// Small-batch exact scan: the cosine scores of up to 8 queries against a
// float32 corpus, with the top-k selected inside the scan, in one pass over
// the corpus.
//
// Replaces no Pallas kernel. The JAX package leaves this route
// (minivectordb_tpu/ops/scan.py:scan_topk, batches under 16) to XLA: a
// matmul into the (B, C) score matrix, then lax.top_k. The port's plain form
// of it (ops/scan.py: torch.matmul, the scale and mask, topk_last_axis)
// writes that matrix to device memory and reads it back several times; this
// source computes the same answer without it:
//
//   score[b, r] = dot(buf[r], q[b] / max(||q[b]||, 1e-30)) * inv[r]
//   score[b, r] = -3.0e38  where r >= count or mask[r] == 0
//   out[b]      = the kb best (score, row) of each query, in topk_last_axis's
//                 order: descending score, the lower row first among equal
//                 scores (also across the kb-th place), -0.0 equal to +0.0;
//                 masked rows rank by row like any other
//
// What bounds it on an H100: at B <= 8 a corpus row of d float32 words feeds
// 2 * B * d operations, at most 4 a byte read, far below the ~20 a byte at
// which IEEE FMAs on the CUDA cores (67 TFLOP/s) would meet 3.35 TB/s. So the
// bytes bound it: the live rows read once, count * d * 4 bytes (3.07 GB at
// 1M x 768: 0.92 ms). The design keeps every corpus byte's trip single and
// overlapped, and the selection off that stream's path:
//   - small_scan_kernel: each block streams one contiguous range of rows,
//     once. A warp takes R consecutive rows at a time; lane l reads 16-byte
//     words l, l + 32, ... of each (8- or 4-byte words where d, or the
//     buffer's alignment, allows no wider), so a warp reads whole 512-byte
//     runs of a row, R of them independent and in flight, 8 warps a block and
//     2 blocks an SM. The loads are marked streaming (ld.global.cs), so the
//     corpus does not evict the queries or the per-row scales. Rows at or past
//     `count` are not read at all; masked rows are not read either.
//   - The queries sit in shared memory, normalised in each block's prologue
//     with the plain version's formula (1,024 columns at a time where d is
//     wider: then each row group reloads them, a small share of the row's own
//     bytes). Products are IEEE float32 FMAs on the CUDA cores, neither TF32
//     nor 3xTF32. Each lane sums its columns in order; then a butterfly across
//     the warp (each exchange halves the values a lane holds) leaves each
//     (row, query) dot in one lane after R * B - 1 + 5 - log2(R * B) shuffles.
//   - The scores never leave the block as a matrix: each query has a list of
//     candidate keys in shared memory and a threshold, the kb-th best key kept
//     so far. A key is (order-preserving uint32 of score + 0.0) << 32 | ~row,
//     so keys are distinct and compare in topk_last_axis's order, and one
//     64-bit word carries both score and row; 0 is no key. A key above the
//     threshold is appended (a shared-memory atomic); a list that could
//     overflow in the next round is sorted (bitonic, by the whole block) and
//     cut to kb, which raises the threshold. After the first thousand rows of
//     a block few rows pass, so a block sorts its lists a few times over some
//     thousands of rows and once at its end, and writes its kb best keys a
//     query, sorted.
//   - small_scan_merge: one block a query reduces the blocks' lists (kb keys
//     each, sorted) to the final kb. The kb-th best of the lists' leading keys
//     (ceil(kb / lists) of each) bounds the answer from below, so only keys
//     at or above it are appended to the list, which is sorted and written
//     as (values float32, ids int32). Slots past the rows that exist (count <
//     kb) get -3.0e38 and their own slot number as the row, as a top-k over
//     the padded buffer gives.
// ops/small_scan.py:small_scan_plain repeats this arithmetic (per-block top-k
// of the same keys, then the merge) in plain PyTorch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 8;
constexpr int QCHUNK = 1024;       // query columns resident in shared memory
constexpr int MAX_KB = 1024;       // the widest selection (ops/small_scan.py KMAX)
constexpr int MAX_BLOCKS = 1024;   // scan blocks a launch: the merge's leading keys fit
constexpr int MERGE_CAP = 8192;    // the merge's list
constexpr int MERGE_THREADS = 512;
constexpr int MERGE_LOADS = 8;     // keys a merge thread loads at once
constexpr int MERGE_HEADS = 2048;  // >= the next power of two of kb + MAX_BLOCKS
constexpr int MAX_DEVICES = 64;
constexpr float MASKED = -3.0e38f;

// ---------------------------------------------------------------------------
// keys
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_key(float s, int row) {
    // s + 0.0 turns -0.0 into +0.0 (__fadd_rn is never folded away); the
    // flip maps IEEE order onto unsigned order
    uint32_t u = __float_as_uint(__fadd_rn(s, 0.0f));
    u ^= (u & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u;
    return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(row));
}

__device__ __forceinline__ float key_score(uint64_t key) {
    const uint32_t u = static_cast<uint32_t>(key >> 32);
    return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

__device__ __forceinline__ int key_row(uint64_t key) {
    return static_cast<int>(~static_cast<uint32_t>(key));
}

// ---------------------------------------------------------------------------
// lists in shared memory
// ---------------------------------------------------------------------------

// Sorts the first n keys (a power of two) of each list l < lists with sel[l]
// (every list when sel is null) descending, by bitonic exchanges of the whole
// block; list l starts at keys + l * stride.
__device__ void sort_lists(uint64_t* keys, int stride, int lists, const int* sel, int n) {
    const int half = n >> 1;
    const int shift = 31 - __clz(half);
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < lists * half; t += blockDim.x) {
                const int l = t >> shift;
                if (sel != nullptr && !sel[l]) continue;
                const int p = t & (half - 1);
                const int i = 2 * p - (p & (j - 1));
                uint64_t* list = keys + l * stride;
                const uint64_t a = list[i];
                const uint64_t b = list[i + j];
                if ((a < b) == ((i & k) == 0)) {
                    list[i] = b;
                    list[i + j] = a;
                }
            }
            __syncthreads();
        }
    }
}

// Cuts each list with sel[l] to its kb best keys, sorted, and sets its
// threshold to the kb-th (0 while it holds fewer). The caller has synced
// since the lists, cnt and sel were last written.
__device__ void compact(uint64_t* keys, int stride, int lists, int* cnt, uint64_t* thr,
                        const int* sel, int kb) {
    int most = kb;
    for (int l = 0; l < lists; ++l)
        if (sel[l] && cnt[l] > most) most = cnt[l];
    int n = 1;
    while (n < most) n <<= 1;  // <= stride: cnt <= stride and kb <= stride
    for (int l = 0; l < lists; ++l)
        if (sel[l])
            for (int i = cnt[l] + threadIdx.x; i < n; i += blockDim.x) keys[l * stride + i] = 0;
    __syncthreads();
    sort_lists(keys, stride, lists, sel, n);
    if (threadIdx.x < lists && sel[threadIdx.x]) {
        const int m = min(cnt[threadIdx.x], kb);
        cnt[threadIdx.x] = m;
        thr[threadIdx.x] = m == kb ? keys[threadIdx.x * stride + kb - 1] : 0;
    }
    __syncthreads();
}

// ---------------------------------------------------------------------------
// the scan
// ---------------------------------------------------------------------------

template <int V> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ float fma_dot(float acc, float4 x, float4 q) {
    acc = fmaf(x.x, q.x, acc);
    acc = fmaf(x.y, q.y, acc);
    acc = fmaf(x.z, q.z, acc);
    return fmaf(x.w, q.w, acc);
}
__device__ __forceinline__ float fma_dot(float acc, float2 x, float2 q) {
    acc = fmaf(x.x, q.x, acc);
    return fmaf(x.y, q.y, acc);
}
__device__ __forceinline__ float fma_dot(float acc, float x, float q) { return fmaf(x, q, acc); }

// The warp's butterfly over a lane's n sums, from lane bit O down: the
// exchange across bit O hands the partner half of the values and adds the
// half it hands back; once one value is left, plain xor sums finish it. Lane
// l ends with the warp's total of value l >> (5 - log2 n) of the n it began
// with.
template <int O, int n>
__device__ __forceinline__ void butterfly(float* acc, int lane) {
    if constexpr (O > 0) {
        if constexpr (n > 1) {
            const bool upper = (lane & O) != 0;
#pragma unroll
            for (int i = 0; i < n / 2; ++i) {
                const float keep = upper ? acc[i + n / 2] : acc[i];
                const float send = upper ? acc[i] : acc[i + n / 2];
                acc[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, O);
            }
        } else {
            acc[0] += __shfl_xor_sync(0xFFFFFFFFu, acc[0], O);
        }
        butterfly<O / 2, (n > 1 ? n / 2 : 1)>(acc, lane);
    }
}

// Rows a warp takes at a time: R * QB sums a lane (32 at most).
template <int QB> struct Rows { static constexpr int value = QB == 8 ? 4 : 8; };

// Block x scans rows [x * rows_per_block, min(count, (x + 1) * rows_per_block))
// for queries 0 .. nq - 1 (nq <= QB; the rest are zero) and writes its kb best
// keys a query, sorted, to cand[(query * gridDim.x + x) * kb ...]. cap (a power
// of two) is each list's room; a round is `groups` row groups of R a warp.
template <int QB, int V>
__global__ void __launch_bounds__(THREADS, 2)
small_scan_kernel(const float* __restrict__ buf, const float* __restrict__ q,
                  const float* __restrict__ inv, const uint8_t* __restrict__ mask,
                  uint64_t* __restrict__ cand, int d, int nq, int count, int kb, int cap,
                  int rows_per_block, int groups)
{
    constexpr int R = Rows<QB>::value;
    constexpr int N = R * QB;
    constexpr int L = N == 8 ? 3 : N == 16 ? 4 : 5;  // log2(N); N is 8, 16 or 32
    static_assert(N == 8 || N == 16 || N == 32, "a lane's sums");
    using T = typename Vec<V>::T;

    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);      // QB lists of cap
    float* qs = reinterpret_cast<float*>(keys + QB * cap);  // QB x qw normalised query words
    const int qw = min(d, QCHUNK);
    __shared__ uint64_t thr[QB];
    __shared__ int cnt[QB];
    __shared__ int sel[QB];
    __shared__ float scale[QB];
    __shared__ float part[WARPS][QB];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int r0 = blockIdx.x * rows_per_block;
    const int r1 = min(count, r0 + rows_per_block);

    // prologue: each query's norm, clamped as the plain version clamps it
    float ss[QB];
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) ss[qq] = 0.0f;
    for (int i = tid; i < d; i += THREADS) {
#pragma unroll
        for (int qq = 0; qq < QB; ++qq) {
            if (qq < nq) {
                const float v = q[static_cast<size_t>(qq) * d + i];
                ss[qq] = fmaf(v, v, ss[qq]);
            }
        }
    }
#pragma unroll
    for (int qq = 0; qq < QB; ++qq) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ss[qq] += __shfl_xor_sync(0xFFFFFFFFu, ss[qq], o);
        if (lane == 0) part[warp][qq] = ss[qq];
    }
    if (tid < QB) {
        cnt[tid] = 0;
        thr[tid] = 0;
    }
    __syncthreads();
    if (tid < QB) {
        float t = 0.0f;
        for (int w = 0; w < WARPS; ++w) t += part[w][tid];
        scale[tid] = fmaxf(sqrtf(t), 1e-30f);
    }
    __syncthreads();

    // the normalised query words of columns [c0, c0 + w) into qs
    auto load_queries = [&](int c0, int w) {
        for (int i = tid; i < QB * w; i += THREADS) {
            const int qq = i / w;
            const int j = i - qq * w;
            qs[qq * qw + j] = qq < nq ? q[static_cast<size_t>(qq) * d + c0 + j] / scale[qq] : 0.0f;
        }
    };
    const int chunks = (d + QCHUNK - 1) / QCHUNK;
    if (chunks == 1) load_queries(0, d);  // seen after the first round's barrier

    const int round_rows = WARPS * R * groups;
    const int rounds = r1 > r0 ? (r1 - r0 + round_rows - 1) / round_rows : 0;
    for (int rnd = 0; rnd < rounds; ++rnd) {
        __syncthreads();  // the last round's keys are in
        const int limit = cap - round_rows;
        if (tid < QB) sel[tid] = cnt[tid] > limit;
        if (__syncthreads_or(tid < QB && cnt[tid] > limit))
            compact(keys, cap, QB, cnt, thr, sel, kb);
        for (int g = 0; g < groups; ++g) {
            const int base = r0 + ((rnd * groups + g) * WARPS + warp) * R;
            bool live[R];
            const T* rowp[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int row = base + r;
                live[r] = row < r1 && (mask == nullptr || mask[row]);
                rowp[r] = reinterpret_cast<const T*>(buf + static_cast<size_t>(row) * d);
            }
            float acc[N];
#pragma unroll
            for (int i = 0; i < N; ++i) acc[i] = 0.0f;
            for (int c = 0; c < chunks; ++c) {
                const int c0 = c * QCHUNK;
                const int w = min(QCHUNK, d - c0);
                if (chunks > 1) {
                    __syncthreads();
                    load_queries(c0, w);
                    __syncthreads();
                }
                const int nv = w / V;
                const int v0 = c0 / V;
                for (int v = lane; v < nv; v += 32) {
                    T x[R];
#pragma unroll
                    for (int r = 0; r < R; ++r) x[r] = live[r] ? __ldcs(rowp[r] + v0 + v) : T{};
#pragma unroll
                    for (int qq = 0; qq < QB; ++qq) {
                        const T qv = reinterpret_cast<const T*>(qs + qq * qw)[v];
#pragma unroll
                        for (int r = 0; r < R; ++r)
                            acc[r * QB + qq] = fma_dot(acc[r * QB + qq], x[r], qv);
                    }
                }
            }
            butterfly<16, N>(acc, lane);
            // lane holds value lane >> (5 - L) (row idx / QB, query idx % QB);
            // 2^(5 - L) lanes hold it, the first appends it
            if ((lane & ((1 << (5 - L)) - 1)) == 0) {
                const int idx = lane >> (5 - L);
                const int qq = idx % QB;
                const int row = base + idx / QB;
                if (qq < nq && row < r1) {
                    const bool on = mask == nullptr || mask[row];
                    const uint64_t key = make_key(on ? acc[0] * __ldg(inv + row) : MASKED, row);
                    if (key > thr[qq]) keys[qq * cap + atomicAdd(&cnt[qq], 1)] = key;
                }
            }
        }
    }
    __syncthreads();
    if (tid < QB) sel[tid] = tid < nq;
    __syncthreads();
    compact(keys, cap, QB, cnt, thr, sel, kb);
    for (int i = tid; i < nq * kb; i += THREADS) {
        const int qq = i / kb;
        const int j = i - qq * kb;
        cand[(static_cast<size_t>(qq) * gridDim.x + blockIdx.x) * kb + j] = keys[qq * cap + j];
    }
}

// ---------------------------------------------------------------------------
// the merge
// ---------------------------------------------------------------------------

// Block b reduces query b's `lists` sorted lists of kb keys (cand[(b * lists
// + l) * kb ...]) to its kb best, written as vals / ids (b, kb).
__global__ void __launch_bounds__(MERGE_THREADS)
small_scan_merge(const uint64_t* __restrict__ cand, int lists, int kb,
                 float* __restrict__ vals, int* __restrict__ ids)
{
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // MERGE_CAP
    uint64_t* heads = keys + MERGE_CAP;                  // MERGE_HEADS
    __shared__ uint64_t thr[1];
    __shared__ int cnt[1];
    __shared__ int sel[1];
    const int tid = threadIdx.x;
    const uint64_t* in = cand + static_cast<size_t>(blockIdx.x) * lists * kb;
    if (tid == 0) {
        cnt[0] = 0;
        thr[0] = 0;
        sel[0] = 1;
    }
    if (lists > 0) {
        // the leading m keys of every list: the kb best of them are kb keys,
        // so every key of the answer is at least the kb-th of them
        const int m = (kb + lists - 1) / lists;
        const int nh = lists * m;
        int hs = 1;
        while (hs < nh) hs <<= 1;
        for (int i = tid; i < hs; i += MERGE_THREADS)
            heads[i] = i < nh ? in[static_cast<size_t>(i / m) * kb + i % m] : 0;
        __syncthreads();
        sort_lists(heads, hs, 1, nullptr, hs);
        if (tid == 0) thr[0] = heads[kb - 1] ? heads[kb - 1] - 1 : 0;
        // rounds of MERGE_LOADS keys a thread, all loaded before any is
        // appended, so a round waits for one trip to L2
        const int total = lists * kb;
        constexpr int ROUND = MERGE_THREADS * MERGE_LOADS;  // <= MERGE_CAP - kb
        for (int start = 0; start < total; start += ROUND) {
            __syncthreads();
            if (__syncthreads_or(tid == 0 && cnt[0] > MERGE_CAP - ROUND))
                compact(keys, MERGE_CAP, 1, cnt, thr, sel, kb);
            const uint64_t t = thr[0];
            uint64_t got[MERGE_LOADS];
#pragma unroll
            for (int u = 0; u < MERGE_LOADS; ++u) {
                const int i = start + u * MERGE_THREADS + tid;
                got[u] = i < total ? in[i] : 0;
            }
#pragma unroll
            for (int u = 0; u < MERGE_LOADS; ++u)
                if (got[u] > t) keys[atomicAdd(&cnt[0], 1)] = got[u];
        }
    }
    __syncthreads();
    compact(keys, MERGE_CAP, 1, cnt, thr, sel, kb);
    for (int j = tid; j < kb; j += MERGE_THREADS) {
        const uint64_t key = keys[j];
        vals[static_cast<size_t>(blockIdx.x) * kb + j] = key ? key_score(key) : MASKED;
        ids[static_cast<size_t>(blockIdx.x) * kb + j] = key ? key_row(key) : j;
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int list_cap(int kb) {
    int c = 1024;
    while (c < 2 * kb) c <<= 1;
    return c;
}

size_t scan_smem(int qb, int d, int cap) {
    return static_cast<size_t>(qb) * cap * 8 + static_cast<size_t>(qb) * (d < QCHUNK ? d : QCHUNK) * 4;
}

int device_index(int& dev) {
    if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
    return dev < 0 || dev >= MAX_DEVICES ? static_cast<int>(cudaErrorInvalidDevice) : 0;
}

// The largest dynamic shared memory either kernel asks for, allowed once a
// device and instantiation.
template <typename K>
int allow_smem(K* kernel, size_t most, bool (&ready)[MAX_DEVICES]) {
    int dev;
    if (int e = device_index(dev)) return e;
    if (!ready[dev]) {
        if (cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most)))
            return static_cast<int>(e);
        ready[dev] = true;
    }
    return 0;
}

using ScanKernel = void (*)(const float*, const float*, const float*, const uint8_t*,
                            uint64_t*, int, int, int, int, int, int, int);

template <int QB, int V>
int scan_kernel_ready(ScanKernel& kernel) {
    static bool ready[MAX_DEVICES];
    kernel = small_scan_kernel<QB, V>;
    return allow_smem(kernel, scan_smem(QB, QCHUNK, list_cap(MAX_KB)), ready);
}

template <int QB>
int pick(int v, ScanKernel& kernel) {
    if (v == 4) return scan_kernel_ready<QB, 4>(kernel);
    if (v == 2) return scan_kernel_ready<QB, 2>(kernel);
    return scan_kernel_ready<QB, 1>(kernel);
}

// queries padded to 1, 2, 4 or 8
int queries_of(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

int scan_kernel_for(int B, int v, ScanKernel& kernel) {
    switch (queries_of(B)) {
        case 1: return pick<1>(v, kernel);
        case 2: return pick<2>(v, kernel);
        case 4: return pick<4>(v, kernel);
        default: return pick<8>(v, kernel);
    }
}

// The widest word a lane reads: 16 bytes where every row starts on a
// 16-byte boundary, else 8, else 4.
int word_of(const void* buf, int d) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(buf);
    if (d % 4 == 0 && p % 16 == 0) return 4;
    if (d % 2 == 0 && p % 8 == 0) return 2;
    return 1;
}

}  // namespace

// Scan blocks a launch for rows of d float32 words, B queries and kb keys
// kept: as many as stay resident on the current card at once (its SMs times
// the blocks an SM holds), at most 1,024. Returns a cudaError value (0 = ok).
extern "C" int small_scan_max_blocks(int d, int B, int kb, int* blocks)
{
    if (d <= 0 || B < 1 || B > MAX_Q || kb < 1 || kb > MAX_KB || blocks == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    ScanKernel kernel;
    if (int e = scan_kernel_for(B, d % 4 == 0 ? 4 : d % 2 == 0 ? 2 : 1, kernel)) return e;
    int dev, sms, per_sm;
    if (int e = device_index(dev)) return e;
    if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
        return static_cast<int>(e);
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, THREADS, scan_smem(queries_of(B), d, list_cap(kb))))
        return static_cast<int>(e);
    const int n = sms * (per_sm > 0 ? per_sm : 1);
    *blocks = n < MAX_BLOCKS ? n : MAX_BLOCKS;
    return 0;
}

// buf (C, d) float32 and q (B, d) float32, contiguous; inv (C,) float32; mask
// (C,) bytes or null; cand scratch of B * blocks * kb 64-bit words; vals (B,
// kb) float32 and ids (B, kb) int32 out. Rows [0, count) are scanned by
// `blocks` blocks of rows_per_block rows (blocks * rows_per_block >= count;
// no block at count = 0). Launches the scan and the merge on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
extern "C" int small_scan_f32(const float* buf, const float* q, const float* inv,
                              const uint8_t* mask, void* cand, float* vals, int* ids,
                              int d, int B, int count, int kb, int blocks,
                              int rows_per_block, void* stream)
{
    if (d <= 0 || B < 1 || B > MAX_Q || kb < 1 || kb > MAX_KB || count < 0 || blocks < 0 ||
        blocks > MAX_BLOCKS || (count > 0 && (blocks == 0 || rows_per_block <= 0 ||
                                              static_cast<long long>(blocks) * rows_per_block < count)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto* keys = static_cast<uint64_t*>(cand);
    const int n = count > 0 ? blocks : 0;
    if (n > 0) {
        ScanKernel kernel;
        const int v = word_of(buf, d);
        if (int e = scan_kernel_for(B, v, kernel)) return e;
        const int qb = queries_of(B);
        const int cap = list_cap(kb);
        const int r = qb == 8 ? Rows<8>::value : Rows<1>::value;
        // rounds of up to 4 row groups a warp, while a round fills at most half
        // of a list's room past kb; one group a round where d is chunked
        int groups = (cap - kb) / (2 * WARPS * r);
        groups = d > QCHUNK ? 1 : groups < 1 ? 1 : groups > 4 ? 4 : groups;
        kernel<<<n, THREADS, scan_smem(qb, d, cap), st>>>(
            buf, q, inv, mask, keys, d, B, count, kb, cap, rows_per_block, groups);
        if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    }
    static bool ready[MAX_DEVICES];
    constexpr size_t merge_smem = static_cast<size_t>(MERGE_CAP + MERGE_HEADS) * 8;
    if (int e = allow_smem(small_scan_merge, merge_smem, ready)) return e;
    small_scan_merge<<<B, MERGE_THREADS, merge_smem, st>>>(keys, n, kb, vals, ids);
    return static_cast<int>(cudaGetLastError());
}
