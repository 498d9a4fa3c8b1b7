// IVF probe kernels: score queries against the list blocks they probe.
//
// Replaces the three Pallas TPU kernels of minivectordb_tpu/ops/pallas_ivf.py:
//   _probe_kernel    (launched by _probe_scores)     -> ivf_probe_f32, ivf_probe_bf16
//   _group_kernel    (launched by _grouped_scores)   -> ivf_grouped_f32, ivf_grouped_bf16
//   _group_kernel_q  (launched by _grouped_scores_q) -> ivf_grouped_i8
//
// The packed index is lists (L, P, d): L list blocks of P slots, rows stored
// normalized, so a dot product is a cosine.
//
// Paged probe (small batches). For every (query b, probe i):
//   out[b, i*P + r] = dot(q[b], lists[ids[b, i], r])          r in [0, P)
// unmasked, as the TPU kernel leaves it; the caller masks and selects. It is
// B*nprobe matrix-vector products that each read a whole (P, d) block once:
// bound by bytes. A block of 256 threads owns 128 slots of one (b, i) pair;
// the query row sits in shared memory as float32; a warp walks 4 slots at a
// time, its lanes striding along d with 16-byte loads where a row is a whole
// number of 16-byte pieces (4-byte loads otherwise), float32 FMAs, a
// warp-shuffle sum per slot, and each warp writes its 16 sums as one 64-byte
// run. bf16 values are widened to float32 (exact), so products are exact and
// the sum is float32.
//
// Grouped probe (batches of 16 and more; int8 lists at every batch). The
// caller sorts the (query, list) pairs by list and packs each list's queries
// into groups of G <= 16; step s scores group gq[s] (G, d) against list block
// step_list[s]:
//   out[s, g, r] = valid[list, r] ? dot(gq[s, g], lists[list, r]) : -3.0e38
//   int8:          valid ? (float(idot) * list_inv[list, r]) * gqinv[s, g] : -3.0e38
// and a step with step_list[s] < 0 (padding of the static step bound) writes
// the sentinel everywhere, so no uninitialised value leaves the kernel. One
// launch walks all steps: a block owns (step, 128 slots). Every touched list
// block is read from device memory once per group that probes it (groups of
// one list follow each other, so L2 serves the repeats): bound by bytes, the
// (S, G, P) float32 output included, as long as the products keep up.
//   bf16 / int8 (grouped_mma_kernel): mma.sync m16n8k16 / m16n8k32 with the
//   G <= 16 queries as the 16-row A tile and 8 list slots as the B tile. Both
//   operands are contiguous along d, mma.sync's "row.col" layout, and a dot
//   product does not care in which order k is walked as long as A and B walk
//   it alike: so a thread loads 16 contiguous bytes of its slot (and of its
//   two query rows) and feeds words 0,1 to one mma and words 2,3 to the next.
//   List fragments therefore come straight from device memory in 16-byte
//   loads, two steps ahead in registers, with no shared-memory staging; only
//   the query tile (16 x d) is staged, zero-padded to 16 rows.
//   f32 (grouped_f32_kernel): IEEE FMAs on the CUDA cores, never TF32. Slot
//   and query chunks of 32 floats go through shared memory; a thread keeps a
//   4-slot x 4-query register tile and reads both operands as float4.
// Ragged shapes are masked in the kernels: any P, any d whose row is a whole
// number of 32-bit words, any G <= 16.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libivf_probe.so ivf_probe.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float MASKED = -3.0e38f;
constexpr int TILE = 128;  // list slots per block, all kernels
constexpr int GMAX = 16;   // queries per group (rows of the mma A tile)

struct BF16 {};
struct I8 {};

__device__ __forceinline__ uint4 ldg16(const uint32_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// Four consecutive words of a row, zero past the row's end (dw words).
template <bool VEC16>
__device__ __forceinline__ uint4 load_words(const uint32_t* row, int w, int dw) {
    if (VEC16) {  // dw % 4 == 0 and w % 4 == 0: the piece is whole or absent
        return w < dw ? ldg16(row + w) : make_uint4(0u, 0u, 0u, 0u);
    }
    uint4 v;
    v.x = w < dw ? __ldg(row + w) : 0u;
    v.y = w + 1 < dw ? __ldg(row + w + 1) : 0u;
    v.z = w + 2 < dw ? __ldg(row + w + 2) : 0u;
    v.w = w + 3 < dw ? __ldg(row + w + 3) : 0u;
    return v;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// ---------------------------------------------------------------------------
// Paged probe
// ---------------------------------------------------------------------------

constexpr int PROBE_THREADS = 256;                      // 8 warps
constexpr int PROBE_WARP_ROWS = TILE / (PROBE_THREADS / 32);  // 16 slots a warp

// dot of one row piece (4 words) with the query values it meets
template <bool IS_BF16>
__device__ __forceinline__ float dot_words(const uint4 x, const float* qv, float acc) {
    if (IS_BF16) {
        acc = fmaf(bf16_lo(x.x), qv[0], acc);
        acc = fmaf(bf16_hi(x.x), qv[1], acc);
        acc = fmaf(bf16_lo(x.y), qv[2], acc);
        acc = fmaf(bf16_hi(x.y), qv[3], acc);
        acc = fmaf(bf16_lo(x.z), qv[4], acc);
        acc = fmaf(bf16_hi(x.z), qv[5], acc);
        acc = fmaf(bf16_lo(x.w), qv[6], acc);
        acc = fmaf(bf16_hi(x.w), qv[7], acc);
    } else {
        acc = fmaf(__uint_as_float(x.x), qv[0], acc);
        acc = fmaf(__uint_as_float(x.y), qv[1], acc);
        acc = fmaf(__uint_as_float(x.z), qv[2], acc);
        acc = fmaf(__uint_as_float(x.w), qv[3], acc);
    }
    return acc;
}

template <bool IS_BF16, bool VEC16>
__global__ void __launch_bounds__(PROBE_THREADS)
probe_kernel(const uint32_t* __restrict__ lists,  // (L, P, dw) words
             const uint32_t* __restrict__ q,      // (B, dw) words
             const int* __restrict__ ids,         // (B, nprobe)
             float* __restrict__ out,             // (B, nprobe * P)
             int L, int P, int dw, int nprobe, int tiles)
{
    constexpr int VPW = IS_BF16 ? 2 : 1;  // values per word
    extern __shared__ __align__(16) float qs[];  // the query row, dwp * VPW floats

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int tile = blockIdx.x % tiles;
    const int pair = blockIdx.x / tiles;  // b * nprobe + i
    const int b = pair / nprobe;
    const int dwp = (dw + 3) & ~3;        // words, padded to whole pieces

    const uint32_t* qrow = q + (size_t)b * dw;
    for (int w = tid; w < dwp; w += PROBE_THREADS) {
        const uint32_t x = w < dw ? qrow[w] : 0u;
        if (IS_BF16) {
            qs[2 * w] = bf16_lo(x);
            qs[2 * w + 1] = bf16_hi(x);
        } else {
            qs[w] = __uint_as_float(x);
        }
    }
    __syncthreads();

    int list = ids[pair];
    list = min(max(list, 0), L - 1);  // ids come from a top-k over L lists
    const uint32_t* block = lists + (size_t)list * P * dw;
    const int row_w = tile * TILE + warp * PROBE_WARP_ROWS;  // this warp's first slot
    float* orow = out + (size_t)pair * P;

    float mine = 0.0f;  // lane j < 16 ends up holding the sum of slot row_w + j
#pragma unroll
    for (int g4 = 0; g4 < PROBE_WARP_ROWS / 4; ++g4) {
        const int r0 = row_w + g4 * 4;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int w = lane * 4; w < dwp; w += 128) {
            uint4 x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = r0 + j;
                x[j] = r < P ? load_words<VEC16>(block + (size_t)r * dw, w, dw)
                             : make_uint4(0u, 0u, 0u, 0u);
            }
            float qv[4 * VPW];
#pragma unroll
            for (int e = 0; e < VPW; ++e) {
                const float4 t = *reinterpret_cast<const float4*>(&qs[w * VPW + 4 * e]);
                qv[4 * e] = t.x; qv[4 * e + 1] = t.y; qv[4 * e + 2] = t.z; qv[4 * e + 3] = t.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = dot_words<IS_BF16>(x[j], qv, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
            if (lane == g4 * 4 + j) mine = acc[j];
        }
    }
    if (lane < PROBE_WARP_ROWS && row_w + lane < P) orow[row_w + lane] = mine;
}

template <bool IS_BF16>
int launch_probe(const void* lists, const void* q, const int* ids, float* out,
                 int L, int P, int dw, int B, int nprobe, void* stream)
{
    if (L <= 0 || P <= 0 || dw <= 0 || B <= 0 || nprobe <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (P + TILE - 1) / TILE;
    const long long blocks = (long long)B * nprobe * tiles;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int VPW = IS_BF16 ? 2 : 1;
    const int dwp = (dw + 3) & ~3;
    const size_t smem = (size_t)dwp * VPW * sizeof(float);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec16 = dw % 4 == 0 && reinterpret_cast<uintptr_t>(lists) % 16 == 0;
    auto* kernel = vec16 ? probe_kernel<IS_BF16, true> : probe_kernel<IS_BF16, false>;
    kernel<<<static_cast<unsigned>(blocks), PROBE_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lists), static_cast<const uint32_t*>(q), ids, out,
        L, P, dw, nprobe, tiles);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Grouped probe, shared pieces
// ---------------------------------------------------------------------------

constexpr int GROUP_THREADS = 128;  // 4 warps

// A padding step: every value of the block's (G, 128-slot) output tile is the
// sentinel.
__device__ __forceinline__ void fill_masked(float* out, size_t s, int G, int P, int row0) {
    for (int idx = threadIdx.x; idx < G * TILE; idx += GROUP_THREADS) {
        const int g = idx / TILE;
        const int r = row0 + (idx - g * TILE);
        if (r < P) out[(s * G + g) * (size_t)P + r] = MASKED;
    }
}

// ---------------------------------------------------------------------------
// Grouped probe, bf16 / int8: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// D = A (16 x k, row-major) * B (k x 8, column-major) + D
__device__ __forceinline__ void mma(BF16, float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(I8, int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename K> struct Acc { using type = float; };
template <> struct Acc<I8> { using type = int; };

__device__ __forceinline__ float finish(BF16, float acc, float, float) { return acc; }
// Same order as the TPU kernel: (float(dots) * list_inv[slot]) * qinv[query].
__device__ __forceinline__ float finish(I8, int acc, float linv, float qinv) {
    return __fmul_rn(__fmul_rn(static_cast<float>(acc), linv), qinv);
}

// Words of the staged query tile per row: the row padded to whole 16-word
// steps, plus 16 when that is a multiple of 32, so that query rows g and g+1
// lie 16 banks apart and a quarter-warp's 16-byte reads never collide.
__host__ __device__ inline int q_stride(int dw) {
    const int dwp = (dw + 15) & ~15;
    return dwp % 32 == 0 ? dwp + 16 : dwp;
}

template <typename K, bool VEC16>
__global__ void __launch_bounds__(GROUP_THREADS)
grouped_mma_kernel(const uint32_t* __restrict__ lists,   // (L, P, dw) words
                   const uint32_t* __restrict__ gq,      // (S, G, dw) words
                   const int* __restrict__ step_list,    // (S,)
                   const uint8_t* __restrict__ valid,    // (L, P) bool
                   const float* __restrict__ list_inv,   // (L, P), int8 only
                   const float* __restrict__ gqinv,      // (S, G), int8 only
                   float* __restrict__ out,              // (S, G, P)
                   int L, int P, int dw, int G, int tiles)
{
    using acc_t = typename Acc<K>::type;
    extern __shared__ __align__(16) uint32_t qsm[];  // GMAX x q_stride(dw) words

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;   // A/C fragment row (query), B fragment column (slot)
    const int t4 = lane & 3;   // which 16-byte piece of a 16-word step
    const size_t s = blockIdx.x / tiles;
    const int row0 = (blockIdx.x % tiles) * TILE;
    const int list = step_list[s];
    if (list < 0 || list >= L) {  // the same for every thread of the block
        fill_masked(out, s, G, P, row0);
        return;
    }

    const int dwp = (dw + 15) & ~15;
    const int qst = q_stride(dw);
    const uint32_t* gqs = gq + s * G * (size_t)dw;
    for (int idx = tid; idx < GMAX * dwp; idx += GROUP_THREADS) {
        const int r = idx / dwp;
        const int w = idx - r * dwp;
        qsm[r * qst + w] = (r < G && w < dw) ? gqs[(size_t)r * dw + w] : 0u;
    }
    __syncthreads();

    // this warp's 32 slots: 4 n-tiles of 8; this thread feeds slot nt*8 + g
    const int wrow = row0 + warp * 32;
    const uint32_t* brow[4];
    bool bin[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
        const int r = wrow + nt * 8 + g;
        bin[nt] = r < P;
        brow[nt] = lists + ((size_t)list * P + (bin[nt] ? r : 0)) * dw;
    }

    acc_t acc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0;

    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const int nsteps = dwp / 16;
    // list pieces travel two steps ahead of the arithmetic, in registers
    uint4 nxt[2][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
            nxt[p][nt] = (p < nsteps && bin[nt])
                ? load_words<VEC16>(brow[nt], p * 16 + 4 * t4, dw) : zero;

    for (int st = 0; st < nsteps; ++st) {
        uint4 cur[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            cur[nt] = nxt[0][nt];
            nxt[0][nt] = nxt[1][nt];
            nxt[1][nt] = (st + 2 < nsteps && bin[nt])
                ? load_words<VEC16>(brow[nt], (st + 2) * 16 + 4 * t4, dw) : zero;
        }
        const int w = st * 16 + 4 * t4;
        const uint4 qa = *reinterpret_cast<const uint4*>(&qsm[g * qst + w]);
        const uint4 qb = *reinterpret_cast<const uint4*>(&qsm[(g + 8) * qst + w]);
        // fragment registers: (row g, low k), (row g+8, low k), (row g, high
        // k), (row g+8, high k); "low" and "high" are two words of the same
        // 16-byte piece in A and in B alike
        const uint32_t a01[4] = {qa.x, qb.x, qa.y, qb.y};
        const uint32_t a23[4] = {qa.z, qb.z, qa.w, qb.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            mma(K{}, acc[nt], a01, cur[nt].x, cur[nt].y);
            mma(K{}, acc[nt], a23, cur[nt].z, cur[nt].w);
        }
    }

    // Epilogue. acc[nt][h*2 + e] is (query g + 8h, slot nt*8 + 2*t4 + e).
    float qi[2] = {1.0f, 1.0f};
    if (gqinv != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (g + 8 * h < G) qi[h] = gqinv[s * G + g + 8 * h];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = wrow + nt * 8 + 2 * t4 + e;
            if (r >= P) continue;
            const size_t slot = (size_t)list * P + r;
            const bool ok = valid[slot] != 0;
            const float linv = list_inv != nullptr ? list_inv[slot] : 1.0f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gg = g + 8 * h;
                if (gg < G)
                    out[(s * G + gg) * (size_t)P + r] =
                        ok ? finish(K{}, acc[nt][h * 2 + e], linv, qi[h]) : MASKED;
            }
        }
}

template <typename K>
int launch_grouped_mma(const void* lists, const void* gq, const int* step_list,
                       const uint8_t* valid, const float* list_inv, const float* gqinv,
                       float* out, int L, int P, int dw, int S, int G, void* stream)
{
    if (L <= 0 || P <= 0 || dw <= 0 || S <= 0 || G <= 0 || G > GMAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (P + TILE - 1) / TILE;
    const long long blocks = (long long)S * tiles;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = (size_t)GMAX * q_stride(dw) * sizeof(uint32_t);
    const bool vec16 = dw % 4 == 0 && reinterpret_cast<uintptr_t>(lists) % 16 == 0;
    auto* kernel = vec16 ? grouped_mma_kernel<K, true> : grouped_mma_kernel<K, false>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kernel<<<static_cast<unsigned>(blocks), GROUP_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lists), static_cast<const uint32_t*>(gq), step_list,
        valid, list_inv, gqinv, out, L, P, dw, G, tiles);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Grouped probe, float32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int KC = 32;        // floats of a row per chunk
constexpr int FLD = KC + 4;   // shared stride of a slot / query row (16-byte aligned)

template <bool VEC16>
__global__ void __launch_bounds__(GROUP_THREADS)
grouped_f32_kernel(const float* __restrict__ lists,    // (L, P, d)
                   const float* __restrict__ gq,       // (S, G, d)
                   const int* __restrict__ step_list,  // (S,)
                   const uint8_t* __restrict__ valid,  // (L, P) bool
                   float* __restrict__ out,            // (S, G, P)
                   int L, int P, int d, int G, int tiles)
{
    __shared__ __align__(16) float As[TILE * FLD];
    __shared__ __align__(16) float Qs[GMAX * FLD];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int wq = tid >> 5;  // this warp's queries: 4*wq .. 4*wq + 3
    const size_t s = blockIdx.x / tiles;
    const int row0 = (blockIdx.x % tiles) * TILE;
    const int list = step_list[s];
    if (list < 0 || list >= L) {
        fill_masked(out, s, G, P, row0);
        return;
    }
    const float* block = lists + (size_t)list * P * d;
    const float* gqs = gq + s * G * (size_t)d;

    // copy mapping: thread -> (slot tid/8 + 16*i, piece tid%8) of the slot
    // chunk and (query tid/8, piece tid%8) of the query chunk
    const int ld_r = tid >> 3;
    const int ld_k = (tid & 7) * 4;
    auto fetch = [&](const float* base, int r, int rmax, int k0) -> float4 {
        const int k = k0 + ld_k;
        if (r >= rmax) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float* p = base + (size_t)r * d;
        if (VEC16)  // d % 4 == 0: the piece is whole or absent
            return k < d ? __ldg(reinterpret_cast<const float4*>(p + k))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 v;
        v.x = k < d ? __ldg(p + k) : 0.0f;
        v.y = k + 1 < d ? __ldg(p + k + 1) : 0.0f;
        v.z = k + 2 < d ? __ldg(p + k + 2) : 0.0f;
        v.w = k + 3 < d ? __ldg(p + k + 3) : 0.0f;
        return v;
    };

    float acc[4][4];  // [slot lane + 32*j][query 4*wq + i]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

    float4 ra[8], rq;
#pragma unroll
    for (int i = 0; i < 8; ++i) ra[i] = fetch(block, row0 + ld_r + 16 * i, P, 0);
    rq = fetch(gqs, ld_r, G, 0);

    for (int k0 = 0; k0 < d; k0 += KC) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            *reinterpret_cast<float4*>(&As[(ld_r + 16 * i) * FLD + ld_k]) = ra[i];
        *reinterpret_cast<float4*>(&Qs[ld_r * FLD + ld_k]) = rq;
        __syncthreads();
        if (k0 + KC < d) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                ra[i] = fetch(block, row0 + ld_r + 16 * i, P, k0 + KC);
            rq = fetch(gqs, ld_r, G, k0 + KC);
        }
#pragma unroll
        for (int kk = 0; kk < KC; kk += 4) {
            float4 a[4], q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                a[j] = *reinterpret_cast<const float4*>(&As[(lane + 32 * j) * FLD + kk]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
                q[i] = *reinterpret_cast<const float4*>(&Qs[(4 * wq + i) * FLD + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[j][i] = fmaf(a[j].x, q[i].x, acc[j][i]);
                    acc[j][i] = fmaf(a[j].y, q[i].y, acc[j][i]);
                    acc[j][i] = fmaf(a[j].z, q[i].z, acc[j][i]);
                    acc[j][i] = fmaf(a[j].w, q[i].w, acc[j][i]);
                }
        }
        __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = row0 + lane + 32 * j;
        if (r >= P) continue;
        const bool ok = valid[(size_t)list * P + r] != 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int gg = 4 * wq + i;
            if (gg < G) out[(s * G + gg) * (size_t)P + r] = ok ? acc[j][i] : MASKED;
        }
    }
}

int launch_grouped_f32(const void* lists, const void* gq, const int* step_list,
                       const uint8_t* valid, float* out, int L, int P, int d, int S,
                       int G, void* stream)
{
    if (L <= 0 || P <= 0 || d <= 0 || S <= 0 || G <= 0 || G > GMAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (P + TILE - 1) / TILE;
    const long long blocks = (long long)S * tiles;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec16 = d % 4 == 0 && reinterpret_cast<uintptr_t>(lists) % 16 == 0
        && reinterpret_cast<uintptr_t>(gq) % 16 == 0;
    auto* kernel = vec16 ? grouped_f32_kernel<true> : grouped_f32_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), GROUP_THREADS, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lists), static_cast<const float*>(gq), step_list, valid,
        out, L, P, d, G, tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All tensors contiguous; lists, q and gq 4-byte aligned. `d` is in elements:
// d*itemsize must be a multiple of 4 (the wrappers check). Each returns
// cudaGetLastError() after the launch (0 = launched).

extern "C" int ivf_probe_f32(const void* lists, const void* q, const int* ids, float* out,
                             int L, int P, int d, int B, int nprobe, void* stream)
{
    return launch_probe<false>(lists, q, ids, out, L, P, d, B, nprobe, stream);
}

extern "C" int ivf_probe_bf16(const void* lists, const void* q, const int* ids, float* out,
                              int L, int P, int d, int B, int nprobe, void* stream)
{
    if (d % 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch_probe<true>(lists, q, ids, out, L, P, d / 2, B, nprobe, stream);
}

extern "C" int ivf_grouped_f32(const void* lists, const void* gq, const int* step_list,
                               const uint8_t* valid, float* out, int L, int P, int d,
                               int S, int G, void* stream)
{
    return launch_grouped_f32(lists, gq, step_list, valid, out, L, P, d, S, G, stream);
}

extern "C" int ivf_grouped_bf16(const void* lists, const void* gq, const int* step_list,
                                const uint8_t* valid, float* out, int L, int P, int d,
                                int S, int G, void* stream)
{
    if (d % 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch_grouped_mma<BF16>(lists, gq, step_list, valid, nullptr, nullptr, out,
                                    L, P, d / 2, S, G, stream);
}

extern "C" int ivf_grouped_i8(const void* lists, const void* gq, const int* step_list,
                              const uint8_t* valid, const float* list_inv,
                              const float* gqinv, float* out, int L, int P, int d, int S,
                              int G, void* stream)
{
    if (d % 4 || list_inv == nullptr || gqinv == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_grouped_mma<I8>(lists, gq, step_list, valid, list_inv, gqinv, out,
                                  L, P, d / 4, S, G, stream);
}
