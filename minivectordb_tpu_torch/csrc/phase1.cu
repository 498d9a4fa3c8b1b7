// Phase 1 of the fused exact scan: subtile maxima of masked cosine scores.
//
// Replaces the two Pallas TPU kernels of minivectordb_tpu/ops/pallas_scan.py:
//   _phase1_kernel       (launched by subtile_maxima)        -> phase1_f32, phase1_bf16
//   _phase1_kernel_int8  (launched by _subtile_maxima_int8)  -> phase1_i8
//
// For a padded corpus buf (C, d), a query block q (B, d) of the same type and
// per-row scales inv (C,), it computes, without ever writing the (B, C)
// score matrix to device memory,
//
//   score[b, r] = dot(buf[r], q[b]) * inv[r]              (f32 / bf16, f32 sum)
//   score[b, r] = float(idot(buf[r], q[b])) * inv[r] * qinv[b]   (int8, int32 sum)
//   score[b, r] = -3.0e38  where r >= count or mask[r] == 0
//   out[b, s]   = max over the 32 rows of subtile s
//
// and writes out as (B, C/32). (The TPU kernel writes (C/32, B) because its
// compiler can only regroup the major axis; its caller transposes at once.)
//
// What bounds it on an H100: the product is 2*B*C*d operations over C*d
// elements read once. At B = 256 float32 is bound by arithmetic: its
// multiply-adds must be IEEE float32 FMAs on the CUDA cores (no TF32), about
// 3 ms of them at the card's peak against 0.5 ms of memory traffic. bf16 and
// int8 are bound by memory (0.24 and 0.12 ms of corpus bytes) as long as
// their products run on the tensor cores, which they do here through
// mma.sync. Their chunks arrive through a 4-stage cp.async ring that keeps
// three chunks per block in flight (register prefetch of one chunk left the
// kernel waiting on memory latency). What limits them now
// is traffic from L2 into the SMs: every row tile is fetched by both query
// blocks and every row tile re-reads its query tile, four times the corpus
// bytes in all (copied 16 bytes at a time where rows are 16-byte multiples,
// else 4). Wider tiles or a resident query tile, wgmma and TMA are later
// work. Both kernels share one skeleton:
//   - a block owns 128 rows x 128 queries and walks d in chunks of 16 32-bit
//     words (16 floats, 32 bf16, 64 int8) through shared memory;
//   - the next chunk(s) are requested before the current chunk's arithmetic
//     (float32: into registers; mma: by cp.async into the ring, which runs on
//     across the block's row tiles), so memory latency hides behind it;
//   - a warp owns exactly one 32-row subtile by 64 queries, so the subtile
//     max never leaves the warp: an in-thread max, then __shfl_xor_sync
//     steps; scale, mask and max all happen in registers;
//   - a block walks up to 8 consecutive row tiles and stages its maxima in
//     shared memory, so each query's output leaves as one 128-byte run;
//   - row tiles that start at or past `count` are skipped (sentinel output);
//   - two 256-thread blocks fit on an SM (at most 128 registers a thread).
// float32 (phase1_f32_kernel): tiles are stored k-major; a thread keeps an
// 8 x 8 register tile, so every word it reads from shared memory feeds 8 FMAs.
// bf16 / int8 (phase1_mma_kernel): tiles are stored as they lie in memory
// (row-major, k contiguous), which is exactly the "row.col" operand layout
// of mma.sync m16n8k16 (bf16) and m16n8k32 (int8): each fragment register is
// one 32-bit word read straight from shared memory, the same word index for
// both types, with a row stride of 20 words so the 32 lanes of a fragment
// load hit 32 different banks. A warp runs 2 x 8 mma per 8-word step.
// Ragged edges are masked in the kernel: d need not be a multiple of the
// chunk, B need not be a multiple of 128, C need only be a multiple of 32.
// `count` is a kernel argument, so no scalar upload or host sync is needed.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libphase1.so phase1.cu

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // corpus rows per tile
constexpr int BN = 128;       // queries per block
constexpr int KW = 16;        // 32-bit words of a row per chunk
constexpr int THREADS = 256;  // 8 warps: 4 subtiles x 2 query halves
constexpr int SUBTILE = 32;   // rows per max group
constexpr int MAX_RT = 8;     // row tiles a block walks
constexpr int LDS = BM + 4;   // f32 kernel: shared stride of a k-row (BM == BN)
constexpr int TLD = KW + 4;   // mma kernel: shared stride of a corpus/query row
constexpr int OLD = MAX_RT * (BM / SUBTILE) + 1;  // staged-output stride
constexpr float MASKED = -3.0e38f;

struct BF16 {};
struct I8 {};

template <typename K> struct Acc { using type = float; };
template <> struct Acc<I8> { using type = int; };

// D = A (16 x k, row-major) * B (k x 8, column-major) + D on the tensor cores.
__device__ __forceinline__ void mma(BF16, float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(I8, int (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float scaled(BF16, float acc, float inv, float) {
    return acc * inv;
}
// Same order as the TPU kernel: (float(dots) * inv[row]) * qinv[query].
__device__ __forceinline__ float scaled(I8, int acc, float inv, float qinv) {
    return __fmul_rn(__fmul_rn(static_cast<float>(acc), inv), qinv);
}

// ---------------------------------------------------------------------------
// float32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------

template <bool HAS_MASK>
__global__ void __launch_bounds__(THREADS, 2)  // 2 blocks per SM: <= 128 registers
phase1_f32_kernel(const uint32_t* __restrict__ buf,   // (C, dw) words
                  const uint32_t* __restrict__ q,     // (B, dw) words
                  const float* __restrict__ inv,      // (C,)
                  const uint8_t* __restrict__ mask,   // (C,) bool, HAS_MASK only
                  float* __restrict__ out,            // (B, C/32)
                  int C, int dw, int B, int count, int rt)
{
    __shared__ __align__(16) uint32_t As[KW * LDS];
    __shared__ __align__(16) uint32_t Bs[KW * LDS];
    __shared__ float Os[BN * OLD];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wr = warp >> 1;   // 0..3: which 32-row subtile of the tile
    const int wq = warp & 1;    // 0..1: which 64-query half of the block
    const int rg = lane >> 3;   // 0..3: 8-row group inside the subtile
    const int qg = lane & 7;    // 0..7: 8-query group inside the half
    const int row_in_tile = wr * SUBTILE + rg * 8;
    const int q_in_blk = wq * 64 + qg * 8;
    const int q0 = blockIdx.y * BN;
    const int nsub = C / SUBTILE;
    const int ld_k = tid & (KW - 1);  // word of the chunk this thread loads
    const int ld_r = tid >> 4;        // first of its 8 rows / queries (step 16)
    const int nchunks = (dw + KW - 1) / KW;

    // Tiles that start at or past `count` hold no live row: their maxima are
    // the sentinel without any arithmetic (right after a capacity bucket
    // grows, that is up to half of the buffer).
    for (int idx = tid; idx < BN * OLD; idx += THREADS) Os[idx] = MASKED;
    __syncthreads();

    for (int t = 0; t < rt; ++t) {
        const int row0 = (blockIdx.x * rt + t) * BM;
        if (row0 >= C || row0 >= count) break;  // same for every thread of the block

        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

        uint32_t ra[8], rb[8];
        {
            const bool kin = ld_k < dw;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = row0 + ld_r + 16 * i;
                const int qq = q0 + ld_r + 16 * i;
                ra[i] = (kin && r < C) ? buf[(size_t)r * dw + ld_k] : 0u;
                rb[i] = (kin && qq < B) ? q[(size_t)qq * dw + ld_k] : 0u;
            }
        }

        for (int c = 0; c < nchunks; ++c) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                As[ld_k * LDS + ld_r + 16 * i] = ra[i];
                Bs[ld_k * LDS + ld_r + 16 * i] = rb[i];
            }
            __syncthreads();

            if (c + 1 < nchunks) {
                const int kw = (c + 1) * KW + ld_k;
                const bool kin = kw < dw;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int r = row0 + ld_r + 16 * i;
                    const int qq = q0 + ld_r + 16 * i;
                    ra[i] = (kin && r < C) ? buf[(size_t)r * dw + kw] : 0u;
                    rb[i] = (kin && qq < B) ? q[(size_t)qq * dw + kw] : 0u;
                }
            }

#pragma unroll
            for (int kw = 0; kw < KW; ++kw) {
                const uint4 a0 = *reinterpret_cast<const uint4*>(&As[kw * LDS + row_in_tile]);
                const uint4 a1 = *reinterpret_cast<const uint4*>(&As[kw * LDS + row_in_tile + 4]);
                const uint4 b0 = *reinterpret_cast<const uint4*>(&Bs[kw * LDS + q_in_blk]);
                const uint4 b1 = *reinterpret_cast<const uint4*>(&Bs[kw * LDS + q_in_blk + 4]);
                const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                const uint32_t b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = fmaf(__uint_as_float(a[i]), __uint_as_float(b[j]),
                                         acc[i][j]);
            }
            __syncthreads();
        }

        // Epilogue in registers: scale, mask, max over the subtile's 32 rows.
        float m[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) m[j] = MASKED;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = row0 + row_in_tile + i;
            bool valid = r < count && r < C;
            float iv = 0.0f;
            if (r < C) {
                iv = inv[r];
                if (HAS_MASK) valid = valid && (mask[r] != 0);
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float s = valid ? acc[i][j] * iv : MASKED;
                m[j] = fmaxf(m[j], s);
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 8));
            m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], 16));
        }
        if (rg == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                Os[(q_in_blk + j) * OLD + t * (BM / SUBTILE) + wr] = m[j];
        }
    }

    __syncthreads();
    const int nsb = rt * (BM / SUBTILE);          // subtiles this block covers
    const int sub0 = blockIdx.x * nsb;
    for (int idx = tid; idx < BN * nsb; idx += THREADS) {
        const int ql = idx / nsb;
        const int s = idx - ql * nsb;
        if (q0 + ql < B && sub0 + s < nsub)
            out[(size_t)(q0 + ql) * nsub + sub0 + s] = Os[ql * OLD + s];
    }
}


// ---------------------------------------------------------------------------
// bfloat16 / int8: mma.sync on the tensor cores, fed by a cp.async ring
// ---------------------------------------------------------------------------

// Copy 4 bytes global -> shared without passing through registers; with
// src_bytes == 0 nothing is read and the word is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
// The same for 16 bytes; both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

constexpr int STAGES = 4;                          // chunks in the ring
constexpr int STAGE_WORDS = (BM + BN) * TLD;       // one chunk: A tile, then B tile
constexpr int MMA_SMEM_BYTES = (STAGES * STAGE_WORDS + BN * OLD) * 4;

// VEC16: rows are a whole number of 16-byte pieces (dw % 4 == 0) and 16-byte
// aligned, so a chunk row is copied as 4 pieces of 16 bytes instead of 16 words.
template <typename K, bool HAS_MASK, bool VEC16>
__global__ void __launch_bounds__(THREADS, 2)  // 2 blocks per SM: <= 128 registers
phase1_mma_kernel(const uint32_t* __restrict__ buf,   // (C, dw) words
                  const uint32_t* __restrict__ q,     // (B, dw) words
                  const float* __restrict__ inv,      // (C,)
                  const float* __restrict__ qinv,     // (B,) int8 only
                  const uint8_t* __restrict__ mask,   // (C,) bool, HAS_MASK only
                  float* __restrict__ out,            // (B, C/32)
                  int C, int dw, int B, int count, int rt)
{
    using acc_t = typename Acc<K>::type;
    extern __shared__ __align__(16) uint32_t smem[];
    float* Os = reinterpret_cast<float*>(smem + STAGES * STAGE_WORDS);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wr = warp >> 1;   // 0..3: which 32-row subtile of the tile
    const int wq = warp & 1;    // 0..1: which 64-query half of the block
    const int g = lane >> 2;    // fragment row (A, C) / column (B)
    const int t4 = lane & 3;    // fragment word (A, B) / column pair (C)
    const int a_row = wr * SUBTILE + g;  // + 16 per m-tile, + 8 per half
    const int b_row = wq * 64 + g;       // + 8 per n-tile
    const int q0 = blockIdx.y * BN;
    const int nsub = C / SUBTILE;
    const int ld_k = tid & (KW - 1);  // word of the chunk this thread copies
    const int ld_r = tid >> 4;        // first of its 8 rows / queries (step 16)
    const int nchunks = (dw + KW - 1) / KW;
    const int tile0 = blockIdx.x * rt;               // first row tile of this block
    // Only tiles that start below `count` hold a live row; the rest keep the
    // sentinel that Os is prefilled with (right after a capacity bucket grows,
    // that is up to half of the buffer).
    const int live_rows = min(C, count) - tile0 * BM;
    const int tiles_here = max(0, min(rt, (live_rows + BM - 1) / BM));
    const int total = tiles_here * nchunks;          // chunks this block walks
    for (int idx = tid; idx < BN * OLD; idx += THREADS) Os[idx] = MASKED;

    float qscale[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int qq = q0 + wq * 64 + nt * 8 + 2 * t4 + c;
            qscale[nt][c] = (qinv != nullptr && qq < B) ? qinv[qq] : 1.0f;
        }

    // The ring runs over all (row tile, chunk) pairs of the block in order, so
    // the copies for the next row tile are in flight during this one's epilogue.
    int it = 0, ic = 0;  // (tile, chunk) of the next chunk to request
    auto request = [&](int n) {
        if (n < total) {
            uint32_t* as = smem + (n % STAGES) * STAGE_WORDS;
            uint32_t* bs = as + BM * TLD;
            const int row0 = (tile0 + it) * BM;
            if (VEC16) {
                // thread -> (row tid/4 [+64], piece tid%4) of each tile
                const int kw = ic * KW + (tid & 3) * 4;
                const bool kin = kw < dw;
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const int lr = (tid >> 2) + 64 * i;
                    const int r = row0 + lr;
                    const int qq = q0 + lr;
                    const bool oka = kin && r < C;
                    const bool okb = kin && qq < B;
                    cp_async16(&as[lr * TLD + (tid & 3) * 4],
                               oka ? buf + (size_t)r * dw + kw : buf, oka ? 16 : 0);
                    cp_async16(&bs[lr * TLD + (tid & 3) * 4],
                               okb ? q + (size_t)qq * dw + kw : q, okb ? 16 : 0);
                }
            } else {
                const int kw = ic * KW + ld_k;
                const bool kin = kw < dw;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int r = row0 + ld_r + 16 * i;
                    const int qq = q0 + ld_r + 16 * i;
                    const bool oka = kin && r < C;
                    const bool okb = kin && qq < B;
                    cp_async4(&as[(ld_r + 16 * i) * TLD + ld_k],
                              oka ? buf + (size_t)r * dw + kw : buf, oka ? 4 : 0);
                    cp_async4(&bs[(ld_r + 16 * i) * TLD + ld_k],
                              okb ? q + (size_t)qq * dw + kw : q, okb ? 4 : 0);
                }
            }
            if (++ic == nchunks) { ic = 0; ++it; }
        }
        cp_async_commit();  // also when empty: keeps the group count uniform
    };

#pragma unroll
    for (int n = 0; n < STAGES - 1; ++n) request(n);

    acc_t acc[2][8][4];
    int t = 0, c = 0;  // (tile, chunk) being computed
    for (int n = 0; n < total; ++n) {
        cp_async_wait<STAGES - 2>();  // this thread's copies of chunk n landed
        __syncthreads();              // everyone's did; everyone left chunk n-1
        request(n + STAGES - 1);       // refill the stage chunk n-1 occupied

        if (c == 0) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
        }

        const uint32_t* As = smem + (n % STAGES) * STAGE_WORDS;
        const uint32_t* Bs = As + BM * TLD;
        // Two 8-word steps per chunk. Register i of a fragment is the word
        // at (row g [+8], word t4 [+4]) of its 16-row / 8-column tile.
#pragma unroll
        for (int ks = 0; ks < KW / 8; ++ks) {
            uint32_t af[2][4], bf[8][2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int base = (a_row + mt * 16) * TLD + ks * 8 + t4;
                af[mt][0] = As[base];
                af[mt][1] = As[base + 8 * TLD];
                af[mt][2] = As[base + 4];
                af[mt][3] = As[base + 8 * TLD + 4];
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const int base = (b_row + nt * 8) * TLD + ks * 8 + t4;
                bf[nt][0] = Bs[base];
                bf[nt][1] = Bs[base + 4];
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) mma(K{}, acc[mt][nt], af[mt], bf[nt]);
        }

        if (++c < nchunks) continue;

        // Last chunk of row tile t: epilogue in registers. This thread holds,
        // for each of its 16 queries (n-tile nt, column 2*t4 + e), the rows g,
        // g+8, g+16, g+24 of the subtile: accumulator element h*2 + e of
        // m-tile mt.
        const int row0 = (tile0 + t) * BM;
        float iv[2][2];
        bool ok[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = row0 + a_row + mt * 16 + h * 8;
                ok[mt][h] = r < count && r < C;
                iv[mt][h] = 0.0f;
                if (r < C) {
                    iv[mt][h] = inv[r];
                    if (HAS_MASK) ok[mt][h] = ok[mt][h] && (mask[r] != 0);
                }
            }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float m = MASKED;
#pragma unroll
                for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float sc = ok[mt][h]
                            ? scaled(K{}, acc[mt][nt][h * 2 + e], iv[mt][h], qscale[nt][e])
                            : MASKED;
                        m = fmaxf(m, sc);
                    }
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
                m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
                if (g == 0)
                    Os[(wq * 64 + nt * 8 + 2 * t4 + e) * OLD + t * (BM / SUBTILE) + wr] = m;
            }
        c = 0;
        ++t;
    }
    cp_async_wait<0>();

    __syncthreads();
    const int nsb = rt * (BM / SUBTILE);          // subtiles this block covers
    const int sub0 = blockIdx.x * nsb;
    for (int idx = tid; idx < BN * nsb; idx += THREADS) {
        const int ql = idx / nsb;
        const int s = idx - ql * nsb;
        if (q0 + ql < B && sub0 + s < nsub)
            out[(size_t)(q0 + ql) * nsub + sub0 + s] = Os[ql * OLD + s];
    }
}

// K = void launches the float32 kernel, BF16 / I8 the mma kernel.
template <typename K>
int launch(const void* buf, const void* q, const float* inv, const float* qinv,
           const uint8_t* mask, float* out, int C, int dw, int B, int count,
           void* stream)
{
    if (C <= 0 || B <= 0 || dw <= 0 || C % SUBTILE != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (C + BM - 1) / BM;
    const int qblocks = (B + BN - 1) / BN;
    // Walk several row tiles per block (wider output runs) only while that
    // still leaves a few blocks for each of the card's 132 SMs.
    int rt = MAX_RT;
    while (rt > 1 && ((tiles + rt - 1) / rt) * qblocks < 4 * 132) rt >>= 1;
    const dim3 grid((tiles + rt - 1) / rt, qblocks);
    const auto* bw = static_cast<const uint32_t*>(buf);
    const auto* qw = static_cast<const uint32_t*>(q);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_void<K>::value) {
        if (mask != nullptr)
            phase1_f32_kernel<true><<<grid, THREADS, 0, st>>>(
                bw, qw, inv, mask, out, C, dw, B, count, rt);
        else
            phase1_f32_kernel<false><<<grid, THREADS, 0, st>>>(
                bw, qw, inv, mask, out, C, dw, B, count, rt);
    } else {
        // more than the 48 KB a kernel gets without asking
        const bool vec16 = dw % 4 == 0
            && reinterpret_cast<uintptr_t>(buf) % 16 == 0
            && reinterpret_cast<uintptr_t>(q) % 16 == 0;
        auto* kernel = mask != nullptr
            ? (vec16 ? phase1_mma_kernel<K, true, true> : phase1_mma_kernel<K, true, false>)
            : (vec16 ? phase1_mma_kernel<K, false, true> : phase1_mma_kernel<K, false, false>);
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_BYTES);
        if (e != cudaSuccess) return static_cast<int>(e);
        kernel<<<grid, THREADS, MMA_SMEM_BYTES, st>>>(
            bw, qw, inv, qinv, mask, out, C, dw, B, count, rt);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf (C, d) and q (B, d) contiguous, 4-byte aligned; mask may be null. `d`
// is in elements: d*itemsize must be a multiple of 4 (the wrapper checks).
// Each returns cudaGetLastError() after the launch (0 = launched).
extern "C" int phase1_f32(const void* buf, const void* q, const float* inv,
                          const uint8_t* mask, float* out, int C, int d, int B,
                          int count, void* stream)
{
    return launch<void>(buf, q, inv, nullptr, mask, out, C, d, B, count, stream);
}

extern "C" int phase1_bf16(const void* buf, const void* q, const float* inv,
                           const uint8_t* mask, float* out, int C, int d, int B,
                           int count, void* stream)
{
    if (d % 2) return static_cast<int>(cudaErrorInvalidValue);
    return launch<BF16>(buf, q, inv, nullptr, mask, out, C, d / 2, B, count, stream);
}

extern "C" int phase1_i8(const void* buf, const void* qi, const float* inv,
                         const float* qinv, const uint8_t* mask, float* out,
                         int C, int d, int B, int count, void* stream)
{
    if (d % 4 || qinv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch<I8>(buf, qi, inv, qinv, mask, out, C, d / 4, B, count, stream);
}
