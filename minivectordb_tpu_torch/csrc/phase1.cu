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
// and writes out as (B, C/32), every subtile of it. (The TPU kernel writes
// (C/32, B) because its compiler can only regroup the major axis; its caller
// transposes at once.) `count` is a kernel argument, so no scalar upload or
// host sync is needed; any B >= 1 and any C that is a multiple of 32.
//
// What bounds it on an H100: the product is 2*B*C*d operations over C*d
// elements read once. float32 is bound by arithmetic at B = 256: as IEEE
// FMAs on the CUDA cores (67 TFLOP/s) about 2.9 ms of them at 1M x 384, as
// three TF32 products on the tensor cores (3xTF32, 495 TFLOP/s) 1.2 ms,
// against 0.5 ms of memory traffic. bf16 and
// int8 sit on the ridge: at B = 256 a corpus byte feeds 256 bf16 operations
// (the card does 295 per byte of memory bandwidth) or 512 int8 ones (590),
// 0.24 / 0.12 ms of memory and 0.20 / 0.10 ms of tensor-core work. Only
// wgmma reaches the tensor cores' rate, the corpus should cross from device
// memory once, and the products must overlap the stream of corpus bytes.
//
// float32 rows TMA can describe (d a multiple of 4; phase1_tf32_kernel):
// 3xTF32 on wgmma. wgmma reads a float32 word as TF32 and ignores its 13 low
// significand bits, so a word as it lies is its own hi = trunc(x) (rounded
// toward zero), lo = x - hi is exact in float32 and is read truncated in its
// turn, and a product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi summed in
// float32, the small terms first within each k-slab (a_lo b_lo, below 2^-20
// |a| |b|, is dropped). Truncating instead of rounding hi (cvt.rna, as K6-f32
// does) costs about one bit (each word kept to 2^-20 of itself rather than
// 2^-21) and saves rewriting every landed word: nothing but the corpus's lo
// is ever written to shared memory. A subtile maximum lands about 1e-6 from
// the IEEE one on random rows and up to 1e-5 where a row equals its query
// (the tensor cores' float32 accumulation, not the split: it does not round
// to nearest, on a sum of about |row|), inside the 2e-5 the kernel is held to;
// phase 3 rescores the winners in IEEE float32, so the returned scores stay
// IEEE.
// fused_scan.subtile_maxima_3xtf32_plain repeats this arithmetic.
//   - The skeleton is the bf16 kernel's below (persistent warp-specialised
//     blocks, a TMA ring of 128-byte k-slabs, 32 floats = four k8 steps, in
//     the 128-byte swizzle; mbarriers; the inv side ring; the epilogue), with
//     queries as A (M = 64 a warpgroup's m-tile) and corpus rows as B (N =
//     128 rows a tile), both K-major as TF32 wgmma requires.
//   - Shared memory decides the shape. A query's hi and lo words take 3 KB
//     at d = 384, so not even 64 queries' stay resident beside a ring: each
//     stage carries the block's query slab beside the corpus slab, and all of
//     B = 256 sit in one block (two consumer warpgroups of two m-tiles each,
//     128 accumulators a thread), so each corpus tile leaves device memory and
//     L2 once and is split once. A stage is the corpus slab (16 KB, its hi),
//     its lo (16 KB) and the query slab (up to 32 KB): three stages at B =
//     256. L2 reads a launch at 1M x 384, B = 256: the corpus once (1.5 GB)
//     and the queries once per tile (7,813 x 393 KB = 3.1 GB), 4.6 GB (the
//     CUDA-core kernel read the corpus once per 128-query block, 3.1 GB).
//   - The corpus's lo words are made by three helper warps of the producer
//     warpgroup into the stage (a "ready" mbarrier a stage), at the same
//     swizzled offsets as the landed words. The queries' lo words never touch
//     shared memory: each consumer thread reads its A fragments of the slab
//     (16 words an m-tile), forms lo in registers and issues lo b_hi with A
//     from registers; a_hi b_lo and a_hi b_hi read A from the slab itself.
//   - Registers: 128 accumulators and 32 lo words a consumer thread. The
//     producer warpgroup hands registers to the consumers with setmaxnreg
//     (56 / 224 of the 168 a thread that 384 threads leave: 128 * 56 +
//     256 * 224 = 384 * 168), so nothing spills.
//   - Shapes: B <= 64 takes one consumer warpgroup of one m-tile (256
//     threads, no register trade), B <= 128 two of one, more two of two;
//     beyond 256 queries consecutive blocks take the query blocks of a tile.
// float32 rows TMA cannot describe (d not a multiple of 4; phase1_f32_kernel):
// IEEE FMAs on the CUDA cores. A block owns 128 rows x 128 queries and walks
// d in chunks of 16 words through shared memory, stored k-major; a thread
// keeps an 8 x 8 register tile, so every word it reads from shared memory
// feeds 8 FMAs; the next chunk is loaded into registers during this one's
// arithmetic; a warp owns one 32-row subtile by 64 queries, so the subtile
// max never leaves the warp; a block walks up to 8 row tiles and stages its
// maxima, so each query's output leaves as one 128-byte run; row tiles that
// start at or past `count` are skipped; two 256-thread blocks fit on an SM.
// The route is chosen by row width alone (phase1_route), as for bf16 / int8.
//
// bf16 / int8 whose rows TMA can describe (d * itemsize a multiple of 16
// bytes; phase1_wgmma_kernel): persistent, warp-specialised blocks, one per
// SM.
//   - Queries are wgmma's A operand (M = 64 per consumer warpgroup; 1, 2 or
//     4 warpgroups: 64 .. 256 queries a block), corpus rows its B operand (a
//     tile of N = 256 rows, or 128 with 4 warpgroups, whose accumulators
//     would not fit, or where 256-row stages would leave the ring too short);
//     both K-major, which is how rows lie in memory and what int8 wgmma
//     requires. Products are wgmma.mma_async m64nNk16 .f32.bf16.bf16 or
//     m64nNk32 .s32.s8.s8 with both operands read from shared memory; a
//     128-byte k-slab of a row (64 bf16, 128 int8) is four k-steps for
//     either type, so one skeleton serves both. N = 256 halves the barrier
//     round trips and the query reads from shared memory per product, which
//     bound the 128-row version's consumers at B = 256.
//   - The block's queries are loaded once, by TMA, and stay resident in
//     shared memory for all its corpus tiles (at d = 384: 128 bf16 queries or
//     256 int8 ones, 96 KB). The host picks the queries per block so that the
//     tile fits beside a ring of at least 4 stages; where not even 64 fit
//     (bf16 beyond d = 1,280) each stage carries the query slab beside the
//     corpus slab instead.
//   - One producer warp has TMA load 128-byte k-slabs of the corpus tile (16
//     or 32 KB, 128-byte swizzle) into a ring of up to 8 stages, with a
//     "full" and an "empty" mbarrier per stage; the ring runs on across the
//     block's tiles, so one tile's epilogue overlaps the next tile's loads.
//     TMA's zero fill covers rows >= C and k >= d. A tile ahead, its lanes
//     load the tile's inv and mask bytes and store inv into a 2-slot side
//     ring, NaN for a row at or past `count` or masked out.
//   - Where B needs more than one query block, consecutive blocks take the
//     query blocks of one tile, so each tile leaves device memory once and
//     the other reads hit L2. (Thread-block clusters that multicast each
//     slab to the blocks of one tile, one L2 read per corpus byte, were
//     correct but slower in every case measured: the consumers, not L2,
//     bound the kernel, and the cluster couples the blocks' rings.)
//   - Tiles that start at or past `count` hold no live row and get the
//     sentinel without any arithmetic.
//   - Epilogue in registers: a thread holds, for two queries, columns
//     8j + 2(lane % 4) + {0, 1} of the tile; a 32-row subtile is four of its
//     n8 groups: scale by inv (NaN drops out of fmaxf, so a subtile with no
//     live row keeps -3.0e38 and the mask costs nothing here), an in-thread
//     max of 8 values, then a two-step transposed reduction across the quad
//     (3 shuffles per query and 4 subtiles) leaves lane i with subtile i, so
//     each query's maxima leave as 16-byte runs, no shared-memory round trip.
//   - Host: the shared-memory attribute, the SM count and the blocks the
//     card holds at once are set up once per device; the tensor maps are
//     encoded per call through cudaGetDriverEntryPoint (no -lcuda).
// bf16 / int8 rows TMA cannot describe (d * itemsize not a multiple of 16,
// e.g. int8 at d = 24; phase1_mma_kernel): the route is chosen by row width
// alone (phase1_route). A block owns 128 rows x 128 queries; chunks of 16 words arrive
// through a 4-stage cp.async ring (4-byte copies) and feed mma.sync m16n8k16
// (bf16) / m16n8k32 (int8) from 32-bit shared-memory fragments, a warp owning
// one 32-row subtile by 64 queries. The wrapper asks phase1_route which
// kernel a launch took and counts the narrow one's launches apart.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libphase1.so phase1.cu

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // corpus rows per tile (f32 and narrow kernels)
constexpr int BN = 128;       // queries per block (f32 and narrow kernels)
constexpr int KW = 16;        // 32-bit words of a row per chunk
constexpr int THREADS = 256;  // 8 warps: 4 subtiles x 2 query halves
constexpr int SUBTILE = 32;   // rows per max group
constexpr int MAX_RT = 8;     // row tiles a block walks
constexpr int LDS = BM + 4;   // f32 kernel: shared stride of a k-row (BM == BN)
constexpr int TLD = KW + 4;   // mma kernel: shared stride of a corpus/query row
constexpr int OLD = MAX_RT * (BM / SUBTILE) + 1;  // staged-output stride
constexpr float MASKED = -3.0e38f;
constexpr int MAX_DEVICES = 64;

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
// The wgmma kernel takes the max over a subtile's rows before the query's
// scale: a product with qinv > 0 (1 / the query's norm) rounds monotonically,
// so max(round(y * qinv)) == round(max(y) * qinv), bit for bit, with one
// multiply per subtile instead of one per row.
__device__ __forceinline__ float row_scaled(BF16, float acc, float inv) { return acc * inv; }
__device__ __forceinline__ float row_scaled(I8, int acc, float inv) {
    return __fmul_rn(static_cast<float>(acc), inv);
}
__device__ __forceinline__ float query_scaled(BF16, float m, float) { return m; }
__device__ __forceinline__ float query_scaled(I8, float m, float qinv) {
    return m == MASKED ? MASKED : __fmul_rn(m, qinv);
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
// bfloat16 / int8 rows TMA cannot describe: mma.sync fed by a cp.async ring
// ---------------------------------------------------------------------------

// Copy 4 bytes global -> shared without passing through registers; with
// src_bytes == 0 nothing is read and the word is zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

template <typename K, bool HAS_MASK>
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
    // sentinel that Os is prefilled with.
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


// ---------------------------------------------------------------------------
// bfloat16 / int8 rows TMA can describe: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

// A tile is TN corpus rows (wgmma's N): 128, or 256 where the accumulators
// fit (at most 2 consumer warpgroups) and the ring keeps MIN_STAGES stages.
constexpr int SLAB = 128;                 // bytes of a row per k-slab: the swizzle span
constexpr int KSTEPS = 4;                 // wgmma k-steps per slab (32 bytes each)
constexpr int MIN_STAGES = 4, MAX_STAGES = 8;
constexpr int NINFO = 2;                  // slots of the tiles' inv (NaN where not live)
constexpr int BAR_BYTES = (2 * MAX_STAGES + 2 * NINFO + 1) * 8;
constexpr int SMEM_LIMIT = 232448;        // dynamic shared memory a block may have

// What the host decides per launch (see make_plan); offsets are from the
// 1024-aligned start of the block's shared memory.
struct Plan {
    int C, B, count;
    int ks;          // k-slabs of a row
    int resident;    // 1: the query tile stays in shared memory; 0: it streams
    int stages;      // ring stages
    int stage_bytes; // a corpus slab (+ the block's query slab when streaming)
    int qblocks;     // query blocks
    int per_qblock;  // blocks walking the tiles for one query block
    int live_tiles;  // tiles that start below min(count, C)
    int tiles;       // all tiles of C
    int ring, info, bars;  // shared-memory offsets
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
// waits until the phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}
// TMA: the box of a 2-d tensor map at (element x, row y) into shared memory
// at dst, completing on the mbarrier at bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
        : "memory");
}
// wgmma matrix descriptor of a K-major tile in the 128-byte swizzle that TMA
// writes: rows of 128 bytes, 8-row core groups 1024 bytes apart (stride byte
// offset), leading byte offset unused (1); addr 1024-aligned, or 32 bytes
// per k-step past such an address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups of this warp are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across wgmma_wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define WG_ACC64(c) \
    c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), \
    c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
    c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
    c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), \
    c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), \
    c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), \
    c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), \
    c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])
#define WG_REGS64 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_ACC128(c) \
    c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), \
    c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), \
    c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), \
    c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), \
    c(d[33]), c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), \
    c(d[41]), c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), \
    c(d[49]), c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), \
    c(d[57]), c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63]), c(d[64]), \
    c(d[65]), c(d[66]), c(d[67]), c(d[68]), c(d[69]), c(d[70]), c(d[71]), c(d[72]), \
    c(d[73]), c(d[74]), c(d[75]), c(d[76]), c(d[77]), c(d[78]), c(d[79]), c(d[80]), \
    c(d[81]), c(d[82]), c(d[83]), c(d[84]), c(d[85]), c(d[86]), c(d[87]), c(d[88]), \
    c(d[89]), c(d[90]), c(d[91]), c(d[92]), c(d[93]), c(d[94]), c(d[95]), c(d[96]), \
    c(d[97]), c(d[98]), c(d[99]), c(d[100]), c(d[101]), c(d[102]), c(d[103]), \
    c(d[104]), c(d[105]), c(d[106]), c(d[107]), c(d[108]), c(d[109]), c(d[110]), \
    c(d[111]), c(d[112]), c(d[113]), c(d[114]), c(d[115]), c(d[116]), c(d[117]), \
    c(d[118]), c(d[119]), c(d[120]), c(d[121]), c(d[122]), c(d[123]), c(d[124]), \
    c(d[125]), c(d[126]), c(d[127])
#define WG_REGS128 \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
    "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
    "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
    "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
    "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (64 x N) = A (64 x k-step, shared) * B (k-step x N, shared) [+ d when
// accumulate], both K-major: bf16 (k-step 16) summed in float32, int8
// (k-step 32) summed exactly in int32; N = 128 or 256
template <int N, typename T>
__device__ void wgmma(T, typename Acc<T>::type (&d)[N / 2], uint64_t da, uint64_t db,
                      bool accumulate);

template <>
__device__ __forceinline__ void wgmma<128>(BF16, float (&d)[64], uint64_t da, uint64_t db,
                                           bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC64("+f")
        : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
template <>
__device__ __forceinline__ void wgmma<256>(BF16, float (&d)[128], uint64_t da, uint64_t db,
                                           bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_REGS128
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC128("+f")
        : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
template <>
__device__ __forceinline__ void wgmma<128>(I8, int (&d)[64], uint64_t da, uint64_t db,
                                           bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_REGS64
        ", %64, %65, p;\n}\n"
        : WG_ACC64("+r")
        : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
template <>
__device__ __forceinline__ void wgmma<256>(I8, int (&d)[128], uint64_t da, uint64_t db,
                                           bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_REGS128
        ", %128, %129, p;\n}\n"
        : WG_ACC128("+r")
        : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
// d (64 x 128, float32) [+]= A (64 x 8) * B (8 x 128), each float32 word read
// as TF32 (its 13 low significand bits ignored); B K-major in shared memory,
// A K-major in shared memory (tf32_ss) or wgmma's register fragment (tf32_rs)
__device__ __forceinline__ void tf32_ss(float (&d)[64], uint64_t da, uint64_t db,
                                        bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS64
        ", %64, %65, p, 1, 1;\n}\n"
        : WG_ACC64("+f")
        : "l"(da), "l"(db), "r"(static_cast<int>(accumulate)));
}
__device__ __forceinline__ void tf32_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                        bool accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_REGS64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_ACC64("+f")
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(static_cast<int>(accumulate)));
}
#undef WG_ACC64
#undef WG_REGS64
#undef WG_ACC128
#undef WG_REGS128

template <typename K, int WG, int TN>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
phase1_wgmma_kernel(const __grid_constant__ CUtensorMap tbuf,  // corpus (C, d)
                    const __grid_constant__ CUtensorMap tq,    // queries (B, d)
                    const float* __restrict__ inv,             // (C,), 16-byte aligned
                    const float* __restrict__ qinv,            // (B,) int8 only
                    const uint8_t* __restrict__ mask,          // (C,) bool or null
                    float* __restrict__ out,                   // (B, C/32)
                    const Plan p)
{
    using acc_t = typename Acc<K>::type;
    constexpr int CONSUMERS = WG * 128;
    constexpr int QB = WG * 64;            // queries of the block
    constexpr int QSLAB = QB * SLAB;       // bytes of one k-slab of them
    constexpr int EPS = std::is_same<K, I8>::value ? SLAB : SLAB / 2;  // elements a slab
    constexpr int SLAB_BYTES = TN * SLAB;  // one corpus slab: 16 or 32 KB
    constexpr int INFO_BYTES = TN * 4;     // one tile's inv
    constexpr int SUBS = TN / SUBTILE;     // subtiles of a tile
    // The 128-byte swizzle repeats every 1024 bytes and the wgmma descriptors
    // assume tiles on such boundaries: dynamic shared memory starts on one.
    extern __shared__ __align__(1024) unsigned char shm[];
    const uint32_t sbase = smem_u32(shm);
    if (sbase % 1024 != 0) __trap();
    const uint32_t ring = sbase + p.ring;
    const uint32_t info = sbase + p.info;
    const uint32_t bars = sbase + p.bars;
    // barriers: full[MAX_STAGES], empty[MAX_STAGES], ifull[NINFO], iempty[NINFO], qfull
    const uint32_t full = bars, empty = bars + 8 * MAX_STAGES;
    const uint32_t ifull = bars + 16 * MAX_STAGES, iempty = ifull + 8 * NINFO;
    const uint32_t qfull = iempty + 8 * NINFO;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    // Consecutive blocks take the query blocks of one tile, so they read it
    // from device memory once and from L2 the other times.
    const int j0 = blockIdx.x / p.qblocks;            // the block's first tile
    const int q0 = (blockIdx.x % p.qblocks) * QB;     // and first query

    if (tid == 0) {
        for (int s = 0; s < p.stages; ++s) {
            mbar_init(full + 8 * s, 1);                       // the producer's expect_tx
            mbar_init(empty + 8 * s, CONSUMERS / 32);         // every consumer warp
        }
        for (int i = 0; i < NINFO; ++i) {
            mbar_init(ifull + 8 * i, 32);                     // the producer lanes' stores
            mbar_init(iempty + 8 * i, CONSUMERS / 32);
        }
        mbar_init(qfull, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ------------------------------ producer warp
        if (lane == 0 && p.resident) {
            mbar_expect_tx(qfull, p.ks * QSLAB);
            for (int k = 0; k < p.ks; ++k) tma_load(sbase + k * QSLAB, &tq, k * EPS, q0, qfull);
        }
        const int lim = min(p.count, p.C);
        // inv and mask bytes of rows 128 j + 4 lane .. + 3 of the next tile (C
        // is a multiple of 32), loaded a tile ahead
        float4 nv[TN / 128];
        uint32_t nm[TN / 128];
        auto fetch = [&](int t) {
#pragma unroll
            for (int j = 0; j < TN / 128; ++j) {
                const int r = t * TN + 128 * j + 4 * lane;
                nv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
                nm[j] = 0;
                if (t < p.live_tiles && r < p.C) {
                    nv[j] = __ldg(reinterpret_cast<const float4*>(inv + r));
                    nm[j] = mask != nullptr ? __ldg(reinterpret_cast<const uint32_t*>(mask + r))
                                            : 0x01010101u;
                }
            }
        };
        fetch(j0);
        int n = 0, i = 0;
        for (int t = j0; t < p.live_tiles; t += p.per_qblock, ++i) {
            const int row0 = t * TN;
            const int slot = i % NINFO;
            mbar_wait(iempty + 8 * slot, ((i / NINFO) & 1) ^ 1);
            {   // a row that is not live gets NaN, which fmaxf passes over
                const float nan = __int_as_float(0x7fffffff);
#pragma unroll
                for (int j = 0; j < TN / 128; ++j) {
                    const int r = row0 + 128 * j + 4 * lane;
                    const uint32_t m = nm[j];
                    const float4 v = make_float4(
                        r < lim && (m & 0xFFu) ? nv[j].x : nan,
                        r + 1 < lim && (m & 0xFF00u) ? nv[j].y : nan,
                        r + 2 < lim && (m & 0xFF0000u) ? nv[j].z : nan,
                        r + 3 < lim && (m >> 24) ? nv[j].w : nan);
                    *reinterpret_cast<float4*>(shm + p.info + slot * INFO_BYTES + 512 * j +
                                               16 * lane) = v;
                }
                mbar_arrive(ifull + 8 * slot);
                fetch(t + p.per_qblock);
            }
            for (int k = 0; k < p.ks; ++k, ++n) {
                const int s = n % p.stages;
                mbar_wait(empty + 8 * s, ((n / p.stages) & 1) ^ 1);
                if (lane == 0) {
                    const uint32_t st = ring + s * p.stage_bytes;
                    mbar_expect_tx(full + 8 * s, SLAB_BYTES + (p.resident ? 0 : QSLAB));
                    tma_load(st, &tbuf, k * EPS, row0, full + 8 * s);
                    if (!p.resident) tma_load(st + SLAB_BYTES, &tq, k * EPS, q0, full + 8 * s);
                }
            }
        }
        __syncwarp();
    } else {
        // ------------------------------ consumer warpgroups
        const int warp = tid >> 5;
        const int wg = warp >> 2;
        const int g = lane >> 2, t4 = lane & 3;
        const int qr = wg * 64 + (warp & 3) * 16 + g;  // this thread's queries: qr, qr + 8
        const int nsub = p.C / SUBTILE;
        float qs[2] = {1.0f, 1.0f};
        if (qinv != nullptr) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (q0 + qr + 8 * h < p.B) qs[h] = qinv[q0 + qr + 8 * h];
        }
        if (p.resident) mbar_wait(qfull, 0);
        // a release: after this warp's products that read the stage are done
        auto release = [&](int s) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
        };

        acc_t acc[TN / 2];
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) acc[e] = 0;
        int n = 0, i = 0;
        for (int t = j0; t < p.live_tiles; t += p.per_qblock, ++i) {
            int prev = 0;
            for (int k = 0; k < p.ks; ++k, ++n) {
                const int s = n % p.stages;
                mbar_wait(full + 8 * s, (n / p.stages) & 1);
                const uint32_t st = ring + s * p.stage_bytes;
                const uint32_t a = (p.resident ? sbase + k * QSLAB : st + SLAB_BYTES)
                                 + wg * 64 * SLAB;
                const uint64_t da = desc_sw128(a), db = desc_sw128(st);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < KSTEPS; ++kk)  // 32 bytes a k-step: 2 in 16-byte units
                    wgmma<TN>(K{}, acc, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
                wgmma_commit();
                if (k > 0) {
                    wgmma_wait<1>();  // the slab before is done
                    release(prev);
                }
                prev = s;
            }
            wgmma_wait<0>();
            fence_regs(acc);
            release(prev);

            // Epilogue. acc[4 nt + 2 h + e] is (query qr + 8 h, row 8 nt + 2 t4 + e
            // of the tile); subtile sb is n8 groups 4 sb .. 4 sb + 3.
            const int slot = i % NINFO;
            mbar_wait(ifull + 8 * slot, (i / NINFO) & 1);
            const float* iv = reinterpret_cast<const float*>(shm + p.info + slot * INFO_BYTES);
            // the scores of rows that are not live are NaN (their inv), which
            // fmaxf passes over: a subtile without a live row keeps MASKED
            float m[2][SUBS];
#pragma unroll
            for (int sb = 0; sb < SUBS; ++sb) {
                m[0][sb] = MASKED;
                m[1][sb] = MASKED;
#pragma unroll
                for (int nn = 0; nn < 4; ++nn) {
                    const int nt = 4 * sb + nn;
                    const float2 sc = *reinterpret_cast<const float2*>(iv + 8 * nt + 2 * t4);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        m[h][sb] = fmaxf(m[h][sb],
                                         fmaxf(row_scaled(K{}, acc[4 * nt + 2 * h], sc.x),
                                               row_scaled(K{}, acc[4 * nt + 2 * h + 1], sc.y)));
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(iempty + 8 * slot);
            // Across the quad, transposed, four subtiles at a time: after the
            // xor-2 step a lane keeps subtiles (t4 & 2) + {0, 1} of the four,
            // after the xor-1 step subtile t4.
            const bool hi = (t4 & 2) != 0, lo = (t4 & 1) != 0;
#pragma unroll
            for (int f = 0; f < SUBS; f += 4) {
                const int sub = SUBS * t + f + t4;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const float* v = m[h] + f;
                    const float a0 = fmaxf(hi ? v[2] : v[0],
                                           __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2));
                    const float a1 = fmaxf(hi ? v[3] : v[1],
                                           __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2));
                    const float r = fmaxf(lo ? a1 : a0, __shfl_xor_sync(0xffffffffu, lo ? a0 : a1, 1));
                    const int q = q0 + qr + 8 * h;
                    if (q < p.B && sub < nsub) out[(size_t)q * nsub + sub] = query_scaled(K{}, r, qs[h]);
                }
            }
        }

        // tiles at or past count: the sentinel, shared out like the live ones
        for (int t = p.live_tiles + j0; t < p.tiles; t += p.per_qblock)
            for (int idx = tid; idx < QB * SUBS; idx += CONSUMERS) {
                const int q = q0 + idx / SUBS, sub = SUBS * t + idx % SUBS;
                if (q < p.B && sub < nsub) out[(size_t)q * nsub + sub] = MASKED;
            }
    }
}

// ---------------------------------------------------------------------------
// float32 rows TMA can describe: 3xTF32 on wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

constexpr int TF_TN = 128;      // corpus rows a tile (wgmma's N)
constexpr int TF_HELPERS = 96;  // the producer warpgroup's other warps: the corpus's lo words
// barriers: full, empty and ready a stage; ifull and iempty an info slot
constexpr int TF_BAR_BYTES = (3 * MAX_STAGES + 2 * NINFO) * 8;

// WG consumer warpgroups of MT m-tiles (64 queries) each, and a producer
// warpgroup: one warp loads, the other three (helpers) write the corpus's lo
// words. With two consumer warpgroups the producer warpgroup hands registers
// to them (setmaxnreg); the split must fit the 168 registers a thread that
// __launch_bounds__(384, 1) leaves, or the consumers would wait forever. One
// warpgroup (256 threads) has 255 a thread and trades none.
template <int WG, int MT>
struct Tf32Cfg {
    static constexpr int CONSUMERS = WG * 128;
    static constexpr int THREADS = CONSUMERS + 128;
    static constexpr int QB = WG * MT * 64;  // queries of a block
    static constexpr bool TRADE = WG > 1;
    static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
    static constexpr int REGS = TRADE ? 128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS : 0;
    static_assert(REGS <= THREADS * (65536 / THREADS / 8 * 8),
                  "the register split exceeds what the block holds");
};

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// x less x read as TF32 (its 13 low significand bits cleared): exact in float32
__device__ __forceinline__ float tf32_rest(float x) {
    return x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}

template <int WG, int MT>
__global__ void __launch_bounds__(Tf32Cfg<WG, MT>::THREADS, 1)
phase1_tf32_kernel(const __grid_constant__ CUtensorMap tbuf,  // corpus (C, d) float32
                   const __grid_constant__ CUtensorMap tq,    // queries (B, d) float32
                   const float* __restrict__ inv,             // (C,), 16-byte aligned
                   const uint8_t* __restrict__ mask,          // (C,) bool or null
                   float* __restrict__ out,                   // (B, C/32)
                   const Plan p)
{
    using Cfg = Tf32Cfg<WG, MT>;
    constexpr int CONSUMERS = Cfg::CONSUMERS, QB = Cfg::QB, TN = TF_TN;
    constexpr int SLAB_BYTES = TN * SLAB;  // a corpus slab, as landed (hi) or its lo: 16 KB
    constexpr int EPS = SLAB / 4;          // floats a slab row
    constexpr int INFO_BYTES = TN * 4;     // one tile's inv
    constexpr int SUBS = TN / SUBTILE;     // subtiles of a tile
    static_assert(SUBS == 4, "the epilogue's quad reduction takes four subtiles a tile");
    extern __shared__ __align__(1024) unsigned char shm[];
    const uint32_t sbase = smem_u32(shm);
    if (sbase % 1024 != 0) __trap();
    const uint32_t ring = sbase + p.ring;
    const uint32_t bars = sbase + p.bars;
    // a stage: the corpus slab (hi), its lo, the block's query slab
    const uint32_t full = bars, empty = bars + 8 * MAX_STAGES, ready = bars + 16 * MAX_STAGES;
    const uint32_t ifull = bars + 24 * MAX_STAGES, iempty = ifull + 8 * NINFO;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int j0 = blockIdx.x / p.qblocks;         // the block's first tile
    const int q0 = (blockIdx.x % p.qblocks) * QB;  // and first query

    if (tid == 0) {
        for (int s = 0; s < p.stages; ++s) {
            mbar_init(full + 8 * s, 1);                      // the producer's expect_tx
            mbar_init(empty + 8 * s, CONSUMERS / 32);        // every consumer warp
            mbar_init(ready + 8 * s, TF_HELPERS / 32);       // every helper warp
        }
        for (int i = 0; i < NINFO; ++i) {
            mbar_init(ifull + 8 * i, 32);                    // the producer lanes' stores
            mbar_init(iempty + 8 * i, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // One branch a role, never joined again: ptxas then knows each side's
    // register count from its setmaxnreg.
    if (tid >= CONSUMERS) {
        if constexpr (Cfg::TRADE) setmaxnreg_dec<Cfg::PRODUCER_REGS>();
        if (tid < CONSUMERS + 32) {
            // ------------------------------ the loading warp
            const int lim = min(p.count, p.C);
            // inv and mask bytes of rows 4 lane .. + 3 of the next tile,
            // loaded a tile ahead
            float4 nv;
            uint32_t nm;
            auto fetch = [&](int t) {
                const int r = t * TN + 4 * lane;
                nv = make_float4(0.f, 0.f, 0.f, 0.f);
                nm = 0;
                if (t < p.live_tiles && r < p.C) {
                    nv = __ldg(reinterpret_cast<const float4*>(inv + r));
                    nm = mask != nullptr ? __ldg(reinterpret_cast<const uint32_t*>(mask + r))
                                         : 0x01010101u;
                }
            };
            fetch(j0);
            int n = 0, i = 0;
            for (int t = j0; t < p.live_tiles; t += p.per_qblock, ++i) {
                const int row0 = t * TN;
                const int slot = i % NINFO;
                mbar_wait(iempty + 8 * slot, ((i / NINFO) & 1) ^ 1);
                {   // a row that is not live gets NaN, which fmaxf passes over
                    const float nan = __int_as_float(0x7fffffff);
                    const int r = row0 + 4 * lane;
                    const float4 v = make_float4(
                        r < lim && (nm & 0xFFu) ? nv.x : nan,
                        r + 1 < lim && (nm & 0xFF00u) ? nv.y : nan,
                        r + 2 < lim && (nm & 0xFF0000u) ? nv.z : nan,
                        r + 3 < lim && (nm >> 24) ? nv.w : nan);
                    *reinterpret_cast<float4*>(shm + p.info + slot * INFO_BYTES + 16 * lane) = v;
                    mbar_arrive(ifull + 8 * slot);
                    fetch(t + p.per_qblock);
                }
                for (int k = 0; k < p.ks; ++k, ++n) {
                    const int s = n % p.stages;
                    mbar_wait(empty + 8 * s, ((n / p.stages) & 1) ^ 1);
                    if (lane == 0) {
                        const uint32_t st = ring + s * p.stage_bytes;
                        mbar_expect_tx(full + 8 * s, SLAB_BYTES + QB * SLAB);
                        tma_load(st, &tbuf, k * EPS, row0, full + 8 * s);
                        tma_load(st + 2 * SLAB_BYTES, &tq, k * EPS, q0, full + 8 * s);
                    }
                }
            }
            __syncwarp();
            return;
        }
        // ------------------------------ helpers: each landed corpus slab's lo
        // words, at the landed words' (swizzled) offsets
        const int h = tid - CONSUMERS - 32;
        int n = 0;
        for (int t = j0; t < p.live_tiles; t += p.per_qblock)
            for (int k = 0; k < p.ks; ++k, ++n) {
                const int s = n % p.stages;
                mbar_wait(full + 8 * s, (n / p.stages) & 1);
                const float4* hi =
                    reinterpret_cast<const float4*>(shm + p.ring + s * p.stage_bytes);
                float4* lo = reinterpret_cast<float4*>(shm + p.ring + s * p.stage_bytes + SLAB_BYTES);
#pragma unroll 4
                for (int u = h; u < SLAB_BYTES / 16; u += TF_HELPERS) {
                    const float4 x = hi[u];
                    lo[u] = make_float4(tf32_rest(x.x), tf32_rest(x.y), tf32_rest(x.z),
                                        tf32_rest(x.w));
                }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before wgmma reads
                __syncwarp();
                if (lane == 0) mbar_arrive(ready + 8 * s);
            }
        return;
    }
    if constexpr (Cfg::TRADE) setmaxnreg_inc<Cfg::CONSUMER_REGS>();

    // ------------------------------ consumer warpgroups
    const int warp = tid >> 5;
    const int wg = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    const int nsub = p.C / SUBTILE;
    // a release: after this warp is done with what the barrier guards
    auto release = [&](uint32_t bar) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
    };
    // this thread's queries in m-tile mt: row(mt), row(mt) + 8 of the block's
    auto row = [&](int mt) { return (wg * MT + mt) * 64 + (warp & 3) * 16 + g; };

    float acc[MT][TN / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < TN / 2; ++e) acc[mt][e] = 0.f;
    uint32_t qlo[MT][KSTEPS][4];  // the queries' lo words: wgmma's A fragments
    int n = 0, i = 0;
    for (int t = j0; t < p.live_tiles; t += p.per_qblock, ++i) {
        int prev = 0;
        for (int k = 0; k < p.ks; ++k, ++n) {
            const int s = n % p.stages;
            mbar_wait(full + 8 * s, (n / p.stages) & 1);
            mbar_wait(ready + 8 * s, (n / p.stages) & 1);
            if (k > 0) {
                wgmma_wait<0>();  // the slab before is done, and with it qlo
                release(empty + 8 * prev);
            }
            const uint32_t st = ring + s * p.stage_bytes;
            // A fragment word e of k-step kk: query row(mt) + 8 (e & 1), column
            // 8 kk + t4 + 4 (e >> 1) of the slab, in the 128-byte swizzle (16-byte
            // chunks XOR the row's index mod 8, here g)
            const unsigned char* qslab = shm + p.ring + s * p.stage_bytes + 2 * SLAB_BYTES;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int c = 8 * kk + t4 + 4 * (e >> 1);
                        const int off = (row(mt) + 8 * (e & 1)) * SLAB + (((c >> 2) ^ g) << 4) +
                                        ((c & 3) << 2);
                        qlo[mt][kk][e] =
                            __float_as_uint(tf32_rest(*reinterpret_cast<const float*>(qslab + off)));
                    }
            wgmma_fence();
            // a_lo b_hi, a_hi b_lo, then a_hi b_hi: the small terms first
            const uint64_t dhi = desc_sw128(st), dlo = desc_sw128(st + SLAB_BYTES);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int kk = 0; kk < KSTEPS; ++kk)  // 32 bytes a k-step: 2 in 16-byte units
                    tf32_rs(acc[mt], qlo[mt][kk], dhi + 2 * kk, k > 0 || kk > 0);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const uint64_t dq = desc_sw128(st + 2 * SLAB_BYTES + (wg * MT + mt) * 64 * SLAB);
#pragma unroll
                for (int kk = 0; kk < KSTEPS; ++kk) tf32_ss(acc[mt], dq + 2 * kk, dlo + 2 * kk, true);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                const uint64_t dq = desc_sw128(st + 2 * SLAB_BYTES + (wg * MT + mt) * 64 * SLAB);
#pragma unroll
                for (int kk = 0; kk < KSTEPS; ++kk) tf32_ss(acc[mt], dq + 2 * kk, dhi + 2 * kk, true);
            }
            wgmma_commit();
            prev = s;
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        release(empty + 8 * prev);

        // Epilogue, as the bf16 kernel's: acc[mt][4 nt + 2 h + e] is (query
        // row(mt) + 8 h, row 8 nt + 2 t4 + e of the tile); subtile sb is n8
        // groups 4 sb .. 4 sb + 3; rows that are not live have a NaN inv
        const int slot = i % NINFO;
        mbar_wait(ifull + 8 * slot, (i / NINFO) & 1);
        const float* iv = reinterpret_cast<const float*>(shm + p.info + slot * INFO_BYTES);
        float m[MT][2][SUBS];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int sb = 0; sb < SUBS; ++sb) {
                m[mt][0][sb] = MASKED;
                m[mt][1][sb] = MASKED;
#pragma unroll
                for (int nn = 0; nn < 4; ++nn) {
                    const int nt = 4 * sb + nn;
                    const float2 sc = *reinterpret_cast<const float2*>(iv + 8 * nt + 2 * t4);
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        m[mt][h][sb] = fmaxf(m[mt][h][sb],
                                             fmaxf(acc[mt][4 * nt + 2 * h] * sc.x,
                                                   acc[mt][4 * nt + 2 * h + 1] * sc.y));
                }
            }
        release(iempty + 8 * slot);
        // across the quad, transposed: lane t4 keeps subtile t4 of the four
        const bool hi = (t4 & 2) != 0, lo = (t4 & 1) != 0;
        const int sub = SUBS * t + t4;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float* v = m[mt][h];
                const float a0 = fmaxf(hi ? v[2] : v[0],
                                       __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2));
                const float a1 = fmaxf(hi ? v[3] : v[1],
                                       __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2));
                const float r = fmaxf(lo ? a1 : a0, __shfl_xor_sync(0xffffffffu, lo ? a0 : a1, 1));
                const int q = q0 + row(mt) + 8 * h;
                if (q < p.B && sub < nsub) out[(size_t)q * nsub + sub] = r;
            }
    }

    // tiles at or past count: the sentinel, shared out like the live ones
    for (int t = p.live_tiles + j0; t < p.tiles; t += p.per_qblock)
        for (int idx = tid; idx < QB * SUBS; idx += CONSUMERS) {
            const int q = q0 + idx / SUBS, sub = SUBS * t + idx % SUBS;
            if (q < p.B && sub < nsub) out[(size_t)q * nsub + sub] = MASKED;
        }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The card's SM count, once per device.
int sm_count(int& sms) {
    static int cache[MAX_DEVICES];
    int dev;
    if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (cache[dev] == 0) {
        if (cudaError_t e = cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount, dev))
            return static_cast<int>(e);
    }
    sms = cache[dev];
    return 0;
}

// The narrow-row kernels: K = void launches float32's CUDA-core kernel,
// BF16 / I8 the mma.sync kernel.
template <typename K>
int launch_blocks(const void* buf, const void* q, const float* inv, const float* qinv,
                  const uint8_t* mask, float* out, int C, int dw, int B, int count,
                  void* stream)
{
    if (C <= 0 || B <= 0 || dw <= 0 || C % SUBTILE != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int sms;
    if (int e = sm_count(sms)) return e;
    const int tiles = (C + BM - 1) / BM;
    const int qblocks = (B + BN - 1) / BN;
    // Walk several row tiles per block (wider output runs) only while that
    // still leaves a few blocks for each SM.
    int rt = MAX_RT;
    while (rt > 1 && ((tiles + rt - 1) / rt) * qblocks < 4 * sms) rt >>= 1;
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
        auto* kernel = mask != nullptr ? phase1_mma_kernel<K, true> : phase1_mma_kernel<K, false>;
        // more than the 48 KB a kernel gets without asking: set once per device
        static bool ready[MAX_DEVICES][2];
        int dev;
        if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
        if (!ready[dev][mask != nullptr]) {
            if (cudaError_t e = cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_BYTES))
                return static_cast<int>(e);
            ready[dev][mask != nullptr] = true;
        }
        kernel<<<grid, THREADS, MMA_SMEM_BYTES, st>>>(
            bw, qw, inv, qinv, mask, out, C, dw, B, count, rt);
    }
    return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (so the
// library needs no -lcuda)
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// Errors of the host setup, beside the cudaError values the launch returns.
constexpr int ERR_NO_ENCODER = 10001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10002;      // a tensor map was refused

// A 2-d tensor map over rows (rows, d) of 1-, 2- or 4-byte elements whose
// box is one 128-byte k-slab of box_rows rows, in the 128-byte swizzle.
// Elements past d and rows past `rows` read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int esize, int d, int rows, int box_rows) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * esize};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(SLAB / esize),
                               static_cast<cuuint32_t>(box_rows)};
    const cuuint32_t one[2] = {1, 1};
    const CUresult res = encode(
        map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
             : esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
        const_cast<void*>(ptr), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// The query-block plan: consumer
// warpgroups wg (64 queries each) as many as B needs, at most 4, halved
// until their query tile fits beside MIN_STAGES stages of 128-row slabs; if
// not even one warpgroup's fits, the queries stream with the corpus (wg as
// B needs). Tiles of tn = 256 rows where wg <= 2 (128 accumulator registers
// a thread) and MIN_STAGES such stages still fit, else 128. Then as many
// stages as fit, at most MAX_STAGES.
void make_plan(Plan& p, int esize, int C, int d, int B, int count, int& wg, int& tn) {
    const int mblocks = (B + 63) / 64;
    const int want = mblocks >= 3 ? 4 : mblocks;
    p.C = C;
    p.B = B;
    p.count = count;
    p.ks = (d * esize + SLAB - 1) / SLAB;
    auto fixed = [](int t) { return NINFO * t * 4 + BAR_BYTES; };  // info slots, barriers
    auto qtile = [&](int w) { return p.ks * 64 * w * SLAB; };
    wg = want;
    while (wg > 1 && fixed(128) + qtile(wg) + MIN_STAGES * 128 * SLAB > SMEM_LIMIT) wg /= 2;
    p.resident = fixed(128) + qtile(wg) + MIN_STAGES * 128 * SLAB <= SMEM_LIMIT;
    if (!p.resident) wg = want;
    auto stage = [&](int t) { return t * SLAB + (p.resident ? 0 : 64 * wg * SLAB); };
    auto room = [&](int t) { return SMEM_LIMIT - fixed(t) - (p.resident ? qtile(wg) : 0); };
    tn = wg <= 2 && room(256) / stage(256) >= MIN_STAGES ? 256 : 128;
    p.stage_bytes = stage(tn);
    p.stages = min(MAX_STAGES, room(tn) / p.stage_bytes);
    p.ring = p.resident ? qtile(wg) : 0;
    p.info = p.ring + p.stages * p.stage_bytes;
    p.bars = p.info + NINFO * tn * 4;
    p.qblocks = (B + 64 * wg - 1) / (64 * wg);
    const int live_rows = min(count, C);
    p.live_tiles = live_rows > 0 ? (live_rows + tn - 1) / tn : 0;
    p.tiles = (C + tn - 1) / tn;
}

// Blocks the card holds at once for a kernel of the given threads, once per
// device and kernel (cache is the kernel's own table; the host calls cost
// more than a launch); the shared-memory attribute is set on the way. Every
// launch asks for SMEM_LIMIT bytes, so a block has its SM to itself. A kernel
// whose warpgroups trade registers (setmaxnreg) needs regs of them in all: a
// block that starts with fewer would wait forever, so it is refused.
template <typename Kernel>
int resident_blocks(Kernel* kernel, int threads, int regs, int (&cache)[MAX_DEVICES],
                    int& blocks) {
    int dev, sms, per_sm;
    if (int e = sm_count(sms)) return e;  // checks the device index too
    if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
    if (cache[dev] == 0) {
        if (cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT))
            return static_cast<int>(e);
        if (regs > 0) {
            cudaFuncAttributes attr;
            if (cudaError_t e = cudaFuncGetAttributes(&attr, kernel)) return static_cast<int>(e);
            if (attr.numRegs * threads < regs) return static_cast<int>(cudaErrorInvalidConfiguration);
        }
        if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, threads, SMEM_LIMIT))
            return static_cast<int>(e);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        cache[dev] = sms * per_sm;
    }
    blocks = cache[dev];
    return 0;
}

template <typename K, int WG, int TN>
int launch_wgmma_as(Plan p, const CUtensorMap& tbuf, const CUtensorMap& tq, const float* inv,
                    const float* qinv, const uint8_t* mask, float* out, cudaStream_t stream) {
    static int cache[MAX_DEVICES];
    int blocks;
    if (int e = resident_blocks(phase1_wgmma_kernel<K, WG, TN>, WG * 128 + 32, 0, cache, blocks))
        return e;
    // the blocks of one query block walk its tiles; the query blocks run side by side
    p.per_qblock = max(1, blocks / p.qblocks);
    phase1_wgmma_kernel<K, WG, TN><<<p.per_qblock * p.qblocks, WG * 128 + 32, SMEM_LIMIT,
                                     stream>>>(tbuf, tq, inv, qinv, mask, out, p);
    return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_wgmma(const void* buf, const void* q, const float* inv, const float* qinv,
                 const uint8_t* mask, float* out, int C, int d, int B, int count,
                 void* stream) {
    constexpr int esize = std::is_same<K, I8>::value ? 1 : 2;
    if (C <= 0 || B <= 0 || d <= 0 || C % SUBTILE != 0 || (d * esize) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(buf) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
        reinterpret_cast<uintptr_t>(inv) % 16 || reinterpret_cast<uintptr_t>(mask) % 4)
        return static_cast<int>(cudaErrorMisalignedAddress);
    Plan p;
    int wg, tn;
    make_plan(p, esize, C, d, B, count, wg, tn);
    CUtensorMap tbuf, tq;
    if (int e = make_map(&tbuf, buf, esize, d, C, tn)) return e;
    if (int e = make_map(&tq, q, esize, d, B, 64 * wg)) return e;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wg == 4) return launch_wgmma_as<K, 4, 128>(p, tbuf, tq, inv, qinv, mask, out, st);
    if (wg == 2)
        return tn == 256 ? launch_wgmma_as<K, 2, 256>(p, tbuf, tq, inv, qinv, mask, out, st)
                         : launch_wgmma_as<K, 2, 128>(p, tbuf, tq, inv, qinv, mask, out, st);
    return tn == 256 ? launch_wgmma_as<K, 1, 256>(p, tbuf, tq, inv, qinv, mask, out, st)
                     : launch_wgmma_as<K, 1, 128>(p, tbuf, tq, inv, qinv, mask, out, st);
}

// The float32 plan: one consumer warpgroup of one m-tile where B <= 64, two
// of one where B <= 128, else two of two (256 queries); queries stream with
// each stage (a stage: the corpus slab, its lo, the query slab); as many
// stages as fit, at most MAX_STAGES.
void make_plan_tf32(Plan& p, int C, int d, int B, int count, int& wg, int& mt) {
    wg = B > 64 ? 2 : 1;
    mt = B > 128 ? 2 : 1;
    const int qb = 64 * wg * mt;
    p.C = C;
    p.B = B;
    p.count = count;
    p.ks = (d * 4 + SLAB - 1) / SLAB;
    p.resident = 0;
    p.stage_bytes = 2 * TF_TN * SLAB + qb * SLAB;
    p.stages = min(MAX_STAGES, (SMEM_LIMIT - NINFO * TF_TN * 4 - TF_BAR_BYTES) / p.stage_bytes);
    p.ring = 0;
    p.info = p.stages * p.stage_bytes;
    p.bars = p.info + NINFO * TF_TN * 4;
    p.qblocks = (B + qb - 1) / qb;
    const int live_rows = min(count, C);
    p.live_tiles = live_rows > 0 ? (live_rows + TF_TN - 1) / TF_TN : 0;
    p.tiles = (C + TF_TN - 1) / TF_TN;
}

template <int WG, int MT>
int launch_tf32_as(Plan p, const CUtensorMap& tbuf, const CUtensorMap& tq, const float* inv,
                   const uint8_t* mask, float* out, cudaStream_t stream) {
    using Cfg = Tf32Cfg<WG, MT>;
    static int cache[MAX_DEVICES];
    int blocks;
    if (int e = resident_blocks(phase1_tf32_kernel<WG, MT>, Cfg::THREADS, Cfg::REGS, cache, blocks))
        return e;
    // the blocks of one query block walk its tiles; the query blocks run side by side
    p.per_qblock = max(1, blocks / p.qblocks);
    phase1_tf32_kernel<WG, MT><<<p.per_qblock * p.qblocks, Cfg::THREADS, SMEM_LIMIT, stream>>>(
        tbuf, tq, inv, mask, out, p);
    return static_cast<int>(cudaGetLastError());
}

int launch_tf32(const void* buf, const void* q, const float* inv, const uint8_t* mask,
                float* out, int C, int d, int B, int count, void* stream) {
    if (C <= 0 || B <= 0 || d <= 0 || C % SUBTILE != 0 || d % 4 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(buf) % 16 || reinterpret_cast<uintptr_t>(q) % 16 ||
        reinterpret_cast<uintptr_t>(inv) % 16 || reinterpret_cast<uintptr_t>(mask) % 4)
        return static_cast<int>(cudaErrorMisalignedAddress);
    Plan p;
    int wg, mt;
    make_plan_tf32(p, C, d, B, count, wg, mt);
    CUtensorMap tbuf, tq;
    if (int e = make_map(&tbuf, buf, 4, d, C, TF_TN)) return e;
    if (int e = make_map(&tq, q, 4, d, B, 64 * wg * mt)) return e;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (wg == 1) return launch_tf32_as<1, 1>(p, tbuf, tq, inv, mask, out, st);
    return mt == 1 ? launch_tf32_as<2, 1>(p, tbuf, tq, inv, mask, out, st)
                   : launch_tf32_as<2, 2>(p, tbuf, tq, inv, mask, out, st);
}

}  // namespace

// Which kernel phase1_f32 / phase1_bf16 / phase1_i8 launch for rows of d
// elements of esize bytes: 1 a wgmma kernel (rows of a whole number of 16
// bytes, the row stride TMA can describe: phase1_tf32_kernel for float32,
// phase1_wgmma_kernel for bf16 / int8), 0 the narrow kernel (float32's
// CUDA-core phase1_f32_kernel, bf16 / int8's mma.sync one). Row width alone
// decides; the wrapper asks it to count a launch under its kernel.
extern "C" int phase1_route(int d, int esize) { return (d * esize) % 16 == 0 ? 1 : 0; }

// buf (C, d) and q (B, d) contiguous, 4-byte aligned; mask may be null. `d`
// is in elements: d*itemsize must be a multiple of 4 (the wrapper checks).
// Every type's rows take the kernel phase1_route names; the wgmma kernels
// also need buf, q and inv 16-byte aligned (the wrapper sees to it). Each
// returns cudaGetLastError() after the launch (0 = launched), or 10001 /
// 10002 when the driver's tensor-map encoder is missing or refuses the layout.
extern "C" int phase1_f32(const void* buf, const void* q, const float* inv,
                          const uint8_t* mask, float* out, int C, int d, int B,
                          int count, void* stream)
{
    if (phase1_route(d, 4)) return launch_tf32(buf, q, inv, mask, out, C, d, B, count, stream);
    return launch_blocks<void>(buf, q, inv, nullptr, mask, out, C, d, B, count, stream);
}

extern "C" int phase1_bf16(const void* buf, const void* q, const float* inv,
                           const uint8_t* mask, float* out, int C, int d, int B,
                           int count, void* stream)
{
    if (d % 2) return static_cast<int>(cudaErrorInvalidValue);
    if (phase1_route(d, 2))
        return launch_wgmma<BF16>(buf, q, inv, nullptr, mask, out, C, d, B, count, stream);
    return launch_blocks<BF16>(buf, q, inv, nullptr, mask, out, C, d / 2, B, count, stream);
}

extern "C" int phase1_i8(const void* buf, const void* qi, const float* inv,
                         const float* qinv, const uint8_t* mask, float* out,
                         int C, int d, int B, int count, void* stream)
{
    if (d % 4 || qinv == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (phase1_route(d, 1))
        return launch_wgmma<I8>(buf, qi, inv, qinv, mask, out, C, d, B, count, stream);
    return launch_blocks<I8>(buf, qi, inv, qinv, mask, out, C, d / 4, B, count, stream);
}
