// Flash attention backward with segment ids: K7 (dK, dV) and K8 (dQ), float32.
//
// Replaces the two Pallas TPU kernels that the custom VJP of
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention runs when
// minivectordb_tpu/models/train.py differentiates the encoder
// (_flash_attention_bwd_dkv -> _flash_attention_dkv_kernel, its pallas_call at
// flash_attention.py:1121, and _flash_attention_bwd_dq ->
// _flash_attention_dq_kernel, its pallas_call at flash_attention.py:1456).
//   -> flash_attention_bwd_dkv_f32 (K7), flash_attention_bwd_dq_f32 (K8)
//
// For q, k, v, dO (B, NH, S, HD), segment ids seg (B, S), the forward's row
// log-sum-exp lse (B, NH, S) and delta = rowsum(dO * O) (B, NH, S):
//   P[i, j]  = seg[i] == seg[j] ? exp(dot(q_i, k_j) * scale - lse_i) : 0
//   dV       = P^T dO
//   dS[i, j] = P[i, j] * (dot(dO_i, v_j) - delta_i)
//   dK       = dS^T Q * scale
//   dQ       = dS K * scale
// in float32, the (S, S) matrices never in device memory. delta is one
// torch.sum in the wrapper, as the TPU code computes it in XLA outside its
// kernels. Both form their products on the tensor cores in 3xTF32: K7 its
// four (bwd_dkv_tf32_kernel), K8 its three (bwd_dq_tf32_kernel), K8 being
// K7 mirrored.
//
// K7. Work: 8 * HD operations per (query, key) pair of one segment (S, dP,
// dV, dK), against q, k, v, dO read and dK, dV written once: operations bound
// it. On the CUDA cores (IEEE FMAs, about 67 TFLOP/s) that bound is 0.320 ms
// at the e5-large training shape (B 16, 16 heads of 64, S 512), and the
// CUDA-core kernel this one replaces reached 40% of it. wgmma takes float32
// only as TF32 (10 stored significand bits), so every operand x is cut into
// words hi and lo = x - hi, and a product a b is a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the small terms first, summed in float32 (a_lo b_lo, below
// 2^-20 |a| |b|, is dropped): three TF32 products at 495 TFLOP/s, 0.130 ms at
// that shape, 2.4x below the CUDA cores' bound. The design follows from
// wgmma's operands:
//   - wgmma reads TF32 operands from shared memory K-major only. S = Q K^T
//     and dP = dO V^T contract over hd: K and V are their B operands as TMA
//     lands them (rows of hd in the 64- or 128-byte swizzle). dV and dK
//     contract over the queries, so the kernel forms them transposed,
//     dV^T = dO^T P and dK^T = Q^T dS: their B operands, P and dS, are
//     written key-major by the kernel itself, and their A operands, dO^T and
//     Q^T, are read from the landed tiles in transposed order straight into
//     wgmma's register fragments (the queries of each 8 in the order 0, 2, 4,
//     6, 1, 3, 5, 7 on both sides, so the 32 lanes of a load hit 32 banks).
//     No tile is transposed in shared memory. M is the queries (64 a step)
//     for S and dP, and hd (one 64-row m-tile up to hd = 64, two above; rows
//     past hd read as zeros) for dV^T and dK^T.
//   - The words. The tensor core reads a float32 word as TF32, its 13 low
//     bits ignored, so the tiles the kernel reads are cut by truncation: Q's
//     and dO's hi in S and dP are the landed tiles themselves (A from shared
//     memory) and only their lo words (x - hi, truncated) are formed, in
//     registers, as are dO^T's and Q^T's hi and lo. The words the kernel
//     writes are rounded to nearest (cvt.rna): K and V in place once a block,
//     their lo words beside them; P and dS as they are written.
//   - Shared memory decides the tile: K, V and their lo words stay for the
//     block's life, a step's Q and dO land in one of two stages, and P / dS
//     take four key-major tiles (hi and lo). A block owns 64 keys up to
//     hd = 64 and 32 above (226 KB at hd = 128); one block an SM.
//   - Registers decide the split: two warpgroups, warpgroup 0 computes S, P
//     and dV^T, warpgroup 1 dP, dS and dK^T, each product's register words
//     at most 255 a thread (nothing is traded). P reaches warpgroup 1 through
//     its own hi and lo words (hi + lo is exact in float32), so warpgroup 0
//     writes the next step's P once warpgroup 1 has read them, behind a named
//     barrier, without waiting for dK^T.
//   - Each warpgroup keeps one step's second product and the next step's
//     first in flight together (above hd = 64 the two m-tiles of the second
//     go one after the other) and waits for both inside the iteration (a wait
//     across the loop's back-edge serializes wgmma, C7515); the elementwise
//     work runs between. Descriptors are formed once a tile; P is one
//     ex2.approx of a prescaled argument, then the mask.
//   - A step's dV^T and dK^T are summed on the tensor cores into a fresh
//     accumulator and added to the running sums in IEEE float32, so the
//     tensor cores' accumulation (which does not round to nearest) spans 64
//     queries, not the whole sum; the steps are added in ascending order.
//   - Tiles arrive by TMA onto mbarriers: K and V once, each visited step's
//     Q and dO two steps ahead, by warp 0 into one of two stages once every
//     warp has released it; its lse, delta and ids by cp.async onto the same
//     barrier.
//   - dK and dV leave through shared memory as whole 16-byte pieces.
// What bounds it now is the chain of a step inside each warpgroup, not the
// tensor cores: see PERF.md section 6 for its ablations on the card.
//
// K8. Work: 6 * HD operations per pair of one segment (S, dP, dQ), against
// q, k, v, dO read and dQ written once: operations bound it, 0.098 ms in
// 3xTF32 at the e5-large training shape (0.240 ms on the CUDA cores, where
// the CUDA-core kernel this one replaces reached 38% of it, held back by the
// dispatch of FMAs beside the shared-memory loads that fed them). K8 is K7
// mirrored: a block owns a tile of queries and walks the key steps of 64.
//   - Operands. dQ = dS K contracts over the keys, so the kernel forms
//     dQ^T = K^T dS^T: dS is written query-major by the kernel itself (B),
//     K^T is read from the landed K tile in transposed order into register
//     fragments (A; K7's bank-free order, the keys of each 8 as 0, 2, 4, 6,
//     1, 3, 5, 7 on both sides). M is hd (one m-tile up to hd = 64, two
//     above; rows past hd read as zeros). S and dP are formed transposed
//     too, S^T = K Q^T and dP^T = V dO^T: the step's K and V are their A
//     operands as TMA lands them (hi: the tile as it lies; lo: x - hi,
//     truncated, in registers), and the block's Q and dO, rounded in place
//     once with their lo words beside them, are B. So, as in K7, no stage
//     needs lo words written into shared memory.
//   - Shared memory: Q, dO and their lo words stay for the block's life, a
//     step's K and V land in one of two stages, dS takes two query-major
//     words (hi, lo) and S^T / dP^T one exchange tile. A block owns 64
//     queries up to hd = 64 (177 KB at hd = 64) and 32 above (217 KB at
//     hd = 128); one block an SM.
//   - The split: warpgroup 0 forms S^T, warpgroup 1 dP^T, over all of the
//     block's queries. Each then hands the other half of its product to the
//     other warpgroup through the exchange tile and forms P (one ex2.approx
//     of a prescaled argument, then the mask) and dS = P (dP - delta) for
//     its own half of the queries, written as dS^T's hi and lo words. dQ^T
//     is split in two as well: up to hd = 64 each warpgroup takes its own
//     half of the queries, above it one m-tile of all the queries; either
//     way N = 32 and 16 + 16 accumulator words a thread.
//   - Each warpgroup keeps one step's dQ^T and the next step's S^T or dP^T
//     in flight together and waits for both inside the iteration. Above
//     hd = 64 the lo words of S^T's or dP^T's A past the first quarter of hd
//     are loaded once that dQ^T has completed, so the two sets of register
//     words never live at once: no spill at any width (up to 255 registers).
//     Each step's dQ^T is summed on the tensor cores into a fresh accumulator and
//     added to the running sum in IEEE float32, the steps in ascending key
//     order (K7's rule). K and V arrive by TMA into two stages, each visited
//     step two ahead, by warp 0 once every warp has released the stage, the
//     keys' ids by cp.async onto the same barrier; Q, dO and the queries'
//     lse, delta and ids once.
//   - dQ leaves through shared memory as whole 16-byte pieces, times scale.
//
// In both kernels a tile whose range of segment ids [min, max] does not meet
// the block's own holds no pair of one segment and is skipped: the rule of
// the forward kernel (seg_range / tiles_meeting in flash_attention.cu), so the
// real-by-pad corners of the encoder's "ones, then zeros" ids cost nothing.
// Rows past S read as zeros and are masked; only rows below S are written. No
// atomics: the sums run in a fixed order, and the result is deterministic.
//
// Layout: q, k, v share one set of element strides (batch, head, sequence),
// dO has its own, the outputs share a third; the last axis is contiguous and
// every row starts on a 16-byte boundary (K7's tensor maps need 16-byte
// strides too). Any S >= 1; HD a multiple of 16 up to 128.
//
// Build (plain C interface, loaded with ctypes; the tensor maps are encoded
// through cudaGetDriverEntryPoint, so no -lcuda):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.44269504088896341f;

struct Strides {
    long long b, h, s;  // in elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronous; zeros when !valid (src unread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// named barriers (0 is __syncthreads): n threads, whole warps
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// K7: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

// mbarriers, TMA, wgmma and the TF32 split: copies of the helpers of
// csrc/flash_attention.cu's float32 kernel (K6-f32), with the widths K7 needs

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
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
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// the mbarrier at bar receives one arrival when this thread's earlier
// cp.async copies have landed (counted in its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}
// orders this thread's generic accesses to shared memory before later ones
// of the async proxy (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box of rows row .. of head h, batch b of a 5-d tensor map
// (make_map) into shared memory at dst, completing on the mbarrier at bar;
// the box lands as slabs of SPAN-byte rows, slab after slab, in TMA's swizzle
// of that span. hb_swap: batch is dim 3 and head dim 4.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row, int h,
                                         int b, bool hb_swap, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(0),
           "r"(hb_swap ? b : h), "r"(hb_swap ? h : b), "r"(bar)
        : "memory");
}

// byte offset, within a 1024-byte-aligned region, of offset off in the TMA /
// wgmma swizzle of SPAN-byte rows (16-byte chunks XOR the 128-byte line's index)
template <int SPAN>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
    return off ^ (((off >> 7) & (SPAN / 16 - 1)) << 4);
}
// byte offset of element (r, c) of an R-row float32 tile that lies as slabs
// of SPAN-byte rows (SPAN / 4 columns a slab), slab after slab, swizzled
template <int SPAN, int R>
__device__ __forceinline__ uint32_t tile_at(int r, int c) {
    constexpr int CPS = SPAN / 4;
    return swz<SPAN>((c / CPS) * (R * SPAN) + r * SPAN + (c % CPS) * 4);
}
// wgmma descriptor of such a tile at base, read K-major (as B, N = R rows;
// or as A, 64 rows): 8-row groups 8 SPAN bytes apart (stride byte offset),
// the leading byte offset unused; k-step ks (8 columns) starts 32 bytes a
// step into a slab row, ``+ kstep<SPAN, R>(ks)`` (the start address field,
// in 16-byte units, takes the offset without a carry: shared addresses fit
// in its 18 bits). One descriptor a tile, not one a product.
template <int SPAN>
__device__ __forceinline__ uint64_t tdesc(uint32_t base) {
    constexpr uint64_t mode = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
    return static_cast<uint64_t>((base & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16)
         | (static_cast<uint64_t>(8 * SPAN >> 4) << 32) | (mode << 62);
}
template <int SPAN, int R>
__device__ __forceinline__ constexpr uint64_t kstep(int ks) {
    return static_cast<uint64_t>(((ks / (SPAN / 32)) * (R * SPAN) + (ks % (SPAN / 32)) * 32) >> 4);
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
// keeps the compiler from moving accumulator registers across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// x rounded to the nearest TF32 value, ties away from zero (its 13 low bits 0)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t y;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
    return y;
}
// 2^x, one MUFU instruction; results below 2^-126 (P of a key far below its
// row's log-sum-exp) flush to 0
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x truncated to TF32 (its 13 low bits cleared): what the tensor core reads
// from the float32 word x as it lies
__device__ __forceinline__ uint32_t tf32_trunc(float x) {
    return __float_as_uint(x) & 0xFFFFE000u;
}
// hi = tf32(x) and lo = tf32(x - hi): x - hi is exact, hi + lo keeps about 21 bits
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// d (64 x N, float32) += A (64 x 8 TF32, wgmma's register fragment, rs, or
// K-major in shared memory, ss) * B (8 x N TF32, K-major in shared memory).
// Fragment of warp w, lane (g, t4):
// a[e] is A's (row 16 w + g + 8 (e & 1), column t4 + 4 (e >> 1)); d[4 j + 2 h
// + e] is D's (row 16 w + g + 8 h, column 8 j + 2 t4 + e).
template <int N>
struct Tf32Mma;

template <>
struct Tf32Mma<32> {
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t da, uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "%16, %17, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "l"(da), "l"(db), "r"(1));
    }
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
};

template <>
struct Tf32Mma<64> {
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31}, "
            "%32, %33, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(1));
    }
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
            "%30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
              "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
              "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
              "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    }
};

// [lo, hi] of the segment ids of rows first .. first + LEN - 1 below S
// (first < S, LEN <= 64); every lane of the calling warp gets both. Indices
// past the tile or S repeat its last row, which changes neither bound.
template <int LEN>
__device__ __forceinline__ void seg_range_of(const int* __restrict__ segb, int first, int S,
                                             int lane, int& lo, int& hi) {
    const int last = min(first + LEN, S) - 1;
    const int a = segb[min(first + lane, last)];
    const int c = segb[min(first + lane + 32, last)];
    lo = min(a, c);
    hi = max(a, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
}

// the first step start at or after r0 whose W rows meet [lo, hi] (S if
// none); the same answer in every warp
template <int W>
__device__ __forceinline__ int next_step(const int* __restrict__ segb, int r0, int S, int lane,
                                         int lo, int hi) {
    for (; r0 < S; r0 += W) {
        int a, b;
        seg_range_of<W>(segb, r0, S, lane, a, b);
        if (!(b < lo || a > hi)) break;
    }
    return r0;
}

// Within each 8 positions of the dimension a second product contracts over
// (K7: queries, K8: keys), its B tile holds them in the order 0, 2, 4, 6, 1,
// 3, 5, 7: the order its A fragments take them in (fragment column t4 + 4 E
// is position 2 t4 + E), which keeps the fragment loads off shared bank
// conflicts
__device__ __forceinline__ int frag_pos(int x) {
    return (x & ~7) | ((x & 7) >> 1) | ((x & 1) << 2);
}

// K7's shapes and shared memory (byte offsets). Tiles of q, k, v and dO
// land by TMA as slabs of SPAN-byte rows (the widest swizzle, 64 or 128
// bytes, dividing a row's 4 HD bytes), slab after slab; P and dS are tiles of
// KEYS rows (keys) of W queries in 128-byte slabs. Every tile starts on a
// 1024-byte boundary (the swizzle's period).
template <int HD>
struct DkvCfg {
    static constexpr int W = 64;                          // queries a step: M of S and dP
    static constexpr int KEYS = HD <= 64 ? 64 : 32;       // keys a block: N of every product
    static constexpr int THREADS = 256;                   // two warpgroups
    static constexpr int SPAN = HD % 32 == 0 ? 128 : 64;  // bytes of a slab row of q, k, v, dO
    static constexpr int MT = (HD + 63) / 64;             // 64-row m-tiles of dV^T and dK^T
    static constexpr int OWN = KEYS * HD * 4;             // K, K lo, V or V lo
    static constexpr int TILE = W * HD * 4;               // a step's Q or dO
    static constexpr int PT = KEYS * W * 4;               // one word of P or dS, key-major
    static constexpr int K = 0, V = 2 * OWN;              // K lo at K + OWN, V lo at V + OWN
    static constexpr int STAGES = 4 * OWN;                // stage st: Q at + 2 st TILE, dO after it
    static constexpr int PW = STAGES + 4 * TILE;          // P hi, P lo, dS hi (P first), dS lo
    static constexpr int ROWS = PW + 4 * PT;              // stage st: lse, delta, ids (W each)
    static constexpr int SEGK = ROWS + 2 * 3 * W * 4;     // the block's keys' ids
    static constexpr int BARS = SEGK + KEYS * 4;          // full[2], empty[2], then K and V's
    static constexpr int SMEM = BARS + 5 * 8;
    static constexpr int LDO = HD + 4;                    // row stride of dV, dK staged at the end
    static_assert(SMEM <= 232448, "shared memory above the block limit");
    static_assert(OWN % 1024 == 0 && TILE % 1024 == 0 && PT % 1024 == 0 &&
                  KEYS * SPAN % 1024 == 0, "tiles off the swizzle's 1024 bytes");
    static_assert(2 * KEYS * LDO * 4 <= STAGES, "dK and dV are staged in K and V's bytes");
};

// K7: one block per (batch, head, tile of KEYS keys), two warpgroups; it
// walks the query steps of W rows that meet its keys. A step: warpgroup 0
// forms S = Q K^T and P (written key-major as P^T's hi and lo words), then
// dV^T += dO^T P; warpgroup 1 forms dP = dO V^T, reads P back from its words,
// forms dS = P (dP - delta) (written key-major as dS^T's hi and lo words),
// then dK^T += Q^T dS. Every product is three TF32 products on wgmma. S and
// dP read their A words' hi, Q's or dO's, from the step's tile as it lies and
// their lo words from registers; dV^T and dK^T take dO^T's and Q^T's hi and
// lo from registers, read from the tile in transposed order. Each warpgroup
// keeps a step's second product and the next step's first in flight together;
// the elementwise work of a step runs between. Warp 0 also loads the steps:
// a stage is refilled once every warp has released it.
template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::THREADS, 1)
bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    bool q_swap, bool do_swap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    float* __restrict__ dk, float* __restrict__ dv, int NH, int S, Strides os,
                    float scale)
{
    using C = DkvCfg<HD>;
    constexpr int W = C::W, KEYS = C::KEYS, SPAN = C::SPAN, MT = C::MT, NT = C::THREADS;
    extern __shared__ __align__(1024) unsigned char sm7[];  // the swizzles repeat every 1024 bytes
    const uint32_t sb = smem_u32(sm7);
    if (sb % 1024 != 0) __trap();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2;            // 0: S, P, dV^T; 1: dP, dS, dK^T
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * (warp & 3) + g;  // this thread's fragment rows r0 and r0 + 8

    const int ntiles = (S + KEYS - 1) / KEYS;
    const int bh = blockIdx.x / ntiles;
    const int n0 = (blockIdx.x - bh * ntiles) * KEYS;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const float* lseb = lse + (size_t)bh * S;
    const float* deltab = delta + (size_t)bh * S;
    // a stage's "full" barrier: warp 0's lane 0 with the TMA bytes and its 32
    // lanes' cp.async copies; "empty": one arrival a warp
    auto full = [&](int st) { return sb + C::BARS + 8 * st; };
    auto empty = [&](int st) { return sb + C::BARS + 16 + 8 * st; };
    const uint32_t kvbar = sb + C::BARS + 32;
    auto q_at = [&](int st) { return C::STAGES + 2 * st * C::TILE; };  // dO at + TILE
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(full(i), 33);
            mbar_init(empty(i), NT / 32);
        }
        mbar_init(kvbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // warp 0: a step's Q and dO by TMA (rows past S land as zeros), its lse,
    // delta and ids by cp.async (zeros past S), all onto the stage's barrier
    auto load_step = [&](int st, int m0) {
        if (lane == 0) {
            mbar_expect_tx(full(st), 2 * C::TILE);
            tma_load(sb + q_at(st), &tq, m0, h, b, q_swap, full(st));
            tma_load(sb + q_at(st) + C::TILE, &tdo, m0, h, b, do_swap, full(st));
        }
        unsigned char* r = sm7 + C::ROWS + st * 3 * W * 4;
        for (int i = lane; i < W; i += 32) {
            const bool ok = m0 + i < S;
            const int at = ok ? m0 + i : 0;
            cp_async4(r + 4 * i, lseb + at, ok);
            cp_async4(r + 4 * (W + i), deltab + at, ok);
            cp_async4(r + 4 * (2 * W + i), segb + at, ok);
        }
        cp_async_arrive(full(st));
    };
    // this warp is done with stage st (its reads come before TMA refills it)
    auto release = [&](int st) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
    };

    if (tid == 0) {
        mbar_expect_tx(kvbar, 2 * C::OWN);
        tma_load(sb + C::K, &tk, n0, h, b, q_swap, kvbar);
        tma_load(sb + C::V, &tv, n0, h, b, q_swap, kvbar);
    }
    // the keys' ids (a key past S is computed on zeros and never written, so
    // its id is any one)
    if (tid < KEYS) cp_async4(sm7 + C::SEGK + 4 * tid, segb + min(n0 + tid, S - 1), true);
    cp_async_commit();
    int klo, khi;
    seg_range_of<KEYS>(segb, n0, S, lane, klo, khi);
    int m0 = next_step<W>(segb, 0, S, lane, klo, khi);       // this step (S: none)
    int mn = next_step<W>(segb, m0 + W, S, lane, klo, khi);  // the next
    if (warp == 0) {
        if (m0 < S) load_step(0, m0);
        if (mn < S) load_step(1, mn);
    }

    // K and V rounded to their TF32 hi words in place, their lo words at the
    // same offsets OWN bytes on, 16 bytes a thread at a time
    cp_async_wait<0>();
    mbar_wait(kvbar, 0);
    for (int i = tid; i < 2 * C::OWN / 16; i += NT) {
        const int which = i / (C::OWN / 16);
        unsigned char* at = sm7 + 2 * which * C::OWN + 16 * (i - which * (C::OWN / 16));
        float4 x = *reinterpret_cast<const float4*>(at);
        uint4 hi, lo;
        tf32_split(x.x, hi.x, lo.x);
        tf32_split(x.y, hi.y, lo.y);
        tf32_split(x.z, hi.z, lo.z);
        tf32_split(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(at) = hi;
        *reinterpret_cast<uint4*>(at + C::OWN) = lo;
    }
    fence_proxy_async();  // before wgmma reads them
    __syncthreads();      // ... and the keys' ids are in

    const int* segk = reinterpret_cast<const int*>(sm7 + C::SEGK);
    const float scale2 = scale * LOG2E;
    float acc[MT][KEYS / 2];  // dV^T (warpgroup 0) or dK^T (1): rows hd, columns keys
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) acc[mt][i] = 0.f;
    float c[KEYS / 2];                      // S or dP: queries r0, r0 + 8 by keys 8 j + 2 t4 + {0, 1}
    float f[KEYS / 2];                      // a step's dV^T or dK^T (one m-tile)
    uint32_t alo[HD / 8][4];                // the first product's lo words
    uint32_t bhi[W / 8][4], blo[W / 8][4];  // the second product's A words

    // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1) of the step in
    // stage st, issued (not waited for): X_lo Y_hi + X_hi Y_lo + X_hi Y_hi.
    // X's hi is the tile as it lies (A from shared memory); its lo words,
    // x - hi truncated, are wgmma's register fragment: element (query r0 +
    // 8 (e & 1), column 8 ks + t4 + 4 (e >> 1)) of the tile.
    auto issue_first = [&](int st) {
        const uint32_t xa = q_at(st) + wg * C::TILE;
        const uint64_t dx = tdesc<SPAN>(sb + xa);
        const uint64_t dy = tdesc<SPAN>(sb + (wg == 0 ? C::K : C::V));  // lo at + OWN
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = *reinterpret_cast<const float*>(
                    sm7 + xa + tile_at<SPAN, W>(r0 + 8 * (e & 1), 8 * ks + t4 + 4 * (e >> 1)));
                alo[ks][e] = tf32_trunc(x - __uint_as_float(tf32_trunc(x)));
            }
#pragma unroll
        for (int i = 0; i < KEYS / 2; ++i) c[i] = 0.f;
        fence_regs(c);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks) Tf32Mma<KEYS>::rs(c, alo[ks], dy + kstep<SPAN, KEYS>(ks));
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks)
            Tf32Mma<KEYS>::ss(c, dx + kstep<SPAN, W>(ks),
                              dy + (C::OWN >> 4) + kstep<SPAN, KEYS>(ks));
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks)
            Tf32Mma<KEYS>::ss(c, dx + kstep<SPAN, W>(ks), dy + kstep<SPAN, KEYS>(ks));
        wgmma_commit();
    };

    // P = 2^(s * scale * log2 e - lse * log2 e), then the mask (a query
    // past S takes lse = inf, so its P is 0), written key-major as its hi and
    // lo words; warpgroup 1 reads them back (hi + lo is exact in float32)
    // for dS = P (dP - delta), written key-major as its hi and lo words.
    // ``first``: no step before this one, whose P words warpgroup 1 could
    // still be reading; ``last``: no step after it.
    auto elementwise = [&](int st, int m0, bool first, bool last) {
        const float* rows = reinterpret_cast<const float*>(sm7 + C::ROWS + st * 3 * W * 4);
        const int* sq_s = reinterpret_cast<const int*>(rows + 2 * W);
        unsigned char* pw = sm7 + C::PW;
        if (wg == 0) {
            float lq[2];
            int sq[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int q = r0 + 8 * hh;
                lq[hh] = m0 + q < S ? rows[q] * LOG2E : INFINITY;
                sq[hh] = sq_s[q];
            }
#pragma unroll
            for (int j = 0; j < KEYS / 8; ++j) {
                const int2 sk = *reinterpret_cast<const int2*>(segk + 8 * j + 2 * t4);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float& x = c[4 * j + 2 * hh + e];
                        x = (e ? sk.y : sk.x) == sq[hh] ? fast_exp2(fmaf(x, scale2, -lq[hh])) : 0.f;
                    }
            }
            if (!first) bar_sync(4, NT);  // warpgroup 1 has read the step before's P
#pragma unroll
            for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float p = c[4 * j + 2 * hh + e];
                        const uint32_t at = tile_at<128, KEYS>(8 * j + 2 * t4 + e, frag_pos(r0 + 8 * hh));
                        uint32_t hi, lo;
                        tf32_split(p, hi, lo);
                        *reinterpret_cast<uint32_t*>(pw + at) = hi;
                        *reinterpret_cast<uint32_t*>(pw + C::PT + at) = lo;
                    }
            fence_proxy_async();
            bar_arrive(1, NT);  // P is in for warpgroup 1 ...
            bar_sync(2, 128);   // ... and P^T's words for this warpgroup's dV^T
        } else {
            float dz[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) dz[hh] = rows[W + r0 + 8 * hh];
            bar_sync(1, NT);
#pragma unroll
            for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const uint32_t at = tile_at<128, KEYS>(8 * j + 2 * t4 + e, frag_pos(r0 + 8 * hh));
                        const float p = *reinterpret_cast<const float*>(pw + at) +
                                        *reinterpret_cast<const float*>(pw + C::PT + at);
                        float& x = c[4 * j + 2 * hh + e];
                        x = p * (x - dz[hh]);
                    }
            if (!last) bar_arrive(4, NT);  // P is read: the next step's may take its place
#pragma unroll
            for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const uint32_t at = tile_at<128, KEYS>(8 * j + 2 * t4 + e, frag_pos(r0 + 8 * hh));
                        uint32_t hi, lo;
                        tf32_split(c[4 * j + 2 * hh + e], hi, lo);
                        *reinterpret_cast<uint32_t*>(pw + 2 * C::PT + at) = hi;
                        *reinterpret_cast<uint32_t*>(pw + 3 * C::PT + at) = lo;
                    }
            fence_proxy_async();
            bar_sync(3, 128);  // dS^T's words are in for this warpgroup's dK^T
        }
    };

    // dV^T += dO^T P (warpgroup 0) or dK^T += Q^T dS (warpgroup 1) of the
    // step in stage st: hd rows 64 mt + r0 (+ 8) by keys, summed over the
    // step's queries into a fresh accumulator, then added in IEEE float32.
    // The A words, dO^T's or Q^T's, are cut by truncation (as the first
    // product's): fragment column t4 + 4 E of k-step kk is query 8 kk +
    // 2 t4 + E (frag_pos), element (that query, column 64 mt + r0 + 8 (e & 1)) of
    // the tile, read in transposed order (0 past hd), the 32 lanes of a load
    // on 32 banks. With one m-tile the product is left in flight; then the
    // stage is released.
    auto issue_second = [&](int st) {
        const unsigned char* x = sm7 + q_at(st) + (1 - wg) * C::TILE;
        const uint64_t dy = tdesc<128>(sb + C::PW + wg * 2 * C::PT);  // hi words; lo at + PT
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int kk = 0; kk < W / 8; ++kk)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    // rows past hd read a real column and take 0 by a select,
                    // not a branch (wgmma's registers must not come from a
                    // divergent path, C7520)
                    const int d = 64 * mt + r0 + 8 * (e & 1);
                    const float u = *reinterpret_cast<const float*>(
                        x + tile_at<SPAN, W>(8 * kk + 2 * t4 + (e >> 1), min(d, HD - 1)));
                    const float v = d < HD ? u : 0.f;
                    bhi[kk][e] = tf32_trunc(v);
                    blo[kk][e] = tf32_trunc(v - __uint_as_float(bhi[kk][e]));
                }
#pragma unroll
            for (int i = 0; i < KEYS / 2; ++i) f[i] = 0.f;
            fence_regs(f);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < W / 8; ++kk) Tf32Mma<KEYS>::rs(f, blo[kk], dy + kstep<128, KEYS>(kk));
#pragma unroll
            for (int kk = 0; kk < W / 8; ++kk)
                Tf32Mma<KEYS>::rs(f, bhi[kk], dy + (C::PT >> 4) + kstep<128, KEYS>(kk));
#pragma unroll
            for (int kk = 0; kk < W / 8; ++kk) Tf32Mma<KEYS>::rs(f, bhi[kk], dy + kstep<128, KEYS>(kk));
            wgmma_commit();
            if constexpr (MT > 1) {
                wgmma_wait<0>();
                fence_regs(f);
#pragma unroll
                for (int i = 0; i < KEYS / 2; ++i) acc[mt][i] += f[i];
            }
        }
        release(st);
    };

    // Step i lies in stage i & 1. Each iteration issues step i's second
    // product and step i + 1's first, and waits for both inside it (a wait
    // across the loop's back-edge serializes wgmma, C7515); warp 0 then
    // refills stage i & 1 with step i + 2 once every warp has released it.
    if (m0 < S) {
        mbar_wait(full(0), 0);
        issue_first(0);
        wgmma_wait<0>();
        fence_regs(c);
        elementwise(0, m0, true, mn >= S);
    }
    for (int i = 0; m0 < S; ++i) {
        const int st = i & 1;
        const int mnn = next_step<W>(segb, mn < S ? mn + W : S, S, lane, klo, khi);
        issue_second(st);
        if (mn < S) {
            mbar_wait(full(st ^ 1), ((i + 1) >> 1) & 1);
            issue_first(st ^ 1);
        }
        wgmma_wait<0>();
        fence_regs(c);
        fence_regs(f);
        if constexpr (MT == 1) {
#pragma unroll
            for (int k = 0; k < KEYS / 2; ++k) acc[0][k] += f[k];
        }
        if (warp == 0 && mnn < S) {
            mbar_wait(empty(st), (i >> 1) & 1);
            load_step(st, mnn);
        }
        if (mn >= S) break;
        elementwise(st ^ 1, mn, false, mnn >= S);
        m0 = mn;
        mn = mnn;
    }

    // dV (warpgroup 0) and dK (1) staged row-major in shared memory, rows
    // LDO floats apart (the 4 keys a warp's store touches lie 8 banks apart),
    // then written as whole 16-byte pieces, dK times scale
    __syncthreads();  // every warp is done with K, V and the stages
    float* ob = reinterpret_cast<float*>(sm7);
    constexpr int LDO = C::LDO;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int d = 64 * mt + r0 + 8 * hh;
                if (d >= HD) continue;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    ob[(wg * KEYS + 8 * j + 2 * t4 + e) * LDO + d] = acc[mt][4 * j + 2 * hh + e];
            }
    __syncthreads();
    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
    constexpr int C4 = HD / 4;
    for (int idx = tid; idx < 2 * KEYS * C4; idx += NT) {
        const int r = idx / C4, c4 = idx - r * C4;  // r: dV's keys, then dK's
        const int key = r < KEYS ? r : r - KEYS;
        if (n0 + key >= S) continue;
        float4 x = *reinterpret_cast<const float4*>(ob + r * LDO + 4 * c4);
        if (r >= KEYS) {
            x.x *= scale;
            x.y *= scale;
            x.z *= scale;
            x.w *= scale;
        }
        *reinterpret_cast<float4*>((r < KEYS ? dv : dk) + out_off + (size_t)(n0 + key) * os.s +
                                   4 * c4) = x;
    }
}

// ---------------------------------------------------------------------------
// K8: 3xTF32 on wgmma, K7 mirrored
// ---------------------------------------------------------------------------

// K8's shapes and shared memory (byte offsets). Tiles of q, k, v and dO land
// by TMA as K7's do; dS^T's words are tiles of QUERIES rows (queries) of W
// keys in 128-byte slabs. Every tile starts on a 1024-byte boundary.
template <int HD>
struct DqCfg {
    static constexpr int W = 64;                          // keys a step: M of S^T and dP^T
    static constexpr int QUERIES = HD <= 64 ? 64 : 32;    // queries a block: N of S^T, dP^T
    static constexpr int THREADS = 256;                   // two warpgroups
    static constexpr int SPAN = HD % 32 == 0 ? 128 : 64;  // bytes of a slab row of q, k, v, dO
    static constexpr int MT = (HD + 63) / 64;             // 64-row m-tiles of dQ^T
    // a warpgroup's dQ^T: its half of the queries (one m-tile) or its m-tile
    static constexpr int NQ = MT == 1 ? QUERIES / 2 : QUERIES;
    static constexpr int OWN = QUERIES * HD * 4;          // Q, Q lo, dO or dO lo
    static constexpr int TILE = W * HD * 4;               // a step's K or V
    static constexpr int DST = QUERIES * W * 4;           // one word of dS^T, query-major
    static constexpr int Q = 0, DO = 2 * OWN;             // Q lo at Q + OWN, dO lo at DO + OWN
    static constexpr int STAGES = 4 * OWN;                // stage st: K at + 2 st TILE, V after it
    static constexpr int DS = STAGES + 4 * TILE;          // dS^T hi, dS^T lo
    static constexpr int XCH = DS + 2 * DST;              // S^T / dP^T halves exchanged
    static constexpr int ROWS = XCH + W * QUERIES * 4;    // the block's lse, delta, ids
    static constexpr int SEGK = ROWS + 3 * QUERIES * 4;   // stage st: its keys' ids at + st W
    static constexpr int BARS = SEGK + 2 * W * 4;         // full[2], empty[2], then Q and dO's
    static constexpr int SMEM = BARS + 5 * 8;
    static constexpr int LDO = HD + 4;                    // row stride of dQ staged at the end
    static_assert(NQ == 32, "a warpgroup's dQ^T has 32 columns");
    static_assert(SMEM <= 232448, "shared memory above the block limit");
    static_assert(OWN % 1024 == 0 && TILE % 1024 == 0 && DST % 1024 == 0 &&
                  QUERIES * SPAN % 1024 == 0, "tiles off the swizzle's 1024 bytes");
    static_assert(QUERIES * LDO * 4 <= STAGES, "dQ is staged in Q and dO's bytes");
};

// K8: one block per (batch, head, tile of QUERIES queries), two warpgroups;
// it walks the key steps of W keys that meet its queries. A step: warpgroup 0
// forms S^T = K Q^T, warpgroup 1 dP^T = V dO^T; each hands the other half of
// its product to the other through the exchange tile and forms P and dS =
// P (dP - delta) for its own half of the queries, written query-major as
// dS^T's hi and lo words; then each forms its part of dQ^T += K^T dS^T. Every
// product is three TF32 products on wgmma. S^T and dP^T read their A words'
// hi, K's or V's, from the step's tile as it lies and their lo words from
// registers; dQ^T takes K^T's hi and lo from registers, read from the tile in
// transposed order. Each warpgroup keeps a step's dQ^T and the next step's
// S^T or dP^T in flight together; the elementwise work of a step runs
// between. Warp 0 also loads the steps: a stage is refilled once every warp
// has released it.
template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::THREADS, 1)
bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   bool q_swap, bool do_swap, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ seg,
                   float* __restrict__ dq, int NH, int S, Strides os, float scale)
{
    using C = DqCfg<HD>;
    constexpr int W = C::W, QN = C::QUERIES, SPAN = C::SPAN, MT = C::MT, NQ = C::NQ;
    constexpr int NT = C::THREADS;
    constexpr int JH = QN / 16;  // fragment column groups (8 queries) of half the queries
    extern __shared__ __align__(1024) unsigned char sm8[];  // the swizzles repeat every 1024 bytes
    const uint32_t sb = smem_u32(sm8);
    if (sb % 1024 != 0) __trap();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2;            // 0: S^T; 1: dP^T
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = 16 * (warp & 3) + g;  // this thread's fragment rows r0 and r0 + 8
    // this warpgroup's dQ^T: m-tile mt, queries qo .. qo + NQ - 1
    const int mt = MT > 1 ? wg : 0, qo = MT > 1 ? 0 : wg * NQ;

    const int ntiles = (S + QN - 1) / QN;
    const int bh = blockIdx.x / ntiles;
    const int m0 = (blockIdx.x - bh * ntiles) * QN;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const float* lseb = lse + (size_t)bh * S;
    const float* deltab = delta + (size_t)bh * S;
    // a stage's "full" barrier: warp 0's lane 0 with the TMA bytes and its 32
    // lanes' cp.async copies; "empty": one arrival a warp
    auto full = [&](int st) { return sb + C::BARS + 8 * st; };
    auto empty = [&](int st) { return sb + C::BARS + 16 + 8 * st; };
    const uint32_t qbar = sb + C::BARS + 32;
    auto k_at = [&](int st) { return C::STAGES + 2 * st * C::TILE; };  // V at + TILE
    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            mbar_init(full(i), 33);
            mbar_init(empty(i), NT / 32);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // warp 0: a step's K and V by TMA (rows past S land as zeros), its keys'
    // ids by cp.async (zeros past S), all onto the stage's barrier
    auto load_step = [&](int st, int n0) {
        if (lane == 0) {
            mbar_expect_tx(full(st), 2 * C::TILE);
            tma_load(sb + k_at(st), &tk, n0, h, b, q_swap, full(st));
            tma_load(sb + k_at(st) + C::TILE, &tv, n0, h, b, q_swap, full(st));
        }
        unsigned char* r = sm8 + C::SEGK + st * W * 4;
        for (int i = lane; i < W; i += 32) {
            const bool ok = n0 + i < S;
            cp_async4(r + 4 * i, segb + (ok ? n0 + i : 0), ok);
        }
        cp_async_arrive(full(st));
    };
    // this warp is done with stage st (its reads come before TMA refills it)
    auto release = [&](int st) {
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
    };

    if (tid == 0) {
        mbar_expect_tx(qbar, 2 * C::OWN);
        tma_load(sb + C::Q, &tq, m0, h, b, q_swap, qbar);
        tma_load(sb + C::DO, &tdo, m0, h, b, do_swap, qbar);
    }
    // the block's queries' lse, delta and ids (zeros past S)
    for (int i = tid; i < 3 * QN; i += NT) {
        const int which = i / QN, r = i - which * QN;
        const bool ok = m0 + r < S;
        const int at = ok ? m0 + r : 0;
        cp_async4(sm8 + C::ROWS + 4 * i,
                  which == 0 ? static_cast<const void*>(lseb + at)
                  : which == 1 ? static_cast<const void*>(deltab + at)
                               : static_cast<const void*>(segb + at), ok);
    }
    cp_async_commit();
    int qlo, qhi;
    seg_range_of<QN>(segb, m0, S, lane, qlo, qhi);
    int n0 = next_step<W>(segb, 0, S, lane, qlo, qhi);       // this step (S: none)
    int nn = next_step<W>(segb, n0 + W, S, lane, qlo, qhi);  // the next
    if (warp == 0) {
        if (n0 < S) load_step(0, n0);
        if (nn < S) load_step(1, nn);
    }

    // Q and dO rounded to their TF32 hi words in place, their lo words at the
    // same offsets OWN bytes on, 16 bytes a thread at a time
    cp_async_wait<0>();
    mbar_wait(qbar, 0);
    for (int i = tid; i < 2 * C::OWN / 16; i += NT) {
        const int which = i / (C::OWN / 16);
        unsigned char* at = sm8 + 2 * which * C::OWN + 16 * (i - which * (C::OWN / 16));
        float4 x = *reinterpret_cast<const float4*>(at);
        uint4 hi, lo;
        tf32_split(x.x, hi.x, lo.x);
        tf32_split(x.y, hi.y, lo.y);
        tf32_split(x.z, hi.z, lo.z);
        tf32_split(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(at) = hi;
        *reinterpret_cast<uint4*>(at + C::OWN) = lo;
    }
    fence_proxy_async();  // before wgmma reads them
    __syncthreads();      // ... and the queries' rows are in

    const float scale2 = scale * LOG2E;
    float acc[NQ / 2];  // dQ^T: rows hd (m-tile mt), columns queries qo ..
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;
    float c[QN / 2];                        // S^T or dP^T: keys r0, r0 + 8 by queries 8 j + 2 t4 + {0, 1}
    float f[NQ / 2];                        // a step's dQ^T
    uint32_t alo[HD / 8][4];                // the first product's lo words
    uint32_t bhi[W / 8][4], blo[W / 8][4];  // dQ^T's A words
    // 0 before the first dQ^T: above hd = 64 the first step's issue_first adds it
#pragma unroll
    for (int i = 0; i < NQ / 2; ++i) f[i] = 0.f;
    // a step's dQ^T, once waited for, added to the running sum in IEEE float32
    auto add_step = [&]() {
        fence_regs(f);
#pragma unroll
        for (int k = 0; k < NQ / 2; ++k) acc[k] += f[k];
    };

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1) of the step in
    // stage st, issued (not waited for): X_lo Y_hi + X_hi Y_lo + X_hi Y_hi.
    // X's hi is the tile as it lies (A from shared memory); its lo words,
    // x - hi truncated, are wgmma's register fragment: element (key r0 +
    // 8 (e & 1), column 8 ks + t4 + 4 (e >> 1)) of the tile. Above hd = 64
    // the lo words past the first quarter of hd are loaded only once the
    // step before's dQ^T, issued just before, has read its A words
    // (registers: the two do not live at once), the X_lo Y_hi term in two
    // groups; that dQ^T is added to the running sum there.
    auto issue_first = [&](int st) {
        const uint32_t xa = k_at(st) + wg * C::TILE;
        const uint64_t dx = tdesc<SPAN>(sb + xa);
        const uint64_t dy = tdesc<SPAN>(sb + (wg == 0 ? C::Q : C::DO));  // lo at + OWN
        auto lo_words = [&](int ks) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = *reinterpret_cast<const float*>(
                    sm8 + xa + tile_at<SPAN, W>(r0 + 8 * (e & 1), 8 * ks + t4 + 4 * (e >> 1)));
                alo[ks][e] = tf32_trunc(x - __uint_as_float(tf32_trunc(x)));
            }
        };
        constexpr int KA = MT > 1 ? HD / 32 : HD / 8;  // k-steps of the first group
#pragma unroll
        for (int ks = 0; ks < KA; ++ks) lo_words(ks);
#pragma unroll
        for (int i = 0; i < QN / 2; ++i) c[i] = 0.f;
        fence_regs(c);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KA; ++ks) Tf32Mma<QN>::rs(c, alo[ks], dy + kstep<SPAN, QN>(ks));
        if constexpr (KA < HD / 8) {
            wgmma_commit();
            wgmma_wait<1>();  // the step before's dQ^T is done (0 before the first)
            add_step();
#pragma unroll
            for (int ks = KA; ks < HD / 8; ++ks) lo_words(ks);
            wgmma_fence();
#pragma unroll
            for (int ks = KA; ks < HD / 8; ++ks) Tf32Mma<QN>::rs(c, alo[ks], dy + kstep<SPAN, QN>(ks));
        }
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks)
            Tf32Mma<QN>::ss(c, dx + kstep<SPAN, W>(ks),
                            dy + (C::OWN >> 4) + kstep<SPAN, QN>(ks));
#pragma unroll
        for (int ks = 0; ks < HD / 8; ++ks)
            Tf32Mma<QN>::ss(c, dx + kstep<SPAN, W>(ks), dy + kstep<SPAN, QN>(ks));
        wgmma_commit();
    };

    // The halves: warpgroup 0 keeps S^T's queries 0 .. QN / 2 - 1 (fragment
    // columns j < JH) and hands over the rest, warpgroup 1 keeps dP^T's
    // queries QN / 2 .. and hands over the first; an exchanged value lies at
    // float v * 128 + (tid & 127) of its warpgroup's half of the tile (32
    // lanes, 32 banks). Then P = 2^(s * scale * log2 e - lse * log2 e), 0
    // where the ids differ or the key lies past S, and dS = P (dP - delta),
    // written query-major as dS^T's hi and lo words (keys in frag_pos order).
    // Selects, not indices, pick a half: the fragment stays in registers.
    auto elementwise = [&](int st, int n0) {
        const int* sk = reinterpret_cast<const int*>(sm8 + C::SEGK + st * W * 4);
        float* xch = reinterpret_cast<float*>(sm8 + C::XCH);
        unsigned char* dsw = sm8 + C::DS;
        const int me = tid & 127;
#pragma unroll
        for (int jj = 0; jj < JH; ++jj)
#pragma unroll
            for (int u = 0; u < 4; ++u)
                xch[(wg * 4 * JH + 4 * jj + u) * 128 + me] =
                    wg == 0 ? c[4 * (JH + jj) + u] : c[4 * jj + u];
        bar_sync(1, NT);  // both halves are in
        const float* rows = reinterpret_cast<const float*>(sm8 + C::ROWS);
        int sk_r[2];
        bool kok[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            sk_r[hh] = sk[r0 + 8 * hh];
            kok[hh] = n0 + r0 + 8 * hh < S;
        }
#pragma unroll
        for (int jj = 0; jj < JH; ++jj) {
            // this thread's queries 8 (wg JH + jj) + 2 t4 + {0, 1}: lse, delta, ids
            const int q = 8 * (wg * JH + jj) + 2 * t4;
            const float2 lq = *reinterpret_cast<const float2*>(rows + q);
            const float2 dz = *reinterpret_cast<const float2*>(rows + QN + q);
            const int2 sq = *reinterpret_cast<const int2*>(rows + 2 * QN + q);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int u = 2 * hh + e;
                    const float mine = wg == 0 ? c[4 * jj + u] : c[4 * (JH + jj) + u];
                    const float other = xch[((1 - wg) * 4 * JH + 4 * jj + u) * 128 + me];
                    const float s = wg == 0 ? mine : other;
                    const float dp = wg == 0 ? other : mine;
                    const float p = kok[hh] && sk_r[hh] == (e ? sq.y : sq.x)
                                        ? fast_exp2(fmaf(s, scale2, -(e ? lq.y : lq.x) * LOG2E))
                                        : 0.f;
                    uint32_t hi, lo;
                    tf32_split(p * (dp - (e ? dz.y : dz.x)), hi, lo);
                    const uint32_t at = tile_at<128, QN>(q + e, frag_pos(r0 + 8 * hh));
                    *reinterpret_cast<uint32_t*>(dsw + at) = hi;
                    *reinterpret_cast<uint32_t*>(dsw + C::DST + at) = lo;
                }
        }
        fence_proxy_async();
        bar_sync(2, NT);  // dS^T's words are in, and the exchange tile is read
    };

    // dQ^T += K^T dS^T of the step in stage st: hd rows 64 mt + r0 (+ 8) by
    // queries qo .., summed over the step's keys into a fresh accumulator
    // (added in IEEE float32 by add_step once waited for). K^T's words are cut by
    // truncation (as the first product's): fragment column t4 + 4 E of
    // k-step kk is key 8 kk + 2 t4 + E (frag_pos), element (that key, column
    // 64 mt + r0 + 8 (e & 1)) of the tile, read in transposed order (0 past
    // hd), the 32 lanes of a load on 32 banks. The product is left in flight;
    // then the stage is released.
    auto issue_second = [&](int st) {
        const unsigned char* x = sm8 + k_at(st);
        const uint64_t dy = tdesc<128>(sb + C::DS + qo * 128);  // hi words; lo at + DST
#pragma unroll
        for (int kk = 0; kk < W / 8; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                // rows past hd read a real column and take 0 by a select,
                // not a branch (wgmma's registers must not come from a
                // divergent path, C7520)
                const int d = 64 * mt + r0 + 8 * (e & 1);
                const float u = *reinterpret_cast<const float*>(
                    x + tile_at<SPAN, W>(8 * kk + 2 * t4 + (e >> 1), min(d, HD - 1)));
                const float v = d < HD ? u : 0.f;
                bhi[kk][e] = tf32_trunc(v);
                blo[kk][e] = tf32_trunc(v - __uint_as_float(bhi[kk][e]));
            }
#pragma unroll
        for (int i = 0; i < NQ / 2; ++i) f[i] = 0.f;
        fence_regs(f);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W / 8; ++kk) Tf32Mma<NQ>::rs(f, blo[kk], dy + kstep<128, QN>(kk));
#pragma unroll
        for (int kk = 0; kk < W / 8; ++kk)
            Tf32Mma<NQ>::rs(f, bhi[kk], dy + (C::DST >> 4) + kstep<128, QN>(kk));
#pragma unroll
        for (int kk = 0; kk < W / 8; ++kk) Tf32Mma<NQ>::rs(f, bhi[kk], dy + kstep<128, QN>(kk));
        wgmma_commit();
        release(st);
    };

    // Step i lies in stage i & 1. Each iteration issues step i's dQ^T and
    // step i + 1's first product, and waits for both inside it (a wait across
    // the loop's back-edge serializes wgmma, C7515); warp 0 refills stage
    // i & 1 with step i + 2 as soon as every warp has released it, before
    // the wait.
    if (n0 < S) {
        mbar_wait(full(0), 0);
        issue_first(0);
        wgmma_wait<0>();
        fence_regs(c);
        elementwise(0, n0);
    }
    for (int i = 0; n0 < S; ++i) {
        const int st = i & 1;
        const int nnn = next_step<W>(segb, nn < S ? nn + W : S, S, lane, qlo, qhi);
        issue_second(st);
        if (warp == 0 && nnn < S) {  // stage st is released: TMA refills it under the products
            mbar_wait(empty(st), (i >> 1) & 1);
            load_step(st, nnn);
        }
        if (nn < S) {
            mbar_wait(full(st ^ 1), ((i + 1) >> 1) & 1);
            issue_first(st ^ 1);
        }
        wgmma_wait<0>();
        fence_regs(c);
        if (MT == 1 || nn >= S) add_step();  // else issue_first added it
        if (nn >= S) break;
        elementwise(st ^ 1, nn);
        n0 = nn;
        nn = nnn;
    }

    // dQ staged row-major in shared memory, rows LDO floats apart (the 4
    // queries a warp's store touches lie 8 banks apart), then written as
    // whole 16-byte pieces, times scale
    __syncthreads();  // every warp is done with Q, dO and the stages
    float* ob = reinterpret_cast<float*>(sm8);
    constexpr int LDO = C::LDO;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int d = 64 * mt + r0 + 8 * hh;
            if (d >= HD) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e)
                ob[(qo + 8 * j + 2 * t4 + e) * LDO + d] = acc[4 * j + 2 * hh + e];
        }
    __syncthreads();
    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
    constexpr int C4 = HD / 4;
    for (int idx = tid; idx < QN * C4; idx += NT) {
        const int r = idx / C4, c4 = idx - r * C4;
        if (m0 + r >= S) continue;
        float4 x = *reinterpret_cast<const float4*>(ob + r * LDO + 4 * c4);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
        *reinterpret_cast<float4*>(dq + out_off + (size_t)(m0 + r) * os.s + 4 * c4) = x;
    }
}

struct Problem {
    const float *q, *k, *v, *dout, *lse, *delta;
    const int* seg;
    float *out0, *out1;  // K7: dK, dV; K8: dQ
    int B, NH, S;
    Strides in, dos, os;
    float scale;
    cudaStream_t stream;
};

// Blocks (B * NH * ceil(S / rows)); the shared-memory attribute is set once
// per device and kernel (ready is the kernel's own table, by device).
template <typename Kernel>
int prepare(const Problem& p, Kernel* kernel, int smem, int rows, bool (&ready)[MAX_DEVICES],
            int& blocks) {
    if (p.B <= 0 || p.NH <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = (long long)p.B * p.NH * ((p.S + rows - 1) / rows);
    if (n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    blocks = static_cast<int>(n);
    int dev;
    if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (!ready[dev]) {
        if (cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
            return static_cast<int>(e);
        ready[dev] = true;
    }
    return 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (so
// the library needs no -lcuda)
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

// Errors of the host setup, beside the cudaError values the launch returns
// (csrc/flash_attention.cu's codes).
constexpr int ERR_NO_ENCODER = 10001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10002;      // a tensor map was refused

// A 5-d tensor map over a float32 (B, NH, S, HD) tensor with element strides
// st, whose boxes are rows rows of the sequence, every element of them,
// landing as slabs of span-byte rows (span / 4 columns), slab after slab, in
// TMA's swizzle of that span: dim 0 is a slab's part of a row, dim 1 the
// sequence, dim 2 the row's slabs, dims 3 and 4 head and batch, the smaller
// stride first (hb_swap: batch first). Rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, Strides st, const Problem& p, int HD, int rows,
             int span, bool& hb_swap) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    hb_swap = st.b < st.h;
    const long long hs = hb_swap ? st.b : st.h, bs = hb_swap ? st.h : st.b;
    const int hn = hb_swap ? p.B : p.NH, bn = hb_swap ? p.NH : p.B;
    const int cw = span / 4;  // elements of a box row
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(cw), static_cast<cuuint64_t>(p.S),
                                static_cast<cuuint64_t>(HD / cw), static_cast<cuuint64_t>(hn),
                                static_cast<cuuint64_t>(bn)};
    const cuuint64_t strides[4] = {static_cast<cuuint64_t>(st.s) * 4,
                                   static_cast<cuuint64_t>(cw) * 4,
                                   static_cast<cuuint64_t>(hs) * 4,
                                   static_cast<cuuint64_t>(bs) * 4};
    const cuuint32_t box[5] = {static_cast<cuuint32_t>(cw), static_cast<cuuint32_t>(rows),
                               static_cast<cuuint32_t>(HD / cw), 1, 1};
    const cuuint32_t one[5] = {1, 1, 1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(ptr), dims, strides, box,
        one, CU_TENSOR_MAP_INTERLEAVE_NONE,
        span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int HD>
int launch_dkv(const Problem& p) {
    using C = DkvCfg<HD>;
    static bool ready[MAX_DEVICES];
    int blocks;
    if (int e = prepare(p, bwd_dkv_tf32_kernel<HD>, C::SMEM, C::KEYS, ready, blocks)) return e;
    CUtensorMap tq, tdo, tk, tv;
    bool q_swap, do_swap;
    if (int e = make_map(&tq, p.q, p.in, p, HD, C::W, C::SPAN, q_swap)) return e;
    if (int e = make_map(&tk, p.k, p.in, p, HD, C::KEYS, C::SPAN, q_swap)) return e;
    if (int e = make_map(&tv, p.v, p.in, p, HD, C::KEYS, C::SPAN, q_swap)) return e;
    if (int e = make_map(&tdo, p.dout, p.dos, p, HD, C::W, C::SPAN, do_swap)) return e;
    bwd_dkv_tf32_kernel<HD><<<blocks, C::THREADS, C::SMEM, p.stream>>>(
        tq, tdo, tk, tv, q_swap, do_swap, p.lse, p.delta, p.seg, p.out0, p.out1, p.NH, p.S,
        p.os, p.scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const Problem& p) {
    using C = DqCfg<HD>;
    static bool ready[MAX_DEVICES];
    int blocks;
    if (int e = prepare(p, bwd_dq_tf32_kernel<HD>, C::SMEM, C::QUERIES, ready, blocks)) return e;
    CUtensorMap tq, tdo, tk, tv;
    bool q_swap, do_swap;
    if (int e = make_map(&tq, p.q, p.in, p, HD, C::QUERIES, C::SPAN, q_swap)) return e;
    if (int e = make_map(&tk, p.k, p.in, p, HD, C::W, C::SPAN, q_swap)) return e;
    if (int e = make_map(&tv, p.v, p.in, p, HD, C::W, C::SPAN, q_swap)) return e;
    if (int e = make_map(&tdo, p.dout, p.dos, p, HD, C::QUERIES, C::SPAN, do_swap)) return e;
    bwd_dq_tf32_kernel<HD><<<blocks, C::THREADS, C::SMEM, p.stream>>>(
        tq, tdo, tk, tv, q_swap, do_swap, p.lse, p.delta, p.seg, p.out0, p.NH, p.S, p.os,
        p.scale);
    return static_cast<int>(cudaGetLastError());
}

template <bool DKV>
int dispatch(const Problem& p, int HD) {
#define BWD_CASE(N) \
    case N: return DKV ? launch_dkv<N>(p) : launch_dq<N>(p);
    switch (HD) {
        BWD_CASE(16) BWD_CASE(32) BWD_CASE(48) BWD_CASE(64)
        BWD_CASE(80) BWD_CASE(96) BWD_CASE(112) BWD_CASE(128)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BWD_CASE
}

}  // namespace

// q, k, v: element (b, h, s, d) at b*in_b + h*in_h + s*in_s + d; dout with the
// do_* strides; dk, dv (K7) and dq (K8) with the out_* strides; lse and delta
// (B, NH, S) float32 and seg (B, S) int32, contiguous. Strides in elements.
// Returns the cudaError of the launch (0 = launched), or 10001 / 10002 when
// the driver's tensor-map encoder is missing or refuses the layout.
extern "C" int flash_attention_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* delta, const int* seg, float* dk,
                                           float* dv, int B, int NH, int S, int HD,
                                           long long in_b, long long in_h, long long in_s,
                                           long long do_b, long long do_h, long long do_s,
                                           long long out_b, long long out_h, long long out_s,
                                           float sm_scale, void* stream)
{
    const Problem p{q, k, v, dout, lse, delta, seg, dk, dv, B, NH, S, {in_b, in_h, in_s},
                    {do_b, do_h, do_s}, {out_b, out_h, out_s}, sm_scale,
                    static_cast<cudaStream_t>(stream)};
    return dispatch<true>(p, HD);
}

extern "C" int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse,
                                          const float* delta, const int* seg, float* dq,
                                          int B, int NH, int S, int HD,
                                          long long in_b, long long in_h, long long in_s,
                                          long long do_b, long long do_h, long long do_s,
                                          long long out_b, long long out_h, long long out_s,
                                          float sm_scale, void* stream)
{
    const Problem p{q, k, v, dout, lse, delta, seg, dq, nullptr, B, NH, S, {in_b, in_h, in_s},
                    {do_b, do_h, do_s}, {out_b, out_h, out_s}, sm_scale,
                    static_cast<cudaStream_t>(stream)};
    return dispatch<false>(p, HD);
}
