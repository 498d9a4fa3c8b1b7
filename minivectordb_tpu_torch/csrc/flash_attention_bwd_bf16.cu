// Flash attention backward with segment ids in bfloat16: K7 (dK, dV) and K8
// (dQ) on the tensor cores.
//
// Replaces the two Pallas TPU kernels that the custom VJP of
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention runs when
// minivectordb_tpu/models/train.py differentiates an encoder whose parameters
// are bfloat16 (init_params(..., dtype=jnp.bfloat16)):
// _flash_attention_bwd_dkv -> _flash_attention_dkv_kernel, and
// _flash_attention_bwd_dq -> _flash_attention_dq_kernel, with bf16 operands.
//   -> flash_attention_bwd_dkv_bf16 (K7), flash_attention_bwd_dq_bf16 (K8)
//
// For q, k, v, dO (B, NH, S, HD) bf16, segment ids seg (B, S), the forward's
// row log-sum-exp lse (B, NH, S) and delta = rowsum(dO * O) (B, NH, S), both
// float32, the function of the TPU kernels at their rounding points:
//   s[i, j]  = dot(q_i, k_j) (float32 accumulation) * scale
//   P[i, j]  = seg[i] == seg[j] ? exp(s[i, j] - lse_i) : 0        (float32)
//   dV       = bf16(P)^T dO                                      (float32 sums)
//   dS[i, j] = P[i, j] * (dot(dO_i, v_j) - delta_i) * scale      (float32)
//   dK       = bf16(dS)^T Q,   dQ = bf16(dS) K                    (float32 sums)
// and the outputs rounded to bf16 once. delta is one torch.sum in the wrapper
// (float32 products), as the TPU code computes it in XLA outside its kernels.
//
// Design. Both kernels run on wgmma, one warpgroup a block, and keep the
// (S, S) matrices in registers: a product's float32 accumulator of S^T /
// dS^T (K7) or dS (K8) is rounded to bf16 and packed into the register A
// operand of the next product (the C fragment of two 8-column chunks is the
// A fragment of one k16 step). Each block owns a tile of one (batch, head)
// (64 keys in K7, 64 queries in K8: wgmma's M) and walks the other side in
// steps of W = 64 rows (32 for HD > 64, which keeps the accumulators and
// the step's scores under the register limit), the next step's tiles
// landing while the current one is multiplied. A step whose range of
// segment ids [min, max] does not meet the block's own holds no pair of one
// segment and is skipped (the rule of K6 and of the float32 K7/K8). Rows past
// S land as zeros and are masked; only rows below S are written. No atomics:
// two kernels as on the TPU, so the result is deterministic.
//   - Tiles arrive by TMA, issued by one thread onto one mbarrier a stage
//     (two stages): the block's own two tiles once, each step's two. One
//     copy of a tile serves both of its reads, K-major and MN-major, so no
//     warp re-reads it; the step's per-row values (lse, delta, ids in K7;
//     the key ids in K8) by cp.async. K7's tiles land in wgmma's no-swizzle
//     core-matrix layout, a box row of 16 bytes; K8's in the widest swizzle
//     (32, 64 or 128 bytes) whose row divides HD, a box row of that span.
//   - K7: S^T = K Q^T and dP^T = V dO^T from shared memory; P^T and
//     dS^T * scale made from the accumulators and fed from registers to
//     dV += P^T dO and dK += dS^T Q, whose B is the step's Q / dO tile read
//     MN-major.
//   - K8: S = Q K^T and dP = dO V^T from shared memory; dS * scale fed from
//     registers to dQ += dS K, whose B is the step's K tile read MN-major.
//     The rows' lse, delta and ids stay in registers; a key's id is read
//     once per column pair.
//   - P (float32) is one ex2 of a prescaled argument, then the mask, with
//     no branch; dS * scale = P * (dP * scale - delta * scale).
//   - Each step's wgmma groups are waited inside the step: a wait across the
//     loop's back-edge makes ptxas serialize every wgmma (C7515).
//   - The gradients are staged in shared memory and leave as whole 16-byte
//     pieces.
//
// Work: K7 multiplies 8 * HD operations per (query, key) pair of one segment
// (S, dP, dV, dK), K8 6 * HD (S, dP, dQ), at 989 TFLOP/s of bf16 on paper;
// their bytes (q, k, v, dO read, the gradients written) bound them at the
// training shape. The limits left: TMA boxes of 16-byte rows issue a
// request per 16 bytes, and K7's step loads, still in that form, bound it
// (K8's loop with such boxes and no product at all took as long as the
// whole kernel); in K8 the block's prologue and epilogue (Q, dO in, dQ out:
// the bytes of the bound) stand against about six visited steps, and a
// step's products, its elementwise part and the last product wait for each
// other inside the warpgroup (four blocks an SM overlap them); about 15% of
// the multiplied pairs are masked (64 x 64 tiles at the training lengths).
//
// Layout: q, k, v share one set of element strides (batch, head, sequence),
// dO has its own, the outputs share a third; the last axis is contiguous and
// every row starts on a 16-byte boundary (the tensor maps need 16-byte
// strides too). Any S >= 1; HD a multiple of 16 up to 128.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd_bf16.so flash_attention_bwd_bf16.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_DEVICES = 64;

struct Strides {
    long long b, h, s;  // in elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronous; zeros when !valid (src unread)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// (lo, hi) rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&t);
}

// [lo, hi] of the segment ids of rows first .. first + LEN - 1 below S
// (first < S); every lane of the calling warp gets both. Indices past the
// tile or S repeat its last row, which changes neither bound. Every warp
// computes it for itself, so a block-wide decision on it needs no barrier.
template <int LEN>
__device__ __forceinline__ void seg_range(const int* __restrict__ segb, int first, int S,
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

// the first step start at or after r0 whose W rows meet [lo, hi] (S if none)
template <int W>
__device__ __forceinline__ int next_step(const int* __restrict__ segb, int r0, int S, int lane,
                                         int lo, int hi) {
    for (; r0 < S; r0 += W) {
        int a, b;
        seg_range<W>(segb, r0, S, lane, a, b);
        if (!(b < lo || a > hi)) break;  // the same answer in every warp
    }
    return r0;
}

// ---------------------------------------------------------------------------
// wgmma, mbarriers and TMA: copies of the helpers of
// csrc/flash_attention.cu's bfloat16 kernel (K6), with the widths K7 and K8
// need
// ---------------------------------------------------------------------------

// wgmma matrix descriptor, no swizzle: start address, leading byte offset
// (between core matrices along K) and stride byte offset (between core
// matrices along M or N), all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// the same in the swizzle of SPAN = 32, 64 or 128 bytes that TMA writes
// (slabs of rows of SPAN bytes): K-major, 8-row groups 8 SPAN bytes apart
// (stride byte offset), leading byte offset unused, the start 32 bytes a
// k-step into a row; MN-major, 8-row groups along K 8 SPAN bytes apart
// (stride), slabs along MN lbo apart (leading)
template <int SPAN>
__device__ __forceinline__ uint64_t smem_desc_sw(uint32_t addr, uint32_t lbo) {
    constexpr uint64_t mode = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
    return smem_desc(addr, lbo, 8 * SPAN) | (mode << 62);
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
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
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
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}
// TMA: the box of rows row .. of head h, batch b of a 5-d tensor map
// (make_map) into shared memory at dst, completing on the mbarrier at bar;
// the box lands as column slabs of all its rows, one after the other (the
// core-matrix layout, or a swizzled one). hb_swap: batch is dim 3 and head
// dim 4.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row, int h,
                                         int b, bool hb_swap, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(0),
           "r"(hb_swap ? b : h), "r"(hb_swap ? h : b), "r"(bar)
        : "memory");
}

// d (64 x N, float32) += A (64 x 16, shared) * B (16 x N, shared), both K-major
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

// d (64 x N, float32) += A (64 x 16, registers) * B (16 x N, shared, MN-major)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x, one MUFU instruction (2^-inf = 0); about 2 ulp, far inside the
// bfloat16 rounding that P and dS take next
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// K7's shapes. One warpgroup a block owns KEYS = 64 keys (wgmma's M) and
// walks the query steps of W rows. Tiles are kept in wgmma's no-swizzle
// layout, column-major in 16-byte columns: 16-byte chunk c of row r of an
// R-row tile lies at byte (c * R + r) * 16, so every 8 rows of a column are
// one core matrix (128 contiguous bytes); a TMA box lands in that layout.
// One copy of a Q or dO tile then serves both of its reads: K-major (hd
// along K) as B of S^T and dP^T, MN-major (hd along N) as B of dK and dV.
template <int HD>
struct DkvCfg {
    static constexpr int KEYS = 64;
    static constexpr int THREADS = 128;
    static constexpr int W = HD <= 64 ? 64 : 32;       // queries a step (N of S^T)
    static constexpr int OWN = KEYS * HD * 2;          // bytes of K (or V)
    static constexpr int TILE = W * HD * 2;            // bytes of a step's Q (or dO)
    static constexpr int STAGE = 2 * TILE + 3 * W * 4; // Q, dO, then lse, delta, ids
    // K, V, two stages, then the mbarriers: a stage's Q and dO landed (one
    // a stage), K and V landed
    static constexpr int FULL = 2 * OWN + 2 * STAGE;
    static constexpr int KVBAR = FULL + 2 * 8;
    static constexpr int SMEM = KVBAR + 8;
    static_assert(SMEM <= 232448, "shared memory above the block limit");
};

// K7: one block per (batch, head, tile of 64 keys), one warpgroup; it walks
// the query steps that meet its keys. A step: S^T = K Q^T and dP^T = V dO^T
// (wgmma, both operands in shared memory), P^T and dS^T * scale made from
// the accumulators, rounded to bf16 and packed into wgmma's register A
// fragments, then dV += P^T dO and dK += dS^T Q (wgmma, A from registers).
// One thread asks the TMA for K and V once and for the next step's Q and dO
// while the current step runs (two stages, an mbarrier each); every thread
// copies the next step's lse, delta and ids (cp.async). One block-wide
// barrier a step. dK and dV leave through shared memory as whole 16-byte
// pieces.
template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::THREADS)
bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    bool q_swap, bool do_swap, const float* __restrict__ lse,
                    const float* __restrict__ delta, const int* __restrict__ seg,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int NH, int S,
                    Strides os, float scale)
{
    using C = DkvCfg<HD>;
    constexpr int W = C::W, KEYS = C::KEYS, NT = C::THREADS;
    // descriptors' offsets between core matrices: K-major (K, V as A; Q, dO
    // as B of S^T, dP^T): along hd a column (R x 16 bytes) on, along the rows
    // 128 bytes on; MN-major (Q, dO as B of dK, dV): along the queries 128
    // bytes on, along hd a column on
    constexpr uint32_t KV_COL = KEYS * 16, Q_COL = W * 16, CORE = 128;
    extern __shared__ __align__(128) unsigned char smem7[];  // TMA lands on 128-byte boundaries
    const uint32_t sb = smem_u32(smem7);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t k_sm = sb, v_sm = sb + C::OWN;
    auto q_sm = [&](int st) { return sb + 2 * C::OWN + st * C::STAGE; };
    auto o_sm = [&](int st) { return q_sm(st) + C::TILE; };
    auto rows = [&](int st) {  // lse at [0, W), delta at [W, 2W), ids at [2W, 3W)
        return reinterpret_cast<const float*>(smem7 + 2 * C::OWN + st * C::STAGE + 2 * C::TILE);
    };
    auto full = [&](int st) { return sb + C::FULL + 8 * st; };

    const int ntiles = (S + KEYS - 1) / KEYS;
    const int bh = blockIdx.x / ntiles;
    const int n0 = (blockIdx.x - bh * ntiles) * KEYS;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const float* lseb = lse + (size_t)bh * S;
    const float* deltab = delta + (size_t)bh * S;
    if (tid == 0) {
        mbar_init(full(0), 1);
        mbar_init(full(1), 1);
        mbar_init(sb + C::KVBAR, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a step's Q and dO tiles by TMA (rows past S land as zeros), its lse,
    // delta and ids by cp.async
    auto load_step = [&](int st, int m0) {
        if (tid == 0) {
            mbar_expect_tx(full(st), 2 * C::TILE);
            tma_load(q_sm(st), &tq, m0, h, b, q_swap, full(st));
            tma_load(o_sm(st), &tdo, m0, h, b, do_swap, full(st));
        }
        const uint32_t r = q_sm(st) + 2 * C::TILE;
        for (int i = tid; i < W; i += NT) {
            const bool ok = m0 + i < S;
            const int at = ok ? m0 + i : 0;
            cp_async4(r + 4 * i, lseb + at, ok);
            cp_async4(r + 4 * (W + i), deltab + at, ok);
            cp_async4(r + 4 * (2 * W + i), segb + at, ok);
        }
        cp_async_commit();
    };

    int klo, khi;
    seg_range<KEYS>(segb, n0, S, lane, klo, khi);
    if (tid == 0) {
        mbar_expect_tx(sb + C::KVBAR, 2 * C::OWN);
        tma_load(k_sm, &tk, n0, h, b, q_swap, sb + C::KVBAR);
        tma_load(v_sm, &tv, n0, h, b, q_swap, sb + C::KVBAR);
    }
    int m0 = next_step<W>(segb, 0, S, lane, klo, khi);
    if (m0 < S) load_step(0, m0);
    int mn = next_step<W>(segb, m0 + W, S, lane, klo, khi);  // the step after m0 (S: none)

    // this thread's keys, the accumulators' rows g and g + 8 of its warp's
    // 16; a key past S is computed on zeros and never written, so its id is
    // any one
    const int row0 = 16 * warp + g;
    const int ks0 = segb[min(n0 + row0, S - 1)], ks1 = segb[min(n0 + row0 + 8, S - 1)];
    const float scale2 = scale * LOG2E;

    float adk[HD / 2], adv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
        adk[i] = 0.f;
        adv[i] = 0.f;
    }

    mbar_wait(sb + C::KVBAR, 0);
    int st = 0, uses = 0;  // uses: steps taken (stage st's phase: (uses / 2) & 1)
    while (m0 < S) {
        cp_async_wait<0>();                  // this step's lse, delta and ids
        mbar_wait(full(st), (uses >> 1) & 1);  // ... and its Q and dO
        __syncthreads();  // visible to every warp; every warp is done with the other stage
        if (mn < S) load_step(st ^ 1, mn);
        const uint32_t qs = q_sm(st), os_ = o_sm(st);

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x W queries, summed over hd
        float sc[W / 2], dp[W / 2];
#pragma unroll
        for (int i = 0; i < W / 2; ++i) {
            sc[i] = 0.f;
            dp[i] = 0.f;
        }
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
            wgmma_ss<W>(sc, smem_desc(k_sm + ks * 2 * KV_COL, KV_COL, CORE),
                        smem_desc(qs + ks * 2 * Q_COL, Q_COL, CORE));
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks)
            wgmma_ss<W>(dp, smem_desc(v_sm + ks * 2 * KV_COL, KV_COL, CORE),
                        smem_desc(os_ + ks * 2 * Q_COL, Q_COL, CORE));
        wgmma_commit();
        const int mnn = next_step<W>(segb, mn < S ? mn + W : S, S, lane, klo, khi);  // meanwhile
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // P^T and dS^T * scale in place: key rows g (sc[4j], sc[4j + 1]) and
        // g + 8 (sc[4j + 2], sc[4j + 3]), query columns 8j + 2t + {0, 1}.
        // P = 2^(s * scale * log2 e - lse * log2 e), then the mask (a column
        // past S takes lse = inf, so its P is 0); dS * scale = P * (dP * scale
        // - delta * scale).
        const float* lse_s = rows(st);
        const float* dl_s = lse_s + W;
        const int* sq_s = reinterpret_cast<const int*>(lse_s + 2 * W);
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
            const int col = 8 * j + 2 * t;
            const float2 l = *reinterpret_cast<const float2*>(lse_s + col);
            const float2 dl = *reinterpret_cast<const float2*>(dl_s + col);
            const int2 sq = *reinterpret_cast<const int2*>(sq_s + col);
            const float l0 = m0 + col < S ? l.x * LOG2E : INFINITY;
            const float l1 = m0 + col + 1 < S ? l.y * LOG2E : INFINITY;
            const float lz[4] = {l0, l1, l0, l1};
            const float dz[4] = {dl.x * scale, dl.y * scale, dl.x * scale, dl.y * scale};
            const bool vis[4] = {sq.x == ks0, sq.y == ks0, sq.x == ks1, sq.y == ks1};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = fast_exp2(fmaf(sc[4 * j + e], scale2, -lz[e]));
                const float p = vis[e] ? x : 0.f;
                sc[4 * j + e] = p;
                dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, -dz[e]);
            }
        }
        // the C fragments of two 8-column chunks, packed to bf16, are one
        // register A fragment of 16 queries
        uint32_t pa[W / 16][4], sa[W / 16][4];
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
                sa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
            }

        // dV += bf16(P^T) dO, dK += bf16(dS^T) Q over the step's queries
        fence_regs(adv);
        fence_regs(adk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
            wgmma_rs<HD>(adv, pa[kk], smem_desc(os_ + kk * 2 * CORE, CORE, Q_COL));
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
            wgmma_rs<HD>(adk, sa[kk], smem_desc(qs + kk * 2 * CORE, CORE, Q_COL));
        wgmma_commit();
        wgmma_wait<0>();  // this stage is refilled after the next barrier
        fence_regs(adv);
        fence_regs(adk);
        st ^= 1;
        ++uses;
        m0 = mn;
        mn = mnn;
    }

    // dK and dV rounded once and staged row-major in shared memory, rows
    // HD + 8 elements apart (the 8 rows a warp writes at once fall on
    // distinct banks): row g of the warp's 16 from adk[4j], adk[4j + 1], row
    // g + 8 from adk[4j + 2], adk[4j + 3], columns 8j + 2t + {0, 1}. Then
    // they leave as whole 16-byte pieces, a warp covering whole rows.
    constexpr int LDO = HD + 8;
    static_assert(2 * KEYS * LDO * 2 <= C::FULL, "dK and dV fit beside the barriers");
    __syncthreads();  // every warp is done with K, V and the stages
    __nv_bfloat16* ok = reinterpret_cast<__nv_bfloat16*>(smem7);
    __nv_bfloat16* ov = ok + KEYS * LDO;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
            const int at = (row0 + 8 * half) * LDO + 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(ok + at) =
                __floats2bfloat162_rn(adk[4 * j + 2 * half], adk[4 * j + 2 * half + 1]);
            *reinterpret_cast<__nv_bfloat162*>(ov + at) =
                __floats2bfloat162_rn(adv[4 * j + 2 * half], adv[4 * j + 2 * half + 1]);
        }
    __syncthreads();
    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
    for (int idx = tid; idx < KEYS * HD / 8; idx += NT) {
        const int r = idx / (HD / 8), ch = idx - r * (HD / 8);
        if (n0 + r >= S) continue;
        const size_t o = out_off + (size_t)(n0 + r) * os.s + 8 * ch;
        *reinterpret_cast<uint4*>(dk + o) = *reinterpret_cast<const uint4*>(ok + r * LDO + 8 * ch);
        *reinterpret_cast<uint4*>(dv + o) = *reinterpret_cast<const uint4*>(ov + r * LDO + 8 * ch);
    }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// K8's shapes: K7's with the roles of queries and keys swapped. One
// warpgroup a block owns QUERIES = 64 queries (wgmma's M) and walks the key
// steps of W rows. One copy of a K tile serves both of its reads: K-major
// (hd along K) as B of S, MN-major (hd along N) as B of dQ.
template <int HD>
struct DqCfg {
    static constexpr int QUERIES = 64;
    static constexpr int THREADS = 128;
    static constexpr int W = HD <= 64 ? 64 : 32;       // keys a step (N of S)
    // tiles as slabs of rows of SPAN bytes (the widest swizzle whose row
    // divides HD), SPAN / 2 columns each: tile (R rows) element (r, c) lies
    // in slab c / EL, row r, column c % EL, before the swizzle
    static constexpr int SPAN = HD % 64 == 0 ? 128 : HD % 32 == 0 ? 64 : 32;
    static constexpr int EL = SPAN / 2;
    static constexpr int OWN = QUERIES * HD * 2;       // bytes of Q (or dO)
    static constexpr int TILE = W * HD * 2;            // bytes of a step's K (or V)
    // Q, dO, the two stages' K and V, their key ids, then the mbarriers: a
    // stage's K and V landed (one a stage), Q and dO landed
    static constexpr int IDS = 2 * OWN + 4 * TILE;
    static constexpr int FULL = IDS + 2 * W * 4;
    static constexpr int QBAR = FULL + 2 * 8;
    static constexpr int SMEM = QBAR + 8;
    static_assert(OWN % 1024 == 0 && TILE % 1024 == 0, "tiles off the swizzle's 1024 bytes");
    static_assert(SMEM <= 232448, "shared memory above the block limit");
};

// K8: one block per (batch, head, tile of 64 queries), one warpgroup; it
// walks the key steps that meet its queries. A step: S = Q K^T and
// dP = dO V^T (wgmma, both operands in shared memory), dS * scale made from
// the accumulators, rounded to bf16 and packed into wgmma's register A
// fragments, then dQ += dS K (wgmma, A from registers). One thread asks the
// TMA for Q and dO once and for the next step's K and V while the current
// step runs (two stages, an mbarrier each); every thread copies the next
// step's key ids (cp.async). The rows' lse, delta and ids stay in registers.
// One block-wide barrier a step. dQ leaves through shared memory as whole
// 16-byte pieces. At most 128 registers, so four blocks share an SM up to
// hd = 96 (three above, by shared memory).
template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::THREADS, 4)
bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   bool q_swap, bool do_swap, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ seg,
                   __nv_bfloat16* __restrict__ dq, int NH, int S, Strides os, float scale)
{
    using C = DqCfg<HD>;
    constexpr int W = C::W, QUERIES = C::QUERIES, NT = C::THREADS;
    extern __shared__ __align__(1024) unsigned char smem8[];  // the swizzles repeat every 1024 bytes
    const uint32_t sb = smem_u32(smem8);
    if (sb % 1024 != 0) __trap();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_sm = sb, o_sm = sb + C::OWN;
    auto k_sm = [&](int st) { return sb + 2 * C::OWN + st * 2 * C::TILE; };
    auto v_sm = [&](int st) { return k_sm(st) + C::TILE; };
    auto ids = [&](int st) { return reinterpret_cast<const int*>(smem8 + C::IDS) + st * W; };
    // descriptors: K-major, k-step kk of an R-row tile; MN-major, the step's
    // K tile from key 16 kk
    constexpr int SPAN = C::SPAN, KPS = C::EL / 16;  // k-steps a slab row
    auto kdesc = [&](uint32_t base, int R, int kk) {
        return smem_desc_sw<SPAN>(base + (kk / KPS) * R * SPAN + (kk % KPS) * 32, 16);
    };
    auto ndesc = [&](uint32_t ks, int kk) {
        return smem_desc_sw<SPAN>(ks + kk * 16 * SPAN, W * SPAN);
    };
    auto full = [&](int st) { return sb + C::FULL + 8 * st; };

    const int ntiles = (S + QUERIES - 1) / QUERIES;
    const int bh = blockIdx.x / ntiles;
    const int m0 = (blockIdx.x - bh * ntiles) * QUERIES;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    if (tid == 0) {
        mbar_init(full(0), 1);
        mbar_init(full(1), 1);
        mbar_init(sb + C::QBAR, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // a step's K and V tiles by TMA (rows past S land as zeros), its key ids
    // by cp.async (zeros past S)
    auto load_step = [&](int st, int n0) {
        if (tid == 0) {
            mbar_expect_tx(full(st), 2 * C::TILE);
            tma_load(k_sm(st), &tk, n0, h, b, q_swap, full(st));
            tma_load(v_sm(st), &tv, n0, h, b, q_swap, full(st));
        }
        const uint32_t r = sb + C::IDS + st * W * 4;
        for (int i = tid; i < W; i += NT) {
            const bool ok = n0 + i < S;
            cp_async4(r + 4 * i, segb + (ok ? n0 + i : 0), ok);
        }
        cp_async_commit();
    };

    int qlo, qhi;
    seg_range<QUERIES>(segb, m0, S, lane, qlo, qhi);
    if (tid == 0) {
        mbar_expect_tx(sb + C::QBAR, 2 * C::OWN);
        tma_load(q_sm, &tq, m0, h, b, q_swap, sb + C::QBAR);
        tma_load(o_sm, &tdo, m0, h, b, do_swap, sb + C::QBAR);
    }
    int n0 = next_step<W>(segb, 0, S, lane, qlo, qhi);
    if (n0 < S) load_step(0, n0);
    int nn = next_step<W>(segb, n0 + W, S, lane, qlo, qhi);  // the step after n0 (S: none)

    // this thread's queries, the accumulators' rows g and g + 8 of its
    // warp's 16: lse * log2 e, delta * scale and the id of each; a query past
    // S is computed on zeros and never written
    const int row0 = 16 * warp + g;
    const size_t rb = (size_t)bh * S;
    float lz[2], dz[2];
    int sq[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int r = m0 + row0 + 8 * hf;
        const bool ok = r < S;
        lz[hf] = ok ? lse[rb + r] * LOG2E : 0.f;
        dz[hf] = ok ? delta[rb + r] * scale : 0.f;
        sq[hf] = ok ? segb[r] : 0;
    }
    const float scale2 = scale * LOG2E;

    float adq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) adq[i] = 0.f;

    mbar_wait(sb + C::QBAR, 0);
    int st = 0, uses = 0;  // uses: steps taken (stage st's phase: (uses / 2) & 1)
    while (n0 < S) {
        cp_async_wait<0>();                  // this step's key ids
        mbar_wait(full(st), (uses >> 1) & 1);  // ... and its K and V
        __syncthreads();  // visible to every warp; every warp is done with the other stage
        if (nn < S) load_step(st ^ 1, nn);
        const uint32_t ks = k_sm(st), vs = v_sm(st);

        // S = Q K^T and dP = dO V^T: 64 queries x W keys, summed over hd
        float sc[W / 2], dp[W / 2];
#pragma unroll
        for (int i = 0; i < W / 2; ++i) {
            sc[i] = 0.f;
            dp[i] = 0.f;
        }
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<W>(sc, kdesc(q_sm, QUERIES, kk), kdesc(ks, W, kk));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<W>(dp, kdesc(o_sm, QUERIES, kk), kdesc(vs, W, kk));
        wgmma_commit();
        const int nnn = next_step<W>(segb, nn < S ? nn + W : S, S, lane, qlo, qhi);  // meanwhile
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // dS * scale in place: query rows g (dp[4j], dp[4j + 1]) and g + 8
        // (dp[4j + 2], dp[4j + 3]), key columns 8j + 2t + {0, 1}.
        // P = 2^(s * scale * log2 e - lse * log2 e) in float32, then the mask
        // (one segment, and the key below S: ids past S read as 0, which a
        // query may hold); dS * scale = P * (dP * scale - delta * scale)
        const int* sk_s = ids(st);
        const int keys = S - n0;  // of the step's columns, those below S
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
            const int col = 8 * j + 2 * t;
            const int2 sk = *reinterpret_cast<const int2*>(sk_s + col);
            const bool in0 = col < keys, in1 = col + 1 < keys;
            const bool vis[4] = {in0 && sk.x == sq[0], in1 && sk.y == sq[0],
                                 in0 && sk.x == sq[1], in1 && sk.y == sq[1]};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = fast_exp2(fmaf(sc[4 * j + e], scale2, -lz[e >> 1]));
                const float p = vis[e] ? x : 0.f;
                dp[4 * j + e] = p * fmaf(dp[4 * j + e], scale, -dz[e >> 1]);
            }
        }
        // the C fragments of two 8-column chunks, packed to bf16, are one
        // register A fragment of 16 keys
        uint32_t sa[W / 16][4];
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
                sa[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

        // dQ += bf16(dS * scale) K over the step's keys
        fence_regs(adq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk)
            wgmma_rs<HD>(adq, sa[kk], ndesc(ks, kk));
        wgmma_commit();
        wgmma_wait<0>();  // this stage is refilled after the next barrier
        fence_regs(adq);
        st ^= 1;
        ++uses;
        n0 = nn;
        nn = nnn;
    }

    // dQ rounded once and staged row-major in shared memory, rows HD + 8
    // elements apart (the 8 rows a warp writes at once fall on distinct
    // banks): row g of the warp's 16 from adq[4j], adq[4j + 1], row g + 8
    // from adq[4j + 2], adq[4j + 3], columns 8j + 2t + {0, 1}. Then it leaves
    // as whole 16-byte pieces, a warp covering whole rows.
    constexpr int LDO = HD + 8;
    static_assert(QUERIES * LDO * 2 <= C::FULL, "dQ fits beside the barriers");
    __syncthreads();  // every warp is done with Q, dO and the stages
    __nv_bfloat16* oq = reinterpret_cast<__nv_bfloat16*>(smem8);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(oq + (row0 + 8 * half) * LDO + 8 * j + 2 * t) =
                __floats2bfloat162_rn(adq[4 * j + 2 * half], adq[4 * j + 2 * half + 1]);
    __syncthreads();
    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
    for (int idx = tid; idx < QUERIES * HD / 8; idx += NT) {
        const int r = idx / (HD / 8), ch = idx - r * (HD / 8);
        if (m0 + r >= S) continue;
        *reinterpret_cast<uint4*>(dq + out_off + (size_t)(m0 + r) * os.s + 8 * ch) =
            *reinterpret_cast<const uint4*>(oq + r * LDO + 8 * ch);
    }
}

struct Problem {
    const __nv_bfloat16 *q, *k, *v, *dout;
    const float *lse, *delta;
    const int* seg;
    __nv_bfloat16 *out0, *out1;  // K7: dK, dV; K8: dQ
    int B, NH, S;
    Strides in, dos, os;
    float scale;
    cudaStream_t stream;
};

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

// A 5-d tensor map over a bf16 (B, NH, S, HD) tensor with element strides st,
// whose boxes are rows rows of the sequence, every element of them, landing
// as column slabs of all the rows, one after the other: dim 0 is a slab's
// part of a row, dim 1 the sequence, dim 2 the row's slabs, dims 3 and 4
// head and batch, the smaller stride first (hb_swap: batch first). A slab is
// 16 bytes wide in the no-swizzle core-matrix layout (span = 0), or span =
// 32, 64 or 128 bytes in the swizzle of that span. Rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, Strides st, const Problem& p, int HD, int rows,
             bool& hb_swap, int span = 0) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    hb_swap = st.b < st.h;
    const long long hs = hb_swap ? st.b : st.h, bs = hb_swap ? st.h : st.b;
    const int hn = hb_swap ? p.B : p.NH, bn = hb_swap ? p.NH : p.B;
    const int cw = span ? span / 2 : 8;  // elements of a box row
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(cw), static_cast<cuuint64_t>(p.S),
                                static_cast<cuuint64_t>(HD / cw), static_cast<cuuint64_t>(hn),
                                static_cast<cuuint64_t>(bn)};
    const cuuint64_t strides[4] = {static_cast<cuuint64_t>(st.s) * 2,
                                   static_cast<cuuint64_t>(cw) * 2,
                                   static_cast<cuuint64_t>(hs) * 2,
                                   static_cast<cuuint64_t>(bs) * 2};
    const cuuint32_t box[5] = {static_cast<cuuint32_t>(cw), static_cast<cuuint32_t>(rows),
                               static_cast<cuuint32_t>(HD / cw), 1, 1};
    const cuuint32_t one[5] = {1, 1, 1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides, box,
        one, CU_TENSOR_MAP_INTERLEAVE_NONE,
        span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
        : span == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// The shared-memory attribute, set once per device and kernel (ready is the
// kernel's own table, by device).
template <typename Kernel>
int allow_smem(Kernel* kernel, int smem, bool (&ready)[MAX_DEVICES]) {
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

// Blocks (B * NH * ceil(S / rows)), after allow_smem.
template <typename Kernel>
int prepare(const Problem& p, Kernel* kernel, int smem, int rows, bool (&ready)[MAX_DEVICES],
            int& blocks) {
    if (p.B <= 0 || p.NH <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = (long long)p.B * p.NH * ((p.S + rows - 1) / rows);
    if (n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    blocks = static_cast<int>(n);
    return allow_smem(kernel, smem, ready);
}

template <int HD>
struct Dkv {
    static bool ready[MAX_DEVICES];
    static int launch(const Problem& p) {
        using C = DkvCfg<HD>;
        int blocks;
        if (int e = prepare(p, bwd_dkv_bf16_kernel<HD>, C::SMEM, C::KEYS, ready, blocks))
            return e;
        CUtensorMap tq, tdo, tk, tv;
        bool q_swap, do_swap;
        if (int e = make_map(&tq, p.q, p.in, p, HD, C::W, q_swap)) return e;
        if (int e = make_map(&tk, p.k, p.in, p, HD, C::KEYS, q_swap)) return e;
        if (int e = make_map(&tv, p.v, p.in, p, HD, C::KEYS, q_swap)) return e;
        if (int e = make_map(&tdo, p.dout, p.dos, p, HD, C::W, do_swap)) return e;
        bwd_dkv_bf16_kernel<HD><<<blocks, C::THREADS, C::SMEM, p.stream>>>(
            tq, tdo, tk, tv, q_swap, do_swap, p.lse, p.delta, p.seg, p.out0, p.out1, p.NH, p.S,
            p.os, p.scale);
        return static_cast<int>(cudaGetLastError());
    }
    static int occupancy(int& blocks) {
        using C = DkvCfg<HD>;
        if (int e = allow_smem(bwd_dkv_bf16_kernel<HD>, C::SMEM, ready)) return e;
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, bwd_dkv_bf16_kernel<HD>, C::THREADS, C::SMEM));
    }
};
template <int HD>
bool Dkv<HD>::ready[MAX_DEVICES];

template <int HD>
struct Dq {
    static bool ready[MAX_DEVICES];
    static int launch(const Problem& p) {
        using C = DqCfg<HD>;
        int blocks;
        if (int e = prepare(p, bwd_dq_bf16_kernel<HD>, C::SMEM, C::QUERIES, ready, blocks))
            return e;
        CUtensorMap tq, tdo, tk, tv;
        bool q_swap, do_swap;
        if (int e = make_map(&tq, p.q, p.in, p, HD, C::QUERIES, q_swap, C::SPAN)) return e;
        if (int e = make_map(&tk, p.k, p.in, p, HD, C::W, q_swap, C::SPAN)) return e;
        if (int e = make_map(&tv, p.v, p.in, p, HD, C::W, q_swap, C::SPAN)) return e;
        if (int e = make_map(&tdo, p.dout, p.dos, p, HD, C::QUERIES, do_swap, C::SPAN)) return e;
        bwd_dq_bf16_kernel<HD><<<blocks, C::THREADS, C::SMEM, p.stream>>>(
            tq, tdo, tk, tv, q_swap, do_swap, p.lse, p.delta, p.seg, p.out0, p.NH, p.S, p.os,
            p.scale);
        return static_cast<int>(cudaGetLastError());
    }
    static int occupancy(int& blocks) {
        using C = DqCfg<HD>;
        if (int e = allow_smem(bwd_dq_bf16_kernel<HD>, C::SMEM, ready)) return e;
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, bwd_dq_bf16_kernel<HD>, C::THREADS, C::SMEM));
    }
};
template <int HD>
bool Dq<HD>::ready[MAX_DEVICES];

// Kernel<HD>::launch(p) or Kernel<HD>::occupancy(blocks) for the head width
template <template <int> class Kernel, typename F>
int dispatch(int HD, F&& f) {
#define BWD_CASE(N) \
    case N: return f(Kernel<N>{});
    switch (HD) {
        BWD_CASE(16) BWD_CASE(32) BWD_CASE(48) BWD_CASE(64)
        BWD_CASE(80) BWD_CASE(96) BWD_CASE(112) BWD_CASE(128)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BWD_CASE
}

using bf16 = __nv_bfloat16;

}  // namespace

// q, k, v: element (b, h, s, d) at b*in_b + h*in_h + s*in_s + d; dout with the
// do_* strides; dk, dv (K7) and dq (K8) with the out_* strides; lse and delta
// (B, NH, S) float32 and seg (B, S) int32, contiguous. Strides in elements.
// Returns the cudaError of the launch (0 = launched), or 10001 / 10002 when
// cuTensorMapEncodeTiled is missing or refuses a layout.
extern "C" int flash_attention_bwd_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                                            const bf16* dout, const float* lse,
                                            const float* delta, const int* seg, bf16* dk,
                                            bf16* dv, int B, int NH, int S, int HD,
                                            long long in_b, long long in_h, long long in_s,
                                            long long do_b, long long do_h, long long do_s,
                                            long long out_b, long long out_h, long long out_s,
                                            float sm_scale, void* stream)
{
    const Problem p{q, k, v, dout, lse, delta, seg, dk, dv, B, NH, S, {in_b, in_h, in_s},
                    {do_b, do_h, do_s}, {out_b, out_h, out_s}, sm_scale,
                    static_cast<cudaStream_t>(stream)};
    return dispatch<Dkv>(HD, [&](auto kern) { return kern.launch(p); });
}

extern "C" int flash_attention_bwd_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                                           const bf16* dout, const float* lse,
                                           const float* delta, const int* seg, bf16* dq,
                                           int B, int NH, int S, int HD,
                                           long long in_b, long long in_h, long long in_s,
                                           long long do_b, long long do_h, long long do_s,
                                           long long out_b, long long out_h, long long out_s,
                                           float sm_scale, void* stream)
{
    const Problem p{q, k, v, dout, lse, delta, seg, dq, nullptr, B, NH, S, {in_b, in_h, in_s},
                    {do_b, do_h, do_s}, {out_b, out_h, out_s}, sm_scale,
                    static_cast<cudaStream_t>(stream)};
    return dispatch<Dq>(HD, [&](auto kern) { return kern.launch(p); });
}

// Blocks of K7 (dkv != 0) or K8 that one SM holds at once at head width hd,
// from the kernel's registers, threads and shared memory; into *blocks.
// Returns the cudaError (0 = answered).
extern "C" int flash_attention_bwd_bf16_blocks_per_sm(int hd, int dkv, int* blocks)
{
    return dkv ? dispatch<Dkv>(hd, [&](auto kern) { return kern.occupancy(*blocks); })
               : dispatch<Dq>(hd, [&](auto kern) { return kern.occupancy(*blocks); });
}
