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
// Design: mma.sync m16n8k16 (bf16 in, float32 accumulators) fed by ldmatrix,
// with cp.async double buffering; the first, simple tensor-core form (a
// wgmma / TMA redesign is later work). Every product is one of two shapes:
//   - both operands from shared memory: in K7 S^T = K Q^T and dP^T = V dO^T,
//     in K8 S = Q K^T and dP = dO V^T (ldmatrix without .trans: the tiles
//     are K-major along hd);
//   - A from registers: the just-computed float32 accumulator of S^T / dS^T
//     (K7) or dS (K8), rounded to bf16 and packed in place (the C fragment of
//     two n-tiles of m16n8 is the A fragment of one k16 step), B a (rows x hd)
//     tile read with ldmatrix.trans: dV += P^T dO, dK += dS^T Q, dQ += dS K.
// So the (S, S) matrices never leave registers. Each warp owns 16 rows of the
// block's tile (keys in K7, queries in K8): a block of 4 warps takes 64 keys
// (K7) or 64 queries (K8) of one (batch, head) and walks the other side in
// steps of W = 64 rows (32 for HD > 64, which keeps the dK/dV accumulators and
// the step's scores under the register limit), the next step's tiles landing
// by cp.async while the current one is multiplied. A step whose range of
// segment ids [min, max] does not meet the block's own holds no pair of one
// segment and is skipped (the rule of K6 and of the float32 K7/K8). Rows past
// S land as zeros (cp.async's zero fill) and are masked; only rows below S are
// written. No atomics: two kernels as on the TPU, so the result is
// deterministic.
//
// Work: K7 multiplies 8 * HD operations per (query, key) pair of one segment
// (S, dP, dV, dK), K8 6 * HD (S, dP, dQ), at 989 TFLOP/s of bf16 on paper;
// their bytes (q, k, v, dO read, the gradients written) bound them at the
// training shape. This design's limits are the latency between the
// dependent products of a step and the exp per pair.
//
// Layout: q, k, v share one set of element strides (batch, head, sequence),
// dO has its own, the outputs share a third; the last axis is contiguous and
// every row starts on a 16-byte boundary. Any S >= 1; HD a multiple of 16 up
// to 128.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd_bf16.so flash_attention_bwd_bf16.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 64;        // the block's own rows: keys (K7) or queries (K8)
constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int MAX_DEVICES = 64;

struct Strides {
    long long b, h, s;  // in elements
};

template <int HD>
struct Cfg {
    static constexpr int W = HD <= 64 ? 64 : 32;  // rows of the other side per step
    static constexpr int LD = HD + 8;  // shared row stride (elements): ldmatrix conflict-free
    static constexpr int CH = HD / 8;  // 16-byte chunks of a row
    static constexpr int OWN = 2 * BT * LD;  // the block's two resident tiles
    static constexpr int STEP = 2 * W * LD;  // one step's two tiles
    // bf16 tiles, then float32 lse and delta and int ids of each stage
    static constexpr int SMEM = (OWN + 2 * STEP) * 2 + 2 * 3 * W * 4;
    static_assert(SMEM <= 232448, "shared memory above the block limit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 / 4 bytes global -> shared, asynchronous; zeros when !valid (src unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16 x 8) += a (16 x 16, row-major) * b (16 x 8, column-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&t);
}

// Shared-memory address that lane gives ldmatrix for:
//  a_addr: the A fragment (rows r0 .. r0 + 15, columns c0 .. c0 + 15) of a
//          row-major tile;
//  b_addr: the B fragments of two n-tiles (rows r0 .. r0 + 15 of the tile are
//          the 16 n, columns c0 .. c0 + 15 the k) - regs {b0, b1} of n-tile 0
//          then of n-tile 1;
//  bt_addr: the same from a tile whose rows are the k (rows r0 .. r0 + 15)
//          and columns the n (c0 .. c0 + 15), for ldmatrix.trans.
template <int LD>
__device__ __forceinline__ uint32_t a_addr(uint32_t base, int lane, int r0, int c0) {
    return base + 2 * ((r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t b_addr(uint32_t base, int lane, int r0, int c0) {
    const int m = lane >> 3;
    return base + 2 * ((r0 + (m >> 1) * 8 + (lane & 7)) * LD + c0 + (m & 1) * 8);
}
template <int LD>
__device__ __forceinline__ uint32_t bt_addr(uint32_t base, int lane, int r0, int c0) {
    const int m = lane >> 3;
    return base + 2 * ((r0 + (m & 1) * 8 + (lane & 7)) * LD + c0 + (m >> 1) * 8);
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

// rows r0 .. r0 + R - 1 of one (batch, head) of a bf16 (.., S, HD) tensor
// whose rows are ss elements apart -> a shared tile at dst (row stride LD);
// zeros past S
template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          long long ss, int r0, int S) {
    using C = Cfg<HD>;
    for (int idx = threadIdx.x; idx < R * C::CH; idx += THREADS) {
        const int r = idx / C::CH;
        const int c = idx - r * C::CH;
        const bool ok = r0 + r < S;
        cp_async16(dst + 2 * (r * C::LD + 8 * c), src + (ok ? (r0 + r) * ss + 8 * c : 0), ok);
    }
}

// K7: one block per (batch, head, tile of 64 keys); warp w owns keys
// n0 + 16 w .. + 15 and walks the query steps that meet them
template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int NH, int S, Strides in, Strides dos,
                    Strides os, float scale)
{
    using C = Cfg<HD>;
    constexpr int W = C::W, LD = C::LD, NQ = W / 8, ND = HD / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    const uint32_t sb = smem_u32(smem);
    const uint32_t Ks = sb, Vs = sb + 2 * BT * LD;
    auto Qs = [&](int st) { return sb + 2 * (C::OWN + st * C::STEP); };
    auto dOs = [&](int st) { return Qs(st) + 2 * W * LD; };
    float* rows = reinterpret_cast<float*>(smem + 2 * (C::OWN + 2 * C::STEP));
    // stage st: lse at rows[st * 3W], delta at + W, ids (int) at + 2W
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;

    const int ntiles = (S + BT - 1) / BT;
    const int bh = blockIdx.x / ntiles;
    const int n0 = (blockIdx.x - bh * ntiles) * BT;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const size_t in_off = (size_t)b * in.b + (size_t)h * in.h;
    const __nv_bfloat16* qb = q + in_off;
    const __nv_bfloat16* dob = dout + (size_t)b * dos.b + (size_t)h * dos.h;
    const float* lseb = lse + (size_t)bh * S;
    const float* deltab = delta + (size_t)bh * S;

    auto load_step = [&](int st, int m0) {
        load_tile<HD, W>(Qs(st), qb, in.s, m0, S);
        load_tile<HD, W>(dOs(st), dob, dos.s, m0, S);
        const uint32_t r = smem_u32(rows + st * 3 * W);
        for (int i = tid; i < W; i += THREADS) {
            const bool ok = m0 + i < S;
            const int at = ok ? m0 + i : 0;
            cp_async4(r + 4 * i, lseb + at, ok);
            cp_async4(r + 4 * (W + i), deltab + at, ok);
            cp_async4(r + 4 * (2 * W + i), segb + at, ok);
        }
    };

    int klo, khi;
    seg_range<BT>(segb, n0, S, lane, klo, khi);
    load_tile<HD, BT>(Ks, k + in_off, in.s, n0, S);
    load_tile<HD, BT>(Vs, v + in_off, in.s, n0, S);
    int m0 = next_step<W>(segb, 0, S, lane, klo, khi);
    if (m0 < S) load_step(0, m0);
    cp_async_commit();

    // this thread's keys: rows g and g + 8 of the warp's 16
    const int key0 = n0 + 16 * warp + g;
    const bool kok0 = key0 < S, kok1 = key0 + 8 < S;
    const int ks0 = kok0 ? segb[key0] : 0, ks1 = kok1 ? segb[key0 + 8] : 0;

    float adk[ND][4], adv[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            adk[j][e] = 0.f;
            adv[j][e] = 0.f;
        }

    int st = 0;
    while (m0 < S) {
        const int mn = next_step<W>(segb, m0 + W, S, lane, klo, khi);
        if (mn < S) {
            load_step(st ^ 1, mn);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x W queries
        float sc[NQ][4], dp[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[j][e] = 0.f;
                dp[j][e] = 0.f;
            }
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
            uint32_t ka[4], va[4];
            ldsm_x4(ka, a_addr<LD>(Ks, lane, 16 * warp, kk));
            ldsm_x4(va, a_addr<LD>(Vs, lane, 16 * warp, kk));
#pragma unroll
            for (int j = 0; j < NQ; j += 2) {
                uint32_t qf[4], of[4];
                ldsm_x4(qf, b_addr<LD>(Qs(st), lane, 8 * j, kk));
                ldsm_x4(of, b_addr<LD>(dOs(st), lane, 8 * j, kk));
                mma(sc[j], ka, qf[0], qf[1]);
                mma(sc[j + 1], ka, qf[2], qf[3]);
                mma(dp[j], va, of[0], of[1]);
                mma(dp[j + 1], va, of[2], of[3]);
            }
        }

        // P^T and dS^T * scale, in place: key rows g (e < 2) and g + 8,
        // query columns 8 j + 2 t + (e & 1)
        const float* lse_s = rows + st * 3 * W;
        const float* dl_s = lse_s + W;
        const int* sq_s = reinterpret_cast<const int*>(lse_s + 2 * W);
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = 8 * j + 2 * t + (e & 1);
                const bool vis = (e < 2 ? kok0 && sq_s[col] == ks0 : kok1 && sq_s[col] == ks1)
                                 && m0 + col < S;
                const float p = vis ? __expf(sc[j][e] * scale - lse_s[col]) : 0.f;
                sc[j][e] = p;
                dp[j][e] = p * (dp[j][e] - dl_s[col]) * scale;
            }

        // dV += bf16(P^T) dO, dK += bf16(dS^T) Q over the step's queries
#pragma unroll
        for (int kq = 0; kq < W / 16; ++kq) {
            const uint32_t pa[4] = {pack_bf16(sc[2 * kq][0], sc[2 * kq][1]),
                                    pack_bf16(sc[2 * kq][2], sc[2 * kq][3]),
                                    pack_bf16(sc[2 * kq + 1][0], sc[2 * kq + 1][1]),
                                    pack_bf16(sc[2 * kq + 1][2], sc[2 * kq + 1][3])};
            const uint32_t sa[4] = {pack_bf16(dp[2 * kq][0], dp[2 * kq][1]),
                                    pack_bf16(dp[2 * kq][2], dp[2 * kq][3]),
                                    pack_bf16(dp[2 * kq + 1][0], dp[2 * kq + 1][1]),
                                    pack_bf16(dp[2 * kq + 1][2], dp[2 * kq + 1][3])};
#pragma unroll
            for (int jd = 0; jd < ND; jd += 2) {
                uint32_t of[4], qf[4];
                ldsm_x4_t(of, bt_addr<LD>(dOs(st), lane, 16 * kq, 8 * jd));
                ldsm_x4_t(qf, bt_addr<LD>(Qs(st), lane, 16 * kq, 8 * jd));
                mma(adv[jd], pa, of[0], of[1]);
                mma(adv[jd + 1], pa, of[2], of[3]);
                mma(adk[jd], sa, qf[0], qf[1]);
                mma(adk[jd + 1], sa, qf[2], qf[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
        st ^= 1;
        m0 = mn;
    }

    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int key = key0 + 8 * half;
        if (key >= S) continue;
        __nv_bfloat16* dkr = dk + out_off + (size_t)key * os.s;
        __nv_bfloat16* dvr = dv + out_off + (size_t)key * os.s;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            const int col = 8 * j + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(dkr + col) =
                __floats2bfloat162_rn(adk[j][2 * half], adk[j][2 * half + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
                __floats2bfloat162_rn(adv[j][2 * half], adv[j][2 * half + 1]);
        }
    }
}

// K8: one block per (batch, head, tile of 64 queries); warp w owns queries
// m0 + 16 w .. + 15 and walks the key steps that meet them
template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, int NH, int S,
                   Strides in, Strides dos, Strides os, float scale)
{
    using C = Cfg<HD>;
    constexpr int W = C::W, LD = C::LD, NK = W / 8, ND = HD / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    const uint32_t sb = smem_u32(smem);
    const uint32_t Qs = sb, dOs = sb + 2 * BT * LD;
    auto Ks = [&](int st) { return sb + 2 * (C::OWN + st * C::STEP); };
    auto Vs = [&](int st) { return Ks(st) + 2 * W * LD; };
    int* segk = reinterpret_cast<int*>(smem + 2 * (C::OWN + 2 * C::STEP));  // [2][W]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;

    const int ntiles = (S + BT - 1) / BT;
    const int bh = blockIdx.x / ntiles;
    const int m0 = (blockIdx.x - bh * ntiles) * BT;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const size_t in_off = (size_t)b * in.b + (size_t)h * in.h;
    const __nv_bfloat16* kb = k + in_off;
    const __nv_bfloat16* vb = v + in_off;

    auto load_step = [&](int st, int n0) {
        load_tile<HD, W>(Ks(st), kb, in.s, n0, S);
        load_tile<HD, W>(Vs(st), vb, in.s, n0, S);
        for (int i = tid; i < W; i += THREADS) {
            const bool ok = n0 + i < S;
            cp_async4(smem_u32(segk + st * W + i), segb + (ok ? n0 + i : 0), ok);
        }
    };

    int qlo, qhi;
    seg_range<BT>(segb, m0, S, lane, qlo, qhi);
    load_tile<HD, BT>(Qs, q + in_off, in.s, m0, S);
    load_tile<HD, BT>(dOs, dout + (size_t)b * dos.b + (size_t)h * dos.h, dos.s, m0, S);
    int n0 = next_step<W>(segb, 0, S, lane, qlo, qhi);
    if (n0 < S) load_step(0, n0);
    cp_async_commit();

    // this thread's queries: rows g and g + 8 of the warp's 16
    const int row0 = m0 + 16 * warp + g;
    const bool qok[2] = {row0 < S, row0 + 8 < S};
    const size_t rb = (size_t)bh * S;
    float lrow[2], drow[2];
    int sq[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int r = row0 + 8 * hf;
        lrow[hf] = qok[hf] ? lse[rb + r] : 0.f;
        drow[hf] = qok[hf] ? delta[rb + r] : 0.f;
        sq[hf] = qok[hf] ? segb[r] : 0;
    }

    float adq[ND][4];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) adq[j][e] = 0.f;

    int st = 0;
    while (n0 < S) {
        const int nn = next_step<W>(segb, n0 + W, S, lane, qlo, qhi);
        if (nn < S) {
            load_step(st ^ 1, nn);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // S = Q K^T and dP = dO V^T for the warp's 16 queries x W keys
        float sc[NK][4], dp[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[j][e] = 0.f;
                dp[j][e] = 0.f;
            }
#pragma unroll
        for (int kk = 0; kk < HD; kk += 16) {
            uint32_t qa[4], oa[4];
            ldsm_x4(qa, a_addr<LD>(Qs, lane, 16 * warp, kk));
            ldsm_x4(oa, a_addr<LD>(dOs, lane, 16 * warp, kk));
#pragma unroll
            for (int j = 0; j < NK; j += 2) {
                uint32_t kf[4], vf[4];
                ldsm_x4(kf, b_addr<LD>(Ks(st), lane, 8 * j, kk));
                ldsm_x4(vf, b_addr<LD>(Vs(st), lane, 8 * j, kk));
                mma(sc[j], qa, kf[0], kf[1]);
                mma(sc[j + 1], qa, kf[2], kf[3]);
                mma(dp[j], oa, vf[0], vf[1]);
                mma(dp[j + 1], oa, vf[2], vf[3]);
            }
        }

        // dS * scale in place: query rows g (e < 2) and g + 8, key columns
        // 8 j + 2 t + (e & 1)
        const int* sk = segk + st * W;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hf = e >> 1;
                const int col = 8 * j + 2 * t + (e & 1);
                const bool vis = qok[hf] && n0 + col < S && sk[col] == sq[hf];
                const float p = vis ? __expf(sc[j][e] * scale - lrow[hf]) : 0.f;
                dp[j][e] = p * (dp[j][e] - drow[hf]) * scale;
            }

        // dQ += bf16(dS) K over the step's keys
#pragma unroll
        for (int kk = 0; kk < W / 16; ++kk) {
            const uint32_t sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                    pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                    pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                    pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
            for (int jd = 0; jd < ND; jd += 2) {
                uint32_t kf[4];
                ldsm_x4_t(kf, bt_addr<LD>(Ks(st), lane, 16 * kk, 8 * jd));
                mma(adq[jd], sa, kf[0], kf[1]);
                mma(adq[jd + 1], sa, kf[2], kf[3]);
            }
        }
        __syncthreads();  // every warp is done with this stage before it is refilled
        st ^= 1;
        n0 = nn;
    }

    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        if (!qok[hf]) continue;
        __nv_bfloat16* dqr = dq + out_off + (size_t)(row0 + 8 * hf) * os.s;
#pragma unroll
        for (int j = 0; j < ND; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * j + 2 * t) =
                __floats2bfloat162_rn(adq[j][2 * hf], adq[j][2 * hf + 1]);
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

// Blocks (B * NH * ceil(S / 64)); the shared-memory attribute is set once per
// device and kernel (ready is the kernel's own table, by device).
template <typename Kernel>
int prepare(const Problem& p, Kernel* kernel, int smem, bool (&ready)[MAX_DEVICES],
            int& blocks) {
    if (p.B <= 0 || p.NH <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = (long long)p.B * p.NH * ((p.S + BT - 1) / BT);
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

template <int HD>
int launch_dkv(const Problem& p) {
    constexpr int smem = Cfg<HD>::SMEM;
    static bool ready[MAX_DEVICES];
    int blocks;
    if (int e = prepare(p, bwd_dkv_bf16_kernel<HD>, smem, ready, blocks)) return e;
    bwd_dkv_bf16_kernel<HD><<<blocks, THREADS, smem, p.stream>>>(
        p.q, p.k, p.v, p.dout, p.lse, p.delta, p.seg, p.out0, p.out1, p.NH, p.S, p.in, p.dos,
        p.os, p.scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const Problem& p) {
    constexpr int smem = Cfg<HD>::SMEM;
    static bool ready[MAX_DEVICES];
    int blocks;
    if (int e = prepare(p, bwd_dq_bf16_kernel<HD>, smem, ready, blocks)) return e;
    bwd_dq_bf16_kernel<HD><<<blocks, THREADS, smem, p.stream>>>(
        p.q, p.k, p.v, p.dout, p.lse, p.delta, p.seg, p.out0, p.NH, p.S, p.in, p.dos, p.os,
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

using bf16 = __nv_bfloat16;

}  // namespace

// q, k, v: element (b, h, s, d) at b*in_b + h*in_h + s*in_s + d; dout with the
// do_* strides; dk, dv (K7) and dq (K8) with the out_* strides; lse and delta
// (B, NH, S) float32 and seg (B, S) int32, contiguous. Strides in elements.
// Returns the cudaError of the launch (0 = launched).
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
    return dispatch<true>(p, HD);
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
    return dispatch<false>(p, HD);
}
