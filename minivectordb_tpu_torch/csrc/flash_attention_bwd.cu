// Flash attention backward with segment ids: K7 (dK, dV) and K8 (dQ), float32.
//
// Replaces the two Pallas TPU kernels that the custom VJP of
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention runs when
// minivectordb_tpu/models/train.py differentiates the encoder
// (_flash_attention_bwd_dkv -> _flash_attention_dkv_kernel, and
// _flash_attention_bwd_dq -> _flash_attention_dq_kernel).
//   -> flash_attention_bwd_dkv_f32 (K7), flash_attention_bwd_dq_f32 (K8)
//
// For q, k, v, dO (B, NH, S, HD), segment ids seg (B, S), the forward's row
// log-sum-exp lse (B, NH, S) and delta = rowsum(dO * O) (B, NH, S):
//   P[i, j]  = seg[i] == seg[j] ? exp(dot(q_i, k_j) * scale - lse_i) : 0
//   dV       = P^T dO
//   dS[i, j] = P[i, j] * (dot(dO_i, v_j) - delta_i)
//   dK       = dS^T Q * scale
//   dQ       = dS K * scale
// all in float32 with IEEE FMAs on the CUDA cores (never TF32), the (S, S)
// matrices never in device memory. delta is one torch.sum in the wrapper, as
// the TPU code computes it in XLA outside its kernels.
//
// Design (the first, simple form; a Hopper redesign with wgmma and TMA is later
// work). Tiles of T = 64 query rows and 64 keys. K7 takes one block per
// (batch, head, key tile): K and V of its keys stay in shared memory, dK and dV
// accumulate in registers, and it walks the query tiles, loading Q, dO, lse and
// delta of each. K8 takes one block per (batch, head, query tile) and walks the
// key tiles the same way, dQ in registers. Per pair of tiles a block computes
// S = Q K^T and dP = dO V^T (thread (ty, tx) of 16 x 16 owns rows ty + 16 i and
// keys tx + 16 j), then P and dS into shared memory (K7 stores them transposed,
// key-major), then the products into its accumulators, each thread owning 4
// rows (keys for K7) and float4 column groups tx + 16 c. A tile whose range of
// segment ids [min, max] does not meet the block's own holds no pair of one
// segment and is skipped: the rule of the forward kernel (seg_range /
// tiles_meeting in flash_attention.cu), so the real-by-pad corners of the
// encoder's "ones, then zeros" ids cost nothing. Rows past S read as zeros and
// are masked; only rows below S are written.
//
// Work: K7 multiplies 8 * HD operations per (query, key) pair of one segment
// (S, dP, dV, dK), K8 6 * HD (S, dP, dQ); both read their inputs a few times
// through L2. Operations bound them on paper (about 67 TFLOP/s of float32 on
// the card); the shared-memory reads that feed the FMAs bound this design: per
// 4 keys of a row a thread reads 2 x 4 + 2 x 4 float4s for 128 FMAs.
//
// Layout: q, k, v share one set of element strides (batch, head, sequence),
// dO has its own, the outputs share a third; the last axis is contiguous and
// every row starts on a 16-byte boundary. Any S >= 1; HD a multiple of 16 up
// to 128.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;         // query rows and keys per tile
constexpr int THREADS = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int PLD = T + 4;    // shared row stride of a P or dS tile
constexpr int MAX_DEVICES = 64;

struct Strides {
    long long b, h, s;  // in elements
};

template <int HD>
struct Cfg {
    static constexpr int LD = HD + 4;  // shared row stride of a Q, K, V or dO tile
    static constexpr int C4 = HD / 4;  // float4 columns of a row
    static constexpr int CG = (C4 + 15) / 16;  // float4 column groups of a thread
    // K7: K, V, Q, dO tiles, P^T and dS^T, lse, delta and both tiles' ids
    static constexpr int DKV_SMEM = (4 * T * LD + 2 * T * PLD + 2 * T) * 4 + 2 * T * 4;
    // K8: Q, dO, K, V tiles, dS, lse, delta and both tiles' ids
    static constexpr int DQ_SMEM = (4 * T * LD + T * PLD + 2 * T) * 4 + 2 * T * 4;
    static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "shared memory above the block limit");
};

// [lo, hi] of the segment ids of rows first .. first + T - 1 below S (first <
// S); every lane of the calling warp gets both (indices past S repeat row
// S - 1, which changes neither bound). Every warp computes it for itself, so
// a block-wide decision on it needs no barrier.
__device__ __forceinline__ void seg_range(const int* __restrict__ segb, int first, int S,
                                          int& lo, int& hi) {
    const int lane = threadIdx.x & 31;
    const int a = segb[min(first + lane, S - 1)];
    const int c = segb[min(first + lane + 32, S - 1)];
    lo = min(a, c);
    hi = max(a, c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
}

// rows r0 .. r0 + T - 1 of one (batch, head) of a (.., S, HD) tensor whose
// rows are ss elements apart -> a shared tile with row stride LD; zeros past S
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long ss, int r0, int S) {
    using C = Cfg<HD>;
    for (int idx = threadIdx.x; idx < T * C::C4; idx += THREADS) {
        const int r = idx / C::C4;
        const int c = idx - r * C::C4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + r < S) x = __ldg(reinterpret_cast<const float4*>(src + (r0 + r) * ss) + c);
        *reinterpret_cast<float4*>(dst + r * C::LD + 4 * c) = x;
    }
}

// lse, delta and segment ids of rows r0 .. r0 + T - 1 (zeros past S)
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s, int* seg_s,
                                          const float* __restrict__ lseb,
                                          const float* __restrict__ deltab,
                                          const int* __restrict__ segb, int r0, int S) {
    for (int r = threadIdx.x; r < T; r += THREADS) {
        const bool ok = r0 + r < S;
        lse_s[r] = ok ? lseb[r0 + r] : 0.f;
        dl_s[r] = ok ? deltab[r0 + r] : 0.f;
        seg_s[r] = ok ? segb[r0 + r] : 0;
    }
}

__device__ __forceinline__ float comp(const float4& x, int u) {
    return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// s = Q K^T and dp = dO V^T for rows ty + 16 i and keys tx + 16 j of the tiles
template <int HD>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
    constexpr int LD = Cfg<HD>::LD;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            s[i][j] = 0.f;
            dp[i][j] = 0.f;
        }
#pragma unroll 2
    for (int kk = 0; kk < HD; kk += 4) {
        float4 kv[4], vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + kk]);
            vv[j] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * j) * LD + kk]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + kk]);
            const float4 ov = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * i) * LD + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
                s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
                s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
                s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
                dp[i][j] = fmaf(ov.x, vv[j].x, dp[i][j]);
                dp[i][j] = fmaf(ov.y, vv[j].y, dp[i][j]);
                dp[i][j] = fmaf(ov.z, vv[j].z, dp[i][j]);
                dp[i][j] = fmaf(ov.w, vv[j].w, dp[i][j]);
            }
        }
    }
}

// P and dS of row ty + 16 i, key tx + 16 j (the rows' lse, delta and ids in
// shared memory): 0 where the segments differ or the row or key lies past S
__device__ __forceinline__ void probs(const float (&s)[4][4], const float (&dp)[4][4],
                                      const float* lse_s, const float* dl_s, const int* segq_s,
                                      const int* segk_s, int m0, int n0, int S, float scale,
                                      int tx, int ty, float (&p)[4][4], float (&ds)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = ty + 16 * i;
        const bool rok = m0 + row < S;
        const float lrow = lse_s[row];
        const float drow = dl_s[row];
        const int sq = segq_s[row];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int key = tx + 16 * j;
            const bool vis = rok && n0 + key < S && segk_s[key] == sq;
            p[i][j] = vis ? expf(s[i][j] * scale - lrow) : 0.f;
            ds[i][j] = p[i][j] * (dp[i][j] - drow);
        }
    }
}

// K7: one block per (batch, head, key tile of T keys)
template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ seg, float* __restrict__ dk, float* __restrict__ dv,
               int NH, int S, Strides in, Strides dos, Strides os, float scale)
{
    using C = Cfg<HD>;
    constexpr int LD = C::LD, CG = C::CG;
    extern __shared__ __align__(16) float sm[];
    float* Ks = sm;
    float* Vs = Ks + T * LD;
    float* Qs = Vs + T * LD;
    float* dOs = Qs + T * LD;
    float* Pt = dOs + T * LD;   // P^T: [key][row]
    float* dSt = Pt + T * PLD;  // dS^T: [key][row]
    float* lse_s = dSt + T * PLD;
    float* dl_s = lse_s + T;
    int* segq_s = reinterpret_cast<int*>(dl_s + T);
    int* segk_s = segq_s + T;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int ntiles = (S + T - 1) / T;
    const int bh = blockIdx.x / ntiles;
    const int n0 = (blockIdx.x - bh * ntiles) * T;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const size_t in_off = (size_t)b * in.b + (size_t)h * in.h;
    const float* qb = q + in_off;
    const float* dob = dout + (size_t)b * dos.b + (size_t)h * dos.h;
    const float* lseb = lse + (size_t)bh * S;
    const float* deltab = delta + (size_t)bh * S;

    load_tile<HD>(Ks, k + in_off, in.s, n0, S);
    load_tile<HD>(Vs, v + in_off, in.s, n0, S);
    for (int r = tid; r < T; r += THREADS) segk_s[r] = n0 + r < S ? segb[n0 + r] : 0;
    int klo, khi;
    seg_range(segb, n0, S, klo, khi);

    float adk[4][CG][4], adv[4][CG][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CG; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                adk[i][c][e] = 0.f;
                adv[i][c][e] = 0.f;
            }

    for (int m0 = 0; m0 < S; m0 += T) {
        int qlo, qhi;
        seg_range(segb, m0, S, qlo, qhi);
        if (qhi < klo || qlo > khi) continue;  // the same answer in every warp
        __syncthreads();  // the previous tile's reads of Q, dO, P^T, dS^T are done
        load_tile<HD>(Qs, qb, in.s, m0, S);
        load_tile<HD>(dOs, dob, dos.s, m0, S);
        load_rows(lse_s, dl_s, segq_s, lseb, deltab, segb, m0, S);
        __syncthreads();

        float s[4][4], dp[4][4], p[4][4], ds[4][4];
        scores<HD>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
        probs(s, dp, lse_s, dl_s, segq_s, segk_s, m0, n0, S, scale, tx, ty, p, ds);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                Pt[(tx + 16 * j) * PLD + ty + 16 * i] = p[i][j];
                dSt[(tx + 16 * j) * PLD + ty + 16 * i] = ds[i][j];
            }
        __syncthreads();

        // dV[key] += sum_r P[r, key] dO[r], dK[key] += sum_r dS[r, key] Q[r]
        // for keys ty + 16 i and this thread's column groups
#pragma unroll 2
        for (int r = 0; r < T; r += 4) {
            float4 pv[4], sv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pv[i] = *reinterpret_cast<const float4*>(&Pt[(ty + 16 * i) * PLD + r]);
                sv[i] = *reinterpret_cast<const float4*>(&dSt[(ty + 16 * i) * PLD + r]);
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int c = 0; c < CG; ++c) {
                    const int col = 4 * (tx + 16 * c);
                    if (col >= HD) continue;
                    const float4 o = *reinterpret_cast<const float4*>(&dOs[(r + u) * LD + col]);
                    const float4 x = *reinterpret_cast<const float4*>(&Qs[(r + u) * LD + col]);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float pu = comp(pv[i], u), su = comp(sv[i], u);
                        adv[i][c][0] = fmaf(pu, o.x, adv[i][c][0]);
                        adv[i][c][1] = fmaf(pu, o.y, adv[i][c][1]);
                        adv[i][c][2] = fmaf(pu, o.z, adv[i][c][2]);
                        adv[i][c][3] = fmaf(pu, o.w, adv[i][c][3]);
                        adk[i][c][0] = fmaf(su, x.x, adk[i][c][0]);
                        adk[i][c][1] = fmaf(su, x.y, adk[i][c][1]);
                        adk[i][c][2] = fmaf(su, x.z, adk[i][c][2]);
                        adk[i][c][3] = fmaf(su, x.w, adk[i][c][3]);
                    }
                }
        }
    }

    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int key = n0 + ty + 16 * i;
        if (key >= S) continue;
        float* dkr = dk + out_off + (size_t)key * os.s;
        float* dvr = dv + out_off + (size_t)key * os.s;
#pragma unroll
        for (int c = 0; c < CG; ++c) {
            const int col = 4 * (tx + 16 * c);
            if (col >= HD) continue;
            *reinterpret_cast<float4*>(dvr + col) =
                make_float4(adv[i][c][0], adv[i][c][1], adv[i][c][2], adv[i][c][3]);
            *reinterpret_cast<float4*>(dkr + col) =
                make_float4(adk[i][c][0] * scale, adk[i][c][1] * scale, adk[i][c][2] * scale,
                            adk[i][c][3] * scale);
        }
    }
}

// K8: one block per (batch, head, query tile of T rows)
template <int HD>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ seg, float* __restrict__ dq, int NH, int S, Strides in,
              Strides dos, Strides os, float scale)
{
    using C = Cfg<HD>;
    constexpr int LD = C::LD, CG = C::CG;
    extern __shared__ __align__(16) float sm[];
    float* Qs = sm;
    float* dOs = Qs + T * LD;
    float* Ks = dOs + T * LD;
    float* Vs = Ks + T * LD;
    float* dSs = Vs + T * LD;  // dS: [row][key]
    float* lse_s = dSs + T * PLD;
    float* dl_s = lse_s + T;
    int* segq_s = reinterpret_cast<int*>(dl_s + T);
    int* segk_s = segq_s + T;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int ntiles = (S + T - 1) / T;
    const int bh = blockIdx.x / ntiles;
    const int m0 = (blockIdx.x - bh * ntiles) * T;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const size_t in_off = (size_t)b * in.b + (size_t)h * in.h;
    const float* kb = k + in_off;
    const float* vb = v + in_off;

    load_tile<HD>(Qs, q + in_off, in.s, m0, S);
    load_tile<HD>(dOs, dout + (size_t)b * dos.b + (size_t)h * dos.h, dos.s, m0, S);
    load_rows(lse_s, dl_s, segq_s, lse + (size_t)bh * S, delta + (size_t)bh * S, segb, m0, S);
    int qlo, qhi;
    seg_range(segb, m0, S, qlo, qhi);

    float adq[4][CG][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CG; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) adq[i][c][e] = 0.f;

    for (int n0 = 0; n0 < S; n0 += T) {
        int klo, khi;
        seg_range(segb, n0, S, klo, khi);
        if (khi < qlo || klo > qhi) continue;  // the same answer in every warp
        __syncthreads();  // the previous tile's reads of K and dS are done
        load_tile<HD>(Ks, kb, in.s, n0, S);
        load_tile<HD>(Vs, vb, in.s, n0, S);
        for (int r = tid; r < T; r += THREADS) segk_s[r] = n0 + r < S ? segb[n0 + r] : 0;
        __syncthreads();

        float s[4][4], dp[4][4], p[4][4], ds[4][4];
        scores<HD>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
        probs(s, dp, lse_s, dl_s, segq_s, segk_s, m0, n0, S, scale, tx, ty, p, ds);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * PLD + tx + 16 * j] = ds[i][j];
        __syncthreads();

        // dQ[row] += sum_key dS[row, key] K[key] for rows ty + 16 i
#pragma unroll 2
        for (int key = 0; key < T; key += 4) {
            float4 sv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                sv[i] = *reinterpret_cast<const float4*>(&dSs[(ty + 16 * i) * PLD + key]);
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
                for (int c = 0; c < CG; ++c) {
                    const int col = 4 * (tx + 16 * c);
                    if (col >= HD) continue;
                    const float4 x = *reinterpret_cast<const float4*>(&Ks[(key + u) * LD + col]);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float su = comp(sv[i], u);
                        adq[i][c][0] = fmaf(su, x.x, adq[i][c][0]);
                        adq[i][c][1] = fmaf(su, x.y, adq[i][c][1]);
                        adq[i][c][2] = fmaf(su, x.z, adq[i][c][2]);
                        adq[i][c][3] = fmaf(su, x.w, adq[i][c][3]);
                    }
                }
        }
    }

    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty + 16 * i;
        if (row >= S) continue;
        float* dqr = dq + out_off + (size_t)row * os.s;
#pragma unroll
        for (int c = 0; c < CG; ++c) {
            const int col = 4 * (tx + 16 * c);
            if (col >= HD) continue;
            *reinterpret_cast<float4*>(dqr + col) =
                make_float4(adq[i][c][0] * scale, adq[i][c][1] * scale, adq[i][c][2] * scale,
                            adq[i][c][3] * scale);
        }
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

// Blocks (B * NH * ceil(S / T)); the shared-memory attribute is set once per
// device and kernel (ready is the kernel's own table, by device).
template <typename Kernel>
int prepare(const Problem& p, Kernel* kernel, int smem, bool (&ready)[MAX_DEVICES],
            int& blocks) {
    if (p.B <= 0 || p.NH <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n = (long long)p.B * p.NH * ((p.S + T - 1) / T);
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
    constexpr int smem = Cfg<HD>::DKV_SMEM;
    static bool ready[MAX_DEVICES];
    int blocks;
    if (int e = prepare(p, bwd_dkv_kernel<HD>, smem, ready, blocks)) return e;
    bwd_dkv_kernel<HD><<<blocks, THREADS, smem, p.stream>>>(
        p.q, p.k, p.v, p.dout, p.lse, p.delta, p.seg, p.out0, p.out1, p.NH, p.S, p.in, p.dos,
        p.os, p.scale);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const Problem& p) {
    constexpr int smem = Cfg<HD>::DQ_SMEM;
    static bool ready[MAX_DEVICES];
    int blocks;
    if (int e = prepare(p, bwd_dq_kernel<HD>, smem, ready, blocks)) return e;
    bwd_dq_kernel<HD><<<blocks, THREADS, smem, p.stream>>>(
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

}  // namespace

// q, k, v: element (b, h, s, d) at b*in_b + h*in_h + s*in_s + d; dout with the
// do_* strides; dk, dv (K7) and dq (K8) with the out_* strides; lse and delta
// (B, NH, S) float32 and seg (B, S) int32, contiguous. Strides in elements.
// Returns the cudaError of the launch (0 = launched).
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
