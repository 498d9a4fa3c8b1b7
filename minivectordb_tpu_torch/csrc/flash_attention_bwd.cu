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
// Design. Tiles of T = 64 query rows and 64 keys. K7 takes one block per
// (batch, head, key tile): K and V of its keys stay in shared memory, dK and
// dV accumulate in registers, and it walks the query tiles, fetching Q, dO,
// lse, delta and the ids of each with cp.async (zero fill past S). Its 256
// threads form two groups that split each pair of products: group 0 computes
// S = Q K^T, P and dV += P^T dO, group 1 dP = dO V^T, dS and dK += dS^T Q,
// each thread an 8 x 4 tile (12 shared float4 loads per 128 FMAs; a warp is
// 4 x 8 threads, so it reads 4 rows of one operand and 8 of the other). P^T
// and dS^T pass through shared memory, key-major, stored without bank
// conflicts; group 0 signals P^T to group 1 with a named barrier and goes on
// to dV, group 1 waits only for it. P is one exp2 per pair, without a branch.
// Two blocks an SM up to HD = 64 (105 KB of shared memory, 128 registers).
// K8 takes one block per (batch, head, query tile) and walks the key tiles,
// dQ in registers. Its two groups split S and dP the same way (group 0 S and
// P, group 1 dP and dS, 8 x 4 tiles a thread, a warp 8 rows x 4 keys), P and
// dS passing through one row-major tile whose stores miss no bank; then all
// 256 threads compute dQ += dS K on a 16 x 16 grid, each thread 4 rows and
// float4 column groups tx + 16 c, over the keys in ascending order. K is
// double-buffered and V refilled in place, by cp.async behind the products:
// group 0 fetches the next visited tile's K once its P is in, group 1 the
// next V once its own reads of V are done, so a key tile costs two block-wide
// barriers and one named one. Two blocks an SM up to HD = 64 (106 KB, 128
// registers). In both kernels a tile whose range of segment ids [min, max]
// does not meet the block's own holds no pair of one segment and is skipped:
// the rule of the forward kernel (seg_range / tiles_meeting in
// flash_attention.cu), so the real-by-pad corners of the encoder's "ones, then
// zeros" ids cost nothing. Rows past S read as zeros and are masked; only rows
// below S are written.
//
// Work: K7 multiplies 8 * HD operations per (query, key) pair of one segment
// (S, dP, dV, dK), K8 6 * HD (S, dP, dQ); both read their inputs a few times
// through L2. Operations bound them on paper (about 67 TFLOP/s of float32 on
// the card). What bounds these designs is the dispatch of FMAs beside the
// shared-memory loads that feed them and the steps between the products
// (per 4-wide step of HD a thread of either kernel reads 12 float4s for 128
// FMAs in S or dP; K8's dQ 8 for 64).
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
    // K7: K, V, Q, dO tiles, P^T and dS^T, lse, delta and both tiles' ids;
    // two blocks an SM (so at most 128 registers a thread) where they fit
    static constexpr int DKV_SMEM = (4 * T * LD + 2 * T * PLD + 2 * T) * 4 + 2 * T * 4;
    static constexpr int DKV_MINB = 2 * (DKV_SMEM + 1024) <= 233472 ? 2 : 1;
    // K8: Q, dO, two K tiles, V, P / dS, lse, delta, the rows' ids and two
    // key tiles' ids; two blocks an SM where they fit
    static constexpr int DQ_SMEM = (5 * T * LD + T * PLD + 2 * T) * 4 + 3 * T * 4;
    static constexpr int DQ_MINB = 2 * (DQ_SMEM + 1024) <= 233472 ? 2 : 1;
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

__device__ __forceinline__ float comp(const float4& x, int u) {
    return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 / 4 bytes global -> shared, asynchronous; zeros when !valid (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// waits for this thread's copies; a barrier after it publishes everyone's
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows r0 .. r0 + T - 1 of one (batch, head) of a (.., S, HD) tensor whose
// rows are ss elements apart -> a shared tile with row stride LD, by cp.async
// (zeros past S), issued by threads first .. first + n - 1 of the block
template <int HD>
__device__ __forceinline__ void fetch_tile(float* dst, const float* __restrict__ src,
                                           long long ss, int r0, int S,
                                           int first = 0, int n = THREADS) {
    using C = Cfg<HD>;
    for (int idx = threadIdx.x - first; idx < T * C::C4; idx += n) {
        const int r = idx / C::C4;
        const int c = idx - r * C::C4;
        const bool ok = r0 + r < S;
        cp_async16(dst + r * C::LD + 4 * c, src + (ok ? (r0 + r) * ss + 4 * c : 0), ok);
    }
}

// the segment ids of rows r0 .. r0 + T - 1 -> ids[0, T) by cp.async, one a
// thread of the first T (zeros past S)
__device__ __forceinline__ void fetch_ids(int* ids, const int* __restrict__ segb, int r0,
                                          int S) {
    const int t = threadIdx.x;
    if (t < T) cp_async4(ids + t, segb + (r0 + t < S ? r0 + t : 0), r0 + t < S);
}

// lse, delta and ids of rows r0 .. r0 + T - 1 -> rows[0, T), [T, 2T),
// [2T, 3T) by cp.async, one value a thread (zeros past S)
__device__ __forceinline__ void fetch_rows(float* rows, const float* __restrict__ lseb,
                                           const float* __restrict__ deltab,
                                           const int* __restrict__ segb, int r0, int S) {
    static_assert(THREADS >= 3 * T, "one value a thread");
    const int i = threadIdx.x, which = i / T, r = i - which * T;
    if (which > 2) return;
    const bool ok = r0 + r < S;
    const int at = ok ? r0 + r : 0;
    cp_async4(rows + i, which == 0 ? static_cast<const void*>(lseb + at)
                        : which == 1 ? static_cast<const void*>(deltab + at)
                                     : static_cast<const void*>(segb + at), ok);
}

// named barriers (0 is __syncthreads): n threads, whole warps
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// K7: one block per (batch, head, key tile of T keys). Its 256 threads form
// two groups of 128: group 0 computes S = Q K^T, P and dV += P^T dO, group 1
// dP = dO V^T, dS and dK += dS^T Q. A thread holds 8 rows x 4 keys of S or
// dP (rows ra + 8 i, keys ka + 16 j), then 8 keys x CG float4 column groups
// of dV or dK (keys kb + 8 i, columns 4 (cb + 16 g)).
template <int HD>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::DKV_MINB)
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

    // Each warp is 4 x 8 threads of its group's product: its loads of the
    // row-major operand touch 4 rows, those of the key-major one 8 keys, and
    // its P^T / dS^T stores fall on 32 different banks (PLD = 4 mod 32).
    const int tid = threadIdx.x, lane = tid & 31;
    const int grp = tid >> 7;  // 0: S, P, dV; 1: dP, dS, dK
    const int w = (tid >> 5) & 3;
    const int ra = (lane >> 3) + 4 * (w & 1);  // S, dP: rows ra + 8 i
    const int ka = (lane & 7) + 8 * (w >> 1);  // and keys ka + 16 j
    const int kb = ra;                         // dV, dK: keys kb + 8 i
    const int cb = ka;                         // and float4 columns cb + 16 g

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

    fetch_tile<HD>(Ks, k + in_off, in.s, n0, S);
    fetch_tile<HD>(Vs, v + in_off, in.s, n0, S);
    fetch_ids(segk_s, segb, n0, S);
    int klo, khi;
    seg_range(segb, n0, S, klo, khi);

    float acc[8][CG][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int g = 0; g < CG; ++g)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;

    for (int m0 = 0; m0 < S; m0 += T) {
        int qlo, qhi;
        seg_range(segb, m0, S, qlo, qhi);
        if (qhi < klo || qlo > khi) continue;  // the same answer in every warp
        __syncthreads();  // the last tile's reads of Q, dO, P^T, dS^T are done
        fetch_tile<HD>(Qs, qb, in.s, m0, S);
        fetch_tile<HD>(dOs, dob, dos.s, m0, S);
        fetch_rows(lse_s, lseb, deltab, segb, m0, S);  // lse_s, dl_s, segq_s
        cp_async_wait_all();
        __syncthreads();

        // group 0: s = Q K^T, group 1: s = dO V^T
        {
            const float* X = grp == 0 ? Qs : dOs;
            const float* Y = grp == 0 ? Ks : Vs;
            float s[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
            for (int kk = 0; kk < HD; kk += 4) {
                float4 y[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    y[j] = *reinterpret_cast<const float4*>(&Y[(ka + 16 * j) * LD + kk]);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float4 x = *reinterpret_cast<const float4*>(&X[(ra + 8 * i) * LD + kk]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
                        s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
                        s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
                        s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
                    }
                }
            }
            if (grp == 0) {
                const float scale2 = scale * 1.44269504088896341f;
                // P (0 where the segments differ or the row or key lies past S)
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int row = ra + 8 * i;
                    const bool rok = m0 + row < S;
                    const float lrow = lse_s[row] * 1.44269504088896341f;
                    const int sq = segq_s[row];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int key = ka + 16 * j;
                        const bool vis = rok && n0 + key < S && segk_s[key] == sq;
                        const float e = exp2f(fmaf(s[i][j], scale2, -lrow));
                        Pt[key * PLD + row] = __int_as_float(__float_as_int(e) & -int(vis));
                    }
                }
                bar_arrive(1, THREADS);  // P^T is in for group 1 ...
                bar_sync(2, THREADS / 2);  // ... and for this group's dV
            } else {
                bar_sync(1, THREADS);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int row = ra + 8 * i;
                    const float drow = dl_s[row];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int at = (ka + 16 * j) * PLD + row;
                        dSt[at] = Pt[at] * (s[i][j] - drow);
                    }
                }
                bar_sync(3, THREADS / 2);  // dS^T is in for this group's dK
            }
        }

        // group 0: dV[key] += sum_r P[r, key] dO[r]; group 1: dK[key] +=
        // sum_r dS[r, key] Q[r]; keys kb + 8 i, this thread's column groups
        {
            const float* A = grp == 0 ? Pt : dSt;
            const float* X = grp == 0 ? dOs : Qs;
#pragma unroll 1
            for (int r = 0; r < T; r += 4) {
                float4 a[8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    a[i] = *reinterpret_cast<const float4*>(&A[(kb + 8 * i) * PLD + r]);
#pragma unroll
                for (int u = 0; u < 4; ++u)
#pragma unroll
                    for (int g = 0; g < CG; ++g) {
                        const int col = 4 * (cb + 16 * g);
                        if (col >= HD) continue;
                        const float4 x = *reinterpret_cast<const float4*>(&X[(r + u) * LD + col]);
#pragma unroll
                        for (int i = 0; i < 8; ++i) {
                            const float au = comp(a[i], u);
                            acc[i][g][0] = fmaf(au, x.x, acc[i][g][0]);
                            acc[i][g][1] = fmaf(au, x.y, acc[i][g][1]);
                            acc[i][g][2] = fmaf(au, x.z, acc[i][g][2]);
                            acc[i][g][3] = fmaf(au, x.w, acc[i][g][3]);
                        }
                    }
            }
        }
    }

    // group 0 writes dV, group 1 dK (times scale)
    const size_t out_off = (size_t)b * os.b + (size_t)h * os.h;
    float* outb = (grp == 0 ? dv : dk) + out_off;
    const float mul = grp == 0 ? 1.f : scale;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int key = n0 + kb + 8 * i;
        if (key >= S) continue;
        float* r = outb + (size_t)key * os.s;
#pragma unroll
        for (int g = 0; g < CG; ++g) {
            const int col = 4 * (cb + 16 * g);
            if (col >= HD) continue;
            *reinterpret_cast<float4*>(r + col) =
                make_float4(acc[i][g][0] * mul, acc[i][g][1] * mul, acc[i][g][2] * mul,
                            acc[i][g][3] * mul);
        }
    }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// the first tile at or after n0 whose range of ids meets [qlo, qhi], or S;
// every warp finds it for itself
__device__ __forceinline__ int next_tile(const int* __restrict__ segb, int n0, int S, int qlo,
                                         int qhi) {
    for (; n0 < S; n0 += T) {
        int klo, khi;
        seg_range(segb, n0, S, klo, khi);
        if (!(khi < qlo || klo > qhi)) break;
    }
    return n0;
}

// K8: one block per (batch, head, query tile of T rows). Its 256 threads form
// two groups of 128 for S and dP: group 0 computes S = Q K^T and P, group 1
// dP = dO V^T and dS = P (dP - delta), a thread 8 rows x 4 keys (rows ra + 8 i,
// keys ka + 16 j). Then every thread adds dS K to dQ for rows ty + 16 i and
// float4 columns tx + 16 c.
template <int HD>
__global__ void __launch_bounds__(THREADS, Cfg<HD>::DQ_MINB)
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
    float* K2 = dOs + T * LD;  // two K tiles: this one and the next
    float* Vs = K2 + 2 * T * LD;
    float* dSs = Vs + T * LD;  // P, then dS: [row][key]
    float* lse_s = dSs + T * PLD;
    float* dl_s = lse_s + T;
    int* segq_s = reinterpret_cast<int*>(dl_s + T);
    int* segk2 = segq_s + T;  // two key tiles' ids

    // A warp of either group is 8 rows x 4 keys: its loads of Q or dO touch 8
    // rows, those of K or V 4 keys, and its P / dS stores fall on 32
    // different banks (PLD = 4 mod 32).
    const int tid = threadIdx.x, lane = tid & 31;
    const int grp = tid >> 7;  // 0: S, P; 1: dP, dS
    const int ra = lane & 7;                        // S, dP: rows ra + 8 i
    const int ka = (lane >> 3) + 4 * ((tid >> 5) & 3);  // and keys ka + 16 j
    const int tx = tid & 15, ty = tid >> 4;         // dQ: rows ty + 16 i

    const int ntiles = (S + T - 1) / T;
    const int bh = blockIdx.x / ntiles;
    const int m0 = (blockIdx.x - bh * ntiles) * T;
    const int b = bh / NH, h = bh - b * NH;
    const int* segb = seg + (size_t)b * S;
    const size_t in_off = (size_t)b * in.b + (size_t)h * in.h;
    const float* kb = k + in_off;
    const float* vb = v + in_off;

    int qlo, qhi;
    seg_range(segb, m0, S, qlo, qhi);
    int n0 = next_tile(segb, 0, S, qlo, qhi);  // < S: the block's own tile meets its range
    fetch_tile<HD>(Qs, q + in_off, in.s, m0, S);
    fetch_tile<HD>(dOs, dout + (size_t)b * dos.b + (size_t)h * dos.h, dos.s, m0, S);
    fetch_rows(lse_s, lse + (size_t)bh * S, delta + (size_t)bh * S, segb, m0, S);
    fetch_tile<HD>(K2, kb, in.s, n0, S);
    fetch_tile<HD>(Vs, vb, in.s, n0, S);
    fetch_ids(segk2, segb, n0, S);

    float adq[4][CG][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CG; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) adq[i][c][e] = 0.f;

    for (int cur = 0; n0 < S; cur ^= 1) {
        const int n1 = next_tile(segb, n0 + T, S, qlo, qhi);
        const float* Ks = K2 + cur * T * LD;
        const int* segk_s = segk2 + cur * T;
        cp_async_wait_all();
        __syncthreads();  // this tile's K, V and ids are in; the last tile's dQ is done

        // group 0: s = Q K^T, group 1: s = dO V^T
        {
            const float* X = grp == 0 ? Qs : dOs;
            const float* Y = grp == 0 ? Ks : Vs;
            float s[8][4];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 1
            for (int kk = 0; kk < HD; kk += 4) {
                float4 y[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    y[j] = *reinterpret_cast<const float4*>(&Y[(ka + 16 * j) * LD + kk]);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float4 x = *reinterpret_cast<const float4*>(&X[(ra + 8 * i) * LD + kk]);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
                        s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
                        s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
                        s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
                    }
                }
            }
            if (grp == 0) {
                const float scale2 = scale * 1.44269504088896341f;
                // P (0 where the segments differ or the row or key lies past S)
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int row = ra + 8 * i;
                    const bool rok = m0 + row < S;
                    const float lrow = lse_s[row] * 1.44269504088896341f;
                    const int sq = segq_s[row];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int key = ka + 16 * j;
                        const bool vis = rok && n0 + key < S && segk_s[key] == sq;
                        const float e = exp2f(fmaf(s[i][j], scale2, -lrow));
                        dSs[row * PLD + key] = __int_as_float(__float_as_int(e) & -int(vis));
                    }
                }
                bar_arrive(1, THREADS);  // P is in for group 1
                // the next tile's K into the other buffer (read last in the
                // last tile's dQ), and its ids
                if (n1 < S) {
                    fetch_tile<HD>(K2 + (cur ^ 1) * T * LD, kb, in.s, n1, S, 0, THREADS / 2);
                    fetch_ids(segk2 + (cur ^ 1) * T, segb, n1, S);
                }
            } else {
                bar_sync(1, THREADS);  // P is in, and this group's reads of V are done
                if (n1 < S) fetch_tile<HD>(Vs, vb, in.s, n1, S, THREADS / 2, THREADS / 2);
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int row = ra + 8 * i;
                    const float drow = dl_s[row];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int at = row * PLD + ka + 16 * j;
                        dSs[at] = dSs[at] * (s[i][j] - drow);
                    }
                }
            }
        }
        __syncthreads();  // dS is in

        // dQ[row] += sum_key dS[row, key] K[key] for rows ty + 16 i
#pragma unroll 4
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
        n0 = n1;
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
