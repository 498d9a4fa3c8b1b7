// Flash attention forward with segment ids (the encoder's attention, K6).
//
// Replaces the Pallas TPU kernel that minivectordb_tpu/models/encoder.py
// (_attention, the flash branch) calls for long sequences:
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention with
// SegmentIds(q=seg, kv=seg).  -> flash_attention_f32, flash_attention_bf16
//
// For every (batch b, head h, query row i):
//   s[j]   = seg[b, i] == seg[b, j] ? dot(q[b,h,i], k[b,h,j]) * sm_scale : MASK
//   out[i] = sum_j softmax(s)[j] * v[b,h,j]
// with MASK = -0.7 * float32 max (finite, the TPU kernel's value), the softmax
// and both sums in float32, and the (S, S) matrix never in device memory. The
// segment ids are the attention mask (real tokens 1, pads 0), so a pad query
// attends to the pad keys of its own row; every query sees at least itself.
// The output has q's element type; bf16 is rounded once, from the float32
// accumulator divided by the float32 sum.
//
// What bounds it: operations. 4*B*NH*S*S*HD of them against only 4 tensors of
// B*NH*S*HD elements moved, so the design keeps K and V tiles in shared
// memory and everything else in registers:
//   one block = one (batch, head, 64 query rows); it walks the keys in tiles
//   of 64 staged through shared memory (rows past S are zero-filled and
//   masked), keeps the running max m, running sum l and the (64, HD)
//   accumulator in float32 registers, and rescales them tile by tile (online
//   softmax). Blocks are independent, so nothing carries over between them.
//   MASK is finite: a row that sees nothing in a tile gets p = exp(0) = 1 for
//   that tile, and the first tile with a visible key wipes it with
//   alpha = exp(MASK - m) = 0; no exp(-inf - (-inf)) can occur.
//   The work that the data does not need is skipped: a key tile whose range
//   of segment ids [min, max] does not meet the query tile's holds no pair of
//   one segment, so it is neither loaded nor multiplied (a row's own tile
//   always meets it, so every row still sees itself). With the encoder's ids
//   (real tokens 1, then pads 0) that drops the real-by-pad corners.
//
//   bf16 (flash_bf16_kernel): 4 warps, each owns 16 query rows. Q fragments
//   live in registers; S = Q K^T by mma.sync m16n8k16 with K fragments read
//   from the shared K tile (k-contiguous: the "col" operand as stored); the
//   probabilities are rounded to bf16 in registers and become the A fragments
//   of P V directly (the C layout of one mma is the A layout of the next);
//   V fragments come from the row-major shared V tile with ldmatrix .trans.
//   f32 (flash_f32_kernel): IEEE FMAs on the CUDA cores, never TF32. 256
//   threads as 16 x 16; a thread owns a 4 x 4 tile of S (rows ty + 16i, keys
//   tx + 16j) and a 4 x HD/16 tile of the output, reads both operands as
//   float4 from padded shared rows, and a row's max and sum are reduced by
//   shuffles inside its half-warp. P goes through shared memory, written and
//   read by the same half-warp.
//
// Layout: q, k, v share one set of element strides (batch, head, sequence;
// the last axis is contiguous), the output has its own, so (B, NH, S, HD) and
// (B, S, NH, HD) memory both work without a transposed copy. Rows must start
// on 16-byte boundaries. Any S >= 1; HD a multiple of 16 up to 128.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per tile
constexpr float MASK_VALUE = -2.3819763e38f;  // float32(-0.7 * float32 max)
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
    long long b, h, s;  // in elements
};

// [lo, hi] of the segment ids of rows first .. first + 63 below S; every lane
// of the calling warp gets both (all warps of a block get the same).
__device__ __forceinline__ void seg_range(const int* __restrict__ segb, int first, int S,
                                          int lane, int& lo, int& hi) {
    lo = INT_MAX;
    hi = INT_MIN;
    const int end = min(first + 64, S);
    for (int r = first + lane; r < end; r += 32) {
        const int s = segb[r];
        lo = min(lo, s);
        hi = max(hi, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
}

// ---------------------------------------------------------------------------
// float32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int PST = BN + 16;  // shared stride of a P row: rows ty, ty+1 lie 16 banks apart

template <int HD>
constexpr size_t f32_smem_bytes() {
    return sizeof(float) * (2 * BM * (HD + 4) + BN * HD + BM * PST) + sizeof(int) * BN;
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ out, int NH, int S, Strides in, Strides os,
                 float sm_scale, int mtiles)
{
    constexpr int QST = HD + 4;         // padded row: float4 reads of 8 rows hit 8 bank groups
    constexpr int CW = HD / 16;         // output columns per thread
    constexpr bool VEC = HD % 64 == 0;  // columns as float4 groups, else one by one
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;              // BM x QST
    float* Ks = Qs + BM * QST;     // BN x QST
    float* Vs = Ks + BN * QST;     // BN x HD
    float* Ps = Vs + BN * HD;      // BM x PST
    int* segk = reinterpret_cast<int*>(Ps + BM * PST);  // BN

    const int tid = threadIdx.x;
    const int tx = tid & 15;   // key column / output column group
    const int ty = tid >> 4;   // query row group; a half-warp shares one ty
    const int mt = blockIdx.x % mtiles;
    const int bh = blockIdx.x / mtiles;
    const int b = bh / NH;
    const int h = bh - b * NH;
    const int m0 = mt * BM;
    const size_t base = (size_t)b * in.b + (size_t)h * in.h;
    const float* qb = q + base;
    const float* kb = k + base;
    const float* vb = v + base;
    const int* segb = seg + (size_t)b * S;

    for (int idx = tid; idx < BM * (HD / 4); idx += F32_THREADS) {
        const int r = idx / (HD / 4);
        const int c = (idx - r * (HD / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + r < S)
            val = *reinterpret_cast<const float4*>(qb + (size_t)(m0 + r) * in.s + c);
        *reinterpret_cast<float4*>(&Qs[r * QST + c]) = val;
    }

    int segq[4];
    float m[4], l[4], acc[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = m0 + ty + 16 * i;
        segq[i] = r < S ? segb[r] : 0;
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
    }

    int qlo, qhi;
    seg_range(segb, m0, S, tid & 31, qlo, qhi);

    for (int n0 = 0; n0 < S; n0 += BN) {
        int klo, khi;
        seg_range(segb, n0, S, tid & 31, klo, khi);
        if (khi < qlo || klo > qhi) continue;  // no pair of one segment; block-uniform
        __syncthreads();  // the previous tile is consumed
        for (int idx = tid; idx < BN * (HD / 4); idx += F32_THREADS) {
            const int r = idx / (HD / 4);
            const int c = (idx - r * (HD / 4)) * 4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
            float4 vv = kv;
            if (n0 + r < S) {
                const size_t off = (size_t)(n0 + r) * in.s + c;
                kv = *reinterpret_cast<const float4*>(kb + off);
                vv = *reinterpret_cast<const float4*>(vb + off);
            }
            *reinterpret_cast<float4*>(&Ks[r * QST + c]) = kv;
            *reinterpret_cast<float4*>(&Vs[r * HD + c]) = vv;
        }
        if (tid < BN) segk[tid] = n0 + tid < S ? segb[n0 + tid] : 0;
        __syncthreads();

        // S = Q K^T for rows ty + 16i, keys tx + 16j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < HD; kk += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QST + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QST + kk]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }

        // scale, mask, online softmax; the 16 lanes of a half-warp hold one row
        bool seen[4];
        int sk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            seen[j] = n0 + tx + 16 * j < S;
            sk[j] = segk[tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = (seen[j] && sk[j] == segq[i]) ? s[i][j] * sm_scale : MASK_VALUE;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float mnew = fmaxf(m[i], mx);     // finite: every s is
            const float alpha = expf(m[i] - mnew);  // 0 while m is still -inf
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - mnew);
                sum += p;
                Ps[(ty + 16 * i) * PST + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
            m[i] = mnew;
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
        }
        __syncwarp();  // a row of P is written and read by one half-warp

        // O += P V for rows ty + 16i and this thread's CW columns
#pragma unroll 2
        for (int j0 = 0; j0 < BN; j0 += 4) {
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PST + j0]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float* vrow = &Vs[(j0 + jj) * HD];
                float vv[CW];
                if constexpr (VEC) {
#pragma unroll
                    for (int c4 = 0; c4 < CW / 4; ++c4) {
                        const float4 t =
                            *reinterpret_cast<const float4*>(&vrow[c4 * 64 + tx * 4]);
                        vv[c4 * 4 + 0] = t.x;
                        vv[c4 * 4 + 1] = t.y;
                        vv[c4 * 4 + 2] = t.z;
                        vv[c4 * 4 + 3] = t.w;
                    }
                } else {
#pragma unroll
                    for (int c = 0; c < CW; ++c) vv[c] = vrow[tx + 16 * c];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                                  : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
                    for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
                }
            }
        }
    }

    float* ob = out + (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = m0 + ty + 16 * i;
        if (r >= S) continue;
        float* orow = ob + (size_t)r * os.s;
        if constexpr (VEC) {
#pragma unroll
            for (int c4 = 0; c4 < CW / 4; ++c4)
                *reinterpret_cast<float4*>(&orow[c4 * 64 + tx * 4]) = make_float4(
                    acc[i][c4 * 4 + 0] / l[i], acc[i][c4 * 4 + 1] / l[i],
                    acc[i][c4 * 4 + 2] / l[i], acc[i][c4 * 4 + 3] / l[i]);
        } else {
#pragma unroll
            for (int c = 0; c < CW; ++c) orow[tx + 16 * c] = acc[i][c] / l[i];
        }
    }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF16_THREADS = 128;

// D = A (16 x 16, row-major) * B (16 x 8, column-major) + D
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed on the way into the fragments: lanes
// 8i .. 8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// (lo, hi) rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&t);
}

template <int HD>
constexpr size_t bf16_smem_bytes() {
    return sizeof(uint16_t) * 2 * BN * (HD + 8) + sizeof(int) * BN;
}

template <int HD>
__global__ void __launch_bounds__(BF16_THREADS)
flash_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, const int* __restrict__ seg,
                  uint16_t* __restrict__ out, int NH, int S, Strides in, Strides os,
                  float scale_log2, int mtiles)
{
    constexpr int KST = HD + 8;     // padded row: 8 rows of a fragment hit 8 bank groups
    constexpr int KSTEPS = HD / 16; // k-steps of Q K^T
    constexpr int NT_O = HD / 8;    // n-tiles of the output
    extern __shared__ __align__(16) uint16_t sm16[];
    uint16_t* Ks = sm16;               // BN x KST
    uint16_t* Vs = Ks + BN * KST;      // BN x KST
    int* segk = reinterpret_cast<int*>(Vs + BN * KST);  // BN

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;   // fragment row (A, C) / column (B)
    const int t4 = lane & 3;
    const int mt = blockIdx.x % mtiles;
    const int bh = blockIdx.x / mtiles;
    const int b = bh / NH;
    const int h = bh - b * NH;
    const int m0 = mt * BM;
    const size_t base = (size_t)b * in.b + (size_t)h * in.h;
    const uint16_t* qb = q + base;
    const uint16_t* kb = k + base;
    const uint16_t* vb = v + base;
    const int* segb = seg + (size_t)b * S;

    // this thread's two query rows: g and g + 8 of the warp's 16
    const int r0 = m0 + warp * 16 + g;
    const int r1 = r0 + 8;
    const bool in0 = r0 < S, in1 = r1 < S;
    const int segq0 = in0 ? segb[r0] : 0;
    const int segq1 = in1 ? segb[r1] : 0;

    uint32_t qa[KSTEPS][4];
    {
        const uint16_t* q0 = qb + (size_t)(in0 ? r0 : 0) * in.s + 2 * t4;
        const uint16_t* q1 = qb + (size_t)(in1 ? r1 : 0) * in.s + 2 * t4;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
            qa[ks][0] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + ks * 16) : 0u;
            qa[ks][1] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + ks * 16) : 0u;
            qa[ks][2] = in0 ? *reinterpret_cast<const uint32_t*>(q0 + ks * 16 + 8) : 0u;
            qa[ks][3] = in1 ? *reinterpret_cast<const uint32_t*>(q1 + ks * 16 + 8) : 0u;
        }
    }

    float mrow[2] = {-INFINITY, -INFINITY};
    float lrow[2] = {0.f, 0.f};
    float o[NT_O][4];
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

    int qlo, qhi;
    seg_range(segb, m0, S, lane, qlo, qhi);

    for (int n0 = 0; n0 < S; n0 += BN) {
        int klo, khi;
        seg_range(segb, n0, S, lane, klo, khi);
        if (khi < qlo || klo > qhi) continue;  // no pair of one segment; block-uniform
        __syncthreads();  // the previous tile is consumed
        for (int idx = tid; idx < BN * (HD / 8); idx += BF16_THREADS) {
            const int r = idx / (HD / 8);
            const int c = (idx - r * (HD / 8)) * 8;
            uint4 kv = make_uint4(0u, 0u, 0u, 0u);
            uint4 vv = kv;
            if (n0 + r < S) {
                const size_t off = (size_t)(n0 + r) * in.s + c;
                kv = *reinterpret_cast<const uint4*>(kb + off);
                vv = *reinterpret_cast<const uint4*>(vb + off);
            }
            *reinterpret_cast<uint4*>(&Ks[r * KST + c]) = kv;
            *reinterpret_cast<uint4*>(&Vs[r * KST + c]) = vv;
        }
        if (tid < BN) segk[tid] = n0 + tid < S ? segb[n0 + tid] : 0;
        __syncthreads();

        // S = Q K^T: c[nt] is rows (g, g+8) x keys nt*8 + 2*t4 + (0, 1)
        float c[BN / 8][4];
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
            for (int nt = 0; nt < BN / 8; ++nt) {
                const uint16_t* kr = &Ks[(nt * 8 + g) * KST + ks * 16 + 2 * t4];
                mma_bf16(c[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                         *reinterpret_cast<const uint32_t*>(kr + 8));
            }

        // scale (into the exp2 domain), mask, online softmax; a row lives in
        // the 4 lanes of a quad
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = nt * 8 + 2 * t4 + e;
                const bool seen = n0 + col < S;
                const int sk = segk[col];
                c[nt][e] = (seen && sk == segq0) ? c[nt][e] * scale_log2 : MASK_VALUE;
                c[nt][2 + e] = (seen && sk == segq1) ? c[nt][2 + e] * scale_log2 : MASK_VALUE;
                mx[0] = fmaxf(mx[0], c[nt][e]);
                mx[1] = fmaxf(mx[1], c[nt][2 + e]);
            }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            const float mnew = fmaxf(mrow[hh], mx[hh]);  // finite: every s is
            alpha[hh] = exp2f(mrow[hh] - mnew);          // 0 while m is still -inf
            mrow[hh] = mnew;
        }
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                c[nt][e] = exp2f(c[nt][e] - mrow[0]);
                c[nt][2 + e] = exp2f(c[nt][2 + e] - mrow[1]);
                sum[0] += c[nt][e];
                sum[1] += c[nt][2 + e];
            }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
            sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
            lrow[hh] = lrow[hh] * alpha[hh] + sum[hh];
        }
#pragma unroll
        for (int nt = 0; nt < NT_O; ++nt) {
            o[nt][0] *= alpha[0];
            o[nt][1] *= alpha[0];
            o[nt][2] *= alpha[1];
            o[nt][3] *= alpha[1];
        }

        // O += P V: the C fragments of two key n-tiles are one A fragment
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]),
            };
#pragma unroll
            for (int np = 0; np < NT_O / 2; ++np) {
                // matrices: keys kk*16 + (0..7 | 8..15) x dims np*16 + (0..7),
                // then the same keys x dims np*16 + 8 + (0..7)
                uint32_t vf[4];
                ldmatrix_x4_trans(
                    vf, &Vs[(kk * 16 + (lane & 15)) * KST + np * 16 + 8 * (lane >> 4)]);
                mma_bf16(o[2 * np], pa, vf[0], vf[1]);
                mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
            }
        }
    }

    uint16_t* ob = out + (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
    for (int nt = 0; nt < NT_O; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (in0)
            *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * os.s + col) =
                pack_bf16(o[nt][0] / lrow[0], o[nt][1] / lrow[0]);
        if (in1)
            *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * os.s + col) =
                pack_bf16(o[nt][2] / lrow[1], o[nt][3] / lrow[1]);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Problem {
    const void *q, *k, *v;
    const int* seg;
    void* out;
    int B, NH, S;
    Strides in, os;
    float sm_scale;
    cudaStream_t stream;
};

template <typename Kernel>
int prepare(Kernel* kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int HD>
int launch_f32(const Problem& p, unsigned blocks, int mtiles) {
    constexpr size_t smem = f32_smem_bytes<HD>();
    if (int e = prepare(flash_f32_kernel<HD>, smem)) return e;
    flash_f32_kernel<HD><<<blocks, F32_THREADS, smem, p.stream>>>(
        static_cast<const float*>(p.q), static_cast<const float*>(p.k),
        static_cast<const float*>(p.v), p.seg, static_cast<float*>(p.out), p.NH, p.S,
        p.in, p.os, p.sm_scale, mtiles);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Problem& p, unsigned blocks, int mtiles) {
    constexpr size_t smem = bf16_smem_bytes<HD>();
    if (int e = prepare(flash_bf16_kernel<HD>, smem)) return e;
    flash_bf16_kernel<HD><<<blocks, BF16_THREADS, smem, p.stream>>>(
        static_cast<const uint16_t*>(p.q), static_cast<const uint16_t*>(p.k),
        static_cast<const uint16_t*>(p.v), p.seg, static_cast<uint16_t*>(p.out), p.NH,
        p.S, p.in, p.os, p.sm_scale * LOG2E, mtiles);
    return static_cast<int>(cudaGetLastError());
}

template <bool IS_BF16>
int dispatch(const Problem& p, int HD) {
    if (p.B <= 0 || p.NH <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int mtiles = (p.S + BM - 1) / BM;
    const long long blocks = (long long)p.B * p.NH * mtiles;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned nb = static_cast<unsigned>(blocks);
#define FLASH_CASE(N) \
    case N: return IS_BF16 ? launch_bf16<N>(p, nb, mtiles) : launch_f32<N>(p, nb, mtiles);
    switch (HD) {
        FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(48) FLASH_CASE(64)
        FLASH_CASE(80) FLASH_CASE(96) FLASH_CASE(112) FLASH_CASE(128)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_CASE
}

}  // namespace

// q, k, v: element (b, h, s, d) at b*in_b + h*in_h + s*in_s + d; out likewise
// with the out_* strides; seg (B, S) int32, contiguous. Strides in elements.
// Returns the cudaError of the launch (0 = launched).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const int* seg, void* out, int B, int NH, int S, int HD,
                                   long long in_b, long long in_h, long long in_s,
                                   long long out_b, long long out_h, long long out_s,
                                   float sm_scale, void* stream)
{
    const Problem p{q, k, v, seg, out, B, NH, S, {in_b, in_h, in_s},
                    {out_b, out_h, out_s}, sm_scale, static_cast<cudaStream_t>(stream)};
    return dispatch<false>(p, HD);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const int* seg, void* out, int B, int NH, int S, int HD,
                                    long long in_b, long long in_h, long long in_s,
                                    long long out_b, long long out_h, long long out_s,
                                    float sm_scale, void* stream)
{
    const Problem p{q, k, v, seg, out, B, NH, S, {in_b, in_h, in_s},
                    {out_b, out_h, out_s}, sm_scale, static_cast<cudaStream_t>(stream)};
    return dispatch<true>(p, HD);
}
