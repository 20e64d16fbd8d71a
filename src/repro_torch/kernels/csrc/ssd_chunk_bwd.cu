// Backward of the Mamba2 SSD intra-chunk product for Hopper (sm_90a): the
// gradient of ssd_chunk.cu. The TPU kernel
// repro/kernels/ssd_scan/ssd_scan.py::ssd_chunk has no backward kernel (the
// JAX model differentiates plain jnp); the port's forward runs the CUDA
// kernel, so its gradient is a kernel too.
//
// Forward, per (batch*chunk bc, head hh), with cs the in-chunk cumulative
// sum of dA, L_ij = exp(cs_i - cs_j) for j <= i (0 above the diagonal),
// G_ij = C_i . B_j and w_j = exp(cs_{l-1} - cs_j) dt_j:
//   y_i  = sum_j M_ij x_j,   M_ij = G_ij L_ij dt_j
//   st   = sum_j B_j^T w_j x_j                                 (n, p)
// Given dy (like y) and dst (like st), with dM_ij = dy_i . x_j (j <= i):
//   dx_j  = sum_i M_ij dy_i + w_j (dst^T B_j)
//   dG_ij = dM_ij L_ij dt_j,  dC_i = sum_h sum_j dG_ij B_j,
//   dB_j  = sum_h (sum_i dG_ij C_i + w_j dst x_j)
//   ddt_j = sum_i dM_ij G_ij L_ij + exp(cs_{l-1} - cs_j) dw_j,
//           dw_j = B_j . (dst x_j)
//   dcs_i = sum_j dM_ij M_ij - sum_k dM_ki M_ki - w_i dw_i
//           + [i = l-1] sum_j w_j dw_j
//   ddA_k = sum_{i >= k} dcs_i            (cs is a cumulative sum)
// Layouts (row-major, float32): x, dy, dx (bc, l, h, p); dA, dt, ddA, ddt
// (bc, l, h); B, C, dB, dC (bc, l, n), one SSM group shared by every head;
// dst (bc, h, n, p).
//
// Design. G, and the products of the heads' summed dG with B and C, do not
// depend on the head, so a block owns (bc, one 64-row tile, a group of
// kGroup heads) and does them once for its group; five kernels run on one
// stream, with no atomics, so the result does not depend on the order
// blocks run in:
//  (1) query pass, per (query tile i, group, bc), heaviest tiles first:
//      for each key tile j <= i, G_ij = C_i B_j^T once; then per head
//      dM = dy_i x_j^T, L, M and dG in the accumulators' registers, the
//      head's row sums of dM o M, and dG summed over the group's heads in
//      registers. The sum goes to scratch (transposed, for pass 3) and
//      dC_i += (sum_h dG) B_j.
//  (2) state pass, per (key tile j, group, bc): per head dst x_j and
//      dst^T B_j, which give dx's and dB's state terms, dw, and ddt's,
//      dcs's and sum w dw's state terms (written; pass 3 adds to them).
//  (3) key pass, per (key tile j, group, bc): G_ij for every i >= j once,
//      kept in shared memory; then per head dM, M, the column sums for
//      ddt and dcs, and dx_j += M^T dy_i; last dB_j += (sum_h dG)^T C_i
//      from pass 1's sums.
//  (4) per (bc, head): ddA = the reverse cumulative sum of dcs, in float64.
//  (5) dB and dC: the sum of the groups' partials.
// Every product is a warp's mma.sync.m16n8k8 in split TF32: each float32
// operand v is hi = tf32(v) (rounded to nearest, cvt.rna) and lo = tf32(v -
// hi), and the accumulator takes hi.hi + hi.lo + lo.hi in float32. Plain
// TF32 misses the element-wise rule the kernel is held to by ~7x; the
// split keeps about 21 bits and stays within the float32 rounding there.
// wgmma takes TF32 operands only K-major, and half of these products
// contract over a tile's rows (M^T dy, (sum dG)^T C, dG B): mma.sync reads
// its fragments from shared memory with 32-bit loads at any index, so a
// product over rows is only another index. Tiles sit in shared memory as
// float32 rows padded by 4 (reads along a row hit distinct banks, reads
// down a column two-way). L = exp(cs_i - cs_j) is taken only where j <= i
// (above the diagonal the segment sum is positive and may overflow, and 0
// * inf would put a NaN into a product); fragments above the diagonal are
// zeros before they are split. The next step's x and dy tiles arrive by
// cp.async into a two-stage ring while this step's products run. cs is
// formed as the forward forms it: a warp scan in float64, rounded once.
//
// What bounds it: operations. The least work is about 52.5 GFLOP at the
// serving shape (8, 8, 256, 64, 64, 64); split TF32 does it three times at
// the TF32 rate (495 TFLOP/s), a floor of 0.32 ms, against 0.78 ms for
// float32 on CUDA cores. The passes add G once per group and pass, and dM
// twice per head (passes 1 and 3).
#include "hopper.cuh"
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;               // rows per tile (query and key)
constexpr int kLDT = kT + 4;         // padded row of a 64 x 64 tile
// 16 warps: the passes' shared memory admits one block per SM, where 8
// warps left the SM waiting on loads and barriers (PERF.md, PR 15)
constexpr int kThreads = 512;
// a warp owns 16 rows and every kCG-th 8-column tile of a 64-row output
constexpr int kCG = kThreads / 128;
constexpr int kNT = 8 / kCG;         // its tiles of a 64-wide output
constexpr int kNTW = 16 / kCG;       // and of one up to 128 wide
constexpr int kGroup = 8;            // heads per block, one scan a warp
constexpr int kMaxL = 256;
constexpr int kMaxDim = 128;

struct Dims {
  int l, h, p, n;
  int pp, np;                        // p and n rounded up to 8
  int ldp, ldn;                      // padded rows of p- and n-wide tiles
  int nt, groups;                    // 64-row tiles, head groups
};

// a matrix in memory: element (r, c) at p[r * sr + c * sc]
struct View {
  const float* p;
  int sr, sc;
  __device__ __forceinline__ float at(int r, int c) const {
    return p[r * sr + c * sc];
  }
};

// One warp's share of a 64-row product C(64 x N) += A(64 x K) B(K x N), K
// and N multiples of 8: rows row0 .. row0 + 15 and the 8-column tiles
// kCG j + cg (j < NT) that lie below N, in split TF32.
template <int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], View A, View B,
                                         int row0, int cg, int K, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    hopper::split_tf32(A.at(row0 + g, k + t), ah[0], al[0]);
    hopper::split_tf32(A.at(row0 + g + 8, k + t), ah[1], al[1]);
    hopper::split_tf32(A.at(row0 + g, k + t + 4), ah[2], al[2]);
    hopper::split_tf32(A.at(row0 + g + 8, k + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * (kCG * j + cg);
      if (col >= N) break;
      uint32_t bh[2], bl[2];
      hopper::split_tf32(B.at(k + t, col + g), bh[0], bl[0]);
      hopper::split_tf32(B.at(k + t + 4, col + g), bh[1], bl[1]);
      hopper::mma_tf32(acc[j], al, bh);
      hopper::mma_tf32(acc[j], ah, bl);
      hopper::mma_tf32(acc[j], ah, bh);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// the (row, column) of accumulator element e of 8-column tile j, in a tile
// whose warp rows start at row0
struct Frag {
  int row0, cg, g, t;
  __device__ __forceinline__ Frag() {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    row0 = 16 * (w & 3);
    cg = w >> 2;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int e) const {
    return row0 + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int col(int j, int e) const {
    return 8 * (kCG * j + cg) + 2 * t + (e & 1);
  }
};

// the in-chunk cumsum of dA and dt for the group's heads: warp w scans head
// g0 + w into cs[w][0, kMaxL) (zeros past l), accumulating in float64 and
// rounding once, as the forward does
__device__ void group_prefix(const float* dA, const float* dt, int64_t bc,
                             int g0, int ng, const Dims& dm, float* cs,
                             float* dts) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l = dm.l, h = dm.h;
  for (int e = threadIdx.x; e < ng * kMaxL; e += kThreads) {
    const int hq = e / kMaxL, i = e % kMaxL;
    dts[e] = i < l ? dt[(bc * l + i) * h + g0 + hq] : 0.f;
  }
  if (w >= ng) return;
  double v[kMaxL / 32];
  double run = 0.0;
#pragma unroll
  for (int u = 0; u < kMaxL / 32; ++u) {
    const int i = lane * (kMaxL / 32) + u;
    run += i < l ? (double)dA[(bc * l + i) * h + g0 + w] : 0.0;
    v[u] = run;
  }
  double tot = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, tot, d);
    if (lane >= d) tot += o;
  }
  const double off = tot - run;
#pragma unroll
  for (int u = 0; u < kMaxL / 32; ++u)
    cs[w * kMaxL + lane * (kMaxL / 32) + u] = (float)(v[u] + off);
}

// rows [r0, r0 + kT) of a row-major matrix (row stride `stride`, `cols`
// columns) into dst [kT][ld]: rows past l and columns in [cols, pad) as
// zeros. cp.async when `async` (16-byte copies where `vec`), else plain
// loads; the caller commits, waits and synchronises.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int l, int64_t stride,
                                           int cols, int pad, int ld,
                                           bool async, bool vec) {
  if (async && vec) {
    const int q = pad / 4;           // pad and cols multiples of 4 here
    for (int e = threadIdx.x; e < kT * q; e += kThreads) {
      const int r = e / q, c = 4 * (e % q);
      float* d = dst + r * ld + c;
      if (r0 + r < l && c < cols)
        hopper::cp_async16(d, src + (int64_t)(r0 + r) * stride + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int e = threadIdx.x; e < kT * pad; e += kThreads) {
    const int r = e / pad, c = e % pad;
    float* d = dst + r * ld + c;
    if (r0 + r < l && c < cols) {
      const float* s = src + (int64_t)(r0 + r) * stride + c;
      if (async) hopper::cp_async4(d, s);
      else *d = *s;
    } else {
      *d = 0.f;
    }
  }
}

// sum over the 4 threads of a quad (one accumulator row), and over the 8
// quads of a warp (one accumulator column)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__host__ __device__ inline int pairs(int nt) { return nt * (nt + 1) / 2; }

__host__ __device__ inline size_t query_smem_floats(const Dims& d, int stages) {
  return 2 * kGroup * kMaxL + kCG * kGroup * kT + 2 * (size_t)kT * d.ldn +
         (size_t)kT * kLDT + (size_t)stages * 2 * kT * d.ldp;
}

// (1) per (query tile, group, bc): the group's dC rows, the heads' dcs row
// sums, and the group's summed dG per tile pair (transposed, to scratch)
__global__ void __launch_bounds__(kThreads, 1)
query_pass(const float* __restrict__ x, const float* __restrict__ dA,
           const float* __restrict__ dt, const float* __restrict__ B,
           const float* __restrict__ C, const float* __restrict__ dy,
           float* __restrict__ dCg, float* __restrict__ dGt,
           float* __restrict__ dcs_row, Dims dm, int stages, bool vec_x) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [kGroup][kMaxL]
  float* dts = cs + kGroup * kMaxL;              // [kGroup][kMaxL]
  float* rowE = dts + kGroup * kMaxL;            // [kCG][kGroup][kT]
  float* Ci = rowE + kCG * kGroup * kT;            // [kT][ldn]
  float* Bj = Ci + kT * dm.ldn;                  // [kT][ldn]
  float* Dg = Bj + kT * dm.ldn;                  // [kT][kLDT]
  float* ring = Dg + kT * kLDT;                  // stages x (dy, x)

  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int it = dm.nt - 1 - blockIdx.x;         // heaviest tiles first
  const int grp = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int g0 = grp * kGroup, ng = min(kGroup, h - g0);
  const int64_t hs = (int64_t)h * p;
  const float* xb = x + bc * l * hs + (int64_t)g0 * p;
  const float* dyb = dy + bc * l * hs + (int64_t)g0 * p;
  const float* Bb = B + bc * l * n;
  const int i0 = it * kT;
  const int stage = 2 * kT * dm.ldp;

  group_prefix(dA, dt, bc, g0, ng, dm, cs, dts);
  for (int e = threadIdx.x; e < kCG * kGroup * kT; e += kThreads) rowE[e] = 0.f;
  stage_rows(Ci, C + bc * l * n, i0, l, n, n, dm.np, dm.ldn, false, false);

  // step s: key tile s / ng, head s % ng; its dy_i and x_j into the ring
  const int steps = (it + 1) * ng;
  auto issue = [&](int s) {
    float* st = ring + (s % stages) * stage;
    const int hq = s % ng;
    stage_rows(st, dyb + hq * p, i0, l, hs, p, dm.pp, dm.ldp, true, vec_x);
    stage_rows(st + kT * dm.ldp, xb + hq * p, (s / ng) * kT, l, hs, p, dm.pp,
               dm.ldp, true, vec_x);
    hopper::cp_async_commit();
  };
  issue(0);

  const Frag f;
  float dC[kNTW][4];
  zero(dC);
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();                 // the last dC product is done
    stage_rows(Bj, Bb, j0, l, n, n, dm.np, dm.ldn, false, false);
    __syncthreads();
    float G[kNT][4], dGs[kNT][4];
    zero(G);
    zero(dGs);
    warp_mma(G, View{Ci, dm.ldn, 1}, View{Bj, 1, dm.ldn}, f.row0, f.cg,
             dm.np, kT);
    for (int hq = 0; hq < ng; ++hq) {
      const int s = jt * ng + hq;
      const bool next = s + 1 < steps;
      if (next && stages == 2) {
        issue(s + 1);
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
      const float* sdy = ring + (s % stages) * stage;
      float dM[kNT][4];
      zero(dM);
      warp_mma(dM, View{sdy, dm.ldp, 1}, View{sdy + kT * dm.ldp, 1, dm.ldp},
               f.row0, f.cg, dm.pp, kT);
      const float* csh = cs + hq * kMaxL;
      const float* dth = dts + hq * kMaxL;
      float e2[2] = {0.f, 0.f};      // rows g and g + 8
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + f.row(e), jj = j0 + f.col(j, e);
          const float L = (jj <= i && i < l) ? expf(csh[i] - csh[jj]) : 0.f;
          const float ldt = L * dth[jj];
          e2[e >> 1] = fmaf(dM[j][e], G[j][e] * ldt, e2[e >> 1]);
          dGs[j][e] = fmaf(dM[j][e], ldt, dGs[j][e]);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float v = quad_sum(e2[u]);
        if (f.t == 0) rowE[(f.cg * kGroup + hq) * kT + f.row0 + f.g + 8 * u] += v;
      }
      __syncthreads();               // this step's stage is consumed
      if (next && stages == 1) issue(s + 1);
    }
    // the group's dG: into Dg for dC, transposed into scratch for pass 3
    float* gt = dGt + ((bc * dm.groups + grp) * pairs(dm.nt) + pairs(it) + jt) *
                          (int64_t)(kT * kT);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(e), c = f.col(j, e);
        Dg[r * kLDT + c] = dGs[j][e];
        gt[c * kT + r] = dGs[j][e];
      }
    __syncthreads();
    warp_mma(dC, View{Dg, kLDT, 1}, View{Bj, dm.ldn, 1}, f.row0, f.cg, kT,
             dm.np);
  }

  __syncthreads();
  for (int e = threadIdx.x; e < ng * kT; e += kThreads) {
    const int hq = e / kT, r = e % kT, i = i0 + r;
    if (i < l)
    {
      float e2 = 0.f;
      for (int c = 0; c < kCG; ++c) e2 += rowE[(c * kGroup + hq) * kT + r];
      dcs_row[(bc * l + i) * h + g0 + hq] = e2;
    }
  }
  float* out = dCg + (bc * dm.groups + grp) * (int64_t)l * n;
#pragma unroll
  for (int j = 0; j < kNTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + f.row(e), c = f.col(j, e);
      if (i < l && c < n) out[(int64_t)i * n + c] = dC[j][e];
    }
}

__host__ __device__ inline size_t state_smem_floats(const Dims& d) {
  return 2 * kGroup * kMaxL + kCG * kT + (size_t)kT * d.ldn +
         (size_t)kT * d.ldp + (size_t)d.np * d.ldp;
}

// (2) per (key tile, group, bc): the chunk-state terms. Writes dx, ddt,
// dcs_col and sw for the group's heads and the group's dB partial; the key
// pass adds its terms to them.
__global__ void __launch_bounds__(kThreads, 1)
state_pass(const float* __restrict__ x, const float* __restrict__ dA,
           const float* __restrict__ dt, const float* __restrict__ B,
           const float* __restrict__ dst, float* __restrict__ dx,
           float* __restrict__ dBg, float* __restrict__ ddt,
           float* __restrict__ dcs_col, float* __restrict__ sw, Dims dm) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [kGroup][kMaxL]
  float* dts = cs + kGroup * kMaxL;
  float* dwp = dts + kGroup * kMaxL;             // [kCG][kT]
  float* Bj = dwp + kCG * kT;                    // [kT][ldn]
  float* X = Bj + kT * dm.ldn;                   // [kT][ldp]
  float* DS = X + kT * dm.ldp;                   // [np][ldp]

  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int jt = blockIdx.x, grp = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int g0 = grp * kGroup, ng = min(kGroup, h - g0);
  const int64_t hs = (int64_t)h * p;
  const int j0 = jt * kT;

  group_prefix(dA, dt, bc, g0, ng, dm, cs, dts);
  stage_rows(Bj, B + bc * l * n, j0, l, n, n, dm.np, dm.ldn, false, false);
  const Frag f;
  float dBs[kNTW][4];
  zero(dBs);
  for (int hq = 0; hq < ng; ++hq) {
    const int hh = g0 + hq;
    __syncthreads();                 // the last head's reads are done
    stage_rows(X, x + bc * l * hs + (int64_t)hh * p, j0, l, hs, p, dm.pp,
               dm.ldp, false, false);
    const float* dsb = dst + (bc * h + hh) * (int64_t)n * p;
    for (int e = threadIdx.x; e < dm.np * dm.pp; e += kThreads) {
      const int k = e / dm.pp, c = e % dm.pp;
      DS[k * dm.ldp + c] = (k < n && c < p) ? dsb[(int64_t)k * p + c] : 0.f;
    }
    __syncthreads();
    float xd[kNTW][4], bd[kNTW][4];        // (dst x_j)[k] and (dst^T B_j)[c]
    zero(xd);
    zero(bd);
    warp_mma(xd, View{X, dm.ldp, 1}, View{DS, 1, dm.ldp}, f.row0, f.cg,
             dm.pp, dm.np);
    warp_mma(bd, View{Bj, dm.ldn, 1}, View{DS, dm.ldp, 1}, f.row0, f.cg,
             dm.np, dm.pp);
    const float* csh = cs + hq * kMaxL;
    const float* dth = dts + hq * kMaxL;
    const float cs_last = csh[l - 1];
    float dw2[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(e), c = f.col(j, e);
        if (c < dm.np)
          dw2[e >> 1] = fmaf(Bj[r * dm.ldn + c], xd[j][e], dw2[e >> 1]);
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float v = quad_sum(dw2[u]);
      if (f.t == 0) dwp[f.cg * kT + f.row0 + f.g + 8 * u] = v;
    }
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = f.row(e), c = f.col(j, e), jj = j0 + r;
        const float w = jj < l ? expf(cs_last - csh[jj]) * dth[jj] : 0.f;
        dBs[j][e] = fmaf(w, xd[j][e], dBs[j][e]);
        if (jj < l && c < p)
          dx[(bc * l + jj) * hs + (int64_t)hh * p + c] = w * bd[j][e];
      }
    __syncthreads();
    if (threadIdx.x < kT) {
      const int jj = j0 + threadIdx.x;
      if (jj < l) {
        const float decay = expf(cs_last - csh[jj]), w = decay * dth[jj];
        float dw = 0.f;
        for (int c = 0; c < kCG; ++c) dw += dwp[c * kT + threadIdx.x];
        const int64_t o = (bc * l + jj) * h + hh;
        ddt[o] = decay * dw;
        dcs_col[o] = -w * dw;
        sw[o] = w * dw;
      }
    }
  }
  float* out = dBg + (bc * dm.groups + grp) * (int64_t)l * n;
#pragma unroll
  for (int j = 0; j < kNTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j0 + f.row(e), c = f.col(j, e);
      if (jj < l && c < n) out[(int64_t)jj * n + c] = dBs[j][e];
    }
}

__host__ __device__ inline int widest(const Dims& d) {
  return d.ldp > d.ldn ? d.ldp : d.ldn;
}

__host__ __device__ inline size_t key_smem_floats(const Dims& d, int stages) {
  return 2 * kGroup * kMaxL + 2 * 4 * kT + (size_t)d.nt * kT * kLDT +
         (size_t)kT * kLDT + (size_t)(1 + stages) * kT * widest(d);
}

// (3) per (key tile, group, bc): adds to dx, ddt and dcs_col the terms of
// the masked product, and to the group's dB partial (sum_h dG)^T C
__global__ void __launch_bounds__(kThreads, 1)
key_pass(const float* __restrict__ x, const float* __restrict__ dA,
         const float* __restrict__ dt, const float* __restrict__ B,
         const float* __restrict__ C, const float* __restrict__ dy,
         const float* __restrict__ dGt, float* __restrict__ dx,
         float* __restrict__ dBg, float* __restrict__ ddt,
         float* __restrict__ dcs_col, Dims dm, int stages, bool vec_x) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [kGroup][kMaxL]
  float* dts = cs + kGroup * kMaxL;
  float* colS = dts + kGroup * kMaxL;            // [2][4][kT]
  float* Gall = colS + 2 * 4 * kT;               // [nt][kT][kLDT]
  float* Ms = Gall + dm.nt * kT * kLDT;          // [kT][kLDT]: M^T, dG^T
  float* P = Ms + kT * kLDT;                     // [kT][widest]: B_j, x_j
  float* ring = P + kT * widest(dm);             // stages x [kT][widest]

  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int jt = blockIdx.x, grp = blockIdx.y;   // jt = 0 is the heaviest
  const int64_t bc = blockIdx.z;
  const int g0 = grp * kGroup, ng = min(kGroup, h - g0);
  const int64_t hs = (int64_t)h * p;
  const float* Cb = C + bc * l * n;
  const int j0 = jt * kT, nq = dm.nt - jt;
  const int stage = kT * widest(dm);
  const Frag f;

  group_prefix(dA, dt, bc, g0, ng, dm, cs, dts);
  // G_ij for every query tile i >= j, once for the group's heads
  stage_rows(P, B + bc * l * n, j0, l, n, n, dm.np, dm.ldn, false, false);
  for (int q = 0; q < nq; ++q) {
    __syncthreads();
    stage_rows(ring, Cb, j0 + q * kT, l, n, n, dm.np, dm.ldn, false, false);
    __syncthreads();
    float G[kNT][4];
    zero(G);
    warp_mma(G, View{ring, dm.ldn, 1}, View{P, 1, dm.ldn}, f.row0, f.cg,
             dm.np, kT);
    float* Gq = Gall + q * kT * kLDT;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Gq[f.row(e) * kLDT + f.col(j, e)] = G[j][e];
  }
  __syncthreads();

  // step s: head s / nq, query tile j + s % nq; its dy_i into the ring
  const int steps = ng * nq;
  auto issue = [&](int s) {
    stage_rows(ring + (s % stages) * stage,
               dy + bc * l * hs + (int64_t)(g0 + s / nq) * p,
               j0 + (s % nq) * kT, l, hs, p, dm.pp, dm.ldp, true, vec_x);
    hopper::cp_async_commit();
  };
  issue(0);
  for (int hq = 0; hq < ng; ++hq) {
    const int hh = g0 + hq;
    const float* csh = cs + hq * kMaxL;
    const float* dth = dts + hq * kMaxL;
    __syncthreads();                 // the last head's reads of P are done
    stage_rows(P, x + bc * l * hs + (int64_t)hh * p, j0, l, hs, p, dm.pp,
               dm.ldp, false, false);
    float dxa[kNTW][4], cP[kNT][2], cE[kNT][2];
    zero(dxa);
#pragma unroll
    for (int j = 0; j < kNT; ++j) cP[j][0] = cP[j][1] = cE[j][0] = cE[j][1] = 0.f;
    for (int q = 0; q < nq; ++q) {
      const int s = hq * nq + q;
      const bool next = s + 1 < steps;
      if (next && stages == 2) {
        issue(s + 1);
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();
      const float* sdy = ring + (s % stages) * stage;
      float dM[kNT][4];
      zero(dM);
      warp_mma(dM, View{sdy, dm.ldp, 1}, View{P, 1, dm.ldp}, f.row0, f.cg,
               dm.pp, kT);
      const float* Gq = Gall + q * kT * kLDT;
      const int i0 = j0 + q * kT;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = f.row(e), c = f.col(j, e);
          const int i = i0 + r, jj = j0 + c;
          const float L = (jj <= i && i < l) ? expf(csh[i] - csh[jj]) : 0.f;
          const float gl = Gq[r * kLDT + c] * L;
          const float M = gl * dth[jj];
          cP[j][e & 1] = fmaf(dM[j][e], gl, cP[j][e & 1]);
          cE[j][e & 1] = fmaf(dM[j][e], M, cE[j][e & 1]);
          Ms[c * kLDT + r] = M;
        }
      __syncthreads();
      warp_mma(dxa, View{Ms, kLDT, 1}, View{sdy, dm.ldp, 1}, f.row0, f.cg,
               kT, dm.pp);
      __syncthreads();               // Ms and this step's stage are consumed
      if (next && stages == 1) issue(s + 1);
    }
    // column sums: over the warp's rows, then over the 4 row strips
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float vp = column_sum(cP[j][u]), ve = column_sum(cE[j][u]);
        if (f.g == 0) {
          colS[(f.row0 / 16) * kT + f.col(j, u)] = vp;
          colS[(4 + f.row0 / 16) * kT + f.col(j, u)] = ve;
        }
      }
    __syncthreads();
    if (threadIdx.x < kT && j0 + threadIdx.x < l) {
      const int c = threadIdx.x;
      const int64_t o = (bc * l + j0 + c) * h + hh;
      ddt[o] += colS[c] + colS[kT + c] + colS[2 * kT + c] + colS[3 * kT + c];
      dcs_col[o] -= colS[4 * kT + c] + colS[5 * kT + c] + colS[6 * kT + c] +
                    colS[7 * kT + c];
    }
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = j0 + f.row(e), c = f.col(j, e);
        if (jj < l && c < p) dx[(bc * l + jj) * hs + (int64_t)hh * p + c] +=
            dxa[j][e];
      }
  }

  // dB_j += sum_i (sum_h dG_ij)^T C_i, from pass 1's transposed sums
  float dB[kNTW][4];
  zero(dB);
  for (int q = 0; q < nq; ++q) {
    const int it = jt + q;
    const float* gt = dGt + ((bc * dm.groups + grp) * pairs(dm.nt) +
                             pairs(it) + jt) * (int64_t)(kT * kT);
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads)
      Ms[(e / kT) * kLDT + e % kT] = gt[e];
    stage_rows(ring, Cb, it * kT, l, n, n, dm.np, dm.ldn, false, false);
    __syncthreads();
    warp_mma(dB, View{Ms, kLDT, 1}, View{ring, dm.ldn, 1}, f.row0, f.cg,
             kT, dm.np);
  }
  float* out = dBg + (bc * dm.groups + grp) * (int64_t)l * n;
#pragma unroll
  for (int j = 0; j < kNTW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j0 + f.row(e), c = f.col(j, e);
      if (jj < l && c < n) out[(int64_t)jj * n + c] += dB[j][e];
    }
}

// (4) per (bc, head): ddA_k = sum_{i >= k} dcs_i, the last row also
// collecting sum_j w_j dw_j
__global__ void finish_dA_kernel(const float* __restrict__ dcs_row,
                                 const float* __restrict__ dcs_col,
                                 const float* __restrict__ sw,
                                 float* __restrict__ ddA, int64_t BC, int l,
                                 int h) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= BC * h) return;
  const int64_t bc = t / h;
  const int hh = (int)(t % h);
  double tot = 0.0;
  for (int i = 0; i < l; ++i) tot += (double)sw[(bc * l + i) * h + hh];
  double run = tot;
  for (int i = l - 1; i >= 0; --i) {
    const int64_t o = (bc * l + i) * h + hh;
    run += (double)dcs_row[o] + (double)dcs_col[o];
    ddA[o] = (float)run;
  }
}

// (5) dB and dC: the sum over head groups of the groups' partials
__global__ void group_sum_kernel(const float* __restrict__ dBg,
                                 const float* __restrict__ dCg,
                                 float* __restrict__ dB, float* __restrict__ dC,
                                 int64_t BC, int l, int groups, int n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per = (int64_t)l * n;
  if (t >= BC * per) return;
  const int64_t bc = t / per, e = t % per;
  float sb = 0.f, sc = 0.f;
  for (int gg = 0; gg < groups; ++gg) {
    sb += dBg[(bc * groups + gg) * per + e];
    sc += dCg[(bc * groups + gg) * per + e];
  }
  dB[t] = sb;
  dC[t] = sc;
}

Dims make_dims(int64_t l, int64_t h, int64_t p, int64_t n) {
  Dims d;
  d.l = (int)l;
  d.h = (int)h;
  d.p = (int)p;
  d.n = (int)n;
  d.pp = (int)((p + 7) / 8 * 8);
  d.np = (int)((n + 7) / 8 * 8);
  d.ldp = d.pp + 4;
  d.ldn = d.np + 4;
  d.nt = (int)((l + kT - 1) / kT);
  d.groups = (int)((h + kGroup - 1) / kGroup);
  return d;
}

constexpr size_t kSmemMax = 232448;  // bytes a block may have on sm_90

// the ring's depth: two stages where they fit
int ring_stages(size_t (*floats)(const Dims&, int), const Dims& d) {
  return floats(d, 2) * sizeof(float) <= kSmemMax ? 2 : 1;
}

}  // namespace

// floats of scratch the launcher needs: the groups' dB and dC partials
// (2 BC groups l n), pass 1's summed dG per tile pair (BC groups pairs 64
// 64), and dcs's row and column terms and w dw (3 BC l h)
extern "C" int64_t ssd_chunk_bwd_scratch(int64_t BC, int64_t l, int64_t h,
                                         int64_t p, int64_t n) {
  const Dims d = make_dims(l, h, p, n);
  return 2 * BC * d.groups * l * n +
         BC * d.groups * (int64_t)pairs(d.nt) * kT * kT + 3 * BC * l * h;
}

extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dA, const void* dt, const void* B,
    const void* C, const void* dy, const void* dst, void* dx, void* ddA,
    void* ddt, void* dB, void* dC, void* scratch, int64_t BC, int64_t l,
    int64_t h, int64_t p, int64_t n, void* stream) {
  if (BC <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0)
    return (int)cudaSuccess;
  if (l > kMaxL || p > kMaxDim || n > kMaxDim || BC > 65535 ||
      h > 65535 * kGroup)
    return (int)cudaErrorInvalidValue;
  const Dims dm = make_dims(l, h, p, n);
  cudaStream_t st = (cudaStream_t)stream;
  float* dBg = (float*)scratch;
  float* dCg = dBg + BC * dm.groups * l * n;
  float* dGt = dCg + BC * dm.groups * l * n;
  float* dcs_row = dGt + BC * dm.groups * (int64_t)pairs(dm.nt) * kT * kT;
  float* dcs_col = dcs_row + BC * l * h;
  float* sw = dcs_col + BC * l * h;
  // 16-byte cp.async of x and dy rows: every row and the bases on 16 bytes
  const bool vec_x = p % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)dy % 16 == 0;

  const int sq = ring_stages(query_smem_floats, dm);
  const int sk = ring_stages(key_smem_floats, dm);
  const size_t smem_q = query_smem_floats(dm, sq) * sizeof(float);
  const size_t smem_s = state_smem_floats(dm) * sizeof(float);
  const size_t smem_k = key_smem_floats(dm, sk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      query_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      state_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      key_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((unsigned)dm.nt, (unsigned)dm.groups, (unsigned)BC);
  query_pass<<<grid, kThreads, smem_q, st>>>(
      (const float*)x, (const float*)dA, (const float*)dt, (const float*)B,
      (const float*)C, (const float*)dy, dCg, dGt, dcs_row, dm, sq, vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  state_pass<<<grid, kThreads, smem_s, st>>>(
      (const float*)x, (const float*)dA, (const float*)dt, (const float*)B,
      (const float*)dst, (float*)dx, dBg, (float*)ddt, dcs_col, sw, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  key_pass<<<grid, kThreads, smem_k, st>>>(
      (const float*)x, (const float*)dA, (const float*)dt, (const float*)B,
      (const float*)C, (const float*)dy, dGt, (float*)dx, dBg, (float*)ddt,
      dcs_col, dm, sk, vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t heads = BC * h;
  finish_dA_kernel<<<(unsigned)((heads + 127) / 128), 128, 0, st>>>(
      dcs_row, dcs_col, sw, (float*)ddA, BC, (int)l, (int)h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t elems = BC * l * n;
  group_sum_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(
      dBg, dCg, (float*)dB, (float*)dC, BC, (int)l, dm.groups, (int)n);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
