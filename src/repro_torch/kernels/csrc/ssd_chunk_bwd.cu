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
// Design: four kernels on one stream and no atomics, so the result does not
// depend on the order blocks run in. (1) One block per (bc, head, 64-row
// query tile i) walks the key tiles j <= i and accumulates this head's dC_i
// and the row sums of dM o M. (2) One block per (bc, head, 64-row key tile
// j) walks the query tiles i >= j and accumulates dx_j, this head's dB_j and
// the column sums for ddt_j and dcs_j, then adds the chunk-state terms.
// Both recompute G, L and dM from the inputs; each thread holds 4 rows x 4
// columns of a 64 x 64 tile (rows ty + 16 r, columns tx + 16 u) and 4 rows x
// up to 8 columns of its outputs, with tiles in shared memory padded to
// odd row lengths. exp(cs_i - cs_j) is taken only where j <= i: above the
// diagonal the segment sum is positive and may overflow, and 0 * inf would
// put a NaN into the gradient. (3) One thread per (bc, head) turns dcs into
// ddA with a reverse cumulative sum in float64. (4) One thread per (bc, row,
// state entry) sums the heads' dB and dC partials. cs is formed as the
// forward forms it (a warp scan accumulated in float64, rounded once).
//
// What bounds it: float32 operations on CUDA cores (TF32 off, as in the
// forward): about 3 l^2 (n + p) + 6 l n p flops per head, G and dM formed
// twice. Forming G once per (batch, chunk) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;               // rows per tile (query and key)
constexpr int kLDM = kT + 1;         // padded row of the 64 x 64 tiles
constexpr int kThreads = 256;        // 16 x 16 threads: ty, tx
constexpr int kMaxL = 256;
constexpr int kMaxQ = 8;             // up to 128 output columns per thread

struct Dims {
  int l, h, p, n;
  int ldn, ldp;                      // padded rows of the n- and p-wide tiles
};

// inclusive in-chunk cumsum of dA for head hh into cs[0, kMaxL) (zeros past
// l), accumulated in float64 by warp 0 and rounded once; dt into dts
__device__ void chunk_prefix(const float* dA, const float* dt, int64_t bc,
                             int hh, const Dims& dm, float* cs, float* dts) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = dm.l, h = dm.h;
  for (int i = tid; i < kMaxL; i += kThreads)
    dts[i] = i < l ? dt[(bc * l + i) * h + hh] : 0.f;
  if (warp == 0) {
    double v[kMaxL / 32];
    double run = 0.0;
#pragma unroll
    for (int u = 0; u < kMaxL / 32; ++u) {
      const int i = lane * (kMaxL / 32) + u;
      run += i < l ? (double)dA[(bc * l + i) * h + hh] : 0.0;
      v[u] = run;
    }
    double tot = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, tot, d);
      if (lane >= d) tot += t;
    }
    const double off = tot - run;
#pragma unroll
    for (int u = 0; u < kMaxL / 32; ++u)
      cs[lane * (kMaxL / 32) + u] = (float)(v[u] + off);
  }
}

// stage rows [r0, r0 + kT) (< l) of a row-major matrix with row stride
// `stride` and `cols` columns into dst [kT][ld], zero-padded
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int l, int64_t stride,
                                          int cols, int ld) {
  for (int e = threadIdx.x; e < kT * ld; e += kThreads) {
    const int r = e / ld, c = e % ld;
    const int row = r0 + r;
    dst[e] = (row < l && c < cols) ? src[(int64_t)row * stride + c] : 0.f;
  }
}

// G = C_i B_j^T and dM = dy_i x_j^T over one tile pair, masked, with the
// derived M = G L dt_j and dG = dM L dt_j. Thread (ty, tx) gets query rows
// ty + 16 r and key columns tx + 16 u.
struct PairTile {
  float G[4][4], dM[4][4], L[4][4];
};

__device__ __forceinline__ void pair_tile(const float* Ci, const float* dyi,
                                          const float* Bj, const float* xj,
                                          const float* cs, int i0, int j0,
                                          const Dims& dm, int ty, int tx,
                                          PairTile& t) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) t.G[r][u] = t.dM[r][u] = 0.f;
  for (int k = 0; k < dm.n; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = Ci[(ty + 16 * r) * dm.ldn + k];
      b[r] = Bj[(tx + 16 * r) * dm.ldn + k];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) t.G[r][u] = fmaf(a[r], b[u], t.G[r][u]);
  }
  for (int c = 0; c < dm.p; ++c) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[r] = dyi[(ty + 16 * r) * dm.ldp + c];
      b[r] = xj[(tx + 16 * r) * dm.ldp + c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) t.dM[r][u] = fmaf(a[r], b[u], t.dM[r][u]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + tx + 16 * u;
      t.L[r][u] = (j <= i && i < dm.l) ? expf(cs[i] - cs[j]) : 0.f;
    }
  }
}

// sum over the 16 threads of a half-warp (the tx of one ty)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__host__ __device__ inline size_t dc_smem_floats(const Dims& d) {
  return 2 * kMaxL + 2 * (size_t)kT * (d.ldn + d.ldp) + (size_t)kT * kLDM;
}

// (1) per (query tile, head, bc): this head's dC rows and dcs row sums
__global__ void __launch_bounds__(kThreads)
dc_kernel(const float* __restrict__ x, const float* __restrict__ dA,
          const float* __restrict__ dt, const float* __restrict__ B,
          const float* __restrict__ C, const float* __restrict__ dy,
          float* __restrict__ dCh, float* __restrict__ dcs_row, Dims dm) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* dts = cs + kMaxL;
  float* Ci = dts + kMaxL;                       // [kT][ldn]
  float* dyi = Ci + kT * dm.ldn;                 // [kT][ldp]
  float* Bj = dyi + kT * dm.ldp;                 // [kT][ldn]
  float* xj = Bj + kT * dm.ldn;                  // [kT][ldp]
  float* dGs = xj + kT * dm.ldp;                 // [kT][kLDM]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int it = blockIdx.x, hh = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int64_t hs = (int64_t)h * p;
  const float* xb = x + bc * l * hs + (int64_t)hh * p;
  const float* dyb = dy + bc * l * hs + (int64_t)hh * p;
  const float* Bb = B + bc * l * n;
  const float* Cb = C + bc * l * n;
  const int i0 = it * kT;

  chunk_prefix(dA, dt, bc, hh, dm, cs, dts);
  load_rows(Ci, Cb + (int64_t)i0 * n, 0, l - i0, n, n, dm.ldn);
  load_rows(dyi, dyb + i0 * hs, 0, l - i0, hs, p, dm.ldp);

  float acc[4][kMaxQ], rowE[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rowE[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) acc[r][q] = 0.f;
  }

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();                 // cs ready; previous tiles consumed
    load_rows(Bj, Bb + (int64_t)j0 * n, 0, l - j0, n, n, dm.ldn);
    load_rows(xj, xb + j0 * hs, 0, l - j0, hs, p, dm.ldp);
    __syncthreads();

    PairTile t;
    pair_tile(Ci, dyi, Bj, xj, cs, i0, j0, dm, ty, tx, t);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float ld = t.L[r][u] * dts[j0 + tx + 16 * u];
        rowE[r] = fmaf(t.dM[r][u], t.G[r][u] * ld, rowE[r]);
        dGs[(ty + 16 * r) * kLDM + tx + 16 * u] = t.dM[r][u] * ld;
      }
    __syncthreads();

    // dC_i[k] += sum_j dG_ij B_j[k] for rows ty + 16 r, k = tx + 16 q
    for (int j = 0; j < kT; ++j) {
      float g[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) g[r] = dGs[(ty + 16 * r) * kLDM + j];
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (16 * q >= n) break;
        const float b = Bj[j * dm.ldn + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][q] = fmaf(g[r], b, acc[r][q]);
      }
    }
  }

  float* dCb = dCh + (bc * h + hh) * (int64_t)l * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    const float e = half_warp_sum(rowE[r]);
    if (i >= l) continue;
    if (tx == 0) dcs_row[(bc * l + i) * h + hh] = e;
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int k = tx + 16 * q;
      if (16 * q < n && k < n) dCb[(int64_t)i * n + k] = acc[r][q];
    }
  }
}

__host__ __device__ inline size_t dxb_smem_floats(const Dims& d) {
  const size_t pair = (size_t)kT * (d.ldn + d.ldp);
  const size_t ds = (size_t)d.n * d.ldp;
  return 2 * kMaxL + pair + (pair > ds ? pair : ds) + 2 * (size_t)kT * kLDM +
         2 * kT;
}

// (2) per (key tile, head, bc): dx rows, this head's dB rows, ddt, and the
// column terms of dcs
__global__ void __launch_bounds__(kThreads)
dxb_kernel(const float* __restrict__ x, const float* __restrict__ dA,
           const float* __restrict__ dt, const float* __restrict__ B,
           const float* __restrict__ C, const float* __restrict__ dy,
           const float* __restrict__ dst, float* __restrict__ dx,
           float* __restrict__ dBh, float* __restrict__ ddt,
           float* __restrict__ dcs_col, float* __restrict__ sw_out,
           Dims dm) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* dts = cs + kMaxL;
  float* Bj = dts + kMaxL;                       // [kT][ldn]
  float* xj = Bj + kT * dm.ldn;                  // [kT][ldp]
  float* Ci = xj + kT * dm.ldp;                  // [kT][ldn]
  float* dyi = Ci + kT * dm.ldn;                 // [kT][ldp]
  float* DS = Ci;                                // [n][ldp], state pass
  const size_t pair = (size_t)kT * (dm.ldn + dm.ldp);
  const size_t dsz = (size_t)dm.n * dm.ldp;
  float* Ms = Ci + (pair > dsz ? pair : dsz);    // [kT][kLDM]
  float* dGs = Ms + kT * kLDM;                   // [kT][kLDM]
  float* colP = dGs + kT * kLDM;                 // [kT]
  float* colE = colP + kT;                       // [kT]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int jt = blockIdx.x, hh = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int64_t hs = (int64_t)h * p;
  const float* xb = x + bc * l * hs + (int64_t)hh * p;
  const float* dyb = dy + bc * l * hs + (int64_t)hh * p;
  const float* Bb = B + bc * l * n;
  const float* Cb = C + bc * l * n;
  const int j0 = jt * kT;
  const int nt = (l + kT - 1) / kT;

  chunk_prefix(dA, dt, bc, hh, dm, cs, dts);
  load_rows(Bj, Bb + (int64_t)j0 * n, 0, l - j0, n, n, dm.ldn);
  load_rows(xj, xb + j0 * hs, 0, l - j0, hs, p, dm.ldp);

  float ax[4][kMaxQ], ab[4][kMaxQ], cP[4], cE[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    cP[r] = cE[r] = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) ax[r][q] = ab[r][q] = 0.f;
  }

  for (int it = jt; it < nt; ++it) {
    const int i0 = it * kT;
    __syncthreads();
    load_rows(Ci, Cb + (int64_t)i0 * n, 0, l - i0, n, n, dm.ldn);
    load_rows(dyi, dyb + i0 * hs, 0, l - i0, hs, p, dm.ldp);
    __syncthreads();

    PairTile t;
    pair_tile(Ci, dyi, Bj, xj, cs, i0, j0, dm, ty, tx, t);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float d = dts[j0 + tx + 16 * u];
        const float gl = t.G[r][u] * t.L[r][u];
        cP[u] = fmaf(t.dM[r][u], gl, cP[u]);
        cE[u] = fmaf(t.dM[r][u], gl * d, cE[u]);
        Ms[(ty + 16 * r) * kLDM + tx + 16 * u] = gl * d;
        dGs[(ty + 16 * r) * kLDM + tx + 16 * u] = t.dM[r][u] * t.L[r][u] * d;
      }
    __syncthreads();

    // dx_j += sum_i M_ij dy_i and dB_j += sum_i dG_ij C_i, for key rows
    // ty + 16 r and columns tx + 16 q
    for (int i = 0; i < kT; ++i) {
      float m[4], g[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m[r] = Ms[i * kLDM + ty + 16 * r];
        g[r] = dGs[i * kLDM + ty + 16 * r];
      }
#pragma unroll
      for (int q = 0; q < kMaxQ; ++q) {
        if (16 * q < p) {
          const float d = dyi[i * dm.ldp + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) ax[r][q] = fmaf(m[r], d, ax[r][q]);
        }
        if (16 * q < n) {
          const float c = Ci[i * dm.ldn + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) ab[r][q] = fmaf(g[r], c, ab[r][q]);
        }
      }
    }
  }

  // column sums over the query rows: thread (ty, tx) holds columns
  // tx + 16 u summed over its rows; reduce over ty through shared memory
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    Ms[ty * kT + tx + 16 * u] = cP[u];
    dGs[ty * kT + tx + 16 * u] = cE[u];
  }
  const float* dsb = dst + (bc * h + hh) * (int64_t)n * p;
  for (int e = tid; e < n * dm.ldp; e += kThreads) {   // dst, [n][ldp]
    const int k = e / dm.ldp, c = e % dm.ldp;
    DS[e] = c < p ? dsb[(int64_t)k * p + c] : 0.f;
  }
  __syncthreads();
  if (tid < kT) {
    float sp = 0.f, se = 0.f;
    for (int y = 0; y < 16; ++y) {
      sp += Ms[y * kT + tid];
      se += dGs[y * kT + tid];
    }
    colP[tid] = sp;
    colE[tid] = se;
  }
  __syncthreads();

  // chunk-state terms for key rows ty + 16 r
  const float cs_last = cs[l - 1];
  float* dBb = dBh + (bc * h + hh) * (int64_t)l * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jl = ty + 16 * r, j = j0 + jl;
    const float decay = j < l ? expf(cs_last - cs[j]) : 0.f;
    const float w = decay * dts[j];
    float dw = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int k = tx + 16 * q;
      if (16 * q < n && k < n) {               // (dst x_j)[k]
        float xd = 0.f;
        for (int c = 0; c < p; ++c)
          xd = fmaf(xj[jl * dm.ldp + c], DS[k * dm.ldp + c], xd);
        ab[r][q] = fmaf(w, xd, ab[r][q]);
        dw = fmaf(Bj[jl * dm.ldn + k], xd, dw);
      }
      const int c = tx + 16 * q;
      if (16 * q < p && c < p) {               // (dst^T B_j)[c]
        float bd = 0.f;
        for (int k2 = 0; k2 < n; ++k2)
          bd = fmaf(Bj[jl * dm.ldn + k2], DS[k2 * dm.ldp + c], bd);
        ax[r][q] = fmaf(w, bd, ax[r][q]);
      }
    }
    dw = half_warp_sum(dw);
    if (j >= l) continue;
    if (tx == 0) {
      const int64_t o = (bc * l + j) * h + hh;
      ddt[o] = colP[jl] + decay * dw;
      dcs_col[o] = -colE[jl] - w * dw;
      sw_out[o] = w * dw;
    }
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      const int c = tx + 16 * q;
      if (16 * q < p && c < p) dx[(bc * l + j) * hs + (int64_t)hh * p + c] =
          ax[r][q];
      if (16 * q < n && c < n) dBb[(int64_t)j * n + c] = ab[r][q];
    }
  }
}

// (3) per (bc, head): ddA_k = sum_{i >= k} dcs_i, the last row also
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

// (4) dB and dC: the sum over heads of the per-head partials
__global__ void head_sum_kernel(const float* __restrict__ dBh,
                                const float* __restrict__ dCh,
                                float* __restrict__ dB, float* __restrict__ dC,
                                int64_t BC, int l, int h, int n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per = (int64_t)l * n;
  if (t >= BC * per) return;
  const int64_t bc = t / per, e = t % per;
  float sb = 0.f, sc = 0.f;
  for (int hh = 0; hh < h; ++hh) {
    sb += dBh[(bc * h + hh) * per + e];
    sc += dCh[(bc * h + hh) * per + e];
  }
  dB[t] = sb;
  dC[t] = sc;
}

}  // namespace

// scratch: 2 * BC*h*l*n floats (the heads' dB and dC partials) then
// 3 * BC*l*h floats (dcs row and column terms, w dw)
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dA, const void* dt, const void* B,
    const void* C, const void* dy, const void* dst, void* dx, void* ddA,
    void* ddt, void* dB, void* dC, void* scratch, int64_t BC, int64_t l,
    int64_t h, int64_t p, int64_t n, void* stream) {
  if (BC <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0)
    return (int)cudaSuccess;
  if (l > kMaxL || p > 16 * kMaxQ || n > 16 * kMaxQ || BC > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  Dims dm{(int)l, (int)h, (int)p, (int)n, (int)n + 1, (int)p + 1};
  cudaStream_t st = (cudaStream_t)stream;
  float* dBh = (float*)scratch;
  float* dCh = dBh + BC * h * l * n;
  float* dcs_row = dCh + BC * h * l * n;
  float* dcs_col = dcs_row + BC * l * h;
  float* sw = dcs_col + BC * l * h;

  const size_t smem_a = dc_smem_floats(dm) * sizeof(float);
  const size_t smem_b = dxb_smem_floats(dm) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      dxb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((unsigned)((l + kT - 1) / kT), (unsigned)h, (unsigned)BC);
  dc_kernel<<<grid, kThreads, smem_a, st>>>(
      (const float*)x, (const float*)dA, (const float*)dt, (const float*)B,
      (const float*)C, (const float*)dy, dCh, dcs_row, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dxb_kernel<<<grid, kThreads, smem_b, st>>>(
      (const float*)x, (const float*)dA, (const float*)dt, (const float*)B,
      (const float*)C, (const float*)dy, (const float*)dst, (float*)dx, dBh,
      (float*)ddt, dcs_col, sw, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t heads = BC * h;
  finish_dA_kernel<<<(unsigned)((heads + 127) / 128), 128, 0, st>>>(
      dcs_row, dcs_col, sw, (float*)ddA, BC, (int)l, (int)h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t elems = BC * l * n;
  head_sum_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(
      dBh, dCh, (float*)dB, (float*)dC, BC, (int)l, (int)h, (int)n);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
