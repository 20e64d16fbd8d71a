// Mamba2 SSD intra-chunk product for Hopper (sm_90a). Replaces the Pallas
// kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_chunk (body
// _ssd_chunk_kernel).
//
// Per (batch*chunk bc, head hh), with cs the in-chunk cumulative sum of dA:
//   y[i, :]  = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x[j, :]
//   st[:, :] = sum_j B_j^T exp(cs_{l-1} - cs_j) dt_j x[j, :]
// Layouts (row-major, float32): x and y (bc, l, h, p); dA, dt (bc, l, h);
// B, C (bc, l, n), one SSM group shared by every head; st (bc, h, n, p).
//
// Design: one block of 256 threads per (bc, head). It forms cs once in
// shared memory (a warp scan, accumulated in double so it rounds like a
// sequential sum), then walks 64-row query tiles i and, for each, the
// 64-row key tiles j at or below the diagonal: C of tile i and B of tile j
// are staged transposed, each thread forms 4 x 4 entries of the masked
// M = (C B^T) o exp(segsum) o dt (exp taken only where j <= i: above the
// diagonal the segment sum is positive and may overflow), and M times the
// x tile accumulates 4 rows x p/16 columns of y in registers. A last pass
// over the key tiles forms the chunk state from B scaled by
// exp(cs_{l-1} - cs_j) dt_j. The TPU kernel kept the whole chunk in VMEM;
// here the tiles keep shared memory at ~67 KB for l = 256, p = n = 64
// (three blocks per SM), and any l <= 256, p, n <= 128 fit.
//
// What bounds it: float32 operations on CUDA cores (TF32 would miss the
// 1e-4 tolerance): per head about l^2 (n + p) + 2 l n p flops. C B^T does
// not depend on the head; computing it once per (batch, chunk) is later
// work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;               // rows per tile (query and key)
constexpr int kLDT = kT + 4;         // padded row of the transposed B tile
constexpr int kThreads = 256;        // 16 x 16: rows ty*4.., columns tx*4..
constexpr int kMaxL = 256;

struct Dims {
  int l, h, p, n;
  int pg, ng;                        // 64-wide groups of p and of n
};

__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return 2 * kMaxL                    // cs, dt
         + (size_t)d.ng * 64 * kT     // Ct [n][kT], later Bs [kT][ng*64]
         + (size_t)d.ng * 64 * kLDT   // Bt [n][kLDT]
         + (size_t)kT * d.pg * 64     // Xs [kT][pg*64]
         + (size_t)kT * kT;           // Ms [kT][kT]
}

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ dt, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ st, Dims dm) {
  extern __shared__ float4 smem4[];
  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int LDX = dm.pg * 64, LDB = dm.ng * 64;
  float* cs = reinterpret_cast<float*>(smem4);
  float* dts = cs + kMaxL;
  float* Ct = dts + kMaxL;                       // [LDB][kT]
  float* Bt = Ct + (size_t)LDB * kT;             // [LDB][kLDT]
  float* Xs = Bt + (size_t)LDB * kLDT;           // [kT][LDX]
  float* Ms = Xs + (size_t)kT * LDX;             // [kT][kT]
  float* Bs = Ct;                                // [kT][LDB], state pass

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int hh = blockIdx.x;
  const int64_t bc = blockIdx.y;
  const float* xb = x + bc * l * h * p + (int64_t)hh * p;   // row stride h*p
  float* yb = y + bc * l * h * p + (int64_t)hh * p;
  const float* Bb = B + bc * l * n;
  const float* Cb = C + bc * l * n;
  const int64_t hs = (int64_t)h * p;

  for (int i = tid; i < kMaxL; i += kThreads)
    dts[i] = i < l ? dt[(bc * l + i) * h + hh] : 0.f;
  if (warp == 0) {                   // inclusive cumsum of dA, 8 per lane
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

  const int nt = (l + kT - 1) / kT;
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * kT;
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    __syncthreads();                 // cs ready; previous tiles consumed
    for (int e = tid; e < kT * LDB; e += kThreads) {   // C tile, transposed
      const int r = e / LDB, k = e % LDB;
      const int i = i0 + r;
      Ct[k * kT + r] = (i < l && k < n) ? Cb[(int64_t)i * n + k] : 0.f;
    }

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();
      for (int e = tid; e < kT * LDB; e += kThreads) { // B tile, transposed
        const int r = e / LDB, k = e % LDB;
        const int j = j0 + r;
        Bt[k * kLDT + r] = (j < l && k < n) ? Bb[(int64_t)j * n + k] : 0.f;
      }
      for (int e = tid; e < kT * LDX; e += kThreads) { // x tile
        const int r = e / LDX, c = e % LDX;
        const int j = j0 + r;
        Xs[r * LDX + c] = (j < l && c < p) ? xb[j * hs + c] : 0.f;
      }
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      for (int k = 0; k < n; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&Ct[k * kT + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bt[k * kLDT + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        float mv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx * 4 + c;
          mv[c] = (j <= i && i < l)
                      ? s[r][c] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
        }
        *reinterpret_cast<float4*>(&Ms[(ty * 4 + r) * kT + tx * 4]) =
            make_float4(mv[0], mv[1], mv[2], mv[3]);
      }
      __syncthreads();

      for (int jj = 0; jj < kT; jj += 4) {
        float mv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 m4 =
              *reinterpret_cast<const float4*>(&Ms[(ty * 4 + r) * kT + jj]);
          mv[r][0] = m4.x; mv[r][1] = m4.y; mv[r][2] = m4.z; mv[r][3] = m4.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            if (g >= dm.pg) break;
            const float4 w = *reinterpret_cast<const float4*>(
                &Xs[(jj + u) * LDX + g * 64 + tx * 4]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              acc[r][g * 4 + 0] = fmaf(mv[r][u], w.x, acc[r][g * 4 + 0]);
              acc[r][g * 4 + 1] = fmaf(mv[r][u], w.y, acc[r][g * 4 + 1]);
              acc[r][g * 4 + 2] = fmaf(mv[r][u], w.z, acc[r][g * 4 + 2]);
              acc[r][g * 4 + 3] = fmaf(mv[r][u], w.w, acc[r][g * 4 + 3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= l) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = g * 64 + tx * 4 + u;
          if (g < dm.pg && c < p) yb[i * hs + c] = acc[r][g * 4 + u];
        }
    }
  }

  // chunk state: st[k, c] = sum_j B[j, k] exp(cs_{l-1} - cs_j) dt_j x[j, c]
  float sa[2][4][2][4];              // [n group][row][p group][col]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) sa[a][r][g][u] = 0.f;
  const float cs_last = cs[l - 1];
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    for (int e = tid; e < kT * LDB; e += kThreads) {
      const int r = e / LDB, k = e % LDB;
      const int j = j0 + r;
      Bs[r * LDB + k] = (j < l && k < n)
          ? Bb[(int64_t)j * n + k] * (expf(cs_last - cs[j]) * dts[j]) : 0.f;
    }
    for (int e = tid; e < kT * LDX; e += kThreads) {
      const int r = e / LDX, c = e % LDX;
      const int j = j0 + r;
      Xs[r * LDX + c] = (j < l && c < p) ? xb[j * hs + c] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kT; ++jj) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (a >= dm.ng) break;
        const float4 b4 =
            *reinterpret_cast<const float4*>(&Bs[jj * LDB + a * 64 + ty * 4]);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          if (g >= dm.pg) break;
          const float4 w =
              *reinterpret_cast<const float4*>(&Xs[jj * LDX + g * 64 + tx * 4]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            sa[a][r][g][0] = fmaf(bv[r], w.x, sa[a][r][g][0]);
            sa[a][r][g][1] = fmaf(bv[r], w.y, sa[a][r][g][1]);
            sa[a][r][g][2] = fmaf(bv[r], w.z, sa[a][r][g][2]);
            sa[a][r][g][3] = fmaf(bv[r], w.w, sa[a][r][g][3]);
          }
        }
      }
    }
  }
  float* sb = st + (bc * h + hh) * (int64_t)n * p;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = a * 64 + ty * 4 + r;
      if (a >= dm.ng || k >= n) continue;
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = g * 64 + tx * 4 + u;
          if (g < dm.pg && c < p) sb[(int64_t)k * p + c] = sa[a][r][g][u];
        }
    }
}

}  // namespace

extern "C" int ssd_chunk_launch(const void* x, const void* dA, const void* dt,
                                const void* B, const void* C, void* y,
                                void* st, int64_t BC, int64_t l, int64_t h,
                                int64_t p, int64_t n, void* stream) {
  if (BC <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0)
    return (int)cudaSuccess;
  if (l > kMaxL || p > 128 || n > 128 || BC > 65535 || h > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Dims dm{(int)l, (int)h, (int)p, (int)n, (int)((p + 63) / 64),
          (int)((n + 63) / 64)};
  const size_t smem = smem_floats(dm) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)h, (unsigned)BC);
  ssd_chunk_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dA, (const float*)dt, (const float*)B,
      (const float*)C, (float*)y, (float*)st, dm);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
