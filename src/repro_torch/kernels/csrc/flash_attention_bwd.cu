// Backward of causal (optionally sliding-window) flash attention for Hopper
// (sm_90a): the gradient of flash_attention.cu. The TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention has no
// backward kernel (the JAX model differentiates plain jnp); the port's
// forward runs the CUDA kernel, so its gradient is a kernel too.
//
// q, k, v, o, do, dq, dk, dv are row-major (B*H, S, D), float32 or bf16;
// lse is the forward's float32 logsumexp per row (B*H, S). With
// s_ij = (q_i . k_j) / sqrt(D) and the forward's mask (j <= i, and
// j > i - window when window > 0):
//   P_ij  = exp(s_ij - lse_i)              (recomputed, never stored)
//   D_i   = do_i . o_i
//   dS_ij = P_ij (do_i . v_j - D_i)
//   dv_j  = sum_i P_ij do_i,  dk_j = sum_i dS_ij q_i / sqrt(D),
//   dq_i  = sum_j dS_ij k_j / sqrt(D),
// accumulated in float32 and written in the input type.
//
// Design: three kernels on one stream, no atomics, so the result does not
// depend on the order blocks run in. (1) One warp per row forms D_i.
// (2) One block of 256 threads per (batch x head, 64-key tile) loops over
// the 64-query tiles that can see its keys (from the diagonal to the end of
// the window) and keeps dk, dv for its 64 keys in registers. (3) One block
// per (batch x head, 64-query tile) loops over the key tiles its queries
// see, as the forward does, and keeps dq in registers. Each thread of a
// block holds 4 rows x 4 columns of the 64 x 64 score tile (rows ty + 16 r,
// columns tx + 16 u, so neighbouring threads read neighbouring shared-memory
// words) and 4 rows x D/16 columns of its output. Tiles sit in shared
// memory as float32 with rows padded to D + 1 words. Any S: rows past S
// load as zeros, their probabilities are masked to 0 and they are not
// stored.
//
// What bounds it: operations. Per visible (query, key) pair it does 7
// products of length D (s and do.v twice, once per pass, then dv, dk, dq)
// on CUDA cores in float32; mma.sync / wgmma is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;               // rows per tile (queries and keys)
constexpr int kLDP = kB + 1;         // padded row of the P / dS tiles
constexpr int kThreads = 256;        // 16 x 16 threads: ty, tx

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(4 * kB * (D + 1) + 2 * kB * kLDP + 2 * kB);
}

// stage rows [r0, r0 + kB) of a (S, D) matrix as float32 [kB][D + 1]
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t r0, int64_t S) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int64_t row = r0 + r;
    dst[r * (D + 1) + d] = row < S ? to_f(src[row * D + d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int64_t qpos, int64_t kpos,
                                        int64_t S, int window) {
  bool ok = kpos <= qpos && qpos < S;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// s = q k^T and dp = do v^T over one (query tile, key tile) pair: thread
// (ty, tx) gets rows ty + 16 r, columns tx + 16 u
template <int D>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx, float s[4][4],
                                            float dp[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[r][u] = dp[r][u] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      qa[r] = Qs[(ty + 16 * r) * (D + 1) + d];
      oa[r] = dOs[(ty + 16 * r) * (D + 1) + d];
      kb[r] = Ks[(tx + 16 * r) * (D + 1) + d];
      vb[r] = Vs[(tx + 16 * r) * (D + 1) + d];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        s[r][u] = fmaf(qa[r], kb[u], s[r][u]);
        dp[r][u] = fmaf(oa[r], vb[u], dp[r][u]);
      }
  }
}

// P and dS of one tile pair into shared memory [query][key]
__device__ __forceinline__ void probs_and_grads(
    float s[4][4], float dp[4][4], const float* ls, const float* Ds,
    float* Ps, float* dSs, int64_t q0, int64_t k0, int64_t S, int window,
    float scale, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = tx + 16 * u;
      const float p = visible(q0 + i, k0 + j, S, window)
                          ? expf(s[r][u] * scale - ls[i]) : 0.f;
      if (Ps != nullptr) Ps[i * kLDP + j] = p;
      dSs[i * kLDP + j] = p * (dp[r][u] - Ds[i]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ Dsum, int64_t rows) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(o[row * D + d]), to_f(dout[row * D + d]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) Dsum[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ Dsum,
            T* __restrict__ dk, T* __restrict__ dv, int64_t S, int window,
            float scale) {
  constexpr int LD = D + 1;
  constexpr int NQ = D / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kB][LD]
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Ps = dOs + kB * LD;                     // [kB][kLDP]
  float* dSs = Ps + kB * kLDP;
  float* ls = dSs + kB * kLDP;                   // [kB]
  float* Ds = ls + kB;                           // [kB]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = blockIdx.y;
  const int64_t k0 = (int64_t)blockIdx.x * kB;   // longest loops first
  const int64_t off = bh * S * D;
  load_tile<T, D>(Ks, k + off, k0, S);
  load_tile<T, D>(Vs, v + off, k0, S);

  float adk[4][NQ], adv[4][NQ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NQ; ++c) adk[r][c] = adv[r][c] = 0.f;

  // query tiles holding a query that sees a key of this tile
  const int64_t nq = (S + kB - 1) / kB;
  int64_t it_end = nq;
  if (window > 0) {
    const int64_t last_q = k0 + kB - 1 + window - 1;
    if (last_q / kB + 1 < it_end) it_end = last_q / kB + 1;
  }
  for (int64_t it = k0 / kB; it < it_end; ++it) {
    const int64_t q0 = it * kB;
    __syncthreads();                 // the previous tiles are consumed
    load_tile<T, D>(Qs, q + off, q0, S);
    load_tile<T, D>(dOs, dout + off, q0, S);
    for (int r = tid; r < kB; r += kThreads) {
      const int64_t row = q0 + r;
      ls[r] = row < S ? lse[bh * S + row] : 0.f;
      Ds[r] = row < S ? Dsum[bh * S + row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs_and_grads(s, dp, ls, Ds, Ps, dSs, q0, k0, S, window, scale, ty,
                    tx);
    __syncthreads();

    // dv_j += P_ij do_i and dk_j += dS_ij q_i for keys j = ty + 16 r
#pragma unroll 2
    for (int i = 0; i < kB; ++i) {
      float pj[4], dsj[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pj[r] = Ps[i * kLDP + ty + 16 * r];
        dsj[r] = dSs[i * kLDP + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const float o = dOs[i * LD + tx + 16 * c];
        const float qq = Qs[i * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          adv[r][c] = fmaf(pj[r], o, adv[r][c]);
          adk[r][c] = fmaf(dsj[r], qq, adk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = k0 + ty + 16 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      from_f(&dk[off + row * D + tx + 16 * c], adk[r][c] * scale);
      from_f(&dv[off + row * D + tx + 16 * c], adv[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ Dsum,
          T* __restrict__ dq, int64_t S, int window, float scale) {
  constexpr int LD = D + 1;
  constexpr int NQ = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [kB][LD]
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* dSs = dOs + kB * LD;                    // [kB][kLDP]
  float* ls = dSs + 2 * kB * kLDP;               // after the unused P tile
  float* Ds = ls + kB;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kB;
  const int64_t off = bh * S * D;
  load_tile<T, D>(Qs, q + off, q0, S);
  load_tile<T, D>(dOs, dout + off, q0, S);
  for (int r = tid; r < kB; r += kThreads) {
    const int64_t row = q0 + r;
    ls[r] = row < S ? lse[bh * S + row] : 0.f;
    Ds[r] = row < S ? Dsum[bh * S + row] : 0.f;
  }

  float adq[4][NQ];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NQ; ++c) adq[r][c] = 0.f;

  // key tiles that hold a key visible to some query of this tile
  const int64_t last_q = q0 + kB - 1;
  const int64_t last_k = last_q < S - 1 ? last_q : S - 1;
  const int64_t kt_end = (last_k + kB) / kB;
  int64_t kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kB;
  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * kB;
    __syncthreads();
    load_tile<T, D>(Ks, k + off, k0, S);
    load_tile<T, D>(Vs, v + off, k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tiles<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
    probs_and_grads(s, dp, ls, Ds, nullptr, dSs, q0, k0, S, window, scale,
                    ty, tx);
    __syncthreads();

    // dq_i += dS_ij k_j for queries i = ty + 16 r
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float dsi[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsi[r] = dSs[(ty + 16 * r) * kLDP + j];
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const float kk = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) adq[r][c] = fmaf(dsi[r], kk, adq[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = q0 + ty + 16 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c)
      from_f(&dq[off + row * D + tx + 16 * c], adq[r][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* Dsum, void* dq, void* dk, void* dv, int64_t BH,
                   int64_t S, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = BH * S;
  const int64_t row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  rowdot_kernel<T, D><<<(unsigned)row_blocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, Dsum, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)D);
  const dim3 grid((unsigned)((S + kB - 1) / kB), (unsigned)BH);
  dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dsum,
      (T*)dk, (T*)dv, S, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dsum,
      (T*)dq, S, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bf16. window <= 0: no window. Dsum: float32
// scratch of B*H*S values.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* Dsum, void* dq, void* dk,
    void* dv, int64_t BH, int64_t S, int64_t D, int64_t window, int dtype,
    void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  if (BH > 65535 || (S + kB - 1) / kB > 2147483647LL ||
      window > 2147483647LL || BH * S / (kThreads / 32) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ls = (const float*)lse;
  float* Ds = (float*)Dsum;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                  S, w, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                   S, w, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, dout, ls, Ds, dq, dk,
                                          dv, BH, S, w, st);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, dout, ls, Ds, dq, dk,
                                           dv, BH, S, w, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
