// Causal (optionally sliding-window) flash attention for Hopper (sm_90a).
// Replaces the Pallas kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention (body
// _flash_kernel).
//
// q, k, v, o are row-major (B*H, S, D), float32 or bf16. Query i attends
// to keys j <= i (and j > i - window when window > 0) with scores
// (q_i . k_j) / sqrt(D); masked scores are -1e30, the softmax is online in
// float32 (running max m, normaliser l, accumulator acc) and the output is
// acc / max(l, 1e-30) in the input type — the TPU kernel's arithmetic.
// When lse is not null it also gets each row's float32 logsumexp m + log l
// (B*H, S), which the backward kernel (flash_attention_bwd.cu) recomputes
// the probabilities from; serving passes null.
//
// Design: on the TPU the KV axis is the innermost grid axis and m, l, acc
// live in VMEM scratch across grid steps. Here one block of 256 threads
// owns (one batch x head, one 64-query tile) and loops over 64-key tiles
// itself, so m, l and acc stay in registers for the whole row: each thread
// holds 4 query rows x 4 key columns of the score tile and 4 rows x D/16
// output columns. Key tiles above the causal diagonal and tiles wholly
// outside the window are never visited; the heaviest query tiles (the last
// ones) are scheduled first. Q (transposed), each K tile (transposed) and
// V tile, and the tile's probabilities sit in shared memory as float32;
// the row max and sum are reduced over the 16 threads of a row with warp
// shuffles. Any S: rows past S are computed but not stored and keys past S
// load as zeros, which causality keeps away from every real query.
//
// What bounds it: operations. It does 4 D flops per visible (query, key)
// pair on CUDA cores in float32 (mma.sync / wgmma on the tensor cores is
// later work); device memory sees q, k, v and o about once per query tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kLDK = kBK + 4;        // padded row of the transposed K tile
constexpr int kThreads = 256;        // 16 x 16: rows ty*4.., columns tx*4..
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// reduce over the 16 threads that share a row (one half-warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(D * kBQ + D * kLDK + kBK * D + kBQ * kBK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int64_t S, int window,
                       float scale) {
  constexpr int NC = D / 64;         // 64-column groups of the output
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][kBQ]
  float* Kt = Qt + D * kBQ;                      // [D][kLDK]
  float* Vs = Kt + D * kLDK;                     // [kBK][D]
  float* Ps = Vs + kBK * D;                      // [kBQ][kBK]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qb = q + bh * S * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int64_t row = q0 + r;
    Qt[d * kBQ + r] = row < S ? to_f(qb[row * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a key visible to some query of this tile
  const int64_t last_q = q0 + kBQ - 1;
  const int64_t last_k = last_q < S - 1 ? last_q : S - 1;
  const int64_t kt_end = (last_k + kBK) / kBK;
  int64_t kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;

  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();                 // the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int64_t row = k0 + r;
      const bool in = row < S;
      Kt[d * kLDK + r] = in ? to_f(kb[row * D + d]) : 0.f;
      Vs[r * D + d] = in ? to_f(vb[row * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kBQ + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[d * kLDK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k0 + tx * 4 + j;
        bool ok = kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mt));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * kBK + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * kBK + kk]);
        pv[i][0] = p4.x; pv[i][1] = p4.y; pv[i][2] = p4.z; pv[i][3] = p4.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              &Vs[(kk + u) * D + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g * 4 + 0] = fmaf(pv[i][u], w.x, acc[i][g * 4 + 0]);
            acc[i][g * 4 + 1] = fmaf(pv[i][u], w.y, acc[i][g * 4 + 1]);
            acc[i][g * 4 + 2] = fmaf(pv[i][u], w.z, acc[i][g * 4 + 2]);
            acc[i][g * 4 + 3] = fmaf(pv[i][u], w.w, acc[i][g * 4 + 3]);
          }
        }
      }
    }
  }

  T* ob = o + bh * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[bh * S + row] = m[i] + logf(l[i]);
#pragma unroll
    for (int g = 0; g < NC; ++g)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        from_f(&ob[row * D + g * 64 + tx * 4 + u], acc[i][g * 4 + u] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int64_t BH, int64_t S, int window,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + kBQ - 1) / kBQ), (unsigned)BH);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, S, window,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bf16. window <= 0: no window. lse: null, or
// float32 (B*H, S) for the rows' logsumexp.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int64_t BH,
                                      int64_t S, int64_t D, int64_t window,
                                      int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  if (BH > 65535 || (S + kBQ - 1) / kBQ > 2147483647LL ||
      window > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ls = (float*)lse;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, ls, BH, S, w, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
