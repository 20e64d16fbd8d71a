// Causal (optionally sliding-window) flash attention for Hopper (sm_90a).
// Replaces the Pallas kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention (body
// _flash_kernel).
//
// q, k, v, o are row-major (B*H, S, D), float32 or bf16. Query i attends
// to keys j <= i (and j > i - window when window > 0) with scores
// (q_i . k_j) / sqrt(D); the softmax is online in float32 (running max m,
// normaliser l, accumulator acc) and the output is acc / l in the input
// type — the TPU kernel's arithmetic. When lse is not null it also gets
// each row's float32 logsumexp m + log l in the natural log (B*H, S),
// which the backward kernels (flash_attention_bwd.cu) recompute the
// probabilities from; serving passes null.
//
// bf16, on the tensor cores (flash_attention_tc): one block of two
// consumer warpgroups and one producer warp owns (one batch x head, one
// 128-query tile), 64 query rows per warpgroup; on the TPU the KV axis is
// the innermost grid axis with m, l, acc in VMEM scratch, here the block
// loops over key tiles itself (128 keys at D = 64, 64 at D = 128 and 160,
// where the accumulators need the registers) and m, l, acc stay in
// registers. D = 160 fills whole 64-column blocks (hopper.cuh): TMA
// zero-fills columns 160-191, Q K^T steps over the 160 real columns, and
// P V is one wgmma at N = 192 whose 16 padded accumulator registers a
// thread (96 in all, against 64 at D = 128) are never stored.
// The producer loads Q once and streams K and V through a two-stage ring
// in shared memory with TMA (hopper.cuh's layout: 128-byte swizzle, rows
// past S as zeros), completing on mbarriers, so the next tile loads while
// this one is multiplied. S = Q K^T is wgmma m64nBKk16 with both operands
// K-major in shared memory; the softmax runs in base 2 (log2 e folded into
// the scale) on the accumulator, its row max and sum taken over the four
// threads of a quad; O += P V is wgmma with P from registers (the
// accumulator pairs packed to bf16x2, which is the A-fragment layout) and
// V MN-major through the transpose bit. Only tiles that cross the diagonal
// or the window's edge are masked; tiles above the diagonal or wholly
// outside the window are never loaded, or skipped by the warpgroup they do
// not reach. Query tiles run heaviest first, a head's tiles adjacent in
// launch order so its K and V are reused from L2. O is written in bf16
// from registers; the logsumexp is converted to the natural log at the
// store.
//
// float32, on CUDA cores (flash_attention_kernel): one block of 256
// threads per (batch x head, 64-query tile) loops over 64-key tiles;
// each thread holds 4 query rows x 4 key columns of the score tile and
// 4 rows x D/16 output columns (4 in each 64-column group and, at D = 160,
// 2 of the last 32 columns), and Q, K (transposed), V and the tile's
// probabilities sit in shared memory as float32 (141,824 bytes at 160).
// TF32 would miss the float32 tolerance; float32 runs only in the port's
// parity tests.
//
// What bounds it: operations, 4 D flops per visible (query, key) pair at
// the bf16 tensor-core rate (device memory sees q, k, v and o about once
// per query tile, 4 S D bytes against 2 S^2 D flops per head).
#include "hopper.cuh"
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

// the CUDA-core kernels below are instantiated for float32 only
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }

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
  constexpr int TAIL = D % 64 / 16;  // columns a thread owns past them
  constexpr int NA = 4 * NC + TAIL;
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

  float m[4], l[4], acc[4][NA];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = 0.f;
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
      for (int c = 0; c < NA; ++c) acc[i][c] *= alpha;
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
        const float* wt = &Vs[(kk + u) * D + NC * 64 + tx * TAIL];
#pragma unroll
        for (int c = 0; c < TAIL; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][4 * NC + c] = fmaf(pv[i][u], wt[c], acc[i][4 * NC + c]);
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
#pragma unroll
    for (int c = 0; c < TAIL; ++c)
      from_f(&ob[row * D + NC * 64 + tx * TAIL + c], acc[i][4 * NC + c] * inv);
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

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kTcThreads = 2 * kWG + 32;   // two consumers, one producer warp
constexpr int kTcBQ = 128;           // query rows per block (64 per consumer)
constexpr int kStages = 2;           // K / V ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct TcFwd {
  static constexpr int DP = hopper::padded_cols(D);   // columns in smem
  static constexpr int BK = D == 64 ? 128 : 64;   // keys per tile
  static constexpr int Q_BYTES = kTcBQ * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;    // one K or V tile
  static constexpr int TILES = Q_BYTES + 2 * kStages * KV_BYTES;
  // tiles, then full[kStages], empty[kStages] and the Q barrier, and
  // 1024 bytes to align the tiles for the swizzle
  static constexpr size_t SMEM = TILES + 8 * (2 * kStages + 1) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int S, int window, float scale_log2) {
  using C = TcFwd<D>;
  constexpr int BK = C::BK, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  uint8_t* sQ = base;
  uint8_t* sKV = base + C::Q_BYTES;         // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(base + C::TILES);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;   // heaviest first
  const int last_q = min(q0 + kTcBQ - 1, S - 1);
  const int kt_end = last_q / BK + 1;
  const int kt_begin =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / BK : 0;
  const int ntiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * kWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {                             // the producer warp
    if (threadIdx.x == 2 * kWG) {
      hopper::mbar_expect_tx(qbar, C::Q_BYTES);
      hopper::tma_tile<D>(sQ, kTcBQ, kTcBQ, &tq, qbar, q0, bh);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages;
        if (i >= kStages) hopper::mbar_wait(&empty[st], (i / kStages - 1) & 1);
        hopper::mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        const int k0 = (kt_begin + i) * BK;
        uint8_t* sK = sKV + st * 2 * C::KV_BYTES;
        hopper::tma_tile<D>(sK, BK, BK, &tk, &full[st], k0, bh);
        hopper::tma_tile<D>(sK + C::KV_BYTES, BK, BK, &tv, &full[st], k0, bh);
      }
    }
    return;
  }

  // a consumer warpgroup: rows qlo .. qlo + 63 of the block's tile
  const int t = threadIdx.x % kWG, lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;     // and row0 + 8
  const int qlo = q0 + 64 * wg, qhi = qlo + 63;
  const int qr[2] = {qlo + row0, qlo + row0 + 8};
  const uint32_t uQ = hopper::smem_u32(sQ);

  float acc[DP / 2];                 // D's columns, then the padding's
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  hopper::mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % kStages;
    const int k0 = (kt_begin + i) * BK;
    const bool reached = k0 <= qhi && (window <= 0 || k0 + BK - 1 > qlo - window);
    hopper::mbar_wait(&full[st], (i / kStages) & 1);
    if (reached) {
      const uint32_t uK = hopper::smem_u32(sKV + st * 2 * C::KV_BYTES);
      const uint32_t uV = uK + C::KV_BYTES;
      float s[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BK>(s, hopper::desc_kmajor(uQ, kTcBQ, 64 * wg, kk),
                             hopper::desc_kmajor(uK, BK, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);

      // every pair of the tile visible to every row: no mask work
      const bool open = k0 + BK - 1 <= qlo &&
                        (window <= 0 || k0 > qhi - window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int h = (j >> 1) & 1;
        float x = s[j] * scale_log2;
        if (!open) {
          const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const bool ok = kp <= qr[h] && (window <= 0 || kp > qr[h] - window);
          x = ok ? x : -INFINITY;
        }
        s[j] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float mn = fmaxf(m[h], mx[h]);
        alpha[h] = exp2f(m[h] - mn);
        m[h] = mn;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int h = (j >> 1) & 1;
        s[j] = exp2f(s[j] - m[h]);
        l[h] += s[j];
      }
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_rs<DP>(acc, p[kk], hopper::desc_mnmajor(uV, BK, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(acc);
    }
    hopper::mbar_arrive(&empty[st]);
  }

  // the row sums are spread over the quad
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  __nv_bfloat16* ob = o + (int64_t)bh * S * D;
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {     // the real columns only
    const int h = (j >> 1) & 1;
    if (qr[h] >= S) continue;
    const int col = 8 * (j >> 2) + 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(&ob[(int64_t)qr[h] * D + col]) =
        __floats2bfloat162_rn(acc[j] * inv[h], acc[j + 1] * inv[h]);
  }
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (qr[h] < S)
        lse[(int64_t)bh * S + qr[h]] = (m[h] + log2f(l[h])) * kLn2;
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int64_t BH, int64_t S, int window,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hopper::make_tile_map(&mq, q, BH, S, D) ||
      !hopper::make_tile_map(&mk, k, BH, S, D) ||
      !hopper::make_tile_map(&mv, v, BH, S, D))
    return cudaErrorInvalidValue;
  const size_t smem = TcFwd<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + kTcBQ - 1) / kTcBQ), (unsigned)BH);
  flash_attention_tc<D><<<grid, kTcThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, (int)S, window,
      kLog2e / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bf16 (tensor cores; q, k, v 16-byte
// aligned). D in {64, 128, 160}. window <= 0: no window. lse: null, or
// float32 (B*H, S) for the rows' logsumexp.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int64_t BH,
                                      int64_t S, int64_t D, int64_t window,
                                      int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  if (BH > 65535 || S > 2147483647LL - kTcBQ || window > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ls = (float*)lse;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 1 && D == 64)
    return (int)launch_tc<64>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 1 && D == 128)
    return (int)launch_tc<128>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 0 && D == 160)
    return (int)launch<float, 160>(q, k, v, o, ls, BH, S, w, st);
  if (dtype == 1 && D == 160)
    return (int)launch_tc<160>(q, k, v, o, ls, BH, S, w, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
