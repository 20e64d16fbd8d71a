// Backward of causal (optionally sliding-window) flash attention for Hopper
// (sm_90a): the gradient of flash_attention.cu. The TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention has no
// backward kernel (the JAX model differentiates plain jnp); the port's
// forward runs the CUDA kernel, so its gradient is a kernel too.
//
// q, k, v, o, do, dq, dk, dv are row-major (B*H, S, D), float32 or bf16,
// any D from 1 to 256 (bf16: a multiple of 8, which the wrapper's
// zero-padded copy gives); lse is the forward's float32 logsumexp per row
// (B*H, S), natural log. With s_ij = (q_i . k_j) / sqrt(head_dim) (the
// model's head dim: D, or less where the rows were padded with zeros) and
// the forward's mask (j <= i, and j > i - window when window > 0):
//   P_ij  = exp(s_ij - lse_i)              (recomputed, never stored)
//   D_i   = do_i . o_i
//   dS_ij = P_ij (do_i . v_j - D_i)
//   dv_j  = sum_i P_ij do_i,  dk_j = sum_i dS_ij q_i / sqrt(head_dim),
//   dq_i  = sum_j dS_ij k_j / sqrt(head_dim),
// accumulated in float32 and written in the input type.
//
// Three kernels on one stream and no atomics, so the result does not
// depend on the order blocks run in: (1) one warp per row forms D_i (in
// bf16 beside lse_i log2 e, in rows padded to whole 64-row tiles);
// (2) one block per (batch x head, key tile) loops over the query tiles
// that see its keys and keeps dk, dv in registers; (3) one block per
// (batch x head, query tile) loops over the key tiles its queries see and
// keeps dq in registers. Each pass recomputes s and do . v, so the kernels
// do 14 D flops per visible pair where 10 D would do with dq summed across
// blocks by atomics: at (8, 32, 2048, 64) causal that is 481 GFLOP against
// 344, a floor of 0.49 ms at the bf16 tensor-core rate. B*H goes on grid y
// in launches of at most 65,535, each with its first matrix passed in.
//
// The kernels are templated on the width W = padded_cols(D) in {64, 128,
// 192, 256}; D comes at run time. Columns past D are zeros in shared
// memory, so they add exact zeros to the products over D, and no store
// writes a column past D.
//
// bf16, on the tensor cores (dkdv_tc, dq_tc): two consumer warpgroups of
// 64 rows each and one producer warp per block. The producer loads the
// block's own 128-row tiles once (K and V, or Q and dO) and streams the
// other side's 64-row tiles through a ring with TMA and mbarriers
// (hopper.cuh's layout, rows past S and columns past D as zeros); in the
// dk/dv pass each tile brings its 64 entries of lse log2 e and D by bulk
// copy (read from device memory per element, they took half the pass's
// time). There S^T = K Q^T and dP^T = V dO^T are wgmma with both operands
// K-major in shared memory, ceil(D / 16) k-steps; P^T = exp2(S^T scale
// log2 e - lse log2 e) and dS^T = P^T (dP^T - D) are formed on the
// accumulators, packed to bf16 as A fragments in registers, and dV += P^T
// dO, dK += dS^T Q are wgmma with dO and Q MN-major through the transpose
// bit. The dq pass forms S and dP as the forward does and dQ += dS K with K
// MN-major. Only tiles that cross the diagonal, the window's edge or S are
// masked; tiles a warpgroup's rows never see are skipped. The tensor cores
// take bf16 operands, so P and dS are rounded to bf16 before their
// products.
//
// Past W = 64 the dk/dv pass runs as two launches of one kernel: one
// accumulates dV (S, P^T), the other dK (S, dP, dS^T); each recomputes S,
// the second dP. That is 10 D flops per visible pair in the dk/dv passes
// against 8 D at W = 64 (16 D in all with the dq pass, against 14 D), and
// it is faster: dK and dV together (2 x W / 2 accumulator registers a
// thread) beside the S, dP tiles (64) and their bf16 fragments (32) pass
// the 168 registers ptxas gives a thread of a 288-thread block. At W = 128
// the one launch spilled 1,060 bytes (3,232 with D at run time) and ptxas
// serialized its wgmmas; split, it spills nothing and the backward at D =
// 128 takes 0.17-0.18 ms in place of 0.23-0.24 at (4, 24, 512, 128)
// (PERF.md). W = 192 (D = 160 and every D in (128, 192]): the products
// whose N is the gradient's columns (dV, dK, dQ) are one wgmma at N = 192,
// 96 accumulator registers a thread, the padding never stored. W = 256:
// even one gradient's 128 accumulators would not fit beside S, so every
// pass runs two blocks per tile (grid z), each accumulating 128 of the
// gradient columns from the same columns of the streamed (or own) tile,
// and each recomputing S and dP over all of D (26 D flops per visible
// pair in all). Its 128-row own tiles of 256 columns take 128 KB, so the
// ring has one stage (another 64 KB).
//
// The head dims of the registered configurations (64, 128, 160) run
// instantiations with D fixed at compile time; every other D runs its
// width's run-time instantiation, whose products over D take all W / 16
// k-steps (see k_steps): at D = 160 that would be 12 in place of 10.
//
// float32, on CUDA cores (dkdv_kernel, dq_kernel): 256 threads per
// KB-row tile (KB = 64, and 32 at W = 256, where four 64-row tiles would
// not fit in shared memory), each holding KB/16 rows x KB/16 columns of
// the KB x KB score tile (rows ty + 16 r, columns tx + 16 u) and KB/16
// rows x W/16 columns of its output; tiles sit in shared memory as
// float32, rows padded to W + 1 words (231,424 bytes a block at W = 192,
// 140,288 at W = 256). TF32 would miss the float32 tolerance. bf16 at D <
// 8 runs these kernels too, loading and storing bf16 (as the forward: the
// tensor cores' bf16 rounding of P and dS, not averaged over D, would
// exceed the per-row limit there).
//
// What bounds it: operations, 10 D flops per visible pair (q k^T, do v^T,
// dv, dk, dq) at the bf16 tensor-core rate.
#include "hopper.cuh"
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16 threads: ty, tx
constexpr int64_t kMaxGridY = 65535; // matrices per launch

// rows of a float32 tile at width W
template <int W>
constexpr int f32_rows() { return W <= 192 ? 64 : 32; }

// the CUDA-core kernels below read and write float32, or bf16 below D = 8
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int W, int KB>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(4 * KB * (W + 1) + 2 * KB * (KB + 1) + 2 * KB);
}

// stage rows [r0, r0 + KB) of a (S, D) matrix as float32 [KB][W + 1],
// zeros past S and past D
template <typename T, int W, int KB>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t r0, int64_t S, int D) {
  for (int e = threadIdx.x; e < KB * W; e += kThreads) {
    const int r = e / W, d = e % W;
    const int64_t row = r0 + r;
    dst[r * (W + 1) + d] = row < S && d < D ? to_f(src[row * D + d]) : 0.f;
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
template <int W, int KB>
__device__ __forceinline__ void score_tiles(const float* Qs, const float* dOs,
                                            const float* Ks, const float* Vs,
                                            int ty, int tx,
                                            float s[KB / 16][KB / 16],
                                            float dp[KB / 16][KB / 16],
                                            int D) {
  constexpr int R = KB / 16;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int u = 0; u < R; ++u) s[r][u] = dp[r][u] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qa[R], oa[R], kb[R], vb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qa[r] = Qs[(ty + 16 * r) * (W + 1) + d];
      oa[r] = dOs[(ty + 16 * r) * (W + 1) + d];
      kb[r] = Ks[(tx + 16 * r) * (W + 1) + d];
      vb[r] = Vs[(tx + 16 * r) * (W + 1) + d];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < R; ++u) {
        s[r][u] = fmaf(qa[r], kb[u], s[r][u]);
        dp[r][u] = fmaf(oa[r], vb[u], dp[r][u]);
      }
  }
}

// P and dS of one tile pair into shared memory [query][key]
template <int KB>
__device__ __forceinline__ void probs_and_grads(
    float s[KB / 16][KB / 16], float dp[KB / 16][KB / 16], const float* ls,
    const float* Ds, float* Ps, float* dSs, int64_t q0, int64_t k0,
    int64_t S, int window, float scale, int ty, int tx) {
  constexpr int R = KB / 16, LDP = KB + 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ty + 16 * r;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int j = tx + 16 * u;
      const float p = visible(q0 + i, k0 + j, S, window)
                          ? expf(s[r][u] * scale - ls[i]) : 0.f;
      if (Ps != nullptr) Ps[i * LDP + j] = p;
      dSs[i * LDP + j] = p * (dp[r][u] - Ds[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ Dsum, int64_t rows, int D) {
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

template <typename T, int W, int KB>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ Dsum,
            T* __restrict__ dk, T* __restrict__ dv, int64_t S, int D,
            int window, float scale, int64_t bh0) {
  constexpr int LD = W + 1, LDP = KB + 1;
  constexpr int R = KB / 16;         // score rows (and columns) per thread
  constexpr int NQ = W / 16;         // output columns per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [KB][LD]
  float* Vs = Ks + KB * LD;
  float* Qs = Vs + KB * LD;
  float* dOs = Qs + KB * LD;
  float* Ps = dOs + KB * LD;                     // [KB][LDP]
  float* dSs = Ps + KB * LDP;
  float* ls = dSs + KB * LDP;                    // [KB]
  float* Ds = ls + KB;                           // [KB]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t k0 = (int64_t)blockIdx.x * KB;   // longest loops first
  const int64_t off = bh * S * D;
  load_tile<T, W, KB>(Ks, k + off, k0, S, D);
  load_tile<T, W, KB>(Vs, v + off, k0, S, D);

  float adk[R][NQ], adv[R][NQ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NQ; ++c) adk[r][c] = adv[r][c] = 0.f;

  // query tiles holding a query that sees a key of this tile
  const int64_t nq = (S + KB - 1) / KB;
  int64_t it_end = nq;
  if (window > 0) {
    const int64_t last_q = k0 + KB - 1 + window - 1;
    if (last_q / KB + 1 < it_end) it_end = last_q / KB + 1;
  }
  for (int64_t it = k0 / KB; it < it_end; ++it) {
    const int64_t q0 = it * KB;
    __syncthreads();                 // the previous tiles are consumed
    load_tile<T, W, KB>(Qs, q + off, q0, S, D);
    load_tile<T, W, KB>(dOs, dout + off, q0, S, D);
    for (int r = tid; r < KB; r += kThreads) {
      const int64_t row = q0 + r;
      ls[r] = row < S ? lse[bh * S + row] : 0.f;
      Ds[r] = row < S ? Dsum[bh * S + row] : 0.f;
    }
    __syncthreads();

    float s[R][R], dp[R][R];
    score_tiles<W, KB>(Qs, dOs, Ks, Vs, ty, tx, s, dp, D);
    probs_and_grads<KB>(s, dp, ls, Ds, Ps, dSs, q0, k0, S, window, scale,
                        ty, tx);
    __syncthreads();

    // dv_j += P_ij do_i and dk_j += dS_ij q_i for keys j = ty + 16 r
#pragma unroll 2
    for (int i = 0; i < KB; ++i) {
      float pj[R], dsj[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pj[r] = Ps[i * LDP + ty + 16 * r];
        dsj[r] = dSs[i * LDP + ty + 16 * r];
      }
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const float o = dOs[i * LD + tx + 16 * c];
        const float qq = Qs[i * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          adv[r][c] = fmaf(pj[r], o, adv[r][c]);
          adk[r][c] = fmaf(dsj[r], qq, adk[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = k0 + ty + 16 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int col = tx + 16 * c;
      if (col >= D) continue;
      from_f(&dk[off + row * D + col], adk[r][c] * scale);
      from_f(&dv[off + row * D + col], adv[r][c]);
    }
  }
}

template <typename T, int W, int KB>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ Dsum,
          T* __restrict__ dq, int64_t S, int D, int window, float scale,
          int64_t bh0) {
  constexpr int LD = W + 1, LDP = KB + 1;
  constexpr int R = KB / 16;
  constexpr int NQ = W / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [KB][LD]
  float* Vs = Ks + KB * LD;
  float* Qs = Vs + KB * LD;
  float* dOs = Qs + KB * LD;
  float* dSs = dOs + KB * LD;                    // [KB][LDP]
  float* ls = dSs + 2 * KB * LDP;                // after the unused P tile
  float* Ds = ls + KB;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t bh = bh0 + blockIdx.y;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * KB;
  const int64_t off = bh * S * D;
  load_tile<T, W, KB>(Qs, q + off, q0, S, D);
  load_tile<T, W, KB>(dOs, dout + off, q0, S, D);
  for (int r = tid; r < KB; r += kThreads) {
    const int64_t row = q0 + r;
    ls[r] = row < S ? lse[bh * S + row] : 0.f;
    Ds[r] = row < S ? Dsum[bh * S + row] : 0.f;
  }

  float adq[R][NQ];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < NQ; ++c) adq[r][c] = 0.f;

  // key tiles that hold a key visible to some query of this tile
  const int64_t last_q = q0 + KB - 1;
  const int64_t last_k = last_q < S - 1 ? last_q : S - 1;
  const int64_t kt_end = (last_k + KB) / KB;
  int64_t kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / KB;
  for (int64_t kt = kt_begin; kt < kt_end; ++kt) {
    const int64_t k0 = kt * KB;
    __syncthreads();
    load_tile<T, W, KB>(Ks, k + off, k0, S, D);
    load_tile<T, W, KB>(Vs, v + off, k0, S, D);
    __syncthreads();

    float s[R][R], dp[R][R];
    score_tiles<W, KB>(Qs, dOs, Ks, Vs, ty, tx, s, dp, D);
    probs_and_grads<KB>(s, dp, ls, Ds, nullptr, dSs, q0, k0, S, window,
                        scale, ty, tx);
    __syncthreads();

    // dq_i += dS_ij k_j for queries i = ty + 16 r
#pragma unroll 2
    for (int j = 0; j < KB; ++j) {
      float dsi[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dsi[r] = dSs[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const float kk = Ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < R; ++r) adq[r][c] = fmaf(dsi[r], kk, adq[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = q0 + ty + 16 * r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      const int col = tx + 16 * c;
      if (col < D) from_f(&dq[off + row * D + col], adq[r][c] * scale);
    }
  }
}

template <typename T, int W>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* Dsum, void* dq, void* dk, void* dv, int64_t BH,
                   int64_t S, int D, float scale, int window,
                   cudaStream_t stream) {
  constexpr int KB = f32_rows<W>();
  const size_t smem = smem_bytes<W, KB>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, W, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, W, KB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = BH * S;
  const int64_t row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  rowdot_kernel<T><<<(unsigned)row_blocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, Dsum, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int64_t b0 = 0; b0 < BH; b0 += kMaxGridY) {
    const int64_t n = BH - b0 < kMaxGridY ? BH - b0 : kMaxGridY;
    const dim3 grid((unsigned)((S + KB - 1) / KB), (unsigned)n);
    dkdv_kernel<T, W, KB><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dsum,
        (T*)dk, (T*)dv, S, D, window, scale, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_kernel<T, W, KB><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, Dsum,
        (T*)dq, S, D, window, scale, b0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kTcThreads = 2 * kWG + 32;   // two consumers, one producer warp
constexpr int kOwn = 128;            // the block's own rows (64 per consumer)
constexpr int kStream = 64;          // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;

// rows of the bf16 backward's row vectors: S padded to whole 64-row tiles,
// so each streamed tile's 64 entries start 16-byte aligned for the bulk
// copy
__host__ __device__ __forceinline__ int64_t vec_stride(int64_t S) {
  return (S + kStream - 1) / kStream * kStream;
}

constexpr int kVecBytes = 2 * kStream * 4;   // a stage's two row vectors

template <int W>
struct TcBwd {
  static constexpr int NV = W <= 192 ? W : 128;   // gradient columns a block
  static constexpr int SPLIT = W / NV;            // blocks a tile
  static constexpr int STAGES = W <= 192 ? 2 : 1; // ring depth
  static constexpr int OWN_BYTES = kOwn * W * 2;        // one own tile
  static constexpr int STREAM_BYTES = kStream * W * 2;  // one streamed tile
  static constexpr int TILES = 2 * OWN_BYTES + 2 * STAGES * STREAM_BYTES;
  static constexpr int VECS = STAGES * kVecBytes;
  static constexpr size_t SMEM = TILES + VECS + 8 * (2 * STAGES + 1) + 1024;
};

// the block's shared memory: two own tiles, the ring, the ring's row
// vectors, the barriers
struct TcSmem {
  uint8_t* own;                      // own tile 0, then own tile 1
  uint8_t* ring;                     // stage s: streamed tile 0, then 1
  float* vec;                        // stage s: lse log2 e, then D
  uint64_t* full;
  uint64_t* empty;
  uint64_t* ownbar;
};

template <int W>
__device__ __forceinline__ TcSmem tc_smem(uint8_t* raw) {
  using C = TcBwd<W>;
  uint8_t* base = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
  TcSmem m;
  m.own = base;
  m.ring = base + 2 * C::OWN_BYTES;
  m.vec = reinterpret_cast<float*>(base + C::TILES);
  m.full = reinterpret_cast<uint64_t*>(base + C::TILES + C::VECS);
  m.empty = m.full + C::STAGES;
  m.ownbar = m.empty + C::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&m.full[s], 1);
      hopper::mbar_init(&m.empty[s], 2 * kWG);
    }
    hopper::mbar_init(m.ownbar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return m;
}

// the producer: the block's own 128 rows of a and b from row r0, then
// 64-row tiles of c and d from rows (t0 + i) * 64 for ntiles tiles, and
// with them, when ``vecs`` is not null, the same 64 entries of its two
// row vectors (``vecs`` and ``vecs + plane``)
template <int W>
__device__ __forceinline__ void tc_produce(const TcSmem& m,
                                           const CUtensorMap* a,
                                           const CUtensorMap* b,
                                           const CUtensorMap* c,
                                           const CUtensorMap* d, int r0,
                                           int t0, int ntiles, int bh,
                                           const float* vecs,
                                           int64_t plane) {
  using C = TcBwd<W>;
  constexpr int NS = C::STAGES;
  const uint32_t vbytes = vecs != nullptr ? kVecBytes : 0;
  hopper::mbar_expect_tx(m.ownbar, 2 * C::OWN_BYTES);
  hopper::tma_tile<W>(m.own, kOwn, kOwn, a, m.ownbar, r0, bh);
  hopper::tma_tile<W>(m.own + C::OWN_BYTES, kOwn, kOwn, b, m.ownbar, r0, bh);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NS;
    if (i >= NS) hopper::mbar_wait(&m.empty[st], (i / NS - 1) & 1);
    hopper::mbar_expect_tx(&m.full[st], 2 * C::STREAM_BYTES + vbytes);
    uint8_t* tile = m.ring + st * 2 * C::STREAM_BYTES;
    const int row = (t0 + i) * kStream;
    if (vecs != nullptr) {
      float* v = m.vec + st * 2 * kStream;
      hopper::bulk_load(v, vecs + row, kStream * 4, &m.full[st]);
      hopper::bulk_load(v + kStream, vecs + plane + row, kStream * 4,
                        &m.full[st]);
    }
    hopper::tma_tile<W>(tile, kStream, kStream, c, &m.full[st], row, bh);
    hopper::tma_tile<W>(tile + C::STREAM_BYTES, kStream, kStream, d,
                        &m.full[st], row, bh);
  }
}

// the k-steps of a product over D: ceil(D / 16) where D is known at
// compile time; at run time all W / 16, the steps past D adding the zeros
// TMA loaded (a run-time bound in the wgmma sequence made ptxas spill 3x
// as much and ran the dK/dV pass 2x slower)
template <int W, int DC>
__device__ __forceinline__ int k_steps(int D) {
  return DC > 0 ? (D + 15) / 16 : W / 16;
}

// A = rows [64 wg, 64 wg + 64) of own tile ``ua`` and B = streamed tile
// ``ub``, both K-major over D: acc = A B^T (64 x 64) in nk k-steps (every
// column block but the last is all real columns)
template <int W>
__device__ __forceinline__ void tc_scores(float (&acc)[32], uint32_t ua,
                                          int wg, uint32_t ub, int nk) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    if (kk + 4 < W / 16 || kk < nk)
      hopper::wgmma_ss<64>(acc, hopper::desc_kmajor(ua, kOwn, 64 * wg, kk),
                           hopper::desc_kmajor(ub, kStream, 0, kk), kk > 0);
}

// the 64 x 64 tile's values packed as four k-steps of A fragments
__device__ __forceinline__ void tc_pack(const float (&x)[32],
                                        uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = hopper::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// the accumulator's columns col0 .. col0 + NV - 1 that lie before D to
// rows ``row`` of ``out`` (rows of D columns)
template <int NV>
__device__ __forceinline__ void tc_store(__nv_bfloat16* out,
                                         float (&acc)[NV / 2],
                                         const int (&row)[2], int S, int D,
                                         int col0, float mul, int lane) {
#pragma unroll
  for (int j = 0; j < NV / 2; j += 2) {
    const int h = (j >> 1) & 1;
    const int col = col0 + 8 * (j >> 2) + 2 * (lane & 3);
    if (row[h] >= S || col >= D) continue;
    *reinterpret_cast<__nv_bfloat162*>(&out[(int64_t)row[h] * D + col]) =
        __floats2bfloat162_rn(acc[j] * mul, acc[j + 1] * mul);
  }
}

// what one dkdv_tc launch accumulates: dK and dV (W = 64), or one of them
// (two launches: every wider W)
enum Grads { kDKDV = 0, kDV = 1, kDK = 2 };

// one block per (batch x head, 128-key tile, column slice): dk, dv (or one
// of them, as G says) over the 64-query tiles that see its keys; the score
// tiles' rows are keys, columns queries. ``plane`` is the offset of the D
// row vectors after the lse ones (B*H vec_stride(S)). DC > 0: D = DC at
// compile time; DC = 0: D = d
template <int W, int DC, int G>
__global__ void __launch_bounds__(kTcThreads, 1)
dkdv_tc(const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo,
        const float* __restrict__ vecs, __nv_bfloat16* __restrict__ dk,
        __nv_bfloat16* __restrict__ dv, int S, int d, int window,
        float scale, float scale_log2, int bh0, int64_t plane) {
  using C = TcBwd<W>;
  constexpr int NV = C::NV, NS = C::STAGES;
  constexpr bool want_dv = G != kDK, want_dk = G != kDV;
  const int D = DC > 0 ? DC : d;
  extern __shared__ uint8_t smem_raw[];
  const TcSmem m = tc_smem<W>(smem_raw);
  const int bh = bh0 + blockIdx.y;
  // the block's gradient columns
  const int col0 = C::SPLIT > 1 ? (int)blockIdx.z * NV : 0;
  const int k0 = blockIdx.x * kOwn;          // the longest loops first
  const int nq = (S + kStream - 1) / kStream;
  int it_end = nq;
  if (window > 0) it_end = min(nq, (k0 + kOwn - 1 + window - 1) / kStream + 1);
  const int it_begin = k0 / kStream;
  const int ntiles = it_end - it_begin;

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    if (threadIdx.x == 2 * kWG)
      tc_produce<W>(m, &tk, &tv, &tq, &tdo, k0, it_begin, ntiles, bh,
                    vecs + bh * vec_stride(S), plane);
    return;
  }

  const int t = threadIdx.x % kWG, lane = t % 32;
  const int klo = k0 + 64 * wg, khi = klo + 63;
  const int kr[2] = {klo + 16 * (t / 32) + lane / 4,
                     klo + 16 * (t / 32) + lane / 4 + 8};
  const uint32_t uK = hopper::smem_u32(m.own);
  const uint32_t uV = uK + C::OWN_BYTES;
  const int nk = k_steps<W, DC>(D);
  // the block's columns of a streamed tile: whole column blocks
  const uint32_t cols = col0 / 64 * kStream * hopper::kRowBytes;

  float adk[want_dk ? NV / 2 : 1], adv[want_dv ? NV / 2 : 1];
  if constexpr (want_dk) {
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) adk[j] = 0.f;
  }
  if constexpr (want_dv) {
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) adv[j] = 0.f;
  }

  hopper::mbar_wait(m.ownbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NS;
    const int q0 = (it_begin + i) * kStream;
    const bool reached = q0 + kStream - 1 >= klo &&
                         (window <= 0 || q0 <= khi + window - 1);
    hopper::mbar_wait(&m.full[st], (i / NS) & 1);
    if (reached) {
      const uint32_t uQ = hopper::smem_u32(m.ring + st * 2 * C::STREAM_BYTES);
      const uint32_t uO = uQ + C::STREAM_BYTES;
      const float* sl = m.vec + st * 2 * kStream;   // lse log2 e, then D
      float s[32], dp[32];
      hopper::wgmma_fence();
      tc_scores<W>(s, uK, wg, uQ, nk);
      if constexpr (want_dk) tc_scores<W>(dp, uV, wg, uO, nk);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      if constexpr (want_dk) hopper::fence_regs(dp);

      const bool open = q0 >= khi && q0 + kStream <= S &&
                        (window <= 0 || q0 + kStream - 1 < klo + window);
#pragma unroll
      for (int cb = 0; cb < 8; ++cb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * cb + 2 * (lane & 3) + e;
          const int qp = q0 + c;
          const bool in = qp < S;
          const float l2 = sl[c], di = sl[kStream + c];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 4 * cb + 2 * h + e;
            float p = exp2f(s[j] * scale_log2 - l2);
            if (!open) {
              const bool ok = in && kr[h] <= qp &&
                              (window <= 0 || kr[h] > qp - window);
              p = ok ? p : 0.f;
            }
            s[j] = p;
            if constexpr (want_dk) dp[j] = p * (dp[j] - di);
          }
        }
      uint32_t pa[4][4], da[4][4];
      if constexpr (want_dv) tc_pack(s, pa);
      if constexpr (want_dk) tc_pack(dp, da);
      hopper::wgmma_fence();
      if constexpr (want_dv) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<NV>(adv, pa[kk],
                               hopper::desc_mnmajor(uO + cols, kStream, kk),
                               1);
      }
      if constexpr (want_dk) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<NV>(adk, da[kk],
                               hopper::desc_mnmajor(uQ + cols, kStream, kk),
                               1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      if constexpr (want_dv) hopper::fence_regs(adv);
      if constexpr (want_dk) hopper::fence_regs(adk);
    }
    hopper::mbar_arrive(&m.empty[st]);
  }
  if constexpr (want_dk)
    tc_store<NV>(dk + (int64_t)bh * S * D, adk, kr, S, D, col0, scale, lane);
  if constexpr (want_dv)
    tc_store<NV>(dv + (int64_t)bh * S * D, adv, kr, S, D, col0, 1.f, lane);
}

// one block per (batch x head, 128-query tile, column slice): dq over the
// 64-key tiles its queries see; the accumulators' rows are queries,
// columns keys
template <int W, int DC>
__global__ void __launch_bounds__(kTcThreads, 1)
dq_tc(const __grid_constant__ CUtensorMap tq,
      const __grid_constant__ CUtensorMap tk,
      const __grid_constant__ CUtensorMap tv,
      const __grid_constant__ CUtensorMap tdo,
      const float* __restrict__ vecs, __nv_bfloat16* __restrict__ dq,
      int S, int d, int window, float scale, float scale_log2, int bh0,
      int64_t plane) {
  using C = TcBwd<W>;
  constexpr int NV = C::NV, NS = C::STAGES;
  const int D = DC > 0 ? DC : d;
  extern __shared__ uint8_t smem_raw[];
  const TcSmem m = tc_smem<W>(smem_raw);
  const int bh = bh0 + blockIdx.y;
  const int col0 = C::SPLIT > 1 ? (int)blockIdx.z * NV : 0;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kOwn;   // heaviest first
  const int last_q = min(q0 + kOwn - 1, S - 1);
  const int kt_end = last_q / kStream + 1;
  const int kt_begin =
      (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / kStream : 0;
  const int ntiles = kt_end - kt_begin;

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    if (threadIdx.x == 2 * kWG)
      tc_produce<W>(m, &tq, &tdo, &tk, &tv, q0, kt_begin, ntiles, bh,
                    nullptr, 0);
    return;
  }

  const int t = threadIdx.x % kWG, lane = t % 32;
  const int qlo = q0 + 64 * wg, qhi = qlo + 63;
  const int qr[2] = {qlo + 16 * (t / 32) + lane / 4,
                     qlo + 16 * (t / 32) + lane / 4 + 8};
  const float* lrow = vecs + bh * vec_stride(S);
  float l2[2], di[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = qr[h] < S;
    l2[h] = in ? lrow[qr[h]] : 0.f;
    di[h] = in ? lrow[plane + qr[h]] : 0.f;
  }
  const uint32_t uQ = hopper::smem_u32(m.own);
  const uint32_t uO = uQ + C::OWN_BYTES;
  const int nk = k_steps<W, DC>(D);
  const uint32_t cols = col0 / 64 * kStream * hopper::kRowBytes;

  float adq[NV / 2];
#pragma unroll
  for (int j = 0; j < NV / 2; ++j) adq[j] = 0.f;

  hopper::mbar_wait(m.ownbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NS;
    const int k0 = (kt_begin + i) * kStream;
    const bool reached = k0 <= qhi &&
                         (window <= 0 || k0 + kStream - 1 > qlo - window);
    hopper::mbar_wait(&m.full[st], (i / NS) & 1);
    if (reached) {
      const uint32_t uK = hopper::smem_u32(m.ring + st * 2 * C::STREAM_BYTES);
      const uint32_t uV = uK + C::STREAM_BYTES;
      float s[32], dp[32];
      hopper::wgmma_fence();
      tc_scores<W>(s, uQ, wg, uK, nk);
      tc_scores<W>(dp, uO, wg, uV, nk);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      const bool open = k0 + kStream - 1 <= qlo && qhi < S &&
                        (window <= 0 || k0 > qhi - window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int h = (j >> 1) & 1;
        float p = exp2f(s[j] * scale_log2 - l2[h]);
        if (!open) {
          const int kp = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          const bool ok = qr[h] < S && kp <= qr[h] &&
                          (window <= 0 || kp > qr[h] - window);
          p = ok ? p : 0.f;
        }
        dp[j] = p * (dp[j] - di[h]);
      }
      uint32_t da[4][4];
      tc_pack(dp, da);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs<NV>(adq, da[kk],
                             hopper::desc_mnmajor(uK + cols, kStream, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_regs(adq);
    }
    hopper::mbar_arrive(&m.empty[st]);
  }
  tc_store<NV>(dq + (int64_t)bh * S * D, adq, qr, S, D, col0, scale, lane);
}

// one warp per row: lse log2 e into plane 0 and D = do . o into plane 1
// of ``vecs``, rows padded to vec_stride(S) (the padding stays 0). DC as
// for dkdv_tc and dq_tc: with D at run time its loop took 21% longer at D
// = 64 (PERF.md)
template <int DC>
__global__ void __launch_bounds__(kThreads)
rowvec_tc(const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ vecs,
          int64_t rows, int S, int d) {
  const int D = DC > 0 ? DC : d;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(__bfloat162float(o[row * D + d]),
               __bfloat162float(dout[row * D + d]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int64_t at = row / S * vec_stride(S) + row % S;
    vecs[at] = lse[row] * kLog2e;
    vecs[rows / S * vec_stride(S) + at] = acc;
  }
}

// let ``fn`` take ``bytes`` of dynamic shared memory
template <typename F>
cudaError_t allow_smem(F* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int W, int DC>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* vecs, void* dq, void* dk, void* dv, int64_t BH,
                      int64_t S, int D, float scale, int window,
                      cudaStream_t stream) {
  using C = TcBwd<W>;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::make_tile_map(&mq, q, BH, S, D) ||
      !hopper::make_tile_map(&mk, k, BH, S, D) ||
      !hopper::make_tile_map(&mv, v, BH, S, D) ||
      !hopper::make_tile_map(&mdo, dout, BH, S, D))
    return cudaErrorInvalidValue;
  // dK and dV in one launch where a thread's registers hold both
  constexpr bool split = W > 64;
  const size_t smem = C::SMEM;
  cudaError_t err;
  if constexpr (split) {
    err = allow_smem(dkdv_tc<W, DC, kDV>, smem);
    if (err == cudaSuccess) err = allow_smem(dkdv_tc<W, DC, kDK>, smem);
  } else {
    err = allow_smem(dkdv_tc<W, DC, kDKDV>, smem);
  }
  if (err == cudaSuccess) err = allow_smem(dq_tc<W, DC>, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = BH * S;
  const int64_t row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  rowvec_tc<DC><<<(unsigned)row_blocks, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, vecs, rows,
      (int)S, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = scale * kLog2e;
  const int64_t plane = BH * vec_stride(S);
  __nv_bfloat16 *gk = (__nv_bfloat16*)dk, *gv = (__nv_bfloat16*)dv;
  for (int64_t b0 = 0; b0 < BH; b0 += kMaxGridY) {
    const int64_t n = BH - b0 < kMaxGridY ? BH - b0 : kMaxGridY;
    const dim3 grid((unsigned)((S + kOwn - 1) / kOwn), (unsigned)n, C::SPLIT);
    if constexpr (split) {
      dkdv_tc<W, DC, kDV><<<grid, kTcThreads, smem, stream>>>(
          mq, mk, mv, mdo, vecs, gk, gv, (int)S, D, window, scale,
          scale_log2, (int)b0, plane);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      dkdv_tc<W, DC, kDK><<<grid, kTcThreads, smem, stream>>>(
          mq, mk, mv, mdo, vecs, gk, gv, (int)S, D, window, scale,
          scale_log2, (int)b0, plane);
    } else {
      dkdv_tc<W, DC, kDKDV><<<grid, kTcThreads, smem, stream>>>(
          mq, mk, mv, mdo, vecs, gk, gv, (int)S, D, window, scale,
          scale_log2, (int)b0, plane);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dq_tc<W, DC><<<grid, kTcThreads, smem, stream>>>(
        mq, mk, mv, mdo, vecs, (__nv_bfloat16*)dq, (int)S, D, window, scale,
        scale_log2, (int)b0, plane);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// kind: 0 = float32 on CUDA cores, 1 = bf16 on the tensor cores (q, k, v,
// do 16-byte aligned, D a multiple of 8), 2 = bf16 on CUDA cores (D < 8):
// the wrapper's route. D in [1, 256] is the rows' length, head_dim in [1,
// D] the head dim of the scale 1 / sqrt(head_dim). window <= 0: no window.
// Dsum: float32 scratch of 2 B*H vec_stride(S) values, zeros (the CUDA-core
// kernels use its first B*H*S, the tensor-core ones hold the row vectors
// there).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* Dsum, void* dq, void* dk,
    void* dv, int64_t BH, int64_t S, int64_t D, int64_t head_dim,
    int64_t window, int kind, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaSuccess;
  if (BH > 2147483647LL || S > 2147483647LL - kOwn ||
      window > 2147483647LL || BH * S / (kThreads / 32) > 2147483647LL ||
      D < 1 || D > 256 || head_dim < 1 || head_dim > D ||
      (kind == 1 && D % 8 != 0) || (kind == 2 && D >= 8))
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  const float scale = 1.0f / sqrtf((float)head_dim);
  const int d = (int)D;
  cudaStream_t st = (cudaStream_t)stream;
  const float* ls = (const float*)lse;
  float* Ds = (float*)Dsum;
  const int width = hopper::padded_cols(d);
  if (kind == 0) {
    if (width == 64)
      return (int)launch<float, 64>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                    S, d, scale, w, st);
    if (width == 128)
      return (int)launch<float, 128>(q, k, v, o, dout, ls, Ds, dq, dk, dv,
                                     BH, S, d, scale, w, st);
    if (width == 192)
      return (int)launch<float, 192>(q, k, v, o, dout, ls, Ds, dq, dk, dv,
                                     BH, S, d, scale, w, st);
    return (int)launch<float, 256>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                   S, d, scale, w, st);
  }
  if (kind == 2)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, dout, ls, Ds, dq, dk,
                                          dv, BH, S, d, scale, w, st);
  if (kind == 1) {
    if (d == 64)
      return (int)launch_tc<64, 64>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                    S, d, scale, w, st);
    if (d == 128)
      return (int)launch_tc<128, 128>(q, k, v, o, dout, ls, Ds, dq, dk, dv,
                                      BH, S, d, scale, w, st);
    if (d == 160)
      return (int)launch_tc<192, 160>(q, k, v, o, dout, ls, Ds, dq, dk, dv,
                                      BH, S, d, scale, w, st);
    if (width == 64)
      return (int)launch_tc<64, 0>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                   S, d, scale, w, st);
    if (width == 128)
      return (int)launch_tc<128, 0>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                    S, d, scale, w, st);
    if (width == 192)
      return (int)launch_tc<192, 0>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH,
                                    S, d, scale, w, st);
    return (int)launch_tc<256, 0>(q, k, v, o, dout, ls, Ds, dq, dk, dv, BH, S,
                                  d, scale, w, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
