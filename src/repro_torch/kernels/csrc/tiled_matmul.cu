// Tiled matrix product for Hopper (sm_90a): c = a @ b with float32
// accumulation, written in the input type. Replaces the Pallas kernel
// repro/kernels/tiled_matmul/tiled_matmul.py::tiled_matmul (body
// _mm_kernel).
//
// a (M, K), b (K, N), c (M, N), row-major, all bf16 or all float32, any
// M, N, K (the TPU kernel needs multiples of its 128 blocks; its block_*
// arguments are TPU tiling and are not part of this function). On the TPU
// the K axis is the innermost grid axis and the (bm, bn) float32
// accumulator lives in VMEM across grid steps; here one block owns an
// output tile and loops over K itself, the accumulator in registers.
//
// Three routes, chosen by the wrapper from dtype, shape and alignment
// before the launch (tiled_matmul.py::route):
//  * bf16, TMA (mm_tma_kernel): a and b 16-byte aligned, K and N multiples
//    of 8, so every row starts on 16 bytes as a tensor map needs. A block
//    of two consumer warpgroups and one producer warp owns a 128 x 256
//    output tile, 64 rows per warpgroup. The producer streams 64-deep K
//    steps of a (128 x 64, K-major) and b (64 x 256, read MN-major through
//    the transpose bit) with TMA into a ring of 4 stages of 48 KB
//    (hopper.cuh's layout: 64-column blocks of 128-byte swizzled rows;
//    boxes past M, N or K arrive as zeros), each stage with a full and an
//    empty mbarrier. Each consumer issues four wgmma m64n256k16 per stage
//    and keeps one stage's products in flight while it waits for the
//    next. 288 threads leave ptxas 224 registers a thread, room for the
//    128 float32 accumulators, so no setmaxnreg is needed. Blocks run in
//    bands of 8 M tiles that share one column of b tiles, so that band's
//    b is read from L2. The epilogue rounds to bf16 in registers and
//    stores pairs of columns, masked at M and N.
//  * bf16, mma.sync (mm_bf16_kernel): every other bf16 input (rows that
//    are not 16-byte multiples). A 128 x 128 tile per block of 8 warps,
//    K in steps of 32 through shared memory, mma.sync.m16n8k16.
//  * float32 (mm_f32_kernel): CUDA cores in float32 (no TF32), a 64 x 64
//    tile per block, 4 x 4 outputs per thread from float4 reads.
//
// What bounds it: operations, 2 M N K flops (989 TFLOP/s bf16 on the
// tensor cores; 67 TFLOP/s float32). The TMA route's b is re-read once per
// M tile and a once per N tile, from L2 within a band.
#include "hopper.cuh"
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---- bf16 through mma.sync ------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLDA = kBK + 8;        // padded rows, in bf16 values
constexpr int kLDB = kBN + 8;

// 8 bf16 values (raw bits) at row `row`, columns [col, col + 8) of a
// (rows, cols) row-major matrix, zero past its edges
__device__ __forceinline__ uint4 load8(const uint16_t* m, int64_t row,
                                       int64_t col, int64_t rows,
                                       int64_t cols) {
  uint16_t v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    v[u] = (row < rows && col + u < cols) ? m[row * cols + col + u] : 0;
  uint4 out;
  out.x = v[0] | ((uint32_t)v[1] << 16);
  out.y = v[2] | ((uint32_t)v[3] << 16);
  out.z = v[4] | ((uint32_t)v[5] << 16);
  out.w = v[6] | ((uint32_t)v[7] << 16);
  return out;
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
mm_bf16_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
               __nv_bfloat16* __restrict__ c, int64_t M, int64_t N,
               int64_t K) {
  __shared__ __align__(16) uint16_t As[kBM * kLDA];
  __shared__ __align__(16) uint16_t Bs[kBK * kLDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;           // mma group, thread in it
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;

  // each thread moves 2 vectors of 8 values of A and 2 of B per K step
  int ar[2], ac[2], br[2], bcol[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int v = tid + kThreads * s;
    ar[s] = v / (kBK / 8);
    ac[s] = (v % (kBK / 8)) * 8;
    br[s] = v / (kBN / 8);
    bcol[s] = (v % (kBN / 8)) * 8;
  }
  uint4 ra[2], rb[2];
  auto fetch = [&](int64_t k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      ra[s] = load8(a, m0 + ar[s], k0 + ac[s], M, K);
      rb[s] = load8(b, k0 + br[s], n0 + bcol[s], K, N);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      *reinterpret_cast<uint4*>(&As[ar[s] * kLDA + ac[s]]) = ra[s];
      *reinterpret_cast<uint4*>(&Bs[br[s] * kLDB + bcol[s]]) = rb[s];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  fetch(0);
  stash();
  __syncthreads();
  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) fetch(k0 + kBK);       // in flight while the tensor cores run
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[4][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint16_t* r0 = &As[(wm + i * 16 + g) * kLDA + kk + t * 2];
        const uint16_t* r8 = r0 + 8 * kLDA;
        fa[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        fa[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        fa[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        fa[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn + j * 8 + g;
        const int k = kk + t * 2;
        fb[j][0] = Bs[k * kLDB + col] | ((uint32_t)Bs[(k + 1) * kLDB + col] << 16);
        fb[j][1] = Bs[(k + 8) * kLDB + col] |
                   ((uint32_t)Bs[(k + 9) * kLDB + col] << 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], fa[i][0], fa[i][1], fa[i][2], fa[i][3],
                   fb[j][0], fb[j][1]);
    }
    __syncthreads();                 // this tile is consumed
    if (more) {
      stash();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int64_t col = n0 + wn + j * 8 + t * 2 + (e & 1);
        if (row < M && col < N) c[row * N + col] = __float2bfloat16(acc[i][j][e]);
      }
}

// ---- bf16 through TMA and wgmma -------------------------------------------

constexpr int kWG = 128;                     // threads of a warpgroup
constexpr int kTmThreads = 2 * kWG + 32;     // two consumers, one producer
constexpr int kTmBM = 128, kTmBN = 256, kTmBK = 64;
constexpr int kTmStages = 4;
constexpr int kGroupM = 8;                   // M tiles in a band
constexpr int kTmA = kTmBM * kTmBK * 2;      // bytes of one stage's a tile
constexpr int kTmB = kTmBK * kTmBN * 2;      // and of its b tile
constexpr int kTmStage = kTmA + kTmB;
// the ring, then full[] and empty[], and 1024 bytes to align the ring
constexpr size_t kTmSmem = kTmStages * kTmStage + 16 * kTmStages + 1024;

__global__ void __launch_bounds__(kTmThreads, 1)
mm_tma_kernel(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tb,
              __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023))
                              & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTmStages * kTmStage);
  uint64_t* empty = full + kTmStages;

  // bands of kGroupM M tiles; inside a band, M tiles vary fastest
  const int tiles_m = (M + kTmBM - 1) / kTmBM;
  const int tiles_n = (N + kTmBN - 1) / kTmBN;
  const int per_band = kGroupM * tiles_n;
  const int band = blockIdx.x / per_band, in_band = blockIdx.x % per_band;
  const int band_m = min(tiles_m - band * kGroupM, kGroupM);
  const int m0 = (band * kGroupM + in_band % band_m) * kTmBM;
  const int n0 = (in_band / band_m) * kTmBN;
  const int nk = (K + kTmBK - 1) / kTmBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * kWG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {                             // the producer warp
    if (threadIdx.x == 2 * kWG) {
      for (int i = 0; i < nk; ++i) {
        const int st = i % kTmStages;
        if (i >= kTmStages)
          hopper::mbar_wait(&empty[st], (i / kTmStages - 1) & 1);
        hopper::mbar_expect_tx(&full[st], kTmStage);
        uint8_t* sA = ring + st * kTmStage;
        uint8_t* sB = sA + kTmA;
        const int k0 = i * kTmBK;
        for (int rb = 0; rb < kTmBM / hopper::kBox; ++rb)
          hopper::tma_load(sA + rb * hopper::kBoxBytes, &ta, &full[st], k0,
                           m0 + rb * hopper::kBox, 0);
        for (int cb = 0; cb < kTmBN / hopper::kBox; ++cb)
          hopper::tma_load(sB + cb * hopper::kBoxBytes, &tb, &full[st],
                           n0 + cb * hopper::kBox, k0, 0);
      }
    }
    return;
  }

  // a consumer warpgroup: rows m0 + 64 wg .. + 63, all 256 columns
  float acc[kTmBN / 2];
#pragma unroll
  for (int j = 0; j < kTmBN / 2; ++j) acc[j] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int st = i % kTmStages;
    hopper::mbar_wait(&full[st], (i / kTmStages) & 1);
    const uint32_t uA = hopper::smem_u32(ring + st * kTmStage);
    const uint32_t uB = uA + kTmA;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTmBK / 16; ++kk)
      hopper::wgmma_ss_n256_tb(acc, hopper::desc_kmajor(uA, kTmBM, 64 * wg, kk),
                               hopper::desc_mnmajor(uB, kTmBK, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                 // the previous stage is read
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % kTmStages]);
  }
  hopper::wgmma_wait_all();
  hopper::fence_regs(acc);

  // register j: row 16 (t / 32) + (t % 32) / 4 + 8 ((j / 2) % 2), columns
  // 8 (j / 4) + 2 (t % 4) and + 1
  const int t = threadIdx.x % kWG;
  const int row0 = m0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int col0 = n0 + 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < kTmBN / 2; j += 2) {
    const int row = row0 + 8 * ((j / 2) % 2), col = col0 + 8 * (j / 4);
    if (row < M && col < N)                  // N even: col + 1 < N too
      *reinterpret_cast<uint32_t*>(c + (int64_t)row * N + col) =
          hopper::pack_bf16(acc[j], acc[j + 1]);
  }
}

// ---- float32 on the CUDA cores --------------------------------------------

constexpr int kFT = 64, kFK = 16, kFLD = kFT + 4;

__global__ void __launch_bounds__(kThreads)
mm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int64_t M, int64_t N, int64_t K) {
  __shared__ __align__(16) float As[kFK * kFLD];   // [k][m], transposed
  __shared__ __align__(16) float Bs[kFK * kFLD];   // [k][n]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t m0 = (int64_t)blockIdx.y * kFT, n0 = (int64_t)blockIdx.x * kFT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();
    for (int e = tid; e < kFT * kFK; e += kThreads) {
      const int r = e / kFK, kk = e % kFK;         // A: along k
      const int64_t row = m0 + r, k = k0 + kk;
      As[kk * kFLD + r] = (row < M && k < K) ? a[row * K + k] : 0.f;
      const int kb = e / kFT, col = e % kFT;       // B: along n
      const int64_t kr = k0 + kb, cc = n0 + col;
      Bs[kb * kFLD + col] = (kr < K && cc < N) ? b[kr * N + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(&As[kk * kFLD + ty * 4]);
      const float4 y = *reinterpret_cast<const float4*>(&Bs[kk * kFLD + tx * 4]);
      const float av[4] = {x.x, x.y, x.z, x.w};
      const float bv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t row = m0 + ty * 4 + i, col = n0 + tx * 4 + j;
      if (row < M && col < N) c[row * N + col] = acc[i][j];
    }
}

}  // namespace

// route: 0 = float32, 1 = bf16 through mma.sync, 2 = bf16 through TMA
// (a, b 16-byte aligned, K and N multiples of 8; refused otherwise).
extern "C" int tiled_matmul_launch(const void* a, const void* b, void* c,
                                   int64_t M, int64_t N, int64_t K,
                                   int route, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 2) {
    if (K % 8 != 0 || N % 8 != 0 || (uintptr_t)a % 16 != 0 ||
        (uintptr_t)b % 16 != 0 || M > INT32_MAX || N > INT32_MAX ||
        K > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    const int64_t tiles = ((M + kTmBM - 1) / kTmBM) * ((N + kTmBN - 1) / kTmBN);
    if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    if (!hopper::make_tile_map(&ta, a, 1, M, (int)K) ||
        !hopper::make_tile_map(&tb, b, 1, K, (int)N))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        mm_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kTmSmem);
    if (err != cudaSuccess) return (int)err;
    mm_tma_kernel<<<(unsigned)tiles, kTmThreads, kTmSmem, st>>>(
        ta, tb, (__nv_bfloat16*)c, (int)M, (int)N, (int)K);
    return (int)cudaGetLastError();
  }
  if (route == 1) {
    if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((N + kBN - 1) / kBN),
                    (unsigned)((M + kBM - 1) / kBM));
    mm_bf16_kernel<<<grid, kThreads, 0, st>>>(
        (const uint16_t*)a, (const uint16_t*)b, (__nv_bfloat16*)c, M, N, K);
    return (int)cudaGetLastError();
  }
  if (route == 0) {
    if ((M + kFT - 1) / kFT > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((N + kFT - 1) / kFT),
                    (unsigned)((M + kFT - 1) / kFT));
    mm_f32_kernel<<<grid, kThreads, 0, st>>>((const float*)a, (const float*)b,
                                             (float*)c, M, N, K);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
