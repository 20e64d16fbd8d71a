// Per-lane ascending sort of a +inf-padded (lanes, R) float64 matrix, with
// an optional fused count of finite entries above a per-lane budget, for
// Hopper (sm_90a). Replaces the Pallas kernel
// repro/kernels/fulcrum/lane_sort.py::lane_sort (body _lane_sort_kernel),
// which the engine's report builder runs on every sort chunk.
//
// Design: a bitonic network over the row virtually padded with +inf to
// Rp = next power of two (the padding sorts to the end, so the first R
// sorted values are the row's own). Rows with Rp <= kChunk (16384 doubles,
// 128 KB) are sorted by one block each entirely in shared memory: one load,
// log2(Rp)(log2(Rp)+1)/2 compare-exchange stages separated by
// __syncthreads, one store, and the violation count reduced in the block.
// Longer rows (the reference's sort chunks allow R up to 4M) go through a
// scratch matrix of width Rp: shared-memory sorts of each kChunk piece with
// the bitonic directions of the full network, then for every stage whose
// compare distance is >= kChunk one global-memory pass, and the distances
// below kChunk again in shared memory per piece. A separate pass counts
// violations on that path.
//
// What bounds it: bytes (16 B per element: one read, one write) on the
// shared-memory path; a network of log2(Rp)^2/2 stages runs in shared
// memory, so device memory sees each element twice. The global path adds
// two passes of 16 B per element for every stage of distance >= kChunk.
// Sorting only permutes, so the result equals any other sort of the row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;        // doubles a block sorts in shared memory
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void compare_exchange(double* s, int64_t i,
                                                 int64_t p, bool up) {
  const double x = s[i], y = s[p];
  if ((x > y) == up) {
    s[i] = y;
    s[p] = x;
  }
}

// Bitonic stages k in [k_lo, k_hi] (j from k/2 down to 1, or from j_first
// in the first stage) on n doubles in shared memory; `offset` is the
// piece's index in the full row, which fixes each compare's direction
// (bit k of the global index).
__device__ void smem_stages(double* s, int n, int64_t offset, int64_t k_lo,
                            int64_t k_hi, int64_t j_first) {
  for (int64_t k = k_lo; k <= k_hi; k <<= 1) {
    for (int64_t j = (k == k_lo && j_first > 0) ? j_first : k >> 1; j > 0;
         j >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (int)(j - 1));   // lower index of the pair
        compare_exchange(s, i, i + j, ((offset + i) & k) == 0);
      }
      __syncthreads();
    }
  }
}

__device__ int block_sum(int v) {
  __shared__ int total;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) atomicAdd(&total, v);
  __syncthreads();
  return total;
}

// Whole row in shared memory: Rp <= kChunk.
__global__ void __launch_bounds__(kMaxThreads)
sort_rows_smem(const double* __restrict__ mat,
               const double* __restrict__ budgets,
               double* __restrict__ out,
               int* __restrict__ counts, int64_t R, int Rp) {
  extern __shared__ double s[];
  const int64_t lane = blockIdx.x;
  const double* row = mat + lane * R;
  for (int i = threadIdx.x; i < Rp; i += blockDim.x)
    s[i] = i < R ? row[i] : INFINITY;
  __syncthreads();
  smem_stages(s, Rp, 0, 2, Rp, 0);
  double* orow = out + lane * R;
  const double bud = budgets != nullptr ? budgets[lane] : 0.0;
  int over = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    const double v = s[i];
    orow[i] = v;
    over += (isfinite(v) && v > bud) ? 1 : 0;
  }
  if (counts != nullptr) {
    const int total = block_sum(over);
    if (threadIdx.x == 0) counts[lane] = total;
  }
}

// Long rows, step 1: sort each kChunk piece (stages k <= kChunk) into work.
__global__ void __launch_bounds__(kMaxThreads)
sort_pieces(const double* __restrict__ mat,
            double* __restrict__ work, int64_t R,
            int64_t Rp) {
  extern __shared__ double s[];
  const int64_t pieces = Rp / kChunk;
  const int64_t lane = blockIdx.x / pieces;
  const int64_t offset = (blockIdx.x % pieces) * kChunk;
  const double* row = mat + lane * R;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
    s[i] = offset + i < R ? row[offset + i] : INFINITY;
  __syncthreads();
  smem_stages(s, kChunk, offset, 2, kChunk, 0);
  double* wrow = work + lane * Rp + offset;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) wrow[i] = s[i];
}

// Long rows, step 2: one stage (k, j) with j >= kChunk, one pair per thread.
__global__ void merge_global(double* __restrict__ work, int64_t lanes,
                             int64_t Rp, int64_t k, int64_t j) {
  const int64_t half = Rp / 2;
  const int64_t n = lanes * half;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < n;
       g += (int64_t)gridDim.x * blockDim.x) {
    const int64_t lane = g / half, t = g % half;
    const int64_t i = 2 * t - (t & (j - 1));
    compare_exchange(work + lane * Rp, i, i + j, (i & k) == 0);
  }
}

// Long rows, step 3: stages (k, j < kChunk) inside each piece. On the last
// k (== Rp) it writes the first R values of each row to out instead.
__global__ void __launch_bounds__(kMaxThreads)
merge_pieces(double* __restrict__ work,
             double* __restrict__ out, int64_t R, int64_t Rp,
             int64_t k) {
  extern __shared__ double s[];
  const int64_t pieces = Rp / kChunk;
  const int64_t lane = blockIdx.x / pieces;
  const int64_t offset = (blockIdx.x % pieces) * kChunk;
  double* wrow = work + lane * Rp + offset;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) s[i] = wrow[i];
  __syncthreads();
  smem_stages(s, kChunk, offset, k, k, kChunk / 2);
  if (k < Rp) {
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x) wrow[i] = s[i];
  } else {
    double* orow = out + lane * R;
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x)
      if (offset + i < R) orow[offset + i] = s[i];
  }
}

// Long rows, step 4: per-lane count of finite entries above the budget.
__global__ void __launch_bounds__(kMaxThreads)
count_over(const double* __restrict__ out,
           const double* __restrict__ budgets,
           int* __restrict__ counts, int64_t R) {
  const int64_t lane = blockIdx.x;
  const double* row = out + lane * R;
  const double bud = budgets[lane];
  int over = 0;
  for (int64_t i = threadIdx.x; i < R; i += blockDim.x) {
    const double v = row[i];
    over += (isfinite(v) && v > bud) ? 1 : 0;
  }
  const int total = block_sum(over);
  if (threadIdx.x == 0) counts[lane] = total;
}

int64_t padded(int64_t R) {
  int64_t Rp = 1;
  while (Rp < R) Rp <<= 1;
  return Rp;
}

int threads_for(int64_t pairs) {
  int64_t t = pairs < 32 ? 32 : pairs;
  return (int)(t > kMaxThreads ? kMaxThreads : t);
}

}  // namespace

// Width of the scratch matrix (lanes, width) the launcher needs for rows of
// R values: 0 when rows fit in shared memory, else R padded to a power of 2.
extern "C" int64_t lane_sort_work_width(int64_t R) {
  const int64_t Rp = padded(R);
  return Rp > kChunk ? Rp : 0;
}

extern "C" int lane_sort_launch(const void* mat, const void* budgets,
                                void* out, void* counts, void* work,
                                int64_t lanes, int64_t R, void* stream) {
  if (lanes <= 0 || R <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  static bool configured = false;     // once per process (one device)
  if (!configured) {
    const int bytes = kChunk * (int)sizeof(double);
    cudaError_t err = cudaFuncSetAttribute(
        sort_rows_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          sort_pieces, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          merge_pieces, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int64_t Rp = padded(R);
  const double* m = (const double*)mat;
  const double* b = (const double*)budgets;
  double* o = (double*)out;
  int* c = (int*)counts;
  if (Rp <= kChunk) {
    sort_rows_smem<<<(unsigned)lanes, threads_for(Rp / 2),
                     Rp * sizeof(double), st>>>(m, b, o, c, R, (int)Rp);
    return (int)cudaGetLastError();
  }
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  double* w = (double*)work;
  const unsigned blocks = (unsigned)(lanes * (Rp / kChunk));
  const size_t smem = kChunk * sizeof(double);
  sort_pieces<<<blocks, kMaxThreads, smem, st>>>(m, w, R, Rp);
  const int64_t pairs = lanes * (Rp / 2);
  const unsigned gblocks =
      (unsigned)((pairs + 255) / 256 < 65536 ? (pairs + 255) / 256 : 65536);
  for (int64_t k = 2 * kChunk; k <= Rp; k <<= 1) {
    for (int64_t j = k >> 1; j >= kChunk; j >>= 1)
      merge_global<<<gblocks, 256, 0, st>>>(w, lanes, Rp, k, j);
    merge_pieces<<<blocks, kMaxThreads, smem, st>>>(w, o, R, Rp, k);
  }
  if (c != nullptr)
    count_over<<<(unsigned)lanes, kMaxThreads, 0, st>>>(o, b, c, R);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
