// Per-lane ascending sort of a +inf-padded (lanes, R) float64 matrix, with
// an optional fused count of finite entries above a per-lane budget, for
// Hopper (sm_90a). Replaces the Pallas kernel
// repro/kernels/fulcrum/lane_sort.py::lane_sort (body _lane_sort_kernel),
// which the engine's report builder runs on every sort chunk.
//
// Design: a bitonic network over the row virtually padded with +inf to
// Rp = next power of two (the padding sorts to the end, so the first R
// sorted values are the row's own), in one of three routes that
// lane_sort_route picks from R alone:
//
//  * warp, Rp <= 32 kE (512): one warp sorts one row (a block holds
//    kWarpRows rows), N = max(Rp, 32) / 32 doubles in each lane's
//    registers. Lane l's register e holds element l N + e, so distances
//    j < N pair registers of one thread and N <= j < 32 N pair lanes
//    l ^ (j / N) through __shfl_xor_sync (two 32-bit shuffles a double).
//    No shared memory and no barrier. Since a sort only permutes, lane l
//    loads elements l, l + 32, ... (coalesced) into its registers in any
//    order; before the store, a transpose by shuffles gives lane l the
//    sorted elements l, l + 32, ..., so the store is coalesced too.
//  * block, 32 kE < Rp <= kChunk (16384): one block of W = Rp / (32 kE)
//    warps holds the row in registers, kE = 16 a thread (a block has at
//    most 1024 threads, so 16384 values need 16 each); one instantiation
//    per W. Distances j < 32 kE run as in the warp route. For each merge
//    size k > 32 kE, the row goes once through shared memory into the
//    layout whose warp bits and low index bits trade places, every
//    distance j >= 32 kE of that merge runs there in registers and
//    shuffles, and the row comes back: two barriers for each such k (8 at
//    Rp = 8192, against 91 stages a barrier each in shared memory). Pad
//    slots keep every shared access at two per bank, the least for 32
//    doubles.
//  * global, Rp > kChunk (the reference's sort chunks allow R up to 4M):
//    through a scratch matrix of width Rp: shared-memory sorts of each
//    kChunk piece with the bitonic directions of the full network, then
//    for every stage whose compare distance is >= kChunk one global-memory
//    pass, and the distances below kChunk again in shared memory per
//    piece. A separate pass counts violations on that path.
//
// Every compare swaps when (lower > upper) == ascending, both partners of a
// shuffle deciding from the same pair, so the row's values are only ever
// permuted and the result equals any other sort of the row bit for bit.
//
// What bounds it: bytes, 16 B per element (one read, one write of device
// memory) on the warp and block routes; the network's log2(Rp)^2 / 2
// stages run on registers, so what the card spends beyond the bytes is
// the compares, selects and shuffles they issue. The global path adds two
// passes of 16 B per element for every stage of distance >= kChunk.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16384;        // the longest row one block sorts
constexpr int kMaxThreads = 1024;
constexpr int kE = 16;               // doubles a thread of the block route holds
constexpr int kWarpBits = 9;         // log2 of kWarpMax
constexpr int kWarpMax = 32 * kE;    // the longest (padded) row of a warp
constexpr int kWarpRows = 8;         // rows (warps) in a warp-route block

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

// One pair of registers: a is the lower element.
__device__ __forceinline__ void cx_regs(double& a, double& b, bool up) {
  if ((a > b) == up) {
    const double t = a;
    a = b;
    b = t;
  }
}

// Stages j = jtop, jtop / 2, ..., 1 of a bitonic merge on the N doubles a
// thread holds, where register e of thread tid holds element tid N + e of
// the network (the blocked layout) and a pair sorts ascending when its
// index has bit kdir clear (kdir == 0: every pair ascending). Distances
// j >= N go through shuffles with lane tid ^ (j / N) (jtop <= 16 N), the
// rest stay in the thread. kUniform: kdir is 0 or >= N, so every pair of
// the thread has one direction.
template <int N, bool kUniform>
__device__ __forceinline__ void merge_regs(double (&v)[N], int tid,
                                           int kdir, int jtop) {
  const int base = tid * N;
  const bool up_t = (base & kdir) == 0;
  for (int j = jtop; j >= N; j >>= 1) {   // kdir > j >= N, or 0
    const int m = j / N;
    const bool lower = (tid & m) == 0;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const double p = __shfl_xor_sync(0xffffffffu, v[e], m);
      // the lower partner compares (v > p), the upper (p > v): one pair
      const bool swap = (lower ? v[e] > p : p > v[e]) == up_t;
      if (swap) v[e] = p;
    }
  }
#pragma unroll
  for (int j = N / 2; j >= 1; j >>= 1) {
    if (j > jtop) continue;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (e & j) continue;
      cx_regs(v[e], v[e + j],
              kUniform ? up_t : ((base | e) & kdir) == 0);
    }
  }
}

// Warp route: Rp <= kWarpMax, one row per warp, N = max(Rp, 32) / 32.
template <int N>
__global__ void __launch_bounds__(kWarpRows * 32)
sort_rows_warp(const double* __restrict__ mat,
               const double* __restrict__ budgets,
               double* __restrict__ out, int* __restrict__ counts,
               int64_t lanes, int64_t R) {
  constexpr int n = N >= 16 ? 4 : N >= 8 ? 3 : N >= 4 ? 2 : N >= 2 ? 1 : 0;
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= lanes) return;               // the whole warp: no barrier follows
  const double* row = mat + r * R;
  const double bud = budgets != nullptr ? budgets[r] : 0.0;
  double v[N];
  int over = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {         // any order: the sort permutes
    const int i = e * 32 + lane;
    v[e] = i < R ? row[i] : INFINITY;
    over += (isfinite(v[e]) && v[e] > bud) ? 1 : 0;
  }
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) merge_regs<N, false>(v, lane, k, k >> 1);
  for (int k = 2 * N; k <= 32 * N; k <<= 1)
    merge_regs<N, true>(v, lane, k, k >> 1);
  // Blocked to striped: lane l's register e then holds element 32 e + l.
  // Trading register bit b with lane bit 5 - n + b moves index bits 5 ..
  // n + 4 into the registers and leaves the lane number rotated by n.
#pragma unroll
  for (int b = 0; b < n; ++b) {
    const int q = 5 - n + b;
    const bool hi = (lane >> q) & 1;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (e & (1 << b)) continue;
      const int e2 = e | (1 << b);
      const double got = __shfl_xor_sync(0xffffffffu, hi ? v[e] : v[e2],
                                         1 << q);
      if (hi) v[e] = got;
      else v[e2] = got;
    }
  }
  const int src = ((lane >> n) | (lane << (5 - n))) & 31;
  double* orow = out + r * R;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const double x = __shfl_sync(0xffffffffu, v[e], src);
    const int i = e * 32 + lane;
    if (i < R) orow[i] = x;
  }
  if (counts != nullptr) {
    over = __reduce_add_sync(0xffffffffu, over);
    if (lane == 0) counts[r] = over;
  }
}

// Shared-memory slot of element i: one pad slot after every 16 doubles and
// one more after every 8192, so that a warp's 32 accesses in either layout
// below, or 32 consecutive elements, hit each bank twice at most (the
// least for doubles). Elements whose index bits are disjoint add:
// slot(a | b) = slot(a) + slot(b).
__host__ __device__ constexpr int slot(int i) {
  return i + (i >> 4) + (i >> 13);
}

// The traded layout of the block route: index bits 0 .. w - 1 and
// kWarpBits .. kWarpBits + w - 1 swap places (W = 2^w warps), so distances
// >= 32 kE become register and lane distances.
template <int W>
__device__ constexpr int trade(int p) {
  return (p & ~((W - 1) | ((W - 1) << kWarpBits))) |
         ((p & (W - 1)) << kWarpBits) | ((p >> kWarpBits) & (W - 1));
}

// Block route: kWarpMax < Rp = 32 kE W <= kChunk, one row per block of W
// warps, kE doubles a thread in registers; shared memory only for the
// distances >= kWarpMax. Every shared address is a base per thread plus a
// constant per register, so no address stays live across the network.
template <int W>
__global__ void __launch_bounds__(32 * W, 32 / W)
sort_rows_block(const double* __restrict__ mat,
                const double* __restrict__ budgets,
                double* __restrict__ out, int* __restrict__ counts,
                int64_t R) {
  constexpr int T = 32 * W, Rp = kE * T;
  extern __shared__ double s[];
  __shared__ int part[W];
  const int tid = threadIdx.x;
  const int64_t r = blockIdx.x;
  const double* row = mat + r * R;
  const double bud = budgets != nullptr ? budgets[r] : 0.0;
  double v[kE];
  int over = 0;
#pragma unroll
  for (int e = 0; e < kE; ++e) {        // coalesced, in any order
    const int i = e * T + tid;
    v[e] = i < R ? row[i] : INFINITY;
    over += (isfinite(v[e]) && v[e] > bud) ? 1 : 0;
  }
  double* sn = s + slot(tid * kE);          // + e: element tid kE + e
  double* st = s + slot(trade<W>(tid * kE));  // + slot(trade(e)): traded
#pragma unroll
  for (int k = 2; k <= kE; k <<= 1) merge_regs<kE, false>(v, tid, k, k >> 1);
  for (int k = 2 * kE; k <= Rp; k <<= 1) {
    if (k > kWarpMax) {
#pragma unroll
      for (int e = 0; e < kE; ++e) sn[e] = v[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kE; ++e) v[e] = st[slot(trade<W>(e))];
      // index bit c >= kWarpBits is bit c - kWarpBits here; k == Rp has
      // no direction bit inside the row
      merge_regs<kE, false>(v, tid, k == Rp ? 0 : k >> kWarpBits,
                            k >> (kWarpBits + 1));
#pragma unroll
      for (int e = 0; e < kE; ++e) st[slot(trade<W>(e))] = v[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kE; ++e) v[e] = sn[e];
    }
    merge_regs<kE, true>(v, tid, k, min(k >> 1, kWarpMax / 2));
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) sn[e] = v[e];
  if (counts != nullptr) {
    over = __reduce_add_sync(0xffffffffu, over);
    if ((tid & 31) == 0) part[tid >> 5] = over;
  }
  __syncthreads();
  double* orow = out + r * R;
#pragma unroll
  for (int e = 0; e < kE; ++e) {        // coalesced
    const int i = e * T + tid;
    if (i < R) orow[i] = s[slot(i)];
  }
  if (counts != nullptr && tid < 32) {
    const int total = __reduce_add_sync(0xffffffffu, tid < W ? part[tid] : 0);
    if (tid == 0) counts[r] = total;
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

template <int N>
void launch_warp(const double* m, const double* b, double* o, int* c,
                 int64_t lanes, int64_t R, cudaStream_t st) {
  const unsigned blocks = (unsigned)((lanes + kWarpRows - 1) / kWarpRows);
  sort_rows_warp<N><<<blocks, kWarpRows * 32, 0, st>>>(m, b, o, c, lanes, R);
}

constexpr size_t block_smem(int W) {
  return (size_t)(slot(kE * 32 * W - 1) + 1) * sizeof(double);
}

template <int W>
cudaError_t launch_block(const double* m, const double* b, double* o, int* c,
                         int64_t lanes, int64_t R, cudaStream_t st) {
  static bool configured = false;     // once per process (one device)
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sort_rows_block<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)block_smem(W));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  sort_rows_block<W><<<(unsigned)lanes, 32 * W, block_smem(W), st>>>(
      m, b, o, c, R);
  return cudaGetLastError();
}

}  // namespace

// The route rows of R values take: 0 warp, 1 block, 2 global.
extern "C" int lane_sort_route(int64_t R) {
  const int64_t Rp = padded(R);
  return Rp <= kWarpMax ? 0 : Rp <= kChunk ? 1 : 2;
}

// Width of the scratch matrix (lanes, width) the launcher needs for rows of
// R values: 0 on the warp and block routes, else R padded to a power of 2.
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
  switch (lane_sort_route(R)) {
    case 0:
      switch (Rp <= 32 ? 1 : Rp / 32) {
        case 1: launch_warp<1>(m, b, o, c, lanes, R, st); break;
        case 2: launch_warp<2>(m, b, o, c, lanes, R, st); break;
        case 4: launch_warp<4>(m, b, o, c, lanes, R, st); break;
        case 8: launch_warp<8>(m, b, o, c, lanes, R, st); break;
        default: launch_warp<16>(m, b, o, c, lanes, R, st); break;
      }
      return (int)cudaGetLastError();
    case 1:
      switch (Rp / kWarpMax) {
        case 2: return (int)launch_block<2>(m, b, o, c, lanes, R, st);
        case 4: return (int)launch_block<4>(m, b, o, c, lanes, R, st);
        case 8: return (int)launch_block<8>(m, b, o, c, lanes, R, st);
        case 16: return (int)launch_block<16>(m, b, o, c, lanes, R, st);
        default: return (int)launch_block<32>(m, b, o, c, lanes, R, st);
      }
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
