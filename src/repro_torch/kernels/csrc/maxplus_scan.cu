// Managed-interleaving max-plus scan fused with the training slack-fill sum,
// for Hopper (sm_90a). Replaces the Pallas kernel
// repro/kernels/fulcrum/maxplus_scan.py::maxplus_scan (body _maxplus_kernel).
//
// Per lane i (one row of the row-major (lanes, K) float64 inputs):
//   c_k   = max(c_{k-1}, ready_k) + exec_k,  c_{-1} = clock_i
//   fills = sum over finite ready_k of clip(floor((ready_k - c_{k-1}) / t_tr_i),
//                                           0, tau_cap_i)
// Padding is trailing ready = +inf, exec = 0 (absorbing); t_tr = +inf gives
// no fills and tau_cap = +inf no cap.
//
// Design: one warp per lane, walking the event axis in tiles of 32 x ITEMS.
// Each thread composes its ITEMS consecutive events into one max-plus affine
// map x -> max(x + A, B); a warp-shuffle Hillis-Steele scan turns those into
// exclusive prefix maps, so each thread knows the completion entering its
// first event from the carry of the previous tile. It then replays its own
// events with the plain recurrence, writing every completion and counting
// fills. The tile's last completion is the next tile's carry.
//
// What bounds it: bytes. It reads ready and exec and writes c once (24 B
// per event) and does ~10 float64 operations per event, far below the
// card's float64 rate, so the floor is 24 B x lanes x K over the memory
// rate. A warp per lane keeps each lane's row reads contiguous (one thread
// per lane would stride a warp's loads across 32 rows), and 8 lanes per
// block give enough warps in flight to cover memory latency. Float64 all
// the way: the ulp of 120 s in float32 (7.6e-6 s) is far above the engine's
// 1e-8 s tolerance. The scan order differs from the Pallas doubling, so
// completions agree to that tolerance, not bitwise, and a fill count can
// move by one at an exact floor boundary (docs/exactness.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kItems = 4;            // consecutive events per thread
constexpr int kWarpsPerBlock = 8;    // lanes per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
maxplus_scan_kernel(const double* __restrict__ ready,
                    const double* __restrict__ exec_t,
                    const double* __restrict__ t_tr,
                    const double* __restrict__ tau_cap,
                    const double* __restrict__ clock,
                    double* __restrict__ c_out,
                    double* __restrict__ fills_out,
                    int64_t lanes, int64_t K) {
  const int t = threadIdx.x & 31;
  const int64_t lane =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane >= lanes) return;         // the whole warp leaves together
  const double* r_row = ready + lane * K;
  const double* e_row = exec_t + lane * K;
  double* c_row = c_out + lane * K;
  const double ttr = t_tr[lane];
  const double cap = tau_cap[lane];
  double carry = clock[lane];
  double fill = 0.0;

  for (int64_t base = 0; base < K; base += 32 * kItems) {
    const int64_t k0 = base + (int64_t)t * kItems;
    double r[kItems], e[kItems];
    double A = 0.0, B = -INFINITY;   // identity map x -> x
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (k0 + j < K) {
        r[j] = r_row[k0 + j];
        e[j] = e_row[k0 + j];
      } else {                       // beyond the row: identity element
        r[j] = -INFINITY;
        e[j] = 0.0;
      }
      B = fmax(B + e[j], r[j] + e[j]);   // compose: earlier map first
      A = A + e[j];
    }
    // inclusive scan of the per-thread maps across the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double As = __shfl_up_sync(kFull, A, d);
      const double Bs = __shfl_up_sync(kFull, B, d);
      if (t >= d) {
        B = fmax(Bs + A, B);
        A = As + A;
      }
    }
    double Ae = __shfl_up_sync(kFull, A, 1);
    double Be = __shfl_up_sync(kFull, B, 1);
    if (t == 0) {
      Ae = 0.0;
      Be = -INFINITY;
    }
    double cur = fmax(carry + Ae, Be);   // completion before this thread
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (k0 + j < K) {
        const double start = cur;
        cur = fmax(cur, r[j]) + e[j];
        c_row[k0 + j] = cur;
        if (isfinite(r[j])) {        // select, never multiply: inf-inf=NaN
          const double q = floor((r[j] - start) / ttr);
          fill += fmin(fmax(q, 0.0), cap);
        }
      }
    }
    carry = __shfl_sync(kFull, cur, 31);
  }
  // fills are whole numbers: the warp sum is exact in any order
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) fill += __shfl_down_sync(kFull, fill, d);
  if (t == 0) fills_out[lane] = fill;
}

}  // namespace

extern "C" int maxplus_scan_launch(const void* ready, const void* exec_t,
                                   const void* t_tr, const void* tau_cap,
                                   const void* clock, void* c_out,
                                   void* fills_out, int64_t lanes, int64_t K,
                                   void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  const int64_t blocks = (lanes + kWarpsPerBlock - 1) / kWarpsPerBlock;
  maxplus_scan_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                        (cudaStream_t)stream>>>(
      (const double*)ready, (const double*)exec_t, (const double*)t_tr,
      (const double*)tau_cap, (const double*)clock, (double*)c_out,
      (double*)fills_out, lanes, K);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
