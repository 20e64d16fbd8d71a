// One fleet window as one launch, for Hopper (sm_90a): the planning ladder,
// the mode-switch charge, deadline-drop admission, compaction and the
// batch-ready max-plus fold of every device. Counterpart of the reference's
// jitted window program (repro/core/fused_window.py::_fused_kernel, a
// jax.jit program, not Pallas); the wrapper is
// repro_torch/kernels/fulcrum/fused_window.py, which documents the layout.
//
// Inputs: the grid's columns t, p, bsf (float64) and mode_ids (int32) of N
// entries; rows (K, kNIn + T) float64, device k's fields then its T arrival
// times (+inf padded). Output (K, kNOut + 2T) float64: the fields, then the
// admitted times and the latencies (+inf padded).
//
// Design: one block per device.
//  * The rungs: the block's threads stride over the N grid entries, each
//    keeping its first strict minimum of lam over the feasible entries; a
//    warp-shuffle and shared-memory reduction takes the smaller lam, ties
//    to the lower index (jnp.argmin's first occurrence). All-infeasible
//    gives index 0, lam = +inf, ok = false. A rung runs only where this
//    device's own gate needs it; every thread of the block takes the same
//    branch, since the gate depends on the device's row alone.
//  * The serial part: thread 0 runs the admission recurrence over the
//    device's arrivals (a ring of forming-batch member indices, drops from
//    its front), writes the admitted times in order as batches commit (a
//    batch's members and the trailing partial batch are the admitted
//    subsequence), then folds c = max(c, ready_j) + t_in over the admitted
//    batches and writes the latencies. When 2T doubles fit in shared memory
//    (T <= kStageMaxT), the arrivals and the admitted times are staged there;
//    else thread 0 works on the global rows. The block's threads fill the
//    +inf tails and copy the staged admitted times out.
//
// Bitwise arithmetic: every float64 operation of the rungs, the switch
// charge and the admission is a correctly rounded intrinsic (__dmul_rn,
// __dadd_rn, __dsub_rn, __ddiv_rn), which nvcc never contracts into an FMA:
// tk = t * ts and lam = (bs - 1) / ar + tk would otherwise fuse, move lam by
// an ulp and flip argmins against the reference. fmax and the comparisons
// are exact.
//
// What bounds it: the serial admission and fold, a chain of dependent
// float64 operations per arrival on one thread; the bytes (the grid once,
// each row in and out once) and the rungs' operations take a few
// microseconds at K = 512.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRing = 1024;                 // largest batch size taken
constexpr int64_t kStageBytes = 192 * 1024;    // dynamic shared memory cap
// rows of up to this many arrivals are staged (their times and the
// admitted times, 2 T doubles); longer rows work on the global rows
constexpr int64_t kStageMaxT = kStageBytes / (2 * (int64_t)sizeof(double));

// the row's fields and the output's, in the wrapper's IN_FIELDS / OUT_FIELDS
enum { kTs, kPs, kPbud, kBud, kNom, kEst, kHi, kClock0, kLive, kPrev,
       kNTimes, kNCarry, kNIn };
enum { oSolved, oSel, oLam, oPower, oMode, oSwitch, oClockIn, oNRej,
       oNCarryRej, oNAdm, oNBatches, oClockOut, oRung, oRungs, kNOut };

struct Pick {
  double lam;
  int idx;
  bool ok;
};

// One rung for this block's device: the masked first-occurrence argmin of
// lam = (bs - 1) / ar + t*ts over the entries with p*ps <= pb,
// t*ts <= bs / b_h and lam <= b_l. Every thread returns the result.
__device__ Pick rung(const double* __restrict__ t,
                     const double* __restrict__ p,
                     const double* __restrict__ bsf, int N, double ts,
                     double ps, double pb, double ar, double b_h, double b_l,
                     double* s_lam, int* s_idx, int* s_ok) {
  double best = INFINITY;
  int bidx = INT_MAX;
  int ok = 0;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    const double tk = __dmul_rn(t[j], ts);
    const double pk = __dmul_rn(p[j], ps);
    const double lam = __dadd_rn(__ddiv_rn(__dsub_rn(bsf[j], 1.0), ar), tk);
    const bool feas = (pk <= pb) && (tk <= __ddiv_rn(bsf[j], b_h)) &&
                      (lam <= b_l);
    ok |= feas;
    if (feas && lam < best) {        // strict: the first occurrence stays
      best = lam;
      bidx = j;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const double ol = __shfl_down_sync(kFull, best, d);
    const int oi = __shfl_down_sync(kFull, bidx, d);
    if (ol < best || (ol == best && oi < bidx)) {
      best = ol;
      bidx = oi;
    }
  }
  ok = __any_sync(kFull, ok);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lam[w] = best;
    s_idx[w] = bidx;
    s_ok[w] = ok;
  }
  __syncthreads();
  Pick r{s_lam[0], s_idx[0], s_ok[0] != 0};
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    if (s_lam[i] < r.lam || (s_lam[i] == r.lam && s_idx[i] < r.idx)) {
      r.lam = s_lam[i];
      r.idx = s_idx[i];
    }
    r.ok = r.ok || s_ok[i] != 0;
  }
  __syncthreads();                   // the slots are free for the next rung
  if (r.lam == INFINITY) r.idx = 0;  // argmin over all +inf is entry 0
  return r;
}

__global__ void __launch_bounds__(kThreads)
fused_window_kernel(const double* __restrict__ t,
                    const double* __restrict__ p,
                    const double* __restrict__ bsf,
                    const int* __restrict__ mode_ids, int N,
                    const double* __restrict__ rows, double* __restrict__ out,
                    int T, double switch_cost, double adm_budget, int trims,
                    int max_bs, int staged) {
  extern __shared__ double s_stage[];           // staged: times, admitted
  __shared__ double s_lam[kWarps];
  __shared__ int s_idx[kWarps], s_ok[kWarps];
  __shared__ int s_ring[kMaxRing];
  __shared__ int s_nadm, s_nserved;

  const int64_t k = blockIdx.x;
  const double* row = rows + k * (kNIn + T);
  double* orow = out + k * (kNOut + 2 * (int64_t)T);
  const double* tv_g = row + kNIn;
  double* ct_g = orow + kNOut;
  double* lat_g = ct_g + T;

  const double ts = row[kTs], ps = row[kPs], pb = row[kPbud];
  const double bud = row[kBud], nom = row[kNom], est = row[kEst];
  const double hi = row[kHi], clock0 = row[kClock0];
  const bool live = row[kLive] != 0.0;
  const int prev = (int)row[kPrev];
  const int n = (int)row[kNTimes];
  const int n_carry = (int)row[kNCarry];

  // the ladder; each gate is this device's own
  bool solved = false;
  int sel = 0, won = 0, rungs = 0;
  double lam = INFINITY;
  const bool interval = live && hi > est;
  if (interval) {
    const Pick r = rung(t, p, bsf, N, ts, ps, pb, est, fmax(hi, est), bud,
                        s_lam, s_idx, s_ok);
    ++rungs;
    if (r.ok) { solved = true; sel = r.idx; lam = r.lam; won = 1; }
  }
  if (interval && !solved) {
    const Pick r = rung(t, p, bsf, N, ts, ps, pb, hi, hi, bud, s_lam, s_idx,
                        s_ok);
    ++rungs;
    if (r.ok) { solved = true; sel = r.idx; lam = r.lam; won = 2; }
  }
  const bool un12 = live && !solved;
  if (un12) {
    const Pick r = rung(t, p, bsf, N, ts, ps, pb, est, est, bud, s_lam,
                        s_idx, s_ok);
    ++rungs;
    if (r.ok) { solved = true; sel = r.idx; lam = r.lam; won = 3; }
  }
  if (un12 && !solved && bud < nom) {
    const Pick r = rung(t, p, bsf, N, ts, ps, pb, est, est, nom, s_lam,
                        s_idx, s_ok);
    ++rungs;
    if (r.ok) { solved = true; sel = r.idx; lam = r.lam; won = 4; }
  }

  const int bs = (int)bsf[sel];
  const double t_in = __dmul_rn(t[sel], ts);
  const double power = __dmul_rn(p[sel], ps);
  const int mode = mode_ids[sel];
  const double sw =
      (solved && prev >= 0 && mode != prev) ? switch_cost : 0.0;
  const double clock_in = __dadd_rn(clock0, sw);

  double* tv = const_cast<double*>(tv_g);
  double* ct = ct_g;
  if (solved && staged) {
    tv = s_stage;
    ct = s_stage + T;
    for (int i = threadIdx.x; i < n; i += kThreads) tv[i] = tv_g[i];
  } else if (solved && !trims) {
    for (int i = threadIdx.x; i < n; i += kThreads) ct_g[i] = tv_g[i];
  }
  __syncthreads();
  if (solved && !trims && staged) ct = tv;      // everything is admitted

  if (threadIdx.x == 0) {
    int n_adm = 0, n_rej = 0, n_carry_rej = 0, nb = 0;
    double c = clock_in;
    if (solved && trims) {
      // controller._admit_mask: members of the forming batch are
      // s_ring[(h + q) % max_bs], q < m
      const double thr = __dadd_rn(adm_budget, 1e-12);
      int h = 0, m = 0;
      for (int i = 0; i < n; ++i) {
        s_ring[(h + m) % max_bs] = i;
        if (++m < bs) continue;
        const double comp = __dadd_rn(fmax(c, tv[i]), t_in);
        while (m > 0) {
          const int j = s_ring[h % max_bs];
          if (!(__dsub_rn(comp, tv[j]) > thr)) break;
          ++n_rej;
          n_carry_rej += j < n_carry;
          ++h;
          --m;
        }
        if (m == bs) {                  // commit: its members are admitted
          for (int q = 0; q < bs; ++q) ct[n_adm++] = tv[s_ring[(h + q) % max_bs]];
          c = comp;
          m = 0;
        }
      }
      for (int q = 0; q < m; ++q) ct[n_adm++] = tv[s_ring[(h + q) % max_bs]];
    } else if (solved) {
      n_adm = n;
    }
    // the engine: c = max(c, ready_j) + t_in from clock_in over the
    // admitted batches; request i of batch j waits comp_j - ct[i]
    const int bsc = bs < 1 ? 1 : bs;
    nb = n_adm / bsc;
    c = clock_in;
    for (int j = 0; j < nb; ++j) {
      c = __dadd_rn(fmax(c, ct[(j + 1) * bsc - 1]), t_in);
      for (int q = j * bsc; q < (j + 1) * bsc; ++q)
        lat_g[q] = __dsub_rn(c, ct[q]);
    }
    s_nadm = n_adm;
    s_nserved = nb * bsc;
    orow[oSolved] = solved ? 1.0 : 0.0;
    orow[oSel] = (double)sel;
    orow[oLam] = lam;
    orow[oPower] = power;
    orow[oMode] = (double)mode;
    orow[oSwitch] = sw;
    orow[oClockIn] = clock_in;
    orow[oNRej] = (double)n_rej;
    orow[oNCarryRej] = (double)n_carry_rej;
    orow[oNAdm] = (double)n_adm;
    orow[oNBatches] = (double)nb;
    orow[oClockOut] = nb > 0 ? c : clock_in;
    orow[oRung] = (double)won;
    orow[oRungs] = (double)rungs;
  }
  __syncthreads();
  const int n_adm = s_nadm, n_served = s_nserved;
  for (int i = threadIdx.x; i < T; i += kThreads) {
    if (i >= n_adm) ct_g[i] = INFINITY;
    else if (ct != ct_g) ct_g[i] = ct[i];
    if (i >= n_served) lat_g[i] = INFINITY;
  }
}

}  // namespace

extern "C" int fused_window_launch(const void* t, const void* p,
                                   const void* bsf, const void* mode_ids,
                                   int64_t N, const void* rows, void* out,
                                   int64_t K, int64_t T, double switch_cost,
                                   double adm_budget, int trims, int max_bs,
                                   void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  if (N < 1 || N > INT_MAX || T < 0 || T > INT_MAX / 2 || max_bs < 1 ||
      max_bs > kMaxRing || K > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int staged = T <= kStageMaxT;
  const size_t smem = staged ? (size_t)(2 * T * sizeof(double)) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kStageBytes);
  if (err != cudaSuccess) return (int)err;
  fused_window_kernel<<<(unsigned)K, kThreads, smem, (cudaStream_t)stream>>>(
      (const double*)t, (const double*)p, (const double*)bsf,
      (const int*)mode_ids, (int)N, (const double*)rows, (double*)out, (int)T,
      switch_cost, adm_budget, trims, max_bs, staged);
  return (int)cudaGetLastError();
}

// The longest row staged in shared memory (tests size rows past it).
extern "C" int64_t fused_window_stage_max_t() { return kStageMaxT; }

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
