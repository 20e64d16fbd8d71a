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
// Design (the second; the first ran the admission, compaction and fold on
// one thread over a ring of member indices, 72-95% of its time): one block
// of 256 threads per device, at least four blocks an SM, so 512 devices
// run in one wave on the card's 132 SMs. Three parts:
//  * The ladder, one pass over the grid for every rung the device's gate
//    can reach (rungs 1 and 2 where hi > est, 3 where live, 4 where bud <
//    nominal too), one first strict minimum of lam per rung a thread.
//    Rungs 1, 3 and 4 share lam = (bs - 1) / est + t ts; rungs 1 and 2
//    share bs / hi (rung 1's bs / max(hi, est) is it wherever rung 1
//    runs), rungs 3 and 4 bs / est. The quotients come from per-block
//    tables of u / est and u / hi for u = 0..max_bs (max_bs <= kTableMax),
//    bitwise the division's, where bs is a whole number up to max_bs;
//    other entries divide. Each thread has two entries' columns in flight
//    at once. An entry over the power grant (every rung's first test) is
//    skipped. Warp shuffles, then one barrier for
//    all the rungs' (lam, index) pairs; every thread then walks the gate:
//    a rung counts in `rungs` only where the first design would have run
//    it, and a rung whose gate is closed reports as not run. Ties go to
//    the lower index (jnp.argmin's first occurrence); all-infeasible gives
//    index 0, lam = +inf, ok = false. Meanwhile cp.async stages the
//    device's arrival times (16-byte copies, the row's 8-byte offset kept).
//  * With admission, the walk, serial on one thread where bitwise
//    exactness demands it: controller._admit_mask's recurrence decides
//    each drop on the rounded completion of the commit before. The forming
//    batch is always a run of consecutive arrivals lo..i (pushes in
//    arrival order, drops from its front, a commit empties it), so a start
//    index replaces the ring of member indices, and a batch is judged only
//    where it fills, at i = lo + bs - 1. The walk chains the completions
//    comp = max(c, t[i]) + t_in of the next four batches as if each
//    committed, then judges their oldest members together: the batches
//    before the first that drops commit, and that one sheds its front.
//    Each commit records its first member and its completion, which is the
//    engine's fold's completion of that batch bit for bit (the fold
//    recomputes the same recurrence from the same clock over the admitted
//    batches; the reference says so at repro/core/controller.py:153-155).
//    Without admission, the fold by the whole block: each thread folds a
//    run of consecutive batches into one max-plus map c -> max(c + a, b),
//    the block scans the maps, and each thread replays its run from the
//    clock the scan gives it (the engine's tolerance tier, as the plain
//    version's doubling scan). The other warps meanwhile write the rows'
//    +inf tails past the device's n arrivals.
//  * The compaction and the latencies, written by the whole block from the
//    records: slot s < n_batches bs belongs to batch j = s / bs and holds
//    arrival lo_j + s % bs, its latency comp_j - t; the trailing partial
//    batch lo..n-1 follows, with +inf latencies. No thread walks the
//    arrivals a second time.
// Two routes by fused_window_route (the wrapper's route() is the same
// rule): "staged" (T <= kStageMaxT): the times, each commit's completion
// and its first member (uint16) in dynamic shared memory, 18 T + 8 bytes;
// "global" (longer
// rows): the walk reads the global row, the records go to the output
// row's first n_batches slots (lo_j as an exact double in the admitted
// times, comp_j in the latencies), and the block writes its slots a chunk
// at a time from the top, one barrier between a chunk's reads and its
// writes, so a record is read before its slot is written.
//
// Bitwise arithmetic: every float64 operation of the rungs, the switch
// charge and the admission is a correctly rounded intrinsic (__dmul_rn,
// __dadd_rn, __dsub_rn, __ddiv_rn), which nvcc never contracts into an FMA:
// tk = t * ts and lam = (bs - 1) / ar + tk would otherwise fuse, move lam by
// an ulp and flip argmins against the reference. fmax and the comparisons
// are exact.
//
// What bounds it: the bytes (the grid once, each row in and out once) and
// the rungs' operations take about a microsecond at K = 512. The ladder's
// pass waits on the grid's loads: one L2 latency per two entries a thread
// where the SMs are few (K = 64), and L2's bandwidth at K = 512, where
// every block reads the whole grid (512 x 53 KB in ~5 us). With
// admission, the walk's chain of dependent float64 operations runs once
// per batch judged, not once per arrival.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#ifdef KF_STAMPS
#define KF_STAMP_LABELS \
  "fields_and_tables,pass,reduction_and_staging,walk_or_fold," \
  "compaction_and_latencies"
#endif
// stamps: begin
#ifdef KF_STAMPS
// The diagnostic build (-DKF_STAMPS; tools/fused_window_split.py and
// chip_smoke.py's split) that the ordinary build never compiles: thread 0 of
// each of the first kStampBlocks blocks writes clock64() at the end of each
// part (slots 0-5) and the global timer (ns) at the first and the last
// stamp (slots 6 and 7).
constexpr int kStampBlocks = 4096, kStampSlots = 8;
__device__ long long g_kf_stamps[kStampBlocks * kStampSlots];
__device__ __forceinline__ void kf_stamp(int slot, int timer_slot) {
  if (threadIdx.x != 0 || blockIdx.x >= kStampBlocks) return;
  long long* s = g_kf_stamps + (long long)blockIdx.x * kStampSlots;
  s[slot] = clock64();
  if (timer_slot >= 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    s[timer_slot] = (long long)ns;
  }
}
#define KF_STAMP_BEGIN() kf_stamp(0, 6)
#define KF_STAMP(i) kf_stamp((i), -1)
#define KF_STAMP_END(i) \
  do {                  \
    __syncthreads();    \
    kf_stamp((i), 7);   \
  } while (0)
// the first `blocks` blocks' slots, to host memory (after a synchronize)
extern "C" int fused_window_stamps(void* host, int64_t blocks) {
  if (blocks > kStampBlocks) blocks = kStampBlocks;
  return (int)cudaMemcpyFromSymbol(host, g_kf_stamps,
                                   blocks * kStampSlots * sizeof(long long));
}
// the parts between consecutive clock stamps, comma-separated
extern "C" const char* fused_window_stamp_labels() { return KF_STAMP_LABELS; }
#else
#define KF_STAMP_BEGIN()
#define KF_STAMP(i)
#define KF_STAMP_END(i)
#endif
// stamps: end

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;                  // resident blocks an SM
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRungs = 4;
constexpr int kMaxBs = 1024;    // the largest max_bs taken (MAX_RING)
// per-block quotient tables up to this max_bs; past it every entry divides
constexpr int kTableMax = 256;
// rows of up to this many arrivals are staged in shared memory; longer
// rows work on the global rows
constexpr int64_t kStageMaxT = 12288;
// a staged row's dynamic shared memory: its times (one double more, for
// the 16-byte offset), each commit's completion (double) and first member
// (uint16: lo < kStageMaxT)
constexpr int64_t stage_bytes(int64_t T) { return 18 * T + 8; }

// the row's fields and the output's, in the wrapper's IN_FIELDS / OUT_FIELDS
enum { kTs, kPs, kPbud, kBud, kNom, kEst, kHi, kClock0, kLive, kPrev,
       kNTimes, kNCarry, kNIn };
enum { oSolved, oSel, oLam, oPower, oMode, oSwitch, oClockIn, oNRej,
       oNCarryRej, oNAdm, oNBatches, oClockOut, oRung, oRungs, kNOut };

// one rung's first-occurrence minimum of lam
struct Best {
  double lam;
  int idx;
};

// a thread's own entries come in ascending order: strict keeps the first
__device__ __forceinline__ void keep(Best& b, double lam, int j) {
  if (lam < b.lam) {
    b.lam = lam;
    b.idx = j;
  }
}

// two partial minima: the smaller lam, ties to the lower index
__device__ __forceinline__ void merge(Best& b, double lam, int idx) {
  if (lam < b.lam || (lam == b.lam && idx < b.idx)) {
    b.lam = lam;
    b.idx = idx;
  }
}

// cp.async: begin
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// cp.async: end

// What the walk leaves: batches committed, the trailing batch's first
// member, the drops, and the last completion (the clock if none).
struct Walk {
  int nb, lo, n_rej, n_carry_rej;
  double c;
};

// controller._admit_mask's recurrence over arrivals tv[0, n), from clock
// c, batches of bs >= 1: commit j's first member goes to los[j], its
// completion to comps[j]. From the forming batch's start lo it chains the
// completions of the next kAhead batches as if each committed (the serial
// recurrence's own operations in its order), then judges their oldest
// members together: the batches before the first that drops commit, and
// that one drops its front members one by one.
template <typename Lo>
__device__ Walk walk(const double* tv, int n, int bs, double c, double t_in,
                     double thr, int n_carry, double* comps, Lo* los) {
  constexpr int kAhead = 4;
  Walk w{0, 0, 0, 0, c};
  while (w.lo + bs - 1 < n) {
    double comp[kAhead];
    int filled = 0;                    // batches of the group that fill
    double cc = w.c;
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int i = w.lo + (q + 1) * bs - 1;
      comp[q] = cc = __dadd_rn(fmax(cc, tv[min(i, n - 1)]), t_in);
      filled += i < n;
    }
    int drop = filled;                 // the first batch that drops
#pragma unroll
    for (int q = kAhead - 1; q >= 0; --q)
      if (q < filled &&
          __dsub_rn(comp[q], tv[min(w.lo + q * bs, n - 1)]) > thr)
        drop = q;
    double cd = w.c;                   // the dropping batch's completion
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      if (q < drop) {
        comps[w.nb + q] = comp[q];
        los[w.nb + q] = (Lo)(w.lo + q * bs);
        w.c = comp[q];
      } else if (q == drop) {
        cd = comp[q];
      }
    }
    w.nb += drop;
    w.lo += drop * bs;
    if (drop < filled) {
      // the oldest members whose wait passes the budget leave the batch
      const int i = w.lo + bs - 1;
      int l = w.lo + 1;
      while (l <= i && __dsub_rn(cd, tv[l]) > thr) ++l;
      w.n_rej += l - w.lo;
      w.n_carry_rej += max(0, min(l, n_carry) - w.lo);
      w.lo = l;
    }
  }
  return w;
}

// a max-plus map c -> max(c + a, b); one batch's is (t_in, t_last + t_in)
struct Map {
  double a, b;
};

// f then g
__device__ __forceinline__ Map then(Map f, Map g) {
  return Map{__dadd_rn(f.a, g.a), fmax(__dadd_rn(f.b, g.a), g.b)};
}

// The engine's fold without admission, by the whole block: nb batches of
// bs, batch j's last member tv[(j + 1) bs - 1]. Each thread folds a run of
// consecutive batches into one map, the block scans the runs' maps (warp
// shuffles, then the warps' through s_map), and each thread replays its
// run from the clock the scan gives it, one batch after another, writing
// comps[j] and los[j] = j bs. Within a run the completions are the serial
// fold's; across runs they meet it within the engine tolerance. All
// threads call it; it holds one barrier.
template <typename Lo>
__device__ void fold(const double* tv, int nb, int bs, double clock_in,
                     double t_in, double* comps, Lo* los, Map* s_map) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int run = (nb + kThreads - 1) / kThreads;
  const int j0 = min(nb, tid * run), j1 = min(nb, j0 + run);
  Map m{0.0, -INFINITY};                          // the identity
  for (int j = j0; j < j1; ++j)
    m = then(m, Map{t_in, __dadd_rn(tv[(j + 1) * bs - 1], t_in)});
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {              // inclusive, in the warp
    const Map o{__shfl_up_sync(kFull, m.a, d), __shfl_up_sync(kFull, m.b, d)};
    if (lane >= d) m = then(o, m);
  }
  if (lane == 31) s_map[w] = m;
  Map pre{__shfl_up_sync(kFull, m.a, 1), __shfl_up_sync(kFull, m.b, 1)};
  if (lane == 0) pre = Map{0.0, -INFINITY};
  __syncthreads();
  Map before{0.0, -INFINITY};                     // the warps before this
  for (int v = 0; v < w; ++v) before = then(before, s_map[v]);
  pre = then(before, pre);
  double c = fmax(__dadd_rn(clock_in, pre.a), pre.b);
  for (int j = j0; j < j1; ++j) {
    c = __dadd_rn(fmax(c, tv[(j + 1) * bs - 1]), t_in);
    comps[j] = c;
    los[j] = (Lo)(j * bs);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_window_kernel(const double* __restrict__ t,
                    const double* __restrict__ p,
                    const double* __restrict__ bsf,
                    const int* __restrict__ mode_ids, int N,
                    const double* __restrict__ rows, double* __restrict__ out,
                    int T, double switch_cost, double adm_budget, int trims,
                    int max_bs) {
  extern __shared__ __align__(16) double s_stage[];
  __shared__ double s_q[2][kTableMax + 1];       // u / est, u / hi
  __shared__ double s_lam[kRungs][kWarps];
  __shared__ int s_idx[kRungs][kWarps];
  __shared__ unsigned s_ok[kWarps];
  __shared__ Map s_map[kWarps];
  __shared__ int s_walk[4];
  __shared__ double s_clock_out;
  KF_STAMP_BEGIN();

  const int tid = threadIdx.x;
  const int64_t k = blockIdx.x;
  const double* row = rows + k * (kNIn + (int64_t)T);
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
  const bool interval = live && hi > est;        // rungs 1 and 2
  const bool tight = live && bud < nom;          // rung 4
  const bool tabled = max_bs <= kTableMax;

  // the staged times keep the row's offset from 16 bytes, so the copies
  // past its first element are 16 bytes wide
  const int head = (int)(((uintptr_t)tv_g >> 3) & 1);
  double* tv_s = s_stage + head;
  double* s_comp = s_stage + T + 1;
  uint16_t* s_lo = reinterpret_cast<uint16_t*>(s_comp + T);
  if (kStaged && live && n > 0) {
    const int h = min(head, n);
    for (int q = tid; q < (n - h) / 2; q += kThreads)
      cp_async16(tv_s + h + 2 * q, tv_g + h + 2 * q);
    if (tid == 0 && h) cp_async8(tv_s, tv_g);
    if (tid == kThreads - 1 && ((n - h) & 1))
      cp_async8(tv_s + n - 1, tv_g + n - 1);
  }
  if (live && tabled) {
    for (int u = tid; u <= max_bs; u += kThreads) {
      s_q[0][u] = __ddiv_rn((double)u, est);
      if (interval) s_q[1][u] = __ddiv_rn((double)u, hi);
    }
  }
  __syncthreads();                     // the quotient tables
  KF_STAMP(1);

  // the ladder's one pass; every gate is this device's own, so every
  // thread of the block takes the same branches
  Best best[kRungs];
#pragma unroll
  for (int r = 0; r < kRungs; ++r) best[r] = Best{INFINITY, INT_MAX};
  unsigned ok = 0;                               // bit r: rung r feasible
  if (live) {
    // one entry: its quotients from the tables where bs is a whole number
    // up to max_bs (bs - 1 is then exact), else divided here
    auto entry = [&](int j, double tj, double pj, double b) {
      const double tk = __dmul_rn(tj, ts);
      const double pk = __dmul_rn(pj, ps);
      if (!(pk <= pb)) return;                   // every rung's first test
      double de, qe, dh = 0.0, qh = 0.0;
      const int v = tabled && b >= 1.0 && b <= (double)max_bs ? (int)b : 0;
      if (v > 0 && (double)v == b) {
        de = s_q[0][v];
        qe = s_q[0][v - 1];
        if (interval) {
          dh = s_q[1][v];
          qh = s_q[1][v - 1];
        }
      } else {
        const double a = __dsub_rn(b, 1.0);
        de = __ddiv_rn(b, est);
        qe = __ddiv_rn(a, est);
        if (interval) {
          dh = __ddiv_rn(b, hi);
          qh = __ddiv_rn(a, hi);
        }
      }
      const double lam_e = __dadd_rn(qe, tk);
      if (tk <= de) {                            // rungs 3 and 4
        if (lam_e <= bud) {
          ok |= 4u;
          keep(best[2], lam_e, j);
        }
        if (tight && lam_e <= nom) {
          ok |= 8u;
          keep(best[3], lam_e, j);
        }
      }
      if (interval && tk <= dh) {                // rungs 1 and 2
        if (lam_e <= bud) {
          ok |= 1u;
          keep(best[0], lam_e, j);
        }
        const double lam_h = __dadd_rn(qh, tk);
        if (lam_h <= bud) {
          ok |= 2u;
          keep(best[1], lam_h, j);
        }
      }
    };
    // two entries' columns in flight at once, taken in ascending order
    for (int j = tid; j < N; j += 2 * kThreads) {
      const int j2 = j + kThreads;
      const double t0 = t[j], p0 = p[j], b0 = bsf[j];
      double t1 = 0.0, p1 = 0.0, b1 = 0.0;
      if (j2 < N) {
        t1 = t[j2];
        p1 = p[j2];
        b1 = bsf[j2];
      }
      entry(j, t0, p0, b0);
      if (j2 < N) entry(j2, t1, p1, b1);
    }
    KF_STAMP(2);
    const unsigned reach = (interval ? 3u : 0u) | 4u | (tight ? 8u : 0u);
#pragma unroll
    for (int r = 0; r < kRungs; ++r) {
      if (!(reach >> r & 1u)) continue;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const double ol = __shfl_down_sync(kFull, best[r].lam, d);
        const int oi = __shfl_down_sync(kFull, best[r].idx, d);
        merge(best[r], ol, oi);
      }
    }
    ok = __reduce_or_sync(kFull, ok);
    if ((tid & 31) == 0) {
      const int w = tid >> 5;
#pragma unroll
      for (int r = 0; r < kRungs; ++r) {
        s_lam[r][w] = best[r].lam;
        s_idx[r][w] = best[r].idx;
      }
      s_ok[w] = ok;
    }
  } else {
    KF_STAMP(2);
  }
  if (kStaged) cp_async_wait_all();
  __syncthreads();                     // the warps' pairs, the staged times
  KF_STAMP(3);

  // the gate, in the first design's order
  bool solved = false;
  int sel = 0, won = 0, rungs = 0;
  double lam = INFINITY;
  if (live) {
    unsigned okb = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) okb |= s_ok[w];
    const bool gate[kRungs] = {interval, interval, true, tight};
#pragma unroll
    for (int r = 0; r < kRungs; ++r) {
      if (solved || !gate[r]) continue;
      ++rungs;
      if (okb >> r & 1u) {
        Best b{s_lam[r][0], s_idx[r][0]};
#pragma unroll
        for (int w = 1; w < kWarps; ++w) merge(b, s_lam[r][w], s_idx[r][w]);
        solved = true;
        won = r + 1;
        sel = b.lam == INFINITY ? 0 : b.idx;   // argmin over all +inf: 0
        lam = b.lam;
      }
    }
  }

  const int bs = (int)bsf[sel];
  const int bsc = bs < 1 ? 1 : bs;
  const double t_in = __dmul_rn(t[sel], ts);
  const double power = __dmul_rn(p[sel], ps);
  const int mode = mode_ids[sel];
  const double sw =
      (solved && prev >= 0 && mode != prev) ? switch_cost : 0.0;
  const double clock_in = __dadd_rn(clock0, sw);
  const double* tv = kStaged ? tv_s : tv_g;

  // the +inf tails past the n arrivals: warps 1-7 while thread 0 walks,
  // else every thread
  const bool walking = solved && trims;
  if (!walking || tid >= 32) {
    const int from = walking ? tid - 32 : tid;
    const int step = walking ? kThreads - 32 : kThreads;
    for (int i = n + from; i < T; i += step) {
      ct_g[i] = INFINITY;
      lat_g[i] = INFINITY;
    }
  }
  if (walking) {
    if (tid == 0) {
      const double thr = __dadd_rn(adm_budget, 1e-12);
      const Walk w =
          kStaged ? walk(tv_s, n, bsc, clock_in, t_in, thr, n_carry, s_comp,
                         s_lo)
                  : walk(tv_g, n, bsc, clock_in, t_in, thr, n_carry, lat_g,
                         ct_g);
      s_walk[0] = w.nb;
      s_walk[1] = w.lo;
      s_walk[2] = w.n_rej;
      s_walk[3] = w.n_carry_rej;
      s_clock_out = w.c;
    }
  } else if (solved) {
    const int nb = n / bsc;
    if (kStaged)
      fold(tv, nb, bsc, clock_in, t_in, s_comp, s_lo, s_map);
    else
      fold(tv, nb, bsc, clock_in, t_in, lat_g, ct_g, s_map);
    if (tid == 0) {
      s_walk[0] = nb;
      s_walk[1] = nb * bsc;
      s_walk[2] = s_walk[3] = 0;
    }
    if (nb > 0 && tid == (nb - 1) / ((nb + kThreads - 1) / kThreads))
      s_clock_out = kStaged ? s_comp[nb - 1] : lat_g[nb - 1];
  } else if (tid == 0) {
    s_walk[0] = s_walk[1] = s_walk[2] = s_walk[3] = 0;
  }
  KF_STAMP(4);
  __syncthreads();                     // the records and the counts

  const int nb = s_walk[0], lo_end = s_walk[1];
  const int n_adm = solved ? nb * bsc + (n - lo_end) : 0;
  const int n_served = nb * bsc;
  if (tid == 0) {
    orow[oSolved] = solved ? 1.0 : 0.0;
    orow[oSel] = (double)sel;
    orow[oLam] = lam;
    orow[oPower] = power;
    orow[oMode] = (double)mode;
    orow[oSwitch] = sw;
    orow[oClockIn] = clock_in;
    orow[oNRej] = (double)s_walk[2];
    orow[oNCarryRej] = (double)s_walk[3];
    orow[oNAdm] = (double)n_adm;
    orow[oNBatches] = (double)nb;
    orow[oClockOut] = nb > 0 ? s_clock_out : clock_in;
    orow[oRung] = (double)won;
    orow[oRungs] = (double)rungs;
  }
  // from the top chunk down: a chunk's slots read records of lower slots
  // only, so on the global route a chunk's writes wait for its reads alone
  for (int base = n > 0 ? (n - 1) / kThreads * kThreads : -1; base >= 0;
       base -= kThreads) {
    const int s = base + tid;
    double ct = INFINITY, lt = INFINITY;
    if (s < n_served) {
      const int j = s / bsc;
      const int lo_j = kStaged ? (int)s_lo[j] : (int)ct_g[j];
      const double comp = kStaged ? s_comp[j] : lat_g[j];
      ct = tv[lo_j + (s - j * bsc)];
      lt = __dsub_rn(comp, ct);
    } else if (s < n_adm) {
      ct = tv[lo_end + (s - n_served)];
    }
    if (!kStaged) __syncthreads();
    if (s < n) {
      ct_g[s] = ct;
      lat_g[s] = lt;
    }
  }
  KF_STAMP_END(5);
}

}  // namespace

// The route rows of T arrivals take: 0 staged, 1 global (the wrapper's
// route() applies the same rule; K, N and max_bs do not move it).
extern "C" int fused_window_route(int64_t K, int64_t T, int64_t N,
                                  int max_bs) {
  (void)K;
  (void)N;
  (void)max_bs;
  return T <= kStageMaxT ? 0 : 1;
}

extern "C" int fused_window_launch(const void* t, const void* p,
                                   const void* bsf, const void* mode_ids,
                                   int64_t N, const void* rows, void* out,
                                   int64_t K, int64_t T, double switch_cost,
                                   double adm_budget, int trims, int max_bs,
                                   void* stream) {
  if (K <= 0) return (int)cudaSuccess;
  if (N < 1 || N > INT_MAX || T < 0 || T > INT_MAX / 2 || max_bs < 1 ||
      max_bs > kMaxBs || K > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fused_window_route(K, T, N, max_bs) == 0) {
    const size_t smem = (size_t)stage_bytes(T);
    if (smem > 48 * 1024) {
      // past the default 48 KB: raised once a device, not once a launch
      static std::atomic<uint64_t> raised{0};
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err != cudaSuccess) return (int)err;
      const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
      if (!(raised.load() & bit)) {
        err = cudaFuncSetAttribute(fused_window_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)stage_bytes(kStageMaxT));
        if (err != cudaSuccess) return (int)err;
        raised.fetch_or(bit);
      }
    }
    fused_window_kernel<true><<<(unsigned)K, kThreads, smem, s>>>(
        (const double*)t, (const double*)p, (const double*)bsf,
        (const int*)mode_ids, (int)N, (const double*)rows, (double*)out,
        (int)T, switch_cost, adm_budget, trims, max_bs);
  } else {
    fused_window_kernel<false><<<(unsigned)K, kThreads, 0, s>>>(
        (const double*)t, (const double*)p, (const double*)bsf,
        (const int*)mode_ids, (int)N, (const double*)rows, (double*)out,
        (int)T, switch_cost, adm_budget, trims, max_bs);
  }
  return (int)cudaGetLastError();
}

// The longest row staged in shared memory (tests size rows past it).
extern "C" int64_t fused_window_stage_max_t() { return kStageMaxT; }

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
