// Mamba2 SSD intra-chunk product for Hopper (sm_90a). Replaces the Pallas
// kernel repro/kernels/ssd_scan/ssd_scan.py::ssd_chunk (body
// _ssd_chunk_kernel).
//
// Per (batch*chunk bc, head hh), with cs the in-chunk cumulative sum of dA,
// G_ij = C_i . B_j and L_ij = exp(cs_i - cs_j) for j <= i (0 above):
//   y[i, :]  = sum_j M_ij x[j, :],   M_ij = G_ij L_ij dt_j
//   st[:, :] = sum_j B_j^T w_j x[j, :],   w_j = exp(cs_{l-1} - cs_j) dt_j
// Layouts (row-major, float32): x and y (bc, l, h, p); dA, dt (bc, l, h);
// B, C (bc, l, n), one SSM group shared by every head; st (bc, h, n, p).
//
// Design. G does not depend on the head, so a block owns (bc, one 64-row
// tile, a group of kGroup = 8 heads) and forms G once for its group; its
// 16 warps are 4 teams of 4, each warp one 16-row strip of the tile.
//  - Query blocks, per (query tile i, group, bc), the heaviest tiles first:
//    C_i and every key tile B_j, j <= i, arrive together; team tau forms
//    G_ij of the tau-th key tile for its four strips and keeps it in shared
//    memory in the mma accumulator's own layout (64 KB for four key
//    tiles). Then each team takes two of the group's heads: for each key
//    tile, the warp turns its strip's G fragments into M (exp, dt, and the
//    mask on the diagonal tile, there only up to the strip's last row) in
//    registers and multiplies by x_j, and writes its rows of y once.
//  - State blocks, per (64 state rows, group, bc), after the query blocks
//    of their (bc, group): B of the whole chunk in shared memory, w_j per
//    head; each team accumulates st = (B o w)^T x over every key tile for
//    its heads and writes it once. The state is a block of its own rather
//    than the last query tile's work, so no block does both the longest
//    y rows and the state. It costs a second read of x (268 MB at the
//    serving shape, mostly from L2) and of B (33.5 MB over the groups,
//    4.2 MB of it from device memory); the query blocks read x_j once per
//    query tile at or below it, 2.5 times in all.
// Every product is a warp's mma.sync.m16n8k8 in split TF32: each float32
// operand v is hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest
// as cvt.rna rounds (split_tf32, on the integer units), and the float32
// accumulator takes hi.hi + hi.lo + lo.hi. Plain TF32 would miss the 2e-4 /
// 1e-4 tolerance (tests/test_torch_ssd.py emulates both). wgmma takes TF32
// operands only K-major, and M x and (B o w)^T x contract over the tile's
// rows; mma.sync reads its fragments from shared memory at any index.
// Within each 8-wide step of a product a thread holds the reduction
// indices 2t and 2t + 1 (t = lane % 4) of both operands, a permutation of
// the instruction's t and t + 4 that leaves the sum as it is: G's
// accumulator fragment is then M's A fragment as it stands, and rows along
// the reduction load as float2. Row pads keep every fragment load free of
// bank conflicts (x rows p + 4 wide, C and B rows a multiple of 16 plus
// 8). Each team streams its x tiles through a one-tile cp.async buffer,
// synchronising only its own 128 threads (named barriers): the SM's other
// three teams hide a team's load (a second stage ran slower, PERF.md). The
// grid runs a (bc, group)'s blocks next to each other, so x_j, read by each
// query tile at or below it, comes from L2 after its first read. cs is
// formed per head in float64 and rounded once, as chunk_cumsum does. Above
// the diagonal the segment sum is positive and may overflow, so there exp
// takes -inf and gives 0.
//
// What bounds it: bytes, 621 MB at the serving shape (8, 8, 256, 64, 64,
// 64), 0.185 ms at 3.35 TB/s; its least work, 26.1 GFLOP, takes 0.158 ms
// as split TF32 (three products each at 495 TFLOP/s). The kernel issues
// more, 42.6 M mma.sync at that shape: G once per group (the diagonal tile
// whole), M x per head on five eighths of the diagonal tile, the state in
// full. mma.sync reaches about two thirds of the TF32 rate on this card,
// and each product carries its operands' splits, exp and fragment loads;
// one block per SM (512 threads at 113 registers; 178 KB of shared memory
// at that shape) leaves its prologue and the G phase unhidden (PERF.md).
#include "hopper.cuh"
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kT = 64;               // rows per tile (query and key)
constexpr int kTeams = 4;            // teams of 4 warps, one strip each
constexpr int kTeamThreads = 128;
constexpr int kThreads = kTeams * kTeamThreads;
constexpr int kGroup = 8;            // heads per block, one scan a warp
constexpr int kMaxL = 256;
constexpr int kMaxDim = 128;
constexpr int kLDS = kT + 4;         // padded row of the state block's B

struct Dims {
  int l, h, p, n;
  int pp, np;                        // p and n rounded up to 8
  int ldx, ldg;                      // padded rows of x and of C, B tiles
  int nt, groups, ns;                // tiles, head groups, state blocks
  int slots;                         // B tiles staged at once for G
};

// the in-chunk cumsum of dA and dt for the group's heads: warp w scans head
// g0 + w into cs[w][0, kMaxL) (zeros past l), accumulating in float64 and
// rounding once
__device__ void group_prefix(const float* dA, const float* dt, int64_t bc,
                             int g0, int ng, const Dims& dm, float* cs,
                             float* dts) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l = dm.l, h = dm.h;
  for (int e = threadIdx.x; e < ng * kMaxL; e += kThreads) {
    const int hq = e / kMaxL, i = e % kMaxL;
    dts[e] = i < l ? dt[(bc * l + i) * h + g0 + hq] : 0.f;
  }
  if (w >= ng) return;
  double v[kMaxL / 32];
  double run = 0.0;
#pragma unroll
  for (int u = 0; u < kMaxL / 32; ++u) {
    const int i = lane * (kMaxL / 32) + u;
    run += i < l ? (double)dA[(bc * l + i) * h + g0 + w] : 0.0;
    v[u] = run;
  }
  double tot = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, tot, d);
    if (lane >= d) tot += o;
  }
  const double off = tot - run;
#pragma unroll
  for (int u = 0; u < kMaxL / 32; ++u)
    cs[w * kMaxL + lane * (kMaxL / 32) + u] = (float)(v[u] + off);
}

// rows [r0, r0 + kT) of a row-major matrix (row stride `stride`) into dst
// [kT][ld] by cp.async (16-byte copies where `vec`): columns [0, cols) from
// src, columns [cols, pad) and rows at or past l as zeros. The `nthr`
// threads numbered `tid` share it; the caller commits, waits and syncs.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int l, int64_t stride,
                                           int cols, int pad, int ld,
                                           bool vec, int tid, int nthr) {
  if (vec) {                         // cols and pad multiples of 4
    const int q = pad / 4;
    for (int e = tid; e < kT * q; e += nthr) {
      const int r = e / q, c = 4 * (e % q);
      float* d = dst + r * ld + c;
      if (r0 + r < l && c < cols)
        hopper::cp_async16(d, src + (int64_t)(r0 + r) * stride + c);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  for (int e = tid; e < kT * pad; e += nthr) {
    const int r = e / pad, c = e % pad;
    float* d = dst + r * ld + c;
    if (r0 + r < l && c < cols)
      hopper::cp_async4(d, src + (int64_t)(r0 + r) * stride + c);
    else
      *d = 0.f;
  }
}

// stage_rows for a team's 64 x 64 x tile with 16-byte copies: each of the
// 128 threads copies the same 16 bytes of 8 rows, no division and no
// column checks
__device__ __forceinline__ void stage_x64(float* dst, const float* src,
                                          int r0, int l, int64_t stride,
                                          int ld, int tt) {
  const int r = tt >> 4, c = (tt & 15) << 2;
#pragma unroll
  for (int u = 0; u < kT / 8; ++u) {
    const int row = r + 8 * u;
    float* d = dst + row * ld + c;
    if (r0 + row < l)
      hopper::cp_async16(d, src + (int64_t)(r0 + row) * stride + c);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// acc += A B in split TF32 for one 8-wide reduction step: A's fragment
// (already split) against the 8-column tiles of B below pp (all PT of them
// where kFull), B read from shared memory rows r and r + 1 (the step's
// reduction indices 2t and 2t + 1 of this thread) of a [.][ld] tile. Up to
// eight tiles' fragments are split first and their three products issued
// tile after tile, so that no product waits on the one before it.
template <int PT, bool kFull>
__device__ __forceinline__ void mma_rows(float (&acc)[PT][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* X, int r, int ld,
                                         int pp, int g) {
  constexpr int kChunk = PT < 8 ? PT : 8;
#pragma unroll
  for (int c0 = 0; c0 < PT; c0 += kChunk) {
    if (!kFull && 8 * c0 >= pp) break;
    uint32_t bh[kChunk][2], bl[kChunk][2];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int pn = c0 + u;
      const bool live = kFull || 8 * pn < pp;
      const float b0 = live ? X[r * ld + 8 * pn + g] : 0.f;
      const float b1 = live ? X[(r + 1) * ld + 8 * pn + g] : 0.f;
      hopper::split_tf32(b0, bh[u][0], bl[u][0]);
      hopper::split_tf32(b1, bh[u][1], bl[u][1]);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) hopper::mma_tf32(acc[c0 + u], al, bh[u]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) hopper::mma_tf32(acc[c0 + u], ah, bl[u]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) hopper::mma_tf32(acc[c0 + u], ah, bh[u]);
  }
}

// one warp's 16 x p accumulator (rows r0 + g and r0 + g + 8 of a 64-row
// output whose row stride is `stride`) into out; rows past `rows` and
// columns past p are not written
template <int PT>
__device__ __forceinline__ void store_rows(float* out, int64_t stride,
                                           const float (&acc)[PT][4], int r0,
                                           int rows, int p, int g, int t) {
#pragma unroll
  for (int pn = 0; pn < PT; ++pn) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + g + 8 * u, c = 8 * pn + 2 * t;
      if (r >= rows || c >= p) continue;
      float* o = out + (int64_t)r * stride + c;
      if (c + 1 < p && (p & 1) == 0) {
        *reinterpret_cast<float2*>(o) =
            make_float2(acc[pn][2 * u], acc[pn][2 * u + 1]);
      } else {
        o[0] = acc[pn][2 * u];
        if (c + 1 < p) o[1] = acc[pn][2 * u + 1];
      }
    }
  }
}

template <int PT>
__device__ __forceinline__ void zero(float (&acc)[PT][4]) {
#pragma unroll
  for (int j = 0; j < PT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__host__ __device__ inline size_t r1_floats(const Dims& d) {
  return (size_t)d.nt * kT * kLDS;   // >= G's nt x 4 strips x 8 x 32 x 4
}
// the team buffers of x tiles, or C_i and dm.slots B_j while G is formed
__host__ __device__ inline size_t ring_floats(const Dims& d) {
  const size_t ring = (size_t)kTeams * kT * d.ldx;
  const size_t staging = (size_t)(1 + d.slots) * kT * d.ldg;
  return ring > staging ? ring : staging;
}
__host__ __device__ inline size_t smem_floats(const Dims& d) {
  return 2 * kGroup * kMaxL + r1_floats(d) + ring_floats(d);
}

// The team loop shared by both kinds of block: steps (head of the team,
// key tile jt in [0, tiles)), x_j of the step's head through the team's
// buffer; `step(hq, jt, X)` runs the products on the tile at X, and
// `done(hq)` writes a head's result after its last tile. The next tile's
// copy is issued once the team has consumed this one; each warp splits
// what it reads (one split per team and tile, shared through shared
// memory, measured slower: PERF.md).
template <bool kFull, typename Step, typename Done>
__device__ __forceinline__ void team_loop(const float* xb, int ng, int tiles,
                                          const Dims& dm, float* ring,
                                          bool vec_x, Step step, Done done) {
  const int team = threadIdx.x / kTeamThreads;
  const int tt = threadIdx.x % kTeamThreads;
  const int nh = ng > team ? (ng - team + kTeams - 1) / kTeams : 0;
  const int steps = nh * tiles;
  float* mine = ring + (size_t)team * kT * dm.ldx;
  const int64_t hs = (int64_t)dm.h * dm.p;
  auto issue = [&](int s) {
    const int hq = team + kTeams * (s / tiles);
    if (kFull && vec_x)
      stage_x64(mine, xb + (int64_t)hq * dm.p, (s % tiles) * kT, dm.l, hs,
                dm.ldx, tt);
    else
      stage_rows(mine, xb + (int64_t)hq * dm.p, (s % tiles) * kT, dm.l, hs,
                 dm.p, dm.pp, dm.ldx, vec_x, tt, kTeamThreads);
    hopper::cp_async_commit();
  };
  if (steps > 0) issue(0);
  for (int s = 0; s < steps; ++s) {
    hopper::cp_async_wait<0>();
    hopper::bar_sync(1 + team, kTeamThreads);
    const int hq = team + kTeams * (s / tiles), jt = s % tiles;
    step(hq, jt, mine);
    hopper::bar_sync(1 + team, kTeamThreads);   // this tile is consumed
    if (s + 1 < steps) issue(s + 1);
    if (jt == tiles - 1) done(hq);
  }
}

template <int PT, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ dt, const float* __restrict__ B,
                 const float* __restrict__ C, float* __restrict__ y,
                 float* __restrict__ st, Dims dm, bool vec_x, bool vec_bc) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);  // [kGroup][kMaxL]
  float* dts = cs + kGroup * kMaxL;              // dt, or w in state blocks
  float* R1 = dts + kGroup * kMaxL;              // G fragments, or B
  float* ring = R1 + r1_floats(dm);              // staging, then x tiles

  const int l = dm.l, h = dm.h, p = dm.p, n = dm.n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / 4, s = warp % 4, row0 = 16 * s;
  const int g = lane >> 2, t = lane & 3;
  const int grp = blockIdx.y;
  const int64_t bc = blockIdx.z;
  const int g0 = grp * kGroup, ng = min(kGroup, h - g0);
  const int64_t hs = (int64_t)h * p;
  const float* xb = x + bc * l * hs + (int64_t)g0 * p;
  float4* Gf = reinterpret_cast<float4*>(R1);    // [nt][4 strips][8][32]
  float acc[PT][4];
  zero(acc);

  group_prefix(dA, dt, bc, g0, ng, dm, cs, dts);

  if ((int)blockIdx.x < dm.nt) {
    // ---- query block: y for rows [i0, i0 + 64) of the group's heads ----
    const int it = dm.nt - 1 - blockIdx.x;      // heaviest tiles first
    const int i0 = it * kT;
    const bool rows_here = i0 + row0 < l;       // the strip has live rows
    // G_ij for the key tiles j <= i: C_i and dm.slots B_j (every tile
    // where n <= 64, as at the serving shape) arrive together; team
    // tau forms G of the round's tau-th tile for the warp's strip, all 8
    // column tiles at once (on the diagonal those past the strip's last row
    // are formed and never read)
    float* Cs = ring;                            // [kT][ldg]
    float* Bslots = ring + kT * dm.ldg;          // [slots][kT][ldg]
    const int slots = dm.slots;
    const float* Bb = B + bc * l * n;
    stage_rows(Cs, C + bc * l * n, i0, l, n, n, dm.np, dm.ldg, vec_bc,
               threadIdx.x, kThreads);
    for (int r0 = 0; r0 <= it; r0 += slots) {
      const int cnt = min(slots, it + 1 - r0);
      for (int u = 0; u < cnt; ++u)
        stage_rows(Bslots + u * kT * dm.ldg, Bb, (r0 + u) * kT, l, n, n,
                   dm.np, dm.ldg, vec_bc, threadIdx.x, kThreads);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
      if (team < cnt && rows_here) {
        const int jt = r0 + team;
        const float* Bs = Bslots + team * kT * dm.ldg;
        float d[8][4];
        zero(d);
        for (int k0 = 0; k0 < dm.np; k0 += 8) {
          const float* c0 = Cs + (row0 + g) * dm.ldg + k0 + 2 * t;
          const float2 ca = *reinterpret_cast<const float2*>(c0);
          const float2 cb = *reinterpret_cast<const float2*>(c0 + 8 * dm.ldg);
          uint32_t ah[4], al[4], bh[8][2], bl[8][2];
          hopper::split_tf32(ca.x, ah[0], al[0]);
          hopper::split_tf32(cb.x, ah[1], al[1]);
          hopper::split_tf32(ca.y, ah[2], al[2]);
          hopper::split_tf32(cb.y, ah[3], al[3]);
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            const float2 bv = *reinterpret_cast<const float2*>(
                Bs + (8 * jn + g) * dm.ldg + k0 + 2 * t);
            hopper::split_tf32(bv.x, bh[jn][0], bl[jn][0]);
            hopper::split_tf32(bv.y, bh[jn][1], bl[jn][1]);
          }
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) hopper::mma_tf32(d[jn], al, bh[jn]);
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) hopper::mma_tf32(d[jn], ah, bl[jn]);
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) hopper::mma_tf32(d[jn], ah, bh[jn]);
        }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
          Gf[((jt * 4 + s) * 8 + jn) * 32 + lane] =
              make_float4(d[jn][0], d[jn][1], d[jn][2], d[jn][3]);
      }
      __syncthreads();               // G stored; the slots are free
    }

    // per head of the team: y_i = sum_j M_ij x_j
    const int i_lo = i0 + row0 + g, i_hi = i_lo + 8;
    team_loop<kFull>(
        xb, ng, it + 1, dm, ring, vec_x,
        [&](int hq, int jt, const float* X) {
          if (!rows_here) return;
          const float* csh = cs + hq * kMaxL;
          const float* dth = dts + hq * kMaxL;
          const float ci_lo = csh[i_lo], ci_hi = csh[i_hi];
          const bool lo_live = i_lo < l, hi_live = i_hi < l;
          // M's A fragment for the step's key columns j, j + 1 and the rows
          // g, g + 8: below the diagonal tile every pair is live (rows past
          // l have G = 0 there, as C's rows past l are zeros)
          auto ksteps = [&](auto diag) {
            constexpr bool kDiag = decltype(diag)::value;
            const int steps = kDiag ? 2 * s + 2 : 8;
            for (int jn = 0; jn < steps; ++jn) {
              const float4 gv = Gf[((jt * 4 + s) * 8 + jn) * 32 + lane];
              const int j = jt * kT + 8 * jn + 2 * t;
              const float2 cj = *reinterpret_cast<const float2*>(csh + j);
              const float2 dj = *reinterpret_cast<const float2*>(dth + j);
              float a0 = ci_lo - cj.x, a1 = ci_lo - cj.y;
              float a2 = ci_hi - cj.x, a3 = ci_hi - cj.y;
              if (kDiag) {   // above it exp's argument is positive: -inf
                a0 = (lo_live && j <= i_lo) ? a0 : -INFINITY;
                a1 = (lo_live && j + 1 <= i_lo) ? a1 : -INFINITY;
                a2 = (hi_live && j <= i_hi) ? a2 : -INFINITY;
                a3 = (hi_live && j + 1 <= i_hi) ? a3 : -INFINITY;
              }
              const float m0 = gv.x * expf(a0) * dj.x;
              const float m1 = gv.y * expf(a1) * dj.y;
              const float m2 = gv.z * expf(a2) * dj.x;
              const float m3 = gv.w * expf(a3) * dj.y;
              uint32_t ah[4], al[4];
              hopper::split_tf32(m0, ah[0], al[0]);
              hopper::split_tf32(m2, ah[1], al[1]);
              hopper::split_tf32(m1, ah[2], al[2]);
              hopper::split_tf32(m3, ah[3], al[3]);
              mma_rows<PT, kFull>(acc, ah, al, X, 8 * jn + 2 * t, dm.ldx,
                                  dm.pp, g);
            }
          };
          if (jt == it) ksteps(std::true_type{});
          else ksteps(std::false_type{});
        },
        [&](int hq) {
          store_rows(y + (bc * l + i0) * hs + (int64_t)(g0 + hq) * p, hs,
                     acc, row0, l - i0, p, g, t);
          zero(acc);
        });
    return;
  }

  // ---- state block: st rows [k0, k0 + 64) of the group's heads ----------
  const int k0 = 64 * (blockIdx.x - dm.nt);
  const int kc = min(kT, n - k0);               // live state rows here
  float* Bs = R1;                                // [nt * kT][kLDS]
  for (int jt = 0; jt < dm.nt; ++jt)
    stage_rows(Bs + jt * kT * kLDS, B + bc * l * n + k0, jt * kT, l, n, kc,
               kT, kLDS, vec_bc, threadIdx.x, kThreads);
  hopper::cp_async_commit();
  __syncthreads();                   // cs and dt of every head are in
  for (int e = threadIdx.x; e < ng * kMaxL; e += kThreads) {
    const int hq = e / kMaxL, j = e % kMaxL;
    dts[e] = j < l ? expf(cs[hq * kMaxL + l - 1] - cs[e]) * dts[e] : 0.f;
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
  const bool rows_here = row0 < kc;
  team_loop<kFull>(
      xb, ng, dm.nt, dm, ring, vec_x,
      [&](int hq, int jt, const float* X) {
        if (!rows_here) return;
        const float* wh = dts + hq * kMaxL;
        const int j0 = jt * kT;
        const int steps = min(8, (l - j0 + 7) / 8);
        for (int kk = 0; kk < steps; ++kk) {
          const int r = 8 * kk + 2 * t;          // rows r, r + 1 of the tile
          const float2 w = *reinterpret_cast<const float2*>(wh + j0 + r);
          const float* b0 = Bs + (j0 + r) * kLDS + row0 + g;
          uint32_t ah[4], al[4];
          hopper::split_tf32(b0[0] * w.x, ah[0], al[0]);
          hopper::split_tf32(b0[8] * w.x, ah[1], al[1]);
          hopper::split_tf32(b0[kLDS] * w.y, ah[2], al[2]);
          hopper::split_tf32(b0[kLDS + 8] * w.y, ah[3], al[3]);
          mma_rows<PT, kFull>(acc, ah, al, X, r, dm.ldx, dm.pp, g);
        }
      },
      [&](int hq) {
        store_rows(st + ((bc * h + g0 + hq) * (int64_t)n + k0) * p, p, acc,
                   row0, kc, p, g, t);
        zero(acc);
      });
}

constexpr size_t kSmemMax = 232448;  // bytes a block may have on sm_90

Dims make_dims(int64_t l, int64_t h, int64_t p, int64_t n) {
  Dims d;
  d.l = (int)l;
  d.h = (int)h;
  d.p = (int)p;
  d.n = (int)n;
  d.pp = (int)((p + 7) / 8 * 8);
  d.np = (int)((n + 7) / 8 * 8);
  d.ldx = d.pp + 4;
  d.ldg = (d.np + 15) / 16 * 16 + 8;
  d.nt = (int)((l + kT - 1) / kT);
  d.groups = (int)((h + kGroup - 1) / kGroup);
  d.ns = (int)((n + kT - 1) / kT);
  // as many B tiles beside C_i as shared memory holds, up to one a team
  // (three at n = 128)
  const size_t tile = (size_t)kT * d.ldg;
  const size_t free = kSmemMax / sizeof(float) - 2 * kGroup * kMaxL -
                      r1_floats(d) - tile;
  d.slots = (int)(free / tile < kTeams ? free / tile : kTeams);
  return d;
}

template <int PT, bool kFull>
cudaError_t launch(const float* x, const float* dA, const float* dt,
                   const float* B, const float* C, float* y, float* st,
                   int64_t BC, const Dims& dm, bool vec_x, bool vec_bc,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(dm) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<PT, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(dm.nt + dm.ns), (unsigned)dm.groups,
                  (unsigned)BC);
  ssd_chunk_kernel<PT, kFull><<<grid, kThreads, smem, stream>>>(
      x, dA, dt, B, C, y, st, dm, vec_x, vec_bc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_chunk_launch(const void* x, const void* dA, const void* dt,
                                const void* B, const void* C, void* y,
                                void* st, int64_t BC, int64_t l, int64_t h,
                                int64_t p, int64_t n, void* stream) {
  if (BC <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0)
    return (int)cudaSuccess;
  if (l > kMaxL || p > kMaxDim || n > kMaxDim || BC > 65535 ||
      h > 65535LL * kGroup)
    return (int)cudaErrorInvalidValue;
  const Dims dm = make_dims(l, h, p, n);
  // 16-byte cp.async: rows of 4-multiples and 16-byte aligned bases
  const bool vec_x = p % 4 == 0 && (uintptr_t)x % 16 == 0;
  const bool vec_bc = n % 4 == 0 && (uintptr_t)B % 16 == 0 &&
                      (uintptr_t)C % 16 == 0;
  const auto args = [&](auto launcher) {
    return launcher((const float*)x, (const float*)dA, (const float*)dt,
                    (const float*)B, (const float*)C, (float*)y, (float*)st,
                    BC, dm, vec_x, vec_bc, (cudaStream_t)stream);
  };
  // p = 64 (the model's head dim) without column checks; any other p,
  // whose x rows end inside a tile, with them
  return (int)(p == 64 ? args(launch<8, true>) : args(launch<16, false>));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
