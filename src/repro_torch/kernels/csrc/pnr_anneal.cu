// Placement kernel for Hopper (sm_90a): the simulated-annealing chain with
// fused delta-HPWL rescoring (K2), whose prologue scores the chain's start
// (the per-net HPWL of K1).
//
// K2 `anneal_kernel` replaces the `fori_loop` of `_build_batch_annealer` /
// `_build_annealer` (reference fabric/place.py) with the Pallas
// `_hpwl_delta_kernel` fused in: one warp anneals one chain for the whole
// sweep.  Each step depends on the one before (the accepted swap changes
// what the next step reads), so the latency of one step's chain of
// dependent loads and reductions, not bytes, sets its pace.  The design
// shortens that chain:
// - a block runs one chain (one warp) and stages its problem's read-only
//   tables in shared memory: the pin table (per net its pin count, then
//   its pins, masked pins dropped; built by the wrapper), the fixed boxes
//   (hierarchical sub-problems only), ent_nets and slot_xy.  The chain
//   keeps its slot_of, its inverse (occupant) and its per-net costs there.
//   A block whose tables do not fit beside its chain reads them from
//   global memory, and a chain whose own state does not fit (more than
//   227 KB: the grouped path's 128x128 buckets, the 256x256 deblock) keeps
//   that state in a global scratch too (`chain_g`, one row a chain);
// - duplicate touched nets go in one __match_any_sync: the lowest lane of
//   a match group keeps the net, the reference's rule that a later
//   duplicate becomes N (dup_tri);
// - a net's count and first 7 pins arrive in two 16-byte loads;
// - the move stream is loaded 32 steps at a time, a step a lane, a chunk
//   ahead, and broadcast with shuffles;
// - the best placement is written out when the chain leaves it, not at
//   every improvement.
//
// K1, the Pallas `_hpwl_kernel` (reference kernels/pnr_cost.py,
// `hpwl_pallas`; its jnp twin `net_hpwl` scores the annealer's start), has
// no launch of its own: its whole job is the starting per-net costs that
// K2 reads, and K2 already holds the staged pin table and the chain's
// per-net costs.  So K2's prologue scores them, a net a lane, with the
// rescoring's own `row_cost`; a launch alone would cost microseconds
// against K1's bytes bound of 45 ns at the image suite's largest
// problem.  `pnc0_out`, when not null, receives them (for the checks
// against the plain version).
//
// The reference's entry points on this source: `hpwl_pallas` and
// `hpwl_batched` are one zero-step launch of K2 (its prologue scores the
// placements; `xy_chain` gives each chain its own slot coordinates), and
// `hpwl_delta_pallas` is `swap_delta_kernel`: one warp rescoring a given
// list of nets with `row_cost`.
//
// Fixed boxes (the hierarchical placer's cluster-local problems): each net
// carries [xmin, xmax, ymin, ymax] of its pins outside the sub-problem,
// folded into the bounding box; a net with no movable pin scores its box
// when the box is not empty (xmin <= xmax).  The box is a template
// parameter: without boxes every step is the flat path's code, load for
// load.
//
// Arithmetic: coordinates are integers and box corners integers or
// half-integers (a cluster's centre, origin + (rw - 1) / 2), so every
// HPWL is a multiple of 0.5.  float32 holds every multiple of 0.5 below
// 2^23 exactly, so while a chain's total cost stays below 2^22 its
// per-net costs, sums in any order and deltas (|new - cur| < 2^23) are
// exact, and equal the reference's; min/max are exact at any size.  The
// Metropolis test `log_u * temp < cur - new` is one float32 multiply and
// one subtraction, as in the reference.  Build with --fmad=false.
//
// The C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define BIG 1e9f
#define CURVE_POINTS 16
#define MAX_TOUCH_PER_LANE 2   // 2K <= 64 touched nets per move
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// HPWL of the net whose pin-table row is `row` (row[0] = pin count c,
// row[1..c] = its entities; rows 16-byte aligned, at least 8 wide), with
// a and b scored at each other's slot, and with FIX its fixed box `*box`
// folded in.  Pins past the count stand in for the first pin, which leaves
// the box as it is: every load of a group goes out at once, with no branch.
template <bool FIX>
__device__ __forceinline__ float row_cost(const int* __restrict__ row,
                                          const float4* __restrict__ box,
                                          const int* slot_of,
                                          const float2* __restrict__ xy,
                                          int a, int b, int sa, int sb) {
  const int4 h0 = reinterpret_cast<const int4*>(row)[0];
  const int4 h1 = reinterpret_cast<const int4*>(row)[1];
  float4 f;
  if (FIX) f = *box;
  const int cnt = h0.x;
  if (cnt == 0) {
    // the reference's fold from its +-1e9 sentinels; an empty box (min >
    // max) scores 0
    if (!FIX || !(f.x <= f.y)) return 0.0f;
    return (fmaxf(-BIG, f.y) - fminf(BIG, f.x))
         + (fmaxf(-BIG, f.w) - fminf(BIG, f.z));
  }
  auto at = [&](int e) {
    int s = slot_of[e];
    s = (e == a) ? sb : ((e == b) ? sa : s);
    return xy[s];
  };
  int e[7] = {h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
  for (int d = 1; d < 7; ++d) e[d] = d < cnt ? e[d] : e[0];
  float2 p[7];
#pragma unroll
  for (int d = 0; d < 7; ++d) p[d] = at(e[d]);
  float xmin = p[0].x, xmax = p[0].x, ymin = p[0].y, ymax = p[0].y;
#pragma unroll
  for (int d = 1; d < 7; ++d) {
    xmin = fminf(xmin, p[d].x);
    xmax = fmaxf(xmax, p[d].x);
    ymin = fminf(ymin, p[d].y);
    ymax = fmaxf(ymax, p[d].y);
  }
  for (int base = 8; base <= cnt; base += 4) {
    const int4 h = reinterpret_cast<const int4*>(row + base)[0];
    const int more[4] = {h.x, base + 1 <= cnt ? h.y : e[0],
                         base + 2 <= cnt ? h.z : e[0],
                         base + 3 <= cnt ? h.w : e[0]};
    float2 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = at(more[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xmin = fminf(xmin, q[u].x);
      xmax = fmaxf(xmax, q[u].x);
      ymin = fminf(ymin, q[u].y);
      ymax = fmaxf(ymax, q[u].y);
    }
  }
  if (FIX) {
    xmin = fminf(xmin, f.x);
    xmax = fmaxf(xmax, f.y);
    ymin = fminf(ymin, f.z);
    ymax = fmaxf(ymax, f.w);
  }
  return (xmax - xmin) + (ymax - ymin);
}

// One chain's sweep (warp-wide).  tab/fix/en/xy: the problem's tables
// (shared or global memory; fix read only with FIX); slot_of/occ/pnc: the
// chain's state (shared memory, or its row of the global scratch).  The
// prologue scores the start into pnc (and pnc0_r when not null).  TPL:
// touched-net slots per lane (2K <= 32 * TPL).
template <int TPL, bool FIX>
__device__ __forceinline__ void sweep(
    int S, int N, int W, int K, int E, int full, int telemetry, int lane,
    const int* __restrict__ tab, const float4* __restrict__ fix,
    const int* __restrict__ en, const float2* __restrict__ xy,
    const float* __restrict__ temps_p, const uint8_t* __restrict__ active_p,
    const int* __restrict__ A_r, const int* __restrict__ T_r,
    const float* __restrict__ lu_r, int* slot_of, int* occ, float* pnc,
    float* __restrict__ pnc0_r, int* __restrict__ best_slot_r,
    float* __restrict__ best_r, int* __restrict__ accepts_r,
    float* __restrict__ curve_r) {
  // prologue: the start's per-net costs, a net a lane; a = b = -1 matches
  // no entity, so every pin sits at its own slot
  float part = 0.0f;
  for (int n = lane; n < N; n += 32) {
    const float c = row_cost<FIX>(tab + (long long)n * W, fix + n, slot_of,
                                  xy, -1, -1, 0, 0);
    pnc[n] = c;
    if (pnc0_r != nullptr) pnc0_r[n] = c;
    part += c;
  }
  float cur = warp_sum(part);     // exact: multiples of 0.5 below 2^22
  __syncwarp();                   // every lane's pnc is written

  const int T2 = 2 * K;
  const unsigned below = (1u << lane) - 1u;
  float best = cur;
  bool best_here = true;      // the best placement is slot_of, not written
  int n_acc = 0;
  float curve_v = 0.0f;       // lane c < CURVE_POINTS holds point c

  // the move stream, a step a lane: this chunk and the next
  int ca, ct, cact, na, nt, nact;
  float clu, ctmp, nlu, ntmp;
  auto fetch = [&](int i0, int& fa, int& ft, float& flu, float& ftmp,
                   int& fact) {
    const int i = i0 + lane;
    const bool in = i < S;
    fa = in ? A_r[i] : 0;
    ft = in ? T_r[i] : 0;
    flu = in ? lu_r[i] : 0.0f;
    ftmp = in ? temps_p[i] : 0.0f;
    fact = in ? active_p[i] : 0;
  };
  fetch(0, ca, ct, clu, ctmp, cact);
  fetch(32, na, nt, nlu, ntmp, nact);

  for (int i0 = 0; i0 < S; i0 += 32) {
    const int steps = min(32, S - i0);
    for (int u = 0; u < steps; ++u) {
      const int a = __shfl_sync(FULL_MASK, ca, u);
      const int t = __shfl_sync(FULL_MASK, ct, u);
      const int b = occ[t];
      const int sa = slot_of[a], sb = slot_of[b];
      float newc;
      int tn[TPL];
      float nv[TPL];
      if (full) {
        float acc = 0.0f;
        for (int n = lane; n < N; n += 32)
          acc += row_cost<FIX>(tab + (long long)n * W, fix + n, slot_of, xy,
                               a, b, sa, sb);
        newc = warp_sum(acc);
#pragma unroll
        for (int k = 0; k < TPL; ++k) tn[k] = N;
      } else {
        int nn[TPL];
        bool keep[TPL];
#pragma unroll
        for (int k = 0; k < TPL; ++k) {
          const int j = lane + 32 * k;
          nn[k] = j < T2 ? ((j < K) ? en[(long long)a * K + j]
                                    : en[(long long)b * K + (j - K)])
                         : N;
          // the first occurrence of a net keeps it (dup_tri rule)
          const unsigned grp = __match_any_sync(FULL_MASK, nn[k]);
          keep[k] = nn[k] < N && (grp & below) == 0u;
        }
        if (TPL == 2) {         // entries 32.. also lose to entries 0..31
          for (int src = 0; src < 32; ++src) {
            const int v = __shfl_sync(FULL_MASK, nn[0], src);   // all lanes
            if (v == nn[TPL - 1]) keep[TPL - 1] = false;
          }
        }
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < TPL; ++k) {
          tn[k] = keep[k] ? nn[k] : N;
          nv[k] = 0.0f;
          if (keep[k]) {
            nv[k] = row_cost<FIX>(tab + (long long)nn[k] * W, fix + nn[k],
                                  slot_of, xy, a, b, sa, sb);
            acc += nv[k] - pnc[nn[k]];
          }
        }
        newc = cur + warp_sum(acc);
      }
      const float lu = __shfl_sync(FULL_MASK, clu, u);
      const float tmp = __shfl_sync(FULL_MASK, ctmp, u);
      const int act = __shfl_sync(FULL_MASK, cact, u);
      const bool accept = ((newc <= cur) || (lu * tmp < cur - newc)) && act;
      __syncwarp();                // every lane has read the pre-move state
      if (accept) {
        if (best_here && !(newc < best)) {
          // leaving the best placement: write it out before the swap
          for (int e = lane; e < E; e += 32) best_slot_r[e] = slot_of[e];
          best_here = false;
          __syncwarp();
        }
#pragma unroll
        for (int k = 0; k < TPL; ++k)
          if (tn[k] < N) pnc[tn[k]] = nv[k];
        if (lane == 0) {
          slot_of[a] = sb;
          slot_of[b] = sa;
          occ[sb] = a;
          occ[sa] = b;
        }
        cur = newc;
        if (cur < best) {
          best = cur;
          best_here = true;
        }
      }
      if (telemetry) {
        n_acc += accept ? 1 : 0;
        const int idx = (int)(((long long)(i0 + u) * CURVE_POINTS) / S);
        if (lane == min(idx, CURVE_POINTS - 1)) curve_v = cur;
      }
      __syncwarp();
    }
    ca = na;
    ct = nt;
    clu = nlu;
    ctmp = ntmp;
    cact = nact;
    fetch(i0 + 64, na, nt, nlu, ntmp, nact);
  }

  if (best_here)
    for (int e = lane; e < E; e += 32) best_slot_r[e] = slot_of[e];
  if (lane == 0) {
    *best_r = best;
    if (telemetry) *accepts_r = n_acc;
  }
  if (telemetry && lane < CURVE_POINTS) curve_r[lane] = curve_v;
}

// K2: one chain r a block (blockDim.x = 32).  pin_tab (P, N, W): per net
// [count, pins..., -1...]; net_fix (P, N, 4) with FIX.  Streams a/t/log_u
// are per chain (R, S); temps/active per problem (P, S).  slot_xy is per
// problem (P, E, 2), or with `xy_chain` per chain (R, E, 2): R placements
// of one problem scored by a zero-step launch (hpwl_batched).  With
// `stage`, the chain's problem's tables are copied to shared memory.
template <bool FIX>
__global__ void anneal_kernel(
    int S, int N, int W, int E, int K, int stage, int full, int telemetry,
    int xy_chain, const int* __restrict__ prob,
    const float* __restrict__ slot_xy,
    const int* __restrict__ pin_tab, const int* __restrict__ ent_nets,
    const float* __restrict__ temps, const uint8_t* __restrict__ active,
    const int* __restrict__ A, const int* __restrict__ T,
    const float* __restrict__ log_u, const int* __restrict__ slot0,
    const float* __restrict__ net_fix, int* __restrict__ chain_g,
    float* __restrict__ pnc0_out, int* __restrict__ best_slot_out,
    float* __restrict__ best_out, int* __restrict__ accepts_out,
    float* __restrict__ curve_out) {
  extern __shared__ int4 smem_i4[];
  const int r = blockIdx.x, lane = threadIdx.x;
  const long long p = prob[r];
  const int* tab_g = pin_tab + p * N * W;
  const float4* fix_g =
      FIX ? reinterpret_cast<const float4*>(net_fix + p * N * 4) : nullptr;
  const int* en_g = ent_nets + p * E * K;
  const float2* xy_g = reinterpret_cast<const float2*>(
      slot_xy + (xy_chain ? (long long)r : p) * E * 2);
  // [pin table N*W | boxes N (FIX) | xy E | ent_nets E*K] (if staged), then
  // the chain's [slot_of E | occ E | pnc N]
  const bool fs = FIX && stage;
  int* tab_s = reinterpret_cast<int*>(smem_i4);
  float4* fix_s = reinterpret_cast<float4*>(tab_s + (stage ? N * W : 0));
  float2* xy_s = reinterpret_cast<float2*>(fix_s + (fs ? N : 0));
  int* en_s = reinterpret_cast<int*>(xy_s + (stage ? E : 0));
  int* slot_of = en_s + (stage ? E * K : 0);
  int* occ = slot_of + E;
  float* pnc = reinterpret_cast<float*>(occ + E);
  const float* temps_p = temps + p * S;
  const uint8_t* active_p = active + p * S;
  const int* A_r = A + (long long)r * S;
  const int* T_r = T + (long long)r * S;
  const float* lu_r = log_u + (long long)r * S;
  float* pnc0_r = pnc0_out ? pnc0_out + (long long)r * N : nullptr;
  int* bs_r = best_slot_out + (long long)r * E;
  float* curve_r = curve_out + (long long)r * CURVE_POINTS;
  if (chain_g != nullptr) {
    // the chain's state in its row of the global scratch (nothing staged:
    // the tables are larger still); its own copies of the sweep
    int* slot_g = chain_g + (long long)r * (2LL * E + N);
    int* occ_g = slot_g + E;
    float* pnc_g = reinterpret_cast<float*>(occ_g + E);
    for (int e = lane; e < E; e += 32) {
      const int s = slot0[(long long)r * E + e];
      slot_g[e] = s;
      occ_g[s] = e;
    }
    __syncwarp();
    if (2 * K <= 32)
      sweep<1, FIX>(S, N, W, K, E, full, telemetry, lane, tab_g, fix_g, en_g,
                    xy_g, temps_p, active_p, A_r, T_r, lu_r, slot_g, occ_g,
                    pnc_g, pnc0_r, bs_r, best_out + r, accepts_out + r,
                    curve_r);
    else
      sweep<2, FIX>(S, N, W, K, E, full, telemetry, lane, tab_g, fix_g, en_g,
                    xy_g, temps_p, active_p, A_r, T_r, lu_r, slot_g, occ_g,
                    pnc_g, pnc0_r, bs_r, best_out + r, accepts_out + r,
                    curve_r);
    return;
  }
  if (stage) {
    const int4* src = reinterpret_cast<const int4*>(tab_g);
    for (int i = lane; i < N * W / 4; i += 32)
      reinterpret_cast<int4*>(tab_s)[i] = src[i];
    if (FIX)
      for (int i = lane; i < N; i += 32) fix_s[i] = fix_g[i];
    for (int i = lane; i < E; i += 32) xy_s[i] = xy_g[i];
    for (int i = lane; i < E * K; i += 32) en_s[i] = en_g[i];
  }
  for (int e = lane; e < E; e += 32) {
    const int s = slot0[(long long)r * E + e];
    slot_of[e] = s;
    occ[s] = e;
  }
  __syncwarp();                  // the staged tables and slot_of

  // four inlined copies: the compiler reads the staged tables with
  // shared-memory loads in the first two
  if (stage && 2 * K <= 32)
    sweep<1, FIX>(S, N, W, K, E, full, telemetry, lane, tab_s, fix_s, en_s,
                  xy_s, temps_p, active_p, A_r, T_r, lu_r, slot_of, occ, pnc,
                  pnc0_r, bs_r, best_out + r, accepts_out + r, curve_r);
  else if (stage)
    sweep<2, FIX>(S, N, W, K, E, full, telemetry, lane, tab_s, fix_s, en_s,
                  xy_s, temps_p, active_p, A_r, T_r, lu_r, slot_of, occ, pnc,
                  pnc0_r, bs_r, best_out + r, accepts_out + r, curve_r);
  else if (2 * K <= 32)
    sweep<1, FIX>(S, N, W, K, E, full, telemetry, lane, tab_g, fix_g, en_g,
                  xy_g, temps_p, active_p, A_r, T_r, lu_r, slot_of, occ, pnc,
                  pnc0_r, bs_r, best_out + r, accepts_out + r, curve_r);
  else
    sweep<2, FIX>(S, N, W, K, E, full, telemetry, lane, tab_g, fix_g, en_g,
                  xy_g, temps_p, active_p, A_r, T_r, lu_r, slot_of, occ, pnc,
                  pnc0_r, bs_r, best_out + r, accepts_out + r, curve_r);
}

// The delta of one swap over a given list of nets (the reference's Pallas
// `_hpwl_delta_kernel`, `hpwl_delta_pallas`): one warp, a touched net a
// lane, each rescored by K2's own `row_cost` with entities ab[0] and ab[1]
// at each other's slot.  touched (T,): net ids, entries outside [0, N)
// padding (new 0, old 0; the wrapper refuses negative ones); new_out (T,)
// the rescored costs, delta_out the sum of new - per_net[net] over the
// list, duplicates counted each time, as the reference counts them.
__global__ void swap_delta_kernel(
    int T, int N, int W, const float* __restrict__ slot_xy,
    const int* __restrict__ slot_of, const int* __restrict__ pin_tab,
    const float* __restrict__ per_net, const int* __restrict__ touched,
    const int* __restrict__ ab, float* __restrict__ new_out,
    float* __restrict__ delta_out) {
  const int lane = threadIdx.x;
  const int a = ab[0], b = ab[1];
  const int sa = slot_of[a], sb = slot_of[b];
  const float2* xy = reinterpret_cast<const float2*>(slot_xy);
  float acc = 0.0f;
  for (int t = lane; t < T; t += 32) {
    const int n = touched[t];
    float c = 0.0f;
    if (n >= 0 && n < N) {
      c = row_cost<false>(pin_tab + (long long)n * W, nullptr, slot_of, xy,
                          a, b, sa, sb);
      acc += c - per_net[n];
    }
    new_out[t] = c;
  }
  acc = warp_sum(acc);
  if (lane == 0) *delta_out = acc;
}

extern "C" {

// K2's shared memory: the staged tables (if `stage`; the boxes too with
// `fix`) and one chain's state (if `chain`; else it lives in the global
// scratch, (2E + N) int32 a chain).
long long pnr_anneal_smem_bytes(int N, int W, int E, int K, int stage,
                                int fix, int chain) {
  long long tables = stage ? ((long long)N * W + (fix ? 4LL * N : 0)
                              + (long long)E * 2 + (long long)E * K) * 4
                           : 0;
  return tables + (chain ? (2LL * E + N) * 4 : 0);
}

int pnr_anneal(int R, int S, int N, int W, int E, int K, int stage, int full,
               int telemetry, int xy_chain, const void* prob,
               const void* slot_xy,
               const void* pin_tab, const void* ent_nets, const void* temps,
               const void* active, const void* A, const void* T,
               const void* log_u, const void* slot0, const void* net_fix,
               void* chain_g, void* pnc0_out, void* best_slot, void* best,
               void* accepts, void* curve, void* stream) {
  // delta scoring keeps MAX_TOUCH_PER_LANE touched nets a lane; the
  // wrapper asks for full scoring above that.  A chain in the global
  // scratch stages nothing.
  if ((!full && 2 * K > 32 * MAX_TOUCH_PER_LANE) || (chain_g && stage))
    return (int)cudaErrorInvalidValue;
  const bool fix = net_fix != nullptr;
  auto kernel = fix ? anneal_kernel<true> : anneal_kernel<false>;
  long long smem = pnr_anneal_smem_bytes(N, W, E, K, stage, fix,
                                         chain_g == nullptr);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    kernel<<<R, 32, (size_t)smem, (cudaStream_t)stream>>>(
        S, N, W, E, K, stage, full, telemetry, xy_chain, (const int*)prob,
        (const float*)slot_xy, (const int*)pin_tab, (const int*)ent_nets,
        (const float*)temps, (const uint8_t*)active, (const int*)A,
        (const int*)T, (const float*)log_u, (const int*)slot0,
        (const float*)net_fix, (int*)chain_g, (float*)pnc0_out,
        (int*)best_slot, (float*)best, (int*)accepts, (float*)curve);
  }
  return (int)cudaGetLastError();
}

int pnr_swap_delta(int T, int N, int W, const void* slot_xy,
                   const void* slot_of, const void* pin_tab,
                   const void* per_net, const void* touched, const void* ab,
                   void* new_out, void* delta_out, void* stream) {
  swap_delta_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      T, N, W, (const float*)slot_xy, (const int*)slot_of,
      (const int*)pin_tab, (const float*)per_net, (const int*)touched,
      (const int*)ab, (float*)new_out, (float*)delta_out);
  return (int)cudaGetLastError();
}

const char* pnr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
