// Placement kernels for Hopper (sm_90a): batched per-net HPWL (K1) and the
// simulated-annealing chain with fused delta-HPWL rescoring (K2).
//
// K1 `net_hpwl_kernel` replaces the Pallas `_hpwl_kernel` (reference
// kernels/pnr_cost.py, `hpwl_pallas`) and its jnp twin `net_hpwl`: one
// thread per (row, net) reduces the net's pin bounding box with the same
// +-1e9 sentinels.  It reads each pin's entity, slot and slot coordinate
// once, so bytes bound it.
//
// K2 `anneal_kernel` replaces the `fori_loop` of `_build_batch_annealer` /
// `_build_annealer` (reference fabric/place.py) with the Pallas
// `_hpwl_delta_kernel` fused in: one warp anneals one chain for the whole
// sweep, holding the chain's slot_of, its inverse (occupant), the per-net
// costs and best_slot in shared memory.  Each step depends on the one
// before (the accepted swap changes what the next step reads), so the
// chain of dependent shared/global loads per step, not bytes, sets its
// pace; chains run in parallel across blocks.
//
// Arithmetic: every HPWL is an integer-valued float32 far below 2^24, so
// per-net costs, their sums and deltas are exact in any order; the
// Metropolis test `log_u * temp < cur - new` is one float32 multiply and
// one subtraction, as in the reference.  Build with --fmad=false.
//
// The C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define BIG 1e9f
#define CURVE_POINTS 16
#define MAX_TOUCH_PER_LANE 2   // 2K <= 64 touched nets per move

// HPWL of one net: pins/mask point at its D-wide rows.  With `swap`, the
// entities a and b are scored at each other's slot (the candidate move
// applied by select on pin ids, as the Pallas delta kernel does).
__device__ __forceinline__ float net_cost(
    const int* __restrict__ pins, const uint8_t* __restrict__ mask, int D,
    const int* slot_of, const float2* xy, bool swap, int a, int b, int sa,
    int sb) {
  float xmin = BIG, xmax = -BIG, ymin = BIG, ymax = -BIG;
  bool any = false;
  for (int d = 0; d < D; ++d) {
    if (!mask[d]) continue;
    int e = pins[d];
    int s = slot_of[e];
    if (swap) s = (e == a) ? sb : ((e == b) ? sa : s);
    float2 p = xy[s];
    xmin = fminf(xmin, p.x);
    xmax = fmaxf(xmax, p.x);
    ymin = fminf(ymin, p.y);
    ymax = fmaxf(ymax, p.y);
    any = true;
  }
  return any ? (xmax - xmin) + (ymax - ymin) : 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// K1: out[r, n] = HPWL of net n of problem prob[r] under slot_of[r].
__global__ void net_hpwl_kernel(int R, int N, int D, int E,
                                const int* __restrict__ prob,
                                const int* __restrict__ slot_of,
                                const float* __restrict__ slot_xy,
                                const int* __restrict__ net_pins,
                                const uint8_t* __restrict__ net_mask,
                                float* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * N) return;
  int r = (int)(idx / N), n = (int)(idx % N);
  long long p = prob[r];
  long long row = (p * N + n) * D;
  out[idx] = net_cost(net_pins + row, net_mask + row, D,
                      slot_of + (long long)r * E,
                      reinterpret_cast<const float2*>(slot_xy + p * E * 2),
                      false, 0, 0, 0, 0);
}

// K2: one warp per chain r (block r).  Streams a/t/log_u are per chain
// (R, S); temps/active per problem (P, S).
__global__ void anneal_kernel(
    int S, int N, int D, int E, int K, int full, int telemetry,
    const int* __restrict__ prob, const float* __restrict__ slot_xy,
    const int* __restrict__ net_pins, const uint8_t* __restrict__ net_mask,
    const int* __restrict__ ent_nets, const float* __restrict__ temps,
    const uint8_t* __restrict__ active, const int* __restrict__ A,
    const int* __restrict__ T, const float* __restrict__ log_u,
    const int* __restrict__ slot0, const float* __restrict__ pnc0,
    int* __restrict__ best_slot_out, float* __restrict__ best_out,
    int* __restrict__ accepts_out, float* __restrict__ curve_out) {
  extern __shared__ float4 smem4[];
  float2* xy = reinterpret_cast<float2*>(smem4);          // E
  int* slot_of = reinterpret_cast<int*>(xy + E);           // E
  int* occ = slot_of + E;                                  // E
  int* best_slot = occ + E;                                // E
  float* pnc = reinterpret_cast<float*>(best_slot + E);    // N
  float* curve = pnc + N;                                  // CURVE_POINTS

  const int r = blockIdx.x, lane = threadIdx.x;
  const long long p = prob[r];
  const int* pins_p = net_pins + p * N * D;
  const uint8_t* mask_p = net_mask + p * N * D;
  const int* en_p = ent_nets + p * E * K;
  const float* temps_p = temps + p * S;
  const uint8_t* active_p = active + p * S;
  const int* A_r = A + (long long)r * S;
  const int* T_r = T + (long long)r * S;
  const float* lu_r = log_u + (long long)r * S;

  for (int e = lane; e < E; e += 32) {
    int s = slot0[(long long)r * E + e];
    slot_of[e] = s;
    best_slot[e] = s;
    occ[s] = e;
    xy[e] = reinterpret_cast<const float2*>(slot_xy + p * E * 2)[e];
  }
  float part = 0.0f;
  for (int n = lane; n < N; n += 32) {
    float c = pnc0[(long long)r * N + n];
    pnc[n] = c;
    part += c;
  }
  if (lane < CURVE_POINTS) curve[lane] = 0.0f;
  float cur = warp_sum(part);      // exact: integer-valued costs
  float best = cur;
  int n_acc = 0;
  __syncwarp();

  const int T2 = 2 * K;
  for (int i = 0; i < S; ++i) {
    const int a = A_r[i], t = T_r[i];
    const int b = occ[t];
    const int sa = slot_of[a], sb = slot_of[b];
    float newc;
    int tn[MAX_TOUCH_PER_LANE];
    float nv[MAX_TOUCH_PER_LANE];
    if (full) {
      float acc = 0.0f;
      for (int n = lane; n < N; n += 32)
        acc += net_cost(pins_p + (long long)n * D, mask_p + (long long)n * D,
                        D, slot_of, xy, true, a, b, sa, sb);
      newc = warp_sum(acc);
    } else {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_TOUCH_PER_LANE; ++k) {
        int j = lane + 32 * k;
        tn[k] = N;
        nv[k] = 0.0f;
        if (j >= T2) continue;
        int n = (j < K) ? en_p[(long long)a * K + j]
                        : en_p[(long long)b * K + (j - K)];
        // a later duplicate of an earlier entry becomes N (dup_tri rule)
        for (int jj = 0; jj < j && n < N; ++jj) {
          int m = (jj < K) ? en_p[(long long)a * K + jj]
                           : en_p[(long long)b * K + (jj - K)];
          if (m == n) n = N;
        }
        if (n >= N) continue;
        tn[k] = n;
        nv[k] = net_cost(pins_p + (long long)n * D,
                         mask_p + (long long)n * D, D, slot_of, xy, true, a,
                         b, sa, sb);
        acc += nv[k] - pnc[n];
      }
      newc = cur + warp_sum(acc);
    }
    const bool accept = ((newc <= cur) || (lu_r[i] * temps_p[i] < cur - newc))
                        && active_p[i];
    __syncwarp();                  // every lane has read the pre-move state
    if (accept) {
      if (!full) {
#pragma unroll
        for (int k = 0; k < MAX_TOUCH_PER_LANE; ++k)
          if (tn[k] < N) pnc[tn[k]] = nv[k];
      }
      if (lane == 0) {
        slot_of[a] = sb;
        slot_of[b] = sa;
        occ[sb] = a;
        occ[sa] = b;
      }
      cur = newc;
    }
    __syncwarp();
    if (cur < best) {
      best = cur;
      for (int e = lane; e < E; e += 32) best_slot[e] = slot_of[e];
    }
    if (telemetry) {
      n_acc += accept ? 1 : 0;
      if (lane == 0) {
        int idx = (int)(((long long)i * CURVE_POINTS) / S);
        curve[idx < CURVE_POINTS - 1 ? idx : CURVE_POINTS - 1] = cur;
      }
    }
    __syncwarp();
  }

  for (int e = lane; e < E; e += 32)
    best_slot_out[(long long)r * E + e] = best_slot[e];
  if (lane == 0) {
    best_out[r] = best;
    if (telemetry) accepts_out[r] = n_acc;
  }
  if (telemetry && lane < CURVE_POINTS)
    curve_out[(long long)r * CURVE_POINTS + lane] = curve[lane];
}

extern "C" {

int pnr_net_hpwl(int R, int N, int D, int E, const void* prob,
                 const void* slot_of, const void* slot_xy,
                 const void* net_pins, const void* net_mask, void* out,
                 void* stream) {
  long long total = (long long)R * N;
  if (total > 0) {
    int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    net_hpwl_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        R, N, D, E, (const int*)prob, (const int*)slot_of,
        (const float*)slot_xy, (const int*)net_pins,
        (const uint8_t*)net_mask, (float*)out);
  }
  return (int)cudaGetLastError();
}

long long pnr_anneal_smem_bytes(int N, int E) {
  return (long long)E * 8 + (long long)E * 12 + (long long)N * 4
         + CURVE_POINTS * 4;
}

int pnr_anneal(int R, int S, int N, int D, int E, int K, int full,
               int telemetry, const void* prob, const void* slot_xy,
               const void* net_pins, const void* net_mask,
               const void* ent_nets, const void* temps, const void* active,
               const void* A, const void* T, const void* log_u,
               const void* slot0, const void* pnc0, void* best_slot,
               void* best, void* accepts, void* curve, void* stream) {
  long long smem = pnr_anneal_smem_bytes(N, E);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        anneal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    anneal_kernel<<<R, 32, (size_t)smem, (cudaStream_t)stream>>>(
        S, N, D, E, K, full, telemetry, (const int*)prob,
        (const float*)slot_xy, (const int*)net_pins,
        (const uint8_t*)net_mask, (const int*)ent_nets,
        (const float*)temps, (const uint8_t*)active, (const int*)A,
        (const int*)T, (const float*)log_u, (const int*)slot0,
        (const float*)pnc0, (int*)best_slot, (float*)best, (int*)accepts,
        (float*)curve);
  }
  return (int)cudaGetLastError();
}

const char* pnr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
