// Cycle-stepper kernel of the cycle-accurate simulator for Hopper (sm_90a):
// K3 `sim_stepper_kernel`.
//
// It replaces the vmapped `lax.scan` of the reference's batched simulator
// (sim/cycle.py, `_build_batch_stepper`) and, inside it, the Pallas
// compute-all-select ALU step (kernels/sim_step.py, `_build_step_kernel`,
// masked as `alu_step_masked`), which is the device function `alu` below.
// One block runs one (program, input row) through every cycle of the
// bucket, keeping the machine state resident for the whole run: the
// ext/sig registers, double-buffered wire registers, the latch FIFOs and
// the operand buffer [latch view | const | tmp].  The state lives in
// shared memory, or, when it exceeds the 227 KB a block can opt into (or
// the caller asks for it), in a global scratch buffer: the same kernel
// body either way.
//
// Bound: a chain of dependent cycles, each three block barriers, sets the
// pace; bytes and operations are far below it.  So the design shortens a
// cycle:
// - Events, not tests.  An entity (tile, signal, ext, latch or output
//   capture) with first event t0 fires at t0 + k*II for k < K, so only
//   those with t0 = c (mod II) can fire at cycle c.  The wrapper sorts
//   them once into per-phase lists of (index, t0 div II) (event_lists in
//   sim_step.py); cycle c = m*II + b walks list b and fires the entries
//   with 0 <= m - (t0 div II) < K, at k = m - (t0 div II): no division
//   and no test of an entity of another phase.  A tile that does not fire
//   at c computes nothing: its results reach the machine only through the
//   signals it owns, which load only when it fires (the wrapper checks
//   that a signal reads its owner's tmp slots).
// - ext and sig registers change only at their events, so they are single
//   buffers written after the cycle's readers (phase A of the next cycle);
//   wires still copy every cycle, double-buffered.
// - A micro-op is one 16-byte table entry {global op id, 3 operands}: the
//   wrapper folds the bucket's opcode table into it.
// - Up to 1024 threads a block, so a phase has few iterations a thread.
//
// The block stages its program's event lists in shared memory, beside
// the state.  Per cycle c, three barriers: (A) the signals and exts
// loaded at c - 1 take their values, and the tiles firing at c refresh
// the latch views they read (the FIFO slot of the iteration their latch's
// consumer executes); (B) the tiles firing at c run their micro-ops in
// order, one thread a tile (tmp rebuilt from zeros; operands read only
// the tile's own tmp slots, checked by the wrapper); (C) every wire loads
// from the old state into the other buffer, arriving words enter the
// latch FIFOs, outputs are captured straight to global memory.  With
// `empty` set the loop keeps its barriers and walks its event lists but
// moves no value: the floor of a cycle.
//
// Arithmetic follows the JAX package's simulator under XLA's CPU backend
// bit for bit on every IEEE-exact op: NaN-propagating min/max with -0 < +0,
// sign keeping -0 and NaN, round half to even, 2**b exact for integer b.
// mac rounds as XLA compiles it: one fused multiply-add when the op table
// lacks mul (OP_MAC), the product rounded and then the sum when it holds
// mul (OP_MAC2; the wrapper picks the id, kernel_op_ids in sim_step.py).
// Build with --fmad=false and without fast math so nothing else is
// contracted or approximated.
//
// `alu_step_kernel` is the reference's free-standing Pallas step
// (`alu_step_pallas`): the same `alu` over caller-given lanes.
//
// The C entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_THREADS 1024
#define SMEM_LIMIT 232448

// global op ids: the order of ALU_IMPLS in kernels/sim_step.py
enum AluOp {
  OP_NOP, OP_ADD, OP_SUB, OP_NEG, OP_ABS, OP_MUL, OP_MAC, OP_DIV, OP_RECIP,
  OP_SHL, OP_SHR, OP_ASHR, OP_EQ, OP_NEQ, OP_LT, OP_LTE, OP_GT, OP_GTE,
  OP_MIN, OP_MAX, OP_AND, OP_OR, OP_XOR, OP_NOT, OP_SIGN, OP_SEL, OP_FLOOR,
  OP_ROUND, OP_EXP, OP_LOG, OP_TANH, OP_SIGMOID, OP_RSQRT, OP_SQRT, OP_POW,
  N_OPS
};

// ids past the table: mac with its product rounded first
// (sim_step.py OP_MAC2)
enum { OP_MAC2 = N_OPS };

// event kinds, the order of the wrapper's lists (sim_step.py EVENT_KINDS)
enum EvKind { EV_TILE, EV_SIG, EV_EXT, EV_LATCH, EV_OUT, N_EV };

// 2**b: exact for integer b (from the exponent bits), powf otherwise.
__device__ __forceinline__ float pow2f(float b) {
  if (!(b == floorf(b))) return powf(2.0f, b);     // NaN lands here too
  if (b > 127.0f) return INFINITY;
  if (b < -149.0f) return 0.0f;
  int n = (int)b;
  return n >= -126 ? __int_as_float((n + 127) << 23)
                   : __int_as_float(1 << (n + 149));
}

__device__ __forceinline__ float xmin(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ float xmax(float a, float b) {
  if (isnan(a) || isnan(b)) return a + b;
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

__device__ __forceinline__ float pred(bool p) { return p ? 1.0f : 0.0f; }

// One ALU op of the static table (nop and unknown ids -> 0.0).
__device__ float alu(int op, float a, float b, float c) {
  switch (op) {
    case OP_ADD: return a + b;
    case OP_SUB: return a - b;
    case OP_NEG: return -a;
    case OP_ABS: return fabsf(a);
    case OP_MUL: return a * b;
    case OP_MAC: return __fmaf_rn(a, b, c);
    case OP_MAC2: return __fadd_rn(__fmul_rn(a, b), c);
    case OP_DIV: return a / b;
    case OP_RECIP: return 1.0f / a;
    case OP_SHL: return a * pow2f(b);
    case OP_SHR:
    case OP_ASHR: return a / pow2f(b);
    case OP_EQ: return pred(a == b);
    case OP_NEQ: return pred(a != b);
    case OP_LT: return pred(a < b);
    case OP_LTE: return pred(a <= b);
    case OP_GT: return pred(a > b);
    case OP_GTE: return pred(a >= b);
    case OP_MIN: return xmin(a, b);
    case OP_MAX: return xmax(a, b);
    case OP_AND: return pred(a != 0.0f && b != 0.0f);
    case OP_OR: return pred(a != 0.0f || b != 0.0f);
    case OP_XOR: return pred((a != 0.0f) != (b != 0.0f));
    case OP_NOT: return pred(a == 0.0f);
    case OP_SIGN: return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
    case OP_SEL: return a != 0.0f ? c : b;
    case OP_FLOOR: return floorf(a);
    case OP_ROUND: return rintf(a);
    case OP_EXP: return expf(a);
    case OP_LOG: return logf(a);
    case OP_TANH: return tanhf(a);
    case OP_SIGMOID: return 1.0f / (1.0f + expf(-a));
    case OP_RSQRT: return rsqrtf(a);
    case OP_SQRT: return sqrtf(a);
    case OP_POW: return powf(a, b);
    default: return 0.0f;
  }
}

struct Args {
  int B, K, cycles, D, ip, up, ep, sp, wp, lp, cp, op, nb, ev_cap;
  long long state_floats;
  int use_global, empty;
  const int* ii;           // (G,)
  const int* dims;         // (G, 2): n_steps, n_inst
  const int4* steps;       // (G, ip, up): {op id, a, b, c}
  const float* const_pool; // (G, cp)
  const int* fire_time;    // (G, ip)
  const int* wire_src;     // (G, wp)
  const int* sig_tmp;      // (G, sp)
  const int* latch_wire;   // (G, lp)
  const int* latch_owner;  // (G, lp)
  const int* out_wire;     // (G, op)
  const int2* ev;          // event entries {index, t0 div II}; at most
                           // ev_cap of them a program
  const int* ev_off;       // (N_EV, G, nb): list b of program g is
                           // ev[o[b] .. o[b + 1])
  const float* inputs;     // (G, B, K, ep)
  float* outbuf;           // (G, B, K, op)
  float* scratch;          // global state (use_global)
};

__global__ void __launch_bounds__(MAX_THREADS)
sim_stepper_kernel(const Args a) {
  extern __shared__ float smem[];
  const int g = blockIdx.x / a.B;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = a.K, D = a.D, up = a.up, sp = a.sp, ep = a.ep;
  const int lp = a.lp, cp = a.cp, wp = a.wp, op = a.op;
  float* st = a.use_global
                  ? a.scratch + (long long)blockIdx.x * a.state_floats
                  : smem;
  float* ext = st;
  float* sig = ext + ep;
  float* wire = sig + sp;
  float* wire_n = wire + wp;
  float* latch = wire_n + wp;          // lp x D
  float* opnd = latch + lp * D;        // [latch view lp | const cp | tmp]
  const int tmp_off = lp + cp;

  const int ii = a.ii[g];
  const int n_steps = min(a.dims[2 * g], up);
  const int4* steps = a.steps + (long long)g * a.ip * up;
  const float* const_pool = a.const_pool + (long long)g * cp;
  const int* fire_time = a.fire_time + (long long)g * a.ip;
  const int* wire_src = a.wire_src + (long long)g * wp;
  const int* sig_tmp = a.sig_tmp + (long long)g * sp;
  const int* latch_wire = a.latch_wire + (long long)g * lp;
  const int* latch_owner = a.latch_owner + (long long)g * lp;
  const int* out_wire = a.out_wire + (long long)g * op;
  const float* in_row = a.inputs + (long long)blockIdx.x * K * ep;
  float* out_row = a.outbuf + (long long)blockIdx.x * K * op;
  const int G = gridDim.x / a.B, nb = a.nb;
  const bool live = !a.empty;

  // this program's event lists, staged in shared memory after the state
  // (or alone): entries ev_s, list b of kind j at off_s[j * nb + b]
  int2* ev_s = reinterpret_cast<int2*>(
      smem + (a.use_global ? 0 : (a.state_floats + 1) / 2 * 2));
  int* off_s = reinterpret_cast<int*>(ev_s + a.ev_cap);
  for (int j = 0, base = 0; j < N_EV; ++j) {
    const int* o = a.ev_off + ((long long)j * G + g) * nb;
    const int first = o[0], n_j = o[nb - 1] - first;
    for (int b = tid; b < nb; b += nt) off_s[j * nb + b] = o[b] - first + base;
    for (int e = tid; e < n_j; e += nt) ev_s[base + e] = a.ev[first + e];
    base += n_j;
  }

  // every entry of phase list b of `kind` firing at iteration m: f(x, k)
  auto walk = [&](int kind, int b, int m, auto&& f) {
    const int* o = off_s + kind * nb + b;
    for (int e = o[0] + tid; e < o[1]; e += nt) {
      const int2 v = ev_s[e];
      const int k = m - v.y;
      if (k >= 0 && k < K && live) f(v.x, k);
    }
  };

  // all state zero, constants in place (they are never overwritten)
  const long long const_at = (long long)(opnd - st) + lp;
  for (long long i = tid; i < a.state_floats; i += nt) {
    long long j = i - const_at;
    st[i] = (j >= 0 && j < cp) ? const_pool[j] : 0.0f;
  }
  __syncthreads();

  int b = 0, m = 0, pb = 0, pm = 0;    // cycle c = m * ii + b; c - 1
  for (int c = 0; c < a.cycles; ++c) {
    // (A) registers loaded at c - 1; latch views of the tiles firing at c
    if (c > 0) {
      walk(EV_SIG, pb, pm, [&](int s, int) {
        sig[s] = opnd[tmp_off + sig_tmp[s]];
      });
      walk(EV_EXT, pb, pm, [&](int e, int k) {
        ext[e] = in_row[(long long)k * ep + e];
      });
    }
    walk(EV_TILE, b, m, [&](int i, int) {
      for (int u = 0; u < n_steps; ++u) {
        const int4 s = steps[i * up + u];
        const int src[3] = {s.y, s.z, s.w};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int l = src[j];
          if (l >= lp) continue;
          // the slot of the iteration the latch's consumer executes; C's
          // truncating `/` differs from floor only for d < 0, clipped to
          // 0 either way
          const int d = c - fire_time[latch_owner[l]];
          const int q = d / ii;
          const int kv = q < 0 ? 0 : (q > K - 1 ? K - 1 : q);
          opnd[l] = latch[l * D + kv % D];
        }
      }
    });
    __syncthreads();

    // (B) the tiles firing at c, each its micro-ops in order
    walk(EV_TILE, b, m, [&](int i, int) {
      float* tmp = opnd + tmp_off + i * up;
      for (int u = 0; u < up; ++u) tmp[u] = 0.0f;
      for (int u = 0; u < n_steps; ++u) {
        const int4 s = steps[i * up + u];
        tmp[u] = alu(s.x, opnd[s.y], opnd[s.z], opnd[s.w]);
      }
    });
    __syncthreads();

    // (C) wires from the old state; latches and captures
    if (live)
      for (int w = tid; w < wp; w += nt) {
        const int s = wire_src[w];
        wire_n[w] = s < sp ? sig[s]
                           : (s < sp + ep ? ext[s - sp] : wire[s - sp - ep]);
      }
    walk(EV_LATCH, b, m, [&](int l, int k) {
      latch[l * D + k % D] = wire[latch_wire[l]];
    });
    walk(EV_OUT, b, m, [&](int o, int k) {
      out_row[(long long)k * op + o] = wire[out_wire[o]];
    });
    __syncthreads();

    float* t = wire; wire = wire_n; wire_n = t;
    pb = b;
    pm = m;
    if (++b == ii) {
      b = 0;
      ++m;
    }
  }
}

// One free-standing ALU step of every lane (the reference's Pallas
// `_build_step_kernel` entry point, `alu_step_pallas`): out[i] =
// alu(op, a[i], b[i], c[i]) over rows x cols lanes, with op the global id
// table[k] of the lane's code k = codes[row * code_stride + col] (0 for a
// row of codes shared by every row), nop for a code outside the table.
// K3's own dispatch, outside the cycle loop: the stepper's operands come
// from its machine state, these from the caller.
__global__ void alu_step_kernel(long long n, int cols, int code_stride,
                                int n_codes, const int* __restrict__ codes,
                                const int* __restrict__ table,
                                const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ c,
                                float* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / cols;
    const int k = codes[row * code_stride + (int)(i - row * cols)];
    const int op = (k >= 0 && k < n_codes) ? table[k] : OP_NOP;
    out[i] = alu(op, a[i], b[i], c[i]);
  }
}

// floats of state per block; kernels/sim_step.py::stepper_state_bytes / 4
static long long sim_state_floats(int ip, int up, int ep, int sp, int wp,
                                  int lp, int cp, int D) {
  return (long long)ep + sp + 2LL * wp + (long long)lp * D + lp + cp
         + (long long)ip * up;
}

// The launch's threads a block: enough that the widest per-cycle loop
// (the wires) takes a few iterations a thread.
static int sim_threads(int wp) {
  int t = 128;
  while (t < MAX_THREADS && t * 4 < wp) t *= 2;
  return t;
}

extern "C" {

int sim_stepper(int G, int B, int K, int cycles, int D, int ip, int up,
                int ep, int sp, int wp, int lp, int cp, int op, int nb,
                int ev_cap, int use_global, int empty, const void* ii,
                const void* dims,
                const void* steps, const void* const_pool,
                const void* fire_time, const void* wire_src,
                const void* sig_tmp, const void* latch_wire,
                const void* latch_owner, const void* out_wire,
                const void* ev, const void* ev_off, const void* inputs,
                void* outbuf, void* scratch, void* stream) {
  long long floats = sim_state_floats(ip, up, ep, sp, wp, lp, cp, D);
  // the state (shared placement), then the event lists and offsets
  long long smem = (use_global ? 0 : (floats + 1) / 2 * 8)
                   + 8LL * ev_cap + 4LL * N_EV * nb;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sim_stepper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Args a{B, K, cycles, D, ip, up, ep, sp, wp, lp, cp, op, nb, ev_cap, floats,
         use_global, empty, (const int*)ii, (const int*)dims,
         (const int4*)steps, (const float*)const_pool,
         (const int*)fire_time, (const int*)wire_src, (const int*)sig_tmp,
         (const int*)latch_wire, (const int*)latch_owner,
         (const int*)out_wire, (const int2*)ev, (const int*)ev_off,
         (const float*)inputs, (float*)outbuf, (float*)scratch};
  if ((long long)G * B > 0)
    sim_stepper_kernel<<<(unsigned)(G * B), sim_threads(wp), (size_t)smem,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int sim_alu_step(long long n, int cols, int code_stride, int n_codes,
                 const void* codes, const void* table, const void* a,
                 const void* b, const void* c, void* out, void* stream) {
  if (n > 0) {
    const long long blocks = (n + 255) / 256;
    alu_step_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
                      (cudaStream_t)stream>>>(
        n, cols, code_stride, n_codes, (const int*)codes, (const int*)table,
        (const float*)a, (const float*)b, (const float*)c, (float*)out);
  }
  return (int)cudaGetLastError();
}

const char* sim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
