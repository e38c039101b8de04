// Cycle-stepper kernel of the cycle-accurate simulator for Hopper (sm_90a):
// K3 `sim_stepper_kernel`.
//
// It replaces the vmapped `lax.scan` of the reference's batched simulator
// (sim/cycle.py, `_build_batch_stepper`) and, inside it, the Pallas
// compute-all-select ALU step (kernels/sim_step.py, `_build_step_kernel`,
// masked as `alu_step_masked`), which is the device function `alu` below.
// One block runs one (program, input row) through every cycle of the
// bucket, keeping the machine state resident for the whole run:
// double-buffered ext/sig/wire registers, the latch FIFOs and the operand
// buffer [latch view | const | tmp].  The state lives in shared memory, or,
// when it exceeds the 227 KB a block can opt into (or the caller asks for
// it), in a global scratch buffer: the same kernel body either way.
//
// Per cycle: (1) every latch's FIFO slot for the iteration its consumer
// executes goes into the operand buffer; (2) each tile runs its micro-ops
// in order on one thread (operands only ever read the tile's own tmp
// slots; the wrapper checks this), inactive lanes and steps retire 0.0;
// (3) sig/ext/wire registers load from the old state into the other
// buffer, arriving words enter the latch FIFOs, outputs are captured
// straight to global memory.  Three block barriers a cycle.  The chain of
// dependent cycles sets the pace; bytes and operations are far below it.
//
// Arithmetic follows the JAX package's simulator under XLA's CPU backend
// bit for bit on every IEEE-exact op: NaN-propagating min/max with -0 < +0,
// sign keeping -0 and NaN, mac as one fused multiply-add, round half to
// even, 2**b exact for integer b.  Build with --fmad=false and without fast
// math so nothing else is contracted or approximated.
//
// The C entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define SMEM_LIMIT 232448

// global op ids: the order of ALU_IMPLS in kernels/sim_step.py
enum AluOp {
  OP_NOP, OP_ADD, OP_SUB, OP_NEG, OP_ABS, OP_MUL, OP_MAC, OP_DIV, OP_RECIP,
  OP_SHL, OP_SHR, OP_ASHR, OP_EQ, OP_NEQ, OP_LT, OP_LTE, OP_GT, OP_GTE,
  OP_MIN, OP_MAX, OP_AND, OP_OR, OP_XOR, OP_NOT, OP_SIGN, OP_SEL, OP_FLOOR,
  OP_ROUND, OP_EXP, OP_LOG, OP_TANH, OP_SIGMOID, OP_RSQRT, OP_SQRT, OP_POW,
  N_OPS
};

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

// A period-II event train starting at t0: fires at t0 + k*II for k < K.
// `k` comes back clipped to [0, K-1].  C's truncating `/` differs from
// the reference's floor division only for d < 0, where both clip to 0.
__device__ __forceinline__ bool periodic(int c, int t0, int ii, int K,
                                         int* k) {
  int d = c - t0;
  int q = d / ii;
  *k = q < 0 ? 0 : (q > K - 1 ? K - 1 : q);
  return d >= 0 && d % ii == 0 && q < K;
}

__global__ void __launch_bounds__(THREADS) sim_stepper_kernel(
    int B, int K, int cycles, int D, int ip, int up, int ep, int sp, int wp,
    int lp, int cp, int op, long long state_floats, int use_global,
    const int* __restrict__ ii_g, const int* __restrict__ dims_g,
    const int* __restrict__ opcodes_g, const int* __restrict__ op_src_g,
    const float* __restrict__ const_pool_g,
    const int* __restrict__ fire_time_g, const int* __restrict__ ext_time_g,
    const int* __restrict__ wire_src_g, const int* __restrict__ sig_tmp_g,
    const int* __restrict__ sig_owner_g, const int* __restrict__ latch_wire_g,
    const int* __restrict__ latch_time_g,
    const int* __restrict__ latch_owner_g,
    const int* __restrict__ out_wire_g, const int* __restrict__ out_time_g,
    const int* __restrict__ op_ids, const float* __restrict__ inputs,
    float* __restrict__ outbuf, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int g = blockIdx.x / B;
  const int tid = threadIdx.x;
  float* st = use_global ? scratch + (long long)blockIdx.x * state_floats
                         : smem;
  float* ext = st;
  float* ext_n = ext + ep;
  float* sig = ext_n + ep;
  float* sig_n = sig + sp;
  float* wire = sig_n + sp;
  float* wire_n = wire + wp;
  float* latch = wire_n + wp;          // lp x D
  float* opnd = latch + lp * D;        // [latch view lp | const cp | tmp]
  const int tmp_off = lp + cp;

  const int ii = ii_g[g];
  const int n_steps = min(dims_g[2 * g], up);
  const int n_inst = dims_g[2 * g + 1];
  const int* opcodes = opcodes_g + (long long)g * ip * up;
  const int* op_src = op_src_g + (long long)g * ip * up * 3;
  const float* const_pool = const_pool_g + (long long)g * cp;
  const int* fire_time = fire_time_g + (long long)g * ip;
  const int* ext_time = ext_time_g + (long long)g * ep;
  const int* wire_src = wire_src_g + (long long)g * wp;
  const int* sig_tmp = sig_tmp_g + (long long)g * sp;
  const int* sig_owner = sig_owner_g + (long long)g * sp;
  const int* latch_wire = latch_wire_g + (long long)g * lp;
  const int* latch_time = latch_time_g + (long long)g * lp;
  const int* latch_owner = latch_owner_g + (long long)g * lp;
  const int* out_wire = out_wire_g + (long long)g * op;
  const int* out_time = out_time_g + (long long)g * op;
  const float* in_row = inputs + (long long)blockIdx.x * K * ep;
  float* out_row = outbuf + (long long)blockIdx.x * K * op;

  // all state zero, constants in place (they are never overwritten)
  const long long const_at = (long long)(opnd - st) + lp;
  for (long long i = tid; i < state_floats; i += THREADS) {
    long long j = i - const_at;
    st[i] = (j >= 0 && j < cp) ? const_pool[j] : 0.0f;
  }
  __syncthreads();

  for (int c = 0; c < cycles; ++c) {
    int k;
    // (1) each consumer reads the FIFO slot of the iteration it executes
    for (int l = tid; l < lp; l += THREADS) {
      periodic(c, fire_time[latch_owner[l]], ii, K, &k);
      opnd[l] = latch[l * D + k % D];
    }
    __syncthreads();

    // (2) tiles compute in lockstep; each tile's steps in order, tmp
    // rebuilt from zeros every cycle
    for (int i = tid; i < ip; i += THREADS) {
      float* tmp = opnd + tmp_off + i * up;
      for (int u = 0; u < up; ++u) tmp[u] = 0.0f;
      if (i >= n_inst) continue;
      for (int u = 0; u < n_steps; ++u) {
        const int* src = op_src + (i * up + u) * 3;
        tmp[u] = alu(op_ids[opcodes[i * up + u]], opnd[src[0]],
                     opnd[src[1]], opnd[src[2]]);
      }
    }
    __syncthreads();

    // (3) registers load from the old state; latches and captures
    for (int s = tid; s < sp; s += THREADS)
      sig_n[s] = periodic(c, fire_time[sig_owner[s]], ii, K, &k)
                     ? opnd[tmp_off + sig_tmp[s]] : sig[s];
    for (int e = tid; e < ep; e += THREADS)
      ext_n[e] = periodic(c, ext_time[e], ii, K, &k)
                     ? in_row[(long long)k * ep + e] : ext[e];
    for (int w = tid; w < wp; w += THREADS) {
      const int s = wire_src[w];
      wire_n[w] = s < sp ? sig[s]
                         : (s < sp + ep ? ext[s - sp] : wire[s - sp - ep]);
    }
    for (int l = tid; l < lp; l += THREADS)
      if (periodic(c, latch_time[l], ii, K, &k))
        latch[l * D + k % D] = wire[latch_wire[l]];
    for (int o = tid; o < op; o += THREADS)
      if (periodic(c, out_time[o], ii, K, &k))
        out_row[(long long)k * op + o] = wire[out_wire[o]];
    __syncthreads();

    float* t;
    t = ext; ext = ext_n; ext_n = t;
    t = sig; sig = sig_n; sig_n = t;
    t = wire; wire = wire_n; wire_n = t;
  }
}

// floats of state per block; kernels/sim_step.py::stepper_state_bytes / 4
static long long sim_state_floats(int ip, int up, int ep, int sp, int wp,
                                  int lp, int cp, int D) {
  return 2LL * (ep + sp + wp) + (long long)lp * D + lp + cp
         + (long long)ip * up;
}

extern "C" {

int sim_stepper(int G, int B, int K, int cycles, int D, int ip, int up,
                int ep, int sp, int wp, int lp, int cp, int op,
                int use_global, const void* ii, const void* dims,
                const void* opcodes, const void* op_src,
                const void* const_pool, const void* fire_time,
                const void* ext_time, const void* wire_src,
                const void* sig_tmp, const void* sig_owner,
                const void* latch_wire, const void* latch_time,
                const void* latch_owner, const void* out_wire,
                const void* out_time, const void* op_ids,
                const void* inputs, void* outbuf, void* scratch,
                void* stream) {
  long long floats = sim_state_floats(ip, up, ep, sp, wp, lp, cp, D);
  long long smem = use_global ? 0 : floats * 4;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sim_stepper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if ((long long)G * B > 0) {
    sim_stepper_kernel<<<(unsigned)(G * B), THREADS, (size_t)smem,
                         (cudaStream_t)stream>>>(
        B, K, cycles, D, ip, up, ep, sp, wp, lp, cp, op, floats, use_global,
        (const int*)ii, (const int*)dims, (const int*)opcodes,
        (const int*)op_src, (const float*)const_pool,
        (const int*)fire_time, (const int*)ext_time, (const int*)wire_src,
        (const int*)sig_tmp, (const int*)sig_owner, (const int*)latch_wire,
        (const int*)latch_time, (const int*)latch_owner,
        (const int*)out_wire, (const int*)out_time, (const int*)op_ids,
        (const float*)inputs, (float*)outbuf, (float*)scratch);
  }
  return (int)cudaGetLastError();
}

const char* sim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
