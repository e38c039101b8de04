// K5: matmul with a fused PE-graph epilogue (gemm_pe_kernel).
//
// Replaces the Pallas _gemm_kernel of the JAX package
// (src/repro/kernels/gemm.py): out = epilogue(x @ w, extras...), x (M, K)
// and w (K, N) float32 or bfloat16, widened to float32 on load, float32
// accumulation, the epilogue evaluated per output element while its
// accumulator is in registers, stored as float32 or bfloat16.
//
// Bound: at the main path's shapes (4096 x 2048 x 8192) the product does
// 2*M*N*K operations on far fewer bytes, so float32 operations bound it.
// No TF32: the reference product is float32 and is held to 1e-4.
//
// Design (simple and correct first): one 128x128 output tile per block of
// 256 threads, 8x8 outputs per thread in registers, K in steps of 8
// staged through shared memory (the next step's global loads are issued
// before the current step's arithmetic), edges masked by bounds checks.
// The K loop uses __fmaf_rn explicitly: the build's --fmad=false, kept
// for the epilogue, would otherwise split every multiply-add in two.
//
// The epilogue is an op list (struct Epilogue, passed by value) over a
// small slot file: slot 0 = accumulator, then the extras, the constants,
// one slot per op.  epi_apply is the device table of the JAX package's
// _JNP_SEMANTICS (kernels/pe_fused.py), opcode order = EPI_OPCODES in
// gemm.py; booleans are 0.0f / 1.0f.  It is not the simulator's ALU
// table (csrc/sim_step.cu): shr/ashr here are a * exp2(-b).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

// outside the anonymous namespace: the extern "C" entry point takes a
// struct Epilogue*, and a parameter of an internal-linkage type would
// make that symbol internal too
constexpr int MAX_OPS = 32, MAX_SLOTS = 64, MAX_EXTRA = 8;

enum Opcode : int {
  OP_ADD, OP_SUB, OP_NEG, OP_ABS, OP_MUL, OP_MAC, OP_DIV, OP_RECIP,
  OP_SHL, OP_SHR, OP_ASHR, OP_EQ, OP_NEQ, OP_LT, OP_LTE, OP_GT, OP_GTE,
  OP_MIN, OP_MAX, OP_AND, OP_OR, OP_XOR, OP_NOT, OP_SIGN, OP_SEL,
  OP_EXP, OP_LOG, OP_TANH, OP_SIGMOID, OP_RSQRT, OP_SQRT, OP_ERF, OP_POW,
  OP_FLOOR, OP_ROUND, N_OPCODES
};

struct EpiOp {
  int code, dst, a, b, c;
};

struct Epilogue {
  int n_ops, n_extra, out, n_init;
  int extra_kind[MAX_EXTRA];           // 0: vec (N,), 1: full (M, N)
  const float* extra[MAX_EXTRA];
  float slot_init[MAX_SLOTS];          // constants in slots [1+n_extra, n_init)
  EpiOp ops[MAX_OPS];
};

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8, THREADS = 256;

__device__ __forceinline__ float load_in(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_in(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_out(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, size_t i,
                                          float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float b2f(bool v) { return v ? 1.0f : 0.0f; }

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// a != 0 is true for NaN, as JAX's float -> bool conversion
__device__ float epi_apply(int code, float a, float b, float c) {
  switch (code) {
    case OP_ADD: return a + b;
    case OP_SUB: return a - b;
    case OP_NEG: return -a;
    case OP_ABS: return fabsf(a);
    case OP_MUL: return a * b;
    case OP_MAC: return a * b + c;      // two roundings, as a * b + c
    case OP_DIV: return a / b;          // IEEE division (no fast math)
    case OP_RECIP: return 1.0f / a;
    case OP_SHL: return a * exp2f(b);
    case OP_SHR:
    case OP_ASHR: return a * exp2f(-b);
    case OP_EQ: return b2f(a == b);
    case OP_NEQ: return b2f(a != b);
    case OP_LT: return b2f(a < b);
    case OP_LTE: return b2f(a <= b);
    case OP_GT: return b2f(a > b);
    case OP_GTE: return b2f(a >= b);
    case OP_MIN: return (isnan(a) || isnan(b)) ? qnan() : fminf(a, b);
    case OP_MAX: return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
    case OP_AND: return b2f(a != 0.0f && b != 0.0f);
    case OP_OR: return b2f(a != 0.0f || b != 0.0f);
    case OP_XOR: return b2f((a != 0.0f) != (b != 0.0f));
    case OP_NOT: return b2f(!(a != 0.0f));
    case OP_SIGN: return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a);
    case OP_SEL: return a != 0.0f ? c : b;   // sel(c, f, t) = where(c, t, f)
    case OP_EXP: return expf(a);
    case OP_LOG: return logf(a);
    case OP_TANH: return tanhf(a);
    case OP_SIGMOID: return 1.0f / (1.0f + expf(-a));
    case OP_RSQRT: return rsqrtf(a);
    case OP_SQRT: return sqrtf(a);
    case OP_ERF: return erff(a);
    case OP_POW: return powf(a, b);
    case OP_FLOOR: return floorf(a);
    case OP_ROUND: return rintf(a);     // half to even
    default: return qnan();
  }
}

template <typename TIn, typename TOut, bool EPI>
__global__ void __launch_bounds__(THREADS)
gemm_pe_kernel(int M, int N, int K, const TIn* __restrict__ x,
               const TIn* __restrict__ w, TOut* __restrict__ out,
               const Epilogue epi) {
  // +4 floats a row: conflict-free transposed stores of the x tile, and
  // rows stay 16-byte aligned for the float4 reads
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // each thread stages 4 elements of the x tile and 4 of the w tile
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / BK, c = idx % BK;       // x tile: BM x BK
      const int gm = m0 + r, gk = k0 + c;
      ra[i] = (gm < M && gk < K) ? load_in(x, (size_t)gm * K + gk) : 0.0f;
      const int r2 = idx / BN, c2 = idx % BN;     // w tile: BK x BN
      const int gk2 = k0 + r2, gn = n0 + c2;
      rb[i] = (gk2 < K && gn < N) ? load_in(w, (size_t)gk2 * N + gn) : 0.0f;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      As[idx % BK][idx / BK] = ra[i];
      Bs[idx / BN][idx % BN] = rb[i];
    }
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float v[EPI ? MAX_SLOTS : 1];
  if (EPI) {
    for (int s = 0; s < epi.n_init; ++s) v[s] = epi.slot_init[s];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn >= N) break;
      const size_t o = (size_t)gm * N + gn;
      float r = acc[i][j];
      if (EPI) {
        v[0] = r;
        for (int e = 0; e < epi.n_extra; ++e)
          v[1 + e] = epi.extra[e][epi.extra_kind[e] ? o : (size_t)gn];
        for (int q = 0; q < epi.n_ops; ++q) {
          const EpiOp op = epi.ops[q];
          v[op.dst] = epi_apply(op.code, v[op.a], v[op.b], v[op.c]);
        }
        r = v[epi.out];
      }
      store_out(out, o, r);
    }
  }
}

template <typename TIn, typename TOut>
int launch(int M, int N, int K, const void* x, const void* w, void* out,
           const Epilogue& epi, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool has_epi = epi.n_ops > 0 || epi.out != 0;
  if (has_epi)
    gemm_pe_kernel<TIn, TOut, true><<<grid, THREADS, 0, stream>>>(
        M, N, K, static_cast<const TIn*>(x), static_cast<const TIn*>(w),
        static_cast<TOut*>(out), epi);
  else
    gemm_pe_kernel<TIn, TOut, false><<<grid, THREADS, 0, stream>>>(
        M, N, K, static_cast<const TIn*>(x), static_cast<const TIn*>(w),
        static_cast<TOut*>(out), epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (M, N) = epilogue(x (M, K) @ w (K, N)); in_bf16 / out_bf16 pick the
// operand and result types (float32 otherwise).  Returns cudaGetLastError.
int gemm_pe_launch(int M, int N, int K, const void* x, const void* w,
                   void* out, int in_bf16, int out_bf16,
                   const Epilogue* epi, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(M, N, K, x, w, out,
                                                      *epi, s)
               : launch<__nv_bfloat16, float>(M, N, K, x, w, out, *epi, s);
  return out_bf16 ? launch<float, __nv_bfloat16>(M, N, K, x, w, out, *epi, s)
                  : launch<float, float>(M, N, K, x, w, out, *epi, s);
}

// (opcodes, max ops, max slots, max extras), checked by gemm.py on load
int gemm_pe_limits(int* out) {
  out[0] = N_OPCODES;
  out[1] = MAX_OPS;
  out[2] = MAX_SLOTS;
  out[3] = MAX_EXTRA;
  return 0;
}

const char* gemm_pe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
