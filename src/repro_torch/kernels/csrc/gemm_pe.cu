// K5: matmul with a fused PE-graph epilogue (gemm_pe_kernel).
//
// Replaces the Pallas _gemm_kernel of the JAX package
// (src/repro/kernels/gemm.py): out = epilogue(x @ w, extras...), x (M, K)
// and w (K, N) float32 or bfloat16, float32 accumulation, the epilogue
// evaluated per output element while its accumulator is in registers,
// stored as float32 or bfloat16.
//
// Bound: at the main path's shapes (4096 x 2048 x 8192) the product does
// 2*M*N*K operations on far fewer bytes, so operations bound it.  The
// float32 product runs on the TF32 tensor cores with the 3xTF32 split:
// each operand a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and the
// accumulator takes lo*hi + hi*lo + hi*hi in float32 (lo*lo, below 2^-22
// of a product, is dropped), which holds float32 accuracy at three times
// the tensor-core work: 3 * 2*M*N*K operations at 495 TFLOP/s.
// bfloat16 operands are exact in TF32 and take one pass.  No library GEMM
// and no TF32 rounding of the result: the reference product is float32
// and is held to 1e-4.
//
// Design: a first pass splits x into its TF32 parts and w into the parts
// of its transpose (K-major, as wgmma takes TF32 operands), zero-padded to
// whole tiles, so the main kernel needs no edge masks.  The main kernel
// runs one 128x128 output tile per block of two warpgroups, each issuing
// wgmma.m64n128k8 from shared memory; K in steps of 32 through a ring of 3
// stages (x hi, x lo, w hi, w lo: 64 KB a stage) filled by 16-byte
// cp.async into the 128-byte swizzle the descriptors name, the next
// stage's copies issued while the tensor cores work.  Blocks walk the
// output in groups of 8 row tiles, so the blocks in flight share their
// panels in L2.  The tensor cores truncate as they accumulate: each step
// of 32 is summed from zero and added to the float32 result in registers
// with one rounding to nearest, which keeps the error near float32's.
//
// The epilogue is an op list (struct Epilogue, passed by value) over a
// small slot file: slot 0 = accumulator, then the extras, the constants,
// one slot per op.  epi_apply is the device table of the JAX package's
// _JNP_SEMANTICS (kernels/pe_fused.py), opcode order = EPI_OPCODES in
// gemm.py; booleans are 0.0f / 1.0f.  It is not the simulator's ALU
// table (csrc/sim_step.cu): shr/ashr here are a * exp2(-b).  The build's
// --fmad=false keeps every epilogue op one IEEE rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

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

using namespace hopper;

// bfloat16 travels as its 16 bits: widening is a shift, exact
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
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

// One op on four output elements at once (one dispatch for the four);
// in each expression a, b, c name one element's operands.
#define L4(expr)                                                   \
  {                                                                \
    float4 r;                                                      \
    float* rr = &r.x;                                              \
    const float* aa = &A.x; const float* bb = &B.x;                \
    const float* cc = &C.x;                                        \
    _Pragma("unroll") for (int l = 0; l < 4; ++l) {                \
      const float a = aa[l], b = bb[l], c = cc[l];                 \
      (void)b; (void)c;                                            \
      rr[l] = (expr);                                              \
    }                                                              \
    return r;                                                      \
  }

// a != 0 is true for NaN, as JAX's float -> bool conversion
__device__ float4 epi_apply(int code, float4 A, float4 B, float4 C) {
  switch (code) {
    case OP_ADD: L4(a + b)
    case OP_SUB: L4(a - b)
    case OP_NEG: L4(-a)
    case OP_ABS: L4(fabsf(a))
    case OP_MUL: L4(a * b)
    case OP_MAC: L4(a * b + c)      // two roundings, as a * b + c
    case OP_DIV: L4(a / b)          // IEEE division (no fast math)
    case OP_RECIP: L4(1.0f / a)
    case OP_SHL: L4(a * exp2f(b))
    case OP_SHR:
    case OP_ASHR: L4(a * exp2f(-b))
    case OP_EQ: L4(b2f(a == b))
    case OP_NEQ: L4(b2f(a != b))
    case OP_LT: L4(b2f(a < b))
    case OP_LTE: L4(b2f(a <= b))
    case OP_GT: L4(b2f(a > b))
    case OP_GTE: L4(b2f(a >= b))
    case OP_MIN: L4((isnan(a) || isnan(b)) ? qnan() : fminf(a, b))
    case OP_MAX: L4((isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b))
    case OP_AND: L4(b2f(a != 0.0f && b != 0.0f))
    case OP_OR: L4(b2f(a != 0.0f || b != 0.0f))
    case OP_XOR: L4(b2f((a != 0.0f) != (b != 0.0f)))
    case OP_NOT: L4(b2f(!(a != 0.0f)))
    case OP_SIGN: L4(a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : a))
    case OP_SEL: L4(a != 0.0f ? c : b)   // sel(c, f, t) = where(c, t, f)
    case OP_EXP: L4(expf(a))
    case OP_LOG: L4(logf(a))
    case OP_TANH: L4(tanhf(a))
    case OP_SIGMOID: L4(1.0f / (1.0f + expf(-a)))
    case OP_RSQRT: L4(rsqrtf(a))
    case OP_SQRT: L4(sqrtf(a))
    case OP_ERF: L4(erff(a))
    case OP_POW: L4(powf(a, b))
    case OP_FLOOR: L4(floorf(a))
    case OP_ROUND: L4(rintf(a))     // half to even
    default: L4(qnan())
  }
}

#undef L4

// The epilogue of the n (1 to 4) output elements o .. o + n - 1 (columns
// gn .. gn + n - 1 of one row) on their accumulators r; v is the caller's
// slot file with the constants already in place.
template <bool EPI>
__device__ __forceinline__ float4 epi_eval(const Epilogue& epi, float4* v,
                                           float4 r, size_t o, int gn,
                                           int n) {
  if (!EPI) return r;
  v[0] = r;
  for (int e = 0; e < epi.n_extra; ++e) {
    const float* p = epi.extra[e] + (epi.extra_kind[e] ? o : (size_t)gn);
    v[1 + e] = make_float4(p[0], n > 1 ? p[1] : 0.0f, n > 2 ? p[2] : 0.0f,
                           n > 3 ? p[3] : 0.0f);
  }
  for (int q = 0; q < epi.n_ops; ++q) {
    const EpiOp op = epi.ops[q];
    v[op.dst] = epi_apply(op.code, v[op.a], v[op.b], v[op.c]);
  }
  return v[epi.out];
}

template <bool EPI>
__device__ __forceinline__ void epi_init(const Epilogue& epi, float4* v) {
  if (EPI)
    for (int s = 0; s < epi.n_init; ++s) {
      const float c = epi.slot_init[s];
      v[s] = make_float4(c, c, c, c);
    }
}

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int GROUP_M = 8;
// a stage: x's hi and lo tiles (BM rows), w's hi and lo tiles (BN rows),
// each row BK float32 = 128 bytes, 128-byte swizzled
constexpr int TILE_BYTES = BM * BK * 4;
static_assert(BM == BN && THREADS / 8 * 4 == BM,
              "a thread copies 4 rows of each tile, x and w alike");
constexpr int STAGE_BYTES = 4 * TILE_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + alignment

// x (M, K) -> its TF32 parts (2, Mp, Kp), zero-padded; w (K, N) -> the
// parts of its transpose (2, Np, Kp).  With `one` (bfloat16 operands,
// exact in TF32) only the hi part is written.  A block moves a 32 x 32
// tile (the padded sizes are multiples of 32); for w through shared
// memory, so both sides stay coalesced.
template <typename T>
__global__ void split_kernel(int rows, int cols, int rows_p, int cols_p,
                             const T* __restrict__ in, float* __restrict__ out,
                             int transpose, int one) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;       // 32 x 8
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const size_t plane = (size_t)(transpose ? cols_p : rows_p) *
                       (transpose ? rows_p : cols_p);
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = (r < rows && c < cols) ? to_f32(in[(size_t)r * cols + c])
                                         : 0.0f;
  }
  if (transpose) __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    // transposed: out row c0 + i, column r0 + tx of (cols_p, rows_p)
    const float v = transpose ? tile[tx][i] : tile[i][tx];
    const int orow = transpose ? c0 + i : r0 + i;
    const int ocol = transpose ? r0 + tx : c0 + tx;
    const size_t o = (size_t)orow * (transpose ? rows_p : cols_p) + ocol;
    const uint32_t hi = one ? __float_as_uint(v) : tf32(v);
    out[o] = __uint_as_float(hi);
    if (!one) out[plane + o] = __uint_as_float(tf32(v - __uint_as_float(hi)));
  }
}

// xs (2, Mp, Kp), ws (2, Np, Kp): the split operands, padded to whole
// tiles.  Warpgroup g of the block computes rows 64 g .. 64 g + 63 of the
// 128 x 128 tile.  Each K step of 32 is summed by the tensor cores from
// zero (scale-d 0) and added to the float32 result with one rounding to
// nearest: the tensor cores truncate as they accumulate, and over a
// whole K of 2048 that bias grows to the order of the 1e-4 tolerance.
template <typename TOut, bool EPI>
__global__ void __launch_bounds__(THREADS, 1)
gemm_pe_kernel(int M, int N, int Kp, int two, const float* __restrict__ xs,
               const float* __restrict__ ws, TOut* __restrict__ out,
               const Epilogue epi) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* smem =
      smem_raw + ((1024u - (static_cast<uint32_t>(
                                __cvta_generic_to_shared(smem_raw)) & 1023u)) &
                  1023u);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n, pid = blockIdx.x;
  const int first_m = (pid / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int m0 = (first_m + (pid % per_group) % group_m) * BM;
  const int n0 = ((pid % per_group) / group_m) * BN;
  const size_t xplane = (size_t)tiles_m * BM * Kp;
  const size_t wplane = (size_t)tiles_n * BN * Kp;

  const int tid = threadIdx.x, wg = tid / 128;
  // a K step into a stage: a thread copies 16-byte chunk ch of rows r0,
  // r0 + 32, r0 + 64, r0 + 96 of each tile (x hi, x lo, w hi, w lo) into
  // the 128-byte swizzle, where chunk c of row r lands at c ^ (r % 8)
  const int r0 = tid / 8, ch = tid % 8;
  const float* src[4] = {xs + (size_t)(m0 + r0) * Kp + ch * 4,
                         xs + xplane + (size_t)(m0 + r0) * Kp + ch * 4,
                         ws + (size_t)(n0 + r0) * Kp + ch * 4,
                         ws + wplane + (size_t)(n0 + r0) * Kp + ch * 4};
  const uint32_t dst = r0 * 128 + ((ch ^ (r0 & 7)) << 4);
  auto load_stage = [&](uint32_t st, int k0) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (!two && (t & 1)) continue;                 // no lo parts
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(st + t * TILE_BYTES + dst + j * 32 * 128,
                   src[t] + (size_t)j * 32 * Kp + k0);
    }
  };
  float d[64], acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;

  const int kt_n = Kp / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(base + s * STAGE_BYTES, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    // this thread's copies of step kt are visible to the tensor cores;
    // after the barrier, everyone's, and no warpgroup still reads the
    // stage refilled below (each waited for its wgmmas of step kt - 1)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
    const uint64_t ah = smem_desc(st + wg * 64 * 128);
    const uint64_t al = smem_desc(st + TILE_BYTES + wg * 64 * 128);
    const uint64_t bh = smem_desc(st + 2 * TILE_BYTES);
    const uint64_t bl = smem_desc(st + 3 * TILE_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint64_t o = kk * 2;                 // 32 bytes, in 16s
      if (two) {
        wgmma_tf32_ss<128>(d, al + o, bh + o, kk);   // small terms first
        wgmma_tf32_ss<128>(d, ah + o, bl + o, 1);
        wgmma_tf32_ss<128>(d, ah + o, bh + o, 1);
      } else {
        wgmma_tf32_ss<128>(d, ah + o, bh + o, kk);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the next copies go out while the tensor cores work
    const int nk = kt + STAGES - 1;
    if (nk < kt_n) load_stage(base + (nk % STAGES) * STAGE_BYTES, nk * BK);
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += d[e];
  }
  cp_async_wait<0>();

  // the tile through shared memory (the ring is free now): one copy of
  // the epilogue's code in a plain loop, and coalesced reads of the
  // extras and stores of the result.  Warp w of the warpgroup holds rows
  // 16 w .. 16 w + 15; per 8 columns j four values: (g, 2q), (g, 2q + 1),
  // (g + 8, 2q), (g + 8, 2q + 1).
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int LD = BN + 8;             // conflict-free float2 stores
  __syncthreads();
  {
    const int lane = tid % 32, g = lane / 4, q = lane % 4;
    const int r = wg * 64 + ((tid % 128) / 32) * 16 + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = j * 8 + 2 * q;
      *reinterpret_cast<float2*>(&tile[r * LD + c]) =
          make_float2(acc[j * 4], acc[j * 4 + 1]);
      *reinterpret_cast<float2*>(&tile[(r + 8) * LD + c]) =
          make_float2(acc[j * 4 + 2], acc[j * 4 + 3]);
    }
  }
  __syncthreads();
  // four consecutive columns a thread: one pass of the op list for four
  // elements, and one plain loop, so one copy of the epilogue's code
  float4 v[EPI ? MAX_SLOTS : 1];
  epi_init<EPI>(epi, v);
#pragma unroll 1
  for (int i = tid; i < BM * BN / 4; i += THREADS) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const int n = min(4, N - gn);
      const size_t o = (size_t)gm * N + gn;
      const float4 y = epi_eval<EPI>(
          epi, v, *reinterpret_cast<const float4*>(&tile[r * LD + c]), o, gn,
          n);
      const float* yy = &y.x;
      for (int u = 0; u < n; ++u) store_out(out, o + u, yy[u]);
    }
  }
}

template <typename T, typename TOut>
int dispatch_tc(int M, int N, int K, const void* x, const void* w,
                void* xs, void* ws, void* out, const Epilogue& epi,
                cudaStream_t s) {
  const int two = sizeof(T) == 4;           // float32: hi and lo parts
  const int Mp = (M + BM - 1) / BM * BM, Np = (N + BN - 1) / BN * BN;
  const int Kp = (K + BK - 1) / BK * BK;
  const dim3 tb(32, 8);
  if (Kp > 0) {
    split_kernel<T><<<dim3(Kp / 32, Mp / 32), tb, 0, s>>>(
        M, K, Mp, Kp, static_cast<const T*>(x), static_cast<float*>(xs), 0,
        !two);
    split_kernel<T><<<dim3(Np / 32, Kp / 32), tb, 0, s>>>(
        K, N, Kp, Np, static_cast<const T*>(w), static_cast<float*>(ws), 1,
        !two);
  }
  const bool has_epi = epi.n_ops > 0 || epi.out != 0;
  auto kern = has_epi ? gemm_pe_kernel<TOut, true> : gemm_pe_kernel<TOut, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(unsigned)((long long)(Mp / BM) * (Np / BN)), THREADS, SMEM_BYTES,
         s>>>(M, N, Kp, two, static_cast<const float*>(xs),
              static_cast<const float*>(ws), static_cast<TOut*>(out), epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (M, N) = epilogue(x (M, K) @ w (K, N)); in_bf16 / out_bf16 pick the
// operand and result types (float32 otherwise).  xs and ws take the split
// operands: float32 (P, Mp, Kp) and (P, Np, Kp), P = 2 parts for float32
// operands and 1 for bfloat16, Mp, Np, Kp = M, N, K rounded up to the
// tile (gemm_pe_limits).  Returns cudaGetLastError.
int gemm_pe_launch(int M, int N, int K, const void* x, const void* w,
                   void* xs, void* ws, void* out, int in_bf16, int out_bf16,
                   const Epilogue* epi, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return out_bf16 ? dispatch_tc<uint16_t, __nv_bfloat16>(
                          M, N, K, x, w, xs, ws, out, *epi, s)
                    : dispatch_tc<uint16_t, float>(M, N, K, x, w, xs, ws, out,
                                                   *epi, s);
  return out_bf16 ? dispatch_tc<float, __nv_bfloat16>(M, N, K, x, w, xs, ws,
                                                      out, *epi, s)
                  : dispatch_tc<float, float>(M, N, K, x, w, xs, ws, out,
                                              *epi, s);
}

// (opcodes, max ops, max slots, max extras, tile M, N, K), checked by
// gemm.py on load
int gemm_pe_limits(int* out) {
  out[0] = N_OPCODES;
  out[1] = MAX_OPS;
  out[2] = MAX_SLOTS;
  out[3] = MAX_EXTRA;
  out[4] = BM;
  out[5] = BN;
  out[6] = BK;
  return 0;
}

const char* gemm_pe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
