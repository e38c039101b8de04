// K6: flash attention with GQA, causal and sliding-window masks and a
// logit softcap (flash_attention_kernel).
//
// Replaces the Pallas _attn_kernel of the JAX package
// (src/repro/kernels/flash_attention.py): q (B, Hq, S, D) scaled by
// `scale`, k/v (B, Hkv, S, D), query head h reads kv head h / (Hq/Hkv);
// s = q k^T, soft-capped as softcap * tanhf(s / softcap) when softcap is
// set; masked scores are -1e30 (not -inf: a tile whose keys are all
// masked, met before any real key, adds exp(0) terms that the next real
// key's alpha = exp(-1e30 - m) wipes out, as in the reference); running
// max, l and acc in float32; out = acc / max(l, 1e-30) in q's dtype.
// Masks: causal k <= q, window k > q - window (also without causal), and,
// unlike the reference, k < S, so a ragged S needs no padded keys.
//
// Bound: 4*D float32 operations per unmasked (q, k) pair on a few bytes a
// row, so float32 operations outside the tensor cores bound it (67 TFLOP/s
// on an H100 SXM).  No TF32: the reference math is float32 and is held to
// 2e-5.
//
// Design (simple and correct first): one block of 128 threads per (b, h,
// q-tile of 64 rows); q-tiles are launched heaviest first so the causal
// tail is short.  The q tile is scaled and stored transposed in shared
// memory once; each 64-key tile of k (transposed) and v is staged through
// shared memory, bfloat16 widened on load.  A thread owns 4 query rows x 8
// key columns of s and the same 4 rows x D/8 columns of acc; the row max
// and sum are reduced over the 8 threads of a row with __shfl_xor_sync.
// p goes to shared memory (over the k tile, which is no longer needed) for
// the p v product.  Products are __fmaf_rn (the build's --fmad=false would
// otherwise split them); expf, tanhf and the division are IEEE.  The kv
// loop stops at the causal horizon of the q tile and, with a window,
// starts at the first tile any of its rows can see; a skipped tile would
// change no result.  Shared memory: 34 KB (D <= 32), 50 KB (D <= 64),
// 100 KB (D <= 128) a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 128;
constexpr int TR = 4;             // query rows a thread owns
constexpr int LD = BQ + 4;        // row stride of the transposed tiles
constexpr float NEG_INF = -1e30f;
static_assert(BQ == BK, "p^T reuses the k^T tile's rows");

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

struct Params {
  int B, Hq, Hkv, S, D, causal, window;
  float softcap, scale;
};

template <int DP>
constexpr size_t smem_floats() {
  // q^T [DP][LD], k^T [DP][LD] (then p^T [BK][LD]), v [BK][DP]
  return (size_t)DP * LD + (size_t)(DP > BK ? DP : BK) * LD +
         (size_t)BK * DP;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const Params p) {
  constexpr int NG = DP / 32;     // groups of 4 output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + DP * LD;       // also Ps
  float* Vs = Ks + (DP > BK ? DP : BK) * LD;

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int S = p.S, D = p.D;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const size_t q_base = ((size_t)b * p.Hq + h) * S * D;
  const size_t kv_base = ((size_t)b * p.Hkv + hk) * S * D;

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int r = idx / DP, c = idx % DP;
    Qs[c * LD + r] = (q0 + r < S && c < D)
                         ? load_in(q, q_base + (size_t)(q0 + r) * D + c) *
                               p.scale
                         : 0.0f;
  }

  float m[TR], l[TR], acc[TR][NG * 4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NG * 4; ++j) acc[i][j] = 0.0f;
  }

  const int n_kv = (S + BK - 1) / BK;
  const int hi = p.causal ? min((q0 + BQ - 1) / BK + 1, n_kv) : n_kv;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();              // the previous tile's p^T and v are read
    for (int idx = tid; idx < BK * DP; idx += THREADS) {
      const int r = idx / DP, c = idx % DP;
      const bool ok = k0 + r < S && c < D;
      const size_t g = kv_base + (size_t)(k0 + r) * D + c;
      Ks[c * LD + r] = ok ? load_in(k, g) : 0.0f;
      Vs[r * DP + c] = ok ? load_in(v, g) : 0.0f;
    }
    __syncthreads();

    // s = q k^T: rows ty*4 + i, columns tx*4 + jj and 32 + tx*4 + jj
    float s[TR][8];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 qv =
          *reinterpret_cast<const float4*>(&Qs[c * LD + ty * 4]);
      const float4 k0v =
          *reinterpret_cast<const float4*>(&Ks[c * LD + tx * 4]);
      const float4 k1v =
          *reinterpret_cast<const float4*>(&Ks[c * LD + 32 + tx * 4]);
      const float a[TR] = {qv.x, qv.y, qv.z, qv.w};
      const float kk[8] = {k0v.x, k0v.y, k0v.z, k0v.w,
                           k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          s[i][jj] = __fmaf_rn(a[i], kk[jj], s[i][jj]);
    }

    // softcap, masks, online softmax
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int kp = k0 + (jj < 4 ? tx * 4 + jj : 32 + tx * 4 + jj - 4);
        float x = s[i][jj];
        if (p.softcap != 0.0f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = kp < S;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window != 0) ok = ok && kp > qp - p.window;
        s[i][jj] = ok ? x : NEG_INF;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        sum += s[i][jj];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NG * 4; ++jj) acc[i][jj] *= alpha;
    }

    __syncthreads();              // every thread is done with k^T
    float* Ps = Ks;               // p^T [BK][LD]
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = jj < 4 ? tx * 4 + jj : 32 + tx * 4 + jj - 4;
      *reinterpret_cast<float4*>(&Ps[c * LD + ty * 4]) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
    }
    __syncthreads();

    // acc += p v: columns 32*g + tx*4 + dd
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv =
          *reinterpret_cast<const float4*>(&Ps[c * LD + ty * 4]);
      const float pp[TR] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[c * DP + 32 * g + tx * 4]);
        const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
            acc[i][g * 4 + dd] = __fmaf_rn(pp[i], vq[dd], acc[i][g * 4 + dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const int c = 32 * g + tx * 4 + dd;
        if (c < D)
          store_out(out, q_base + (size_t)qp * D + c,
                    acc[i][g * 4 + dd] / den);
      }
  }
}

template <typename T, int DP>
int launch(const Params& p, const void* q, const void* k, const void* v,
           void* out, cudaStream_t stream) {
  const size_t bytes = smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  flash_attention_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Params& p, const void* q, const void* k, const void* v,
             void* out, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, q, k, v, out, stream);
  if (p.D <= 64) return launch<T, 64>(p, q, k, v, out, stream);
  return launch<T, 128>(p, q, k, v, out, stream);
}

}  // namespace

extern "C" {

// out (B, Hq, S, D) = attention(q, k, v); dtype 0 = float32, 1 = bfloat16
// for all four tensors.  Returns cudaGetLastError (or the error of the
// shared-memory attribute); cudaErrorInvalidValue for D outside 1..128 or
// Hq not a multiple of Hkv.
int flash_attention_launch(int B, int Hq, int Hkv, int S, int D,
                           const void* q, const void* k, const void* v,
                           void* out, int dtype, int causal, int window,
                           float softcap, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{B, Hq, Hkv, S, D, causal, window, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_d<__nv_bfloat16>(p, q, k, v, out, s)
                    : launch_d<float>(p, q, k, v, out, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
