// K7: the diagonal selective scan of Mamba-1 (mamba_scan_kernel).
//
// Replaces the Pallas _scan_kernel of the JAX package
// (src/repro/kernels/mamba_scan.py): a and bx (B, S, D, N), c (B, S, N),
// h starts at zero for each (b, d); for each t in order
// h = a_t * h + bx_t, then y_t = sum_n h[n] * c_t[n], all in float32;
// y (B, S, D) float32.  a, bx and c are float32 or bfloat16 (widened on
// load).
//
// Bound: each of a, bx and c is read once and y written once, about one
// operation per byte, so device-memory bytes bound it (3.35 TB/s on an
// H100 SXM).  No (S, D, N) state reaches device memory.
//
// Design: the TPU carries h across sequence blocks in VMEM scratch; here
// one block owns its channels for the whole sequence and a loop inside it
// replaces the grid's sequential axis.  A group of G lanes (G = N rounded
// up to a power of two, at most 32) serves one channel, one lane per state
// (NPL states a lane when N > 32), so B * D * G threads are in flight
// (131,072 at the falcon-mamba-7b widths, not 8,192 with one thread a
// channel); y_t is reduced over the group with __shfl_xor_sync.  A warp
// reads 32 consecutive elements of a and of bx per step.  Steps go in
// chunks of TS (4 at N <= 32); the next chunk's a, bx and c are loaded
// into registers before this chunk's arithmetic, so the sequential loop is
// not a chain of dependent loads.  Longer chunks cost registers, and so
// blocks an SM, for no more bytes in flight.  h = a * h + bx is a multiply
// and an add (the build's --fmad=false), as the plain PyTorch version
// computes it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_in(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_in(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T, int G, int NPL>
__global__ void __launch_bounds__(THREADS)
mamba_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                  const T* __restrict__ c, float* __restrict__ y, int S,
                  int D, int N) {
  constexpr int CH = THREADS / G;              // channels a block
  constexpr int TS = NPL >= 4 ? 1 : 4 / NPL;   // steps a chunk
  const int lane = threadIdx.x % G;
  const int d = blockIdx.x * CH + threadIdx.x / G;
  const int b = blockIdx.y;
  const bool live = d < D;
  const size_t step = (size_t)D * N;           // one step of a / bx
  const size_t ab_base = (size_t)b * S * step + (size_t)d * N;
  const size_t c_base = (size_t)b * S * N;
  const size_t y_base = (size_t)b * S * D + d;

  float h[NPL];
#pragma unroll
  for (int k = 0; k < NPL; ++k) h[k] = 0.0f;

  float ca[TS][NPL], cb[TS][NPL], cc[TS][NPL];
  float na[TS][NPL], nb[TS][NPL], nc[TS][NPL];
  auto fetch = [&](int t0, float (&fa)[TS][NPL], float (&fb)[TS][NPL],
                   float (&fc)[TS][NPL]) {
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const int t = t0 + s;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        const int n = lane + k * G;
        const bool in = t < S && n < N;
        const size_t i = ab_base + (size_t)t * step + n;
        fa[s][k] = in && live ? load_in(a, i) : 0.0f;
        fb[s][k] = in && live ? load_in(bx, i) : 0.0f;
        fc[s][k] = in ? load_in(c, c_base + (size_t)t * N + n) : 0.0f;
      }
    }
  };

  fetch(0, ca, cb, cc);
  for (int t0 = 0; t0 < S; t0 += TS) {
    fetch(t0 + TS, na, nb, nc);                // in flight during this chunk
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      float part = 0.0f;
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        h[k] = ca[s][k] * h[k] + cb[s][k];
        part += h[k] * cc[s][k];
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0 && live && t0 + s < S)
        y[y_base + (size_t)(t0 + s) * D] = part;
    }
#pragma unroll
    for (int s = 0; s < TS; ++s)
#pragma unroll
      for (int k = 0; k < NPL; ++k) {
        ca[s][k] = na[s][k];
        cb[s][k] = nb[s][k];
        cc[s][k] = nc[s][k];
      }
  }
}

template <typename T, int G, int NPL>
int launch(int B, int S, int D, int N, const void* a, const void* bx,
           const void* c, float* y, cudaStream_t stream) {
  constexpr int CH = THREADS / G;
  const dim3 grid((D + CH - 1) / CH, B);
  mamba_scan_kernel<T, G, NPL><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx),
      static_cast<const T*>(c), y, S, D, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int B, int S, int D, int N, const void* a, const void* bx,
             const void* c, float* y, cudaStream_t s) {
  if (N <= 1) return launch<T, 1, 1>(B, S, D, N, a, bx, c, y, s);
  if (N <= 2) return launch<T, 2, 1>(B, S, D, N, a, bx, c, y, s);
  if (N <= 4) return launch<T, 4, 1>(B, S, D, N, a, bx, c, y, s);
  if (N <= 8) return launch<T, 8, 1>(B, S, D, N, a, bx, c, y, s);
  if (N <= 16) return launch<T, 16, 1>(B, S, D, N, a, bx, c, y, s);
  if (N <= 32) return launch<T, 32, 1>(B, S, D, N, a, bx, c, y, s);
  if (N <= 64) return launch<T, 32, 2>(B, S, D, N, a, bx, c, y, s);
  if (N <= 128) return launch<T, 32, 4>(B, S, D, N, a, bx, c, y, s);
  if (N <= 256) return launch<T, 32, 8>(B, S, D, N, a, bx, c, y, s);
  return launch<T, 32, 16>(B, S, D, N, a, bx, c, y, s);
}

}  // namespace

extern "C" {

// y (B, S, D) float32 = scan(a, bx (B, S, D, N), c (B, S, N)); dtype 0 =
// float32, 1 = bfloat16 for a, bx and c.  Returns cudaGetLastError;
// cudaErrorInvalidValue for N outside 1..512.
int mamba_scan_launch(int B, int S, int D, int N, const void* a,
                      const void* bx, const void* c, void* y, int dtype,
                      void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  if (N <= 0 || N > 512) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
  return dtype == 1 ? launch_n<__nv_bfloat16>(B, S, D, N, a, bx, c, out, s)
                    : launch_n<float>(B, S, D, N, a, bx, c, out, s);
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
