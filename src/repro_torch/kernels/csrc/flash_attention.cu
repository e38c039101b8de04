// K6: flash attention with GQA, causal and sliding-window masks and a
// logit softcap (flash_attention_kernel), on Hopper's tensor cores.
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
// Bound: 4*D operations per unmasked (q, k) pair (2*D for q k^T, 2*D for
// p v) at the tensor cores' rate: 989 TFLOP/s in bfloat16, 495 TFLOP/s in
// TF32 for float32 (H100 SXM, 700 W).  At chip_smoke.py's cases: (a)
// 0.139 ms, (b) 0.833 ms, (c, bfloat16) 0.0695 ms, (d) 0.0663 ms.  float32
// runs 3xTF32, three TF32 products for each: that work alone takes (a)
// 0.416, (b) 2.50, (d) 0.199 ms at the same rate.  A second floor: one
// expf a pair, on the special-function units (16 a clock an SM, 4.18e12 a
// second at 1.98 GHz): (a, c) 0.064, (b) 0.193, (d) 0.031 ms.
//
// Design.  A block of two consumer warpgroups takes 128 query rows of one
// (b, h), 64 a warpgroup; q-tiles launch heaviest first, so the causal
// tail is short.  The q tile stays in shared memory for the whole kv loop;
// K and V tiles of BK keys stream through a ring of STAGES buffers, one
// item (K_j, then V_j) a buffer, filled by 16-byte cp.async, the copies of
// the next items in flight while the current one computes (one barrier an
// item).  All operands are in 128-byte swizzled atoms (hopper.cuh).
// - bfloat16: S = Q K^T is one wgmma.m64n64k16 chain from shared memory
//   (K is K-major over D as it lies), scaled in float32 after the product;
//   P goes to bfloat16 in registers and is the register A operand of
//   O += P V, with V read MN-major through imm-trans-b, no transposing
//   copy.
// - float32: 3xTF32, as K5 (gemm_pe.cu).  Each operand a = hi + lo with
//   hi = tf32(a), lo = tf32(a - hi); a product takes lo*hi + hi*lo + hi*hi
//   (lo*lo, below 2^-22 of it, is dropped).  The block splits q (scaled)
//   into shared memory once; a first pass (kv_split_kernel) splits k and
//   v, v transposed (TF32 wgmma takes K-major operands only), zero-padded
//   to whole tiles, so each is split once for all query heads of its
//   group.  P is split in registers.  The register A operand of TF32
//   holds keys q and q + 4 of each 8 where S's accumulator holds keys 2q
//   and 2q + 1, so the split pass writes each 8 keys of v^T in that order
//   and P needs no shuffle.  The tensor cores truncate as they
//   accumulate: S is summed from zero in chunks of 32 of D, the chunks
//   added in float32.
// - Softcap, masks and the online softmax run in the accumulator's
//   layout: a row lies on the 4 threads of a quad, so its max is two
//   __shfl_xor_sync; l stays a per-thread partial sum until the end.
//   Masks are evaluated only on tiles that cross a mask edge.  Each kv
//   tile's P V goes to a fresh accumulator, added after the alpha rescale
//   with one __fmaf_rn.
// - The kv loop stops at the causal horizon of the block's rows and, with
//   a window, starts at the first tile any of them can see.  Both
//   warpgroups run every tile of that range: where a tile lies outside
//   one warpgroup's own rows' horizon its keys all score -1e30 and change
//   no result, and a branch around wgmma that differs between warpgroups
//   makes the compiler serialize every wgmma of the kernel.
// Tiles: bfloat16 BK = 64, 4 stages (D <= 64: 48 KB, D <= 128: 96 KB of
// shared memory); at D <= 64 the kernel is held to 128 registers, so two
// blocks share an SM and one's softmax runs beside the other's products.
// float32 D <= 64: BK = 64, 4 stages: q's parts 64 KB + 4 x 32 KB = 192
// KB.  float32 D <= 128: q's parts alone take 128 KB, so BK = 32 and 3
// stages of 32 KB: 224 KB of the 227 KB a block may have.
// D is padded to 64 or 128 with zeros.  No fast math: the build keeps
// --fmad=false; expf, tanhf and the division are IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NWG = 2, THREADS = 128 * NWG, BQ = 64 * NWG;
constexpr float NEG_INF = -1e30f;

struct Params {
  int B, Hq, Hkv, S, D, causal, window;
  float softcap, scale;
  int Sp;                 // keys of the split k / v^T, padded (float32)
  size_t kv_plane;        // floats of one part of the split k (or v^T)
};

// ring geometry per (float32?, padded head dim)
template <bool F32, int DP>
struct Cfg {
  static constexpr int BK = (F32 && DP == 128) ? 32 : 64;
  static constexpr int STAGES = (F32 && DP == 128) ? 3 : 4;
  static constexpr int PARTS = F32 ? 2 : 1;
  static constexpr int EB = F32 ? 4 : 2;                  // bytes a value
  static constexpr int Q_PLANE = BQ * DP * EB;
  static constexpr int ITEM_PLANE = BK * DP * EB;
  static constexpr int ITEM = PARTS * ITEM_PLANE;
  static constexpr int SMEM = PARTS * Q_PLANE + STAGES * ITEM + 1024;
};
static_assert(Cfg<true, 128>::SMEM <= 232448, "227 KB a block");

// A tile of ROWS rows x CHUNKS 16-byte chunks (PLANES times, `plane`
// bytes apart in global memory) into 128-byte swizzled atoms at dst:
// [plane][chunk / 8][row][128 bytes].  Rows from valid_rows and chunks
// from valid_chunks on are zero-filled.
template <int PLANES, int ROWS, int CHUNKS>
__device__ __forceinline__ void copy_tile(uint32_t dst, const char* src,
                                          size_t plane, size_t ld,
                                          int valid_rows, int valid_chunks,
                                          int tid) {
  constexpr int N = PLANES * ROWS * CHUNKS;
  static_assert(N % THREADS == 0 && CHUNKS % 8 == 0, "whole atoms");
#pragma unroll
  for (int i = tid; i < N; i += THREADS) {
    const int c = i % CHUNKS, r = (i / CHUNKS) % ROWS;
    const int pl = i / (CHUNKS * ROWS);
    const bool ok = r < valid_rows && c < valid_chunks;
    const char* s = src + pl * plane + (size_t)r * ld + c * 16;
    cp_async16_zfill(dst + pl * (ROWS * CHUNKS * 16) + (c / 8) * (ROWS * 128)
                         + swz128(r, c % 8),
                     ok ? s : src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k, v (BH, S, D) float32 -> ks (2, BH, Sp, DP): k's TF32 parts, and vt
// (2, BH, DP, Sp): those of v transposed, column 8c + e holding key 8c +
// (e < 4 ? 2e : 2e - 7); zero-padded.  A block moves a 32 x 32 tile.
__global__ void kv_split_kernel(int S, int D, int Sp, int DP,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ ks,
                                float* __restrict__ vt) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;       // 32 x 8
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const size_t bh = blockIdx.z;
  const size_t plane = (size_t)gridDim.z * Sp * DP;
  const float* kb = k + bh * S * D;
  const float* vb = v + bh * S * D;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    const bool ok = r < S && c < D;
    const float x = ok ? kb[(size_t)r * D + c] : 0.0f;
    const uint32_t hi = tf32(x);
    const size_t o = (bh * Sp + r) * DP + c;
    ks[o] = __uint_as_float(hi);
    ks[plane + o] = __uint_as_float(tf32(x - __uint_as_float(hi)));
    tile[i][tx] = ok ? vb[(size_t)r * D + c] : 0.0f;
  }
  __syncthreads();
  const int e = tx & 7;
  const int key = (tx & ~7) | (e < 4 ? 2 * e : 2 * e - 7);
  for (int i = ty; i < 32; i += 8) {
    const float x = tile[key][i];
    const uint32_t hi = tf32(x);
    const size_t o = (bh * DP + c0 + i) * Sp + r0 + tx;
    vt[o] = __uint_as_float(hi);
    vt[plane + o] = __uint_as_float(tf32(x - __uint_as_float(hi)));
  }
}

template <bool F32, int DP>
__global__ void __launch_bounds__(THREADS, (!F32 && DP == 64) ? 2 : 1)
flash_attention_kernel(const void* __restrict__ q_,
                       const void* __restrict__ k_,
                       const void* __restrict__ v_,
                       const float* __restrict__ ks,
                       const float* __restrict__ vt, void* __restrict__ out_,
                       const Params p) {
  using C = Cfg<F32, DP>;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  constexpr int NS = BK / 2, NO = DP / 2;     // accumulator floats a thread
  constexpr int NP = F32 ? BK : BK / 4;       // P's A-operand registers

  extern __shared__ unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: align to it
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t qs = smem_addr(smem);
  const uint32_t ring = qs + C::PARTS * C::Q_PLANE;

  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, g = lane / 4, qd = lane % 4;
  const int S = p.S, D = p.D;
  const int n_qt = (S + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const size_t q_base = ((size_t)b * p.Hq + h) * S * D;
  const size_t bh_kv = (size_t)b * p.Hkv + hk;

  // the q tile: float32 scaled and split here, bfloat16 as it is
  if constexpr (F32) {
    const float* q = static_cast<const float*>(q_);
    for (int i = tid; i < BQ * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const float x = (q0 + r < S && c < D)
                          ? q[q_base + (size_t)(q0 + r) * D + c] * p.scale
                          : 0.0f;
      const uint32_t hi = tf32(x);
      const uint32_t off = (c / 32) * (BQ * 128) + swz128(r, (c % 32) / 4)
                           + (c % 4) * 4;
      *reinterpret_cast<uint32_t*>(smem + off) = hi;
      *reinterpret_cast<uint32_t*>(smem + C::Q_PLANE + off) =
          tf32(x - __uint_as_float(hi));
    }
  } else {
    copy_tile<1, BQ, DP / 8>(
        qs, static_cast<const char*>(q_) + (q_base + (size_t)q0 * D) * 2, 0,
        (size_t)D * 2, S - q0, D / 8, tid);
  }

  const int n_kv = (S + BK - 1) / BK;
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) / BK : 0;
  const int hi = p.causal ? min((q0 + BQ - 1) / BK + 1, n_kv) : n_kv;
  const int qa = q0 + 64 * wg, qb = qa + 63;     // this warpgroup's rows
  const int n_items = 2 * (hi - lo);

  // item 2t: K of tile lo + t; item 2t + 1: V of that tile
  auto load_item = [&](int it) {
    const uint32_t dst = ring + (it % STAGES) * C::ITEM;
    const int k0 = (lo + it / 2) * BK;
    if constexpr (F32) {
      const size_t plane = p.kv_plane * 4;
      if (!(it & 1))
        copy_tile<2, BK, DP / 4>(
            dst, reinterpret_cast<const char*>(ks + (bh_kv * p.Sp + k0) * DP),
            plane, (size_t)DP * 4, BK, DP / 4, tid);
      else
        copy_tile<2, DP, BK / 4>(
            dst, reinterpret_cast<const char*>(vt + bh_kv * DP * p.Sp + k0),
            plane, (size_t)p.Sp * 4, DP, BK / 4, tid);
    } else {
      const char* src = static_cast<const char*>((it & 1) ? v_ : k_)
                        + ((bh_kv * S + k0) * D) * 2;
      copy_tile<1, BK, DP / 8>(dst, src, 0, (size_t)D * 2, S - k0, D / 8,
                               tid);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_items) load_item(s);
    cp_async_commit();
  }

  float o[NO], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float alpha[2] = {1.0f, 1.0f};
  uint32_t pa[NP];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  const int warp = (tid % 128) / 32;
  const int row0 = qa + 16 * warp + g;       // and row0 + 8

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<STAGES - 2>();
    // this thread's copies (and the q tile's stores) visible to the
    // tensor cores; after the barrier, everyone's, and no warpgroup still
    // reads the buffer refilled below (each waited for its wgmmas)
    fence_proxy_async();
    __syncthreads();
    const int k0 = (lo + it / 2) * BK;
    const uint32_t cur = ring + (it % STAGES) * C::ITEM;
    auto refill = [&]() {
      if (it + STAGES - 1 < n_items) load_item(it + STAGES - 1);
      cp_async_commit();
    };

    if (!(it & 1)) {
      // ---- S = Q K^T, softcap, masks, online softmax -> P ----
      float s[NS];
      if constexpr (F32) {
        constexpr int NC = DP / 32;         // chunks of 32 of D
        float part[NC][NS];
        {
          wgmma_fence();
#pragma unroll
          for (int c = 0; c < NC; ++c)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t qa_ = qs + c * (BQ * 128) + wg * 64 * 128
                                   + kk * 32;
              const uint32_t kb_ = cur + c * (BK * 128) + kk * 32;
              const uint64_t ah = smem_desc(qa_);
              const uint64_t al = smem_desc(qa_ + C::Q_PLANE);
              const uint64_t bh = smem_desc(kb_);
              const uint64_t bl = smem_desc(kb_ + C::ITEM_PLANE);
              wgmma_tf32_ss<BK>(part[c], al, bh, kk);   // small terms first
              wgmma_tf32_ss<BK>(part[c], ah, bl, 1);
              wgmma_tf32_ss<BK>(part[c], ah, bh, 1);
            }
          wgmma_commit();
        }
        refill();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          s[i] = part[0][i];
#pragma unroll
          for (int c = 1; c < NC; ++c) s[i] += part[c][i];
        }
      } else {
        {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            const uint64_t a = smem_desc(qs + (kk / 4) * (BQ * 128)
                                         + wg * 64 * 128 + (kk % 4) * 32);
            const uint64_t bd = smem_desc(cur + (kk / 4) * (BK * 128)
                                          + (kk % 4) * 32);
            wgmma_bf16_ss<BK>(s, a, bd, kk);
          }
          wgmma_commit();
        }
        refill();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < NS; ++i) s[i] *= p.scale;
      }

      const bool edge = (p.causal && k0 + BK - 1 > qa) ||
                        (p.window > 0 && k0 <= qb - p.window) ||
                        k0 + BK > S;
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;               // row0 or row0 + 8
        float x = s[i];
        if (p.softcap != 0.0f) x = p.softcap * tanhf(x / p.softcap);
        if (edge) {
          const int kp = k0 + 8 * (i / 4) + 2 * qd + (i & 1);
          const int qp = row0 + 8 * r;
          bool ok = kp < S;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window > 0) ok = ok && kp > qp - p.window;
          x = ok ? x : NEG_INF;
        }
        s[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = expf(s[i] - m[r]);
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], sum[r]);

      // P as the A operand of P V
      if constexpr (F32) {
        // per 8 keys: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4) of
        // the TF32 operand are keys 2q, 2q, 2q + 1, 2q + 1 of S; parts
        // hi at [4jj ..], lo at [BK / 2 + 4jj ..]
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj) {
          const float x[4] = {s[4 * jj], s[4 * jj + 2], s[4 * jj + 1],
                              s[4 * jj + 3]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t h_ = tf32(x[e]);
            pa[4 * jj + e] = h_;
            pa[BK / 2 + 4 * jj + e] = tf32(x[e] - __uint_as_float(h_));
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < NP; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      }
    } else {
      // ---- O = O * alpha + P V ----
      float f[NO];
      {
        wgmma_fence();
        if constexpr (F32) {
#pragma unroll
          for (int jj = 0; jj < BK / 8; ++jj) {
            const uint32_t vb_ = cur + (jj / 4) * (DP * 128) + (jj % 4) * 32;
            const uint64_t bh = smem_desc(vb_);
            const uint64_t bl = smem_desc(vb_ + C::ITEM_PLANE);
            wgmma_tf32_rs<DP>(f, &pa[BK / 2 + 4 * jj], bh, jj);
            wgmma_tf32_rs<DP>(f, &pa[4 * jj], bl, 1);
            wgmma_tf32_rs<DP>(f, &pa[4 * jj], bh, 1);
          }
        } else {
#pragma unroll
          for (int t = 0; t < BK / 16; ++t)
            wgmma_bf16_rs_tb<DP>(f, &pa[4 * t],
                                 smem_desc_mn(cur + t * 16 * 128, BK * 128),
                                 t);
        }
        wgmma_commit();
      }
      refill();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NO; ++i)
        o[i] = __fmaf_rn(o[i], alpha[(i >> 1) & 1], f[i]);
    }
  }
  cp_async_wait<0>();

  if (qa >= S) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qp = row0 + 8 * r;
    if (qp >= S) continue;
    const float den = fmaxf(lr, 1e-30f);
    const size_t base = q_base + (size_t)qp * D;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * c + 2 * qd + e;
        if (col >= D) continue;
        const float y = o[4 * c + 2 * r + e] / den;
        if constexpr (F32)
          static_cast<float*>(out_)[base + col] = y;
        else
          static_cast<__nv_bfloat16*>(out_)[base + col] =
              __float2bfloat16_rn(y);
      }
  }
}

template <bool F32, int DP>
int launch(const Params& p, const void* q, const void* k, const void* v,
           float* scratch, void* out, cudaStream_t stream) {
  using C = Cfg<F32, DP>;
  float* ks = scratch;
  float* vt = F32 ? scratch + 2 * p.kv_plane : nullptr;
  if (F32)
    kv_split_kernel<<<dim3(DP / 32, p.Sp / 32, p.B * p.Hkv), dim3(32, 8), 0,
                      stream>>>(p.S, p.D, p.Sp, DP,
                                static_cast<const float*>(k),
                                static_cast<const float*>(v), ks, vt);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<F32, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  flash_attention_kernel<F32, DP><<<grid, THREADS, C::SMEM, stream>>>(
      q, k, v, ks, vt, out, p);
  return static_cast<int>(cudaGetLastError());
}

int padded_dim(int D) { return D <= 64 ? 64 : 128; }
int padded_keys(int S) { return (S + 63) / 64 * 64; }

}  // namespace

extern "C" {

// float32 scratch the launch needs for B * Hkv kv heads: the split k and
// v^T (2 parts each) for float32 (dtype 0), none for bfloat16 (dtype 1)
long long flash_attention_scratch_floats(int BHkv, int S, int D,
                                         int dtype) {
  if (dtype == 1 || S <= 0) return 0;
  return 4LL * BHkv * padded_keys(S) * padded_dim(D);
}

// out (B, Hq, S, D) = attention(q, k, v); dtype 0 = float32, 1 = bfloat16
// for all four tensors, all 16-byte aligned; scratch of
// flash_attention_scratch_floats.  Returns cudaGetLastError (or the error
// of the shared-memory attribute); cudaErrorInvalidValue for D outside
// 1..128 (bfloat16: not a multiple of 8) or Hq not a multiple of Hkv.
int flash_attention_launch(int B, int Hq, int Hkv, int S, int D,
                           const void* q, const void* k, const void* v,
                           void* scratch, void* out, int dtype, int causal,
                           int window, float softcap, float scale,
                           void* stream) {
  if (B <= 0 || Hq <= 0 || S <= 0) return 0;
  if (D <= 0 || D > 128 || Hkv <= 0 || Hq % Hkv != 0 ||
      (dtype == 1 && D % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int DP = padded_dim(D), Sp = padded_keys(S);
  const Params p{B, Hq, Hkv, S, D, causal, window, softcap, scale, Sp,
                 (size_t)B * Hkv * Sp * DP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(scratch);
  if (dtype == 1)
    return DP == 64 ? launch<false, 64>(p, q, k, v, f, out, s)
                    : launch<false, 128>(p, q, k, v, f, out, s);
  return DP == 64 ? launch<true, 64>(p, q, k, v, f, out, s)
                  : launch<true, 128>(p, q, k, v, f, out, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
