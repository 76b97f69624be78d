// Int8 fused ConvNeXt block for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_convnext.py::convnext_block_fused_int8,
// the Pallas TPU kernel of the int8 A/B. One call computes a whole ConvNeXt
// block on x (B, T, C) with both pointwise products in int8 x int8 -> int32:
//
//   h    = LayerNorm_f32(dwconv7(x) + dwb)                   eps 1e-6
//   hq   = round(h * (127 / amax_row(h))), hs = amax * (1/127)    per frame
//   u    = gelu_as(((f32(hq @ W1q) * hs) * s1) + b1)         A-S erf, as JAX
//   uq   = round(u * (127 / amax_row(u))), us = amax * (1/127)    per frame
//   out  = x + gamma * (((f32(uq @ W2q) * us) * s2) + b2)     x's dtype
//
// W1q (C, I) and W2q (I, C) are the per-output-channel int8 codes with scales
// s1 (I,) and s2 (C,), packed once by the wrapper (ops/fused_convnext.py::
// kernel_weights_int8) into the shared-memory images that wgmma reads.
//
// Arithmetic. The int32 sums are exact in any order. Every other step is
// written with the round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc cannot fuse a multiply and an add into one
// FMA, in the order of the plain twin (ops/fused_convnext.py::
// convnext_block_int8_reference): the dwconv taps k = 0..6 and then the bias;
// the LayerNorm sums by halves (s[i] + s[i + n/2], the odd last element
// carried), its 1/sqrt as a division by a rounded square root; rounding
// half to even (rintf). The twin does the same with PyTorch's elementwise
// operators, so on the card the two agree bit for bit wherever expf does.
//
// Bound on this card: operations. The two products take 4*B*T*C*I int8
// operations; at the WaveNeXt trunk's A/B shape (B=32, T=1792, C=384, I=1152)
// 1.0e11, 0.051 ms at the 1,979 TOP/s int8 dense peak, against 88 MB of bf16
// activations in and out, 0.026 ms at 3.35 TB/s. This kernel does 1.5x those
// operations (below); the bound counts the function's work only.
//
// Design: B1's pipeline (convnext_block.cu) on int8 operands.
// - one block per (item, 64-frame tile) and three warpgroups: warpgroups 0
//   and 1 compute, one thread of warpgroup 2 streams the weight ring;
// - the pack: for each 128-wide chunk j of I (I rounded up to 128 with zero
//   codes), the W1 chunk image and then the W2 chunk image, C x 128 bytes
//   each, K-major with 128-byte swizzled rows (128 int8 of K to a row, a k32
//   step is 32 bytes, as a k16 step of bf16 is in B1). One cp.async.bulk
//   fills a slot and completes on its `full` mbarrier; the producer refills
//   a slot once the eight consumer warps have arrived on its `empty` one;
// - prologue, by all twelve warps, two frames at a time, before the roles
//   split (the producer's first slots load meanwhile): dwconv + LayerNorm +
//   the first quantizer; lane l holds channels l + 32 m, so the twin's
//   sums by halves run in registers and shuffles (`tree_sum_warp`); the
//   codes go straight into the swizzled hq tile, the scales into shared
//   memory;
// - the second quantizer needs the amax of a whole row of u (all I columns)
//   before any of the row can be quantized, and a (64, I) float32 u tile
//   does not fit (288 KiB at I = 1152 against 227 KB). So product 1 runs
//   twice:
//   pass A: for each chunk j, S_w = hq @ W1_j[:, 64w : 64w + 64] (wgmma
//     m64n64k32 s8) and each row's running max of |u|, u = gelu(dequant(S)),
//     taking the GELU only of the thread's largest value in the chunk where
//     that decides the max (`row_amax_update`; exact, with a path that takes
//     every GELU when it does not); the maxima meet within each quad by
//     shuffles and across the two warpgroups in shared memory. max is exact
//     in any order, and pass B computes each u bit for bit as pass A would;
//   pass B: B1's loop with codes in place of G: S_w = hq @ W1_j, then
//     acc_w += uq_{j-1} @ W2_{j-1}[:, wC/2 : (w+1)C/2] (m64n(C/2)k32) left
//     running while the warpgroup takes the GELU of S_w and quantizes its
//     half of uq_j (double buffered, swizzled); uq_{-1} is zeros, so every
//     pass has the same shape, and the last second product follows the loop.
//   The ring streams W1_0 .. W1_{n-1}, then W1_0, W2_0, W1_1, W2_1, ...
// - epilogue: out = x + gamma * dequant(acc) from the int32 accumulator
//   registers (the same fragment layout as float32), rows past T not stored.
// Why recompute product 1, and not a 2-block cluster that splits I and
// keeps each half of u in shared memory (one GELU pass, option (b)): this
// is B1's loop with one pass added, and once pass A takes the GELU of one
// value in 16 it costs its products and little more (PERF.md); the
// cluster would hold 147 KB of u at I = 1152, leave about 50 KB for the
// ring (two 24 KB slots at C = 384), run the prologue twice, and need a
// larger cluster past I = 1152. It was not built. Tried and dropped
// (scripts/b2_variants.py): issuing S_{j+1} before the GELU of S_j, with
// two S register sets, ran slower in every form.
//
// Budgets at C = 384: shared memory hq 24 KB + uq 2 x 8 KB + 1 KB of row
// scales + 3 slots x 48 KB = 185 KB, plus the barriers and 1 KB of
// alignment slack: one block per SM. C = 256 runs 6 slots of 32 KB, C = 128
// 8 of 16 KB. Registers: 168 a thread for the prologue (one block of 384
// threads per SM), then setmaxnreg gives the producer's warpgroup 40 and the
// consumers 232; a consumer thread holds its share of the 64 x C/2 int32
// accumulator (96 at C = 384) and of the 64 x 64 S tile (32).
//
// Shapes taken: C in {128, 256, 384} (a template argument), I a multiple of
// 64, any T >= 1, x in f32 or bf16. The caller checks shapes and types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 64;          // frames per block: one wgmma M
constexpr int IC = 128;         // intermediate channels per chunk: one swizzle row of int8
constexpr int HALO = 3;         // k = 7 depthwise conv
constexpr int CONSUMERS = 2;    // computing warpgroups
constexpr int NTHREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_WARPS = CONSUMERS * 4;
constexpr int MAX_STAGES = 8;
constexpr int PROLOGUE_FRAMES = 2;  // frames a warp takes at a time: 32 pairs over 12 warps

// The constants of the JAX function, rounded from double as PyTorch and XLA
// round a Python float to float32.
constexpr float EPS = static_cast<float>(1e-6);
constexpr float AMAX_MIN = static_cast<float>(1e-12);
constexpr float INV127 = static_cast<float>(1.0 / 127.0);
constexpr float INV_SQRT2 = static_cast<float>(0.7071067811865475);  // 1 / sqrt(2)
constexpr float A1 = static_cast<float>(0.254829592), A2 = static_cast<float>(-0.284496736),
                A3 = static_cast<float>(1.421413741), A4 = static_cast<float>(-1.453152027),
                A5 = static_cast<float>(1.061405429), P = static_cast<float>(0.3275911);

// Shared-memory layout, in bytes from a 1024-byte-aligned base.
template <int C>
struct Layout {
  static constexpr int SLOT = C * IC;        // one W1 or W2 chunk image
  static constexpr int HQ_BYTES = TM * C;    // C / 128 K-blocks of 64 rows
  static constexpr int UQ_BYTES = TM * IC;
  static constexpr int HQ_OFF = 0;
  static constexpr int UQ_OFF = HQ_OFF + HQ_BYTES;
  static constexpr int ROWS_OFF = UQ_OFF + 2 * UQ_BYTES;  // hs[64], row maxima[2][64]
  static constexpr int RING_OFF = ROWS_OFF + 1024;
  static constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - BAR_BYTES - RING_OFF) / SLOT;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * SLOT;
  static constexpr int BYTES = BAR_OFF + BAR_BYTES + 1024;  // + slack to align the base
  static_assert(C % 128 == 0, "hq's K-blocks are 128 codes");
  static_assert(STAGES >= 2, "the ring needs two slots");
  static_assert(BYTES <= SMEM_LIMIT, "a block may use at most 227 KB of shared memory");
};

__device__ __forceinline__ void consumers_sync() { named_sync<CONSUMERS * 128>(); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The A-S 7.1.26 erf of the JAX kernel (pallas_convnext.py::_erf), its
// operations in the same order.
__device__ __forceinline__ float erf_as(float x) {
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(P, ax)));
  float poly = __fadd_rn(A4, __fmul_rn(t, A5));
  poly = __fadd_rn(A3, __fmul_rn(t, poly));
  poly = __fadd_rn(A2, __fmul_rn(t, poly));
  poly = __fadd_rn(A1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  // copysignf(r, x) = sign(x) * r wherever x != 0; at x = 0 the GELU's
  // factor u is 0 and the GELU is the same signed zero either way
  return copysignf(__fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))), x);
}

__device__ __forceinline__ float gelu_as(float u) {
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, erf_as(__fmul_rn(u, INV_SQRT2))));
}

// ((f32(acc) * row_scale) * col_scale) + bias, no FMA
__device__ __forceinline__ float dequant(int acc, float row_scale, float col_scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), row_scale), col_scale), bias);
}

__device__ __forceinline__ int quant(float v, float inv) {
  return static_cast<int>(rintf(__fmul_rn(v, inv)));
}

// u of the two adjacent columns col, col + 1 (col even) from their int32
// sums a0, a1 at row scale hs; columns at or past I are padding and give 0.
__device__ __forceinline__ float2 gelu_pair(int a0, int a1, float hs, int col, int inter,
                                            const float* __restrict__ s1,
                                            const float* __restrict__ b1) {
  if (col >= inter) return make_float2(0.f, 0.f);  // I is a multiple of 64: both columns or neither
  const float2 sc = *reinterpret_cast<const float2*>(s1 + col);
  const float2 bi = *reinterpret_cast<const float2*>(b1 + col);
  return make_float2(gelu_as(dequant(a0, hs, sc.x, bi.x)), gelu_as(dequant(a1, hs, sc.y, bi.y)));
}

// The bound of |gelu(v)| for v < 0: the A-S GELU's least value is -0.169971
// (at v = -0.7518), and its float32 evaluation stays within 1e-6 of it.
constexpr float NEG_GELU_BOUND = 0.1701f;
constexpr float BAND = 1.0f - 1.0f / 1024.0f;

// max(amax, |gelu(v)|) over the 16 values v = dequant(S) of row h in this
// thread's columns col .. col + 1, col + 8 .. col + 9, ... of a chunk,
// exactly as if every gelu(v) were computed, from the GELU of the largest v
// alone where that decides it. For 0 <= v1 < v2 * (1 - 2^-10) the computed
// gelu(v1) < gelu(v2): the exact A-S GELU grows at least as fast as v there,
// and its float32 evaluation is within 1e-5 of it, relatively. For v < 0,
// |gelu(v)| <= min(|v| / 2, NEG_GELU_BOUND). Any value that neither rule
// settles (a second v within 2^-10 of the largest, a largest v <= 0, or a
// negative v whose bound reaches the running amax) sends the row down the
// path that computes every GELU.
__device__ __forceinline__ float row_amax_update(const int (&s)[32], int h, float hs, int col,
                                                 const float* __restrict__ s1,
                                                 const float* __restrict__ b1, float amax) {
  float v[16];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 sc = *reinterpret_cast<const float2*>(s1 + col + 8 * jj);
    const float2 bi = *reinterpret_cast<const float2*>(b1 + col + 8 * jj);
    v[2 * jj] = dequant(s[4 * jj + 2 * h], hs, sc.x, bi.x);
    v[2 * jj + 1] = dequant(s[4 * jj + 2 * h + 1], hs, sc.y, bi.y);
  }
  float vmax = v[0], vmin = v[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) {
    vmax = fmaxf(vmax, v[i]);
    vmin = fminf(vmin, v[i]);
  }
  const float top = fmaxf(amax, fabsf(gelu_as(vmax)));
  const float thr = vmax * BAND;
  bool slow = !(vmax > 0.f) || fminf(-0.5f * vmin, NEG_GELU_BOUND) > top;
#pragma unroll
  for (int i = 0; i < 16; ++i) slow |= v[i] >= thr && v[i] != vmax;
  if (!slow) return top;
#pragma unroll
  for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(gelu_as(v[i])));
  return amax;
}

// S_w = hq @ W1 chunk (the slot at w1_slot)[:, 64w : 64w + 64], depth C.
template <int C>
__device__ __forceinline__ void first_product(int (&s)[32], uint32_t hq_addr, uint32_t w1_slot,
                                              int w) {
  const uint32_t b_base = w1_slot + w * 64 * ROW;
#pragma unroll
  for (int k = 0; k < C / 32; ++k) {
    const uint32_t a = hq_addr + (k / 4) * (TM * ROW) + (k % 4) * 32;
    const uint32_t b = b_base + (k / 4) * (IC * ROW) + (k % 4) * 32;
    wgmma_s8<64>(s, smem_desc(a), smem_desc(b), k > 0);
  }
}

// acc_w += uq (64 x 128, at uq_addr) @ W2 chunk (at w2_slot)[:, wC/2 : (w+1)C/2]
template <int C>
__device__ __forceinline__ void second_product(int (&acc)[C / 4], uint32_t uq_addr,
                                               uint32_t w2_slot, int w) {
  const uint32_t b_base = w2_slot + w * (C / 2) * ROW;
#pragma unroll
  for (int k = 0; k < IC / 32; ++k)
    wgmma_s8<C / 2>(acc, smem_desc(uq_addr + k * 32), smem_desc(b_base + k * 32), 1);
}

constexpr unsigned FULL = 0xffffffffu;

// Sum of the warp's N values by halves, in the twin's `_tree_sum` order
// (s[i] + s[i + n/2], the odd last element carried to s[n/2]), with value i
// in v[i / 32] of lane i % 32. A level whose half is a multiple of 32 adds
// within each lane; any other takes each partner from lane (lane + half) % 32
// by shuffles. Every lane returns the total.
template <int N, int M>
__device__ __forceinline__ float tree_sum_warp(float (&v)[M], int lane) {
  if constexpr (N == 1) {
    return __shfl_sync(FULL, v[0], 0);
  } else {
    constexpr int HALF = N / 2, NEXT = HALF + (N & 1);
    constexpr int SLOTS = (N + 31) / 32, NEXT_SLOTS = (NEXT + 31) / 32;
    const float last = (N & 1) ? __shfl_sync(FULL, v[(N - 1) / 32], (N - 1) % 32) : 0.f;
    if constexpr (HALF % 32 == 0) {
#pragma unroll
      for (int m = 0; m < HALF / 32; ++m) v[m] = __fadd_rn(v[m], v[m + HALF / 32]);
    } else {
      constexpr int SQ = HALF / 32, SH = HALF % 32;
      const int src = (lane + SH) & 31;
      const bool wrap = lane + SH >= 32;  // the partner lies one slot further on
      float next[NEXT_SLOTS];
#pragma unroll
      for (int m = 0; m < NEXT_SLOTS; ++m) {
        const float p0 = m + SQ < SLOTS ? __shfl_sync(FULL, v[m + SQ < M ? m + SQ : 0], src) : 0.f;
        const float p1 =
            m + SQ + 1 < SLOTS ? __shfl_sync(FULL, v[m + SQ + 1 < M ? m + SQ + 1 : 0], src) : 0.f;
        next[m] = __fadd_rn(v[m], wrap ? p1 : p0);
      }
#pragma unroll
      for (int m = 0; m < NEXT_SLOTS; ++m) v[m] = next[m];
    }
    if constexpr (N & 1) {
      if (lane == HALF % 32) v[HALF / 32] = last;
    }
    return tree_sum_warp<NEXT, M>(v, lane);
  }
}

// Depthwise conv + LayerNorm + first quantizer of frames r0 .. r0 + F - 1
// by one warp: lane l holds channels l + 32 m, slides an (F + 6)-frame
// window over them, and sums each frame's row with `tree_sum_warp`. The
// codes go into the swizzled hq tile (zeros for a frame at or past T), the
// scales into hs_s.
template <int C, int F, typename T>
__device__ __forceinline__ void prologue_frames(
    const T* __restrict__ xb, unsigned char* hq_s, float* hs_s, const float* __restrict__ dw,
    const float* __restrict__ dwb, const float* __restrict__ lnw, const float* __restrict__ lnb,
    int t0, int t_len, int r0, int lane) {
  constexpr int M = C / 32;
  float acc[F][M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int c = lane + 32 * m;
    float win[F + 2 * HALO];
#pragma unroll
    for (int u = 0; u < F + 2 * HALO; ++u) {
      const int t = t0 + r0 + u - HALO;
      win[u] = (t >= 0 && t < t_len) ? to_f32(xb[static_cast<size_t>(t) * C + c]) : 0.f;
    }
    float wk[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) wk[k] = dw[k * C + c];
    const float bias = dwb[c];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) a = __fadd_rn(a, __fmul_rn(win[f + k], wk[k]));
      acc[f][m] = __fadd_rn(a, bias);
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int r = r0 + f;
    float s[M];
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] = acc[f][m];
    const float mean = __fdiv_rn(tree_sum_warp<C>(s, lane), static_cast<float>(C));
#pragma unroll
    for (int m = 0; m < M; ++m) {
      acc[f][m] = __fsub_rn(acc[f][m], mean);
      s[m] = __fmul_rn(acc[f][m], acc[f][m]);
    }
    const float var = __fdiv_rn(tree_sum_warp<C>(s, lane), static_cast<float>(C));
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, EPS)));
    float amax = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = lane + 32 * m;
      acc[f][m] = __fadd_rn(__fmul_rn(__fmul_rn(acc[f][m], rstd), lnw[c]), lnb[c]);
      amax = fmaxf(amax, fabsf(acc[f][m]));
    }
    amax = fmaxf(warp_max(amax), AMAX_MIN);
    const float inv = __fdiv_rn(127.f, amax);
    const bool live = t0 + r < t_len;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = lane + 32 * m;
      hq_s[swizzle((c / IC) * (TM * ROW) + r * ROW + c % IC)] =
          live ? static_cast<unsigned char>(static_cast<int8_t>(quant(acc[f][m], inv))) : 0;
    }
    if (lane == 0) hs_s[r] = live ? __fmul_rn(amax, INV127) : 0.f;
  }
}

// The packed image (chunk * 2 + 0 for W1, + 1 for W2) that the producer
// streams as ring item q of 3n: W1_0 .. W1_{n-1} for pass A, then W1_0, W2_0,
// W1_1, W2_1, ... for pass B.
__device__ __forceinline__ int ring_image(int q, int n) { return q < n ? 2 * q : q - n; }

template <int C, typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
convnext_block_int8_kernel(const T* __restrict__ x, T* __restrict__ out,
                           const float* __restrict__ dw, const float* __restrict__ dwb,
                           const float* __restrict__ lnw, const float* __restrict__ lnb,
                           const int8_t* __restrict__ packed, const float* __restrict__ s1,
                           const float* __restrict__ b1, const float* __restrict__ s2,
                           const float* __restrict__ b2, const float* __restrict__ gamma,
                           int t_len, int inter) {
  using L = Layout<C>;
  constexpr int S = L::STAGES;
  constexpr int N2 = C / 2;  // output columns per consumer warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + MAX_STAGES;
  float* hs_s = reinterpret_cast<float*>(smem + L::ROWS_OFF);
  float* rmax_s = hs_s + TM;  // [warpgroup][row]
  const int n_chunks = (inter + IC - 1) / IC;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const T* xb = x + static_cast<size_t>(item) * t_len * C;
  T* ob = out + static_cast<size_t>(item) * t_len * C;
  const int lane = threadIdx.x % 32;

  // -- prologue, all twelve warps, while the producer's first slots load -----
  if (threadIdx.x == CONSUMERS * 128)
    for (int q = 0; q < S && q < 3 * n_chunks; ++q) {
      mbar_expect_tx(&full[q], L::SLOT);
      const size_t image = ring_image(q, n_chunks);
      bulk_load(smem + L::RING_OFF + q * L::SLOT, packed + image * L::SLOT, L::SLOT, &full[q]);
    }
  for (int g = threadIdx.x / 32; g < TM / PROLOGUE_FRAMES; g += NTHREADS / 32)
    prologue_frames<C, PROLOGUE_FRAMES, T>(xb, smem + L::HQ_OFF, hs_s, dw, dwb, lnw, lnb, t0, t_len,
                                           g * PROLOGUE_FRAMES, lane);
  // uq_{-1} = 0: pass B's first second product adds nothing, so every pass
  // issues, commits and waits alike (branches between the wgmma groups make
  // ptxas serialize them, its warning C7514)
  for (int e = threadIdx.x; e < L::UQ_BYTES / 16; e += NTHREADS)
    reinterpret_cast<uint4*>(smem + L::UQ_OFF + L::UQ_BYTES)[e] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  __syncthreads();

  if (wg == CONSUMERS) {
    // -- producer: the rest of W1_0 .. W1_{n-1} (pass A), then W1_0, W2_0,
    // W1_1, ... (pass B); its warpgroup gives up registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      for (int q = S; q < 3 * n_chunks; ++q) {
        const int s = q % S;
        mbar_wait(&empty[s], (q / S - 1) & 1);
        mbar_expect_tx(&full[s], L::SLOT);
        const size_t image = ring_image(q, n_chunks);
        bulk_load(smem + L::RING_OFF + s * L::SLOT, packed + image * L::SLOT, L::SLOT, &full[s]);
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int warp = threadIdx.x / 32;  // 0..7
  const int w = wg;                   // which half of S's and of the output's columns
  const int wq = warp % 4;            // warp within the warpgroup: rows 16 wq .. 16 wq + 15

  const uint32_t hq_addr = smem_u32(smem + L::HQ_OFF);
  const uint32_t uq_addr = smem_u32(smem + L::UQ_OFF);
  const uint32_t ring = smem_u32(smem + L::RING_OFF);
  int rows[2];
  float hs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = 16 * wq + lane / 4 + 8 * h;
    hs[h] = hs_s[rows[h]];
  }
  const int col0 = w * 64 + 2 * (lane % 4);  // this thread's first column within a chunk
  int s_reg[32];

  // -- pass A: each row's amax of |u| ----------------------------------------
  float rmax[2] = {0.f, 0.f};
  for (int j = 0; j < n_chunks; ++j) {
    const int sa = j % S;
    mbar_wait(&full[sa], (j / S) & 1);
    wgmma_fence();
    first_product<C>(s_reg, hq_addr, ring + sa * L::SLOT, w);
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[sa]);
    if (j * IC + w * 64 < inter)  // else this half of the last chunk is padding
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rmax[h] = row_amax_update(s_reg, h, hs[h], j * IC + col0, s1, b1, rmax[h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
    if (lane % 4 == 0) rmax_s[w * TM + rows[h]] = rmax[h];
  }
  consumers_sync();
  float inv[2], us[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float amax = fmaxf(fmaxf(rmax_s[rows[h]], rmax_s[TM + rows[h]]), AMAX_MIN);
    inv[h] = __fdiv_rn(127.f, amax);
    us[h] = __fmul_rn(amax, INV127);
  }

  // -- pass B: u again, its codes, and acc += uq @ W2q -------------------------
  int acc[N2 / 2];
#pragma unroll
  for (int i = 0; i < N2 / 2; ++i) acc[i] = 0;
  for (int j = 0; j < n_chunks; ++j) {
    const int qa = n_chunks + 2 * j, sa = qa % S;  // W1_j
    const int qb = qa - 1, sb = qb % S;            // W2_{j-1}
    mbar_wait(&full[sa], (qa / S) & 1);
    if (j > 0) mbar_wait(&full[sb], (qb / S) & 1);
    wgmma_fence();
    first_product<C>(s_reg, hq_addr, ring + sa * L::SLOT, w);
    wgmma_commit();
    // acc_w += uq_{j-1} @ W2_{j-1}, left running. For j = 0, uq_{-1} = 0
    // against the ring's first slot: int8 codes times zero add nothing,
    // whatever the slot holds
    second_product<C>(acc, uq_addr + ((j + 1) % 2) * L::UQ_BYTES,
                      ring + (j > 0 ? sb : 0) * L::SLOT, w);
    wgmma_commit();
    wgmma_wait<1>();  // S_w is in; the second product may still run
    if (lane == 0) mbar_arrive(&empty[sa]);
    unsigned char* uq_s = smem + L::UQ_OFF + (j % 2) * L::UQ_BYTES;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = col0 + 8 * jj;
        const int i = 4 * jj + 2 * h;
        const float2 u = gelu_pair(s_reg[i], s_reg[i + 1], hs[h], j * IC + n, inter, s1, b1);
        const uint32_t lo = static_cast<uint8_t>(static_cast<int8_t>(quant(u.x, inv[h])));
        const uint32_t hi = static_cast<uint8_t>(static_cast<int8_t>(quant(u.y, inv[h])));
        *reinterpret_cast<uint16_t*>(uq_s + swizzle(rows[h] * ROW + n)) =
            static_cast<uint16_t>(lo | (hi << 8));
      }
    wgmma_wait<0>();
    if (j > 0 && lane == 0) mbar_arrive(&empty[sb]);
    fence_async_smem();
    consumers_sync();  // uq_j whole, uq_{j-1} read by both warpgroups
  }
  {  // the last chunk's second product
    const int qb = 3 * n_chunks - 1, sb = qb % S;
    mbar_wait(&full[sb], (qb / S) & 1);
    wgmma_fence();
    second_product<C>(acc, uq_addr + ((n_chunks + 1) % 2) * L::UQ_BYTES, ring + sb * L::SLOT, w);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // -- epilogue: out = x + gamma * dequant(acc), in x's dtype ----------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + rows[h];
    if (t >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < N2 / 8; ++jj) {
      const int c = w * N2 + 8 * jj + 2 * (lane % 4);
      const size_t idx = static_cast<size_t>(t) * C + c;
      const float2 g = *reinterpret_cast<const float2*>(gamma + c);
      const float2 sc = *reinterpret_cast<const float2*>(s2 + c);
      const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
      const float h0 = dequant(acc[4 * jj + 2 * h], us[h], sc.x, bb.x);
      const float h1 = dequant(acc[4 * jj + 2 * h + 1], us[h], sc.y, bb.y);
      if constexpr (sizeof(T) == 4) {
        const float2 xv = *reinterpret_cast<const float2*>(xb + idx);
        *reinterpret_cast<float2*>(ob + idx) =
            make_float2(__fadd_rn(xv.x, __fmul_rn(g.x, h0)), __fadd_rn(xv.y, __fmul_rn(g.y, h1)));
      } else {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xb + idx));
        *reinterpret_cast<__nv_bfloat162*>(ob + idx) = __floats2bfloat162_rn(
            __fadd_rn(xv.x, __fmul_rn(g.x, h0)), __fadd_rn(xv.y, __fmul_rn(g.y, h1)));
      }
    }
  }
}

template <int C, typename T>
cudaError_t launch(const void* x, void* out, const void* dw, const void* dwb, const void* lnw,
                   const void* lnb, const void* packed, const void* s1, const void* b1,
                   const void* s2, const void* b2, const void* gamma, int batch, int t_len,
                   int inter, cudaStream_t stream) {
  using L = Layout<C>;
  auto kernel = convnext_block_int8_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TM - 1) / TM, batch);
  kernel<<<grid, NTHREADS, L::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const int8_t*>(packed),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const float*>(s2), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), t_len, inter);
  return cudaGetLastError();
}

// Calls f(Width<C>()) for the instantiated width C, or returns
// cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_channels(int channels, F&& f) {
  switch (channels) {
    case 128: return f(Width<128>());
    case 256: return f(Width<256>());
    case 384: return f(Width<384>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). x_bf16 selects the type of
// x and out: 0 for float32, 1 for bfloat16. `packed` holds the int8 weight
// images as ops/fused_convnext.py::kernel_weights_int8 lays them out; s1 (I,)
// and s2 (C,) are their float32 scales.
extern "C" int convnext_block_int8_launch(const void* x, void* out, const void* dw,
                                          const void* dwb, const void* lnw, const void* lnb,
                                          const void* packed, const void* s1, const void* b1,
                                          const void* s2, const void* b2, const void* gamma,
                                          int batch, int t_len, int channels, int inter,
                                          int x_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || inter < 64 || inter % 64 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_channels(channels, [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (x_bf16)
      return launch<C, __nv_bfloat16>(x, out, dw, dwb, lnw, lnb, packed, s1, b1, s2, b2, gamma,
                                      batch, t_len, inter, s);
    return launch<C, float>(x, out, dw, dwb, lnw, lnb, packed, s1, b1, s2, b2, gamma, batch, t_len,
                            inter, s);
  });
}

// Dynamic shared memory a block takes at `channels` (0 if not taken), and
// the number of weight slots in its ring.
extern "C" int convnext_block_int8_smem_bytes(int channels) {
  int bytes = 0;
  with_channels(channels, [&](auto c) {
    bytes = Layout<decltype(c)::value>::BYTES;
    return cudaSuccess;
  });
  return bytes;
}

extern "C" int convnext_block_int8_stages(int channels) {
  int stages = 0;
  with_channels(channels, [&](auto c) {
    stages = Layout<decltype(c)::value>::STAGES;
    return cudaSuccess;
  });
  return stages;
}
