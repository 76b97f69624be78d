// Fused ConvNeXt block for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_convnext.py::convnext_block_fused (its
// body `_block_kernel`), the Pallas TPU kernel of the inference hot path. One
// call computes a whole ConvNeXt block on x (B, T, C):
//
//   h   = LayerNorm_f32(dwconv7(x) + dwb)            eps 1e-6, centred variance
//   u   = gelu(bf16(h) @ bf16(W1) + b1)              f32 accumulation
//   out = x + gamma * (bf16(u) @ bf16(W2) + b2)      f32 accumulation, x's dtype
//
// where gelu(u) = 0.5 * u * (1 + erf(u / sqrt 2)) with the Abramowitz-Stegun
// erf of the JAX kernel (`_erf`), in its order of operations. A 3-frame halo
// on each side of a tile reads real neighbours and zeros only outside
// [0, T). The (T, I) intermediate never reaches device memory.
//
// Bound on this card: operations. The two products take 4*B*T*C*I FLOP; at
// the WaveNeXt trunk's bench shape (B=32, T=1792, C=384, I=1152) that is
// 1.0e11 FLOP, 0.10 ms at the 989 TFLOP/s bf16 dense peak, against 176 MB of
// float32 x in and out, 0.05 ms at 3.35 TB/s. A second limit sits in L2:
// every 64-frame tile reads all of W1 and W2 (1.77 MB of bf16 at the trunk),
// 1.59 GB from L2 per trunk launch.
//
// Design:
// - one block per (item, 64-frame tile) and three warpgroups: warpgroups 0
//   and 1 compute, one thread of warpgroup 2 feeds a ring of weight slots;
// - the weights arrive packed by the wrapper (ops/fused_convnext.py::
//   kernel_weights): for each 64-wide chunk j of I, the W1 chunk and then the
//   W2 chunk as the 128-byte-swizzled, K-major shared-memory images that
//   wgmma reads, C x 64 bf16 each. The producer streams W1_0, W2_0, W1_1, ...
//   into STAGES slots with one cp.async.bulk per slot, which completes on the
//   slot's `full` mbarrier; it refills a slot once all eight consumer warps
//   have arrived on its `empty` mbarrier;
// - prologue, by the 256 consumer threads while the first slots load:
//   dwconv + LayerNorm in float32, one warp per 8 frames taken 4 at a time,
//   each lane loading a 10-frame window of its channels 16 bytes at a time;
//   h goes as bf16 straight into the swizzled A tile;
// - chunk j, consumer warpgroup w (0 or 1):
//     S_w   = h @ W1_j[:, 32w:32w+32]                     wgmma m64n32k16
//     acc_w += G_{j-1} @ W2_{j-1}[:, wC/2:(w+1)C/2]       wgmma m64n(C/2)k16
//   both from shared memory, in two commit groups; the second is left
//   running while the warpgroup adds b1 to S_w, applies the GELU in
//   registers and writes its bf16 half of G_j (double-buffered, swizzled); a
//   named barrier joins the two warpgroups before G_j is read. Every pass has
//   the same shape (G_{-1} is zeros), and the last second product follows
//   the loop;
// - epilogue: out = x + gamma * (acc + b2) straight from the accumulator
//   registers, rows past T not stored.
//
// Budgets at C = 384: shared memory h 48 KB + G 2 x 8 KB + 3 slots x 48 KB
// = 208 KB, plus the barriers and 1 KB of alignment slack: one block per SM.
// The ring takes what the h tile leaves, up to 8 slots of C x 128 bytes:
// 2 slots at C = 448 and 512, 3 at 384, 4 at 320, 5 at 256, 7 at 192 and 8
// below. Registers: 384 threads at one block per SM get 168 a thread;
// setmaxnreg moves them to 24 for the producer's warpgroup and 240 for the
// consumers, whose thread holds its share of the 64 x C/2 float32
// accumulator (96 registers at C = 384, 128 at 512) and of the 64 x 32 S
// tile (16). Above C = 384 the prologue takes two frames at a time, not
// four, which spilled more. With 40 / 232, C = 384 spilled 172 B (x f32)
// and C = 512 with x bf16 124 B; with 24 / 240 they spill 0 and 60 B.
// Not done (later work): a persistent grid that overlaps one tile's
// epilogue and prologue with the next tile's products; a cluster of two
// blocks multicasting each slot (halves the L2 traffic) was built and ran
// slower than this single-block kernel.
//
// Shapes taken: any C up to 512 and any I, x in f32 or bf16, the packed
// weights in bf16, every other parameter f32. The kernel is instantiated
// for C' = C rounded up to a multiple of 64 (the template argument); the
// pack holds C' x I' weights, I' = I rounded up to a multiple of 64, with
// zeros past C and I. Where C < C' (PADDED), the prologue reads x and the
// parameters below C (16 bytes at a time where C is a multiple of 4, else
// element by element) and writes zeros into h past C, the LayerNorm divides
// by C and masks the lanes past it, and the epilogue stores the columns
// below C (in pairs where C is even); b1 reads zero past I, so the padded
// columns of S give gelu(0) = 0. Where C is not a multiple of 128 the
// LayerNorm also masks lanes. The caller checks shapes and types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 64;          // frames per block: one wgmma M
constexpr int IC = 64;          // intermediate channels per chunk: 64 bf16, one swizzle row
constexpr int HALO = 3;         // k = 7 depthwise conv
constexpr int CONSUMERS = 2;    // computing warpgroups
constexpr int NTHREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_WARPS = CONSUMERS * 4;
constexpr int FRAMES_PER_WARP = TM / CONSUMER_WARPS;
constexpr int MAX_STAGES = 8;

// Frames the prologue takes at a time: two above C = 384, where four would
// hold too many registers (ptxas spilled more than at C = 384).
template <int C, bool PADDED>
constexpr int PROLOGUE_FRAMES = C > 384 ? 2 : 4;

// Shared-memory layout, in bytes from a 1024-byte-aligned base. Every
// operand tile is K-major with 128-byte rows, in blocks of 64 K-columns.
template <int C>
struct Layout {
  static constexpr int SLOT = C * IC * 2;   // one W1 or W2 chunk image
  static constexpr int H_BYTES = TM * C * 2;
  static constexpr int G_BYTES = TM * IC * 2;
  static constexpr int H_OFF = 0;
  static constexpr int G_OFF = H_OFF + H_BYTES;
  static constexpr int RING_OFF = G_OFF + 2 * G_BYTES;
  static constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - BAR_BYTES - RING_OFF) / SLOT;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * SLOT;
  static constexpr int BYTES = BAR_OFF + BAR_BYTES + 1024;  // + slack to align the base
  static_assert(C % 64 == 0 && C >= 64 && C <= 512, "C is a multiple of 64 up to 512");
  static_assert(STAGES >= 2, "the ring needs two slots");
  static_assert(BYTES <= SMEM_LIMIT, "a block may use at most 227 KB of shared memory");
  static_assert(SLOT % 1024 == 0 && H_BYTES % 1024 == 0, "swizzle atoms are 1024 bytes");
  static_assert(TM == IC, "h and the W1 image share the 64-row K-block stride");
  static_assert(CONSUMER_WARPS * C * 4 <= 2 * G_BYTES, "the prologue's sums fit in the G buffers");
};

__device__ __forceinline__ void consumers_sync() { named_sync<CONSUMERS * 128>(); }

// Four consecutive channels of x as float32: one 16-byte load (8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// row[c .. c + 3] as float32. PADDED: one load where rows of c_len elements
// are 16-byte aligned (8-byte for bf16: c_len a multiple of 4) and all four
// lie below c_len, else one element at a time, zero at or past c_len.
template <bool PADDED, typename T>
__device__ __forceinline__ float4 load4_row(const T* row, int c, int c_len) {
  if constexpr (!PADDED) {
    return load4(row + c);
  } else {
    if (c_len % 4 == 0 && c + 4 <= c_len) return load4(row + c);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < c_len ? to_f32(row[c + e]) : 0.f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// 0.5 u (1 + erf(u / sqrt 2)) with the Abramowitz-Stegun erf in the JAX
// kernel's order of operations (`_erf`): sign(x) (1 - poly(t) exp(-x^2)),
// t = 1 / (1 + p |x|) rounded once. exp is the hardware's exp2 of x log2 e
// (__expf, a few ulp); the sign is copied, which differs from sign(x) only
// at x = 0, where u = 0 too.
__device__ __forceinline__ float gelu(float u) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float x = u * 0.70710678118654752f;
  const float ax = fabsf(x);
  const float t = __frcp_rn(1.f + p * ax);
  const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
  const float erf = copysignf(1.f - poly * __expf(-ax * ax), x);
  return 0.5f * u * (1.f + erf);
}

// The sum by halves (the twin's `_tree_sum`) of the C values (C a multiple
// of 64, at most 512) that a warp holds as lane l's w[4 j + e] = value
// 4 (l + 32 j) + e. While more than 32 are left, N is a multiple of 8, so
// value i + N/2 sits in the same slot e of lane (l + N/8) % 32, N/256 or
// N/256 + 1 groups on (one shuffle for each; none where N/8 is a multiple
// of 32): each level is shuffles and adds in registers. The last 32 or
// fewer go one to a lane (`warp_tail_sum`). w is overwritten; returns the
// sum to every lane.
template <int C, int N = C>
__device__ __forceinline__ float tree_sum_regs(float (&w)[4 * ((C + 127) / 128)], int lane) {
  constexpr int GROUPS = (C + 127) / 128;
  if constexpr (N > 32) {
    static_assert(N % 8 == 0, "above 32 values every level halves a multiple of 8");
    constexpr int HALF = N / 2, H4 = HALF / 4, G4 = H4 / 32, R4 = H4 % 32;
    const int src = (lane + R4) & 31;
    const bool wrap = lane + R4 >= 32;
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      if (128 * j >= HALF) break;  // the group holds no value below HALF
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = 0.f, b = 0.f;
        if (j + G4 < GROUPS)
          a = R4 ? __shfl_sync(0xffffffffu, w[4 * (j + G4) + e], src) : w[4 * (j + G4) + e];
        if (R4 && j + G4 + 1 < GROUPS) b = __shfl_sync(0xffffffffu, w[4 * (j + G4 + 1) + e], src);
        if (128 * j + 4 * lane + e < HALF) w[4 * j + e] = __fadd_rn(w[4 * j + e], wrap ? b : a);
      }
    }
    return tree_sum_regs<C, HALF>(w, lane);
  } else {  // value i at lane i / 4, slot i % 4: one to a lane
    const int src = lane / 4;
    const float s0 = __shfl_sync(0xffffffffu, w[0], src), s1 = __shfl_sync(0xffffffffu, w[1], src);
    const float s2 = __shfl_sync(0xffffffffu, w[2], src), s3 = __shfl_sync(0xffffffffu, w[3], src);
    const int e = lane % 4;
    const float s = lane >= N ? 0.f : e == 0 ? s0 : e == 1 ? s1 : e == 2 ? s2 : s3;
    return warp_tail_sum(s, N, lane);
  }
}

// Depthwise conv + LayerNorm of frames r0 .. r0 + F - 1 by one warp, written
// as bf16 into the swizzled h tile of C' = C columns; frames at or past T
// are zeros. Lane l holds channels 4 (l + 32 j) .. 4 (l + 32 j) + 3 and
// slides an (F + 6)-frame window over them. The arithmetic is the twin's
// (ops/fused_convnext.py::_dwconv_layernorm), so that h equals its h bit
// for bit: round-to-nearest intrinsics in its order (no fused multiply-add),
// the mean and the variance summed by halves over the real width (in
// registers, `tree_sum_regs`; where PADDED, over c_len by `warp_tree_sum`
// through the warp's `sums`, C' floats of shared memory), 1/std a division
// by a rounded square root. An h on the other side of a bf16 rounding from
// the twin's moves a whole row of u, and the block's output by up to ~3e-3
// at C = 512 / I = 3072 (PERF.md, PR 9). Channels at or past c_len hold
// zeros; h is zero there.
template <int C, bool PADDED, typename T>
__device__ __forceinline__ void dwconv_layernorm(const T* __restrict__ xb, unsigned char* h_s,
                                                 float* sums, const float* __restrict__ dw,
                                                 const float* __restrict__ dwb,
                                                 const float* __restrict__ lnw,
                                                 const float* __restrict__ lnb, int t0, int t_len,
                                                 int c_len, int r0, int lane) {
  constexpr int GROUPS = (C + 127) / 128;  // float4 groups per lane
  constexpr bool RAGGED = PADDED || C % 128 != 0;
  constexpr int F = PROLOGUE_FRAMES<C, PADDED>;
  const int cl = PADDED ? c_len : C;  // the row stride and the real width
  float v[F][4 * GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int c = 4 * (lane + 32 * j);
    const bool on = !RAGGED || c < cl;
    float4 win[F + 2 * HALO];
#pragma unroll
    for (int u = 0; u < F + 2 * HALO; ++u) {
      const int t = t0 + r0 + u - HALO;
      win[u] = (on && t >= 0 && t < t_len)
                   ? load4_row<PADDED>(xb + static_cast<size_t>(t) * cl, c, cl)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 wk[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      wk[k] = on ? load4_row<PADDED>(dw + k * cl, c, cl) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bias = on ? load4_row<PADDED>(dwb, c, cl) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int f = 0; f < F; ++f) {  // taps outside [0, T) add the twin's 0 * dw = 0
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        acc.x = __fadd_rn(acc.x, __fmul_rn(win[f + k].x, wk[k].x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(win[f + k].y, wk[k].y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(win[f + k].z, wk[k].z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(win[f + k].w, wk[k].w));
      }
      v[f][4 * j] = __fadd_rn(acc.x, bias.x);
      v[f][4 * j + 1] = __fadd_rn(acc.y, bias.y);
      v[f][4 * j + 2] = __fadd_rn(acc.z, bias.z);
      v[f][4 * j + 3] = __fadd_rn(acc.w, bias.w);
    }
  }
  // the sum by halves of this lane's values of frame f, or of their
  // centred squares, over the real width
  auto tree = [&](int f, bool square, float mean) {
    float w[4 * GROUPS];
#pragma unroll
    for (int i = 0; i < 4 * GROUPS; ++i) {
      const float d = square ? __fsub_rn(v[f][i], mean) : v[f][i];
      w[i] = square ? __fmul_rn(d, d) : d;
    }
    if constexpr (!PADDED) {
      return tree_sum_regs<C>(w, lane);
    } else {
#pragma unroll
      for (int i = 0; i < 4 * GROUPS; ++i) {
        const int c = 4 * (lane + 32 * (i / 4)) + i % 4;
        if (c < cl) sums[c] = w[i];
      }
      __syncwarp();
      const float total = warp_tree_sum([&](int i) { return sums[i]; }, sums, cl, lane);
      __syncwarp();  // every lane has read `sums` before it is written again
      return total;
    }
  };
  const float n = static_cast<float>(cl);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int r = r0 + f;
    const bool live = t0 + r < t_len;
    const float mean = __fdiv_rn(tree(f, false, 0.f), n);
    const float var = __fdiv_rn(tree(f, true, mean), n);
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int c = 4 * (lane + 32 * j);
      if (C % 128 != 0 && c >= C) continue;  // past the tile; zeros from lnw = lnb = 0 below C
      const float4 g = load4_row<PADDED>(lnw, c, cl), bb = load4_row<PADDED>(lnb, c, cl);
      const float gs[4] = {g.x, g.y, g.z, g.w}, bs[4] = {bb.x, bb.y, bb.z, bb.w};
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hv[e] = live ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[f][4 * j + e], mean), rstd), gs[e]), bs[e])
                     : 0.f;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(hv[0], hv[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(hv[2], hv[3]);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      const uint32_t off = (c / 64) * (TM * ROW) + r * ROW + (c % 64) * 2;
      *reinterpret_cast<uint2*>(h_s + swizzle(off)) = packed;
    }
  }
}

template <int C, bool PADDED, typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
convnext_block_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ dw,
                      const float* __restrict__ dwb, const float* __restrict__ lnw,
                      const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ packed,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      const float* __restrict__ gamma, int t_len, int c_len, int inter) {
  using L = Layout<C>;
  constexpr int S = L::STAGES;
  constexpr int N2 = C / 2;  // output columns per consumer warpgroup
  const int cl = PADDED ? c_len : C;  // the real width: x's row stride
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + MAX_STAGES;
  const int n_chunks = (inter + IC - 1) / IC;  // the pack's I' / 64
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

  if (wg == CONSUMERS) {
    // -- producer: one thread streams W1_0, W2_0, W1_1, ... through the ring;
    // its warpgroup gives up registers to the consumers (128 x 24 + 256 x 240
    // = 384 x 168, the block's allocation)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(packed);
      for (int q = 0; q < 2 * n_chunks; ++q) {
        const int s = q % S;
        if (q >= S) mbar_wait(&empty[s], (q / S - 1) & 1);
        mbar_expect_tx(&full[s], L::SLOT);
        bulk_load(smem + L::RING_OFF + s * L::SLOT, src + static_cast<size_t>(q) * L::SLOT, L::SLOT,
                  &full[s]);
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int tid = threadIdx.x;  // 0..255
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w = wg;              // which half of the output columns
  const int wq = warp % 4;       // warp within the warpgroup: rows 16 wq .. 16 wq + 15
  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const T* xb = x + static_cast<size_t>(item) * t_len * cl;
  T* ob = out + static_cast<size_t>(item) * t_len * cl;

#pragma unroll
  for (int r0 = warp * FRAMES_PER_WARP; r0 < (warp + 1) * FRAMES_PER_WARP;
       r0 += PROLOGUE_FRAMES<C, PADDED>)
    dwconv_layernorm<C, PADDED, T>(xb, smem + L::H_OFF,
                                   reinterpret_cast<float*>(smem + L::G_OFF) + warp * C, dw, dwb,
                                   lnw, lnb, t0, t_len, c_len, r0, lane);
  consumers_sync();  // every warp's LayerNorm sums (in the G buffers) are done
  // G_{-1} = 0: the first pass's second product adds nothing, so every pass
  // of the loop issues, commits and waits alike (branches between the wgmma
  // groups make ptxas serialize them, its warning C7514)
  for (int e = tid; e < L::G_BYTES / 16; e += CONSUMERS * 128)
    reinterpret_cast<uint4*>(smem + L::G_OFF + L::G_BYTES)[e] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();
  consumers_sync();

  const uint32_t h_addr = smem_u32(smem + L::H_OFF);
  const uint32_t g_addr = smem_u32(smem + L::G_OFF);
  const uint32_t ring = smem_u32(smem + L::RING_OFF);
  float acc[N2 / 2];
#pragma unroll
  for (int i = 0; i < N2 / 2; ++i) acc[i] = 0.f;

  float s_reg[16], bias[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) s_reg[i] = 0.f;
  for (int j = 0; j < n_chunks; ++j) {
    const int qa = 2 * j, sa = qa % S;            // W1_j
    const int qb = 2 * j - 1, sb = (qb + S) % S;  // W2_{j-1}
    mbar_wait(&full[sa], (qa / S) & 1);
    if (j > 0) mbar_wait(&full[sb], (qb / S) & 1);
    wgmma_fence();
    // S_w = h @ W1_j[:, 32w : 32w + 32]
    const uint32_t b1_base = ring + sa * L::SLOT + w * 32 * ROW;
#pragma unroll
    for (int k = 0; k < C / 16; ++k) {
      const uint32_t koff = (k / 4) * (TM * ROW) + (k % 4) * 32;
      wgmma_bf16<32>(s_reg, smem_desc(h_addr + koff), smem_desc(b1_base + koff), k > 0);
    }
    wgmma_commit();
    // acc_w += G_{j-1} @ W2_{j-1}[:, w N2 : (w + 1) N2], left running. For
    // j = 0, G_{-1} = 0 against the h tile, which is finite, never rewritten
    // and as large as a slot (a ring slot could be refilled while read)
    const uint32_t a2_base = g_addr + ((j + 1) % 2) * L::G_BYTES;
    const uint32_t b2_base = (j > 0 ? ring + sb * L::SLOT : h_addr) + w * N2 * ROW;
#pragma unroll
    for (int k = 0; k < IC / 16; ++k)
      wgmma_bf16<N2>(acc, smem_desc(a2_base + k * 32), smem_desc(b2_base + k * 32), 1);
    wgmma_commit();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {  // b1 for this thread's columns, while the products run
      const int n = j * IC + w * 32 + 8 * jj + 2 * (lane % 4);
      bias[2 * jj] = n < inter ? b1[n] : 0.f;
      bias[2 * jj + 1] = n + 1 < inter ? b1[n + 1] : 0.f;
    }
    wgmma_wait<1>();  // S_w is in; the second product may still run
    if (lane == 0) mbar_arrive(&empty[sa]);
    // bias + GELU, rounded to bf16 into this warpgroup's half of G_j
    unsigned char* g_s = smem + L::G_OFF + (j % 2) * L::G_BYTES;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = w * 32 + 8 * jj + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wq + lane / 4 + 8 * half;
        const __nv_bfloat162 g2 =
            __floats2bfloat162_rn(gelu(s_reg[4 * jj + 2 * half] + bias[2 * jj]),
                                  gelu(s_reg[4 * jj + 2 * half + 1] + bias[2 * jj + 1]));
        *reinterpret_cast<__nv_bfloat162*>(g_s + swizzle(r * ROW + n * 2)) = g2;
      }
    }
    wgmma_wait<0>();
    if (j > 0 && lane == 0) mbar_arrive(&empty[sb]);
    fence_async_smem();
    consumers_sync();  // G_j whole, G_{j-1} read by both warpgroups
  }
  {  // the last chunk's second product
    const int j = n_chunks, qb = 2 * j - 1, sb = qb % S;
    mbar_wait(&full[sb], (qb / S) & 1);
    wgmma_fence();
    const uint32_t a2_base = g_addr + ((j + 1) % 2) * L::G_BYTES;
    const uint32_t b2_base = ring + sb * L::SLOT + w * N2 * ROW;
#pragma unroll
    for (int k = 0; k < IC / 16; ++k)
      wgmma_bf16<N2>(acc, smem_desc(a2_base + k * 32), smem_desc(b2_base + k * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // -- epilogue: out = x + gamma * (acc + b2), in x's dtype ------------------
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + 16 * wq + lane / 4 + 8 * half;
    if (t >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < N2 / 8; ++jj) {
      const int c = w * N2 + 8 * jj + 2 * (lane % 4);
      const size_t idx = static_cast<size_t>(t) * cl + c;
      if (PADDED && (c_len % 2 != 0 || c >= c_len)) {  // element by element, below c_len
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= c_len) continue;
          const float hv = acc[4 * jj + 2 * half + e] + b2[c + e];
          const float o = to_f32(xb[idx + e]) + gamma[c + e] * hv;
          if constexpr (sizeof(T) == 4) ob[idx + e] = o;
          else ob[idx + e] = __float2bfloat16_rn(o);
        }
        continue;
      }
      const float2 g = *reinterpret_cast<const float2*>(gamma + c);
      const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
      const float h0 = acc[4 * jj + 2 * half] + bb.x;
      const float h1 = acc[4 * jj + 2 * half + 1] + bb.y;
      if constexpr (sizeof(T) == 4) {
        const float2 xv = *reinterpret_cast<const float2*>(xb + idx);
        *reinterpret_cast<float2*>(ob + idx) = make_float2(xv.x + g.x * h0, xv.y + g.y * h1);
      } else {
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xb + idx));
        *reinterpret_cast<__nv_bfloat162*>(ob + idx) =
            __floats2bfloat162_rn(xv.x + g.x * h0, xv.y + g.y * h1);
      }
    }
  }
}

template <int C, bool PADDED, typename T>
cudaError_t launch(const void* x, void* out, const void* dw, const void* dwb, const void* lnw,
                   const void* lnb, const void* packed, const void* b1, const void* b2,
                   const void* gamma, int batch, int t_len, int c_len, int inter,
                   cudaStream_t stream) {
  using L = Layout<C>;
  auto kernel = convnext_block_kernel<C, PADDED, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TM - 1) / TM, batch);
  kernel<<<grid, NTHREADS, L::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const __nv_bfloat16*>(packed),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), t_len, c_len, inter);
  return cudaGetLastError();
}

// Calls f(Width<C>()) for the instantiated width C (a multiple of 64 up to
// 512), or returns cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t with_channels(int channels, F&& f) {
  switch (channels) {
    case 64: return f(Width<64>());
    case 128: return f(Width<128>());
    case 192: return f(Width<192>());
    case 256: return f(Width<256>());
    case 320: return f(Width<320>());
    case 384: return f(Width<384>());
    case 448: return f(Width<448>());
    case 512: return f(Width<512>());
    default: return cudaErrorInvalidValue;
  }
}

int padded_channels(int channels) { return (channels + 63) / 64 * 64; }

}  // namespace

// Returns the launch's cudaError_t (0 on success). x_bf16 selects the type of
// x and out: 0 for float32, 1 for bfloat16. `packed` holds the weights as
// ops/fused_convnext.py::kernel_weights lays them out, padded to C' and I'.
extern "C" int convnext_block_fused_launch(const void* x, void* out, const void* dw,
                                           const void* dwb, const void* lnw, const void* lnb,
                                           const void* packed, const void* b1, const void* b2,
                                           const void* gamma, int batch, int t_len, int channels,
                                           int inter, int x_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || channels < 1 || inter < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool padded = channels != padded_channels(channels);
  return with_channels(padded_channels(channels), [&](auto c) {
    constexpr int C = decltype(c)::value;
    if (padded) {
      if (x_bf16)
        return launch<C, true, __nv_bfloat16>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma,
                                              batch, t_len, channels, inter, s);
      return launch<C, true, float>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, batch,
                                    t_len, channels, inter, s);
    }
    if (x_bf16)
      return launch<C, false, __nv_bfloat16>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma,
                                             batch, t_len, channels, inter, s);
    return launch<C, false, float>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, batch, t_len,
                                   channels, inter, s);
  });
}

// Dynamic shared memory a block takes at `channels` (rounded up to a
// multiple of 64; 0 if not taken), and the number of weight slots in its ring.
extern "C" int convnext_block_smem_bytes(int channels) {
  int bytes = 0;
  with_channels(padded_channels(channels), [&](auto c) {
    bytes = Layout<decltype(c)::value>::BYTES;
    return cudaSuccess;
  });
  return bytes;
}

extern "C" int convnext_block_stages(int channels) {
  int stages = 0;
  with_channels(padded_channels(channels), [&](auto c) {
    stages = Layout<decltype(c)::value>::STAGES;
    return cudaSuccess;
  });
  return stages;
}
