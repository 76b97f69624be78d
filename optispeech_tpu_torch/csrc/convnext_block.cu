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
// C = 256 runs 5 slots of 32 KB, C = 128 8 of 16 KB. Registers: 384 threads
// at one block per SM get 168 a thread; setmaxnreg moves them to 40 for the
// producer's warpgroup and 232 for the consumers, whose thread holds its
// share of the 64 x C/2 float32 accumulator (96 registers at C = 384) and of
// the 64 x 32 S tile (16).
// Not done (later work): a persistent grid that overlaps one tile's
// epilogue and prologue with the next tile's products; a cluster of two
// blocks multicasting each slot (halves the L2 traffic) was built and ran
// slower than this single-block kernel.
//
// Shapes taken: C in {128, 256, 384} (a template argument), I a multiple of
// 64, x in f32 or bf16, the packed weights in bf16, every other parameter
// f32. The caller checks shapes and types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // frames per block: one wgmma M
constexpr int IC = 64;          // intermediate channels per chunk
constexpr int HALO = 3;         // k = 7 depthwise conv
constexpr int CONSUMERS = 2;    // computing warpgroups
constexpr int NTHREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_WARPS = CONSUMERS * 4;
constexpr int FRAMES_PER_WARP = TM / CONSUMER_WARPS;
constexpr int ROW = 128;        // bytes in one swizzle row: 64 bf16 of K
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block

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
  static_assert(STAGES >= 2, "the ring needs two slots");
  static_assert(BYTES <= SMEM_LIMIT, "a block may use at most 227 KB of shared memory");
  static_assert(SLOT % 1024 == 0 && H_BYTES % 1024 == 0, "swizzle atoms are 1024 bytes");
  static_assert(TM == IC, "h and the W1 image share the 64-row K-block stride");
};

// 128-byte swizzle, as wgmma's descriptor layout 1 reads it: the 16-byte
// chunk within a 128-byte row is XORed with the row's index mod 8.
__device__ __forceinline__ uint32_t swizzle(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (SBO); LBO is unused in this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// One contiguous global -> shared copy, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void consumers_sync() {  // the 256 consumer threads only
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// D (64 x N, f32 registers) += A (64 x 16) @ B (16 x N), both bf16 from
// shared memory through descriptors, K-major; scale_d = 0 overwrites D.
// D's layout: d[i] holds row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n192k16(float (&d)[96], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_m64n32k16(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64k16(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_m64n128k16(d, a, b, scale_d);
  else wgmma_m64n192k16(d, a, b, scale_d);
}

// Four consecutive channels of x as float32: one 16-byte load (8 for bf16).
__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

// Depthwise conv + LayerNorm of frames r0 .. r0 + 3 by one warp, written as
// bf16 into the swizzled h tile; frames at or past T are zeros. Lane l holds
// channels 4 (l + 32 j) .. 4 (l + 32 j) + 3 and slides a 10-frame window
// over them.
template <int C, typename T>
__device__ __forceinline__ void dwconv_layernorm(const T* __restrict__ xb, unsigned char* h_s,
                                                 const float* __restrict__ dw,
                                                 const float* __restrict__ dwb,
                                                 const float* __restrict__ lnw,
                                                 const float* __restrict__ lnb, int t0, int t_len,
                                                 int r0, int lane) {
  constexpr int GROUPS = C / 128;  // float4 groups per lane
  constexpr int F = 4;
  float v[F][4 * GROUPS];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int c = 4 * (lane + 32 * j);
    float4 win[F + 2 * HALO];
#pragma unroll
    for (int u = 0; u < F + 2 * HALO; ++u) {
      const int t = t0 + r0 + u - HALO;
      win[u] = (t >= 0 && t < t_len) ? load4(xb + static_cast<size_t>(t) * C + c)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 wk[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) wk[k] = load4(dw + k * C + c);
    const float4 bias = load4(dwb + c);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        acc.x += win[f + k].x * wk[k].x;
        acc.y += win[f + k].y * wk[k].y;
        acc.z += win[f + k].z * wk[k].z;
        acc.w += win[f + k].w * wk[k].w;
      }
      v[f][4 * j] = acc.x + bias.x;
      v[f][4 * j + 1] = acc.y + bias.y;
      v[f][4 * j + 2] = acc.z + bias.z;
      v[f][4 * j + 3] = acc.w + bias.w;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int r = r0 + f;
    const bool live = t0 + r < t_len;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * GROUPS; ++i) sum += v[f][i];
    const float mean = warp_sum(sum) * (1.f / C);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * GROUPS; ++i) {
      const float d = v[f][i] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) * (1.f / C) + 1e-6f);
#pragma unroll
    for (int j = 0; j < GROUPS; ++j) {
      const int c = 4 * (lane + 32 * j);
      const float4 g = load4(lnw + c), bb = load4(lnb + c);
      float hv[4] = {(v[f][4 * j] - mean) * rstd * g.x + bb.x,
                     (v[f][4 * j + 1] - mean) * rstd * g.y + bb.y,
                     (v[f][4 * j + 2] - mean) * rstd * g.z + bb.z,
                     (v[f][4 * j + 3] - mean) * rstd * g.w + bb.w};
      if (!live) hv[0] = hv[1] = hv[2] = hv[3] = 0.f;
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

template <int C, typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
convnext_block_kernel(const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ dw,
                      const float* __restrict__ dwb, const float* __restrict__ lnw,
                      const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ packed,
                      const float* __restrict__ b1, const float* __restrict__ b2,
                      const float* __restrict__ gamma, int t_len, int inter) {
  using L = Layout<C>;
  constexpr int S = L::STAGES;
  constexpr int N2 = C / 2;  // output columns per consumer warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + MAX_STAGES;
  const int n_chunks = inter / IC;
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
    // its warpgroup gives up registers to the consumers (128 x 40 + 256 x 232
    // = 384 x 168, the block's allocation)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int tid = threadIdx.x;  // 0..255
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int w = wg;              // which half of the output columns
  const int wq = warp % 4;       // warp within the warpgroup: rows 16 wq .. 16 wq + 15
  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const T* xb = x + static_cast<size_t>(item) * t_len * C;
  T* ob = out + static_cast<size_t>(item) * t_len * C;

#pragma unroll
  for (int r0 = warp * FRAMES_PER_WARP; r0 < (warp + 1) * FRAMES_PER_WARP; r0 += 4)
    dwconv_layernorm<C, T>(xb, smem + L::H_OFF, dw, dwb, lnw, lnb, t0, t_len, r0, lane);
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
      wgmma<32>(s_reg, smem_desc(h_addr + koff), smem_desc(b1_base + koff), k > 0);
    }
    wgmma_commit();
    // acc_w += G_{j-1} @ W2_{j-1}[:, w N2 : (w + 1) N2], left running. For
    // j = 0, G_{-1} = 0 against the h tile, which is finite, never rewritten
    // and as large as a slot (a ring slot could be refilled while read)
    const uint32_t a2_base = g_addr + ((j + 1) % 2) * L::G_BYTES;
    const uint32_t b2_base = (j > 0 ? ring + sb * L::SLOT : h_addr) + w * N2 * ROW;
#pragma unroll
    for (int k = 0; k < IC / 16; ++k)
      wgmma<N2>(acc, smem_desc(a2_base + k * 32), smem_desc(b2_base + k * 32), 1);
    wgmma_commit();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {  // b1 for this thread's columns, while the products run
      const int n = j * IC + w * 32 + 8 * jj + 2 * (lane % 4);
      bias[2 * jj] = b1[n];
      bias[2 * jj + 1] = b1[n + 1];
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
      wgmma<N2>(acc, smem_desc(a2_base + k * 32), smem_desc(b2_base + k * 32), 1);
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
      const size_t idx = static_cast<size_t>(t) * C + c;
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

template <int C, typename T>
cudaError_t launch(const void* x, void* out, const void* dw, const void* dwb, const void* lnw,
                   const void* lnb, const void* packed, const void* b1, const void* b2,
                   const void* gamma, int batch, int t_len, int inter, cudaStream_t stream) {
  using L = Layout<C>;
  auto kernel = convnext_block_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TM - 1) / TM, batch);
  kernel<<<grid, NTHREADS, L::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const __nv_bfloat16*>(packed),
      static_cast<const float*>(b1), static_cast<const float*>(b2),
      static_cast<const float*>(gamma), t_len, inter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int channels, const void* x, void* out, const void* dw, const void* dwb,
                     const void* lnw, const void* lnb, const void* packed, const void* b1,
                     const void* b2, const void* gamma, int batch, int t_len, int inter,
                     cudaStream_t stream) {
  switch (channels) {
    case 128:
      return launch<128, T>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, batch, t_len, inter, stream);
    case 256:
      return launch<256, T>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, batch, t_len, inter, stream);
    case 384:
      return launch<384, T>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, batch, t_len, inter, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). x_bf16 selects the type of
// x and out: 0 for float32, 1 for bfloat16. `packed` holds the weights as
// ops/fused_convnext.py::kernel_weights lays them out.
extern "C" int convnext_block_fused_launch(const void* x, void* out, const void* dw,
                                           const void* dwb, const void* lnw, const void* lnb,
                                           const void* packed, const void* b1, const void* b2,
                                           const void* gamma, int batch, int t_len, int channels,
                                           int inter, int x_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || inter < IC || inter % IC != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(channels, x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma,
                                   batch, t_len, inter, s);
  return dispatch<float>(channels, x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, batch, t_len,
                         inter, s);
}

// Dynamic shared memory a block takes at `channels` (0 if not taken), and
// the number of weight slots in its ring.
extern "C" int convnext_block_smem_bytes(int channels) {
  switch (channels) {
    case 128: return Layout<128>::BYTES;
    case 256: return Layout<256>::BYTES;
    case 384: return Layout<384>::BYTES;
    default: return 0;
  }
}

extern "C" int convnext_block_stages(int channels) {
  switch (channels) {
    case 128: return Layout<128>::STAGES;
    case 256: return Layout<256>::STAGES;
    case 384: return Layout<384>::STAGES;
    default: return 0;
  }
}
