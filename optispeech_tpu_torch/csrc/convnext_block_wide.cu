// Fused ConvNeXt block for Hopper (sm_90a) at C > 512: the wide path of B1,
// bound to Python through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_convnext.py::convnext_block_fused (its
// body `_block_kernel`) for the blocks that JAX's `pick_tile` tiles and that
// convnext_block.cu cannot hold: above C = 512 that kernel's h tile and two
// ring slots of C x 128 bytes pass 227 KB of shared memory, and its 64 x C
// float32 accumulator passes the registers. Same function as
// convnext_block.cu (header there):
//
//   h   = LayerNorm_f32(dwconv7(x) + dwb)            eps 1e-6, centred variance
//   u   = gelu(bf16(h) @ bf16(W1) + b1)              f32 accumulation
//   out = x + gamma * (bf16(u) @ bf16(W2) + b2)      f32 accumulation, x's dtype
//
// Bound on this card: operations, 4*B*T*C*I FLOP at the bf16 peak, as for
// B1; this path does more (below), and PERF.md gives its time against it.
//
// Design (simple first; C is a runtime argument, so two instantiations per
// kernel, one per type of x, cover every width):
// - kernel 1, `wide_layernorm_kernel`: one block of 256 threads per frame
//   computes dwconv + LayerNorm in float32 over all C channels (the dwconv
//   outputs and a copy to sum held in 2 x C x 4 bytes of shared memory; the
//   mean and the centred variance summed by halves, as the twin sums them)
//   and writes h as bf16 into a scratch image
//   laid out for kernel 2's bulk copies: per (item, 64-frame tile) C' / 64
//   K blocks of 64 frames x 128 bytes, 128-byte swizzled, zeros past C and
//   past T. h makes one round trip through device memory (B x T' x C' x 2
//   bytes); the (T, I) intermediate never does;
// - kernel 2, `wide_products_kernel`: one block per (item, 64-frame tile,
//   slab of 256 output channels), with B1's three warpgroups (two compute,
//   one thread of the third streams operands). For each 64-wide chunk j of
//   I, product 1 streams its depth C in K blocks of 64: each ring slot A
//   holds the h K block and the W1_j K block (8 KB each, one
//   cp.async.bulk each, straight from the h image and from B1's own pack,
//   ops/fused_convnext.py::kernel_weights, whose W1_j image is C' / 64
//   such K blocks in a row); consumer warpgroup w accumulates
//   S_w = h @ W1_j[:, 32w : 32w + 32] (wgmma m64n32k16), adds b1, applies
//   the GELU and writes its bf16 half of G_j; a ring slot B holds the slab's
//   rows of the W2_j image (256 x 128 bytes), and warpgroup w accumulates
//   acc_w += G_j @ W2_j[:, c0 + 128w : c0 + 128w + 128] (m64n128k16);
// - arithmetic: the dwconv, the LayerNorm (its sums by halves, its 1/sqrt a
//   division by a rounded square root), b1, the GELU (`expf`, IEEE
//   division) and the epilogue use the round-to-nearest intrinsics in the
//   twin's order (ops/fused_convnext.py::convnext_block_reference), so
//   nvcc fuses no multiply-add there and h equals the twin's bit for bit.
//   Only the products' sums run in another order. An h that lands on the
//   other side of a bf16 rounding moves a whole row of u, and through u's
//   roundings the block's output by ~1e-3: a LayerNorm summed in another
//   order flips such an h in about one frame in a hundred at C = 768
//   (scripts/b1_wide_error.py);
// - sums: the tensor cores add a wgmma's products into its accumulator at
//   less than float32's rounding, which at C in the thousands left B1's way
//   of chaining every K step in one accumulator several times further from
//   a float64-summed twin than the float32 twin is (PERF.md). So each
//   K block of 64 goes into fresh registers and is added to the running sum
//   with a float32 round-to-nearest add, for both products;
// - product 1 is recomputed for every slab: ceil(C' / 256) times the
//   product-1 work of B1, which keeps the accumulator at 64 registers a
//   thread and the shared memory at 137 KB at every C;
// - every wgmma group is waited for before its slot is released, and both
//   warpgroups meet before and after G_j is read: the loads run ahead in
//   the ring (4 slots A, 2 slots B), the products do not overlap each other
//   or the GELU. Making it fast is later work (PERF.md).
// Rows of a slab past C' (the last slab when C' is no multiple of 256) are
// not copied; the columns they feed are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 64;          // frames per tile: one wgmma M
constexpr int KB = 64;          // channels per K block of product 1: one 128-byte row of bf16
constexpr int IC = 64;          // intermediate channels per chunk
constexpr int NS = 256;         // output channels per slab
constexpr int HALO = 3;         // k = 7 depthwise conv
constexpr int CONSUMERS = 2;    // computing warpgroups, NS / 2 output channels each
constexpr int NTHREADS = (CONSUMERS + 1) * 128;
constexpr int CONSUMER_WARPS = CONSUMERS * 4;
constexpr int LN_THREADS = 256;
constexpr int MAX_CHANNELS = 16384;  // the LayerNorm's 2 x C x 4 bytes of shared memory stay <= 128 KB

constexpr int TILE_BYTES = TM * KB * 2;    // an h K block or a W1 K block: 8 KB
constexpr int A_SLOT = 2 * TILE_BYTES;     // h K block, then W1 K block
constexpr int B_SLOT = NS * IC * 2;        // a slab's rows of the W2 chunk image: 32 KB
constexpr int A_STAGES = 4;
constexpr int B_STAGES = 2;
constexpr int G_BYTES = TM * IC * 2;
constexpr int A_OFF = 0;
constexpr int B_OFF = A_OFF + A_STAGES * A_SLOT;
constexpr int G_OFF = B_OFF + B_STAGES * B_SLOT;
constexpr int BAR_OFF = G_OFF + G_BYTES;
constexpr int BAR_BYTES = 2 * (A_STAGES + B_STAGES) * 8;
constexpr int SMEM_BYTES = BAR_OFF + BAR_BYTES + 1024;  // + slack to align the base
static_assert(SMEM_BYTES <= SMEM_LIMIT, "a block may use at most 227 KB of shared memory");
static_assert(TILE_BYTES % 1024 == 0 && B_SLOT % 1024 == 0, "swizzle atoms are 1024 bytes");

__device__ __forceinline__ void consumers_sync() { named_sync<CONSUMERS * 128>(); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The sum of w[0 .. n) by halves, the twin's `_tree_sum`: w[i] + w[i + n/2]
// for i < n/2, the odd last element carried, until one is left. Called by
// the whole block after w is written and synchronised; w is overwritten,
// and its sum returned to every thread.
__device__ __forceinline__ float tree_sum(float* w, int n) {
  while (n > 1) {
    const int half = n / 2;
    for (int i = threadIdx.x; i < half; i += LN_THREADS) w[i] = __fadd_rn(w[i], w[i + half]);
    __syncthreads();
    if (n % 2) {
      if (threadIdx.x == 0) w[half] = w[n - 1];
      __syncthreads();
    }
    n = half + n % 2;
  }
  const float total = w[0];
  __syncthreads();  // every thread has read w[0] before w is written again
  return total;
}

// 0.5 u (1 + erf(u / sqrt 2)) with the Abramowitz-Stegun erf of the JAX
// kernel (`_erf`), every operation rounded as the twin rounds it (no FMA,
// `expf`): see the header's note on arithmetic.
__device__ __forceinline__ float gelu(float u) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float x = __fmul_rn(u, 0.70710678118654752f);
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  // copysignf(r, x) = sign(x) * r wherever x != 0; at x = 0 u is 0 as well
  const float erf = copysignf(__fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))), x);
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, erf));
}

// Kernel 1: frame blockIdx.x of item blockIdx.y (frames past T give zeros)
// as bf16 h into the swizzled image of its tile: byte (c / 64) * 8192 +
// r * 128 + (c % 64) * 2 of the tile's C' * 128 bytes, r = frame % 64.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
wide_layernorm_kernel(const T* __restrict__ x, unsigned char* __restrict__ h_img,
                      const float* __restrict__ dw, const float* __restrict__ dwb,
                      const float* __restrict__ lnw, const float* __restrict__ lnb, int t_len,
                      int c_len, int c_pad, int n_tiles) {
  extern __shared__ float v[];  // the frame's dwconv outputs, c_len floats, then c_len of sums
  float* w = v + c_len;
  const int frame = blockIdx.x;
  const int item = blockIdx.y;
  const int r = frame % TM;
  unsigned char* img =
      h_img + (static_cast<size_t>(item) * n_tiles + frame / TM) * static_cast<size_t>(c_pad) * TM * 2;
  auto put = [&](int c, float hv) {
    const uint32_t off = (c / KB) * TILE_BYTES + r * ROW + (c % KB) * 2;
    *reinterpret_cast<__nv_bfloat16*>(img + swizzle(off)) = __float2bfloat16_rn(hv);
  };
  if (frame >= t_len) {  // the last tile's rows past T: zeros
    for (int c = threadIdx.x; c < c_pad; c += LN_THREADS) put(c, 0.f);
    return;
  }
  const T* xb = x + static_cast<size_t>(item) * t_len * c_len;
  for (int c = threadIdx.x; c < c_len; c += LN_THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) {  // taps outside [0, T) add the twin's 0 * dw = 0
      const int t = frame + k - HALO;
      if (t >= 0 && t < t_len)
        acc = __fadd_rn(acc, __fmul_rn(to_f32(xb[static_cast<size_t>(t) * c_len + c]),
                                       dw[k * c_len + c]));
    }
    acc = __fadd_rn(acc, dwb[c]);
    v[c] = acc;
    w[c] = acc;
  }
  __syncthreads();
  const float n = static_cast<float>(c_len);
  const float mean = __fdiv_rn(tree_sum(w, c_len), n);
  for (int c = threadIdx.x; c < c_len; c += LN_THREADS) {
    const float d = __fsub_rn(v[c], mean);
    w[c] = __fmul_rn(d, d);
  }
  __syncthreads();
  const float var = __fdiv_rn(tree_sum(w, c_len), n);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
  for (int c = threadIdx.x; c < c_pad; c += LN_THREADS)
    put(c, c < c_len ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[c], mean), rstd), lnw[c]), lnb[c])
                     : 0.f);
}

// Kernel 2: tile blockIdx.x, slab blockIdx.y, item blockIdx.z.
template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1)
wide_products_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const unsigned char* __restrict__ h_img,
                     const unsigned char* __restrict__ packed, const float* __restrict__ b1,
                     const float* __restrict__ b2, const float* __restrict__ gamma, int t_len,
                     int c_len, int c_pad, int inter, int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty_a = full_a + A_STAGES;
  uint64_t* full_b = empty_a + A_STAGES;
  uint64_t* empty_b = full_b + B_STAGES;
  const int tile = blockIdx.x, item = blockIdx.z;
  const int c0 = blockIdx.y * NS;  // the slab's first output channel
  const int n_chunks = (inter + IC - 1) / IC;
  const int n_kb = c_pad / KB;
  const size_t image = static_cast<size_t>(c_pad) * IC * 2;  // one chunk image of the pack
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], CONSUMER_WARPS);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // -- producer: one thread streams (h, W1_j) K blocks and W2_j slab rows;
    // its warpgroup gives up registers to the consumers (128 x 24 + 256 x 240
    // = 384 x 168, the block's allocation)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const unsigned char* h_src =
          h_img + (static_cast<size_t>(item) * n_tiles + tile) * static_cast<size_t>(c_pad) * TM * 2;
      const uint32_t slab_bytes = (c_pad - c0 < NS ? c_pad - c0 : NS) * ROW;
      int qa = 0;
      for (int j = 0; j < n_chunks; ++j) {
        const unsigned char* w1 = packed + static_cast<size_t>(2 * j) * image;
        for (int kb = 0; kb < n_kb; ++kb, ++qa) {
          const int s = qa % A_STAGES;
          if (qa >= A_STAGES) mbar_wait(&empty_a[s], (qa / A_STAGES - 1) & 1);
          mbar_expect_tx(&full_a[s], A_SLOT);
          unsigned char* dst = smem + A_OFF + s * A_SLOT;
          bulk_load(dst, h_src + static_cast<size_t>(kb) * TILE_BYTES, TILE_BYTES, &full_a[s]);
          bulk_load(dst + TILE_BYTES, w1 + static_cast<size_t>(kb) * TILE_BYTES, TILE_BYTES,
                    &full_a[s]);
        }
        const int s = j % B_STAGES;
        if (j >= B_STAGES) mbar_wait(&empty_b[s], (j / B_STAGES - 1) & 1);
        mbar_expect_tx(&full_b[s], slab_bytes);
        bulk_load(smem + B_OFF + s * B_SLOT,
                  packed + static_cast<size_t>(2 * j + 1) * image + static_cast<size_t>(c0) * ROW,
                  slab_bytes, &full_b[s]);
      }
    }
    return;
  }

  // -- consumers -------------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
  const int tid = threadIdx.x;  // 0..255
  const int lane = tid % 32;
  const int w = wg;                // which half of the slab's output channels
  const int wq = (tid / 32) % 4;   // warp within the warpgroup: rows 16 wq .. 16 wq + 15
  const uint32_t a_ring = smem_u32(smem + A_OFF);
  const uint32_t b_ring = smem_u32(smem + B_OFF);
  const uint32_t g_addr = smem_u32(smem + G_OFF);
  unsigned char* g_s = smem + G_OFF;
  // each wgmma group sums 64 products into fresh registers, which are added
  // to the running sums with round-to-nearest float32 adds
  float acc[NS / 4], part[NS / 4];
#pragma unroll
  for (int i = 0; i < NS / 4; ++i) acc[i] = 0.f;
  float s_reg[16], s_part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s_reg[i] = 0.f;

  int qa = 0;
  for (int j = 0; j < n_chunks; ++j) {
    // S_w = h @ W1_j[:, 32w : 32w + 32], K block by K block
    for (int kb = 0; kb < n_kb; ++kb, ++qa) {
      const int s = qa % A_STAGES;
      mbar_wait(&full_a[s], (qa / A_STAGES) & 1);
      wgmma_fence();
      const uint32_t h_base = a_ring + s * A_SLOT;
      const uint32_t w_base = h_base + TILE_BYTES + w * 32 * ROW;
#pragma unroll
      for (int k = 0; k < KB / 16; ++k)
        wgmma_bf16<32>(s_part, smem_desc(h_base + k * 32), smem_desc(w_base + k * 32), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty_a[s]);
#pragma unroll
      for (int i = 0; i < 16; ++i) s_reg[i] = kb > 0 ? __fadd_rn(s_reg[i], s_part[i]) : s_part[i];
    }
    // bias + GELU, rounded to bf16 into this warpgroup's half of G_j
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = w * 32 + 8 * jj + 2 * (lane % 4);
      const int col = j * IC + n;
      const float bias0 = col < inter ? b1[col] : 0.f;
      const float bias1 = col + 1 < inter ? b1[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wq + lane / 4 + 8 * half;
        const __nv_bfloat162 g2 =
            __floats2bfloat162_rn(gelu(__fadd_rn(s_reg[4 * jj + 2 * half], bias0)),
                                  gelu(__fadd_rn(s_reg[4 * jj + 2 * half + 1], bias1)));
        *reinterpret_cast<__nv_bfloat162*>(g_s + swizzle(r * ROW + n * 2)) = g2;
      }
    }
    fence_async_smem();
    consumers_sync();  // G_j whole
    // acc_w += G_j @ W2_j[:, c0 + 128w : c0 + 128w + 128]
    const int sb = j % B_STAGES;
    mbar_wait(&full_b[sb], (j / B_STAGES) & 1);
    wgmma_fence();
    const uint32_t w2_base = b_ring + sb * B_SLOT + w * (NS / 2) * ROW;
#pragma unroll
    for (int k = 0; k < IC / 16; ++k)
      wgmma_bf16<NS / 2>(part, smem_desc(g_addr + k * 32), smem_desc(w2_base + k * 32), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty_b[sb]);
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    consumers_sync();  // both warpgroups have read G_j before G_{j+1} is written
  }

  // -- epilogue: out = x + gamma * (acc + b2), in x's dtype, columns below C
  const T* xb = x + static_cast<size_t>(item) * t_len * c_len;
  T* ob = out + static_cast<size_t>(item) * t_len * c_len;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = tile * TM + 16 * wq + lane / 4 + 8 * half;
    if (t >= t_len) continue;
#pragma unroll
    for (int jj = 0; jj < NS / 16; ++jj) {
      const int c = c0 + w * (NS / 2) + 8 * jj + 2 * (lane % 4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e >= c_len) continue;
        const size_t idx = static_cast<size_t>(t) * c_len + c + e;
        const float hv = __fadd_rn(acc[4 * jj + 2 * half + e], b2[c + e]);
        store(ob + idx, __fadd_rn(to_f32(xb[idx]), __fmul_rn(gamma[c + e], hv)));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, const void* dw, const void* dwb, const void* lnw,
                   const void* lnb, const void* packed, const void* b1, const void* b2,
                   const void* gamma, void* h_img, int batch, int t_len, int c_len, int inter,
                   cudaStream_t stream) {
  const int n_tiles = (t_len + TM - 1) / TM;
  const int c_pad = (c_len + KB - 1) / KB * KB;
  auto ln = wide_layernorm_kernel<T>;
  const int ln_smem = 2 * c_len * 4;
  cudaError_t err = cudaFuncSetAttribute(ln, cudaFuncAttributeMaxDynamicSharedMemorySize, ln_smem);
  if (err != cudaSuccess) return err;
  ln<<<dim3(n_tiles * TM, batch), LN_THREADS, ln_smem, stream>>>(
      static_cast<const T*>(x), static_cast<unsigned char*>(h_img), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), t_len, c_len, c_pad, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto products = wide_products_kernel<T>;
  err = cudaFuncSetAttribute(products, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  products<<<dim3(n_tiles, (c_pad + NS - 1) / NS, batch), NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const unsigned char*>(h_img),
      static_cast<const unsigned char*>(packed), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<const float*>(gamma), t_len, c_len, c_pad, inter,
      n_tiles);
  return cudaGetLastError();
}

}  // namespace

// Returns the launches' cudaError_t (0 on success). x_bf16 selects the type
// of x and out: 0 for float32, 1 for bfloat16. `packed` holds the weights as
// ops/fused_convnext.py::kernel_weights lays them out, padded to C' and I';
// `h_img` is scratch of B x ceil(T / 64) x 64 x C' bf16 (C' = C rounded up
// to a multiple of 64), written by the first kernel and read by the second.
extern "C" int convnext_block_wide_launch(const void* x, void* out, const void* dw,
                                          const void* dwb, const void* lnw, const void* lnb,
                                          const void* packed, const void* b1, const void* b2,
                                          const void* gamma, void* h_img, int batch, int t_len,
                                          int channels, int inter, int x_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || t_len < 1 || channels < 1 || channels > MAX_CHANNELS ||
      inter < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, h_img, batch,
                                 t_len, channels, inter, s);
  return launch<float>(x, out, dw, dwb, lnw, lnb, packed, b1, b2, gamma, h_img, batch, t_len,
                       channels, inter, s);
}
