// Fused ConvNeXt block for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_convnext.py::convnext_block_fused, the
// Pallas TPU kernel of the inference hot path. One call computes a whole
// ConvNeXt block on x (B, T, C):
//
//   h   = LayerNorm_f32(dwconv7(x) + dwb)               eps 1e-6, centred variance
//   u   = gelu_exact(bf16(h) @ bf16(W1) + b1)           f32 accumulation
//   out = x + gamma * (bf16(u) @ bf16(W2) + b2)         f32 accumulation, x's dtype
//
// with a 3-frame halo on each side of a tile that reads real neighbours and
// zeros only outside [0, T).
//
// Bound on this card: operations. The two products take 4*B*T*C*I FLOP; at
// the WaveNeXt trunk's bench shape (B=32, T=1792, C=384, I=1152) that is
// 1.0e11 FLOP, 0.10 ms at the 989 TFLOP/s bf16 dense peak, against 88 MB of
// bf16 activations in and out (176 MB in f32), 0.03-0.05 ms at 3.35 TB/s.
// An unfused block would also write and read the (T, I) intermediate, three
// times the activation bytes at I = 3C; this kernel keeps it on chip.
//
// Design (simple first, see PERF.md for its time against the bound):
// - one block of 8 warps per (item, 64-frame tile); any T >= 1, the ragged
//   last tile is masked;
// - dwconv + LayerNorm: one warp per frame, each lane holds C/32 channels
//   in registers; the result goes to shared memory as bf16 (the operand the
//   tensor cores take);
// - the MLP loops over I in 64-wide chunks: the W1 and W2 chunks are staged
//   in shared memory, S = h @ W1c runs on the tensor cores (WMMA bf16,
//   f32 accumulation), bias + exact GELU round it to bf16, and G @ W2c is
//   accumulated into a (64, C) f32 accumulator held in registers across all
//   chunks. The (T, I) intermediate never reaches device memory.
// - epilogue: the accumulator is staged through shared memory and written
//   as x + gamma * (acc + b2) in x's dtype.
// Not done yet (later work): TMA / cp.async double buffering of the weight
// chunks, wgmma, larger tiles, more than one block per SM.
//
// Shapes taken: C in {128, 256, 384} (a template argument), I a multiple of
// 64, x in f32 or bf16, every other parameter f32 except W1 (C, I) and
// W2 (I, C), which arrive in bf16. The caller checks shapes and types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;      // frames per block
constexpr int IC = 64;      // intermediate channels per chunk
constexpr int HALO = 3;     // k = 7 depthwise conv
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD_H = 8;    // bf16 row padding (16 bytes) against bank conflicts
constexpr int PAD_F = 4;    // f32 row padding

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// Shared-memory layout, in bytes. The f32 output staging of the epilogue
// reuses the h tile and the W1 chunk, which are dead by then.
template <int C>
struct Layout {
  static constexpr int LDH = C + PAD_H;    // h tile (TM, C) bf16
  static constexpr int LDW1 = IC + PAD_H;  // W1 chunk (C, IC) bf16
  static constexpr int LDS = IC + PAD_F;   // S (TM, IC) f32
  static constexpr int LDG = IC + PAD_H;   // G (TM, IC) bf16
  static constexpr int LDW2 = C + PAD_H;   // W2 chunk (IC, C) bf16
  static constexpr int LDO = C + PAD_F;    // output staging (TM, C) f32
  static constexpr int H_OFF = 0;
  static constexpr int W1_OFF = H_OFF + align128(TM * LDH * 2);
  static constexpr int S_OFF = W1_OFF + align128(C * LDW1 * 2);
  static constexpr int G_OFF = S_OFF + align128(TM * LDS * 4);
  static constexpr int W2_OFF = G_OFF + align128(TM * LDG * 2);
  static constexpr int BYTES = W2_OFF + align128(IC * LDW2 * 2);
  static_assert(TM * LDO * 4 <= S_OFF, "output staging must fit over h and the W1 chunk");
  static_assert(BYTES <= 232448, "a block may use at most 227 KB of shared memory");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int C, typename T>
__global__ void __launch_bounds__(NTHREADS)
convnext_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ dw, const float* __restrict__ dwb,
                      const float* __restrict__ lnw, const float* __restrict__ lnb,
                      const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w2, const float* __restrict__ b2,
                      const float* __restrict__ gamma, int t_len, int inter) {
  using L = Layout<C>;
  constexpr int PER_LANE = C / 32;   // channels per lane in the LayerNorm phase
  constexpr int NCW = C / 16 / NWARPS;  // output column fragments per warp
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L::H_OFF);
  __nv_bfloat16* w1_s = reinterpret_cast<__nv_bfloat16*>(smem + L::W1_OFF);
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem + L::G_OFF);
  __nv_bfloat16* w2_s = reinterpret_cast<__nv_bfloat16*>(smem + L::W2_OFF);
  float* o_s = reinterpret_cast<float*>(smem);

  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* xb = x + static_cast<size_t>(item) * t_len * C;
  T* ob = out + static_cast<size_t>(item) * t_len * C;

  // -- depthwise conv + LayerNorm, one warp per frame ----------------------
  for (int r = warp; r < TM; r += NWARPS) {
    const int t = t0 + r;
    __nv_bfloat16* hrow = h_s + r * L::LDH;
    if (t >= t_len) {  // ragged last tile: rows past T are never written out
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) hrow[lane + 32 * j] = __float2bfloat16(0.f);
      continue;
    }
    float v[PER_LANE];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int tt = t + k - HALO;
        if (tt >= 0 && tt < t_len) acc += to_f32(xb[static_cast<size_t>(tt) * C + c]) * dw[k * C + c];
      }
      acc += dwb[c];
      v[j] = acc;
      sum += acc;
    }
    const float mean = warp_sum(sum) * (1.f / C);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const float d = v[j] - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(warp_sum(sq) * (1.f / C) + 1e-6f);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      hrow[c] = __float2bfloat16((v[j] - mean) * rstd * lnw[c] + lnb[c]);
    }
  }

  // -- MLP over I in chunks; the (TM, C) accumulator stays in registers ----
  FragC acc[4][NCW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NCW; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int i0 = 0; i0 < inter; i0 += IC) {
    // stage W1[:, i0:i0+IC] and W2[i0:i0+IC, :], 16 bytes per thread per step
    for (int e = threadIdx.x; e < C * (IC / 8); e += NTHREADS) {
      const int row = e / (IC / 8);
      const int col = (e % (IC / 8)) * 8;
      *reinterpret_cast<uint4*>(w1_s + row * L::LDW1 + col) =
          *reinterpret_cast<const uint4*>(w1 + static_cast<size_t>(row) * inter + i0 + col);
    }
    for (int e = threadIdx.x; e < IC * (C / 8); e += NTHREADS) {
      const int row = e / (C / 8);
      const int col = (e % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(w2_s + row * L::LDW2 + col) =
          *reinterpret_cast<const uint4*>(w2 + static_cast<size_t>(i0 + row) * C + col);
    }
    __syncthreads();  // also orders the LayerNorm writes of h before the first product

    // S = h @ W1c: (TM, C) x (C, IC); 16 fragments, two per warp
    {
      const int fr = warp / 2;
      const int fc = (warp % 2) * 2;
      FragC s[2];
      wmma::fill_fragment(s[0], 0.f);
      wmma::fill_fragment(s[1], 0.f);
#pragma unroll 4
      for (int k = 0; k < C; k += 16) {
        FragA a;
        wmma::load_matrix_sync(a, h_s + fr * 16 * L::LDH + k, L::LDH);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB bm;
          wmma::load_matrix_sync(bm, w1_s + k * L::LDW1 + (fc + j) * 16, L::LDW1);
          wmma::mma_sync(s[j], a, bm, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(s_s + fr * 16 * L::LDS + (fc + j) * 16, s[j], L::LDS,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // bias + exact GELU, rounded to bf16 for the second product
    for (int e = threadIdx.x; e < TM * IC; e += NTHREADS) {
      const int r = e / IC;
      const int n = e % IC;
      const float u = s_s[r * L::LDS + n] + b1[i0 + n];
      g_s[r * L::LDG + n] = __float2bfloat16(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
    }
    __syncthreads();

    // acc += G @ W2c: (TM, IC) x (IC, C); warp w owns columns [w*NCW*16, (w+1)*NCW*16)
#pragma unroll
    for (int k = 0; k < IC; k += 16) {
      FragA a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], g_s + i * 16 * L::LDG + k, L::LDG);
#pragma unroll
      for (int j = 0; j < NCW; ++j) {
        FragB bm;
        wmma::load_matrix_sync(bm, w2_s + k * L::LDW2 + (warp * NCW + j) * 16, L::LDW2);
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], a[i], bm, acc[i][j]);
      }
    }
    __syncthreads();  // the next chunk overwrites w1_s, w2_s and g_s
  }

  // -- epilogue: out = x + gamma * (acc + b2), in x's dtype ----------------
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NCW; ++j)
      wmma::store_matrix_sync(o_s + i * 16 * L::LDO + (warp * NCW + j) * 16, acc[i][j], L::LDO,
                              wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < TM * C; e += NTHREADS) {
    const int r = e / C;
    const int c = e % C;
    const int t = t0 + r;
    if (t < t_len) {
      const size_t idx = static_cast<size_t>(t) * C + c;
      ob[idx] = from_f32<T>(to_f32(xb[idx]) + gamma[c] * (o_s[r * L::LDO + c] + b2[c]));
    }
  }
}

template <int C, typename T>
cudaError_t launch(const void* x, void* out, const void* dw, const void* dwb, const void* lnw,
                   const void* lnb, const void* w1, const void* b1, const void* w2, const void* b2,
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
      static_cast<const float*>(lnb), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma), t_len, inter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int channels, const void* x, void* out, const void* dw, const void* dwb,
                     const void* lnw, const void* lnb, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* gamma, int batch, int t_len,
                     int inter, cudaStream_t stream) {
  switch (channels) {
    case 128:
      return launch<128, T>(x, out, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, batch, t_len, inter, stream);
    case 256:
      return launch<256, T>(x, out, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, batch, t_len, inter, stream);
    case 384:
      return launch<384, T>(x, out, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, batch, t_len, inter, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). x_bf16 selects the type of
// x and out: 0 for float32, 1 for bfloat16.
extern "C" int convnext_block_fused_launch(const void* x, void* out, const void* dw,
                                           const void* dwb, const void* lnw, const void* lnb,
                                           const void* w1, const void* b1, const void* w2,
                                           const void* b2, const void* gamma, int batch,
                                           int t_len, int channels, int inter, int x_bf16,
                                           void* stream) {
  if (batch < 1 || t_len < 1 || inter < IC || inter % IC != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(channels, x, out, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma,
                                   batch, t_len, inter, s);
  return dispatch<float>(channels, x, out, dw, dwb, lnw, lnb, w1, b1, w2, b2, gamma, batch, t_len,
                         inter, s);
}
