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
// s1 (I,) and s2 (C,), quantized by the caller and passed transposed, W1q^T
// (I, C) and W2q^T (C, I), so that the products' depth is contiguous, as the
// tensor cores' B operand wants it.
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
// activations in and out, 0.026 ms at 3.35 TB/s.
//
// Design (simple first; PERF.md has its time against the bound):
// - one block of 8 warps per (item, 32-frame tile); any T >= 1, the ragged
//   last tile is masked and the halo reads zeros only outside [0, T);
// - dwconv + LayerNorm + the first quantizer, one warp per frame: the int8
//   codes go to shared memory;
// - the second quantizer needs the whole row of u (all I columns) before it
//   can scale any of it, so the tile runs in two phases. Phase 1 walks I in
//   64-wide chunks of W1q^T staged in shared memory, and writes
//   u = gelu(dequant(hq @ W1q)) as float32 into a (32, I) tile in shared
//   memory (147 KB at I = 1152). Then each frame's amax is taken and its
//   codes are written over the start of its own float32 row. Phase 2 walks I
//   again in 64-deep chunks of W2q^T, with the (32, C) int32 sums in
//   registers;
// - products: mma.sync m16n8k32 s8.s8.s32, fragments loaded from shared
//   memory as 32-bit words (rows padded so that a warp's loads hit 32
//   distinct banks);
// - epilogue straight from the accumulator fragments: out = x + gamma * h2.
// Not done yet (later work): cp.async / TMA double buffering of the weight
// chunks, wgmma, more than one block per SM (the f32 u tile takes 191 KB).
//
// Shapes taken: C in {128, 256, 384} (a template argument), I a multiple of
// 64 whose f32 tile fits the 227 KB a block may use (I <= 1408 for every C),
// x in f32 or bf16. The caller checks shapes and types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;      // frames per block
constexpr int KC = 64;      // intermediate channels per weight chunk
constexpr int HALO = 3;     // k = 7 depthwise conv
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD_Q = 16;   // int8 row padding in bytes: row pitch = 4 mod 32 words
constexpr int PAD_F = 4;    // f32 row padding in words
constexpr int MAX_SMEM = 232448;

// The constants of the JAX function, rounded from double as PyTorch and XLA
// round a Python float to float32.
constexpr float EPS = static_cast<float>(1e-6);
constexpr float AMAX_MIN = static_cast<float>(1e-12);
constexpr float INV127 = static_cast<float>(1.0 / 127.0);
constexpr float INV_SQRT2 = static_cast<float>(0.7071067811865475);  // 1 / sqrt(2)
constexpr float A1 = static_cast<float>(0.254829592), A2 = static_cast<float>(-0.284496736),
                A3 = static_cast<float>(1.421413741), A4 = static_cast<float>(-1.453152027),
                A5 = static_cast<float>(1.061405429), P = static_cast<float>(0.3275911);

__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }

// Shared-memory layout, in bytes, for channels C and intermediate width I.
// The LayerNorm's tree-sum scratch (8 warps x C floats) lives in the weight
// chunk, which is not used until the first product.
struct Layout {
  int ldh1, ldq, h1_off, hq_off, scale_off, w_off, bytes;
  __host__ __device__ Layout(int c, int inter) {
    ldh1 = inter + PAD_F;  // f32 words per row of u; later its int8 codes
    ldq = c + PAD_Q;
    h1_off = 0;
    hq_off = h1_off + align128(TM * ldh1 * 4);
    scale_off = hq_off + align128(TM * ldq);
    w_off = scale_off + align128(2 * TM * 4);
    const int w1_chunk = KC * (c + PAD_Q), w2_chunk = c * (KC + PAD_Q);
    bytes = w_off + align128(w1_chunk > w2_chunk ? w1_chunk : w2_chunk);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum of s[0..N) by halves, in place: s[i] += s[i + n/2] for i < n/2, the odd
// last element carried to s[n/2]; the order of the twin's `_tree_sum`.
template <int N>
__device__ __forceinline__ float tree_sum(float* s, int lane) {
  __syncwarp();
  int n = N;
  while (n > 1) {
    const int half = n >> 1;
    for (int i = lane; i < half; i += 32) s[i] = __fadd_rn(s[i], s[i + half]);
    __syncwarp();
    if (n & 1) {
      if (lane == 0) s[half] = s[n - 1];
      __syncwarp();
    }
    n = half + (n & 1);
  }
  const float total = s[0];
  __syncwarp();  // every lane has read s[0] before the caller reuses s
  return total;
}

// The A-S 7.1.26 erf of the JAX kernel (pallas_convnext.py::_erf), its
// operations in the same order.
__device__ __forceinline__ float erf_as(float x) {
  const float s = static_cast<float>((x > 0.f) - (x < 0.f));
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(P, ax)));
  float poly = __fadd_rn(A4, __fmul_rn(t, A5));
  poly = __fadd_rn(A3, __fmul_rn(t, poly));
  poly = __fadd_rn(A2, __fmul_rn(t, poly));
  poly = __fadd_rn(A1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))));
}

__device__ __forceinline__ float gelu_as(float u) {
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, erf_as(__fmul_rn(u, INV_SQRT2))));
}

// ((f32(acc) * row_scale) * col_scale) + bias, no FMA
__device__ __forceinline__ float dequant(int acc, float row_scale, float col_scale, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(acc), row_scale), col_scale), bias);
}

__device__ __forceinline__ int8_t quant(float v, float inv) {
  return static_cast<int8_t>(static_cast<int>(rintf(__fmul_rn(v, inv))));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A (16x32, row) * B (32x8, col), int8 operands, int32 sums. Fragment
// layout (PTX ISA, mma.m16n8k32): with g = lane / 4, q = lane % 4, a[0] holds
// A[g][4q..4q+3], a[1] A[g+8][4q..], a[2] A[g][16+4q..], a[3] A[g+8][16+4q..];
// b[0] holds B[4q..4q+3][g], b[1] B[16+4q..][g]; d[0..1] D[g][2q, 2q+1],
// d[2..3] D[g+8][2q, 2q+1].
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A fragment of rows [r0, r0 + 16), depth [k, k + 32) of an int8 matrix
// with row pitch `ld` bytes
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* m, int ld, int r0, int k,
                                       int g, int q) {
  const int8_t* p = m + (r0 + g) * ld + k + 4 * q;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * ld + 16);
}

// the B fragment of columns [n0, n0 + 8), depth [k, k + 32) of a matrix held
// transposed (one row of `ld` bytes per column)
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const int8_t* mt, int ld, int n0, int k,
                                       int g, int q) {
  const int8_t* p = mt + (n0 + g) * ld + k + 4 * q;
  b[0] = ld32(p);
  b[1] = ld32(p + 16);
}

template <int C, typename T>
__global__ void __launch_bounds__(NTHREADS)
convnext_block_int8_kernel(const T* __restrict__ x, T* __restrict__ out,
                           const float* __restrict__ dw, const float* __restrict__ dwb,
                           const float* __restrict__ lnw, const float* __restrict__ lnb,
                           const int8_t* __restrict__ w1t, const float* __restrict__ s1,
                           const float* __restrict__ b1, const int8_t* __restrict__ w2t,
                           const float* __restrict__ s2, const float* __restrict__ b2,
                           const float* __restrict__ gamma, int t_len, int inter) {
  constexpr int PER_LANE = C / 32;  // channels per lane in the LayerNorm phase
  constexpr int LDW1 = C + PAD_Q;   // staged W1q^T chunk (KC, C)
  constexpr int LDW2 = KC + PAD_Q;  // staged W2q^T chunk (C, KC)
  constexpr int NT2 = C / 32;       // 8-column output tiles per warp in phase 2
  const Layout L(C, inter);
  extern __shared__ __align__(128) unsigned char smem[];
  float* u_s = reinterpret_cast<float*>(smem + L.h1_off);
  int8_t* hq_s = reinterpret_cast<int8_t*>(smem + L.hq_off);
  float* hs_s = reinterpret_cast<float*>(smem + L.scale_off);
  float* us_s = hs_s + TM;
  int8_t* w_s = reinterpret_cast<int8_t*>(smem + L.w_off);

  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const T* xb = x + static_cast<size_t>(item) * t_len * C;
  T* ob = out + static_cast<size_t>(item) * t_len * C;

  // -- dwconv + LayerNorm + first quantizer, one warp per frame -------------
  float* red = reinterpret_cast<float*>(w_s) + warp * C;
  for (int r = warp; r < TM; r += NWARPS) {
    const int t = t0 + r;
    int8_t* qrow = hq_s + r * L.ldq;
    if (t >= t_len) {  // ragged last tile: rows past T are never written out
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) qrow[lane + 32 * j] = 0;
      if (lane == 0) hs_s[r] = 0.f;
      continue;
    }
    float v[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int tt = t + k - HALO;
        const float xv = (tt >= 0 && tt < t_len) ? to_f32(xb[static_cast<size_t>(tt) * C + c]) : 0.f;
        acc = __fadd_rn(acc, __fmul_rn(xv, dw[k * C + c]));
      }
      acc = __fadd_rn(acc, dwb[c]);
      v[j] = acc;
      red[c] = acc;
    }
    const float mean = __fdiv_rn(tree_sum<C>(red, lane), static_cast<float>(C));
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const float d = __fsub_rn(v[j], mean);
      v[j] = d;
      red[lane + 32 * j] = __fmul_rn(d, d);
    }
    const float var = __fdiv_rn(tree_sum<C>(red, lane), static_cast<float>(C));
    const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, EPS)));
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int c = lane + 32 * j;
      v[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[j], rstd), lnw[c]), lnb[c]);
      amax = fmaxf(amax, fabsf(v[j]));
    }
    amax = fmaxf(warp_max(amax), AMAX_MIN);
    const float inv = __fdiv_rn(127.f, amax);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) qrow[lane + 32 * j] = quant(v[j], inv);
    if (lane == 0) hs_s[r] = __fmul_rn(amax, INV127);
  }
  __syncthreads();  // the codes are in place and the scratch in w_s is free

  // -- phase 1: u = gelu(dequant(hq @ W1q)) into the f32 tile, 64 columns at a time
  {
    const int mb = (warp & 1) * 16;    // the warp's 16 rows
    const int nb = (warp >> 1) * 16;   // and its two 8-column tiles of the chunk
    for (int i0 = 0; i0 < inter; i0 += KC) {
      for (int e = threadIdx.x; e < KC * (C / 16); e += NTHREADS) {
        const int row = e / (C / 16);
        const int col = (e % (C / 16)) * 16;
        *reinterpret_cast<uint4*>(w_s + row * LDW1 + col) =
            *reinterpret_cast<const uint4*>(w1t + static_cast<size_t>(i0 + row) * C + col);
      }
      __syncthreads();
      int acc[2][4] = {};
#pragma unroll 4
      for (int k = 0; k < C; k += 32) {
        uint32_t a[4];
        load_a(a, hq_s, L.ldq, mb, k, g, q);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[2];
          load_b(b, w_s, LDW1, nb + 8 * j, k, g, q);
          mma_s8(acc[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mb + g + 8 * h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = i0 + nb + 8 * j + 2 * q + e;
            u_s[r * L.ldh1 + col] = gelu_as(dequant(acc[j][2 * h + e], hs_s[r], s1[col], b1[col]));
          }
        }
      __syncthreads();  // the next chunk overwrites w_s
    }
  }

  // -- second quantizer: each frame's codes over the start of its f32 row ---
  for (int r = warp; r < TM; r += NWARPS) {
    float* row = u_s + r * L.ldh1;
    float amax = 0.f;
    for (int i = lane; i < inter; i += 32) amax = fmaxf(amax, fabsf(row[i]));
    amax = fmaxf(warp_max(amax), AMAX_MIN);
    const float inv = __fdiv_rn(127.f, amax);
    int8_t* qrow = reinterpret_cast<int8_t*>(row);
    // byte i lies in float i / 4, which was read in this pass or an earlier
    // one; no later pass reads below float 32 * pass
    for (int i = lane; i < inter; i += 32) {
      const float v = row[i];
      __syncwarp();
      qrow[i] = quant(v, inv);
    }
    if (lane == 0) us_s[r] = __fmul_rn(amax, INV127);
  }
  __syncthreads();

  // -- phase 2: (32, C) int32 sums of uq @ W2q in registers, 64 deep at a time
  const int8_t* uq_s = reinterpret_cast<const int8_t*>(u_s);
  const int ldu = L.ldh1 * 4;
  const int mb = (warp & 1) * 16;
  const int nb = (warp >> 1) * NT2 * 8;
  int acc[NT2][4] = {};
  for (int k0 = 0; k0 < inter; k0 += KC) {
    for (int e = threadIdx.x; e < C * (KC / 16); e += NTHREADS) {
      const int row = e / (KC / 16);
      const int col = (e % (KC / 16)) * 16;
      *reinterpret_cast<uint4*>(w_s + row * LDW2 + col) =
          *reinterpret_cast<const uint4*>(w2t + static_cast<size_t>(row) * inter + k0 + col);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 32) {
      uint32_t a[4];
      load_a(a, uq_s, ldu, mb, k0 + kk, g, q);
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        uint32_t b[2];
        load_b(b, w_s, LDW2, nb + 8 * j, kk, g, q);
        mma_s8(acc[j], a, b);
      }
    }
    __syncthreads();  // the next chunk overwrites w_s
  }

  // -- epilogue: out = x + gamma * h2, in x's dtype --------------------------
#pragma unroll
  for (int j = 0; j < NT2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mb + g + 8 * h;
      const int t = t0 + r;
      if (t >= t_len) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nb + 8 * j + 2 * q + e;
        const size_t idx = static_cast<size_t>(t) * C + c;
        const float h2 = dequant(acc[j][2 * h + e], us_s[r], s2[c], b2[c]);
        ob[idx] = from_f32<T>(__fadd_rn(to_f32(xb[idx]), __fmul_rn(gamma[c], h2)));
      }
    }
}

template <int C, typename T>
cudaError_t launch(const void* x, void* out, const void* dw, const void* dwb, const void* lnw,
                   const void* lnb, const void* w1t, const void* s1, const void* b1,
                   const void* w2t, const void* s2, const void* b2, const void* gamma, int batch,
                   int t_len, int inter, cudaStream_t stream) {
  const Layout L(C, inter);
  if (L.bytes > MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = convnext_block_int8_kernel<C, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + TM - 1) / TM, batch);
  kernel<<<grid, NTHREADS, L.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const float*>(dw),
      static_cast<const float*>(dwb), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const int8_t*>(w1t),
      static_cast<const float*>(s1), static_cast<const float*>(b1),
      static_cast<const int8_t*>(w2t), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const float*>(gamma), t_len, inter);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int channels, const void* x, void* out, const void* dw, const void* dwb,
                     const void* lnw, const void* lnb, const void* w1t, const void* s1,
                     const void* b1, const void* w2t, const void* s2, const void* b2,
                     const void* gamma, int batch, int t_len, int inter, cudaStream_t stream) {
  switch (channels) {
    case 128:
      return launch<128, T>(x, out, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2, gamma, batch,
                            t_len, inter, stream);
    case 256:
      return launch<256, T>(x, out, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2, gamma, batch,
                            t_len, inter, stream);
    case 384:
      return launch<384, T>(x, out, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2, gamma, batch,
                            t_len, inter, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). x_bf16 selects the type of
// x and out: 0 for float32, 1 for bfloat16. w1t is W1q^T (I, C) and w2t is
// W2q^T (C, I), int8; s1 (I,) and s2 (C,) their float32 scales.
extern "C" int convnext_block_int8_launch(const void* x, void* out, const void* dw,
                                          const void* dwb, const void* lnw, const void* lnb,
                                          const void* w1t, const void* s1, const void* b1,
                                          const void* w2t, const void* s2, const void* b2,
                                          const void* gamma, int batch, int t_len, int channels,
                                          int inter, int x_bf16, void* stream) {
  if (batch < 1 || t_len < 1 || inter < KC || inter % KC != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(channels, x, out, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2,
                                   gamma, batch, t_len, inter, s);
  return dispatch<float>(channels, x, out, dw, dwb, lnw, lnb, w1t, s1, b1, w2t, s2, b2, gamma,
                         batch, t_len, inter, s);
}
