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
// B1, except where I is small (C = 12272 / I = 64: the bytes of x and out).
// This path also moves h and u through device memory once each (below);
// that traffic is its cost, not part of the bound.
//
// Design: three kernels on the caller's stream (four where product 1 splits
// its depth), C a runtime argument:
// - `wide_layernorm_kernel`: dwconv + LayerNorm in float32, bf16 h into an
//   image laid out for the products' bulk copies: per 64-frame row tile
//   (B x ceil(T / 64) of them) C' / 64 tiles of 64 frames x 128 bytes,
//   128-byte swizzled, zeros past C and past T (C' = C rounded up to a
//   multiple of 64). A block takes `ln_frames(C')` consecutive frames of
//   one item (16 at C' <= 768, one above 6144): each thread loads an
//   8-frame window of rows for a channel pair (14 rows of x for 8 frames,
//   not 56), the block sums each frame's mean and variance by halves while
//   more than 1024 values are left, a warp a frame then (shared memory,
//   then shuffles), and h leaves as 128-byte warp stores;
// - `wide_gemm_kernel`, once per product: out tile = A @ B over 64-deep K
//   blocks, A from an image (h, or u for product 2) and B from B1's own pack
//   (ops/fused_convnext.py::kernel_weights: for chunk j of I, the W1 image,
//   C' / 64 K blocks of 64 columns, then the W2 image, C' rows of the 64
//   K values of chunk j). A persistent grid of one block per SM walks
//   128 x 128 output tiles (a K split of product 1 is a tile of its own);
//   each block has five warpgroups:
//     * one thread of the producer streams, per K block, the two 64-frame A
//       tiles and the two 64-column B tiles (8 KB each, cp.async.bulk) into
//       a ring of 4 slots on mbarriers;
//     * two MMA warpgroups each take 64 rows: per K block a wgmma group
//       (m64n128k16 x 4) into fresh registers, added to the running sums
//       with float32 round-to-nearest adds (the tensor cores sum at less
//       than float32's rounding, which at C in the thousands moved the
//       result past the tolerance when all of K was chained in one
//       accumulator); the tile's sums then go to a float32 staging tile in
//       shared memory;
//     * two epilogue warpgroups read the staging tile while the MMA
//       warpgroups run the next tile's products, so that the GELU (or the
//       residual's loads and stores) overlap the tensor cores; a warp
//       takes 4 rows at once, so that their chains overlap. Product 1 adds
//       b1, applies the GELU and writes bf16 u into its image, rows as
//       128-byte warp stores; product 2 writes x + gamma * (acc + b2); a
//       split of product 1 writes its float32 partial sums;
// - `wide_split_gelu_kernel` (only where product 1 is split): the partial
//   sums added in split order, then b1 and the GELU, into u's image. A
//   fixed order, so the result does not change from run to run.
// Where product 1's tiles would fill fewer than half the SMs (small I and
// few frames: C = 12272 / I = 64 at T = 64 has 16 of them over 192 K
// blocks) the host cuts its depth (`wide_plan` in ops/fused_convnext.py).
// Rows past T and columns past C or I' in a tile are computed on whatever
// the ring holds and never stored.
//
// Arithmetic: the dwconv, the LayerNorm (its sums by halves, its 1/sqrt a
// division by a rounded square root), b1, the GELU (`expf`, IEEE division)
// and the epilogue use the round-to-nearest intrinsics in the twin's order
// (ops/fused_convnext.py::convnext_block_reference), so nvcc fuses no
// multiply-add there and h equals the twin's bit for bit. Only the
// products' sums run in another order. An h that lands on the other side of
// a bf16 rounding moves a whole row of u, and through u's roundings the
// block's output by ~1e-3: a LayerNorm summed in another order flips such an
// h in about one frame in a hundred at C = 768 (scripts/b1_wide_error.py).
// u in memory changes no number: the twin rounds gelu(...) to bf16 before
// product 2 as well.
//
// Budgets: the product kernel keeps 4 slots x 32 KB and a 128 x 136 float32
// staging tile (68 KB) in 197 KB of shared memory; setmaxnreg gives the MMA
// warpgroups 152 registers a thread (64 for the sums, 64 for a K block's
// products), the epilogue 72 and the producer 24 (within 640 x 96).
// Measured (PERF.md, PR 9): the epilogue's GELU bounds product 1 (its
// instructions, not the tensor cores); the MMA warpgroups add each K
// block's sum in step, which leaves the tensor cores near half busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TM = 64;          // frames of a row tile: one wgmma M
constexpr int KB = 64;          // channels of a K block: one 128-byte row of bf16
constexpr int HALO = 3;         // k = 7 depthwise conv
constexpr int MAX_CHANNELS = 16384;
constexpr int TILE_BYTES = TM * KB * 2;  // an image tile, or 64 columns of a B K block: 8 KB

// LayerNorm kernel: a block of LN_THREADS takes ln_frames(C') frames
constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_MAX_FRAMES = 16;
constexpr int LN_FLOATS = 12288;  // dwconv outputs a block keeps, about
constexpr int LN_GROUP = 8;       // frames a thread's dwconv window covers
constexpr int LN_WARP_SUM = 1024; // sums above this many elements start block-wide

// Product kernel
constexpr int BM = 2 * TM;    // rows of an output tile, one row tile per MMA warpgroup
constexpr int BN = 128;       // columns of an output tile
constexpr int MMA_WGS = 2;    // warpgroups 0 and 1
constexpr int EPI_WGS = 2;    // then the epilogue's
constexpr int PRODUCER_WG = MMA_WGS + EPI_WGS;
constexpr int GEMM_THREADS = (PRODUCER_WG + 1) * 128;
constexpr int EPI_WARPS = EPI_WGS * 4;
constexpr int EPI_ROWS = 4;   // rows an epilogue warp takes at once, for independent chains
// registers a thread after setmaxnreg, within the block's GEMM_THREADS x
// (65536 / GEMM_THREADS, in steps of 8)
constexpr int PRODUCER_REGS = 24, EPI_REGS = 72, MMA_REGS = 152;
static_assert(128 * (PRODUCER_REGS + EPI_WGS * EPI_REGS + MMA_WGS * MMA_REGS) <=
                  GEMM_THREADS * (65536 / GEMM_THREADS / 8 * 8),
              "setmaxnreg may hand out only the block's registers");
static_assert(BM % (EPI_WARPS * EPI_ROWS) == 0 && TM % (EPI_WARPS * EPI_ROWS) == 0,
              "an epilogue warp's rows at once lie in one row tile");
constexpr int SLOT = 2 * TILE_BYTES + BN * KB * 2;  // two A tiles, then the B tile: 32 KB
constexpr int STAGES = 4;
constexpr int ACC_STRIDE = BN + 8;  // floats a staged row: a warp's float2 stores hit distinct banks
constexpr int ACC_OFF = STAGES * SLOT;
constexpr int BAR_OFF = ACC_OFF + BM * ACC_STRIDE * 4;
constexpr int GEMM_SMEM = BAR_OFF + (2 * STAGES + 2) * 8 + 1024;  // + slack to align the base
static_assert(GEMM_SMEM <= SMEM_LIMIT, "a block may use at most 227 KB of shared memory");
static_assert(SLOT % 1024 == 0 && TILE_BYTES % 1024 == 0, "swizzle atoms are 1024 bytes");

enum Epilogue { EPI_U = 0, EPI_PART = 1, EPI_OUT = 2 };

inline int ln_frames(int c_pad) {
  const int f = LN_FLOATS / c_pad;
  return f < 1 ? 1 : (f > LN_MAX_FRAMES ? LN_MAX_FRAMES : f);
}

// Dynamic shared memory of a LayerNorm block: the frames' dwconv outputs,
// a buffer of C' / 2 + 1 floats for each frame's sums, mean and 1/std.
inline int ln_smem_bytes(int c_pad) {
  const int f = ln_frames(c_pad);
  return (f * c_pad + f * (c_pad / 2 + 1) + 2 * f) * 4;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 pair_at(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// row[c] and row[c + 1] (c even) as float32, zero at or past n: one load
// where n is even (rows of n elements keep pairs aligned), else two.
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* row, int c, int n) {
  if (n % 2 == 0) return c < n ? pair_at(row + c) : make_float2(0.f, 0.f);
  return make_float2(c < n ? to_f32(row[c]) : 0.f, c + 1 < n ? to_f32(row[c + 1]) : 0.f);
}

// 0.5 u (1 + erf(u / sqrt 2)) with the Abramowitz-Stegun erf of the JAX
// kernel (`_erf`), every operation rounded as the twin rounds it (no FMA,
// `expf`): see the header's note on arithmetic.
__device__ __forceinline__ float gelu(float u) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float x = __fmul_rn(u, 0.70710678118654752f);
  const float ax = fabsf(x);
  const float t = __frcp_rn(__fadd_rn(1.f, __fmul_rn(p, ax)));  // = __fdiv_rn(1, .), bit for bit
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  // copysignf(r, x) = sign(x) * r wherever x != 0; at x = 0 u is 0 as well
  const float erf = copysignf(__fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-ax, ax)))), x);
  return __fmul_rn(__fmul_rn(0.5f, u), __fadd_rn(1.f, erf));
}

// One level of the sums by halves for frames 0 .. live - 1 of the block at
// once, by all its threads: buf_f[i] = value(f, i) + value(f, i + n/2) for
// i < n/2, value(f, n - 1) carried to buf_f[n/2] by the thread of i = 0
// (the only one that reads there, first); in place as warp_tree_sum.
// Returns the level's length.
template <typename F>
__device__ __forceinline__ int block_level(F value, float* bufs, int buf_len, int live, int n) {
  const int half = n / 2;
  for (int idx = threadIdx.x; idx < live * half; idx += LN_THREADS) {
    const int f = idx / half, i = idx % half;
    const float s = __fadd_rn(value(f, i), value(f, i + half));
    const float last = i == 0 && n % 2 ? value(f, n - 1) : 0.f;
    bufs[f * buf_len + i] = s;
    if (i == 0 && n % 2) bufs[f * buf_len + half] = last;
  }
  __syncthreads();
  return half + n % 2;
}

// Kernel 1: frames blockIdx.x * frames .. + frames - 1 (of ceil(T / 64) * 64;
// those past T give zeros) of item blockIdx.y, as bf16 h into the image:
// row tile r = item * t_tiles + frame / 64, its tile for channels 64 kb ..
// 64 kb + 63 at (r * C' / 64 + kb) * 8 KB, frame % 64 its row.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
wide_layernorm_kernel(const T* __restrict__ x, unsigned char* __restrict__ h_img,
                      const float* __restrict__ dw, const float* __restrict__ dwb,
                      const float* __restrict__ lnw, const float* __restrict__ lnb, int t_len,
                      int c_len, int c_pad, int t_tiles, int frames) {
  extern __shared__ float ln_smem[];
  const int buf_len = c_pad / 2 + 1;
  float* v = ln_smem;                    // frames x C' dwconv outputs
  float* bufs = v + frames * c_pad;      // a sum buffer per frame
  float* stats = bufs + frames * buf_len;  // mean, 1/std
  const int item = blockIdx.y;
  const int f0 = blockIdx.x * frames;
  const int n_frames = min(frames, t_tiles * TM - f0);
  const int live = max(0, min(n_frames, t_len - f0));  // the block's frames below T
  const T* xb = x + static_cast<size_t>(item) * t_len * c_len;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // dwconv: a thread per (channel pair, LN_GROUP frames), neighbouring
  // threads on neighbouring pairs; the group's window of rows is loaded
  // first (rows outside [0, T) and past the block's frames stay zero: the
  // twin's 0 * dw = 0 adds nothing)
  const int pairs = (c_len + 1) / 2;
  const int groups = (live + LN_GROUP - 1) / LN_GROUP;
  for (int idx = threadIdx.x; idx < pairs * groups; idx += LN_THREADS) {
    const int c = 2 * (idx % pairs), fa = (idx / pairs) * LN_GROUP;
    const int rows = min(LN_GROUP, live - fa) + 2 * HALO;
    float2 win[LN_GROUP + 2 * HALO];
#pragma unroll
    for (int u = 0; u < LN_GROUP + 2 * HALO; ++u) {
      const int t = f0 + fa + u - HALO;
      win[u] = u < rows && t >= 0 && t < t_len
                   ? load_pair(xb + static_cast<size_t>(t) * c_len, c, c_len)
                   : make_float2(0.f, 0.f);
    }
    float2 wk[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) wk[k] = load_pair(dw + k * c_len, c, c_len);
    const float2 bias = load_pair(dwb, c, c_len);
#pragma unroll
    for (int f = 0; f < LN_GROUP; ++f) {
      if (fa + f >= live) break;
      float ax = 0.f, ay = 0.f;
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        ax = __fadd_rn(ax, __fmul_rn(win[f + k].x, wk[k].x));
        ay = __fadd_rn(ay, __fmul_rn(win[f + k].y, wk[k].y));
      }
      *reinterpret_cast<float2*>(v + (fa + f) * c_pad + c) =
          make_float2(__fadd_rn(ax, bias.x), __fadd_rn(ay, bias.y));
    }
  }
  __syncthreads();

  // mean, then 1/std: levels above LN_WARP_SUM elements block-wide, the
  // rest by a warp a frame
  const float n = static_cast<float>(c_len);
  for (int pass = 0; pass < 2; ++pass) {
    auto first = [&](int f, int i) {
      const float a = v[f * c_pad + i];
      if (pass == 0) return a;
      const float d = __fsub_rn(a, stats[2 * f]);
      return __fmul_rn(d, d);
    };
    int len = c_len;
    bool in_buf = false;
    while (len > LN_WARP_SUM) {
      len = in_buf ? block_level([&](int f, int i) { return bufs[f * buf_len + i]; }, bufs, buf_len,
                                 live, len)
                   : block_level(first, bufs, buf_len, live, len);
      in_buf = true;
    }
    for (int f = warp; f < live; f += LN_WARPS) {
      float* buf = bufs + f * buf_len;
      const float sum = in_buf ? warp_tree_sum([&](int i) { return buf[i]; }, buf, len, lane)
                               : warp_tree_sum([&](int i) { return first(f, i); }, buf, len, lane);
      if (lane == 0) {
        if (pass == 0) stats[2 * f] = __fdiv_rn(sum, n);
        else stats[2 * f + 1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(sum, n), 1e-6f)));
      }
    }
    __syncthreads();
  }

  // h: a warp writes one 128-byte row of a tile at a time
  const int nkb = c_pad / KB;
  for (int idx = warp; idx < n_frames * nkb; idx += LN_WARPS) {
    const int f = idx / nkb, kb = idx % nkb;
    const int c = kb * KB + 2 * lane;
    float h0 = 0.f, h1 = 0.f;
    if (f < live) {
      const float mean = stats[2 * f], rstd = stats[2 * f + 1];
      const float2 d = *reinterpret_cast<const float2*>(v + f * c_pad + c);
      const float2 g = load_pair(lnw, c, c_len), bb = load_pair(lnb, c, c_len);
      if (c < c_len) h0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(d.x, mean), rstd), g.x), bb.x);
      if (c + 1 < c_len) h1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(d.y, mean), rstd), g.y), bb.y);
    }
    const int frame = f0 + f;
    const size_t tile = (static_cast<size_t>(item) * t_tiles + frame / TM) * nkb + kb;
    const uint32_t off = (frame % TM) * ROW + (c % KB) * 2;
    *reinterpret_cast<__nv_bfloat162*>(h_img + tile * TILE_BYTES + swizzle(off)) =
        __floats2bfloat162_rn(h0, h1);
  }
}

// One product, out (rows of the A image) = A @ B, and its epilogue.
struct GemmArgs {
  const unsigned char* a;  // row tile r, K block k at (r * a_blocks + k) * 8 KB
  const unsigned char* b;  // K block k, columns 64 j .. 64 j + 63 at k * b_kstride + j * b_jstride
  size_t b_kstride, b_jstride;
  int a_blocks;            // K blocks a row tile of A holds
  int row_tiles;           // 64-frame row tiles of A
  int n_chunks;            // 64-column chunks of the output (I' / 64 or C' / 64)
  int n_tiles;             // BN-column tiles of the output
  int k_blocks, k_splits, k_per_split;
  int units;               // (row tiles / 2) x n_tiles x k_splits
  const float* bias;       // b1 (EPI_U), b2 (EPI_OUT); read as 0 at or past bias_len
  int bias_len;
  unsigned char* u;        // EPI_U: the u image, n_chunks tiles a row tile
  float* partials;         // EPI_PART: (k_splits, row_tiles * 64, n_chunks * 64)
  const void* x;           // EPI_OUT: x and out (B, T, C), gamma
  void* out;
  const float* gamma;
  int t_len, c_len, t_tiles;
};

struct Tile {
  int m, n, split, k0, k1;
};

// Work unit -> tile: the K split fastest, then the column tile, then the
// rows, so that the blocks running together share their A rows in L2.
__device__ __forceinline__ Tile tile_of(const GemmArgs& g, int unit) {
  Tile t;
  t.split = unit % g.k_splits;
  const int mn = unit / g.k_splits;
  t.n = mn % g.n_tiles;
  t.m = mn / g.n_tiles;
  t.k0 = t.split * g.k_per_split;
  t.k1 = min(g.k_blocks, t.k0 + g.k_per_split);
  return t;
}

// The epilogue of rows row0 + k EPI_WARPS (k < EPI_ROWS) of row tile rt,
// columns 64 j + 2 lane and + 1 of the output, their sums in acc[k]. Every
// row's loads go out before any row's arithmetic, so that the chains of
// several rows overlap.
template <int EPI, typename T>
__device__ __forceinline__ void epilogue(const GemmArgs& g, int split, int rt, int row0, int j,
                                         int lane, const float2 (&acc)[EPI_ROWS]) {
  const int col = j * KB + 2 * lane;
  if constexpr (EPI == EPI_U) {
    const float b0 = col < g.bias_len ? g.bias[col] : 0.f;
    const float b1 = col + 1 < g.bias_len ? g.bias[col + 1] : 0.f;
    __nv_bfloat162 u[EPI_ROWS];
#pragma unroll
    for (int k = 0; k < EPI_ROWS; ++k)
      u[k] = __floats2bfloat162_rn(gelu(__fadd_rn(acc[k].x, b0)), gelu(__fadd_rn(acc[k].y, b1)));
    unsigned char* tile = g.u + (static_cast<size_t>(rt) * g.n_chunks + j) * TILE_BYTES;
#pragma unroll
    for (int k = 0; k < EPI_ROWS; ++k)
      *reinterpret_cast<__nv_bfloat162*>(tile + swizzle((row0 + k * EPI_WARPS) * ROW + 4 * lane)) = u[k];
  } else if constexpr (EPI == EPI_PART) {
    const size_t rows = static_cast<size_t>(g.row_tiles) * TM;
#pragma unroll
    for (int k = 0; k < EPI_ROWS; ++k)
      *reinterpret_cast<float2*>(
          g.partials + (split * rows + static_cast<size_t>(rt) * TM + row0 + k * EPI_WARPS) *
                           (g.n_chunks * KB) + col) = acc[k];
  } else {
    const int item = rt / g.t_tiles;
    const int t0 = (rt % g.t_tiles) * TM + row0;
    const T* x = static_cast<const T*>(g.x) + (static_cast<size_t>(item) * g.t_len + t0) * g.c_len + col;
    T* out = static_cast<T*>(g.out) + (static_cast<size_t>(item) * g.t_len + t0) * g.c_len + col;
    const size_t step = static_cast<size_t>(EPI_WARPS) * g.c_len;  // from one row to the next
    if (g.c_len % 2 == 0 && col < g.c_len) {  // pairs, aligned
      const float2 gm = pair_at(g.gamma + col), bb = pair_at(g.bias + col);
      float2 xv[EPI_ROWS];
#pragma unroll
      for (int k = 0; k < EPI_ROWS; ++k)
        xv[k] = t0 + k * EPI_WARPS < g.t_len ? pair_at(x + k * step) : make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < EPI_ROWS; ++k)
        if (t0 + k * EPI_WARPS < g.t_len)
          store_pair(out + k * step, __fadd_rn(xv[k].x, __fmul_rn(gm.x, __fadd_rn(acc[k].x, bb.x))),
                     __fadd_rn(xv[k].y, __fmul_rn(gm.y, __fadd_rn(acc[k].y, bb.y))));
    } else {
#pragma unroll
      for (int k = 0; k < EPI_ROWS; ++k) {
        if (t0 + k * EPI_WARPS >= g.t_len) break;
        if (col < g.c_len)
          store(out + k * step, __fadd_rn(to_f32(x[k * step]),
                                          __fmul_rn(g.gamma[col], __fadd_rn(acc[k].x, g.bias[col]))));
        if (col + 1 < g.c_len)
          store(out + k * step + 1,
                __fadd_rn(to_f32(x[k * step + 1]),
                          __fmul_rn(g.gamma[col + 1], __fadd_rn(acc[k].y, g.bias[col + 1]))));
      }
    }
  }
}

// Kernel 2 (a product): blocks walk the units blockIdx.x, + gridDim.x, ...
template <int EPI, typename T>
__global__ void __launch_bounds__(GEMM_THREADS, 1) wide_gemm_kernel(const GemmArgs g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* acc_full = empty + STAGES;  // the staging tile holds a tile's sums
  uint64_t* acc_empty = acc_full + 1;   // the epilogue has read them
  float* staged = reinterpret_cast<float*>(smem + ACC_OFF);
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MMA_WGS * 4);
    }
    mbar_init(acc_full, MMA_WGS * 128);
    mbar_init(acc_empty, EPI_WGS * 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == PRODUCER_WG) {
    // -- producer: one thread streams each unit's A and B K blocks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x == PRODUCER_WG * 128) {
      int q = 0;
      for (int unit = blockIdx.x; unit < g.units; unit += gridDim.x) {
        const Tile tl = tile_of(g, unit);
        const int a_tiles = 2 * tl.m + 1 < g.row_tiles ? 2 : 1;
        const int b_chunks = min(BN / KB, g.n_chunks - tl.n * (BN / KB));
        const uint32_t bytes = (a_tiles + b_chunks) * TILE_BYTES;
        for (int k = tl.k0; k < tl.k1; ++k, ++q) {
          const int s = q % STAGES;
          if (q >= STAGES) mbar_wait(&empty[s], (q / STAGES - 1) & 1);
          mbar_expect_tx(&full[s], bytes);
          unsigned char* dst = smem + s * SLOT;
          for (int i = 0; i < a_tiles; ++i)
            bulk_load(dst + i * TILE_BYTES,
                      g.a + (static_cast<size_t>(2 * tl.m + i) * g.a_blocks + k) * TILE_BYTES,
                      TILE_BYTES, &full[s]);
          for (int j = 0; j < b_chunks; ++j)
            bulk_load(dst + (2 + j) * TILE_BYTES,
                      g.b + static_cast<size_t>(k) * g.b_kstride +
                          static_cast<size_t>(tl.n * (BN / KB) + j) * g.b_jstride,
                      TILE_BYTES, &full[s]);
        }
      }
    }
    return;
  }

  if (wg >= MMA_WGS) {
    // -- epilogue: warp e takes rows e + EPI_WARPS i, EPI_ROWS of them at a
    // time (rows r, r + EPI_WARPS, ...: one row tile), 64 columns a pass
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(EPI_REGS) : "memory");
    const int e = threadIdx.x / 32 - MMA_WGS * 4;
    int it = 0;
    for (int unit = blockIdx.x; unit < g.units; unit += gridDim.x, ++it) {
      const Tile tl = tile_of(g, unit);
      mbar_wait(acc_full, it & 1);
      for (int r0 = e; r0 < BM; r0 += EPI_WARPS * EPI_ROWS) {
        const int rt = 2 * tl.m + r0 / TM;  // the row tile
        if (rt >= g.row_tiles) break;
#pragma unroll
        for (int half = 0; half < BN / KB; ++half) {
          const int j = tl.n * (BN / KB) + half;  // the 64-column chunk
          if (j >= g.n_chunks) break;
          float2 acc[EPI_ROWS];
#pragma unroll
          for (int k = 0; k < EPI_ROWS; ++k)
            acc[k] = *reinterpret_cast<const float2*>(staged + (r0 + k * EPI_WARPS) * ACC_STRIDE +
                                                      half * KB + 2 * lane);
          epilogue<EPI, T>(g, tl.split, rt, r0 % TM, j, lane, acc);
        }
      }
      mbar_arrive(acc_empty);
    }
    return;
  }

  // -- MMA warpgroups: w takes rows 64 w .. 64 w + 63 of each tile --------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(MMA_REGS) : "memory");
  const int w = wg;
  const int wq = (threadIdx.x / 32) % 4;  // warp within the warpgroup: rows 16 wq .. 16 wq + 15
  const uint32_t ring = smem_u32(smem);
  float acc[BN / 2], part[BN / 2];
  int q = 0, it = 0;
  for (int unit = blockIdx.x; unit < g.units; unit += gridDim.x, ++it) {
    const Tile tl = tile_of(g, unit);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;  // 0 + the first K block's sum is that sum
    for (int k = tl.k0; k < tl.k1; ++k, ++q) {
      const int s = q % STAGES;
      mbar_wait(&full[s], (q / STAGES) & 1);
      wgmma_fence();
      const uint32_t a_base = ring + s * SLOT + w * TILE_BYTES;
      const uint32_t b_base = ring + s * SLOT + 2 * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        wgmma_bf16<BN>(part, smem_desc(a_base + kk * 32), smem_desc(b_base + kk * 32), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    if (it > 0) mbar_wait(acc_empty, (it - 1) & 1);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = w * TM + 16 * wq + lane / 4 + 8 * h;
        *reinterpret_cast<float2*>(staged + r * ACC_STRIDE + 8 * jj + 2 * (lane % 4)) =
            make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
      }
    mbar_arrive(acc_full);
  }
}

// Kernel 3 (product 1 split): u = gelu(sum of the splits' partial sums, in
// split order, + b1), bf16 into u's image; a thread per column pair.
__global__ void __launch_bounds__(256)
wide_split_gelu_kernel(const float* __restrict__ partials, unsigned char* __restrict__ u_img,
                       const float* __restrict__ b1, int inter, int k_splits, int row_tiles,
                       int n_chunks) {
  const int width = n_chunks * KB;
  const size_t plane = static_cast<size_t>(row_tiles) * TM * width;
  for (size_t p = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; p < plane / 2;
       p += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = 2 * p;
    const int col = static_cast<int>(e % width);
    const size_t r = e / width;
    float2 s = *reinterpret_cast<const float2*>(partials + e);
    for (int k = 1; k < k_splits; ++k) {
      const float2 q = *reinterpret_cast<const float2*>(partials + k * plane + e);
      s = make_float2(__fadd_rn(s.x, q.x), __fadd_rn(s.y, q.y));
    }
    const float b0 = col < inter ? b1[col] : 0.f;
    const float b1v = col + 1 < inter ? b1[col + 1] : 0.f;
    const uint32_t off = (r % TM) * ROW + (col % KB) * 2;
    *reinterpret_cast<__nv_bfloat162*>(u_img + ((r / TM) * n_chunks + col / KB) * TILE_BYTES +
                                       swizzle(off)) =
        __floats2bfloat162_rn(gelu(__fadd_rn(s.x, b0)), gelu(__fadd_rn(s.y, b1v)));
  }
}

struct Call {
  const void *x, *dw, *dwb, *lnw, *lnb, *packed, *b1, *b2, *gamma;
  void *out, *h_img, *u_img, *partials;
  int batch, t_len, c_len, inter, k_splits, k_per_split;
};

template <int EPI, typename T>
cudaError_t launch_gemm(const GemmArgs& g, int sms, cudaStream_t stream) {
  auto kernel = wide_gemm_kernel<EPI, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<g.units < sms ? g.units : sms, GEMM_THREADS, GEMM_SMEM, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Call& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int t_tiles = (a.t_len + TM - 1) / TM;
  const int c_pad = (a.c_len + KB - 1) / KB * KB;
  const int i_pad = (a.inter + KB - 1) / KB * KB;
  const int row_tiles = a.batch * t_tiles;
  const size_t image = static_cast<size_t>(c_pad) * KB * 2;  // one chunk image of the pack
  const unsigned char* packed = static_cast<const unsigned char*>(a.packed);

  // 1. LayerNorm -> h
  const int frames = ln_frames(c_pad);
  const int ln_smem = ln_smem_bytes(c_pad);
  auto ln = wide_layernorm_kernel<T>;
  err = cudaFuncSetAttribute(ln, cudaFuncAttributeMaxDynamicSharedMemorySize, ln_smem);
  if (err != cudaSuccess) return err;
  ln<<<dim3((t_tiles * TM + frames - 1) / frames, a.batch), LN_THREADS, ln_smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<unsigned char*>(a.h_img),
      static_cast<const float*>(a.dw), static_cast<const float*>(a.dwb),
      static_cast<const float*>(a.lnw), static_cast<const float*>(a.lnb), a.t_len, a.c_len, c_pad,
      t_tiles, frames);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // 2. product 1 -> u (or partial sums, then u)
  GemmArgs g{};
  g.a = static_cast<const unsigned char*>(a.h_img);
  g.a_blocks = c_pad / KB;
  g.b = packed;
  g.b_kstride = TILE_BYTES;
  g.b_jstride = 2 * image;
  g.row_tiles = row_tiles;
  g.n_chunks = i_pad / KB;
  g.n_tiles = (i_pad + BN - 1) / BN;
  g.k_blocks = c_pad / KB;
  g.k_splits = a.k_splits;
  g.k_per_split = a.k_per_split;
  g.units = (row_tiles + 1) / 2 * g.n_tiles * g.k_splits;
  g.bias = static_cast<const float*>(a.b1);
  g.bias_len = a.inter;
  g.u = static_cast<unsigned char*>(a.u_img);
  g.partials = static_cast<float*>(a.partials);
  if (a.k_splits > 1) {
    err = launch_gemm<EPI_PART, float>(g, sms, stream);
    if (err != cudaSuccess) return err;
    const size_t pairs = static_cast<size_t>(row_tiles) * TM * i_pad / 2;
    const size_t blocks = (pairs + 255) / 256;
    const int grid = static_cast<int>(blocks < static_cast<size_t>(sms) * 8 ? blocks : sms * 8);
    wide_split_gelu_kernel<<<grid, 256, 0, stream>>>(
        static_cast<const float*>(a.partials), static_cast<unsigned char*>(a.u_img),
        static_cast<const float*>(a.b1), a.inter, a.k_splits, row_tiles, i_pad / KB);
    err = cudaGetLastError();
  } else {
    err = launch_gemm<EPI_U, float>(g, sms, stream);
  }
  if (err != cudaSuccess) return err;

  // 3. product 2 -> out
  g.a = static_cast<const unsigned char*>(a.u_img);
  g.a_blocks = i_pad / KB;
  g.b = packed + image;
  g.b_kstride = 2 * image;
  g.b_jstride = TILE_BYTES;
  g.n_chunks = c_pad / KB;
  g.n_tiles = (c_pad + BN - 1) / BN;
  g.k_blocks = i_pad / KB;
  g.k_splits = 1;
  g.k_per_split = g.k_blocks;
  g.units = (row_tiles + 1) / 2 * g.n_tiles;
  g.bias = static_cast<const float*>(a.b2);
  g.bias_len = a.c_len;
  g.x = a.x;
  g.out = a.out;
  g.gamma = static_cast<const float*>(a.gamma);
  g.t_len = a.t_len;
  g.c_len = a.c_len;
  g.t_tiles = t_tiles;
  return launch_gemm<EPI_OUT, T>(g, sms, stream);
}

}  // namespace

// Returns the launches' cudaError_t (0 on success). x_bf16 selects the type
// of x and out: 0 for float32, 1 for bfloat16. `packed` holds the weights as
// ops/fused_convnext.py::kernel_weights lays them out, padded to C' and I'.
// Scratch, sized by ops/fused_convnext.py::wide_plan: `h_img` B x ceil(T /
// 64) x 64 x C' bf16, `u_img` the same with I', and where k_splits > 1
// `partials`, k_splits x B x ceil(T / 64) x 64 x I' float32 (else unused).
// Product 1's C' / 64 K blocks go in k_splits runs of k_per_split, none
// empty.
extern "C" int convnext_block_wide_launch(const void* x, void* out, const void* dw,
                                          const void* dwb, const void* lnw, const void* lnb,
                                          const void* packed, const void* b1, const void* b2,
                                          const void* gamma, void* h_img, void* u_img,
                                          void* partials, int batch, int t_len, int channels,
                                          int inter, int k_splits, int k_per_split, int x_bf16,
                                          void* stream) {
  const int k_blocks = (channels + KB - 1) / KB;
  if (batch < 1 || batch > 65535 || t_len < 1 || channels < 1 || channels > MAX_CHANNELS ||
      inter < 1 || k_splits < 1 || k_per_split < 1 || (k_splits - 1) * k_per_split >= k_blocks ||
      k_splits * k_per_split < k_blocks || (k_splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  const Call a{x, dw, dwb, lnw, lnb, packed, b1, b2, gamma, out, h_img, u_img, partials,
               batch, t_len, channels, inter, k_splits, k_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// Dynamic shared memory of a block of the LayerNorm kernel (kernel 0) or of
// the product kernel (kernel 1) at `channels`.
extern "C" int convnext_block_wide_smem_bytes(int kernel, int channels) {
  if (channels < 1 || channels > MAX_CHANNELS) return 0;
  return kernel == 0 ? ln_smem_bytes((channels + KB - 1) / KB * KB) : GEMM_SMEM;
}
