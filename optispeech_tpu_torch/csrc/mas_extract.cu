// Monotonic alignment search with the bin-loss numerator, no gradient, for
// Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_mas.py::viterbi_decode_pallas, the
// Pallas TPU kernel of per-item MAS for extract-durations workloads. For
// each item it gives, on the log-probs lp (B, F, T) f32:
//   durations[i] = #{j < fl : A[j] == i}
//   binsum[i]    = sum of lp[j][i] over the frames j < fl with A[j] == i,
//                  added from the last valid frame down, as the TPU kernel
//                  adds them, so the sums match its order bit for bit;
// where A is the path of mas_forward.cuh's DP, backtraced from token tl-1
// at frame fl-1 with A[j-1] = A[j] - dec[j][A[j]] unless A[j] == 0. The
// caller turns binsum into the bin loss (mean over items of
// -sum_i binsum[i] / fl).
//
// Bound on this card: bytes. The kernel must read lp's valid region once,
// sum_b fl*tl*4 bytes (42.6 MB at B=128, F=768, T=192 with tl in [96, 192]
// and fl in [384, 768]: 0.0127 ms at 3.35 TB/s), and write two (B, T) f32
// outputs; it does two operations per cell. A second floor is the dependent
// chain: fl steps in sequence per item, forward and back.
//
// Design (simple first, see PERF.md for its time against the bound): the
// TPU kernel keeps the whole (F, T) f32 Q table in VMEM (590 KB at
// 768 x 192, more than a block's 227 KB of shared memory) and backtraces
// with one-hot reductions. Here the backtrace only needs the take-left bit
// Q[j-1][a-1] >= Q[j-1][a], so the forward (mas_forward.cuh, shared with
// mas_wavefront.cu: one warp per item, Q row in registers, ballot words)
// records one bit per cell in a (B, F, C) scratch instead of Q. The
// backtrace runs in the same warp, 32 frames at a time: the lanes load the
// two decision words the path can touch (it moves at most one token a
// frame), the warp walks the frames with shuffles and lane k keeps the token
// of frame jh - k; then each lane reads its frame's log-prob at that token
// (32 loads in flight, not one per frame), and the warp adds them in frame
// order with shuffles, lane 0 writing each token's run length and sum when
// the run ends. Reads beyond the valid region: one cell per valid frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "mas_forward.cuh"

namespace {

using mas::FULL;

template <int C>
__global__ void __launch_bounds__(32)
mas_extract_kernel(const float* __restrict__ lp, const int* __restrict__ text_lengths,
                   const int* __restrict__ feats_lengths, float* __restrict__ durations,
                   float* __restrict__ binsum, uint32_t* __restrict__ dec, int n_feats,
                   int n_text) {
  __shared__ float ring[mas::ring_frames<C>()][32 * C];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int tl = text_lengths[b], fl = feats_lengths[b];
  const float* lpb = lp + static_cast<size_t>(b) * n_feats * n_text;
  uint32_t* decb = dec + static_cast<size_t>(b) * n_feats * C;
  float* ds = durations + static_cast<size_t>(b) * n_text;
  float* bs = binsum + static_cast<size_t>(b) * n_text;

  mas::forward<C>(lpb, decb, tl, fl, n_text, ring);

  // ---- backtrace from frame fl-1 (pinned to token tl-1) down to frame 0 --
  for (int i = lane; i < n_text; i += 32) {
    ds[i] = 0.f;
    bs[i] = 0.f;
  }
  __syncwarp();  // orders lane 0's decision words and the zeros before the reads below
  int a = tl - 1;    // token of the next frame to walk (warp-uniform)
  int cur = tl - 1;  // token of the open run
  int run = 0;       // its frames so far
  float acc = 0.f;   // its log-probs so far, from the highest frame down
  for (int jh = fl - 1; jh >= 0; jh -= 32) {
    const int n = jh < 31 ? jh + 1 : 32;  // frames jh .. jh - n + 1
    const int w = a >> 5;
    const int jj = jh - lane;  // lane k holds frame jh - k
    uint32_t hi = 0, lo = 0;
    if (lane < n && jj >= 1) {
      hi = decb[static_cast<size_t>(jj) * C + w];
      if (w > 0) lo = decb[static_cast<size_t>(jj) * C + w - 1];
    }
    int tok = 0;
    for (int k = 0; k < n; ++k) {
      const uint32_t h = __shfl_sync(FULL, hi, k);
      const uint32_t l = __shfl_sync(FULL, lo, k);
      if (lane == k) tok = a;  // frame jh - k sits at token a
      const uint32_t word = ((a >> 5) == w) ? h : l;
      if (a > 0 && ((word >> (a & 31)) & 1u)) a -= 1;  // frame 0's word is 0
    }
    const float v = lane < n ? lpb[static_cast<size_t>(jj) * n_text + tok] : 0.f;
    for (int k = 0; k < n; ++k) {
      const int t = __shfl_sync(FULL, tok, k);
      const float x = __shfl_sync(FULL, v, k);
      if (t != cur) {
        if (lane == 0) {
          ds[cur] = static_cast<float>(run);
          bs[cur] = acc;
        }
        cur = t;
        run = 0;
        acc = 0.f;
      }
      ++run;
      acc = __fadd_rn(acc, x);
    }
  }
  if (lane == 0) {
    ds[cur] = static_cast<float>(run);
    bs[cur] = acc;
  }
}

template <int C>
cudaError_t launch(const float* lp, const int* tl, const int* fl, float* ds, float* bs,
                   uint32_t* dec, int batch, int n_feats, int n_text, cudaStream_t stream) {
  mas_extract_kernel<C><<<batch, 32, 0, stream>>>(lp, tl, fl, ds, bs, dec, n_feats, n_text);
  return cudaGetLastError();
}

}  // namespace

// lp (B, F, T) f32; text_lengths, feats_lengths (B,) int32 in [1, T] and
// [1, F]; durations and binsum (B, T) f32 out; dec a (B, F, tokens_per_lane)
// uint32 scratch, tokens_per_lane a power of two with 32 * tokens_per_lane >= T.
extern "C" int mas_extract_launch(const void* lp, const void* text_lengths,
                                  const void* feats_lengths, void* durations, void* binsum,
                                  void* dec, int batch, int n_feats, int n_text,
                                  int tokens_per_lane, void* stream) {
  if (batch < 1 || n_feats < 1 || n_text < 1 || 32L * tokens_per_lane < n_text)
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lp);
  const int* tl = static_cast<const int*>(text_lengths);
  const int* fl = static_cast<const int*>(feats_lengths);
  float* ds = static_cast<float*>(durations);
  float* bs = static_cast<float*>(binsum);
  uint32_t* d = static_cast<uint32_t*>(dec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tokens_per_lane) {
    case 1: return launch<1>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    case 2: return launch<2>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    case 4: return launch<4>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    case 8: return launch<8>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    case 16: return launch<16>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    case 32: return launch<32>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    case 64: return launch<64>(l, tl, fl, ds, bs, d, batch, n_feats, n_text, s);
    default: return cudaErrorInvalidValue;
  }
}
