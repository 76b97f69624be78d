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
// outputs; it does two operations per cell. The floor that binds is the
// dependent chain: fl frames in sequence per item, forward and back.
//
// Design: the TPU kernel keeps the whole (F, T) f32 Q table in VMEM (590 KB
// at 768 x 192, more than a block's 227 KB of shared memory) and backtraces
// with one-hot reductions. Here the backtrace needs only the take-left bit
// Q[j-1][a-1] >= Q[j-1][a], so the forward (mas_forward.cuh, shared with
// mas_wavefront.cu: one warp per item, contiguous tokens per lane, one
// shuffle and one decision word a frame, log-probs staged by bulk copies)
// records one bit per cell instead of Q. The backtrace walks each window of
// NW <= 32 frames once: the lanes gather each frame's decisions at the 32
// tokens the path can reach in the window (`mas::window_word`), the walk's
// chain is a shift and a subtract a frame, and lane k keeps the token of
// the window's k-th frame from the top. After the walk each lane loads its
// frame's log-prob at that token (NW loads in flight); the walk two windows
// down folds them in (by then they have arrived), frame by frame from the
// top, with shuffles: a token's
// run ends where the token changes, and lane 0 writes its length and its
// sum. The fold is a second chain beside the walk's, not a second walk.
// Reads beyond the valid region: none; one extra read of a cell per valid
// frame.

#include <cstdint>
#include <cuda_runtime.h>

#include "mas_forward.cuh"

namespace {

using mas::FULL;

template <int K>
__global__ void __launch_bounds__(32)
mas_extract_kernel(const float* __restrict__ lp, const int* __restrict__ text_lengths,
                   const int* __restrict__ feats_lengths, float* __restrict__ durations,
                   float* __restrict__ binsum, typename mas::Layout<K>::Word* __restrict__ dec,
                   int batch, int n_feats, int n_text) {
  using L = mas::Layout<K>;
  using Word = typename L::Word;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int tl = text_lengths[b], fl = feats_lengths[b];
  const float* lpb = lp + static_cast<size_t>(b) * n_feats * n_text;
  const float* lp_end = lp + static_cast<size_t>(batch) * n_feats * n_text;
  Word* decb = dec + static_cast<size_t>(b) * mas::decision_rows<K>(n_feats) * 32;
  float* ds = durations + static_cast<size_t>(b) * n_text;
  float* bs = binsum + static_cast<size_t>(b) * n_text;

  mas::forward<K>(lpb, lp_end, decb, tl, fl, n_text, mas::ring_of<K>(smem),
                  mas::barriers_of<K>(smem));

  // ---- backtrace from frame fl-1 (pinned to token tl-1) down to frame 0 --
  for (int i = lane; i < n_text; i += 32) {
    ds[i] = 0.f;
    bs[i] = 0.f;
  }
  __syncwarp();  // orders the decision rows and the zeros before the reads below
  int a = tl - 1;     // the walk's token at the next frame to walk (warp-uniform)
  int cur = tl - 1;   // the fold's open run: its token,
  int run = 0;        // its frames so far
  float acc = 0.f;    // and its log-probs so far, from the highest frame down
  // frame s-th from the top of a window: its token (-1 past fl) and log-prob
  // at lane s, folded two windows later, so that the log-prob's load has a
  // window's walk to arrive in: `older` the window above `newer`
  int older_tok = -1, newer_tok = -1;
  float older_v = 0.f, newer_v = 0.f;
  // the older window's s-th frame from its top, with selects rather than
  // branches (a frame past fl has token -1 and leaves the run as it is)
  auto fold = [&](int s) {
    const int tok = __shfl_sync(FULL, older_tok, s);
    const float v = __shfl_sync(FULL, older_v, s);
    const bool valid = tok >= 0;
    const bool ends = valid && tok != cur;  // the open run ends above this frame
    if (ends && lane == 0) {
      ds[cur] = static_cast<float>(run);
      bs[cur] = acc;
    }
    const float sum = __fadd_rn(ends ? 0.f : acc, v);
    acc = valid ? sum : acc;
    run = ends ? 1 : run + valid;
    cur = ends ? tok : cur;
  };
  const int top = (fl - 1) / L::NW;
  Word next[L::D];
  mas::load_window<K>(decb, top, fl, next);
#pragma unroll 1
  for (int w = top; w >= 0; --w) {
    Word rows[L::D];
#pragma unroll
    for (int r = 0; r < L::D; ++r) rows[r] = next[r];
    if (w > 0) mas::load_window<K>(decb, w - 1, fl, next);
    int tok = -1;  // lane s: the token of the window's s-th frame from its top
    if constexpr (K <= 32) {
      const int base = a > 31 ? a - 31 : 0;  // the path stays in base .. a here
      const uint32_t window = mas::window_word<K>(rows, base);
      int d = a - base;
#pragma unroll
      for (int s = 0; s < L::NW; ++s) {
        fold(s);
        const int j = w * L::NW + L::NW - 1 - s;
        const uint32_t ws = __shfl_sync(FULL, window, s);
        if (j >= fl) continue;
        if (lane == s) tok = base + d;
        if (j > 0) d -= (ws >> d) & 1u;
      }
      a = base + d;
    } else {
#pragma unroll
      for (int r = L::D - 1; r >= 0; --r) {  // one frame a row
        const int s = L::NW - 1 - r;
        fold(s);
        const int j = w * L::NW + r;
        if (j >= fl) continue;
        if (lane == s) tok = a;
        if (j > 0) a -= mas::decision_at<K>(rows[r], a);
      }
    }
    older_tok = newer_tok;
    older_v = newer_v;
    newer_tok = tok;
    newer_v = tok >= 0 ? lpb[static_cast<size_t>(w * L::NW + L::NW - 1 - lane) * n_text + tok] : 0.f;
  }
#pragma unroll
  for (int s = 0; s < L::NW; ++s) fold(s);  // the last two windows' frames
  older_tok = newer_tok;
  older_v = newer_v;
#pragma unroll
  for (int s = 0; s < L::NW; ++s) fold(s);
  if (lane == 0) {
    ds[cur] = static_cast<float>(run);
    bs[cur] = acc;
  }
}

template <int K>
cudaError_t launch(const float* lp, const int* tl, const int* fl, float* ds, float* bs, void* dec,
                   int batch, int n_feats, int n_text, cudaStream_t stream) {
  return mas::launch_warp_per_item<K>(mas_extract_kernel<K>, batch, stream, lp, tl, fl, ds, bs,
                                      static_cast<typename mas::Layout<K>::Word*>(dec), batch,
                                      n_feats, n_text);
}

}  // namespace

// lp (B, F, T) f32, 16-byte aligned; text_lengths, feats_lengths (B,) int32
// in [1, T] and [1, F]; durations and binsum (B, T) f32 out; dec scratch of
// B x ceil(F / FW) x 32 words (ops/mas.py::decision_bytes), tokens_per_lane
// one of ops/mas.py::TOKENS_PER_LANE with 32 * tokens_per_lane >= T.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tokens_per_lane) {
#define MAS_CASE(K) \
  case K: return launch<K>(l, tl, fl, ds, bs, dec, batch, n_feats, n_text, s);
    MAS_TOKENS_PER_LANE(MAS_CASE)
#undef MAS_CASE
    default: return cudaErrorInvalidValue;
  }
}
