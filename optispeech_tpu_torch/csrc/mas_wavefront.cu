// Monotonic alignment search (MAS) for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_mas_wavefront.py::viterbi_decode_wavefront,
// the Pallas TPU kernel of batched MAS. The forward DP is mas_forward.cuh's
// (recurrence, tie-breaking, layout and loads there); this kernel then
// backtraces from token tl-1 at frame fl-1: A[j-1] = A[j] - dec[j][A[j]]
// unless A[j] == 0, and durations[i] = #{j < fl : A[j] == i}. The durations
// are bit-equal to optispeech_tpu/ops/mas.py::viterbi_decode.
//
// Bound on this card: bytes. The kernel must read lp's valid region once,
// sum_b fl*tl*4 bytes (42.6 MB at B=128, F=768, T=192 with tl in [96, 192]
// and fl in [384, 768]: 0.0127 ms at 3.35 TB/s); it does two operations per
// cell. The floor that binds is the dependent chain: fl frames in sequence
// per item, forward and back, each at least a shuffle and a max + add.
//
// Design: one warp per item, so the grid is the batch (an item's frames are
// a serial chain; B = 128 fills 128 of the 132 SMs), running
// mas_forward.cuh's forward. The backtrace runs in the same warp, a window
// of NW <= 32 frames at a time: the lanes hold the window's decision rows
// (one coalesced load per row, issued a window ahead) and gather, lane s
// for the window's s-th frame from the top, its decisions at the 32 tokens
// the path can reach in the window (`mas::window_word`); the walk's chain is
// then a shift and a subtract a frame, lane s keeps its frame's token, and
// each lane adds one to its token's duration (an atomic add, off the chain).

#include <cstdint>
#include <cuda_runtime.h>

#include "mas_forward.cuh"

namespace {

using mas::FULL;

template <int K>
__global__ void __launch_bounds__(32)
mas_wavefront_kernel(const float* __restrict__ lp, const int* __restrict__ text_lengths,
                     const int* __restrict__ feats_lengths, float* __restrict__ durations,
                     typename mas::Layout<K>::Word* __restrict__ dec, int batch, int n_feats,
                     int n_text) {
  using L = mas::Layout<K>;
  using Word = typename L::Word;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int tl = text_lengths[b], fl = feats_lengths[b];
  const float* lpb = lp + static_cast<size_t>(b) * n_feats * n_text;
  const float* lp_end = lp + static_cast<size_t>(batch) * n_feats * n_text;
  Word* decb = dec + static_cast<size_t>(b) * mas::decision_rows<K>(n_feats) * 32;
  float* out = durations + static_cast<size_t>(b) * n_text;

  mas::forward<K>(lpb, lp_end, decb, tl, fl, n_text, mas::ring_of<K>(smem),
                  mas::barriers_of<K>(smem));

  // ---- backtrace from frame fl-1 (pinned to token tl-1) down to 0 --------
  for (int i = lane; i < n_text; i += 32) out[i] = 0.f;
  __syncwarp();  // orders the decision rows and the zeros before the reads below
  int a = tl - 1;  // the path's token at the next frame to walk (warp-uniform)
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
        const int j = w * L::NW + r;
        if (j >= fl) continue;
        if (lane == L::NW - 1 - r) tok = a;
        if (j > 0) a -= mas::decision_at<K>(rows[r], a);
      }
    }
    if (tok >= 0) atomicAdd(out + tok, 1.f);  // durations[i] = frames at token i
  }
}

template <int K>
cudaError_t launch(const float* lp, const int* tl, const int* fl, float* ds, void* dec, int batch,
                   int n_feats, int n_text, cudaStream_t stream) {
  return mas::launch_warp_per_item<K>(mas_wavefront_kernel<K>, batch, stream, lp, tl, fl, ds,
                                      static_cast<typename mas::Layout<K>::Word*>(dec), batch,
                                      n_feats, n_text);
}

}  // namespace

// lp (B, F, T) f32, 16-byte aligned; text_lengths, feats_lengths (B,) int32
// in [1, T] and [1, F]; durations (B, T) f32 out; dec scratch of
// B x ceil(F / FW) x 32 words (ops/mas.py::decision_bytes), tokens_per_lane
// one of ops/mas.py::TOKENS_PER_LANE with 32 * tokens_per_lane >= T.
extern "C" int mas_wavefront_launch(const void* lp, const void* text_lengths,
                                    const void* feats_lengths, void* durations, void* dec,
                                    int batch, int n_feats, int n_text, int tokens_per_lane,
                                    void* stream) {
  if (batch < 1 || n_feats < 1 || n_text < 1 || 32L * tokens_per_lane < n_text)
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lp);
  const int* tl = static_cast<const int*>(text_lengths);
  const int* fl = static_cast<const int*>(feats_lengths);
  float* ds = static_cast<float*>(durations);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tokens_per_lane) {
#define MAS_CASE(K) \
  case K: return launch<K>(l, tl, fl, ds, dec, batch, n_feats, n_text, s);
    MAS_TOKENS_PER_LANE(MAS_CASE)
#undef MAS_CASE
    default: return cudaErrorInvalidValue;
  }
}
