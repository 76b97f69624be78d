// Monotonic alignment search (MAS) for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces optispeech_tpu/ops/pallas_mas_wavefront.py::viterbi_decode_wavefront,
// the Pallas TPU kernel of batched MAS. The forward DP is mas_forward.cuh's
// (recurrence, tie-breaking and design there); this kernel then backtraces
// from token tl-1 at frame fl-1: A[j-1] = A[j] - dec[j][A[j]] unless
// A[j] == 0, and durations[i] = #{j < fl : A[j] == i}. The durations are
// bit-equal to optispeech_tpu/ops/mas.py::viterbi_decode.
//
// Bound on this card: bytes. The kernel must read lp's valid region once,
// sum_b fl*tl*4 bytes (at most B*F*T*4: 75.5 MB at B=128, F=768, T=192,
// 0.023 ms at 3.35 TB/s); it does two operations per cell. A second floor
// is the dependent chain: fl steps in sequence per item, forward and back.
// It also writes and re-reads the decision bits, B*F*T/8 bytes (2.4 MB at
// that shape), which the TPU kernel streams to device memory as int8.
//
// Design (simple first, see PERF.md for its time against the bound): one
// warp per item, so the grid is the batch, running mas_forward.cuh's
// forward; the backtrace runs in the same warp: every 32 frames the lanes
// load the two decision words the path can touch (the path moves at most
// one token a frame), then the warp walks the 32 frames with shuffles and
// lane 0 writes each token's run length as its duration.
// What bounds it now (PERF.md): one warp per SM issues every instruction of
// a frame in order with nothing to hide its latencies, about 0.4 us a frame
// at T = 192. Not done yet: fewer instructions a frame (16-byte copies, no
// work on chunks past the text length without branching), and work for the
// SMs that a batch under 132 leaves idle.

#include <cstdint>
#include <cuda_runtime.h>

#include "mas_forward.cuh"

namespace {

using mas::FULL;

template <int C>
__global__ void __launch_bounds__(32)
mas_wavefront_kernel(const float* __restrict__ lp, const int* __restrict__ text_lengths,
                     const int* __restrict__ feats_lengths, float* __restrict__ durations,
                     uint32_t* __restrict__ dec, int n_feats, int n_text) {
  __shared__ float ring[mas::ring_frames<C>()][32 * C];
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int tl = text_lengths[b], fl = feats_lengths[b];
  const float* lpb = lp + static_cast<size_t>(b) * n_feats * n_text;
  uint32_t* decb = dec + static_cast<size_t>(b) * n_feats * C;
  float* out = durations + static_cast<size_t>(b) * n_text;

  mas::forward<C>(lpb, decb, tl, fl, n_text, ring);

  // ---- backtrace from frame fl-1 (pinned to token tl-1) down to 0 --------
  for (int i = lane; i < n_text; i += 32) out[i] = 0.f;
  __syncwarp();  // orders lane 0's decision words and the zeros before the reads below
  int a = tl - 1;
  int run = 0;
  for (int jh = fl - 1; jh >= 1; jh -= 32) {
    const int w = a >> 5;
    const int jj = jh - lane;  // lane k holds frame jh - k
    uint32_t hi = 0, lo = 0;
    if (jj >= 1) {
      hi = decb[static_cast<size_t>(jj) * C + w];
      if (w > 0) lo = decb[static_cast<size_t>(jj) * C + w - 1];
    }
    const int n = jh < 32 ? jh : 32;
    for (int k = 0; k < n; ++k) {
      const uint32_t h = __shfl_sync(FULL, hi, k);
      const uint32_t l = __shfl_sync(FULL, lo, k);
      ++run;  // frame jh - k sits at token a
      const uint32_t word = ((a >> 5) == w) ? h : l;
      if (a > 0 && ((word >> (a & 31)) & 1u)) {
        if (lane == 0) out[a] = static_cast<float>(run);
        run = 0;
        a -= 1;
      }
    }
  }
  if (lane == 0) out[a] = static_cast<float>(run + 1);  // frame 0
}

template <int C>
cudaError_t launch(const float* lp, const int* tl, const int* fl, float* ds, uint32_t* dec,
                   int batch, int n_feats, int n_text, cudaStream_t stream) {
  mas_wavefront_kernel<C><<<batch, 32, 0, stream>>>(lp, tl, fl, ds, dec, n_feats, n_text);
  return cudaGetLastError();
}

}  // namespace

// lp (B, F, T) f32; text_lengths, feats_lengths (B,) int32 in [1, T] and
// [1, F]; durations (B, T) f32 out; dec a (B, F, tokens_per_lane) uint32
// scratch, tokens_per_lane a power of two with 32 * tokens_per_lane >= T.
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
  uint32_t* d = static_cast<uint32_t*>(dec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tokens_per_lane) {
    case 1: return launch<1>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    case 2: return launch<2>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    case 4: return launch<4>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    case 8: return launch<8>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    case 16: return launch<16>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    case 32: return launch<32>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    case 64: return launch<64>(l, tl, fl, ds, d, batch, n_feats, n_text, s);
    default: return cudaErrorInvalidValue;
  }
}
