// Latency probe for the dependent chains of the MAS kernels (B3, B4), built
// and run by chip_smoke.py phases 6 and 9: one warp times, with clock64,
// (1) the forward's chain from one frame to the next, a __shfl_up_sync of
// the lane's last cell, a select at lane 0, one fmaxf and one __fadd_rn
// (csrc/mas_forward.cuh), and (2) the backtrace's chain from one frame to
// the next, a shift of the frame's window word by the path's offset and a
// subtract (csrc/mas_wavefront.cu, mas_extract.cu; the window words come
// from shuffles off the chain). fl x (1 + 2) cycles at the card's SM clock
// is the least time a kernel can take for an item of fl frames, whatever
// else it does: the chain floor beside the bytes bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(32)
mas_chain_kernel(const float* __restrict__ in, float* __restrict__ out,
                 long long* __restrict__ cycles, int n) {
  const int lane = threadIdx.x;
  float q = in[lane];
  const float v = in[32 + lane];
  const unsigned word = __float_as_uint(in[64 + lane]);
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float up = __shfl_up_sync(FULL, q, 1);
      q = __fadd_rn(fmaxf(q, lane == 0 ? -1e9f : up), v);
    }
  }
  const long long t1 = clock64();
  unsigned words[UNROLL];  // the window words of UNROLL frames, off the chain
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) words[u] = __shfl_sync(FULL, word, u);
  int d = 31;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) d -= (words[u] >> d) & 1u;
    d += 31 - (d & 31);  // keep the shift in range between rounds
  }
  const long long t2 = clock64();
  out[lane] = q + static_cast<float>(d);
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = t2 - t1;
  }
}

}  // namespace

// in: 96 floats (q, v and the decision words' bits); out: 32 floats; cycles:
// 2 int64, the two chains' clock64 spans over n * 8 steps each.
extern "C" int mas_chain_launch(const void* in, void* out, void* cycles, int n, void* stream) {
  mas_chain_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), static_cast<long long*>(cycles), n);
  return cudaGetLastError();
}
