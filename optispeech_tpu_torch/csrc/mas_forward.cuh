// Forward pass of monotonic alignment search, one warp per item, shared by
// the two MAS kernels (mas_wavefront.cu, mas_extract.cu).
//
// For item b, with tl = text length and fl = frame length (both >= 1,
// clamped by the caller), on the log-probs lp (F, T) f32 of that item:
//
//   Q[0][i] = lp[0][0] if i == 0 else BIG_NEG
//   Q[j][i] = max(Q[j-1][i], Q[j-1][i-1]) + lp[j][i]        (Q[j-1][-1] = BIG_NEG)
//   dec[j][i] = Q[j-1][i-1] >= Q[j-1][i]                     (take-left, ties left)
//
// with one max and one add per cell in f32 (no FMA, no reassociation), the
// recurrence and tie-breaking of optispeech_tpu/ops/mas.py::viterbi_decode.
// Only the valid region (j < fl, i < tl) is read: Q at i < tl depends on
// lp[j'][i'] with i' <= i only, and a backtrace from token tl-1 never
// leaves it, so the padded cells that the JAX function fills with BIG_NEG
// cannot change the result.
//
// Design:
// - lane l holds tokens l + 32c for c < C (C = tokens per lane, a template
//   argument), so each 32-token chunk of a frame is one coalesced load and
//   its decisions are one __ballot_sync word;
// - the Q row stays in registers: Q[j-1][i-1] comes from the lane below
//   (__shfl_up_sync), or for lane 0 from lane 31's previous chunk. There is
//   no block barrier in the frame loop: a barrier would also wait for the
//   prefetched loads still in flight;
// - the log-probs are prefetched PF frames ahead with cp.async into a ring
//   in shared memory, each lane copying the cells it reads (a ring in
//   registers measured slower: the loads share the warp's few scoreboards,
//   so a frame waits for loads issued long after its own);
// - lane 0 writes the decision words to a (F, C) scratch in device memory,
//   row j for 1 <= j < fl.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mas {

constexpr float BIG_NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// one 4-byte async copy global -> shared; zero-fills the cell when !valid
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// frames in flight in the shared-memory ring; the ring stays <= 32 KB
template <int C>
__host__ __device__ constexpr int ring_frames() { return (256 / C) < 16 ? 256 / C : 16; }

// The forward DP of one item by one warp (blockDim.x == 32): lpb is the
// item's (F, n_text) log-probs, decb its (F, C) decision words, ring a
// __shared__ float[ring_frames<C>()][32 * C] of the calling kernel.
template <int C>
__device__ __forceinline__ void forward(const float* __restrict__ lpb,
                                        uint32_t* __restrict__ decb, int tl, int fl,
                                        int n_text, float (*ring)[32 * C]) {
  constexpr int PF = ring_frames<C>();
  const int lane = threadIdx.x;

  // frame j's cells of this lane into ring slot j % PF (zeros outside the
  // valid region); one commit group per frame, empty past the last one
  auto fetch = [&](int j) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = lane + 32 * c;
      const bool valid = j < fl && i < tl;  // zero-filled cells cost no read
      copy_async(&ring[j % PF][i], valid ? lpb + static_cast<size_t>(j) * n_text + i : lpb, valid);
    }
    commit_copies();
  };

#pragma unroll
  for (int k = 0; k < PF - 1; ++k) fetch(k);
  float q[C];
  for (int j = 0; j < fl; ++j) {
    wait_copies<PF - 2>();  // frame j has landed
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = ring[j % PF][lane + 32 * c];
    fetch(j + PF - 1);  // into the slot read at frame j-1
    if (j == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) q[c] = (lane + 32 * c == 0) ? v[c] : BIG_NEG;
      continue;
    }
    // high chunks first, so that q[c-1] still holds frame j-1 when read
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const float below = __shfl_sync(FULL, c > 0 ? q[c > 0 ? c - 1 : 0] : BIG_NEG, 31);
      const float up = __shfl_up_sync(FULL, q[c], 1);
      const float left = lane == 0 ? below : up;  // Q[j-1][i-1]
      const bool take_left = left >= q[c];
      q[c] = __fadd_rn(fmaxf(q[c], left), v[c]);
      const unsigned word = __ballot_sync(FULL, take_left);
      if (lane == 0) decb[static_cast<size_t>(j) * C + c] = word;
    }
  }
  wait_copies<0>();
}

}  // namespace mas
