// Forward pass of monotonic alignment search, one warp per item, the layout
// of its decisions, and the backtrace's window words, shared by the two MAS
// kernels (mas_wavefront.cu, B3, and mas_extract.cu, B4).
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
// cannot change the result (the cells past tl hold whatever the ring holds).
//
// What bounds it: the frames of an item are a dependent chain, so the time
// is fl x (cycles per frame), one warp per SM at B = 128 with nothing to
// hide a latency behind. The design cuts the instructions and the waits of
// a frame:
// - lane l holds the contiguous tokens K l .. K l + K - 1, K = ceil(T / 32)
//   (a template argument, the next instantiated width, not the next power
//   of two). A frame's K updates depend only on the previous frame, except
//   the first, whose left neighbour Q[j-1][K l - 1] is lane l-1's last cell:
//   one __shfl_up_sync a frame. The Q row stays in registers;
// - lane l's K decision bits of a frame go into a register word at bit
//   f K, FW = 32 / K frames to a word (a 64-bit word of one frame for
//   K > 32), and the warp stores its 32 words every FW frames, one
//   coalesced row;
// - lane 0 stages the log-probs SF frames at a time, about 16 (SR whole
//   decision rows): one cp.async.bulk of their rows (contiguous in lp), the
//   start rounded down and the length up to 16 bytes, into a ring of STAGES
//   slots, each completing on its own mbarrier, STAGES - 1 stages ahead;
//   the frames of a stage run unrolled, and the stage's bookkeeping is
//   hoisted out of them (it, not the copies' latency, was what the loads
//   cost: rings of 48 and 192 KB timed the same, PERF.md). The ring takes
//   up to 96 KB of dynamic shared memory (B = 128 puts one block on an
//   SM). The one stage whose rounded window would pass the end of lp (the
//   tensor's last rows) is read from device memory instead.
//
// Decision layout, (B, ceil(F / FW), 32) words: row g holds frames
// g FW .. g FW + FW - 1, word l of it lane l's tokens, bit f K + k the
// decision of frame g FW + f at token K l + k. The backtrace reads the rows
// in windows of D = 32 / FW rows (NW = D FW <= 32 frames), a window ahead,
// and gathers for each frame of a window the 32 decisions at the tokens the
// path can reach in it (`window_word`), so that its own chain is a shift
// and a subtract a frame.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace mas {

// The instantiated tokens per lane (ops/mas.py::TOKENS_PER_LANE): every K
// up to 16, then steps that keep a lane's idle tokens under a fifth.
#define MAS_TOKENS_PER_LANE(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16) \
  X(20) X(24) X(28) X(32) X(40) X(48) X(56) X(64)

constexpr float BIG_NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// A lane's decision word: 32 bits up to K = 32 tokens a lane, else 64.
template <bool NARROW>
struct WordOf {
  using type = uint32_t;
};
template <>
struct WordOf<false> {
  using type = uint64_t;
};

template <int K>
struct Layout {
  static_assert(K >= 1 && K <= 64, "a lane holds 1 to 64 tokens");
  using Word = typename WordOf<(K <= 32)>::type;
  static constexpr int FW = K <= 32 ? 32 / K : 1;  // frames per decision word
  static constexpr int D = 32 / FW;                // decision rows per backtrace window
  static constexpr int NW = D * FW;                // frames per backtrace window, <= 32
  // decision rows per stage of the ring: about 16 frames, at most 16 KB
  static constexpr int SR_FRAMES = (16 + FW - 1) / FW;
  static constexpr int SR_BYTES = 16384 / (FW * 32 * K * 4) > 0 ? 16384 / (FW * 32 * K * 4) : 1;
  static constexpr int SR = SR_FRAMES < SR_BYTES ? SR_FRAMES : SR_BYTES;
  static constexpr int SF = SR * FW;               // frames per stage
  // floats in a ring slot: SF rows of up to 32 K tokens, and 32 bytes for
  // the 16-byte rounding of the window's start and end
  static constexpr int SLOT = SF * 32 * K + 8;
  static constexpr int FIT = 24576 / SLOT;         // slots in 96 KB
  static constexpr int STAGES = FIT > 32 ? 32 : (FIT < 3 ? 3 : FIT);
  // dynamic shared memory of a block: the ring, then its mbarriers
  static constexpr int SMEM_BYTES = STAGES * SLOT * 4 + STAGES * 8;
  // source lanes whose tokens a 32-token window [base, base + 31] can touch
  static constexpr int SOURCES = K == 1 ? 32 : (K - 1 + 31) / K + 1;
};

// The ring (STAGES slots of SLOT floats) and its mbarriers in a kernel's
// dynamic shared memory, `smem`, of Layout<K>::SMEM_BYTES.
template <int K>
__device__ __forceinline__ float (*ring_of(unsigned char* smem))[Layout<K>::SLOT] {
  return reinterpret_cast<float(*)[Layout<K>::SLOT]>(smem);
}
template <int K>
__device__ __forceinline__ uint64_t* barriers_of(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(smem + Layout<K>::STAGES * Layout<K>::SLOT * 4);
}

// Launches kernel<<<batch, 32, SMEM_BYTES>>> after raising its dynamic
// shared memory limit to the ring's size.
template <int K, typename Kernel, typename... Args>
cudaError_t launch_warp_per_item(Kernel kernel, int batch, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<K>::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<batch, 32, Layout<K>::SMEM_BYTES, stream>>>(args...);
  return cudaGetLastError();
}

// The decision rows of an item: ceil(F / FW).
template <int K>
__host__ __device__ constexpr int decision_rows(int n_feats) {
  return (n_feats + Layout<K>::FW - 1) / Layout<K>::FW;
}

// Stage g's window: the rows of frames g SF .. min(fl, g SF + SF) - 1, from
// the first row's start rounded down to 16 bytes (`shift` floats before it)
// to the last row's first tl floats rounded up to 16 bytes. False where the
// window would pass `lp_end`: the stage is then read from device memory.
template <int K>
__device__ __forceinline__ bool stage_window(const float* lpb, int g, int tl, int fl, int n_text,
                                             const float* lp_end, uintptr_t& start,
                                             uint32_t& bytes, int& shift) {
  constexpr int SF = Layout<K>::SF;
  const int rows = fl - g * SF < SF ? fl - g * SF : SF;
  const uintptr_t p = reinterpret_cast<uintptr_t>(lpb + static_cast<size_t>(g) * SF * n_text);
  start = p & ~static_cast<uintptr_t>(15);
  shift = static_cast<int>(p - start) / 4;
  bytes = (static_cast<uint32_t>(p - start) + 4u * ((rows - 1) * n_text + tl) + 15u) & ~15u;
  return start + bytes <= reinterpret_cast<uintptr_t>(lp_end);
}

// The forward DP of one item by one warp (blockDim.x == 32): lpb is the
// item's (F, n_text) log-probs, lp_end the end of the whole lp tensor, decb
// its decision rows; ring and full are the calling kernel's shared memory
// (`ring_of`).
template <int K>
__device__ __forceinline__ void forward(const float* __restrict__ lpb, const float* lp_end,
                                        typename Layout<K>::Word* __restrict__ decb, int tl,
                                        int fl, int n_text, float (*ring)[Layout<K>::SLOT],
                                        uint64_t* full) {
  using L = Layout<K>;
  using Word = typename L::Word;
  constexpr int S = L::STAGES;
  constexpr int FW = L::FW;
  constexpr int SF = L::SF;
  const int lane = threadIdx.x;
  const int i0 = K * lane;  // this lane's first token
  const int n_stages = (fl + SF - 1) / SF;
  // the one stage that may not come through the ring: the tensor's last rows
  uintptr_t start;
  uint32_t bytes;
  int shift;
  const int from_memory =
      stage_window<K>(lpb, n_stages - 1, tl, fl, n_text, lp_end, start, bytes, shift)
          ? -1 : n_stages - 1;
  const uint32_t stage_bytes = 4u * SF * n_text;
  const uint32_t lead = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(lpb)) & 15u;

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) hopper::mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  // lane 0: stage g into slot g % S, or a bare arrival for the stage read
  // from device memory
  auto fetch = [&](int g) {
    if (g >= n_stages) return;
    uint64_t* bar = &full[g % S];
    if (g == from_memory) {
      hopper::mbar_arrive(bar);
      return;
    }
    stage_window<K>(lpb, g, tl, fl, n_text, lp_end, start, bytes, shift);
    hopper::mbar_expect_tx(bar, bytes);
    hopper::bulk_load(ring[g % S], reinterpret_cast<const void*>(start), bytes, bar);
  };
  if (lane == 0) {
#pragma unroll 1
    for (int g = 0; g < S - 1; ++g) fetch(g);
  }

  float q[K];
#pragma unroll 1
  for (int g = 0; g < n_stages; ++g) {
    const int s = g % S;
    const bool in_ring = g != from_memory;
    const int lead_floats = static_cast<int>((lead + g * stage_bytes) & 15u) / 4;
    hopper::mbar_wait(&full[s], (g / S) & 1);
    __syncwarp();  // every lane has read stage g - 1's slot and waited on its phase
    if (lane == 0) fetch(g + S - 1);  // into that slot
    const float* cells = ring[s] + lead_floats + i0;
#pragma unroll
    for (int r = 0; r < L::SR; ++r) {
      Word word = 0;
#pragma unroll
      for (int f = 0; f < FW; ++f) {
        const int e = r * FW + f;  // frame within the stage
        const int j = g * SF + e;  // frames past fl compute junk that nothing reads
        float v[K];
        if (in_ring) {
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = cells[e * n_text + k];
        } else {
          const float* row = lpb + static_cast<size_t>(j) * n_text;
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = j < fl && i0 + k < tl ? row[i0 + k] : 0.f;
        }
        if (e == 0 && g == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) q[k] = i0 + k == 0 ? v[k] : BIG_NEG;
          continue;
        }
        const float up = __shfl_up_sync(FULL, q[K - 1], 1);
        const float left0 = lane == 0 ? BIG_NEG : up;  // Q[j-1][i0 - 1]
        Word bits = 0;
        // high tokens first, so that q[k-1] still holds frame j-1 when read
#pragma unroll
        for (int k = K - 1; k >= 1; --k) {
          bits |= static_cast<Word>(q[k - 1] >= q[k]) << k;
          q[k] = __fadd_rn(fmaxf(q[k], q[k - 1]), v[k]);
        }
        bits |= static_cast<Word>(left0 >= q[0]);
        q[0] = __fadd_rn(fmaxf(q[0], left0), v[0]);
        word |= bits << (f * K);
      }
      const int row_g = g * L::SR + r;  // decision row
      if (row_g * FW < fl) decb[static_cast<size_t>(row_g) * 32 + lane] = word;
    }
  }
}

// Lane l's words of the D decision rows of backtrace window w (rows past the
// last one the forward stored read as 0).
template <int K>
__device__ __forceinline__ void load_window(const typename Layout<K>::Word* __restrict__ decb,
                                            int w, int fl,
                                            typename Layout<K>::Word (&rows)[Layout<K>::D]) {
  using L = Layout<K>;
#pragma unroll
  for (int r = 0; r < L::D; ++r) {
    const int g = w * L::D + r;
    rows[r] = g * L::FW < fl ? decb[static_cast<size_t>(g) * 32 + threadIdx.x] : 0;
  }
}

// For K <= 32: the decisions of lane s's frame (frame NW - 1 - s of the
// window, counted from its first) at tokens base .. base + 31, bit p for
// token base + p, gathered from the lanes that hold those tokens; token 0's
// decision reads 0 (the path never leaves token 0).
template <int K>
__device__ __forceinline__ uint32_t window_word(const uint32_t (&rows)[Layout<K>::D], int base) {
  using L = Layout<K>;
  const int from_first = L::NW - 1 - static_cast<int>(threadIdx.x);  // this lane's frame
  const int my_row = from_first / L::FW, my_slot = from_first % L::FW;
  const int first_src = base / K;
  uint64_t gathered = 0;  // bit K + p for token base + p, p from -(K - 1) up
#pragma unroll
  for (int i = 0; i < L::SOURCES; ++i) {
    const int src = first_src + i;
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < L::D; ++r) {
      const uint32_t got = __shfl_sync(FULL, rows[r], src & 31);
      if (r == my_row) word = got;
    }
    const int at = src * K - base + K;  // where this source's first token goes, >= 1
    const uint64_t seg = K == 32 ? word : (word >> (my_slot * K)) & ((1u << (K % 32)) - 1u);
    if (src < 32 && at < 32 + K) gathered |= seg << at;
  }
  const uint32_t window = static_cast<uint32_t>(gathered >> K);
  return base == 0 ? window & ~1u : window;
}

// For K > 32 (one frame a row): the decision at token a of the frame whose
// row word is `row`, by a shuffle from the lane that holds token a.
template <int K>
__device__ __forceinline__ int decision_at(uint64_t row, int a) {
  const uint64_t word = __shfl_sync(FULL, row, a / K);
  return a > 0 ? static_cast<int>((word >> (a % K)) & 1u) : 0;
}

}  // namespace mas
