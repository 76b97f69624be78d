// Packed-dataset reader and batch assembler, the host collator of the
// packed data path (data/packed.py). Built with the host C++ compiler into
// build/ at first use (ops/_build.py::load_host).
//
// The whole dataset lives in ONE mmapped arena file and a batch is
// assembled (zero-padding to the bucketed shapes, statistics
// normalisation, the uv-threshold on pitch) by parallel C++ workers
// writing straight into caller-owned numpy buffers: no Python work per
// item. Normalisation is (v - mean) / std in float32, the operations
// data/datamodule.py::BucketedCollate runs in numpy, so the two give the
// same bits.
//
// File format (little-endian), written by data/packed.py::pack_dataset:
//   header:  magic "OSPK" (4 bytes), u32 version=1, u64 n_items,
//            u32 n_feats, u32 hop_length, u32 reserved[2]
//   table:   n_items records of ItemRec (see below), 8-byte aligned
//   data:    concatenated arrays; offsets in ItemRec are absolute file offsets
//            text: i32[text_len]; wav: f32[wav_len]; mel: f32[n_feats*mel_len]
//            (mel-major: mel[c * mel_len + t]); pitch,energy: f32[mel_len]

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

#pragma pack(push, 1)
struct Header {
  char magic[4];
  uint32_t version;
  uint64_t n_items;
  uint32_t n_feats;
  uint32_t hop_length;
  uint32_t reserved[2];
};

struct ItemRec {
  uint64_t text_off;
  uint64_t wav_off;
  uint64_t mel_off;
  uint64_t pitch_off;
  uint64_t energy_off;
  uint32_t text_len;
  uint32_t wav_len;
  uint32_t mel_len;
  int32_t sid;
  int32_t lid;
  uint32_t pad;
};
#pragma pack(pop)

struct Dataset {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  const Header* header = nullptr;
  const ItemRec* table = nullptr;
};

struct Stats {
  float mel_mean, mel_std;
  float energy_mean, energy_std;
  float pitch_mean, pitch_std;
  float uv_threshold;  // pitch <= threshold -> 0 before normalization
};

}  // namespace

extern "C" {

void* pd_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(mem, st.st_size, MADV_WILLNEED);
  auto* ds = new Dataset;
  ds->fd = fd;
  ds->base = static_cast<const uint8_t*>(mem);
  ds->size = st.st_size;
  ds->header = reinterpret_cast<const Header*>(ds->base);
  if (memcmp(ds->header->magic, "OSPK", 4) != 0 || ds->header->version != 1) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete ds;
    return nullptr;
  }
  ds->table = reinterpret_cast<const ItemRec*>(ds->base + sizeof(Header));
  return ds;
}

void pd_close(void* handle) {
  auto* ds = static_cast<Dataset*>(handle);
  if (!ds) return;
  munmap(const_cast<uint8_t*>(ds->base), ds->size);
  ::close(ds->fd);
  delete ds;
}

uint64_t pd_num_items(void* handle) {
  return static_cast<Dataset*>(handle)->header->n_items;
}

uint32_t pd_n_feats(void* handle) {
  return static_cast<Dataset*>(handle)->header->n_feats;
}

uint32_t pd_hop_length(void* handle) {
  return static_cast<Dataset*>(handle)->header->hop_length;
}

// Fill lens[i*2+0] = text_len, lens[i*2+1] = mel_len for each index.
void pd_lengths(void* handle, const int64_t* idxs, int64_t n, int32_t* lens) {
  auto* ds = static_cast<Dataset*>(handle);
  for (int64_t i = 0; i < n; ++i) {
    const ItemRec& r = ds->table[idxs[i]];
    lens[i * 2] = static_cast<int32_t>(r.text_len);
    lens[i * 2 + 1] = static_cast<int32_t>(r.mel_len);
  }
}

// Assemble a normalized, bucket-padded batch directly into caller buffers.
// Buffers must be zero-initialized by the caller or are fully overwritten
// here (padding regions are explicitly zeroed).
// x: i32[n, t_text]; wav: f32[n, t_mel*hop]; mel: f32[n, n_feats, t_mel];
// pitch, energy: f32[n, t_mel]; xl/ml/wl: i32[n]; sids/lids: i32[n]
void pd_assemble_batch(
    void* handle, const int64_t* idxs, int64_t n,
    int64_t t_text, int64_t t_mel,
    const Stats* stats, int do_normalize,
    int32_t* x, float* wav, float* mel, float* pitch, float* energy,
    int32_t* xl, int32_t* ml, int32_t* wl, int32_t* sids, int32_t* lids,
    int n_threads) {
  auto* ds = static_cast<Dataset*>(handle);
  const int64_t n_feats = ds->header->n_feats;
  const int64_t hop = ds->header->hop_length;
  const int64_t t_wav = t_mel * hop;

  auto work = [&](int64_t i) {
    const ItemRec& r = ds->table[idxs[i]];
    const int64_t tl = std::min<int64_t>(r.text_len, t_text);
    const int64_t mlen = std::min<int64_t>(r.mel_len, t_mel);
    const int64_t wlen = std::min<int64_t>(r.wav_len, t_wav);
    xl[i] = static_cast<int32_t>(tl);
    ml[i] = static_cast<int32_t>(mlen);
    wl[i] = static_cast<int32_t>(wlen);
    sids[i] = r.sid;
    lids[i] = r.lid;

    // phoneme ids
    const int32_t* src_x = reinterpret_cast<const int32_t*>(ds->base + r.text_off);
    int32_t* dst_x = x + i * t_text;
    memcpy(dst_x, src_x, tl * sizeof(int32_t));
    memset(dst_x + tl, 0, (t_text - tl) * sizeof(int32_t));

    // waveform, clipped to [-1, 1] as the collate clips it
    const float* src_w = reinterpret_cast<const float*>(ds->base + r.wav_off);
    float* dst_w = wav + i * t_wav;
    for (int64_t t = 0; t < wlen; ++t) {
      float v = src_w[t];
      dst_w[t] = v < -1.f ? -1.f : (v > 1.f ? 1.f : v);
    }
    memset(dst_w + wlen, 0, (t_wav - wlen) * sizeof(float));

    // mel, normalised AFTER zero-padding as the collate does, so the
    // padding holds the normalised zero
    const float* src_m = reinterpret_cast<const float*>(ds->base + r.mel_off);
    const float m_mu = do_normalize ? stats->mel_mean : 0.f;
    const float m_sd = do_normalize ? stats->mel_std : 1.f;
    const float m_pad = (0.f - m_mu) / m_sd;
    for (int64_t c = 0; c < n_feats; ++c) {
      float* dst_m = mel + (i * n_feats + c) * t_mel;
      const float* row = src_m + c * r.mel_len;
      for (int64_t t = 0; t < mlen; ++t) dst_m[t] = (row[t] - m_mu) / m_sd;
      for (int64_t t = mlen; t < t_mel; ++t) dst_m[t] = m_pad;
    }

    // pitch: the uv-threshold zeroes it BEFORE normalisation
    const float* src_p = reinterpret_cast<const float*>(ds->base + r.pitch_off);
    const float p_mu = do_normalize ? stats->pitch_mean : 0.f;
    const float p_sd = do_normalize ? stats->pitch_std : 1.f;
    float* dst_p = pitch + i * t_mel;
    for (int64_t t = 0; t < mlen; ++t) {
      float v = src_p[t] <= stats->uv_threshold ? 0.f : src_p[t];
      dst_p[t] = (v - p_mu) / p_sd;
    }
    const float p_pad = (0.f - p_mu) / p_sd;
    for (int64_t t = mlen; t < t_mel; ++t) dst_p[t] = p_pad;

    // energy
    const float* src_e = reinterpret_cast<const float*>(ds->base + r.energy_off);
    const float e_mu = do_normalize ? stats->energy_mean : 0.f;
    const float e_sd = do_normalize ? stats->energy_std : 1.f;
    float* dst_e = energy + i * t_mel;
    for (int64_t t = 0; t < mlen; ++t) dst_e[t] = (src_e[t] - e_mu) / e_sd;
    const float e_pad = (0.f - e_mu) / e_sd;
    for (int64_t t = mlen; t < t_mel; ++t) dst_e[t] = e_pad;
  };

  if (n_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) work(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  const int k = std::min<int64_t>(n_threads, n);
  threads.reserve(k);
  for (int t = 0; t < k; ++t) {
    threads.emplace_back([&] {
      for (int64_t i = next.fetch_add(1); i < n; i = next.fetch_add(1)) work(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
