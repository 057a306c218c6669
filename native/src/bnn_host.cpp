// Native host runtime ops — the analogue of the reference's C++ host
// offload library (SURVEY.md C10 «bnn/src/library/host/
// foldedmv-offload.cpp»: binarizeAndPack / quantize+pack input images,
// output argmax, buffer plumbing). These run on the host CPU feeding the
// device engine: image preprocessing and bit-packing at serving rates is
// host-side work in this design (device-side unpacking lives in XLA ops).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// All batch entry points are multithreaded over images.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Simple static-partition parallel-for over [0, n).
template <typename F>
void parallel_for(int64_t n, const F& fn, int max_threads = 0) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (max_threads <= 0) max_threads = hw > 0 ? hw : 4;
  int nt = static_cast<int>(std::min<int64_t>(max_threads, n));
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nt);
  std::atomic<int64_t> next(0);
  constexpr int64_t kChunk = 16;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&] {
      for (;;) {
        int64_t start = next.fetch_add(kChunk);
        if (start >= n) return;
        int64_t end = std::min(n, start + kChunk);
        for (int64_t i = start; i < end; ++i) fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Number of uint32 words for n 1-bit values.
int64_t bnn_packed_len(int64_t n, int bits) {
  int per_word = 32 / bits;
  return (n + per_word - 1) / per_word;
}

// MNIST-style binarize+pack: bit j of word w of image i is
// (img[i][32w+j] >= thresh). imgs: [n_imgs, len] uint8 row-major;
// out: [n_imgs, ceil(len/32)] uint32. The host half of the reference's
// binarizeAndPack.
void bnn_binarize_pack_u8(const uint8_t* imgs, uint32_t* out,
                          int64_t n_imgs, int64_t len, uint8_t thresh) {
  const int64_t words = bnn_packed_len(len, 1);
  parallel_for(n_imgs, [&](int64_t i) {
    const uint8_t* src = imgs + i * len;
    uint32_t* dst = out + i * words;
    for (int64_t w = 0; w < words; ++w) {
      uint32_t acc = 0;
      const int64_t base = w * 32;
      const int64_t lim = std::min<int64_t>(32, len - base);
      for (int64_t j = 0; j < lim; ++j) {
        acc |= static_cast<uint32_t>(src[base + j] >= thresh) << j;
      }
      dst[w] = acc;
    }
  });
}

// uint8 image → centered int8 (value - 128), vectorizable memcpy-like op.
void bnn_center_int8(const uint8_t* src, int8_t* dst, int64_t n) {
  parallel_for((n + (1 << 20) - 1) >> 20, [&](int64_t blk) {
    const int64_t start = blk << 20;
    const int64_t end = std::min(n, start + (1 << 20));
    for (int64_t i = start; i < end; ++i) {
      dst[i] = static_cast<int8_t>(static_cast<int>(src[i]) - 128);
    }
  });
}

// Pack ±1 int8 rows along the last axis: vals [rows, k] → out [rows, kw].
// Bit = (val > 0); pad bits zero. Matches ops/packing.pack_bits.
void bnn_pack_bits_i8(const int8_t* vals, uint32_t* out, int64_t rows,
                      int64_t k) {
  const int64_t words = bnn_packed_len(k, 1);
  parallel_for(rows, [&](int64_t r) {
    const int8_t* src = vals + r * k;
    uint32_t* dst = out + r * words;
    for (int64_t w = 0; w < words; ++w) {
      uint32_t acc = 0;
      const int64_t base = w * 32;
      const int64_t lim = std::min<int64_t>(32, k - base);
      for (int64_t j = 0; j < lim; ++j) {
        acc |= static_cast<uint32_t>(src[base + j] > 0) << j;
      }
      dst[w] = acc;
    }
  });
}

// Pack 2-bit codes {0..3} 16-per-word. Matches ops/packing.pack_codes2.
void bnn_pack_codes2_i8(const int8_t* codes, uint32_t* out, int64_t rows,
                        int64_t k) {
  const int64_t words = bnn_packed_len(k, 2);
  parallel_for(rows, [&](int64_t r) {
    const int8_t* src = codes + r * k;
    uint32_t* dst = out + r * words;
    for (int64_t w = 0; w < words; ++w) {
      uint32_t acc = 0;
      const int64_t base = w * 16;
      const int64_t lim = std::min<int64_t>(16, k - base);
      for (int64_t j = 0; j < lim; ++j) {
        acc |= (static_cast<uint32_t>(src[base + j]) & 3u) << (2 * j);
      }
      dst[w] = acc;
    }
  });
}

// Row-wise argmax of float logits [n, ncls] → out [n] int32.
void bnn_argmax_f32(const float* logits, int64_t n, int64_t ncls,
                    int32_t* out) {
  parallel_for(n, [&](int64_t i) {
    const float* row = logits + i * ncls;
    int32_t best = 0;
    float bv = row[0];
    for (int64_t c = 1; c < ncls; ++c) {
      if (row[c] > bv) { bv = row[c]; best = static_cast<int32_t>(c); }
    }
    out[i] = best;
  });
}

// Nearest-neighbour resize of interleaved uint8 HWC images to out_h×out_w
// (the host half of the reference CnvClassifier's PIL 32×32 resize,
// SURVEY.md C12 «bnn/bnn.py»).
void bnn_resize_nn_u8(const uint8_t* src, uint8_t* dst, int64_t n_imgs,
                      int64_t h, int64_t w, int64_t c, int64_t oh,
                      int64_t ow) {
  parallel_for(n_imgs, [&](int64_t i) {
    const uint8_t* s = src + i * h * w * c;
    uint8_t* d = dst + i * oh * ow * c;
    for (int64_t y = 0; y < oh; ++y) {
      int64_t sy = std::min(h - 1, y * h / oh);
      for (int64_t x = 0; x < ow; ++x) {
        int64_t sx = std::min(w - 1, x * w / ow);
        std::memcpy(d + (y * ow + x) * c, s + (sy * w + sx) * c,
                    static_cast<size_t>(c));
      }
    }
  });
}

}  // extern "C"
