// Native host-path kernels for analytics_zoo_tpu.
//
// The reference reaches MKL/OpenCV through JNI for its host data path
// (SURVEY.md §2.3); the TPU rebuild keeps device math in XLA and uses this
// small library for the host-side hot loops: CRC32C for TFRecord framing
// and uint8 image normalization feeding the per-chip infeed.
//
// Build: g++ -O3 -shared -fPIC -march=native -o libzoonative.so zoonative.cpp

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8 table driven
// ---------------------------------------------------------------------------

static uint32_t kCrcTable[8][256];
static bool kCrcInit = false;

static void crc_init() {
  const uint32_t poly = 0x82F63B78u;
  for (int i = 0; i < 256; ++i) {
    uint32_t c = (uint32_t)i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? poly : 0);
    kCrcTable[0][i] = c;
  }
  for (int t = 1; t < 8; ++t) {
    for (int i = 0; i < 256; ++i) {
      uint32_t c = kCrcTable[t - 1][i];
      kCrcTable[t][i] = (c >> 8) ^ kCrcTable[0][c & 0xFF];
    }
  }
  kCrcInit = true;
}

uint32_t zoo_crc32c(const char* data, size_t n) {
  if (!kCrcInit) crc_init();
  uint32_t crc = 0xFFFFFFFFu;
  const uint8_t* p = (const uint8_t*)data;
  while (n >= 8) {
    crc ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
    uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8) |
                  ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
    crc = kCrcTable[7][crc & 0xFF] ^ kCrcTable[6][(crc >> 8) & 0xFF] ^
          kCrcTable[5][(crc >> 16) & 0xFF] ^ kCrcTable[4][crc >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ kCrcTable[0][(crc ^ *p++) & 0xFF];
  return crc ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// uint8 HWC image batch -> float32 (x - mean[c]) / std[c]
// ---------------------------------------------------------------------------

void zoo_normalize_u8(const uint8_t* in, float* out, size_t n,
                      size_t channels, const float* mean, const float* std) {
  float inv[16];
  size_t c = channels < 16 ? channels : 16;
  for (size_t i = 0; i < c; ++i) inv[i] = 1.0f / std[i];
  for (size_t i = 0; i < n; ++i) {
    size_t ch = i % channels;
    out[i] = ((float)in[i] - mean[ch]) * inv[ch];
  }
}

// ---------------------------------------------------------------------------
// Threaded batch assembly: N variable-size HWC uint8 images -> one
// contiguous (N, oh, ow, ch) uint8 batch with per-image crop offsets and
// horizontal flips.  This is the host-side hot loop that keeps the
// per-chip infeed fed (SURVEY.md §2.3: "high-throughput host-side
// decode/augment feeding infeed" — the one justified native component).
// Crop offsets / flip flags come from the CALLER (seeded Python RNG), so
// augmentation replay after checkpoint-resume stays exact.
// ---------------------------------------------------------------------------

void zoo_assemble_batch(const uint8_t* const* imgs,
                        const int32_t* hw,    // (N, 2): src h, w
                        const int32_t* off,   // (N, 2): crop y0, x0
                        const uint8_t* flip,  // (N,): 1 = mirror
                        uint8_t* out, int32_t n, int32_t oh, int32_t ow,
                        int32_t ch, int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  auto work = [&](int32_t start, int32_t end) {
    for (int32_t i = start; i < end; ++i) {
      const uint8_t* src = imgs[i];
      const int32_t w = hw[2 * i + 1];
      const int32_t y0 = off[2 * i], x0 = off[2 * i + 1];
      uint8_t* dst_img = out + (size_t)i * oh * ow * ch;
      for (int32_t y = 0; y < oh; ++y) {
        const uint8_t* srow = src + ((size_t)(y0 + y) * w + x0) * ch;
        uint8_t* drow = dst_img + (size_t)y * ow * ch;
        if (!flip[i]) {
          memcpy(drow, srow, (size_t)ow * ch);
        } else {
          for (int32_t x = 0; x < ow; ++x)
            memcpy(drow + (size_t)x * ch,
                   srow + (size_t)(ow - 1 - x) * ch, (size_t)ch);
        }
      }
    }
  };
  if (n_threads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int32_t per = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int32_t s = t * per, e = s + per < n ? s + per : n;
    if (s >= e) break;
    pool.emplace_back(work, s, e);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Threaded bilinear resize: N same-size HWC uint8 images -> (N, oh, ow, ch)
// uint8.  Half-pixel-center sampling with edge clamping — the cv2
// INTER_LINEAR convention, so the Python oracle (ImageResize/cv2) and the
// native path agree to rounding.  Completes the native host preprocess
// chain: resize (here) -> crop/flip (zoo_assemble_batch) -> normalize
// (zoo_normalize_u8).
// ---------------------------------------------------------------------------

void zoo_resize_bilinear_u8(const uint8_t* in, uint8_t* out, int32_t n,
                            int32_t ih, int32_t iw, int32_t oh, int32_t ow,
                            int32_t ch, int32_t n_threads) {
  const float sy = (float)ih / (float)oh;
  const float sx = (float)iw / (float)ow;
  // Per-output-column sampling data is identical across rows and images:
  // precompute once.
  std::vector<int32_t> x0s(ow), x1s(ow);
  std::vector<float> fxs(ow);
  for (int32_t x = 0; x < ow; ++x) {
    float src = ((float)x + 0.5f) * sx - 0.5f;
    if (src < 0) src = 0;
    int32_t x0 = (int32_t)src;
    if (x0 > iw - 1) x0 = iw - 1;
    int32_t x1 = x0 + 1 < iw ? x0 + 1 : iw - 1;
    x0s[x] = x0;
    x1s[x] = x1;
    fxs[x] = src - (float)x0;
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;
  auto work = [&](int32_t start, int32_t end) {
    for (int32_t i = start; i < end; ++i) {
      const uint8_t* src_img = in + (size_t)i * ih * iw * ch;
      uint8_t* dst_img = out + (size_t)i * oh * ow * ch;
      for (int32_t y = 0; y < oh; ++y) {
        float srcy = ((float)y + 0.5f) * sy - 0.5f;
        if (srcy < 0) srcy = 0;
        int32_t y0 = (int32_t)srcy;
        if (y0 > ih - 1) y0 = ih - 1;
        int32_t y1 = y0 + 1 < ih ? y0 + 1 : ih - 1;
        float fy = srcy - (float)y0;
        const uint8_t* r0 = src_img + (size_t)y0 * iw * ch;
        const uint8_t* r1 = src_img + (size_t)y1 * iw * ch;
        uint8_t* drow = dst_img + (size_t)y * ow * ch;
        for (int32_t x = 0; x < ow; ++x) {
          const uint8_t* p00 = r0 + (size_t)x0s[x] * ch;
          const uint8_t* p01 = r0 + (size_t)x1s[x] * ch;
          const uint8_t* p10 = r1 + (size_t)x0s[x] * ch;
          const uint8_t* p11 = r1 + (size_t)x1s[x] * ch;
          float fx = fxs[x];
          for (int32_t c = 0; c < ch; ++c) {
            float top = (float)p00[c] + fx * ((float)p01[c] - (float)p00[c]);
            float bot = (float)p10[c] + fx * ((float)p11[c] - (float)p10[c]);
            float v = top + fy * (bot - top);
            drow[(size_t)x * ch + c] = (uint8_t)(v + 0.5f);
          }
        }
      }
    }
  };
  if (n_threads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int32_t per = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int32_t s = t * per, e = s + per < n ? s + per : n;
    if (s >= e) break;
    pool.emplace_back(work, s, e);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
