// Host-side detection and image-prep ops of the PyTorch port, built with
// the host C++ compiler at first use and bound with ctypes
// (dana_tpu_torch/native/__init__.py).  The same functions, arithmetic and
// loop order as the JAX package's dana_tpu/native/host_ops.cpp, so both
// give the same bits:
//   bbox_overlaps, greedy_nms    pairwise IoU and greedy NMS (+1 widths,
//                                suppression at IoU > threshold), for the
//                                demo and evaluation helpers
//   meansub_u8 / _f32            image - per-channel means, one pass
//   pad_s2d_u8 / _f32            canvas pad + conv1 border + 2x2
//                                space-to-depth of one image, one pass
// Every function keeps its state on the stack: the loaders' assembly
// threads call them concurrently (a ctypes call releases the interpreter
// lock).

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// out[i*k + j] = IoU(boxes[i], query[j]); +1 widths.
void bbox_overlaps(const float* boxes, int64_t n, const float* query,
                   int64_t k, float* out) {
  for (int64_t j = 0; j < k; ++j) {
    const float* q = query + j * 4;
    const float q_area = (q[2] - q[0] + 1.0f) * (q[3] - q[1] + 1.0f);
    for (int64_t i = 0; i < n; ++i) {
      const float* b = boxes + i * 4;
      const float iw =
          std::min(b[2], q[2]) - std::max(b[0], q[0]) + 1.0f;
      float v = 0.0f;
      if (iw > 0) {
        const float ih =
            std::min(b[3], q[3]) - std::max(b[1], q[1]) + 1.0f;
        if (ih > 0) {
          const float ua = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f) +
                           q_area - iw * ih;
          v = iw * ih / ua;
        }
      }
      out[i * k + j] = v;
    }
  }
}

// Greedy score-descending NMS (stable sort). Returns the number of kept
// boxes; their input indices land in keep_out[0..ret).
int64_t greedy_nms(const float* boxes, const float* scores, int64_t n,
                   float thresh, int64_t* keep_out, int64_t max_keep) {
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return scores[a] > scores[b]; });
  std::vector<float> areas(n);
  for (int64_t i = 0; i < n; ++i) {
    const float* b = boxes + i * 4;
    areas[i] = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  }
  std::vector<char> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n && kept < max_keep; ++oi) {
    const int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* bi = boxes + i * 4;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 4;
      const float iw = std::min(bi[2], bj[2]) - std::max(bi[0], bj[0]) + 1.0f;
      if (iw <= 0) continue;
      const float ih = std::min(bi[3], bj[3]) - std::max(bi[1], bj[1]) + 1.0f;
      if (ih <= 0) continue;
      const float inter = iw * ih;
      const float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host image-prep passes (data/blob.py): mean subtraction, and the canvas
// pad, conv1 border and the stem's 2x2 space-to-depth packing in one pass
// (one write per output byte, no intermediate canvas).  Layout as
// blob.s2d_pack: [(ch+6)/2, (cw+6)/2, 4*3] with the conv1 pad-3 border
// applied and channel order (row phase, column phase, c).
// (The core is a template, which may not carry C linkage.)

// Fused canvas-pad + space-to-depth core; see pad_s2d_f32/u8 below.
template <typename T>
static void pad_s2d_impl(const T* src, int64_t h, int64_t w, int64_t ch,
                         int64_t cw, const T* pad3, T* dst) {
  const int64_t hp = ch + 6, wp = cw + 6;
  const int64_t oh = hp / 2, ow = wp / 2;
  for (int64_t oy = 0; oy < oh; ++oy) {
    T* drow = dst + oy * ow * 12;
    for (int64_t i2 = 0; i2 < 2; ++i2) {
      const int64_t yy = 2 * oy + i2 - 3;        // source row
      const bool yin = yy >= 0 && yy < h;
      const T* srow = src + (yin ? yy * w * 3 : 0);
      for (int64_t j2 = 0; j2 < 2; ++j2) {
        const int64_t kc = (i2 * 2 + j2) * 3;
        if (!yin) {
          for (int64_t ox = 0; ox < ow; ++ox) {
            T* d = drow + ox * 12 + kc;
            d[0] = pad3[0]; d[1] = pad3[1]; d[2] = pad3[2];
          }
          continue;
        }
        // xx = 2*ox + j2 - 3 in [0, w) <=> ox in [x0, x1)
        const int64_t x0 = (3 - j2 + 1) / 2;              // first in-range ox
        const int64_t x1_excl = (w + 3 - j2 + 1) / 2;     // first out ox
        const int64_t xe = x1_excl < ow ? x1_excl : ow;
        for (int64_t ox = 0; ox < x0 && ox < ow; ++ox) {
          T* d = drow + ox * 12 + kc;
          d[0] = pad3[0]; d[1] = pad3[1]; d[2] = pad3[2];
        }
        for (int64_t ox = x0; ox < xe; ++ox) {
          const T* s = srow + (2 * ox + j2 - 3) * 3;
          T* d = drow + ox * 12 + kc;
          d[0] = s[0]; d[1] = s[1]; d[2] = s[2];
        }
        for (int64_t ox = xe > x0 ? xe : x0; ox < ow; ++ox) {
          T* d = drow + ox * 12 + kc;
          d[0] = pad3[0]; d[1] = pad3[1]; d[2] = pad3[2];
        }
      }
    }
  }
}

extern "C" {

// dst[i] = src[i] - mean3[i % 3]  (u8 -> f32, fused astype+subtract)
void meansub_u8(const uint8_t* src, int64_t npix, const float* mean3,
                float* dst) {
  const float m0 = mean3[0], m1 = mean3[1], m2 = mean3[2];
  for (int64_t p = 0; p < npix; ++p) {
    dst[p * 3 + 0] = static_cast<float>(src[p * 3 + 0]) - m0;
    dst[p * 3 + 1] = static_cast<float>(src[p * 3 + 1]) - m1;
    dst[p * 3 + 2] = static_cast<float>(src[p * 3 + 2]) - m2;
  }
}

// f32 variant (imread may already hold f32 pixels)
void meansub_f32(const float* src, int64_t npix, const float* mean3,
                 float* dst) {
  const float m0 = mean3[0], m1 = mean3[1], m2 = mean3[2];
  for (int64_t p = 0; p < npix; ++p) {
    dst[p * 3 + 0] = src[p * 3 + 0] - m0;
    dst[p * 3 + 1] = src[p * 3 + 1] - m1;
    dst[p * 3 + 2] = src[p * 3 + 2] - m2;
  }
}

// Fused canvas-pad + space-to-depth for one image.
//
// src [h, w, 3] sits top-left on a logical (ch, cw) canvas (ch, cw even);
// the canvas gets the conv1 pad-3 border; output is the 2x2-strided pack
// dst [(ch+6)/2, (cw+6)/2, 12].  Every out-of-source position (canvas pad
// AND conv border) takes pad3 — 0 for mean-subtracted f32, the rounded
// means for raw u8 (both paths pad with one value).
void pad_s2d_f32(const float* src, int64_t h, int64_t w, int64_t ch,
                 int64_t cw, const float* pad3, float* dst) {
  pad_s2d_impl<float>(src, h, w, ch, cw, pad3, dst);
}

void pad_s2d_u8(const uint8_t* src, int64_t h, int64_t w, int64_t ch,
                int64_t cw, const uint8_t* pad3, uint8_t* dst) {
  pad_s2d_impl<uint8_t>(src, h, w, ch, cw, pad3, dst);
}

}  // extern "C"
