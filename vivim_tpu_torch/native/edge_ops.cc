// Native host-side data-path ops of the clip loader (vivim_tpu_torch.native).
//
// The device path runs the model; the host-side input pipeline is the
// other hot loop — per-frame distance-transform edge maps
// (the reference's Multiclass_Data.py:220-234 calls scipy EDT twice per
// class per frame) and mask/image resizes.  This file implements them in
// C++ (exact 2-pass Felzenszwalb EDT) for the threaded loader.
//
// Built as a plain shared library, bound via ctypes (no pybind11 in the
// image).  All arrays are C-contiguous; caller owns all buffers.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <limits>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
// Large finite cost for "foreground" samples: true INF makes the envelope
// intersection (inf - inf) NaN and corrupts the hull stack; 1e10 dominates
// any squared image distance (< 1e9 for 16k x 16k) without overflow.
constexpr float kBig = 1e10f;

// Felzenszwalb & Huttenlocher 1-D squared distance transform.
// f: input costs (size n), d: output (size n); v, zbuf: scratch (size n+1).
void dt1d(const float* f, float* d, int* v, float* zbuf, int n) {
  int k = 0;
  v[0] = 0;
  zbuf[0] = -kInf;
  zbuf[1] = kInf;
  for (int q = 1; q < n; ++q) {
    float s;
    while (true) {
      int p = v[k];
      s = ((f[q] + q * (float)q) - (f[p] + p * (float)p)) / (2.0f * (q - p));
      if (s <= zbuf[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    zbuf[k] = s;
    zbuf[k + 1] = kInf;
  }
  k = 0;
  for (int q = 0; q < n; ++q) {
    while (zbuf[k + 1] < q) ++k;
    int p = v[k];
    d[q] = (q - p) * (float)(q - p) + f[p];
  }
}

// Exact 2-D squared EDT of "distance to nearest zero pixel".
// mask: HxW uint8 (nonzero = foreground); out: HxW float squared distances.
void edt2d_sq(const uint8_t* mask, float* out, int h, int w) {
  std::vector<float> f(std::max(h, w));
  std::vector<float> d(std::max(h, w));
  std::vector<int> v(std::max(h, w) + 1);
  std::vector<float> z(std::max(h, w) + 2);

  // column pass
  for (int x = 0; x < w; ++x) {
    for (int y = 0; y < h; ++y)
      f[y] = mask[y * w + x] ? kBig : 0.0f;
    dt1d(f.data(), d.data(), v.data(), z.data(), h);
    for (int y = 0; y < h; ++y) out[y * w + x] = d[y];
  }
  // row pass
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) f[x] = out[y * w + x];
    dt1d(f.data(), d.data(), v.data(), z.data(), w);
    for (int x = 0; x < w; ++x) out[y * w + x] = d[x];
  }
}

}  // namespace

extern "C" {

// EDT (euclidean, not squared) of distance-to-nearest-zero, scipy semantics.
void vivim_edt(const uint8_t* mask, float* out, int h, int w) {
  edt2d_sq(mask, out, h, w);
  for (int i = 0; i < h * w; ++i) out[i] = std::sqrt(out[i]);
}

// Edge band map (Multiclass_Data.py:220-234): for each of C class masks
// (zero-padded by one pixel), band = (EDT(m) + EDT(1-m)) <= radius; the
// output accumulates the per-class bands (uint8 counts -> float by caller).
//
// The sum collapses: at every pixel one term is 0 (the pixel is itself a
// zero of either the mask or its inverse), so
//   band(p)  <=>  some OPPOSITE-valued pixel lies within `radius` of p.
// Every Euclidean distance <= radius is realized inside a +-ceil(radius)
// window, so for small radii the band is an OR of shifted byte-compares
// (`pad[p] != pad[p+off]` over all offsets with |off| <= radius) — exact,
// branch-free, auto-vectorized; larger radii fall back to the EDT pair.
void vivim_edge_band(const uint8_t* masks, int c, int h, int w, float radius,
                     uint8_t* out) {
  const int ph = h + 2, pw = w + 2;
  std::vector<uint8_t> pad((size_t)ph * pw);
  std::memset(out, 0, (size_t)h * w);

  const int R = (int)std::ceil(radius);
  const bool windowed = R <= 4;
  struct Off { int dy, dx; };
  std::vector<Off> offs;
  if (windowed) {
    for (int dy = -R; dy <= R; ++dy)
      for (int dx = -R; dx <= R; ++dx) {
        if (dy == 0 && dx == 0) continue;
        if ((float)(dy * dy + dx * dx) <= radius * radius + 1e-6f)
          offs.push_back({dy, dx});
      }
  }
  std::vector<uint8_t> band;
  std::vector<uint8_t> inv;
  std::vector<float> d1, d2;
  if (windowed) {
    band.resize((size_t)ph * pw);
  } else {
    inv.resize((size_t)ph * pw);
    d1.resize((size_t)ph * pw);
    d2.resize((size_t)ph * pw);
  }

  for (int ci = 0; ci < c; ++ci) {
    const uint8_t* m = masks + (size_t)ci * h * w;
    std::memset(pad.data(), 0, pad.size());
    for (int y = 0; y < h; ++y)
      std::memcpy(pad.data() + (size_t)(y + 1) * pw + 1, m + (size_t)y * w, w);
    if (windowed) {
      std::memset(band.data(), 0, band.size());
      for (const Off& o : offs) {
        // overlap of the padded field with itself shifted by (dy, dx)
        const int y0 = std::max(0, -o.dy), y1 = std::min(ph, ph - o.dy);
        const int x0 = std::max(0, -o.dx), x1 = std::min(pw, pw - o.dx);
        for (int y = y0; y < y1; ++y) {
          const uint8_t* a = pad.data() + (size_t)y * pw + x0;
          const uint8_t* b =
              pad.data() + (size_t)(y + o.dy) * pw + (x0 + o.dx);
          uint8_t* bd = band.data() + (size_t)y * pw + x0;
          const int nx = x1 - x0;
          for (int x = 0; x < nx; ++x) bd[x] |= (uint8_t)(a[x] != b[x]);
        }
      }
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          out[(size_t)y * w + x] += band[(size_t)(y + 1) * pw + x + 1];
    } else {
      for (size_t i = 0; i < (size_t)ph * pw; ++i) inv[i] = pad[i] ? 0 : 1;
      edt2d_sq(pad.data(), d1.data(), ph, pw);
      edt2d_sq(inv.data(), d2.data(), ph, pw);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          float dist = std::sqrt(d1[(size_t)(y + 1) * pw + x + 1]) +
                       std::sqrt(d2[(size_t)(y + 1) * pw + x + 1]);
          if (dist <= radius) out[(size_t)y * w + x] += 1;
        }
    }
  }
}

// Nearest-neighbor resize, uint8, CHW-agnostic single channel.
void vivim_resize_nearest_u8(const uint8_t* src, int sh, int sw,
                             uint8_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    // PIL NEAREST: src index = floor((y + 0.5) * sh / dh)
    int sy = (int)(((float)y + 0.5f) * sh / dh);
    if (sy >= sh) sy = sh - 1;
    for (int x = 0; x < dw; ++x) {
      int sx = (int)(((float)x + 0.5f) * sw / dw);
      if (sx >= sw) sx = sw - 1;
      dst[y * dw + x] = src[sy * sw + sx];
    }
  }
}

// Bilinear resize + ImageNet normalization fused: HWC uint8 RGB ->
// HWC float32 normalized.  Matches PIL's antialiased BILINEAR (triangle
// filter with support scaled by the downscale ratio, separable passes).
namespace {

struct Taps {
  std::vector<int> lo;      // first source index per output pixel
  std::vector<int> n;       // tap count per output pixel
  std::vector<float> w;     // weights, kmax per output pixel
  int kmax;
};

Taps precompute_taps(int in_size, int out_size) {
  Taps t;
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // triangle filter support
  int kmax = (int)std::ceil(support) * 2 + 1;
  t.kmax = kmax;
  t.lo.resize(out_size);
  t.n.resize(out_size);
  t.w.resize((size_t)out_size * kmax, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double ss = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double arg = (x - center + 0.5) / filterscale;
      double val = arg < 0 ? -arg : arg;
      double tri = val < 1.0 ? 1.0 - val : 0.0;
      t.w[(size_t)xx * kmax + (x - xmin)] = (float)tri;
      ss += tri;
    }
    if (ss > 0)
      for (int k = 0; k < xmax - xmin; ++k)
        t.w[(size_t)xx * kmax + k] /= (float)ss;
    t.lo[xx] = xmin;
    t.n[xx] = xmax - xmin;
  }
  return t;
}

}  // namespace

void vivim_resize_bilinear_normalize(const uint8_t* src, int sh, int sw,
                                     float* dst, int dh, int dw,
                                     const float* mean, const float* std_) {
  Taps tx = precompute_taps(sw, dw);
  Taps ty = precompute_taps(sh, dh);
  // horizontal pass: (sh, dw, 3) temp
  std::vector<float> tmp((size_t)sh * dw * 3);
  for (int y = 0; y < sh; ++y) {
    for (int x = 0; x < dw; ++x) {
      const float* wrow = &tx.w[(size_t)x * tx.kmax];
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < tx.n[x]; ++k) {
        const uint8_t* px = src + ((size_t)y * sw + tx.lo[x] + k) * 3;
        acc[0] += wrow[k] * px[0];
        acc[1] += wrow[k] * px[1];
        acc[2] += wrow[k] * px[2];
      }
      float* out = &tmp[((size_t)y * dw + x) * 3];
      out[0] = acc[0]; out[1] = acc[1]; out[2] = acc[2];
    }
  }
  // vertical pass + normalization
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < dh; ++y) {
    const float* wrow = &ty.w[(size_t)y * ty.kmax];
    for (int x = 0; x < dw; ++x) {
      float acc[3] = {0, 0, 0};
      for (int k = 0; k < ty.n[y]; ++k) {
        const float* px = &tmp[(((size_t)(ty.lo[y] + k)) * dw + x) * 3];
        acc[0] += wrow[k] * px[0];
        acc[1] += wrow[k] * px[1];
        acc[2] += wrow[k] * px[2];
      }
      float* out = dst + ((size_t)y * dw + x) * 3;
      for (int c = 0; c < 3; ++c)
        out[c] = (acc[c] * inv255 - mean[c]) / std_[c];
    }
  }
}

namespace {

inline uint8_t blend8(float degenerate, float value, float alpha) {
  // PIL Image.blend (Blend.c): out = in1 + alpha*(in2-in1), TRUNCATED to
  // int (no rounding) and clipped
  float v = degenerate + alpha * (value - degenerate);
  int r = (int)v;
  if (r < 0) r = 0;
  if (r > 255) r = 255;
  return (uint8_t)r;
}

inline int luma8(int r, int g, int b) {
  // PIL RGB->L: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
  return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16;
}

}  // namespace

// Fused PIL ImageEnhance chain: Brightness -> Contrast -> Color ->
// Sharpness, each blending the image toward its "degenerate" version
// exactly as PIL does (ImageEnhance.py), with per-stage uint8 rounding.
// In the reference augmentation (Multiclass_Data.py colorEnhance) these
// run as four separate PIL passes — ~33 ms/frame at 512 px, the single
// largest host-loader cost; fused here they are ~2 ms.
// img: HWC RGB uint8, modified in place.
void vivim_color_enhance(uint8_t* img, int h, int w, float f_bright,
                         float f_contrast, float f_color, float f_sharp) {
  const size_t n = (size_t)h * w;
  // 1. brightness: blend toward black
  for (size_t i = 0; i < n * 3; ++i)
    img[i] = blend8(0.0f, img[i], f_bright);
  // 2. contrast: blend toward solid gray = round(mean of L)
  {
    uint64_t sum = 0;
    for (size_t i = 0; i < n; ++i)
      sum += luma8(img[i * 3], img[i * 3 + 1], img[i * 3 + 2]);
    float mean = (float)((int)((double)sum / n + 0.5));
    for (size_t i = 0; i < n * 3; ++i)
      img[i] = blend8(mean, img[i], f_contrast);
  }
  // 3. color (saturation): blend toward per-pixel grayscale
  for (size_t i = 0; i < n; ++i) {
    float L = (float)luma8(img[i * 3], img[i * 3 + 1], img[i * 3 + 2]);
    img[i * 3] = blend8(L, img[i * 3], f_color);
    img[i * 3 + 1] = blend8(L, img[i * 3 + 1], f_color);
    img[i * 3 + 2] = blend8(L, img[i * 3 + 2], f_color);
  }
  // 4. sharpness: blend toward SMOOTH-filtered ([[1,1,1],[1,5,1],[1,1,1]]/13;
  // PIL copies the 1-px border from the input)
  {
    std::vector<uint8_t> src(img, img + n * 3);
    for (int y = 1; y < h - 1; ++y) {
      for (int x = 1; x < w - 1; ++x) {
        for (int c = 0; c < 3; ++c) {
          const size_t idx = ((size_t)y * w + x) * 3 + c;
          const size_t up = idx - (size_t)w * 3, dn = idx + (size_t)w * 3;
          float sm = (src[up - 3] + src[up] + src[up + 3] +
                      src[idx - 3] + 5.0f * src[idx] + src[idx + 3] +
                      src[dn - 3] + src[dn] + src[dn + 3]) / 13.0f;
          // PIL rounds the filtered degenerate to uint8 before blending
          float smr = (float)(int)(sm + 0.5f);
          img[idx] = blend8(smr, src[idx], f_sharp);
        }
      }
    }
  }
}

}  // extern "C"
