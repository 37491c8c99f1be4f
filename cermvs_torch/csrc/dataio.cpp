// The port's host data runtime: the PFM codec and multithreaded image
// resampling of the training data path, with a plain C interface bound by
// ctypes (cermvs_torch/io/native.py, which builds this file with g++ at first
// use).
//
// Its arithmetic must stay the JAX package's data runtime's, bit for bit:
// both packages crop and resize training batches with it, and the tests hold
// each image, depth and PFM against the other package's. Under the build
// flags of io/native.py (-O3 -march=native), GCC contracts the bilinear
// blends into fused multiply-adds; another flag set gives other images.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PFM codec ('Pf' greyscale / 'PF' color, negative scale = little endian,
// rows bottom-up).
// ---------------------------------------------------------------------------

// Returns 0 on success.  On success *width/*height/*channels describe the
// data; call pfm_read_data to fill a caller-allocated float buffer.
int pfm_read_header(const char* path, int* width, int* height, int* channels,
                    float* scale) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char tag[3] = {0, 0, 0};
  if (std::fscanf(f, "%2s", tag) != 1) { std::fclose(f); return -2; }
  int c;
  if (std::strcmp(tag, "PF") == 0) c = 3;
  else if (std::strcmp(tag, "Pf") == 0) c = 1;
  else { std::fclose(f); return -3; }
  int w, h;
  float s;
  if (std::fscanf(f, "%d %d %f", &w, &h, &s) != 3) { std::fclose(f); return -4; }
  *width = w; *height = h; *channels = c; *scale = s;
  std::fclose(f);
  return 0;
}

// Fills out (height*width*channels floats, row-major, top-down).
int pfm_read_data(const char* path, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char tag[3] = {0, 0, 0};
  if (std::fscanf(f, "%2s", tag) != 1) { std::fclose(f); return -2; }
  int c = (std::strcmp(tag, "PF") == 0) ? 3 : 1;
  int w, h;
  float s;
  if (std::fscanf(f, "%d %d %f", &w, &h, &s) != 3) { std::fclose(f); return -4; }
  // skip single whitespace byte after the scale line
  std::fgetc(f);
  size_t n = static_cast<size_t>(w) * h * c;
  std::vector<float> buf(n);
  if (std::fread(buf.data(), sizeof(float), n, f) != n) {
    std::fclose(f);
    return -5;
  }
  std::fclose(f);
  const bool file_le = s < 0.0f;
  uint16_t probe = 1;
  const bool host_le = *reinterpret_cast<uint8_t*>(&probe) == 1;
  if (file_le != host_le) {
    for (size_t i = 0; i < n; ++i) {
      uint32_t v;
      std::memcpy(&v, &buf[i], 4);
      v = __builtin_bswap32(v);
      std::memcpy(&buf[i], &v, 4);
    }
  }
  // rows are stored bottom-up
  size_t row = static_cast<size_t>(w) * c;
  for (int y = 0; y < h; ++y)
    std::memcpy(out + static_cast<size_t>(y) * row,
                buf.data() + static_cast<size_t>(h - 1 - y) * row,
                row * sizeof(float));
  return 0;
}

int pfm_write(const char* path, const float* data, int width, int height) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint16_t probe = 1;
  const bool host_le = *reinterpret_cast<uint8_t*>(&probe) == 1;
  std::fprintf(f, "Pf\n%d %d\n%f\n", width, height, host_le ? -1.0 : 1.0);
  for (int y = height - 1; y >= 0; --y) {
    if (std::fwrite(data + static_cast<size_t>(y) * width, sizeof(float),
                    width, f) != static_cast<size_t>(width)) {
      std::fclose(f);
      return -2;
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Multithreaded resampling (the augmentation hot path).
// ---------------------------------------------------------------------------

static void run_rows(int rows, const std::function<void(int)>& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = std::max(1u, std::min(hw, 8u));
  if (rows < 64) n_threads = 1;
  if (n_threads == 1) {
    for (int y = 0; y < rows; ++y) body(y);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&]() {
      int y;
      while ((y = next.fetch_add(8)) < rows) {
        int end = std::min(rows, y + 8);
        for (int i = y; i < end; ++i) body(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Bilinear resize, half-pixel centers (cv2.INTER_LINEAR convention).
// src: (h, w, c) float32 -> dst: (oh, ow, c).
void resize_bilinear(const float* src, int h, int w, int c, float* dst,
                     int oh, int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  run_rows(oh, [&](int oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float wy = fy - y0;
    int y0c = std::clamp(y0, 0, h - 1);
    int y1c = std::clamp(y0 + 1, 0, h - 1);
    const float* r0 = src + static_cast<size_t>(y0c) * w * c;
    const float* r1 = src + static_cast<size_t>(y1c) * w * c;
    float* out = dst + static_cast<size_t>(oy) * ow * c;
    for (int ox = 0; ox < ow; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = static_cast<int>(std::floor(fx));
      float wx = fx - x0;
      int x0c = std::clamp(x0, 0, w - 1);
      int x1c = std::clamp(x0 + 1, 0, w - 1);
      for (int k = 0; k < c; ++k) {
        float a = r0[x0c * c + k] * (1 - wx) + r0[x1c * c + k] * wx;
        float b = r1[x0c * c + k] * (1 - wx) + r1[x1c * c + k] * wx;
        out[ox * c + k] = a * (1 - wy) + b * wy;
      }
    }
  });
}

// Nearest-neighbor resize (depth maps; matches F.interpolate mode='nearest':
// src index = floor(dst_index * scale)).
void resize_nearest(const float* src, int h, int w, int c, float* dst,
                    int oh, int ow) {
  const float sy = static_cast<float>(h) / oh;
  const float sx = static_cast<float>(w) / ow;
  run_rows(oh, [&](int oy) {
    int y = std::min(static_cast<int>(oy * sy), h - 1);
    const float* r = src + static_cast<size_t>(y) * w * c;
    float* out = dst + static_cast<size_t>(oy) * ow * c;
    for (int ox = 0; ox < ow; ++ox) {
      int x = std::min(static_cast<int>(ox * sx), w - 1);
      for (int k = 0; k < c; ++k) out[ox * c + k] = r[x * c + k];
    }
  });
}

// Fused scale+crop for a stack of frames: resize (bilinear for images,
// nearest for depths) then copy the crop window.  frames: (n, h, w, c).
void scale_and_crop(const float* frames, int n, int h, int w, int c,
                    int rh, int rw, int y0, int x0, int ch, int cw,
                    int nearest, float* out) {
  std::vector<float> tmp(static_cast<size_t>(rh) * rw * c);
  for (int i = 0; i < n; ++i) {
    const float* src = frames + static_cast<size_t>(i) * h * w * c;
    if (nearest)
      resize_nearest(src, h, w, c, tmp.data(), rh, rw);
    else
      resize_bilinear(src, h, w, c, tmp.data(), rh, rw);
    float* dst = out + static_cast<size_t>(i) * ch * cw * c;
    for (int y = 0; y < ch; ++y)
      std::memcpy(dst + static_cast<size_t>(y) * cw * c,
                  tmp.data() + (static_cast<size_t>(y + y0) * rw + x0) * c,
                  static_cast<size_t>(cw) * c * sizeof(float));
  }
}

}  // extern "C"
