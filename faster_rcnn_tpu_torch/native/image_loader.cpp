// Native host-side image pipeline: JPEG decode + bicubic resize + canvas pad
// + ImageNet preprocessing, in one pass with no intermediate Python objects.
//
// The reference's data path is cv2.imread + cv2.resize(INTER_CUBIC) per
// access inside the training hot loop (shapes.py:24-29, SURVEY.md §3.1 "DISK
// + HOST CPU").  Here the whole decode->resize->flip->preprocess->pad chain
// runs in C++ (libjpeg + hand-rolled Catmull-Rom bicubic, matching
// INTER_CUBIC's a=-0.5 kernel and center-aligned sampling grid), called from
// Python worker threads via ctypes — ctypes releases the GIL, so N workers
// decode truly in parallel while the GPU computes.
//
// C ABI only; no pybind11 (not in the image).  Built by
// faster_rcnn_tpu_torch/data/native_loader.py on first use, into
// faster_rcnn_tpu_torch/_build/.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to tightly packed RGB8.  Returns false on failure.
bool decode_jpeg(const char* path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Catmull-Rom bicubic weight, a = -0.5 (cv2 INTER_CUBIC kernel).
inline float cubic_w(float t) {
  const float a = -0.5f;
  t = std::fabs(t);
  if (t <= 1.0f) return ((a + 2.0f) * t - (a + 3.0f)) * t * t + 1.0f;
  if (t < 2.0f) return (((t - 5.0f) * t + 8.0f) * t - 4.0f) * a;
  return 0.0f;
}

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// Center-aligned bicubic resize RGB8 -> RGB float (still 0..255 range).
//
// Separable two-pass implementation (the Catmull-Rom kernel factorizes as
// w(x,y) = w(x)*w(y), and border clamping is per-axis): a horizontal pass
// into a (sh x dw) float intermediate, then a vertical pass.  Identical
// tap ordering and nesting to the direct 16-tap version it replaced —
// rowacc-over-kx inside acc-over-ky — so the output is bit-identical; but
// the horizontal weights are applied once per SOURCE row instead of once
// per OUTPUT row, cutting MACs ~2.5x at the production geometries and
// turning the inner loops into sequential streams (measured: KITTI-canvas
// prepare_example 34.8 -> ~14 ms/img, now ahead of PIL's own two-pass).
void resize_bicubic(const uint8_t* src, int sw, int sh, float* dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;

  std::vector<int> xi(dw * 4);
  std::vector<float> xw(dw * 4);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = static_cast<int>(std::floor(fx));
    float frac = fx - x0;
    for (int k = 0; k < 4; ++k) {
      xi[x * 4 + k] = clampi(x0 - 1 + k, 0, sw - 1);
      xw[x * 4 + k] = cubic_w(frac + 1 - k);
    }
  }

  // pass 1: horizontal, src rows -> (sh x dw x 3) float intermediate
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int* xis = &xi[x * 4];
      const float* xws = &xw[x * 4];
      for (int c = 0; c < 3; ++c) {
        float rowacc = 0.0f;
        for (int kx = 0; kx < 4; ++kx) {
          rowacc += xws[kx] * srow[xis[kx] * 3 + c];
        }
        trow[x * 3 + c] = rowacc;
      }
    }
  }

  // pass 2: vertical, intermediate rows -> dst
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = static_cast<int>(std::floor(fy));
    float fr = fy - y0;
    int yi[4];
    float yw[4];
    for (int k = 0; k < 4; ++k) {
      yi[k] = clampi(y0 - 1 + k, 0, sh - 1);
      yw[k] = cubic_w(fr + 1 - k);
    }
    const float* t0 = tmp.data() + static_cast<size_t>(yi[0]) * dw * 3;
    const float* t1 = tmp.data() + static_cast<size_t>(yi[1]) * dw * 3;
    const float* t2 = tmp.data() + static_cast<size_t>(yi[2]) * dw * 3;
    const float* t3 = tmp.data() + static_cast<size_t>(yi[3]) * dw * 3;
    float* drow = dst + static_cast<size_t>(y) * dw * 3;
    const int n = dw * 3;
    for (int i = 0; i < n; ++i) {
      drow[i] = yw[0] * t0[i] + yw[1] * t1[i] + yw[2] * t2[i] + yw[3] * t3[i];
    }
  }
}

const float kMeansBGR[3] = {103.939f, 116.779f, 123.68f};

}  // namespace

extern "C" {

// Decode `path`, bicubic-resize to (target_h, target_w), optionally mirror
// horizontally, convert RGB->BGR, subtract ImageNet means, and write float32
// HWC into `out` (canvas_h, canvas_w, 3), zero-padding outside the image.
// Returns 0 on success.
int frcnn_load_image(const char* path, float* out, int canvas_h, int canvas_w,
                     int target_h, int target_w, int flip) {
  if (target_h > canvas_h || target_w > canvas_w) return 2;

  std::vector<uint8_t> rgb;
  int sw = 0, sh = 0;
  if (!decode_jpeg(path, &rgb, &sw, &sh)) return 1;

  std::vector<float> resized(static_cast<size_t>(target_h) * target_w * 3);
  resize_bicubic(rgb.data(), sw, sh, resized.data(), target_w, target_h);

  memset(out, 0, sizeof(float) * canvas_h * canvas_w * 3);
  for (int y = 0; y < target_h; ++y) {
    const float* srow = resized.data() + static_cast<size_t>(y) * target_w * 3;
    float* drow = out + (static_cast<size_t>(y) * canvas_w) * 3;
    for (int x = 0; x < target_w; ++x) {
      int sxp = flip ? (target_w - 1 - x) : x;
      // RGB source -> BGR output with mean subtraction
      drow[x * 3 + 0] = srow[sxp * 3 + 2] - kMeansBGR[0];
      drow[x * 3 + 1] = srow[sxp * 3 + 1] - kMeansBGR[1];
      drow[x * 3 + 2] = srow[sxp * 3 + 0] - kMeansBGR[2];
    }
  }
  return 0;
}

// Like frcnn_load_image but emits the RAW resized RGB canvas as uint8 (no
// BGR flip / mean subtraction) — the wire format of the uint8 serving and
// training pipelines: 4x less host->device traffic, preprocessing happens on
// device (train/pipeline.py ingest_images, inference.make_detect_fn
// uint8_input).  Bicubic ringing is clamped into [0, 255]; values round to
// nearest so the device-side float path sees at most +-0.5 quantization.
int frcnn_load_image_u8(const char* path, uint8_t* out, int canvas_h,
                        int canvas_w, int target_h, int target_w, int flip) {
  if (target_h > canvas_h || target_w > canvas_w) return 2;

  std::vector<uint8_t> rgb;
  int sw = 0, sh = 0;
  if (!decode_jpeg(path, &rgb, &sw, &sh)) return 1;

  std::vector<float> resized(static_cast<size_t>(target_h) * target_w * 3);
  resize_bicubic(rgb.data(), sw, sh, resized.data(), target_w, target_h);

  // Pad with the mean RGB pixel so the device-side mean subtraction maps
  // padding to ~0 — matching the float path, whose canvas is zeroed AFTER
  // preprocessing.  (Zero-padding raw uint8 would make the backbone see
  // -mean in the pad and shift edge features.)
  const uint8_t pad[3] = {124, 117, 104};  // round(kMeansBGR reversed)
  for (size_t i = 0; i < static_cast<size_t>(canvas_h) * canvas_w; ++i) {
    out[i * 3 + 0] = pad[0];
    out[i * 3 + 1] = pad[1];
    out[i * 3 + 2] = pad[2];
  }
  for (int y = 0; y < target_h; ++y) {
    const float* srow = resized.data() + static_cast<size_t>(y) * target_w * 3;
    uint8_t* drow = out + (static_cast<size_t>(y) * canvas_w) * 3;
    for (int x = 0; x < target_w; ++x) {
      int sxp = flip ? (target_w - 1 - x) : x;
      for (int c = 0; c < 3; ++c) {
        float v = srow[sxp * 3 + c];
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        drow[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
  return 0;
}

// Raw decode only (for probing / tests): writes RGB8 into out (must be
// preallocated w*h*3; call with out=null to query dims). Returns 0 on
// success, 1 decode failure, 3 buffer mismatch.
int frcnn_decode_jpeg(const char* path, uint8_t* out, int* w, int* h) {
  std::vector<uint8_t> rgb;
  int sw = 0, sh = 0;
  if (!decode_jpeg(path, &rgb, &sw, &sh)) return 1;
  if (out != nullptr) {
    if (*w != sw || *h != sh) return 3;
    memcpy(out, rgb.data(), rgb.size());
  }
  *w = sw;
  *h = sh;
  return 0;
}

}  // extern "C"
