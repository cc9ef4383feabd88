// Native host-side image decode + resample core: the port's own copy of
// federated_multi_modal_tpu/native/imagecodec.cc, built by native/__init__.py
// into federated_multi_modal_tpu_torch/build/.
//
// Replacement for the host half of the reference's data path:
// the reference reads images through PIL inside 8 torch DataLoader worker
// processes (Dassl DatasetWrapper, reference trainers/client_datamanager.py:
// 65-103).  Here the host's only job is to produce fixed-size uint8
// canvases (augmentation runs fused on device, ops/preprocess.py), so the
// hot path is "JPEG bytes -> SxS RGB canvas".  This library does that in
// C++:
//
//   * libjpeg decode with DCT-domain prescaling (1/2, 1/4, 1/8) chosen so
//     the decoded image is the smallest one still >= the canvas on its
//     short side — large photos skip most of the IDCT work entirely.
//   * libpng decode (palette/gray/16-bit/alpha all folded to 8-bit RGB,
//     alpha dropped like PIL's convert("RGB")).
//   * PIL-equivalent separable resampling (anti-aliased bicubic a=-0.5 /
//     bilinear / nearest with filter-support scaling) to the square canvas.
//   * a pthread batch API so multi-core hosts decode a whole batch in
//     parallel (the reference's NUM_WORKERS=8 analogue, without pickling
//     or process fork overhead).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdio>  // must precede jpeglib.h (it needs FILE declared)

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Error codes (mirrored in native/__init__.py)
// ---------------------------------------------------------------------------
enum {
  FMM_OK = 0,
  FMM_ERR_OPEN = 1,     // file missing / unreadable
  FMM_ERR_FORMAT = 2,   // not a format we handle -> caller falls back to PIL
  FMM_ERR_DECODE = 3,   // corrupt stream
  FMM_ERR_ARG = 4,      // bad arguments
};

enum {
  FMM_INTERP_NEAREST = 0,
  FMM_INTERP_BILINEAR = 1,
  FMM_INTERP_BICUBIC = 2,
};

struct Image {
  std::vector<uint8_t> px;  // H*W*3, RGB
  int w = 0;
  int h = 0;
};

// ---------------------------------------------------------------------------
// JPEG (libjpeg with setjmp error trap so corrupt files don't abort)
// ---------------------------------------------------------------------------
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silence(j_common_ptr, int) {}

int decode_jpeg(FILE* f, int canvas, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.pub.emit_message = jpeg_silence;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return FMM_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  // DCT-domain prescale: largest 1/d (d in 8,4,2) keeping the short side
  // >= canvas.  This is the big host-side win — a 4000px photo headed for
  // a 256 canvas decodes at 1/8 scale, skipping ~98% of IDCT + color work.
  int short_side = cinfo.image_width < cinfo.image_height
                       ? cinfo.image_width
                       : cinfo.image_height;
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int d = 8; d > 1; d >>= 1) {
    if (short_side / d >= canvas) {
      cinfo.scale_denom = d;
      break;
    }
  }
  bool cmyk = (cinfo.jpeg_color_space == JCS_CMYK ||
               cinfo.jpeg_color_space == JCS_YCCK);
  cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;  // match PIL's default quality
  jpeg_start_decompress(&cinfo);

  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  int ncomp = cinfo.output_components;
  std::vector<uint8_t> row(static_cast<size_t>(out->w) * ncomp);
  out->px.resize(static_cast<size_t>(out->w) * out->h * 3);
  JSAMPROW rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    uint8_t* dst = out->px.data() + static_cast<size_t>(y) * out->w * 3;
    if (cmyk) {
      // Adobe-style inverted CMYK -> RGB (same as PIL's JpegImagePlugin)
      for (int x = 0; x < out->w; ++x) {
        int c = row[x * 4 + 0], m = row[x * 4 + 1], yv = row[x * 4 + 2],
            k = row[x * 4 + 3];
        dst[x * 3 + 0] = static_cast<uint8_t>(c * k / 255);
        dst[x * 3 + 1] = static_cast<uint8_t>(m * k / 255);
        dst[x * 3 + 2] = static_cast<uint8_t>(yv * k / 255);
      }
    } else if (ncomp == 3) {
      std::memcpy(dst, row.data(), static_cast<size_t>(out->w) * 3);
    } else {  // grayscale fallback (libjpeg normally expands for us)
      for (int x = 0; x < out->w; ++x) {
        dst[x * 3 + 0] = dst[x * 3 + 1] = dst[x * 3 + 2] = row[x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return FMM_OK;
}

// ---------------------------------------------------------------------------
// PNG (libpng; everything folded to 8-bit RGB, alpha dropped like
// PIL.Image.convert("RGB"))
// ---------------------------------------------------------------------------
int decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return FMM_ERR_DECODE;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return FMM_ERR_DECODE;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return FMM_ERR_DECODE;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->px.resize(static_cast<size_t>(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) {
    rows[y] = out->px.data() + static_cast<size_t>(y) * out->w * 3;
  }
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return FMM_OK;
}

// ---------------------------------------------------------------------------
// PIL-equivalent separable resampling (Image.resize semantics: the filter
// support is scaled by the downsampling ratio => anti-aliased, per-window
// normalized weights, edge windows clipped + renormalized)
// ---------------------------------------------------------------------------
double kernel_bicubic(double x) {  // Catmull-Rom-ish, a = -0.5 (PIL's cubic)
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

double kernel_bilinear(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  std::vector<int> xmin;        // per output pixel: first input index
  std::vector<int> xlen;        // window length
  std::vector<double> weights;  // ksize per output pixel, flattened
  int ksize = 0;
};

Coeffs precompute_coeffs(int in_size, int out_size, int interp) {
  double (*kfn)(double) =
      interp == FMM_INTERP_BILINEAR ? kernel_bilinear : kernel_bicubic;
  double support = interp == FMM_INTERP_BILINEAR ? 1.0 : 2.0;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double scaled_support = support * filterscale;
  int ksize = static_cast<int>(std::ceil(scaled_support)) * 2 + 1;

  Coeffs c;
  c.ksize = ksize;
  c.xmin.resize(out_size);
  c.xlen.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int x0 = static_cast<int>(center - scaled_support + 0.5);
    if (x0 < 0) x0 = 0;
    int x1 = static_cast<int>(center + scaled_support + 0.5);
    if (x1 > in_size) x1 = in_size;
    double* w = &c.weights[static_cast<size_t>(i) * ksize];
    double total = 0.0;
    for (int x = x0; x < x1; ++x) {
      double v = kfn((x + 0.5 - center) / filterscale);
      w[x - x0] = v;
      total += v;
    }
    if (total != 0.0) {
      for (int x = 0; x < x1 - x0; ++x) w[x] /= total;
    }
    c.xmin[i] = x0;
    c.xlen[i] = x1 - x0;
  }
  return c;
}

inline uint8_t clamp_u8(double v) {
  return v < 0.0 ? 0 : (v > 255.0 ? 255 : static_cast<uint8_t>(v + 0.5));
}

// Resize src (h x w x 3) to (canvas x canvas x 3) into dst.
void resample(const Image& src, int canvas, int interp, uint8_t* dst) {
  if (interp == FMM_INTERP_NEAREST) {
    for (int y = 0; y < canvas; ++y) {
      int sy = static_cast<int>((y + 0.5) * src.h / canvas);
      if (sy >= src.h) sy = src.h - 1;
      const uint8_t* srow = src.px.data() + static_cast<size_t>(sy) * src.w * 3;
      uint8_t* drow = dst + static_cast<size_t>(y) * canvas * 3;
      for (int x = 0; x < canvas; ++x) {
        int sx = static_cast<int>((x + 0.5) * src.w / canvas);
        if (sx >= src.w) sx = src.w - 1;
        std::memcpy(drow + x * 3, srow + sx * 3, 3);
      }
    }
    return;
  }
  Coeffs ch = precompute_coeffs(src.w, canvas, interp);
  Coeffs cv = precompute_coeffs(src.h, canvas, interp);

  // horizontal pass: (h x w) -> (h x canvas), float intermediate
  std::vector<float> mid(static_cast<size_t>(src.h) * canvas * 3);
  for (int y = 0; y < src.h; ++y) {
    const uint8_t* srow = src.px.data() + static_cast<size_t>(y) * src.w * 3;
    float* drow = mid.data() + static_cast<size_t>(y) * canvas * 3;
    for (int x = 0; x < canvas; ++x) {
      const double* w = &ch.weights[static_cast<size_t>(x) * ch.ksize];
      int x0 = ch.xmin[x], n = ch.xlen[x];
      double r = 0, g = 0, b = 0;
      const uint8_t* p = srow + static_cast<size_t>(x0) * 3;
      for (int k = 0; k < n; ++k, p += 3) {
        r += w[k] * p[0];
        g += w[k] * p[1];
        b += w[k] * p[2];
      }
      drow[x * 3 + 0] = static_cast<float>(r);
      drow[x * 3 + 1] = static_cast<float>(g);
      drow[x * 3 + 2] = static_cast<float>(b);
    }
  }
  // vertical pass: (h x canvas) -> (canvas x canvas)
  for (int y = 0; y < canvas; ++y) {
    const double* w = &cv.weights[static_cast<size_t>(y) * cv.ksize];
    int y0 = cv.xmin[y], n = cv.xlen[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * canvas * 3;
    for (int x = 0; x < canvas * 3; ++x) {
      double acc = 0;
      for (int k = 0; k < n; ++k) {
        acc += w[k] * mid[static_cast<size_t>(y0 + k) * canvas * 3 + x];
      }
      drow[x] = clamp_u8(acc);
    }
  }
}

// Center-crop to the shorter-side square in place (aspect-preserving
// canvas: Resize(shorter)+CenterCrop parity with the reference eval
// pipeline; the squash mode distorts aspect ratios).
void center_crop_square(Image* img) {
  int side = img->w < img->h ? img->w : img->h;
  if (img->w == img->h) return;
  int x0 = (img->w - side) / 2;
  int y0 = (img->h - side) / 2;
  std::vector<uint8_t> px(static_cast<size_t>(side) * side * 3);
  for (int y = 0; y < side; ++y) {
    const uint8_t* srow =
        img->px.data() +
        (static_cast<size_t>(y0 + y) * img->w + x0) * 3;
    std::memcpy(px.data() + static_cast<size_t>(y) * side * 3, srow,
                static_cast<size_t>(side) * 3);
  }
  img->px = std::move(px);
  img->w = side;
  img->h = side;
}

int decode_one(const char* path, int canvas, int interp, int crop_square,
               uint8_t* out) {
  if (!path || !out || canvas <= 0) return FMM_ERR_ARG;
  FILE* f = std::fopen(path, "rb");
  if (!f) return FMM_ERR_OPEN;
  uint8_t magic[8] = {0};
  size_t got = std::fread(magic, 1, 8, f);
  std::rewind(f);
  Image img;
  int rc;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF) {
    rc = decode_jpeg(f, canvas, &img);
  } else if (got >= 8 && !png_sig_cmp(magic, 0, 8)) {
    rc = decode_png(f, &img);
  } else {
    rc = FMM_ERR_FORMAT;  // bmp/gif/tiff/webp etc: PIL fallback
  }
  std::fclose(f);
  if (rc != FMM_OK) return rc;
  if (img.w <= 0 || img.h <= 0) return FMM_ERR_DECODE;
  if (crop_square) center_crop_square(&img);
  resample(img, canvas, interp, out);
  return FMM_OK;
}

}  // namespace

extern "C" {

// Decode `path` into a canvas x canvas x 3 uint8 RGB buffer.
// crop_square: 1 = aspect-preserving shorter-side center crop before the
// resample; 0 = squash the full frame.
int fmm_decode_to_canvas(const char* path, int canvas, int interp,
                         int crop_square, uint8_t* out) {
  return decode_one(path, canvas, interp, crop_square, out);
}

// Decode n files in parallel with up to n_threads worker threads.
// `out` is n * canvas * canvas * 3 bytes; statuses[i] gets the per-file rc.
// Returns the number of failures.
int fmm_decode_batch(const char** paths, int n, int canvas, int interp,
                     int crop_square, int n_threads, uint8_t* out,
                     int* statuses) {
  if (n <= 0 || !paths || !out || !statuses) return -1;
  size_t stride = static_cast<size_t>(canvas) * canvas * 3;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decode_one(paths[i], canvas, interp, crop_square,
                          out + stride * i);
      statuses[i] = rc;
      if (rc != FMM_OK) failures.fetch_add(1);
    }
  };
  int nt = n_threads < 1 ? 1 : (n_threads > n ? n : n_threads);
  if (nt == 1) {
    work();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(work);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

const char* fmm_native_version() { return "fmmtpu-io 1.1"; }

}  // extern "C"
