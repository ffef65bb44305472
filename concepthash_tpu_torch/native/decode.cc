// Native image decode + short-side resize + center crop for the input
// pipeline (the port's own copy of concepthash_tpu/native/decode.cc, the
// same code, so the two give the same bytes): called from the loader's
// decode threads through ctypes, which releases the GIL for the call, where
// PIL's decode holds it for part of its work.
//
// JPEG decodes use libjpeg DCT scaling (scale_num/8) to land near the target
// size before the bilinear pass — typically 4-16x less IDCT work for
// thumbnail-style targets.
//
// Built by concepthash_tpu_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC -o <lib> decode.cc -ljpeg -lpng
//
// exported:
//   decode_resize_crop(bytes, len, resize, out[resize*resize*3]) -> 0 | -1
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> px;  // RGB8
  int w = 0, h = 0;
};

// ---------------------------------------------------------------- jpeg
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(const uint8_t* data, size_t len, int target, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT scaling: choose the smallest scale >= target on the short side
  int short_side = cinfo.image_width < cinfo.image_height ? cinfo.image_width
                                                          : cinfo.image_height;
  if (target > 0 && short_side > target) {
    for (int denom = 8; denom >= 2; --denom) {
      if (short_side / denom >= target) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = denom;  // libjpeg supports M/8 scaling; 1/N ok
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->px.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->px.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------------- png
struct PngReadState {
  const uint8_t* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  auto* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "eof");
  }
  memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const uint8_t* data, size_t len, Image* out) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  if (png_get_rowbytes(png, info) != size_t(out->w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  out->px.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->px.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ------------------------------------------------- resize + center crop
// bilinear, half-pixel centers (align_corners=false convention)
void resize_bilinear(const Image& src, int dw, int dh, Image* dst) {
  dst->w = dw;
  dst->h = dh;
  dst->px.resize(size_t(dw) * dh * 3);
  const float sx = float(src.w) / dw;
  const float sy = float(src.h) / dh;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : int(fy);
    int y1 = y0 + 1 < src.h ? y0 + 1 : src.h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    const uint8_t* r0 = src.px.data() + size_t(y0) * src.w * 3;
    const uint8_t* r1 = src.px.data() + size_t(y1) * src.w * 3;
    uint8_t* drow = dst->px.data() + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : int(fx);
      int x1 = x0 + 1 < src.w ? x0 + 1 : src.w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int c = 0; c < 3; ++c) {
        float top = r0[x0 * 3 + c] * (1 - wx) + r0[x1 * 3 + c] * wx;
        float bot = r1[x0 * 3 + c] * (1 - wx) + r1[x1 * 3 + c] * wx;
        float v = top * (1 - wy) + bot * wy;
        drow[x * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success; out must hold resize*resize*3 bytes.
int decode_resize_crop(const uint8_t* data, size_t len, int resize,
                       uint8_t* out) {
  Image img;
  bool ok = false;
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    ok = decode_jpeg(data, len, resize, &img);
  } else {
    ok = decode_png(data, len, &img);
  }
  if (!ok || img.w <= 0 || img.h <= 0) return -1;

  // short-side resize preserving aspect
  int nw, nh;
  if (img.w <= img.h) {
    nw = resize;
    nh = int(float(img.h) * resize / img.w + 0.5f);
    if (nh < resize) nh = resize;
  } else {
    nh = resize;
    nw = int(float(img.w) * resize / img.h + 0.5f);
    if (nw < resize) nw = resize;
  }
  Image resized;
  resize_bilinear(img, nw, nh, &resized);

  const int left = (nw - resize) / 2;
  const int top = (nh - resize) / 2;
  for (int y = 0; y < resize; ++y) {
    memcpy(out + size_t(y) * resize * 3,
           resized.px.data() + (size_t(y + top) * nw + left) * 3,
           size_t(resize) * 3);
  }
  return 0;
}

// Decode only (native size) into caller buffer after a size query.
int image_size(const uint8_t* data, size_t len, int* w, int* h) {
  Image img;
  bool ok;
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    ok = decode_jpeg(data, len, 0, &img);
  } else {
    ok = decode_png(data, len, &img);
  }
  if (!ok) return -1;
  *w = img.w;
  *h = img.h;
  return 0;
}
}
