// ics_tpu_torch native host shims: JPEG/PNG decode (libjpeg / libpng) + SHA-256.
//
// The decode path feeds the TPU ingestion front: bytes -> RGB8 canvas rows.
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// SHA-256 implemented from the FIPS 180-4 spec (content-hash identity used
// across the system).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>

#include <jpeglib.h>
#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4)
// ---------------------------------------------------------------------------

static const uint32_t K256[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

static inline uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

static void sha256_block(uint32_t h[8], const uint8_t *p) {
  uint32_t w[64];
  for (int i = 0; i < 16; i++)
    w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
           (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
  for (int i = 16; i < 64; i++) {
    uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int i = 0; i < 64; i++) {
    uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + S1 + ch + K256[i] + w[i];
    uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

void icstpu_sha256(const uint8_t *data, size_t len, char *hex_out /*>=65*/) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t full = len / 64;
  for (size_t i = 0; i < full; i++) sha256_block(h, data + i * 64);
  uint8_t tail[128];
  size_t rem = len - full * 64;
  memcpy(tail, data + full * 64, rem);
  tail[rem] = 0x80;
  size_t pad_end = (rem < 56) ? 56 : 120;
  memset(tail + rem + 1, 0, pad_end - rem - 1);
  uint64_t bits = uint64_t(len) * 8;
  for (int i = 0; i < 8; i++)
    tail[pad_end + i] = uint8_t(bits >> (56 - 8 * i));
  sha256_block(h, tail);
  if (pad_end == 120) sha256_block(h, tail + 64);
  static const char *hex = "0123456789abcdef";
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++) {
      uint8_t byte = uint8_t(h[i] >> (24 - 8 * j));
      hex_out[i * 8 + j * 2] = hex[byte >> 4];
      hex_out[i * 8 + j * 2 + 1] = hex[byte & 0xf];
    }
  hex_out[64] = '\0';
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) — error handler that longjmps instead of exit()
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

// decompression-bomb guard: PIL's MAX_IMAGE_PIXELS default — a ~1KB
// crafted JPEG can declare 65535x65535 (12.9 GB of RGB) and libjpeg pads
// truncated entropy data instead of erroring, OOM-killing the server.
// The PIL fallback never runs because the native path "succeeds"
// (self-review r3).
static const unsigned long long ICSTPU_MAX_PIXELS = 178956970ULL;

static void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr *err = reinterpret_cast<JpegErrorMgr *>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

static int decode_jpeg(const uint8_t *data, size_t len, uint8_t **out,
                       int *width, int *height) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  // volatile: modified between setjmp and longjmp — a non-volatile
  // auto here is indeterminate in the error path (UB; in practice the
  // register-cached nullptr leaked the full allocation on every
  // attacker-supplied corrupt image; self-review r3)
  uint8_t *volatile buffer = nullptr;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    free(buffer);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char *>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  if (1ULL * w * h > ICSTPU_MAX_PIXELS) {
    jpeg_destroy_decompress(&cinfo);
    return -4;  // declared size past the bomb guard
  }
  size_t stride = size_t(w) * 3;
  buffer = static_cast<uint8_t *>(malloc(stride * h));
  if (!buffer) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = buffer + size_t(cinfo.output_scanline) * stride;
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out = buffer;
  *width = w;
  *height = h;
  return 0;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng) — any color type normalized to RGB8
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t *data;
  size_t len;
  size_t offset;
};

static void png_read_fn(png_structp png, png_bytep out, png_size_t count) {
  PngReadState *st = static_cast<PngReadState *>(png_get_io_ptr(png));
  if (st->offset + count > st->len) {
    png_error(png, "read past end");
    return;
  }
  memcpy(out, st->data + st->offset, count);
  st->offset += count;
}

static int decode_png(const uint8_t *data, size_t len, uint8_t **out,
                      int *width, int *height) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return -2;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -3;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -3;
  }
  uint8_t *volatile buffer = nullptr;
  png_bytep *volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(buffer);
    free(rows);
    return -1;
  }
  PngReadState st = {data, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  // normalize to 8-bit RGB
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  if (1ULL * w * h > ICSTPU_MAX_PIXELS) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;  // decompression-bomb guard (see ICSTPU_MAX_PIXELS)
  }
  size_t stride = size_t(w) * 3;
  buffer = static_cast<uint8_t *>(malloc(stride * h));
  rows = static_cast<png_bytep *>(malloc(sizeof(png_bytep) * h));
  if (!buffer || !rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    free(buffer);
    free(rows);
    return -3;
  }
  for (png_uint_32 y = 0; y < h; y++) rows[y] = buffer + size_t(y) * stride;
  png_read_image(png, rows);
  png_destroy_read_struct(&png, &info, nullptr);
  free(rows);
  *out = buffer;
  *width = int(w);
  *height = int(h);
  return 0;
}

// ---------------------------------------------------------------------------
// Public API
// ---------------------------------------------------------------------------

// kind: 1 = JPEG, 2 = PNG, 0 = unknown
int icstpu_probe(const uint8_t *data, size_t len) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
    return 1;
  if (len >= 8 && !png_sig_cmp(data, 0, 8)) return 2;
  return 0;
}

// Returns 0 on success; *out is malloc'd RGB8 (h*w*3), caller frees via
// icstpu_free.
int icstpu_decode(const uint8_t *data, size_t len, uint8_t **out, int *width,
                  int *height) {
  switch (icstpu_probe(data, len)) {
    case 1:
      return decode_jpeg(data, len, out, width, height);
    case 2:
      return decode_png(data, len, out, width, height);
    default:
      return -2;
  }
}

void icstpu_free(uint8_t *p) { free(p); }

}  // extern "C"
