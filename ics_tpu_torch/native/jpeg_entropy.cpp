// ics_tpu_torch JPEG entropy decoder: quantized DCT coefficients and
// quantization tables out of a JPEG file, with no libjpeg.
//
// It computes what libjpeg-turbo's jpeg_read_coefficients() computes for
// the files it serves, and writes the same buffer as the libjpeg shim did:
// a CoeffHeader (coeff_header.h) followed by one int16 plane per component,
// [height_in_blocks][width_in_blocks][64] in natural order. Covered (ITU-T
// T.81): SOF0/SOF1/SOF2 at 8-bit precision with 1 to 4 components and
// sampling factors 1 to 4; DQT (8- and 16-bit entries), DHT, DRI; several
// scans per frame, interleaved (dummy blocks decoded and dropped) or not;
// progressive DC/AC first and refinement scans; restart intervals. Files
// that libjpeg would decode with other machinery (lossless, hierarchical,
// arithmetic coding, 12-bit samples) are declined.
//
// Damaged streams follow libjpeg-turbo (jdhuff.c, jdphuff.c, jdmarker.c,
// jdatasrc.c): the input behaves as if followed by endless FF D9 (a fake
// EOI, as jpeg_mem_src supplies); the MCU that runs into a marker or the
// end is finished on zero bits, and every later MCU of that restart
// segment is left zero. Every read is bounds-checked; no input can make
// the decoder read or write outside its buffers.
//
// C ABI for ctypes: icstpu_jpeg_entropy() / icstpu_entropy_free().

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>

#include "coeff_header.h"

namespace {

// decompression-bomb guard, the same figure as the libjpeg shim's
constexpr unsigned long long kMaxPixels = 178956970ULL;
constexpr int kMaxDimension = 65500;   // JPEG_MAX_DIMENSION
constexpr int kMaxBlocksInMcu = 10;    // D_MAX_BLOCKS_IN_MCU
constexpr int kLook = 9;               // Huffman look-ahead bits
constexpr int kMinGetBits = 57;        // bits the buffer is filled to

enum : int { kOk = 0, kMalformed = -1, kDeclined = -2, kAlloc = -5, kTooLarge = -6 };

struct Failure {
  int rc;
};
[[noreturn]] void fail(int rc = kMalformed) { throw Failure{rc}; }

// zigzag -> natural order, with 16 extra entries so that a corrupt run
// length (k up to 63 + 15) lands on coefficient 63, as in libjpeg
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Annex K.3 tables, which libjpeg puts in empty slots 0 and 1 for
// streams that carry no DHT (motion-JPEG frames)
const uint8_t kStdDcBits[2][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcBits[2][17] = {
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
     0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
     0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
     0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
     0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
     0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
     0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
     0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
     0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
     0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
     0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
     0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
     0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
     0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
     0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
     0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
     0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
     0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
     0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// The input, read past its end as FF D9 FF D9 ... (jpeg_mem_src's fake EOI).
struct Source {
  const uint8_t *data;
  size_t len;
  size_t pos;
  int byte() {
    size_t p = pos++;
    if (p < len) return data[p];
    return ((p - len) & 1) ? 0xD9 : 0xFF;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    if (n > 0) pos += size_t(n);
  }
};

struct HuffSpec {  // a table as a DHT segment gives it
  bool present = false;
  uint8_t bits[17];
  uint8_t vals[256];
};

struct Huff {  // the decoding form (libjpeg's d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol; 0 = a longer code
  // AC codes whose code and magnitude bits fit the look-ahead together:
  // (value << 8) | (run << 4) | bits taken; 0 = take the general path
  int16_t fast_ac[1 << kLook];
};

void derive(const HuffSpec &spec, bool dc, Huff *t) {
  if (!spec.present) fail();
  char size[257];
  int32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = spec.bits[l];
    if (p + n > 256) fail();
    while (n--) size[p++] = char(l);
  }
  size[p] = 0;
  int nsym = p;
  int32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code_of[p++] = code;
      code++;
    }
    if (code >= (int32_t(1) << si)) fail();  // a code of all ones
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (spec.bits[l]) {
      t->valoffset[l] = p - code_of[p];
      p += spec.bits[l];
      t->maxcode[l] = code_of[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;  // sentinel: ends the slow decode loop
  memcpy(t->vals, spec.vals, sizeof(t->vals));
  memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= kLook; l++) {
    for (int i = 1; i <= spec.bits[l]; i++, p++) {
      int first = code_of[p] << (kLook - l);
      for (int ctr = 0; ctr < (1 << (kLook - l)); ctr++)
        t->look[first + ctr] = uint16_t((l << 8) | spec.vals[p]);
    }
  }
  memset(t->fast_ac, 0, sizeof(t->fast_ac));
  for (int i = 0; i < (1 << kLook); i++) {
    int e = t->look[i];
    if (!e) continue;
    int len = e >> 8, run = (e & 0xFF) >> 4, size = e & 15;
    if (size == 0 || len + size > kLook) continue;
    int r = (i >> (kLook - len - size)) & ((1 << size) - 1);
    int v = r < (1 << (size - 1)) ? r - (1 << size) + 1 : r;
    if (v >= -128 && v <= 127) t->fast_ac[i] = int16_t(v * 256 + run * 16 + len + size);
  }
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (spec.vals[i] > 15) fail();
}

struct Component {
  int id, h, v, tq;
  int bw, bh;  // size in blocks
  int16_t *coeffs;
  bool latched;
  uint16_t quant[64];
};

class Decoder {
 public:
  Decoder(const uint8_t *data, size_t len) : src_{data, len, 0} {}
  ~Decoder() { free(out_); }
  int run(uint8_t **out, size_t *out_len);

 private:
  // markers (jdmarker.c)
  void next_marker();
  void read_sof(bool progressive);
  void read_dqt();
  void read_dht();
  void read_dri();
  void read_sos();
  void start_image();
  // entropy-coded data (jdhuff.c, jdphuff.c)
  void fill(int nbits);
  int bits(int n) {
    if (left_ < n) fill(n);
    left_ -= n;
    return int((buf_ >> left_) & ((uint64_t(1) << n) - 1));
  }
  int decode(const Huff &t);
  void restart();
  void resync(int desired);
  void decode_scan();
  void mcu_baseline(int16_t **blocks, int nblocks);
  void mcu_dc_first(int16_t **blocks, int nblocks);
  void mcu_dc_refine(int16_t **blocks, int nblocks);
  void mcu_ac_first(int16_t *block);
  void mcu_ac_refine(int16_t *block);

  Source src_;
  int marker_ = 0;  // libjpeg's unread_marker
  bool saw_sof_ = false, started_ = false, multi_scan_ = false, progressive_ = false;
  int width_ = 0, height_ = 0, ncomp_ = 0, max_h_ = 1, max_v_ = 1;
  Component comp_[4];
  bool qt_present_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  HuffSpec dc_spec_[4], ac_spec_[4];
  Huff dc_[4], ac_[4];
  int restart_interval_ = 0;
  // the current scan
  int scan_n_ = 0, scan_comp_[4], scan_dc_[4], scan_ac_[4];
  int block_comp_[kMaxBlocksInMcu];  // each MCU block's place in the scan
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int next_restart_ = 0, restarts_to_go_ = 0;
  int last_dc_[4];
  unsigned eobrun_ = 0;
  bool insufficient_ = false;
  uint64_t buf_ = 0;
  int left_ = 0;
  uint8_t *out_ = nullptr;
  size_t out_len_ = 0;
};

void Decoder::next_marker() {
  for (;;) {
    int c = src_.byte();
    while (c != 0xFF) c = src_.byte();  // skip non-FF bytes
    do c = src_.byte(); while (c == 0xFF);
    if (c != 0) {
      marker_ = c;
      return;
    }
    // FF 00: stuffed data, keep looking
  }
}

void Decoder::read_sof(bool progressive) {
  long length = src_.u16();
  int precision = src_.byte();
  height_ = src_.u16();
  width_ = src_.u16();
  ncomp_ = src_.byte();
  length -= 8;
  if (saw_sof_) fail();
  if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) fail();
  if (length != ncomp_ * 3) fail();
  if (ncomp_ > 4) fail();
  for (int c = 0; c < ncomp_; c++) {
    Component &cp = comp_[c];
    cp.id = src_.byte();
    int hv = src_.byte();
    cp.h = (hv >> 4) & 15;
    cp.v = hv & 15;
    cp.tq = src_.byte();
    cp.coeffs = nullptr;
    cp.latched = false;
  }
  if (precision != 8) fail(kDeclined);
  saw_sof_ = true;
  progressive_ = progressive;
}

void Decoder::read_dqt() {
  long length = src_.u16() - 2;
  while (length > 0) {
    length--;
    int n = src_.byte();
    int prec = n >> 4;
    n &= 15;
    if (n >= 4) fail();
    for (int i = 0; i < 64; i++)
      qt_[n][kNatural[i]] = uint16_t(prec ? src_.u16() : src_.byte());
    qt_present_[n] = true;
    length -= prec ? 128 : 64;
  }
  if (length != 0) fail();
}

void Decoder::read_dht() {
  long length = src_.u16() - 2;
  while (length > 16) {
    int index = src_.byte();
    uint8_t counts[17];
    counts[0] = 0;
    int count = 0;
    for (int i = 1; i <= 16; i++) {
      counts[i] = uint8_t(src_.byte());
      count += counts[i];
    }
    length -= 17;
    if (count > 256 || count > length) fail();
    uint8_t vals[256];
    memset(vals, 0, sizeof(vals));
    for (int i = 0; i < count; i++) vals[i] = uint8_t(src_.byte());
    length -= count;
    HuffSpec *spec;
    if (index & 0x10) {
      index -= 0x10;
      if (index >= 4) fail();
      spec = &ac_spec_[index];
    } else {
      if (index >= 4) fail();
      spec = &dc_spec_[index];
    }
    memcpy(spec->bits, counts, sizeof(counts));
    memcpy(spec->vals, vals, sizeof(vals));
    spec->present = true;
  }
  if (length != 0) fail();
}

void Decoder::read_dri() {
  if (src_.u16() != 4) fail();
  restart_interval_ = src_.u16();
}

void Decoder::read_sos() {
  if (!saw_sof_) fail();
  int length = src_.u16();
  int n = src_.byte();
  if (length != n * 2 + 6 || n < 1 || n > 4) fail();
  scan_n_ = n;
  bool used[4] = {false, false, false, false};
  for (int i = 0; i < n; i++) {
    int cc = src_.byte();
    int c = src_.byte();
    int found = -1;
    for (int k = 0; k < ncomp_; k++)
      if (comp_[k].id == cc && !used[k]) {
        found = k;
        break;
      }
    if (found < 0) fail();
    used[found] = true;
    scan_comp_[i] = found;
    scan_dc_[i] = (c >> 4) & 15;
    scan_ac_[i] = c & 15;
  }
  ss_ = src_.byte();
  se_ = src_.byte();
  int a = src_.byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_restart_ = 0;
}

// jdinput.c initial_setup, the shim's pixel cap, and the output buffer
void Decoder::start_image() {
  if (width_ > kMaxDimension || height_ > kMaxDimension) fail();
  max_h_ = max_v_ = 1;
  for (int c = 0; c < ncomp_; c++) {
    const Component &cp = comp_[c];
    if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4) fail();
    if (cp.h > max_h_) max_h_ = cp.h;
    if (cp.v > max_v_) max_v_ = cp.v;
  }
  if (1ULL * width_ * height_ > kMaxPixels) fail(kTooLarge);
  size_t total = sizeof(CoeffHeader);
  for (int c = 0; c < ncomp_; c++) {
    Component &cp = comp_[c];
    cp.bw = int((long(width_) * cp.h + 8L * max_h_ - 1) / (8L * max_h_));
    cp.bh = int((long(height_) * cp.v + 8L * max_v_ - 1) / (8L * max_v_));
    total += size_t(cp.bw) * cp.bh * 64 * sizeof(int16_t);
  }
  out_ = static_cast<uint8_t *>(calloc(total, 1));
  if (!out_) fail(kAlloc);
  out_len_ = total;
  uint8_t *cursor = out_ + sizeof(CoeffHeader);
  for (int c = 0; c < ncomp_; c++) {
    comp_[c].coeffs = reinterpret_cast<int16_t *>(cursor);
    cursor += size_t(comp_[c].bw) * comp_[c].bh * 64 * sizeof(int16_t);
  }
  // jinit_huff_decoder: empty slots 0 and 1 take the standard tables
  for (int t = 0; t < 2; t++) {
    if (!dc_spec_[t].present) {
      memcpy(dc_spec_[t].bits, kStdDcBits[t], 17);
      memset(dc_spec_[t].vals, 0, 256);
      for (int i = 0; i < 12; i++) dc_spec_[t].vals[i] = uint8_t(i);
      dc_spec_[t].present = true;
    }
    if (!ac_spec_[t].present) {
      memcpy(ac_spec_[t].bits, kStdAcBits[t], 17);
      memset(ac_spec_[t].vals, 0, 256);
      memcpy(ac_spec_[t].vals, kStdAcVals[t], 162);
      ac_spec_[t].present = true;
    }
  }
}

// jdhuff.c jpeg_fill_bit_buffer: never reads past a marker; once one is
// met, bits that are really needed come as zeros and the flag is raised
void Decoder::fill(int nbits) {
  if (marker_ == 0) {
    while (left_ < kMinGetBits) {
      int c = src_.byte();
      if (c == 0xFF) {
        do c = src_.byte(); while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker_ = c;
          break;
        }
      }
      buf_ = (buf_ << 8) | uint64_t(c);
      left_ += 8;
    }
    if (marker_ == 0) return;
  }
  if (nbits > left_) {
    insufficient_ = true;
    buf_ <<= (kMinGetBits - left_);
    left_ = kMinGetBits;
  }
}

int Decoder::decode(const Huff &t) {
  int l = 1;
  if (left_ < kLook) fill(0);
  if (left_ >= kLook) {
    int e = t.look[(buf_ >> (left_ - kLook)) & ((1 << kLook) - 1)];
    if (e) {
      left_ -= e >> 8;
      return e & 0xFF;
    }
    l = kLook + 1;
  }
  int32_t code = bits(l);
  while (code > t.maxcode[l]) {
    code = (code << 1) | bits(1);
    l++;
  }
  if (l > 16) return 0;  // corrupt data: libjpeg fakes a zero
  return t.vals[(t.valoffset[l] + code) & 0xFF];
}

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// jdmarker.c jpeg_resync_to_restart
void Decoder::resync(int desired) {
  int m = marker_;
  for (;;) {
    int action;
    if (m < 0xC0)
      action = 2;
    else if (m < 0xD0 || m > 0xD7)
      action = 3;
    else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
      action = 3;
    else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
      action = 2;
    else
      action = 1;
    if (action == 1) {
      marker_ = 0;  // take it as the expected marker
      return;
    }
    if (action == 3) return;  // leave it: the segment decodes as empty
    next_marker();
    m = marker_;
  }
}

// process_restart of jdhuff.c and jdphuff.c
void Decoder::restart() {
  left_ = 0;
  if (marker_ == 0) next_marker();
  if (marker_ == 0xD0 + next_restart_)
    marker_ = 0;
  else
    resync(next_restart_);
  next_restart_ = (next_restart_ + 1) & 7;
  for (int i = 0; i < 4; i++) last_dc_[i] = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  if (marker_ == 0) insufficient_ = false;
}

void Decoder::mcu_baseline(int16_t **blocks, int nblocks) {
  if (insufficient_) return;  // out of data: the rest of the segment stays zero
  for (int b = 0; b < nblocks; b++) {
    int ci = block_comp_[b];
    int16_t *block = blocks[b];
    int s = decode(dc_[scan_dc_[ci]]);
    if (s) s = extend(bits(s), s);
    last_dc_[ci] = int(unsigned(last_dc_[ci]) + unsigned(s));
    block[0] = int16_t(last_dc_[ci]);
    const Huff &ac = ac_[scan_ac_[ci]];
    for (int k = 1; k < 64; k++) {
      if (left_ < kLook) fill(0);
      if (left_ >= kLook) {  // the common case: code and value in one look-up
        int c = ac.fast_ac[(buf_ >> (left_ - kLook)) & ((1 << kLook) - 1)];
        if (c) {
          k += (c >> 4) & 15;
          left_ -= c & 15;
          block[kNatural[k]] = int16_t(c >> 8);
          continue;
        }
      }
      s = decode(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        block[kNatural[k]] = int16_t(extend(bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }
}

void Decoder::mcu_dc_first(int16_t **blocks, int nblocks) {
  if (insufficient_) return;
  for (int b = 0; b < nblocks; b++) {
    int ci = block_comp_[b];
    int s = decode(dc_[scan_dc_[ci]]);
    if (s) s = extend(bits(s), s);
    long sum = long(last_dc_[ci]) + s;
    if (sum > INT32_MAX || sum < INT32_MIN) fail();
    last_dc_[ci] = int(sum);
    blocks[b][0] = int16_t(unsigned(sum) << al_);
  }
}

void Decoder::mcu_dc_refine(int16_t **blocks, int nblocks) {
  // no flag check: zero bits change nothing
  for (int b = 0; b < nblocks; b++)
    if (bits(1)) blocks[b][0] = int16_t(blocks[b][0] | (1 << al_));
}

void Decoder::mcu_ac_first(int16_t *block) {
  if (insufficient_) return;
  if (eobrun_ > 0) {
    eobrun_--;
    return;
  }
  const Huff &t = ac_[scan_ac_[0]];
  for (int k = ss_; k <= se_; k++) {
    int s = decode(t);
    int r = s >> 4;
    s &= 15;
    if (s) {
      k += r;
      block[kNatural[k]] = int16_t(unsigned(extend(bits(s), s)) << al_);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun_ = 1u << r;
      if (r) eobrun_ += unsigned(bits(r));
      eobrun_--;
      break;
    }
  }
}

void Decoder::mcu_ac_refine(int16_t *block) {
  if (insufficient_) return;
  const int p1 = 1 << al_;
  const int m1 = -1 * (1 << al_);
  const Huff &t = ac_[scan_ac_[0]];
  int k = ss_;
  if (eobrun_ == 0) {
    for (; k <= se_; k++) {
      int s = decode(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        s = bits(1) ? p1 : m1;  // a newly nonzero coefficient (size 1)
      } else if (r != 15) {
        eobrun_ = 1u << r;
        if (r) eobrun_ += unsigned(bits(r));
        break;
      }
      // pass r zero coefficients, appending correction bits to the nonzero
      do {
        int16_t *coef = block + kNatural[k];
        if (*coef != 0) {
          if (bits(1) && (*coef & p1) == 0)
            *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= se_);
      if (s) block[kNatural[k]] = int16_t(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; k++) {
      int16_t *coef = block + kNatural[k];
      if (*coef != 0 && bits(1) && (*coef & p1) == 0)
        *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    eobrun_--;
  }
}

void Decoder::decode_scan() {
  // jdphuff.c start_pass_phuff_decoder's checks of the scan's parameters
  bool dc_band = ss_ == 0;
  if (progressive_) {
    bool bad = dc_band ? se_ != 0 : (ss_ > se_ || se_ > 63 || scan_n_ != 1);
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) fail();
  }
  // jdinput.c per_scan_setup: the MCU's blocks and the scan's MCU grid
  struct Slot {
    int s, dy, dx;
  } slots[kMaxBlocksInMcu];
  int nblocks = 0, mcus_x, mcus_y;
  if (scan_n_ == 1) {
    const Component &cp = comp_[scan_comp_[0]];
    mcus_x = cp.bw;
    mcus_y = cp.bh;
    slots[nblocks++] = {0, 0, 0};
  } else {
    mcus_x = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (int s = 0; s < scan_n_; s++) {
      const Component &cp = comp_[scan_comp_[s]];
      if (nblocks + cp.h * cp.v > kMaxBlocksInMcu) fail();
      for (int dy = 0; dy < cp.v; dy++)
        for (int dx = 0; dx < cp.h; dx++) slots[nblocks++] = {s, dy, dx};
    }
  }
  // jdinput.c latch_quant_tables
  for (int s = 0; s < scan_n_; s++) {
    Component &cp = comp_[scan_comp_[s]];
    if (cp.latched) continue;
    if (cp.tq >= 4 || !qt_present_[cp.tq]) fail();
    memcpy(cp.quant, qt_[cp.tq], sizeof(cp.quant));
    cp.latched = true;
  }
  // the entropy decoder's start_pass: tables, predictors, bit buffer
  for (int s = 0; s < scan_n_; s++) {
    if (progressive_) {
      if (dc_band) {
        if (ah_ == 0) {
          if (scan_dc_[s] >= 4) fail();
          derive(dc_spec_[scan_dc_[s]], true, &dc_[scan_dc_[s]]);
        }
      } else {
        if (scan_ac_[s] >= 4) fail();
        derive(ac_spec_[scan_ac_[s]], false, &ac_[scan_ac_[s]]);
      }
    } else {
      if (scan_dc_[s] >= 4 || scan_ac_[s] >= 4) fail();
      derive(dc_spec_[scan_dc_[s]], true, &dc_[scan_dc_[s]]);
      derive(ac_spec_[scan_ac_[s]], false, &ac_[scan_ac_[s]]);
    }
  }
  for (int i = 0; i < 4; i++) last_dc_[i] = 0;
  eobrun_ = 0;
  insufficient_ = false;
  buf_ = 0;
  left_ = 0;
  restarts_to_go_ = restart_interval_;

  alignas(16) int16_t scratch[kMaxBlocksInMcu][64];
  int16_t *blocks[kMaxBlocksInMcu];
  for (int b = 0; b < nblocks; b++) block_comp_[b] = slots[b].s;
  for (int my = 0; my < mcus_y; my++) {
    for (int mx = 0; mx < mcus_x; mx++) {
      if (restart_interval_ && restarts_to_go_ == 0) restart();
      for (int b = 0; b < nblocks; b++) {
        const Component &cp = comp_[scan_comp_[slots[b].s]];
        int row = scan_n_ == 1 ? my : my * cp.v + slots[b].dy;
        int col = scan_n_ == 1 ? mx : mx * cp.h + slots[b].dx;
        if (row < cp.bh && col < cp.bw) {
          blocks[b] = cp.coeffs + (size_t(row) * cp.bw + col) * 64;
        } else {  // a dummy block of an interleaved MCU: decoded, dropped
          memset(scratch[b], 0, sizeof(scratch[b]));
          blocks[b] = scratch[b];
        }
      }
      if (!progressive_)
        mcu_baseline(blocks, nblocks);
      else if (dc_band)
        (ah_ == 0 ? mcu_dc_first(blocks, nblocks) : mcu_dc_refine(blocks, nblocks));
      else
        (ah_ == 0 ? mcu_ac_first(blocks[0]) : mcu_ac_refine(blocks[0]));
      if (restart_interval_) restarts_to_go_--;
    }
  }
  left_ = 0;  // the rest of the bit buffer is dropped at the scan's end
}

int Decoder::run(uint8_t **out, size_t *out_len) {
  if (src_.byte() != 0xFF || src_.byte() != 0xD8) fail();  // SOI first
  for (;;) {
    if (marker_ == 0) next_marker();
    int m = marker_;
    marker_ = 0;
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_sof(false);
        break;
      case 0xC2:
        read_sof(true);
        break;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail(kDeclined);  // lossless, hierarchical or arithmetic-coded
      case 0xC4:
        read_dht();
        break;
      case 0xDB:
        read_dqt();
        break;
      case 0xDD:
        read_dri();
        break;
      case 0xDA: {
        read_sos();
        if (!started_) {
          start_image();
          started_ = true;
          multi_scan_ = scan_n_ < ncomp_ || progressive_;
        } else if (!multi_scan_) {
          fail();
        }
        decode_scan();
        break;
      }
      case 0xD9: {  // EOI
        if (!started_) fail();
        CoeffHeader hdr;
        memset(&hdr, 0, sizeof(hdr));
        hdr.num_components = ncomp_;
        hdr.width = width_;
        hdr.height = height_;
        for (int c = 0; c < ncomp_; c++) {
          const Component &cp = comp_[c];
          hdr.comp[c][0] = cp.bw;
          hdr.comp[c][1] = cp.bh;
          hdr.comp[c][2] = cp.h;
          hdr.comp[c][3] = cp.v;
          if (cp.latched) {
            memcpy(hdr.quant[c], cp.quant, sizeof(cp.quant));
          } else {  // never scanned: the table its number names at the end
            if (cp.tq >= 4 || !qt_present_[cp.tq]) fail();
            memcpy(hdr.quant[c], qt_[cp.tq], sizeof(hdr.quant[c]));
          }
        }
        memcpy(out_, &hdr, sizeof(hdr));
        *out = out_;
        *out_len = out_len_;
        out_ = nullptr;
        return kOk;
      }
      case 0xD8:  // a second SOI
        fail();
      case 0xCC:  // DAC, DNL, APPn, COM: skipped
      case 0xDC:
      case 0xE0: case 0xE1: case 0xE2: case 0xE3: case 0xE4: case 0xE5: case 0xE6:
      case 0xE7: case 0xE8: case 0xE9: case 0xEA: case 0xEB: case 0xEC: case 0xED:
      case 0xEE: case 0xEF: case 0xFE:
        src_.skip(long(src_.u16()) - 2);
        break;
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6:
      case 0xD7: case 0x01:
        break;  // a stray RSTn or TEM: nothing to do
      default:
        fail();
    }
  }
}

}  // namespace

extern "C" {

// Returns 0 on success; *out receives a malloc'd buffer laid out as
//   [CoeffHeader][comp0 coeffs int16 (blocks_h*blocks_w*64)][comp1 ...]
// which the caller frees with icstpu_entropy_free. Nonzero: -1 malformed,
// -2 declined (another coding process or precision), -5 out of memory,
// -6 past the pixel cap.
int icstpu_jpeg_entropy(const uint8_t *data, size_t len, uint8_t **out, size_t *out_len) {
  try {
    Decoder dec(data, len);  // its destructor frees the buffer on a failure
    return dec.run(out, out_len);
  } catch (const Failure &f) {
    return f.rc;
  } catch (const std::bad_alloc &) {
    return kAlloc;
  }
}

void icstpu_entropy_free(uint8_t *p) { free(p); }

}  // extern "C"
