// Restart-marker parallel JPEG entropy decode.
//
// Huffman entropy decoding is the irreducibly serial part of JPEG — except
// when the encoder emitted restart markers (DRI > 0): DC predictors reset
// and the bitstream re-aligns at every RSTn, so the runs of segments
// between markers are independently decodable. This module parses the
// marker structure, splits the scan at RSTn boundaries, groups contiguous
// segments into chunks, and decodes every chunk WITH LIBJPEG ITSELF: each
// chunk is wrapped into a synthesized in-memory JPEG (original header
// bytes with the SOF dimensions patched to a single MCU row of the chunk's
// MCU count, RSTn sequence renumbered from zero, EOI appended) and fed to
// jpeg_read_coefficients on a worker thread; the decoded blocks are then
// scattered into the real component planes by global MCU index.
//
// Why wrap libjpeg instead of a from-scratch Huffman decoder (the round-2
// design): the hand-written bit reader cost 1.3-1.6x libjpeg's summed CPU
// per byte depending on content (worst on dense/noisy scans —
// docs/benchmarks.md), so threading traded total CPU for latency. With
// per-chunk libjpeg the summed CPU tracks the serial path on ANY content
// (the only overhead is one header re-parse + a chunk memcpy per chunk),
// wall-clock divides by the worker count, and byte-identical parity with
// icstpu_jpeg_coeffs is inherited from the decoder itself.
//
// Output buffer layout is BYTE-IDENTICAL to icstpu_jpeg_coeffs
// (imgcodec.cpp): [CoeffHeader][per-component int16 planes, natural order].
//
// Scope: baseline/extended-sequential Huffman (SOF0/SOF1), 8-bit, 1 or 3
// components, one scan, DRI > 0, >= 2 segments. Anything else returns 1
// and the caller falls back to the serial path.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>

#include "coeff_header.h"

namespace {

// zigzag (stream) index -> natural (row-major) index, per the JPEG spec;
// quant tables are stored in natural order to match libjpeg's
// jpeg_read_coefficients output exactly.
const uint8_t kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// DHT validation only (the actual decode is libjpeg's): reject
// oversubscribed tables before spawning threads.
bool check_huff(const uint8_t counts[17], int nsym) {
  if (nsym == 0 || nsym > 256) return false;
  uint32_t code = 0;
  for (int l = 1; l <= 16; l++) {
    code += counts[l];
    if (code > (1u << l)) return false;
    code <<= 1;
  }
  return true;
}

// mirrors CoeffHeader in imgcodec.cpp — layouts must stay byte-identical

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width_in_blocks = 0, height_in_blocks = 0;
};

struct Parsed {
  int width = 0, height = 0, ncomp = 0;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  int restart_interval = 0;
  const uint8_t *scan_start = nullptr;
  size_t sof_payload_off = 0;  // offset of the SOF segment payload in data
};

static inline int rdiv_up(long a, long b) { return int((a + b - 1) / b); }

// returns 0 ok, 1 not-eligible (caller: serial fallback), <0 malformed
int parse_headers(const uint8_t *data, size_t len, Parsed *out) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) return -2;
  size_t pos = 2;
  bool have_sof = false;
  while (pos + 4 <= len) {
    if (data[pos] != 0xFF) return -2;
    uint8_t m = data[pos + 1];
    if (m == 0xFF) {          // fill byte
      pos++;
      continue;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {  // standalone markers
      pos += 2;
      continue;
    }
    size_t seglen = (size_t(data[pos + 2]) << 8) | data[pos + 3];
    if (seglen < 2 || pos + 2 + seglen > len) return -2;
    const uint8_t *seg = data + pos + 4;
    size_t body = seglen - 2;
    switch (m) {
      case 0xC0:              // SOF0 baseline
      case 0xC1: {            // SOF1 extended sequential (same entropy form)
        if (body < 6) return -2;
        int precision = seg[0];
        out->height = (seg[1] << 8) | seg[2];
        out->width = (seg[3] << 8) | seg[4];
        out->ncomp = seg[5];
        out->sof_payload_off = size_t(seg - data);
        if (precision != 8) return 1;
        if (out->ncomp != 1 && out->ncomp != 3) return 1;
        if (body < size_t(6 + 3 * out->ncomp)) return -2;
        for (int c = 0; c < out->ncomp; c++) {
          const uint8_t *cs = seg + 6 + 3 * c;
          out->comp[c].id = cs[0];
          out->comp[c].h = cs[1] >> 4;
          out->comp[c].v = cs[1] & 15;
          out->comp[c].tq = cs[2];
          if (out->comp[c].h < 1 || out->comp[c].h > 4 ||
              out->comp[c].v < 1 || out->comp[c].v > 4 ||
              out->comp[c].tq > 3)
            return 1;
        }
        have_sof = true;
        break;
      }
      case 0xC2:              // progressive
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return 1;             // non-sequential-Huffman SOF: serial path
      case 0xC4: {            // DHT (possibly several tables)
        size_t off = 0;
        while (off + 17 <= body) {
          int tc = seg[off] >> 4, th = seg[off] & 15;
          if (tc > 1 || th > 3) return 1;
          uint8_t counts[17] = {0};
          int nsym = 0;
          for (int l = 1; l <= 16; l++) {
            counts[l] = seg[off + l];
            nsym += counts[l];
          }
          if (off + 17 + nsym > body || !check_huff(counts, nsym)) return -2;
          off += 17 + nsym;
        }
        break;
      }
      case 0xDB: {            // DQT (possibly several tables)
        size_t off = 0;
        while (off < body) {
          int pq = seg[off] >> 4, tq = seg[off] & 15;
          if (tq > 3 || pq > 1) return -2;
          size_t n = pq ? 128 : 64;
          if (off + 1 + n > body) return -2;
          for (int i = 0; i < 64; i++) {
            uint16_t v = pq ? ((seg[off + 1 + 2 * i] << 8) |
                               seg[off + 2 + 2 * i])
                            : seg[off + 1 + i];
            out->qt[tq][kNaturalOrder[i]] = v;  // store natural (libjpeg)
          }
          out->qt_present[tq] = true;
          off += 1 + n;
        }
        break;
      }
      case 0xDD:              // DRI
        if (body < 2) return -2;
        out->restart_interval = (seg[0] << 8) | seg[1];
        break;
      case 0xDA: {            // SOS
        if (!have_sof) return -2;
        if (body < 1) return -2;
        int ns = seg[0];
        if (ns != out->ncomp) return 1;  // multi-scan: serial path
        if (body < size_t(1 + 2 * ns + 3)) return -2;
        for (int s = 0; s < ns; s++) {
          int cid = seg[1 + 2 * s];
          bool found = false;
          for (int c = 0; c < out->ncomp; c++)
            if (out->comp[c].id == cid) found = true;
          if (!found) return -2;
        }
        const uint8_t *tail = seg + 1 + 2 * ns;
        if (tail[0] != 0 || tail[1] != 63 || tail[2] != 0) return 1;
        out->scan_start = seg + body;
        return 0;
      }
      case 0xD9:              // EOI before SOS
        return -2;
      default:                // APPn / COM / others: skip
        break;
    }
    pos += 2 + seglen;
  }
  return -2;
}

// one run of contiguous restart segments decoded as one synthesized JPEG
struct ChunkTask {
  long first_seg;             // index into the segment-start table
  long nseg;
  long first_mcu;
  long mcu_count;
};

struct JpegErrorJmp {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void chunk_error_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErrorJmp *>(cinfo->err)->jb, 1);
}

// Decode one chunk via libjpeg and scatter its blocks into the real
// planes. header = original bytes [0, scan_start) — copied per call with
// the SOF dims patched to (chunk_mcus * hmax * 8) x (vmax * 8): one MCU
// row holding exactly the chunk's MCUs (MCU geometry only affects block
// PLACEMENT, never the entropy stream itself).
bool decode_chunk(const uint8_t *data, const Parsed &P,
                  const std::vector<const uint8_t *> &starts,
                  const uint8_t *scan_end, const ChunkTask &T,
                  long mcu_w, int hmax, int vmax, int16_t *planes[4],
                  std::vector<uint8_t> &scratch) {
  const size_t header_len = size_t(P.scan_start - data);
  const uint8_t *chunk_begin = starts[T.first_seg];
  const uint8_t *chunk_end =
      (size_t(T.first_seg + T.nseg) < starts.size())
          ? starts[T.first_seg + T.nseg] - 2  // strip the trailing RSTn
          : scan_end;
  scratch.clear();
  scratch.reserve(header_len + size_t(chunk_end - chunk_begin) + 2);
  scratch.insert(scratch.end(), data, data + header_len);
  // patch SOF height/width in the copy (payload: [prec][H][H][W][W]...)
  const size_t sof = P.sof_payload_off;
  const long syn_w = (P.ncomp == 1) ? T.mcu_count * 8
                                    : T.mcu_count * hmax * 8;
  const long syn_h = (P.ncomp == 1) ? 8 : vmax * 8;
  if (syn_w > 65500) return false;  // caller sizes chunks below this
  scratch[sof + 1] = uint8_t(syn_h >> 8);
  scratch[sof + 2] = uint8_t(syn_h & 0xFF);
  scratch[sof + 3] = uint8_t(syn_w >> 8);
  scratch[sof + 4] = uint8_t(syn_w & 0xFF);
  // copy the scan slice, renumbering the RSTn cycle from zero
  const size_t scan_off = scratch.size();
  scratch.insert(scratch.end(), chunk_begin, chunk_end);
  for (long s = 1; s < T.nseg; s++) {
    size_t marker = scan_off + size_t(starts[T.first_seg + s] - chunk_begin) - 2;
    if (scratch[marker] != 0xFF) return false;
    scratch[marker + 1] = uint8_t(0xD0 + ((s - 1) & 7));
  }
  scratch.push_back(0xFF);
  scratch.push_back(0xD9);  // EOI

  jpeg_decompress_struct cinfo;
  JpegErrorJmp jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = chunk_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, scratch.data(),
               static_cast<unsigned long>(scratch.size()));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jvirt_barray_ptr *barrays = jpeg_read_coefficients(&cinfo);
  if (!barrays || cinfo.num_components != P.ncomp) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // scatter: synthesized comp c is one MCU row [v_c rows x mcus*h_c cols]
  for (int c = 0; c < P.ncomp; c++) {
    jpeg_component_info *ci = &cinfo.comp_info[c];
    const Component &C = P.comp[c];
    const int h_c = (P.ncomp == 1) ? 1 : C.h;
    const int v_c = (P.ncomp == 1) ? 1 : C.v;
    if (long(ci->width_in_blocks) < T.mcu_count * h_c ||
        int(ci->height_in_blocks) < v_c) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    for (int by = 0; by < v_c; by++) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          reinterpret_cast<j_common_ptr>(&cinfo), barrays[c],
          JDIMENSION(by), 1, FALSE);
      for (long m = 0; m < T.mcu_count; m++) {
        const long g = T.first_mcu + m;
        const long my = g / mcu_w, mx = g % mcu_w;
        const long row = my * v_c + by;
        if (row >= C.height_in_blocks) continue;  // dummy MCU-pad rows
        for (int bx = 0; bx < h_c; bx++) {
          const long col = mx * h_c + bx;
          if (col >= C.width_in_blocks) continue;  // dummy MCU-pad cols
          memcpy(planes[c] + (row * C.width_in_blocks + col) * 64,
                 rows[0][m * h_c + bx], 64 * sizeof(int16_t));
        }
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

void icstpu_free(uint8_t *p);  // imgcodec.cpp

// Parallel coefficient extraction. Returns 0 on success (buffer layout
// identical to icstpu_jpeg_coeffs), 1 when the file isn't eligible for the
// restart-parallel path (caller should use the serial decoder), negative
// on malformed input.
int icstpu_jpeg_coeffs_mt(const uint8_t *data, size_t len, uint8_t **out,
                          size_t *out_len, int threads) {
  if (threads < 2) return 1;
  if (threads > 64) threads = 64;
  Parsed P;
  int rc = parse_headers(data, len, &P);
  if (rc != 0) return rc;
  if (P.restart_interval <= 0) return 1;
  if (P.width <= 0 || P.height <= 0) return -2;

  int hmax = 1, vmax = 1;
  for (int c = 0; c < P.ncomp; c++) {
    if (P.comp[c].h > hmax) hmax = P.comp[c].h;
    if (P.comp[c].v > vmax) vmax = P.comp[c].v;
    if (!P.qt_present[P.comp[c].tq]) return -2;
  }
  for (int c = 0; c < P.ncomp; c++) {
    P.comp[c].width_in_blocks =
        rdiv_up(long(P.width) * P.comp[c].h, long(hmax) * 8);
    P.comp[c].height_in_blocks =
        rdiv_up(long(P.height) * P.comp[c].v, long(vmax) * 8);
  }

  long mcu_w, mcu_h;
  if (P.ncomp == 1) {
    // single-component scan is non-interleaved: MCU = 1 block, sampling
    // factors ignored (ITU T.81 A.2.2); grid = the component's block grid
    mcu_w = P.comp[0].width_in_blocks;
    mcu_h = P.comp[0].height_in_blocks;
  } else {
    mcu_w = rdiv_up(P.width, hmax * 8);
    mcu_h = rdiv_up(P.height, vmax * 8);
  }
  const long total_mcus = mcu_w * mcu_h;
  const long nseg =
      (total_mcus + P.restart_interval - 1) / P.restart_interval;
  if (nseg < 2) return 1;     // nothing to parallelize

  // (the too-small-to-amortize-threads policy lives in the Python wrapper
  // — imgcodec.MT_MIN_BYTES — so the parity tests can exercise this path
  // on small images)
  const uint8_t *data_end = data + len;

  // split the entropy stream at RSTn markers
  std::vector<const uint8_t *> starts;
  starts.push_back(P.scan_start);
  const uint8_t *pend = data_end;
  const uint8_t *p = P.scan_start;
  while (p + 1 < pend) {
    if (p[0] != 0xFF) {
      p++;
      continue;
    }
    uint8_t m = p[1];
    if (m == 0x00) {
      p += 2;                 // stuffed byte
    } else if (m == 0xFF) {
      p++;                    // fill byte
    } else if (m >= 0xD0 && m <= 0xD7) {
      starts.push_back(p + 2);
      p += 2;
    } else {
      pend = p;               // EOI / next marker: end of scan
      break;
    }
  }
  if (long(starts.size()) != nseg) return 1;  // marker count mismatch

  size_t total = sizeof(CoeffHeader);
  for (int c = 0; c < P.ncomp; c++)
    total += size_t(P.comp[c].width_in_blocks) * P.comp[c].height_in_blocks *
             64 * sizeof(int16_t);
  uint8_t *buffer = static_cast<uint8_t *>(calloc(1, total));
  if (!buffer) return -5;
  CoeffHeader hdr;
  memset(&hdr, 0, sizeof(hdr));
  hdr.num_components = P.ncomp;
  hdr.width = P.width;
  hdr.height = P.height;
  int16_t *planes[4] = {nullptr, nullptr, nullptr, nullptr};
  uint8_t *cursor = buffer + sizeof(hdr);
  for (int c = 0; c < P.ncomp; c++) {
    hdr.comp[c][0] = P.comp[c].width_in_blocks;
    hdr.comp[c][1] = P.comp[c].height_in_blocks;
    hdr.comp[c][2] = P.comp[c].h;
    hdr.comp[c][3] = P.comp[c].v;
    memcpy(hdr.quant[c], P.qt[P.comp[c].tq], sizeof(hdr.quant[c]));
    planes[c] = reinterpret_cast<int16_t *>(cursor);
    cursor += size_t(P.comp[c].width_in_blocks) * P.comp[c].height_in_blocks *
              64 * sizeof(int16_t);
  }
  memcpy(buffer, &hdr, sizeof(hdr));

  // chunking: contiguous segment runs, capped so the synthesized single
  // MCU row stays under JPEG's 65500-px width, targeting ~2 chunks per
  // worker for load balance on skewed content
  const long mcu_px = (P.ncomp == 1) ? 8 : hmax * 8;
  const long max_mcus_per_chunk = 65500 / mcu_px;
  const long max_segs_by_width =
      (max_mcus_per_chunk >= P.restart_interval)
          ? max_mcus_per_chunk / P.restart_interval
          : 0;
  if (max_segs_by_width < 1) return 1;  // absurd DRI: serial path
  long segs_per_chunk = (nseg + threads * 2 - 1) / (threads * 2);
  if (segs_per_chunk < 1) segs_per_chunk = 1;
  if (segs_per_chunk > max_segs_by_width) segs_per_chunk = max_segs_by_width;

  std::vector<ChunkTask> tasks;
  for (long s = 0; s < nseg; s += segs_per_chunk) {
    ChunkTask t;
    t.first_seg = s;
    t.nseg = std::min<long>(segs_per_chunk, nseg - s);
    t.first_mcu = s * P.restart_interval;
    t.mcu_count = std::min<long>(t.nseg * P.restart_interval,
                                 total_mcus - t.first_mcu);
    tasks.push_back(t);
  }

  int T = int(std::min<long>(threads, long(tasks.size())));
  std::atomic<bool> failed(false);
  std::atomic<long> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= long(tasks.size()) || failed.load(std::memory_order_relaxed))
        return;
      if (!decode_chunk(data, P, starts, pend, tasks[i], mcu_w, hmax, vmax,
                        planes, scratch))
        failed.store(true);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(T - 1);
  for (int t = 0; t < T - 1; t++) pool.emplace_back(worker);
  worker();
  for (auto &th : pool) th.join();
  if (failed.load()) {
    free(buffer);
    return -6;
  }
  *out = buffer;
  *out_len = total;
  return 0;
}

}  // extern "C"
