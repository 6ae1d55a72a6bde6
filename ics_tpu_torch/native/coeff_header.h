// DCT-coefficient buffer header — the ONE definition.
//
// Two things must agree on this layout: jpeg_entropy.cpp, which writes it,
// and the Python parser in imgcodec.py (which hardcodes the 76-byte int
// block and 588-byte total). It is the layout of the JAX package's libjpeg
// shim, so the two packages' buffers compare byte for byte.
#pragma once

#include <cstdint>

struct CoeffHeader {
  int num_components;  // 1 or 3
  int width, height;   // image dims
  // per component: blocks_w, blocks_h, h_samp, v_samp
  int comp[4][4];
  // quant tables per component, natural order
  uint16_t quant[4][64];
};

// imgcodec.py parses 19 ints (4*19 = 76 bytes) then 4*64 uint16s
// (512 bytes) = 588 total; a field added here without updating the
// Python parse must fail the BUILD, not corrupt parses at runtime.
static_assert(sizeof(CoeffHeader) == 588, "CoeffHeader layout drifted");
