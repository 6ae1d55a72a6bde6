// Pieces of Swin's window attention shared by the forward (window_attention.cu) and its
// backward (window_attention_bwd.cu): the token -> address map, the cp.async copies of
// the table and the mask, and the bf16 tensor-core steps of one warp's 16 query rows. The backward
// recomputes the forward's scores and probabilities through the same functions, so that
// its P is the forward's bit for bit.
//
// Rows of q, k, v (and dO) lie in shared memory as [rows][D + kPad] bf16: the padding puts
// the eight rows an ldmatrix reads on distinct banks.

#pragma once

#include "hopper.cuh"
#include "mma_frag.cuh"

namespace ics {
namespace window {

constexpr int kMaxTokens = 64;   // tokens a window may have
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 of padding per row of q, k, v
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;  // what a block may ask for on sm_90

struct Window {
  int b, wy, wx, mask_w;
};

// window n of the call (image-major, row-major in an image); P has the grid's fields
template <class P>
__device__ __forceinline__ Window window_of(const P& p, int n) {
  Window w;
  w.b = n / p.nw_img;
  const int local = n - w.b * p.nw_img;
  w.wy = local / p.nwx;
  w.wx = local - w.wy * p.nwx;
  w.mask_w = n % p.n_mask;
  return w;
}

// offset (elements, before the head) of token (i, j) of a window, by the given strides:
// image token ((wy wh + i + shift) mod gy, (wx wwid + j + shift) mod gx)
template <class P>
__device__ __forceinline__ long long token_offset(const P& p, const Window& w, int i, int j,
                                                  long long sb, long long sy, long long sx) {
  int y = w.wy * p.wh + i + p.shift;
  int x = w.wx * p.wwid + j + p.shift;
  y -= y >= p.gy ? p.gy : 0;
  x -= x >= p.gx ? p.gx : 0;
  return w.b * sb + y * sy + x * sx;
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// the first `bytes` (0 to 16) of a 16-byte piece, the rest zeros
__device__ __forceinline__ void cp_async_16_part(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// e / l correctly rounded, as the plain version divides, from r = 1 / l
// correctly rounded (one division a row): q = e r, then q + (e - q l) r with
// the remainder exact in a fused multiply-add (Markstein). The compiler's
// division would take its slow path on every e = 0, a key past ww or cut by
// the mask.
__device__ __forceinline__ float divide(float e, float r, float l) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// e^(s - m) as ex2.approx(s log2(e) - m log2(e)): __expf's instruction, with
// the subtraction folded into one multiply-add
__device__ __forceinline__ float exp_minus(float s, float m_log2e) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmaf_rn(s, kLog2e, -m_log2e)));
  return y;
}

// 8-key tiles of the scores at ww tokens: a template parameter of the kernels
__host__ __device__ constexpr int key_tiles(int ww) {
  return ww <= 16 ? 2 : ww <= 32 ? 4 : ww <= 56 ? 7 : 8;
}

// rows of q, k and v a head takes in a stage: the keys of KT tiles of 8,
// rounded up to whole k16 steps of P.V
template <int KT>
__host__ __device__ constexpr int stage_rows() {
  return (KT * 8 + 15) / 16 * 16;
}

// rows of a window a thread stages: row tid / (D / 8) + k * kThreads / (D / 8)
template <int D>
__host__ __device__ constexpr int row_passes() {
  return (kMaxTokens * (D / 8) + kThreads - 1) / kThreads;
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// where a window's mask starts in its staged pieces: the [ww, ww] block is
// staged as the 16-byte pieces that hold it, so it starts `delta` floats into
// the first
__device__ __forceinline__ int mask_delta(int ww, int mask_w) { return (mask_w * ww * ww) & 3; }

// bytes of the staged pieces of one window's mask: up to 3 floats before the
// block, and room behind it for the last row's keys past ww, read and dropped
__host__ __device__ constexpr int mask_stage_bytes(int ww) {
  return round_up((3 + (ww - 1) * ww + key_tiles(ww) * 8) * 4, 16);
}

// Starts the copies of mask block `mask_w` ([n_mask, ww, ww] fp32, 16-byte
// aligned) into shared memory at dst, as whole 16-byte pieces.
__device__ __forceinline__ void load_mask(const float* mask, int ww, int mask_w, uint32_t dst,
                                          int tid) {
  const long long first = static_cast<long long>(mask_w) * ww * ww;  // floats
  const float* start = mask + (first & ~3LL);
  const int floats = mask_delta(ww, mask_w) + ww * ww;
  for (int i = tid; i * 4 < floats; i += kThreads) {
    const int left = floats - i * 4;
    cp_async_16_part(dst + i * 16, start + i * 4, left < 4 ? left * 4 : 16);
  }
}

// The A fragments (16 rows x D) of row tile rt of the rows at `base`
template <int D>
__device__ __forceinline__ void load_rows_a(uint32_t (&f)[D / 16][4], uint32_t base, int rt,
                                            int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = rt * 16 + (lane & 15);
    const int col = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(f[kk], base + (r * LD + col) * 2);
  }
}

// each bf16 of f times scale in fp32, rounded, as a caller's q * scale rounds
template <int N>
__device__ __forceinline__ void scale_bf16(uint32_t (&f)[N], float scale) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&f[i]));
    f[i] = pack_f32(__fmul_rn(v.x, scale), __fmul_rn(v.y, scale));
  }
}

// acc (16 rows x 8 KT keys) += A B^T, B's rows [key][d] at b_s: S = Q K^T, dP = dO V^T.
// One ldmatrix.x4 brings the B fragments of two 8-key tiles for one k16 step.
template <int D, int KT>
__device__ __forceinline__ void product_abt(float (&acc)[KT][4], const uint32_t (&a)[D / 16][4],
                                            uint32_t b_s, int lane) {
  constexpr int LD = D + kPad;
  constexpr int PT = (KT + 1) / 2;
#pragma unroll
  for (int np = 0; np < PT; ++np) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t kb[4];
      const int r = (2 * np + (lane >> 4)) * 8 + (lane & 7);
      const int col = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(kb, b_s + (r * LD + col) * 2);
      mma_bf16(acc[2 * np], a[kk], kb[0], kb[1]);
      if (2 * np + 1 < KT) mma_bf16(acc[(2 * np + 1) % KT], a[kk], kb[2], kb[3]);
    }
  }
}

// acc (16 rows x D) += A B, A given as the fragments of PT k16 steps of keys, B's rows
// [key][d] at b_s: O = P V, dq = dS K. One ldmatrix.x4.trans brings the B fragments of
// two 8-wide blocks of D for one k16 step.
template <int D, int PT>
__device__ __forceinline__ void product_ab(float (&acc)[D / 8][4], const uint32_t (&a)[PT][4],
                                           uint32_t b_s, int lane) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int kc = 0; kc < PT; ++kc) {
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t vb[4];
      const int r = kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int col = (dt + (lane >> 4)) * 8;
      ldmatrix_x4_trans(vb, b_s + (r * LD + col) * 2);
      mma_bf16(acc[dt], a[kc], vb[0], vb[1]);
      mma_bf16(acc[dt + 1], a[kc], vb[2], vb[3]);
    }
  }
}

// The scores of row tile rt (S = Q K^T in s) turned into the softmax's numerators:
// + bias (the table column tb through the index rows, ld_idx apart), + mask (rows ww
// apart at mask_s) on real (row, key) pairs, keys past ww at -inf, row max, e =
// ex2.approx, keys past ww at e = 0; l the row sums, rl = 1 / l. A row past ww reads a
// real row's bias and mask, is finite, and is dropped by the caller.
template <int KT>
__device__ __forceinline__ void softmax_exp(float (&s)[KT][4], int rt, int lane, int ww,
                                            const short* index_s, int ld_idx, const float* tb,
                                            const float* mask_s, bool masked, float (&l)[2],
                                            float (&rl)[2]) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float m[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rt * 16 + g + half * 8;
    const int rr = r < ww ? r : ww - 1;   // a row past ww reads a real one, then drops it
    const short* idx_row = index_s + rr * ld_idx;
    const float* mask_row = mask_s + rr * ww;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
      const int key = nt * 8 + t * 2;
      const uint32_t ip = *reinterpret_cast<const uint32_t*>(idx_row + key);
      float v0 = s[nt][half * 2] + tb[ip & 0xffffu];
      float v1 = s[nt][half * 2 + 1] + tb[ip >> 16];
      if (masked) {
        v0 += mask_row[key];
        v1 += mask_row[key + 1];
      }
      v0 = r < ww ? (key < ww ? v0 : kNegInf) : 0.f;       // a row past ww: finite, dropped
      v1 = r < ww ? (key + 1 < ww ? v1 : kNegInf) : 0.f;
      s[nt][half * 2] = v0;
      s[nt][half * 2 + 1] = v1;
      m[half] = fmaxf(m[half], fmaxf(v0, v1));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool ok = nt * 8 + t * 2 + j < ww;
      s[nt][j] = ok ? exp_minus(s[nt][j], ml[0]) : 0.f;
      s[nt][2 + j] = ok ? exp_minus(s[nt][2 + j], ml[1]) : 0.f;
      l[0] += s[nt][j];
      l[1] += s[nt][2 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    rl[i] = 1.f / l[i];
  }
}

// The A fragments of PT k16 steps from the fp32 accumulators of KT 8-key tiles, rounded
// to bf16: two neighbouring tiles are exactly one step's fragment (an odd KT's last step
// takes zeros for its second tile)
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&f)[(KT + 1) / 2][4], const float (&s)[KT][4]) {
#pragma unroll
  for (int nt = 0; nt < (KT + 1) / 2 * 2; ++nt) {
    const int st = nt < KT ? nt : 0;
    f[nt / 2][(nt & 1) * 2] = nt < KT ? pack_f32(s[st][0], s[st][1]) : 0u;
    f[nt / 2][(nt & 1) * 2 + 1] = nt < KT ? pack_f32(s[st][2], s[st][3]) : 0u;
  }
}

}  // namespace window
}  // namespace ics
