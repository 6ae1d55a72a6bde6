// Window attention for NVIDIA Hopper (sm_90a), the attention of Swin's windows:
// out = softmax(Q K^T + bias[head] + mask[window]) V per (window, head), windows
// of ww <= 64 tokens (49 for Swin's 7x7 windows), head_dim in {16, 32}.
//
// Replaces the Pallas TPU kernel scripts/proto_window_attn.py:82,
// pallas_window_attention (body _kernel). Contract, as that kernel's: scores, bias, mask, max, exp and sum
// are fp32; P is divided by its row sum and then rounded to the input's type; P.V
// accumulates in fp32; the output is rounded once. The mask's entries (0 or
// -1e4) are added as they are, never turned into -inf. q is multiplied by
// `scale` in fp32 and rounded to the input's type before the product, as a
// caller's `q * scale` rounds (scale 1 leaves q as it is).
//
// One kernel serves two entries through one token -> address map. A window is
// (image b, window row wy, window column wx) of a gy x gx grid of tokens in
// windows of wh x wwid; its token (i, j) lies at image token
// ((wy wh + i + shift) mod gy, (wx wwid + j + shift) mod gx), and q, k, v and the
// output are read and written there by strides:
//   - window_attention_qkv: the [B, G, G, 3, H, hd] qkv product as it leaves its
//     GEMM, the output [B, G, G, H hd] in image order. The cyclic shift of
//     shifted blocks is the index map: no roll, partition, q/k/v split, q
//     scale, head merge or window merge is copied through device memory.
//   - window_attention: [Bn, H, ww, hd] tensors, a window a row (gy = wh = 1,
//     gx = wwid = ww, shift 0).
// The bias is a table gathered through a [ww, ww] int16 index: the relative-
// position table [(2w-1)^2, H] with Swin's index, or the 4-D entry's
// [H, ww, ww] bias as a table of ww^2 rows with the identity index. The mask
// of window n is mask[n mod n_mask]; an image's windows are numbered row-major.
//
// What bounds it on an H100: bytes. One (window, head) reads 3 x 49 x 32 bf16
// and writes 49 x 32 (12.5 KB) for 4 x 49^2 x 32 = 0.3 MFLOP, about 25 FLOP a
// byte, a tenth of the card's bf16 ridge: Swin-T's 12 calls at batch 32 move
// 367 MB, 0.11 ms at 3.35 TB/s. The [Bn, H, ww, ww] scores (fp32, three
// times the size of q, k, v and the output together) live in registers only.
//
// Design (bf16): a persistent grid of blocks of four warps, as many as fit the
// card, each walking work items (a window and a group of its heads) with a
// stride of the grid.
//   - Loads overlap products: a block stages the next item's q, k, v rows by
//     16-byte cp.async into the other stage of a ring of two while its warps
//     compute the current item. Addresses are computed per token (a thread's
//     rows are the same in every item), so a window that wraps round the
//     image's edge costs nothing more.
//   - Bias and mask come from shared memory: the int16 index is staged once a
//     block; an item's stage holds its heads' table columns (676 bytes a head
//     at w 7) and its window's mask as whole 16-byte pieces of the [ww, ww]
//     block (the pieces at its two ends cut to the block), staged once an
//     item. Only a group of heads shares the mask: at ww 49 a head's rows
//     already take the four warps, the group is one head, and the mask is
//     copied from L2 once a (window, head). Index rows are padded so that a
//     quad's pair loads hit distinct banks.
//   - A warp takes 16 query rows of one head: Q by ldmatrix, K by ldmatrix and
//     V by ldmatrix.trans from rows padded by 8 bf16 (no bank conflicts), both
//     products on mma.sync m16n8k16, the scores as fp32 accumulators of KT
//     8-key tiles (7 at ww 49, a template parameter, as is head_dim), keys past
//     ww at -inf before the max and at p = 0 after, P fed to P.V straight from
//     the score registers. Its 16 output rows go back through its own Q rows of
//     the stage and leave as 16-byte stores. Rows of K and V past ww are zeros
//     in shared memory, written once and never copied over.
// mma.sync and not wgmma: at about 25 FLOP a byte the tensor cores idle either
// way, and a 49-token window fills neither a 64-row wgmma tile nor a warpgroup.
// The fp32 variant is SIMT, plain FMA in full fp32 (no TF32), one block a
// (window, head), one thread a query row, with the same address map.

#include <cmath>
#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"
#include "mma_frag.cuh"
#include "device_guard.cuh"

namespace {

using namespace ics;
using bf16 = __nv_bfloat16;

constexpr int kMaxTokens = 64;   // tokens a window may have
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // bf16 of padding per row of q, k, v
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // what a block may ask for on sm_90
constexpr int kMaxDevices = 64;

// Where the tokens of a window lie, and what an item is.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sb, sy, sx, sh;   // strides (elements) of q, k, v: image, row, column, head
  long long ob, oy, ox, oh;   // the same of the output
  int gy, gx;                 // tokens a column and a row of an image
  int wh, wwid, ww;           // window height, width, tokens
  int shift;
  int nwx, nw_img;            // windows a row and an image
  int heads;
  const float* table;         // bias table: row j of head h at table[j t_row + h t_head]
  long long t_row, t_head;
  int t_rows;
  const short* index;         // [ww, ww] rows of the table
  const float* mask;          // [n_mask, ww, ww] or null, 16-byte aligned
  int n_mask;
  float scale;
  int head_group, n_groups, n_items;
  // shared memory of the bf16 kernel, bytes: the index, then two stages of
  // [q, k, v rows of the group's heads][their table columns][the mask]
  int ld_idx;                 // row stride of the index, elements
  int index_bytes, stage_bytes, table_off, mask_off;
};

struct Window {
  int b, wy, wx, mask_w;
};

__device__ __forceinline__ Window window_of(const Params& p, int n) {
  Window w;
  w.b = n / p.nw_img;
  const int local = n - w.b * p.nw_img;
  w.wy = local / p.nwx;
  w.wx = local - w.wy * p.nwx;
  w.mask_w = n % p.n_mask;
  return w;
}

// offset (elements, before the head) of token (i, j) of a window, by the given strides
__device__ __forceinline__ long long token_offset(const Params& p, const Window& w, int i, int j,
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmaf_rn(s, 1.4426950408889634f, -m_log2e)));
  return y;
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

// where a window's mask starts in its stage: the [ww, ww] block is staged as
// the 16-byte pieces that hold it, so it starts `delta` floats into the first
__device__ __forceinline__ int mask_delta(const Params& p, int mask_w) {
  return (mask_w * p.ww * p.ww) & 3;
}

// Starts the copies of one item into a stage: q, k and v rows of its heads,
// their table columns, its window's mask. Nothing waits here. `ti`, `tj`:
// the window positions of this thread's rows (-1: past the window).
template <int D, int KT>
__device__ __forceinline__ void load_item(const Params& p, int item, uint32_t stage_base,
                                          int tid, const int (&ti)[row_passes<D>()],
                                          const int (&tj)[row_passes<D>()]) {
  constexpr int LD = D + kPad;
  constexpr int CH = D / 8;                 // 16-byte pieces a row
  constexpr int RPP = kThreads / CH;        // rows a pass of the block
  constexpr int ROWS = stage_rows<KT>();
  const int n = item / p.n_groups;
  const int h0 = (item - n * p.n_groups) * p.head_group;
  const Window w = window_of(p, n);
  const int c = tid % CH;
  long long src[row_passes<D>()];
#pragma unroll
  for (int k = 0; k < row_passes<D>(); ++k) {
    src[k] = ti[k] >= 0 ? token_offset(p, w, ti[k], tj[k], p.sb, p.sy, p.sx) + c * 8 : 0;
  }
  const bf16* qkv[3] = {static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k),
                        static_cast<const bf16*>(p.v)};
  for (int hh = 0; hh < p.head_group; ++hh) {
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      const bf16* base = qkv[which] + (h0 + hh) * p.sh;
      const uint32_t dst = stage_base + ((hh * 3 + which) * ROWS) * LD * 2 + c * 16;
#pragma unroll
      for (int k = 0; k < row_passes<D>(); ++k) {
        if (ti[k] >= 0) cp_async_16(dst + (tid / CH + k * RPP) * LD * 2, base + src[k], true);
      }
    }
  }
  const uint32_t table_dst = stage_base + p.table_off;
  for (int hh = 0; hh < p.head_group; ++hh) {
    const float* col = p.table + (h0 + hh) * p.t_head;
    for (int j = tid; j < p.t_rows; j += kThreads) {
      cp_async_4(table_dst + (hh * p.t_rows + j) * 4, col + j * p.t_row);
    }
  }
  if (p.mask != nullptr) {
    // the 16-byte pieces that hold the window's block (the mask is 16-byte aligned)
    const long long first = static_cast<long long>(w.mask_w) * p.ww * p.ww;  // floats
    const float* start = p.mask + (first & ~3LL);
    const int floats = mask_delta(p, w.mask_w) + p.ww * p.ww;
    const uint32_t mask_dst = stage_base + p.mask_off;
    for (int i = tid; i * 4 < floats; i += kThreads) {
      const int left = floats - i * 4;
      cp_async_16_part(mask_dst + i * 16, start + i * 4, left < 4 ? left * 4 : 16);
    }
  }
}

// One item from its stage: each warp takes 16 query rows of one head at a time.
template <int D, int KT>
__device__ __forceinline__ void compute_item(const Params& p, int item, uint8_t* smem_raw,
                                             int stage_off, const int* tok_s, int warp,
                                             int lane) {
  constexpr int LD = D + kPad;
  constexpr int CH = D / 8;
  constexpr int ROWS = stage_rows<KT>();
  constexpr int PT = (KT + 1) / 2;          // k16 steps of P.V
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ww = p.ww;
  const int row_tiles = (ww + 15) / 16;
  const int n = item / p.n_groups;
  const int h0 = (item - n * p.n_groups) * p.head_group;
  uint8_t* stage = smem_raw + stage_off;
  const uint32_t stage_u32 = smem_u32(stage);
  const short* index_s = reinterpret_cast<const short*>(smem_raw);
  const bool masked = p.mask != nullptr;
  const float* mask_s = reinterpret_cast<const float*>(stage + p.mask_off) +
                        (masked ? mask_delta(p, n % p.n_mask) : 0);
  const int ld = p.ld_idx;

  for (int task = warp; task < p.head_group * row_tiles; task += kWarps) {
    const int hh = task / row_tiles;
    const int rt = task - hh * row_tiles;
    const uint32_t q_s = stage_u32 + (hh * 3) * ROWS * LD * 2;
    const uint32_t k_s = q_s + ROWS * LD * 2;
    const uint32_t v_s = k_s + ROWS * LD * 2;
    const float* tb = reinterpret_cast<const float*>(stage + p.table_off) + hh * p.t_rows;

    // Q, scaled in fp32 and rounded as the caller's q * scale
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int r = rt * 16 + (lane & 15);
      const int col = kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qf[kk], q_s + (r * LD + col) * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[kk][i]));
        qf[kk][i] = pack_f32(__fmul_rn(f.x, p.scale), __fmul_rn(f.y, p.scale));
      }
    }

    // S = Q K^T, 16 rows x 8 KT keys; one ldmatrix.x4 brings the B fragments
    // of two 8-key tiles for one k16 step
    float s[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int np = 0; np < PT; ++np) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        const int r = (2 * np + (lane >> 4)) * 8 + (lane & 7);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kb, k_s + (r * LD + col) * 2);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        if (2 * np + 1 < KT) mma_bf16(s[(2 * np + 1) % KT], qf[kk], kb[2], kb[3]);
      }
    }

    // + bias, then + mask, on real (row, key) pairs; keys past ww at -inf;
    // row max
    float m[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rt * 16 + g + half * 8;
      const int rr = r < ww ? r : ww - 1;   // a row past ww reads a real one, then drops it
      const short* idx_row = index_s + rr * ld;
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

    // exp and row sum; p = 0 on keys past ww
    const float ml[2] = {m[0] * 1.4426950408889634f, m[1] * 1.4426950408889634f};
    float l[2] = {0.f, 0.f};
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
    float rl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      rl[i] = 1.f / l[i];
    }

    // P = exp / sum, rounded to bf16: the S accumulators of two neighbouring
    // key tiles are exactly the A fragment of one k16 step (an odd KT's last
    // step takes zeros for its second tile)
    uint32_t pf[PT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * PT; ++nt) {
      const int st = nt < KT ? nt : 0;
      pf[nt / 2][(nt & 1) * 2] = nt < KT ? pack_f32(divide(s[st][0], rl[0], l[0]),
                                                    divide(s[st][1], rl[0], l[0])) : 0u;
      pf[nt / 2][(nt & 1) * 2 + 1] = nt < KT ? pack_f32(divide(s[st][2], rl[1], l[1]),
                                                        divide(s[st][3], rl[1], l[1])) : 0u;
    }

    // O = P V; one ldmatrix.x4.trans brings the B fragments of two 8-wide
    // blocks of D for one k16 step of keys
    float o[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < PT; ++kc) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t vb[4];
        const int r = kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = (dt + (lane >> 4)) * 8;
        ldmatrix_x4_trans(vb, v_s + (r * LD + col) * 2);
        mma_bf16(o[dt], pf[kc], vb[0], vb[1]);
        mma_bf16(o[dt + 1], pf[kc], vb[2], vb[3]);
      }
    }

    // the 16 output rows through this warp's own Q rows, then 16-byte stores
    bf16* out_s = reinterpret_cast<bf16*>(stage + (hh * 3) * ROWS * LD * 2) + rt * 16 * LD;
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(out_s + g * LD + col) = pack_f32(o[dt][0], o[dt][1]);
      *reinterpret_cast<uint32_t*>(out_s + (g + 8) * LD + col) = pack_f32(o[dt][2], o[dt][3]);
    }
    __syncwarp();
    const Window w = window_of(p, n);
    bf16* out = static_cast<bf16*>(p.o) + (h0 + hh) * p.oh;
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH;
      const int c = i - r * CH;
      const int token = rt * 16 + r;
      if (token < ww) {
        const uint4 val = *reinterpret_cast<const uint4*>(out_s + r * LD + c * 8);
        const int ij = tok_s[token];
        *reinterpret_cast<uint4*>(
            out + token_offset(p, w, ij >> 8, ij & 255, p.ob, p.oy, p.ox) + c * 8) = val;
      }
    }
    __syncwarp();  // the next task of this warp may land on the same rows
  }
}

template <int D, int KT>
__global__ void __launch_bounds__(kThreads)
window_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int CH = D / 8;
  constexpr int RPP = kThreads / CH;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int tok_s[kMaxTokens];         // token t of a window: (i << 8) | j
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // every stage zeroed once: rows of k and v past ww stay zero for good
  const int total = p.index_bytes + 2 * p.stage_bytes;
  for (int i = tid * 16; i < total; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(smem_raw + i) = make_uint4(0, 0, 0, 0);
  }
  if (tid < p.ww) tok_s[tid] = ((tid / p.wwid) << 8) | (tid % p.wwid);
  int ti[row_passes<D>()], tj[row_passes<D>()];   // this thread's rows of every item
#pragma unroll
  for (int k = 0; k < row_passes<D>(); ++k) {
    const int row = tid / CH + k * RPP;
    ti[k] = row < p.ww ? row / p.wwid : -1;
    tj[k] = row < p.ww ? row % p.wwid : 0;
  }
  __syncthreads();
  const uint32_t ring = smem_u32(smem_raw) + p.index_bytes;
  const int step = gridDim.x;
  if (blockIdx.x < p.n_items) load_item<D, KT>(p, blockIdx.x, ring, tid, ti, tj);
  cp_async_commit();
  // the index under the first item's copies: every load in flight before the
  // first store (the loop's first barrier publishes them)
  {
    constexpr int kPasses = kMaxTokens * kMaxTokens / kThreads;
    const int n_index = p.ww * p.ww;
    short got[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int i = tid + k * kThreads;
      got[k] = i < n_index ? p.index[i] : short(0);
    }
    short* index_s = reinterpret_cast<short*>(smem_raw);
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int i = tid + k * kThreads;
      if (i < n_index) {
        const int r = i / p.ww;
        index_s[r * p.ld_idx + i - r * p.ww] = got[k];
      }
    }
  }
  int stage = 0;
  for (int item = blockIdx.x; item < p.n_items; item += step) {
    const int next = item + step;
    if (next < p.n_items) {
      load_item<D, KT>(p, next, ring + (stage ^ 1) * p.stage_bytes, tid, ti, tj);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this item's stage has landed for every thread (and the index)
    compute_item<D, KT>(p, item, smem_raw, p.index_bytes + stage * p.stage_bytes, tok_s, warp,
                        lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
    stage ^= 1;
  }
  cp_async_wait<0>();
}

template <int D>
__global__ void __launch_bounds__(kMaxTokens)
window_f32_kernel(const Params p) {
  __shared__ float ks[kMaxTokens][D];
  __shared__ float vs[kMaxTokens][D];
  __shared__ float ps[kMaxTokens][kMaxTokens + 1];  // a score row per thread

  const int head = blockIdx.x % p.heads;
  const int n = blockIdx.x / p.heads;
  const Window w = window_of(p, n);
  const float* q = static_cast<const float*>(p.q) + head * p.sh;
  const float* k = static_cast<const float*>(p.k) + head * p.sh;
  const float* v = static_cast<const float*>(p.v) + head * p.sh;
  const int ww = p.ww;
  for (int i = threadIdx.x; i < ww * D; i += kMaxTokens) {
    const int t = i / D;
    const long long off = token_offset(p, w, t / p.wwid, t % p.wwid, p.sb, p.sy, p.sx) + i % D;
    ks[t][i % D] = k[off];
    vs[t][i % D] = v[off];
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row >= ww) return;

  float qr[D];
  const int ri = row / p.wwid;
  const int rj = row % p.wwid;
  const long long q_off = token_offset(p, w, ri, rj, p.sb, p.sy, p.sx);
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = __fmul_rn(q[q_off + d], p.scale);
  const short* idx = p.index + row * ww;
  const float* tb = p.table + head * p.t_head;
  const float* mask_row =
      p.mask == nullptr ? nullptr
                        : p.mask + (static_cast<long long>(w.mask_w) * ww + row) * ww;
  float* pr = ps[row];
  float m = kNegInf;
  for (int j = 0; j < ww; ++j) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
    s += tb[static_cast<unsigned short>(idx[j]) * p.t_row];
    if (mask_row != nullptr) s += mask_row[j];
    pr[j] = s;
    m = fmaxf(m, s);
  }
  float l = 0.f;
  for (int j = 0; j < ww; ++j) {
    pr[j] = expf(pr[j] - m);
    l += pr[j];
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int j = 0; j < ww; ++j) {
    const float pj = pr[j] / l;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[j][d], acc[d]);
  }
  float* o = static_cast<float*>(p.o) + token_offset(p, w, ri, rj, p.ob, p.oy, p.ox) +
             head * p.oh;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = acc[d];
}

// ---- host side ------------------------------------------------------------------------------

// Blocks of a kernel that fit the card at a shared-memory size: asked once, then kept.
int resident_blocks(const void* kernel, int smem, int device) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, int> known;
  const auto key = std::make_tuple(kernel, smem, device);
  std::lock_guard<std::mutex> lock(mu);
  const auto found = known.find(key);
  if (found != known.end()) return found->second;
  int per_sm = 0;
  int sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  known.emplace(key, per_sm * sms);
  return per_sm * sms;
}

template <int D, int KT>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream, int device) {
  auto kernel = window_bf16_kernel<D, KT>;
  static bool configured[kMaxDevices] = {};
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int smem = p.index_bytes + 2 * p.stage_bytes;
  const int dynamic_max = kMaxSmem - static_cast<int>(kMaxTokens * sizeof(int));
  if (smem > dynamic_max) return cudaErrorInvalidValue;
  if (!configured[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic_max);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const int resident = resident_blocks(reinterpret_cast<const void*>(kernel), smem, device);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  // as many blocks as fit, each with the same number of items give or take one
  int blocks = p.n_items < resident ? p.n_items : resident;
  const int per_block = (p.n_items + blocks - 1) / blocks;
  blocks = (p.n_items + per_block - 1) / per_block;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, int key_tiles, const Params& p, cudaStream_t stream, int device) {
  if (dtype == 1) {
    window_f32_kernel<D><<<p.n_items, kMaxTokens, 0, stream>>>(p);
    return cudaGetLastError();
  }
  switch (key_tiles) {
    case 2: return launch_bf16<D, 2>(p, stream, device);
    case 4: return launch_bf16<D, 4>(p, stream, device);
    case 7: return launch_bf16<D, 7>(p, stream, device);
    case 8: return launch_bf16<D, 8>(p, stream, device);
    default: return cudaErrorInvalidValue;
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32, of q, k, v and o. Token (y, x) of image b, head h
// of q lies at q + b sb + y sy + x sx + h sh (elements; the same strides for k
// and v), its head_dim values contiguous and 16-byte aligned; the output's by
// ob, oy, ox, oh. The grid is gy x gx tokens in windows of wh x wwid, rolled by
// `shift` (0 <= shift < wh, wwid). table: fp32, row j of head h at
// table[j t_row + h t_head], t_rows rows; index: int16 [wh wwid, wh wwid], its
// values in [0, t_rows). mask: fp32 [n_mask, ww, ww], contiguous and 16-byte
// aligned, or null; window n (image-major, row-major in an image) takes
// mask[n mod n_mask]. q is multiplied by scale and rounded to its type.
// head_group (bf16): heads a work item takes, a divisor of heads. Returns a
// cudaError_t; 0 when the launch was accepted.
int ics_window_attention(int dtype, const void* q, const void* k, const void* v, void* o,
                         long long sb, long long sy, long long sx, long long sh, long long ob,
                         long long oy, long long ox, long long oh, int batch, int gy, int gx,
                         int wh, int wwid, int shift, int heads, int head_dim,
                         const void* table, long long t_row, long long t_head, int t_rows,
                         const void* index, const void* mask, int n_mask, float scale,
                         int head_group, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || heads <= 0) return 0;
  const int ww = wh * wwid;
  if (wh <= 0 || wwid <= 0 || ww > kMaxTokens || gy % wh != 0 || gx % wwid != 0 ||
      shift < 0 || shift >= wh || shift >= wwid || head_group <= 0 ||
      heads % head_group != 0 || t_rows <= 0 || (mask != nullptr && n_mask <= 0) ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.sb = sb;
  p.sy = sy;
  p.sx = sx;
  p.sh = sh;
  p.ob = ob;
  p.oy = oy;
  p.ox = ox;
  p.oh = oh;
  p.gy = gy;
  p.gx = gx;
  p.wh = wh;
  p.wwid = wwid;
  p.ww = ww;
  p.shift = shift;
  p.nwx = gx / wwid;
  p.nw_img = (gy / wh) * p.nwx;
  p.heads = heads;
  p.table = static_cast<const float*>(table);
  p.t_row = t_row;
  p.t_head = t_head;
  p.t_rows = t_rows;
  p.index = static_cast<const short*>(index);
  p.mask = static_cast<const float*>(mask);
  p.n_mask = mask != nullptr ? n_mask : 1;
  p.scale = scale;
  p.head_group = dtype == 1 ? 1 : head_group;
  p.n_groups = heads / p.head_group;
  const long long items = static_cast<long long>(batch) * p.nw_img * p.n_groups;
  if (items > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_items = static_cast<int>(items);
  // key tiles of 8 the bf16 kernel is built for; index rows: the tiles' keys
  // as an odd multiple of 8, so that the eight rows a quad's pair loads touch
  // lie on distinct banks
  const int key_tiles = ww <= 16 ? 2 : ww <= 32 ? 4 : ww <= 56 ? 7 : 8;
  p.ld_idx = key_tiles * 8 % 16 == 0 ? key_tiles * 8 + 8 : key_tiles * 8;
  p.index_bytes = round_up(ww * p.ld_idx * 2, 16);
  p.table_off = p.head_group * 3 * round_up(key_tiles * 8, 16) * (head_dim + kPad) * 2;
  p.mask_off = p.table_off + round_up(p.head_group * t_rows * 4, 16);
  // the mask's pieces (3 floats at most before the block), and room behind
  // them for the last row's keys past ww, read and dropped
  p.stage_bytes =
      p.mask_off + (mask != nullptr ? round_up((3 + (ww - 1) * ww + key_tiles * 8) * 4, 16) : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(dtype, key_tiles, p, s, device));
    case 32: return static_cast<int>(launch<32>(dtype, key_tiles, p, s, device));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
