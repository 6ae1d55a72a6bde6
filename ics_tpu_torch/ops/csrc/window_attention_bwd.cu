// Backward of Swin's window attention for NVIDIA Hopper (sm_90a): the gradient of
// window_attention_qkv's output with respect to its qkv input (the explain step's input
// gradient through Swin) and, for training, with respect to the relative-position table.
//
// The TPU kernel that window_attention.cu replaces (scripts/proto_window_attn.py:82,
// pallas_window_attention) has no backward; this is the backward of the port's forward
// kernel. Per (window, head) the forward computes, in fp32,
//   S = (q scale)_T K^T + bias + mask,   P = softmax(S),   O = (P)_T V,
// where (.)_T is a rounding to the input's type T (bf16 or fp32). Given dO this kernel
// recomputes S and P exactly as the forward does and computes
//   dP = dO V^T,   D_i = sum_j P_ij dP_ij,   dS = P (dP - D),
//   dq = scale dS K,   dk = dS^T (q scale)_T,   dv = (P)_T^T dO,
// every sum in fp32, each gradient rounded once to T on its store. The bias table, its
// index and the mask are read as the forward reads them; the mask takes no gradient.
//
// The table's gradient: the bias is the same for every window of a head, so its gradient
// is dB[h, i, j] = sum over windows of dS_ij, and the table's is that gathered back through
// the index. A block takes windows of one head only (block (h, g) of G a head takes
// windows g, g + G, g + 2G, ...), sums their dS and writes one [ww, ww] partial of a
// [heads, G, ww, ww] buffer at its end. ics_window_attention_dtable then sums the G
// partials of each (head, i, j) by a block per (head, 32 positions) with a fixed tree
// (table_sum_kernel), and each table row over the (i, j) that index it, a warp a (row,
// head) over a stable sort of the index with a fixed butterfly (table_gather_kernel): no
// atomics, the same bits on every run.
//
// Token map: the forward's (window_tile.cuh). The tokens of the windows of one image are
// a permutation of the image's (the cyclic shift), so a work item (a window and a head)
// owns its rows of dq, dk and dv: no atomics.
//
// What bounds it on an H100: the bytes, at about 70 FLOP a byte, under the bf16 ridge
// (295). An item reads q, k, v and dO and writes dq, dk and dv, 7 ww hd values (22 KB in
// bf16 at ww 49, hd 32), for 5 products of 2 ww^2 hd operations each (dq, dk, dv, dP and
// the recomputed S: 1.5 MFLOP). Swin-T's 12 calls at a SmoothGrad batch of 16 move
// 320 MB, 0.096 ms at 3.35 TB/s, and do 22 GFLOP, 0.023 ms at the bf16 peak. The first
// design (fp32 SIMT, a block of 64 threads an item, four barriers and every FMA fed from
// shared memory) was bound by issuing those shared-memory loads, at 23x the bound.
//
// Design (bf16), the forward's shape (window_attention.cu) carried to the backward:
//   - A persistent grid of 4-warp blocks, heads x G blocks with G from the card's
//     occupancy (ics_window_attention_bwd_resident and the planner in
//     ops/window_attention.py): a block walks windows of one head, a stride of G apart.
//     The head's table column and the index are staged once a block; so is the window's
//     mask where G is a multiple of n_mask (window n takes mask n mod n_mask, so all of a
//     block's windows share one), else the mask travels with each item.
//   - Loads overlap products: the block stages the next item's q, k, v and dO rows by
//     16-byte cp.async into the other stage of a ring of two while its warps compute the
//     current one. Rows past ww are zeros, written once and never copied over.
//   - Query phase: warp w takes query rows 16w..16w+15 (ww <= 64: four warps at most).
//     S = (q scale)_bf16 K^T on mma.sync m16n8k16 from ldmatrix, bias and mask from shared
//     memory, and P = e (1/l) with its remainder step: the forward's own functions, so P
//     is the forward's bit for bit. dP = dO V^T on mma.sync; D_i by quad shuffles from the
//     P and dP accumulators, which share one layout (no O = P V recompute); dS = P (dP - D)
//     in registers; dq = scale dS K with dS as a bf16 A fragment and K by ldmatrix.trans.
//     dS and (P)_bf16 go to two padded [rows, rows + 8] bf16 tiles in shared memory. With
//     the table's gradient a warp's rows of dS add into fp32 registers of the score layout
//     across the block's windows (a block's warp always takes the same rows).
//   - Key phase, after one barrier: warp w takes key rows 16w..16w+15: dk = dS^T (q
//     scale)_bf16 and dv = (P)_bf16^T dO, with dS^T and P^T from the tiles and q and dO by
//     ldmatrix.trans. This is FlashAttention-2's backward shaped to one window.
//   - Stores: a quad's fragments are transposed by shuffles (quad_transpose) so that a
//     lane holds 16 contiguous bytes of a row: every store of dq, dk, dv is 16 bytes.
//   Two barriers an item: one before the query phase (the stage has landed; every warp is
//   done with the last item's tiles and stage), one before the key phase.
// dS enters the products rounded to bf16, as the plain version's bf16 autograd rounds dP
// and the gradients of q and k; the sums are fp32.
// The fp32 variant is SIMT (one block of 64 threads, a thread a row, fp32 FMAs, the
// forward's expf and division), with the same grid of heads x G blocks and the same
// partial sums of dS for the table. Which body runs is decided by the dtype alone; the
// bf16 body covers every shape the entry takes (ww <= 64, hd 16 and 32, any shift, a mask
// or none, qkv as a strided view with 16-byte rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_tile.cuh"
#include "device_guard.cuh"

namespace {

using namespace ics;
using namespace ics::window;
using bf16 = __nv_bfloat16;

constexpr int kMaxDevices = 64;
constexpr int kF32Threads = kMaxTokens;   // the fp32 body: a thread a row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  long long sb, sy, sx, sh;   // strides (elements) of q, k, v: image, row, column, head
  long long ob, oy, ox, oh;   // the same of dO
  long long gb, gy_s, gx_s, gh;  // the same of dq, dk, dv
  int gy, gx;                 // tokens a column and a row of an image
  int wh, wwid, ww;           // window height, width, tokens
  int shift;
  int nwx, nw_img;            // windows a row and an image
  int heads;
  const float* table;         // bias table: row j of head h at table[j t_row + h t_head]
  long long t_row, t_head;
  int t_rows;
  const short* index;         // [ww, ww] rows of the table
  const float* mask;          // [n_mask, ww, ww] or null (16-byte aligned for bf16)
  int n_mask;
  float scale;
  float* dbias_part;          // [heads, groups, ww, ww] sums of dS, or null: no table gradient
  int groups;                 // blocks a head; block g of a head takes windows g, g + groups, ...
  int windows;                // windows of the call
  int ld;                     // fp32 body: row stride of its [ww, ww] blocks in shared memory
  // shared memory of the bf16 body, bytes: the index, the head's table column, the mask
  // where the block's windows share one, the dS and P tiles, then two stages of
  // [q, k, v, dO rows][the item's mask where they do not]
  int ld_idx;                 // row stride of the index, elements
  int table_off, fixed_mask_off, tiles_off, ring_off, stage_bytes, stage_mask_off;
  int mask_fixed;
};

// ---- the bf16 body --------------------------------------------------------------------------

// Starts the copies of window n's q, k, v and dO rows of `head` (and its mask, unless the
// block keeps one) into a stage. `ti`, `tj`: the window positions of this thread's rows
// (-1: past the window).
template <int D, int KT>
__device__ __forceinline__ void load_item(const Params& p, int n, int head, uint32_t stage_base,
                                          int tid, const int (&ti)[row_passes<D>()],
                                          const int (&tj)[row_passes<D>()]) {
  constexpr int LD = D + kPad;
  constexpr int CH = D / 8;                 // 16-byte pieces a row
  constexpr int RPP = kThreads / CH;        // rows a pass of the block
  constexpr int ROWS = stage_rows<KT>();
  const Window w = window_of(p, n);
  const int c = tid % CH;
  const bf16* src[4] = {static_cast<const bf16*>(p.q) + head * p.sh,
                        static_cast<const bf16*>(p.k) + head * p.sh,
                        static_cast<const bf16*>(p.v) + head * p.sh,
                        static_cast<const bf16*>(p.dout) + head * p.oh};
#pragma unroll
  for (int k = 0; k < row_passes<D>(); ++k) {
    if (ti[k] < 0) continue;
    const uint32_t dst = stage_base + (tid / CH + k * RPP) * LD * 2 + c * 16;
    const long long in = token_offset(p, w, ti[k], tj[k], p.sb, p.sy, p.sx) + c * 8;
    const long long out = token_offset(p, w, ti[k], tj[k], p.ob, p.oy, p.ox) + c * 8;
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      cp_async_16(dst + which * ROWS * LD * 2, src[which] + in, true);
    }
    cp_async_16(dst + 3 * ROWS * LD * 2, src[3] + out, true);
  }
  if (p.mask != nullptr && !p.mask_fixed) {
    load_mask(p.mask, p.ww, w.mask_w, stage_base + p.stage_mask_off, tid);
  }
}

// 16 rows x D of fp32 accumulators (rows g and g + 8 of a quad's lanes), times f, rounded
// to bf16 and stored as 16-byte pieces at the tokens of rows rt*16.. of window w: a quad
// transposes its words so that each lane holds a whole piece.
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, const float (&acc)[D / 8][4],
                                           float f, int rt, int lane, const Window& w,
                                           const int* tok_s, bf16* base) {
  const int g = lane >> 2;
  const int t = lane & 3;
  uint32_t words[2][D / 8];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    words[0][dt] = pack_f32(acc[dt][0] * f, acc[dt][1] * f);
    words[1][dt] = pack_f32(acc[dt][2] * f, acc[dt][3] * f);
  }
  // pieces: D = 32, lane t takes piece t of row g, then of row g + 8; D = 16, lane t
  // takes piece t & 1 of row g + 8 (t >> 1)
  constexpr int kRounds = D / 16;
#pragma unroll
  for (int round = 0; round < kRounds; ++round) {
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (D == 32) {
        a[i] = words[round][i];
      } else {
        a[i] = words[i >> 1][i & 1];
      }
    }
    quad_transpose(a, t);
    const int row = rt * 16 + g + (D == 32 ? round * 8 : (t >> 1) * 8);
    const int piece = D == 32 ? t : (t & 1);
    if (row < p.ww) {
      const int ij = tok_s[row];
      bf16* dst = base + token_offset(p, w, ij >> 8, ij & 255, p.gb, p.gy_s, p.gx_s) + piece * 8;
      *reinterpret_cast<uint4*>(dst) = make_uint4(a[0], a[1], a[2], a[3]);
    }
  }
}

template <int D, int KT, bool kTable>
__global__ void __launch_bounds__(kThreads)
window_bwd_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 32, "head_dim must be 16 or 32");
  constexpr int LD = D + kPad;
  constexpr int CH = D / 8;
  constexpr int RPP = kThreads / CH;
  constexpr int ROWS = stage_rows<KT>();
  constexpr int LDT = ROWS + 8;             // row stride of the dS and P tiles, elements
  constexpr int PT = (KT + 1) / 2;          // k16 steps of dS K
  constexpr int QT = ROWS / 16;             // k16 steps of dS^T Q and P^T dO
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ int tok_s[kMaxTokens];         // token t of a window: (i << 8) | j
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ww = p.ww;
  const int row_tiles = (ww + 15) / 16;
  const bool busy = warp < row_tiles;       // this warp's query rows, then its key rows
  const int head = blockIdx.x / p.groups;
  const int first = blockIdx.x - head * p.groups;

  // everything zeroed once: rows past ww and the tiles' rows and keys past the products
  // stay zero for good
  const int total = p.ring_off + 2 * p.stage_bytes;
  for (int i = tid * 16; i < total; i += kThreads * 16) {
    *reinterpret_cast<uint4*>(smem_raw + i) = make_uint4(0, 0, 0, 0);
  }
  if (tid < ww) tok_s[tid] = ((tid / p.wwid) << 8) | (tid % p.wwid);
  int ti[row_passes<D>()], tj[row_passes<D>()];   // this thread's rows of every item
#pragma unroll
  for (int k = 0; k < row_passes<D>(); ++k) {
    const int row = tid / CH + k * RPP;
    ti[k] = row < ww ? row / p.wwid : -1;
    tj[k] = row < ww ? row % p.wwid : 0;
  }
  __syncthreads();
  const uint32_t smem_base = smem_u32(smem_raw);
  const uint32_t ring = smem_base + p.ring_off;
  // the block's constants and its first item, all in flight together
  {
    const float* col = p.table + head * p.t_head;
    for (int j = tid; j < p.t_rows; j += kThreads) {
      cp_async_4(smem_base + p.table_off + j * 4, col + j * p.t_row);
    }
    if (p.mask != nullptr && p.mask_fixed) {
      load_mask(p.mask, ww, first % p.n_mask, smem_base + p.fixed_mask_off, tid);
    }
    load_item<D, KT>(p, first, head, ring, tid, ti, tj);
    cp_async_commit();
    constexpr int kPasses = kMaxTokens * kMaxTokens / kThreads;
    const int n_index = ww * ww;
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
        const int r = i / ww;
        index_s[r * p.ld_idx + i - r * ww] = got[k];
      }
    }
  }
  const short* index_s = reinterpret_cast<const short*>(smem_raw);
  const float* tb = reinterpret_cast<const float*>(smem_raw + p.table_off);
  const bool masked = p.mask != nullptr;
  bf16* ds_tile = reinterpret_cast<bf16*>(smem_raw + p.tiles_off);
  bf16* p_tile = ds_tile + ROWS * LDT;
  const uint32_t ds_tile_u32 = smem_u32(ds_tile);
  const uint32_t p_tile_u32 = smem_u32(p_tile);
  bf16* dq_base = static_cast<bf16*>(p.dq) + head * p.gh;
  bf16* dk_base = static_cast<bf16*>(p.dk) + head * p.gh;
  bf16* dv_base = static_cast<bf16*>(p.dv) + head * p.gh;

  float acc[KT][4];                         // sums of dS over the block's windows
#pragma unroll
  for (int nt = 0; nt < KT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  int stage = 0;
  for (int n = first; n < p.windows; n += p.groups) {
    cp_async_wait<0>();
    __syncthreads();  // this item's stage has landed; every warp is done with the last item
    if (n + p.groups < p.windows) {
      load_item<D, KT>(p, n + p.groups, head, ring + (stage ^ 1) * p.stage_bytes, tid, ti, tj);
    }
    cp_async_commit();
    const uint32_t q_s = ring + stage * p.stage_bytes;
    const uint32_t k_s = q_s + ROWS * LD * 2;
    const uint32_t v_s = k_s + ROWS * LD * 2;
    const uint32_t do_s = v_s + ROWS * LD * 2;
    const Window w = window_of(p, n);

    // query phase: rows rt*16.. of this warp
    if (busy) {
      const int rt = warp;
      const float* mask_s =
          masked ? reinterpret_cast<const float*>(
                       smem_raw + (p.mask_fixed ? p.fixed_mask_off
                                                : p.ring_off + stage * p.stage_bytes +
                                                      p.stage_mask_off)) +
                       mask_delta(ww, w.mask_w)
                 : nullptr;
      uint32_t qf[D / 16][4];
      load_rows_a<D>(qf, q_s, rt, lane);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) scale_bf16(qf[kk], p.scale);
      float s[KT][4];
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      product_abt<D, KT>(s, qf, k_s, lane);
      float l[2], rl[2];
      softmax_exp<KT>(s, rt, lane, ww, index_s, p.ld_idx, tb, mask_s, masked, l, rl);
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = divide(s[nt][j], rl[j >> 1], l[j >> 1]);
      }

      // dP = dO V^T; D_i = sum_j P_ij dP_ij; dS = P (dP - D) over dP
      uint32_t dof[D / 16][4];
      load_rows_a<D>(dof, do_s, rt, lane);
      float dp[KT][4];
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      product_abt<D, KT>(dp, dof, v_s, lane);
      float dd[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        dd[0] = fmaf(s[nt][0], dp[nt][0], dd[0]);
        dd[0] = fmaf(s[nt][1], dp[nt][1], dd[0]);
        dd[1] = fmaf(s[nt][2], dp[nt][2], dd[1]);
        dd[1] = fmaf(s[nt][3], dp[nt][3], dd[1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dd[i] += __shfl_xor_sync(0xffffffffu, dd[i], 1);
        dd[i] += __shfl_xor_sync(0xffffffffu, dd[i], 2);
      }
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dp[nt][j] = s[nt][j] * (dp[nt][j] - dd[j >> 1]);
          if (kTable) acc[nt][j] += dp[nt][j];
        }
      }

      // the tiles: dS and (P)_bf16 of this warp's rows
#pragma unroll
      for (int nt = 0; nt < KT; ++nt) {
        const int at = (rt * 16 + g) * LDT + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ds_tile + at) = pack_f32(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(ds_tile + at + 8 * LDT) = pack_f32(dp[nt][2], dp[nt][3]);
        *reinterpret_cast<uint32_t*>(p_tile + at) = pack_f32(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(p_tile + at + 8 * LDT) = pack_f32(s[nt][2], s[nt][3]);
      }

      // dq = scale dS K
      uint32_t dsf[PT][4];
      pack_a<KT>(dsf, dp);
      float dq[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;
      product_ab<D, PT>(dq, dsf, k_s, lane);
      store_rows<D>(p, dq, p.scale, rt, lane, w, tok_s, dq_base);
    }
    __syncthreads();  // every warp's rows of the tiles are in

    // key phase: key rows jt*16.. of this warp; dk = dS^T (q scale), dv = P^T dO
    if (busy) {
      const int jt = warp;
      float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
        dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < QT; ++kc) {
        uint32_t da[4], pa[4];
        const int tr = kc * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
        const int tc = jt * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(da, ds_tile_u32 + (tr * LDT + tc) * 2);
        ldmatrix_x4_trans(pa, p_tile_u32 + (tr * LDT + tc) * 2);
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t qb[4], ob[4];
          const int r = kc * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int col = (dt + (lane >> 4)) * 8;
          ldmatrix_x4_trans(qb, q_s + (r * LD + col) * 2);
          ldmatrix_x4_trans(ob, do_s + (r * LD + col) * 2);
          scale_bf16(qb, p.scale);
          mma_bf16(dk[dt], da, qb[0], qb[1]);
          mma_bf16(dk[dt + 1], da, qb[2], qb[3]);
          mma_bf16(dv[dt], pa, ob[0], ob[1]);
          mma_bf16(dv[dt + 1], pa, ob[2], ob[3]);
        }
      }
      store_rows<D>(p, dk, 1.f, jt, lane, w, tok_s, dk_base);
      store_rows<D>(p, dv, 1.f, jt, lane, w, tok_s, dv_base);
    }
    stage ^= 1;
  }
  cp_async_wait<0>();

  if (kTable && busy) {
    float* out = p.dbias_part + static_cast<long long>(blockIdx.x) * ww * ww;
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = warp * 16 + g + (j >> 1) * 8;
        const int c = nt * 8 + 2 * t + (j & 1);
        if (r < ww && c < ww) out[r * ww + c] = acc[nt][j];
      }
    }
  }
}

// ---- the fp32 body --------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kF32Threads)
window_bwd_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ww = p.ww;
  float* qs = smem;                 // [ww][D]: q scale
  float* ks = qs + ww * D;
  float* vs = ks + ww * D;
  float* dos = vs + ww * D;
  float* ps = dos + ww * D;         // [ww][ld]: P, then dS
  float* accs = ps + ww * p.ld;     // [ww][ld]: the sum of dS over the block's windows

  const int head = blockIdx.x / p.groups;
  const int group = blockIdx.x - head * p.groups;
  const float* q = static_cast<const float*>(p.q) + head * p.sh;
  const float* k = static_cast<const float*>(p.k) + head * p.sh;
  const float* v = static_cast<const float*>(p.v) + head * p.sh;
  const float* dout = static_cast<const float*>(p.dout) + head * p.oh;
  const bool table_grad = p.dbias_part != nullptr;
  const int r = threadIdx.x;        // a query row in phases 1 and 3, a key row in 2 and 4
  const bool live = r < ww;
  const int ri = live ? r / p.wwid : 0;
  const int rj = live ? r - ri * p.wwid : 0;
  if (table_grad && live) {
    for (int j = 0; j < ww; ++j) accs[r * p.ld + j] = 0.f;
  }

  for (int n = group; n < p.windows; n += p.groups) {
    const Window w = window_of(p, n);
    for (int e = threadIdx.x; e < ww * D; e += blockDim.x) {
      const int t = e / D;
      const int d = e - t * D;
      const int ti = t / p.wwid;
      const int tj = t - ti * p.wwid;
      const long long off = token_offset(p, w, ti, tj, p.sb, p.sy, p.sx) + d;
      qs[e] = __fmul_rn(q[off], p.scale);
      ks[e] = k[off];
      vs[e] = v[off];
      dos[e] = dout[token_offset(p, w, ti, tj, p.ob, p.oy, p.ox) + d];
    }
    __syncthreads();

    const long long g_off = token_offset(p, w, ri, rj, p.gb, p.gy_s, p.gx_s) + head * p.gh;
    float dor[D];
    float dd = 0.f;

    // 1. S_i and P_i (as the forward computes them), O'_i = P_i V and D_i = dO_i . O'_i
    if (live) {
      float* prow = ps + r * p.ld;
      const short* idx = p.index + r * ww;
      const float* tb = p.table + head * p.t_head;
      const float* mrow =
          p.mask == nullptr ? nullptr : p.mask + (static_cast<long long>(w.mask_w) * ww + r) * ww;
      float qr[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qr[d] = qs[r * D + d];
        dor[d] = dos[r * D + d];
      }
      float m = kNegInf;
      for (int j = 0; j < ww; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
        s += tb[static_cast<unsigned short>(idx[j]) * p.t_row];
        if (mrow != nullptr) s += mrow[j];
        prow[j] = s;
        m = fmaxf(m, s);
      }
      float l = 0.f;
      for (int j = 0; j < ww; ++j) {
        const float e = expf(prow[j] - m);   // as the forward's fp32 kernel
        prow[j] = e;
        l += e;
      }
      float o[D];
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = 0.f;
      for (int j = 0; j < ww; ++j) {
        const float pj = __fdiv_rn(prow[j], l);
        prow[j] = pj;
#pragma unroll
        for (int d = 0; d < D; ++d) o[d] = fmaf(pj, vs[j * D + d], o[d]);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) dd = fmaf(dor[d], o[d], dd);
    }
    __syncthreads();

    // 2. dv_j = sum_i P_ij dO_i
    if (live) {
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int i = 0; i < ww; ++i) {
        const float pij = ps[i * p.ld + r];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(pij, dos[i * D + d], acc[d]);
      }
      float* dv = static_cast<float*>(p.dv) + g_off;
#pragma unroll
      for (int d = 0; d < D; ++d) dv[d] = acc[d];
    }
    __syncthreads();

    // 3. dS_i = P_i (dO_i V^T - D_i) over P_i; dq_i = scale dS_i K
    if (live) {
      float* prow = ps + r * p.ld;
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int j = 0; j < ww; ++j) {
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dp = fmaf(dor[d], vs[j * D + d], dp);
        const float ds = prow[j] * (dp - dd);
        prow[j] = ds;
        if (table_grad) accs[r * p.ld + j] += ds;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j * D + d], acc[d]);
      }
      float* dq = static_cast<float*>(p.dq) + g_off;
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = acc[d] * p.scale;
    }
    __syncthreads();

    // 4. dk_j = sum_i dS_ij (q scale)_i
    if (live) {
      float acc[D];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = 0.f;
      for (int i = 0; i < ww; ++i) {
        const float ds = ps[i * p.ld + r];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, qs[i * D + d], acc[d]);
      }
      float* dk = static_cast<float*>(p.dk) + g_off;
#pragma unroll
      for (int d = 0; d < D; ++d) dk[d] = acc[d];
    }
    __syncthreads();   // the next window's staging overwrites what phase 4 read
  }

  if (table_grad && live) {
    float* out = p.dbias_part + (static_cast<long long>(blockIdx.x) * ww + r) * ww;
    for (int j = 0; j < ww; ++j) out[j] = accs[r * p.ld + j];
  }
}

// ---- the table's gradient -------------------------------------------------------------------

constexpr int kSumLanes = 32;   // positions a block of table_sum_kernel
constexpr int kSumRows = 8;     // partials a block adds side by side

// dbias[h, t] = sum over g of part[h, g, t], t < ww^2: block (slice, h) takes 32 positions;
// row y of its threads adds partials y, y + 8, ... in order, then a fixed tree over the rows
__global__ void __launch_bounds__(kSumLanes * kSumRows)
table_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias, int groups,
                 int ww2) {
  __shared__ float rows[kSumRows][kSumLanes];
  const int x = threadIdx.x % kSumLanes;
  const int y = threadIdx.x / kSumLanes;
  const int h = blockIdx.y;
  const int t = blockIdx.x * kSumLanes + x;
  float s = 0.f;
  if (t < ww2) {
    const float* src = part + static_cast<long long>(h) * groups * ww2 + t;
    for (int g = y; g < groups; g += kSumRows) s += src[static_cast<long long>(g) * ww2];
  }
  rows[y][x] = s;
  __syncthreads();
#pragma unroll
  for (int half = kSumRows / 2; half > 0; half /= 2) {
    if (y < half) rows[y][x] += rows[y + half][x];
    __syncthreads();
  }
  if (y == 0 && t < ww2) dbias[static_cast<long long>(h) * ww2 + t] = rows[0][x];
}

// out[row, h] = sum of dbias[h, order[e]] over e in [offsets[row], offsets[row + 1]): a
// warp an output, lane l adding elements l, l + 32, ... of the run in order, then a fixed
// butterfly over the lanes
__global__ void table_gather_kernel(const float* __restrict__ dbias,
                                    const int* __restrict__ order,
                                    const int* __restrict__ offsets, float* __restrict__ out,
                                    int rows, int heads, int ww2) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (t >= rows * heads) return;   // the whole warp leaves together
  const int row = t / heads;
  const int h = t - row * heads;
  float s = 0.f;
  for (int e = offsets[row] + lane; e < offsets[row + 1]; e += 32) s += dbias[h * ww2 + order[e]];
#pragma unroll
  for (int m = 16; m > 0; m /= 2) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) out[t] = s;
}

// ---- host side ------------------------------------------------------------------------------

// The bf16 body's shared memory at a shape, bytes; the offsets go to p where it is given.
int bf16_smem(int ww, int head_dim, int t_rows, bool masked, bool mask_fixed, Params* p) {
  const int kt = key_tiles(ww);
  const int rows = round_up(kt * 8, 16);
  const int ld_idx = kt * 8 % 16 == 0 ? kt * 8 + 8 : kt * 8;
  const int table_off = round_up(ww * ld_idx * 2, 16);
  const int fixed_mask_off = table_off + round_up(t_rows * 4, 16);
  const int tiles_off = fixed_mask_off + (masked && mask_fixed ? mask_stage_bytes(ww) : 0);
  const int ring_off = tiles_off + 2 * rows * (rows + 8) * 2;
  const int stage_mask_off = 4 * rows * (head_dim + kPad) * 2;
  const int stage_bytes = stage_mask_off + (masked && !mask_fixed ? mask_stage_bytes(ww) : 0);
  if (p != nullptr) {
    p->ld_idx = ld_idx;
    p->table_off = table_off;
    p->fixed_mask_off = fixed_mask_off;
    p->tiles_off = tiles_off;
    p->ring_off = ring_off;
    p->stage_mask_off = stage_mask_off;
    p->stage_bytes = stage_bytes;
  }
  return ring_off + 2 * stage_bytes;
}

int f32_smem(int ww, int head_dim, bool table_grad) {
  const int ld = ww % 2 == 1 ? ww : ww + 1;
  return (4 * ww * head_dim + (table_grad ? 2 : 1) * ww * ld) * 4;
}

// Sets a kernel's dynamic shared-memory limit on this device, once.
template <typename K>
cudaError_t configure(K kernel, int bytes, bool (&done)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

// the bf16 body for (D, KT, table); `resident` != null: only how many blocks of it fit
template <int D, int KT, bool kTable>
cudaError_t run_bf16(const Params& p, int smem, cudaStream_t stream, int device, int* resident) {
  auto kernel = window_bwd_bf16_kernel<D, KT, kTable>;
  static bool configured[kMaxDevices] = {};
  const int dynamic_max = kMaxSmem - static_cast<int>(kMaxTokens * sizeof(int));
  if (smem > dynamic_max) return cudaErrorInvalidValue;
  cudaError_t err = configure(kernel, dynamic_max, configured, device);
  if (err != cudaSuccess) return err;
  if (resident != nullptr) {
    *resident = resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem, device);
    return *resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }
  kernel<<<static_cast<unsigned>(p.groups) * p.heads, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_f32(const Params& p, cudaStream_t stream, int device, int* resident) {
  auto kernel = window_bwd_f32_kernel<D>;
  static bool configured[kMaxDevices] = {};
  const int most = f32_smem(kMaxTokens, D, true) + kMaxTokens * 4;
  cudaError_t err = configure(kernel, most, configured, device);
  if (err != cudaSuccess) return err;
  const int smem = f32_smem(p.ww, D, p.dbias_part != nullptr);
  if (resident != nullptr) {
    *resident = resident_blocks(reinterpret_cast<const void*>(kernel), kF32Threads, smem, device);
    return *resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  }
  kernel<<<static_cast<unsigned>(p.groups) * p.heads, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kTable>
cudaError_t run_kt(int kt, const Params& p, int smem, cudaStream_t s, int device, int* resident) {
  switch (kt) {
    case 2: return run_bf16<D, 2, kTable>(p, smem, s, device, resident);
    case 4: return run_bf16<D, 4, kTable>(p, smem, s, device, resident);
    case 7: return run_bf16<D, 7, kTable>(p, smem, s, device, resident);
    case 8: return run_bf16<D, 8, kTable>(p, smem, s, device, resident);
    default: return cudaErrorInvalidValue;
  }
}

// The launch, or with `resident` the blocks of the body that fit the card. p holds the
// shape; its table, mask and offsets are filled here.
cudaError_t dispatch(int dtype, int head_dim, Params& p, cudaStream_t s, int device,
                     int* resident) {
  if (dtype == 1) {
    p.ld = p.ww % 2 == 1 ? p.ww : p.ww + 1;
    switch (head_dim) {
      case 16: return run_f32<16>(p, s, device, resident);
      case 32: return run_f32<32>(p, s, device, resident);
      default: return cudaErrorInvalidValue;
    }
  }
  const int smem = bf16_smem(p.ww, head_dim, p.t_rows, p.mask != nullptr, p.mask_fixed, &p);
  const int kt = key_tiles(p.ww);
  const bool table = p.dbias_part != nullptr || resident != nullptr;
  switch (head_dim * 2 + (table ? 1 : 0)) {
    case 32: return run_kt<16, false>(kt, p, smem, s, device, resident);
    case 33: return run_kt<16, true>(kt, p, smem, s, device, resident);
    case 64: return run_kt<32, false>(kt, p, smem, s, device, resident);
    case 65: return run_kt<32, true>(kt, p, smem, s, device, resident);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Blocks of the backward's body for this dtype (0 = bf16, 1 = fp32) and shape that fit
// the card at once, in the form with the table's gradient (the larger); masked: a mask is
// read, mask_fixed: kept once a block (else staged with each item). A negative
// cudaError_t where the runtime cannot say. The planner in ops/window_attention.py makes
// the grid of heads x G blocks from it.
int ics_window_attention_bwd_resident(int dtype, int head_dim, int ww, int t_rows, int masked,
                                      int mask_fixed, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return -static_cast<int>(err);
  if ((dtype != 0 && dtype != 1) || ww <= 0 || ww > kMaxTokens || t_rows <= 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.ww = ww;
  p.t_rows = t_rows;
  p.mask = masked ? reinterpret_cast<const float*>(16) : nullptr;   // only its presence counts
  p.mask_fixed = mask_fixed != 0;
  p.dbias_part = reinterpret_cast<float*>(16);
  int resident = 0;
  err = dispatch(dtype, head_dim, p, nullptr, device, &resident);
  return err == cudaSuccess ? resident : -static_cast<int>(err);
}

// dtype: 0 = bf16, 1 = fp32, of q, k, v, dout, dq, dk and dv. Token (y, x) of image b,
// head h of q lies at q + b sb + y sy + x sx + h sh (elements; the same strides for k and
// v), its head_dim values contiguous; dout's by ob, oy, ox, oh, and dq's, dk's and dv's
// by gb, gys, gxs, gh; for bf16 every row 16-byte aligned. Grid, windows, shift, table,
// index, mask and scale as ics_window_attention takes them (t_rows: the table's rows).
// groups: blocks a head, 1 to the windows of the call; block g of a head takes windows g,
// g + groups, ... dbias_part: null, or [heads, groups, ww, ww] fp32 for the sums of dS over
// each block's windows. Returns a cudaError_t; 0 when the launch was accepted.
int ics_window_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv, long long sb,
                             long long sy, long long sx, long long sh, long long ob,
                             long long oy, long long ox, long long oh, long long gb,
                             long long gys, long long gxs, long long gh, int batch, int gy,
                             int gx, int wh, int wwid, int shift, int heads, int head_dim,
                             const void* table, long long t_row, long long t_head, int t_rows,
                             const void* index, const void* mask, int n_mask, float scale,
                             void* dbias_part, int groups, void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || heads <= 0) return 0;
  const int ww = wh * wwid;
  if (wh <= 0 || wwid <= 0 || ww > kMaxTokens || gy % wh != 0 || gx % wwid != 0 ||
      shift < 0 || shift >= wh || shift >= wwid || t_rows <= 0 ||
      (mask != nullptr && n_mask <= 0) ||
      (dtype == 0 && reinterpret_cast<uintptr_t>(mask) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sb = sb;
  p.sy = sy;
  p.sx = sx;
  p.sh = sh;
  p.ob = ob;
  p.oy = oy;
  p.ox = ox;
  p.oh = oh;
  p.gb = gb;
  p.gy_s = gys;
  p.gx_s = gxs;
  p.gh = gh;
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
  const long long windows = static_cast<long long>(batch) * p.nw_img;
  if (windows > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  p.windows = static_cast<int>(windows);
  p.dbias_part = static_cast<float*>(dbias_part);
  p.groups = groups;
  if (groups <= 0 || groups > p.windows || static_cast<long long>(groups) * heads > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.mask_fixed = mask != nullptr && groups % p.n_mask == 0;
  return static_cast<int>(
      dispatch(dtype, head_dim, p, static_cast<cudaStream_t>(stream), device, nullptr));
}

// The table gradient from the partial sums that ics_window_attention_bwd wrote: part
// [heads, groups, ww, ww] fp32 -> dbias [heads, ww, ww] fp32 (scratch) -> out [rows,
// heads] fp32, contiguous. order: the ww^2 positions of the index sorted by table row
// (stable), offsets: [rows + 1] starts of each row's run in order, both int32. Two
// launches on the stream. Returns a cudaError_t; 0 when both were accepted.
int ics_window_attention_dtable(const void* part, int groups, int heads, int ww, void* dbias,
                                const void* order, const void* offsets, int rows, void* out,
                                void* stream, int device) {
  const ics::DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups <= 0 || heads <= 0 || heads > 65535 || ww <= 0 || ww > kMaxTokens || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ww2 = ww * ww;
  table_sum_kernel<<<dim3((ww2 + kSumLanes - 1) / kSumLanes, heads), kSumLanes * kSumRows, 0,
                     s>>>(static_cast<const float*>(part), static_cast<float*>(dbias), groups,
                          ww2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  table_gather_kernel<<<(rows * heads * 32 + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(dbias), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<float*>(out), rows, heads, ww2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
