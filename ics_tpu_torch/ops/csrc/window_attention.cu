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

#include "window_tile.cuh"
#include "device_guard.cuh"

namespace {

using namespace ics;
using namespace ics::window;
using bf16 = __nv_bfloat16;

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
  if (p.mask != nullptr) load_mask(p.mask, p.ww, w.mask_w, stage_base + p.mask_off, tid);
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
                        (masked ? mask_delta(ww, n % p.n_mask) : 0);
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
    load_rows_a<D>(qf, q_s, rt, lane);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) scale_bf16(qf[kk], p.scale);

    // S = Q K^T, 16 rows x 8 KT keys, then the softmax's numerators and row sums
    float s[KT][4];
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    product_abt<D, KT>(s, qf, k_s, lane);
    float l[2], rl[2];
    softmax_exp<KT>(s, rt, lane, ww, index_s, ld, tb, mask_s, masked, l, rl);

    // P = exp / sum, rounded to bf16 as the A fragments of P.V
#pragma unroll
    for (int nt = 0; nt < KT; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] = divide(s[nt][j], rl[j >> 1], l[j >> 1]);
    }
    uint32_t pf[PT][4];
    pack_a<KT>(pf, s);

    // O = P V
    float o[D / 8][4];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    product_ab<D, PT>(o, pf, v_s, lane);

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
  const int resident =
      resident_blocks(reinterpret_cast<const void*>(kernel), kThreads, smem, device);
  if (resident <= 0) return cudaErrorInvalidConfiguration;
  // as many blocks as fit, each with the same number of items give or take one
  int blocks = p.n_items < resident ? p.n_items : resident;
  const int per_block = (p.n_items + blocks - 1) / blocks;
  blocks = (p.n_items + per_block - 1) / per_block;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, int kt, const Params& p, cudaStream_t stream, int device) {
  if (dtype == 1) {
    window_f32_kernel<D><<<p.n_items, kMaxTokens, 0, stream>>>(p);
    return cudaGetLastError();
  }
  switch (kt) {
    case 2: return launch_bf16<D, 2>(p, stream, device);
    case 4: return launch_bf16<D, 4>(p, stream, device);
    case 7: return launch_bf16<D, 7>(p, stream, device);
    case 8: return launch_bf16<D, 8>(p, stream, device);
    default: return cudaErrorInvalidValue;
  }
}

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
  const int kt = key_tiles(ww);
  p.ld_idx = kt * 8 % 16 == 0 ? kt * 8 + 8 : kt * 8;
  p.index_bytes = round_up(ww * p.ld_idx * 2, 16);
  p.table_off = p.head_group * 3 * round_up(kt * 8, 16) * (head_dim + kPad) * 2;
  p.mask_off = p.table_off + round_up(p.head_group * t_rows * 4, 16);
  // the mask's pieces (3 floats at most before the block), and room behind
  // them for the last row's keys past ww, read and dropped
  p.stage_bytes = p.mask_off + (mask != nullptr ? mask_stage_bytes(ww) : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return static_cast<int>(launch<16>(dtype, kt, p, s, device));
    case 32: return static_cast<int>(launch<32>(dtype, kt, p, s, device));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
