// Fused block-sparse attention over a static BCSR mask schedule, for NVIDIA
// Hopper (sm_90a): kernel B5, the SDDMM scores, the masked block softmax and
// the context SpMM of one (instance, block-row) in one launch, with no score
// or probability block written to device memory.
//
// Replaces the Pallas TPU kernel `bcsr_attn_fused`
// (src/repro/kernels/bcsr_attn.py:60 `_attn_fused_kernel`, :132 the
// wrapper).  That kernel runs the grid (G, nbr, 3, max_bpr) in order and
// carries the row max m, the denominator l and the context accumulator in
// VMEM from one grid step to the next: phase 0 takes m over the block-row's
// slots (clamped >= -1e30), phase 1 sums l = sum exp(logit - m) (clamped >=
// 1e-30), phase 2 adds (exp(logit - m) / l) @ V.  On the card CTAs run in
// parallel and in no order, so nothing carries between them: one CTA owns
// up to 128 query rows of one block-row of one instance and walks the row's
// live slots itself, in two passes:
//   pass 1: S = Q K^T per slot, the exact row max m over every live slot;
//   pass 2: S again (bit for bit the same), z = exp(S - m) where the mask
//           allows it, l += rowsum(z) and acc += z V together;
// then out = acc / max(l, 1e-30), one division per element at the end.
// The max stays exact, so there is no flash-style rescaling; against the
// TPU kernel's order (divide z by l, then multiply by V) only where the
// division rounds differs (ROADMAP C, carve-out 2).  A sentinel slot
// (flat_idx == nnzb, padding of a short row) is dropped from the CTA's slot
// list: on the TPU it adds exact +0 terms and never raises m, so this is
// exact; a row with no valid element ends at m = -1e30, l = 1e-30 and a
// zero context, as there.  No atomics, and every sum runs in a fixed order:
// two launches give the same bits.
//
// Layout: grid (nbr * slices, G, ceil(dv / 128)); W = min(8, ceil(h / 16))
// warps, warp k owning query rows 16k .. 16k + 15 of the slice (a 128-row
// block is one CTA of 8 warps).  A slot's keys are walked in key tiles of
// 32: each warp holds its 16 x 32 score tile and its 16 x 128 context tile
// in registers (grid z covers dv > 128), with no register spills.
// Shared memory holds the Q slice [16W, d] (staged once) and a 3-slot
// cp.async ring of chunks that runs across key tiles, slots and passes: a
// K chunk is a key tile's 32 keys x 128 columns of d (two chunks at d =
// 256), a V chunk its 32 keys x 128 columns of dv; 122 KB at d = 128 (187
// KB at d = 256).  Rows, keys and columns past h, w, Lq, Lk, d and dv are
// staged as zeros (a cp.async source size of 0) and not written.
//
// Products: Q K^T and z V on mma.sync m16n8k8 TF32 as 3xTF32 (hi*hi +
// hi*lo + lo*hi), since the contract is an f32 attention.  The tensor
// cores' f32 sums truncate, so each tile's sum over 32 terms starts from
// zero and is added to S or the context with a round-to-nearest add.
// mma.sync accumulates in place, so products into one tile form a
// dependency chain: each term is issued over four tiles before the next.
// z goes from the score accumulators to the A operand of z V in
// registers, without shuffles or shared memory: each k8 step reads its
// keys in the order (2t, 2t + 1) for t = 0 .. 3, which is the order an
// accumulator tile holds them, and V's fragment loads follow that order
// (the order within a step does not change the sum's operands).  Q and K
// fragments use the same order, so each is one 8-byte load.  Row strides
// are padded so that the fragment loads are free of bank conflicts.
//
// Masking: `ebits`, one bit per element, [nnzb(+1), h, ceil(w / 32)]
// int32 words (bit c % 32 of word c / 32 is element c of a row): 2 KB a
// 128 x 128 block in place of the f32 mask's 64 KB.  Each thread loads its
// two rows' word of a key tile while the tile's K chunks are multiplied.
//
// Bound on this card: operations.  At smat-attn-1.3b's full width (G = 16
// instances, L = 8192, d = dv = 128, banded(4096) in 128x128 blocks: 1584
// stored blocks) one launch reads q, k, v, the bitmask and the schedule
// and writes out, about 28 MB (8 us at the H100 SXM datasheet's 3.35
// TB/s); its useful work is Q K^T once and P V once per stored block, 2 *
// 2 * 128^3 operations per block per instance, about 213 GFLOP: 1.29 ms at
// the 3xTF32 rate (a third of 495 TFLOP/s).  This design runs Q K^T twice,
// so it does 1.5 times that work: 1.93 ms at best.  Left for later: wgmma
// with TMA loads and a warp-specialised producer (mma.sync does not reach
// the card's TF32 rate), and more warps an SM (registers bind it to 8).
#include "spmm_tile.cuh"

namespace {

using spmm_tile::cdiv;
using spmm_tile::cp_async_commit;
using spmm_tile::cp_async_wait;
using spmm_tile::mma_tf32;
using spmm_tile::stage_copy;

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxW = 128;               // widest block the kernel holds
constexpr int kMaxD = 256;               // widest q/k and v rows
constexpr int kKT = 32;                  // keys of a key tile
constexpr int kNT = kKT / 8;             // score n8 tiles a warp holds (4)
constexpr int kDVT = 128;                // context columns a CTA owns
constexpr int kVT = kDVT / 8;            // context n8 tiles a warp holds
constexpr int kKC = 128;                 // d columns of a K chunk
constexpr int kKStride = kKC + 8;        // K chunk rows: 8 banks mod 32
constexpr int kVStride = kDVT + 4;       // V chunk rows: 4 banks mod 32
constexpr int kSlotFloats = kKT * kKStride > kKT * kVStride
                                ? kKT * kKStride : kKT * kVStride;
constexpr int kStages = 3;               // chunk slots in the ring
constexpr float kNegInf = -2.0e38f;      // the mask's NEG_INF

struct Args {
  const float* q;          // [G, lq, d]
  const float* k;          // [G, lk, d]
  const float* v;          // [G, lk, dv]
  const unsigned* ebits;   // [nnzb(+1), h, words]
  const int* flat_idx;     // [nbr * max_bpr], padding = nnzb
  const int* flat_col;     // [nbr * max_bpr]
  float* out;              // [G, lq, dv]
  int lq, lk, d, dv, h, w, words, nnzb, max_bpr, warps, slices, vec;
  float scale, cap;
  int use_cap;
};

// x = hi + lo for 3xTF32: hi is x rounded to TF32 (to nearest, ties away,
// as cvt.rna) by an integer add and mask, lo = x - hi exactly, handed to
// the tensor cores as it is: they read the top 19 bits of an operand
// (CUTLASS's fast 3xTF32 split): fewer instructions than spmm_tile.cuh's
// cvt pair, and every warp splits every K and V fragment it reads.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Stage `rows` x `cols` floats (element (r, c) from src[r * ld + c], valid
// while r < rv and c < cv, else zeros) into dst[r * stride + c]; `safe` is
// an aligned address inside the operand, read by no copy.  COLS > 0 fixes
// the columns at compile time (the ring's chunks), 0 takes `cols`.
template <int VEC, int COLS>
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      long long ld, int rows, int cols,
                                      int rv, int cv, int nthreads,
                                      const float* safe) {
  constexpr int kVE = VEC / 4;
  const int per_row = COLS > 0 ? COLS / kVE : cols / kVE;
  for (int e = threadIdx.x; e < rows * per_row; e += nthreads) {
    const int r = e / per_row, c = (e % per_row) * kVE;
    const bool valid = r < rv && c < cv;
    stage_copy<VEC>(dst + r * stride + c, valid ? src + r * ld + c : safe,
                    valid, safe);
  }
}

template <int COLS>
__device__ __forceinline__ void stage_any(int vec, float* dst, int stride,
                                          const float* src, long long ld,
                                          int rows, int cols, int rv, int cv,
                                          int nthreads, const float* safe) {
  if (vec == 16)
    stage<16, COLS>(dst, stride, src, ld, rows, cols, rv, cv, nthreads,
                    safe);
  else
    stage<4, COLS>(dst, stride, src, ld, rows, cols, rv, cv, nthreads, safe);
}

// t[n] += A B_n for the four n8 tiles of one k8 step, as 3xTF32: the
// terms lo*hi, hi*lo, hi*hi, each issued over all four tiles before the
// next, so that no product waits on the one before it.
__device__ __forceinline__ void mma3(float (&t)[4][4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[4][2],
                                     const uint32_t (&blo)[4][2]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(t[n], alo, bhi[n][0], bhi[n][1]);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(t[n], ahi, blo[n][0], blo[n][1]);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_tf32(t[n], ahi, bhi[n][0], bhi[n][1]);
}

// S += Q[rows, d0 .. d0 + 32 * nsub] K_chunk^T over the key tile's 4
// score tiles (keys past the block's w and columns past d are zeros; the
// mask drops them).  Keys of a k8 step in the order (2t, 2t + 1): one
// 8-byte load per fragment pair.  Each tile's sum over 32 columns of d is
// taken from zero on the tensor cores, then added to S with one
// round-to-nearest add.
__device__ __forceinline__ void qk_chunk(float (&S)[kNT][4], const float* q_s,
                                         int qs, const float* k_s, int d0,
                                         int nsub, int row) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll 1
  for (int sc = 0; sc < nsub; ++sc) {
    float t[kNT][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = sc * 32 + ks * 8 + 2 * tig;
      const float2 x0 =
          *reinterpret_cast<const float2*>(q_s + row * qs + d0 + k);
      const float2 x1 =
          *reinterpret_cast<const float2*>(q_s + (row + 8) * qs + d0 + k);
      uint32_t ahi[4], alo[4], bhi[kNT][2], blo[kNT][2];
      split_tf32(x0.x, ahi[0], alo[0]);
      split_tf32(x1.x, ahi[1], alo[1]);
      split_tf32(x0.y, ahi[2], alo[2]);
      split_tf32(x1.y, ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float2 b = *reinterpret_cast<const float2*>(
            k_s + (n * 8 + gid) * kKStride + k);
        split_tf32(b.x, bhi[n][0], blo[n][0]);
        split_tf32(b.y, bhi[n][1], blo[n][1]);
      }
      mma3(t, ahi, alo, bhi, blo);
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] += t[n][q];
  }
}

// O += z V_chunk over the key tile's 32 keys, in groups of four context
// tiles.  z's A fragment of k8 step kk is score tile kk's accumulators:
// keys 8kk + 2t and 8kk + 2t + 1 of rows g and g + 8 (zeros past the
// block's w, whose V rows are zeros too).  Sums as in qk_chunk, over 32
// keys.
__device__ __forceinline__ void pv_chunk(float (&O)[kVT][4],
                                         const float (&S)[kNT][4],
                                         const float* v_s) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const float* vp = v_s + 2 * tig * kVStride + gid;
#pragma unroll
  for (int grp = 0; grp < kVT / 4; ++grp) {
    float t[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ahi[4], alo[4], bhi[4][2], blo[4][2];
      split_tf32(S[kk][0], ahi[0], alo[0]);
      split_tf32(S[kk][2], ahi[1], alo[1]);
      split_tf32(S[kk][1], ahi[2], alo[2]);
      split_tf32(S[kk][3], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float* bp = vp + kk * 8 * kVStride + (grp * 4 + n) * 8;
        split_tf32(bp[0], bhi[n][0], blo[n][0]);
        split_tf32(bp[kVStride], bhi[n][1], blo[n][1]);
      }
      mma3(t, ahi, alo, bhi, blo);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) O[grp * 4 + n][q] += t[n][q];
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__global__ void __launch_bounds__(kMaxThreads, 1) attn_fused_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int nthreads = 32 * a.warps;
  const int rows_cta = 16 * a.warps;
  const int dq = cdiv(a.d, 32) * 32;
  const int qs = dq + 8;                         // Q rows: 8 banks mod 32
  float* q_s = smem;                             // [rows_cta][qs]
  float* ring = q_s + rows_cta * qs;             // kStages x kSlotFloats
  int* live_idx = reinterpret_cast<int*>(ring + kStages * kSlotFloats);
  int* live_col = live_idx + a.max_bpr;
  __shared__ int n_live;

  const int g = blockIdx.y;
  const int i = blockIdx.x / a.slices;
  const int r0 = (blockIdx.x % a.slices) * rows_cta;  // first row in block
  const int dv0 = blockIdx.z * kDVT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long long q0 = (long long)i * a.h + r0;       // first query row
  const float* qg = a.q + (long long)g * a.lq * a.d;
  const float* kg = a.k + (long long)g * a.lk * a.d;
  const float* vg = a.v + (long long)g * a.lk * a.dv;

  // the row's live slots, in schedule order
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < a.max_bpr; ++t) {
      const long long f = (long long)i * a.max_bpr + t;
      const int idx = a.flat_idx[f];
      if (idx >= a.nnzb) continue;       // sentinel slot: adds nothing
      live_idx[n] = idx;
      live_col[n] = a.flat_col[f];
      ++n;
    }
    n_live = n;
  }
  // the Q slice, zeros past h, Lq and d (its own cp.async group)
  const int q_rows = (int)min((long long)min(rows_cta, a.h - r0),
                              (long long)a.lq - q0);
  stage_any<0>(a.vec, q_s, qs, qg + q0 * a.d, a.d, rows_cta, dq, q_rows,
               a.d, nthreads, qg);
  cp_async_commit();
  __syncthreads();

  // the chunk sequence over every (live slot, key tile) unit: pass 1 walks
  // each unit's nkc K chunks, pass 2 its nkc K chunks and then its V chunk
  const int nkt = cdiv(a.w, kKT);                // key tiles a slot
  const int units = n_live * nkt;
  const int nkc = cdiv(a.d, kKC);                // K chunks a unit
  const int pass1 = units * nkc;
  const int total = pass1 + units * (nkc + 1);
  const int nvts = cdiv(min(kDVT, a.dv - dv0), 8);   // context tiles

  // a position in the chunk sequence, advanced one chunk at a time
  struct Cursor {
    int pass, slot, kt, c;     // c == nkc: the unit's V chunk
  };
  auto advance = [&](Cursor& u) {
    if (++u.c < nkc + u.pass) return;
    u.c = 0;
    if (++u.kt < nkt) return;
    u.kt = 0;
    if (++u.slot < n_live) return;
    u.slot = 0;
    ++u.pass;
  };
  auto issue = [&](const Cursor& u, int j) {
    float* dst = ring + (j % kStages) * kSlotFloats;
    const long long key0 = (long long)live_col[u.slot] * a.w + u.kt * kKT;
    const int keys = (int)min((long long)(a.w - u.kt * kKT), a.lk - key0);
    if (u.c < nkc) {         // [kKT keys][kKC columns of d]
      const int c0 = u.c * kKC;
      stage_any<kKC>(a.vec, dst, kKStride, kg + key0 * a.d + c0, a.d, kKT,
                     kKC, keys, a.d - c0, nthreads, kg);
    } else {                 // [kKT keys][kDVT columns of dv]
      stage_any<kDVT>(a.vec, dst, kVStride, vg + key0 * a.dv + dv0, a.dv,
                      kKT, kDVT, keys, a.dv - dv0, nthreads, vg);
    }
  };

  const int row = warp * 16 + gid;       // this thread's rows: row, row + 8
  bool row_ok[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) row_ok[rr] = r0 + row + 8 * rr < a.h;
  float S[kNT][4], O[kVT][4];
#pragma unroll
  for (int t = 0; t < kVT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) O[t][q] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  unsigned bits[2][kKT / 32];

  // j < 0: the prologue fills kStages - 1 slots; then each step waits for
  // chunk j, refills the slot chunk j - 1 used, and consumes chunk j
  Cursor in{0, 0, 0, 0}, at{0, 0, 0, 0};   // chunk to issue; to consume
  for (int j = 1 - kStages; j < total; ++j) {
    if (j >= 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();         // chunk j landed; chunk j - 1's slot is free
    }
    if (j + kStages - 1 < total) {
      issue(in, j + kStages - 1);
      advance(in);
    }
    cp_async_commit();
    if (j < 0) continue;
    const Cursor ch = at;
    advance(at);
    const float* buf = ring + (j % kStages) * kSlotFloats;
    if (ch.c == nkc) {         // the V chunk; constant tile indices into S
      pv_chunk(O, S, buf);
      continue;
    }
    if (ch.c == 0) {           // a unit's first K chunk: fresh scores
#pragma unroll
      for (int t = 0; t < kNT; ++t)
#pragma unroll
        for (int q = 0; q < 4; ++q) S[t][q] = 0.f;
      const unsigned* eb =
          a.ebits + (long long)live_idx[ch.slot] * a.h * a.words;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int wd = 0; wd < kKT / 32; ++wd) {
          const int word = ch.kt * (kKT / 32) + wd;
          bits[rr][wd] = row_ok[rr] && word < a.words
                             ? eb[(long long)(r0 + row + 8 * rr) * a.words +
                                  word]
                             : 0u;
        }
    }
    qk_chunk(S, q_s, qs, buf, ch.c * kKC, min(kKC, dq - ch.c * kKC) / 32,
             row);
    if (ch.c != nkc - 1) continue;
    // the unit's scores are complete: logits (scale, cap, mask)
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = q / 2, col = t * 8 + 2 * tig + q % 2;
        const bool ok = (bits[rr][col / 32] >> (col % 32)) & 1u;
        float s = S[t][q] * a.scale;
        if (a.use_cap) s = a.cap * tanhf(s / a.cap);
        if (ch.pass == 0) {
          m[rr] = fmaxf(m[rr], ok ? s : kNegInf);
        } else {
          const float z = ok ? expf(s - m[rr]) : 0.f;
          l[rr] += z;
          S[t][q] = z;
        }
      }
    }
    if (j == pass1 - 1) {      // pass 1 ends: the row max
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) m[rr] = fmaxf(quad_max(m[rr]), -1e30f);
    }
  }
  cp_async_wait<0>();

  float* og = a.out + (long long)g * a.lq * a.dv;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float den = fmaxf(quad_sum(l[rr]), 1e-30f);
    const long long qr = q0 + row + 8 * rr;
    if (!row_ok[rr] || qr >= a.lq) continue;
#pragma unroll
    for (int t = 0; t < kVT; ++t) {
      const int col = dv0 + t * 8 + 2 * tig;
      if (t >= nvts) break;
      if (col < a.dv) og[qr * a.dv + col] = O[t][2 * rr] / den;
      if (col + 1 < a.dv) og[qr * a.dv + col + 1] = O[t][2 * rr + 1] / den;
    }
  }
}

int warps_for(int h) { return h >= 16 * kMaxWarps ? kMaxWarps : cdiv(h, 16); }

// Shared memory one CTA needs for these widths and schedule length, bytes.
long long smem_bytes(int d, int h, int max_bpr) {
  return 4LL * (16LL * warps_for(h) * (cdiv(d, 32) * 32 + 8) +
                (long long)kStages * kSlotFloats) +
         8LL * max_bpr;
}

}  // namespace

// q, k, v and out are float32 and contiguous, ebits int32 [nnzb(+1), h,
// ceil(w / 32)]; flat_idx and flat_col int32, nbr * max_bpr slots (padding
// slots hold the sentinel nnzb).  `vec`: 16 where q, k, v are 16-byte
// aligned and d, dv are multiples of 4, else 4.  Returns the launch's
// cudaError_t (0 = launched); cudaErrorInvalidValue for widths the kernel
// does not hold (d or dv above 256, w above 128).
extern "C" int bcsr_attn_fused(const void* q, const void* k, const void* v,
                               const void* ebits, const void* flat_idx,
                               const void* flat_col, void* out, int G,
                               int lq, int lk, int d, int dv, int nbr,
                               int max_bpr, int h, int w, int nnzb,
                               float scale, float cap, int use_cap, int vec,
                               void* stream) {
  if (d < 1 || d > kMaxD || dv < 1 || dv > kMaxD || w < 1 || w > kMaxW ||
      h < 1 || max_bpr < 1 || (vec != 16 && vec != 4))
    return cudaErrorInvalidValue;
  if (vec == 16 && (d % 4 || dv % 4 || !spmm_tile::aligned(q, 16) ||
                    !spmm_tile::aligned(k, 16) || !spmm_tile::aligned(v, 16)))
    return cudaErrorInvalidValue;
  const int warps = warps_for(h);
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const unsigned*>(ebits),
         static_cast<const int*>(flat_idx), static_cast<const int*>(flat_col),
         static_cast<float*>(out), lq, lk, d, dv, h, w, cdiv(w, 32), nnzb,
         max_bpr, warps, cdiv(h, 16 * warps), vec, scale, cap, use_cap};
  const long long smem = smem_bytes(d, h, max_bpr);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    // a refused size (past the card's 227 KB, analysis/workspace.py
    // attn_max_bpr) is this call's error, not the next launch's: clear it
    cudaGetLastError();
    return err;
  }
  dim3 grid(nbr * a.slices, G, cdiv(dv, kDVT));
  attn_fused_kernel<<<grid, 32 * warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The static analyzer's queries (analysis/workspace.py mirrors them): the
// dynamic shared memory of a launch at these widths and schedule length,
// bytes, and its threads a CTA.
extern "C" int bcsr_attn_fused_smem_bytes(int d, int h, int max_bpr) {
  return static_cast<int>(smem_bytes(d, h, max_bpr));
}

extern "C" int bcsr_attn_fused_threads(int h) { return 32 * warps_for(h); }
