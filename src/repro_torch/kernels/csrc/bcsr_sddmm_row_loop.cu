// BCSR SDDMM through SMaT's static schedule, for NVIDIA Hopper (sm_90a):
// kernel B4.  Slot t of block-row i computes dC[block i] @ B[block
// flat_col[i*max_bpr+t]]^T into output entry flat_idx[i*max_bpr+t], the
// weight gradient of a block-sparse layer under the `row_loop` backend
// (and the attention backward's score products there).
//
// Replaces the Pallas TPU kernel `bcsr_sddmm_row_loop`
// (src/repro/kernels/bcsr_spmm.py:227 `_sddmm_row_loop_kernel`, :246 the
// wrapper).  That kernel runs the static 2D (block-row x slot) grid of
// `bcsr_spmm_row_loop`, (nbr, max_bpr, N/bn), and carries an f32 [h, w]
// accumulator in VMEM over the sequential N axis.  A padding slot
// (t >= row_len[i]) still computes its product and writes it to the
// sentinel entry nnzb of an [nnzb+1, h, w] output, which the wrapper
// slices off: the static schedule's waste on short rows.  On the card,
// CTAs run in parallel and in no order, so one CTA owns one 64 x 64 tile of
// one slot and walks N itself; a CTA whose slot holds the sentinel returns
// before its first load, so padding slots compute nothing and nothing
// writes the sentinel (the output is [nnzb, h, w]).  Live slots name
// distinct entries: no atomics, bit-stable across calls.
//
// Layout: kernel B2's (bcsr_sddmm.cu) -- the same tile routine of
// sddmm_tile.cuh: 4 warps of 32 x 32 over the tile, a 3-slot cp.async ring
// of N chunks with zero-fill past h, w and N, each operand staged along its
// contiguous axis, bf16 on mma.sync m16n8k16, f32 as 3xTF32 with B2's
// split and round-to-nearest sums, the shared-memory epilogue.  Only the
// source of each CTA's (entry, block-row, block-col) differs, so B4 is
// bit-equal to B2 on every stored entry, at every copy width.
//
// Bound on this card (H100 SXM datasheet rates), B2's at the same shapes:
//   FFN training, bf16, N = 2048 (smat-ffn-1.3b, 112 blocks of 128x128):
//     bytes -- dC and B read once and 3.7 MB written, 45.6 MB, 13.6 us at
//     3.35 TB/s.  The schedule holds 384 slots (gate/up) or 144 (down) for
//     the 112 blocks; the 272 or 32 padding slots cost a CTA launch that
//     reads one index and exits (4 CTAs a slot).
//   attention backward, f32, N = 128 (banded(4096) at L = 8192, 1,584 live
//     of 2,112 slots): operations -- 6.6 GFLOP at the 3xTF32 rate (a third
//     of 495 TFLOP/s), 40 us.
// Left for later: B2's items (wgmma with TMA loads, a 128 x 128 tile with a
// split N), and a grid over the live slots only.
#include <climits>

#include "sddmm_tile.cuh"

namespace {

// CTA column b is slot b = i * max_bpr + t of the static schedule: output
// entry flat_idx[b], dC block-row i, B block-col flat_col[b].  An entry
// outside [0, nnzb) -- the sentinel nnzb of a padding slot -- has no work.
struct ScheduleSource {
  const int* flat_idx;
  const int* flat_col;
  int max_bpr;
  int nnzb;

  __device__ bool get(int b, long long& e, long long& row,
                      long long& col) const {
    const int idx = flat_idx[b];
    if (idx < 0 || idx >= nnzb) return false;
    e = idx;
    row = b / max_bpr;
    col = flat_col[b];
    return true;
  }
};

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `dc` and `b` share in_type.
// flat_idx and flat_col hold nbr * max_bpr slots; `out` is a contiguous
// [nnzb, h, w].  `vec`, `ak`, `bk` as for bcsr_sddmm (the rule is
// `bcsr_spmm.sddmm_launch_config`; the tile routine checks them again).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int bcsr_sddmm_row_loop(const void* dc, const void* b,
                                   const void* flat_idx, const void* flat_col,
                                   void* out, int nbr, int max_bpr, int nnzb,
                                   int h, int w, int n_cols, long long sdm,
                                   long long sdn, long long sbk, long long sbn,
                                   int vec, int ak, int bk, int in_type,
                                   int out_type, void* stream) {
  if (nbr < 0 || max_bpr <= 0 || nnzb < 0 ||
      (long long)nbr * max_bpr > INT_MAX)
    return cudaErrorInvalidValue;
  const ScheduleSource src{static_cast<const int*>(flat_idx),
                           static_cast<const int*>(flat_col), max_bpr, nnzb};
  sddmm_tile::Args g{dc, b, out, h, w, n_cols, sdm, sdn, sbk, sbn, vec, 0, 0};
  return sddmm_tile::launch(src, g, nbr * max_bpr, ak, bk, in_type, out_type,
                            static_cast<cudaStream_t>(stream));
}
