// BCSR SDDMM, dvals[s] = dC[block row_ids[s]] @ B[block col_ids[s]]^T, for
// NVIDIA Hopper (sm_90a): kernel B2, the weight gradient of a block-sparse
// linear layer (and the attention backward's score products), computed
// only at the stored blocks.
//
// Replaces the Pallas TPU kernel `bcsr_sddmm`
// (src/repro/kernels/bcsr_spmm.py:170 `_sddmm_kernel`, :189 the wrapper).
// The TPU version runs a sequential grid (nnzb, N/bn) and carries an f32
// [h, w] accumulator in VMEM over the N axis, zeroing it at the first tile
// and flushing it at the last.  On the card, CTAs run in parallel and in no
// order, so nothing can carry between them: here one CTA owns one 64 x 64
// tile of one stored block and walks N itself.  No atomics: the result is
// bit-stable across calls.
//
// Layout: the tile routine of sddmm_tile.cuh (its header has the details):
// 4 warps of 32 x 32 over the tile; a 3-slot cp.async ring of N chunks
// (128 bytes a row) of both operands, each staged along its contiguous
// axis -- the FFN backward passes dC as the transposed cotangent view and
// B as x^T (both staged k-major, fragments through ldmatrix.trans), the
// attention backward row-major Q and K; bf16 products on mma.sync
// m16n8k16, f32 products as 3xTF32 (B1's split and per-step sums).
//
// Bound on this card (H100 SXM datasheet rates):
//   FFN training, bf16, N = 2048 (smat-ffn-1.3b, 112 blocks of 128x128):
//     bytes -- dC [8192, 2048] and B [2048, 2048] read once and 3.7 MB
//     written, 45.6 MB, 13.6 us at 3.35 TB/s; the 7.5 GFLOP take 7.6 us at
//     989 TFLOP/s.  112 blocks are fewer than the 132 SMs, so each block is
//     cut into four CTAs (448, four to an SM): every dC and B panel is read
//     twice from L2, about 235 MB of L2 -> SM traffic.
//   attention backward, f32, N = 128 (1,584 blocks): operations -- 6.6
//     GFLOP at the 3xTF32 rate (a third of 495 TFLOP/s), 40 us.
// Left for later: wgmma with TMA loads, a 128 x 128 tile with a split N
// (half the L2 re-reads) for the FFN shape.
#include "sddmm_tile.cuh"

namespace {

// CTA b computes stored entry b: block-row row_ids[b], block-col col_ids[b].
struct EntrySource {
  const int* row_ids;
  const int* col_ids;

  __device__ bool get(int b, long long& e, long long& row,
                      long long& col) const {
    e = b;
    row = row_ids[b];
    col = col_ids[b];
    return true;
  }
};

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `dc` and `b` share in_type.
// `out` is a contiguous [nnzb, h, w].  `vec` the copy width in bytes,
// `ak` / `bk` 1 where dC / B is staged k-major (its row axis contiguous);
// the rule is `bcsr_spmm.sddmm_launch_config`.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int bcsr_sddmm(const void* dc, const void* b, const void* row_ids,
                          const void* col_ids, void* out, int nnzb, int h,
                          int w, int n_cols, long long sdm, long long sdn,
                          long long sbk, long long sbn, int vec, int ak,
                          int bk, int in_type, int out_type, void* stream) {
  const EntrySource src{static_cast<const int*>(row_ids),
                        static_cast<const int*>(col_ids)};
  sddmm_tile::Args g{dc, b, out, h, w, n_cols, sdm, sdn, sbk, sbn, vec, 0, 0};
  return sddmm_tile::launch(src, g, nnzb, ak, bk, in_type, out_type,
                            static_cast<cudaStream_t>(stream));
}
