// BCSR SpMM, C[nbr*h, N] = A_bcsr @ B, for NVIDIA Hopper (sm_90a): kernel B1.
//
// Replaces the Pallas TPU kernel `bcsr_spmm_nnz_stream`
// (src/repro/kernels/bcsr_spmm.py:46 `_nnz_stream_kernel`, :67 the wrapper).
// The TPU version runs a sequential grid (N/bn, nnzb) over the row-major
// nonzero-block list and carries an f32 accumulator from one grid step to the
// next, zeroing it at a row's first block and flushing it at its last.  On
// the card, CTAs run in parallel and in no order, so nothing can carry
// between them: one CTA owns one output tile [BM rows of block-row i, BN
// columns] and walks that row's entries rowptr[i] .. rowptr[i+1] itself.  No
// atomics, so the result is bit-stable across calls, and an empty block-row
// (the sentinel rows of the transpose structure) writes zeros.
//
// Layout: the shared tile routine of spmm_tile.cuh (its header has the
// details): BM = 128 rows with 8 warps (the wrapper's choice for N > 16 and
// blocks taller than 64 rows), or 16 with 4 warps at decode; a 4-slot
// cp.async ring of [BM, KC] A and [KC, BN] B chunks running across entries;
// bf16 products on the tensor cores (mma.sync m16n8k16, ldmatrix), f32
// products as 3xTF32 on the tensor cores.  B comes row-major [K, N] or as the
// x^T view (the model's and the dB path's); the copy width (16, 8, 4 or 2
// bytes) follows the operands' alignment.
//
// Bound on this card, at the main path's shapes (smat-ffn-1.3b, 112 blocks of
// 128x128 per weight, bf16, H100 SXM datasheet rates):
//   decode, N = 4: bytes -- 3.7 MB of blocks per launch, 1.1 us.  The design
//     keeps that stream going: BM = 16 gives 8 CTAs per block-row (128 on the
//     down projection's 16 rows), each with up to 3 chunks of 256-byte rows
//     in flight.
//   training and prefill, N = 2048 and 8192: bytes (13.6 us at 2048; the
//     8192-column output and B dominate at 8192), with operations (7.5 GFLOP
//     at 2048, 7.6 us at the bf16 tensor rate) close behind: mma.sync at a
//     fraction of peak suffices (FMA on the CUDA cores would not).  What
//     holds the kernel back now is L2 -> SM traffic: every N tile re-reads
//     its block-row's A blocks (32 times at N = 2048, BN = 64).
//   attention backward, f32, N = 128 (1,584 blocks): operations -- 6.6 GFLOP
//     at the 3xTF32 rate (a third of 495 TFLOP/s), 40 us; the operand
//     splits and the per-step adds are instructions beside the products.
// Left for later: wgmma with TMA loads and an mbarrier ring, persistent CTAs
// (one tile's epilogue under the next one's loads), a 128-wide N tile (half
// the A re-reads from L2), and, for dB = A^T dC,
// reading A's blocks transposed in the kernel (ldmatrix.trans on A) in place
// of the copy `ops.transposed_vals` makes every backward.
#include "spmm_tile.cuh"

namespace {

// Block-row i's entries: rowptr[i] .. rowptr[i+1], in order.
struct RowptrSource {
  const int* rowptr;
  const int* col_ids;

  __device__ int count(int i) const { return rowptr[i + 1] - rowptr[i]; }

  __device__ void fill(int i, int e0, int n, int* idx_s, int* col_s) const {
    const int s0 = rowptr[i] + e0;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      idx_s[t] = s0 + t;
      col_s[t] = col_ids[s0 + t];
    }
  }
};

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `vals` and `b` share in_type.
// `bn` the N tile (8, 16, 32, 64), `bm` the rows a CTA owns (16 or 128; the
// rule is `bcsr_spmm.spmm_launch_config`), `vec` the copy width in bytes,
// `kmajor` 1 where B is staged k-major (row-major B, sbn == 1), 0 where it
// is the x^T view (sbk == 1).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int bcsr_spmm_nnz_stream(const void* vals, const void* rowptr,
                                    const void* col_ids, const void* b,
                                    void* out, int nbr, int h, int w,
                                    int n_cols, long long sbk, long long sbn,
                                    int bn, int bm, int vec, int kmajor,
                                    int in_type, int out_type, void* stream) {
  const RowptrSource src{static_cast<const int*>(rowptr),
                         static_cast<const int*>(col_ids)};
  spmm_tile::Args g{vals, b, out, h, w, n_cols, sbk, sbn, vec, 0, 0};
  return spmm_tile::launch(src, g, nbr, bn, bm, kmajor, in_type, out_type,
                           static_cast<cudaStream_t>(stream));
}
