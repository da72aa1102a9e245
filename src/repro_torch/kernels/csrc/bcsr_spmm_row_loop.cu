// BCSR SpMM through SMaT's static schedule, C[nbr*h, N] = A_bcsr @ B, for
// NVIDIA Hopper (sm_90a): kernel B3.
//
// Replaces the Pallas TPU kernel `bcsr_spmm_row_loop`
// (src/repro/kernels/bcsr_spmm.py:105 `_row_loop_kernel`, :124 the wrapper).
// That kernel is the paper's static 2D schedule: a grid (nbr, N/bn, max_bpr)
// whose last axis runs, for every block-row i, the same max_bpr slots; slot t
// reads entry flat_idx[i*max_bpr + t] of block-col flat_col[i*max_bpr + t],
// padding slots (t >= row_len[i]) point at entry 0 and are masked, and an f32
// accumulator is carried over t from one grid step to the next.  On the card,
// CTAs run in parallel and in no order, so nothing can carry between them:
// one CTA owns one output tile [BM rows of block-row i, BN columns] and walks
// the row's live slots t < row_len[i] itself (the padding slots are never
// visited).  It first stages the row's flat_idx/flat_col in shared memory
// (128 slots at a time), so no slot's copy waits on a dependent index load.
// No atomics: bit-stable across calls, and a row of length 0 writes zeros.
//
// Layout: kernel B1's (bcsr_spmm.cu) -- the same tile routine of
// spmm_tile.cuh, which walks the live slots in order; only the source of
// each entry's ids differs.  So B3 is bit-equal to B1 on the same entries,
// at every copy width.
//
// Bound on this card: B1's, at the same shapes (decode N = 4: 3.7 MB of
// blocks, 1.1 us; N = 2048 and 8192: bytes, operations close behind), met
// by the same design (tensor-core products, a cp.async ring across slots,
// BM = 16 at decode for 8 CTAs a block-row, BM = 128 above it).  Left for
// later: B1's items (wgmma with TMA, persistent CTAs, fewer A re-reads).
#include "spmm_tile.cuh"

namespace {

// Block-row i's live slots t < row_len[i] of the static schedule, in order.
struct ScheduleSource {
  const int* flat_idx;
  const int* flat_col;
  const int* row_len;
  int max_bpr;

  __device__ int count(int i) const { return min(row_len[i], max_bpr); }

  __device__ void fill(int i, int e0, int n, int* idx_s, int* col_s) const {
    const long long base = (long long)i * max_bpr + e0;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      idx_s[t] = flat_idx[base + t];
      col_s[t] = flat_col[base + t];
    }
  }
};

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `vals` and `b` share in_type.
// flat_idx and flat_col hold nbr * max_bpr slots, row_len nbr counts, one
// schedule for all `instances`.  `instances`, the batch strides, `bn`,
// `bm`, `vec` and `kmajor` as for bcsr_spmm_nnz_stream.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int bcsr_spmm_row_loop(const void* vals, const void* flat_idx,
                                  const void* flat_col, const void* row_len,
                                  const void* b, void* out, int nbr,
                                  int max_bpr, int h, int w, int n_cols,
                                  long long sbk, long long sbn, int bn,
                                  int bm, int vec, int kmajor, int in_type,
                                  int out_type, int instances,
                                  long long s_vals, long long s_b,
                                  long long s_out, void* stream) {
  const ScheduleSource src{static_cast<const int*>(flat_idx),
                           static_cast<const int*>(flat_col),
                           static_cast<const int*>(row_len), max_bpr};
  spmm_tile::Args g{vals, b, out, h, w, n_cols, sbk, sbn, vec,
                    0, 0, 0, s_vals, s_b, s_out};
  return spmm_tile::launch(src, g, nbr, instances, bn, bm, kmajor, in_type,
                           out_type, static_cast<cudaStream_t>(stream));
}

// The static analyzer's queries (analysis/workspace.py mirrors them):
// dynamic shared memory of one instantiation, bytes (-1 for one the launch
// does not take), and threads a CTA.
extern "C" int bcsr_spmm_row_loop_smem_bytes(int in_type, int bm, int bn,
                                             int kmajor) {
  return spmm_tile::smem_bytes(in_type, bm, bn, kmajor);
}

extern "C" int bcsr_spmm_row_loop_threads(int bm) {
  return spmm_tile::threads(bm);
}
