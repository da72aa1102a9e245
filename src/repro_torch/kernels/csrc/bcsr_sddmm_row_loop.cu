// BCSR SDDMM through SMaT's static schedule, for NVIDIA Hopper (sm_90a):
// slot t of block-row i computes dC[block i] @ B[block flat_col[i*max_bpr+t]]^T
// into output entry flat_idx[i*max_bpr+t], the weight gradient of a
// block-sparse layer under the `row_loop` backend.
//
// Replaces the Pallas TPU kernel `bcsr_sddmm_row_loop`
// (src/repro/kernels/bcsr_spmm.py:227 `_sddmm_row_loop_kernel`, :246 the
// wrapper).  That kernel runs the static 2D (block-row x slot) grid of
// `bcsr_spmm_row_loop`, (nbr, max_bpr, N/bn), and carries an f32 [h, w]
// accumulator in VMEM over the sequential N axis.  A padding slot
// (t >= row_len[i]) still computes its product and writes it to the sentinel
// entry nnzb of an [nnzb+1, h, w] output, which the wrapper slices off: the
// static schedule's waste on short rows.  This kernel keeps that contract.
// On the card, CTAs run in parallel and in no order, so here one CTA owns
// one output tile [32 rows, up to 128 columns] of one slot and loops over N
// itself.  Live slots write distinct entries, so there are no atomics and
// the kept result is deterministic; padding slots all write the sentinel,
// whose contents are discarded.
//
// Layout: grid (nbr * max_bpr, ceil(h / TM), ceil(w / TW)); 256 threads.
// Per step, NC columns of the TM rows of dC (rows i*h + r0 + r) and of the
// TW rows of B (rows flat_col*w + c0 + c) are staged in shared memory as
// f32; every thread keeps its 16 accumulators of the [TM, TW] tile in f32
// registers, and the tile is written once, in the output type.  Both
// operands may be strided (in training dC is the transposed view of the
// cotangent and B the view x^T): the staging loops read along whichever
// axis is contiguous, so no panel is copied.  Ragged h, w and N edges are
// staged as zeros and not written.
//
// Bound on this card: bytes.  At the training shape of smat-ffn-1.3b
// (T = 2048 tokens, gate/up weight [8192, 2048], 112 blocks of 128x128) one
// launch must read dC and B in bf16 and write 3.7 MB: about 45.6 MB, 13.6 us
// at the H100 SXM datasheet's 3.35 TB/s, against 7.5 GFLOP of live slots,
// 7.6 us at its 989 TFLOP/s bf16 tensor-core rate.  This first design does
// nothing special about that bound: loads are scalar, there is no
// cp.async/TMA pipeline, the products run on CUDA cores (FMA), and padding
// slots cost as much as live ones.  Those are the redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 32;                    // output rows per CTA
constexpr int kTW = 128;                   // output columns per CTA
constexpr int kNC = 32;                    // N chunk staged per step
constexpr int kRowStep = kThreads / kTW;   // rows one pass of threads covers
constexpr int kRows = kTM / kRowStep;      // accumulators per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
sddmm_row_loop_kernel(const TIn* __restrict__ dc, const TIn* __restrict__ b,
                      const int* __restrict__ flat_idx,
                      const int* __restrict__ flat_col, TOut* __restrict__ out,
                      int max_bpr, int h, int w, int n_cols, long long sdm,
                      long long sdn, long long sbk, long long sbn) {
  // rows of a_s are 16-byte aligned (kNC + 4 floats) for the float4 reads
  __shared__ __align__(16) float a_s[kTM][kNC + 4];
  __shared__ float b_s[kNC][kTW + 1];      // +1: column reads/writes spread

  const int slot = blockIdx.x;             // i * max_bpr + t
  const int i = slot / max_bpr;
  const int r0 = blockIdx.y * kTM;
  const int c0 = blockIdx.z * kTW;
  const int rows = min(kTM, h - r0);
  const int cols = min(kTW, w - c0);
  const int tid = threadIdx.x;
  const int tc = tid % kTW;
  const int tr = tid / kTW;
  const long long e = flat_idx[slot];                      // output entry
  const long long m0 = (long long)i * h + r0;              // first dC row
  const long long k0 = (long long)flat_col[slot] * w + c0; // first B row

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  for (int n0 = 0; n0 < n_cols; n0 += kNC) {
    const int nc = min(kNC, n_cols - n0);
    for (int idx = tid; idx < kTM * kNC; idx += kThreads) {
      int r, nn;
      if (sdm == 1) {
        r = idx % kTM; nn = idx / kTM;     // dC^T view: rows contiguous
      } else {
        nn = idx % kNC; r = idx / kNC;     // row-major dC: columns contiguous
      }
      a_s[r][nn] = (r < rows && nn < nc)
                       ? to_f32(dc[(m0 + r) * sdm + (long long)(n0 + nn) * sdn])
                       : 0.f;
    }
    for (int idx = tid; idx < kNC * kTW; idx += kThreads) {
      int c, nn;
      if (sbk == 1) {
        c = idx % kTW; nn = idx / kTW;     // x^T view: rows contiguous
      } else {
        nn = idx % kNC; c = idx / kNC;     // row-major B: columns contiguous
      }
      b_s[nn][c] = (c < cols && nn < nc)
                       ? to_f32(b[(k0 + c) * sbk + (long long)(n0 + nn) * sbn])
                       : 0.f;
    }
    __syncthreads();
    // the chunk's tail is staged as zeros, so the loop runs the whole chunk
#pragma unroll 2
    for (int nn = 0; nn < kNC; nn += 4) {
      float bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = b_s[nn + q][tc];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        // one warp shares tr, so this is a broadcast read
        const float4 av =
            *reinterpret_cast<const float4*>(&a_s[tr + j * kRowStep][nn]);
        acc[j] = fmaf(av.x, bv[0], acc[j]);
        acc[j] = fmaf(av.y, bv[1], acc[j]);
        acc[j] = fmaf(av.z, bv[2], acc[j]);
        acc[j] = fmaf(av.w, bv[3], acc[j]);
      }
    }
    __syncthreads();
  }

  if (tc < cols) {
    TOut* o = out + (e * h + r0) * w + c0 + tc;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = tr + j * kRowStep;
      if (r < rows) o[(long long)r * w] = from_f32<TOut>(acc[j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_typed(const void* dc, const void* b, const int* flat_idx,
                         const int* flat_col, void* out, int nbr, int max_bpr,
                         int h, int w, int n_cols, long long sdm,
                         long long sdn, long long sbk, long long sbn,
                         cudaStream_t stream) {
  dim3 grid(nbr * max_bpr, (h + kTM - 1) / kTM, (w + kTW - 1) / kTW);
  sddmm_row_loop_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(dc), static_cast<const TIn*>(b), flat_idx,
      flat_col, static_cast<TOut*>(out), max_bpr, h, w, n_cols, sdm, sdn,
      sbk, sbn);
  return cudaGetLastError();
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `dc` and `b` share in_type.
// `out` is a contiguous [nnzb + 1, h, w]; flat_idx and flat_col hold
// nbr * max_bpr slots.  Returns the launch's cudaError_t (0 = launched).
extern "C" int bcsr_sddmm_row_loop(const void* dc, const void* b,
                                   const void* flat_idx, const void* flat_col,
                                   void* out, int nbr, int max_bpr, int h,
                                   int w, int n_cols, long long sdm,
                                   long long sdn, long long sbk, long long sbn,
                                   int in_type, int out_type, void* stream) {
  const int* fi = static_cast<const int*>(flat_idx);
  const int* fc = static_cast<const int*>(flat_col);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return launch_typed<float, float>(dc, b, fi, fc, out, nbr, max_bpr, h, w,
                                      n_cols, sdm, sdn, sbk, sbn, st);
  if (in_type == 0 && out_type == 1)
    return launch_typed<float, __nv_bfloat16>(dc, b, fi, fc, out, nbr,
                                              max_bpr, h, w, n_cols, sdm, sdn,
                                              sbk, sbn, st);
  if (in_type == 1 && out_type == 0)
    return launch_typed<__nv_bfloat16, float>(dc, b, fi, fc, out, nbr,
                                              max_bpr, h, w, n_cols, sdm, sdn,
                                              sbk, sbn, st);
  if (in_type == 1 && out_type == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        dc, b, fi, fc, out, nbr, max_bpr, h, w, n_cols, sdm, sdn, sbk, sbn,
        st);
  return cudaErrorInvalidValue;
}
