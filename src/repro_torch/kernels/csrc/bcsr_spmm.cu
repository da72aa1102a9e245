// BCSR SpMM, C[nbr*h, N] = A_bcsr @ B, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bcsr_spmm_nnz_stream`
// (src/repro/kernels/bcsr_spmm.py:46 `_nnz_stream_kernel`, :67 the wrapper).
// The TPU version runs a sequential grid (N/bn, nnzb) over the row-major
// nonzero-block list and carries an f32 accumulator from one grid step to the
// next, zeroing it at a row's first block and flushing it at its last.  On
// the card, CTAs run in parallel and in no order, so nothing can carry
// between them: here one CTA owns one output tile [rows of block-row i, BN
// columns] and loops over that row's entries rowptr[i]..rowptr[i+1] itself.
// No atomics, so the result is deterministic, and an empty block-row simply
// writes zeros.
//
// Grid (nbr, ceil(N / BN), ceil(h / TM)); 256 threads.  Per entry s, chunks
// of KC columns of the A block and the matching KC rows of B (rows
// col_ids[s]*w + k) are staged in shared memory as f32; every thread keeps
// its share of the [TM, BN] tile in f32 registers and the tile is written
// once, in the output type.  B may be strided (the model passes x^T as a
// transposed view); the staging loop reads along whichever axis is
// contiguous.
//
// Bound on this card: bytes.  In decode (N = 4 at the model's full width)
// one launch reads about 3.7 MB of bf16 `vals` (112 blocks of 128x128) and
// does 2*112*128*128*4 = 29 MFLOP, so it cannot take less than about 1.1 us
// at the H100 SXM datasheet's 3.35 TB/s.  This first design does nothing
// special about that bound: loads are scalar, there is no cp.async/TMA
// pipeline and the products run on CUDA cores (FMA), not tensor cores.  Its
// known weak spot: the down projection has only 16 block-rows, so even with
// each 128-row block split over 4 CTAs (TM = 32) it runs 64 CTAs on 132 SMs
// in decode.  Tensor cores, a load pipeline and a split of a block-row's
// entries over CTAs are left to the kernel's redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 32;   // output rows per CTA: grid z splits a block-row's
                          // h rows, so a short matrix still fills the card
constexpr int kKC = 64;   // reduction chunk staged per step

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

template <typename TIn, typename TOut, int BN>
__global__ void __launch_bounds__(kThreads)
nnz_stream_kernel(const TIn* __restrict__ vals, const int* __restrict__ rowptr,
                  const int* __restrict__ col_ids, const TIn* __restrict__ b,
                  TOut* __restrict__ out, int h, int w, int n_cols,
                  long long sbk, long long sbn) {
  constexpr int kRowStep = kThreads / BN;  // rows one pass of threads covers
  constexpr int kRows = kTM / kRowStep;    // accumulator rows per thread
  __shared__ float a_s[kTM][kKC + 1];      // +1: rows land in distinct banks
  __shared__ float b_s[kKC][BN];

  const int i = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * kTM;
  const int rows = min(kTM, h - r0);
  const int tid = threadIdx.x;
  const int tc = tid % BN;
  const int tr = tid / BN;

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  const int s_end = rowptr[i + 1];
  for (int s = rowptr[i]; s < s_end; ++s) {
    const TIn* a = vals + ((long long)s * h + r0) * w;
    const long long kb = (long long)col_ids[s] * w;
    for (int k0 = 0; k0 < w; k0 += kKC) {
      const int kc = min(kKC, w - k0);
      for (int idx = tid; idx < kTM * kKC; idx += kThreads) {
        const int r = idx / kKC, kk = idx % kKC;
        a_s[r][kk] = (r < rows && kk < kc)
                         ? to_f32(a[(long long)r * w + k0 + kk]) : 0.f;
      }
      for (int idx = tid; idx < kKC * BN; idx += kThreads) {
        int kk, c;
        if (sbn == 1) {
          kk = idx / BN; c = idx % BN;    // row-major B: columns contiguous
        } else {
          kk = idx % kKC; c = idx / kKC;  // x^T view: rows contiguous
        }
        const int n = n0 + c;
        b_s[kk][c] = (kk < kc && n < n_cols)
                         ? to_f32(b[(kb + k0 + kk) * sbk + (long long)n * sbn])
                         : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; ++kk) {
        const float bv = b_s[kk][tc];
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          acc[j] = fmaf(a_s[tr + j * kRowStep][kk], bv, acc[j]);
      }
      __syncthreads();
    }
  }

  const int n = n0 + tc;
  if (n < n_cols) {
    TOut* o = out + ((long long)i * h + r0) * n_cols + n;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = tr + j * kRowStep;
      if (r < rows) o[(long long)r * n_cols] = from_f32<TOut>(acc[j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_typed(const void* vals, const int* rowptr,
                         const int* col_ids, const void* b, void* out, int nbr,
                         int h, int w, int n_cols, long long sbk,
                         long long sbn, int bn, cudaStream_t stream) {
  dim3 grid(nbr, (n_cols + bn - 1) / bn, (h + kTM - 1) / kTM);
  const TIn* v = static_cast<const TIn*>(vals);
  const TIn* bb = static_cast<const TIn*>(b);
  TOut* o = static_cast<TOut*>(out);
  switch (bn) {
    case 8:
      nnz_stream_kernel<TIn, TOut, 8><<<grid, kThreads, 0, stream>>>(
          v, rowptr, col_ids, bb, o, h, w, n_cols, sbk, sbn);
      break;
    case 16:
      nnz_stream_kernel<TIn, TOut, 16><<<grid, kThreads, 0, stream>>>(
          v, rowptr, col_ids, bb, o, h, w, n_cols, sbk, sbn);
      break;
    case 32:
      nnz_stream_kernel<TIn, TOut, 32><<<grid, kThreads, 0, stream>>>(
          v, rowptr, col_ids, bb, o, h, w, n_cols, sbk, sbn);
      break;
    case 64:
      nnz_stream_kernel<TIn, TOut, 64><<<grid, kThreads, 0, stream>>>(
          v, rowptr, col_ids, bb, o, h, w, n_cols, sbk, sbn);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `vals` and `b` share in_type.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int bcsr_spmm_nnz_stream(const void* vals, const void* rowptr,
                                    const void* col_ids, const void* b,
                                    void* out, int nbr, int h, int w,
                                    int n_cols, long long sbk, long long sbn,
                                    int bn, int in_type, int out_type,
                                    void* stream) {
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(col_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return launch_typed<float, float>(vals, rp, ci, b, out, nbr, h, w, n_cols,
                                      sbk, sbn, bn, st);
  if (in_type == 0 && out_type == 1)
    return launch_typed<float, __nv_bfloat16>(vals, rp, ci, b, out, nbr, h, w,
                                              n_cols, sbk, sbn, bn, st);
  if (in_type == 1 && out_type == 0)
    return launch_typed<__nv_bfloat16, float>(vals, rp, ci, b, out, nbr, h, w,
                                              n_cols, sbk, sbn, bn, st);
  if (in_type == 1 && out_type == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        vals, rp, ci, b, out, nbr, h, w, n_cols, sbk, sbn, bn, st);
  return cudaErrorInvalidValue;
}
