// BCSR SpMM through SMaT's static schedule, C[nbr*h, N] = A_bcsr @ B, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `bcsr_spmm_row_loop`
// (src/repro/kernels/bcsr_spmm.py:105 `_row_loop_kernel`, :124 the wrapper).
// That kernel is the paper's static 2D schedule: a grid (nbr, N/bn, max_bpr)
// whose last axis runs, for every block-row i, the same max_bpr slots; slot t
// reads entry flat_idx[i*max_bpr + t] of block-col flat_col[i*max_bpr + t],
// padding slots (t >= row_len[i]) point at entry 0 and are masked, and an f32
// accumulator is carried over t from one grid step to the next.  On the card,
// CTAs run in parallel and in no order, so nothing can carry between them:
// here one CTA owns one output tile [rows of block-row i, BN columns] and
// runs the row's max_bpr slots itself, reading the schedule (not rowptr, as
// `bcsr_spmm_nnz_stream` does).  A padding slot is skipped by the whole CTA
// at once (a uniform branch: no loads, no FMA), so on this card the static
// schedule costs its short rows only the slot loop.  No atomics: the result
// is deterministic.
//
// Layout: grid (nbr, ceil(N / BN), ceil(h / TM)); 256 threads.  Per live
// slot, chunks of KC columns of the A block and the matching KC rows of B
// (rows flat_col*w + k) are staged in shared memory as f32; every thread
// keeps its share of the [TM, BN] tile in f32 registers and the tile is
// written once, in the output type.  B may be strided (the model passes x^T
// as a transposed view); the staging loop reads along whichever axis is
// contiguous.  Ragged h and N edges are staged as zeros and not written.
//
// Bound on this card: bytes.  In decode (N = 4 at smat-ffn-1.3b's full
// width) one launch must read about 3.7 MB of bf16 blocks (112 of 128x128)
// for 29 MFLOP: at least about 1.1 us at the H100 SXM datasheet's 3.35 TB/s.
// This first design does nothing special about that bound: loads are
// scalar, there is no cp.async/TMA pipeline and the products run on CUDA
// cores (FMA), not tensor cores.  Those are the redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 32;   // output rows per CTA (grid z splits the h rows)
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
row_loop_kernel(const TIn* __restrict__ vals, const int* __restrict__ flat_idx,
                const int* __restrict__ flat_col,
                const int* __restrict__ row_len, const TIn* __restrict__ b,
                TOut* __restrict__ out, int max_bpr, int h, int w, int n_cols,
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
  const int* idx = flat_idx + (long long)i * max_bpr;
  const int* col = flat_col + (long long)i * max_bpr;
  const int len = row_len[i];

  float acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = 0.f;

  for (int t = 0; t < max_bpr; ++t) {
    if (t >= len) continue;                // padding slot: masked
    const TIn* a = vals + ((long long)idx[t] * h + r0) * w;
    const long long kb = (long long)col[t] * w;
    for (int k0 = 0; k0 < w; k0 += kKC) {
      const int kc = min(kKC, w - k0);
      for (int e = tid; e < kTM * kKC; e += kThreads) {
        const int r = e / kKC, kk = e % kKC;
        a_s[r][kk] = (r < rows && kk < kc)
                         ? to_f32(a[(long long)r * w + k0 + kk]) : 0.f;
      }
      for (int e = tid; e < kKC * BN; e += kThreads) {
        int kk, c;
        if (sbn == 1) {
          kk = e / BN; c = e % BN;        // row-major B: columns contiguous
        } else {
          kk = e % kKC; c = e / kKC;      // x^T view: rows contiguous
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

template <typename TIn, typename TOut, int BN>
void launch_bn(dim3 grid, cudaStream_t stream, const void* vals,
               const int* flat_idx, const int* flat_col, const int* row_len,
               const void* b, void* out, int max_bpr, int h, int w,
               int n_cols, long long sbk, long long sbn) {
  row_loop_kernel<TIn, TOut, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(vals), flat_idx, flat_col, row_len,
      static_cast<const TIn*>(b), static_cast<TOut*>(out), max_bpr, h, w,
      n_cols, sbk, sbn);
}

template <typename TIn, typename TOut>
cudaError_t launch_typed(const void* vals, const int* flat_idx,
                         const int* flat_col, const int* row_len,
                         const void* b, void* out, int nbr, int max_bpr,
                         int h, int w, int n_cols, long long sbk,
                         long long sbn, int bn, cudaStream_t stream) {
  dim3 grid(nbr, (n_cols + bn - 1) / bn, (h + kTM - 1) / kTM);
  switch (bn) {
    case 8:
      launch_bn<TIn, TOut, 8>(grid, stream, vals, flat_idx, flat_col, row_len,
                              b, out, max_bpr, h, w, n_cols, sbk, sbn);
      break;
    case 16:
      launch_bn<TIn, TOut, 16>(grid, stream, vals, flat_idx, flat_col,
                               row_len, b, out, max_bpr, h, w, n_cols, sbk,
                               sbn);
      break;
    case 32:
      launch_bn<TIn, TOut, 32>(grid, stream, vals, flat_idx, flat_col,
                               row_len, b, out, max_bpr, h, w, n_cols, sbk,
                               sbn);
      break;
    case 64:
      launch_bn<TIn, TOut, 64>(grid, stream, vals, flat_idx, flat_col,
                               row_len, b, out, max_bpr, h, w, n_cols, sbk,
                               sbn);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `vals` and `b` share in_type.
// flat_idx and flat_col hold nbr * max_bpr slots, row_len nbr counts.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int bcsr_spmm_row_loop(const void* vals, const void* flat_idx,
                                  const void* flat_col, const void* row_len,
                                  const void* b, void* out, int nbr,
                                  int max_bpr, int h, int w, int n_cols,
                                  long long sbk, long long sbn, int bn,
                                  int in_type, int out_type, void* stream) {
  const int* fi = static_cast<const int*>(flat_idx);
  const int* fc = static_cast<const int*>(flat_col);
  const int* rl = static_cast<const int*>(row_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return launch_typed<float, float>(vals, fi, fc, rl, b, out, nbr, max_bpr,
                                      h, w, n_cols, sbk, sbn, bn, st);
  if (in_type == 0 && out_type == 1)
    return launch_typed<float, __nv_bfloat16>(vals, fi, fc, rl, b, out, nbr,
                                              max_bpr, h, w, n_cols, sbk, sbn,
                                              bn, st);
  if (in_type == 1 && out_type == 0)
    return launch_typed<__nv_bfloat16, float>(vals, fi, fc, rl, b, out, nbr,
                                              max_bpr, h, w, n_cols, sbk, sbn,
                                              bn, st);
  if (in_type == 1 && out_type == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        vals, fi, fc, rl, b, out, nbr, max_bpr, h, w, n_cols, sbk, sbn, bn,
        st);
  return cudaErrorInvalidValue;
}
