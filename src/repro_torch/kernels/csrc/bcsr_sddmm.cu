// BCSR SDDMM, dvals[s] = dC[block row_ids[s]] @ B[block col_ids[s]]^T, for
// NVIDIA Hopper (sm_90a): the weight gradient of a block-sparse linear
// layer, computed only at the stored blocks.
//
// Replaces the Pallas TPU kernel `bcsr_sddmm`
// (src/repro/kernels/bcsr_spmm.py:170 `_sddmm_kernel`, :189 the wrapper).
// The TPU version runs a sequential grid (nnzb, N/bn) and carries an f32
// [h, w] accumulator in VMEM over the N axis, zeroing it at the first tile
// and flushing it at the last.  On the card, CTAs run in parallel and in no
// order, so here one CTA owns one output tile [32 rows, up to 128 columns]
// of one stored block and loops over N itself.  No atomics: the result is
// deterministic.
//
// Grid (nnzb, ceil(h / TM), ceil(w / TW)); 256 threads.  Per step, NC
// columns of the TM rows of dC (rows row_ids[s]*h + r0 + r) and of the TW
// rows of B (rows col_ids[s]*w + c0 + c) are staged in shared memory as
// f32; every thread keeps its 16 accumulators of the [TM, TW] tile in f32
// registers, and the tile is written once, in the output type.  Both
// operands may be strided: in training dC is the transposed view of the
// cotangent and B the transposed view x^T, so the staging loops read along
// whichever axis is contiguous, and no panel is copied.  Ragged h, w and N
// edges are masked (staged as zeros, not written).
//
// Bound on this card: bytes.  At the training shape of smat-ffn-1.3b
// (T = 2048 tokens, gate/up weight [8192, 2048], 112 blocks of 128x128) one
// launch must read dC [8192, 2048] and B [2048, 2048] in bf16 and write
// 3.7 MB: about 45.6 MB, 13.6 us at the H100 SXM datasheet's 3.35 TB/s,
// against 7.5 GFLOP, 7.6 us at its 989 TFLOP/s bf16 tensor-core rate.  This
// first design does nothing special about that bound: loads are scalar,
// there is no cp.async/TMA pipeline, and the products run on CUDA cores
// (FMA, about 67 TFLOP/s in f32), so it is compute-limited at about 0.1 ms.
// The inner loop reads four staged dC values with one 16-byte broadcast
// load, to keep shared-memory loads below one per FMA.  mma.sync/wgmma and a
// load pipeline are the redesign's work.
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
sddmm_kernel(const TIn* __restrict__ dc, const TIn* __restrict__ b,
             const int* __restrict__ row_ids, const int* __restrict__ col_ids,
             TOut* __restrict__ out, int h, int w, int n_cols, long long sdm,
             long long sdn, long long sbk, long long sbn) {
  // rows of a_s are 16-byte aligned (kNC + 4 floats) for the float4 reads
  __shared__ __align__(16) float a_s[kTM][kNC + 4];
  __shared__ float b_s[kNC][kTW + 1];      // +1: column reads/writes spread

  const int s = blockIdx.x;
  const int r0 = blockIdx.y * kTM;
  const int c0 = blockIdx.z * kTW;
  const int rows = min(kTM, h - r0);
  const int cols = min(kTW, w - c0);
  const int tid = threadIdx.x;
  const int tc = tid % kTW;
  const int tr = tid / kTW;
  const long long m0 = (long long)row_ids[s] * h + r0;   // first dC row
  const long long k0 = (long long)col_ids[s] * w + c0;   // first B row

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
    TOut* o = out + ((long long)s * h + r0) * w + c0 + tc;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = tr + j * kRowStep;
      if (r < rows) o[(long long)r * w] = from_f32<TOut>(acc[j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch_typed(const void* dc, const void* b, const int* row_ids,
                         const int* col_ids, void* out, int nnzb, int h,
                         int w, int n_cols, long long sdm, long long sdn,
                         long long sbk, long long sbn, cudaStream_t stream) {
  dim3 grid(nnzb, (h + kTM - 1) / kTM, (w + kTW - 1) / kTW);
  sddmm_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(dc), static_cast<const TIn*>(b), row_ids,
      col_ids, static_cast<TOut*>(out), h, w, n_cols, sdm, sdn, sbk, sbn);
  return cudaGetLastError();
}

}  // namespace

// Type codes: 0 = float32, 1 = bfloat16.  `dc` and `b` share in_type.
// `out` is a contiguous [nnzb, h, w].  Returns the launch's cudaError_t
// (0 = launched).
extern "C" int bcsr_sddmm(const void* dc, const void* b, const void* row_ids,
                          const void* col_ids, void* out, int nnzb, int h,
                          int w, int n_cols, long long sdm, long long sdn,
                          long long sbk, long long sbn, int in_type,
                          int out_type, void* stream) {
  const int* ri = static_cast<const int*>(row_ids);
  const int* ci = static_cast<const int*>(col_ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_type == 0 && out_type == 0)
    return launch_typed<float, float>(dc, b, ri, ci, out, nnzb, h, w, n_cols,
                                      sdm, sdn, sbk, sbn, st);
  if (in_type == 0 && out_type == 1)
    return launch_typed<float, __nv_bfloat16>(dc, b, ri, ci, out, nnzb, h, w,
                                              n_cols, sdm, sdn, sbk, sbn, st);
  if (in_type == 1 && out_type == 0)
    return launch_typed<__nv_bfloat16, float>(dc, b, ri, ci, out, nnzb, h, w,
                                              n_cols, sdm, sdn, sbk, sbn, st);
  if (in_type == 1 && out_type == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        dc, b, ri, ci, out, nnzb, h, w, n_cols, sdm, sdn, sbk, sbn, st);
  return cudaErrorInvalidValue;
}
