// Fused block-sparse attention over a static BCSR mask schedule, for NVIDIA
// Hopper (sm_90a): the SDDMM scores, the masked block softmax and the
// context SpMM of one (instance, block-row) in one launch, with no score or
// probability block written to device memory.
//
// Replaces the Pallas TPU kernel `bcsr_attn_fused`
// (src/repro/kernels/bcsr_attn.py:60 `_attn_fused_kernel`, :132 the
// wrapper).  That kernel runs the grid (G, nbr, 3, max_bpr) in order and
// carries the row max m, the denominator l and the context accumulator in
// VMEM from one grid step to the next: phase 0 takes m over the block-row's
// slots (clamped >= -1e30), phase 1 sums l = sum exp(logit - m) (clamped >=
// 1e-30), phase 2 adds (exp(logit - m) / l) @ V.  On the card CTAs run in
// parallel and in no order, so nothing can carry between them: here one CTA
// owns one 32-query-row slice of one block-row of one instance and runs the
// three passes over the row's max_bpr slots itself, recomputing the score
// block Q K^T in each pass (the TPU kernel does the same).  A sentinel slot
// (flat_idx == nnzb, padding of a short row) is skipped by the whole CTA:
// on the TPU it adds exact +0 terms and its logits (all NEG_INF) never
// raise m, so skipping it is exact; a row with no valid element ends at
// m = -1e30, l = 1e-30 and a zero context, as there.  No atomics, and every
// reduction runs in a fixed order: two launches give the same bits.
//
// Layout: grid (nbr * ceil(h / 32), G); 256 threads = 8 warps.  Warp w owns
// query rows 4w .. 4w+3 of the slice; lane c owns score columns c, c+32,
// c+64, c+96 (so w <= 128) and context columns c, c+32, ... (dv <= 256).
// Shared memory holds the Q slice [32, d] (staged once), one K chunk
// [w, 32] of the contraction, the probabilities P [32, w] and one V chunk
// [32, dv], all f32; about 66 KB at d = dv = w = 128.  Row max and row sum
// are warp-shuffle reductions.  Query rows >= Lq, key rows >= Lk and
// contraction columns >= d are staged as zeros, and only rows < Lq are
// written.  Products are f32 FMA on CUDA cores: the contract is an f32
// attention, and TF32 tensor cores would change its numbers.
//
// Bound on this card: operations.  At smat-attn-1.3b's full width (G = 16
// instances, L = 8192, d = dv = 128, banded(4096) in 128x128 blocks: 1584
// stored blocks) one launch reads q, k, v, emask and writes out, about
// 372 MB (0.11 ms at the H100 SXM datasheet's 3.35 TB/s), and its useful
// work is Q K^T once and P V once per stored block, 2 * 2 * 128^3 flops per
// block per instance, about 213 GFLOP: 3.2 ms at the 67 TFLOP/s f32 FMA
// peak.  This design computes Q K^T three times and its inner loops are
// bound by shared-memory loads, so it cannot come within 2x of that bound;
// tensor cores (with an exact f32 split), a cp.async/TMA pipeline, a bitmask
// in place of the f32 emask and fewer passes are the redesign's work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 32;                  // query rows per CTA
constexpr int kRows = kTM / kWarps;      // query rows per warp (4)
constexpr int kMaxW = 128;               // widest block the kernel holds
constexpr int kCols = kMaxW / 32;        // score columns per lane (4)
constexpr int kMaxD = 256;               // widest q/k and v rows
constexpr int kVCols = kMaxD / 32;       // context columns per lane (8)
constexpr int kDC = 32;                  // contraction chunk of K
constexpr int kVC = 32;                  // V rows staged per step
constexpr float kNegInf = -2.0e38f;      // the mask's NEG_INF

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const float* q;          // [G, lq, d]
  const float* k;          // [G, lk, d]
  const float* v;          // [G, lk, dv]
  const float* emask;      // [nnzb, h, w], 0/1
  const int* flat_idx;     // [nbr * max_bpr], padding = nnzb
  const int* flat_col;     // [nbr * max_bpr]
  float* out;              // [G, lq, dv]
  int lq, lk, d, dv, h, w, nnzb, max_bpr, slices;
  float scale, cap;
  int use_cap;
};

__global__ void __launch_bounds__(kThreads) attn_fused_kernel(Args a) {
  extern __shared__ float smem[];
  const int dpad = (a.d + kDC - 1) / kDC * kDC;
  const int dvpad = (a.dv + 31) / 32 * 32;
  float* q_s = smem;                            // [kTM][dpad]
  float* k_s = q_s + kTM * dpad;                // [w][kDC + 1]
  float* p_s = k_s + a.w * (kDC + 1);           // [kTM][w + 1]
  float* v_s = p_s + kTM * (a.w + 1);           // [kVC][dvpad]
  int* s_idx = reinterpret_cast<int*>(v_s + kVC * dvpad);  // [max_bpr]
  int* s_col = s_idx + a.max_bpr;                          // [max_bpr]

  const int g = blockIdx.y;
  const int i = blockIdx.x / a.slices;
  const int r0 = (blockIdx.x % a.slices) * kTM;   // first row in the block
  const int rows = min(kTM, a.h - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = (long long)i * a.h + r0;  // first query row
  const float* qg = a.q + (long long)g * a.lq * a.d;
  const float* kg = a.k + (long long)g * a.lk * a.d;
  const float* vg = a.v + (long long)g * a.lk * a.dv;
  const int nvj = dvpad / 32;

  for (int t = tid; t < a.max_bpr; t += kThreads) {
    s_idx[t] = a.flat_idx[(long long)i * a.max_bpr + t];
    s_col[t] = a.flat_col[(long long)i * a.max_bpr + t];
  }
  for (int e = tid; e < kTM * dpad; e += kThreads) {
    const int r = e / dpad, kk = e % dpad;
    const long long qr = q0 + r;
    q_s[e] = (r < rows && qr < a.lq && kk < a.d) ? qg[qr * a.d + kk] : 0.f;
  }
  __syncthreads();

  // The logits of this thread's [kRows, kCols] cells of slot (idx, col):
  // (q . k) * scale, the optional cap * tanh(s / cap), NEG_INF where the
  // element mask is 0 (and outside the block).  `ok` marks valid cells.
  float lg[kRows][kCols];
  bool ok[kRows][kCols];
  auto logits = [&](int idx, int col) {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) lg[rr][cc] = 0.f;
    const long long k0 = (long long)col * a.w;
    for (int d0 = 0; d0 < dpad; d0 += kDC) {
      __syncthreads();                   // the last chunk's readers are done
      for (int e = tid; e < a.w * kDC; e += kThreads) {
        const int c = e / kDC, kk = e % kDC;
        const long long kr = k0 + c;
        k_s[c * (kDC + 1) + kk] =
            (kr < a.lk && d0 + kk < a.d) ? kg[kr * a.d + d0 + kk] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDC; ++kk) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          qv[rr] = q_s[(warp * kRows + rr) * dpad + d0 + kk];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)   // clamp: columns >= w unused
          kv[cc] = k_s[min(lane + 32 * cc, a.w - 1) * (kDC + 1) + kk];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            lg[rr][cc] = fmaf(qv[rr], kv[cc], lg[rr][cc]);
      }
    }
    const float* em = a.emask + (long long)idx * a.h * a.w;
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int c = lane + 32 * cc;
        ok[rr][cc] = r < rows && c < a.w &&
                     em[(long long)(r0 + r) * a.w + c] != 0.f;
        float s = lg[rr][cc] * a.scale;
        if (a.use_cap) s = a.cap * tanhf(s / a.cap);
        lg[rr][cc] = ok[rr][cc] ? s : kNegInf;
      }
    }
  };

  // pass 0: the row max over the row's live slots
  float m[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) m[rr] = -INFINITY;
  for (int t = 0; t < a.max_bpr; ++t) {
    const int idx = s_idx[t];
    if (idx >= a.nnzb) continue;         // sentinel slot: adds nothing
    logits(idx, s_col[t]);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float x = lg[rr][0];
#pragma unroll
      for (int cc = 1; cc < kCols; ++cc) x = fmaxf(x, lg[rr][cc]);
      m[rr] = fmaxf(m[rr], warp_max(x));
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) m[rr] = fmaxf(m[rr], -1e30f);

  // pass 1: the denominator, slot by slot
  float l[kRows];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) l[rr] = 0.f;
  for (int t = 0; t < a.max_bpr; ++t) {
    const int idx = s_idx[t];
    if (idx >= a.nnzb) continue;
    logits(idx, s_col[t]);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float x = 0.f;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        x += ok[rr][cc] ? expf(lg[rr][cc] - m[rr]) : 0.f;
      l[rr] += warp_sum(x);
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) l[rr] = fmaxf(l[rr], 1e-30f);

  // pass 2: the context, acc += (exp(logit - m) / l) @ V_block
  float acc[kRows][kVCols];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
    for (int jj = 0; jj < kVCols; ++jj) acc[rr][jj] = 0.f;
  for (int t = 0; t < a.max_bpr; ++t) {
    const int idx = s_idx[t];
    if (idx >= a.nnzb) continue;
    const int col = s_col[t];
    logits(idx, col);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int r = warp * kRows + rr;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const int c = lane + 32 * cc;
        if (c < a.w)
          p_s[r * (a.w + 1) + c] =
              ok[rr][cc] ? expf(lg[rr][cc] - m[rr]) / l[rr] : 0.f;
      }
    }
    const long long v0 = (long long)col * a.w;
    for (int c0 = 0; c0 < a.w; c0 += kVC) {
      __syncthreads();                   // P written; last V chunk read
      for (int e = tid; e < kVC * dvpad; e += kThreads) {
        const int cr = e / dvpad, j = e % dvpad;
        const long long vr = v0 + c0 + cr;
        v_s[e] = (c0 + cr < a.w && vr < a.lk && j < a.dv)
                     ? vg[vr * a.dv + j] : 0.f;
      }
      __syncthreads();
      const int vc = min(kVC, a.w - c0);
      for (int cr = 0; cr < vc; ++cr) {
        float pv[kRows];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr)
          pv[rr] = p_s[(warp * kRows + rr) * (a.w + 1) + c0 + cr];
#pragma unroll
        for (int jj = 0; jj < kVCols; ++jj) {
          if (jj < nvj) {
            const float vv = v_s[cr * dvpad + lane + 32 * jj];
#pragma unroll
            for (int rr = 0; rr < kRows; ++rr)
              acc[rr][jj] = fmaf(pv[rr], vv, acc[rr][jj]);
          }
        }
      }
    }
  }

  float* og = a.out + (long long)g * a.lq * a.dv;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int r = warp * kRows + rr;
    const long long qr = q0 + r;
    if (r >= rows || qr >= a.lq) continue;
#pragma unroll
    for (int jj = 0; jj < kVCols; ++jj) {
      const int j = lane + 32 * jj;
      if (jj < nvj && j < a.dv) og[qr * a.dv + j] = acc[rr][jj];
    }
  }
}

}  // namespace

// Shared memory one CTA needs for these widths and schedule length, bytes.
extern "C" long long bcsr_attn_fused_smem(int d, int dv, int w,
                                          int max_bpr) {
  const long long dpad = (d + kDC - 1) / kDC * kDC;
  const long long dvpad = (dv + 31) / 32 * 32;
  return 4LL * (kTM * dpad + (long long)w * (kDC + 1) + kTM * (w + 1) +
                kVC * dvpad) +
         8LL * max_bpr;
}

// q, k, v, emask and out are float32; flat_idx and flat_col int32, nbr *
// max_bpr slots (padding slots hold the sentinel nnzb).  Returns the
// launch's cudaError_t (0 = launched); cudaErrorInvalidValue for widths the
// kernel does not hold (d or dv above 256, w above 128).
extern "C" int bcsr_attn_fused(const void* q, const void* k, const void* v,
                               const void* emask, const void* flat_idx,
                               const void* flat_col, void* out, int G,
                               int lq, int lk, int d, int dv, int nbr,
                               int max_bpr, int h, int w, int nnzb,
                               float scale, float cap, int use_cap,
                               void* stream) {
  if (d < 1 || d > kMaxD || dv < 1 || dv > kMaxD || w < 1 || w > kMaxW ||
      h < 1 || max_bpr < 1)
    return cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k),
         static_cast<const float*>(v), static_cast<const float*>(emask),
         static_cast<const int*>(flat_idx), static_cast<const int*>(flat_col),
         static_cast<float*>(out), lq, lk, d, dv, h, w, nnzb, max_bpr,
         (h + kTM - 1) / kTM, scale, cap, use_cap};
  const long long smem = bcsr_attn_fused_smem(d, dv, w, max_bpr);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(nbr * a.slices, G);
  attn_fused_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
