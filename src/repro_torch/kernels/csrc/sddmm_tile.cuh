// The block-sparse SDDMM tile of kernels B2 (bcsr_sddmm.cu, `bcsr_sddmm`)
// and B4 (bcsr_sddmm_row_loop.cu, `bcsr_sddmm_row_loop`), for NVIDIA Hopper
// (sm_90a): out[e] = dC[block row] @ B[block col]^T for one stored block,
// contracted over the token axis N.  The two kernels differ only in where
// a CTA's (output entry, dC block-row, B block-col) come from: a `Source`,
// as spmm_tile.cuh's -- B2's names stored entry blockIdx.x, B4's reads slot
// blockIdx.x of the static schedule and has no work on a padding slot.  So
// B4 gives B2's bits on every stored entry.
//
// CTA layout.  One CTA owns one [BM = 64, BW = 64] tile of one stored block
// (rows r0 .. r0 + 63 from blockIdx.y, columns c0 .. c0 + 63 from
// blockIdx.z) and walks N itself in chunks of KC (128 bytes of a row: 64
// bf16 or 32 f32 values).  Four warps split the tile 2 x 2, 32 x 32 each:
// two m16 row groups by four n8 column groups.  A 128 x 128 block takes
// four CTAs, so the FFN's 112 blocks give 448 CTAs (four fit on an SM)
// and the attention backward's 1,584 give 6,336.  No atomics and no split
// of N: every output element is one warp's sum in a fixed order, so two
// launches give the same bits.
//
// Loads.  A ring of kStages chunk slots in dynamic shared memory, filled
// with cp.async (16-, 8- or 4-byte copies; 2-byte bf16 loads where nothing
// wider is aligned) and consumed kStages - 1 chunks later, one
// __syncthreads a chunk.  Each operand is staged along whichever of its
// axes is contiguous: dC row-major (k contiguous) as [BM][KC], the
// transposed cotangent view (m contiguous) as [KC][BM]; B row-major as
// [BW][KC], the x^T view as [KC][BW].  Rows past h or w and columns past N
// are zero-filled (a cp.async source size of 0) and never stored.  The
// copy width comes from the wrapper (`bcsr_spmm.sddmm_launch_config`);
// only the staging differs between widths, never the products, so every
// width gives the same bits.
//
// Products.  bf16: mma.sync m16n8k16 (f32 accumulate), fragments through
// ldmatrix (.trans for the operand staged k-major).  f32: 3xTF32, the
// split of spmm_tile.cuh -- hi = tf32(x), lo = tf32(x - hi), the products
// lo*hi, hi*lo, hi*hi summed from zero at each k step, then added to the
// accumulator with a round-to-nearest add (the tensor cores' own f32 sum
// truncates); each term is issued over the warp's eight tiles before the
// next, since mma.sync accumulates in place.  Rows are padded so that
// ldmatrix and the f32 fragment loads are free of bank conflicts.
//
// Epilogue.  The accumulators go through shared memory (reusing the ring)
// and are written once, in the output type, as 16-byte stores where the
// output rows allow it.
#pragma once

#include "spmm_tile.cuh"

namespace sddmm_tile {

using spmm_tile::cdiv;
using spmm_tile::cp_async_commit;
using spmm_tile::cp_async_wait;
using spmm_tile::for_copies;
using spmm_tile::stage_copy;

constexpr int kBM = 64;          // output rows a CTA owns
constexpr int kBW = 64;          // output columns a CTA owns
constexpr int kThreads = 128;    // 4 warps, 2 x 2 over the tile
constexpr int kStages = 3;       // chunk slots in the ring
constexpr int kCStride = kBW + 8;  // f32 epilogue rows

// Runtime arguments of one launch (a kernel parameter).
struct Args {
  const void* dc;     // [M, N], strides (sdm, sdn) in elements
  const void* b;      // [K, N], strides (sbk, sbn) in elements
  void* out;          // [stored entries, h, w], contiguous
  int h, w, n;
  long long sdm, sdn, sbk, sbn;
  int vec;            // copy width in bytes: 16, 8, 4 (or 2 for bf16)
  int out_bf16;       // output type: 0 = float32, 1 = bfloat16
  int out_vec;        // 1: output rows take 16-byte stores
};

// Staging of one operand: KMAJ = staged [KC][64] (its row axis contiguous
// in memory), else [64][KC] (its N axis contiguous).
template <typename T, bool KMAJ>
struct Operand {
  static constexpr int kEsize = sizeof(T);
  static constexpr int kKC = 128 / kEsize;
  // [64][KC + pad]: 144-byte rows; [KC][64 + pad]: 144 (bf16) or 288 (f32)
  // byte rows -- the f32 fragment loads of a k-major tile need a row
  // stride of 8 banks mod 32
  static constexpr int kStride = KMAJ ? 64 + 8 : kKC + 16 / kEsize;
  static constexpr int kElems = (KMAJ ? kKC : 64) * kStride;
};

template <typename T, bool AK, bool BK>
struct Layout {
  using A = Operand<T, AK>;
  using B = Operand<T, BK>;
  static constexpr int kEsize = sizeof(T);
  static constexpr int kKC = 128 / kEsize;
  static constexpr int kMmaK = kEsize == 2 ? 16 : 8;
  static constexpr int kSteps = kKC / kMmaK;        // 4 k steps a chunk
  static constexpr int kStageElems = A::kElems + B::kElems;
  static constexpr int kRingBytes = kStages * kStageElems * kEsize;
  static constexpr int kEpiBytes = kBM * kCStride * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kEpiBytes ? kRingBytes : kEpiBytes;
  static_assert(A::kStride * kEsize % 16 == 0 &&
                    B::kStride * kEsize % 16 == 0,
                "staged rows stay 16-byte aligned");
};

// Copy rows [row0, row0 + 64) x columns [k0, k0 + KC) of one operand
// (element (r, k) at src[r * sr + k * sk]) into one ring slot; rows at or
// past `rows` and columns at or past n are zeros.
template <typename T, bool KMAJ, int VEC>
__device__ __forceinline__ void load_operand(T* dst, const T* src,
                                             long long sr, long long sk,
                                             int rows, int k0, int n) {
  using O = Operand<T, KMAJ>;
  constexpr int kVE = VEC / sizeof(T);
  if constexpr (KMAJ) {      // [KC][64]: the row axis is contiguous
    constexpr int kRowV = 64 / kVE;
    for_copies<VEC, O::kKC * kRowV, kThreads>([&](int v) {
      const int kk = v / kRowV, r = (v % kRowV) * kVE;
      stage_copy<VEC>(dst + kk * O::kStride + r,
                      src + r * sr + (long long)(k0 + kk) * sk,
                      r < rows && k0 + kk < n, src);
    });
  } else {                   // [64][KC]: the N axis is contiguous
    constexpr int kRowV = O::kKC / kVE;
    for_copies<VEC, 64 * kRowV, kThreads>([&](int v) {
      const int r = v / kRowV, kk = (v % kRowV) * kVE;
      stage_copy<VEC>(dst + r * O::kStride + kk,
                      src + r * sr + (long long)(k0 + kk) * sk,
                      r < rows && k0 + kk < n, src);
    });
  }
}

template <typename T, bool AK, bool BK, int VEC>
__device__ __forceinline__ void load_chunk(T* a_s, T* b_s, const T* a_src,
                                           const T* b_src, const Args& g,
                                           int rows, int cols, int k0) {
  load_operand<T, AK, VEC>(a_s, a_src, g.sdm, g.sdn, rows, k0, g.n);
  load_operand<T, BK, VEC>(b_s, b_src, g.sbk, g.sbn, cols, k0, g.n);
}

template <typename T, bool AK, bool BK>
__device__ __forceinline__ void load_any(T* a_s, T* b_s, const T* a_src,
                                         const T* b_src, const Args& g,
                                         int rows, int cols, int k0) {
  // the width is uniform over the launch, so this branch never diverges
  if (g.vec == 16) {
    load_chunk<T, AK, BK, 16>(a_s, b_s, a_src, b_src, g, rows, cols, k0);
  } else if (g.vec == 8) {
    load_chunk<T, AK, BK, 8>(a_s, b_s, a_src, b_src, g, rows, cols, k0);
  } else if (sizeof(T) == 4 || g.vec == 4) {
    load_chunk<T, AK, BK, 4>(a_s, b_s, a_src, b_src, g, rows, cols, k0);
  } else if constexpr (sizeof(T) == 2) {
    load_chunk<T, AK, BK, 2>(a_s, b_s, a_src, b_src, g, rows, cols, k0);
  }
}

// ---------------------------------------------------------------- products
// One chunk's k steps (up to nsteps; steps past N hold zeros and are
// skipped) of this warp's 32 x 32 tile: rows m0 .. m0 + 31, cols n0 .. + 31.
template <bool AK, bool BK>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][4][4],
                                          const __nv_bfloat16* a_s,
                                          const __nv_bfloat16* b_s, int m0,
                                          int n0, int nsteps) {
  using L = Layout<__nv_bfloat16, AK, BK>;
  constexpr int AS = L::A::kStride, BS = L::B::kStride;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = 0; ks < L::kSteps; ++ks) {
    if (ks >= nsteps) break;
    const int k = ks * 16;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if constexpr (AK)
        spmm_tile::ldmatrix_x4_trans(
            a[mt], a_s + (k + lane % 8 + (lane / 16) * 8) * AS + m0 +
                       mt * 16 + ((lane / 8) % 2) * 8);
      else
        spmm_tile::ldmatrix_x4(
            a[mt], a_s + (m0 + mt * 16 + lane % 16) * AS + k +
                       (lane / 16) * 8);
    }
#pragma unroll
    for (int nt = 0; nt < 4; nt += 2) {
      uint32_t bf[4];
      if constexpr (BK)
        spmm_tile::ldmatrix_x4_trans(
            bf, b_s + (k + lane % 16) * BS + n0 + nt * 8 + (lane / 16) * 8);
      else
        spmm_tile::ldmatrix_x4(
            bf, b_s + (n0 + nt * 8 + lane % 8 + (lane / 16) * 8) * BS + k +
                    ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        spmm_tile::mma_bf16(acc[mt][nt], a[mt], bf[0], bf[1]);
        spmm_tile::mma_bf16(acc[mt][nt + 1], a[mt], bf[2], bf[3]);
      }
    }
  }
}

template <bool AK, bool BK>
__device__ __forceinline__ void chunk_mma(float (&acc)[2][4][4],
                                          const float* a_s, const float* b_s,
                                          int m0, int n0, int nsteps) {
  using L = Layout<float, AK, BK>;
  constexpr int AS = L::A::kStride, BS = L::B::kStride;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int ks = 0; ks < L::kSteps; ++ks) {
    if (ks >= nsteps) break;
    const int k = ks * 8;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + mt * 16 + gid;
      float x[4];
      if constexpr (AK) {        // [k][m]
        const float* ap = a_s + (k + tig) * AS + m;
        x[0] = ap[0];
        x[1] = ap[8];
        x[2] = ap[4 * AS];
        x[3] = ap[4 * AS + 8];
      } else {                   // [m][k]
        const float* ap = a_s + m * AS + k + tig;
        x[0] = ap[0];
        x[1] = ap[8 * AS];
        x[2] = ap[4];
        x[3] = ap[8 * AS + 4];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        spmm_tile::split_tf32(x[q], ahi[mt][q], alo[mt][q]);
    }
    uint32_t bhi[4][2], blo[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = n0 + nt * 8 + gid;
      float b0, b1;
      if constexpr (BK) {        // [k][n]
        b0 = b_s[(k + tig) * BS + c];
        b1 = b_s[(k + tig + 4) * BS + c];
      } else {                   // [n][k]
        b0 = b_s[c * BS + k + tig];
        b1 = b_s[c * BS + k + tig + 4];
      }
      spmm_tile::split_tf32(b0, bhi[nt][0], blo[nt][0]);
      spmm_tile::split_tf32(b1, bhi[nt][1], blo[nt][1]);
    }
    // one k step's 24 products a tile, summed from zero, then a
    // round-to-nearest add; issued term by term over the eight tiles, so
    // that no product waits on the one before it
    float t[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) t[mt][nt][q] = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        spmm_tile::mma_tf32(t[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        spmm_tile::mma_tf32(t[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        spmm_tile::mma_tf32(t[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += t[mt][nt][q];
  }
}

// --------------------------------------------------------------- epilogue
template <typename TOut>
__device__ __forceinline__ void store_tile(const float* c_s, const Args& g,
                                           long long e, int r0, int c0,
                                           int rows, int cols) {
  TOut* out = static_cast<TOut*>(g.out) + (e * g.h + r0) * g.w + c0;
  constexpr int kVE = 16 / sizeof(TOut);
  if (g.out_vec) {   // w * sizeof(TOut) % 16 == 0 and out aligned
    for (int v = threadIdx.x; v < kBM * kBW / kVE; v += kThreads) {
      const int r = v / (kBW / kVE), c = (v % (kBW / kVE)) * kVE;
      if (r >= rows || c >= cols) continue;
      alignas(16) TOut pack[kVE];
#pragma unroll
      for (int q = 0; q < kVE; ++q) {
        if constexpr (sizeof(TOut) == 2)
          pack[q] = __float2bfloat16(c_s[r * kCStride + c + q]);
        else
          pack[q] = c_s[r * kCStride + c + q];
      }
      *reinterpret_cast<uint4*>(out + (long long)r * g.w + c) =
          *reinterpret_cast<const uint4*>(pack);
    }
  } else {
    for (int v = threadIdx.x; v < kBM * kBW; v += kThreads) {
      const int r = v / kBW, c = v % kBW;
      if (r >= rows || c >= cols) continue;
      if constexpr (sizeof(TOut) == 2)
        out[(long long)r * g.w + c] = __float2bfloat16(c_s[r * kCStride + c]);
      else
        out[(long long)r * g.w + c] = c_s[r * kCStride + c];
    }
  }
}

// ------------------------------------------------------------------ the CTA
// Grid (entries, ceil(h / 64), ceil(w / 64)), kThreads threads, Layout::
// kSmemBytes of dynamic shared memory.  src.get(blockIdx.x, e, row, col)
// names the output entry, the dC block-row and the B block-col, and
// returns false where the CTA has no work (the same for all its threads):
// the CTA then returns before its first load and its first __syncthreads.
template <class Source, typename T, bool AK, bool BK>
__global__ void __launch_bounds__(kThreads, 4)
sddmm_kernel(const Source src, const Args g) {
  using L = Layout<T, AK, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  long long e, row, col;
  if (!src.get(blockIdx.x, e, row, col)) return;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.z * kBW;
  const int rows = min(kBM, g.h - r0), cols = min(kBW, g.w - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = (warp % 2) * 32, n0 = (warp / 2) * 32;
  const T* a_src = static_cast<const T*>(g.dc) + (row * g.h + r0) * g.sdm;
  const T* b_src = static_cast<const T*>(g.b) + (col * g.w + c0) * g.sbk;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  const int total = cdiv(g.n, L::kKC);
  // j < 0: the prologue fills kStages - 1 slots; then each step waits for
  // chunk j, refills the slot chunk j - 1 used, and multiplies chunk j
  for (int j = 1 - kStages; j < total; ++j) {
    if (j >= 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();         // chunk j landed; chunk j - 1's slot is free
    }
    const int jn = j + kStages - 1;
    if (jn < total) {
      T* a_s = ring + (jn % kStages) * L::kStageElems;
      load_any<T, AK, BK>(a_s, a_s + L::A::kElems, a_src, b_src, g, rows,
                          cols, jn * L::kKC);
    }
    cp_async_commit();
    if (j < 0) continue;
    const T* a_s = ring + (j % kStages) * L::kStageElems;
    const int kc = min(L::kKC, g.n - j * L::kKC);
    chunk_mma<AK, BK>(acc, a_s, a_s + L::A::kElems, m0, n0,
                      cdiv(kc, L::kMmaK));
  }
  cp_async_wait<0>();
  __syncthreads();             // the ring is free: reuse it for the tile

  float* c_s = reinterpret_cast<float*>(smem);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = c_s + (m0 + mt * 16 + gid) * kCStride + n0 + nt * 8 +
                 2 * tig;
      p[0] = acc[mt][nt][0];
      p[1] = acc[mt][nt][1];
      p[8 * kCStride] = acc[mt][nt][2];
      p[8 * kCStride + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  if (g.out_bf16)
    store_tile<__nv_bfloat16>(c_s, g, e, r0, c0, rows, cols);
  else
    store_tile<float>(c_s, g, e, r0, c0, rows, cols);
}

// ------------------------------------------------------------------- host
// The copy width `vec` is legal for one operand of `rows`-row blocks
// staged k-major (rows contiguous) or not (N contiguous): the pointer
// aligned, the staged axis contiguous, and every staged row start and edge
// (the block's rows, N) on a multiple of `vec` bytes.
inline bool operand_vec_ok(const void* p, int vec, int esize, int rows,
                           int n, long long sr, long long sk, bool kmaj) {
  if (!spmm_tile::aligned(p, vec)) return false;
  if (kmaj)
    return sr == 1 && (long long)rows * esize % vec == 0 &&
           (n == 1 || sk * esize % vec == 0);
  return sk == 1 && (long long)n * esize % vec == 0 &&
         sr * esize % vec == 0;
}

inline bool vec_ok(const Args& g, int esize, bool ak, bool bk) {
  const int v = g.vec;
  if (v == esize) return v == 2 || v == 4;
  if (v != 4 && v != 8 && v != 16) return false;
  if (v < esize) return false;
  return operand_vec_ok(g.dc, v, esize, g.h, g.n, g.sdm, g.sdn, ak) &&
         operand_vec_ok(g.b, v, esize, g.w, g.n, g.sbk, g.sbn, bk);
}

template <class Source, typename T, bool AK, bool BK>
cudaError_t launch_one(const Source& src, const Args& g, int entries,
                       cudaStream_t stream) {
  using L = Layout<T, AK, BK>;
  auto kernel = sddmm_kernel<Source, T, AK, BK>;
  // set once per instantiation; its error is every later launch's error
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(entries, cdiv(g.h, kBM), cdiv(g.w, kBW));
  kernel<<<grid, kThreads, L::kSmemBytes, stream>>>(src, g);
  return cudaGetLastError();
}

template <class Source, typename T>
cudaError_t launch_major(const Source& src, const Args& g, int entries,
                         int ak, int bk, cudaStream_t st) {
  if (ak)
    return bk ? launch_one<Source, T, true, true>(src, g, entries, st)
              : launch_one<Source, T, true, false>(src, g, entries, st);
  return bk ? launch_one<Source, T, false, true>(src, g, entries, st)
            : launch_one<Source, T, false, false>(src, g, entries, st);
}

// Launch one SDDMM over `entries` sources (B2's stored entries, B4's
// schedule slots), each a column of CTAs over the block.  Type codes: 0 =
// float32, 1 = bfloat16 (`dc` and `b` share in_type).  `ak` / `bk`: dC /
// B staged k-major (their row axis contiguous).  Returns the launch's
// cudaError_t (0 = launched); cudaErrorInvalidValue for a copy width or
// type it does not take.
template <class Source>
cudaError_t launch(const Source& src, Args g, int entries, int ak, int bk,
                   int in_type, int out_type, cudaStream_t stream) {
  if ((in_type != 0 && in_type != 1) || (out_type != 0 && out_type != 1) ||
      g.h <= 0 || g.w <= 0 || g.n < 0)
    return cudaErrorInvalidValue;
  const int esize = in_type == 1 ? 2 : 4;
  if (!vec_ok(g, esize, ak != 0, bk != 0)) return cudaErrorInvalidValue;
  g.out_bf16 = out_type;
  g.out_vec = spmm_tile::aligned(g.out, 16) &&
              (long long)g.w * (out_type == 1 ? 2 : 4) % 16 == 0;
  if (entries == 0) return cudaSuccess;
  if (in_type == 0)
    return launch_major<Source, float>(src, g, entries, ak, bk, stream);
  return launch_major<Source, __nv_bfloat16>(src, g, entries, ak, bk,
                                             stream);
}

}  // namespace sddmm_tile
