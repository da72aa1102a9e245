// The block-sparse tile product shared by the SpMM kernels B1
// (bcsr_spmm.cu, `bcsr_spmm_nnz_stream`) and B3 (bcsr_spmm_row_loop.cu,
// `bcsr_spmm_row_loop`), for NVIDIA Hopper (sm_90a).  The two kernels differ
// only in where a block-row's entries come from (a `Source`: rowptr, or the
// static slot schedule); everything below -- the CTA layout, the copies, the
// products and their order -- is one code path, so B3 is bit-equal to B1 on
// the same entries.
//
// CTA layout.  One CTA owns the output tile [BM rows of block-row i (from
// row r0 of the block), BN columns from n0] and walks the row's entries in
// order.  Each entry's A block rows and the matching B panel (rows col*w ..
// col*w + w - 1) are cut into reduction chunks of KC columns (128 bytes of a
// row; 256 when BM = 16), and one chunk sequence runs across all entries:
// chunk j is entry j / kpe, columns (j % kpe) * KC.
//   BM = 128: 8 warps split the rows, 16 each (one m16 row group), and each
//            runs every k step of a chunk over its BN columns.  It covers a
//            128-row block whole, so each B panel is read once per block-row.
//   BM = 16: 4 warps on one m16 row group split each chunk's k steps; their
//            partial sums are added in warp order at the end (fixed order:
//            deterministic).  This is the decode shape, N <= 16, where more
//            CTAs per block-row keep the card's SMs streaming A, and the
//            shape of blocks of h <= 64 (grid z covers the block's rows).
//
// Loads.  A ring of kStages chunk slots in dynamic shared memory, filled with
// cp.async (16-, 8- or 4-byte copies; 2-byte bf16 loads where nothing wider
// is aligned) and consumed kStages - 1 chunks later; one __syncthreads per
// chunk, and the ring never drains at an entry's end.  Bytes beyond the
// block (rows >= h, columns >= w) or beyond N are filled with zeros (a
// cp.async source size of 0) and never stored.  The copy width is chosen by
// the wrapper from the pointers and strides; only the staging differs
// between widths, never the products, so every width gives the same bits.
// The entries' block and column ids are staged in shared memory, kWin at a
// time, so the copy of a chunk never waits on a dependent index load.
//
// Products.  bf16: mma.sync m16n8k16 (f32 accumulate), operands through
// ldmatrix; B staged n-major (the x^T view, k contiguous) is already the
// .col operand, B staged k-major (row-major B) takes ldmatrix.trans.  f32:
// 3xTF32 -- each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (cvt.rna), and three m16n8k8 TF32 products lo*hi, hi*lo, hi*hi are summed
// in that order; the tensor cores' f32 sum truncates, so each k step's sum
// starts from zero and is added to the accumulator with round-to-nearest
// adds.  Close to an f32 product (1e-6 of max|C| at the attention backward's
// shape), and deterministic.
// Shared-memory rows are padded by 16 bytes (k-major B rows of BN >= 16 by
// 8 elements) so that ldmatrix and the f32 fragment loads are free of bank
// conflicts.
//
// Epilogue.  The accumulators go through shared memory (reusing the ring)
// and are written once, in the output type, as 16-byte stores where the
// output row allows it.
//
// Instances.  One launch can cover G instances that share the entry list
// (the JAX package's `vmap` of the op: the attention heads): `vals`, B and
// the output each step by their own batch stride from one instance to the
// next, and grid x runs instance-major over (instance, block-row), so x
// holds nbr * G CTAs (gridDim.x takes up to 2^31 - 1; y and z only
// 65,535).  A CTA offsets its loads and stores by its instance's batch
// strides and otherwise runs the single-instance tile unchanged, so a
// launch over G instances gives the bits of G launches of one.  A launch
// of one instance runs the kernel's MULTI = false instantiation, which has
// no instance arithmetic (the per-instance index and offsets cost a
// register, and some instantiations spill with it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace spmm_tile {

// 4 warps a CTA (BM = 16), 8 (BM = 128)
__host__ __device__ constexpr int threads_for(int bm) {
  return bm == 128 ? 256 : 128;
}
constexpr int kStages = 4;      // chunk slots in the ring
constexpr int kWin = 128;       // entries whose ids are staged at once

// Runtime arguments of one launch (a kernel parameter).
struct Args {
  const void* vals;   // [G, nnzb, h, w], each instance contiguous
  const void* b;      // [G, K, N], strides (s_b, sbk, sbn) in elements
  void* out;          // [G, nbr * h, N], each instance contiguous
  int h, w, n_cols;
  long long sbk, sbn;
  int vec;            // copy width in bytes: 16, 8, 4 (or 2 for bf16)
  int out_bf16;       // output type: 0 = float32, 1 = bfloat16
  int out_vec;        // 1: output rows take 16-byte stores
  int nbr;            // block-rows: the CTAs along x of one instance
  long long s_vals, s_b, s_out;  // batch strides in elements (0 for G = 1)
};

template <typename T, int BM, int BN, bool KMAJ>
struct Layout {
  static constexpr int kEsize = sizeof(T);
  static constexpr int kKC = (BM == 16 ? 256 : 128) / kEsize;  // chunk cols
  static constexpr int kMmaK = kEsize == 2 ? 16 : 8;           // mma depth
  static constexpr int kSteps = kKC / kMmaK;                   // per chunk
  static constexpr int kWM = BM / 16;          // warps along the rows
  static constexpr int kThreads = threads_for(BM);
  static constexpr int kWK = kThreads / 32 / kWM;  // warps along a chunk's k
  static constexpr int kNT = BN / 8;           // n8 tiles per warp
  static constexpr int kAStride = kKC + 16 / kEsize;
  // B n-major: [BN][KC + pad]; k-major: [KC][BN + pad]
  static constexpr int kBStride = KMAJ ? BN + (BN == 8 ? 0 : 8)
                                       : kKC + 16 / kEsize;
  static constexpr int kBRows = KMAJ ? kKC : BN;
  static constexpr int kAElems = BM * kAStride;
  static constexpr int kStageElems = kAElems + kBRows * kBStride;
  static constexpr int kRingBytes = kStages * kStageElems * kEsize;
  static constexpr int kCStride = BN + 4;      // f32 epilogue rows
  static constexpr int kEpiBytes = kWK * BM * kCStride * 4;
  static constexpr int kSmemBytes =
      kRingBytes > kEpiBytes ? kRingBytes : kEpiBytes;
  static_assert(BM == 16 || BM == 128, "BM is 16 or 128");
  static_assert(kSteps % kWK == 0, "k steps split evenly over the warps");
  static_assert(kAStride * kEsize % 16 == 0 && kBStride * kEsize % 16 == 0,
                "staged rows stay 16-byte aligned");
};

// ------------------------------------------------------------- primitives
__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One copy of VEC bytes from global to shared memory; zeros where !valid.
template <int VEC>
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           bool valid, const void* safe) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(valid ? src : safe), "r"(valid ? 16 : 0));
  } else if constexpr (VEC == 8 || VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(valid ? src : safe), "n"(VEC), "r"(valid ? VEC : 0));
  } else {
    static_assert(VEC == 2, "copy widths: 16, 8, 4 or 2 bytes");
    *static_cast<__nv_bfloat16*>(dst) =
        valid ? *static_cast<const __nv_bfloat16*>(src)
              : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value (3xTF32 operand split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// ------------------------------------------------------------------ stages
// body(v) for v = 0 .. N - 1, spread over the CTA's threads: unrolled for
// the 16-byte copies of the main path, a plain loop for the narrow ones.
template <int VEC, int N, int kThreads, class Body>
__device__ __forceinline__ void for_copies(const Body& body) {
  if constexpr (VEC == 16) {
#pragma unroll
    for (int it = 0; it < cdiv(N, kThreads); ++it) {
      const int v = threadIdx.x + it * kThreads;
      if (N % kThreads == 0 || v < N) body(v);
    }
  } else {
#pragma unroll 1
    for (int v = threadIdx.x; v < N; v += kThreads) body(v);
  }
}

// Copy chunk (entry block s of block-col cb, columns k0 .. k0 + KC) of
// instance `inst` into one ring slot.
template <typename T, int BM, int BN, bool KMAJ, int VEC>
__device__ __forceinline__ void load_chunk(T* a_s, T* b_s, const Args& g,
                                           int inst, long long s,
                                           long long cb, int k0, int r0,
                                           int rows, int n0) {
  using L = Layout<T, BM, BN, KMAJ>;
  constexpr int kVE = VEC / L::kEsize;          // elements per copy
  constexpr int kRowV = L::kKC / kVE;           // copies per staged row
  const T* vals = static_cast<const T*>(g.vals) + inst * g.s_vals;
  const T* b = static_cast<const T*>(g.b) + inst * g.s_b;
  const T* a_src = vals + (s * g.h + r0) * g.w + k0;
  for_copies<VEC, BM * kRowV, L::kThreads>([&](int v) {
    const int r = v / kRowV, kk = (v % kRowV) * kVE;
    stage_copy<VEC>(a_s + r * L::kAStride + kk,
                    a_src + (long long)r * g.w + kk,
                    r < rows && k0 + kk < g.w, vals);
  });
  const T* b_src = b + (cb * g.w + k0) * g.sbk + (long long)n0 * g.sbn;
  if constexpr (KMAJ) {        // row-major B: [KC][BN], n contiguous
    constexpr int kNV = BN / kVE;
    for_copies<VEC, L::kKC * kNV, L::kThreads>([&](int v) {
      const int kk = v / kNV, c = (v % kNV) * kVE;
      stage_copy<VEC>(b_s + kk * L::kBStride + c,
                      b_src + kk * g.sbk + (long long)c * g.sbn,
                      k0 + kk < g.w && n0 + c < g.n_cols, b);
    });
  } else {                     // the x^T view: [BN][KC], k contiguous
    for_copies<VEC, BN * kRowV, L::kThreads>([&](int v) {
      const int c = v / kRowV, kk = (v % kRowV) * kVE;
      stage_copy<VEC>(b_s + c * L::kBStride + kk,
                      b_src + kk * g.sbk + (long long)c * g.sbn,
                      k0 + kk < g.w && n0 + c < g.n_cols, b);
    });
  }
}

template <typename T, int BM, int BN, bool KMAJ>
__device__ __forceinline__ void load_any(T* a_s, T* b_s, const Args& g,
                                         int inst, long long s, long long cb,
                                         int k0, int r0, int rows, int n0) {
  // the width is uniform over the launch, so this branch never diverges
  if (g.vec == 16) {
    load_chunk<T, BM, BN, KMAJ, 16>(a_s, b_s, g, inst, s, cb, k0, r0, rows,
                                    n0);
  } else if (g.vec == 8) {
    load_chunk<T, BM, BN, KMAJ, 8>(a_s, b_s, g, inst, s, cb, k0, r0, rows,
                                   n0);
  } else if (sizeof(T) == 4 || g.vec == 4) {
    load_chunk<T, BM, BN, KMAJ, 4>(a_s, b_s, g, inst, s, cb, k0, r0, rows,
                                   n0);
  } else if constexpr (sizeof(T) == 2) {
    load_chunk<T, BM, BN, KMAJ, 2>(a_s, b_s, g, inst, s, cb, k0, r0, rows,
                                   n0);
  }
}

// ---------------------------------------------------------------- products
// One chunk's k steps of this warp into acc (row group wm, k steps
// wk, wk + kWK, ...; steps past the block's w hold zeros and are skipped).
template <int BM, int BN, bool KMAJ>
__device__ __forceinline__ void chunk_mma(
    float (&acc)[BN / 8][4], const __nv_bfloat16* a_s,
    const __nv_bfloat16* b_s, int wm, int wk, int nsteps) {
  using L = Layout<__nv_bfloat16, BM, BN, KMAJ>;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int ks = wk; ks < L::kSteps; ks += L::kWK) {
    if (ks >= nsteps) break;
    const int k = ks * 16;
    uint32_t a[4];
    ldmatrix_x4(a, a_s + (wm * 16 + lane % 16) * L::kAStride + k +
                       (lane / 16) * 8);
    if constexpr (L::kNT == 1) {
      uint32_t bf[2];
      const int l = lane % 16;
      if constexpr (KMAJ)
        ldmatrix_x2_trans(bf, b_s + (k + l) * L::kBStride);
      else
        ldmatrix_x2(bf, b_s + (l % 8) * L::kBStride + k + (l / 8) * 8);
      mma_bf16(acc[0], a, bf[0], bf[1]);
    } else {
#pragma unroll
      for (int nt = 0; nt < L::kNT; nt += 2) {
        uint32_t bf[4];
        if constexpr (KMAJ)
          ldmatrix_x4_trans(bf, b_s + (k + lane % 16) * L::kBStride +
                                    nt * 8 + (lane / 16) * 8);
        else
          ldmatrix_x4(bf, b_s + (nt * 8 + lane % 8 + (lane / 16) * 8) *
                                    L::kBStride + k + ((lane / 8) % 2) * 8);
        mma_bf16(acc[nt], a, bf[0], bf[1]);
        mma_bf16(acc[nt + 1], a, bf[2], bf[3]);
      }
    }
  }
}

template <int BM, int BN, bool KMAJ>
__device__ __forceinline__ void chunk_mma(float (&acc)[BN / 8][4],
                                          const float* a_s, const float* b_s,
                                          int wm, int wk, int nsteps) {
  using L = Layout<float, BM, BN, KMAJ>;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int ks = wk; ks < L::kSteps; ks += L::kWK) {
    if (ks >= nsteps) break;
    const int k = ks * 8;
    const float* ap = a_s + (wm * 16 + gid) * L::kAStride + k + tig;
    uint32_t ahi[4], alo[4];
    split_tf32(ap[0], ahi[0], alo[0]);
    split_tf32(ap[8 * L::kAStride], ahi[1], alo[1]);
    split_tf32(ap[4], ahi[2], alo[2]);
    split_tf32(ap[8 * L::kAStride + 4], ahi[3], alo[3]);
#pragma unroll
    for (int nt = 0; nt < L::kNT; ++nt) {
      float b0, b1;
      if constexpr (KMAJ) {
        const float* bp = b_s + (k + tig) * L::kBStride + nt * 8 + gid;
        b0 = bp[0];
        b1 = bp[4 * L::kBStride];
      } else {
        const float* bp = b_s + (nt * 8 + gid) * L::kBStride + k + tig;
        b0 = bp[0];
        b1 = bp[4];
      }
      uint32_t bhi0, blo0, bhi1, blo1;
      split_tf32(b0, bhi0, blo0);
      split_tf32(b1, bhi1, blo1);
      // one k step's 24 products, then a round-to-nearest add
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32(t, alo, bhi0, bhi1);
      mma_tf32(t, ahi, blo0, blo1);
      mma_tf32(t, ahi, bhi0, bhi1);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nt][q] += t[q];
    }
  }
}

// --------------------------------------------------------------- epilogue
template <typename TOut, int BM, int BN, int WK, int kThreads>
__device__ __forceinline__ void store_tile(const float* c_s, int cstride,
                                           const Args& g, int inst,
                                           long long row0, int rows,
                                           int n0) {
  TOut* out = static_cast<TOut*>(g.out) + inst * g.s_out;
  const int cols = min(BN, g.n_cols - n0);
  constexpr int kVE = 16 / sizeof(TOut);
  auto sum = [&](int r, int c) {
    float s = c_s[r * cstride + c];
#pragma unroll
    for (int q = 1; q < WK; ++q) s += c_s[(q * BM + r) * cstride + c];
    return s;
  };
  if (g.out_vec) {   // n_cols * sizeof(TOut) % 16 == 0 and out aligned
    for (int v = threadIdx.x; v < BM * BN / kVE; v += kThreads) {
      const int r = v / (BN / kVE), c = (v % (BN / kVE)) * kVE;
      if (r >= rows || c >= cols) continue;
      alignas(16) TOut pack[kVE];
#pragma unroll
      for (int e = 0; e < kVE; ++e) {
        if constexpr (sizeof(TOut) == 2)
          pack[e] = __float2bfloat16(sum(r, c + e));
        else
          pack[e] = sum(r, c + e);
      }
      *reinterpret_cast<uint4*>(out + (row0 + r) * g.n_cols + n0 + c) =
          *reinterpret_cast<const uint4*>(pack);
    }
  } else {
    for (int v = threadIdx.x; v < BM * BN; v += kThreads) {
      const int r = v / BN, c = v % BN;
      if (r >= rows || c >= cols) continue;
      if constexpr (sizeof(TOut) == 2)
        out[(row0 + r) * g.n_cols + n0 + c] = __float2bfloat16(sum(r, c));
      else
        out[(row0 + r) * g.n_cols + n0 + c] = sum(r, c);
    }
  }
}

// ------------------------------------------------------------------ the CTA
// Grid (nbr * G, ceil(N / BN), ceil(h / BM)), Layout::kThreads threads,
// Layout::kSmemBytes of dynamic shared memory; x = instance * nbr + i (G =
// 1 unless MULTI).  Source supplies block-row i's entry count and, for
// entries e0 .. e0 + n - 1, their block ids and block-cols (the same for
// every instance).
template <class Source, typename T, int BM, int BN, bool KMAJ, bool MULTI>
__global__ void __launch_bounds__(threads_for(BM))
spmm_kernel(const Source src, const Args g) {
  using L = Layout<T, BM, BN, KMAJ>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int idx_s[kWin];
  __shared__ int col_s[kWin];
  T* ring = reinterpret_cast<T*>(smem);

  const int inst = MULTI ? blockIdx.x / g.nbr : 0;
  const int i = MULTI ? blockIdx.x - inst * g.nbr : blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int r0 = blockIdx.z * BM;
  const int rows = min(BM, g.h - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % L::kWM, wk = warp / L::kWM;

  const int n_entries = src.count(i);
  const int kpe = (g.w + L::kKC - 1) / L::kKC;     // chunks per entry
  const int total = n_entries * kpe;
  int wbase = 0;
  src.fill(i, 0, min(kWin, n_entries), idx_s, col_s);
  __syncthreads();

  auto issue = [&](int j) {
    const int e = j / kpe;
    if (e >= wbase + kWin) {   // uniform: the next window of entry ids
      __syncthreads();
      wbase = e;
      src.fill(i, wbase, min(kWin, n_entries - wbase), idx_s, col_s);
      __syncthreads();
    }
    T* a_s = ring + (j % kStages) * L::kStageElems;
    load_any<T, BM, BN, KMAJ>(a_s, a_s + L::kAElems, g, inst,
                              idx_s[e - wbase], col_s[e - wbase],
                              (j % kpe) * L::kKC, r0, rows, n0);
  };

  float acc[L::kNT][4];
#pragma unroll
  for (int t = 0; t < L::kNT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;

  // j < 0: the prologue fills kStages - 1 slots; then each step waits for
  // chunk j, refills the slot chunk j - 1 used, and multiplies chunk j
  for (int j = 1 - kStages; j < total; ++j) {
    if (j >= 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();         // chunk j landed; chunk j - 1's slot is free
    }
    if (j + kStages - 1 < total) issue(j + kStages - 1);
    cp_async_commit();
    if (j < 0) continue;
    const T* a_s = ring + (j % kStages) * L::kStageElems;
    const int kc = min(L::kKC, g.w - (j % kpe) * L::kKC);
    chunk_mma<BM, BN, KMAJ>(acc, a_s, a_s + L::kAElems, wm, wk,
                            (kc + L::kMmaK - 1) / L::kMmaK);
  }
  cp_async_wait<0>();
  __syncthreads();             // the ring is free: reuse it for the tile

  float* c_s = reinterpret_cast<float*>(smem);
  const int gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int t = 0; t < L::kNT; ++t) {
    float* p = c_s + (wk * BM + wm * 16 + gid) * L::kCStride + t * 8 + 2 * tig;
    p[0] = acc[t][0];
    p[1] = acc[t][1];
    p[8 * L::kCStride] = acc[t][2];
    p[8 * L::kCStride + 1] = acc[t][3];
  }
  __syncthreads();
  const long long row0 = (long long)i * g.h + r0;
  if (g.out_bf16)
    store_tile<__nv_bfloat16, BM, BN, L::kWK, L::kThreads>(
        c_s, L::kCStride, g, inst, row0, rows, n0);
  else
    store_tile<float, BM, BN, L::kWK, L::kThreads>(c_s, L::kCStride, g, inst,
                                                   row0, rows, n0);
}

// ------------------------------------------------------------------- host
inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The copy width `vec` is legal for these operands (the wrapper's choice,
// checked again here): both pointers aligned, the staged axis contiguous,
// and every row start and every chunk edge on a multiple of `vec` bytes.
inline bool vec_ok(const Args& g, int esize, bool kmajor) {
  const int v = g.vec;
  if (v == esize) return v == 2 || v == 4;
  if (v != 4 && v != 8 && v != 16) return false;
  if (v < esize || !aligned(g.vals, v) || !aligned(g.b, v) ||
      (long long)g.w * esize % v || g.s_vals * esize % v ||
      g.s_b * esize % v)
    return false;
  if (kmajor)
    return g.sbn == 1 && g.sbk * esize % v == 0 &&
           (long long)g.n_cols * esize % v == 0;
  return g.sbk == 1 && (g.n_cols == 1 || g.sbn * esize % v == 0);
}

template <class Source, typename T, int BM, int BN, bool KMAJ, bool MULTI>
cudaError_t launch_one(const Source& src, Args g, int grid_x,
                       cudaStream_t stream) {
  using L = Layout<T, BM, BN, KMAJ>;
  auto kernel = spmm_kernel<Source, T, BM, BN, KMAJ, MULTI>;
  // set once per instantiation; its error is every later launch's error
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(grid_x, (g.n_cols + BN - 1) / BN, (g.h + BM - 1) / BM);
  kernel<<<grid, L::kThreads, L::kSmemBytes, stream>>>(src, g);
  return cudaGetLastError();
}

template <class Source, typename T, int BM, int BN, bool KMAJ>
cudaError_t launch_multi(const Source& src, const Args& g, int grid_x,
                         cudaStream_t st) {
  return grid_x > g.nbr
             ? launch_one<Source, T, BM, BN, KMAJ, true>(src, g, grid_x, st)
             : launch_one<Source, T, BM, BN, KMAJ, false>(src, g, grid_x,
                                                          st);
}

template <class Source, typename T, int BM, int BN>
cudaError_t launch_kmajor(const Source& src, const Args& g, int grid_x,
                          int kmajor, cudaStream_t st) {
  return kmajor ? launch_multi<Source, T, BM, BN, true>(src, g, grid_x, st)
                : launch_multi<Source, T, BM, BN, false>(src, g, grid_x, st);
}

template <class Source, typename T, int BM>
cudaError_t launch_bn(const Source& src, const Args& g, int grid_x, int bn,
                      int kmajor, cudaStream_t st) {
  const int x = grid_x;
  switch (bn) {
    case 8: return launch_kmajor<Source, T, BM, 8>(src, g, x, kmajor, st);
    case 16: return launch_kmajor<Source, T, BM, 16>(src, g, x, kmajor, st);
    case 32: return launch_kmajor<Source, T, BM, 32>(src, g, x, kmajor, st);
    case 64: return launch_kmajor<Source, T, BM, 64>(src, g, x, kmajor, st);
    default: return cudaErrorInvalidValue;
  }
}

// Launch one SpMM over `instances` instances (g's batch strides apart).
// Type codes: 0 = float32, 1 = bfloat16 (`vals` and `b` share in_type).
// Returns the launch's cudaError_t (0 = launched); cudaErrorInvalidValue
// for a tile, row block or copy width it does not take, or a grid x past
// 2^31 - 1.
template <class Source>
cudaError_t launch(const Source& src, Args g, int nbr, int instances,
                   int bn, int bm, int kmajor, int in_type, int out_type,
                   cudaStream_t stream) {
  if ((in_type != 0 && in_type != 1) || (out_type != 0 && out_type != 1) ||
      g.h <= 0 || g.w <= 0 || nbr < 0 || instances < 1 ||
      (long long)nbr * instances > INT_MAX)
    return cudaErrorInvalidValue;
  const int esize = in_type == 1 ? 2 : 4;
  if (!vec_ok(g, esize, kmajor != 0)) return cudaErrorInvalidValue;
  const int osize = out_type == 1 ? 2 : 4;
  g.out_bf16 = out_type;
  g.out_vec = aligned(g.out, 16) && (long long)g.n_cols * osize % 16 == 0 &&
              g.s_out * osize % 16 == 0;
  g.nbr = nbr;
  if (nbr == 0 || g.n_cols == 0) return cudaSuccess;
  const int grid_x = nbr * instances;
  if (in_type == 0) {
    if (bm == 16)
      return launch_bn<Source, float, 16>(src, g, grid_x, bn, kmajor, stream);
    if (bm == 128)
      return launch_bn<Source, float, 128>(src, g, grid_x, bn, kmajor,
                                           stream);
  } else {
    if (bm == 16)
      return launch_bn<Source, __nv_bfloat16, 16>(src, g, grid_x, bn, kmajor,
                                                  stream);
    if (bm == 128)
      return launch_bn<Source, __nv_bfloat16, 128>(src, g, grid_x, bn,
                                                   kmajor, stream);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------- the C queries
// The dynamic shared memory (Layout::kSmemBytes) and the threads of the
// instantiation `launch` takes for these codes; -1 for one it does not
// compile.  Each SpMM library exports them as plain C queries, so that
// the static analyzer's Python mirrors can be held to them on the card.
template <typename T, int BM, int BN>
int smem_of(int kmajor) {
  return kmajor ? Layout<T, BM, BN, true>::kSmemBytes
                : Layout<T, BM, BN, false>::kSmemBytes;
}

template <typename T, int BM>
int smem_bn(int bn, int kmajor) {
  switch (bn) {
    case 8: return smem_of<T, BM, 8>(kmajor);
    case 16: return smem_of<T, BM, 16>(kmajor);
    case 32: return smem_of<T, BM, 32>(kmajor);
    case 64: return smem_of<T, BM, 64>(kmajor);
    default: return -1;
  }
}

inline int smem_bytes(int in_type, int bm, int bn, int kmajor) {
  if (in_type == 0) {
    if (bm == 16) return smem_bn<float, 16>(bn, kmajor);
    if (bm == 128) return smem_bn<float, 128>(bn, kmajor);
  } else if (in_type == 1) {
    if (bm == 16) return smem_bn<__nv_bfloat16, 16>(bn, kmajor);
    if (bm == 128) return smem_bn<__nv_bfloat16, 128>(bn, kmajor);
  }
  return -1;
}

inline int threads(int bm) {
  return bm == 16 || bm == 128 ? threads_for(bm) : -1;
}

}  // namespace spmm_tile
