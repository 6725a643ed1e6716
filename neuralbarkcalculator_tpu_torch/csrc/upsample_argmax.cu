// Fused per-image bicubic upsample + 3-class argmax for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel upsample_argmax
// (neuralbarkcalculator_tpu/ops/pallas_kernels.py:63-101, body _kernel at
// :36-60). For each image b and each class plane c it computes
//
//     logits_c = row_ops[b] (OH x F) @ feat[b, :, :, c] (F x Wf) @ colT (Wf x OW)
//
// in IEEE float32 and writes only argmax_c logits_c as uint8 [B, OH, OW];
// the float upsampled logits never reach device memory. The argmax uses
// strict '>' in the order c1 vs c0, then c2 vs max(c0, c1), so ties go to
// the lower class and all-zero padded rows (zero operator rows) come out 0.
//
// The operators are bicubic: every row of a row operator and every column
// of colT has at most 4 nonzeros, next to each other. Only those windows
// need arithmetic. At the main path's shapes (B = 8, OH = OW = 1024,
// F = Wf = 128) that is 25 MFLOP for the row side and 201 MFLOP for the
// column side, 3.4 us of float32 at 67 TFLOP/s, against 14.7 MB of traffic
// (feat 1.6 MB, row_ops 4.2 MB, colT 0.5 MB, the uint8 map 8.4 MB), 4.4 us
// at 3.35 TB/s. So the kernel is bound by bytes, and the map is 57 % of
// them.
//
// Design against that bound:
// - The windows come from the operator values, never from the bicubic
//   formula. Each column's window (its first and last nonzero row of colT)
//   arrives as col_win [2, OW], computed once per width operator by
//   ops/upsample_argmax.column_windows and cached beside colT: scanning
//   the 512 KB colT in every block would cost more than the kernel's own
//   traffic. Each block finds its row tile's window (the first and last
//   nonzero column over the tile's rows) from the tile it stages. A dense
//   operator has the whole axis as its window, so any operator gives the
//   right map, only slower. A row tile whose rows are all zero (padding
//   past an image's valid height) writes class 0 with no arithmetic.
// - One block per (image, 32-row tile, 1024-column span), 256 blocks at
//   the main path's shapes, two to an SM: the block loads and scans its
//   row tile once, stages the feature window feat[b, flo:fhi, :, :] once
//   (12 KB) and sums the row side for the whole span in one pass, then
//   walks the span's eight 128-column tiles; each tile's rows of colT
//   (11 KB) arrive by cp.async while the tile before it is computed and
//   stored.
// - Both sides map one output row to each lane. On the row side a lane
//   holds its row's window values in registers and warps take the
//   intermediate columns in turn, reading the feature values as broadcast
//   16-byte loads. On the column side a warp sums 8 columns at a time, as
//   two quads of 4 columns with one window each (at scale 8 a quad's
//   columns share their window, and a group's two quads' windows overlap
//   in 3 taps, a case unrolled in full), so the operator values are broadcast
//   loads and a lane reads its row's intermediate values without bank
//   conflicts. At EfficientNet's scale 32 the window edges fall between
//   columns 32k + 15 and 32k + 16, on quad edges too, and a group's two
//   quads mostly share one window (the general quad loop); at other
//   scales (a 1000-wide image: 31.25) a quad sums over the union of its
//   columns' windows.
// - The class bytes go through shared memory and leave as 16-byte stores,
//   neighbouring threads on neighbouring addresses.
// - The sums are those of the dense product without its zero terms: fmaf
//   in ascending index order from 0, on the row side over the row tile's
//   window and on the column side over each quad's window (the union of
//   its columns' windows; the other terms are exact zeros). For finite
//   logits the map equals the dense product's. A non-finite logit outside
//   the row tile's window, or outside the window of a pixel's quad, no
//   longer reaches that pixel (0 * inf was NaN).
// - Operators whose windows do not fit these buffers (a dense operator,
//   say) take a slower path in passes over chunks of both windows, with
//   the same sums.
// - The buffers are sized from the stride (struct Stride8, Stride4). At
//   stride 8 (and EfficientNet's 32) a 32-row tile needs at most 8
//   feature rows, a 128-column tile 20 intermediate columns and a
//   1024-column span 132. SegFormer's logits are at stride 4: a tile's 32
//   rows need 12 feature rows and its 128 columns 36, so the stride-4
//   kernel (upsample_argmax_kernel_s4, chosen when OW <= 4 Wf) takes 12
//   rows a pass, 36 columns a tile and spans of 2 tiles (68 intermediate
//   columns), which keeps two blocks to an SM with F = 256 (a 1024-row
//   image) in its row tile; its quads have 5-tap windows, the second
//   starting 1 after the first, a case unrolled in full as the 4-tap one
//   is at stride 8. Both kernels run the same code over their own sizes.
// - Plain fp32 FMAs on CUDA cores, no tensor cores: the banded arithmetic
//   is already below the byte bound, and TF32 would break the IEEE float32
//   parity that Precision.HIGHEST sets in the JAX package.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 32;                 // rows per block, one per lane
constexpr int kQuad = 4;                   // columns that share one window
constexpr int kGroup = 2 * kQuad;          // columns a warp sums at a time
constexpr int kColsPerWarp = 2 * kGroup;
constexpr int kTileW = kWarps * kColsPerWarp;  // columns per tile
constexpr int kFeatRow = 12;               // floats per staged (column, class)
constexpr int kFeatPitch = 3 * kFeatRow;   // floats per staged column: [c][f]
constexpr int kTmpPitch = kTileH + 1;      // floats per (class, column) row
constexpr int kOutPitch = kTileW + 16;     // bytes per row of the map tile
static_assert(kTileW == 4 * 32, "a warp stages a colT row as float4s");
static_assert(kTileH * (kTileW / 16) == kThreads,
              "one 16-byte store per thread per tile");

// The buffers of one stride (the header): column tiles per block,
// intermediate columns of a span and of a tile, feature rows per pass, and
// the taps of a quad's window in the unrolled group.
struct Stride8 {
  static constexpr int kTiles = 8;
  static constexpr int kSpanK = 136;
  static constexpr int kKChunk = 22;
  static constexpr int kFChunk = 10;
  static constexpr int kTaps = 4;
};
struct Stride4 {
  static constexpr int kTiles = 2;
  static constexpr int kSpanK = 72;
  static constexpr int kKChunk = 36;
  static constexpr int kFChunk = 12;
  static constexpr int kTaps = 5;
};

template <class S>
struct Sizes : S {
  static constexpr int kSpan = S::kTiles * kTileW;  // columns per block
  static constexpr int kQuads = kSpan / kQuad;
  static constexpr int kColtBuf = S::kKChunk * kTileW;
  static constexpr int kTmpClass = S::kSpanK * kTmpPitch;  // floats a class
  static constexpr int kWins = 4 + 2 * S::kTiles;  // flo, fhi, span, tiles
  static_assert(S::kFChunk <= kFeatRow && kFeatRow % 4 == 0,
                "a staged (column, class) row holds a pass as float4s");
};

// launch flags: which accesses may be 16-byte vectors
constexpr int kRowsVec = 1;  // F % 4 == 0 and row_ops 16-byte aligned
constexpr int kColtVec = 2;  // OW % 4 == 0 and colt 16-byte aligned
constexpr int kOutVec = 4;   // OW % 16 == 0 and out 16-byte aligned

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }
// Floats per staged row of the row tile: +4 keeps a lane reading its own
// row's column at 4-way bank conflicts, not 32-way.
__host__ __device__ inline int rows_pitch(int F) { return round_up4(F) + 4; }

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start copying the row tile [kTileH][F] into dst (pitch rows_pitch(F)).
// Rows past the operator's end, and the columns from F up to a multiple
// of 4, read 0.
__device__ inline void stage_rows(float* dst, const float* src, int rows_here,
                                  int F, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n4 = round_up4(F) >> 2, rp = rows_pitch(F);
  for (int r = warp; r < kTileH; r += kWarps) {
    for (int q = lane; q < n4; q += 32) {
      float* d = dst + r * rp + 4 * q;
      const float* g = src + (size_t)r * F + 4 * q;
      if (r >= rows_here) {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (vec) {
        cp_async16(d, g);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (4 * q + e < F)
            cp_async4(d + e, g + e);
          else
            d[e] = 0.f;
        }
      }
    }
  }
  cp_async_commit();
}

// Start copying feat_b[f0:f0+fn, k0:k0+kn, :] into dst [kn][3][kFeatRow]
// (column k, class c holds f - f0).
__device__ inline void stage_feat(float* dst, const float* __restrict__ fb,
                                  int Wf, int f0, int fn, int k0, int kn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < fn; i += kWarps) {
    const float* g = fb + ((size_t)(f0 + i) * Wf + k0) * 3;
    for (int e = lane; e < kn * 3; e += 32) {
      const int k = e / 3;
      cp_async4(dst + k * kFeatPitch + (e - 3 * k) * kFeatRow + i, g + e);
    }
  }
  cp_async_commit();
}

// Start copying colt[k0:k0+kn, tc0:tc0+kTileW] into dst [kn][kTileW]
// (columns past OW read 0).
__device__ inline void stage_colt(float* dst, const float* __restrict__ colt,
                                  int OW, int k0, int kn, int tc0, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = tc0 + 4 * lane;
  vec = vec && col + 4 <= OW;
  for (int k = warp; k < kn; k += kWarps) {
    const float* g = colt + (size_t)(k0 + k) * OW + col;
    float* d = dst + k * kTileW + 4 * lane;
    if (vec) {
      cp_async16(d, g);
    } else {
      for (int e = 0; e < 4; ++e) {
        if (col + e < OW)
          cp_async4(d + e, g + e);
        else
          d[e] = 0.f;
      }
    }
  }
  cp_async_commit();
}

// This lane's row values rows[lane][f0 .. f0 + fn) from row_ops (`rows`
// is the tile's first row), 0 past fn or past the operator's end.
template <int kFChunk>
__device__ inline void row_values(float (&rv)[kFChunk],
                                  const float* __restrict__ rows, int F,
                                  int rows_here, int f0, int fn) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kFChunk; ++i)
    rv[i] = i < fn && lane < rows_here
                ? __ldg(rows + (size_t)lane * F + f0 + i)
                : 0.f;
}

// Row side of one pass: tmp[c][k][r] (+)= sum_{i < fn} rv[i] *
// feat_s[k][c][i] for k < kn, from 0 when `first`. Lane = row, holding its
// fn <= N row values rv; warps take columns k in turn.
template <class Z, int N>
__device__ inline void row_pass_n(float* tmp_s, const float* fv_s,
                                  const float (&rv)[Z::kFChunk], int fn,
                                  bool first, int kn) {
  static_assert(N <= Z::kFChunk && N <= kFeatRow, "a pass holds N rows");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < kn; k += kWarps) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4* f4 = reinterpret_cast<const float4*>(
          fv_s + k * kFeatPitch + c * kFeatRow);
      float v[4 * ((N + 3) / 4)];
#pragma unroll
      for (int q = 0; q < (N + 3) / 4; ++q) {
        const float4 x = f4[q];
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
      float* t = tmp_s + c * Z::kTmpClass + k * kTmpPitch + lane;
      float a = first ? 0.f : *t;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i < fn) a = fmaf(rv[i], v[i], a);
      *t = a;
    }
  }
}

// The row side with the fewest idle FMA slots: bicubic row tiles of 32
// rows at scale 8 have windows of at most 8 feature rows.
template <class Z>
__device__ inline void row_pass(float* tmp_s, const float* fv_s,
                                const float (&rv)[Z::kFChunk], int fn,
                                bool first, int kn) {
  if (fn <= 8)
    row_pass_n<Z, 8>(tmp_s, fv_s, rv, fn, first, kn);
  else
    row_pass_n<Z, Z::kFChunk>(tmp_s, fv_s, rv, fn, first, kn);
}

// Column side for one quad (columns col + J0 .. + 3 of the tile) over k
// in [lo, hi): acc[c][J0 + j] += tmp[c][k - tk0][lane] *
// colt[k - ck0][col + J0 + j], ascending.
template <class Z, int J0>
__device__ inline void quad_pass(float (&acc)[3][kGroup], const float* tmp_s,
                                 const float* cv_s, int tk0, int ck0, int col,
                                 int lo, int hi) {
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int k = lo; k < hi; ++k) {
    const float* t = tmp_s + (k - tk0) * kTmpPitch + lane;
    const float t0 = t[0], t1 = t[Z::kTmpClass], t2 = t[2 * Z::kTmpClass];
    const float4 x = *reinterpret_cast<const float4*>(
        cv_s + (k - ck0) * kTileW + col + J0);
    const float cv[kQuad] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      acc[0][J0 + j] = fmaf(t0, cv[j], acc[0][J0 + j]);
      acc[1][J0 + j] = fmaf(t1, cv[j], acc[1][J0 + j]);
      acc[2][J0 + j] = fmaf(t2, cv[j], acc[2][J0 + j]);
    }
  }
}

// One 8-column group whose quads both have T-tap windows, the second
// starting D = 1 after the first at k (the bicubic operators at scale 8,
// T = 4, and at scale 4, T = 5): the group's T + D intermediate values are
// loaded once and every tap is unrolled.
template <class Z>
__device__ inline void group_taps(float (&acc)[3][kGroup], const float* tmp_s,
                                  const float* cv_s, int tk, int ck,
                                  int col) {
  constexpr int D = 1, T = Z::kTaps;
  const int lane = threadIdx.x & 31;
  float t[3][T + D];
#pragma unroll
  for (int u = 0; u < T + D; ++u)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      t[c][u] = tmp_s[c * Z::kTmpClass + (tk + u) * kTmpPitch + lane];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(
          cv_s + (ck + q * D + u) * kTileW + col + q * kQuad);
      const float cv[kQuad] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < kQuad; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          acc[c][q * kQuad + j] =
              fmaf(t[c][q * D + u], cv[j], acc[c][q * kQuad + j]);
    }
  }
}

// One 8-column group over the k in [k0, k1) that tmp (from tk0) and the
// staged colT rows (from ck0) hold: its two quads, windows [lo_a, hi_a)
// and [lo_b, hi_b).
template <class Z>
__device__ inline void column_pass(float (&acc)[3][kGroup],
                                   const float* tmp_s, const float* cv_s,
                                   int tk0, int ck0, int k0, int k1, int col,
                                   int lo_a, int hi_a, int lo_b, int hi_b) {
  if (hi_a - lo_a == Z::kTaps && lo_b == lo_a + 1 && hi_b == hi_a + 1 &&
      lo_a >= k0 && hi_b <= k1) {
    group_taps<Z>(acc, tmp_s, cv_s, lo_a - tk0, lo_a - ck0, col);
    return;
  }
  quad_pass<Z, 0>(acc, tmp_s, cv_s, tk0, ck0, col, max(lo_a, k0),
                  min(hi_a, k1));
  quad_pass<Z, kQuad>(acc, tmp_s, cv_s, tk0, ck0, col, max(lo_b, k0),
                      min(hi_b, k1));
}

__device__ inline void zero(float (&acc)[3][kGroup]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[c][j] = 0.f;
}

// The class bytes of columns j0 .. j0 + 3 of a group, little-endian.
__device__ inline uint32_t class_bytes(const float (&acc)[3][kGroup], int j0) {
  uint32_t w = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a0 = acc[0][j0 + j], a1 = acc[1][j0 + j], a2 = acc[2][j0 + j];
    const float best = fmaxf(a0, a1);
    const uint32_t idx = a2 > best ? 2u : (a1 > a0 ? 1u : 0u);
    w |= idx << (8 * j);
  }
  return w;
}

// A tile of a block whose windows do not fit the one-pass buffers: each
// group sums over the tile's window in kKChunk-column passes, each staging
// and summing the row side in kFChunk-row steps. Correct for any operator;
// kept out of line so that the one-pass path keeps its registers. Returns
// this lane's 16 class bytes.
template <class Z>
__device__ __noinline__ uint4 tile_in_passes(
    float* tmp_s, float* feat_s, float* ccur, const float* __restrict__ rows,
    int F, int rows_here, const float* __restrict__ fb,
    const float* __restrict__ colt, int Wf, int OW, int flo, int fhi,
    int wlo, int whi, int tc0, bool colt_vec, const int* qw) {
  const int warp = threadIdx.x >> 5;
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float acc[3][kGroup];
    zero(acc);
    for (int kc0 = wlo; kc0 < whi; kc0 += Z::kKChunk) {
      const int kn = min(Z::kKChunk, whi - kc0);
      stage_colt(ccur, colt, OW, kc0, kn, tc0, colt_vec);
      for (int f0 = flo; f0 < fhi; f0 += Z::kFChunk) {
        const int fn = min(Z::kFChunk, fhi - f0);
        stage_feat(feat_s, fb, Wf, f0, fn, kc0, kn);
        float rv[Z::kFChunk];
        row_values(rv, rows, F, rows_here, f0, fn);
        cp_async_wait_all();
        __syncthreads();
        row_pass<Z>(tmp_s, feat_s, rv, fn, f0 == flo, kn);
        __syncthreads();
      }
      column_pass<Z>(acc, tmp_s, ccur, kc0, kc0, kc0, kc0 + kn,
                  warp * kColsPerWarp + kGroup * p, qw[4 * p],
                  qw[4 * p + 1], qw[4 * p + 2], qw[4 * p + 3]);
      __syncthreads();  // the next pass overwrites its inputs
    }
    w[2 * p] = class_bytes(acc, 0);
    w[2 * p + 1] = class_bytes(acc, kQuad);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Bytes of the first shared region: the row tile until it is scanned,
// then the staged features.
template <class Z>
__host__ __device__ inline size_t region_bytes(int F) {
  const size_t rows = (size_t)kTileH * rows_pitch(F) * sizeof(float);
  const size_t feat = (size_t)Z::kSpanK * kFeatPitch * sizeof(float);
  return rows > feat ? rows : feat;
}

// The kernel's body at the sizes Z (Sizes<Stride8>, Sizes<Stride4>).
template <class Z>
__device__ __forceinline__ void upsample_argmax_body(
    const float* __restrict__ feat, const float* __restrict__ row_ops,
    const float* __restrict__ colt, const int* __restrict__ col_win,
    uint8_t* __restrict__ out, int OH, int F, int Wf, int OW, int flags) {
  constexpr int kTiles = Z::kTiles, kSpan = Z::kSpan, kSpanK = Z::kSpanK;
  constexpr int kKChunk = Z::kKChunk, kFChunk = Z::kFChunk;
  constexpr int kColtBuf = Z::kColtBuf, kTmpClass = Z::kTmpClass;
  constexpr int kWins = Z::kWins;
  extern __shared__ float4 smem4[];
  // the row tile [kTileH][rows_pitch(F)] until it is scanned, then the
  // staged features [kSpanK][3][kFeatRow]
  float* rows_s = reinterpret_cast<float*>(smem4);
  float* feat_s = rows_s;
  float* colt_s = rows_s + region_bytes<Z>(F) / sizeof(float);  // [2][kColtBuf]
  float* tmp_s = colt_s + 2 * kColtBuf;              // [3][kSpanK][kTmpPitch]
  uint8_t* out_s = reinterpret_cast<uint8_t*>(tmp_s + 3 * kTmpClass);
  int* win_s = reinterpret_cast<int*>(out_s + kTileH * kOutPitch);
  int* qwin_s = win_s + kWins;  // [kQuads][lo, hi]: each quad's window

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rp = rows_pitch(F);
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * kSpan;
  const int r0 = blockIdx.y * kTileH;
  const int rows_here = min(kTileH, OH - r0);
  const int ntiles = min(kTiles, (OW - c0 + kTileW - 1) / kTileW);
  const float* fb = feat + (size_t)b * F * Wf * 3;
  const float* rows = row_ops + ((size_t)b * OH + r0) * F;
  const bool colt_vec = flags & kColtVec;

  stage_rows(rows_s, rows, rows_here, F, flags & kRowsVec);
  if (tid < kWins) win_s[tid] = (tid & 1) ? 0 : (tid == 0 ? F : Wf);
  __syncthreads();

  // ---- each quad's window (the union of its columns'), each tile's and
  //      the span's, while the row tile is in flight
  for (int i = tid; i < kSpan; i += kThreads) {  // a warp stays in one tile
    int lo = Wf, hi = 0;
    if (c0 + i < OW) {
      const int l = __ldg(col_win + c0 + i), h = __ldg(col_win + OW + c0 + i);
      if (l < h) {
        lo = l;
        hi = h;
      }
    }
#pragma unroll
    for (int o = 1; o < kQuad; o <<= 1) {
      lo = min(lo, __shfl_xor_sync(~0u, lo, o));
      hi = max(hi, __shfl_xor_sync(~0u, hi, o));
    }
    if ((lane & (kQuad - 1)) == 0) {
      qwin_s[2 * (i / kQuad)] = lo;
      qwin_s[2 * (i / kQuad) + 1] = hi;
    }
    lo = __reduce_min_sync(~0u, lo);
    hi = __reduce_max_sync(~0u, hi);
    if (lane == 0) {
      atomicMin(&win_s[4 + 2 * (i / kTileW)], lo);
      atomicMax(&win_s[5 + 2 * (i / kTileW)], hi);
      atomicMin(&win_s[2], lo);
      atomicMax(&win_s[3], hi);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- the row tile's window: first and last nonzero column
  {
    const int n4 = round_up4(F) >> 2;
    int fl = F, fh = 0;
    for (int r = warp; r < kTileH; r += kWarps) {
      for (int q = lane; q < n4; q += 32) {
        const float4 v =
            *reinterpret_cast<const float4*>(rows_s + r * rp + 4 * q);
        const int f = 4 * q;
        if (v.x != 0.f) { fl = min(fl, f); fh = max(fh, f + 1); }
        if (v.y != 0.f) { fl = min(fl, f + 1); fh = max(fh, f + 2); }
        if (v.z != 0.f) { fl = min(fl, f + 2); fh = max(fh, f + 3); }
        if (v.w != 0.f) { fl = min(fl, f + 3); fh = max(fh, f + 4); }
      }
    }
    fl = __reduce_min_sync(~0u, fl);
    fh = __reduce_max_sync(~0u, fh);
    if (lane == 0) {
      atomicMin(&win_s[0], fl);
      atomicMax(&win_s[1], fh);
    }
  }
  __syncthreads();  // the windows are in; the row tile is no longer read
  const int flo = win_s[0], fhi = win_s[1];
  const int slo = win_s[2], shi = win_s[3];
  const bool rows_live = flo < fhi;
  // one pass (always, for the bicubic operators): the row side once for
  // the span, each tile's colT rows prefetched a tile ahead
  bool fast = rows_live && fhi - flo <= kFChunk && shi - slo <= kSpanK;
  for (int t = 0; t < ntiles; ++t)
    fast = fast && win_s[5 + 2 * t] - win_s[4 + 2 * t] <= kKChunk;
  auto prefetch = [&](int t) {
    const int wlo = win_s[4 + 2 * t], whi = win_s[5 + 2 * t];
    if (wlo < whi)
      stage_colt(colt_s + (t & 1) * kColtBuf, colt, OW, wlo, whi - wlo,
                 c0 + t * kTileW, colt_vec);
  };
  if (fast) {
    float rv[kFChunk];  // this lane's row values, from the staged tile
#pragma unroll
    for (int i = 0; i < kFChunk; ++i)
      rv[i] = i < fhi - flo ? rows_s[lane * rp + flo + i] : 0.f;
    __syncthreads();  // the row tile is read: the features take its place
    stage_feat(feat_s, fb, Wf, flo, fhi - flo, slo, shi - slo);
    prefetch(0);
    cp_async_wait_all();
    __syncthreads();
    row_pass<Z>(tmp_s, feat_s, rv, fhi - flo, true, shi - slo);
  }

  for (int t = 0; t < ntiles; ++t) {
    const int tc0 = c0 + t * kTileW;
    const int wlo = win_s[4 + 2 * t], whi = win_s[5 + 2 * t];
    float* ccur = colt_s + (t & 1) * kColtBuf;
    if (fast) cp_async_wait_all();
    __syncthreads();  // this tile's colT rows and tmp are in; out_s is free
    if (fast && t + 1 < ntiles) prefetch(t + 1);
    const int* qw = qwin_s + 2 * ((t * kTileW + warp * kColsPerWarp) / kQuad);

    // ---- lane = row; each warp sums its 16 columns as two 8-column
    //      groups of two quads
    uint4 cls = make_uint4(0u, 0u, 0u, 0u);
    if (fast && wlo < whi) {
      float acc[3][kGroup];
      zero(acc);
      column_pass<Z>(acc, tmp_s, ccur, slo, wlo, wlo, whi,
                     warp * kColsPerWarp, qw[0], qw[1], qw[2], qw[3]);
      cls.x = class_bytes(acc, 0);
      cls.y = class_bytes(acc, kQuad);
      zero(acc);
      column_pass<Z>(acc, tmp_s, ccur, slo, wlo, wlo, whi,
                     warp * kColsPerWarp + kGroup, qw[4], qw[5], qw[6], qw[7]);
      cls.z = class_bytes(acc, 0);
      cls.w = class_bytes(acc, kQuad);
    } else if (!fast && rows_live && wlo < whi) {
      cls = tile_in_passes<Z>(tmp_s, feat_s, ccur, rows, F, rows_here, fb,
                              colt, Wf, OW, flo, fhi, wlo, whi, tc0,
                              colt_vec, qw);
    }
    *reinterpret_cast<uint4*>(out_s + lane * kOutPitch + warp * kColsPerWarp) =
        cls;
    __syncthreads();

    // ---- the map tile leaves as 16-byte stores, 8 threads per row
    const int r = tid / (kTileW / 16), s = tid % (kTileW / 16);
    const int col = tc0 + 16 * s;
    if (r < rows_here && col < OW) {
      const uint8_t* src = out_s + r * kOutPitch + 16 * s;
      uint8_t* dst = out + ((size_t)b * OH + r0 + r) * OW + col;
      if ((flags & kOutVec) && col + 16 <= OW) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 16 && col + e < OW; ++e) dst[e] = src[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
upsample_argmax_kernel(const float* __restrict__ feat,
                       const float* __restrict__ row_ops,
                       const float* __restrict__ colt,
                       const int* __restrict__ col_win,
                       uint8_t* __restrict__ out, int OH, int F, int Wf,
                       int OW, int flags) {
  upsample_argmax_body<Sizes<Stride8>>(feat, row_ops, colt, col_win, out, OH,
                                       F, Wf, OW, flags);
}

__global__ void __launch_bounds__(kThreads, 2)
upsample_argmax_kernel_s4(const float* __restrict__ feat,
                          const float* __restrict__ row_ops,
                          const float* __restrict__ colt,
                          const int* __restrict__ col_win,
                          uint8_t* __restrict__ out, int OH, int F, int Wf,
                          int OW, int flags) {
  upsample_argmax_body<Sizes<Stride4>>(feat, row_ops, colt, col_win, out, OH,
                                       F, Wf, OW, flags);
}

template <class Z>
size_t smem_bytes(int F) {
  return region_bytes<Z>(F) +
         (size_t)(2 * Z::kColtBuf + 3 * Z::kTmpClass) * sizeof(float) +
         (size_t)kTileH * kOutPitch +
         (size_t)(Z::kWins + 2 * Z::kQuads) * sizeof(int);
}

// The stride-4 sizes where the logits are at most 4 times narrower than
// the map (SegFormer), else the stride-8 ones.
bool stride4(int Wf, int OW) { return OW <= 4 * Wf; }

template <class Z>
int launch(void (*kernel)(const float*, const float*, const float*,
                          const int*, uint8_t*, int, int, int, int, int),
           const float* feat, const float* row_ops, const float* colt,
           const int* col_win, uint8_t* out, int B, int OH, int F, int Wf,
           int OW, cudaStream_t stream) {
  const size_t smem = smem_bytes<Z>(F);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int flags = 0;
  if (F % 4 == 0 && ((uintptr_t)row_ops & 15) == 0) flags |= kRowsVec;
  if (OW % 4 == 0 && ((uintptr_t)colt & 15) == 0) flags |= kColtVec;
  if (OW % 16 == 0 && ((uintptr_t)out & 15) == 0) flags |= kOutVec;
  dim3 grid((OW + Z::kSpan - 1) / Z::kSpan, (OH + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, smem, stream>>>(feat, row_ops, colt, col_win, out,
                                          OH, F, Wf, OW, flags);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for these sizes (the wrapper checks it
// against the card's per-block limit before launching).
size_t upsample_argmax_smem_bytes(int F, int Wf, int OW) {
  return stride4(Wf, OW) ? smem_bytes<Sizes<Stride4>>(F)
                         : smem_bytes<Sizes<Stride8>>(F);
}

// feat [B, F, Wf, 3] f32, row_ops [B, OH, F] f32, colt [Wf, OW] f32,
// col_win [2, OW] int32 (each column's first nonzero row of colt, then
// its last + 1; lo >= hi for an all-zero column), all contiguous on the
// device; out [B, OH, OW] uint8. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
int upsample_argmax_launch(const float* feat, const float* row_ops,
                           const float* colt, const int* col_win,
                           uint8_t* out, int B, int OH, int F, int Wf, int OW,
                           void* stream) {
  if (stride4(Wf, OW))
    return launch<Sizes<Stride4>>(upsample_argmax_kernel_s4, feat, row_ops,
                                  colt, col_win, out, B, OH, F, Wf, OW,
                                  (cudaStream_t)stream);
  return launch<Sizes<Stride8>>(upsample_argmax_kernel, feat, row_ops, colt,
                                col_win, out, B, OH, F, Wf, OW,
                                (cudaStream_t)stream);
}

}  // extern "C"
