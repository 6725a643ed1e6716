// 8-connected component labelling and the small-zone clean-up for Hopper
// (sm_90a), as a parallel union-find.
//
// Replaces neuralbarkcalculator_tpu/ops/ccl.py (label_components :90-119,
// component_areas :122-132, remove_small_objects / remove_small_holes
// :135-150, _remove_small_zones_2d :153-165, the ragged
// _remove_small_zones_masked_2d :168-193). The JAX package computes these
// through XLA, not Pallas, as sweeps of segmented min-scans: a design for a
// TPU, where gathers are slow. A GPU chases pointers well, so this is the
// union-find of Playne & Hawick ("A New Algorithm for Parallel
// Connected-Component Labelling on GPUs", 2018) in its simplest form:
//
//   init      parent[p] = p (per-image flat index row * W + col) for a
//             foreground pixel, H * W (the sentinel) for the rest; the same
//             launch zeroes the per-image area table [B, H*W + 1];
//   merge     each foreground pixel unions with its foreground W, NW, N and
//             NE neighbours in the same image (at most two of them: the
//             others are joined by their own unions). Roots are linked by an
//             atomicMin retry loop, the larger root under the smaller, so a
//             pointer only ever decreases and stays inside its component:
//             the root of a component ends as its smallest index, whatever
//             order the atomics ran in. The labels therefore equal the JAX
//             package's bit for bit (the flat index of the component's
//             smallest pixel, background H * W);
//   compress  label = find(p), in place;
//   count     atomicAdd of each pixel into its root's area, one atomic per
//             distinct root in a warp (__match_any_sync);
//   then one elementwise kernel for the result: the area, a size test, or
//   the whole write-back of remove_small_zones.
//
// remove_small_zones runs two labellings: the holes step labels the
// non-zero pixels (rows below valid_h read as class 0), the objects step
// labels the cleaned class-0 mask cut at valid_h, built in place of the
// first labels by ccl_init_filled_kernel from those labels and areas.
//
// Indices: label values are per-image (0 .. H*W, int32), addresses are
// batch-global (int64). A pixel's neighbours are taken only inside its own
// image and row range, so no merge crosses an image boundary in a batch or
// a row end.
//
// Bound: bytes. The least traffic of remove_small_zones on a uint8 class
// map is one read of the map and one write of the result, 2 B a pixel
// (16.8 MB, 5.0 us at 3.35 TB/s for [8, 1024, 1024]). This first version
// moves far more (int32 labels and areas, two labellings) and is bound by
// the latency of its pointer chasing and atomics, not by bandwidth: every
// find walks a chain of dependent loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t global_index() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

// The root of x. `volatile`: during the merge other threads lower the
// pointers, and every read must see memory, not a register.
__device__ __forceinline__ int find_root(const volatile int* p, int x) {
  int px = p[x];
  while (px != x) {
    x = px;
    px = p[x];
  }
  return x;
}

// Union of the trees of a and b in one image's parent array.
__device__ __forceinline__ void unite(int* p, int a, int b) {
  bool done;
  do {
    a = find_root(p, a);
    b = find_root(p, b);
    if (a < b) {
      const int old = atomicMin(&p[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin(&p[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

template <typename T>
__device__ __forceinline__ bool nonzero(const void* src, int64_t i) {
  return static_cast<const T*>(src)[i] != T(0);
}

__device__ __forceinline__ bool src_nonzero(const void* src, int elem_bytes,
                                            int64_t i) {
  switch (elem_bytes) {
    case 1: return nonzero<uint8_t>(src, i);
    case 4: return nonzero<int32_t>(src, i);
    default: return nonzero<int64_t>(src, i);
  }
}

// parent = own index where fg, else the sentinel, with
// fg = (row < valid_h[b]) && ((src != 0) != invert); zeroes `areas`
// [B, HW + 1] when it is given.
__global__ void ccl_init_kernel(const void* __restrict__ src, int elem_bytes,
                                int invert, const int* __restrict__ valid_h,
                                int* __restrict__ parent,
                                int* __restrict__ areas, int64_t n, int H,
                                int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int local = (int)(i - b * hw);
  const int row = local / W;
  const bool in_rows = valid_h == nullptr || row < valid_h[b];
  const bool fg = in_rows && (src_nonzero(src, elem_bytes, i) != (invert != 0));
  parent[i] = fg ? local : hw;
  if (areas != nullptr) {
    areas[b * (hw + 1) + local] = 0;
    if (local == 0) areas[b * (hw + 1) + hw] = 0;
  }
}

// The objects step's mask from the holes step's labels and areas, in place
// (each pixel reads and writes only its own element): a non-zero pixel in
// a component of at least `thr` pixels stays non-zero, every other pixel
// below valid_h is class 0 after the hole fill and is foreground here.
__global__ void ccl_init_filled_kernel(int* __restrict__ labels,
                                       const int* __restrict__ areas_in,
                                       const int* __restrict__ valid_h,
                                       int thr, int* __restrict__ areas_out,
                                       int64_t n, int H, int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int local = (int)(i - b * hw);
  const int row = local / W;
  const int lab = labels[i];
  const bool kept_nonzero = lab != hw && areas_in[b * (hw + 1) + lab] >= thr;
  const bool in_rows = valid_h == nullptr || row < valid_h[b];
  labels[i] = (in_rows && !kept_nonzero) ? local : hw;
  areas_out[b * (hw + 1) + local] = 0;
  if (local == 0) areas_out[b * (hw + 1) + hw] = 0;
}

__global__ void ccl_merge_kernel(int* __restrict__ parent, int64_t n, int H,
                                 int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int local = (int)(i - b * hw);
  int* p = parent + b * hw;
  if (p[local] == hw) return;  // background (init wrote it; no one else)
  const int row = local / W;
  const int col = local - row * W;
  const int up = local - W;
  const bool has_w = col > 0 && p[local - 1] != hw;
  const bool has_n = row > 0 && p[up] != hw;
  const bool has_nw = row > 0 && col > 0 && p[up - 1] != hw;
  const bool has_ne = row > 0 && col + 1 < W && p[up + 1] != hw;
  // Unions that another pixel's own unions already imply are skipped: a
  // foreground N joins NW (N's own W) and NE (whose W is N), and, through
  // W's unions, W; with N background a foreground W joins NW (W's own N).
  if (has_n) {
    unite(p, local, up);
    return;
  }
  if (has_w) {
    unite(p, local, local - 1);
  } else if (has_nw) {
    unite(p, local, up - 1);
  }
  if (has_ne) unite(p, local, up + 1);
}

__global__ void ccl_compress_kernel(int* __restrict__ parent, int64_t n,
                                    int H, int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int local = (int)(i - b * hw);
  int* p = parent + b * hw;
  if (p[local] == hw) return;
  p[local] = find_root(p, local);
}

// areas[b, label] += 1 for every foreground pixel: the lanes of a warp that
// share a label add their count with one atomic.
__global__ void ccl_count_kernel(const int* __restrict__ labels,
                                 int* __restrict__ areas, int64_t n, int H,
                                 int W) {
  const int64_t i = global_index();
  const int hw = H * W;
  long long key = -1;
  if (i < n) {
    const int64_t b = i / hw;
    const int lab = labels[i];
    if (lab != hw) key = (long long)(b * (hw + 1) + lab);
  }
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31;
  if (key >= 0 && lane == __ffs(peers) - 1)
    atomicAdd(&areas[key], __popc(peers));
}

// out = the area of each pixel's component, 0 on the background.
__global__ void ccl_area_kernel(const int* __restrict__ labels,
                                const int* __restrict__ areas,
                                int* __restrict__ out, int64_t n, int H,
                                int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int lab = labels[i];
  out[i] = lab == hw ? 0 : areas[b * (hw + 1) + lab];
}

// out = (foreground && area >= thr) != invert, as bytes 0 / 1.
__global__ void ccl_keep_kernel(const int* __restrict__ labels,
                                const int* __restrict__ areas, int thr,
                                int invert, uint8_t* __restrict__ out,
                                int64_t n, int H, int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int lab = labels[i];
  const bool keep = lab != hw && areas[b * (hw + 1) + lab] >= thr;
  out[i] = keep != (invert != 0);
}

// The write-back of remove_small_zones (JAX ops/ccl.py:182-193): with
// v = (row < valid_h) ? img : 0 and `cleaned` the objects step's kept
// class-0 pixels, out = 1 where !cleaned && v == 0 && row < valid_h,
// 0 where cleaned && v != 0, else v.
template <typename T>
__global__ void ccl_writeback_kernel(const T* __restrict__ img,
                                     const int* __restrict__ valid_h,
                                     const int* __restrict__ labels,
                                     const int* __restrict__ areas, int thr,
                                     T* __restrict__ out, int64_t n, int H,
                                     int W) {
  const int64_t i = global_index();
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int local = (int)(i - b * hw);
  const bool in_rows = valid_h == nullptr || local / W < valid_h[b];
  const T v = in_rows ? img[i] : T(0);
  const int lab = labels[i];
  const bool cleaned = lab != hw && areas[b * (hw + 1) + lab] >= thr;
  T o = v;
  if (!cleaned && v == T(0) && in_rows) o = T(1);
  if (cleaned && v != T(0)) o = T(0);
  out[i] = o;
}

inline unsigned blocks(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Every entry takes contiguous device buffers of B*H*W pixels (n), areas of
// B*(H*W + 1) int32, and `valid_h` as int32 [B] or null (every row valid);
// elem_bytes is 1 (uint8 / bool), 4 (int32) or 8 (int64). Each launches on
// `stream`, returns cudaGetLastError() (0 on success) and does not
// synchronise. The caller checks H*W + 1 < 2^31.

int ccl_init_launch(const void* src, int elem_bytes, int invert,
                    const int* valid_h, int* parent, int* areas, int B,
                    int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  ccl_init_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      src, elem_bytes, invert, valid_h, parent, areas, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_init_filled_launch(int* labels, const int* areas_in,
                           const int* valid_h, int thr, int* areas_out,
                           int B, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  ccl_init_filled_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      labels, areas_in, valid_h, thr, areas_out, n, H, W);
  return (int)cudaGetLastError();
}

// merge then compress: parent becomes the labels.
int ccl_label_launch(int* parent, int B, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  ccl_merge_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      parent, n, H, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ccl_compress_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      parent, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_count_launch(const int* labels, int* areas, int B, int H, int W,
                     void* stream) {
  const int64_t n = (int64_t)B * H * W;
  ccl_count_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      labels, areas, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_area_launch(const int* labels, const int* areas, int* out, int B,
                    int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  ccl_area_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      labels, areas, out, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_keep_launch(const int* labels, const int* areas, int thr, int invert,
                    uint8_t* out, int B, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  ccl_keep_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      labels, areas, thr, invert, out, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_writeback_launch(const void* img, int elem_bytes, const int* valid_h,
                         const int* labels, const int* areas, int thr,
                         void* out, int B, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  const unsigned g = blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1:
      ccl_writeback_kernel<uint8_t><<<g, kThreads, 0, s>>>(
          (const uint8_t*)img, valid_h, labels, areas, thr, (uint8_t*)out, n,
          H, W);
      break;
    case 4:
      ccl_writeback_kernel<int32_t><<<g, kThreads, 0, s>>>(
          (const int32_t*)img, valid_h, labels, areas, thr, (int32_t*)out, n,
          H, W);
      break;
    case 8:
      ccl_writeback_kernel<int64_t><<<g, kThreads, 0, s>>>(
          (const int64_t*)img, valid_h, labels, areas, thr, (int64_t*)out, n,
          H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
