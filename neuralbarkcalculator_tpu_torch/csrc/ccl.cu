// 8-connected component labelling and the small-zone clean-up for Hopper
// (sm_90a), as a two-level union-find: tiles labelled in shared memory,
// then only the tiles' borders merged in device memory.
//
// Replaces neuralbarkcalculator_tpu/ops/ccl.py (label_components :90-119,
// component_areas :122-132, remove_small_objects / remove_small_holes
// :135-150, _remove_small_zones_2d :153-165, the ragged
// _remove_small_zones_masked_2d :168-193). The JAX package computes these
// through XLA, not Pallas, as sweeps of segmented min-scans: a design for a
// TPU, where gathers are slow. Here it is the block-based union-find of
// Playne & Hawick ("A New Algorithm for Parallel Connected-Component
// Labelling on GPUs", 2018) and Allegretti, Bolelli & Grana ("Optimized
// Block-Based Algorithms to Label Connected Components on GPUs", IEEE TPDS
// 2019), with the contract of the JAX package: a foreground pixel's label
// is the per-image flat index (row * W + col) of its component's smallest
// pixel, int32, and the background holds H * W.
//
// One labelling is three launches:
//
//   tile      one block of 512 threads per tile of kTileH x kTileW
//             (32 x 128) pixels of one image. The tile's
//             pixels are read once from the map in its own dtype (or, for
//             the objects step, from the holes step's labels and areas: the
//             clean-up's mask is built in this load), cut at valid_h. Each
//             pixel starts under the first pixel of its run in its warp's
//             32 columns (a ballot), so rows build no chains. The union-find
//             then runs in shared memory on tile-local indices (< 2^16, held
//             in 32-bit words: shared atomicMin takes 32 bits): the few
//             unions left (runs across 32 columns, and a run's first touch
//             of a run in the row above; 0.03-0.34 a pixel on class maps)
//             are gathered into a list and shared out over the block's
//             threads; roots are linked by atomicMin (the larger under the
//             smaller). Every pixel is then compressed to its tile root,
//             the smallest pixel of its tile component (tile-local and
//             per-image order agree), and its parent written as the
//             per-image flat index of that root, one coalesced int32 store
//             a pixel. Areas are counted in shared memory (one atomic per
//             distinct root in a warp) and written once per tile root; the
//             tile roots are appended to the tile's slot of `scratch`.
//   border    one thread per pixel of a tile's top row and left column:
//             it unions, through device memory, with the foreground
//             neighbours that lie in another tile (top row: N, else NW and
//             NE; left column: W, else NW and SW; the skipped ones are
//             joined by another pixel's unions). ~1/32 + 1/128 of the
//             pixels.
//             Chains run over tile roots only, so they are short.
//   finalize  one block per tile, over its tile roots only: each finds its
//             global root (the component's smallest pixel), points at it,
//             and adds its tile's partial area there with one atomic.
//             label_components then writes each pixel's label in the same
//             launch (its tile's roots are final once the block has
//             passed them).
//
// After it every foreground pixel reaches its label in two hops, pixel ->
// tile root -> global root, which the per-pixel consumers read: the area,
// the keep test, and the write-back of remove_small_zones.
// remove_small_zones is two labellings (holes, then objects on the filled
// class-0 mask) and the write-back: 7 launches; component_areas and the
// keep test 4; label_components 3. No table is zeroed: an area is only
// read at a global root, whose slot its tile wrote.
//
// Bound: bytes. The least traffic of remove_small_zones is one read of the
// map and one write of the result (16 B a pixel in int64, 2 in uint8; 134
// MB, 0.040 ms at 3.35 TB/s for [8, 1024, 1024] int64). This design moves
// 3 e + 16 B a pixel for an e-byte map: the map read by the holes tile
// load and by the write-back, the result written, and two int32 label
// planes each written once and read once; the border, finalize and the
// two-hop gathers touch tile roots only, which stay in L2. Latency: the
// union-find's pointer chasing runs in shared memory (tens of cycles a
// hop, not hundreds), and the device-memory chains and atomics are left to
// the tiles' borders and roots.
//
// Tried on an H100 80GB HBM3 (PERF.md keeps the numbers): one union a
// pixel inside the tile with volatile finds spent most of the tile
// kernel's time in its merge, a few lanes of each warp uniting while the
// others waited; runs, the union list and plain shared-memory finds cut
// it. Of the tiles 16 x 128, 32 x 128, 32 x 256, 64 x 128 and 64 x 256,
// 32 x 128 was the fastest (taller or wider tiles: longer chains, fewer
// blocks); 512 threads a tile beat 128 and 256. Not tried: the 2 x
// 2-block variant (BUF, whose block roots would need an atomicMin of each
// component's smallest pixel) and thread-block clusters merging
// neighbouring tiles in distributed shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kTileWLog2 = 7;
constexpr int kTilePixels = kTileH * kTileW;
constexpr int kTileThreads = 512;
constexpr int kFinalizeThreads = 128;
constexpr int kFlatThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileW == 1 << kTileWLog2 && kTileW >= 32,
              "a tile row is whole warps");
static_assert(kTilePixels % kTileThreads == 0,
              "every thread of a tile block takes as many pixels");
static_assert(kTilePixels < 1 << 15, "a union pair packs two indices");
static_assert(2 * kTilePixels * sizeof(int) + 8 <= 48 * 1024,
              "the tile's shared memory fits a block's default");

// The union-find over a parent array: `Ptr` is int* in shared memory,
// where plain loads see every store, and volatile int* in device memory,
// where each read must go to L2, which the atomics update (an L1 line may
// be stale, and a find that rereads a stale root would spin).

// The root of x, read only.
template <typename Ptr>
__device__ __forceinline__ int find_root(Ptr p, int x) {
  int px = p[x];
  while (px != x) {
    x = px;
    px = p[x];
  }
  return x;
}

// find_root for the merges, each node passed pointed at its grandparent on
// the way (path halving), so the chains that concurrent unions build stay
// short. The grandparent is a smaller index of the same component, so the
// link stays valid whatever other threads write meanwhile, and a root is
// never written: a link that a halving store overwrites is made again by
// unite's retry, which never trusts a store it did not see land. Only
// while a phase merges: a halving store may also overwrite a pointer that
// another thread has just set to its root, so the phases that compress to
// roots (the tile's compress, finalize) find with find_root.
template <typename Ptr>
__device__ __forceinline__ int find_halving(Ptr p, int x) {
  int cur = p[x];
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = p[cur])) {
      p[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

// Union of the trees of a and b. Roots are linked by atomicMin, the larger
// root under the smaller, so a pointer only ever decreases and stays inside
// its component: a component's root ends as its smallest index, whatever
// order the atomics ran in.
template <typename Ptr>
__device__ __forceinline__ void unite(Ptr p, int a, int b) {
  bool done;
  do {
    a = find_halving(p, a);
    b = find_halving(p, b);
    if (a < b) {
      const int old = atomicMin((int*)&p[b], a);
      done = old == b;
      b = old;
    } else if (b < a) {
      const int old = atomicMin((int*)&p[a], b);
      done = old == a;
      a = old;
    } else {
      done = true;
    }
  } while (!done);
}

// The geometry of one tile: image b, first row r0 and column c0.
struct Tile {
  int b, r0, c0;
  __device__ Tile(int tile, int tiles_x, int tiles_y) {
    const int per_image = tiles_x * tiles_y;
    b = tile / per_image;
    const int t = tile - b * per_image;
    const int ty = t / tiles_x;
    r0 = ty * kTileH;
    c0 = (t - ty * tiles_x) * kTileW;
  }
};

// A tile's slot in `scratch`: its root count, then its roots (at most one
// 8-connected component per 2 x 2 block of the tile).
constexpr int64_t kRootStride = (kTileH / 2) * (kTileW / 2) + 1;

// fg = (map != 0) != invert for the holes step and the masks.
template <typename T>
struct MapPred {
  const T* src;
  bool invert;
  __device__ bool operator()(int64_t base, int local) const {
    return (src[base + local] != T(0)) != invert;
  }
};

// The objects step's mask from the holes step's labels and areas: a
// non-zero pixel in a component of at least `thr` pixels stays non-zero;
// every other pixel is class 0 after the hole fill and is foreground here.
struct FilledPred {
  const int* prev;
  const int* prev_areas;
  int thr, hw;
  __device__ bool operator()(int64_t base, int local) const {
    const int lab = prev[base + local];
    return lab == hw || prev_areas[base + prev[base + lab]] < thr;
  }
};

template <class Pred>
__global__ void __launch_bounds__(kTileThreads)
    ccl_tile_kernel(Pred pred, const int* __restrict__ valid_h,
                    int* __restrict__ parent, int* __restrict__ areas,
                    int* __restrict__ scratch, int H, int W, int tiles_x,
                    int tiles_y) {
  constexpr int tw = kTileW, tw_log2 = kTileWLog2, npx = kTilePixels;
  __shared__ int s_parent[npx], s_area[npx], s_nroots, s_npairs;
  const int none = npx;  // the background in shared memory
  const Tile t(blockIdx.x, tiles_x, tiles_y);
  const int hw = H * W;
  const int64_t base = (int64_t)t.b * hw;
  const int rows_img = min(kTileH, H - t.r0);
  const int vh = valid_h == nullptr ? H : min(H, max(valid_h[t.b], 0));
  const int rows_fg = min(kTileH, vh - t.r0);
  const int cols = min(tw, W - t.c0);
  const bool count = areas != nullptr;

  // Each pixel starts under the first pixel of its run of foreground
  // pixels in its warp's 32 columns (a ballot), so rows form no chains.
  const int lane = threadIdx.x & 31;
  const unsigned lanes_to_here = (2u << lane) - 1;
#pragma unroll 4
  for (int i = threadIdx.x; i < npx; i += kTileThreads) {
    const int lr = i >> tw_log2, lc = i & (tw - 1);
    const bool fg = lr < rows_fg && lc < cols &&
                    pred(base, (t.r0 + lr) * W + t.c0 + lc);
    const unsigned gaps = ~__ballot_sync(kFull, fg) & lanes_to_here;
    s_parent[i] = fg ? i - lane + (32 - __clz(gaps)) : none;
  }
  if (threadIdx.x == 0) s_nroots = s_npairs = 0;
  __syncthreads();

  // The unions that remain: a run that goes on from the previous 32
  // columns, and the links to the row above where a run first touches a
  // run there. Others are implied: with W and NW foreground, W (or the
  // first pixel of the run to its left that touches the row above) joins
  // the run above that holds NW and N; with N background, a foreground W
  // joins NW through its own N, and a foreground E joins NE. At most two
  // a pixel, ~0.03-0.34 a pixel on class maps. They are gathered into a
  // list in s_area (free until the count) and then shared out evenly, so
  // a warp's lanes do unions side by side instead of a few lanes doing
  // them while the rest wait; where the list is full a lane unites at
  // once.
  int* s_pairs = s_area;
  const unsigned lanes_below = lanes_to_here >> 1;
  for (int i = threadIdx.x; i < npx; i += kTileThreads) {
    int n = 0, first = 0, second = 0;  // the pixels to unite with
    const auto add = [&](int j) {
      (n == 0 ? first : second) = j;
      ++n;
    };
    if (s_parent[i] != none) {
      const int lr = i >> tw_log2, lc = i & (tw - 1);
      const bool w = lc > 0 && s_parent[i - 1] != none;
      if (w && lane == 0) add(i - 1);
      if (lr > 0) {
        const int up = i - tw;
        const bool nw = lc > 0 && s_parent[up - 1] != none;
        if (s_parent[up] != none) {
          if (!(w && nw)) add(up);
        } else {
          if (nw && !w) add(up - 1);
          if (lc + 1 < tw && s_parent[up + 1] != none &&
              s_parent[i + 1] == none)
            add(up + 1);
        }
      }
    }
    const unsigned one = __ballot_sync(kFull, n >= 1);
    const unsigned two = __ballot_sync(kFull, n >= 2);
    int at = 0;
    if (lane == 0 && (one | two))
      at = atomicAdd(&s_npairs, __popc(one) + __popc(two));
    at = __shfl_sync(kFull, at, 0) + __popc(one & lanes_below) +
         __popc(two & lanes_below);
    if (n >= 1) {
      if (at < npx)
        s_pairs[at] = (i << 16) | first;
      else
        unite(s_parent, i, first);
    }
    if (n >= 2) {
      if (at + 1 < npx)
        s_pairs[at + 1] = (i << 16) | second;
      else
        unite(s_parent, i, second);
    }
  }
  __syncthreads();
  const int npairs = min(s_npairs, npx);
  for (int k = threadIdx.x; k < npairs; k += kTileThreads)
    unite(s_parent, s_pairs[k] >> 16, s_pairs[k] & 0xffff);
  __syncthreads();

  for (int i = threadIdx.x; i < npx; i += kTileThreads) {
    if (s_parent[i] != none) s_parent[i] = find_root(s_parent, i);
    s_area[i] = 0;
  }
  __syncthreads();

  if (count) {
    for (int i = threadIdx.x; i < npx; i += kTileThreads) {
      const int root = s_parent[i];
      const unsigned peers = __match_any_sync(kFull, root);
      if (root != none && (threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(&s_area[root], __popc(peers));
    }
    __syncthreads();
  }

  int* roots = scratch + blockIdx.x * kRootStride;
  for (int i = threadIdx.x; i < npx; i += kTileThreads) {
    const int lr = i >> tw_log2, lc = i & (tw - 1);
    const int root = s_parent[i];
    const int label = root == none ? hw
                                   : (t.r0 + (root >> tw_log2)) * W + t.c0 +
                                         (root & (tw - 1));
    if (lr < rows_img && lc < cols)
      parent[base + (t.r0 + lr) * W + t.c0 + lc] = label;
    const bool is_root = root == i;
    const unsigned mask = __ballot_sync(kFull, is_root);
    int first = 0;
    if ((threadIdx.x & 31) == 0 && mask)
      first = atomicAdd(&s_nroots, __popc(mask));
    first = __shfl_sync(kFull, first, 0);
    if (is_root) {
      roots[1 + first + __popc(mask & lanes_below)] = label;
      if (count) areas[base + label] = s_area[i];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) roots[0] = s_nroots;
}

// Each pixel of a tile's top row and left column unions with its
// foreground neighbours in other tiles (see the note at the top). The
// unions start from the pixels' tile roots, so only tile roots are ever
// written: every other pixel keeps its own tile's root, which finalize's
// label pass relies on.
__global__ void ccl_border_kernel(int* __restrict__ parent, int H, int W,
                                  int tiles_x, int tiles_y, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int tw = kTileW, per_tile = kTileW + kTileH;
  const int tile = (int)(i / per_tile);
  const int k = (int)(i - (int64_t)tile * per_tile);
  const Tile t(tile, tiles_x, tiles_y);
  const int hw = H * W;
  volatile int* p = parent + (int64_t)t.b * hw;
  if (k < tw) {  // top row: N, else NW and NE
    const int c = t.c0 + k;
    if (t.r0 == 0 || c >= W) return;
    const int q = t.r0 * W + c;
    if (p[q] == hw) return;
    const int up = q - W;
    const int rq = p[q];
    if (p[up] != hw) {
      unite(p, rq, p[up]);
      return;
    }
    if (c > 0 && p[up - 1] != hw) unite(p, rq, p[up - 1]);
    if (c + 1 < W && p[up + 1] != hw) unite(p, rq, p[up + 1]);
  } else {  // left column: W, else NW and SW
    const int r = t.r0 + k - tw;
    if (t.c0 == 0 || r >= H) return;
    const int q = r * W + t.c0;
    if (p[q] == hw) return;
    const int w = q - 1;
    const int rq = p[q];
    if (p[w] != hw) {
      unite(p, rq, p[w]);
      return;
    }
    if (r > 0 && p[w - W] != hw) unite(p, rq, p[w - W]);
    if (r + 1 < H && p[w + W] != hw) unite(p, rq, p[w + W]);
  }
}

// Each tile root points at its global root and adds its partial area
// there; with write_labels the block then writes its tile's labels.
__global__ void __launch_bounds__(kFinalizeThreads)
    ccl_finalize_kernel(int* __restrict__ parent, int* __restrict__ areas,
                        const int* __restrict__ scratch, int H, int W,
                        int tiles_x, int tiles_y, int write_labels) {
  constexpr int tw = kTileW;
  const Tile t(blockIdx.x, tiles_x, tiles_y);
  const int hw = H * W;
  const int64_t base = (int64_t)t.b * hw;
  volatile int* p = parent + base;
  const int* roots = scratch + blockIdx.x * kRootStride;
  const int n = roots[0];
  for (int k = threadIdx.x; k < n; k += kFinalizeThreads) {
    const int tr = roots[1 + k];
    const int g = find_root(p, tr);
    if (g != tr) {
      p[tr] = g;
      if (areas != nullptr) atomicAdd(&areas[base + g], areas[base + tr]);
    }
  }
  if (!write_labels) return;
  __syncthreads();
  const int rows = min(kTileH, H - t.r0), cols = min(tw, W - t.c0);
  for (int i = threadIdx.x; i < rows * tw; i += kFinalizeThreads) {
    const int lr = i / tw, lc = i - lr * tw;
    if (lc >= cols) continue;
    const int q = (t.r0 + lr) * W + t.c0 + lc;
    const int v = p[q];
    if (v != hw) p[q] = p[v];
  }
}

// The label of the pixel at batch-global index i in two hops, hw on the
// background.
__device__ __forceinline__ int label_of(const int* __restrict__ parent,
                                        int64_t i, int64_t base, int hw) {
  const int v = parent[i];
  return v == hw ? hw : parent[base + v];
}

// out = the area of each pixel's component, 0 on the background.
__global__ void ccl_area_kernel(const int* __restrict__ parent,
                                const int* __restrict__ areas,
                                int* __restrict__ out, int64_t n, int H,
                                int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hw = H * W;
  const int64_t base = i / hw * hw;
  const int lab = label_of(parent, i, base, hw);
  out[i] = lab == hw ? 0 : areas[base + lab];
}

// out = (foreground && area >= thr) != invert, as bytes 0 / 1.
__global__ void ccl_keep_kernel(const int* __restrict__ parent,
                                const int* __restrict__ areas, int thr,
                                int invert, uint8_t* __restrict__ out,
                                int64_t n, int H, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hw = H * W;
  const int64_t base = i / hw * hw;
  const int lab = label_of(parent, i, base, hw);
  const bool keep = lab != hw && areas[base + lab] >= thr;
  out[i] = keep != (invert != 0);
}

// The write-back of remove_small_zones (JAX ops/ccl.py:182-193): with
// v = (row < valid_h) ? img : 0 and `cleaned` the objects step's kept
// class-0 pixels, out = 1 where !cleaned && v == 0 && row < valid_h,
// 0 where cleaned && v != 0, else v.
template <typename T>
__global__ void ccl_writeback_kernel(const T* __restrict__ img,
                                     const int* __restrict__ valid_h,
                                     const int* __restrict__ parent,
                                     const int* __restrict__ areas, int thr,
                                     T* __restrict__ out, int64_t n, int H,
                                     int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int hw = H * W;
  const int64_t b = i / hw;
  const int64_t base = b * hw;
  const bool in_rows =
      valid_h == nullptr || (int)(i - base) / W < valid_h[b];
  const T v = in_rows ? img[i] : T(0);
  const int lab = label_of(parent, i, base, hw);
  const bool cleaned = lab != hw && areas[base + lab] >= thr;
  T o = v;
  if (!cleaned && v == T(0) && in_rows) o = T(1);
  if (cleaned && v != T(0)) o = T(0);
  out[i] = o;
}

inline unsigned flat_blocks(int64_t n) {
  return (unsigned)((n + kFlatThreads - 1) / kFlatThreads);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The tile kernel, then the border and finalize kernels.
template <class Pred>
int label(Pred pred, const int* valid_h, int* parent, int* areas,
          int* scratch, int write_labels, int B, int H, int W,
          cudaStream_t s) {
  if ((int64_t)B * H * W == 0) return 0;
  const int tiles_x = ceil_div(W, kTileW), tiles_y = ceil_div(H, kTileH);
  const int64_t tiles = (int64_t)B * tiles_x * tiles_y;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  ccl_tile_kernel<Pred><<<(unsigned)tiles, kTileThreads, 0, s>>>(
      pred, valid_h, parent, areas, scratch, H, W, tiles_x, tiles_y);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t n = tiles * (kTileH + kTileW);
  ccl_border_kernel<<<flat_blocks(n), kFlatThreads, 0, s>>>(
      parent, H, W, tiles_x, tiles_y, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ccl_finalize_kernel<<<(unsigned)tiles, kFinalizeThreads, 0, s>>>(
      parent, areas, scratch, H, W, tiles_x, tiles_y, write_labels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry takes contiguous device buffers of B*H*W pixels, `parent`
// and `areas` as int32 [B, H*W], `valid_h` as int32 [B] or null (every
// row valid) and `scratch` of ccl_scratch_ints(B, H, W) int32;
// elem_bytes is 1 (uint8 / bool), 4 (int32) or 8 (int64).
// Each launches on `stream`, returns the first CUDA error (0 on success)
// and does not synchronise. The caller checks H*W + 1 < 2^31.

// The int32 elements of the roots scratch.
int64_t ccl_scratch_ints(int B, int H, int W) {
  return (int64_t)B * ceil_div(H, kTileH) * ceil_div(W, kTileW) *
         kRootStride;
}

// Labels of fg = (row < valid_h) && ((src != 0) != invert) into `parent`
// (pixel -> tile root -> global root), the component areas into `areas`
// at the global roots when it is not null; with write_labels the final
// labels in `parent` (label_components). 3 launches.
int ccl_label_launch(const void* src, int elem_bytes, int invert,
                     const int* valid_h, int* parent, int* areas,
                     int* scratch, int write_labels, int B, int H, int W,
                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bool inv = invert != 0;
  switch (elem_bytes) {
    case 1:
      return label(MapPred<uint8_t>{(const uint8_t*)src, inv}, valid_h,
                   parent, areas, scratch, write_labels, B, H, W, s);
    case 4:
      return label(MapPred<int32_t>{(const int32_t*)src, inv}, valid_h,
                   parent, areas, scratch, write_labels, B, H, W, s);
    case 8:
      return label(MapPred<int64_t>{(const int64_t*)src, inv}, valid_h,
                   parent, areas, scratch, write_labels, B, H, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The objects step's labelling: fg = (row < valid_h) && the pixel is
// class 0 after the holes step (`prev`, `prev_areas` from
// ccl_label_launch, threshold thr). 3 launches.
int ccl_label_filled_launch(const int* prev, const int* prev_areas,
                            const int* valid_h, int thr, int* parent,
                            int* areas, int* scratch, int B, int H, int W,
                            void* stream) {
  return label(FilledPred{prev, prev_areas, thr, H * W}, valid_h, parent,
               areas, scratch, 0, B, H, W, (cudaStream_t)stream);
}

int ccl_area_launch(const int* parent, const int* areas, int* out, int B,
                    int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  ccl_area_kernel<<<flat_blocks(n), kFlatThreads, 0, (cudaStream_t)stream>>>(
      parent, areas, out, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_keep_launch(const int* parent, const int* areas, int thr, int invert,
                    uint8_t* out, int B, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  ccl_keep_kernel<<<flat_blocks(n), kFlatThreads, 0, (cudaStream_t)stream>>>(
      parent, areas, thr, invert, out, n, H, W);
  return (int)cudaGetLastError();
}

int ccl_writeback_launch(const void* img, int elem_bytes, const int* valid_h,
                         const int* parent, const int* areas, int thr,
                         void* out, int B, int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const unsigned g = flat_blocks(n);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1:
      ccl_writeback_kernel<uint8_t><<<g, kFlatThreads, 0, s>>>(
          (const uint8_t*)img, valid_h, parent, areas, thr, (uint8_t*)out, n,
          H, W);
      break;
    case 4:
      ccl_writeback_kernel<int32_t><<<g, kFlatThreads, 0, s>>>(
          (const int32_t*)img, valid_h, parent, areas, thr, (int32_t*)out, n,
          H, W);
      break;
    case 8:
      ccl_writeback_kernel<int64_t><<<g, kFlatThreads, 0, s>>>(
          (const int64_t*)img, valid_h, parent, areas, thr, (int64_t*)out, n,
          H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
