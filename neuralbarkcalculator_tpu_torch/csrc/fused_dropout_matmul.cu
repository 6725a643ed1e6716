// Fused dropout + 1x1 conv (the FCN head's classifier.3 + classifier.4),
// forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_dropout_matmul
// (neuralbarkcalculator_tpu/ops/pallas_kernels.py:125-237):
// fdm_forward_kernel replaces _fdm_fwd_kernel (:139); fdm_backward_kernel
// with fdm_backward_reduce_kernel replaces _fdm_bwd_kernel (:148) and the
// custom VJP's sums of the dw partials and of g (:207-237); both regenerate
// the mask of _fdm_mask (:128). On NCHW float32 activations h [B, C, P]
// (P = H*W):
//
//     forward:  y[b, k, p] = sum_c h[b, c, p] * m[b, c, p] * w[c, k] + bias[k]
//     backward: dh[b, c, p] = (sum_k g[b, k, p] * w[c, k]) * m[b, c, p]
//               dw[c, k]    = sum_{b, p} h[b, c, p] * m[b, c, p] * g[b, k, p]
//               db[k]       = sum_{b, p} g[b, k, p]
//
// with m in {0, scale}, scale = 1/keep. No mask is stored: both directions
// regenerate it. Element i = (b*C + c)*P + p (its linear index in h) draws
// its 32 random bits as word (offset + i) & 3 of Philox4x32-10 with counter
// (offset + i) >> 2 (64 bits, in the counter's first two words) and key =
// the 64-bit seed, and is kept iff bits < thresh (thresh = 2^32 keeps
// everything: rate 0 is the exact identity). The mask depends only on the
// seed and the element's position, not on the tiling, and the port's plain
// version (ops/fused_dropout_matmul.py) computes the same bits. The element
// offset, a multiple of 4, places h inside a larger tensor: a data-parallel
// rank whose rows start at row r of the global batch passes r * C * P, and
// draws exactly those rows of the global batch's mask. It adds one 64-bit
// constant to each lane's first counter and nothing to the step loops.
//
// Bounds at the training path's shapes (h [5, 512, 64, 64], K = 3), on an
// H100 SXM (3.35 TB/s, 132 SMs):
// - bytes: the forward reads h and writes y, 42.2 MB, 12.6 us; the
//   backward reads h and g and writes dh, dw and db, 84.1 MB, 25.1 us.
//   torch's own kernels reach 3.03-3.19 TB/s summing h (13.2-13.8 us) and
//   2.83-2.87 TB/s copying it (29.2-29.6 us) on an H100 80GB HBM3 at 700 W
//   (chip_smoke.py phase 2): what the card's memory gives in practice.
// - integer pipe (an estimate, not a bound): one Philox4x32-10 call per 4
//   elements, 2.62 M in each direction. A call is 10 rounds of two
//   32x32->64 multiplies and two 3-input XORs; the 10 round keys are
//   computed on the host and read as constants. A step of the forward's
//   loop (one call, its 4 keep tests, one float4, K x 4 FMAs) issues 60.75
//   integer instructions (19 IMAD.WIDE.U32, 22 LOP3), the backward's 85.75
//   (chip_smoke.py counts them in the SASS of each kernel's step loop, K =
//   3): 9.5 us forward and 13.4 us backward at an assumed 64 integer
//   operations per clock per SM and 1980 MHz, 12.5 and 16.7 us if
//   IMAD.WIDE issues at half that rate (not checked). So the forward's
//   integer work is of the size of its byte bound and the backward's about
//   half of it; the design overlaps them with the loads instead of adding
//   them.
// - float32: ~63 MFLOP a direction, < 1 us: no work for tensor cores.
//
// Design against those bounds:
// - A warp covers 8 pixel quads (32 consecutive pixels, 128 bytes of a
//   channel row) x 4 channels per step: lane = (quad q = lane % 8, channel
//   s = lane / 8), one float4 and one Philox call per lane and step. (A
//   step of 16 or 32 quads, 2 or 1 channels, with blocks of 8 or 16 warps,
//   read longer runs of each row but timed the forward 12 % and 37 %
//   slower: fewer, larger blocks hid the Philox chain worse.)
// - Loads run ahead of Philox: every warp streams its rows through its own
//   shared-memory ring of kStages = 4 slots filled by 16-byte cp.async, so
//   3 steps (1.5 KB of h a warp; 2.6 KB of h and g in the backward) are in
//   flight while the integer pipe computes the current step's words. At
//   ~4.9 blocks of 4 warps per SM (640 blocks on 132 SMs) that is ~29 KB
//   (forward) and ~52 KB (backward) in flight per SM, against 3.35 TB/s /
//   132 SMs x ~1 us of loaded latency ~ 25 KB needed. Rings of 6 and 8
//   slots timed the same or slower; h loaded into a ring of registers
//   instead timed the forward 10 % and the backward 13 % slower.
// - Few instructions a step: the step loop is unrolled by the ring's depth,
//   so slots are immediate offsets; addresses and the Philox counter run
//   on; the round keys are kernel constants. K (1..4) is a template
//   argument, so K = 3 does three columns of work.
// - Forward, one launch: one block of 4 warps per (image, 32-pixel tile),
//   over all C channels; w (C x K) is staged in shared memory once per
//   block, zero past C, so a ragged last channel step needs no branch. The
//   warps take the channel steps in turn (warp v: steps v, v + 4, ...),
//   each lane keeps its partial y in registers, the 4 channel lanes of a
//   quad are summed by two xor shuffles, the 4 warps' partials through
//   shared memory in warp order, then the bias is added and y leaves once,
//   as float4. A thread-block cluster with the sum in distributed shared
//   memory would do the same sum with more blocks; this needs no partial y
//   outside the SM and no second kernel.
// - Grid: 640 blocks in each direction at the training shapes, all
//   resident at once (kMinBlocks makes at least 5 an SM fit), 4 or 5 an
//   SM: the 5-block SMs carry 3 % more than the mean, and no block waits
//   for a second wave.
// - Backward: one block of 4 warps per (image, 16-channel group, 1024-pixel
//   segment); each thread keeps one channel and walks 32 pixel steps, so
//   its w row sits in registers and dw accumulates over 128 pixels per
//   lane before one xor-shuffle sum over the 8 quad lanes. dh leaves as
//   float4, exactly 0 where dropped (only its sign may differ). The blocks
//   of channel group 0 also sum the g quads they hold into db. Each block
//   writes its dw rows and (group 0) its db row to [B * segments]
//   partials, and fdm_backward_reduce_kernel, launched by the same entry,
//   sums them (20 rows at the training shapes, ~1.7 us): no torch kernel
//   beside the library, no atomics.
// - Determinism: every sum runs in a fixed order. y: each lane's channels
//   in step order, then lane s = 0 + 1, 2 + 3, those two (xor 8, 16), then
//   the warps in index order, then the bias. dw: each lane's 128 pixels in
//   step order, the 8 quad lanes by xor 1, 2, 4, then the partial rows in
//   (image, segment) order. db: each lane's quads, the same shuffles, the
//   rows in order. Equal inputs give equal bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 4;                    // most classes the kernels take
constexpr int kWarps = 4;                   // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kQuads = 8;                   // pixel quads a warp step covers
constexpr int kStepPix = 4 * kQuads;        // 32 pixels
constexpr int kStepC = 32 / kQuads;         // 4 channels a warp step covers
constexpr int kStages = 4;                  // cp.async ring slots per warp
constexpr int kSegSteps = 32;               // backward: steps per segment
constexpr int kSegPix = kSegSteps * kStepPix;  // 1024 pixels
constexpr int kGroupC = kWarps * kStepC;    // backward: 16 channels a block
constexpr int kReduceThreads = 256;
constexpr int kMinBlocks = 5;               // per SM, so <= 96 registers
constexpr uint32_t kSlotBytes = 32 * sizeof(float4);  // a warp's h slot
constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox4x32
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;

// The mask's parameters: the 10 round keys of Philox4x32-10 under the
// 64-bit seed, the counter of element 0 (offset / 4), and the keep rule
// (bits < thresh as a 32-bit compare, with thresh = 2^32, rate 0, as "keep
// all").
struct Mask {
  uint32_t k0[10], k1[10];
  uint64_t ctr0;
  uint32_t thresh;
  int all;
  float scale;
};

Mask make_mask(uint64_t seed, uint64_t offset, uint64_t thresh,
               float scale) {
  Mask m;
  m.ctr0 = offset >> 2;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  for (int r = 0; r < 10; ++r) {
    m.k0[r] = k0;
    m.k1[r] = k1;
    k0 += kW0;
    k1 += kW1;
  }
  m.thresh = (uint32_t)(thresh > 0xFFFFFFFFull ? 0xFFFFFFFFull : thresh);
  m.all = thresh > 0xFFFFFFFFull;
  m.scale = scale;
  return m;
}

// Philox4x32-10 (Salmon et al. 2011, the Random123 constants) at a 64-bit
// counter (counter words 2 and 3 zero).
__device__ __forceinline__ uint4 philox4x32_10(uint64_t counter,
                                               const Mask& m) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ m.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ m.k1[r];
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ float keep_value(uint32_t bits, const Mask& m) {
  return (m.all || bits < m.thresh) ? m.scale : 0.f;
}

// The mask values of the 4 elements whose linear indices are 4 * counter
// and the 3 after it.
__device__ __forceinline__ float4 mask4(uint64_t counter, const Mask& m) {
  const uint4 r = philox4x32_10(counter, m);
  return make_float4(keep_value(r.x, m), keep_value(r.y, m),
                     keep_value(r.z, m), keep_value(r.w, m));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kStages - 1 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// grid (B * tiles); dynamic shared memory: steps * kStepC float4 (w);
// y [B, K, P]
template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fdm_forward_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int C, int P, int tiles, int wsc, int wsk,
                   const __grid_constant__ Mask mask) {
  extern __shared__ float4 w_s[];  // [c]: w[c, :K], zero past C and K
  __shared__ float4 ring[kWarps][kStages][32];
  __shared__ float4 red[kWarps][K][kQuads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % kQuads, s = lane / kQuads;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * kStepPix;
  const int p = p0 + 4 * q;
  const int steps = (C + kStepC - 1) / kStepC;
  // this warp's steps: warp, warp + kWarps, ...; step i of this lane is
  // channel c0 + i * kDc
  const int mine = steps > warp ? (steps - warp + kWarps - 1) / kWarps : 0;
  constexpr int kDc = kWarps * kStepC;
  const int c0 = warp * kStepC + s;
  // the steps whose element lies inside h (none off the image's pixels)
  const int n_ok = (p < P && c0 < C) ? (C - c0 + kDc - 1) / kDc : 0;
  const uint64_t e0 = ((uint64_t)b * C + c0) * P + p;
  const uint64_t de = (uint64_t)kDc * P;
  const float* src = h + (n_ok ? e0 : 0);
  const uint32_t ring0 = smem_addr(&ring[warp][0][lane]);
  int issued = 0;

  auto issue = [&](int slot) {
    const bool ok = issued < n_ok;
    cp_async16(ring0 + slot * kSlotBytes, ok ? src : h, ok);
    src += ok ? de : 0;
    ++issued;
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  for (int c = threadIdx.x; c < steps * kStepC; c += kThreads) {
    float v[kMaxK] = {0.f, 0.f, 0.f, 0.f};
    if (c < C) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = __ldg(w + c * wsc + k * wsk);
    }
    w_s[c] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  float acc[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
    acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  uint64_t ctr = mask.ctr0 + (e0 >> 2);  // counter of step i: += dctr
  const uint64_t dctr = de >> 2;
  const float4* wrow = w_s + c0;    // w of step i: += kDc

  for (int i0 = 0; i0 < mine; i0 += kStages) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (i0 + j < mine) {
        // each lane reads only the slot it filled itself, and its last
        // read of the slot it refills here has returned
        issue((j + kStages - 1) % kStages);
        cp_async_wait_ring();
        const float4 hm = mul4(ring[warp][j][lane], mask4(ctr, mask));
        const float4 wv = *wrow;
        const float wk[kMaxK] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[k][0] = fmaf(hm.x, wk[k], acc[k][0]);
          acc[k][1] = fmaf(hm.y, wk[k], acc[k][1]);
          acc[k][2] = fmaf(hm.z, wk[k], acc[k][2]);
          acc[k][3] = fmaf(hm.w, wk[k], acc[k][3]);
        }
        ctr += dctr;
        wrow += kDc;
      }
    }
  }

  // the 4 channel lanes of each quad (lanes q, q + 8, q + 16, q + 24)
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], 8);
      acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], 16);
    }
  if (s == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      red[warp][k][q] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
  __syncthreads();
  if (threadIdx.x < K * kQuads) {
    const int k = threadIdx.x / kQuads, qq = threadIdx.x % kQuads;
    const int pp = p0 + 4 * qq;
    if (pp < P) {
      float4 v = red[0][k][qq];
#pragma unroll
      for (int r = 1; r < kWarps; ++r) {
        const float4 u = red[r][k][qq];
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
      const float bk = bias[k];
      *reinterpret_cast<float4*>(y + ((uint64_t)b * K + k) * P + pp) =
          make_float4(v.x + bk, v.y + bk, v.z + bk, v.w + bk);
    }
  }
}

// grid (channel groups, segments, B); dw_part [B * segments, C, K],
// db_part [B * segments, K]
template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fdm_backward_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ g, float* __restrict__ dh,
                    float* __restrict__ dw_part, float* __restrict__ db_part,
                    int C, int P, int wsc, int wsk,
                    const __grid_constant__ Mask mask) {
  __shared__ float4 h_ring[kWarps][kStages][32];
  __shared__ float4 g_ring[kWarps][kStages][K][kQuads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % kQuads, s = lane / kQuads;
  const int seg = blockIdx.y, b = blockIdx.z;
  const int c = blockIdx.x * kGroupC + warp * kStepC + s;
  const bool c_ok = c < C;
  // this lane's pixel at step 0; step i adds i * kStepPix
  const int p_first = seg * kSegPix + 4 * q;
  const int steps = min(kSegSteps, (P - seg * kSegPix + kStepPix - 1) /
                                       kStepPix);
  // the steps whose pixel lies inside the image, and whose h element too
  const int n_p = P > p_first
                      ? min(steps, (P - p_first + kStepPix - 1) / kStepPix)
                      : 0;
  const int n_h = c_ok ? n_p : 0;
  const uint64_t e0 = ((uint64_t)b * C + (c_ok ? c : 0)) * P + p_first;
  // lanes s < K bring g's row s of each step's 32 pixels
  const bool g_lane = s < K;
  const float* g_src = g + ((uint64_t)b * K + (g_lane ? s : 0)) * P +
                       (n_p ? p_first : 0);
  const float* h_src = h + (n_h ? e0 : 0);
  float* dh_dst = dh + e0;
  const uint32_t h_ring0 = smem_addr(&h_ring[warp][0][lane]);
  const uint32_t g_ring0 = smem_addr(&g_ring[warp][0][g_lane ? s : 0][q]);
  int issued = 0;

  auto issue = [&](int slot) {
    const bool h_ok = issued < n_h, g_ok = issued < n_p;
    cp_async16(h_ring0 + slot * kSlotBytes, h_ok ? h_src : h, h_ok);
    if (g_lane)
      cp_async16(g_ring0 + slot * (uint32_t)(K * kQuads * sizeof(float4)),
                 g_ok ? g_src : g, g_ok);
    h_src += h_ok ? kStepPix : 0;
    g_src += g_ok ? kStepPix : 0;
    ++issued;
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  float wc[K], dw_acc[K], db_acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wc[k] = c_ok ? __ldg(w + c * wsc + k * wsk) : 0.f;
    dw_acc[k] = db_acc[k] = 0.f;
  }
  const bool do_db = blockIdx.x == 0 && warp == 0;
  // Philox counter of step i: += kStepPix / 4
  uint64_t ctr = mask.ctr0 + (e0 >> 2);

  for (int i0 = 0; i0 < steps; i0 += kStages) {
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      const int i = i0 + j;
      if (i < steps) {
        __syncwarp();  // every lane is done with the slot the copy refills
        issue((j + kStages - 1) % kStages);
        cp_async_wait_ring();
        __syncwarp();  // g's slot was filled by other lanes
        float4 gv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) gv[k] = g_ring[warp][j][k][q];
        if (do_db) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            db_acc[k] += (gv[k].x + gv[k].y) + (gv[k].z + gv[k].w);
        }
        // off the image h and g are zero-filled, so hm and the dw terms
        // are 0 there; dh is stored only inside
        const float4 m = mask4(ctr, mask);
        const float4 hm = mul4(h_ring[warp][j][lane], m);
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          d.x = fmaf(gv[k].x, wc[k], d.x);
          d.y = fmaf(gv[k].y, wc[k], d.y);
          d.z = fmaf(gv[k].z, wc[k], d.z);
          d.w = fmaf(gv[k].w, wc[k], d.w);
        }
        if (i < n_h)
          *reinterpret_cast<float4*>(dh_dst + i * kStepPix) = mul4(d, m);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          dw_acc[k] = fmaf(hm.x, gv[k].x, dw_acc[k]);
          dw_acc[k] = fmaf(hm.y, gv[k].y, dw_acc[k]);
          dw_acc[k] = fmaf(hm.z, gv[k].z, dw_acc[k]);
          dw_acc[k] = fmaf(hm.w, gv[k].w, dw_acc[k]);
        }
        ctr += kStepPix / 4;
      }
    }
  }

  // the 8 quad lanes of each channel (lanes 8s .. 8s + 7)
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 1; o < kQuads; o <<= 1) {
      dw_acc[k] += __shfl_xor_sync(0xffffffffu, dw_acc[k], o);
      db_acc[k] += __shfl_xor_sync(0xffffffffu, db_acc[k], o);
    }
  const uint64_t row = (uint64_t)b * gridDim.y + seg;
  if (q == 0 && c_ok) {
#pragma unroll
    for (int k = 0; k < K; ++k) dw_part[(row * C + c) * K + k] = dw_acc[k];
  }
  if (do_db && lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) db_part[row * K + k] = db_acc[k];
  }
}

// dw[t] = sum_r dw_part[r, t] for t < C*K, db[k] = sum_r db_part[r, k],
// r in order.
__global__ void fdm_backward_reduce_kernel(const float* __restrict__ dw_part,
                                           const float* __restrict__ db_part,
                                           float* __restrict__ dw,
                                           float* __restrict__ db, int rows,
                                           int CK, int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < CK) {
    float v = 0.f;
    for (int r = 0; r < rows; ++r) v += dw_part[(uint64_t)r * CK + t];
    dw[t] = v;
  } else if (t < CK + K) {
    float v = 0.f;
    for (int r = 0; r < rows; ++r) v += db_part[r * K + (t - CK)];
    db[t - CK] = v;
  }
}

int segments(int P) { return (P + kSegPix - 1) / kSegPix; }

template <int K>
int launch_forward(const float* h, const float* w, const float* bias,
                   float* y, int B, int C, int P, int wsc, int wsk,
                   const Mask& mask, cudaStream_t s) {
  const int tiles = (P + kStepPix - 1) / kStepPix;
  const int smem = (C + kStepC - 1) / kStepC * kStepC * (int)sizeof(float4);
  // above the default 48 KB in all (C > ~2000), ask for more
  if (smem > 32 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fdm_forward_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  fdm_forward_kernel<K><<<(unsigned)B * tiles, kThreads, smem, s>>>(
      h, w, bias, y, C, P, tiles, wsc, wsk, mask);
  return (int)cudaGetLastError();
}

template <int K>
int launch_backward(const float* h, const float* w, const float* g,
                    float* dh, float* dw_part, float* db_part, int B, int C,
                    int P, int wsc, int wsk, const Mask& mask,
                    cudaStream_t s) {
  const dim3 grid((C + kGroupC - 1) / kGroupC, segments(P), B);
  fdm_backward_kernel<K><<<grid, kThreads, 0, s>>>(
      h, w, g, dh, dw_part, db_part, C, P, wsc, wsk, mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the backward's dw and db partials: B * (1024-pixel segments).
int fdm_partial_rows(int B, int P) { return B * segments(P); }
int fdm_max_classes() { return kMaxK; }

// h [B, C, P] contiguous and 16-byte aligned, P % 4 == 0; w [C, K] with
// element strides (wsc, wsk), so a transposed view needs no copy; bias [K]
// contiguous; float32; 1 <= K <= kMaxK; y [B, K, P] out; offset (the mask's
// element offset) a multiple of 4. Launches on `stream`; returns
// cudaGetLastError() (0 on success); no synchronise.
int fdm_forward_launch(const float* h, const float* w, const float* bias,
                       float* y, int B, int C, int P, int K, int wsc, int wsk,
                       uint64_t seed, uint64_t offset, uint64_t thresh,
                       float scale, void* stream) {
  if (offset & 3) return (int)cudaErrorInvalidValue;
  const Mask mask = make_mask(seed, offset, thresh, scale);
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 1: return launch_forward<1>(h, w, bias, y, B, C, P, wsc, wsk,
                                       mask, s);
    case 2: return launch_forward<2>(h, w, bias, y, B, C, P, wsc, wsk,
                                       mask, s);
    case 3: return launch_forward<3>(h, w, bias, y, B, C, P, wsc, wsk,
                                       mask, s);
    case 4: return launch_forward<4>(h, w, bias, y, B, C, P, wsc, wsk,
                                       mask, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// h, w as above, g [B, K, P] 16-byte aligned; dh [B, C, P], dw [C, K] and
// db [K] out; dw_part [rows, C, K] and db_part [rows, K] scratch, rows =
// fdm_partial_rows(B, P). Two kernels on `stream`: the backward, then the
// in-order sum of its partials. Same return contract as the forward.
int fdm_backward_launch(const float* h, const float* w, const float* g,
                        float* dh, float* dw_part, float* db_part, float* dw,
                        float* db, int B, int C, int P, int K, int wsc,
                        int wsk, uint64_t seed, uint64_t offset,
                        uint64_t thresh, float scale, void* stream) {
  if (offset & 3) return (int)cudaErrorInvalidValue;
  const Mask mask = make_mask(seed, offset, thresh, scale);
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (K) {
    case 1: rc = launch_backward<1>(h, w, g, dh, dw_part, db_part, B, C, P,
                                    wsc, wsk, mask, s); break;
    case 2: rc = launch_backward<2>(h, w, g, dh, dw_part, db_part, B, C, P,
                                    wsc, wsk, mask, s); break;
    case 3: rc = launch_backward<3>(h, w, g, dh, dw_part, db_part, B, C, P,
                                    wsc, wsk, mask, s); break;
    case 4: rc = launch_backward<4>(h, w, g, dh, dw_part, db_part, B, C, P,
                                    wsc, wsk, mask, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  const int n = C * K + K;
  fdm_backward_reduce_kernel<<<(n + kReduceThreads - 1) / kReduceThreads,
                               kReduceThreads, 0, s>>>(
      dw_part, db_part, dw, db, fdm_partial_rows(B, P), C * K, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
