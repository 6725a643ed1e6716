// Fused dropout + 1x1 conv (the FCN head's classifier.3 + classifier.4),
// forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_dropout_matmul
// (neuralbarkcalculator_tpu/ops/pallas_kernels.py:125-237: forward
// _fdm_fwd_kernel :139, backward _fdm_bwd_kernel :148, mask _fdm_mask :128,
// custom VJP :207-237). On NCHW float32 activations h [B, C, P] (P = H*W):
//
//     forward:  y[b, k, p] = sum_c h[b, c, p] * m[b, c, p] * w[c, k] + bias[k]
//     backward: dh[b, c, p] = (sum_k g[b, k, p] * w[c, k]) * m[b, c, p]
//               dw[c, k]    = sum_{b, p} h[b, c, p] * m[b, c, p] * g[b, k, p]
//                             (per-block partials here, summed by the caller)
//
// with m in {0, scale}, scale = 1/keep. No mask is stored: both directions
// regenerate it. Element i = (b*C + c)*P + p (its linear index in h) draws
// its 32 random bits as word i & 3 of Philox4x32-10 with counter i >> 2
// (64 bits, in the counter's first two words) and key = the 64-bit seed,
// and is kept iff bits < thresh (a 64-bit compare, so thresh = 2^32 keeps
// everything: rate 0 is the exact identity). The mask depends only on the
// seed and the element's position, not on the tiling, and the port's plain
// version (ops/fused_dropout_matmul.py) computes the same bits.
//
// Bound at the training path's shapes (h [5, 512, 64, 64], K = 3): the
// forward reads h (41.94 MB) and writes y, ~42.2 MB; the backward reads h
// and g and writes dh and the dw partials, ~84.3 MB; each does ~63 MFLOP.
// At 3.35 TB/s that is 12.6 us and 25.2 us: bound by memory.
//
// Design against that bound:
// - Threads run over pixels, each owning 4 consecutive pixels of one image,
//   and loop over a 32-channel chunk: every load and store of h and dh is
//   one float4 per thread, neighbouring threads on neighbouring addresses,
//   and one Philox call gives the 4 pixels' bits.
// - The channels are split over blocks (grid y), so that a few images still
//   put ~640 blocks in flight. The forward writes one partial y per channel
//   chunk (~4 MB at these shapes), and a second small kernel sums them in
//   chunk order and adds the bias: deterministic, no atomics.
// - The backward needs no cross-block sum for dh. For dw, each warp sums its
//   pixels with shuffles per channel, and the block writes one [chunk, K]
//   partial; the caller sums the partials (as the JAX VJP does, :232).
// - Plain float32 FMAs on CUDA cores: with K = 3 this is a masked dot of
//   each pixel's channels against three columns, no work for tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // threads per block
constexpr int kPix = 4;                   // consecutive pixels per thread
constexpr int kTilePix = kThreads * kPix; // pixels per block
constexpr int kChunkC = 32;               // channels per block
constexpr int kMaxK = 4;                  // most classes the kernels take
constexpr int kWarps = kThreads / 32;
constexpr int kReduceThreads = 256;

struct Bits4 {
  uint32_t x, y, z, w;
};

// Philox4x32-10 (Salmon et al. 2011, the Random123 constants).
__device__ __forceinline__ Bits4 philox4x32_10(uint64_t counter,
                                               uint64_t seed) {
  uint32_t c0 = (uint32_t)counter, c1 = (uint32_t)(counter >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return {c0, c1, c2, c3};
}

// The mask values of the 4 elements whose linear indices start at i
// (i % 4 == 0).
__device__ __forceinline__ float4 mask4(size_t i, uint64_t seed,
                                        uint64_t thresh, float scale) {
  const Bits4 r = philox4x32_10((uint64_t)(i >> 2), seed);
  return make_float4((uint64_t)r.x < thresh ? scale : 0.f,
                     (uint64_t)r.y < thresh ? scale : 0.f,
                     (uint64_t)r.z < thresh ? scale : 0.f,
                     (uint64_t)r.w < thresh ? scale : 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (pixel tiles, channel chunks, B); part [S, B, K, P]
__global__ void __launch_bounds__(kThreads)
fdm_forward_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   float* __restrict__ part, int B, int C, int P, int K,
                   uint64_t seed, uint64_t thresh, float scale) {
  __shared__ float w_s[kChunkC][kMaxK];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kChunkC;
  const int cn = min(kChunkC, C - c0);
  for (int i = threadIdx.x; i < kChunkC * kMaxK; i += kThreads) {
    const int c = i / kMaxK, k = i % kMaxK;
    w_s[c][k] = (c < cn && k < K) ? w[(size_t)(c0 + c) * K + k] : 0.f;
  }
  __syncthreads();
  const int p0 = blockIdx.x * kTilePix + threadIdx.x * kPix;
  if (p0 >= P) return;

  float acc[kMaxK][kPix];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
#pragma unroll
    for (int j = 0; j < kPix; ++j) acc[k][j] = 0.f;

#pragma unroll 4
  for (int c = 0; c < cn; ++c) {
    const size_t i = ((size_t)b * C + c0 + c) * P + p0;
    const float4 hv = *reinterpret_cast<const float4*>(h + i);
    const float4 m = mask4(i, seed, thresh, scale);
    const float hm[kPix] = {hv.x * m.x, hv.y * m.y, hv.z * m.z, hv.w * m.w};
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        acc[k][j] = fmaf(hm[j], w_s[c][k], acc[k][j]);
  }
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      float* out = part + (((size_t)blockIdx.y * B + b) * K + k) * P + p0;
      *reinterpret_cast<float4*>(out) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    }
  }
}

// y[b, k, p] = bias[k] + sum_s part[s, b, k, p], s in order.
__global__ void fdm_forward_reduce_kernel(const float* __restrict__ part,
                                          const float* __restrict__ bias,
                                          float* __restrict__ y, int S,
                                          int B, int K, int P) {
  const size_t n = (size_t)B * K * P;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float s = 0.f;
  for (int q = 0; q < S; ++q) s += part[(size_t)q * n + t];
  const int k = (int)((t / P) % K);
  y[t] = s + bias[k];
}

// grid (pixel tiles, channel chunks, B); dw_part [B * tiles, C, K]
__global__ void __launch_bounds__(kThreads)
fdm_backward_kernel(const float* __restrict__ h, const float* __restrict__ w,
                    const float* __restrict__ g, float* __restrict__ dh,
                    float* __restrict__ dw_part, int B, int C, int P, int K,
                    uint64_t seed, uint64_t thresh, float scale) {
  __shared__ float w_s[kChunkC][kMaxK];
  __shared__ float red[kWarps][kChunkC][kMaxK];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kChunkC;
  const int cn = min(kChunkC, C - c0);
  for (int i = threadIdx.x; i < kChunkC * kMaxK; i += kThreads) {
    const int c = i / kMaxK, k = i % kMaxK;
    w_s[c][k] = (c < cn && k < K) ? w[(size_t)(c0 + c) * K + k] : 0.f;
  }
  __syncthreads();
  const int p0 = blockIdx.x * kTilePix + threadIdx.x * kPix;
  // threads past P stay for the warp shuffles, contributing zeros
  const bool active = p0 < P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float gv[kMaxK][kPix];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active && k < K)
      v = *reinterpret_cast<const float4*>(g + ((size_t)b * K + k) * P + p0);
    gv[k][0] = v.x;
    gv[k][1] = v.y;
    gv[k][2] = v.z;
    gv[k][3] = v.w;
  }

#pragma unroll 2
  for (int c = 0; c < cn; ++c) {
    float part[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) part[k] = 0.f;
    if (active) {
      const size_t i = ((size_t)b * C + c0 + c) * P + p0;
      const float4 hv = *reinterpret_cast<const float4*>(h + i);
      const float4 m = mask4(i, seed, thresh, scale);
      const float mj[kPix] = {m.x, m.y, m.z, m.w};
      const float hm[kPix] = {hv.x * m.x, hv.y * m.y, hv.z * m.z,
                              hv.w * m.w};
      float d[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) s = fmaf(gv[k][j], w_s[c][k], s);
        d[j] = s * mj[j];
      }
      *reinterpret_cast<float4*>(dh + i) = make_float4(d[0], d[1], d[2], d[3]);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
#pragma unroll
        for (int j = 0; j < kPix; ++j) part[k] = fmaf(hm[j], gv[k][j], part[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      const float v = warp_sum(part[k]);
      if (lane == 0) red[warp][c][k] = v;
    }
  }
  __syncthreads();
  const size_t row = (size_t)b * gridDim.x + blockIdx.x;
  for (int i = threadIdx.x; i < cn * K; i += kThreads) {
    const int c = i / K, k = i % K;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += red[q][c][k];
    dw_part[(row * C + c0 + c) * K + k] = s;
  }
}

dim3 main_grid(int B, int C, int P) {
  return dim3((P + kTilePix - 1) / kTilePix, (C + kChunkC - 1) / kChunkC, B);
}

}  // namespace

extern "C" {

// Channel chunks (S, the forward's partial count) and pixel tiles per image
// (the backward's dw partials are [B * tiles, C, K]).
int fdm_channel_chunks(int C) { return (C + kChunkC - 1) / kChunkC; }
int fdm_pixel_tiles(int P) { return (P + kTilePix - 1) / kTilePix; }
int fdm_max_classes() { return kMaxK; }

// h [B, C, P], w [C, K], bias [K] float32, contiguous, 16-byte aligned,
// P % 4 == 0, K <= kMaxK; part [S, B, K, P] scratch, y [B, K, P]. Launches
// on `stream`; returns cudaGetLastError() (0 on success); no synchronise.
int fdm_forward_launch(const float* h, const float* w, const float* bias,
                       float* part, float* y, int B, int C, int P, int K,
                       uint64_t seed, uint64_t thresh, float scale,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  fdm_forward_kernel<<<main_grid(B, C, P), kThreads, 0, s>>>(
      h, w, part, B, C, P, K, seed, thresh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * K * P;
  const unsigned blocks = (unsigned)((n + kReduceThreads - 1) / kReduceThreads);
  fdm_forward_reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      part, bias, y, fdm_channel_chunks(C), B, K, P);
  return (int)cudaGetLastError();
}

// h [B, C, P], w [C, K], g [B, K, P] as above; dh [B, C, P] and dw_part
// [B * tiles, C, K] out. Same launch contract as the forward.
int fdm_backward_launch(const float* h, const float* w, const float* g,
                        float* dh, float* dw_part, int B, int C, int P, int K,
                        uint64_t seed, uint64_t thresh, float scale,
                        void* stream) {
  fdm_backward_kernel<<<main_grid(B, C, P), kThreads, 0,
                        (cudaStream_t)stream>>>(
      h, w, g, dh, dw_part, B, C, P, K, seed, thresh, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
