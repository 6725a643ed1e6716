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
// Bound at the main-path shapes (OH = OW = 1024, F = Wf = 128): per image
// 2*OH*F*Wf*3 + 2*OH*Wf*OW*3 = 0.91 GFLOP of dense float32 against about
// 1.7 MB of traffic (feat 192 KB, row_ops 512 KB, the uint8 map 1 MB; colT
// is shared by the batch). At 67 TFLOP/s float32 (CUDA cores) and
// 3.35 TB/s that is 13.5 us of arithmetic against 0.5 us of memory, so the
// kernel is bound by float32 operations.
//
// Design against that bound:
// - One block owns one (image, TILE_H-row tile) and walks the whole output
//   width, so the first product tmp = rows_tile @ feat_c (TILE_H x Wf, all
//   three planes) is computed once per row tile and kept in shared memory
//   (3 * 32 * 128 * 4 B = 48 KB at Wf = 128), instead of once per output tile.
// - The second product streams colT through shared memory in KC-row chunks;
//   each thread holds a 4-row x 4-column register tile for all three planes
//   (48 accumulators) and reads tmp as float4 broadcasts, so the inner loop
//   issues 7 shared loads per 48 FMAs and the FMA pipes, not shared memory,
//   set the pace.
// - Plain fp32 FMAs on CUDA cores: no TF32, matching Precision.HIGHEST.
// The 4-tap band structure of the bicubic operators (which would cut the
// arithmetic ~30x) is not exploited here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 32;   // output rows per block
constexpr int kTileW = 128;  // output columns per pass over colT
constexpr int kChunk = 32;   // colT rows staged per step (multiple of 4)

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

__global__ void __launch_bounds__(kThreads, 2)
upsample_argmax_kernel(const float* __restrict__ feat,
                       const float* __restrict__ row_ops,
                       const float* __restrict__ colt,
                       uint8_t* __restrict__ out,
                       int OH, int F, int Wf, int OW) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int wfp = round_up4(Wf);
  float* tmp = smem;                           // [3][kTileH][wfp]
  float* stage = smem + 3 * kTileH * wfp;      // rows tile or colT chunk

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kTileH;
  const int rows_here = min(kTileH, OH - r0);

  // ---- rows tile [kTileH][F] (rows past OH read as zero)
  const float* rows_g = row_ops + ((size_t)b * OH + r0) * F;
  for (int i = tid; i < kTileH * F; i += kThreads) {
    const int r = i / F;
    stage[i] = r < rows_here ? rows_g[i] : 0.f;
  }
  // zero the padding columns of tmp once (read by the float4 loads)
  for (int i = tid; i < 3 * kTileH * (wfp - Wf); i += kThreads) {
    const int row = i / (wfp - Wf);
    tmp[row * wfp + Wf + i % (wfp - Wf)] = 0.f;
  }
  __syncthreads();

  // ---- first product: tmp[c][r][w] = sum_f rows[r][f] * feat[b][f][w][c]
  {
    const int n1 = Wf * 3;  // feat[b] is [F][Wf*3] row-major
    const float* fb = feat + (size_t)b * F * n1;
    const int tx = tid & 63;   // column within a 64-wide chunk
    const int ty = tid >> 6;   // rows ty*8 .. ty*8+7
    for (int j0 = 0; j0 < n1; j0 += 64) {
      const int j = j0 + tx;
      if (j < n1) {
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.f;
        for (int f = 0; f < F; ++f) {
          const float v = __ldg(fb + (size_t)f * n1 + j);
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[i] = fmaf(stage[(ty * 8 + i) * F + f], v, acc[i]);
        }
        const int c = j % 3;
        const int w = j / 3;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          tmp[(c * kTileH + ty * 8 + i) * wfp + w] = acc[i];
      }
    }
  }

  // ---- second product + argmax, one kTileW column tile at a time
  const int tx = tid & 31;  // columns tx + 32*q, q < 4
  const int ty = tid >> 5;  // rows ty*4 .. ty*4+3
  uint8_t* ob = out + ((size_t)b * OH + r0) * OW;
  for (int c0 = 0; c0 < OW; c0 += kTileW) {
    float acc[3][4][4];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][i][q] = 0.f;

    for (int k0 = 0; k0 < Wf; k0 += kChunk) {
      __syncthreads();  // tmp complete / previous chunk consumed
      for (int i = tid; i < kChunk * kTileW; i += kThreads) {
        const int k = k0 + i / kTileW;
        const int col = c0 + i % kTileW;
        stage[i] = (k < Wf && col < OW) ? __ldg(colt + (size_t)k * OW + col)
                                        : 0.f;
      }
      __syncthreads();
      const int kn = min(kChunk, Wf - k0);
      for (int kk = 0; kk < kn; kk += 4) {
        float4 t[3][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            t[p][i] = *reinterpret_cast<const float4*>(
                &tmp[(p * kTileH + ty * 4 + i) * wfp + k0 + kk]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float cv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cv[q] = stage[(kk + u) * kTileW + tx + 32 * q];
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float a = u == 0 ? t[p][i].x
                            : u == 1 ? t[p][i].y
                            : u == 2 ? t[p][i].z : t[p][i].w;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[p][i][q] = fmaf(a, cv[q], acc[p][i][q]);
            }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + tx + 32 * q;
        if (r < rows_here && col < OW) {
          const float a0 = acc[0][i][q], a1 = acc[1][i][q], a2 = acc[2][i][q];
          int idx = a1 > a0 ? 1 : 0;
          const float best = fmaxf(a0, a1);
          idx = a2 > best ? 2 : idx;
          ob[(size_t)r * OW + col] = (uint8_t)idx;
        }
      }
    }
  }
}

size_t smem_bytes(int F, int Wf) {
  const size_t tmp = 3ull * kTileH * round_up4(Wf);
  const size_t rows = (size_t)kTileH * F;
  const size_t chunk = (size_t)kChunk * kTileW;
  return (tmp + (rows > chunk ? rows : chunk)) * sizeof(float);
}

}  // namespace

extern "C" {

// Shared memory one block needs for these sizes (the wrapper checks it
// against the card's per-block limit before launching).
size_t upsample_argmax_smem_bytes(int F, int Wf) { return smem_bytes(F, Wf); }

// feat [B, F, Wf, 3] f32, row_ops [B, OH, F] f32, colt [Wf, OW] f32, all
// contiguous on the device; out [B, OH, OW] uint8. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronise.
int upsample_argmax_launch(const float* feat, const float* row_ops,
                           const float* colt, uint8_t* out, int B, int OH,
                           int F, int Wf, int OW, void* stream) {
  const size_t smem = smem_bytes(F, Wf);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((OH + kTileH - 1) / kTileH, B);
  upsample_argmax_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      feat, row_ops, colt, out, OH, F, Wf, OW);
  return (int)cudaGetLastError();
}

}  // extern "C"
