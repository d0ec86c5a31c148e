// Fused ProD predictor head for Hopper (sm_90a).
//
// Replaces prod_head_pallas (src/repro/kernels/prod_head.py:61): relu(phi W1 +
// b1) W2 + b2 -> softmax over K bins -> CDF -> for each CDF level q the first
// bin with cdf >= q (clamped to K-1) and in-bin linear interpolation with
// cdf_prev = cdf_k - p_k.
//
// What bounds it on the H100: reading W1 (d x hidden fp32, 8.4 MB at d=4096,
// hidden=512) from device memory; everything else is a few KB. The TPU kernel
// keeps all of W1 resident in VMEM; 8 MB does not fit in a block's 227 KB of
// shared memory, so here W1 is streamed:
//
//  * kernel 1 (prod_head_hidden), grid (row tiles of 16, hidden/32 column
//    chunks): each block owns 16 rows of phi and 32 hidden units. phi is
//    staged through shared memory in d-tiles of 256; each of the 8 warps walks
//    32 rows of the W1 tile with one lane per hidden unit (one coalesced
//    128-byte load per W1 row), keeping 16 fp32 accumulators per lane, each
//    fed by a per-tile partial sum. The warps' partial sums meet in shared
//    memory, relu(+b1) gives the block's 32 hidden activations for its 16
//    rows, and the block writes their contribution to the K logits (h_chunk
//    W2[chunk, :]) to a small fp32 scratch (B, hidden/32, K). Splitting hidden across blocks is what spreads
//    the W1 read over many SMs at the serving batch (B=8 gives 16 blocks).
//  * kernel 2 (prod_head_epilogue), one warp per row: sums the partial logits,
//    + b2, softmax, sequential cumsum, then the crossing and interpolation for
//    every level. K <= 128 (64 on the main path), Q <= 32 per lane pass.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kRows = 16;            // phi rows per block
constexpr int kCols = 32;            // hidden units per block, one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileD = kWarps * 32;  // each warp takes 32 consecutive d
constexpr int kMaxK = 128;
constexpr int kEpiWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
prod_head_hidden(const T* __restrict__ phi, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 float* __restrict__ partial, int B, int d, int hidden, int K) {
  __shared__ float phis[kRows][kTileD];
  __shared__ float red[kWarps][kRows][kCols];
  __shared__ float hs[kRows][kCols + 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * kCols;
  const int n_chunks = gridDim.y;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int d0 = 0; d0 < d; d0 += kTileD) {
    for (int i = tid; i < kRows * kTileD; i += kThreads) {
      const int r = i / kTileD, c = i % kTileD;
      float x = 0.f;
      if (row0 + r < B && d0 + c < d) x = to_f32(phi[(size_t)(row0 + r) * d + d0 + c]);
      phis[r][c] = x;
    }
    __syncthreads();
    // Each d-tile's 32 products are summed apart and then added to acc: a
    // chain of 32 + d/256 roundings instead of d/8. Against the fp64 head at
    // d=4096 this keeps the probs' error at or below that of cuBLAS' fp32
    // product (the logit-scale sweep of chip_smoke.py).
    const int kb = warp * 32;
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < 32; ++kk) {
      const int kd = d0 + kb + kk;
      if (kd < d) {
        const float w = w1[(size_t)kd * hidden + col0 + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = fmaf(phis[r][kb + kk], w, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += part[r];
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  for (int i = tid; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][r][c];
    hs[r][c] = fmaxf(s + b1[col0 + c], 0.f);
  }
  __syncthreads();
  for (int i = tid; i < kRows * K; i += kThreads) {
    const int r = i / K, k = i % K;
    if (row0 + r >= B) continue;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < kCols; ++c) s = fmaf(hs[r][c], w2[(size_t)(col0 + c) * K + k], s);
    partial[((size_t)(row0 + r) * n_chunks + blockIdx.y) * K + k] = s;
  }
}

__global__ void __launch_bounds__(kEpiWarps * 32)
prod_head_epilogue(const float* __restrict__ partial, const float* __restrict__ b2,
                   const float* __restrict__ edges, const float* __restrict__ qs,
                   float* __restrict__ probs, float* __restrict__ quants,
                   int B, int n_chunks, int K, int Q) {
  __shared__ float sp[kEpiWarps][kMaxK];
  __shared__ float sc[kEpiWarps][kMaxK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kEpiWarps + warp;
  if (b >= B) return;  // whole warps leave; only __syncwarp below
  float* p = sp[warp];
  float* cdf = sc[warp];

  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) {
    float s = 0.f;
    for (int j = 0; j < n_chunks; ++j) s += partial[((size_t)b * n_chunks + j) * K + k];
    s += b2[k];
    p[k] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float tot = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float e = expf(p[k] - m);
    p[k] = e;
    tot += e;
  }
  tot = warp_sum(tot);
  for (int k = lane; k < K; k += 32) {
    const float pk = p[k] / tot;
    p[k] = pk;
    probs[(size_t)b * K + k] = pk;
  }
  __syncwarp();
  if (lane == 0) {
    float c = 0.f;
    for (int k = 0; k < K; ++k) {
      c += p[k];
      cdf[k] = c;
    }
  }
  __syncwarp();
  for (int qi = lane; qi < Q; qi += 32) {
    const float qv = qs[qi];
    int ks = K - 1;
    for (int k = 0; k < K; ++k) {
      if (cdf[k] >= qv) {
        ks = k;
        break;
      }
    }
    const float pk = p[ks];
    const float prev = cdf[ks] - pk;
    const float t = fminf(fmaxf((qv - prev) / fmaxf(pk, 1e-12f), 0.f), 1.f);
    const float left = edges[ks], right = edges[ks + 1];
    quants[(size_t)b * Q + qi] = left + t * (right - left);
  }
}

template <typename T>
cudaError_t launch(const void* phi, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* edges, const float* qs, float* partial,
                   float* probs, float* quants, cudaStream_t stream, int B, int d,
                   int hidden, int K, int Q) {
  const int n_chunks = hidden / kCols;
  dim3 grid1((B + kRows - 1) / kRows, n_chunks);
  prod_head_hidden<T><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(phi), w1, b1, w2, partial, B, d, hidden, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid2 = (B + kEpiWarps - 1) / kEpiWarps;
  prod_head_epilogue<<<grid2, kEpiWarps * 32, 0, stream>>>(partial, b2, edges, qs, probs,
                                                          quants, B, n_chunks, K, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int prod_head_launch(const void* phi, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* edges,
                                const void* qs, void* partial, void* probs, void* quants,
                                void* stream, int B, int d, int hidden, int K, int Q,
                                int phi_dtype) {
  if (hidden % kCols != 0 || K > kMaxK || K < 1 || B < 1) return (int)cudaErrorInvalidValue;
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(phi, static_cast<const float*>(w1), static_cast<const float*>(b1),
                     static_cast<const float*>(w2), static_cast<const float*>(b2),
                     static_cast<const float*>(edges), static_cast<const float*>(qs),
                     static_cast<float*>(partial), static_cast<float*>(probs),
                     static_cast<float*>(quants), static_cast<cudaStream_t>(stream), B, d,
                     hidden, K, Q);
  };
  if (phi_dtype == kF32) return (int)f(float{});
  if (phi_dtype == kBF16) return (int)f(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
