// Split-KV flash-decoding for Hopper (sm_90a).
//
// Replaces decode_attention_pallas (src/repro/kernels/decode_attention.py:64):
// one query token per row, q (B, H, hd), against a cache k, v (B, Sc, KV, hd);
// keys at positions >= lengths[b] are masked; the G = H/KV query heads of a
// group share their K/V rows; online softmax in fp32; out (B, H, hd) in q's
// type.
//
// The TPU kernel walks the cache along a sequential grid axis and carries
// (m, l, acc) in VMEM, with the lengths scalar-prefetched. Here:
//  * decode_split, grid (n_splits, KV, B): each block reads its own length,
//    attends the G heads of one group to one chunk of <= 128 keys (only the
//    valid ones are read), and writes the chunk's partial max m, sum l and
//    unnormalised acc to an fp32 scratch the wrapper allocates. Scores: one
//    warp per key row (coalesced hd loads), G dot products reduced across the
//    warp. Values: one thread per channel, G accumulators each.
//  * decode_combine, grid (KV, B): rescales the partials by exp(m_i - M) and
//    divides by the combined l.
//
// What bounds it: the K and V bytes of the valid cache prefix (18.9 MB per
// layer at B=8, Sc=576, KV=8, hd=128 in bf16, ~5.6 us at 3.35 TB/s); the
// arithmetic is ~1 FLOP per byte. Each K/V element is read exactly once.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxChunk = 128;
constexpr float kNegInf = -1e30f;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ lengths, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc, int Sc, int H, int KV,
             int chunk, float scale) {
  __shared__ float qs[kMaxG][HD];
  __shared__ float sc[kMaxG][kMaxChunk];
  constexpr int PER = HD / 32;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lengths[b], Sc);
  const int k0 = split * chunk;
  const int n = max(0, min(k0 + chunk, len) - k0);  // valid keys in this chunk
  const size_t pbase = ((size_t)(b * KV + g) * n_splits + split) * G;

  for (int i = tid; i < G * HD; i += kThreads)
    qs[i / HD][i % HD] = to_f32(q[((size_t)b * H + g * G + i / HD) * HD + i % HD]);
  __syncthreads();

  for (int j = warp; j < n; j += kWarps) {
    const T* krow = k + ((size_t)(b * Sc + k0 + j) * KV + g) * HD;
    float kx[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) kx[e] = to_f32(krow[lane + 32 * e]);
    for (int gi = 0; gi < G; ++gi) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) s = fmaf(qs[gi][lane + 32 * e], kx[e], s);
      s = warp_sum(s);
      if (lane == 0) sc[gi][j] = s * scale;
    }
  }
  __syncthreads();

  for (int gi = warp; gi < G; gi += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sc[gi][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sc[gi][j] - mx);
      sc[gi][j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[pbase + gi] = mx;
      part_l[pbase + gi] = sum;
    }
  }
  __syncthreads();

  for (int c = tid; c < HD; c += kThreads) {
    float acc[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) acc[gi] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float vv = to_f32(v[((size_t)(b * Sc + k0 + j) * KV + g) * HD + c]);
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < G) acc[gi] = fmaf(sc[gi][j], vv, acc[gi]);
    }
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
      if (gi < G) part_acc[(pbase + gi) * HD + c] = acc[gi];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, T* __restrict__ out, int H, int KV, int hd,
               int n_splits) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  for (int gi = 0; gi < G; ++gi) {
    auto idx = [&](int s) { return ((size_t)(b * KV + g) * n_splits + s) * G + gi; };
    float M = kNegInf;
    for (int s = 0; s < n_splits; ++s) M = fmaxf(M, part_m[idx(s)]);
    float L = 0.f;
    for (int s = 0; s < n_splits; ++s) L += part_l[idx(s)] * expf(part_m[idx(s)] - M);
    const float den = fmaxf(L, 1e-30f);
    for (int c = threadIdx.x; c < hd; c += kThreads) {
      float o = 0.f;
      for (int s = 0; s < n_splits; ++s)
        o += part_acc[idx(s) * hd + c] * expf(part_m[idx(s)] - M);
      out[((size_t)b * H + g * G + gi) * hd + c] = from_f32<T>(o / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   float* pm, float* pl, float* pacc, void* out, cudaStream_t stream, int B,
                   int Sc, int H, int KV, int chunk, int n_splits, float scale) {
  dim3 grid1(n_splits, KV, B);
  decode_split<T, HD><<<grid1, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      pm, pl, pacc, Sc, H, KV, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(KV, B);
  decode_combine<T><<<grid2, kThreads, 0, stream>>>(pm, pl, pacc, static_cast<T*>(out), H, KV,
                                                   HD, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int hd, const void* q, const void* k, const void* v, const int* lengths,
                        float* pm, float* pl, float* pacc, void* out, cudaStream_t s, int B,
                        int Sc, int H, int KV, int chunk, int n_splits, float scale) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, lengths, pm, pl, pacc, out, s, B, Sc, H, KV, chunk, n_splits, scale);
    case 64: return launch<T, 64>(q, k, v, lengths, pm, pl, pacc, out, s, B, Sc, H, KV, chunk, n_splits, scale);
    case 128: return launch<T, 128>(q, k, v, lengths, pm, pl, pacc, out, s, B, Sc, H, KV, chunk, n_splits, scale);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* part_m, void* part_l,
                                       void* part_acc, void* out, void* stream, int B, int Sc,
                                       int H, int KV, int hd, int chunk, int n_splits,
                                       int dtype, float scale) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || chunk < 1 || chunk > kMaxChunk ||
      n_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pacc = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)by_head_dim<float>(hd, q, k, v, lens, pm, pl, pacc, out, s, B, Sc, H, KV, chunk,
                                   n_splits, scale);
  if (dtype == kBF16)
    return (int)by_head_dim<__nv_bfloat16>(hd, q, k, v, lens, pm, pl, pacc, out, s, B, Sc, H, KV,
                                           chunk, n_splits, scale);
  return (int)cudaErrorInvalidValue;
}
