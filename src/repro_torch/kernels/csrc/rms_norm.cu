// RMSNorm with a (1 + scale) gain, one pass: out = x * rsqrt(mean(x^2) + eps)
// * (1 + scale), x bf16 or fp32, fp32 inside, rounded once to x's dtype.
//
// Replaces no TPU kernel: the reference writes the norm in jnp
// (src/repro/models/layers.py:83-88) and leaves its fusion to XLA. Written
// the same way in PyTorch it is ten launches on the card (a cast to fp32,
// square, mean, add, rsqrt, the scale's cast, 1 + scale, two products, the
// cast back), each a full pass over the activation in fp32: ~40 bytes an
// element. Here an
// element is read once and written once (4 bytes in bf16), so the kernel is
// bound by those bytes: ~70 us for 8 x 2,048 rows of 3,584 at 3.35 TB/s.
//
// Design:
//  * The row is held in registers between the sum and the write: a thread
//    keeps NPT vectors of V elements of it (16-byte loads where the width,
//    the row stride and the address allow; narrower where they do not).
//  * The work per row adapts to the row's width. Short rows (at most 128
//    vectors: a head's q_norm / k_norm over 128, a 512-wide latent) take a
//    power-of-two group of lanes inside a warp, several rows a block, and sum
//    by shuffles within the group. Long rows (the residual's 3,584-7,168)
//    take a block a row, summed by warp shuffles and one exchange of the
//    warps' sums in shared memory.
//  * The scale (bf16 or fp32, whatever x is) is read at the write, in the
//    same vectors as x (d elements that every row reads, so they stay in
//    cache): a thread holds only its slice of the row, and many rows are in
//    flight on each SM.
//  * Arithmetic is the plain path's, in its order: the fp32 sum of squares,
//    var = sum / d, r = rsqrtf(var + eps), out = (x * r) * (1 + scale), each
//    product rounded (no contraction). Only the sum's order differs from the
//    plain path's reduction, so the bf16 outputs are bit-identical but for
//    rare ties.
//  * Rows may have any stride (the MLA's kv[..., :R] has 576); the last
//    dimension must be contiguous. The output is contiguous.
#include <cstdint>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kGroupThreads = 256;  // block size where several rows share a block

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// 1 + scale for V columns from j * V on, in fp32, rounded as the plain path
// rounds it; the scale is bf16 or fp32 whatever x is.
template <typename S, int V>
__device__ __forceinline__ void gain(const void* scale, int j, float (&g)[V]) {
  const Vec<S, V> s = *reinterpret_cast<const Vec<S, V>*>(static_cast<const S*>(scale) + j * V);
#pragma unroll
  for (int e = 0; e < V; ++e) g[e] = __fadd_rn(1.0f, to_f32(s.v[e]));
}

// One row per `tpr` lanes; tpr <= 32 is a group inside a warp, several rows
// a block; tpr > 32 is the whole block (blockDim.x == tpr, a multiple of 32),
// one row.
template <typename T, int V, int NPT>
__global__ void __launch_bounds__(1024)
    rms_norm_sm90(const T* __restrict__ x, const void* __restrict__ scale, T* __restrict__ out,
                  int M, int d, long long stride, int tpr, int scale_bf16, float eps) {
  const int lane = threadIdx.x % tpr;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / tpr) +
                        threadIdx.x / tpr;
  const bool valid = row < M;  // uniform in a block of one row
  const int nvec = d / V;
  const T* xr = x + row * stride;

  Vec<T, V> v[NPT];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int j = lane + k * tpr;
    if (valid && j < nvec) {
      v[k] = *reinterpret_cast<const Vec<T, V>*>(xr + j * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float f = to_f32(v[k].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  if (tpr <= 32) {
    for (int o = tpr >> 1; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o, tpr);
  } else {
    __shared__ float part[32];
    ss = warp_sum(ss);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.0f;
    for (int w = 0; w < (blockDim.x >> 5); ++w) ss += part[w];
  }
  if (!valid) return;
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));
  T* orow = out + row * static_cast<long long>(d);
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int j = lane + k * tpr;
    if (j < nvec) {
      float g[V];
      if (scale_bf16)
        gain<__nv_bfloat16, V>(scale, j, g);
      else
        gain<float, V>(scale, j, g);
      Vec<T, V> o;
#pragma unroll
      for (int e = 0; e < V; ++e)  // (x r) (1 + scale), each product rounded
        o.v[e] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(v[k].v[e]), r), g[e]));
      *reinterpret_cast<Vec<T, V>*>(orow + j * V) = o;
    }
  }
}

template <typename T, int V, int NPT>
cudaError_t launch(const void* x, const void* scale, void* out, cudaStream_t st, int M, int d,
                   int stride, int tpr, int scale_bf16, float eps) {
  const int threads = tpr > 32 ? tpr : kGroupThreads;
  const int rows = threads / tpr;  // a block's rows
  const long long blocks = (static_cast<long long>(M) + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rms_norm_sm90<T, V, NPT><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), M, d, stride, tpr, scale_bf16, eps);
  return cudaGetLastError();
}

// Vectors a thread holds (NPT) and lanes a row (tpr) for a row of nvec
// vectors: a group of <= 32 lanes up to 128 vectors, else a block of up to
// 1,024 threads holding 4, 8 or 16 vectors each.
template <typename T, int V>
cudaError_t by_width(const void* x, const void* scale, void* out, cudaStream_t st, int M, int d,
                     int stride, int scale_bf16, float eps) {
  const int nvec = d / V;
  int npt = nvec <= 32 ? 1 : nvec <= 64 ? 2 : 4;
  int tpr = ceil_div(nvec, npt);
  if (nvec <= 128) {
    int p = 1;
    while (p < tpr) p <<= 1;
    tpr = p;
  } else {
    while (ceil_div(nvec, npt) > 1024 && npt < 16) npt <<= 1;
    tpr = ceil_div(ceil_div(nvec, npt), 32) * 32;
    if (tpr > 1024) return cudaErrorInvalidValue;
  }
  switch (npt) {
    case 1: return launch<T, V, 1>(x, scale, out, st, M, d, stride, tpr, scale_bf16, eps);
    case 2: return launch<T, V, 2>(x, scale, out, st, M, d, stride, tpr, scale_bf16, eps);
    case 4: return launch<T, V, 4>(x, scale, out, st, M, d, stride, tpr, scale_bf16, eps);
    case 8: return launch<T, V, 8>(x, scale, out, st, M, d, stride, tpr, scale_bf16, eps);
    default: return launch<T, V, 16>(x, scale, out, st, M, d, stride, tpr, scale_bf16, eps);
  }
}

// The widest vector (at most 16 bytes of x) that divides the width and the
// row stride and that x's and the scale's addresses are aligned to.
template <typename T>
cudaError_t by_vector(const void* x, const void* scale, void* out, cudaStream_t st, int M, int d,
                      int stride, int scale_bf16, float eps) {
  const auto xa = reinterpret_cast<std::uintptr_t>(x);
  const auto sa = reinterpret_cast<std::uintptr_t>(scale);
  const int ssize = scale_bf16 ? 2 : 4;
  int v = 16 / static_cast<int>(sizeof(T));
  while (v > 1 && (d % v || stride % v || xa % (v * sizeof(T)) || sa % (v * ssize))) v >>= 1;
  if constexpr (sizeof(T) == 2)  // 16-byte vectors of bf16
    if (v == 8) return by_width<T, 8>(x, scale, out, st, M, d, stride, scale_bf16, eps);
  switch (v) {
    case 4: return by_width<T, 4>(x, scale, out, st, M, d, stride, scale_bf16, eps);
    case 2: return by_width<T, 2>(x, scale, out, st, M, d, stride, scale_bf16, eps);
    default: return by_width<T, 1>(x, scale, out, st, M, d, stride, scale_bf16, eps);
  }
}

}  // namespace

// x: M rows of d elements, row r at x + r * stride (elements); scale: d
// contiguous elements; out: M x d contiguous, in x's dtype. dtype and
// scale_dtype are common.cuh's codes.
extern "C" int rms_norm_launch(const void* x, const void* scale, void* out, void* stream, int M,
                               int d, int stride, int dtype, int scale_dtype, float eps) {
  if (M < 1 || d < 1 || stride < d || (scale_dtype != kF32 && scale_dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sb = scale_dtype == kBF16;
  if (dtype == kBF16)
    return (int)by_vector<__nv_bfloat16>(x, scale, out, st, M, d, stride, sb, eps);
  if (dtype == kF32) return (int)by_vector<float>(x, scale, out, st, M, d, stride, sb, eps);
  return (int)cudaErrorInvalidValue;
}
