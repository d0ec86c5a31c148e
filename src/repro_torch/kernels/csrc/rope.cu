// Rotary position embedding, one pass: for each head of x (B, S, H, hd) and
// its token's fp32 angles (B, S, hd / 2), out = [x1 cos - x2 sin,
// x2 cos + x1 sin] with x1, x2 the two halves of the head, fp32 inside,
// rounded once to x's dtype.
//
// Replaces no TPU kernel: the reference writes RoPE in jnp
// (src/repro/models/rope.py:49-56) and leaves its fusion to XLA. Written the
// same way in PyTorch it is twelve launches on the card (two casts, cos, sin,
// four products, a sub, an add, a cat and the cast back): ~48 bytes an
// element.
// Here x is read once and written once and the angles are read once a token,
// so the kernel is bound by those bytes (4 an element in bf16).
//
// Design:
//  * A block holds whole tokens: threads (column vector, head lane, token).
//    Each thread takes V columns of the half (16-byte loads where hd / 2,
//    the strides and the address allow; narrower where they do not: Gemma3's
//    halves of 84 take 8-byte vectors), computes their cos and sin once with
//    the precise sincosf (angles reach thousands of radians: no __sinf, no
//    fast math), and applies them to every head it walks.
//  * Products and sums are rounded as the plain path rounds them (__fmul_rn,
//    __fadd_rn, __fsub_rn: no contraction into an fma), so with the same
//    cos and sin the output is the plain path's, bit for bit.
//  * x may have any strides above its contiguous last dimension (the MLA's
//    q[..., 128:] and kv[..., None, 512:] are read in place); the angles'
//    last dimension is contiguous. The output is contiguous (B, S, H, hd).
#include <cstdint>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;  // a block's threads, about

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void rope_sm90(const T* __restrict__ x, const float* __restrict__ ang,
                          T* __restrict__ out, int B, int S, int H, int hd, long long sxb,
                          long long sxs, long long sxh, long long sab, long long sas) {
  const int half = hd >> 1;
  const int c = threadIdx.x * V;  // first column of this thread's vector
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.z + threadIdx.z;
  if (t >= static_cast<long long>(B) * S) return;
  const long long b = t / S, s = t % S;

  float cs[V], sn[V];
  const float* a = ang + b * sab + s * sas + c;
#pragma unroll
  for (int e = 0; e < V; ++e) sincosf(a[e], &sn[e], &cs[e]);

  const T* xt = x + b * sxb + s * sxs + c;
  T* ot = out + t * H * hd + c;
  for (int h = threadIdx.y; h < H; h += blockDim.y) {
    const Vec<T, V> x1 = *reinterpret_cast<const Vec<T, V>*>(xt + h * sxh);
    const Vec<T, V> x2 = *reinterpret_cast<const Vec<T, V>*>(xt + h * sxh + half);
    Vec<T, V> o1, o2;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f1 = to_f32(x1.v[e]), f2 = to_f32(x2.v[e]);
      o1.v[e] = from_f32<T>(__fsub_rn(__fmul_rn(f1, cs[e]), __fmul_rn(f2, sn[e])));
      o2.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(f2, cs[e]), __fmul_rn(f1, sn[e])));
    }
    *reinterpret_cast<Vec<T, V>*>(ot + static_cast<long long>(h) * hd) = o1;
    *reinterpret_cast<Vec<T, V>*>(ot + static_cast<long long>(h) * hd + half) = o2;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* ang, void* out, cudaStream_t st, int B, int S,
                   int H, int hd, const long long* str) {
  const int nv = (hd / 2) / V;                     // column vectors of a half
  const int hy = H < kThreads / nv ? H : (kThreads / nv > 0 ? kThreads / nv : 1);
  // tokens a block, at most 64 (CUDA's cap on blockDim.z: one head whose
  // half is one vector would ask for 256)
  const int tz = max(1, min(64, kThreads / (nv * hy)));
  const long long tokens = static_cast<long long>(B) * S;
  const long long blocks = (tokens + tz - 1) / tz;
  if (nv > 1024 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rope_sm90<T, V><<<static_cast<unsigned>(blocks), dim3(nv, hy, tz), 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(ang), static_cast<T*>(out), B, S, H,
      hd, str[0], str[1], str[2], str[3], str[4]);
  return cudaGetLastError();
}

// The widest vector (at most 16 bytes) that divides the half, every stride
// of x that is walked and x's address.
template <typename T>
cudaError_t by_vector(const void* x, const void* ang, void* out, cudaStream_t st, int B, int S,
                      int H, int hd, const long long* str) {
  const int half = hd / 2;
  const long long walked[3] = {B > 1 ? str[0] : 0, S > 1 ? str[1] : 0, H > 1 ? str[2] : 0};
  const auto addr = reinterpret_cast<std::uintptr_t>(x);
  int v = 16 / static_cast<int>(sizeof(T));
  while (v > 1 && (half % v || walked[0] % v || walked[1] % v || walked[2] % v ||
                   addr % (v * sizeof(T))))
    v >>= 1;
  if constexpr (sizeof(T) == 2)  // 16-byte vectors of bf16
    if (v == 8) return launch<T, 8>(x, ang, out, st, B, S, H, hd, str);
  switch (v) {
    case 4: return launch<T, 4>(x, ang, out, st, B, S, H, hd, str);
    case 2: return launch<T, 2>(x, ang, out, st, B, S, H, hd, str);
    default: return launch<T, 1>(x, ang, out, st, B, S, H, hd, str);
  }
}

}  // namespace

// x (B, S, H, hd) with strides (sxb, sxs, sxh, 1) in elements; ang (B, S,
// hd / 2) fp32 with strides (sab, sas, 1); out (B, S, H, hd) contiguous in
// x's dtype (common.cuh's code).
extern "C" int rope_launch(const void* x, const void* ang, void* out, void* stream, int B, int S,
                           int H, int hd, int sxb, int sxs, int sxh, int sab, int sas,
                           int dtype) {
  if (B < 1 || S < 1 || H < 1 || hd < 2 || hd % 2) return (int)cudaErrorInvalidValue;
  const long long str[5] = {sxb, sxs, sxh, sab, sas};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return (int)by_vector<__nv_bfloat16>(x, ang, out, st, B, S, H, hd, str);
  if (dtype == kF32) return (int)by_vector<float>(x, ang, out, st, B, S, H, hd, str);
  return (int)cudaErrorInvalidValue;
}
