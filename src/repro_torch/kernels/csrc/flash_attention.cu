// Flash attention forward (prefill) for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:69):
// GQA attention, query head h reads KV head h / G, with causal, sliding-window
// and per-row key-length masks and an online softmax in fp32. Layouts are the
// reference's: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), out like q.
//
// One block per (query tile of 64, head, batch row). The TPU kernel carries
// (m, l, acc) across its sequential KV grid axis; blocks here run in no order,
// so the loop over 32-key KV tiles lives inside the block, with m and l in
// shared memory and acc in registers (a 4 x hd/16 tile per thread).
// Tiles that every row of the block masks (above the causal diagonal, past
// the row's key length, before the window) are skipped, so the work follows
// this run's data.
//
// What bounds it: at B=8, S=512, H=32, KV=8, hd=128 in bf16 the least time is
// set by the bytes (~84 MB of q/k/v/out) and the causal FLOPs (~17 GFLOP) about
// equally. This first version computes both products on the CUDA cores in
// fp32 from shared memory, so it sits far above that bound; wgmma/TMA are the
// later step (ROADMAP.md).
//
// The -1e30 fill of masked scores is the TPU kernel's, so a row whose keys are
// all masked in a tile contributes nothing once a valid key has been seen. A
// row with no valid key at all (key length 0) gets 0 here, where the plain
// version averages V; the serving path never asks for one.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kBQ = 64;
constexpr int kBKV = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + kBKV * (HD + 1) + kBKV * HD + kBQ * (kBKV + 1) +
                          3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const int* __restrict__ kv_len, T* __restrict__ o, int Sq, int Skv, int H, int KV,
          int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // kBQ x (HD+1)
  float* Ks = Qs + kBQ * (HD + 1);    // kBKV x (HD+1)
  float* Vs = Ks + kBKV * (HD + 1);   // kBKV x HD
  float* Ps = Vs + kBKV * HD;         // kBQ x (kBKV+1)
  float* m_s = Ps + kBQ * (kBKV + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  constexpr int NJ = HD / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int len = min(kv_len[b], Skv);

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int qp = q0 + r;
    Qs[r * (HD + 1) + c] =
        qp < Sq ? to_f32(q[((size_t)(b * Sq + qp) * H + h) * HD + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int kv_end = len;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  int kv_start = 0;
  if (window) kv_start = max(0, q0 - window + 1) / kBKV * kBKV;

  for (int kv0 = kv_start; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();  // Q staged / previous tile fully consumed
    for (int i = tid; i < kBKV * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const int kp = kv0 + r;
      float kx = 0.f, vx = 0.f;
      if (kp < Skv) {
        const size_t off = ((size_t)(b * Skv + kp) * KV + g) * HD + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      Ks[r * (HD + 1) + c] = kx;
      Vs[r * HD + c] = vx;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; ++c) {
      float qv[4], kx[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (HD + 1) + c];
#pragma unroll
      for (int j = 0; j < 2; ++j) kx[j] = Ks[(tx + 16 * j) * (HD + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kx[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, cc = tx + 16 * j;
        const int qp = q0 + r, kp = kv0 + cc;
        bool ok = kp < len;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && (qp - kp) < window;
        Ps[r * (kBKV + 1) + cc] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, one key per lane
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x = Ps[r * (kBKV + 1) + lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = expf(x - m_new);
      Ps[r * (kBKV + 1) + lane] = p;
      const float ps = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[((size_t)(b * Sq + qp) * H + h) * HD + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   cudaStream_t stream, int B, int Sq, int Skv, int H, int KV, int causal,
                   int window, float scale) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), kv_len, static_cast<T*>(o),
                                         Sq, Skv, H, KV, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(int hd, const void* q, const void* k, const void* v, const int* kv_len,
                        void* o, cudaStream_t s, int B, int Sq, int Skv, int H, int KV,
                        int causal, int window, float scale) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, kv_len, o, s, B, Sq, Skv, H, KV, causal, window, scale);
    case 64: return launch<T, 64>(q, k, v, kv_len, o, s, B, Sq, Skv, H, KV, causal, window, scale);
    case 128: return launch<T, 128>(q, k, v, kv_len, o, s, B, Sq, Skv, H, KV, causal, window, scale);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* o, void* stream, int B, int Sq,
                                      int Skv, int H, int KV, int hd, int causal, int window,
                                      int dtype, float scale) {
  if (B < 1 || Sq < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)by_head_dim<float>(hd, q, k, v, lens, o, s, B, Sq, Skv, H, KV, causal, window, scale);
  if (dtype == kBF16)
    return (int)by_head_dim<__nv_bfloat16>(hd, q, k, v, lens, o, s, B, Sq, Skv, H, KV, causal,
                                           window, scale);
  return (int)cudaErrorInvalidValue;
}
