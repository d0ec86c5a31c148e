// Chunked SSD scan (Mamba2's state-space-duality prefill) for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan.py:61). Per chunk of
// Q steps, with cum the prefix sum of the log-decay a over the chunk:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra-chunk)
//         + exp(cum_i) C_i . h                                    (carried state)
//   h    <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// Layouts are the reference's: x (B, S, H, P) and Bm, Cm (B, S, N) in fp32 or
// bf16 (one B/C group shared by all heads), dt and a (B, S, H) fp32; y like x
// and the final state h (B, H, P, N) fp32. All arithmetic is fp32.
//
// The TPU kernel walks (batch row, chunk) in order and carries h for all H
// heads in a (H, P, N) VMEM scratch: 786 KB at Mamba2-130M, more than a block's
// 227 KB of shared memory, and blocks here run in no order. So one block owns
// one (head, batch row) and loops over the chunks itself, holding its head's
// P x N state in shared memory (16 KB at N=64, 32 KB at N=128). The chunk's
// x, B, C and the Q x Q score matrix are staged in shared memory too; each
// thread computes a 4 x 4 (or 4 x P/16) register tile of each product.
//
// L = exp(cum_i - cum_j) is evaluated only for i >= j: above the diagonal the
// exponent is positive and may overflow, and inf * 0 would give NaN. A ragged
// last chunk is masked in the kernel: rows past S load x = B = C = dt = a = 0,
// which is the reference's zero padding (src/repro/kernels/ops.py:60-69).
//
// What bounds it: at Zamba2's serving shape (B=8, S=512, H=64, P=64, N=64,
// bf16) the least fp32 work is the chunked form's at a chunk near sqrt(N):
// per step and head Q*P + Q*N/H + 4*P*N + P*N/Q ~ 4.25*P*N (the recurrence
// needs 5*P*N), 4.6 GFLOP, ~0.068 ms at the 67 TFLOP/s fp32 peak. That
// outweighs its ~79 MB of traffic (~0.023 ms), so it is bound by operations. This first version runs the three chunk products on the CUDA
// cores from shared memory, and every head's block recomputes the shared
// C.B^T (64 times over at Zamba2); wgmma on bf16 tiles, TMA staging and
// sharing C.B^T across the heads of a batch row are the next steps.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kQ = 64;          // chunk length
constexpr int kThreads = 256;   // 16 x 16 threads

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kQ * P             // Xs
                          + 2 * kQ * (N + 1)  // Bs, Cs
                          + kQ * (kQ + 1)     // Ss: masked, decayed scores
                          + P * (N + 1)       // Hs: the carried state
                          + 4 * kQ);          // cum, exp(cum), decay-to-end * dt, dt
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_fwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
             const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
             float* __restrict__ h_out, int S, int H) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P and N must be multiples of 16");
  extern __shared__ float smem[];
  float* Xs = smem;                   // kQ x P
  float* Bs = Xs + kQ * P;            // kQ x (N+1)
  float* Cs = Bs + kQ * (N + 1);      // kQ x (N+1)
  float* Ss = Cs + kQ * (N + 1);      // kQ x (kQ+1)
  float* Hs = Ss + kQ * (kQ + 1);     // P x (N+1)
  float* cum = Hs + P * (N + 1);      // kQ
  float* ecum = cum + kQ;             // kQ: exp(cum_i)
  float* wdec = ecum + kQ;            // kQ: exp(cum_last - cum_j) * dt_j
  float* dts = wdec + kQ;             // kQ

  constexpr int NP = P / 16, NN = N / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.x, b = blockIdx.y;

  for (int i = tid; i < P * (N + 1); i += kThreads) Hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int nq = min(kQ, S - c0);
    __syncthreads();  // the previous chunk is done with Xs, Bs, Cs, Hs
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i % P;
      Xs[i] = r < nq ? to_f32(x[((size_t)(b * S + c0 + r) * H + head) * P + p]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < nq) {
        const size_t off = (size_t)(b * S + c0 + r) * N + n;
        bv = to_f32(bm[off]);
        cv = to_f32(cm[off]);
      }
      Bs[r * (N + 1) + n] = bv;
      Cs[r * (N + 1) + n] = cv;
    }
    if (tid < 32) {
      // inclusive prefix sum of a over the chunk: lane l owns rows 2l, 2l+1
      const int r0 = 2 * tid, r1 = r0 + 1;
      const size_t base = (size_t)(b * S + c0) * H + head;
      const float a0 = r0 < nq ? a[base + (size_t)r0 * H] : 0.f;
      const float a1 = r1 < nq ? a[base + (size_t)r1 * H] : 0.f;
      const float d0 = r0 < nq ? dt[base + (size_t)r0 * H] : 0.f;
      const float d1 = r1 < nq ? dt[base + (size_t)r1 * H] : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += t;
      }
      float prev = __shfl_up_sync(0xffffffffu, s, 1);
      if (tid == 0) prev = 0.f;
      const float c0v = prev + a0, c1v = c0v + a1;
      const float last = __shfl_sync(0xffffffffu, c1v, 31);
      cum[r0] = c0v;
      cum[r1] = c1v;
      ecum[r0] = expf(c0v);
      ecum[r1] = expf(c1v);
      // last - cum_j <= 0 up to rounding: no overflow
      wdec[r0] = expf(last - c0v) * d0;
      wdec[r1] = expf(last - c1v) * d1;
      dts[r0] = d0;
      dts[r1] = d1;
    }
    __syncthreads();

    // scores S[i][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i, else 0;
    // thread tile: rows ty + 16 ii, columns tx + 16 jj
    {
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 16 * ii) * (N + 1) + n];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bv[jj] = Bs[(tx + 16 * jj) * (N + 1) + n];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(cv[ii], bv[jj], acc[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty + 16 * ii;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = tx + 16 * jj;
          // mask before exp: cum_i - cum_j > 0 above the diagonal
          Ss[i * (kQ + 1) + j] = i >= j ? acc[ii][jj] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // y[i][p] = sum_j S[i][j] x[j][p] + exp(cum_i) * sum_n C[i][n] h[p][n];
    // thread tile: rows ty + 16 ii, columns p = tx + 16 jj
    {
      float yi[4][NP], yh[4][NP];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < NP; ++jj) yi[ii][jj] = yh[ii][jj] = 0.f;
#pragma unroll 8
      for (int j = 0; j < kQ; ++j) {
        float sv[4], xv[NP];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) sv[ii] = Ss[(ty + 16 * ii) * (kQ + 1) + j];
#pragma unroll
        for (int jj = 0; jj < NP; ++jj) xv[jj] = Xs[j * P + tx + 16 * jj];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < NP; ++jj) yi[ii][jj] = fmaf(sv[ii], xv[jj], yi[ii][jj]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[NP];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 16 * ii) * (N + 1) + n];
#pragma unroll
        for (int jj = 0; jj < NP; ++jj) hv[jj] = Hs[(tx + 16 * jj) * (N + 1) + n];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < NP; ++jj) yh[ii][jj] = fmaf(cv[ii], hv[jj], yh[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = ty + 16 * ii;
        if (i >= nq) continue;
        T* yrow = y + ((size_t)(b * S + c0 + i) * H + head) * P;
#pragma unroll
        for (int jj = 0; jj < NP; ++jj)
          yrow[tx + 16 * jj] = from_f32<T>(yi[ii][jj] + ecum[i] * yh[ii][jj]);
      }
    }
    __syncthreads();  // every read of the old state is done

    // h[p][n] = exp(cum_last) h[p][n] + sum_j B[j][n] wdec[j] x[j][p];
    // thread tile: p = ty + 16 ii, n = tx + 16 jj
    {
      float st[NP][NN];
#pragma unroll
      for (int ii = 0; ii < NP; ++ii)
#pragma unroll
        for (int jj = 0; jj < NN; ++jj) st[ii][jj] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kQ; ++j) {
        const float w = wdec[j];
        float xv[NP], bv[NN];
#pragma unroll
        for (int ii = 0; ii < NP; ++ii) xv[ii] = Xs[j * P + ty + 16 * ii];
#pragma unroll
        for (int jj = 0; jj < NN; ++jj) bv[jj] = Bs[j * (N + 1) + tx + 16 * jj] * w;
#pragma unroll
        for (int ii = 0; ii < NP; ++ii)
#pragma unroll
          for (int jj = 0; jj < NN; ++jj) st[ii][jj] = fmaf(bv[jj], xv[ii], st[ii][jj]);
      }
      const float dlast = expf(cum[kQ - 1]);
#pragma unroll
      for (int ii = 0; ii < NP; ++ii)
#pragma unroll
        for (int jj = 0; jj < NN; ++jj) {
          float* hp = Hs + (ty + 16 * ii) * (N + 1) + tx + 16 * jj;
          *hp = dlast * *hp + st[ii][jj];
        }
    }
  }
  __syncthreads();

  float* hb = h_out + (size_t)(b * H + head) * P * N;
  for (int i = tid; i < P * N; i += kThreads) hb[i] = Hs[(i / N) * (N + 1) + i % N];
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* a, const void* bm,
                   const void* cm, void* y, float* h, cudaStream_t stream, int B, int S,
                   int H) {
  constexpr size_t smem = smem_bytes<P, N>();
  auto kern = ssd_scan_fwd<T, P, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), dt, a,
                                         static_cast<const T*>(bm), static_cast<const T*>(cm),
                                         static_cast<T*>(y), h, S, H);
  return cudaGetLastError();
}

// (P, N) pairs: the serving widths, Zamba2 64/64 and Mamba2-130M 64/128. Any
// other pair is refused with cudaErrorInvalidValue, which the wrapper raises.
template <typename T>
cudaError_t by_widths(int P, int N, const void* x, const float* dt, const float* a,
                      const void* bm, const void* cm, void* y, float* h, cudaStream_t s,
                      int B, int S, int H) {
  if (P == 64 && N == 64) return launch<T, 64, 64>(x, dt, a, bm, cm, y, h, s, B, S, H);
  if (P == 64 && N == 128) return launch<T, 64, 128>(x, dt, a, bm, cm, y, h, s, B, S, H);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, void* y, void* h, void* stream, int B, int S,
                               int H, int P, int N, int dtype) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const float* dtp = static_cast<const float*>(dt);
  const float* ap = static_cast<const float*>(a);
  float* hp = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)by_widths<float>(P, N, x, dtp, ap, bm, cm, y, hp, s, B, S, H);
  if (dtype == kBF16)
    return (int)by_widths<__nv_bfloat16>(P, N, x, dtp, ap, bm, cm, y, hp, s, B, S, H);
  return (int)cudaErrorInvalidValue;
}
