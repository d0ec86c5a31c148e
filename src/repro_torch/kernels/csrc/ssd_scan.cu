// Chunked SSD scan (Mamba2's state-space-duality prefill) for Hopper (sm_90a).
//
// Replaces ssd_scan_pallas (src/repro/kernels/ssd_scan.py:61). Per chunk of
// Q = 64 steps, with cum the prefix sum of the log-decay a over the chunk:
//   y[i]  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra-chunk)
//         + exp(cum_i) C_i . h                                    (carried state)
//   h    <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// Layouts are the reference's: x (B, S, H, P) and Bm, Cm (B, S, N) in fp32 or
// bf16 (one B/C group shared by all heads), dt and a (B, S, H) fp32; y like x
// and the final state h (B, H, P, N) fp32.
//
// The TPU kernel walks (batch row, chunk) in order and carries h for all H
// heads in a (H, P, N) VMEM scratch: 786 KB at Mamba2-130M, more than a block's
// 227 KB of shared memory, and blocks here run in no order. So one block owns
// one (head, batch row) and loops over the chunks itself: 512 blocks at
// Zamba2's serving shape, 192 at Mamba2's, which fills the 132 SMs.
//
// bf16 inputs (the served models): ssd_scan_tc, grid (H, B), 8 warps. Each
//    chunk's x, B, C, dt and a are brought to shared memory by 16-byte
//    cp.async (rows past S fill with zeros: the reference's zero padding),
//    the next chunk's while this one computes. Every product runs on the
//    tensor cores, mma.sync m16n8k16 bf16 -> fp32. Warps 0-3 make y, 16 rows
//    each: G = C B^T, C h^T (h from shared memory) and (G o L o dt) x (the
//    scores on the accumulators of G, only tiles on or below the diagonal).
//    Warps 4-7 carry the state, 16 of its P rows each, in their
//    accumulators across chunks: h = exp(cum_last) h + (w o x)^T B with
//    w_j = exp(cum_last - cum_j) dt_j. Both need only the
//    state before the chunk, so the two sets run side by side, and the
//    state warps overwrite its shared copy once the output warps have read
//    it (a named barrier). x, B and C are exact in bf16. The fp32 operands
//    (the decayed scores, w o x and h) are split into a bf16 high part and
//    a bf16 low part (the rest), two products each: 16 significant bits,
//    ~1e-5 relative, where one bf16 rounding would cost ~2e-3 in h against
//    its 2e-4 tolerance.
//  L = exp(cum_i - cum_j) is evaluated only for i >= j: above the diagonal
//  the exponent is positive and may overflow, and inf * 0 would give NaN.
//  C B^T is the one product the H heads of a batch row share. Each block
//  computes it again: its tiles on or below the diagonal are 11-12% of a
//  block's mma.sync count, and a first launch that wrote it once per (batch
//  row, chunk) for the heads' blocks to read from L2 measured 3-7.5% slower
//  on the H100 at both served shapes than computing it per head.
//
// fp32 inputs keep the first version's kernel (ssd_scan_fwd): the same
// chunking with the three products on the CUDA cores from shared memory.
//
// What bounds it: with the products on the tensor cores, the bytes. At
// Zamba2's serving shape (B=8, S=512, H=64, P=64, N=64, bf16) the scan must
// read x, dt, a, B and C and write y and h: 78.6 MB, 0.0235 ms at 3.35 TB/s,
// against 4.6 GFLOP of the chunked form's least work, 0.005 ms at the 989
// TFLOP/s bf16 peak (0.068 ms at the 67 TFLOP/s fp32 peak of the CUDA
// cores, which bounded the first version).
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

using namespace repro;
using repro::sm90::cp_async16;
using repro::sm90::cp_async4;
using repro::sm90::cp_async_commit;
using repro::sm90::cp_async_wait_all;
using repro::sm90::ldsm_x4;
using repro::sm90::ldsm_x4_trans;
using repro::sm90::mma_bf16;

namespace {

constexpr int kQ = 64;          // chunk length

// ---- fp32: the first version's kernel, the products on the CUDA cores --------

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


// ---- bf16: the products on the tensor cores ---------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kScan = 256;   // threads of ssd_scan_tc: 4 output warps + 4 state warps

// Named barrier 1 of ssd_scan_tc: the output warps arrive once they have read
// C and the state of the chunk before; the state warps wait there before they
// overwrite it.
__device__ __forceinline__ void state_read_arrive() {
  asm volatile("bar.arrive 1, %0;" ::"n"(kScan) : "memory");
}
__device__ __forceinline__ void state_read_wait() {
  asm volatile("bar.sync 1, %0;" ::"n"(kScan) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}
// (x0, x1) = hi + lo, each a pair of bf16: 16 significant bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// Shared memory of ssd_scan_tc, in bytes: two stages of x, B, dt and a; one of
// C (read only by C h^T, early in a chunk, so the next chunk's is brought in
// after it: at N = 128 that keeps two blocks on an SM); the state h as bf16 hi
// and lo; each warp's own cum, e^cum and w. Rows are padded by 16 bytes, so
// the 8 rows an ldmatrix reads fall in distinct banks.
template <int P, int N>
struct TcSmem {
  static constexpr int XS = P + 8, BS = N + 8;   // row strides, bf16
  static constexpr int stage = 2 * (kQ * XS + kQ * BS) + 2 * 4 * kQ;   // x, B, dt, a
  static constexpr int cbuf = 2 * kQ * BS;                             // C
  static constexpr int state = 2 * 2 * P * BS;                         // h: hi, lo
  static constexpr int bytes = 2 * stage + cbuf + state + (kScan / 32) * 3 * 4 * kQ;
};

// The warp's 16 rows of G = C B^T (rows 16 warp.., 8-column tiles 0 .. 2 warp + 1:
// the tiles on or below the diagonal; the others are left 0). cs, bs: 64 rows.
template <int N>
__device__ __forceinline__ void cb_tiles(const bf16* cs, const bf16* bs, int warp, int lane,
                                         float (&g)[8][4]) {
  constexpr int BS = N + 8;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) g[t][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, cs + (16 * warp + (lane & 15)) * BS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {
      if (tp > warp) continue;
      uint32_t bb[4];
      ldsm_x4(bb, bs + (16 * tp + (lane & 7) + ((lane >> 4) << 3)) * BS + ks * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(g[2 * tp], a, bb[0], bb[1]);
      mma_bf16(g[2 * tp + 1], a, bb[2], bb[3]);
    }
  }
}

// Rows r < nq of a chunk's (rows x W*8) bf16 tile at src (row stride
// src_stride elements) into dst (row stride ds), by NT threads (this one is
// t); rows past nq fill with zeros.
template <int W, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, int ds, const bf16* src, size_t src_stride,
                                           int nq, int t) {
  for (int e = t; e < kQ * W; e += NT) {
    const int r = e / W, w = e % W;
    const bool ok = r < nq;
    cp_async16(dst + r * ds + w * 8, src + (ok ? r : 0) * src_stride + w * 8, ok ? 16 : 0);
  }
}

// Warps 0-3 make y, each 16 rows of the chunk; warps 4-7 carry the state, each
// 16 of its P rows. Both read only the state before the chunk, so they run
// side by side: the state warps update theirs in registers and overwrite the
// shared copy once the output warps have read it (named barrier 1).
template <int P, int N>
__global__ void __launch_bounds__(kScan, 2)
ssd_scan_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ a, const bf16* __restrict__ bm,
            const bf16* __restrict__ cm, bf16* __restrict__ y,
            float* __restrict__ h_out, int S, int H) {
  static_assert(P == 64 && N % 16 == 0, "P = 64: 4 warps of 16 state rows");
  using L = TcSmem<P, N>;
  constexpr int XS = L::XS, BS = L::BS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* cs = reinterpret_cast<bf16*>(tc_smem + 2 * L::stage);
  bf16* hhi = cs + kQ * BS;
  bf16* hlo = hhi + P * BS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int w4 = warp & 3;   // the 16 rows (output warps) or state rows (state warps) it owns
  float* cum = reinterpret_cast<float*>(tc_smem + 2 * L::stage + L::cbuf + L::state) +
               warp * 3 * kQ;   // this warp's
  float* ecum = cum + kQ;   // exp(cum_i)
  float* wdec = ecum + kQ;  // exp(cum_last - cum_j) dt_j

  const int head = blockIdx.x, b = blockIdx.y;
  const int nchunks = (S + kQ - 1) / kQ;
  auto xs_of = [&](int st) { return reinterpret_cast<bf16*>(tc_smem + st * L::stage); };

  auto load_stage = [&](int st, int c) {   // x, B, dt, a of chunk c, by every thread
    const int c0 = c * kQ, nq = min(kQ, S - c0);
    bf16* xs = xs_of(st);
    bf16* bs = xs + kQ * XS;
    float* dts = reinterpret_cast<float*>(bs + kQ * BS);
    stage_rows<P / 8, kScan>(xs, XS, x + (((size_t)b * S + c0) * H + head) * P, (size_t)H * P,
                             nq, tid);
    stage_rows<N / 8, kScan>(bs, BS, bm + ((size_t)b * S + c0) * N, N, nq, tid);
    if (tid < 2 * kQ) {   // threads 0..63: dt, 64..127: a
      const int r = tid % kQ;
      const bool ok = r < nq;
      const float* src = (tid < kQ ? dt : a) + ((size_t)b * S + c0 + (ok ? r : 0)) * H + head;
      cp_async4(dts + tid, src, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  auto load_c = [&](int c, int t, auto nt) {   // C of chunk c, by nt threads
    const int c0 = c * kQ;
    stage_rows<N / 8, decltype(nt)::value>(cs, BS, cm + ((size_t)b * S + c0) * N, N,
                                           min(kQ, S - c0), t);
    cp_async_commit();
  };
  // each warp: the inclusive prefix sum of a over the chunk, lane l rows 2l, 2l+1
  auto prefix = [&](const float* dts) {
    const float* as = dts + kQ;
    const int r0 = 2 * lane, r1 = r0 + 1;
    const float a0 = as[r0], a1 = as[r1];
    float s = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += t;
    }
    float prev = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) prev = 0.f;
    const float c0v = prev + a0, c1v = c0v + a1;
    const float last = __shfl_sync(0xffffffffu, c1v, 31);
    cum[r0] = c0v;
    cum[r1] = c1v;
    ecum[r0] = expf(c0v);
    ecum[r1] = expf(c1v);
    // last - cum_j <= 0 up to rounding: no overflow
    wdec[r0] = expf(last - c0v) * dts[r0];
    wdec[r1] = expf(last - c1v) * dts[r1];
    __syncwarp();
  };

  load_stage(0, 0);
  load_c(0, tid, std::integral_constant<int, kScan>());
  const int i0 = 16 * w4 + g, i1 = i0 + 8;

  if (warp < 4) {
    // ---- output warps: y = exp(cum_i) C h^T + (G o L o dt) x, rows i0, i1
    for (int c = 0; c < nchunks; ++c) {
      const int c0 = c * kQ, nq = min(kQ, S - c0);
      cp_async_wait_all();
      __syncthreads();   // chunk c has landed; every warp is done with chunk c - 1
      if (c + 1 < nchunks) load_stage((c + 1) & 1, c + 1);
      const bf16* xs = xs_of(c & 1);
      const bf16* bs = xs + kQ * XS;
      const float* dts = reinterpret_cast<const float*>(bs + kQ * BS);
      prefix(dts);

      float sc[8][4];   // G, then the decayed scores, of the warp's 16 rows
      cb_tiles<N>(cs, bs, w4, lane, sc);

      float yacc[P / 8][4];
#pragma unroll
      for (int t = 0; t < P / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[t][e] = 0.f;
      if (c > 0) {   // C h^T, the state before this chunk
#pragma unroll
        for (int ks = 0; ks < N / 16; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, cs + (16 * w4 + (lane & 15)) * BS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int pt = 0; pt < P / 16; ++pt) {
            const int off = (16 * pt + (lane & 7) + ((lane >> 4) << 3)) * BS + ks * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t bh[4], bl[4];
            ldsm_x4(bh, hhi + off);
            ldsm_x4(bl, hlo + off);
            mma_bf16(yacc[2 * pt], af, bh[0], bh[1]);
            mma_bf16(yacc[2 * pt + 1], af, bh[2], bh[3]);
            mma_bf16(yacc[2 * pt], af, bl[0], bl[1]);
            mma_bf16(yacc[2 * pt + 1], af, bl[2], bl[3]);
          }
        }
        const float e0 = ecum[i0], e1 = ecum[i1];
#pragma unroll
        for (int t = 0; t < P / 8; ++t) {
          yacc[t][0] *= e0;
          yacc[t][1] *= e0;
          yacc[t][2] *= e1;
          yacc[t][3] *= e1;
        }
      }
      state_read_arrive();   // done with C and the state before this chunk

      // L masked before exp. L feeds only y (bf16 out), so the fast exp
      // (ex2.approx: ~1e-5 relative at |cum_i - cum_j| ~ 50) will do
      const float ci0 = cum[i0], ci1 = cum[i1];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (t > 2 * w4 + 1) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * t + 2 * q4 + e;
          const float cj = cum[j], dj = dts[j];
          sc[t][e] = j <= i0 ? sc[t][e] * __expf(ci0 - cj) * dj : 0.f;
          sc[t][2 + e] = j <= i1 ? sc[t][2 + e] * __expf(ci1 - cj) * dj : 0.f;
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks > w4) continue;
        uint32_t ahi[4], alo[4];
        split_bf16(sc[2 * ks][0], sc[2 * ks][1], ahi[0], alo[0]);
        split_bf16(sc[2 * ks][2], sc[2 * ks][3], ahi[1], alo[1]);
        split_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1], ahi[2], alo[2]);
        split_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int pt = 0; pt < P / 16; ++pt) {
          uint32_t bx[4];
          ldsm_x4_trans(bx, xs + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * XS +
                                16 * pt + (lane >> 4) * 8);
          mma_bf16(yacc[2 * pt], ahi, bx[0], bx[1]);
          mma_bf16(yacc[2 * pt + 1], ahi, bx[2], bx[3]);
          mma_bf16(yacc[2 * pt], alo, bx[0], bx[1]);
          mma_bf16(yacc[2 * pt + 1], alo, bx[2], bx[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < P / 8; ++t) {
        const int p = 8 * t + 2 * q4;
        if (i0 < nq)
          *reinterpret_cast<uint32_t*>(y + (((size_t)b * S + c0 + i0) * H + head) * P + p) =
              pack_bf16(yacc[t][0], yacc[t][1]);
        if (i1 < nq)
          *reinterpret_cast<uint32_t*>(y + (((size_t)b * S + c0 + i1) * H + head) * P + p) =
              pack_bf16(yacc[t][2], yacc[t][3]);
      }
    }
    return;
  }

  // ---- state warps: h = exp(cum_last) h + (w o x)^T B, rows p = i0, i1, all N columns
  float hacc[N / 8][4];
#pragma unroll
  for (int t = 0; t < N / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[t][e] = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait_all();
    __syncthreads();   // chunk c has landed; every warp is done with chunk c - 1
    if (c + 1 < nchunks) load_stage((c + 1) & 1, c + 1);
    const bf16* xs = xs_of(c & 1);
    const bf16* bs = xs + kQ * XS;
    prefix(reinterpret_cast<const float*>(bs + kQ * BS));

    const float dlast = ecum[kQ - 1];
#pragma unroll
    for (int t = 0; t < N / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[t][e] *= dlast;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ax[4], ahi[4], alo[4];
      ldsm_x4_trans(ax, xs + (16 * ks + (lane & 7) + ((lane >> 4) << 3)) * XS + 16 * w4 +
                            ((lane >> 3) & 1) * 8);
      const float w0 = wdec[16 * ks + 2 * q4], w1 = wdec[16 * ks + 2 * q4 + 1];
      const float w2 = wdec[16 * ks + 8 + 2 * q4], w3 = wdec[16 * ks + 9 + 2 * q4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = unpack_bf16(ax[r]);
        split_bf16(f.x * (r < 2 ? w0 : w2), f.y * (r < 2 ? w1 : w3), ahi[r], alo[r]);
      }
#pragma unroll
      for (int nt = 0; nt < N / 16; ++nt) {
        uint32_t bb[4];
        ldsm_x4_trans(bb, bs + (16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3)) * BS + 16 * nt +
                              (lane >> 4) * 8);
        mma_bf16(hacc[2 * nt], ahi, bb[0], bb[1]);
        mma_bf16(hacc[2 * nt + 1], ahi, bb[2], bb[3]);
        mma_bf16(hacc[2 * nt], alo, bb[0], bb[1]);
        mma_bf16(hacc[2 * nt + 1], alo, bb[2], bb[3]);
      }
    }
    state_read_wait();   // the output warps are done with C and the old state
    // the new state, split, for the next chunk's C h^T; then the next C
#pragma unroll
    for (int t = 0; t < N / 8; ++t) {
      const int n = 8 * t + 2 * q4;
      uint32_t hi, lo;
      split_bf16(hacc[t][0], hacc[t][1], hi, lo);
      *reinterpret_cast<uint32_t*>(hhi + i0 * BS + n) = hi;
      *reinterpret_cast<uint32_t*>(hlo + i0 * BS + n) = lo;
      split_bf16(hacc[t][2], hacc[t][3], hi, lo);
      *reinterpret_cast<uint32_t*>(hhi + i1 * BS + n) = hi;
      *reinterpret_cast<uint32_t*>(hlo + i1 * BS + n) = lo;
    }
    if (c + 1 < nchunks) load_c(c + 1, tid - kScan / 2, std::integral_constant<int, kScan / 2>());
  }

  float* hb = h_out + ((size_t)b * H + head) * P * N;
#pragma unroll
  for (int t = 0; t < N / 8; ++t) {
    const int n = 8 * t + 2 * q4;
    *reinterpret_cast<float2*>(hb + i0 * N + n) = make_float2(hacc[t][0], hacc[t][1]);
    *reinterpret_cast<float2*>(hb + i1 * N + n) = make_float2(hacc[t][2], hacc[t][3]);
  }
}

template <int P, int N>
cudaError_t launch_simt(const float* x, const float* dt, const float* a, const float* bm,
                        const float* cm, float* y, float* h, cudaStream_t stream, int B, int S,
                        int H) {
  constexpr size_t smem = smem_bytes<P, N>();
  auto kern = ssd_scan_fwd<float, P, N>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), kThreads, smem, stream>>>(x, dt, a, bm, cm, y, h, S, H);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_tc(const bf16* x, const float* dt, const float* a, const bf16* bm,
                      const bf16* cm, bf16* y, float* h, cudaStream_t stream, int B, int S,
                      int H) {
  constexpr int smem = TcSmem<P, N>::bytes;
  auto kern = ssd_scan_tc<P, N>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(H, B), kScan, smem, stream>>>(x, dt, a, bm, cm, y, h, S, H);
  return cudaGetLastError();
}

// (P, N) pairs: the serving widths, Zamba2 64/64 and Mamba2-130M 64/128. Any
// other pair is refused with cudaErrorInvalidValue, which the wrapper raises.
template <int P, int N>
cudaError_t by_dtype(int dtype, const void* x, const float* dt, const float* a, const void* bm,
                     const void* cm, void* y, float* h, cudaStream_t s, int B, int S, int H) {
  if (dtype == kF32)
    return launch_simt<P, N>(static_cast<const float*>(x), dt, a, static_cast<const float*>(bm),
                             static_cast<const float*>(cm), static_cast<float*>(y), h, s, B, S,
                             H);
  if (dtype == kBF16)
    return launch_tc<P, N>(static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(bm),
                           static_cast<const bf16*>(cm), static_cast<bf16*>(y), h, s, B, S, H);
  return cudaErrorInvalidValue;
}

cudaError_t by_widths(int P, int N, int dtype, const void* x, const float* dt, const float* a,
                      const void* bm, const void* cm, void* y, float* h, cudaStream_t s,
                      int B, int S, int H) {
  if (P == 64 && N == 64) return by_dtype<64, 64>(dtype, x, dt, a, bm, cm, y, h, s, B, S, H);
  if (P == 64 && N == 128) return by_dtype<64, 128>(dtype, x, dt, a, bm, cm, y, h, s, B, S, H);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a, const void* bm,
                               const void* cm, void* y, void* h, void* stream, int B, int S,
                               int H, int P, int N, int dtype) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  return (int)by_widths(P, N, dtype, x, static_cast<const float*>(dt),
                        static_cast<const float*>(a), bm, cm, y, static_cast<float*>(h),
                        static_cast<cudaStream_t>(stream), B, S, H);
}
