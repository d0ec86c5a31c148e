// Flash attention forward (prefill) for Hopper (sm_90a).
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py:69):
// GQA attention, query head h reads KV head h / G, with causal, sliding-window
// and per-row key-length masks and an online softmax in fp32. Layouts are the
// reference's: q (B, Sq, H, hd), k and v (B, Skv, KV, hd), out like q.
//
// What bounds it: at B=8, S=512, H=32, KV=8, hd=128 in bf16 the least time is
// set by the bytes (q, k, v and out read or written once: ~80 MB, 24 us at
// 3.35 TB/s) more than by the causal FLOPs (~16 GFLOP, 16 us at the 989
// TFLOP/s bf16 tensor-core peak). Both products therefore have to run on the
// tensor cores, fed by copies that overlap them.
//
// bf16: flash_fwd_sm90, a warp-specialised wgmma kernel.
//  * A block owns 128 query rows of one (batch row, head): 384 threads, two
//    consumer warpgroups of 64 rows each and one producer warpgroup whose
//    first thread issues every load; setmaxnreg moves registers from the
//    producer (24) to the consumers (240).
//  * TMA brings the Q tile once and K and V in tiles of 64 keys (hd = 128) or
//    128 keys (hd <= 64) into a 2-stage ring in shared memory, through 4-D
//    tensor maps over (B, S, heads, hd) with the 128-byte swizzle that wgmma
//    reads (64-byte at hd = 32, whose rows are 64 bytes). Rows past S arrive
//    as zeros. mbarriers say "full" (transaction bytes) and "empty" (one
//    arrival per consumer warp).
//  * S = Q K^T is wgmma m64nBNk16 with Q and K from shared memory and fp32
//    accumulators in registers. The online softmax runs on those fragments:
//    each row lives in the 4 threads of a quad, so its max and sum take two
//    shuffles, and exp2 carries the scale folded with log2(e). There is no
//    score buffer in shared memory and no block-wide barrier per tile.
//  * P is rounded to bf16 in registers and O += P V is wgmma m64nHDk16 with
//    A from registers and V from shared memory as the transposed B operand.
//    The plain version keeps P in fp32; rounding it costs ~1e-3 at unit-scale
//    V, inside the bf16 tolerance of 2e-2.
//  * Query tiles run from the last to the first, so the longest causal rows
//    start first. Tiles that every row of the block masks (past the key
//    length, above the diagonal, before the window) are not loaded; a
//    warpgroup whose 64 rows all mask a loaded tile skips its products; only
//    tiles that cross an edge (diagonal, key length, window start) evaluate
//    the mask.
//  * O is divided by l and rounded to bf16 once and written from registers;
//    query rows >= Sq are not written.
//
// fp32 (tiny-lm only, off the main path): flash_fwd_simt, both products on
// the CUDA cores in fp32 from shared memory, 64 query rows by 32-key tiles.
// This is a branch on dtype, not a fall-back: TF32 would miss the fp32
// tolerance of 2e-5 and wgmma has no fp32 inputs. No failure of the bf16
// kernel ever routes here.
//
// Both kernels keep the TPU kernel's masks: a key counts only if
// kp < min(kv_len[b], Skv), and also kp <= qp when causal and qp - kp < window
// when window > 0; masked scores are filled with -1e30. A row with no valid
// key at all gets 0 here, where the plain version averages V; the serving
// path never asks for one.
#include "common.cuh"
#include "sm90.cuh"

using namespace repro;
using namespace repro::sm90;

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- bf16, sm90
constexpr int kBM = 128;       // query rows per block
constexpr int kThreads = 384;  // warpgroups 0-1 consume, warpgroup 2 produces
constexpr int kStages = 2;     // K/V tiles in the shared-memory ring

template <int HD>
struct Tile {
  static constexpr int BN = HD == 128 ? 64 : 128;  // keys per KV tile
  static constexpr int SWZ = HD >= 64 ? 128 : 64;  // bytes per shared-memory row
  static constexpr int PW = SWZ / 2;               // columns per panel
  static constexpr int NP = HD / PW;               // column panels of a tile
  static constexpr int Q_BYTES = kBM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (3 * kStages + 1) * 8 + 1024;  // + slack to align to 1 KB
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_len,
               __nv_bfloat16* __restrict__ o, int B, int Sq, int Skv, int H, int KV, int causal,
               int window, float scale_log2) {
  using T = Tile<HD>;
  constexpr int BN = T::BN, SWZ = T::SWZ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;                    // [NP][kBM][PW]
  uint8_t* Ks = smem + T::Q_BYTES;             // [kStages][NP][BN][PW]
  uint8_t* Vs = Ks + kStages * T::KV_BYTES;    // [kStages][NP][BN][PW]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* k_full = q_full + 1;               // [kStages]
  uint64_t* v_full = k_full + kStages;         // [kStages]
  uint64_t* empty = v_full + kStages;          // [kStages]

  const int n_q = (Sq + kBM - 1) / kBM;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_q - 1 - blockIdx.x / (B * H)) * kBM;  // last query tile first
  const int h = bh % H, b = bh / H;
  const int g = h / (H / KV);
  const int len = min(kv_len[b], Skv);
  int kv_end = len;
  if (causal) kv_end = min(kv_end, q0 + kBM);
  const int kv_begin = window ? max(0, q0 - window + 1) / BN * BN : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 8);  // lane 0 of each of the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    reg_dealloc<24>();
    if (threadIdx.x == 256 && n_tiles > 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int p = 0; p < T::NP; ++p)
        tma_load_4d(Qs + p * kBM * SWZ, &tm_q, q_full, p * T::PW, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + s, (j / kStages - 1) & 1);
        const int kv0 = kv_begin + j * BN;
        mbar_expect_tx(k_full + s, T::KV_BYTES);
#pragma unroll
        for (int p = 0; p < T::NP; ++p)
          tma_load_4d(Ks + s * T::KV_BYTES + p * BN * SWZ, &tm_k, k_full + s, p * T::PW, g, kv0, b);
        mbar_expect_tx(v_full + s, T::KV_BYTES);
#pragma unroll
        for (int p = 0; p < T::NP; ++p)
          tma_load_4d(Vs + s * T::KV_BYTES + p * BN * SWZ, &tm_v, v_full + s, p * T::PW, g, kv0, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows qlo .. qlo + 63
    reg_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int qlo = q0 + 64 * wg;
    const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0 and r0 + 8
    const int cq = 2 * (lane % 4);        // and columns cq, cq + 1 of each 8
    const uint8_t* Qw = Qs + 64 * wg * SWZ;

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    if (n_tiles > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages, par = (j / kStages) & 1;
      const int kv0 = kv_begin + j * BN;
      const bool skip = qlo >= Sq || (causal && kv0 > qlo + 63) ||
                        (window && kv0 + BN - 1 <= qlo - window);
      mbar_wait(k_full + s, par);
      if (!skip) {
        const uint8_t* Kt = Ks + s * T::KV_BYTES;
        float sacc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
        fence_regs(sacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int p = kk * 16 / T::PW, off = (kk * 16 % T::PW) * 2;
          wgmma_ss<BN>(sacc, gmma_desc<SWZ>(Qw + p * kBM * SWZ + off, 16),
                       gmma_desc<SWZ>(Kt + p * BN * SWZ + off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);

        // element i of sacc: row r0 + 8 * ((i >> 1) & 1), key 8 * (i / 4) + cq + (i & 1)
        const bool edge = kv0 + BN > len || (causal && kv0 + BN - 1 > qlo) ||
                          (window && kv0 <= qlo + 63 - window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            const int qp = qlo + r0 + ((i & 2) ? 8 : 0);
            const int kp = kv0 + 8 * (i / 4) + cq + (i & 1);
            bool ok = kp < len;
            if (causal) ok = ok && kp <= qp;
            if (window) ok = ok && qp - kp < window;
            if (!ok) sacc[i] = kNegInf;
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          if (i & 2) mx1 = fmaxf(mx1, sacc[i]);
          else mx0 = fmaxf(mx0, sacc[i]);
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        // a row that has seen no valid key yet keeps p = 0, l = 0 and O = 0
        const float ms0 = mx0 == kNegInf ? 0.f : mx0 * scale_log2;
        const float ms1 = mx1 == kNegInf ? 0.f : mx1 * scale_log2;
        const float a0 = ex2(m0 * scale_log2 - ms0), a1 = ex2(m1 * scale_log2 - ms1);
        m0 = mx0;
        m1 = mx1;
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const float pv = ex2(fmaf(sacc[i], scale_log2, (i & 2) ? -ms1 : -ms0));
          sacc[i] = pv;
          if (i & 2) l1 += pv;
          else l0 += pv;
        }
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) oacc[i] *= (i & 2) ? a1 : a0;
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int t = 0; t < 4; ++t) pa[kk][t] = pack_bf16(sacc[8 * kk + 2 * t], sacc[8 * kk + 2 * t + 1]);

        mbar_wait(v_full + s, par);
        const uint8_t* Vt = Vs + s * T::KV_BYTES;
        fence_regs(oacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<HD>(oacc, pa[kk], gmma_desc<SWZ>(Vt + kk * 16 * SWZ, BN * SWZ), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
      } else {
        mbar_wait(v_full + s, par);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qp = qlo + r0 + 8 * half;
      const float l = half ? l1 : l0;
      if (qp >= Sq) continue;
      __nv_bfloat16* row = o + ((size_t)(b * Sq + qp) * H + h) * HD;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        const float x0 = oacc[4 * jn + 2 * half], x1 = oacc[4 * jn + 2 * half + 1];
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * jn + cq) =
            l > 0.f ? __floats2bfloat162_rn(x0 / l, x1 / l) : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  }
}

template <int HD>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                        cudaStream_t stream, int B, int Sq, int Skv, int H, int KV, int causal,
                        int window, float scale) {
  using T = Tile<HD>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = bshd_map(&mq, q, B, Sq, H, HD, kBM, T::SWZ);
  if (err == cudaSuccess) err = bshd_map(&mk, k, B, Skv, KV, HD, T::BN, T::SWZ);
  if (err == cudaSuccess) err = bshd_map(&mv, v, B, Skv, KV, HD, T::BN, T::SWZ);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_sm90<HD>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const int n_q = (Sq + kBM - 1) / kBM;
  kern<<<n_q * B * H, kThreads, T::SMEM, stream>>>(mq, mk, mv, kv_len,
                                                    static_cast<__nv_bfloat16*>(o), B, Sq, Skv,
                                                    H, KV, causal, window,
                                                    scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- fp32, SIMT
namespace simt {

constexpr int kBQ = 64;
constexpr int kBKV = 32;
constexpr int kThreads = 256;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (HD + 1) + kBKV * (HD + 1) + kBKV * HD + kBQ * (kBKV + 1) +
                          3 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
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

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   cudaStream_t stream, int B, int Sq, int Skv, int H, int KV, int causal,
                   int window, float scale) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_simt<float, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), kv_len,
                                         static_cast<float*>(o), Sq, Skv, H, KV, causal, window,
                                         scale);
  return cudaGetLastError();
}

}  // namespace simt

cudaError_t by_head_dim(int dtype, int hd, const void* q, const void* k, const void* v,
                        const int* kv_len, void* o, cudaStream_t s, int B, int Sq, int Skv, int H,
                        int KV, int causal, int window, float scale) {
#define FLASH_ARGS q, k, v, kv_len, o, s, B, Sq, Skv, H, KV, causal, window, scale
  if (dtype == kBF16) {
    switch (hd) {
      case 32: return launch_sm90<32>(FLASH_ARGS);
      case 64: return launch_sm90<64>(FLASH_ARGS);
      case 128: return launch_sm90<128>(FLASH_ARGS);
    }
  } else if (dtype == kF32) {
    switch (hd) {
      case 32: return simt::launch<32>(FLASH_ARGS);
      case 64: return simt::launch<64>(FLASH_ARGS);
      case 128: return simt::launch<128>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* o, void* stream, int B, int Sq,
                                      int Skv, int H, int KV, int hd, int causal, int window,
                                      int dtype, float scale) {
  if (B < 1 || Sq < 1 || KV < 1 || H % KV != 0) return (int)cudaErrorInvalidValue;
  return (int)by_head_dim(dtype, hd, q, k, v, static_cast<const int*>(kv_len), o,
                          static_cast<cudaStream_t>(stream), B, Sq, Skv, H, KV, causal, window,
                          scale);
}
