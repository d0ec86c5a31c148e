// The unembed's product for Hopper (sm_90a): fp32 logits = x (M, K) w (K, N),
// x and w bf16.
//
// Replaces no TPU kernel: the reference computes x.float() @ w.float()
// (src/repro/models/layers.py:135-138) and leaves it to XLA. On the H100 that
// product, written the same way, casts the whole head to fp32 on every call
// and runs an fp32 GEMM outside the tensor cores: 12 ms a decode step at
// M = 512, d = 3,584, V = 152,064. The product of two bf16 values is exact in
// fp32, so the same sums can be taken on the tensor cores from the bf16 head.
//
// What bounds it: at M = 512 the FLOPs (558 GFLOP, 0.56 ms at 989 TFLOP/s);
// at M <= 128 the bytes, which are the bf16 head read once (1.09 GB, 0.33 ms
// at 3.35 TB/s) and the fp32 logits written once.
//
// Design:
//  * Persistent blocks, one an SM, walk 128-column tiles of the output (64
//    rows with one consumer warpgroup where M <= 64, else 128 with two); the
//    tiles of one column block are neighbours in the walk, so the blocks that
//    share a slab of the head read it while it is in L2.
//  * One producer thread keeps a ring of stages full with TMA (128-byte
//    swizzle): x's 64-column K slice of the tile's rows, and w's 64 x 128
//    slice, in either layout: an untied head (K, N) is N-contiguous and lands
//    as two 64-column panels (the MN-major B operand); a tied table (N, K) is
//    K-contiguous and lands as 128 rows of 64 (K-major). Rows and columns
//    past the edges arrive as zeros.
//  * Each consumer warpgroup runs wgmma m64n128k16 over a stage's 64 K into a
//    fresh fp32 accumulator, then adds it into the tile's fp32 sums in
//    registers with rounded fp32 adds. The tensor cores' own fp32 sums
//    truncate: accumulated over all of K, as cuBLAS's bf16 GEMM with fp32
//    output does, the largest error against an fp64 product of the same bf16
//    values was 2.1-25x the fp32 GEMM's at M = 8-512 on the cells' widths.
//    Here the truncated part spans 64 terms, and the error is 0.15-1.4x the
//    fp32 GEMM's.
//  * Two such accumulators take turns, so one stage's products run on the
//    tensor cores while the stage before is added. While a wgmma is in
//    flight the code has no divergent branch (the barrier wait polls inside
//    its asm, the arrival is predicated, the loop's two-stage tail is peeled):
//    ptxas otherwise serialises the wgmmas (its warning C7518).
//  * The epilogue writes the fp32 sums from registers (8-byte stores, a full
//    32-byte sector for each quad of a row), masked at M and N, while the
//    producer already loads the next tile's stages.
#include "common.cuh"
#include "sm90.cuh"

using namespace repro;
using namespace repro::sm90;

namespace {

constexpr int kBN = 128;  // output columns per tile
constexpr int kBK = 64;   // K per stage: one 128-byte swizzle row of bf16

template <int NWG>  // consumer warpgroups of 64 rows
struct Cfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);  // + one producer warpgroup
  static constexpr int A_BYTES = BM * kBK * 2;
  static constexpr int B_BYTES = kBK * kBN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = (192 * 1024) / STAGE;  // 6 at 128 rows, 8 at 64
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + slack to align to 1 KB
};

template <int NWG, bool KMAJOR>
__global__ void __launch_bounds__(Cfg<NWG>::THREADS, 1)
unembed_sm90(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
             float* __restrict__ out, int M, int N, int K) {
  using C = Cfg<NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);  // [STAGES]
  uint64_t* empty = full + C::STAGES;                                // [STAGES]

  const int m_tiles = ceil_div(M, C::BM);
  const int tiles = m_tiles * ceil_div(N, kBN);
  const int kb = ceil_div(K, kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: one thread keeps the ring full, across tiles
    if constexpr (NWG > 1) reg_dealloc<24>();
    if (threadIdx.x == 128 * NWG) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * C::BM, n0 = (t / m_tiles) * kBN;
        for (int j = 0; j < kb; ++j, ++it) {
          const int s = it % C::STAGES;
          if (it >= C::STAGES) mbar_wait(empty + s, (it / C::STAGES - 1) & 1);
          uint8_t* As = smem + s * C::STAGE;
          uint8_t* Bs = As + C::A_BYTES;
          mbar_expect_tx(full + s, C::STAGE);
          tma_load_2d(As, &tm_x, full + s, j * kBK, m0);
          if constexpr (KMAJOR) {
            tma_load_2d(Bs, &tm_w, full + s, j * kBK, n0);
          } else {
            tma_load_2d(Bs, &tm_w, full + s, n0, j * kBK);
            tma_load_2d(Bs + kBK * 128, &tm_w, full + s, n0 + 64, j * kBK);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    if constexpr (NWG > 1) reg_alloc<240>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int r0 = 64 * wg + warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8
    const int cq = 2 * (lane % 4);                 // and columns cq, cq + 1 of each 8
    // stage q's products into the fresh accumulator a (one commit group)
    auto start_stage = [&](float (&a)[kBN / 2], int q) {
      const int s = q % C::STAGES;
      mbar_wait_asm(full + s, (q / C::STAGES) & 1);
      const uint8_t* Aw = smem + s * C::STAGE + 64 * wg * 128;
      const uint8_t* Bs = smem + s * C::STAGE + C::A_BYTES;
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = gmma_desc<128>(Aw + kk * 32, 16);
        if constexpr (KMAJOR)
          wgmma_ss<kBN>(a, da, gmma_desc<128>(Bs + kk * 32, 16), kk > 0);
        else
          wgmma_ss_mn128(a, da, gmma_desc<128>(Bs + kk * 16 * 128, kBK * 128), kk > 0);
      }
      wgmma_commit();
    };
    // stage q's products are done: free the stage, add them into sum
    float sum[kBN / 2];
    auto retire = [&](float (&a)[kBN / 2], int q) {
      fence_regs(a);
      mbar_arrive_if(empty + q % C::STAGES, lane == 0);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] += a[i];
    };
    float acc0[kBN / 2], acc1[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc0[i] = acc1[i] = 0.f;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, it += kb) {
      const int m0 = (t % m_tiles) * C::BM, n0 = (t / m_tiles) * kBN;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] = 0.f;
      // two accumulators in turn: a stage's products run on the tensor cores
      // while the stage before is added into sum
      start_stage(acc0, it);
      int j = 0;
      for (; j + 2 < kb; j += 2) {
        start_stage(acc1, it + j + 1);
        wgmma_wait<1>();
        retire(acc0, it + j);
        start_stage(acc0, it + j + 2);
        wgmma_wait<1>();
        retire(acc1, it + j + 1);
      }
      if (j + 1 < kb) {  // two stages left
        start_stage(acc1, it + j + 1);
        wgmma_wait<1>();
        retire(acc0, it + j);
        wgmma_wait<0>();
        retire(acc1, it + j + 1);
      } else {
        wgmma_wait<0>();
        retire(acc0, it + j);
      }
      // element i of sum: row r0 + 8 * ((i >> 1) & 1), column 8 * (i / 4) + cq + (i & 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + r0 + 8 * half;
        if (row >= M) continue;
        float* orow = out + (size_t)row * N;
#pragma unroll
        for (int jn = 0; jn < kBN / 8; ++jn) {
          const int col = n0 + 8 * jn + cq;
          const float v0 = sum[4 * jn + 2 * half], v1 = sum[4 * jn + 2 * half + 1];
          if ((N & 1) == 0) {
            if (col < N) *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
          } else {
            if (col < N) orow[col] = v0;
            if (col + 1 < N) orow[col + 1] = v1;
          }
        }
      }
    }
  }
}

template <int NWG, bool KMAJOR>
cudaError_t launch(const void* x, const void* w, float* out, cudaStream_t stream, int M, int N,
                   int K) {
  using C = Cfg<NWG>;
  CUtensorMap mx, mw;
  cudaError_t err = matrix_map(&mx, x, K, M, (uint64_t)K * 2, kBK, C::BM);
  if (err == cudaSuccess)
    err = KMAJOR ? matrix_map(&mw, w, K, N, (uint64_t)K * 2, kBK, kBN)
                 : matrix_map(&mw, w, N, K, (uint64_t)N * 2, 64, kBK);
  if (err != cudaSuccess) return err;
  auto kern = unembed_sm90<NWG, KMAJOR>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = ceil_div(M, C::BM) * ceil_div(N, kBN), sms = sm_count();
  kern<<<tiles < sms ? tiles : sms, C::THREADS, C::SMEM, stream>>>(mx, mw, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, contiguous; w (K, N) bf16, N-contiguous (w_kmajor = 0: an
// untied head) or K-contiguous (w_kmajor = 1: the transposed view of a
// contiguous (N, K) table); out (M, N) fp32, contiguous.
extern "C" int unembed_launch(const void* x, const void* w, void* out, void* stream, int M,
                              int N, int K, int w_kmajor) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 64)
    return (int)(w_kmajor ? launch<1, true>(x, w, o, st, M, N, K)
                          : launch<1, false>(x, w, o, st, M, N, K));
  return (int)(w_kmajor ? launch<2, true>(x, w, o, st, M, N, K)
                        : launch<2, false>(x, w, o, st, M, N, K));
}
