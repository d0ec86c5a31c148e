// Fused ProD predictor head for Hopper (sm_90a).
//
// Replaces prod_head_pallas (src/repro/kernels/prod_head.py:61): relu(phi W1 +
// b1) W2 + b2 -> softmax over K bins -> CDF -> for each CDF level q the first
// bin with cdf >= q (clamped to K-1) and in-bin linear interpolation with
// cdf_prev = cdf_k - p_k. fp32 throughout: TF32 would miss the probs
// tolerance of 1e-6.
//
// What bounds it on the H100: at serving batch (B = 8) reading W1 (d x hidden
// fp32, 8.4 MB at d = 4096, hidden = 512: 2.5 us at 3.35 TB/s); at B = 512 the
// 2.2 GFLOP of phi W1 (32 us at the 67 TFLOP/s fp32 peak). The TPU kernel
// keeps all of W1 resident in VMEM; it does not fit a block's shared memory,
// so the read of W1 is spread over the whole card instead:
//
//  * The partial sums of phi W1, grid (column tiles of hidden, d-splits, row
//    tiles of phi). plan() picks the d-split so that the grid holds at least
//    two blocks per SM of the current device (its SM count is read once):
//    on the H100's 132 SMs at B = 8, 256 blocks at d = 4096 and 2048 and 192
//    at d = 768. Each block writes its sums for its rows, columns and d-slice
//    to a scratch (n_splits, B, hidden) that the wrapper allocates.
//  * B <= 32 (prod_head_small, one launch): tiles of 8 rows x 32 columns.
//    Each thread keeps 8 float4 loads of W1 in flight (64 KB per SM) and
//    owns an 8 x 4 register tile of its d-rows; the block's 32 d-lanes meet
//    in shared memory in order. The last block of a tile to finish (a
//    counter per tile; __threadfence before each count) sums the tile's d-splits in split order, adds b1, applies relu
//    and multiplies by its 32 rows of W2; the last column tile of a row
//    tile then sums the tiles' logits in order, adds b2 and gives one warp
//    to each row for the outputs. At this size the head is latency-bound:
//    one launch and no pass over the card after the partial sums.
//  * B > 32 (prod_head_tiled, then prod_head_epilogue): tiles of 128 rows x
//    128 columns, an 8 x 8 register tile per thread, phi^T and W1 staged in
//    a 2-stage shared-memory ring (W1 with 16-byte cp.async), so W1 is read
//    from L2 once per row tile. A second launch, 4 rows a block, sums the
//    d-splits in order (16 MB at B = 512: the whole card's work, not a last
//    block's), adds b1, applies relu, multiplies by W2 (the hidden units
//    split over thread groups that meet in a fixed order), adds b2 and gives
//    one warp to each row.
//  * A row's outputs (row_outputs): softmax, a sequential cumsum, then for
//    every level the first bin with cdf >= q, found 32 bins at a time, and
//    the in-bin interpolation. K <= 128 (64 on the main path).
//  No float atomics anywhere: which block finishes last changes no sum, so
//  two calls give bit-identical outputs. The block that brings a counter to
//  its total sets it back to 0, so the counters are zero after every launch
//  and the wrapper zeroes them only once, when it makes them.
//
// The d-split makes the phi W1 sums short chains (at d = 4096, B = 8: 8
// products per thread, 32 d-lanes, 16 splits), which keeps the probs' error
// against an fp64 head at or below that of cuBLAS' fp32 product.
#include <stdint.h>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kGranule = 32;          // a d-slice is a multiple of this many rows
constexpr int kMaxK = 128;
constexpr int kRB = 4;                // rows per block of prod_head_epilogue
constexpr int kSmallB = 32;           // up to here, tiles of 8 rows
constexpr int kDefaultSmem = 48 << 10;  // dynamic shared memory a launch gets unasked

int round_up(int a, int b) { return ceil_div(a, b) * b; }

struct Plan {
  int rows, cols;              // tile of the hidden stage
  int row_tiles, col_tiles;
  int n_splits, ds;            // d-splits and the d-rows of each
};

Plan plan(int B, int d, int hidden) {
  Plan p;
  p.rows = B <= kSmallB ? 8 : 128;
  p.cols = B <= kSmallB ? 32 : 128;
  p.row_tiles = ceil_div(B, p.rows);
  p.col_tiles = ceil_div(hidden, p.cols);
  const int want = ceil_div(2 * sm_count(), p.row_tiles * p.col_tiles);  // 2 blocks per SM
  p.n_splits = ceil_div(d, round_up(ceil_div(d, want), kGranule));
  p.ds = round_up(ceil_div(d, p.n_splits), kGranule);  // every split holds some of d
  return p;
}

template <typename T>
__device__ __forceinline__ float load_phi(const T* phi, int B, int d, int r, int c) {
  return (r < B && c < d) ? to_f32(phi[(size_t)r * d + c]) : 0.f;
}

// ---- partial sums, B <= 32: 8 rows x 32 columns x one d-slice. Thread
// (dl = tid / 8, cg = tid % 8) takes columns 4cg .. 4cg+3 and the d-rows
// dl, dl + 32, ... of each 256-row chunk of the slice.
template <typename T>
__device__ void partial_rows8(float* sm, const T* __restrict__ phi, const float* __restrict__ w1,
                              float* __restrict__ partial, int B, int d, int hidden, int ds) {
  constexpr int R = 8, C = 32, LANES = 32, CH = 256, NL = CH / LANES;
  float(*phis)[CH] = reinterpret_cast<float(*)[CH]>(sm);                  // [R][CH]
  float(*red)[R][C] = reinterpret_cast<float(*)[R][C]>(sm + R * CH);      // [LANES][R][C]
  const int tid = threadIdx.x, cg = tid % 8, dl = tid / 8;
  const int col0 = blockIdx.x * C, split = blockIdx.y, row0 = blockIdx.z * R;
  const int d0 = split * ds, d1 = min(d, d0 + ds);
  const int col = col0 + 4 * cg;

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int dc = d0; dc < d1; dc += CH) {
    float4 w[NL];
#pragma unroll
    for (int t = 0; t < NL; ++t) {  // the thread's W1 loads, all in flight at once
      const int kd = dc + dl + LANES * t;
      w[t] = (col < hidden && kd < d1)
                 ? __ldg(reinterpret_cast<const float4*>(w1 + (size_t)kd * hidden + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < R * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      phis[r][c] = dc + c < d1 ? load_phi(phi, B, d, row0 + r, dc + c) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < NL; ++t) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = phis[r][dl + LANES * t];
        acc[r][0] = fmaf(x, w[t].x, acc[r][0]);
        acc[r][1] = fmaf(x, w[t].y, acc[r][1]);
        acc[r][2] = fmaf(x, w[t].z, acc[r][2]);
        acc[r][3] = fmaf(x, w[t].w, acc[r][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float4*>(&red[dl][r][4 * cg]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  const int r = tid / C, c = tid % C;  // one output per thread, lanes summed in order
  if (row0 + r < B && col0 + c < hidden) {
    float s = 0.f;
#pragma unroll 8
    for (int l = 0; l < LANES; ++l) s += red[l][r][c];
    partial[((size_t)split * B + row0 + r) * hidden + col0 + c] = s;
  }
}

// ---- partial sums, B > 32: 128 rows x 128 columns x one d-slice. Thread
// (rg = tid / 16, cg = tid % 16) owns rows {4rg, 64 + 4rg} + 0..3 and columns
// {4cg, 64 + 4cg} + 0..3; phi^T and W1 pass through a 2-stage ring of
// 16-deep chunks.
template <typename T>
__device__ void partial_tiled(float* sm, const T* __restrict__ phi, const float* __restrict__ w1,
                              float* __restrict__ partial, int B, int d, int hidden, int ds) {
  constexpr int R = 128, C = 128, KC = 16, PS = R + 4;
  float(*phit)[KC][PS] = reinterpret_cast<float(*)[KC][PS]>(sm);             // [2][KC][PS]
  float(*w1s)[KC][C] = reinterpret_cast<float(*)[KC][C]>(sm + 2 * KC * PS);  // [2][KC][C]
  const int tid = threadIdx.x, cg = tid % 16, rg = tid / 16;
  const int col0 = blockIdx.x * C, split = blockIdx.y, row0 = blockIdx.z * R;
  const int d0 = split * ds, d1 = min(d, d0 + ds);
  const int n = d1 > d0 ? ceil_div(d1 - d0, KC) : 0;

  auto load_w1 = [&](int stage, int dc) {  // 16-byte cp.async, zeros past the edges
#pragma unroll
    for (int i = 0; i < KC * C / 4 / kThreads; ++i) {
      const int idx = tid + i * kThreads, kk = idx / (C / 4), c4 = idx % (C / 4);
      const int kd = dc + kk, col = col0 + 4 * c4;
      const bool ok = kd < d1 && col < hidden;
      const float* src = ok ? w1 + (size_t)kd * hidden + col : w1;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&w1s[stage][kk][4 * c4]));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                   "r"(ok ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  constexpr int NX = R * KC / kThreads;
  auto load_phi_chunk = [&](int dc, float (&x)[NX]) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int idx = tid + i * kThreads, r = idx / KC, kk = idx % KC;
      x[i] = dc + kk < d1 ? load_phi(phi, B, d, row0 + r, dc + kk) : 0.f;
    }
  };
  auto store_phi_chunk = [&](int stage, const float (&x)[NX]) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int idx = tid + i * kThreads;
      phit[stage][idx % KC][idx / KC] = x[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float x[NX];
  if (n > 0) {
    load_w1(0, d0);
    load_phi_chunk(d0, x);
    store_phi_chunk(0, x);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }
  for (int it = 0; it < n; ++it) {
    const int s = it & 1;
    const bool more = it + 1 < n;
    if (more) {  // the next chunk's loads overlap this chunk's products
      load_w1(s ^ 1, d0 + (it + 1) * KC);
      load_phi_chunk(d0 + (it + 1) * KC, x);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&phit[s][kk][4 * rg]);
      const float4 a1 = *reinterpret_cast<const float4*>(&phit[s][kk][64 + 4 * rg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&w1s[s][kk][4 * cg]);
      const float4 b1 = *reinterpret_cast<const float4*>(&w1s[s][kk][64 + 4 * cg]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store_phi_chunk(s ^ 1, x);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * rg + i : 64 + 4 * rg + i - 4);
    if (row >= B) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = col0 + 64 * h + 4 * cg;
      if (col < hidden)
        *reinterpret_cast<float4*>(partial + ((size_t)split * B + row) * hidden + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// Softmax over the K logits in p (one warp, one row), then the CDF by a
// sequential cumsum and, for every level, the first bin with cdf >= q (the
// warp tests 32 bins at a time) and the in-bin interpolation. p and cdf are
// the warp's own K floats of shared memory.
__device__ void row_outputs(float* p, float* cdf, const float* __restrict__ edges,
                            const float* __restrict__ qs, float* __restrict__ probs,
                            float* __restrict__ quants, int K, int Q) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, p[k]);
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
    probs[k] = pk;
  }
  __syncwarp();
  if (lane == 0) {
    float c = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      c += p[k];
      cdf[k] = c;
    }
  }
  __syncwarp();
  for (int qi = 0; qi < Q; ++qi) {
    const float qv = qs[qi];
    int ks = K - 1;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const unsigned hit = __ballot_sync(0xffffffffu, k0 + lane < K && cdf[k0 + lane] >= qv);
      if (hit) {
        ks = k0 + __ffs(hit) - 1;
        break;
      }
    }
    if (lane == 0) {
      const float pk = p[ks];
      const float prev = cdf[ks] - pk;
      const float t = fminf(fmaxf((qv - prev) / fmaxf(pk, 1e-12f), 0.f), 1.f);
      const float left = edges[ks], right = edges[ks + 1];
      quants[qi] = left + t * (right - left);
    }
  }
}

// True in the block that brings the counter to `total`, after every other
// block's writes are visible to it. That block sets the counter back to 0
// for the next launch: no other block touches it again in this one.
__device__ bool last_arrival(int* counter, int total) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == total - 1;
    if (is_last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// B <= 32, one launch: the partial sums, then in the last d-split block of
// each (row tile, column tile) the tile's share of the logits, then in the
// last column tile of each row tile the outputs of its 8 rows.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
prod_head_small(const T* __restrict__ phi, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ edges,
                const float* __restrict__ qs, float* __restrict__ partial,
                float* __restrict__ logits, int* __restrict__ counters,
                float* __restrict__ probs, float* __restrict__ quants,
                int B, int d, int hidden, int K, int Q, int ds) {
  constexpr int R = 8, C = 32;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  partial_rows8<T>(sm, phi, w1, partial, B, d, hidden, ds);
  const int n_col = gridDim.x, n_splits = gridDim.y, rt = blockIdx.z;
  if (!last_arrival(counters + rt * n_col + blockIdx.x, n_splits)) return;

  // h = relu(sum of the d-splits in order + b1) for the tile's 8 x 32 units
  float(*hs)[C] = reinterpret_cast<float(*)[C]>(sm);
  const int tid = threadIdx.x, col0 = blockIdx.x * C, row0 = rt * R;
  {
    const int r = tid / C, c = tid % C, row = row0 + r, col = col0 + c;
    float s = 0.f;
    if (row < B && col < hidden) {
#pragma unroll 16
      for (int j = 0; j < n_splits; ++j) s += __ldcg(partial + ((size_t)j * B + row) * hidden + col);
      s = fmaxf(s + b1[col], 0.f);
    }
    hs[r][c] = s;
  }
  __syncthreads();
  // the tile's share of the logits, h_tile W2[tile, :]: rows r and r + 4
  const int n_cols = min(C, hidden - col0);
  for (int i = tid; i < (R / 2) * K; i += kThreads) {
    const int r = i / K, k = i % K;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll 32
    for (int c = 0; c < n_cols; ++c) {
      const float w = __ldg(w2 + (size_t)(col0 + c) * K + k);
      s0 = fmaf(hs[r][c], w, s0);
      s1 = fmaf(hs[r + R / 2][c], w, s1);
    }
    if (row0 + r < B) logits[((size_t)(row0 + r) * n_col + blockIdx.x) * K + k] = s0;
    if (row0 + r + R / 2 < B) logits[((size_t)(row0 + r + R / 2) * n_col + blockIdx.x) * K + k] = s1;
  }
  if (!last_arrival(counters + gridDim.z * n_col + rt, n_col)) return;

  // one warp per row: logits = the column tiles' shares in order + b2
  const int warp = tid >> 5, lane = tid & 31, b = row0 + warp;
  if (b >= B) return;
  float* p = sm + 2 * kMaxK * warp;
  for (int k = lane; k < K; k += 32) {
    float s = 0.f;
#pragma unroll 16
    for (int j = 0; j < n_col; ++j) s += __ldcg(logits + ((size_t)b * n_col + j) * K + k);
    p[k] = s + b2[k];
  }
  __syncwarp();
  row_outputs(p, p + kMaxK, edges, qs, probs + (size_t)b * K, quants + (size_t)b * Q, K, Q);
}

// B > 32, launch 1: the partial sums of 128 x 128 tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
prod_head_tiled(const T* __restrict__ phi, const float* __restrict__ w1,
                float* __restrict__ partial, int B, int d, int hidden, int ds) {
  extern __shared__ float4 smem4[];
  partial_tiled<T>(reinterpret_cast<float*>(smem4), phi, w1, partial, B, d, hidden, ds);
}

// B > 32, launch 2: kRB rows per block. The d-splits are summed in split
// order, then relu(. + b1); the hidden units are split over G thread groups
// for the product with W2 (each thread four bins at a time) and the groups
// meet in order; one warp per row then gives the outputs.
__global__ void __launch_bounds__(kThreads)
prod_head_epilogue(const float* __restrict__ partial, const float* __restrict__ b1,
                   const float* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ edges, const float* __restrict__ qs,
                   float* __restrict__ probs, float* __restrict__ quants,
                   int B, int n_splits, int hidden, int K, int Q, int w2_vec) {
  extern __shared__ float4 esm4[];
  float* hs = reinterpret_cast<float*>(esm4);                   // [kRB][hidden]
  float4* red = esm4 + kRB * hidden / 4;                         // [G][kRB][K4]
  float* rows = reinterpret_cast<float*>(red + kThreads * kRB);  // [kRB][2][kMaxK]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRB;
  const int h4 = hidden / 4;

  for (int i0 = tid; i0 < kRB * h4; i0 += 2 * kThreads) {
    float4 s[2];
#pragma unroll
    for (int o = 0; o < 2; ++o) s[o] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < n_splits; ++j) {
#pragma unroll
      for (int o = 0; o < 2; ++o) {  // both outputs' loads in flight together
        const int i = i0 + o * kThreads, row = row0 + i / h4;
        if (i < kRB * h4 && row < B) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              partial + ((size_t)j * B + row) * hidden + 4 * (i % h4)));
          s[o].x += v.x;
          s[o].y += v.y;
          s[o].z += v.z;
          s[o].w += v.w;
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int i = i0 + o * kThreads;
      if (i >= kRB * h4) continue;
      const int c = 4 * (i % h4);
      float* h = hs + (i / h4) * hidden + c;
      h[0] = fmaxf(s[o].x + b1[c], 0.f);
      h[1] = fmaxf(s[o].y + b1[c + 1], 0.f);
      h[2] = fmaxf(s[o].z + b1[c + 2], 0.f);
      h[3] = fmaxf(s[o].w + b1[c + 3], 0.f);
    }
  }
  __syncthreads();

  const int K4 = (K + 3) / 4, G = kThreads / K4;
  if (tid < G * K4) {
    const int kq = tid % K4, g = tid / K4, k0 = 4 * kq;
    float4 acc[kRB];
#pragma unroll
    for (int r = 0; r < kRB; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int c = g; c < hidden; c += G) {
      const float* w = w2 + (size_t)c * K + k0;
      const float4 wv = w2_vec ? __ldg(reinterpret_cast<const float4*>(w))
                               : make_float4(__ldg(w), k0 + 1 < K ? __ldg(w + 1) : 0.f,
                                             k0 + 2 < K ? __ldg(w + 2) : 0.f,
                                             k0 + 3 < K ? __ldg(w + 3) : 0.f);
#pragma unroll
      for (int r = 0; r < kRB; ++r) {
        const float x = hs[r * hidden + c];
        acc[r].x = fmaf(x, wv.x, acc[r].x);
        acc[r].y = fmaf(x, wv.y, acc[r].y);
        acc[r].z = fmaf(x, wv.z, acc[r].z);
        acc[r].w = fmaf(x, wv.w, acc[r].w);
      }
    }
#pragma unroll
    for (int r = 0; r < kRB; ++r) red[(g * kRB + r) * K4 + kq] = acc[r];
  }
  __syncthreads();

  const int b = row0 + warp;
  if (warp >= kRB || b >= B) return;
  const float* redf = reinterpret_cast<const float*>(red);
  float* p = rows + 2 * kMaxK * warp;
  for (int k = lane; k < K; k += 32) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += redf[(g * kRB + warp) * 4 * K4 + k];
    p[k] = s + b2[k];
  }
  __syncwarp();
  row_outputs(p, p + kMaxK, edges, qs, probs + (size_t)b * K, quants + (size_t)b * Q, K, Q);
}

template <typename T>
cudaError_t launch(const void* phi_, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* edges, const float* qs, float* scratch,
                   int* counters, float* probs, float* quants, cudaStream_t stream, int B, int d,
                   int hidden, int K, int Q) {
  const Plan p = plan(B, d, hidden);
  const T* phi = static_cast<const T*>(phi_);
  const dim3 grid(p.col_tiles, p.n_splits, p.row_tiles);
  cudaError_t err;
  if (p.rows == 8) {
    constexpr int smem = (int)sizeof(float) * (8 * 256 + 32 * 8 * 32);
    static_assert(smem <= kDefaultSmem, "prod_head_small: raise its shared-memory limit");
    float* logits = scratch + (size_t)p.n_splits * B * hidden;
    prod_head_small<T><<<grid, kThreads, smem, stream>>>(phi, w1, b1, w2, b2, edges, qs, scratch,
                                                         logits, counters, probs, quants, B, d,
                                                         hidden, K, Q, p.ds);
    return cudaGetLastError();
  }
  constexpr int smem = (int)sizeof(float) * (2 * 16 * (128 + 4) + 2 * 16 * 128);
  static_assert(smem <= kDefaultSmem, "prod_head_tiled: raise its shared-memory limit");
  prod_head_tiled<T><<<grid, kThreads, smem, stream>>>(phi, w1, scratch, B, d, hidden, p.ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int esmem = (int)sizeof(float) * (kRB * hidden + 4 * kThreads * kRB + 2 * kRB * kMaxK);
  if (esmem > kDefaultSmem) {  // hidden > 1024
    err = cudaFuncSetAttribute(prod_head_epilogue, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               esmem);
    if (err != cudaSuccess) return err;
  }
  const int w2_vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  prod_head_epilogue<<<ceil_div(B, kRB), kThreads, esmem, stream>>>(
      scratch, b1, w2, b2, edges, qs, probs, quants, B, p.n_splits, hidden, K, Q, w2_vec);
  return cudaGetLastError();
}

}  // namespace

// What the wrapper allocates: the fp32 scratch (the d-splits' partial sums,
// then for B <= 32 the column tiles' shares of the logits) and the int32
// counters of the last-block-done steps, which must be zero at the first
// launch and are zero again after each.
extern "C" long long prod_head_scratch_floats(int B, int d, int hidden, int K) {
  const Plan p = plan(B, d, hidden);
  return (long long)p.n_splits * B * hidden + (p.rows == 8 ? (long long)B * p.col_tiles * K : 0);
}

extern "C" int prod_head_counters(int B, int d, int hidden) {
  const Plan p = plan(B, d, hidden);
  return p.row_tiles * (p.col_tiles + 1);
}

extern "C" int prod_head_launch(const void* phi, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* edges,
                                const void* qs, void* scratch, void* counters, void* probs,
                                void* quants, void* stream, int B, int d, int hidden, int K, int Q,
                                int phi_dtype) {
  if (hidden % kGranule != 0 || K > kMaxK || K < 1 || B < 1 || d < 1 ||
      reinterpret_cast<uintptr_t>(w1) % 16 != 0 || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto f = [&](auto tag) {
    using T = decltype(tag);
    return launch<T>(phi, static_cast<const float*>(w1), static_cast<const float*>(b1),
                     static_cast<const float*>(w2), static_cast<const float*>(b2),
                     static_cast<const float*>(edges), static_cast<const float*>(qs),
                     static_cast<float*>(scratch), static_cast<int*>(counters),
                     static_cast<float*>(probs), static_cast<float*>(quants),
                     static_cast<cudaStream_t>(stream), B, d, hidden, K, Q);
  };
  if (phi_dtype == kF32) return (int)f(float{});
  if (phi_dtype == kBF16) return (int)f(__nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}
