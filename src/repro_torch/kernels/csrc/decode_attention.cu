// Split-KV flash-decoding for Hopper (sm_90a).
//
// Replaces decode_attention_pallas (src/repro/kernels/decode_attention.py:64):
// one query token per row, q (B, H, hd), against a cache k, v (B, Sc, KV, hd);
// keys at positions >= lengths[b] are masked; the G = H/KV query heads of a
// group share their K/V rows; online softmax in fp32; out (B, H, hd) in q's
// type. A row with no valid key gives 0.
//
// What bounds it: the bytes of the valid K/V prefix (13.9 MB at the Llama-3-8B
// decode shape of chip_smoke.py: B=8, Sc=576, KV=8, hd=128, bf16, ragged
// lengths; 4.2 us at 3.35 TB/s). Per byte it does G multiply-adds for the
// scores and G for P.V (G = 4 at Llama, 1 at Zamba2), far below the ~295
// FLOP per byte where the tensor cores would become the limit, so the
// products run on the CUDA cores: an m16n8k16 tile would be 1/16 to 1/4 full
// with G = 1..4 query rows, and what the kernel must do is keep enough bytes
// in flight, not multiply faster.
//
// The TPU kernel walks the cache along a sequential grid axis and carries
// (m, l, acc) in VMEM. Blocks here run in no order, so the cache is split:
//  * grid (n_splits, head tiles, B*KV). A block attends GT (1, 2, 4 or 8) of
//    the group's G query heads (G > 8: several head tiles) to one chunk of
//    keys. plan() picks n_splits from Sc, B*KV and the SM count: ~3 passes
//    of keys a block, and at least one block per SM; the lengths are never
//    read on the host. A block whose chunk starts past its row's length
//    exits at once. The wrapper asks the library for the plan
//    (decode_attention_plan) and the sizes of its workspace, and passes the
//    plan back to the launch, so the kernel's geometry lives here only.
//  * A thread owns 8 channels of a key row (one 16-byte load of bf16, two of
//    fp32): hd/8 threads a row, 128/(hd/8) rows a block at a time, and U
//    rows per thread in flight (4 in bf16, 2 in fp32), K and V together:
//    16 KB of loads in flight per block. The G dot products are made from
//    the same K registers (q is kept in registers, pre-scaled by
//    log2(e)/sqrt(hd)) and summed over the row's hd/8 lanes by shuffles;
//    each thread keeps an online softmax (m, l) and G x 8 fp32 accumulators
//    for the rows it reads, in registers. P.V uses the same lane mapping.
//  * hd = 168 (Gemma3) is 21 chunks of 8, which divide neither a warp nor a
//    block. There a key row is an aligned group of 8 lanes, 7 of which own
//    24 channels (three 16-byte loads of bf16, six of fp32) and the 8th
//    reads nothing and adds 0 to the group's shuffles: 4 rows a warp, 16 a
//    block, 2 rows a thread in flight in bf16 (1 in fp32), 21 KB a block.
//    A block attends at most 2 heads (GT <= 2) there, which keeps q and
//    the accumulators (2 x 24 x 2 fp32) in registers.
//  * hd = 112 (Kimi-K2) is 14 chunks of 8: the same 8-lane groups, 7 lanes
//    of 16 channels (two 16-byte loads of bf16, four of fp32): 16 rows a
//    block, 2 in flight a thread in bf16 (1 in fp32), 14 KB a block. A
//    block attends at most 4 heads there (s_acc of 8 heads would pass the
//    48 KB of static shared memory), so Kimi's G = 8 runs 2 head tiles.
//  * At the end the block's row groups meet once in shared memory. A block
//    that is its row's only split writes the output. Otherwise it writes its
//    partial (m, l, acc) to the wrapper's fp32 workspace and counts itself
//    in; the last block of its (row, KV head, head tile) combines the splits
//    in split order (so two calls agree bit for bit) and sets the counter
//    back to 0 for the next launch.
#include <algorithm>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSplits = 128;
constexpr int kPassesPerBlock = 3;   // passes of keys a split aims for
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Lanes of a key row (a power of two: the shuffles stay inside it) and
// channels a lane owns: hd/8 lanes of 8 channels, or, where hd/8 is no power
// of two, 8 lanes (7 loading) of hd/7 channels: 16 at hd = 112, 24 at 168.
__host__ __device__ constexpr bool seven_lanes(int hd) { return hd == 112 || hd == 168; }
__host__ __device__ constexpr int row_lanes(int hd) { return seven_lanes(hd) ? 8 : hd / 8; }
__host__ __device__ constexpr int lane_chans(int hd) { return seven_lanes(hd) ? hd / 7 : 8; }

// key rows a thread has in flight: 4 in bf16, 2 in fp32 (16 KB a block);
// 2 and 1 where a lane owns 16 or 24 channels (14 KB at hd = 112, 21 KB at 168)
__host__ __device__ constexpr int rows_in_flight(int hd, int elem_bytes) {
  return (elem_bytes == 2 ? 4 : 2) / (lane_chans(hd) == 8 ? 1 : 2);
}

// Key rows a block reads in one pass.
__host__ __device__ constexpr int rows_per_pass(int hd, int elem_bytes) {
  return kThreads / row_lanes(hd) * rows_in_flight(hd, elem_bytes);
}

// Query heads a block attends at most (the registers of q and the accumulators).
__host__ __device__ constexpr int max_head_tile(int hd) {
  return hd == 168 ? 2 : hd == 112 ? 4 : 8;
}

struct Plan {
  int gt;        // query heads a block attends: G rounded up to a power of two, at most
                 // max_head_tile
  int n_splits;  // splits of the cache
  int chunk;     // keys a split, a whole number of passes
};

// From the shapes and the SM count alone (never the lengths): a split is
// kPassesPerBlock passes of keys, so that a block's fixed costs (q, the
// merge, the partial and the count) are spread over enough loads, but there
// are at least as many blocks as SMs (a short cache over few rows gets
// shorter splits), and at most kMaxSplits splits. A split is a whole number
// of passes, rounded down so that the splits are at least as many as
// planned (rounded up only where that would pass kMaxSplits).
Plan plan(int B, int KV, int G, int Sc, int hd, int elem_bytes) {
  Plan p;
  p.gt = 1;
  while (p.gt < G && p.gt < max_head_tile(hd)) p.gt *= 2;
  const int step = rows_per_pass(hd, elem_bytes);
  const long long tiles = (long long)B * KV * ceil_div(G, p.gt);   // blocks a split
  const int fill = (int)((sm_count() + tiles - 1) / tiles);
  int n = std::max(ceil_div(Sc, kPassesPerBlock * step), fill);
  n = std::max(1, std::min({n, ceil_div(Sc, step), kMaxSplits}));
  const int per = ceil_div(Sc, n);   // keys a split at n splits
  p.chunk = std::max(step, per / step * step);
  if (ceil_div(Sc, p.chunk) > kMaxSplits) p.chunk = ceil_div(per, step) * step;
  p.n_splits = ceil_div(Sc, p.chunk);
  return p;
}

template <int W>
__device__ __forceinline__ void load16(const void* p, uint4 (&r)[W]) {
  const uint4* s = static_cast<const uint4*>(p);
#pragma unroll
  for (int w = 0; w < W; ++w) r[w] = __ldg(s + w);
}

// W 16-byte words to fp32 channels: 8 a word of bf16, 4 of fp32
template <int W>
__device__ __forceinline__ void unpack(const uint4 (&r)[W], float (&f)[8 * W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r[w]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[8 * w + 2 * i] = t.x;
      f[8 * w + 2 * i + 1] = t.y;
    }
  }
}
template <int W>
__device__ __forceinline__ void unpack(const uint4 (&r)[W], float (&f)[4 * W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    f[4 * w] = __uint_as_float(r[w].x);
    f[4 * w + 1] = __uint_as_float(r[w].y);
    f[4 * w + 2] = __uint_as_float(r[w].z);
    f[4 * w + 3] = __uint_as_float(r[w].w);
  }
}

// True in the block that brings the counter to `total`, after every other
// block's writes are visible to it; that block sets the counter back to 0.
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

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const int* __restrict__ lengths, float* __restrict__ part_ml,
           float* __restrict__ part_acc, int* __restrict__ counters, T* __restrict__ out,
           int Sc, int H, int KV, int chunk, float qscale) {
  constexpr int TPR = row_lanes(HD);       // threads per key row
  constexpr int CPL = lane_chans(HD);      // channels a thread
  constexpr int NA = HD / CPL;             // threads of a row that load (TPR, or 7 of 8)
  constexpr int RG = kThreads / TPR;       // key rows a block reads at once
  constexpr int U = rows_in_flight(HD, sizeof(T));
  constexpr int W = CPL * (int)sizeof(T) / 16;  // 16-byte loads per CPL channels
  __shared__ float s_m[RG][GT], s_l[RG][GT];
  __shared__ float s_acc[RG][GT][HD];   // RG * HD >= 1024 >= 2 * kMaxSplits
  __shared__ float s_L[GT];

  const int split = blockIdx.x, tile = blockIdx.y, bk = blockIdx.z;
  const int n_splits = gridDim.x, n_tiles = gridDim.y;
  const int b = bk / KV, kv = bk % KV, G = H / KV;
  const int g0 = tile * GT, ng = min(GT, G - g0);
  const int len = max(0, min(lengths[b], Sc));
  const int n_valid = (len + chunk - 1) / chunk;   // splits holding a valid key
  const int tid = threadIdx.x, rg = tid / TPR, cs = tid % TPR;
  const bool loads = cs < NA;
  T* orow = out + ((size_t)b * H + kv * G + g0) * HD;   // this tile's heads

  if (split >= n_valid) {
    if (split == 0)   // no valid key: the output is 0
      for (int e = tid; e < ng * HD; e += kThreads) orow[e] = from_f32<T>(0.f);
    return;
  }

  float qr[GT][CPL];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    uint4 raw[W];
#pragma unroll
    for (int w = 0; w < W; ++w) raw[w] = make_uint4(0, 0, 0, 0);
    if (gi < ng && loads) load16<W>(q + ((size_t)b * H + kv * G + g0 + gi) * HD + cs * CPL, raw);
    unpack(raw, qr[gi]);
#pragma unroll
    for (int c = 0; c < CPL; ++c) qr[gi][c] *= qscale;
  }
  float m[GT], l[GT], acc[GT][CPL];
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[gi][c] = 0.f;
  }

  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  const size_t row_stride = (size_t)KV * HD;
  const size_t base = ((size_t)b * Sc * KV + kv) * HD + cs * CPL;
  // the trip count is the same for every lane, so the shuffles below see a
  // full warp; rows past k1 are loaded as zeros and weighted by p = 0
  for (int j0 = k0; j0 < k1; j0 += RG * U) {
    uint4 kr[U][W], vr[U][W];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * RG + rg;
      ok[u] = j < k1;
      if (ok[u] && loads) {
        load16<W>(k + base + j * row_stride, kr[u]);
        load16<W>(v + base + j * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) kr[u][w] = vr[u][w] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[CPL];
      unpack(kr[u], kf);
#pragma unroll
      for (int gi = 0; gi < GT; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < CPL; ++c) d = fmaf(qr[gi][c], kf[c], d);
        s[u][gi] = d;
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int gi = 0; gi < GT; ++gi) s[u][gi] += __shfl_xor_sync(0xffffffffu, s[u][gi], off);
    // online softmax over these U rows, in the log2 domain
#pragma unroll
    for (int gi = 0; gi < GT; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][gi]);
      const float alpha = exp2f(m[gi] - mx);
      m[gi] = mx;
      l[gi] *= alpha;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[gi][c] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][gi] = ok[u] ? exp2f(s[u][gi] - mx) : 0.f;
        l[gi] += s[u][gi];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[CPL];
      unpack(vr[u], vf);
#pragma unroll
      for (int gi = 0; gi < GT; ++gi)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[gi][c] = fmaf(s[u][gi], vf[c], acc[gi][c]);
    }
  }

  // the block's row groups meet in shared memory, once
#pragma unroll
  for (int gi = 0; gi < GT; ++gi) {
    if (cs == 0) {
      s_m[rg][gi] = m[gi];
      s_l[rg][gi] = l[gi];
    }
    if (loads) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) s_acc[rg][gi][cs * CPL + c] = acc[gi][c];
    }
  }
  __syncthreads();
  if (tid < GT) {   // per head: the block's max, each row group's scale, the sum
    float M = kNegInf;
    for (int r = 0; r < RG; ++r) M = fmaxf(M, s_m[r][tid]);
    float L = 0.f;
    for (int r = 0; r < RG; ++r) {
      const float sc = exp2f(s_m[r][tid] - M);
      s_m[r][tid] = sc;
      L += s_l[r][tid] * sc;
    }
    s_L[tid] = L;
    if (n_valid > 1 && tid < ng) {
      const size_t p = ((size_t)bk * G + g0 + tid) * n_splits + split;
      part_ml[2 * p] = M;
      part_ml[2 * p + 1] = L;
    }
  }
  __syncthreads();
  for (int e = tid; e < ng * HD; e += kThreads) {
    const int gi = e / HD, c = e % HD;
    float a = 0.f;
    for (int r = 0; r < RG; ++r) a = fmaf(s_acc[r][gi][c], s_m[r][gi], a);
    if (n_valid == 1)
      orow[e] = from_f32<T>(a / fmaxf(s_L[gi], 1e-30f));
    else
      part_acc[(((size_t)bk * G + g0 + gi) * n_splits + split) * HD + c] = a;
  }
  if (n_valid == 1) return;

  if (!last_arrival(counters + (size_t)bk * n_tiles + tile, n_valid)) return;
  // combine the splits: their (m, l) all at once into shared memory (s_acc is
  // free again), a scale per split, then every channel in split order
  float* s_ms = &s_acc[0][0][0];            // [GT][kMaxSplits]: m, then the scale
  float* s_ls = s_ms + GT * kMaxSplits;     // [GT][kMaxSplits]: l
  for (int e = tid; e < ng * n_valid; e += kThreads) {
    const int gi = e / n_valid, sp = e % n_valid;
    const size_t p = ((size_t)bk * G + g0 + gi) * n_splits + sp;
    s_ms[gi * kMaxSplits + sp] = __ldcg(part_ml + 2 * p);
    s_ls[gi * kMaxSplits + sp] = __ldcg(part_ml + 2 * p + 1);
  }
  __syncthreads();
  if (tid < ng) {
    float* ms = s_ms + tid * kMaxSplits;
    float M = kNegInf;
    for (int sp = 0; sp < n_valid; ++sp) M = fmaxf(M, ms[sp]);
    float L = 0.f;
    for (int sp = 0; sp < n_valid; ++sp) {
      ms[sp] = exp2f(ms[sp] - M);
      L += s_ls[tid * kMaxSplits + sp] * ms[sp];
    }
    s_L[tid] = L;
  }
  __syncthreads();
  for (int e = tid; e < ng * HD; e += kThreads) {
    const int gi = e / HD, c = e % HD;
    const float* pa = part_acc + ((size_t)bk * G + g0 + gi) * n_splits * HD + c;
    const float* sc = s_ms + gi * kMaxSplits;
    float a = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < n_valid; ++sp) a = fmaf(__ldcg(pa + (size_t)sp * HD), sc[sp], a);
    orow[e] = from_f32<T>(a / fmaxf(s_L[gi], 1e-30f));
  }
}

template <typename T, int HD, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   float* part_ml, float* part_acc, int* counters, void* out, cudaStream_t s,
                   int B, int Sc, int H, int KV, int chunk, int n_splits, float qscale) {
  const int G = H / KV;
  dim3 grid(n_splits, ceil_div(G, GT), B * KV);
  decode_fwd<T, HD, GT><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      part_ml, part_acc, counters, static_cast<T*>(out), Sc, H, KV, chunk, qscale);
  return cudaGetLastError();
}

// The head tiles above max_head_tile(HD) are not instantiated (at hd = 112
// and 168 their s_acc would pass the 48 KB of static shared memory).
template <typename T, int HD>
cudaError_t by_group(int gt, const void* q, const void* k, const void* v, const int* lengths,
                     float* pml, float* pacc, int* cnt, void* out, cudaStream_t s, int B,
                     int Sc, int H, int KV, int chunk, int n_splits, float qscale) {
#define DECODE_ARGS q, k, v, lengths, pml, pacc, cnt, out, s, B, Sc, H, KV, chunk, n_splits, qscale
  constexpr int MT = max_head_tile(HD);
  switch (gt) {
    case 1: return launch<T, HD, 1>(DECODE_ARGS);
    case 2: return launch<T, HD, 2>(DECODE_ARGS);
    case 4: if constexpr (MT >= 4) return launch<T, HD, 4>(DECODE_ARGS); else break;
    case 8: if constexpr (MT >= 8) return launch<T, HD, 8>(DECODE_ARGS); else break;
  }
#undef DECODE_ARGS
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_head_dim(int hd, int gt, const void* q, const void* k, const void* v,
                        const int* lengths, float* pml, float* pacc, int* cnt, void* out,
                        cudaStream_t s, int B, int Sc, int H, int KV, int chunk, int n_splits,
                        float qscale) {
  switch (hd) {
    case 32: return by_group<T, 32>(gt, q, k, v, lengths, pml, pacc, cnt, out, s, B, Sc, H, KV, chunk, n_splits, qscale);
    case 64: return by_group<T, 64>(gt, q, k, v, lengths, pml, pacc, cnt, out, s, B, Sc, H, KV, chunk, n_splits, qscale);
    case 112: return by_group<T, 112>(gt, q, k, v, lengths, pml, pacc, cnt, out, s, B, Sc, H, KV, chunk, n_splits, qscale);
    case 128: return by_group<T, 128>(gt, q, k, v, lengths, pml, pacc, cnt, out, s, B, Sc, H, KV, chunk, n_splits, qscale);
    case 168: return by_group<T, 168>(gt, q, k, v, lengths, pml, pacc, cnt, out, s, B, Sc, H, KV, chunk, n_splits, qscale);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(int B, int Sc, int H, int KV, int hd, int dtype) {
  return B >= 1 && Sc >= 1 && KV >= 1 && H >= KV && H % KV == 0 &&
         (hd == 32 || hd == 64 || hd == 112 || hd == 128 || hd == 168) &&
         (dtype == kF32 || dtype == kBF16);
}

}  // namespace

// The plan a launch at these shapes should take on the current device:
// (query heads a block, splits, keys a split) into out[0..2].
extern "C" int decode_attention_plan(int B, int Sc, int H, int KV, int hd, int dtype, int* out) {
  if (!valid(B, Sc, H, KV, hd, dtype)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, KV, H / KV, Sc, hd, dtype == kBF16 ? 2 : 4);
  out[0] = p.gt;
  out[1] = p.n_splits;
  out[2] = p.chunk;
  return 0;
}

// What the wrapper allocates for a launch with n_splits splits and head
// tiles of gt: the fp32 scratch (each split's (m, l) and unnormalised output
// of every query head) and the int32 counters (one per (row, KV head, head
// tile)), zero before the first launch; each launch leaves them zero.
extern "C" long long decode_attention_scratch_floats(int B, int H, int hd, int n_splits) {
  return (long long)B * H * n_splits * (hd + 2);
}

extern "C" int decode_attention_counters(int B, int H, int KV, int gt) {
  return B * KV * ceil_div(H / KV, gt);
}

// Launches the kernel with the plan (gt, n_splits, chunk): the library's
// (decode_attention_plan) on the served path, any other that covers the cache
// to measure it; scratch and counters as large as the two functions above say.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* lengths, void* scratch, void* counters,
                                       void* out, void* stream, int B, int Sc, int H, int KV,
                                       int hd, int dtype, int gt, int n_splits, int chunk,
                                       float scale) {
  if (!valid(B, Sc, H, KV, hd, dtype) || n_splits < 1 || n_splits > kMaxSplits || chunk < 1 ||
      (long long)chunk * n_splits < Sc)
    return (int)cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  float* pml = static_cast<float*>(scratch);
  float* pacc = pml + 2 * (size_t)B * H * n_splits;
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float qscale = scale * kLog2e;
  if (dtype == kF32)
    return (int)by_head_dim<float>(hd, gt, q, k, v, lens, pml, pacc, cnt, out, s, B, Sc, H, KV,
                                   chunk, n_splits, qscale);
  return (int)by_head_dim<__nv_bfloat16>(hd, gt, q, k, v, lens, pml, pacc, cnt, out, s, B, Sc, H,
                                         KV, chunk, n_splits, qscale);
}
