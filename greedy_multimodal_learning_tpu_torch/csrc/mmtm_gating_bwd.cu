// Fused MMTM gating backward for Hopper (sm_90a): two launches a call, one
// cluster kernel over the maps and one kernel for the weight gradients.
//
// Replaces the Pallas TPU kernel `_gating_bwd_kernel`
// (greedy_multimodal_learning_tpu/ops/mmtm_pallas.py:150-226, launched by
// `_fused_backward` :229-278, bound by `_bwd_pallas` :309-329).  Given the
// forward's residuals (f_i, sq_i, g_i, the weights) and the cotangents of its
// six outputs (do_i on out_i, dsq_i^c on sq_i, dg_i^c on g_i), all in f32:
//
//   dz_i   = (sum_S do_i * f_i + dg_i^c) * g_i * (1 - g_i)
//   pre    = [sq0, sq1] . Wsq^T + bsq          (recomputed, unrounded f32)
//   de     = (dz0 . W0 + dz1 . W1) * [pre > 0]
//   dsq_i  = (de . Wsq)[:, i*C:(i+1)*C] + dsq_i^c
//   df_i   = T(do_i * g_i + dsq_i / S)
//   dWsq   = de^T . [sq0, sq1]   dbsq = sum_B de
//   dW_i   = dz_i^T . relu(pre)  db_i = sum_B dz_i
//
// Weights are read in place in torch's nn.Linear (out, in) layout: Wsq (D, 2C),
// W_i (C, D); the weight gradients come out in the same layout, in f32.  The
// forward rounds the joint squeeze and the excitation to T; the backward, like
// the TPU kernel, recomputes pre from the unrounded f32 squeeze (:187-189).
//
// What bounds it on an H100: bytes.  The least traffic is six map streams of
// B*S*C*sizeof(T) bytes each: one read of do0, do1, f0, f1 and one write of
// df0, df1 (at 224², B=128, f32: 51.4 / 25.7 / 12.8 MB per stream at mmtm2 /
// mmtm3 / mmtm4; bf16 half).  The row products are O(B * C * D) multiply-adds,
// but every tile reads 6*C*D weight values from L2 (Wsq twice, W0, W1).
//
// The TPU kernel holds a batch block of all four maps in VMEM
// (mmtm_pallas.py:81-92) and reads each once.  df_i needs dsq_i, which needs
// the whole spatial reduction of the same sample, and one mmtm2 sample is
// 392 KiB per map in f32, beyond one block's 227 KB.  A cluster of K = 8 CTAs
// takes the VMEM block's place; persistent clusters walk tiles of n samples:
//
//   map kernel, for each tile:
//   1. each CTA bulk-copies its share of every sample's rows of do_i into
//      shared memory; while they land, it loads the tile's g and joint rows
//      and computes its share of pre over D (weights from L2);
//   2. it reduces sum do_i * f_i over its rows (f_i read once from global
//      memory, where it is used once anyway); every CTA adds the K partials
//      over DSMEM in rank order -> dz (the same bits everywhere);
//   3. the CTAs split de over D and dsq over 2C, pushing their shares to
//      each other over DSMEM (each weight is read from L2 once a tile);
//   4. df_i from the shared-memory copy of do_i;
//   5. the tile stores dz (B, 2C), e = relu(pre) and de (B, D) for the
//      weight gradients.
//   do_i and f_i cross HBM once, df_i once: the bound's six streams.  As in
//   the forward, the plan takes the smallest tile with the fewest waves.  At
//   224², B=128, on an H100 (15 clusters; weights from L2 a call = tiles x
//   6CD values, Wsq being read twice):
//
//   site   f32: n, tiles, smem a CTA, weights from L2   bf16
//   mmtm2  2, 64 (5 waves), 211 KiB, 24 MiB            3, 43 (3 waves), 174 KiB, 8 MiB
//   mmtm3  3, 43 (3 waves), 179 KiB, 64 MiB            5, 26 (2 waves), 176 KiB, 20 MiB
//   mmtm4  5, 26 (2 waves), 220 KiB, 156 MiB           5, 26 (2 waves), 156 KiB, 78 MiB
//
//   A sample whose do0 and do1 do not fit a cluster (S=3136, C=128 in f32)
//   streams: do_i is read again from global memory for df (eight streams).
//
//   weight-gradient kernel: each output element (and bias) is summed over B
//   by one thread in a fixed order, in a fixed number of batch chunks; the
//   last block of an output tile to finish (a counter) adds the chunks'
//   partial sums in chunk order.  No float atomics: two runs give the same
//   bits, and rows past B are never read.

#include "mmtm_cluster.cuh"

namespace {

using namespace mmtm;

template <typename T>
struct MapArgs {
  const T *do0, *do1, *f0, *f1;
  const float *g0, *g1, *sq0, *sq1;
  const T *wsq, *bsq, *w0, *w1;
  const float *dg0c, *dg1c, *dsq0c, *dsq1c;
  T *df0, *df1;
  float *dz, *e, *de;  // (B, 2C), (B, D), (B, D) for the weight-gradient kernel
  int* counters;       // zeroed here for the weight-gradient kernel
  int ncounters;
  int B, S, C, D, n, nmaps;  // nmaps: 2 (do0, do1 resident) or 0 (stream)
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gating_bwd_map_kernel(MapArgs<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int C = a.C, C2 = 2 * a.C, D = a.D, Dp = (a.D + 3) / 4 * 4;
  const int tiles = (a.B + a.n - 1) / a.n, first = (int)(blockIdx.x / K), step = (int)(gridDim.x / K);
  const int rows_max = (a.S + K - 1) / K;
  int s0, ns;
  split(a.S, K, rank, s0, ns);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < a.ncounters; i += kThreads) a.counters[i] = 0;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.n, a.nmaps, rows_max, C, D, sizeof(T), true);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part);  // partial sums, later dsq
  float* dz = reinterpret_cast<float*>(smem + L.dz);
  float* joint = dz;  // the joint squeeze, until dz replaces it
  float* g = reinterpret_cast<float*>(smem + L.g);
  float* de = reinterpret_cast<float*>(smem + L.de);  // pre, then de
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);
  T* maps = reinterpret_cast<T*>(smem + L.maps);

  const T* src[4] = {a.do0, a.do1, a.f0, a.f1};
  auto issue = [&](int tile) {  // the tile's do0, do1 into shared memory
    if (a.nmaps && threadIdx.x == 0 && tile < tiles)
      issue_tile<T>(src, a.nmaps, maps, bar, a.n, min(a.n, a.B - tile * a.n), tile * a.n, a.S, s0, ns, rows_max, C);
  };
  init_barrier(bar);
  issue(first);
  for (int tile = first, it = 0; tile < tiles; tile += step, ++it) {
    const int b0 = tile * a.n, nb = min(a.n, a.B - b0);
    // @phase 0 (the `// @phase` marks are where kernel_phases.py stamps a tile's phases)

    // 1. the tile's g and joint rows; this CTA's share of pre = joint . Wsq^T
    // + bsq (into de) while the tile's bulk copies are in flight
    for (int i = threadIdx.x; i < nb * C2; i += kThreads) {
      const int j = i / C2, c = i % C2;
      const size_t r = (size_t)(b0 + j) * C + c % C;
      g[i] = (c < C ? a.g0 : a.g1)[r];
      joint[i] = (c < C ? a.sq0 : a.sq1)[r];
    }
    __syncthreads();
    int lo, size;
    split(D, K, rank, lo, size);
    row_product<T, kNone, false, kMaxTile>(joint, C2, C2, a.wsq, a.bsq, lo, lo + size, nb, de, Dp);
    // @phase 1
    if (a.nmaps) wait_barrier(bar, (uint32_t)(it & 1));
    // @phase 2
    auto rows_of = [&](int m, int j) -> const T* {  // m: do0, do1, f0, f1
      return m < a.nmaps ? maps + ((size_t)(m * a.n + j) * rows_max) * C
                         : src[m] + ((size_t)(b0 + j) * a.S + s0) * C;
    };

    // 2. partial sums of do_i * f_i over this CTA's rows (set q = 2 j + m:
    // modality m of sample j); every CTA adds the K partials in rank order
    reduce_sets<T, true>([&](int q) { return rows_of(q % 2, q / 2); }, [&](int q) { return rows_of(q % 2 + 2, q / 2); },
                         2 * nb, ns, C, tmp, part);
    // @phase 3
    cluster.sync();  // every CTA's partials are written, and pre is done with joint
    // @phase 4
    for (int i4 = threadIdx.x; i4 < nb * C2 / 4; i4 += kThreads) {
      const float4 t = cluster_sum4(cluster, part, i4);
      const float dg4[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 4 * i4 + u, j = i / C2, c = i % C2;
        const float* dgc = c < C ? a.dg0c : a.dg1c;
        const float dg = dgc != nullptr ? dg4[u] + dgc[(size_t)(b0 + j) * C + c % C] : dg4[u];
        dz[i] = dg * g[i] * (1.f - g[i]);
        if (rank == 0) a.dz[(size_t)(b0 + j) * C2 + c] = dz[i];
      }
    }
    __syncthreads();

    // @phase 5
    // 3a. this CTA's share of de = (dz0 . W0 + dz1 . W1) * [pre > 0]
    col_product<T, kMaxTile>(dz, C2, C2, C, a.w0, a.w1, D, lo, lo + size, nb, tmp, [&](int j, int d, float total) {
      const float pre = de[j * Dp + d];
      const float v = pre > 0.f ? total : 0.f;
      de[j * Dp + d] = v;
      a.e[(size_t)(b0 + j) * D + d] = fmaxf(pre, 0.f);
      a.de[(size_t)(b0 + j) * D + d] = v;
    });
    // @phase 6
    push_slice(cluster, de, lo, size, Dp, nb);
    cluster.sync();  // every CTA holds all of de and is done reading the partials
    // @phase 7

    // 3b. this CTA's share of dsq = de . Wsq + dsq^c (into part), pushed to every CTA
    split(C2, K, rank, lo, size);
    col_product<T, kMaxTile>(de, Dp, D, D, a.wsq, a.wsq, C2, lo, lo + size, nb, tmp, [&](int j, int c, float total) {
      const float* cot = c < C ? a.dsq0c : a.dsq1c;
      part[j * C2 + c] = cot != nullptr ? total + cot[(size_t)(b0 + j) * C + c % C] : total;
    });
    // @phase 8
    push_slice(cluster, part, lo, size, C2, nb);
    cluster.sync();  // every CTA holds all of dsq
    // @phase 9

    // 4. df = T(do * g + dsq / S) over this CTA's rows of every (sample,
    // modality) q = 2 j + m, 16-byte loads and stores
    constexpr int V = 16 / sizeof(T);
    const int CV = C / V, per = ns * CV;
    const float fs = (float)a.S;
    T* dst[2] = {a.df0, a.df1};
    for (int i = threadIdx.x; i < 2 * nb * per; i += kThreads) {
      const int q = i / per, v = i - q * per, j = q / 2, m = q % 2, c = (v % CV) * V;
      uint4 raw = reinterpret_cast<const uint4*>(rows_of(m, j))[v];
      const float* gj = g + j * C2 + m * C;
      const float* dsq = part + j * C2 + m * C;
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u) vals[u] = from_f32<T>(to_f32<T>(vals[u]) * gj[c + u] + dsq[c + u] / fs);
      __stcs(reinterpret_cast<uint4*>(dst[m] + ((size_t)(b0 + j) * a.S + s0) * C) + v, raw);
    }
    __syncthreads();  // the maps and the rows are read: free for the next tile
    // @phase 10
    issue(tile + step);
  }
}

// ---- weight gradients ------------------------------------------------------------
// out[n, k] = sum_b x[b, n] * y[b, k], bias[n] = sum_b x[b, n], with x rows of
// stride ldx and y = [ya (B, Ka) | yb (B, K - Ka)].  Three such problems
// (blockIdx.z % 3) in one launch; blockIdx.z / 3 picks a chunk of the batch.
// A block owns a 16 x 64 output tile and walks its chunk in 32-row steps
// staged in shared memory; thread (ty, tx) owns outputs (ty + 4i, tx), i < 4.
// With one chunk it writes the outputs; with more, it writes its partial
// sums, and the tile's last block adds the chunks in chunk order.
constexpr int kOuterN = 16;
constexpr int kOuterK = 64;
constexpr int kStep = 32;
constexpr int kWgThreads = 256;  // 4 x 64 threads, 4 outputs each

struct WgProblem {
  const float* x;
  int ldx;
  const float* ya;
  const float* yb;
  int N, K, Ka;
  float* out;
  float* bias;
  size_t part_off;  // where this problem's partial sums start within a chunk's
};

struct WgArgs {
  WgProblem p[3];
  int B, chunks, rows_per_chunk, ntiles, ktiles;
  size_t part_stride;  // floats of partial sums per chunk
  float* partials;
  int* counters;
};

__global__ void __launch_bounds__(kWgThreads) weight_grad_kernel(WgArgs args) {
  const int prob = blockIdx.z % 3, chunk = blockIdx.z / 3;
  const WgProblem p = args.p[prob];
  const int n0 = blockIdx.y * kOuterN, k0 = blockIdx.x * kOuterK;
  if (n0 >= p.N || k0 >= p.K) return;  // uniform over the block and over the chunks
  __shared__ float xs[kStep][kOuterN];
  __shared__ float ys[kStep][kOuterK];
  __shared__ int last;
  const int tx = threadIdx.x % kOuterK, ty = threadIdx.x / kOuterK;  // ty < 4
  const int Kb = p.K - p.Ka;
  const bool bias_thread = blockIdx.x == 0 && tx == 0;
  const int r0 = chunk * args.rows_per_chunk, r1 = min(args.B, r0 + args.rows_per_chunk);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = r0; b0 < r1; b0 += kStep) {
    const int nb = min(kStep, r1 - b0);
    for (int i = threadIdx.x; i < kStep * kOuterN; i += kWgThreads) {
      const int r = i / kOuterN, j = i - r * kOuterN;
      xs[r][j] = (r < nb && n0 + j < p.N) ? p.x[(size_t)(b0 + r) * p.ldx + n0 + j] : 0.f;
    }
    for (int i = threadIdx.x; i < kStep * kOuterK; i += kWgThreads) {
      const int r = i / kOuterK, j = i - r * kOuterK, k = k0 + j;
      float v = 0.f;
      if (r < nb && k < p.K) v = k < p.Ka ? p.ya[(size_t)(b0 + r) * p.Ka + k] : p.yb[(size_t)(b0 + r) * Kb + (k - p.Ka)];
      ys[r][j] = v;
    }
    __syncthreads();
    for (int r = 0; r < nb; ++r) {
      const float yv = ys[r][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(xs[r][ty + 4 * i], yv, acc[i]);
      if (bias_thread) {
#pragma unroll
        for (int i = 0; i < 4; ++i) bacc[i] += xs[r][ty + 4 * i];
      }
    }
    __syncthreads();
  }
  const int k = k0 + tx;
  if (args.chunks == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty + 4 * i;
      if (n >= p.N) continue;
      if (k < p.K) p.out[(size_t)n * p.K + k] = acc[i];
      if (bias_thread) p.bias[n] = bacc[i];
    }
    return;
  }
  // partial sums of this chunk: weights at [n * K + k], biases at [N * K + n]
  float* mine = args.partials + (size_t)chunk * args.part_stride + p.part_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 4 * i;
    if (n >= p.N) continue;
    if (k < p.K) mine[(size_t)n * p.K + k] = acc[i];
    if (bias_thread) mine[(size_t)p.N * p.K + n] = bacc[i];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ticket = atomicAdd(&args.counters[(prob * args.ntiles + blockIdx.y) * args.ktiles + blockIdx.x], 1);
    last = ticket == args.chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = args.partials + p.part_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 4 * i;
    if (n >= p.N) continue;
    if (k < p.K) {
      float total = 0.f;
      for (int c = 0; c < args.chunks; ++c) total += __ldcg(all + (size_t)c * args.part_stride + (size_t)n * p.K + k);
      p.out[(size_t)n * p.K + k] = total;
    }
    if (bias_thread) {
      float total = 0.f;
      for (int c = 0; c < args.chunks; ++c) total += __ldcg(all + (size_t)c * args.part_stride + (size_t)p.N * p.K + n);
      p.bias[n] = total;
    }
  }
}

struct Buffers {
  const void *do0, *do1, *f0, *f1;
  const float *g0, *g1, *sq0, *sq1;
  const void *wsq, *bsq, *w0, *w1;
  const float *dg0c, *dg1c, *dsq0c, *dsq1c;
  void *df0, *df1;
  float *dwsq, *dbsq, *dw0, *db0, *dw1, *db1;
  float *dz, *e, *de, *partials;
  int* counters;
};

template <typename T>
cudaError_t launch(const Buffers& m, int B, int S, int C, int D, int K, int n, int nmaps, int smem, int clusters,
                   int chunks, cudaStream_t stream) {
  const int rows_max = (S + K - 1) / K;
  if ((nmaps != 0 && nmaps != 2) || (size_t)smem != Layout(n, nmaps, rows_max, C, D, sizeof(T), true).total)
    return cudaErrorInvalidValue;
  const int ktiles = ((2 * C > D ? 2 * C : D) + kOuterK - 1) / kOuterK;
  const int ntiles = ((D > C ? D : C) + kOuterN - 1) / kOuterN;
  const int rows_per_chunk = (B + chunks - 1) / chunks;
  if (chunks < 1 || (chunks - 1) * rows_per_chunk >= B) return cudaErrorInvalidValue;  // no empty chunk

  MapArgs<T> a{static_cast<const T*>(m.do0), static_cast<const T*>(m.do1), static_cast<const T*>(m.f0),
               static_cast<const T*>(m.f1), m.g0, m.g1, m.sq0, m.sq1,
               static_cast<const T*>(m.wsq), static_cast<const T*>(m.bsq), static_cast<const T*>(m.w0),
               static_cast<const T*>(m.w1), m.dg0c, m.dg1c, m.dsq0c, m.dsq1c,
               static_cast<T*>(m.df0), static_cast<T*>(m.df1), m.dz, m.e, m.de,
               m.counters, chunks > 1 ? 3 * ntiles * ktiles : 0, B, S, C, D, n, nmaps};
  cudaError_t err = launch_clusters(gating_bwd_map_kernel<T>, a, clusters, K, smem, stream);
  if (err != cudaSuccess) return err;

  const size_t wsq_part = (size_t)D * 2 * C + D, w_part = (size_t)C * D + C;
  WgArgs w{{{m.de, D, m.sq0, m.sq1, D, 2 * C, C, m.dwsq, m.dbsq, 0},
            {m.dz, 2 * C, m.e, m.e, C, D, D, m.dw0, m.db0, wsq_part},
            {m.dz + C, 2 * C, m.e, m.e, C, D, D, m.dw1, m.db1, wsq_part + w_part}},
           B, chunks, rows_per_chunk, ntiles, ktiles, wsq_part + 2 * w_part, m.partials, m.counters};
  weight_grad_kernel<<<dim3(ktiles, ntiles, 3 * chunks), kWgThreads, 0, stream>>>(w);
  return count_launch(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (the maps and the weights; sq, g, the row cotangents and every gradient of
// a weight are float32).  dg0c, dg1c, dsq0c, dsq1c may be null (a zero
// cotangent).  The wrapper (ops/mmtm_gating.py) checks shapes, dtypes,
// contiguity and alignment, allocates every output and the f32 scratch dz
// (B, 2C), e and de (B, D), the chunks' partial sums (when chunks > 1) and
// the int32 counters, and passes its plan: K CTAs a cluster, n samples a
// tile, nmaps resident maps (2: do0 and do1, or 0 to stream), the dynamic
// shared memory per CTA, the persistent clusters to launch and the weight
// gradients' batch chunks.
// Returns the first launch error (0 = success).
extern "C" int mmtm_gating_backward(const void* do0, const void* do1, const void* f0, const void* f1,
                                    const void* g0, const void* g1, const void* sq0, const void* sq1,
                                    const void* wsq, const void* bsq, const void* w0, const void* w1,
                                    const void* dg0c, const void* dg1c, const void* dsq0c, const void* dsq1c,
                                    void* df0, void* df1, void* dwsq, void* dbsq, void* dw0, void* db0, void* dw1,
                                    void* db1, void* dz, void* e, void* de, void* partials, void* counters, int B,
                                    int S, int C, int D, int dtype, int K, int n, int nmaps, int smem,
                                    int clusters, int chunks, void* stream) {
  if (n < 1 || n > kMaxTile || K < 1 || K > 8 || clusters < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const Buffers m{do0, do1, f0, f1, f(g0), f(g1), f(sq0), f(sq1), wsq, bsq, w0, w1,
                  f(dg0c), f(dg1c), f(dsq0c), f(dsq1c), df0, df1, w(dwsq), w(dbsq), w(dw0), w(db0), w(dw1), w(db1),
                  w(dz), w(e), w(de), w(partials), static_cast<int*>(counters)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(m, B, S, C, D, K, n, nmaps, smem, clusters, chunks, st);
    case 1:
      return (int)launch<__nv_bfloat16>(m, B, S, C, D, K, n, nmaps, smem, clusters, chunks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Clusters of the backward's map kernel that fit on the card at once for this
// plan (cudaOccupancyMaxActiveClusters), written to *count.
extern "C" int mmtm_gating_backward_clusters(int dtype, int K, int smem, int* count) {
  switch (dtype) {
    case 0:
      return (int)max_active_clusters(gating_bwd_map_kernel<float>, K, smem, count);
    case 1:
      return (int)max_active_clusters(gating_bwd_map_kernel<__nv_bfloat16>, K, smem, count);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
