// Fused MMTM gating forward for Hopper (sm_90a): one cluster launch a call.
//
// Replaces the Pallas TPU kernel `_gating_kernel`
// (greedy_multimodal_learning_tpu/ops/mmtm_pallas.py:47-78, launched by
// `_fused_forward` :95-147).  For two modalities f0, f1 of shape (B, S, C):
//
//   sq_i  = mean over S of f_i                          (f32)
//   e     = relu(round_T([sq0, sq1]) . Wsq^T + bsq)     (f32 accumulate, f32 bias)
//   g_i   = sigmoid(round_T(e) . W_i^T + b_i)           (f32)
//   out_i = f_i * round_T(g_i)                          (T)
//
// T is the feature dtype (float or bfloat16); the weights share it, as the
// model casts them to the compute dtype (models/mmtm.py:193-205).  Weights are
// read in place in torch's nn.Linear (out, in) layout: Wsq (D, 2C), W_i (C, D).
//
// What bounds it on an H100: bytes.  The least traffic is four map streams:
// one read of f0 and f1, one write of out0 and out1, B*S*C*sizeof(T) bytes
// each (at 224², B=128, f32: 51.4 MB per stream at mmtm2 (S=784, C=128),
// 25.7 MB at mmtm3 (196, 256), 12.8 MB at mmtm4 (49, 512); bf16 half).  The
// products are B*(2C*D + 2*D*C) multiply-adds, far below the arithmetic rate,
// but every tile reads the 4*C*D weights from L2.
//
// The TPU kernel holds a batch block of both maps in VMEM
// (mmtm_pallas.py:81-92, up to 12 MB) and reads each map once.  A Hopper
// block has at most 227 KB of shared memory, less than one mmtm2 sample's map
// (392 KiB in f32).  A thread-block cluster of K = 8 CTAs holds 8 x 227 KB
// and its CTAs read each other's shared memory (DSMEM), so here a cluster
// takes the VMEM block's place.  Persistent clusters walk tiles of n samples;
// for each tile:
//
//   1. Each CTA bulk-copies its share of every sample's rows of f0 and f1
//      (rows [s0, s0 + ns) of S, one contiguous run each) into shared memory.
//   2. It reduces them to per-channel partial sums (16-byte loads).
//   3. Every CTA adds the K partials over DSMEM in rank order (the same bits
//      in every CTA and every run) -> sq; the leader (rank 0) stores sq.
//   4. The CTAs split e's D outputs and push their shares of e to each other
//      over DSMEM, then split the gates' 2C outputs and push g the same way:
//      each weight is read from L2 once a tile.
//   5. Each CTA scales its shared-memory rows by round_T(g) and stores them.
//
// f0 and f1 cross HBM once (the bulk copies), out0 and out1 once (the
// stores): the bound's four streams.  A tile also costs a fixed chain (three
// cluster syncs, two products whose weight loads wait on a memory system
// the other clusters keep busy), so the plan (ops/mmtm_gating.py::_plan)
// takes the smallest tile that gives the fewest waves over the card's 15
// clusters (one 512-thread CTA an SM).  At 224², B=128, on an H100:
//
//   site   f32: n, tiles, smem a CTA, weights from L2   bf16
//   mmtm2  2, 64 (5 waves), 209 KiB, 16 MiB            3, 43 (3 waves), 171 KiB, 5 MiB
//   mmtm3  3, 43 (3 waves), 173 KiB, 43 MiB            5, 26 (2 waves), 166 KiB, 13 MiB
//   mmtm4  5, 26 (2 waves), 198 KiB, 104 MiB           5, 26 (2 waves), 136 KiB, 52 MiB
//
// A sample whose two maps do not fit a cluster (S=3136, C=128 in f32: 392
// rows of 512 B a CTA a map) streams instead: the CTA reduces its rows from
// global memory, computes the gates, and reads the rows again to scale them.

#include "mmtm_cluster.cuh"

namespace {

using namespace mmtm;

template <typename T>
struct FwdArgs {
  const T *f0, *f1, *wsq, *bsq, *w0, *b0, *w1, *b1;
  T *out0, *out1;
  float *sq0, *sq1, *g0, *g1;
  int B, S, C, D, n, nmaps;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gating_fwd_kernel(FwdArgs<T> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int C = a.C, C2 = 2 * a.C, D = a.D, Dp = (a.D + 3) / 4 * 4;
  const int tiles = (a.B + a.n - 1) / a.n, first = (int)(blockIdx.x / K), step = (int)(gridDim.x / K);
  const int rows_max = (a.S + K - 1) / K;
  int s0, ns;
  split(a.S, K, rank, s0, ns);

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(a.n, a.nmaps, rows_max, C, D, sizeof(T), false);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part);  // partial sums, later the gates
  float* sq = reinterpret_cast<float*>(smem + L.sq);
  float* e = reinterpret_cast<float*>(smem + L.e);
  float* tmp = reinterpret_cast<float*>(smem + L.tmp);
  T* maps = reinterpret_cast<T*>(smem + L.maps);

  const T* src[2] = {a.f0, a.f1};
  auto issue = [&](int tile) {  // the tile's maps into shared memory
    if (a.nmaps && threadIdx.x == 0 && tile < tiles)
      issue_tile<T>(src, a.nmaps, maps, bar, a.n, min(a.n, a.B - tile * a.n), tile * a.n, a.S, s0, ns, rows_max, C);
  };
  init_barrier(bar);
  issue(first);
  for (int tile = first, it = 0; tile < tiles; tile += step, ++it) {
    const int b0 = tile * a.n, nb = min(a.n, a.B - b0);
    // @phase 0 (the `// @phase` marks are where kernel_phases.py stamps a tile's phases)
    if (a.nmaps) wait_barrier(bar, (uint32_t)(it & 1));
    // @phase 1
    auto rows_of = [&](int m, int j) -> const T* {
      return a.nmaps ? maps + ((size_t)(m * a.n + j) * rows_max) * C : src[m] + ((size_t)(b0 + j) * a.S + s0) * C;
    };

    // 2. partial sums of this CTA's rows: set q = 2 j + m is modality m of sample j
    auto set_rows = [&](int q) { return rows_of(q % 2, q / 2); };
    reduce_sets<T, false>(set_rows, set_rows, 2 * nb, ns, C, tmp, part);
    cluster.sync();
    // @phase 2

    // 3. sq = (sum of the K partials in rank order) / S, in every CTA
    const float fs = (float)a.S;
    for (int i = threadIdx.x; i < nb * C2 / 4; i += kThreads) {
      const float4 t = cluster_sum4(cluster, part, i);
      reinterpret_cast<float4*>(sq)[i] = make_float4(t.x / fs, t.y / fs, t.z / fs, t.w / fs);
    }
    __syncthreads();
    if (rank == 0) {
      for (int i = threadIdx.x; i < nb * C2; i += kThreads) {
        const int j = i / C2, c = i % C2;
        (c < C ? a.sq0 : a.sq1)[(size_t)(b0 + j) * C + c % C] = sq[i];
      }
    }

    // @phase 3
    // 4a. this CTA's share of e, pushed to every CTA over DSMEM
    int lo, size;
    split(D, K, rank, lo, size);
    row_product<T, kRelu, true, kMaxTile>(sq, C2, C2, a.wsq, a.bsq, lo, lo + size, nb, e, Dp);
    // @phase 4
    push_slice(cluster, e, lo, size, Dp, nb);
    cluster.sync();  // every CTA holds all of e and is done reading the partials
    // @phase 5

    // 4b. this CTA's share of the 2C gate outputs (into part), pushed to every CTA
    split(C2, K, rank, lo, size);
    for (int m = 0; m < 2; ++m) {
      const int from = max(lo, m * C), to = min(lo + size, (m + 1) * C);
      if (from < to)
        row_product<T, kSigmoid, true, kMaxTile>(e, Dp, D, m ? a.w1 : a.w0, m ? a.b1 : a.b0, from - m * C, to - m * C, nb,
                                                 part + m * C, C2);
    }
    // @phase 6
    push_slice(cluster, part, lo, size, C2, nb);
    cluster.sync();  // every CTA holds every gate
    // @phase 7
    if (rank == 0) {
      for (int i = threadIdx.x; i < nb * C2; i += kThreads) {
        const int j = i / C2, c = i % C2;
        (c < C ? a.g0 : a.g1)[(size_t)(b0 + j) * C + c % C] = part[i];
      }
    }

    // 5. out = f * round_T(g) over this CTA's rows of every (sample, modality)
    // q = 2 j + m, 16-byte loads and stores
    constexpr int V = 16 / sizeof(T);
    const int CV = C / V, per = ns * CV;
    T* dst[2] = {a.out0, a.out1};
    for (int i = threadIdx.x; i < 2 * nb * per; i += kThreads) {
      const int q = i / per, v = i - q * per, j = q / 2, m = q % 2, c = (v % CV) * V;
      uint4 raw = reinterpret_cast<const uint4*>(rows_of(m, j))[v];
      const float* g = part + j * C2 + m * C;
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u) vals[u] = from_f32<T>(to_f32<T>(vals[u]) * round_to<T>(g[c + u]));
      __stcs(reinterpret_cast<uint4*>(dst[m] + ((size_t)(b0 + j) * a.S + s0) * C) + v, raw);
    }
    __syncthreads();  // the maps and the rows are read: free for the next tile
    // @phase 8
    issue(tile + step);
  }
}

template <typename T>
cudaError_t launch(const FwdArgs<T>& args, int K, int smem, int clusters, cudaStream_t stream) {
  const int rows_max = (args.S + K - 1) / K;
  if ((size_t)smem != Layout(args.n, args.nmaps, rows_max, args.C, args.D, sizeof(T), false).total)
    return cudaErrorInvalidValue;
  return launch_clusters(gating_fwd_kernel<T>, args, clusters, K, smem, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// The wrapper (ops/mmtm_gating.py) checks shapes, dtypes, contiguity and
// alignment, allocates every output, and passes its plan: K CTAs a cluster,
// n samples a tile, nmaps resident maps (2, or 0 to stream), the dynamic
// shared memory per CTA and the persistent clusters to launch.  Returns the
// launch's CUDA error (0 = success).
extern "C" int mmtm_gating_forward(const void* f0, const void* f1, const void* wsq, const void* bsq,
                                   const void* w0, const void* b0, const void* w1, const void* b1,
                                   void* out0, void* out1, void* sq0, void* sq1, void* g0, void* g1, int B, int S,
                                   int C, int D, int dtype, int K, int n, int nmaps, int smem,
                                   int clusters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kMaxTile || K < 1 || K > 8 || clusters < 1)
    return (int)cudaErrorInvalidValue;
  auto rows = [](void* p) { return static_cast<float*>(p); };
  switch (dtype) {
    case 0: {
      using T = float;
      FwdArgs<T> a{(const T*)f0, (const T*)f1, (const T*)wsq, (const T*)bsq, (const T*)w0, (const T*)b0,
                   (const T*)w1, (const T*)b1, (T*)out0, (T*)out1, rows(sq0), rows(sq1), rows(g0), rows(g1),
                   B, S, C, D, n, nmaps};
      return (int)launch(a, K, smem, clusters, st);
    }
    case 1: {
      using T = __nv_bfloat16;
      FwdArgs<T> a{(const T*)f0, (const T*)f1, (const T*)wsq, (const T*)bsq, (const T*)w0, (const T*)b0,
                   (const T*)w1, (const T*)b1, (T*)out0, (T*)out1, rows(sq0), rows(sq1), rows(g0), rows(g1),
                   B, S, C, D, n, nmaps};
      return (int)launch(a, K, smem, clusters, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Clusters of the forward kernel that fit on the card at once for this plan
// (cudaOccupancyMaxActiveClusters), written to *count.
extern "C" int mmtm_gating_forward_clusters(int dtype, int K, int smem, int* count) {
  switch (dtype) {
    case 0:
      return (int)max_active_clusters(gating_fwd_kernel<float>, K, smem, count);
    case 1:
      return (int)max_active_clusters(gating_fwd_kernel<__nv_bfloat16>, K, smem, count);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
