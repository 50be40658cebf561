// Pieces shared by the MMTM gating kernels (mmtm_gating.cu, mmtm_gating_bwd.cu)
// for Hopper (sm_90a): f32/bf16 conversions, the shared-memory layout of a
// cluster tile, the tile loader (bulk asynchronous copies completing on an
// mbarrier), the fixed-order reduction of a CTA's rows, the row and column
// products of the excitation chain, and the cluster launch.
//
// A cluster of K CTAs (one 512-thread CTA an SM) owns a tile of n samples at
// a time; the clusters are persistent and walk the tiles.  Each CTA owns the
// same contiguous share of every sample's S rows (rows [s0, s0 + ns) of the
// split below), so one (sample, map) share is one contiguous run of ns * C
// values: one bulk copy, no tensor map.  The layout must agree with
// `_smem_bytes` in ops/mmtm_gating.py, which sizes the launch; the entry
// points check it.

#pragma once

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmtm {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;         // one 512-thread CTA an SM
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTile = 8;         // samples a cluster tile (accumulators a thread in the products)
constexpr int kBarrierBytes = 128;  // the mbarrier, padded

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// The casts of the TPU kernel (mmtm_pallas.py:57,62,66,70): round an f32 value
// to T's precision and carry on in f32.
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

// [lo, lo + size) is part r of `total` items split into `parts` nearly equal runs.
__host__ __device__ __forceinline__ void split(int total, int parts, int r, int& lo, int& size) {
  const int q = total / parts, rem = total % parts;
  lo = r * q + (r < rem ? r : rem);
  size = q + (r < rem ? 1 : 0);
}

// Byte offsets of one CTA's dynamic shared memory: the barrier, the tile's
// resident maps (nmaps x n x rows_max x C values), then the f32 rows.
// Forward: part (n x 2C; later the gates), sq (n x 2C), e (n x Dp).
// Backward: part (n x 2C; later dsq), dz (n x 2C; first the joint squeeze),
// g (n x 2C), de (n x Dp; first pre).  tmp is the scratch of the row reduction
// (kThreads x V floats) and, backward, of the column products (kWarps x n x
// 32 floats).
struct Layout {
  size_t maps, part, sq, e, dz, g, de, tmp, total;
  __host__ __device__ Layout(int n, int nmaps, int rows_max, int C, int D, int itemsize, bool backward) {
    const size_t Dp = (size_t)((D + 3) / 4 * 4);
    const size_t row2 = (size_t)n * 2 * C * 4;
    const int V = 16 / itemsize;
    maps = kBarrierBytes;
    part = maps + (size_t)nmaps * n * rows_max * C * itemsize;
    if (!backward) {
      sq = part + row2;
      e = sq + row2;
      tmp = e + (size_t)n * Dp * 4;
      total = tmp + (size_t)kThreads * 4 * V;
      dz = g = de = 0;
    } else {
      dz = part + row2;
      g = dz + row2;
      de = g + row2;
      tmp = de + (size_t)n * Dp * 4;
      total = tmp + (size_t)kThreads * 4 * (n > V ? n : V);
      sq = e = 0;
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The CTA's mbarrier, armed once for every tile's loads.
__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// L2 policies: the maps pass through once (evict first); the weights are read
// by every tile of every cluster (evict last).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Thread 0 only: arm `bar` for this CTA's shares of the tile's resident maps
// and issue one bulk copy per (map, sample) into dst (nmaps x n x rows_max x
// C values).  The caller has synchronised the block after the previous
// tile's last reads of dst, and the proxy fence orders those reads before the
// copies' writes.
template <typename T>
__device__ void issue_tile(const T* const* src, int nmaps, T* dst, uint64_t* bar, int n, int nb, int b0, int S,
                           int s0, int ns, int rows_max, int C) {
  const uint32_t bytes = (uint32_t)ns * C * sizeof(T);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes * nmaps * nb)
               : "memory");
  const uint64_t policy = l2_evict_first();
  for (int m = 0; m < nmaps && bytes; ++m)
    for (int j = 0; j < nb; ++j)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(
              smem_addr(dst + ((size_t)(m * n + j) * rows_max) * C)),
          "l"(src[m] + ((size_t)(b0 + j) * S + s0) * C), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
          : "memory");
}

// Every thread waits for the phase of `bar` with this parity to complete.
__device__ __forceinline__ void wait_barrier(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// out[q * C + c] = sum over `rows` rows of a_q[s, c] (kProduct: a_q[s, c] *
// b_q[s, c]) for the nsets row sets a_q = rows_a(q), b_q = rows_b(q) of rows
// x C values each, in shared or global memory.  One pass over every set with
// 16-byte loads along C: a thread sums one vector column of one set over a
// fixed phase of its rows; where there are fewer columns than threads, the
// phases are added in order through tmp (at most kThreads x V floats).
template <typename T, bool kProduct, class RowsA, class RowsB>
__device__ void reduce_sets(RowsA rows_a, RowsB rows_b, int nsets, int rows, int C, float* tmp, float* out) {
  constexpr int V = 16 / sizeof(T);
  const int CV = C / V, cols = nsets * CV;
  const int P = cols < kThreads ? kThreads / cols : 1;
  for (int it = threadIdx.x; it < cols * P; it += kThreads) {
    const int col = it % cols, ph = it / cols, q = col / CV, cv = col % CV;
    const T* pa = rows_a(q) + cv * V;
    const T* pb = kProduct ? rows_b(q) + cv * V : nullptr;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll 8
    for (int s = ph; s < rows; s += P) {
      const uint4 ra = *reinterpret_cast<const uint4*>(pa + (size_t)s * C);
      const T* va = reinterpret_cast<const T*>(&ra);
      if constexpr (kProduct) {
        const uint4 rb = *reinterpret_cast<const uint4*>(pb + (size_t)s * C);
        const T* vb = reinterpret_cast<const T*>(&rb);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(to_f32<T>(va[i]), to_f32<T>(vb[i]), acc[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += to_f32<T>(va[i]);
      }
    }
    float* dst = P == 1 ? out + (size_t)col * V : tmp + ((size_t)ph * cols + col) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = acc[i];
  }
  if (P > 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < cols * V; i += kThreads) {
      float total = 0.f;
      for (int p = 0; p < P; ++p) total += tmp[(size_t)p * cols * V + i];
      out[i] = total;
    }
  }
  __syncthreads();
}

// The K CTAs' partial sums at part[4 i .. 4 i + 3] (over DSMEM), added in rank
// order: the same bits in every CTA.  All K loads are issued before the adds.
__device__ __forceinline__ float4 cluster_sum4(cg::cluster_group& cluster, float* part, int i) {
  const int K = (int)cluster.num_blocks();
  float4 v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (r < K) v[r] = reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r))[i];
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (r < K) {
      t.x += v[r].x;
      t.y += v[r].y;
      t.z += v[r].z;
      t.w += v[r].w;
    }
  }
  return t;
}

// VW values of T, loaded as one unit of VW * sizeof(T) bytes (read-only
// path) and kept raw in registers until they are used.
template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };

template <typename T, int VW>
struct Raw {
  typename RawOf<VW * sizeof(T)>::type bits;
  // a weight: read-only path, kept in L2 (evict last)
  __device__ __forceinline__ void load(const T* p) {
    constexpr int BYTES = VW * sizeof(T);
    const uint64_t policy = l2_evict_last();
    if constexpr (BYTES == 16)
      asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
          : "=r"(bits.x), "=r"(bits.y), "=r"(bits.z), "=r"(bits.w) : "l"(p), "l"(policy));
    else if constexpr (BYTES == 8)
      asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;" : "=r"(bits.x), "=r"(bits.y) : "l"(p), "l"(policy));
    else if constexpr (BYTES == 4)
      asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(bits) : "l"(p), "l"(policy));
    else
      asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;" : "=h"(bits) : "l"(p), "l"(policy));
  }
  __device__ __forceinline__ float operator[](int i) const { return to_f32<T>(reinterpret_cast<const T*>(&bits)[i]); }
};

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The weights of the products come from L2 and would leave a warp waiting on
// one load at a time: each lane keeps kInFlight loads in flight.  More loads,
// or more outputs a warp in row_product, cost registers and spill (at most
// 128 a thread with one 512-thread CTA an SM).
constexpr int kInFlight = 4;

// out[j * ldo + o] = act(sum_k x[j * ldx + k] * W[o, k] + bias[o]) for o in
// [o0, o1) and samples j < nb; W is (N, K) row-major in T, x f32 in shared
// memory (rounded to T first when kRoundX).  A warp computes R outputs
// together (each x value read from shared memory once for R weight rows),
// lanes along k (VW values each), a butterfly over the lanes: the order is
// fixed.
enum Act { kNone = 0, kRelu = 1, kSigmoid = 2 };

template <typename T, int ACT, bool kRoundX, int VW, int NT>
__device__ void row_product_vw(const float* x, int ldx, int K, const T* __restrict__ W, const T* __restrict__ bias,
                               int o0, int o1, int nb, float* out, int ldo) {
  constexpr int R = 2;              // R x NT accumulators a thread
  constexpr int U = kInFlight / R;  // loads in flight a weight row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int ob = o0 + warp * R; ob < o1; ob += kWarps * R) {
    float acc[R][NT];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[r][j] = 0.f;
    for (int k0 = lane * VW; k0 < K; k0 += 32 * VW * U) {
      Raw<T, VW> w[R][U] = {};
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ob + r < o1 && k0 + u * 32 * VW < K) w[r][u].load(W + (size_t)(ob + r) * K + k0 + u * 32 * VW);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u * 32 * VW;
        if (k >= K) break;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nb) {
            float xs[VW];
            if constexpr (VW % 4 == 0) {  // 16-byte shared-memory loads (k and ldx are multiples of 4)
#pragma unroll
              for (int i = 0; i < VW; i += 4) *reinterpret_cast<float4*>(xs + i) = *reinterpret_cast<const float4*>(x + j * ldx + k + i);
            } else {
#pragma unroll
              for (int i = 0; i < VW; ++i) xs[i] = x[j * ldx + k + i];
            }
#pragma unroll
            for (int i = 0; i < VW; ++i) {
              const float xv = kRoundX ? round_to<T>(xs[i]) : xs[i];
#pragma unroll
              for (int r = 0; r < R; ++r) acc[r][j] = fmaf(w[r][u][i], xv, acc[r][j]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nb)  // nb is the same in every lane
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = ob + r;
        if (o >= o1) break;
        const float bn = to_f32<T>(bias[o]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nb) {
            const float z = acc[r][j] + bn;
            out[j * ldo + o] = ACT == kRelu ? fmaxf(z, 0.f) : ACT == kSigmoid ? 1.f / (1.f + expf(-z)) : z;
          }
        }
      }
    }
  }
}

template <typename T, int ACT, bool kRoundX, int NT>
__device__ void row_product(const float* x, int ldx, int K, const T* __restrict__ W, const T* __restrict__ bias, int o0,
                            int o1, int nb, float* out, int ldo) {
  constexpr int V = 16 / sizeof(T);
  if (K % V == 0 && aligned16(W))
    row_product_vw<T, ACT, kRoundX, V, NT>(x, ldx, K, W, bias, o0, o1, nb, out, ldo);
  else
    row_product_vw<T, ACT, kRoundX, 1, NT>(x, ldx, K, W, bias, o0, o1, nb, out, ldo);
}

// epi(j, o, sum_k x[j * ldx + k] * W(k, o)) for o in [o0, o1) and j < nb,
// where W(k, o) is wa[k * ldw + o] for k < Ka and wb[(k - Ka) * ldw + o] after.
// 32 outputs a pass: a lane reads VW neighbouring outputs of a weight row (a
// warp reads 32 / VW rows, each one coalesced run), the kWarps warps and the
// VW lane groups split k; the lane groups are added by a butterfly and the
// warps' sums in order through red (kWarps x nb x 32 floats).
template <typename T, int VW, int NT, class Epi>
__device__ void col_product_vw(const float* x, int ldx, int K, int Ka, const T* __restrict__ wa,
                               const T* __restrict__ wb, int ldw, int o0, int o1, int nb, float* red, Epi epi) {
  constexpr int G = 32 / VW;  // lanes along the outputs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = lane % G, phase = warp * VW + lane / G, P = kWarps * VW;
  for (int ob = o0; ob < o1; ob += 32) {
    const int o = ob + col * VW;
    float acc[NT][VW];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < VW; ++i) acc[j][i] = 0.f;
    if (o < o1) {
      for (int k0 = phase; k0 < K; k0 += P * kInFlight) {
        Raw<T, VW> w[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int k = k0 + u * P;
          if (k < K) w[u].load(k < Ka ? wa + (size_t)k * ldw + o : wb + (size_t)(k - Ka) * ldw + o);
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int k = k0 + u * P;
          if (k >= K) break;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j < nb) {
              const float xv = x[j * ldx + k];
#pragma unroll
              for (int i = 0; i < VW; ++i) acc[j][i] = fmaf(xv, w[u][i], acc[j][i]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nb)  // nb is the same in every lane
#pragma unroll
        for (int i = 0; i < VW; ++i)
#pragma unroll
          for (int off = G; off < 32; off <<= 1) acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], off);
    if (lane < G) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nb)
#pragma unroll
          for (int i = 0; i < VW; ++i) red[(warp * nb + j) * 32 + col * VW + i] = acc[j][i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb * 32; i += kThreads) {
      const int j = i / 32, l = i % 32;
      if (ob + l < o1) {
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += red[(w * nb + j) * 32 + l];
        epi(j, ob + l, total);
      }
    }
    __syncthreads();
  }
}

template <typename T, int NT, class Epi>
__device__ void col_product(const float* x, int ldx, int K, int Ka, const T* __restrict__ wa,
                            const T* __restrict__ wb, int ldw, int o0, int o1, int nb, float* red, Epi epi) {
  constexpr int V = 4;  // 16-byte loads in f32, 8-byte in bf16: 4 accumulators a sample
  if (o0 % V == 0 && (o1 - o0) % V == 0 && ldw % V == 0 && aligned16(wa) && aligned16(wb))
    col_product_vw<T, V, NT>(x, ldx, K, Ka, wa, wb, ldw, o0, o1, nb, red, epi);
  else
    col_product_vw<T, 1, NT>(x, ldx, K, Ka, wa, wb, ldw, o0, o1, nb, red, epi);
}

// Stores this CTA's slice [lo, lo + size) of each of nb rows (row stride ld)
// of buf into the same places of every other CTA's buf (DSMEM stores); the
// cluster.sync() that follows makes them visible.
__device__ __forceinline__ void push_slice(cg::cluster_group& cluster, float* buf, int lo, int size, int ld, int nb) {
  const int K = (int)cluster.num_blocks(), me = (int)cluster.block_rank(), per = nb * size;
  __syncthreads();  // the slice is written
  for (int i = threadIdx.x; i < (K - 1) * per; i += kThreads) {
    const int r = i / per + (i / per >= me), j = i % per / size, o = lo + i % per % size;
    cluster.map_shared_rank(buf, r)[j * ld + o] = buf[j * ld + o];
  }
}

// Kernels this library has launched: every launch the runtime accepts adds
// one (read with mmtm_cuda_launches(), so a caller can count a call's launches).
inline std::atomic<unsigned long long> launched{0};

inline cudaError_t count_launch(cudaError_t err) {
  if (err == cudaSuccess) launched.fetch_add(1);
  return err;
}

// Launch `kernel` as tiles clusters of K CTAs with smem bytes of dynamic
// shared memory each; returns the launch's error.
template <typename Kernel, typename Args>
cudaError_t launch_clusters(Kernel kernel, const Args& args, int tiles, int K, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)tiles * K, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return count_launch(cudaGetLastError());
}

// How many clusters of K CTAs with smem bytes each can be resident at once.
template <typename Kernel>
cudaError_t max_active_clusters(Kernel kernel, int K, int smem, int* count) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)K, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(count, (void*)kernel, &config);
}

}  // namespace mmtm

// The count of kernels this library has launched (mmtm::launched).
extern "C" unsigned long long mmtm_cuda_launches() { return mmtm::launched.load(); }
