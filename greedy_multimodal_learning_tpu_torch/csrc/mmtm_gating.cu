// Fused MMTM gating forward for Hopper (sm_90a).
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
// What bounds it on an H100: memory.  The least traffic is one read of f0 and
// f1 and one write of out0 and out1; the two excitation products are
// B*(2C*D + 2*D*C) multiply-adds, far below the card's arithmetic rate.  The
// TPU kernel holds a whole batch block of both maps in VMEM and so reads each
// map once.  One sample at the first fusion site (784 x 128 values per
// modality, 400 KB in f32) exceeds the 227 KB of shared memory a block may
// use, so this first design runs four passes instead:
//
//   1. squeeze: one block per (channel tile, sample, modality) reduces over S
//      with warp loads that run along C (coalesced in the (B, S, C) layout);
//   2. excitation: e for a tile of samples x outputs, the sample tile's
//      rounded joint squeeze in shared memory, so each weight row read from
//      L2 serves every sample of the tile;
//   3. gates: the same product shape for g0 and g1 (blockIdx.z picks one);
//   4. scale: out_i = f_i * g_i with 16-byte vector loads and stores.
//
// The maps are read twice (passes 1 and 4), so the traffic is about 1.5x the
// bound.  A one-pass design that keeps the second read in L2, and wgmma for
// the products, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// The casts of the TPU kernel (mmtm_pallas.py:57,62,66,70): round an f32 value
// to T's precision and carry on in f32.
template <typename T> __device__ __forceinline__ float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// ---- pass 1: squeeze -------------------------------------------------------
// grid (ceil(C / 32), B, 2); lane = channel within the tile, warp = row phase.
template <typename T>
__global__ void __launch_bounds__(kThreads) squeeze_kernel(
    const T* __restrict__ f0, const T* __restrict__ f1, float* __restrict__ sq0, float* __restrict__ sq1,
    int S, int C) {
  const T* f = blockIdx.z == 0 ? f0 : f1;
  float* sq = blockIdx.z == 0 ? sq0 : sq1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < C) {
    const T* base = f + (size_t)b * S * C + c;
#pragma unroll 4
    for (int s = warp; s < S; s += kWarps) acc += to_f32<T>(base[(size_t)s * C]);
  }
  __shared__ float part[kWarps][32];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w][lane];
    sq[(size_t)b * C + c] = total / (float)S;
  }
}

// ---- passes 2 and 3: row products ------------------------------------------
// out[b, n] = act(sum_k round_T(x[b, k]) * W[n, k] + bias[n]), W in (N, K)
// row-major.  x is the concatenation of xa (B, Ka) and xb (B, K - Ka), so the
// excitation reads [sq0, sq1] without a joint copy.  grid (ceil(N / kOutTile),
// ceil(B / kSampleTile), z); z selects (W, bias, out) = (w[z], bias[z], out[z]).
constexpr int kSampleTile = 8;
constexpr int kOutTile = 32;
enum Act { kRelu = 0, kSigmoid = 1 };

template <typename T>
struct RowProductArgs {
  const float* xa;
  const float* xb;
  int Ka, K, N, B;
  const T* w[2];
  const T* bias[2];
  float* out[2];
};

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads) row_product_kernel(RowProductArgs<T> a) {
  extern __shared__ float xs[];  // [kSampleTile][K], rounded to T
  const T* __restrict__ W = a.w[blockIdx.z];
  const T* __restrict__ bias = a.bias[blockIdx.z];
  float* __restrict__ out = a.out[blockIdx.z];
  const int K = a.K, Ka = a.Ka, Kb = a.K - a.Ka;
  const int b0 = blockIdx.y * kSampleTile;
  const int nb = min(kSampleTile, a.B - b0);

  for (int i = threadIdx.x; i < kSampleTile * K; i += kThreads) {
    const int s = i / K, k = i - s * K;
    float v = 0.f;
    if (s < nb) {
      const int b = b0 + s;
      v = k < Ka ? a.xa[(size_t)b * Ka + k] : a.xb[(size_t)b * Kb + (k - Ka)];
      v = round_to<T>(v);
    }
    xs[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < kOutTile; j += kWarps) {
    const int n = blockIdx.x * kOutTile + j;
    if (n >= a.N) break;
    const T* __restrict__ wrow = W + (size_t)n * K;
    float acc[kSampleTile];
#pragma unroll
    for (int s = 0; s < kSampleTile; ++s) acc[s] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float wv = to_f32<T>(wrow[k]);
#pragma unroll
      for (int s = 0; s < kSampleTile; ++s) acc[s] = fmaf(wv, xs[s * K + k], acc[s]);
    }
#pragma unroll
    for (int s = 0; s < kSampleTile; ++s) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], off);
    }
    if (lane == 0) {
      const float bn = to_f32<T>(bias[n]);
#pragma unroll
      for (int s = 0; s < kSampleTile; ++s) {
        if (s < nb) {
          const float z = acc[s] + bn;
          out[(size_t)(b0 + s) * a.N + n] = ACT == kRelu ? fmaxf(z, 0.f) : 1.f / (1.f + expf(-z));
        }
      }
    }
  }
}

// ---- pass 4: scale -----------------------------------------------------------
// One 16-byte vector of f per thread; C is a multiple of the vector width, so a
// vector never straddles two samples.  grid (blocks, 1, 2).
template <typename T>
__global__ void __launch_bounds__(kThreads) scale_kernel(
    const T* __restrict__ f0, const T* __restrict__ f1, const float* __restrict__ g0,
    const float* __restrict__ g1, T* __restrict__ out0, T* __restrict__ out1, int S, int C, size_t nvec) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* f = reinterpret_cast<const uint4*>(blockIdx.z == 0 ? f0 : f1);
  uint4* out = reinterpret_cast<uint4*>(blockIdx.z == 0 ? out0 : out1);
  const float* g = blockIdx.z == 0 ? g0 : g1;
  const size_t per_sample = (size_t)S * C;
  for (size_t v = (size_t)blockIdx.x * kThreads + threadIdx.x; v < nvec; v += (size_t)gridDim.x * kThreads) {
    const size_t e = v * kVec;
    const size_t b = e / per_sample;
    const int c = (int)(e % C);
    const float* gb = g + b * C + c;
    uint4 raw = f[v];
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) vals[j] = from_f32<T>(to_f32<T>(vals[j]) * round_to<T>(gb[j]));
    out[v] = raw;
  }
}

template <typename T>
cudaError_t launch(const void* f0, const void* f1, const void* wsq, const void* bsq, const void* w0,
                   const void* b0, const void* w1, const void* b1, void* out0, void* out1, float* sq0,
                   float* sq1, float* e, float* g0, float* g1, int B, int S, int C, int D,
                   cudaStream_t stream) {
  const T* tf0 = static_cast<const T*>(f0);
  const T* tf1 = static_cast<const T*>(f1);

  squeeze_kernel<T><<<dim3((C + 31) / 32, B, 2), kThreads, 0, stream>>>(tf0, tf1, sq0, sq1, S, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int sample_tiles = (B + kSampleTile - 1) / kSampleTile;
  RowProductArgs<T> ex{sq0, sq1, C, 2 * C, D, B,
                       {static_cast<const T*>(wsq), nullptr},
                       {static_cast<const T*>(bsq), nullptr},
                       {e, nullptr}};
  const size_t ex_smem = sizeof(float) * kSampleTile * 2 * C;
  row_product_kernel<T, kRelu><<<dim3((D + kOutTile - 1) / kOutTile, sample_tiles, 1), kThreads, ex_smem, stream>>>(ex);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  RowProductArgs<T> gt{e, e, D, D, C, B,
                       {static_cast<const T*>(w0), static_cast<const T*>(w1)},
                       {static_cast<const T*>(b0), static_cast<const T*>(b1)},
                       {g0, g1}};
  const size_t gt_smem = sizeof(float) * kSampleTile * D;
  row_product_kernel<T, kSigmoid><<<dim3((C + kOutTile - 1) / kOutTile, sample_tiles, 2), kThreads, gt_smem, stream>>>(gt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t nvec = (size_t)B * S * C / (16 / sizeof(T));
  const size_t blocks = (nvec + kThreads - 1) / kThreads;
  const unsigned grid_x = (unsigned)(blocks < 65535 ? blocks : 65535);
  scale_kernel<T><<<dim3(grid_x, 1, 2), kThreads, 0, stream>>>(tf0, tf1, g0, g1, static_cast<T*>(out0),
                                                              static_cast<T*>(out1), S, C, nvec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// The wrapper (ops/mmtm_gating.py) checks shapes, dtypes, contiguity and
// alignment and allocates every output and the (B, D) f32 scratch `e`.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int mmtm_gating_forward(const void* f0, const void* f1, const void* wsq, const void* bsq,
                                   const void* w0, const void* b0, const void* w1, const void* b1,
                                   void* out0, void* out1, void* sq0, void* sq1, void* e, void* g0,
                                   void* g1, int B, int S, int C, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fsq0 = static_cast<float*>(sq0);
  float* fsq1 = static_cast<float*>(sq1);
  float* fe = static_cast<float*>(e);
  float* fg0 = static_cast<float*>(g0);
  float* fg1 = static_cast<float*>(g1);
  switch (dtype) {
    case 0:
      return (int)launch<float>(f0, f1, wsq, bsq, w0, b0, w1, b1, out0, out1, fsq0, fsq1, fe, fg0, fg1, B, S, C, D, st);
    case 1:
      return (int)launch<__nv_bfloat16>(f0, f1, wsq, bsq, w0, b0, w1, b1, out0, out1, fsq0, fsq1, fe, fg0, fg1, B,
                                        S, C, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
