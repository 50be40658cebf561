// Fused MMTM gating backward for Hopper (sm_90a).
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
// What bounds it on an H100: memory.  The least traffic is one read of do0,
// do1, f0, f1 and one write of df0, df1 (six map streams); the row products
// are O(B * C * D) multiply-adds, far below the arithmetic rate.  The TPU
// kernel holds a batch block of all four maps in VMEM and reads each once.
// One sample at the first fusion site is 400 KB per map in f32, beyond the
// 227 KB of shared memory a block may use, and df_i needs dsq_i, which needs
// the full spatial reduction of the same sample first.  So this first design
// runs in passes and reads do_i twice (eight streams, 1.33x the bound):
//
//   1. dgate: one block per (channel tile, sample, modality) reduces
//      do_i * f_i over S (warp loads along C) and applies the sigmoid
//      backward -> dz_i;
//   2. the row chain, three small products over tiles of 8 samples:
//      pre (a warp per output, lanes along the input), de and dsq (lanes
//      along the outputs, so each weight row is one coalesced read);
//   3. df: the elementwise pass with 16-byte vector loads and stores;
//   4. weight gradients: each block owns a 16 x 64 tile of one weight
//      gradient and walks the batch in order.
//
// The TPU grid runs in order and accumulates the weight gradients into
// revisited output blocks (:211-226).  Hopper blocks run in no order, so
// instead of float atomics each output element is summed over the batch by
// one thread in a fixed order: two runs give the same bits, and rows past B
// are never read.

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

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSampleTile = 8;
constexpr int kOutTile = 32;

// ---- pass 1: dgate ------------------------------------------------------------
// grid (ceil(C / 32), B, 2); lane = channel within the tile, warp = row phase.
template <typename T>
__global__ void __launch_bounds__(kThreads) dgate_kernel(
    const T* __restrict__ do0, const T* __restrict__ do1, const T* __restrict__ f0, const T* __restrict__ f1,
    const float* __restrict__ g0, const float* __restrict__ g1, const float* __restrict__ dg0c,
    const float* __restrict__ dg1c, float* __restrict__ dz0, float* __restrict__ dz1, int S, int C) {
  const bool second = blockIdx.z == 1;
  const T* dout = second ? do1 : do0;
  const T* f = second ? f1 : f0;
  const float* g = second ? g1 : g0;
  const float* dgc = second ? dg1c : dg0c;
  float* dz = second ? dz1 : dz0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
  if (c < C) {
    const size_t base = (size_t)b * S * C + c;
#pragma unroll 4
    for (int s = warp; s < S; s += kWarps) {
      const size_t i = base + (size_t)s * C;
      acc = fmaf(to_f32<T>(dout[i]), to_f32<T>(f[i]), acc);
    }
  }
  __shared__ float part[kWarps][32];
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && c < C) {
    float dg = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) dg += part[w][lane];
    const size_t i = (size_t)b * C + c;
    if (dgc != nullptr) dg += dgc[i];
    const float gv = g[i];
    dz[i] = dg * gv * (1.f - gv);
  }
}

// ---- pass 2a: pre = [sq0, sq1] . Wsq^T + bsq ------------------------------------
// A warp per output d, lanes along the 2C inputs of Wsq's row d; the tile's
// 8 joint rows sit in shared memory.  grid (ceil(D / 32), ceil(B / 8)).
template <typename T>
__global__ void __launch_bounds__(kThreads) pre_kernel(
    const float* __restrict__ sq0, const float* __restrict__ sq1, const T* __restrict__ wsq,
    const T* __restrict__ bsq, float* __restrict__ pre, int B, int C, int D) {
  extern __shared__ float xs[];  // [kSampleTile][2C]
  const int K = 2 * C;
  const int b0 = blockIdx.y * kSampleTile;
  const int nb = min(kSampleTile, B - b0);
  for (int i = threadIdx.x; i < kSampleTile * K; i += kThreads) {
    const int s = i / K, k = i - s * K;
    float v = 0.f;
    if (s < nb) v = k < C ? sq0[(size_t)(b0 + s) * C + k] : sq1[(size_t)(b0 + s) * C + (k - C)];
    xs[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < kOutTile; j += kWarps) {
    const int n = blockIdx.x * kOutTile + j;
    if (n >= D) break;
    const T* __restrict__ wrow = wsq + (size_t)n * K;
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
      const float bn = to_f32<T>(bsq[n]);
      for (int s = 0; s < nb; ++s) pre[(size_t)(b0 + s) * D + n] = acc[s] + bn;
    }
  }
}

// ---- passes 2b and 2c: column products --------------------------------------------
// out[b, n] = sum_k x[b, k] * W[k, n] with x = [xa (B, Ka) | xb (B, K - Ka)] and
// W's rows k < Ka from wa (Ka, N), the others from wb (K - Ka, N), row-major.
// Lanes run along n (each weight row is one coalesced read), warps split k,
// and the warps' partial sums add up in shared memory in a fixed order.
// grid (ceil(N / 32), ceil(B / 8)).
enum Epilogue {
  kMaskByPre = 0,  // de:  out[b, n] = acc * (pre[b, n] > 0)
  kSplitAdd = 1,   // dsq: n < Nsplit -> out[b, n] = acc + ca[b, n], else outb[b, n - Nsplit] = acc + cb[...]
};

template <typename T>
struct ColArgs {
  const float* xa;
  const float* xb;
  const T* wa;
  const T* wb;
  int Ka, K, N, B;
  const float* pre;
  float* out;
  float* outb;
  const float* ca;
  const float* cb;
  int Nsplit;
};

template <typename T, int EPI>
__global__ void __launch_bounds__(kThreads) col_product_kernel(ColArgs<T> a) {
  extern __shared__ float xs[];  // [kSampleTile][K]
  __shared__ float part[kWarps][kSampleTile][32];
  const int K = a.K, Ka = a.Ka, Kb = a.K - a.Ka;
  const int b0 = blockIdx.y * kSampleTile;
  const int nb = min(kSampleTile, a.B - b0);
  for (int i = threadIdx.x; i < kSampleTile * K; i += kThreads) {
    const int s = i / K, k = i - s * K;
    float v = 0.f;
    if (s < nb) v = k < Ka ? a.xa[(size_t)(b0 + s) * Ka + k] : a.xb[(size_t)(b0 + s) * Kb + (k - Ka)];
    xs[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kOutTile + lane;
  float acc[kSampleTile];
#pragma unroll
  for (int s = 0; s < kSampleTile; ++s) acc[s] = 0.f;
  if (n < a.N) {
    for (int k = warp; k < K; k += kWarps) {
      const float wv = k < Ka ? to_f32<T>(a.wa[(size_t)k * a.N + n]) : to_f32<T>(a.wb[(size_t)(k - Ka) * a.N + n]);
#pragma unroll
      for (int s = 0; s < kSampleTile; ++s) acc[s] = fmaf(xs[s * K + k], wv, acc[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < kSampleTile; ++s) part[warp][s][lane] = acc[s];
  __syncthreads();

  // 256 threads = 8 samples x 32 outputs: warp = sample, lane = output.
  const int s = warp;
  if (s >= nb || n >= a.N) return;
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += part[w][s][lane];
  const int b = b0 + s;
  if (EPI == kMaskByPre) {
    const size_t i = (size_t)b * a.N + n;
    a.out[i] = a.pre[i] > 0.f ? total : 0.f;
  } else {
    const int second = n >= a.Nsplit;
    const int width = second ? a.N - a.Nsplit : a.Nsplit;
    const size_t i = (size_t)b * width + (second ? n - a.Nsplit : n);
    const float* c = second ? a.cb : a.ca;
    (second ? a.outb : a.out)[i] = c != nullptr ? total + c[i] : total;
  }
}

// ---- pass 3: df ------------------------------------------------------------------
// One 16-byte vector per thread; C is a multiple of the vector width, so a
// vector never straddles two samples.  grid (blocks, 1, 2).
template <typename T>
__global__ void __launch_bounds__(kThreads) df_kernel(
    const T* __restrict__ do0, const T* __restrict__ do1, const float* __restrict__ g0,
    const float* __restrict__ g1, const float* __restrict__ dsq0, const float* __restrict__ dsq1,
    T* __restrict__ df0, T* __restrict__ df1, int S, int C, size_t nvec) {
  constexpr int kVec = 16 / sizeof(T);
  const bool second = blockIdx.z == 1;
  const uint4* dout = reinterpret_cast<const uint4*>(second ? do1 : do0);
  uint4* df = reinterpret_cast<uint4*>(second ? df1 : df0);
  const float* g = second ? g1 : g0;
  const float* dsq = second ? dsq1 : dsq0;
  const size_t per_sample = (size_t)S * C;
  const float fs = (float)S;
  for (size_t v = (size_t)blockIdx.x * kThreads + threadIdx.x; v < nvec; v += (size_t)gridDim.x * kThreads) {
    const size_t e = v * kVec;
    const size_t row = (e / per_sample) * C + (e % C);
    uint4 raw = dout[v];
    T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) vals[j] = from_f32<T>(to_f32<T>(vals[j]) * g[row + j] + dsq[row + j] / fs);
    df[v] = raw;
  }
}

// ---- pass 4: weight gradients -------------------------------------------------------
// out[n, k] = sum_b x[b, n] * y[b, k], bias[n] = sum_b x[b, n], with
// y = [ya (B, Ka) | yb (B, K - Ka)] (relu'd when relu_y).  Up to three such
// problems in one launch (blockIdx.z).  A block owns a 16 x 64 output tile and
// walks the batch in chunks of 32 rows staged in shared memory; thread
// (ty, tx) owns outputs (ty + 4i, tx), i < 4, and adds them over b in order.
constexpr int kOuterN = 16;
constexpr int kOuterK = 64;
constexpr int kChunk = 32;

struct OuterProblem {
  const float* x;
  const float* ya;
  const float* yb;
  int N, K, Ka, relu_y;
  float* out;
  float* bias;
};

struct OuterArgs {
  OuterProblem p[3];
  int B;
};

__global__ void __launch_bounds__(kThreads) outer_kernel(OuterArgs args) {
  const OuterProblem p = args.p[blockIdx.z];
  const int n0 = blockIdx.y * kOuterN, k0 = blockIdx.x * kOuterK;
  if (n0 >= p.N || k0 >= p.K) return;  // uniform over the block
  __shared__ float xs[kChunk][kOuterN];
  __shared__ float ys[kChunk][kOuterK];
  const int tx = threadIdx.x % kOuterK, ty = threadIdx.x / kOuterK;  // ty < 4
  const int Kb = p.K - p.Ka;
  const bool bias_thread = p.bias != nullptr && blockIdx.x == 0 && tx == 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float bacc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < args.B; b0 += kChunk) {
    const int nb = min(kChunk, args.B - b0);
    for (int i = threadIdx.x; i < kChunk * kOuterN; i += kThreads) {
      const int r = i / kOuterN, j = i - r * kOuterN;
      xs[r][j] = (r < nb && n0 + j < p.N) ? p.x[(size_t)(b0 + r) * p.N + n0 + j] : 0.f;
    }
    for (int i = threadIdx.x; i < kChunk * kOuterK; i += kThreads) {
      const int r = i / kOuterK, j = i - r * kOuterK, k = k0 + j;
      float v = 0.f;
      if (r < nb && k < p.K) v = k < p.Ka ? p.ya[(size_t)(b0 + r) * p.Ka + k] : p.yb[(size_t)(b0 + r) * Kb + (k - p.Ka)];
      ys[r][j] = p.relu_y ? fmaxf(v, 0.f) : v;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 4 * i;
    if (n >= p.N) continue;
    if (k < p.K) p.out[(size_t)n * p.K + k] = acc[i];
    if (bias_thread) p.bias[n] = bacc[i];
  }
}

struct Buffers {
  const void *do0, *do1, *f0, *f1;
  const float *g0, *g1, *sq0, *sq1;
  const void *wsq, *bsq, *w0, *w1;
  const float *dg0c, *dg1c, *dsq0c, *dsq1c;
  void *df0, *df1;
  float *dwsq, *dbsq, *dw0, *db0, *dw1, *db1;
  float *dz0, *dz1, *pre, *de, *dsq0, *dsq1;
};

template <typename T>
cudaError_t launch(const Buffers& m, int B, int S, int C, int D, cudaStream_t stream) {
  const T* tdo0 = static_cast<const T*>(m.do0);
  const T* tdo1 = static_cast<const T*>(m.do1);
  const T* wsq = static_cast<const T*>(m.wsq);

  dgate_kernel<T><<<dim3((C + 31) / 32, B, 2), kThreads, 0, stream>>>(
      tdo0, tdo1, static_cast<const T*>(m.f0), static_cast<const T*>(m.f1), m.g0, m.g1, m.dg0c, m.dg1c, m.dz0,
      m.dz1, S, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int sample_tiles = (B + kSampleTile - 1) / kSampleTile;
  pre_kernel<T><<<dim3((D + kOutTile - 1) / kOutTile, sample_tiles), kThreads, sizeof(float) * kSampleTile * 2 * C,
                  stream>>>(m.sq0, m.sq1, wsq, static_cast<const T*>(m.bsq), m.pre, B, C, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ColArgs<T> de{m.dz0, m.dz1, static_cast<const T*>(m.w0), static_cast<const T*>(m.w1), C, 2 * C, D, B,
                m.pre, m.de, nullptr, nullptr, nullptr, D};
  col_product_kernel<T, kMaskByPre><<<dim3((D + kOutTile - 1) / kOutTile, sample_tiles), kThreads,
                                      sizeof(float) * kSampleTile * 2 * C, stream>>>(de);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  ColArgs<T> dsq{m.de, m.de, wsq, wsq, D, D, 2 * C, B, nullptr, m.dsq0, m.dsq1, m.dsq0c, m.dsq1c, C};
  col_product_kernel<T, kSplitAdd><<<dim3((2 * C + kOutTile - 1) / kOutTile, sample_tiles), kThreads,
                                     sizeof(float) * kSampleTile * D, stream>>>(dsq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t nvec = (size_t)B * S * C / (16 / sizeof(T));
  const size_t blocks = (nvec + kThreads - 1) / kThreads;
  const unsigned grid_x = (unsigned)(blocks < 65535 ? blocks : 65535);
  df_kernel<T><<<dim3(grid_x, 1, 2), kThreads, 0, stream>>>(tdo0, tdo1, m.g0, m.g1, m.dsq0, m.dsq1,
                                                           static_cast<T*>(m.df0), static_cast<T*>(m.df1), S, C, nvec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  OuterArgs outer{{{m.de, m.sq0, m.sq1, D, 2 * C, C, 0, m.dwsq, m.dbsq},
                   {m.dz0, m.pre, m.pre, C, D, D, 1, m.dw0, m.db0},
                   {m.dz1, m.pre, m.pre, C, D, D, 1, m.dw1, m.db1}},
                  B};
  const int max_n = D > C ? D : C;
  const int max_k = 2 * C > D ? 2 * C : D;
  outer_kernel<<<dim3((max_k + kOuterK - 1) / kOuterK, (max_n + kOuterN - 1) / kOuterN, 3), kThreads, 0, stream>>>(
      outer);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (the maps and the weights; sq, g, the row cotangents and every gradient of
// a weight are float32).  dg0c, dg1c, dsq0c, dsq1c may be null (a zero
// cotangent).  The wrapper (ops/mmtm_gating.py) checks shapes, dtypes,
// contiguity and alignment and allocates every output and the f32 scratch
// rows dz0, dz1 (B, C), pre, de (B, D), dsq0, dsq1 (B, C).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int mmtm_gating_backward(const void* do0, const void* do1, const void* f0, const void* f1,
                                    const void* g0, const void* g1, const void* sq0, const void* sq1,
                                    const void* wsq, const void* bsq, const void* w0, const void* w1,
                                    const void* dg0c, const void* dg1c, const void* dsq0c, const void* dsq1c,
                                    void* df0, void* df1, void* dwsq, void* dbsq, void* dw0, void* db0, void* dw1,
                                    void* db1, void* dz0, void* dz1, void* pre, void* de, void* dsq0, void* dsq1,
                                    int B, int S, int C, int D, int dtype, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const Buffers m{do0, do1, f0, f1, f(g0), f(g1), f(sq0), f(sq1), wsq, bsq, w0, w1,
                  f(dg0c), f(dg1c), f(dsq0c), f(dsq1c), df0, df1, w(dwsq), w(dbsq), w(dw0), w(db0), w(dw1), w(db1),
                  w(dz0), w(dz1), w(pre), w(de), w(dsq0), w(dsq1)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(m, B, S, C, D, st);
    case 1:
      return (int)launch<__nv_bfloat16>(m, B, S, C, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
