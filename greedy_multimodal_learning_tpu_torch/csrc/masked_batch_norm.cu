// Masked train-mode BatchNorm for Hopper (sm_90a): the forward and the
// backward, one cooperative launch each.
//
// Replaces no Pallas kernel: the JAX package's TorchBatchNorm
// (greedy_multimodal_learning_tpu/models/layers.py:83-120) is plain jnp ops
// that XLA fuses on the TPU.  In the port those ops ran as generic PyTorch
// kernels, about 13 full passes over the map forward and 20 backward
// (models/layers.py::_MaskedBatchNorm, whose CPU path they still are).
//
// For x of shape (B, C, *spatial) with L positions a sample and a (B,) row
// weight m (the validity mask; 1 for every row without one), in float32
// whatever the map's dtype T:
//
//   n    = L * sum_b m_b
//   mean = sum m x / n                                        (phases 0, 1)
//   s2   = sum m (x - mean)^2,  R = sum m (x - mean)           (phases 2, 3)
//   rstd = rsqrt(s2 / n + eps),  y = (x - mean) * (rstd * w) + bias      (4)
//
// and, unless the call is a recompute, the running statistics take mean and
// s2 / n * (n / max(n - 1, 1)) at the momentum.  The backward, derived from
// the forward's graph (the direct term and the affine's gradients over every
// row, the statistics' terms through m_b / n only):
//
//   A = sum dy,  Bs = sum dy (x - mean)       over every row   (phases 0, 1)
//   dbias = A,  dweight = Bs * rstd
//   k = -Bs * w * rstd^3 / n,  c0 = (rstd * w * A + k * R) / n
//   dx = dy * (rstd * w) + m_b * (k * (x - mean) - c0)          (phase 2)
//
// With `relu`, the forward writes max(y, 0) and the backward zeroes dy where
// the recomputed y is not positive (the ReLU that follows a BatchNorm).
//
// What bounds it on an H100: bytes.  The forward reads x for the sums, again
// for the centred sums, again to normalize, and writes y; the backward reads
// dy and x for its sums, again for dx, and writes dx: 8 passes of the map's
// size in all.  At the 2-D cell's 20 sites (B=128, 224², f32) a pass over
// one tower's maps is 1.27 GB.  The small maps (layer 3-4, 13-26 MB) come
// back from the 50 MB L2 on their second and third reads.
//
// Design.  One cooperative grid of co-resident 256-thread blocks (as many as
// the card holds, fewer where the map has less work) runs every phase, with
// a grid barrier between phases.  Each block owns a fixed run of the map:
//
//   * channels-last (the models' layout): row r of the B*L rows holds C
//     contiguous values.  A thread owns one 16-byte vector of channels and
//     walks every lanes-th row of its block's run, kUnroll rows in flight;
//     the block adds its lanes' sums in lane order into its partial row.
//   * contiguous NCHW / NCDHW: plane (b, c) holds L contiguous values; a warp
//     sums a plane, and the partial row of sample b holds its planes' sums.
//
// A phase that reduces the partial rows gives each (sum, channel) to one
// block, whose threads add every 256th partial in order and then a fixed
// tree.  No float atomics, and the grid depends only on the shape, the dtype
// and the card, so two runs give the same bits.  Under data parallelism the
// wrapper (ops/masked_batch_norm.py) runs the phases in three launches
// forward (0-1, 2-3, 4) and two backward (0-1, 2), all-reducing the sums
// between them.

#include <atomic>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Kernels this library has launched: each launch the runtime accepts adds one.
std::atomic<unsigned long long> launched{0};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// V values of T moved as one aligned load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

template <typename T>
struct Args {
  const T* x;
  const T* dy;          // backward: the output's gradient, in x's layout
  T* out;               // forward: y; backward: dx
  const float* mask;    // (B,) row weights, or null: every row
  const float* weight;  // (C,)
  const float* bias;    // (C,)
  float* running_mean;  // forward, updated when `update`
  float* running_var;
  float* part;          // (parts, 2, C) partial sums
  float* stats;         // s1 (C) | n | s2 (C) | R (C) | mean (C) | rstd (C); the backward reads it
  float* red;           // backward: A (C) | Bs (C)
  float* dweight;       // backward, (C,)
  float* dbias;
  long long L;          // positions a sample
  int B, C;
  float eps, momentum, keep;  // keep = 1 - momentum
  int update, relu, lo, hi;   // phases lo..hi run
};

// Offsets into `stats` (ops/masked_batch_norm.py::STATS agrees).
struct StatsAt {
  int s1, n, s2, r, mean, rstd;
};

__host__ __device__ __forceinline__ StatsAt stats_at(int C) {
  return {0, C, C + 1, 2 * C + 1, 3 * C + 1, 4 * C + 1};
}

// [lo, hi) is part r of `total` items split into `parts` nearly equal runs.
__device__ __forceinline__ void split(long long total, int parts, int r, long long& lo, long long& hi) {
  const long long q = total / parts, rem = total % parts;
  lo = r * q + (r < rem ? r : rem);
  hi = lo + q + (r < rem ? 1 : 0);
}

__device__ __forceinline__ float row_weight(const float* mask, long long b) { return mask ? mask[b] : 1.0f; }

// y before the ReLU, rounded the same way in the forward and the backward so
// that the backward's gate sees the forward's sign.
__device__ __forceinline__ float affine(float x, float mean, float inv, float shift) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, mean), inv), shift);
}

// The sum of every thread's v, in a fixed tree; every thread gets it.
__device__ float block_sum(float v, float* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

// The sum of a warp's v in a fixed tree, in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Per-channel constants of one channel for each kind of pass.
struct Channel {
  float mean, inv, shift, k, c0;
};

// A channel's constants for a pass.  MODE 1 (centred sums): the mean from
// the sums.  MODE 2 (backward sums): the saved mean and rstd, inv = rstd * w
// and the bias.  MODE 3 (normalize): the same from the sums, by the
// expressions that saved them.  MODE 4 (dx): MODE 2's, and k and c0 from red
// (the backward's A and Bs).
template <int MODE, typename T>
__device__ __forceinline__ Channel channel(const Args<T>& a, int c) {
  const StatsAt at = stats_at(a.C);
  Channel ch{};
  float rstd;
  if (MODE == 1 || MODE == 3) {
    const float n = a.stats[at.n];
    ch.mean = __fdiv_rn(a.stats[at.s1 + c], n);
    if (MODE == 1) return ch;
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(a.stats[at.s2 + c], n), a.eps));
  } else {
    ch.mean = a.stats[at.mean + c];
    rstd = a.stats[at.rstd + c];
  }
  const float w = a.weight[c];
  ch.inv = __fmul_rn(rstd, w);
  ch.shift = a.bias[c];
  if (MODE == 4) {
    const float n = a.stats[at.n], A = a.red[c], Bs = a.red[a.C + c];
    ch.k = -__fdiv_rn(Bs * w * (rstd * rstd * rstd), n);
    ch.c0 = __fdiv_rn(ch.inv * A + ch.k * a.stats[at.r + c], n);
  }
  return ch;
}

// One element's contributions to the two sums of a pass: MODE 0, m x; MODE 1,
// m (x - mean)^2 and m (x - mean); MODE 2, g and g (x - mean), g = dy behind
// the ReLU's gate.
template <int MODE>
__device__ __forceinline__ void accumulate(float x, float g, float wt, const Channel& ch, bool relu, float& s0,
                                           float& s1) {
  if (MODE == 0) {
    s0 += x * wt;
  } else if (MODE == 1) {
    const float d = x - ch.mean;
    s0 += (d * d) * wt;
    s1 += d * wt;
  } else {
    if (relu && !(affine(x, ch.mean, ch.inv, ch.shift) > 0.0f)) g = 0.0f;
    s0 += g;
    s1 += g * (x - ch.mean);
  }
}

// One element of the forward's output (DX false) or of dx (DX true).
template <bool DX>
__device__ __forceinline__ float apply(float x, float g, float wt, const Channel& ch, bool relu) {
  const float y = affine(x, ch.mean, ch.inv, ch.shift);
  if (!DX) return relu ? (y > 0.0f ? y : (y != y ? y : 0.0f)) : y;
  if (relu && !(y > 0.0f)) g = 0.0f;
  return g * ch.inv + wt * (ch.k * (x - ch.mean) - ch.c0);
}

// Channels-last thread layout: a tile of W channel vectors of V values, one a
// thread, `lanes` rows at a time.
struct Tile {
  int tpr, W, lanes;
};

template <int V>
__device__ __forceinline__ Tile tile(int C) {
  const int tpr = C / V, W = tpr < kThreads ? tpr : kThreads;
  return {tpr, W, kThreads / W};
}

// Channels-last sums of this block's rows into its partial row.
template <int MODE, typename T, int V>
__device__ void cl_sums(const Args<T>& a, float* buf) {
  constexpr int kUnroll = V >= 8 ? 2 : V >= 4 ? 4 : 8;  // rows a thread has in flight
  const Tile t = tile<V>(a.C);
  const int lane = threadIdx.x / t.W;
  long long r0, r1;
  split((long long)a.B * a.L, gridDim.x, blockIdx.x, r0, r1);
  for (int ct = 0; ct < t.tpr; ct += t.W) {
    const int cv = ct + threadIdx.x % t.W;
    float s0[V], s1[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s0[v] = s1[v] = 0.0f;
    if (lane < t.lanes && cv < t.tpr) {
      Channel ch[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if constexpr (MODE == 0) ch[v] = Channel{};
        else ch[v] = channel<MODE, T>(a, cv * V + v);
      }
      const long long step = (long long)t.lanes;
      for (long long r = r0 + lane; r < r1; r += step * kUnroll) {
        Pack<T, V> xs[kUnroll], gs[kUnroll];
        float wt[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long rr = r + u * step;
          if (rr < r1) {
            xs[u] = load<T, V>(a.x + rr * a.C + cv * V);
            if (MODE == 2) gs[u] = load<T, V>(a.dy + rr * a.C + cv * V);
            wt[u] = MODE == 2 ? 1.0f : row_weight(a.mask, rr / a.L);
          } else {
            wt[u] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (r + u * step < r1) {
#pragma unroll
            for (int v = 0; v < V; ++v)
              accumulate<MODE>(to_f32(xs[u].v[v]), MODE == 2 ? to_f32(gs[u].v[v]) : 0.0f, wt[u], ch[v],
                               a.relu != 0, s0[v], s1[v]);
          }
        }
      }
    }
    // the lanes' sums, in lane order
    float* b0 = buf;
    float* b1 = buf + kThreads * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      b0[threadIdx.x * V + v] = s0[v];
      b1[threadIdx.x * V + v] = s1[v];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < t.W * V; j += kThreads) {
      const int c = ct * V + j;
      float p0 = 0.0f, p1 = 0.0f;
      for (int l = 0; l < t.lanes; ++l) {
        p0 += b0[l * t.W * V + j];
        p1 += b1[l * t.W * V + j];
      }
      if (c < a.C) {
        a.part[((long long)blockIdx.x * 2) * a.C + c] = p0;
        a.part[((long long)blockIdx.x * 2 + 1) * a.C + c] = p1;
      }
    }
    __syncthreads();
  }
}

// Channels-last normalize (DX false) or dx (DX true) over this block's rows.
template <bool DX, typename T, int V>
__device__ void cl_apply(const Args<T>& a) {
  constexpr int kUnroll = V >= 8 ? 2 : V >= 4 ? 4 : 8;  // rows a thread has in flight
  const Tile t = tile<V>(a.C);
  const int lane = threadIdx.x / t.W;
  long long r0, r1;
  split((long long)a.B * a.L, gridDim.x, blockIdx.x, r0, r1);
  for (int ct = 0; ct < t.tpr; ct += t.W) {
    const int cv = ct + threadIdx.x % t.W;
    if (lane >= t.lanes || cv >= t.tpr) continue;
    Channel ch[V];
#pragma unroll
    for (int v = 0; v < V; ++v) ch[v] = channel<DX ? 4 : 3, T>(a, cv * V + v);
    const long long step = (long long)t.lanes;
    for (long long r = r0 + lane; r < r1; r += step * kUnroll) {
      Pack<T, V> xs[kUnroll], gs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + u * step;
        if (rr < r1) {
          xs[u] = load<T, V>(a.x + rr * a.C + cv * V);
          if (DX) gs[u] = load<T, V>(a.dy + rr * a.C + cv * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = r + u * step;
        if (rr < r1) {
          const float wt = DX ? row_weight(a.mask, rr / a.L) : 0.0f;
          Pack<T, V> o;
#pragma unroll
          for (int v = 0; v < V; ++v)
            o.v[v] = from_f32<T>(apply<DX>(to_f32(xs[u].v[v]), DX ? to_f32(gs[u].v[v]) : 0.0f, wt, ch[v],
                                           a.relu != 0));
          *reinterpret_cast<Pack<T, V>*>(a.out + rr * a.C + cv * V) = o;
        }
      }
    }
  }
}

// NCHW sums: a warp a plane (b, c); the plane's sums go to sample b's
// partial row.
template <int MODE, typename T>
__device__ void plane_sums(const Args<T>& a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  long long p0, p1;
  split((long long)a.B * a.C, gridDim.x, blockIdx.x, p0, p1);
  for (long long p = p0 + warp; p < p1; p += kWarps) {
    const int b = (int)(p / a.C), c = (int)(p % a.C);
    Channel ch{};
    if constexpr (MODE != 0) ch = channel<MODE, T>(a, c);
    const float wt = MODE == 2 ? 1.0f : row_weight(a.mask, b);
    const T* xp = a.x + p * a.L;
    const T* gp = MODE == 2 ? a.dy + p * a.L : nullptr;
    float s0 = 0.0f, s1 = 0.0f;
    for (long long l = lane; l < a.L; l += 32)
      accumulate<MODE>(to_f32(xp[l]), MODE == 2 ? to_f32(gp[l]) : 0.0f, wt, ch, a.relu != 0, s0, s1);
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      a.part[((long long)b * 2) * a.C + c] = s0;
      a.part[((long long)b * 2 + 1) * a.C + c] = s1;
    }
  }
}

// NCHW normalize or dx: the block's planes one after another.
template <bool DX, typename T>
__device__ void plane_apply(const Args<T>& a) {
  long long p0, p1;
  split((long long)a.B * a.C, gridDim.x, blockIdx.x, p0, p1);
  for (long long p = p0; p < p1; ++p) {
    const int b = (int)(p / a.C), c = (int)(p % a.C);
    const Channel ch = channel<DX ? 4 : 3, T>(a, c);
    const float wt = DX ? row_weight(a.mask, b) : 0.0f;
    for (long long l = threadIdx.x; l < a.L; l += kThreads) {
      const long long i = p * a.L + l;
      a.out[i] = from_f32<T>(apply<DX>(to_f32(a.x[i]), DX ? to_f32(a.dy[i]) : 0.0f, wt, ch, a.relu != 0));
    }
  }
}

// out(s, c, sum over parts in order of part[p][s][c]) for s < nsum: a block
// a (sum, channel), its threads taking every kThreads-th part, then a fixed
// tree.
template <typename Emit>
__device__ void reduce_parts(const float* part, int parts, int nsum, int C, float* buf, Emit out) {
  for (int j = blockIdx.x; j < nsum * C; j += gridDim.x) {
    const int s = j / C, c = j % C;
    float v = 0.0f;
    for (int p = threadIdx.x; p < parts; p += kThreads) v += part[((long long)p * 2 + s) * C + c];
    v = block_sum(v, buf);
    if (threadIdx.x == 0) out(s, c, v);
  }
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads) mbn_forward_kernel(Args<T> a) {
  __shared__ float buf[2 * kThreads * V];
  cg::grid_group grid = cg::this_grid();
  const StatsAt at = stats_at(a.C);
  const int parts = CL ? (int)gridDim.x : a.B;
  for (int phase = a.lo; phase <= a.hi; ++phase) {
    if (phase > a.lo) grid.sync();
    if (phase == 0 || phase == 2) {
      if constexpr (CL) {
        phase == 0 ? cl_sums<0, T, V>(a, buf) : cl_sums<1, T, V>(a, buf);
      } else {
        phase == 0 ? plane_sums<0, T>(a) : plane_sums<1, T>(a);
      }
    } else if (phase == 1) {
      reduce_parts(a.part, parts, 1, a.C, buf, [&](int, int c, float v) { a.stats[at.s1 + c] = v; });
      if (blockIdx.x == gridDim.x - 1) {  // n = L * sum_b m_b
        float v = 0.0f;
        for (int b = threadIdx.x; b < a.B; b += kThreads) v += row_weight(a.mask, b);
        v = block_sum(v, buf);
        if (threadIdx.x == 0) a.stats[at.n] = (float)a.L * v;
      }
    } else if (phase == 3) {  // s2, then R
      reduce_parts(a.part, parts, 2, a.C, buf, [&](int s, int c, float v) { a.stats[at.s2 + s * a.C + c] = v; });
    } else if (phase == 4) {
      if (blockIdx.x == 0) {  // the saved statistics (the normalize recomputes them) and the running ones
        const float n = a.stats[at.n];
        for (int c = threadIdx.x; c < a.C; c += kThreads) {
          const float mean = __fdiv_rn(a.stats[at.s1 + c], n), var = __fdiv_rn(a.stats[at.s2 + c], n);
          a.stats[at.mean + c] = mean;
          a.stats[at.rstd + c] = rsqrtf(__fadd_rn(var, a.eps));
          if (a.update) {
            const float unbiased = __fmul_rn(var, __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.0f), 1.0f)));
            a.running_mean[c] = __fadd_rn(__fmul_rn(a.running_mean[c], a.keep), __fmul_rn(a.momentum, mean));
            a.running_var[c] = __fadd_rn(__fmul_rn(a.running_var[c], a.keep), __fmul_rn(a.momentum, unbiased));
          }
        }
      }
      if constexpr (CL) {
        cl_apply<false, T, V>(a);
      } else {
        plane_apply<false, T>(a);
      }
    }
  }
}

template <typename T, int V, bool CL>
__global__ void __launch_bounds__(kThreads) mbn_backward_kernel(Args<T> a) {
  __shared__ float buf[2 * kThreads * V];
  cg::grid_group grid = cg::this_grid();
  const StatsAt at = stats_at(a.C);
  const int parts = CL ? (int)gridDim.x : a.B;
  for (int phase = a.lo; phase <= a.hi; ++phase) {
    if (phase > a.lo) grid.sync();
    if (phase == 0) {
      if constexpr (CL) {
        cl_sums<2, T, V>(a, buf);
      } else {
        plane_sums<2, T>(a);
      }
    } else if (phase == 1) {  // A -> dbias, Bs -> dweight (this rank's), both to red
      reduce_parts(a.part, parts, 2, a.C, buf, [&](int s, int c, float v) {
        a.red[s * a.C + c] = v;
        if (s == 0)
          a.dbias[c] = v;
        else
          a.dweight[c] = __fmul_rn(v, a.stats[at.rstd + c]);
      });
    } else if (phase == 2) {
      if constexpr (CL) {
        cl_apply<true, T, V>(a);
      } else {
        plane_apply<true, T>(a);
      }
    }
  }
}

template <bool Backward, typename T, int V, bool CL>
const void* kernel_of() {
  return Backward ? (const void*)mbn_backward_kernel<T, V, CL> : (const void*)mbn_forward_kernel<T, V, CL>;
}

// The kernel for a dtype (0 float32, 1 bfloat16), vector width and layout;
// null for a combination that has none.
template <bool Backward>
const void* find_kernel(int dtype, int vec, int channels_last) {
  if (dtype == 0) {
    if (channels_last) return vec == 4 ? kernel_of<Backward, float, 4, true>()
                              : vec == 1 ? kernel_of<Backward, float, 1, true>() : nullptr;
    return vec == 1 ? kernel_of<Backward, float, 1, false>() : nullptr;
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    if (channels_last) return vec == 8 ? kernel_of<Backward, bf, 8, true>()
                              : vec == 1 ? kernel_of<Backward, bf, 1, true>() : nullptr;
    return vec == 1 ? kernel_of<Backward, bf, 1, false>() : nullptr;
  }
  return nullptr;
}

template <typename T>
cudaError_t launch(const void* kernel, Args<T>& a, int grid, cudaStream_t stream) {
  if (kernel == nullptr || grid < 1 || a.C < 1 || a.B < 1 || a.L < 1 || a.lo < 0 || a.hi < a.lo)
    return cudaErrorInvalidValue;
  void* params[] = {(void*)&a};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err == cudaSuccess) launched.fetch_add(1);
  return err;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32, 1 =
// bfloat16; vec: the channels a thread moves at once (16 bytes, or 1),
// channels-last only; channels_last: 1 for (B, *spatial, C) memory, 0 for
// contiguous (B, C, *spatial).  The wrapper checks shapes, dtypes, layouts
// and alignment, allocates every output and the scratch (part: grid (or B
// for NCHW) x 2 x C floats; stats: 5C + 1; red: 2C), and picks the grid
// (at most mbn_max_blocks).  Each returns the launch's CUDA error.
extern "C" int mbn_forward(const void* x, void* y, const void* mask, const void* weight, const void* bias,
                           void* running_mean, void* running_var, void* part, void* stats, long long L, int B,
                           int C, int dtype, int vec, int channels_last, float eps, float momentum, float keep,
                           int update, int relu, int lo, int hi, int grid, void* stream) {
  if (hi > 4) return (int)cudaErrorInvalidValue;
  const void* kernel = find_kernel<false>(dtype, vec, channels_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Args<T> a{(const T*)x, nullptr, (T*)y, (const float*)mask, (const float*)weight, (const float*)bias,
              (float*)running_mean, (float*)running_var, (float*)part, (float*)stats, nullptr, nullptr, nullptr,
              L, B, C, eps, momentum, keep, update, relu, lo, hi};
    return (int)launch(kernel, a, grid, st);
  };
  if (dtype == 0) return fill((float*)nullptr);
  if (dtype == 1) return fill((__nv_bfloat16*)nullptr);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mbn_backward(const void* dy, const void* x, void* dx, const void* mask, const void* weight,
                            const void* bias, void* part, void* stats, void* red, void* dweight, void* dbias,
                            long long L, int B, int C, int dtype, int vec, int channels_last, int relu, int lo,
                            int hi, int grid, void* stream) {
  if (hi > 2) return (int)cudaErrorInvalidValue;
  const void* kernel = find_kernel<true>(dtype, vec, channels_last);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto* tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    Args<T> a{(const T*)x, (const T*)dy, (T*)dx, (const float*)mask, (const float*)weight, (const float*)bias,
              nullptr, nullptr, (float*)part, (float*)stats, (float*)red, (float*)dweight, (float*)dbias,
              L, B, C, 0.0f, 0.0f, 0.0f, 0, relu, lo, hi};
    return (int)launch(kernel, a, grid, st);
  };
  if (dtype == 0) return fill((float*)nullptr);
  if (dtype == 1) return fill((__nv_bfloat16*)nullptr);
  return (int)cudaErrorInvalidValue;
}

// The most blocks of the kernel the current card holds at once (blocks an SM
// by occupancy, times its SMs): the largest cooperative grid.
extern "C" int mbn_max_blocks(int backward, int dtype, int vec, int channels_last, int* count) {
  const void* kernel = backward ? find_kernel<true>(dtype, vec, channels_last)
                                : find_kernel<false>(dtype, vec, channels_last);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *count = per_sm * sms;
  return 0;
}

// The count of kernels this library has launched.
extern "C" unsigned long long mbn_cuda_launches() { return launched.load(); }
