// GroupNorm (+ optional SiLU) for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel sd_video_gen_tpu/ops/groupnorm.py:_gn_kernel (the
// pl.pallas_call in groupnorm_silu_pallas). Same arithmetic: per (batch,
// group) the mean and a two-pass variance in f32, an exact 1 / sqrt(var +
// eps) (not the approximate rsqrt), the per-channel affine, an optional SiLU
// in f32, and the output rounded once to the input type (f32 or bf16).
//
// Layout. The port's models are NCHW, so for a contiguous (B, C, H, W) input
// each (b, g) group is one contiguous run ("row") of n = (C / G) * H * W
// elements, and element j of the row has channel g * (C / G) + j / (H * W).
// The TPU kernel's one-hot (C, G) assignment matmuls exist only because
// Mosaic cannot split the lane dimension; none is needed here.
//
// What bounds it on this card. A few flops per byte moved: it is a pass
// over device memory. The least traffic is one read for the statistics, one
// read and one write for the output. The TPU kernel keeps a whole slab in
// VMEM; on Hopper a row holds up to 2,097,152 elements (the VAE decoder's
// 256-channel norm at 512px: 8 MB f32), far more than one block's shared
// memory, and at B = 1 there are only B * G = 32 rows for 132 SMs. So each
// row is split over many blocks of kChunk elements:
//   1. gn_partial: each block loads its chunk into registers (16-byte vector
//      loads), reduces the chunk's mean, then the chunk's sum of squared
//      deviations from that mean from the same registers (two passes over
//      registers, one read of memory), and writes (mean, M2) per chunk.
//   2. gn_stats: one block per row merges the chunks (Chan et al.: M2 =
//      sum M2_c + n_c (mean_c - mean)^2) and writes (mean, 1 / sqrt(var +
//      eps)). Never E[x^2] - mean^2, which cancels catastrophically.
//   3. gn_apply: normalises, applies the affine and the SiLU and stores, one
//      read and one write, 16-byte vectors.
// A row whose start is not 16-byte aligned (n * sizeof(T) not a multiple of
// 16, or an unaligned pointer) takes the same kernels with scalar loads.
//
// Built by sd_video_gen_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// (one process per source), then linked with -shared into one library and
// called through ctypes (plain C interface below). The caller passes a
// workspace of sdvg_groupnorm_silu_workspace(...) bytes; nothing here
// allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                  // elements a thread holds
constexpr int kChunk = kThreads * kPerThread;   // 4096 elements per block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// V elements of T moved as one load / store (16 bytes when V * sizeof(T) is).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the block; every thread gets the total. red: kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < kThreads / 32 ? red[lane] : 0.f;
  t = warp_sum(t);
  __syncthreads();  // red is free for the next call
  return t;
}

// Element k * V + u of a thread's share of chunk c0 sits at row index
// c0 + (k * kThreads + threadIdx.x) * V + u: neighbouring threads read
// neighbouring vectors. V > 1 only when n % V == 0, so a vector is either
// wholly inside the row or wholly past its end.

// grid = (nchunk, rows); writes part[row * nchunk + chunk] = (mean_c, M2_c).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_partial(const T* __restrict__ x, float2* __restrict__ part, int n,
           int nchunk) {
  __shared__ float red[kThreads / 32];
  const int chunk = blockIdx.x, row = blockIdx.y;
  const int c0 = chunk * kChunk;
  const T* xr = x + (size_t)row * (size_t)n;
  float v[kPerThread];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread / V; ++k) {
    const int e = c0 + (k * kThreads + (int)threadIdx.x) * V;
    if (e < n) {
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + e);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        v[k * V + u] = to_float(p.v[u]);
        s += v[k * V + u];
      }
    }
  }
  const int nc = min(kChunk, n - c0);
  const float mean = block_sum(s, red) / (float)nc;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread / V; ++k) {
    const int e = c0 + (k * kThreads + (int)threadIdx.x) * V;
    if (e < n) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const float d = v[k * V + u] - mean;
        m2 = fmaf(d, d, m2);
      }
    }
  }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) part[(size_t)row * nchunk + chunk] = make_float2(mean, m2);
}

// grid = rows; merges the row's chunks into stats[row] = (mean, rstd).
__global__ void __launch_bounds__(kThreads)
gn_stats(const float2* __restrict__ part, float2* __restrict__ stats, int n,
         int nchunk, float eps) {
  __shared__ float red[kThreads / 32];
  const int row = blockIdx.x;
  const float2* p = part + (size_t)row * nchunk;
  float s = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += kThreads)
    s += (float)min(kChunk, n - c * kChunk) * p[c].x;
  const float mean = block_sum(s, red) / (float)n;
  float m2 = 0.f;
  for (int c = threadIdx.x; c < nchunk; c += kThreads) {
    const float d = p[c].x - mean;
    m2 += p[c].y + (float)min(kChunk, n - c * kChunk) * d * d;
  }
  const float var = block_sum(m2, red) / (float)n;
  if (threadIdx.x == 0) stats[row] = make_float2(mean, 1.0f / sqrtf(var + eps));
}

// grid = (nchunk, rows); out = silu?((x - mean) * rstd * w[c] + b[c]).
template <typename T, int V, bool SILU>
__global__ void __launch_bounds__(kThreads)
gn_apply(const T* __restrict__ x, const T* __restrict__ w,
         const T* __restrict__ b, const float2* __restrict__ stats,
         T* __restrict__ out, int n, int hw, int groups, int cpg) {
  const int chunk = blockIdx.x, row = blockIdx.y;
  const int c0 = chunk * kChunk;
  const size_t base = (size_t)row * (size_t)n;
  const int ch0 = (row % groups) * cpg;
  const float2 st = stats[row];
#pragma unroll
  for (int k = 0; k < kPerThread / V; ++k) {
    const int e = c0 + (k * kThreads + (int)threadIdx.x) * V;
    if (e >= n) continue;
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(x + base + e);
    Pack<T, V> q;
    int ch = e / hw, r = e - ch * hw;  // a vector may cross a channel edge
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (r == hw) {
        ++ch;
        r = 0;
      }
      ++r;
      float y = (to_float(p.v[u]) - st.x) * st.y;
      y = y * to_float(w[ch0 + ch]) + to_float(b[ch0 + ch]);
      if (SILU) y = y / (1.0f + expf(-y));
      q.v[u] = from_float<T>(y);
    }
    *reinterpret_cast<Pack<T, V>*>(out + base + e) = q;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   float2* part, float2* stats, int rows, int n, int hw,
                   int groups, int cpg, int nchunk, float eps, bool silu,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const dim3 grid(nchunk, rows);
  gn_partial<T, V><<<grid, kThreads, 0, s>>>(xt, part, n, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_stats<<<rows, kThreads, 0, s>>>(part, stats, n, nchunk, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (silu)
    gn_apply<T, V, true><<<grid, kThreads, 0, s>>>(xt, wt, bt, stats, ot, n,
                                                   hw, groups, cpg);
  else
    gn_apply<T, V, false><<<grid, kThreads, 0, s>>>(xt, wt, bt, stats, ot, n,
                                                    hw, groups, cpg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* b, void* out,
                     float2* part, float2* stats, int rows, int n, int hw,
                     int groups, int cpg, int nchunk, float eps, bool silu,
                     cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = n % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned)
    return launch<T, V>(x, w, b, out, part, stats, rows, n, hw, groups, cpg,
                        nchunk, eps, silu, s);
  return launch<T, 1>(x, w, b, out, part, stats, rows, n, hw, groups, cpg,
                      nchunk, eps, silu, s);
}

// Rows, row length and chunks of a (B, C, hw) input in G groups; false if the
// kernels cannot take it (grid limits, 32-bit row indices).
bool geometry(int B, int C, long long hw, int G, int* rows, int* n,
              int* nchunk) {
  if (B < 1 || C < 1 || G < 1 || hw < 1 || C % G != 0) return false;
  const long long r = (long long)B * G, len = (long long)(C / G) * hw;
  if (r > 65535 || len > (long long)INT_MAX - kChunk) return false;
  *rows = (int)r;
  *n = (int)len;
  *nchunk = (int)((len + kChunk - 1) / kChunk);
  return true;
}

}  // namespace

extern "C" {

// Bytes of workspace sdvg_groupnorm_silu needs for this shape (0: refused).
long long sdvg_groupnorm_silu_workspace(int B, int C, long long hw, int G) {
  int rows, n, nchunk;
  if (!geometry(B, C, hw, G, &rows, &n, &nchunk)) return 0;
  return (long long)rows * (nchunk + 1) * (long long)sizeof(float2);
}

// dtype: 0 = float32, 1 = bfloat16. x, out: contiguous (B, C, hw); w, b: (C,)
// of x's type; workspace: sdvg_groupnorm_silu_workspace bytes, 8-byte
// aligned. Returns the cudaError_t of the launches (0 on success).
int sdvg_groupnorm_silu(const void* x, const void* w, const void* b, void* out,
                        void* workspace, int B, int C, long long hw, int G,
                        float eps, int silu, int dtype, void* stream) {
  int rows, n, nchunk;
  if (!geometry(B, C, hw, G, &rows, &n, &nchunk))
    return (int)cudaErrorInvalidValue;
  float2* part = static_cast<float2*>(workspace);
  float2* stats = part + (size_t)rows * nchunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpg = C / G;
  if (dtype == 0)
    return (int)dispatch<float>(x, w, b, out, part, stats, rows, n, (int)hw, G,
                                cpg, nchunk, eps, silu != 0, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, w, b, out, part, stats, rows, n,
                                        (int)hw, G, cpg, nchunk, eps, silu != 0,
                                        s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
