// Flash attention for Hopper (sm_90a): o = softmax(q k^T * scale) v, non-causal.
//
// Replaces the TPU kernel sd_video_gen_tpu/ops/attention.py:_flash_kernel
// (the pl.pallas_call in flash_attention). Same arithmetic: q, k, v of shape
// (BH, T, d) in f32 or bf16; logits accumulate in f32; an online softmax over
// key tiles keeps the running max, the normaliser and the output accumulator
// in f32; p is rounded to the input type before the p.v product (as the TPU
// kernel's p.astype(v.dtype)); the output is divided by the normaliser and
// written once, in the input type.
//
// What bounds it on this card. For the spatial self-attention of the SD UNet
// and VAE (T = 64..4096, d = 40..512) the T x T logits are the large object:
// 4096^2 f32 is 64 MB per head, so a plain einsum-softmax-einsum moves
// O(T^2) bytes through device memory three times. This kernel never writes
// them: per (head, query tile) it streams K/V tiles through shared memory and
// keeps the logits tile on chip, so device-memory traffic is O(T d) per query
// tile (served mostly from the 50 MB L2). What is left bounds it on compute:
// this first version multiplies with f32 FMAs on register tiles fed from
// shared memory, so shared-memory bandwidth, not the tensor cores, sets its
// rate. mma.sync / wgmma tiles with TMA loads are the later step.
//
// Design. The TPU grid runs its key axis in order and carries the softmax
// state in VMEM scratch; Hopper runs blocks in parallel, so one block owns one
// (head, query tile) and loops over the key tiles itself, with the state in
// registers (accumulator) and shared memory (max / normaliser). Each head-dim
// bucket picks its query tile so Q, K, V and the logits tile fit the 227 KB of
// shared memory (16 query rows at d = 512). A ragged T is masked (padded keys
// get -inf logits, padded query rows are never stored) instead of raising.
// Shared-memory rows are padded to an odd stride so the column reads of the
// two products are free of bank conflicts.
//
// Built by sd_video_gen_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// (one process per source), then linked with -shared into one library and
// called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// One head-dim bucket: D (>= the real d; columns past d are zero), query and
// key tile rows, threads, and how the threads tile the two products:
// S = Q K^T is (BQ, BK) on a (NT/GX_S, GX_S) thread grid, O += P V is (BQ, D)
// on a (NT/GX_O, GX_O) thread grid; each thread holds a TM x TN register tile
// whose rows are strided by the grid height and columns by its width.
template <int D_, int BQ_, int BK_, int NT_, int GX_S_, int GX_O_>
struct Cfg {
  static constexpr int D = D_, BQ = BQ_, BK = BK_, NT = NT_;
  static constexpr int LD = D + 1;   // odd row stride: conflict-free columns
  static constexpr int LDS = BK + 1;
  static constexpr int GX_S = GX_S_, GY_S = NT / GX_S;
  static constexpr int TM_S = BQ / GY_S, TN_S = BK / GX_S;
  static constexpr int GX_O = GX_O_, GY_O = NT / GX_O;
  static constexpr int TM_O = BQ / GY_O, TN_O = D / GX_O;
  static constexpr int NWARP = NT / 32;
  static constexpr int SMEM_FLOATS = BQ * LD + 2 * BK * LD + BQ * LDS + 3 * BQ;
  static constexpr int SMEM = SMEM_FLOATS * (int)sizeof(float);
  static_assert(NT % 32 == 0, "whole warps");
  static_assert(NT % GX_S == 0 && BQ % GY_S == 0 && BK % GX_S == 0, "S tiling");
  static_assert(NT % GX_O == 0 && BQ % GY_O == 0 && D % GX_O == 0, "O tiling");
  static_assert(BK >= 32, "one warp sweeps a logits row");
  static_assert(SMEM <= 232448, "fits the 227 KB of shared memory a block may use");
};

//                 D   BQ  BK   NT  GX_S GX_O
using Cfg40  = Cfg<40,  64, 64, 128,  8,  8>;   // UNet 512px level 0
using Cfg64  = Cfg<64,  64, 64, 128,  8,  8>;
using Cfg80  = Cfg<80,  64, 64, 128,  8,  8>;   // UNet level 1
using Cfg128 = Cfg<128, 64, 64, 256, 16, 16>;
using Cfg160 = Cfg<160, 64, 32, 256, 16, 16>;   // UNet levels 2 and mid
using Cfg256 = Cfg<256, 32, 32, 256, 16, 16>;
using Cfg512 = Cfg<512, 16, 32, 128, 16, 16>;   // VAE mid block

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid = (ceil(T / BQ), BH); block = NT threads; dynamic smem = C::SMEM.
template <typename T, class C>
__global__ void __launch_bounds__(C::NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int seq, int d,
          float scale) {
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BQ][LD]
  float* sK = sQ + C::BQ * C::LD;    // [BK][LD]
  float* sV = sK + C::BK * C::LD;    // [BK][LD]
  float* sS = sV + C::BK * C::LD;    // [BQ][LDS] logits, then p
  float* sM = sS + C::BQ * C::LDS;   // running max
  float* sL = sM + C::BQ;            // running normaliser
  float* sA = sL + C::BQ;            // this tile's rescale exp(m_old - m_new)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * C::BQ;
  const size_t head = (size_t)blockIdx.y * (size_t)seq * (size_t)d;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;

  for (int i = tid; i < C::BQ * C::D; i += C::NT) {
    const int r = i / C::D, c = i % C::D, row = q0 + r;
    sQ[r * C::LD + c] =
        (row < seq && c < d) ? Elem<T>::load(qh + (size_t)row * d + c) : 0.f;
  }
  for (int r = tid; r < C::BQ; r += C::NT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }

  const int sx = tid % C::GX_S, sy = tid / C::GX_S;
  const int ox = tid % C::GX_O, oy = tid / C::GX_O;
  const int warp = tid / 32, lane = tid % 32;

  float acc[C::TM_O][C::TN_O];
#pragma unroll
  for (int i = 0; i < C::TM_O; ++i)
#pragma unroll
    for (int j = 0; j < C::TN_O; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < seq; k0 += C::BK) {
    __syncthreads();  // last tile's readers are done with sK / sV / sS
    for (int i = tid; i < C::BK * C::D; i += C::NT) {
      const int r = i / C::D, c = i % C::D, row = k0 + r;
      const bool ok = row < seq && c < d;
      const size_t off = (size_t)row * d + c;
      sK[r * C::LD + c] = ok ? Elem<T>::load(kh + off) : 0.f;
      sV[r * C::LD + c] = ok ? Elem<T>::load(vh + off) : 0.f;
    }
    __syncthreads();

    // S = (Q K^T) * scale; keys past the end of the sequence get -inf.
    float s[C::TM_S][C::TN_S];
#pragma unroll
    for (int i = 0; i < C::TM_S; ++i)
#pragma unroll
      for (int j = 0; j < C::TN_S; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C::D; ++c) {
      float a[C::TM_S], b[C::TN_S];
#pragma unroll
      for (int i = 0; i < C::TM_S; ++i) a[i] = sQ[(sy + i * C::GY_S) * C::LD + c];
#pragma unroll
      for (int j = 0; j < C::TN_S; ++j) b[j] = sK[(sx + j * C::GX_S) * C::LD + c];
#pragma unroll
      for (int i = 0; i < C::TM_S; ++i)
#pragma unroll
        for (int j = 0; j < C::TN_S; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < C::TM_S; ++i)
#pragma unroll
      for (int j = 0; j < C::TN_S; ++j) {
        const int r = sy + i * C::GY_S, kk = sx + j * C::GX_S;
        sS[r * C::LDS + kk] = (k0 + kk < seq) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // Online softmax, one warp per row. The tile's first key is always real,
    // so m_new is finite and exp() never sees inf - inf.
    for (int r = warp; r < C::BQ; r += C::NWARP) {
      float* row = sS + r * C::LDS;
      float mx = -INFINITY;
      for (int j = lane; j < C::BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < C::BK; j += 32) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = Elem<T>::round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < C::TM_O; ++i) {
      const float alpha = sA[oy + i * C::GY_O];
#pragma unroll
      for (int j = 0; j < C::TN_O; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int j = 0; j < C::BK; ++j) {
      float p[C::TM_O], w[C::TN_O];
#pragma unroll
      for (int i = 0; i < C::TM_O; ++i) p[i] = sS[(oy + i * C::GY_O) * C::LDS + j];
#pragma unroll
      for (int c = 0; c < C::TN_O; ++c) w[c] = sV[j * C::LD + ox + c * C::GX_O];
#pragma unroll
      for (int i = 0; i < C::TM_O; ++i)
#pragma unroll
        for (int c = 0; c < C::TN_O; ++c) acc[i][c] = fmaf(p[i], w[c], acc[i][c]);
    }
  }

  // sL was last written before the final tile's third barrier.
#pragma unroll
  for (int i = 0; i < C::TM_O; ++i) {
    const int r = oy + i * C::GY_O, row = q0 + r;
    if (row >= seq) continue;
    const float l = sL[r];
    T* orow = o + head + (size_t)row * d;
#pragma unroll
    for (int c = 0; c < C::TN_O; ++c) {
      const int col = ox + c * C::GX_O;
      if (col < d) orow[col] = Elem<T>::store(acc[i][c] / l);
    }
  }
}

template <typename T, class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int seq, int d, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int seq, int d, float scale, cudaStream_t s) {
  if (d <= 40) return launch<T, Cfg40>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 64) return launch<T, Cfg64>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 80) return launch<T, Cfg80>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 128) return launch<T, Cfg128>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 160) return launch<T, Cfg160>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 256) return launch<T, Cfg256>(q, k, v, o, bh, seq, d, scale, s);
  return launch<T, Cfg512>(q, k, v, o, bh, seq, d, scale, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (bh, seq, d) on the
// current device. Returns the cudaError_t of the launch (0 on success).
int sdvg_flash_attention(const void* q, const void* k, const void* v, void* o,
                         int bh, int seq, int d, float scale, int dtype,
                         void* stream) {
  if (bh < 1 || bh > 65535 || seq < 1 || d < 1 || d > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(q, k, v, o, bh, seq, d, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, bh, seq, d, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* sdvg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
