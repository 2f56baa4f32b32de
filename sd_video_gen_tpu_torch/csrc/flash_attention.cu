// Flash attention for Hopper (sm_90a): o = softmax(q k^T * scale) v, non-causal.
//
// Replaces the TPU kernel sd_video_gen_tpu/ops/attention.py:_flash_kernel
// (the pl.pallas_call in flash_attention). Same arithmetic: q, k, v of shape
// (BH, T, d) in f32 or bf16; logits accumulate in f32; an online softmax over
// key tiles keeps the running max, the normaliser and the output accumulator
// in f32; the normaliser sums the f32 p, while p is rounded to the input type
// before the p.v product (as the TPU kernel's p.astype(v.dtype)); the output
// is divided by the normaliser once at the end and written once, in the
// input type. A ragged T is masked (padded keys get -inf logits, padded
// query rows are never stored) instead of raising.
//
// Two bodies, chosen by shape before launch (ops/attention.py:route):
//
// * flash_fwd_wgmma, bf16 with d % 8 == 0 and 16-byte aligned q, k, v (entry
//   sdvg_flash_attention_wgmma). Both products on the tensor cores:
//   S = Q K^T is wgmma with Q and K read from shared memory (K-major), and
//   O += P V is wgmma with P from registers (the f32 accumulator converted
//   to bf16 in place: the accumulator layout of m64nN is the A-fragment
//   layout of m64k16) and V from shared memory in MN-major form. A block
//   is three warpgroups: one producer thread issues TMA loads (Q once, then
//   K and V tiles into a two-stage ring, completed on mbarriers and freed
//   by the consumers' arrivals), and two consumer warpgroups of 64 query
//   rows each compute (setmaxnreg moves registers from the producer to
//   them); while one is in its softmax the other's wgmma runs. The tensor
//   maps are 3-D (d, T, BH), built on the host per call, so rows past T
//   and columns past d are out of bounds and arrive as zeros: the QK^T depth
//   is the head-dim bucket (40, 80, 160 or 512; a d between them runs in
//   the next one up) rounded up to 16 and the PV width the bucket itself,
//   with nothing padded in memory, and no tile reads the next head.
//   Each tile is 64 columns (128 bytes) wide in the 128-byte swizzle that
//   TMA writes and the wgmma descriptors name (layout type B128). The
//   softmax works in base 2: scale * log2(e) is folded into the logits, so
//   each element costs one ex2.approx (MUFU); row max and row sum stay in
//   f32, the max reduced per tile across the four threads of an accumulator
//   row by shuffles, the sum kept per thread and reduced once at the end.
//
//   d = 512: a 64 x 512 f32 accumulator is 128 KB of registers, half the
//   SM's file, so both consumer warpgroups share one 64-row query tile and
//   split the output's columns (64 x 256 each). Each computes S = Q K^T in
//   full for itself (no exchange through shared memory, no extra barrier):
//   the QK^T product is done twice, 1.5x the products of one pass. Shared
//   memory: Q 64 KB + 2 stages x (K 32 KB + V 32 KB) of 32-key tiles.
//   At (1, 4096, 512) this gives 64 blocks for 132 SMs (one block per SM).
//
//   What bounds it. At d = 40 (UNet level 0, the largest share of device
//   time) the products are small and the exponential weighs as much as
//   both of them: 4096^2 exponentials per head at 16 MUFU ops per SM per
//   clock, hence one ex2 per element and nothing else on the MUFU. At
//   d = 512 (VAE mid block) the tensor cores bound it; there the duplicated
//   QK^T is the price of the simple split. Not done yet: overlapping one
//   tile's softmax with the next tile's QK^T inside a warpgroup, an explicit
//   ping-pong between the two warpgroups, TMA stores of the output.
//
// * flash_fwd, everything else (f32 always; bf16 with d % 8 != 0 or an
//   unaligned base pointer, where TMA cannot serve: its row stride must be a
//   multiple of 16 bytes). f32 FMAs on register tiles fed from shared
//   memory, no tensor cores: TF32 wgmma would break the f32 tolerance
//   (1e-4). Per (head, query tile) it streams K/V tiles through shared
//   memory and keeps the logits tile on chip; each head-dim bucket picks its
//   query tile so Q, K, V and the logits fit the 227 KB of shared memory.
//   Shared-memory rows are padded to an odd stride so the column reads of
//   the two products are free of bank conflicts.
//
// The tensor-map encoder cuTensorMapEncodeTiled is a driver function; it is
// reached through the runtime's cudaGetDriverEntryPoint, so the library
// needs no -lcuda at link time.
//
// Built by sd_video_gen_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// (one process per source), then linked with -shared into one library and
// called through ctypes (plain C interface below).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA + mbarrier ring + wgmma.

constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kStages = 2;        // K/V ring depth
constexpr int kChunk = 64;        // columns per 128-byte swizzled tile row
constexpr int kQTileBytes = 64 * 128;   // 64 rows x one 64-column chunk
constexpr int kConsumerWarps = 8;

// One head-dim bucket: D (>= the real d, a multiple of 8; columns past d
// arrive as zeros), BK keys per tile, SPLIT = both warpgroups on one query
// tile, each with half of the output's columns (d = 512).
template <int D_, int BK_, bool SPLIT_>
struct WCfg {
  static constexpr int D = D_, BK = BK_;
  static constexpr bool SPLIT = SPLIT_;
  static constexpr int DQK = (D + 15) / 16 * 16;      // QK^T depth
  static constexpr int KSTEPS = DQK / 16;
  static constexpr int NCH = (DQK + kChunk - 1) / kChunk;
  static constexpr int NPV = SPLIT ? D / 2 : D;       // PV width per warpgroup
  static constexpr int QTILES = SPLIT ? 1 : 2;        // 64-row query tiles
  static constexpr int BQ = 64 * QTILES;
  static constexpr int Q_BYTES = QTILES * NCH * kQTileBytes;
  static constexpr int KV_BYTES = NCH * BK * 128;     // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + kStages * 2 * KV_BYTES;
  static_assert(D % 8 == 0 && NPV % 8 == 0 && NPV <= 256, "wgmma width");
  static_assert(!SPLIT || NPV % kChunk == 0, "split on a chunk edge");
  static_assert(BK % 16 == 0 && BK <= 256, "key tile");
  static_assert(SMEM <= 232448, "fits the 227 KB of shared memory a block may use");
};

// One bucket per head dim of the path; any other d (a multiple of 8) runs
// in the next bucket up, on zero columns.
//                   D    BK  SPLIT
using WCfg40  = WCfg<40,  128, false>;   // UNet 512px level 0
using WCfg80  = WCfg<80,  128, false>;   // UNet level 1
using WCfg160 = WCfg<160, 64,  false>;   // UNet levels 2 and mid
using WCfg512 = WCfg<512, 32,  true>;    // VAE mid block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A wait
// of more than ~2^34 clocks (seconds) can only be a fault (a load that never
// lands): trap, so the launch fails with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One TMA box of a 3-D (d, T, BH) map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1). K-major
// tiles (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO
// unused. MN-major tiles (V): 8-key groups 1024 bytes apart (SBO), 64-column
// chunks LBO bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma.mma_async m64nNk16, f32 += bf16 * bf16, one instruction per width.
// The accumulator of thread t (lane l of warp w in the warpgroup) holds, at
// index i, row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4)
// + i % 2.
#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : F4(0), F4(4), F4(8), F4(12)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28),
        F4(32), F4(36), F4(40), F4(44), F4(48), F4(52), F4(56), F4(60)
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n40(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28),
        F4(32), F4(36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n160(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28),
        F4(32), F4(36), F4(40), F4(44), F4(48), F4(52), F4(56), F4(60),
        F4(64), F4(68), F4(72), F4(76)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28),
        F4(32), F4(36), F4(40), F4(44), F4(48), F4(52), F4(56), F4(60),
        F4(64), F4(68), F4(72), F4(76), F4(80), F4(84), F4(88), F4(92),
        F4(96), F4(100), F4(104), F4(108), F4(112), F4(116), F4(120), F4(124)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

#undef F4

template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int acc) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else {
    static_assert(N == 128, "key tile width");
    wgmma_ss_n128(d, da, db, acc);
  }
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db) {
  if constexpr (N == 40) wgmma_rs_n40(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, db);
  else {
    static_assert(N == 256, "head-dim bucket width");
    wgmma_rs_n256(d, a, db);
  }
}

// grid = (ceil(T / BQ), BH); block = 384 threads; dynamic smem = C::SMEM.
// Warpgroup 0 produces (one thread issues every TMA load), warpgroups 1 and
// 2 consume. scale_log2 = scale * log2(e).
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int seq, int d,
                float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // bars: [0] Q loaded; [1 + s] K of stage s loaded; [1 + S + s] V loaded;
  // [1 + 2S + s] stage s free (one arrival per consumer warp).
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_base = base + C::Q_BYTES;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto bar_k = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto bar_v = [&](int s) { return smem_u32(&bars[1 + kStages + s]); };
  auto bar_free = [&](int s) { return smem_u32(&bars[1 + 2 * kStages + s]); };

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * C::BQ, head = blockIdx.y;
  const int ntiles = (seq + C::BK - 1) / C::BK;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_free(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer. The first wait on each free barrier passes at once (parity
    // of the phase before the first).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int qt = 0; qt < C::QTILES; ++qt)
        for (int c = 0; c < C::NCH; ++c)
          tma_load(base + (qt * C::NCH + c) * kQTileBytes, &tq, c * kChunk,
                   q0 + 64 * qt, head, bar_q);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const uint32_t k_s = kv_base + s * 2 * C::KV_BYTES;
        const uint32_t v_s = k_s + C::KV_BYTES;
        mbar_wait(bar_free(s), ph ^ 1);
        mbar_expect_tx(bar_k(s), C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(k_s + c * C::BK * 128, &tk, c * kChunk, it * C::BK, head,
                   bar_k(s));
        mbar_expect_tx(bar_v(s), C::KV_BYTES);
        for (int c = 0; c < C::NCH; ++c)
          tma_load(v_s + c * C::BK * 128, &tv, c * kChunk, it * C::BK, head,
                   bar_v(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;               // consumer warpgroup 0 or 1
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, c4 = lane % 4;
    const uint32_t q_s = base + (C::SPLIT ? 0 : cw * C::NCH * kQTileBytes);
    const int vcol0 = C::SPLIT ? cw * C::NPV : 0;   // first output column

    float acc[C::NPV / 2];
#pragma unroll
    for (int i = 0; i < C::NPV / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint32_t k_s = kv_base + s * 2 * C::KV_BYTES;
      const uint32_t v_s = k_s + C::KV_BYTES;

      // S = Q K^T over the depth, 16 columns per instruction: +32 bytes
      // inside a swizzled row, the next 64-column chunk after four.
      float sc[C::BK / 2];
      mbar_wait(bar_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KSTEPS; ++kk)
        mma_ss<C::BK>(sc,
                      sw128_desc(q_s + (kk / 4) * kQTileBytes + (kk % 4) * 32, 16),
                      sw128_desc(k_s + (kk / 4) * C::BK * 128 + (kk % 4) * 32, 16),
                      kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<C::BK / 2>(sc);

      // Online softmax in base 2. The tile's first key is always real, so
      // the new max is finite; exp2(-inf) = 0 for the masked keys and for
      // the first tile's rescale.
      const int key0 = it * C::BK;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (key0 + C::BK > seq && key0 + 8 * (i / 4) + 2 * c4 + (i % 2) >= seq)
          x = -INFINITY;
        sc[i] = x;
        if ((i / 2) % 2) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        if ((i / 2) % 2) {
          sc[i] = ex2(sc[i] - mn1);
          rs1 += sc[i];
        } else {
          sc[i] = ex2(sc[i] - mn0);
          rs0 += sc[i];
        }
      }
      l0 = l0 * a0 + rs0;   // this thread's columns; summed across the
      l1 = l1 * a1 + rs1;   // four threads of a row at the end
#pragma unroll
      for (int i = 0; i < C::NPV / 2; ++i) acc[i] *= ((i / 2) % 2) ? a1 : a0;
      uint32_t pa[C::BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V, 16 keys per instruction (two 8-key groups, 2048 bytes).
      mbar_wait(bar_v(s), ph);
      fence_regs<C::NPV / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        mma_rs<C::NPV>(acc, pa[kk],
                       sw128_desc(v_s + (vcol0 / kChunk) * C::BK * 128 +
                                      kk * 2048,
                                  C::BK * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<C::NPV / 2>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_free(s));
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int row0 = q0 + (C::SPLIT ? 0 : 64 * cw) + 16 * warp + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= seq) continue;
      const float l = h ? l1 : l0;
      __nv_bfloat16* orow = o + ((size_t)head * seq + row) * d;
#pragma unroll
      for (int j = 0; j < C::NPV / 8; ++j) {
        const int col = vcol0 + 8 * j;
        if (col >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(orow + col + 2 * c4) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] / l,
                                  acc[4 * j + 2 * h + 1] / l);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 3-D (d, T, BH) bf16 map with 64-column x `rows` boxes, 128-byte swizzle;
// out-of-bounds elements (columns past d, rows past T) are read as zero.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
                     int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kChunk, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(ptr), dims, strides, box, estr,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class C>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int bh, int seq, int d, float scale,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, bh, seq, d, 64);
  if (err == cudaSuccess) err = make_map(&tk, k, bh, seq, d, C::BK);
  if (err == cudaSuccess) err = make_map(&tv, v, bh, seq, d, C::BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma<C>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), seq, d,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           void* o, int bh, int seq, int d, float scale,
                           cudaStream_t s) {
  if (d <= 40) return launch_wgmma<WCfg40>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 80) return launch_wgmma<WCfg80>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 160) return launch_wgmma<WCfg160>(q, k, v, o, bh, seq, d, scale, s);
  return launch_wgmma<WCfg512>(q, k, v, o, bh, seq, d, scale, s);
}

}  // namespace

extern "C" {

// The FMA body. dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous
// (bh, seq, d) on the current device. Returns the cudaError_t of the launch
// (0 on success).
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

// The tensor-core body: bfloat16 only, d a multiple of 8 (8..512), q, k, v
// 16-byte aligned, o 4-byte aligned. Anything else is refused, not
// rerouted: the caller picks the body (ops/attention.py:route).
int sdvg_flash_attention_wgmma(const void* q, const void* k, const void* v,
                               void* o, int bh, int seq, int d, float scale,
                               void* stream) {
  if (bh < 1 || bh > 65535 || seq < 1 || d < 8 || d > 512 || d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_wgmma(q, k, v, o, bh, seq, d, scale,
                             static_cast<cudaStream_t>(stream));
}

const char* sdvg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
