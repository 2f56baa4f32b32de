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
// Three bodies, chosen by dtype, head dim and alignment before launch
// (ops/attention.py:route):
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
// * flash_fwd_tf32x3, f32 with d % 4 == 0 and 16-byte aligned q, k, v
//   (entry sdvg_flash_attention_tf32x3). Both products on the tensor cores
//   in error-compensated TF32: each f32 operand x is split into big =
//   tf32(x) and small = tf32(x - big), both rounded to nearest (ties away)
//   with the 13 low bits cleared, and a product is big * small + small *
//   big + big * big (small * small dropped), accumulated in f32, as
//   CUTLASS's OpMultiplyAddFastF32. Against f64 that keeps attention near
//   1e-7 where one TF32 product leaves 1e-4 (tests/test_torch_attention.py
//   emulates both, and that dropping any one cross term leaves 4.6e-5 or
//   more). On the card the error against the plain f32 version is about
//   1e-5, held to 3e-5; chip_smoke.py sets beside it the same three
//   products summed by cuBLAS on the tensor cores, which tells the tensor
//   cores' own f32 accumulation from the body's arithmetic.
//
//   Layout. wgmma takes a 32-bit operand from shared memory in K-major form
//   only, so the kernel never needs a transposed tile:
//   S = Q K^T is m64n64k8 with A = Q (64 queries x 8 depth) loaded from
//   the raw TMA tile into registers and split there, B = K from shared
//   memory (K-major as TMA writes it), split by a warp of the producer
//   warpgroup (big in place, small in the next box). The output is
//   computed transposed, O^T += V^T P^T (m64n64k8, M = 64 output columns,
//   N = 64 queries): A = V^T is read from the raw V tile in A-fragment
//   order (register i of lane (g, c4) holds row g + 8 (i % 2), column
//   c4 + 4 (i / 2)) and split in registers, B = P written to shared memory
//   by the softmax as big and small parts, keys contiguous (K-major). So V
//   is transposed by where each thread reads it, and P, whose accumulator
//   layout is not the tf32 A-fragment layout, goes through shared memory in
//   the one layout B needs. The rescale of O^T and the final division by
//   the normaliser work per column (query), through a 64-float row of
//   shared memory.
//
//   Pipeline. Three warpgroups: in the first, warp w (0, 1) issues the TMA
//   loads of consumer w's ring and warp 2 + w splits its K chunks; the
//   other two consume. A ring slot (24 KB) holds one unit: a QK unit is a
//   32-column depth chunk of Q (64 rows) and of K (64 keys) with K's small
//   part; a V unit is a 64-column output block of V (64 keys, two 32-column
//   boxes); per 64-key tile a consumer takes its QK units, then its V
//   units. Q comes again from L2 for every key tile. The tensor maps are
//   3-D (d, T, BH) with 32-column (128-byte) swizzled boxes; rows past T
//   and columns past d arrive as zeros, so a d between buckets runs in the
//   next one up on zero columns, and the loops cover d itself (ceil(d / 8)
//   depth steps, ceil(d / 64) output blocks).
//
//   Buckets (each output block is 32 accumulator registers a thread): 40,
//   80 and 160 give each consumer warpgroup a 64-row query tile of its own
//   (1, 2, 3 blocks); 512 puts both on one 64-row tile, each with half of
//   the depth (its partial logits added to the other's through its P area,
//   between two barriers: a + b = b + a, so both hold the same S) and half
//   of the output's columns (4 blocks). Shared memory, every bucket: ring
//   2 x 3 slots x 24 KB = 144 KB, P 2 x (16 + 16) KB = 64 KB, the rows 1 KB
//   (210 KB with the 1 KB alignment pad), so one block per SM.
//
//   What bounds it. Three TF32 products: 3 x 4 BH T^2 d operations at 495
//   TFLOP/s (an effective 165 TFLOP/s of f32 work against the CUDA cores'
//   67); chip_smoke.py prints each f32 shape's time against that bound and
//   beside the FMA body's. The products, not the splits, take most of the
//   time: 64-key tiles (n64 products) run faster than 32-key ones, and the
//   split rounds with two integer operations, not the slower conversion
//   instruction. Not done yet: a consumer that overlaps one tile's softmax
//   with the next tile's QK^T, Q kept in shared memory where it fits, the
//   exchange at d = 512 without its second barrier.
//
// * flash_fwd, everything else (f32 with d % 4 != 0 or an unaligned base
//   pointer; bf16 with d % 8 != 0 or an unaligned base pointer), where TMA
//   cannot serve: its row stride must be a multiple of 16 bytes. f32 FMAs
//   on register tiles fed from shared memory, no tensor cores. Per (head,
//   query tile) it streams K/V tiles through shared memory and keeps the
//   logits tile on chip; each head-dim bucket picks its query tile so Q, K,
//   V and the logits fit the 227 KB of shared memory. Shared-memory rows
//   are padded to an odd stride so the column reads of the two products are
//   free of bank conflicts.
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

// Online softmax in base 2 over one tile of 2 N keys, the logits in the
// m64nN accumulator layout (both tensor-core bodies): element i is row r0
// = g or r1 = g + 8 of the warp's 16 by (i / 2) % 2, key key0 + 8 (i / 4) +
// 2 c4 + i % 2. Scales the logits by scale_log2, masks keys past seq,
// turns them into p in place, updates each row's running max m and this
// thread's share of its normaliser l (summed across the row's four threads
// by quad_sum at the end), and returns each row's rescale factor in a0, a1.
// The tile's first key is always real, so the new max is finite; exp2(-inf)
// = 0 for the masked keys and for the first tile's rescale.
template <int N>
__device__ __forceinline__ void online_softmax(float* sc, int key0, int seq,
                                               int c4, float scale_log2,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& a0, float& a1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = sc[i] * scale_log2;
    if (key0 + 2 * N > seq && key0 + 8 * (i / 4) + 2 * c4 + (i % 2) >= seq)
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
  a0 = ex2(m0 - mn0);
  a1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if ((i / 2) % 2) {
      sc[i] = ex2(sc[i] - mn1);
      rs1 += sc[i];
    } else {
      sc[i] = ex2(sc[i] - mn0);
      rs0 += sc[i];
    }
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
}

// Each row's normaliser: the sum of its four threads' shares.
__device__ __forceinline__ void quad_sum(float& l0, float& l1) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
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

// wgmma.mma_async m64nNk8, f32 += tf32 * tf32, A from registers (4 words
// a thread), B from shared memory in K-major form (32-bit types have no
// transpose bit). acc = 0 overwrites d instead of adding to it.
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t db, int acc) {
  asm volatile(
      "{.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : F4(0), F4(4), F4(8), F4(12), F4(16), F4(20), F4(24), F4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
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

      float a0, a1;
      online_softmax<C::BK / 2>(sc, it * C::BK, seq, c4, scale_log2, m0, m1,
                                l0, l1, a0, a1);
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

    quad_sum(l0, l1);
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

// 3-D (d, T, BH) map of bf16 or f32 elements with boxes of one 128-byte row
// (64 bf16 or 32 f32 columns) x `rows`, 128-byte swizzle; out-of-bounds
// elements (columns past d, rows past T) are read as zero.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int bh, int seq, int d,
                     int rows) {
  constexpr int es = (int)sizeof(T);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * es,
                                 (cuuint64_t)seq * d * es};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = encode(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
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
  using B16 = __nv_bfloat16;
  cudaError_t err = make_map<B16>(&tq, q, bh, seq, d, 64);
  if (err == cudaSuccess) err = make_map<B16>(&tk, k, bh, seq, d, C::BK);
  if (err == cudaSuccess) err = make_map<B16>(&tv, v, bh, seq, d, C::BK);
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

// ---------------------------------------------------------------------------
// f32 on the tensor cores: error-compensated TF32 (3xTF32), TMA + wgmma.

constexpr int kF32Cols = 32;               // f32 columns in a 128-byte row
constexpr int kXBK = 64;                   // keys per tile
constexpr int kXBox = 64 * 128;            // one Q, K or V box: 64 rows x 32 cols
constexpr int kXUnit = 3 * kXBox;          // one ring slot (Q, K big, K small)
constexpr int kXNS = 3;                    // ring slots a consumer warpgroup
constexpr int kXP = 2 * kXBox;             // P (big or small): 64 queries x 64 keys

// One head-dim bucket: MB 64-column output blocks per warpgroup; SPLIT =
// both consumer warpgroups on one 64-row query tile (d > 160), each with
// half of the QK^T depth (partial logits summed through shared memory) and
// half of the output's columns; otherwise each has a query tile of its own.
template <int MB_, bool SPLIT_>
struct XCfg {
  static constexpr int MB = MB_;
  static constexpr bool SPLIT = SPLIT_;
  static constexpr int BQ = SPLIT ? 64 : 128;
  static constexpr int P_OFF = 2 * kXNS * kXUnit;    // [wg][big, small]
  static constexpr int ROW_OFF = P_OFF + 2 * 2 * kXP;
  static constexpr int SMEM = 1024 + ROW_OFF + 2 * 2 * 64 * 4;  // [wg][parity]
  static_assert(SMEM + 3 * 2 * kXNS * 8 <= 232448,
                "fits the 227 KB of shared memory a block may use");
};

//                   MB  SPLIT
using XCfg40  = XCfg<1,  false>;   // UNet 512px level 0
using XCfg80  = XCfg<2,  false>;   // UNet level 1
using XCfg160 = XCfg<3,  false>;   // UNet levels 2 and mid
using XCfg512 = XCfg<4,  true>;    // VAE mid block

// TF32 of x, rounded to nearest with ties away from zero, as the f32 word
// with its 13 low bits clear: the value cvt.rna.tf32.f32 gives (for finite
// x), by two integer operations, which run faster here than the conversion
// instruction; the clear bits make the word exact whatever the tensor cores
// would do with them.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + O(2^-22 |x|): big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// Byte offset of (row, 32-bit column) in a 1024-byte aligned tile of
// 128-byte rows in TMA's 128-byte swizzle: the 16-byte piece index XOR the
// row's index within its 8-row group.
__device__ __forceinline__ uint32_t sw128_off(int row, int col) {
  return row * 128 + ((((col >> 2) ^ (row & 7)) << 4) | ((col & 3) << 2));
}

// Register i (0..3) of the m64k8 tf32 A fragment of lane (g = lane / 4,
// c4 = lane % 4) holds row g + 8 (i % 2), column c4 + 4 (i / 2) of its
// warp's 16 x 8 slice.
__device__ __forceinline__ int afrag_row(int i, int g) { return g + 8 * (i & 1); }
__device__ __forceinline__ int afrag_col(int i, int c4) { return c4 + 4 * (i >> 1); }

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// What warpgroup w of a block does with d: depth chunks [c0, c0 + nc) of
// 32 columns for QK^T, output blocks [m0, m0 + nm) of 64 columns, its
// queries from row qrow; per key tile nc QK units, then nm V units.
struct XPlan {
  int c0, nc, m0, nm, qrow;
};

template <class C>
__device__ __forceinline__ XPlan x_plan(int w, int d) {
  const int nch = (d + kF32Cols - 1) / kF32Cols, nmb = (d + 63) / 64;
  XPlan p;
  if (C::SPLIT) {
    const int hc = (nch + 1) / 2, hm = (nmb + 1) / 2;
    p.c0 = w ? hc : 0;
    p.nc = w ? nch - hc : hc;
    p.m0 = w ? hm : 0;
    p.nm = w ? nmb - hm : hm;
    p.qrow = blockIdx.x * C::BQ;
  } else {
    p.c0 = 0;
    p.nc = nch;
    p.m0 = 0;
    p.nm = nmb;
    p.qrow = blockIdx.x * C::BQ + 64 * w;
  }
  return p;
}

// grid = (ceil(T / BQ), BH); block = 384 threads; dynamic smem = C::SMEM.
// Warpgroup 0: warp w (0, 1) issues the TMA loads of consumer w's ring,
// warp 2 + w splits its K chunks into TF32 big and small parts. Warpgroups
// 1 and 2 consume. scale_log2 = scale * log2(e).
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 float* __restrict__ o, int seq, int d, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  // bars: [s] slot s loaded (TMA); [2 NS + s] slot s ready (its K chunk
  // split; passed through for V); [4 NS + s] slot s free (one arrival per
  // consumer warp). Slots [w NS, (w + 1) NS) are warpgroup w's.
  __shared__ __align__(8) uint64_t bars[3 * 2 * kXNS];
  unsigned char* gen = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(gen);
  auto bar_full = [&](int s) { return smem_u32(&bars[s]); };
  auto bar_ready = [&](int s) { return smem_u32(&bars[2 * kXNS + s]); };
  auto bar_free = [&](int s) { return smem_u32(&bars[4 * kXNS + s]); };

  const int tid = threadIdx.x, head = blockIdx.y;
  const int ntiles = (seq + kXBK - 1) / kXBK;
  if (tid == 0) {
    for (int s = 0; s < 2 * kXNS; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_ready(s), 1);
      mbar_init(bar_free(s), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = tid / 32, lane = tid % 32, w = warp % 2;
    const XPlan pl = x_plan<C>(w, d);
    if (pl.qrow >= seq) return;        // a second query tile past the end
    const int per_tile = pl.nc + pl.nm;
    if (warp < 2) {
      // Producer of warpgroup w's ring. The first wait on each free barrier
      // passes at once (parity of the phase before the first).
      if (lane != 0) return;
      int u = 0;
      for (int t = 0; t < ntiles; ++t) {
        for (int j = 0; j < per_tile; ++j, ++u) {
          const int s = w * kXNS + u % kXNS;
          const uint32_t ph = (u / kXNS) & 1;
          const uint32_t slot = base + s * kXUnit;
          mbar_wait(bar_free(s), ph ^ 1);
          if (j < pl.nc) {
            const int col = kF32Cols * (pl.c0 + j);
            mbar_expect_tx(bar_full(s), 2 * kXBox);
            tma_load(slot, &tq, col, pl.qrow, head, bar_full(s));
            tma_load(slot + kXBox, &tk, col, t * kXBK, head, bar_full(s));
          } else {
            // one 64-column output block as two 32-column boxes; a box
            // wholly past d is not loaded (its rows feed output columns
            // that are never stored)
            const int col = 64 * (pl.m0 + j - pl.nc);
            const int nbox = col + 32 < d ? 2 : 1;
            mbar_expect_tx(bar_full(s), nbox * kXBox);
            for (int b = 0; b < nbox; ++b)
              tma_load(slot + b * kXBox, &tv, col + 32 * b, t * kXBK, head,
                       bar_full(s));
          }
        }
      }
    } else {
      // Splitter of warpgroup w's ring: each K chunk (64 keys x 32 columns)
      // becomes big (in place) and small (the next box), element by element
      // at the same swizzled offsets.
      int u = 0;
      for (int t = 0; t < ntiles; ++t) {
        for (int j = 0; j < per_tile; ++j, ++u) {
          const int s = w * kXNS + u % kXNS;
          const uint32_t ph = (u / kXNS) & 1;
          mbar_wait(bar_full(s), ph);
          if (j < pl.nc) {
            float4* kb = reinterpret_cast<float4*>(gen + s * kXUnit + kXBox);
            float4* ks = kb + kXBox / 16;
#pragma unroll 2
            for (int i = lane; i < kXBox / 16; i += 32) {
              const float4 x = kb[i];
              uint4 b, sm;
              split_tf32(x.x, b.x, sm.x);
              split_tf32(x.y, b.y, sm.y);
              split_tf32(x.z, b.z, sm.z);
              split_tf32(x.w, b.w, sm.w);
              kb[i] = *reinterpret_cast<float4*>(&b);
              ks[i] = *reinterpret_cast<float4*>(&sm);
            }
            fence_proxy_async();
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_ready(s));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = tid / 128 - 1;                // consumer warpgroup 0 or 1
    const int t128 = tid % 128, warp = t128 / 32, lane = t128 % 32;
    const int g = lane / 4, c4 = lane % 4;
    const XPlan pl = x_plan<C>(w, d);
    if (pl.qrow >= seq) return;
    const uint32_t p_big = base + C::P_OFF + w * 2 * kXP, p_small = p_big + kXP;
    unsigned char* p_gen = gen + C::P_OFF + w * 2 * kXP;
    float* rows = reinterpret_cast<float*>(gen + C::ROW_OFF) + w * 2 * 64;
    const int r0 = 16 * warp + g, r1 = r0 + 8;   // this thread's S rows

    float acc[C::MB][32];
#pragma unroll
    for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    int u = 0;
    for (int t = 0; t < ntiles; ++t) {
      // S = Q K^T over this warpgroup's depth chunks: three wgmma per 8
      // columns, small terms first, A (Q) split in registers.
      float sc[32];
      for (int j = 0; j < pl.nc; ++j, ++u) {
        const int s = w * kXNS + u % kXNS;
        const uint32_t ph = (u / kXNS) & 1;
        const uint32_t slot = base + s * kXUnit;
        const unsigned char* qg = gen + s * kXUnit;
        const int left = d - kF32Cols * (pl.c0 + j);
        const int nks = left >= 32 ? 4 : (left + 7) / 8;
        uint32_t qb[4][4], qs[4][4];
        mbar_wait(bar_full(s), ph);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = *reinterpret_cast<const float*>(
                qg + sw128_off(16 * warp + afrag_row(i, g),
                               8 * kk + afrag_col(i, c4)));
            split_tf32(x, qb[kk][i], qs[kk][i]);
          }
        mbar_wait(bar_ready(s), ph);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < nks) {
            const uint64_t kb = sw128_desc(slot + kXBox + 32 * kk, 16);
            const uint64_t ks = sw128_desc(slot + 2 * kXBox + 32 * kk, 16);
            wgmma_tf32_n64(sc, qb[kk], ks, j > 0 || kk > 0);
            wgmma_tf32_n64(sc, qs[kk], kb, 1);
            wgmma_tf32_n64(sc, qb[kk], kb, 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_free(s));
      }
      if (C::SPLIT) {
        // The two halves of the depth: each warpgroup adds the other's
        // partial logits to its own (a + b = b + a: both hold the same S),
        // passed through its P area, free until the second barrier.
        float* mine = reinterpret_cast<float*>(p_gen);
        const float* other = reinterpret_cast<const float*>(
            gen + C::P_OFF + (1 - w) * 2 * kXP);
#pragma unroll
        for (int i = 0; i < 32; ++i) mine[i * 128 + t128] = sc[i];
        named_bar_sync(1, 256);
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] += other[i * 128 + t128];
        named_bar_sync(1, 256);
      }

      float a0, a1;
      online_softmax<32>(sc, t * kXBK, seq, c4, scale_log2, m0, m1, l0, l1,
                         a0, a1);

      // P (64 queries x 64 keys: two 32-key boxes) to shared memory as big
      // and small parts, K-major for O^T += V^T P^T; each row's rescale
      // beside it.
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = h ? r1 : r0, key = 8 * (jj % 4) + 2 * c4;
          const uint32_t off = (jj / 4) * kXBox + sw128_off(r, key);
          uint2 b, sm;
          split_tf32(sc[4 * jj + 2 * h], b.x, sm.x);
          split_tf32(sc[4 * jj + 2 * h + 1], b.y, sm.y);
          *reinterpret_cast<uint2*>(p_gen + off) = b;
          *reinterpret_cast<uint2*>(p_gen + kXP + off) = sm;
        }
      float* alpha = rows + (t & 1) * 64;
      if (c4 == 0) {
        alpha[r0] = a0;
        alpha[r1] = a1;
      }
      fence_proxy_async();
      named_bar_sync(2 + w, 128);

      // O^T (columns x queries) *= alpha of each query, then O^T += V^T P^T:
      // A (V^T) split in registers from the raw V boxes, B = P.
      float al[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        al[2 * jj] = alpha[8 * jj + 2 * c4];
        al[2 * jj + 1] = alpha[8 * jj + 2 * c4 + 1];
      }
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb)
        if (mb < pl.nm)
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[mb][i] *= al[2 * (i / 4) + (i % 2)];

#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb) {
        if (mb < pl.nm) {
          const int s = w * kXNS + u % kXNS;
          const uint32_t ph = (u / kXNS) & 1;
          mbar_wait(bar_full(s), ph);
          mbar_wait(bar_ready(s), ph);
          // this warp's 16 output columns of the block lie in one box
          const unsigned char* vg = gen + s * kXUnit + (warp / 2) * kXBox;
          fence_regs<32>(acc[mb]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {   // keys [32 half, +32)
            uint32_t vb[4][4], vs[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float x = *reinterpret_cast<const float*>(
                    vg + sw128_off(32 * half + 8 * kk + afrag_col(i, c4),
                                   16 * (warp % 2) + afrag_row(i, g)));
                split_tf32(x, vb[kk][i], vs[kk][i]);
              }
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint32_t po = half * kXBox + 32 * kk;
              const uint64_t pb = sw128_desc(p_big + po, 16);
              const uint64_t ps = sw128_desc(p_small + po, 16);
              wgmma_tf32_n64(acc[mb], vb[kk], ps, 1);
              wgmma_tf32_n64(acc[mb], vs[kk], pb, 1);
              wgmma_tf32_n64(acc[mb], vb[kk], pb, 1);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<32>(acc[mb]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(bar_free(s));
          ++u;
        }
      }
    }

    // Normaliser of each query, then O = O^T^T / l, written once.
    quad_sum(l0, l1);
    float* lrow = rows + (ntiles & 1) * 64;
    if (c4 == 0) {
      lrow[r0] = l0;
      lrow[r1] = l1;
    }
    named_bar_sync(2 + w, 128);
    float li[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      li[2 * jj] = lrow[8 * jj + 2 * c4];
      li[2 * jj + 1] = lrow[8 * jj + 2 * c4 + 1];
    }
#pragma unroll
    for (int mb = 0; mb < C::MB; ++mb) {
      if (mb >= pl.nm) continue;
      const int col0 = 64 * (pl.m0 + mb) + 16 * warp + g;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = col0 + 8 * ((i / 2) % 2);
        const int row = pl.qrow + 8 * (i / 4) + 2 * c4 + (i % 2);
        if (col < d && row < seq)
          o[((size_t)head * seq + row) * d + col] =
              acc[mb][i] / li[2 * (i / 4) + (i % 2)];
      }
    }
  }
}

template <class C>
cudaError_t launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                          int bh, int seq, int d, float scale,
                          cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<float>(&tq, q, bh, seq, d, 64);
  if (err == cudaSuccess) err = make_map<float>(&tk, k, bh, seq, d, kXBK);
  if (err == cudaSuccess) err = make_map<float>(&tv, v, bh, seq, d, kXBK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_tf32x3<C>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, kThreads, C::SMEM, stream>>>(tq, tk, tv, static_cast<float*>(o),
                                              seq, d, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch_tf32x3(const void* q, const void* k, const void* v,
                            void* o, int bh, int seq, int d, float scale,
                            cudaStream_t s) {
  if (d <= 40) return launch_tf32x3<XCfg40>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 80) return launch_tf32x3<XCfg80>(q, k, v, o, bh, seq, d, scale, s);
  if (d <= 160) return launch_tf32x3<XCfg160>(q, k, v, o, bh, seq, d, scale, s);
  return launch_tf32x3<XCfg512>(q, k, v, o, bh, seq, d, scale, s);
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

// The f32 tensor-core body (3xTF32): float32 only, d a multiple of 4
// (4..512), q, k, v 16-byte aligned. Anything else is refused, not
// rerouted: the caller picks the body (ops/attention.py:route).
int sdvg_flash_attention_tf32x3(const void* q, const void* k, const void* v,
                                void* o, int bh, int seq, int d, float scale,
                                void* stream) {
  if (bh < 1 || bh > 65535 || seq < 1 || d < 4 || d > 512 || d % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(o) % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_tf32x3(q, k, v, o, bh, seq, d, scale,
                              static_cast<cudaStream_t>(stream));
}

const char* sdvg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
