// GroupNorm (+ optional SiLU) for Hopper (sm_90a), NHWC (channels-last).
//
// Replaces the TPU kernel sd_video_gen_tpu/ops/groupnorm.py:_gn_kernel (the
// pl.pallas_call in groupnorm_silu_pallas), in its own layout: the input is a
// (B, C, H, W) tensor in channels-last strides, memory (B, H*W, C), and group
// g is channels [g * cpg, (g + 1) * cpg) of every pixel. Same arithmetic as
// the TPU kernel and as the NCHW body (groupnorm_silu.cu): per (batch, group)
// the mean and the sum of squared deviations in f32 (per-thread running
// values merged exactly, Chan et al.; never E[x^2] - mean^2), an exact
// 1 / sqrt(var + eps), the per-channel affine, an optional SiLU in f32, and
// one rounding to the input type (f32 or bf16).
//
// What bounds it on this card: bytes. A few flops per element, so the least
// time is one read and one write of the tensor at the memory rate. The TPU
// kernel reaches one read by keeping a whole (H*W, C) slab in VMEM. Here the
// unit of work is (batch b, a slice of whole groups, all H*W pixels):
//
//   cluster mode (one read, one launch), where a cluster of up to 8 blocks
//   holds a unit in shared memory. One cluster per unit; a block owns a range
//   of the unit's pixels and one tile of up to 190 KB. cp.async brings the
//   tile in (the thread's weights and biases come meanwhile); one pass over
//   the tile for each thread's (mean, M2) per channel lane; the block's
//   merge; one cluster barrier; every block reads every block's partials
//   through distributed shared memory and merges them in the same order (so
//   all agree bit for bit); the output pass normalises from shared memory and
//   stores. A block signals the barrier's second half as soon as it has read
//   its neighbours and waits for it only before it exits.
//
//   streaming mode (two reads, two launches), for the rest. gn_nhwc_stats:
//   each block reduces its share of the unit's pixels in registers to one
//   (mean, M2) per group; gn_nhwc_apply: every block first merges the unit's
//   partials itself (one warp per group), then normalises and stores,
//   walking backwards so that it starts on what the L2 cache still holds
//   from the first launch. No third launch, no atomics, no workspace to
//   clear. It moves three tensors' worth of bytes where the bound has two,
//   at the rate a plain copy reaches, so it tops out near 57% of the bound.
//
//   Which mode, and its layout (groups per unit, blocks per cluster), is
//   chosen per shape before launch by a rule (plan_for, better): the cluster
//   mode where the whole tensor is one wave of at most one block per SM
//   (every UNet norm at one clip per batch, most at eight, the VAE's up to
//   64px), or several waves of clusters of at most 4 blocks on rows of at
//   least 64 bytes (the widest 64px norms at eight clips). The streaming mode
//   takes what is left: every VAE norm from 128px up, whose units (8-17 MB at
//   256px and 512px) no cluster holds, and the shapes where only a cluster of
//   8 in many waves would fit, which timed no faster than streaming. So a
//   shape can fit a cluster and still stream: (8, 960, 64, 64) and (8, 512,
//   128, 128) do.
//
// Sectors and bursts. In NHWC a group is cpg adjacent channels of a pixel (8
// bytes at cpg = 4 in bf16). A unit takes whole groups: at least a 32-byte
// sector and whole 16-byte vectors (16 / gcd(cpg * sizeof, 16) groups); the
// streaming mode takes rows of up to 512 bytes. Threads form
// (tile rows) x (vectors of a row), so a thread keeps one column: its lanes'
// channels, groups, weights and biases are fixed and live in registers, and
// neighbouring threads touch neighbouring 16-byte vectors of global and of
// shared memory. Vectors may cross a group edge (cpg = 10, 20, 30, 60): each
// lane carries its own group. Where C * sizeof(T) is not a multiple of 16 or
// a pointer is unaligned, the same kernels run with one element per "vector"
// (and plain loads in place of cp.async).
//
// Arithmetic is not free here: some twenty instructions an element in bf16
// put the SMs' instruction rate within a factor of two of the memory bound,
// so the statistics take one division per four loads.
//
// No mbarrier and no spin wait: the waits are cp.async.wait_group,
// __syncthreads and the hardware cluster barrier, which all blocks of a
// cluster (co-scheduled by the hardware) reach the same number of times, so a
// fault cannot hang the card.
//
// Built by sd_video_gen_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c
// and called through ctypes (plain C interface below). Nothing here
// allocates: the caller passes sdvg_groupnorm_silu_nhwc_plan(...) bytes of
// workspace (0 in cluster mode).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroupsPerUnit = 32;
constexpr int kTileMax = 190 * 1024;       // a block's tile
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMaxStatBlocks = 512;        // streaming mode, blocks per unit
constexpr int kApplyRowsPerThread = 16;    // streaming mode, apply kernel

// Geometry of one launch, worked out on the host (make_plan).
struct Geo {
  int C, hw, G, cpg;
  int gpu;         // groups per unit
  int cs;          // channels per unit = gpu * cpg
  int vpr;         // vectors per tile row = cs / V
  int rows;        // tile rows the block covers per pass = kThreads / vpr
  int nseg;        // row segments of the column reduction
  int tile_bytes;  // cluster mode: one shared-memory tile, a multiple of 16
  int slices;      // G / gpu
};

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

// The calling thread's place in the (rows x vpr) layout.
struct Place {
  int r, col;
  bool active;  // threads past rows * vpr idle
};

__device__ __forceinline__ Place place(const Geo& p) {
  Place w;
  w.r = (int)threadIdx.x / p.vpr;
  w.col = (int)threadIdx.x - w.r * p.vpr;
  w.active = w.r < p.rows;
  return w;
}

// A thread's running (mean, M2) per lane and the number of pixels in them.
template <int V>
struct Running {
  float mean[V], m2[V], have;
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < V; ++k) mean[k] = m2[k] = 0.f;
    have = 0.f;
  }
};

// Adds the pixels px, px + step, ... below `end`, loaded by ld(px), to the
// thread's running values; merged in batches of four loads (Chan et al.: one
// division per batch, none per element).
template <typename T, int V, typename Load>
__device__ __forceinline__ void chan_rows(Load ld, int px, int end, int step,
                                          Running<V>& run) {
  using P = Pack<T, V>;
  float have = run.have;
  for (; px + 3 * step < end; px += 4 * step) {  // four loads in flight
    P v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ld(px + k * step);
    const float tot = have + 4.f, f1 = 4.f / tot, f2 = have * f1;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float x0 = to_float(v[0].v[k]), x1 = to_float(v[1].v[k]),
                  x2 = to_float(v[2].v[k]), x3 = to_float(v[3].v[k]);
      const float bm = ((x0 + x1) + (x2 + x3)) * 0.25f;
      const float d0 = x0 - bm, d1 = x1 - bm, d2 = x2 - bm, d3 = x3 - bm;
      const float bq = fmaf(d0, d0, fmaf(d1, d1, fmaf(d2, d2, d3 * d3)));
      const float dl = bm - run.mean[k];
      run.mean[k] = fmaf(dl, f1, run.mean[k]);
      run.m2[k] += fmaf(dl * dl, f2, bq);
    }
    have = tot;
  }
  for (; px < end; px += step) {
    const P v = ld(px);
    const float tot = have + 1.f, f1 = 1.f / tot, f2 = have * f1;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float dl = to_float(v.v[k]) - run.mean[k];
      run.mean[k] = fmaf(dl, f1, run.mean[k]);
      run.m2[k] = fmaf(dl * dl, f2, run.m2[k]);
    }
    have = tot;
  }
  run.have = have;
}

// Merges every active thread's per-lane (mean, M2) over its pixels of [0, np)
// into the block's (mean, M2) per group, in a fixed order and each step as an
// exact weighted two-pass merge (mean first, then M2 about it): rows ->
// nseg segments per channel (in place: segment s owns row s), then one warp
// per group over its segments x channels. out_mean[g], out_m2[g] for g <
// gpu; smean, sm2: kThreads * V floats each, segcnt: kThreads ints; ends with
// a __syncthreads.
template <int V>
__device__ __forceinline__ void block_merge(const Running<V>& run,
                                            const Place& w, const Geo& p,
                                            int np, float* smean, float* sm2,
                                            int* segcnt, float* out_mean,
                                            float* out_m2) {
  const int cs = p.cs, nseg = p.nseg, step = p.rows;
  // pixels of [0, np) that tile row r takes: r, r + step, ...
  const int whole = np / step, rest = np - whole * step;
  const auto cnt = [&](int r) { return whole + (r < rest ? 1 : 0); };
  if (w.active) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      smean[w.r * cs + w.col * V + k] = run.mean[k];
      sm2[w.r * cs + w.col * V + k] = run.m2[k];
    }
  }
  __syncthreads();
  for (int task = threadIdx.x; task < nseg * cs; task += kThreads) {
    const int seg = task / cs, c = task - seg * cs;
    float a = 0.f;
    int have = 0;
    for (int rr = seg; rr < step; rr += nseg) {
      a += (float)cnt(rr) * smean[rr * cs + c];
      have += cnt(rr);
    }
    const float mu = have ? a / (float)have : 0.f;
    float q = 0.f;
    for (int rr = seg; rr < step; rr += nseg) {
      const float d = smean[rr * cs + c] - mu;
      q += sm2[rr * cs + c] + (float)cnt(rr) * d * d;
    }
    smean[seg * cs + c] = mu;
    sm2[seg * cs + c] = q;
    if (c == 0) segcnt[seg] = have;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float n = (float)p.cpg * (float)np;
  for (int g = warp; g < p.gpu; g += kWarps) {
    // lane's items (seg, j): j + seg * cpg = lane, lane + 32, ...
    const int seg0 = lane / p.cpg, j0 = lane - seg0 * p.cpg;
    const int dseg = 32 / p.cpg, dj = 32 - dseg * p.cpg;
    float a = 0.f;
    for (int seg = seg0, j = j0; seg < nseg;) {
      a += (float)segcnt[seg] * smean[seg * cs + g * p.cpg + j];
      seg += dseg;
      j += dj;
      if (j >= p.cpg) {
        j -= p.cpg;
        ++seg;
      }
    }
    const float mu = np ? warp_sum(a) / n : 0.f;
    float q = 0.f;
    for (int seg = seg0, j = j0; seg < nseg;) {
      const float d = smean[seg * cs + g * p.cpg + j] - mu;
      q += sm2[seg * cs + g * p.cpg + j] + (float)segcnt[seg] * d * d;
      seg += dseg;
      j += dj;
      if (j >= p.cpg) {
        j -= p.cpg;
        ++seg;
      }
    }
    q = warp_sum(q);
    if (lane == 0) {
      out_mean[g] = mu;
      out_m2[g] = q;
    }
  }
  __syncthreads();
}

// 16 bytes, global -> shared memory, without passing through registers.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start the copy of this thread's vectors of pixels [0, np) (first element
// xg) into its slots of the tile. 16-byte vectors go asynchronously (one
// commit group per call); the one-element variant copies at once. (Four
// commit groups with the statistics of one running under the copy of the
// next were timed and changed nothing: see PERF.md.)
template <typename T, int V>
__device__ __forceinline__ void fetch_tile(const T* __restrict__ xg, T* tile,
                                           int np, const Place& w,
                                           const Geo& p) {
  using P = Pack<T, V>;
  if (w.active) {
    P* ts = reinterpret_cast<P*>(tile);
    for (int px = w.r; px < np; px += p.rows) {
      if constexpr (sizeof(P) == 16)
        cp_async16(ts + px * p.vpr + w.col, xg + (size_t)px * p.C);
      else
        ts[px * p.vpr + w.col] =
            *reinterpret_cast<const P*>(xg + (size_t)px * p.C);
    }
  }
  cp_async_commit();
}

// A lane's constants for the output pass: y = (x - mean) * a + b with
// a = rstd * weight, then SiLU.
template <int V>
struct LaneAffine {
  float mean[V], a[V], b[V];
};

template <typename T, int V>
__device__ __forceinline__ LaneAffine<V> lane_affine(
    const T* __restrict__ wt, const T* __restrict__ bs, int slice,
    const Place& w, const Geo& p, const float* mean, const float* rstd) {
  LaneAffine<V> la;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int c = w.active ? w.col * V + u : 0;  // channel inside the slice
    const int g = c / p.cpg;
    la.mean[u] = mean[g];
    la.a[u] = rstd[g] * to_float(wt[slice * p.cs + c]);
    la.b[u] = to_float(bs[slice * p.cs + c]);
  }
  return la;
}

// SiLU in f32, as the NCHW body computes it (expf and a true division).
__device__ __forceinline__ float silu_f32(float y) {
  return y / (1.0f + expf(-y));
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> normalise(const Pack<T, V>& v,
                                                const LaneAffine<V>& la,
                                                bool silu) {
  Pack<T, V> q;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    float y = fmaf(to_float(v.v[u]) - la.mean[u], la.a[u], la.b[u]);
    if (silu) y = silu_f32(y);
    q.v[u] = from_float<T>(y);
  }
  return q;
}

// A lane's weight and bias, fetched before the statistics are known (their
// latency hides behind the tile's).
template <typename T, int V>
__device__ __forceinline__ void lane_params(const T* __restrict__ wt,
                                            const T* __restrict__ bs, int slice,
                                            const Place& w, const Geo& p,
                                            Pack<T, V>* wv, Pack<T, V>* bv) {
  const size_t c = (size_t)slice * p.cs + (w.active ? w.col * V : 0);
  *wv = *reinterpret_cast<const Pack<T, V>*>(wt + c);
  *bv = *reinterpret_cast<const Pack<T, V>*>(bs + c);
}

template <typename T, int V>
__device__ __forceinline__ LaneAffine<V> lane_affine(
    const Pack<T, V>& wv, const Pack<T, V>& bv, const Place& w, const Geo& p,
    const float* mean, const float* rstd) {
  LaneAffine<V> la;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const int g = (w.active ? w.col * V + u : 0) / p.cpg;
    la.mean[u] = mean[g];
    la.a[u] = rstd[g] * to_float(wv.v[u]);
    la.b[u] = to_float(bv.v[u]);
  }
  return la;
}

// The output pass of a block that holds its pixels in a tile: normalise this
// thread's vectors of pixels [0, np) from shared memory and store them (first
// element og).
template <typename T, int V>
__device__ __forceinline__ void write_from_tile(const Pack<T, V>* ts, T* og,
                                                int np, const Place& w,
                                                const Geo& p,
                                                const LaneAffine<V>& la,
                                                bool silu) {
  using P = Pack<T, V>;
  const int step = p.rows;
  int px = w.r;
  for (; px + 3 * step < np; px += 4 * step) {
    P v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = ts[(px + k * step) * p.vpr + w.col];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<P*>(og + (size_t)(px + k * step) * p.C) =
          normalise<T, V>(v[k], la, silu);
  }
  for (; px < np; px += step)
    *reinterpret_cast<P*>(og + (size_t)px * p.C) =
        normalise<T, V>(ts[px * p.vpr + w.col], la, silu);
}

// Shared memory beside the tile: block_merge's three arrays.
template <int V>
__host__ __device__ constexpr int extra_smem() {
  return (2 * kThreads * V + kThreads) * (int)sizeof(float);
}

// The cluster barrier in its two halves (barrier.cluster): a block arrives
// once it has read its neighbours' partials and waits only before it exits,
// so its output pass overlaps the neighbours' reads of its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Cluster mode. grid = (cluster size, slices, B), cluster = (cluster size, 1,
// 1): one cluster per unit (batch blockIdx.z, slice blockIdx.y); block `rank`
// holds pixels [rank * per, (rank + 1) * per) of it in its tile. One pass over
// the tile for each thread's (mean, M2), the block's merge, one cluster
// barrier, every block's merge of all the blocks' partials read through
// distributed shared memory, and the output pass from the tile. Blocks of
// other units on the same SM (two fit while a tile is under ~78 KB) keep
// device memory busy meanwhile: kBlocksPerSm = 2 holds the kernel to the 64
// registers that takes, kBlocksPerSm = 1 (larger tiles) leaves it 128.
template <typename T, int V, int kBlocksPerSm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
gn_nhwc_cluster(const T* __restrict__ x, const T* __restrict__ wt,
                const T* __restrict__ bs, T* __restrict__ out, Geo p,
                float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  using P = Pack<T, V>;
  float* smean = reinterpret_cast<float*>(smem + p.tile_bytes);
  float* sm2 = smean + kThreads * V;
  int* segcnt = reinterpret_cast<int*>(sm2 + kThreads * V);
  __shared__ float part_mean[kMaxGroupsPerUnit], part_m2[kMaxGroupsPerUnit];
  __shared__ float mean[kMaxGroupsPerUnit], rstd[kMaxGroupsPerUnit];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ncl = (int)cluster.num_blocks();
  const int slice = blockIdx.y, bi = blockIdx.z;
  const int per = (p.hw + ncl - 1) / ncl;
  const int p0 = min(rank * per, p.hw), np = min(per, p.hw - p0);
  const Place w = place(p);
  const float n = (float)p.cpg * (float)p.hw;
  const size_t first = ((size_t)bi * p.hw + p0) * p.C + (size_t)slice * p.cs +
                       (w.active ? w.col * V : 0);
  const P* ts = reinterpret_cast<const P*>(smem);

  fetch_tile<T, V>(x + first, reinterpret_cast<T*>(smem), np, w, p);
  P wv, bv;
  lane_params<T, V>(wt, bs, slice, w, p, &wv, &bv);
  cp_async_wait<0>();  // a thread reads back only the slots it fetched

  Running<V> run;
  run.clear();
  if (w.active)
    chan_rows<T, V>([&](int px) { return ts[px * p.vpr + w.col]; }, w.r, np,
                    p.rows, run);
  block_merge<V>(run, w, p, np, smean, sm2, segcnt, part_mean, part_m2);
  if (ncl > 1) {
    cluster.sync();  // every block's partials of this unit are written
    // the gather: thread t reads group t / ncl of block t % ncl
    const int gg = (int)threadIdx.x / ncl, grk = (int)threadIdx.x - gg * ncl;
    const bool gathers = gg < p.gpu;
    if ((int)threadIdx.x / 32 < (p.gpu * ncl + 31) / 32) {
      const int g_np = min(per, p.hw - min(grk * per, p.hw));
      const float g_cnt = gathers ? (float)p.cpg * (float)g_np : 0.f;
      float m_i = 0.f, q_i = 0.f;
      if (gathers) {
        m_i = *cluster.map_shared_rank(part_mean + gg, grk);
        q_i = *cluster.map_shared_rank(part_m2 + gg, grk);
      }
      float a = g_cnt * m_i;
      for (int o = 1; o < ncl; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      const float mu = a / n;
      const float d = m_i - mu;
      float q = q_i + g_cnt * d * d;
      for (int o = 1; o < ncl; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      if (gathers && grk == 0) {
        mean[gg] = mu;
        rstd[gg] = 1.0f / sqrtf(q / n + eps);
      }
    }
    cluster_arrive();  // this block is done with its neighbours' memory
  } else if ((int)threadIdx.x < p.gpu) {
    mean[threadIdx.x] = part_mean[threadIdx.x];
    rstd[threadIdx.x] = 1.0f / sqrtf(part_m2[threadIdx.x] / n + eps);
  }
  __syncthreads();

  if (w.active)
    write_from_tile<T, V>(ts, out + first, np, w, p,
                          lane_affine<T, V>(wv, bv, w, p, mean, rstd),
                          silu != 0);
  // No block's shared memory may go away while a neighbour still reads it.
  if (ncl > 1) cluster_wait();
}

// Pixels [share_begin(blk), share_begin(blk + 1)) of hw belong to stats block
// blk out of nblk.
__host__ __device__ __forceinline__ int share_begin(int blk, int nblk, int hw) {
  const int per = (hw + nblk - 1) / nblk;
  const long long b = (long long)blk * per;
  return b < hw ? (int)b : hw;
}

// Streaming mode, launch 1. grid = (nblk, slices, B). Each thread keeps a
// running (mean, M2) per lane over its pixels in registers (chan_rows), the
// block merges them (block_merge) and writes
// part[(b * G + g) * nblk + blk] = (mean, M2) of its pixels.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
gn_nhwc_stats(const T* __restrict__ x, float2* __restrict__ part, Geo p,
              int nblk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* smean = reinterpret_cast<float*>(smem);
  float* sm2 = smean + kThreads * V;
  int* segcnt = reinterpret_cast<int*>(sm2 + kThreads * V);
  __shared__ float gmean[kMaxGroupsPerUnit], gm2[kMaxGroupsPerUnit];
  using P = Pack<T, V>;

  const int blk = blockIdx.x, slice = blockIdx.y, bi = blockIdx.z;
  const int p0 = share_begin(blk, nblk, p.hw);
  const int np = share_begin(blk + 1, nblk, p.hw) - p0;
  const Place w = place(p);
  Running<V> run;
  run.clear();
  if (w.active) {
    const T* xg = x + ((size_t)bi * p.hw + p0) * p.C + (size_t)slice * p.cs +
                  w.col * V;
    chan_rows<T, V>(
        [&](int px) {
          return *reinterpret_cast<const P*>(xg + (size_t)px * p.C);
        },
        w.r, np, p.rows, run);
  }
  block_merge<V>(run, w, p, np, smean, sm2, segcnt, gmean, gm2);
  if ((int)threadIdx.x < p.gpu)
    part[((size_t)bi * p.G + slice * p.gpu + threadIdx.x) * nblk + blk] =
        make_float2(gmean[threadIdx.x], gm2[threadIdx.x]);
}

// Streaming mode, launch 2. grid = (pixel chunks, slices, B): merges the
// unit's partials (one warp per group), then one read and one write.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
gn_nhwc_apply(const T* __restrict__ x, const T* __restrict__ wt,
              const T* __restrict__ bs, const float2* __restrict__ part,
              T* __restrict__ out, Geo p, int nblk, int chunk_px, float eps,
              int silu) {
  __shared__ float mean[kMaxGroupsPerUnit], rstd[kMaxGroupsPerUnit];
  // Backwards over batch and pixels: what the first launch read last is what
  // the L2 cache still holds.
  const int slice = blockIdx.y, bi = gridDim.z - 1 - blockIdx.z;
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < p.gpu; g += kWarps) {
    const float2* pg = part + ((size_t)bi * p.G + slice * p.gpu + g) * nblk;
    const float n = (float)p.cpg * (float)p.hw;
    float a = 0.f;
    for (int i = lane; i < nblk; i += 32) {
      const int cnt = share_begin(i + 1, nblk, p.hw) - share_begin(i, nblk, p.hw);
      a += (float)p.cpg * (float)cnt * pg[i].x;
    }
    const float m = warp_sum(a) / n;
    float m2 = 0.f;
    for (int i = lane; i < nblk; i += 32) {
      const int cnt = share_begin(i + 1, nblk, p.hw) - share_begin(i, nblk, p.hw);
      const float d = pg[i].x - m;
      m2 += pg[i].y + (float)p.cpg * (float)cnt * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      mean[g] = m;
      rstd[g] = 1.0f / sqrtf(m2 / n + eps);
    }
  }
  __syncthreads();
  const Place w = place(p);
  if (!w.active) return;
  using P = Pack<T, V>;
  const LaneAffine<V> la = lane_affine<T, V>(wt, bs, slice, w, p, mean, rstd);
  const long long c0 = (long long)chunk * chunk_px;
  const int np = (int)min((long long)chunk_px, (long long)p.hw - c0);
  const size_t first = ((size_t)bi * p.hw + (size_t)c0) * p.C +
                       (size_t)slice * p.cs + w.col * V;
  const T* xg = x + first;
  T* og = out + first;
  const int step = p.rows;
  int px = w.r;
  for (; px + 3 * step < np; px += 4 * step) {
    P v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = *reinterpret_cast<const P*>(xg + (size_t)(px + k * step) * p.C);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<P*>(og + (size_t)(px + k * step) * p.C) =
          normalise<T, V>(v[k], la, silu != 0);
  }
  for (; px < np; px += step)
    *reinterpret_cast<P*>(og + (size_t)px * p.C) = normalise<T, V>(
        *reinterpret_cast<const P*>(xg + (size_t)px * p.C), la, silu != 0);
}

// ---- host side ----

enum Mode { kRefused = 0, kCluster = 1, kStreaming = 2 };

struct Plan {
  int mode = kRefused;
  int V = 1;         // elements per vector
  int cluster = 1;   // blocks per cluster (cluster mode)
  int nblk = 0;      // stats blocks per unit (streaming mode)
  int B = 0;
  long long workspace = 0;
  Geo geo{};
};

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

constexpr int kMaxDevices = 64;

// The current device, or -1 if it cannot be asked or is past kMaxDevices.
int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    cudaGetLastError();
    return -1;
  }
  return dev;
}

// SMs of the current device, asked once per device; 0 if the query fails.
int sm_count() {
  static int known[kMaxDevices] = {};
  static std::mutex lock;
  const int dev = current_device();
  if (dev < 0) return 0;
  std::lock_guard<std::mutex> hold(lock);
  if (known[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1) {
      cudaGetLastError();
      return 0;
    }
    known[dev] = n;
  }
  return known[dev];
}

// Two blocks of the cluster kernel share an SM while each one's shared memory
// (tile, merge arrays, statics and the system's 1 KB) is under half of it.
bool two_per_sm(int smem) { return smem + 2048 <= 232448 / 2; }

template <typename T, int V>
void allow_large_launches() {
  static bool done[kMaxDevices] = {};
  const int dev = current_device();
  if (dev < 0 || done[dev]) return;
  cudaFuncSetAttribute(gn_nhwc_cluster<T, V, 1>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kTileMax + extra_smem<V>());
  cudaFuncSetAttribute(gn_nhwc_cluster<T, V, 2>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       232448 / 2);
  done[dev] = true;
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cl,
                    int slices, int B, int smem, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cl, slices, B);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// How many clusters of `cl` blocks with `smem` bytes each the card holds at
// once (it depends on the SMs of each GPC of this die; 0: cannot be placed).
// Asked of the runtime once per (device, cluster size, shared memory).
template <typename T, int V>
int resident_clusters(int cl, int smem) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int>, int> known;
  const int dev = current_device();
  if (dev < 0) return 0;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_tuple(dev, cl, smem);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  allow_large_launches<T, V>();
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(&cfg, attr, cl, 4096, 1, smem, nullptr);
  int n = 0;
  if ((two_per_sm(smem)
           ? cudaOccupancyMaxActiveClusters(&n, gn_nhwc_cluster<T, V, 2>, &cfg)
           : cudaOccupancyMaxActiveClusters(&n, gn_nhwc_cluster<T, V, 1>,
                                            &cfg)) != cudaSuccess) {
    cudaGetLastError();  // cleared: this size is not taken
    n = 0;
  }
  known[key] = n;
  return n;
}

constexpr int kSectorBytes = 32;         // the least row of a unit
constexpr int kMinSplitTile = 16 * 1024; // no cluster for tiles under this
constexpr int kManyWavesCluster = 4;     // largest cluster past one wave
constexpr int kManyWavesRow = 64;        // least row past one wave

// A cluster layout of one call: groups per unit, cluster size, and what they
// give.
struct Layout {
  int g = 0, cl = 0, tile = 0;
  long long blocks = 0;
  bool one_wave = false;
};

// The rule between two cluster layouts that fit. Timings of every layout at
// the serving paths' shapes (chip_smoke.py --tune, PERF.md) showed: one block
// on each SM in a single wave is best, a larger cluster costs latency, and
// past one wave the fewest (largest) tiles win. So: one wave before several;
// in one wave, the layouts that reach half of the SMs before those that do
// not, then the smaller cluster, then more blocks (without half of the SMs:
// more blocks, then the smaller cluster); past one wave, fewer blocks, then
// the smaller cluster.
bool better(const Layout& a, const Layout& b, int sms) {
  if (b.g == 0) return true;
  if (a.one_wave != b.one_wave) return a.one_wave;
  if (!a.one_wave)
    return a.blocks != b.blocks ? a.blocks < b.blocks : a.cl < b.cl;
  const bool ra = 2 * a.blocks >= sms, rb = 2 * b.blocks >= sms;
  if (ra != rb) return ra;
  if (ra) return a.cl != b.cl ? a.cl < b.cl : a.blocks > b.blocks;
  return a.blocks != b.blocks ? a.blocks > b.blocks : a.cl < b.cl;
}

// want: 0 = by the rule, kCluster or kStreaming = that mode or refusal.
// By the rule the cluster mode takes a call where a layout fits in one wave of
// at most one block per SM, or in several waves with clusters of at most
// kManyWavesCluster and rows of at least kManyWavesRow bytes (larger clusters
// and narrower rows lost to streaming there); the streaming mode takes the
// rest. Asked for by name, the cluster mode takes any layout that fits.
template <typename T, int V>
bool plan_for(int B, int C, long long hw_ll, int G, int want, Plan* pl) {
  constexpr int sz = (int)sizeof(T);
  const int hw = (int)hw_ll, cpg = C / G, bg = cpg * sz;
  const int sms = sm_count();
  if (sms < 1) return false;
  // In the vector variant a unit is whole 16-byte vectors.
  const int g16 = 16 / gcd(bg, 16);
  if (V > 1 && G % g16 != 0) return false;  // caller falls to V = 1
  const int gstep = V > 1 ? g16 : 1;
  const auto valid = [&](int g) {
    return g >= 1 && g <= kMaxGroupsPerUnit && G % g == 0 && g % gstep == 0 &&
           g * cpg / V <= kThreads && G / g <= 65535;
  };
  Geo& geo = pl->geo;
  const auto set_slice = [&](int g) {
    geo.C = C;
    geo.hw = hw;
    geo.G = G;
    geo.cpg = cpg;
    geo.gpu = g;
    geo.cs = g * cpg;
    geo.vpr = geo.cs / V;
    geo.rows = kThreads / geo.vpr;
    geo.nseg = kThreads / geo.cs > 1 ? kThreads / geo.cs : 1;
    geo.slices = G / g;
    geo.tile_bytes = 0;
  };
  pl->V = V;
  pl->B = B;

  // Cluster mode: rows under a sector only where the whole pixel is that
  // narrow; a cluster of more than one block only for tiles worth a block.
  Layout best;
  for (int g = 1; want != kStreaming && g <= kMaxGroupsPerUnit && g <= G; ++g) {
    if (!valid(g)) continue;
    const int row = g * bg;
    if (row < kSectorBytes && g != G) continue;
    for (int cl = 1; cl <= kMaxCluster; cl *= 2) {
      const long long tile =
          ((long long)((hw + cl - 1) / cl) * row + 15) / 16 * 16;
      if (tile > kTileMax) continue;
      if (cl > 1 && (tile < kMinSplitTile || hw < cl)) continue;
      const int cap = resident_clusters<T, V>(cl, (int)tile + extra_smem<V>());
      if (cap < 1) continue;
      Layout l;
      l.g = g;
      l.cl = cl;
      l.tile = (int)tile;
      const long long units = (long long)B * (G / g);
      l.blocks = units * cl;
      l.one_wave = units <= cap && l.blocks <= sms;
      if (!l.one_wave && want != kCluster &&
          (cl > kManyWavesCluster || (row < kManyWavesRow && g != G)))
        continue;
      if (better(l, best, sms)) best = l;
    }
  }
  if (best.g) {
    set_slice(best.g);
    pl->mode = kCluster;
    pl->cluster = best.cl;
    geo.tile_bytes = best.tile;
    pl->workspace = 0;
    return true;
  }
  if (want == kCluster) return false;
  // Streaming mode: no tile to fit, so rows of up to 512 bytes.
  int sg = 0;
  for (int g = 1; g <= kMaxGroupsPerUnit && g <= G; ++g)
    if (valid(g) && (sg == 0 || g * bg <= 512)) sg = g;
  if (!sg) return false;
  set_slice(sg);
  pl->mode = kStreaming;
  const long long units = (long long)B * geo.slices;
  long long nblk = (4LL * sms + units - 1) / units;
  const long long most = (hw + 4 * geo.rows - 1) / (4 * geo.rows);
  if (nblk > most) nblk = most;
  if (nblk > kMaxStatBlocks) nblk = kMaxStatBlocks;
  if (nblk < 1) nblk = 1;
  pl->nblk = (int)nblk;
  pl->workspace = (long long)B * G * nblk * (long long)sizeof(float2);
  return true;
}

template <typename T>
bool plan_dtype(int B, int C, long long hw, int G, bool aligned, int want,
                Plan* pl) {
  constexpr int V = 16 / (int)sizeof(T);
  if (aligned && ((long long)C * (long long)sizeof(T)) % 16 == 0 &&
      plan_for<T, V>(B, C, hw, G, want, pl))
    return true;
  *pl = Plan{};
  return plan_for<T, 1>(B, C, hw, G, want, pl);
}

bool make_plan(int B, int C, long long hw, int G, int dtype, bool aligned,
               int want, Plan* pl) {
  if (B < 1 || B > 65535 || C < 1 || G < 1 || hw < 1 || C % G != 0 ||
      hw > (1LL << 30) || want < 0 || want > kStreaming)
    return false;
  if (dtype == 0) return plan_dtype<float>(B, C, hw, G, aligned, want, pl);
  if (dtype == 1)
    return plan_dtype<__nv_bfloat16>(B, C, hw, G, aligned, want, pl);
  return false;
}

template <typename T, int V>
cudaError_t launch(const Plan& pl, const void* x, const void* w, const void* b,
                   void* out, void* workspace, float eps, int silu,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  const Geo& geo = pl.geo;
  if (pl.mode == kCluster) {
    allow_large_launches<T, V>();
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    const int smem = geo.tile_bytes + extra_smem<V>();
    cluster_config(&cfg, attr, pl.cluster, geo.slices, pl.B, smem, s);
    return two_per_sm(smem)
               ? cudaLaunchKernelEx(&cfg, gn_nhwc_cluster<T, V, 2>, xt, wt, bt,
                                    ot, geo, eps, silu)
               : cudaLaunchKernelEx(&cfg, gn_nhwc_cluster<T, V, 1>, xt, wt, bt,
                                    ot, geo, eps, silu);
  }
  float2* part = static_cast<float2*>(workspace);
  gn_nhwc_stats<T, V><<<dim3(pl.nblk, geo.slices, pl.B), kThreads,
                        extra_smem<V>(), s>>>(xt, part, geo, pl.nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int chunk_px = geo.rows * kApplyRowsPerThread;
  const int chunks = (geo.hw + chunk_px - 1) / chunk_px;
  gn_nhwc_apply<T, V><<<dim3(chunks, geo.slices, pl.B), kThreads, 0, s>>>(
      xt, wt, bt, part, ot, geo, pl.nblk, chunk_px, eps, silu);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan for a channels-last (B, C, hw) input of `dtype` (0 = float32, 1 =
// bfloat16) in G groups on the current device; `aligned`: every pointer is
// 16-byte aligned; `mode`: 0 = chosen by the rule (plan_for), 1 = the cluster
// mode, 2 = the streaming mode (to time one against the other and to test
// each at any shape it takes). Returns the workspace bytes the launch needs
// (0 in cluster mode), -1 if refused, -2 if the device cannot be queried.
// info[0..5] = mode (1 cluster, 2 streaming), elements per vector, blocks per
// cluster, groups per unit, clusters in the grid (cluster mode) or stats
// blocks per unit (streaming mode), bytes of the shared-memory tile.
long long sdvg_groupnorm_silu_nhwc_plan(int B, int C, long long hw, int G,
                                        int dtype, int aligned, int mode,
                                        int* info) {
  if (sm_count() < 1) return -2;
  Plan pl;
  if (!make_plan(B, C, hw, G, dtype, aligned != 0, mode, &pl)) return -1;
  if (info) {
    info[0] = pl.mode;
    info[1] = pl.V;
    info[2] = pl.cluster;
    info[3] = pl.geo.gpu;
    info[4] = pl.mode == kCluster ? pl.B * pl.geo.slices : pl.nblk;
    info[5] = pl.geo.tile_bytes;
  }
  return pl.workspace;
}

// x, out: (B, C, hw) in channels-last memory (B, hw, C), dense; w, b: (C,) of
// x's type; workspace: at least the plan's bytes, 8-byte aligned (may be
// null when that is 0); mode as for the plan. Returns the cudaError_t of the
// launches.
int sdvg_groupnorm_silu_nhwc(const void* x, const void* w, const void* b,
                             void* out, void* workspace,
                             long long workspace_bytes, int B, int C,
                             long long hw, int G, float eps, int silu,
                             int dtype, int mode, void* stream) {
  const auto at16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool aligned = at16(x) && at16(out) && at16(w) && at16(b);
  if (sm_count() < 1) return (int)cudaErrorInvalidDevice;
  Plan pl;
  if (!make_plan(B, C, hw, G, dtype, aligned, mode, &pl) ||
      workspace_bytes < pl.workspace || (pl.workspace > 0 && !workspace))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(pl.V > 1
                     ? launch<float, 4>(pl, x, w, b, out, workspace, eps, silu, s)
                     : launch<float, 1>(pl, x, w, b, out, workspace, eps, silu, s));
  return (int)(pl.V > 1 ? launch<__nv_bfloat16, 8>(pl, x, w, b, out, workspace,
                                                   eps, silu, s)
                        : launch<__nv_bfloat16, 1>(pl, x, w, b, out, workspace,
                                                   eps, silu, s));
}

}  // extern "C"
