// Adam's update as one pass over every parameter of a (dtype, mu_dtype)
// group: sdvg_adam_multi_tensor_apply_kernel.
//
// It replaces no TPU kernel: the JAX package leaves Adam to optax under
// XLA, which fuses the update into one loop. The port's plain version
// (train/optim.py, Adam._foreach_update) runs ten torch._foreach_* passes,
// which read 14 tensors and write 10 of every parameter; this kernel reads
// p, g, mu and nu once and writes p, mu and nu once. The update is bound
// by the card's memory bandwidth, and what it saves is bytes: 14 a bf16
// parameter in place of 48-50, and the plain version's two temporaries
// (update, denom). Its few dozen instructions an element are not free
// either: three IEEE divisions and a square root each take a multi-
// function-unit operation and its corrections.
//
// Design:
//   - one read and one write of each element, 16 bytes a thread (8 bf16 or
//     4 f32 of p, g and nu; mu as wide as its own dtype makes 8 or 4),
//     neighbouring threads on neighbouring addresses, as streaming accesses
//     (evict-first); the arithmetic in f32 registers. A tensor's ragged
//     tail (numel not a multiple of the vector width) takes a scalar path.
//   - every tensor of the group in one launch: the table of (p, g, mu, nu,
//     numel, first unit) is passed by value in the kernel's parameters
//     (__grid_constant__, so nothing is copied per thread), up to
//     kMaxTensors tensors, within Hopper's 32 KB of parameter space; the
//     caller splits a longer list into several launches.
//   - a persistent grid (as many blocks as the SMs hold at once, fewer for
//     a small group) walks the concatenated index space of 16-byte units
//     with a grid stride, so every SM stays busy to the end whatever the
//     mix of tensor sizes. A thread finds its first tensor by a binary
//     search over the table's prefix sums and then only moves forward.
//   - nothing goes through a device buffer and nothing synchronises: the
//     launch sits on the caller's stream and is captured into a CUDA graph
//     like any other. The bias corrections 1 - b1^t and 1 - b2^t are read
//     through pointers to the 0-d device tensors the host fills before each
//     step, so a graph's replay takes each step's values.
//
// Same work, same numbers: the element arithmetic is the plain version's,
// rounded to the stored dtype wherever one of its passes stores, with the
// scalars rounded as train/optim.py rounds them, IEEE division and square
// root (built without --use_fast_math), and the alpha-adds and addcmul contracted as PyTorch's foreach
// kernels contract them (see alpha_add). The result is bit-equal to the
// plain version on the card.
//
// The kernel's name carries "multi_tensor_apply_kernel", the name PyTorch's
// foreach kernels share, so the benchmark's optimizer bucket and
// optimizer_ms.train go on reading the optimizer's device time.
//
// Built by sd_video_gen_tpu_torch/ops/_kernels.py with the other sources;
// called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTensors = 600;   // 48 B each: 28.8 KB of the 32 KB

struct AdamTensor {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  long long numel;
  long long start;   // the tensor's first unit in the launch's index space
};

struct AdamTable {
  int n;
  long long units;   // units of all n tensors
  // b1 in mu's dtype; the others in the parameters' dtype
  float b1_mu, a1, b2, a2, eps, neg_lr;
  const void* bc1;   // 0-d tensors of the parameters' dtype
  const void* bc2;
  AdamTensor t[kMaxTensors];
};

template <typename X, int N>
struct alignas(sizeof(X) * N) Pack {
  X v[N];
};

template <typename X>
__device__ __forceinline__ float to_f(X x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename X>
__device__ __forceinline__ X from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to X, as a pass that stores into a tensor of X rounds it
template <typename X>
__device__ __forceinline__ float rnd(float x) { return to_f<X>(from_f<X>(x)); }

// a + alpha * b as PyTorch's foreach add with alpha computes it
// (BinaryOpListAlphaFunctor: nvcc contracts a + alpha * b into one fused
// multiply-add), and a + value * (b * c) as its addcmul does
// (pointwise_op_impl: std::fma(value, b * c, a)). Contracting neither, or
// only one, leaves the f32 groups' p, mu or nu on the card.
__device__ __forceinline__ float alpha_add(float a, float alpha, float b) {
  return __fmaf_rn(alpha, b, a);
}

__device__ __forceinline__ float add_cmul(float a, float value, float b,
                                          float c) {
  return __fmaf_rn(value, __fmul_rn(b, c), a);
}

// 16 (or 8) bytes of a tensor read or written once: streaming accesses
// (evict-first), so the step's other tensors keep the cache
template <typename X, int N>
__device__ __forceinline__ Pack<X, N> load(const X* ptr) {
  static_assert(sizeof(Pack<X, N>) == 16 || sizeof(Pack<X, N>) == 8, "");
  Pack<X, N> out;
  if constexpr (sizeof(Pack<X, N>) == 16) {
    *reinterpret_cast<uint4*>(&out) =
        __ldcs(reinterpret_cast<const uint4*>(ptr));
  } else {
    *reinterpret_cast<uint2*>(&out) =
        __ldcs(reinterpret_cast<const uint2*>(ptr));
  }
  return out;
}

template <typename X, int N>
__device__ __forceinline__ void store(X* ptr, const Pack<X, N>& v) {
  if constexpr (sizeof(Pack<X, N>) == 16) {
    __stcs(reinterpret_cast<uint4*>(ptr),
           *reinterpret_cast<const uint4*>(&v));
  } else {
    __stcs(reinterpret_cast<uint2*>(ptr),
           *reinterpret_cast<const uint2*>(&v));
  }
}

// One element through the plain version's ten passes (train/optim.py), in
// its order. p, g, nu hold values of T; mu a value of M. On return p and nu
// hold their new values of T, mu the new first moment as T computed it (the
// caller rounds it to M where it stores it, as the plain version's copy
// back does).

template <typename T, typename M>
__device__ __forceinline__ void adam_element(float& p, float g, float& mu,
                                             float& nu, const AdamTable& a,
                                             float bc1, float bc2) {
  float m = rnd<M>(__fmul_rn(mu, a.b1_mu));         // mul_ mu_state, b1
  m = rnd<T>(alpha_add(rnd<T>(m), a.a1, g));         // .to(T); add_ g
  float v = rnd<T>(__fmul_rn(nu, a.b2));             // mul_ nu, b2
  v = rnd<T>(add_cmul(v, a.a2, g, g));               // addcmul_ g, g
  float up = rnd<T>(__fdiv_rn(m, bc1));              // div mu, bc1
  float den = rnd<T>(__fdiv_rn(v, bc2));             // div nu, bc2
  den = rnd<T>(__fsqrt_rn(den));                     // sqrt_
  den = rnd<T>(__fadd_rn(den, a.eps));               // add_ eps
  up = rnd<T>(__fdiv_rn(up, den));                   // div_ update, denom
  p = rnd<T>(alpha_add(p, a.neg_lr, up));            // add_ p, -lr update
  mu = m;
  nu = v;
}

template <typename T, typename M>
__global__ void __launch_bounds__(kThreads)
    sdvg_adam_multi_tensor_apply_kernel(const __grid_constant__ AdamTable a) {
  constexpr int V = 16 / sizeof(T);   // elements a unit
  const float bc1 = to_f<T>(*static_cast<const T*>(a.bc1));
  const float bc2 = to_f<T>(*static_cast<const T*>(a.bc2));
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= a.units) return;
  // the last tensor whose first unit is at or before u
  int i = 0;
  for (int hi = a.n - 1; i < hi;) {
    const int mid = (i + hi + 1) / 2;
    if (a.t[mid].start <= u) i = mid; else hi = mid - 1;
  }
  for (; u < a.units; u += stride) {
    while (i + 1 < a.n && a.t[i + 1].start <= u) ++i;
    const AdamTensor& t = a.t[i];
    const long long e = (u - t.start) * V;
    T* p = static_cast<T*>(t.p) + e;
    const T* g = static_cast<const T*>(t.g) + e;
    M* mu = static_cast<M*>(t.mu) + e;
    T* nu = static_cast<T*>(t.nu) + e;
    const long long left = t.numel - e;
    if (left >= V) {
      Pack<T, V> pv = load<T, V>(p);
      const Pack<T, V> gv = load<T, V>(g);
      Pack<M, V> mv = load<M, V>(mu);
      Pack<T, V> nv = load<T, V>(nu);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float pf = to_f<T>(pv.v[k]), mf = to_f<M>(mv.v[k]);
        float nf = to_f<T>(nv.v[k]);
        adam_element<T, M>(pf, to_f<T>(gv.v[k]), mf, nf, a, bc1, bc2);
        pv.v[k] = from_f<T>(pf);
        mv.v[k] = from_f<M>(mf);
        nv.v[k] = from_f<T>(nf);
      }
      store<T, V>(p, pv);
      store<M, V>(mu, mv);
      store<T, V>(nu, nv);
    } else {
      for (int k = 0; k < left; ++k) {
        float pf = to_f<T>(p[k]), mf = to_f<M>(mu[k]), nf = to_f<T>(nu[k]);
        adam_element<T, M>(pf, to_f<T>(g[k]), mf, nf, a, bc1, bc2);
        p[k] = from_f<T>(pf);
        mu[k] = from_f<M>(mf);
        nu[k] = from_f<T>(nf);
      }
    }
  }
}

// Blocks of one launch over `units`: as many as the device's SMs hold at
// once (asked once per device and instantiation), fewer where the units
// run out first.
template <typename T, typename M>
int grid_for(long long units) {
  static int resident[64];   // by device; 0 until asked
  int dev = 0;
  cudaGetDevice(&dev);
  int blocks = dev < 64 ? resident[dev] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sdvg_adam_multi_tensor_apply_kernel<T, M>, kThreads, 0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
    if (dev < 64) resident[dev] = blocks;
  }
  const long long need = (units + kThreads - 1) / kThreads;
  return need < blocks ? (int)need : blocks;
}

template <typename T, typename M>
int launch(const AdamTable& a, cudaStream_t s) {
  sdvg_adam_multi_tensor_apply_kernel<T, M>
      <<<grid_for<T, M>(a.units), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most tensors one launch takes (sdvg_adam's n).
int sdvg_adam_max_tensors() { return kMaxTensors; }

// One Adam update of n tensors, in place. `table` holds 6 numbers a tensor:
// the addresses of p, g, mu and nu (each 16-byte aligned, contiguous), its
// numel and its first unit (the prefix sum over the tensors before it of
// ceil(numel / (16 / sizeof(dtype)))); `units` is the sum over all n.
// dtype / mu_dtype: 0 float32, 1 bfloat16, as (0, 0), (1, 1) or (0, 1).
// b1_mu is b1 rounded to mu's dtype; a1 = 1 - b1, b2, a2 = 1 - b2, eps and
// neg_lr = -lr are rounded to the parameters' dtype. bc1, bc2: the
// addresses of 0-d tensors of the parameters' dtype holding 1 - b1^t and
// 1 - b2^t. Returns the cudaError_t of the launch (0 on success).
int sdvg_adam(const long long* table, int n, long long units, int dtype,
              int mu_dtype, float b1_mu, float a1, float b2, float a2,
              float eps, float neg_lr, const void* bc1, const void* bc2,
              void* stream) {
  if (n < 1 || n > kMaxTensors || units < 1 || !bc1 || !bc2)
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(AdamTable) <= 32764, "the kernel's parameter space");
  AdamTable a;
  a.n = n;
  a.units = units;
  a.b1_mu = b1_mu;
  a.a1 = a1;
  a.b2 = b2;
  a.a2 = a2;
  a.eps = eps;
  a.neg_lr = neg_lr;
  a.bc1 = bc1;
  a.bc2 = bc2;
  for (int i = 0; i < n; ++i) {
    const long long* r = table + 6 * i;
    a.t[i] = AdamTensor{reinterpret_cast<void*>(r[0]),
                        reinterpret_cast<const void*>(r[1]),
                        reinterpret_cast<void*>(r[2]),
                        reinterpret_cast<void*>(r[3]), r[4], r[5]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && mu_dtype == 0) return launch<float, float>(a, s);
  if (dtype == 1 && mu_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (dtype == 0 && mu_dtype == 1) return launch<float, __nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
