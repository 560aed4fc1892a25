// SwiGLU forward and backward for Hopper: out = silu(gate) * up,
// elementwise, and its fused dgate/dup.
//
// Replaces: paddle_tpu/ops/pallas/swiglu.py::_fwd_kernel (the 2-D tiled
// Pallas kernel behind swiglu_fused, launched from _swiglu_fwd_impl) and
// ::_bwd_kernel (launched from _swiglu_bwd).
//
// Like the Pallas kernel it computes in f32 and rounds once on the write;
// the plain version (swiglu_reference) computes silu in the input dtype
// and rounds twice, so in bf16 the two differ by up to a few ulps.
//
// Bound on the H100: bytes. Two reads and one write of N*I elements and
// about 5 flops an element: well below the card's flops-per-byte line.
// Design: a grid-stride loop over 16-byte vectors (8 bf16 values a
// thread a step), one pass, the silu intermediate never leaves registers.
#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T silu_mul(T g, T u) {
  const float gf = ptt::to_f(g);
  return ptt::from_f<T>(gf / (1.f + expf(-gf)) * ptt::to_f(u));
}

template <typename T, bool kVec>
__global__ void swiglu_kernel(const T* __restrict__ g,
                              const T* __restrict__ u, T* __restrict__ o,
                              long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* gv = reinterpret_cast<const ptt::Vec<T>*>(g);
    const ptt::Vec<T>* uv = reinterpret_cast<const ptt::Vec<T>*>(u);
    ptt::Vec<T>* ov = reinterpret_cast<ptt::Vec<T>*>(o);
    for (; i < n / V; i += stride) {
      const ptt::Vec<T> a = gv[i];
      const ptt::Vec<T> b = uv[i];
      ptt::Vec<T> r;
#pragma unroll
      for (int k = 0; k < V; ++k) r.v[k] = silu_mul(a.v[k], b.v[k]);
      ov[i] = r;
    }
  } else {
    for (; i < n; i += stride) o[i] = silu_mul(g[i], u[i]);
  }
}

template <typename T>
cudaError_t launch(const void* g, const void* u, void* o, long long n,
                   int vec, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long items = vec ? n / ptt::Vec<T>::N : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then loop
  const T* gp = static_cast<const T*>(g);
  const T* up = static_cast<const T*>(u);
  T* op = static_cast<T*>(o);
  if (vec)
    swiglu_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(gp, up,
                                                                      op, n);
  else
    swiglu_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(gp, up,
                                                                       op, n);
  return cudaGetLastError();
}

// Backward from the raw inputs, sigmoid recomputed (no silu saved):
// dgate = go * u * sig * (1 + g * (1 - sig)), dup = go * g * sig, in f32
// and each rounded once. Bound on the H100: bytes, three reads and two
// writes of N*I elements (5*N*I*sizeof(T)); same grid-stride design.
template <typename T>
__device__ __forceinline__ void swiglu_grad(T g, T u, T go, T& dg, T& du) {
  const float gf = ptt::to_f(g), uf = ptt::to_f(u), of = ptt::to_f(go);
  const float sig = 1.f / (1.f + expf(-gf));
  dg = ptt::from_f<T>(of * uf * sig * (1.f + gf * (1.f - sig)));
  du = ptt::from_f<T>(of * (gf * sig));
}

template <typename T, bool kVec>
__global__ void swiglu_bwd_kernel(const T* __restrict__ g,
                                  const T* __restrict__ u,
                                  const T* __restrict__ go,
                                  T* __restrict__ dg, T* __restrict__ du,
                                  long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* gv = reinterpret_cast<const ptt::Vec<T>*>(g);
    const ptt::Vec<T>* uv = reinterpret_cast<const ptt::Vec<T>*>(u);
    const ptt::Vec<T>* ov = reinterpret_cast<const ptt::Vec<T>*>(go);
    ptt::Vec<T>* dgv = reinterpret_cast<ptt::Vec<T>*>(dg);
    ptt::Vec<T>* duv = reinterpret_cast<ptt::Vec<T>*>(du);
    for (; i < n / V; i += stride) {
      const ptt::Vec<T> a = gv[i], b = uv[i], c = ov[i];
      ptt::Vec<T> ra, rb;
#pragma unroll
      for (int k = 0; k < V; ++k)
        swiglu_grad(a.v[k], b.v[k], c.v[k], ra.v[k], rb.v[k]);
      dgv[i] = ra;
      duv[i] = rb;
    }
  } else {
    for (; i < n; i += stride) swiglu_grad(g[i], u[i], go[i], dg[i], du[i]);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* u, const void* go,
                       void* dg, void* du, long long n, int vec,
                       cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long items = vec ? n / ptt::Vec<T>::N : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const T* gp = static_cast<const T*>(g);
  const T* up = static_cast<const T*>(u);
  const T* op = static_cast<const T*>(go);
  T* dgp = static_cast<T*>(dg);
  T* dup = static_cast<T*>(du);
  if (vec)
    swiglu_bwd_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, up, op, dgp, dup, n);
  else
    swiglu_bwd_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        gp, up, op, dgp, dup, n);
  return cudaGetLastError();
}

}  // namespace

// gate, up, out: n contiguous elements. vec != 0 asks for 16-byte accesses
// (the caller checked alignment and that n is a multiple of the vector).
extern "C" int swiglu_fwd(const void* g, const void* u, void* o, long long n,
                          int dtype, int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return launch<float>(g, u, o, n, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(g, u, o, n, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gate, up, grad_out, dgate, dup: n contiguous elements each. vec != 0
// asks for 16-byte accesses (the caller checked alignment and n).
extern "C" int swiglu_bwd(const void* g, const void* u, const void* go,
                          void* dg, void* du, long long n, int dtype,
                          int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_bwd<float>(g, u, go, dg, du, n, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch_bwd<__nv_bfloat16>(g, u, go, dg, du, n, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
