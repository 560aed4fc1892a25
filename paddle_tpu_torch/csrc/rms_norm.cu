// RMSNorm forward and its dx for Hopper.
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py::_fwd_kernel (the Pallas
// row-block kernel behind rms_norm, launched from _rms_fwd_impl) and
// ::_dx_kernel (its backward for x, launched from _rms_bwd). dw stays a
// plain f32 column reduction in PyTorch, as the JAX package leaves it to
// XLA.
//
// Computes y = (x * rsqrt(mean(x^2) + eps)).to(T) * w with the statistics
// in f32. The cast to T before the weight product follows the plain
// version (rms_norm_reference), which is what the serving path computes
// off-TPU; the Pallas kernel instead multiplies by w in f32 and casts once.
//
// Bound on the H100: bytes. Each row is read twice (once for the sum of
// squares, once for the output) and written once; the second read hits
// L1/L2 because a row is at most a few KB, so device memory sees
// 2*N*D*sizeof(T) + D*sizeof(T) bytes, about 2 flops a byte.
// Design: one block per row, 16-byte vectorised loads and stores when the
// row is 16-byte aligned, the sum of squares reduced in f32 with warp
// shuffles and one shared-memory step. No tensor cores: there is no
// product to feed them.
#include "common.cuh"

namespace {

template <typename T, bool kVec>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ w, T* __restrict__ y,
                                int d, float eps) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float ss = 0.f;
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const ptt::Vec<T> a = xv[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = ptt::to_f(a.v[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = ptt::to_f(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(ptt::block_sum(ss, scratch) / d + eps);
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    const ptt::Vec<T>* wv = reinterpret_cast<const ptt::Vec<T>*>(w);
    ptt::Vec<T>* yv = reinterpret_cast<ptt::Vec<T>*>(yr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const ptt::Vec<T> a = xv[i];
      const ptt::Vec<T> b = wv[i];
      ptt::Vec<T> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float normed = ptt::to_f(ptt::from_f<T>(ptt::to_f(a.v[k]) * inv));
        o.v[k] = ptt::from_f<T>(normed * ptt::to_f(b.v[k]));
      }
      yv[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float normed = ptt::to_f(ptt::from_f<T>(ptt::to_f(xr[i]) * inv));
      yr[i] = ptt::from_f<T>(normed * ptt::to_f(w[i]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, long long n, int d,
                   float eps, int vec, cudaStream_t stream) {
  const int per_thread = vec ? ptt::Vec<T>::N : 1;
  int threads = (d / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  if (vec)
    rms_norm_kernel<T, true><<<(unsigned)n, threads, 0, stream>>>(xp, wp, yp,
                                                                  d, eps);
  else
    rms_norm_kernel<T, false><<<(unsigned)n, threads, 0, stream>>>(xp, wp, yp,
                                                                   d, eps);
  return cudaGetLastError();
}

// dx = inv * g*w - x * inv^3 * mean(g*w*x), inv = rsqrt(mean(x^2) + eps),
// all in f32, rounded once. Bound on the H100: bytes, like the forward:
// x and g are read (twice, the second time from L1/L2), dx written once,
// 3*N*D*sizeof(T) bytes from device memory. One block per row; both row
// sums are taken in one pass.
template <typename T, bool kVec>
__global__ void rms_norm_dx_kernel(const T* __restrict__ x,
                                   const T* __restrict__ w,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx, int d, float eps) {
  __shared__ float scratch_ss[32];
  __shared__ float scratch_dot[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  const T* gr = g + row * d;
  T* dr = dx + row * d;
  constexpr int V = ptt::Vec<T>::N;
  float ss = 0.f, dot = 0.f;
  if (kVec) {
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    const ptt::Vec<T>* gv = reinterpret_cast<const ptt::Vec<T>*>(gr);
    const ptt::Vec<T>* wv = reinterpret_cast<const ptt::Vec<T>*>(w);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const ptt::Vec<T> a = xv[i], b = gv[i], c = wv[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = ptt::to_f(a.v[k]);
        ss += f * f;
        dot += ptt::to_f(b.v[k]) * ptt::to_f(c.v[k]) * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = ptt::to_f(xr[i]);
      ss += f * f;
      dot += ptt::to_f(gr[i]) * ptt::to_f(w[i]) * f;
    }
  }
  // two scratch arrays: one block_sum's final read must not race the
  // other's first write
  const float inv = rsqrtf(ptt::block_sum(ss, scratch_ss) / d + eps);
  const float coef = inv * inv * inv * (ptt::block_sum(dot, scratch_dot) / d);
  if (kVec) {
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    const ptt::Vec<T>* gv = reinterpret_cast<const ptt::Vec<T>*>(gr);
    const ptt::Vec<T>* wv = reinterpret_cast<const ptt::Vec<T>*>(w);
    ptt::Vec<T>* dv = reinterpret_cast<ptt::Vec<T>*>(dr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const ptt::Vec<T> a = xv[i], b = gv[i], c = wv[i];
      ptt::Vec<T> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float gw = ptt::to_f(b.v[k]) * ptt::to_f(c.v[k]);
        o.v[k] = ptt::from_f<T>(inv * gw - ptt::to_f(a.v[k]) * coef);
      }
      dv[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float gw = ptt::to_f(gr[i]) * ptt::to_f(w[i]);
      dr[i] = ptt::from_f<T>(inv * gw - ptt::to_f(xr[i]) * coef);
    }
  }
}

template <typename T>
cudaError_t launch_dx(const void* x, const void* w, const void* g, void* dx,
                      long long n, int d, float eps, int vec,
                      cudaStream_t stream) {
  const int per_thread = vec ? ptt::Vec<T>::N : 1;
  int threads = (d / per_thread + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  T* dp = static_cast<T*>(dx);
  if (vec)
    rms_norm_dx_kernel<T, true><<<(unsigned)n, threads, 0, stream>>>(
        xp, wp, gp, dp, d, eps);
  else
    rms_norm_dx_kernel<T, false><<<(unsigned)n, threads, 0, stream>>>(
        xp, wp, gp, dp, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n, d] row-major; w: [d]. vec != 0 asks for 16-byte accesses (the
// caller checked alignment and d). Returns cudaGetLastError().
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, long long n,
                            int d, float eps, int dtype, int vec,
                            void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float>(x, w, y, n, d, eps, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16>(x, w, y, n, d, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, g, dx: [n, d] row-major; w: [d]. vec != 0 asks for 16-byte accesses
// (the caller checked alignment and d). Returns cudaGetLastError().
extern "C" int rms_norm_bwd_dx(const void* x, const void* w, const void* g,
                               void* dx, long long n, int d, float eps,
                               int dtype, int vec, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_dx<float>(x, w, g, dx, n, d, eps, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch_dx<__nv_bfloat16>(x, w, g, dx, n, d, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
