// RMSNorm forward and its dx for Hopper, plain and residual-fused.
//
// Replaces: paddle_tpu/ops/pallas/rms_norm.py::_fwd_kernel (K1, the Pallas
// row-block kernel behind rms_norm, launched from _rms_fwd_impl),
// ::_dx_kernel (K2, its backward for x, launched from _rms_bwd),
// ::_fwd_res_kernel (K3, behind rms_norm_residual, launched from
// _rms_res_fwd_impl) and ::_dres_kernel (K4, its backward, launched from
// _rms_res_bwd). dw stays a plain f32 column reduction in PyTorch, as the
// JAX package leaves it to XLA.
//
// K1 computes y = (x * rsqrt(mean(x^2) + eps)).to(T) * w with the
// statistics in f32. The cast to T before the weight product follows the
// plain version (rms_norm_reference), which is what the serving path
// computes off-TPU; the Pallas kernel instead multiplies by w in f32 and
// casts once. K3 is K1 on r = x + res, the add rounded to T (so r equals
// the unfused x + res bit for bit), r written beside y; it too rounds at
// the plain version's points (rms_norm_residual_reference), where the
// Pallas body (_fwd_res_kernel) rounds once.
//
// Bound on the H100: bytes. K1 reads each row twice (once for the sum of
// squares, once for the output) and writes it once; the second read hits
// L1/L2 because a row is at most a few KB, so device memory sees
// 2*N*D*sizeof(T) + D*sizeof(T) bytes, about 2 flops a byte. K3 reads x
// and res and writes r and y (4*N*D*sizeof(T)); its second pass re-reads
// r, which the same thread has just written, from L1/L2.
// Design: one block per row, 16-byte vectorised loads and stores when the
// row is 16-byte aligned, the sum of squares reduced in f32 with warp
// shuffles and one shared-memory step. No tensor cores: there is no
// product to feed them.
#include "common.cuh"

namespace {

// kRes: the row normalised is r = x + res, rounded to T and written to r;
// otherwise it is x (res and r unused).
template <typename T, bool kVec, bool kRes>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const T* __restrict__ res,
                                const T* __restrict__ w, T* __restrict__ y,
                                T* __restrict__ r, int d, float eps) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  T* rr = kRes ? r + row * d : nullptr;
  float ss = 0.f;
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      ptt::Vec<T> a = xv[i];
      if (kRes) {
        const ptt::Vec<T> b =
            reinterpret_cast<const ptt::Vec<T>*>(res + row * d)[i];
#pragma unroll
        for (int k = 0; k < V; ++k)
          a.v[k] = ptt::from_f<T>(ptt::to_f(a.v[k]) + ptt::to_f(b.v[k]));
        reinterpret_cast<ptt::Vec<T>*>(rr)[i] = a;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float f = ptt::to_f(a.v[k]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      T a = xr[i];
      if (kRes) {
        a = ptt::from_f<T>(ptt::to_f(a) + ptt::to_f(res[row * d + i]));
        rr[i] = a;
      }
      const float f = ptt::to_f(a);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(ptt::block_sum(ss, scratch) / d + eps);
  // the second pass reads back the row it normalised: with kRes, r as
  // this same thread wrote it above (same indices), so no barrier is needed
  const T* src = kRes ? static_cast<const T*>(rr) : xr;
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* sv = reinterpret_cast<const ptt::Vec<T>*>(src);
    const ptt::Vec<T>* wv = reinterpret_cast<const ptt::Vec<T>*>(w);
    ptt::Vec<T>* yv = reinterpret_cast<ptt::Vec<T>*>(yr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const ptt::Vec<T> a = sv[i];
      const ptt::Vec<T> b = wv[i];
      ptt::Vec<T> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float normed =
            ptt::to_f(ptt::from_f<T>(ptt::to_f(a.v[k]) * inv));
        o.v[k] = ptt::from_f<T>(normed * ptt::to_f(b.v[k]));
      }
      yv[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float normed = ptt::to_f(ptt::from_f<T>(ptt::to_f(src[i]) * inv));
      yr[i] = ptt::from_f<T>(normed * ptt::to_f(w[i]));
    }
  }
}

int row_threads(int d, int vec, int per_vec) {
  const int per_thread = vec ? per_vec : 1;
  int threads = (d / per_thread + 31) / 32 * 32;
  return threads < 32 ? 32 : (threads > 256 ? 256 : threads);
}

template <typename T, bool kRes>
cudaError_t launch(const void* x, const void* res, const void* w, void* y,
                   void* r, long long n, int d, float eps, int vec,
                   cudaStream_t stream) {
  const int threads = row_threads(d, vec, ptt::Vec<T>::N);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  T* op = static_cast<T*>(r);
  if (vec)
    rms_norm_kernel<T, true, kRes><<<(unsigned)n, threads, 0, stream>>>(
        xp, rp, wp, yp, op, d, eps);
  else
    rms_norm_kernel<T, false, kRes><<<(unsigned)n, threads, 0, stream>>>(
        xp, rp, wp, yp, op, d, eps);
  return cudaGetLastError();
}

// dx = inv * g*w - x * inv^3 * mean(g*w*x) [+ gr], inv = rsqrt(mean(x^2) +
// eps), all in f32, rounded once. With kRes (K4) x is r = x + res, saved
// by the forward, and gr (the gradient of the residual stream r) is added
// before the rounding: dh = rms_dx(gy; r) + gr, which is both dx and dres.
// Bound on the H100: bytes, like the forward: x and g (and gr) are read
// (x and g twice, the second time from L1/L2), dx written once: 3 (K4: 4)
// * N*D*sizeof(T) bytes from device memory. One block per row; both row
// sums are taken in one pass.
template <typename T, bool kVec, bool kRes>
__global__ void rms_norm_dx_kernel(const T* __restrict__ x,
                                   const T* __restrict__ w,
                                   const T* __restrict__ g,
                                   const T* __restrict__ gres,
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
  const T* rr = kRes ? gres + row * d : nullptr;
  if (kVec) {
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    const ptt::Vec<T>* gv = reinterpret_cast<const ptt::Vec<T>*>(gr);
    const ptt::Vec<T>* wv = reinterpret_cast<const ptt::Vec<T>*>(w);
    ptt::Vec<T>* dv = reinterpret_cast<ptt::Vec<T>*>(dr);
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      const ptt::Vec<T> a = xv[i], b = gv[i], c = wv[i];
      ptt::Vec<T> e;
      if (kRes) e = reinterpret_cast<const ptt::Vec<T>*>(rr)[i];
      ptt::Vec<T> o;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float gw = ptt::to_f(b.v[k]) * ptt::to_f(c.v[k]);
        float v = inv * gw - ptt::to_f(a.v[k]) * coef;
        if (kRes) v += ptt::to_f(e.v[k]);
        o.v[k] = ptt::from_f<T>(v);
      }
      dv[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float gw = ptt::to_f(gr[i]) * ptt::to_f(w[i]);
      float v = inv * gw - ptt::to_f(xr[i]) * coef;
      if (kRes) v += ptt::to_f(rr[i]);
      dr[i] = ptt::from_f<T>(v);
    }
  }
}

template <typename T, bool kRes>
cudaError_t launch_dx(const void* x, const void* w, const void* g,
                      const void* gres, void* dx, long long n, int d,
                      float eps, int vec, cudaStream_t stream) {
  const int threads = row_threads(d, vec, ptt::Vec<T>::N);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* gp = static_cast<const T*>(g);
  const T* ep = static_cast<const T*>(gres);
  T* dp = static_cast<T*>(dx);
  if (vec)
    rms_norm_dx_kernel<T, true, kRes><<<(unsigned)n, threads, 0, stream>>>(
        xp, wp, gp, ep, dp, d, eps);
  else
    rms_norm_dx_kernel<T, false, kRes><<<(unsigned)n, threads, 0, stream>>>(
        xp, wp, gp, ep, dp, d, eps);
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
    return launch<float, false>(x, nullptr, w, y, nullptr, n, d, eps, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16, false>(x, nullptr, w, y, nullptr, n, d, eps,
                                        vec, s);
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
    return launch_dx<float, false>(x, w, g, nullptr, dx, n, d, eps, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch_dx<__nv_bfloat16, false>(x, w, g, nullptr, dx, n, d, eps,
                                           vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3. x, res, y, r: [n, d] row-major; w: [d]. Writes r = x + res and
// y = rmsnorm(r) * w. Returns cudaGetLastError().
extern "C" int rms_norm_residual_fwd(const void* x, const void* res,
                                     const void* w, void* y, void* r,
                                     long long n, int d, float eps, int dtype,
                                     int vec, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch<float, true>(x, res, w, y, r, n, d, eps, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch<__nv_bfloat16, true>(x, res, w, y, r, n, d, eps, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4. r, gy, gr, dh: [n, d] row-major; w: [d]. dh = rms_dx(gy; r) + gr.
// Returns cudaGetLastError().
extern "C" int rms_norm_residual_dh(const void* r, const void* w,
                                    const void* gy, const void* gr, void* dh,
                                    long long n, int d, float eps, int dtype,
                                    int vec, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_dx<float, true>(r, w, gy, gr, dh, n, d, eps, vec, s);
  if (dtype == ptt::kBFloat16)
    return launch_dx<__nv_bfloat16, true>(r, w, gy, gr, dh, n, d, eps, vec,
                                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}
