// The fused linear+cross-entropy's per-chunk kernels for Hopper: the
// softmax statistics of a [N, vc] logits block (K10) and its dlogits
// (K11).
//
// Replaces: paddle_tpu/ops/pallas/ce_chunk.py::_stats_kernel (K10,
// launched from chunk_stats) and ::_dlogits_kernel (K11, launched from
// chunk_dlogits). ops/fused_ce.py (here paddle_tpu_torch/ops/fused_ce.py)
// scans the vocab in chunks of vc columns; the matmul that makes each
// block is cuBLAS's, and these kernels do the elementwise work on it in
// one pass each. The last chunk's start is clamped back into the vocab,
// so its first `lo` columns overlap the previous chunk: both kernels mask
// the columns below lo (lo is 0 for every other chunk).
//
// K10: per row, over the columns >= lo, the max m, s = sum(exp(x - m)) and
// the target logit t = x[local] (0 when local is outside [lo, vc): the
// label lies in another chunk). m, s, t are f32. A row with no column
// left (lo >= vc) gives m = -inf, s = 0, as the Pallas body's finite-max
// guard does. The block is read in its own dtype and widened in
// registers, as the Pallas body widens it (l.49); the f32 copy the JAX op
// makes first (fused_ce.py:162) is an exact widening, so skipping it
// changes no number and halves the bytes read.
// K11: (exp(x - lse) - [col == local]) * scale per element, 0 for the
// columns below lo, in f32 and rounded once to T (h's dtype).
//
// Bound on the H100: bytes. K10 reads the block once (N*vc*sizeof(T)) and
// writes 12 bytes a row; K11 reads it and writes it once. About 3-6 flops
// an element, far below the card's flops-per-byte line.
// Design: one warp per row (vc = 1024 bf16 columns are 4 16-byte vectors
// a lane), 8 rows a block. K10 keeps an online max and sum in each lane in
// one pass (a larger element rescales the lane's sum) and merges the lanes
// with xor shuffles, so every lane ends with the same (m, s, t); the
// target is found by comparing the column index with the row's local
// label, never through a one-hot. No shared memory, no atomics.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// (m, s) of a lane after one more element x: an online softmax sum
__device__ __forceinline__ void online_add(float x, float& m, float& s) {
  if (x > m) {
    s = s * expf(m - x) + 1.f;  // m = -inf at first: s is 0 and stays 0
    m = x;
  } else if (m != -INFINITY) {
    s += expf(x - m);  // x = m = -inf would be exp(nan): contributes 0
  }
}

template <typename T, bool kVec>
__global__ void ce_stats_kernel(const T* __restrict__ logits,
                                const int* __restrict__ local,
                                float* __restrict__ m_out,
                                float* __restrict__ s_out,
                                float* __restrict__ t_out, int n, int vc,
                                int lo) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = logits + row * vc;
  const int tgt = local[row];
  float m = -INFINITY, s = 0.f, t = 0.f;
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    for (int i = lane; i < vc / V; i += 32) {
      const ptt::Vec<T> a = xv[i];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int col = i * V + k;
        if (col < lo) continue;
        const float x = ptt::to_f(a.v[k]);
        if (col == tgt) t = x;
        online_add(x, m, s);
      }
    }
  } else {
    for (int col = lo + lane; col < vc; col += 32) {
      const float x = ptt::to_f(xr[col]);
      if (col == tgt) t = x;
      online_add(x, m, s);
    }
  }
  // merge the lanes; the combination is symmetric, so all lanes agree
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
    const float s_o = __shfl_xor_sync(0xffffffffu, s, o);
    const float m_new = fmaxf(m, m_o);
    const float a = m == -INFINITY ? 0.f : s * expf(m - m_new);
    const float b = m_o == -INFINITY ? 0.f : s_o * expf(m_o - m_new);
    s = a + b;
    m = m_new;
  }
  t = ptt::warp_sum(t);  // one lane at most holds the target
  if (lane == 0) {
    m_out[row] = m;
    s_out[row] = s;
    t_out[row] = t;
  }
}

template <typename T>
__device__ __forceinline__ T dlogit(float x, int col, int tgt, int lo,
                                    float lse, float scale) {
  if (col < lo) return ptt::from_f<T>(0.f);
  const float p = expf(x - lse);
  return ptt::from_f<T>((p - (col == tgt ? 1.f : 0.f)) * scale);
}

template <typename T, bool kVec>
__global__ void ce_dlogits_kernel(const T* __restrict__ logits,
                                  const float* __restrict__ lse,
                                  const int* __restrict__ local,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, int n, int vc,
                                  int lo) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = logits + row * vc;
  T* orow = out + row * vc;
  const int tgt = local[row];
  const float l = lse[row], sc = scale[row];
  if (kVec) {
    constexpr int V = ptt::Vec<T>::N;
    const ptt::Vec<T>* xv = reinterpret_cast<const ptt::Vec<T>*>(xr);
    ptt::Vec<T>* ov = reinterpret_cast<ptt::Vec<T>*>(orow);
    for (int i = lane; i < vc / V; i += 32) {
      const ptt::Vec<T> a = xv[i];
      ptt::Vec<T> o;
#pragma unroll
      for (int k = 0; k < V; ++k)
        o.v[k] = dlogit<T>(ptt::to_f(a.v[k]), i * V + k, tgt, lo, l, sc);
      ov[i] = o;
    }
  } else {
    for (int col = lane; col < vc; col += 32)
      orow[col] = dlogit<T>(ptt::to_f(xr[col]), col, tgt, lo, l, sc);
  }
}

unsigned blocks_for(int n) {
  return (unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock);
}

template <typename T>
cudaError_t launch_stats(const void* logits, const void* local, void* m,
                         void* s, void* t, int n, int vc, int lo, int vec,
                         cudaStream_t stream) {
  const T* xp = static_cast<const T*>(logits);
  const int* lp = static_cast<const int*>(local);
  float* mp = static_cast<float*>(m);
  float* sp = static_cast<float*>(s);
  float* tp = static_cast<float*>(t);
  if (vec)
    ce_stats_kernel<T, true><<<blocks_for(n), 32 * kRowsPerBlock, 0,
                               stream>>>(xp, lp, mp, sp, tp, n, vc, lo);
  else
    ce_stats_kernel<T, false><<<blocks_for(n), 32 * kRowsPerBlock, 0,
                                stream>>>(xp, lp, mp, sp, tp, n, vc, lo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dlogits(const void* logits, const void* lse,
                           const void* local, const void* scale, void* out,
                           int n, int vc, int lo, int vec,
                           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(logits);
  const float* ep = static_cast<const float*>(lse);
  const int* lp = static_cast<const int*>(local);
  const float* cp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (vec)
    ce_dlogits_kernel<T, true><<<blocks_for(n), 32 * kRowsPerBlock, 0,
                                 stream>>>(xp, ep, lp, cp, op, n, vc, lo);
  else
    ce_dlogits_kernel<T, false><<<blocks_for(n), 32 * kRowsPerBlock, 0,
                                  stream>>>(xp, ep, lp, cp, op, n, vc, lo);
  return cudaGetLastError();
}

}  // namespace

// K10. logits: [n, vc] row-major in `dtype`; local: int32 [n]; m, s, t:
// f32 [n]. vec != 0 asks for 16-byte accesses (the caller checked the
// alignment and vc). Returns cudaGetLastError().
extern "C" int ce_chunk_stats(const void* logits, const void* local, void* m,
                              void* s, void* t, int n, int vc, int lo,
                              int dtype, int vec, void* stream) {
  if (n <= 0 || vc <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_stats<float>(logits, local, m, s, t, n, vc, lo, vec, st);
  if (dtype == ptt::kBFloat16)
    return launch_stats<__nv_bfloat16>(logits, local, m, s, t, n, vc, lo,
                                       vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11. logits, out: [n, vc] row-major in `dtype`; lse, scale: f32 [n];
// local: int32 [n]. Returns cudaGetLastError().
extern "C" int ce_chunk_dlogits(const void* logits, const void* lse,
                                const void* local, const void* scale,
                                void* out, int n, int vc, int lo, int dtype,
                                int vec, void* stream) {
  if (n <= 0 || vc <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_dlogits<float>(logits, lse, local, scale, out, n, vc, lo,
                                 vec, st);
  if (dtype == ptt::kBFloat16)
    return launch_dlogits<__nv_bfloat16>(logits, lse, local, scale, out, n,
                                         vc, lo, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
