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
//
// K10: one warp per row, kRowsPerBlock rows a block, two passes over a
// slab of the row held in registers (the Pallas body's two passes: the
// max, then one sum of exps). A slab is kSlabVecs 16-byte vectors a lane
// (32 * 4 * 8 = 1024 columns in bf16: the fit's whole chunk row), and
// every load of a slab goes out before any arithmetic on it; vectors
// past vc are predicated off, not a loop of runtime length. Pass 1 takes
// a branch-free max (columns below lo selected to -inf) and one warp_max;
// pass 2 sums exp2((x - m) * log2e) into four independent accumulators.
// Every lane then shares the row's max, so the lanes' sums merge with one
// warp_sum and no exp. A wider row (f32 at vc 1024 is two slabs, a
// 4096-column bf16 chunk four) merges slab by slab: the running sum is
// rescaled once a slab, never once an element. The exp is
// ex2.approx.ftz.f32 (relative error about 2^-22, a few ulps; a term it
// flushes to zero is below 2^-126 of the row's largest, which is 1), far
// inside the 2e-5 of s that the checks allow. A slab whose columns all lie
// in [lo, vc) (every slab but the clamped tail chunk's) takes no mask,
// and its bf16 max is max.bf16x2, two columns an instruction. The target
// comes from the registers of the lane that holds the label's column (one
// shuffle), never through a one-hot or a second load. No shared memory,
// no atomics. Measured on an H100 (PERF.md, K10; tools/cuda_variants.py):
// 5 or 6 blocks an SM (fewer registers: they spill), 16 rows a block and
// 2 vectors a slab all ran slower.
// K11: one warp per row, a lane's 16-byte vectors in a strided loop.
#include <math.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kSlabVecs = 4;     // 16-byte vectors a lane a slab (K10)
constexpr int kStatsBlocks = 4;  // K10's resident blocks an SM (registers)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// one element of T, as a pack of one (K10's path for rows that are not
// 16-byte vectors)
template <typename T>
struct One {
  static constexpr int N = 1;
  T v[1];
};

// the largest of a pack's elements (bf16: max.bf16x2 over its words, one
// instruction for two columns; exact, as every max is)
__device__ __forceinline__ float pack_max(const ptt::Vec<__nv_bfloat16>& a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a.v);
  uint32_t x = w[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    asm("max.bf16x2 %0, %0, %1;\n" : "+r"(x) : "r"(w[i]));
  return fmaxf(__uint_as_float(x << 16), __uint_as_float(x & 0xFFFF0000u));
}
template <typename Pack>
__device__ __forceinline__ float pack_max(const Pack& a) {
  float x = ptt::to_f(a.v[0]);
#pragma unroll
  for (int e = 1; e < Pack::N; ++e) x = fmaxf(x, ptt::to_f(a.v[e]));
  return x;
}

// element e of pack k of a lane's slab, by selects (k and e are the same
// across the warp; no register array is indexed at run time)
template <int NP, typename Pack>
__device__ __forceinline__ float pick(const Pack (&a)[NP], int k, int e) {
  Pack p = a[0];
#pragma unroll
  for (int i = 1; i < NP; ++i)
    if (i == k) p = a[i];
  float x = ptt::to_f(p.v[0]);
#pragma unroll
  for (int i = 1; i < Pack::N; ++i)
    if (i == e) x = ptt::to_f(p.v[i]);
  return x;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kRowsPerBlock, kStatsBlocks)
    ce_stats_kernel(const T* __restrict__ logits,
                    const int* __restrict__ local, float* __restrict__ m_out,
                    float* __restrict__ s_out, float* __restrict__ t_out,
                    int n, int vc, int lo) {
  using Pack = typename std::conditional<kVec, ptt::Vec<T>, One<T>>::type;
  constexpr int V = Pack::N;                   // elements a pack
  constexpr int NP = kVec ? kSlabVecs : 16;    // packs a lane a slab
  constexpr int kSlab = 32 * NP * V;           // columns a slab
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const Pack* xr = reinterpret_cast<const Pack*>(logits + row * vc);
  const int tgt = local[row];
  const int n_packs = vc / V;  // kVec: the caller checked vc % V == 0
  float m = -INFINITY, s = 0.f, t = 0.f;
  for (int base = 0; base < vc; base += kSlab) {
    // the slab's loads, all before any arithmetic on it
    Pack a[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int i = base / V + k * 32 + lane;
      if (i < n_packs) {
        a[k] = xr[i];
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) a[k].v[e] = ptt::from_f<T>(0.f);
      }
    }
    // a slab with every column in [lo, vc) needs no mask (warp-uniform)
    const bool full = base >= lo && base + kSlab <= vc;
    // pass 1: the max over columns >= lo (others -inf)
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      if (full) {
        mx = fmaxf(mx, pack_max(a[k]));
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int col = base + (k * 32 + lane) * V + e;
          const float x = ptt::to_f(a[k].v[e]);
          mx = fmaxf(mx, col >= lo && col < vc ? x : -INFINITY);
        }
      }
    }
    const float m_new = fmaxf(m, ptt::warp_max(mx));
    // the target, where the label's column lies in [lo, vc) and in this
    // slab: from the registers of the lane that holds it
    const int d = tgt - base;
    if (tgt >= lo && tgt < vc && d >= 0 && d < kSlab) {
      const int i = d / V;
      t = __shfl_sync(0xffffffffu, pick(a, i / 32, d % V), i % 32);
    }
    if (m_new == -INFINITY) continue;  // no column yet (warp-uniform)
    // pass 2: the sum of exps against the shared max, four accumulators
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float p = ex2((ptt::to_f(a[k].v[e]) - m_new) * kLog2e);
        const int col = base + (k * 32 + lane) * V + e;
        acc[(k * V + e) % 4] += full || (col >= lo && col < vc) ? p : 0.f;
      }
    // the running sum rescaled once a slab (0 before the first column)
    s = s * ex2((m - m_new) * kLog2e) +
        ((acc[0] + acc[1]) + (acc[2] + acc[3]));
    m = m_new;
  }
  s = ptt::warp_sum(s);  // every lane holds the same m
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
