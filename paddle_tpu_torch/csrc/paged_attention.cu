// Decode-step paged attention for Hopper: one query token a sequence over a
// paged KV pool.
//
// Replaces: paddle_tpu/ops/paged_attention.py::paged_attention, which on a
// TPU reaches the decode kernel jax bundles
// (jax/experimental/pallas/ops/tpu/paged_attention/paged_attention_kernel.py:
// paged_flash_attention_kernel and ..._inline_seq_dim, pallas_call at
// l.628). Its plain version is paged_attention_reference (the jnp oracle
// the JAX package runs off the TPU).
//
// Semantics: q [B, H, D], pools [KVH, P, page, D], tables [B, pages_per_seq]
// and context_lens [B] int32. Query head i of sequence b reads kv head
// i / (H / KVH) at cache positions < context_lens[b], through the
// sequence's block-table row; the scale applies to the f32 logits. A
// sequence with context_lens[b] == 0 gets zeros.
//
// Bound on the H100: bytes. Every cached key and value of the batch is
// read once, for some 2 * rep flops a byte; the arithmetic is on the CUDA
// cores in f32.
//
// Design. One CTA per (sequence, kv head) holds the rep query rows of that
// kv head (rep at most 8), so K and V are read once for all of them. Its 8
// warps split the sequence's keys in chunks of 16 (a page at page size
// 16), chunk c to warp c % 8. In a chunk, two lanes share a key: each loads
// every other 16-byte vector of the key row (the pair reads 32 contiguous
// bytes a load), takes its half of the rep dot products against q in
// shared memory, and one shuffle adds the halves. Each warp keeps an
// online softmax in f32 for the rep rows; for P.V a lane owns D/32
// columns, so a value row is one coalesced read by the warp. Keys at or
// past context_lens[b] are never loaded and get no weight, so a
// non-finite trash page never reaches an output. At the end the warps'
// (max, sum, accumulator) are combined through shared memory. A split of
// one sequence's keys over several CTAs (flash-decoding) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;     // query heads a kv head
constexpr int kChunk = 16;     // keys a warp takes at a time (2 lanes a key)
constexpr float kNegInf = -1e30f;

// N elements of T in one aligned load (N * sizeof(T) a power of two)
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kMaxRep * D + kWarps * kMaxRep * kChunk +
                          kWarps * kMaxRep * D + 2 * kWarps * kMaxRep);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                        const T* __restrict__ vpool,
                        const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens, T* __restrict__ out,
                        int H, int num_pages, int page, int pages_per_seq,
                        int rep, float scale) {
  constexpr int V = ptt::Vec<T>::N;  // elements a 16-byte vector
  constexpr int NVL = D / V / 2;     // vectors of a key row a lane loads
  constexpr int DL = D / 32;         // value columns a lane owns
  static_assert(D % (2 * V) == 0 && D % 32 == 0, "D not taken");

  extern __shared__ float smem[];
  float* qs = smem;                             // [kMaxRep][D]
  float* ps = qs + kMaxRep * D;                 // [kWarps][kMaxRep][kChunk]
  float* red = ps + kWarps * kMaxRep * kChunk;  // [kWarps][kMaxRep][D]
  float* red_m = red + kWarps * kMaxRep * D;    // [kWarps][kMaxRep]
  float* red_l = red_m + kWarps * kMaxRep;      // [kWarps][kMaxRep]

  const int b = blockIdx.x;
  const int h = blockIdx.y;  // kv head
  const int n = ctx_lens[b];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int key_in = lane >> 1, half = lane & 1;

  const T* qb = q + ((size_t)b * H + (size_t)h * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) qs[i] = ptt::to_f(qb[i]);
  __syncthreads();

  const int* tbl = tables + (size_t)b * pages_per_seq;
  const size_t head_stride = (size_t)num_pages * page * D;
  const T* kh = kpool + (size_t)h * head_stride;
  const T* vh = vpool + (size_t)h * head_stride;
  float* pw = ps + warp * kMaxRep * kChunk;

  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }

  for (int base = warp * kChunk; base < n; base += kWarps * kChunk) {
    // scores: lanes 2j and 2j + 1 share key base + j
    const int kp = base + key_in;
    const bool valid = kp < n;
    float s[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) s[r] = 0.f;
    if (valid) {
      const int pid = tbl[min(kp / page, pages_per_seq - 1)];
      const T* krow = kh + ((size_t)pid * page + kp % page) * D;
      ptt::Vec<T> kv[NVL];
#pragma unroll
      for (int i = 0; i < NVL; ++i)
        kv[i] = *reinterpret_cast<const ptt::Vec<T>*>(krow +
                                                      (2 * i + half) * V);
#pragma unroll
      for (int i = 0; i < NVL; ++i) {
        const int col = (2 * i + half) * V;
        float kf[V];
#pragma unroll
        for (int e = 0; e < V; ++e) kf[e] = ptt::to_f(kv[i].v[e]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {  // uniform
            const float* qr = qs + r * D + col;
#pragma unroll
            for (int e = 0; e < V; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              s[r] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                      qv.w * kf[e + 3];
            }
          }
        }
      }
    }
    // online softmax per row over the chunk (masked scores replaced)
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float sr = s[r] + __shfl_xor_sync(0xffffffffu, s[r], 1);
        sr = valid ? sr * scale : kNegInf;
        const float m_new = fmaxf(m[r], ptt::warp_max(sr));
        const float p = valid ? expf(sr - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + ptt::warp_sum(half ? 0.f : p);
        m[r] = m_new;
        if (!half) pw[r * kChunk + key_in] = p;
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] *= alpha;
      }
    }
    __syncwarp();
    // P.V: the chunk's value rows, each read by the whole warp
    Pack<T, DL> vv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int kq = base + j;
      if (kq < n) {  // uniform
        const int pid = tbl[min(kq / page, pages_per_seq - 1)];
        vv[j] = *reinterpret_cast<const Pack<T, DL>*>(
            vh + ((size_t)pid * page + kq % page) * D + lane * DL);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (base + j < n) {  // uniform
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float p = pw[r * kChunk + j];
#pragma unroll
            for (int e = 0; e < DL; ++e)
              acc[r][e] += p * ptt::to_f(vv[j].v[e]);
          }
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next chunk
  }

  // combine the warps: rescale each to the common max
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < DL; ++e)
        red[(warp * kMaxRep + r) * D + lane * DL + e] = acc[r][e];
      if (lane == 0) {
        red_m[warp * kMaxRep + r] = m[r];
        red_l[warp * kMaxRep + r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * kMaxRep + r]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(red_m[w * kMaxRep + r] - mx);
      sum += red_l[w * kMaxRep + r] * f;
      o += red[(w * kMaxRep + r) * D + d] * f;
    }
    out[((size_t)b * H + (size_t)h * rep + r) * D + d] =
        ptt::from_f<T>(sum > 0.f ? o / sum : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* ctx, void* out, int B,
                   int H, int KVH, int num_pages, int page, int pages_per_seq,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, KVH);
  paged_decode_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), static_cast<T*>(out), H, num_pages, page,
      pages_per_seq, H / KVH, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* kp, const void* vp,
                     const void* tables, const void* ctx, void* out, int B,
                     int H, int KVH, int num_pages, int page,
                     int pages_per_seq, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, 64>(q, kp, vp, tables, ctx, out, B, H, KVH, num_pages,
                         page, pages_per_seq, scale, s);
  if (D == 128)
    return launch<T, 128>(q, kp, vp, tables, ctx, out, B, H, KVH, num_pages,
                          page, pages_per_seq, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors contiguous; D in {64, 128}; H / KVH at most 8. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape the kernel does
// not take).
extern "C" int paged_attention_fwd(const void* q, const void* key_pages,
                                   const void* value_pages,
                                   const void* tables, const void* ctx_lens,
                                   void* out, int B, int H, int KVH, int D,
                                   int num_pages, int page, int pages_per_seq,
                                   float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32)
    return launch_d<float>(D, q, key_pages, value_pages, tables, ctx_lens,
                           out, B, H, KVH, num_pages, page, pages_per_seq,
                           scale, s);
  if (dtype == ptt::kBFloat16)
    return launch_d<__nv_bfloat16>(D, q, key_pages, value_pages, tables,
                                   ctx_lens, out, B, H, KVH, num_pages, page,
                                   pages_per_seq, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
