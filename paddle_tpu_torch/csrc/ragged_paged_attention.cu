// Ragged paged attention for Hopper: mixed prefill + decode attention over
// a paged KV pool, one launch for the whole batching step.
//
// Replaces: paddle_tpu/ops/pallas/ragged_paged_attention.py::_ragged_kernel
// (K12, bf16/f32 pools) and ::_ragged_quant_kernel (K13, int8 or fp8 e4m3
// pools with page-parallel f32 scales pools [KVH, P, page]). Both are one
// template over the pool's element type TP: for K13, TP is int8_t or
// __nv_fp8_e4m3, a 16-byte vector carries 16 codes, and each code is
// converted to f32 and multiplied by its token's scale ks[h, pid, off] (the
// same block-table indirection as the data) as the tile is loaded, so the
// softmax body is K12's f32 arithmetic unchanged. Keys past n_kv load no
// code and no scale.
//
// Semantics (the plain version is ragged_paged_attention_reference):
//   q [B, C, H, D], pools [KVH, P, page, D], tables [B, pages_per_seq],
//   ctx [B] and lengths [B] int32. Query token j of slot b attends cache
//   positions <= ctx[b] + j through the slot's block-table row; query head
//   i reads kv head i / (H / KVH). Rows j >= lengths[b] (and every row of
//   an idle slot) are written as zeros: the output comes from torch.empty.
//
// Bound on the H100 (K13 reads half K12's pool bytes plus 4 bytes of scale
// a token and kv head): bytes at decode (every cached key and value of the
// batch is read once, about 2 flops a byte per query head), operations
// only for long prefill chunks. This first version does its arithmetic on
// the CUDA cores in f32 (no wgmma, no TMA): right and simple first.
//
// Design. One CTA per (q block, slot, kv head): the TPU grid's sequential
// axis becomes a loop inside the CTA, and the scalar-prefetched ctx,
// length and table row become plain loads by the CTA itself. A CTA holds
// kRows = 64 query rows: q_tokens = 64 / rep tokens times the rep query
// heads of its kv head, so K and V are read once for all rep heads (where
// rep does not divide 64, as Qwen2's 28 / 4 = 7, the last 64 % rep rows
// are unused: never loaded, computed or written). It
// walks the slot's keys up to ctx + min(q_start + q_tokens, length) in
// tiles of kKeys, looking each key's page up in the table, with an online
// softmax in f32 (scores, running max and sum per row). K and V come in
// 16-byte vectors; in the products each thread loads a K or V value once
// for all its rows, and rows past the slot's length (all but rep of them
// for a decode step) skip their arithmetic. Keys at or past
// that end are never loaded: V rows for them are zero in shared memory,
// and masked scores are replaced (not multiplied) before the product, so
// a non-finite trash page 0 or table padding never reaches an output.
// Shared memory: Q [64][D], K [kKeys][D+1] (padded against bank
// conflicts), V [kKeys][D], P [64][kKeys]; 74 KB at D = 128.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kRows = 64;      // (token, head) query rows per CTA
constexpr int kKeys = 32;      // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * D + kKeys * (D + 1) + kKeys * D + kRows * kKeys + 2 * kRows);
}

// T: q and out; TP: the pools (T itself for K12; int8_t or __nv_fp8_e4m3
// for K13, with ksc/vsc the scales pools, unused otherwise)
template <typename T, typename TP, int D>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ q, const TP* __restrict__ kpool,
                  const TP* __restrict__ vpool,
                  const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ tables,
                  const int* __restrict__ ctx_lens,
                  const int* __restrict__ lengths, T* __restrict__ out, int C,
                  int H, int num_pages, int page, int pages_per_seq, int rep,
                  float scale) {
  static_assert(kThreads % D == 0, "D must divide the block size");
  constexpr bool kQuant = !std::is_same<T, TP>::value;
  constexpr int kGroups = kThreads / D;         // row groups in the PV phase
  constexpr int kAccRows = kRows / kGroups;     // accumulator rows a thread
  constexpr int kRowsPerWarp = kRows / kWarps;  // score rows a warp

  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][D], pre-scaled
  float* ks = qs + kRows * D;           // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);     // [kKeys][D]
  float* ps = vs + kKeys * D;           // [kRows][kKeys]
  float* alpha_s = ps + kRows * kKeys;  // [kRows]
  float* l_s = alpha_s + kRows;         // [kRows]

  const int b = blockIdx.y;
  const int h = blockIdx.z;  // kv head
  const int q_tokens = kRows / rep;
  const int q_start = blockIdx.x * q_tokens;
  const int ctx = ctx_lens[b];
  const int length = lengths[b];
  const int tid = threadIdx.x;

  // row r <-> token q_start + r / rep, query head h * rep + r % rep
  auto out_index = [&](int r, int t, int dd) -> size_t {
    return ((size_t)(b * (size_t)C + t) * H + h * rep + r % rep) * D + dd;
  };

  const int rows_used = q_tokens * rep;  // rows past it belong to no token
  if (q_start >= length) {  // idle slot or a block of padding rows
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, dd = i % D;
      const int t = q_start + r / rep;
      if (r < rows_used && t < C)
        out[out_index(r, t, dd)] = ptt::from_f<T>(0.f);
    }
    return;
  }

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, dd = i % D;
    const int t = q_start + r / rep;
    qs[i] = r < rows_used && t < length
                ? ptt::to_f(q[out_index(r, t, dd)]) * scale
                : 0.f;
  }

  const int n_kv = ctx + min(q_start + q_tokens, length);
  // valid rows are rows [0, n_rows): tokens before `length`; the others
  // (a decode slot uses rep of the 64) skip their arithmetic
  const int n_rows = min(length - q_start, q_tokens) * rep;
  const int warp = tid >> 5, lane = tid & 31;
  const int dcol = tid % D, rgroup = tid / D;
  const int* tbl = tables + (size_t)b * pages_per_seq;
  const size_t head_stride = (size_t)num_pages * page * D;
  const TP* kh = kpool + (size_t)h * head_stride;
  const TP* vh = vpool + (size_t)h * head_stride;
  // scales of kv head h: [P][page]
  const size_t scale_base = (size_t)h * num_pages * page;
  constexpr int V = ptt::Vec<TP>::N;  // pool elements per 16-byte load

  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  for (int k_base = 0; k_base < n_kv; k_base += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    // K and V tile: 16-byte loads from the pages the table names; keys
    // at or past n_kv are zero and never read from the pool
    for (int i = tid; i < kKeys * D / V; i += kThreads) {
      const int j = i / (D / V), dd = (i % (D / V)) * V;
      const int kp = k_base + j;
      float kf[V], vf[V];
      if (kp < n_kv) {
        const int pidx = min(kp / page, pages_per_seq - 1);
        const size_t slot = (size_t)tbl[pidx] * page + kp % page;
        const size_t off = slot * D + dd;
        const ptt::Vec<TP> kv =
            *reinterpret_cast<const ptt::Vec<TP>*>(kh + off);
        const ptt::Vec<TP> vv =
            *reinterpret_cast<const ptt::Vec<TP>*>(vh + off);
        float k_scale = 1.f, v_scale = 1.f;
        if constexpr (kQuant) {
          k_scale = ksc[scale_base + slot];
          v_scale = vsc[scale_base + slot];
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
          kf[e] = ptt::to_f(kv.v[e]);
          vf[e] = ptt::to_f(vv.v[e]);
          if constexpr (kQuant) {
            kf[e] *= k_scale;
            vf[e] *= v_scale;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ks[j * (D + 1) + dd + e] = kf[e];
        vs[j * D + dd + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: warp w owns rows w + kWarps * i, lane owns key k_base +
    // lane; each K value is loaded once for all the warp's rows and Q
    // comes as broadcast 16-byte loads
    const int kp = k_base + lane;
    const float* kr = ks + lane * (D + 1);
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      const float k0 = kr[dd], k1 = kr[dd + 1], k2 = kr[dd + 2],
                  k3 = kr[dd + 3];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + i * kWarps;
        if (r < n_rows) {  // warp-uniform
          const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + dd);
          s[i] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
        }
      }
    }
    // online softmax per row (masked scores replaced, not multiplied)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      if (r >= n_rows) continue;  // warp-uniform
      const int t = q_start + r / rep;
      const bool valid = kp <= ctx + t && kp < n_kv;
      const float sc = valid ? s[i] : kNegInf;
      const float m_new = fmaxf(m_r[i], ptt::warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + ptt::warp_sum(p);
      m_r[i] = m_new;
      ps[r * kKeys + lane] = p;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha[r] + sum_j p[r][j] * v[j][d]: each V
    // value is loaded once for all the thread's rows, P as broadcast
    // 16-byte loads
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rgroup + i * kGroups;
      if (r < n_rows) acc[i] *= alpha_s[r];
    }
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      const float v0 = vs[j * D + dcol], v1 = vs[(j + 1) * D + dcol],
                  v2 = vs[(j + 2) * D + dcol], v3 = vs[(j + 3) * D + dcol];
#pragma unroll
      for (int i = 0; i < kAccRows; ++i) {
        const int r = rgroup + i * kGroups;
        if (r < n_rows) {  // warp-uniform (a warp shares rgroup)
          const float4 pv = *reinterpret_cast<const float4*>(ps + r * kKeys + j);
          acc[i] += pv.x * v0 + pv.y * v1 + pv.z * v2 + pv.w * v3;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp + i * kWarps] = l_r[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int r = rgroup + i * kGroups;
    const int t = q_start + r / rep;
    if (r < rows_used && t < C) {
      const float val = t < length ? acc[i] / fmaxf(l_s[r], 1e-30f) : 0.f;
      out[out_index(r, t, dcol)] = ptt::from_f<T>(val);
    }
  }
}

// The pointers and sizes of one call
struct Args {
  const void *q, *kp, *vp, *ks, *vs, *tables, *ctx, *lengths;
  void* out;
  int B, C, H, KVH, num_pages, page, pages_per_seq;
  float scale;
};

template <typename T, typename TP, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rep = a.H / a.KVH;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      ragged_kernel<T, TP, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int q_tokens = kRows / rep;
  dim3 grid((a.C + q_tokens - 1) / q_tokens, a.B, a.KVH);
  ragged_kernel<T, TP, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const TP*>(a.kp),
      static_cast<const TP*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.ctx), static_cast<const int*>(a.lengths),
      static_cast<T*>(a.out), a.C, a.H, a.num_pages, a.page,
      a.pages_per_seq, rep, a.scale);
  return cudaGetLastError();
}

template <typename T, typename TP>
cudaError_t launch_d(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, TP, 32>(a, s);
    case 64:
      return launch<T, TP, 64>(a, s);
    case 128:
      return launch<T, TP, 128>(a, s);
    case 256:
      return launch<T, TP, 256>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q/out dtype x pool code -> the instantiation
template <typename T>
cudaError_t launch_pool(int pool, int D, const Args& a, cudaStream_t s) {
  if (pool == ptt::kInt8) return launch_d<T, int8_t>(D, a, s);
  if (pool == ptt::kFloat8E4M3) return launch_d<T, __nv_fp8_e4m3>(D, a, s);
  return cudaErrorInvalidValue;
}

bool shape_ok(int B, int C, int H, int KVH) {
  return B > 0 && C > 0 && KVH > 0 && H % KVH == 0 && H / KVH <= kRows;
}

}  // namespace

// All tensors contiguous; D in {32, 64, 128, 256}; H / KVH at most 64.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a shape the
// kernel does not take).
extern "C" int ragged_paged_attention_fwd(
    const void* q, const void* key_pages, const void* value_pages,
    const void* tables, const void* ctx, const void* lengths, void* out,
    int B, int C, int H, int KVH, int D, int num_pages, int page,
    int pages_per_seq, float scale, int dtype, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (!shape_ok(B, C, H, KVH)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   key_pages, value_pages, nullptr,   nullptr,
               tables, ctx,    lengths,     out,       B,
               C,   H,         KVH,         num_pages, page,
               pages_per_seq, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return launch_d<float, float>(D, a, s);
  if (dtype == ptt::kBFloat16)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K13: the pools are int8 (pool == kInt8) or fp8 e4m3 (kFloat8E4M3) codes,
// k_scales / v_scales f32 [KVH, num_pages, page]; q and out f32 or bf16
// (dtype). Otherwise as ragged_paged_attention_fwd.
extern "C" int ragged_paged_attention_quant_fwd(
    const void* q, const void* key_pages, const void* value_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* ctx, const void* lengths, void* out, int B, int C, int H,
    int KVH, int D, int num_pages, int page, int pages_per_seq, float scale,
    int dtype, int pool, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (!shape_ok(B, C, H, KVH)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   key_pages, value_pages, k_scales,  v_scales,
               tables, ctx,    lengths,     out,       B,
               C,   H,         KVH,         num_pages, page,
               pages_per_seq, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return launch_pool<float>(pool, D, a, s);
  if (dtype == ptt::kBFloat16)
    return launch_pool<__nv_bfloat16>(pool, D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
