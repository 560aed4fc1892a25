// Ragged paged attention for Hopper: mixed prefill + decode attention over
// a paged KV pool, one launch for the whole batching step.
//
// Replaces: paddle_tpu/ops/pallas/ragged_paged_attention.py::_ragged_kernel
// (K12, bf16/f32 pools) and ::_ragged_quant_kernel (K13, int8 or fp8 e4m3
// pools with page-parallel f32 scales pools [KVH, P, page]). Both bodies
// below are templates over the pool's element type TP: K13 is K12 over
// int8_t or __nv_fp8_e4m3 codes, each key's code scaled by its token's
// scale ks[h, pid, off] (the same block-table indirection as the data).
// Keys past n_kv load no code and no scale.
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
// only for long prefill chunks.
//
// Rows. A CTA holds kRows = 64 query rows: q_tokens = 64 / rep tokens
// times the rep query heads of its kv head, so K and V are read once for
// all rep heads (where rep does not divide 64, as Qwen2's 28 / 4 = 7, the
// last 64 % rep rows are unused: never loaded, computed or written). The
// TPU grid's sequential axis becomes a loop over the slot's keys inside
// the CTA, and the scalar-prefetched ctx, length and table row become
// plain loads by the CTA itself. Keys at or past the q block's end are
// never loaded: their K and V rows are zero in shared memory, and masked
// scores are replaced (not multiplied) before the product, so a
// non-finite trash page 0 or table padding never reaches an output.
//
// bf16 q at D 64 and 128 (tc::ragged_mma; both served models use D 128):
// split keys, tensor cores, a cp.async ring.
//   * Keys split over CTAs (flash-decoding): the wrapper's plan, from the
//     shapes alone (C, B, KVH, pages_per_seq * page; ops/kernels/
//     ragged_paged_attention.py::split_plan), gives n_splits splits of
//     split_len keys (at most 512; at decode more, to fill the card). One
//     CTA per (q block, split, slot, kv head). With more than one split
//     every CTA writes f32 partials (o unnormalised, and m, l a row) to
//     scratch, and ragged_merge, a second launch, merges them in split
//     order and writes every row of the output: the same bits every run,
//     no atomics, no host sync. A CTA
//     whose split starts past its keys writes an empty partial (m at its
//     floor) and exits. Llama-3-8B's decode and mixed steps take 4 splits
//     of 512 keys, Qwen2's decode step 8 of 256 (256 CTAs).
//   * Products on mma.sync m16n8k16 (bf16 in, f32 sums), four warps. Not
//     wgmma: its 64-row tile would hold a decode step's rep rows (4 for
//     Llama-3-8B, 7 for Qwen2) in 64, where m16 wastes less. Where the
//     shapes give a q block more than 16 rows (C * rep > 16) each warp
//     takes 16 rows and every key of a tile; in a decode step (C * rep <=
//     16) every warp takes the block's rows and 16 keys of each tile, and
//     the warps' softmax states are combined at the end, in warp order.
//     The choice follows the shapes, never the lengths: a row's bits do
//     not depend on the other tokens of its block, so a one-token
//     prefill (the prefix cache's copy-on-write) gives the bits the same
//     token gets inside a full chunk. Tiles of 64 keys come in by cp.async (zero
//     fill by predicate) through a ring of three stages (two tiles in
//     flight while one is multiplied, one __syncthreads a tile); the
//     split's block-table entries are read into shared memory once, and a
//     page of a power of two is found by shifts (a division by the page
//     size cost as much as the products at decode). K13's ring holds codes
//     and scales; each tile's codes are converted (exact in bf16: |c| <=
//     128, e4m3) into a bf16 work tile before its products, by integer and
//     bf16x2 operations (the conversion instructions run at a quarter of
//     the rate; converting one tile ahead into a second buffer ran no
//     faster).
//   * Precision: the checks hold the bf16 kernel to f32 accuracy up to its
//     output's rounding. Scores are bf16 q . k with f32 sums; the softmax
//     scale (and K13's key scale ks[j]: ks[j] * (q . c_j)) multiplies the
//     f32 score, never q. P is not rounded once to bf16 before P V (that
//     moves an output by up to 2^-9 of sum p|v|): it is split into bf16
//     hi + lo halves and multiplied twice, which leaves 2^-17 of it. K13
//     folds the value scale vs[j] into P in f32 before the split; the row
//     sums use P alone. Decode is bytes-bound, so the second product is
//     close to free there.
//   What bounds it: latency, not bytes. Each CTA walks its keys a tile at
//   a time (a few microseconds a tile at the mixed step, where one CTA
//   holds one SM's work), and the merge and a second launch cost a few
//   microseconds of their own.
//
// f32 q, and bf16 at D 32 and 256 (ragged_kernel): the first version's
// body, on the CUDA cores in f32. K and V come in 16-byte vectors (K13's
// codes converted and scaled as they load), one CTA per (q block, slot,
// kv head) walks every key in tiles of kKeys with an online softmax in
// f32; in the products each thread loads a K or V value once for all its
// rows, and rows past the slot's length skip their arithmetic. Shared
// memory: Q [64][D], K [kKeys][D+1], V [kKeys][D], P [64][kKeys].
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

// ---- bf16 q at D 64/128: split keys, mma.sync, a cp.async ring -------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;  // four warps
constexpr int kTileKeys = 64;  // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// shared memory of one CTA: a ring of three stages, each K and V tiles
// [64][D + 8] bf16 (K12), or [64][D + 16] codes and the tile's 64 key
// and 64 value scales (K13), then K13's bf16 work tile of K and V, then
// the split's block-table entries (sized at launch). Rows of D + 8
// elements put the eight rows of an ldmatrix in distinct banks. The ring,
// once drained, holds the four warps' states for the key-split combine.
template <int D, bool kQuant>
struct Smem {
  static constexpr int kLd = D + 8;    // bf16 row, elements
  static constexpr int kLdc = D + 16;  // code row, bytes
  static constexpr uint32_t tile = kTileKeys * kLd * 2;
  static constexpr uint32_t code_tile = kTileKeys * kLdc;
  static constexpr uint32_t stage =
      kQuant ? 2 * code_tile + 2 * kTileKeys * 4 : 2 * tile;
  static constexpr uint32_t work = 3 * stage;
  static constexpr uint32_t pages = work + (kQuant ? 2 * tile : 0);
  static constexpr uint32_t combine = 4 * 16 * (D + 2) * 4;
  static_assert(combine <= work, "the combine fits in the ring");
};

// cp.async of 16 (or 4) bytes; with ok false nothing is read and zeros
// are written
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give matrix i's row
// addresses (.trans: each matrix transposed on the way)
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16 x 16) * b (16 x 8), bf16 in, f32 accumulate. Fragments (lane
// 4g + t): a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..][g], B[2t+8..][g]; c = C[g][2t, 2t+1], C[g+8][2t, 2t+1]
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as bf16 hi + lo halves: x - hi(x) rounded once more; the pair's
// sum is x to within 2^-17 of |x|
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A word of four int8 or e4m3 codes as two bf16x2 words (codes 0, 1
// and 2, 3), exactly, by integer and bf16x2 operations alone (the
// conversion instructions run at a quarter of the rate). int8: each code,
// offset by 128, becomes the low byte of the f32 2^23 + (c + 128), which
// an f32 subtraction turns into c, then the upper halves of two f32 are
// a bf16x2. e4m3: each code's exponent and mantissa bits are moved into a
// bf16's (s eeee mmm -> s 0000eeee mmm0000), which is the code's value
// times 2^-120, subnormal codes included; one bf16x2 product with 2^120
// (exact: a power of two, subnormals kept) rebiases the pair.
template <typename TP>
__device__ __forceinline__ void codes_to_bf16(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
  if constexpr (std::is_same<TP, int8_t>::value) {
    const uint32_t x = w ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 + k)) -
             8388736.0f;
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  } else {
    uint32_t pair[2] = {__byte_perm(w, 0u, 0x4140),   // b0, 0, b1, 0
                        __byte_perm(w, 0u, 0x4342)};  // b2, 0, b3, 0
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint32_t x = pair[k];
      const uint32_t bits =
          ((x << 4) & 0x07F007F0u) | ((x << 8) & 0x80008000u);
      // bf16x2 product with (2^120, 2^120), + (-0, -0) keeps a zero's sign
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(pair[k])
          : "r"(bits), "r"(0x7B807B80u), "r"(0x80008000u));
    }
    lo = pair[0];
    hi = pair[1];
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// TP: the pools' element type, bf16 (K12) or int8_t / __nv_fp8_e4m3 codes
// with f32 scales ksc / vsc (K13). One CTA per (q block and key split,
// slot, kv head); with one split it writes `out`, with several it writes
// its f32 partials (o, and m, l a row) for ragged_merge. Where a block
// may hold more than 16 rows (C * rep > 16) each warp takes 16 rows and
// every key of a tile; in a decode step (C * rep <= 16: rep rows) every
// warp takes those rows and 16 keys of each tile, and the four warps'
// softmax states are combined once at the end, in warp order. The
// choice is the shapes', not the lengths', so a row's bits never depend
// on how many tokens share its block.
template <typename TP, int D>
__global__ void __launch_bounds__(kThreads, 2)
    ragged_mma(const bf16* __restrict__ q, const TP* __restrict__ kpool,
               const TP* __restrict__ vpool, const float* __restrict__ ksc,
               const float* __restrict__ vsc,
               const int* __restrict__ tables,
               const int* __restrict__ ctx_lens,
               const int* __restrict__ lengths, bf16* __restrict__ out,
               float* __restrict__ o_part, float2* __restrict__ ml_part,
               int C, int H, int num_pages, int page, int pages_per_seq,
               int rep, float scale_log2, int split_len, int n_splits) {
  constexpr bool kQuant = !std::is_same<TP, bf16>::value;
  using S = Smem<D, kQuant>;
  constexpr int kLd = S::kLd, kChunks = D / 8, kDB = D / 8, kKK = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x % n_splits, qb = blockIdx.x / n_splits;
  const int b = blockIdx.y, h = blockIdx.z;
  const int q_tokens = kRows / rep, q_start = qb * q_tokens;
  const int rows_used = q_tokens * rep;
  const int ctx = ctx_lens[b], length = lengths[b];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t n_rows_all = (size_t)gridDim.y * C * H;  // partial rows
  // row r <-> (token q_start + r / rep, query head h * rep + r % rep)
  auto row_of = [&](int r) -> size_t {
    return ((size_t)b * C + q_start + r / rep) * H + h * rep + r % rep;
  };

  if (q_start >= length) {  // idle slot or padding rows: zeros
    if (n_splits == 1)
      for (int i = tid; i < rows_used * kChunks; i += kThreads) {
        const int r = i / kChunks;
        if (q_start + r / rep < C)
          *reinterpret_cast<uint4*>(out + row_of(r) * D + i % kChunks * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    return;  // with several splits ragged_merge writes them
  }
  const int n_tok = min(length - q_start, q_tokens);
  const int n_rows = n_tok * rep;  // rows of a token before `length`
  // the keys of this q block (clipped to the table's), and this split's
  const int n_kv =
      min(ctx + min(q_start + q_tokens, length), pages_per_seq * page);
  const int k_lo = split * split_len, k_hi = min(k_lo + split_len, n_kv);
  if (k_lo >= k_hi) {  // past the block's keys: an empty partial
    for (int r = tid; r < n_rows; r += kThreads)
      ml_part[split * n_rows_all + row_of(r)] = make_float2(kNegInf, 0.f);
    return;
  }

  // the split's block-table entries, read once
  int* pg = reinterpret_cast<int*>(smem + S::pages);
  const int p_lo = k_lo / page, n_pg = (k_hi - 1) / page - p_lo + 1;
  const int* tbl = tables + (size_t)b * pages_per_seq + p_lo;
  for (int i = tid; i < n_pg; i += kThreads) pg[i] = tbl[i];
  __syncthreads();
  const size_t head = (size_t)h * num_pages * page;  // kv head h's tokens
  // a key's page and offset: shifts for a page of a power of two (the
  // served ones), a division otherwise (CTA-uniform)
  const bool pow2 = (page & (page - 1)) == 0;
  const int shift = __ffs(page) - 1;
  auto slot_of = [&](int kp) -> size_t {
    const int pi = pow2 ? kp >> shift : kp / page;
    const int off = pow2 ? kp & (page - 1) : kp % page;
    return head + (size_t)pg[pi - p_lo] * page + off;
  };
  // tile `it` of the split into ring stage st: keys at or past k_hi read
  // nothing (no code, no scale) and are zeros
  auto load_tile = [&](int it, int st) {
    const int k0 = k_lo + it * kTileKeys;
    unsigned char* base = smem + st * S::stage;
    if constexpr (!kQuant) {
      constexpr int kStep = kThreads / kChunks;  // keys a pass
      bf16* kt = reinterpret_cast<bf16*>(base);
      bf16* vt = kt + kTileKeys * kLd;
      const int c = tid % kChunks * 8;
#pragma unroll
      for (int u = 0; u < kTileKeys / kStep; ++u) {
        const int j = tid / kChunks + u * kStep, kp = k0 + j;
        const bool ok = kp < k_hi;
        const size_t off = ok ? slot_of(kp) * D + c : 0;
        cp_async16(kt + j * kLd + c, kpool + off, ok);
        cp_async16(vt + j * kLd + c, vpool + off, ok);
      }
    } else {
      constexpr int kCC = D / 16;  // 16-byte chunks of codes a key
      constexpr int kStep = kThreads / kCC;
      unsigned char* kt = base;
      unsigned char* vt = base + S::code_tile;
      float* ks = reinterpret_cast<float*>(base + 2 * S::code_tile);
      const int c = tid % kCC * 16;
#pragma unroll
      for (int u = 0; u < kTileKeys / kStep; ++u) {
        const int j = tid / kCC + u * kStep, kp = k0 + j;
        const bool ok = kp < k_hi;
        const size_t off = ok ? slot_of(kp) * D + c : 0;
        cp_async16(kt + j * S::kLdc + c, kpool + off, ok);
        cp_async16(vt + j * S::kLdc + c, vpool + off, ok);
      }
      static_assert(2 * kTileKeys == kThreads, "a scale a thread");
      const int kp = k0 + tid % kTileKeys;
      const bool ok = kp < k_hi;
      cp_async4(ks + tid,
                (tid < kTileKeys ? ksc : vsc) + (ok ? slot_of(kp) : 0), ok);
    }
  };

  // K13: a stage's codes (exact in bf16) into the work tile
  auto convert = [&](const unsigned char* base) {
    constexpr int kCC = D / 16;
    bf16* wk = reinterpret_cast<bf16*>(smem + S::work);
    for (int i = tid; i < 2 * kTileKeys * kCC; i += kThreads) {
      const int v = i / (kTileKeys * kCC), w = i % (kTileKeys * kCC);
      const int j = w / kCC, c = w % kCC * 16;
      const uint4 codes = *reinterpret_cast<const uint4*>(
          base + v * S::code_tile + j * S::kLdc + c);
      const uint32_t cw[4] = {codes.x, codes.y, codes.z, codes.w};
      uint32_t w2[8];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        codes_to_bf16<TP>(cw[e], w2[2 * e], w2[2 * e + 1]);
      uint4* dst =
          reinterpret_cast<uint4*>(wk + v * kTileKeys * kLd + j * kLd + c);
      dst[0] = make_uint4(w2[0], w2[1], w2[2], w2[3]);
      dst[1] = make_uint4(w2[4], w2[5], w2[6], w2[7]);
    }
  };

  const int n_tiles = (k_hi - k_lo + kTileKeys - 1) / kTileKeys;
  load_tile(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_tile(1, 1);
  cp_async_commit();

  // rows: where a block may hold more than 16 rows, warp w takes rows
  // 16w .. 16w + 15; in a decode step every warp takes rows 0 .. 15 and
  // keys 16w .. 16w + 15 of each tile (grid-uniform: from the shapes)
  const bool key_split = C * rep <= 16;
  const int r0 = (key_split ? 0 : warp * 16) + g;
  const bool active = key_split || warp * 16 < n_rows;
  // the last key each of rows r0, r0 + 8 may see (its token's causal
  // limit, or the split's end; k_hi <= n_kv)
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lim[i] = min(ctx + q_start + (r0 + 8 * i) / rep, k_hi - 1);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kDB][4];
#pragma unroll
  for (int n = 0; n < kDB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // Q's A fragments straight from device memory (rows past n_rows zero)
  uint32_t qf[kKK][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const bool ok = active && r < n_rows;
    const bf16* src = q + (ok ? row_of(r) * D : 0) + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      qf[kk][i] = ok ? ld32(src + 16 * kk) : 0u;
      qf[kk][2 + i] = ok ? ld32(src + 16 * kk + 8) : 0u;
    }
  }
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();  // tile it is in; every reader of tile it - 1 is done
    if (it + 2 < n_tiles) load_tile(it + 2, (it + 2) % 3);
    cp_async_commit();
    const unsigned char* base = smem + it % 3 * S::stage;
    const bf16* kt = reinterpret_cast<const bf16*>(base);
    const float* ks = nullptr;
    if constexpr (kQuant) {  // codes converted, scales left in the stage
      convert(base);
      __syncthreads();
      kt = reinterpret_cast<const bf16*>(smem + S::work);
      ks = reinterpret_cast<const float*>(base + 2 * S::code_tile);
    }
    const bf16* vt = kt + kTileKeys * kLd;
    if (!active) continue;
    // scores: S = Q K^T, 16 rows x 64 keys (16 with the key split), f32
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (key_split && jp != warp) continue;
#pragma unroll
      for (int kk = 0; kk < kKK; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + (jp * 16 + mr + (mi >> 1) * 8) * kLd + kk * 16 +
                        (mi & 1) * 8);
        mma16816(sc[2 * jp], qf[kk], kb[0], kb[1]);
        mma16816(sc[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }
    // the softmax scale (and K13's key scale) on the f32 score; masked
    // scores, and keys of another warp, replaced, not multiplied
    const int k0 = k_lo + it * kTileKeys;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * t + e, kp = k0 + key;
        const bool mine = !key_split || j / 2 == warp;
        const float f = kQuant ? scale_log2 * ks[key] : scale_log2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float v =
              mine && kp <= lim[i] ? sc[j][2 * i + e] * f : kNegInf;
          sc[j][2 * i + e] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < kDB; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // probabilities (K13: times the value's scale after the row sum)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * t + e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x = sc[j][2 * i + e];
          const float p = x > kNegInf ? exp2f(x - m[i]) : 0.f;
          l[i] += p;
          sc[j][2 * i + e] = kQuant ? p * ks[kTileKeys + key] : p;
        }
      }
    // O += P V with P as bf16 hi + lo: two products, f32 sums
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) {
      if (key_split && kk != warp) continue;
      uint32_t ph[4], pl[4];
      split2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < kDB / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + (kk * 16 + mr + (mi & 1) * 8) * kLd + np * 16 +
                          (mi >> 1) * 8);
        mma16816(o[2 * np], ph, vb[0], vb[1]);
        mma16816(o[2 * np + 1], ph, vb[2], vb[3]);
        mma16816(o[2 * np], pl, vb[0], vb[1]);
        mma16816(o[2 * np + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (key_split) {
    // the four warps' (o, m, l) of rows 0 .. 15 through the drained ring,
    // combined by warp 0 in warp order
    float* cs = reinterpret_cast<float*>(smem);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = cs + (warp * 16 + g + 8 * i) * (D + 2);
#pragma unroll
      for (int n = 0; n < kDB; ++n)
        *reinterpret_cast<float2*>(row + 8 * n + 2 * t) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(row + D) = make_float2(m[i], l[i]);
    }
    __syncthreads();
    // warp 0 combines; warps 1 .. 3 go on to rows 16w + g, + 8: past
    // every token, zeros
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mw[4], big = kNegInf;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          mw[w] = cs[(w * 16 + g + 8 * i) * (D + 2) + D];
          big = fmaxf(big, mw[w]);
        }
#pragma unroll
        for (int n = 0; n < kDB; ++n) o[n][2 * i] = o[n][2 * i + 1] = 0.f;
        l[i] = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float* row = cs + (w * 16 + g + 8 * i) * (D + 2);
          const float s = exp2f(mw[w] - big);
          l[i] += s * row[D + 1];
#pragma unroll
          for (int n = 0; n < kDB; ++n) {
            const float2 v =
                *reinterpret_cast<const float2*>(row + 8 * n + 2 * t);
            o[n][2 * i] += s * v.x;
            o[n][2 * i + 1] += s * v.y;
          }
        }
        m[i] = big;
      }
    }
  }
  const int rw = key_split ? warp * 16 + g : r0;  // the rows written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rw + 8 * i, tok = q_start + r / rep;
    if (n_splits == 1) {
      if (r >= rows_used || tok >= C) continue;
      const float inv = tok < length ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
      bf16* dst = out + row_of(r) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kDB; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    } else {
      if (r >= n_rows) continue;
      const size_t row = split * n_rows_all + row_of(r);
      float* dst = o_part + row * D + 2 * t;
#pragma unroll
      for (int n = 0; n < kDB; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (t == 0) ml_part[row] = make_float2(m[i], l[i]);
    }
  }
}

// The split partials of every (slot, token, head) row merged in split
// order: out = sum_s o_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M the
// largest m_s; a split that saw no key of the row (m_s at its floor) is
// skipped, its o never read. Rows past a slot's length are zeros. One
// warp a row, D / 32 columns a lane.
template <int D>
__global__ void __launch_bounds__(kThreads)
    ragged_merge(const float* __restrict__ o_part,
                 const float2* __restrict__ ml_part,
                 const int* __restrict__ lengths, bf16* __restrict__ out,
                 int rows, int C, int H, int n_splits) {
  constexpr int kE = D / 32;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / (C * H), tok = row / H % C, length = lengths[b];
  float acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  if (tok < length) {
    float M = kNegInf, L = 0.f;
    for (int s = 0; s < n_splits; ++s)
      M = fmaxf(M, ml_part[(size_t)s * rows + row].x);
    for (int s = 0; s < n_splits; ++s) {
      const float2 ml = ml_part[(size_t)s * rows + row];
      if (ml.x <= kNegInf) continue;
      const float w = exp2f(ml.x - M);
      L += w * ml.y;
      const float* src = o_part + ((size_t)s * rows + row) * D + lane * kE;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] += w * src[e];
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= inv;
  }
  bf16* dst = out + (size_t)row * D + lane * kE;
#pragma unroll
  for (int e = 0; e < kE; e += 2)
    *reinterpret_cast<__nv_bfloat162*>(dst + e) =
        __floats2bfloat162_rn(acc[e], acc[e + 1]);
}

}  // namespace tc

// The pointers and sizes of one call; the key split (n_splits, split_len,
// the partials' scratch) is the wrapper's plan, used by the bf16 kernels
// at D 64 and 128
struct Args {
  const void *q, *kp, *vp, *ks, *vs, *tables, *ctx, *lengths;
  void* out;
  int B, C, H, KVH, num_pages, page, pages_per_seq;
  float scale;
  int n_splits, split_len;
  void *o_part, *ml_part;
};

template <typename TP, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr bool kQuant = !std::is_same<TP, __nv_bfloat16>::value;
  const int rep = a.H / a.KVH;
  if (a.n_splits < 1 || a.split_len < 1 ||
      (a.n_splits > 1 && (!a.o_part || !a.ml_part)))
    return cudaErrorInvalidValue;
  // the ring (and K13's work tile), then the split's table entries
  const uint32_t smem =
      tc::Smem<D, kQuant>::pages + 4 * (a.split_len / a.page + 2);
  auto kernel = tc::ragged_mma<TP, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int q_tokens = kRows / rep;
  const dim3 grid((a.C + q_tokens - 1) / q_tokens * a.n_splits, a.B,
                  a.KVH);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const TP*>(a.kp),
      static_cast<const TP*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.ctx), static_cast<const int*>(a.lengths),
      static_cast<bf16*>(a.out), static_cast<float*>(a.o_part),
      static_cast<float2*>(a.ml_part), a.C, a.H, a.num_pages, a.page,
      a.pages_per_seq, rep, a.scale * tc::kLog2e, a.split_len, a.n_splits);
  if ((e = cudaGetLastError()) != cudaSuccess || a.n_splits == 1) return e;
  const int rows = a.B * a.C * a.H, per = tc::kThreads / 32;
  tc::ragged_merge<D><<<(rows + per - 1) / per, tc::kThreads, 0, stream>>>(
      static_cast<const float*>(a.o_part),
      static_cast<const float2*>(a.ml_part),
      static_cast<const int*>(a.lengths), static_cast<bf16*>(a.out), rows,
      a.C, a.H, a.n_splits);
  return cudaGetLastError();
}

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

// f32 q: the CUDA-core body at every D; bf16 q: the tensor-core kernel
// at D 64 and 128, the CUDA-core body at D 32 and 256
template <typename T, typename TP>
cudaError_t launch_d(int D, const Args& a, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (D == 64) return launch_mma<TP, 64>(a, s);
    if (D == 128) return launch_mma<TP, 128>(a, s);
  } else {
    if (D == 64) return launch<T, TP, 64>(a, s);
    if (D == 128) return launch<T, TP, 128>(a, s);
  }
  if (D == 32) return launch<T, TP, 32>(a, s);
  if (D == 256) return launch<T, TP, 256>(a, s);
  return cudaErrorInvalidValue;
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
    int pages_per_seq, float scale, int dtype, int n_splits, int split_len,
    void* o_part, void* ml_part, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (!shape_ok(B, C, H, KVH)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,         key_pages, value_pages,   nullptr, nullptr,
               tables,    ctx,       lengths,       out,     B,
               C,         H,         KVH,           num_pages, page,
               pages_per_seq, scale, n_splits,      split_len, o_part,
               ml_part};
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
    int dtype, int pool, int n_splits, int split_len, void* o_part,
    void* ml_part, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (!shape_ok(B, C, H, KVH)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,         key_pages, value_pages,   k_scales, v_scales,
               tables,    ctx,       lengths,       out,      B,
               C,         H,         KVH,           num_pages, page,
               pages_per_seq, scale, n_splits,      split_len, o_part,
               ml_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kFloat32) return launch_pool<float>(pool, D, a, s);
  if (dtype == ptt::kBFloat16)
    return launch_pool<__nv_bfloat16>(pool, D, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
