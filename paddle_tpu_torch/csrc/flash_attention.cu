// Flash attention for Hopper: the forward (out and log-sum-exp) and the
// two backward kernels (dk/dv and dq), causal or not, with grouped-query
// heads, for the training path.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel
// (launched from _flash_fwd), ::_dkv_kernel and ::_dq_kernel (launched
// from _flash_bwd_pallas).
//
// Semantics (the plain versions are flash_attention_fwd_reference and
// flash_attention_bwd_reference in ops/kernels/flash_attention.py):
//   q [B, Sq, H, D], k/v [B, Sk, KVH, D], out [B, Sq, H, D] in the input
//   type, lse [B, H, Sq] f32. Query head h reads kv head h / (H / KVH);
//   the repeat of the JAX package is never materialised. Causal masking
//   is bottom-right aligned: key j is visible to query i iff
//   j <= i + Sk - Sq. A row with no visible key writes 0 and lse -1e30,
//   and its probabilities are masked to 0 in the backward (not computed
//   as exp(s - lse), which would be 1 there).
//   Backward, from the saved lse and delta = rowsum(dO * O) in f32:
//   p = exp(s*scale - lse), ds = p * (dO.V^T - delta) * scale,
//   dv = p^T dO, dk = ds^T q (summed over the query heads of a kv
//   head), dq = ds k.
//
// Bound on the H100: operations. At the training shapes (S = 2048,
// D = 128) the forward does 4*S^2*D/2 flops per head causal against
// 4*S*D*2 bytes: some 500 flops a byte, above the card's line. The
// backward's dkv kernel does 8*D flops a visible (query, key) pair and
// its dq kernel 6*D: 14*D, against 10*D for one fused kernel that
// recomputes nothing. The split stays: the fused kernel must add dq
// across key tiles with atomics, whose order changes from run to run;
// here every CTA writes its rows of dk, dv or dq once, and the gradients
// repeat bit for bit.
//
// Grids, the same for both types:
//   forward: one CTA per (q block, batch, q head), looping over the kv
//     tiles up to the block's last visible key (heaviest q blocks are
//     launched first; bf16 at D 64/128: one persistent CTA per SM walks
//     these items in that order); online softmax in f32.
//   dkv: one CTA per (kv block, batch, kv head), looping over the rep
//     query heads of that kv head and, for each, the q blocks from the
//     first one that can see the kv block; dk and dv accumulate across
//     all of them, so no atomics and no sum over repeated heads (kv
//     block 0, which every q block sees, is launched first).
//   dq: one CTA per (q block, batch, q head), looping over kv tiles.
//
// bf16 at D = 64 and 128, the training path (every model of the repo
// trains at D = 128): Hopper kernels for all three, warp-specialised (see
// the section "warp-specialised wgmma kernels" below and hopper.cuh). A
// producer warp TMA-loads 128-byte-swizzled tiles into a ring of stages
// behind mbarriers; two consumer warpgroups multiply them with wgmma,
// taking the probabilities and dS as A operands straight from the
// accumulator registers (dkv computes S^T and dP^T, keys as rows, so P^T
// and dS^T are already the A operands of dV += P^T dO and dK += dS^T Q).
// forward: persistent, a CTA per SM walking blocks of 128 queries (64 a
// warpgroup), heaviest first, with two Q buffers (the next block's Q
// lands during this one) and a ring of two (K, V) stages of 128 keys that
// runs on across blocks; S = Q K^T (SS, m64n128), the online softmax in
// f32 in registers (a row's 128 scores on the 4 lanes of a quad: two
// shuffles for its max; exp2 by the SFU alone), O += P V (RS, V read
// MN-major); O / l is rounded once and leaves through its Q buffer in
// 16-byte rows. dkv: 64 keys a CTA, the two warpgroups taking (Q, dO) stages of 64
// queries in turn and adding their dK and dV once at the end; dq: 128
// queries a CTA (64 a warpgroup) over (K, V) stages of 64 keys. What
// bounds them: registers, and each warpgroup's chain of products and
// exps. dK and dV at D = 128 are 128 f32 registers a consumer thread, so
// dkv's score tiles are m64n32 (S^T and dP^T 16 each) and its consumers
// need ~200 registers, which setmaxnreg provides (232, the producer 40).
// Within a warpgroup dP is multiplied while P is computed and dV while dS
// is (dkv also waits for a tile's dK under the next tile's scores); the
// two warpgroups overlap each other's softmax. The forward's chain stays
// S, softmax, P V: deferring P V under the next tile's softmax, and
// alternating the two warpgroups' products with named barriers, each ran
// slower on the card, as did 64-key stages; a third stage changed
// nothing. Making it persistent and taking exp2 from the SFU alone (no
// range handling) each helped.
//
// bf16 at D = 16 and 32 (no model of the repo trains at those widths; the
// card tests cover them): FlashAttention-2's register-resident design on
// mma.sync m16n8k16 (bf16 in, f32 accumulate). Four warps a CTA, each
// owning 16 rows (queries, or keys in dkv); K/V (or Q/dO) tiles sit in
// shared memory, padded so that every fragment load is free of bank
// conflicts; scores, probabilities and accumulators never leave
// registers: a score fragment becomes the next product's A operand as it
// is. 64-row CTAs over 64-key tiles (dkv: 32-query tiles); dkv
// double-buffers its Q/dO stages with cp.async.
//
// f32, for parity checks: the same grids on the CUDA cores in f32 (TF32
// would not meet their limits), 32 x 32 tiles staged through shared
// memory; every tile product goes through one routine (TileMM), the
// backward's dK, dV and dQ stay in registers (Acc).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// ---- f32: tiles staged through shared memory, CUDA-core products ------------

template <typename T>
struct Tiles;
template <>
struct Tiles<float> {
  static constexpr int kQ = 32, kK = 32;
};

// leading dimensions in shared memory, padded against bank conflicts and
// kept multiples of 16 bytes
template <typename T>
__host__ __device__ constexpr int ld_t(int cols) {
  return cols + 16 / (int)sizeof(T);
}
__host__ __device__ constexpr int ld_f(int cols) { return cols + 4; }

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// C[M][N] (f32, ldc) (+)= op(A) * op(B) with op(A) [M][Kd], op(B) [Kd][N].
// kTA: A is stored [Kd][M] (its transpose, lda); else [M][Kd].
// kTB: B is stored [N][Kd] (its transpose, ldb); else [Kd][N].
template <typename T, int M, int N, int Kd, bool kTA, bool kTB>
struct TileMM;

template <int M, int N, int Kd, bool kTA, bool kTB>
struct TileMM<float, M, N, Kd, kTA, kTB> {
  static __device__ __forceinline__ void run(const float* A, int lda,
                                             const float* B, int ldb,
                                             float* C, int ldc,
                                             bool accumulate) {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int r = idx / N, c = idx % N;
      float s = accumulate ? C[r * ldc + c] : 0.f;
#pragma unroll 8
      for (int k = 0; k < Kd; ++k) {
        const float a = kTA ? A[k * lda + r] : A[r * lda + k];
        const float b = kTB ? B[c * ldb + k] : B[k * ldb + c];
        s = fmaf(a, b, s);
      }
      C[r * ldc + c] = s;
    }
  }
};

// An M x N f32 accumulator kept in registers across a loop of tile
// products (the backward's dK, dV and dQ, which need no rescaling):
// thread t owns elements t, t + 256, ... . mma() adds op(A) * op(B) as
// TileMM does; store() writes rows row0.. of one head of a
// [B, S, heads, D] tensor.
template <typename T, int M, int N>
struct Acc;

template <int M, int N>
struct Acc<float, M, N> {
  static constexpr int kPer = (M * N + kThreads - 1) / kThreads;
  float c[kPer];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kPer; ++i) c[i] = 0.f;
  }

  template <int Kd, bool kTA, bool kTB>
  __device__ __forceinline__ void mma(const float* A, int lda,
                                      const float* B, int ldb) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < M * N) {
        const int r = idx / N, col = idx % N;
        float s = c[i];
#pragma unroll 8
        for (int k = 0; k < Kd; ++k) {
          const float a = kTA ? A[k * lda + r] : A[r * lda + k];
          const float b = kTB ? B[col * ldb + k] : B[k * ldb + col];
          s = fmaf(a, b, s);
        }
        c[i] = s;
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, size_t stride, int row0,
                                        int n_valid) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / N, col = idx % N;
      if (idx < M * N && row0 + r < n_valid)
        dst[(size_t)(row0 + r) * stride + col] = c[i];
    }
  }
};

// rows [row0, row0 + ROWS) of one head of a [B, S, heads, D] tensor
// (src points at (b, 0, head, 0); rows are `stride` elements apart) into
// shared memory [ROWS][ld]; rows at or past n_valid are zero
template <typename T, int ROWS, int D, int NT = kThreads>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          size_t stride, int row0,
                                          int n_valid) {
  constexpr int V = ptt::Vec<T>::N;
  constexpr int kPerRow = D / V;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow, c = (i % kPerRow) * V;
    ptt::Vec<T> val;
    if (row0 + r < n_valid) {
      val = *reinterpret_cast<const ptt::Vec<T>*>(src + (size_t)(row0 + r) *
                                                            stride + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) val.v[e] = ptt::from_f<T>(0.f);
    }
    *reinterpret_cast<ptt::Vec<T>*>(dst + r * ld + c) = val;
  }
}

// f32 accumulator rows [0, ROWS) to rows row0.. of one head of a
// [B, S, heads, D] tensor, each times mul[r] (or 1), rows past n_valid
// skipped
template <typename T, int ROWS, int D>
__device__ __forceinline__ void store_rows(T* dst, size_t stride, int row0,
                                           int n_valid, const float* acc,
                                           int ld, const float* mul) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (row0 + r < n_valid) {
      const float m = mul ? mul[r] : 1.f;
      dst[(size_t)(row0 + r) * stride + c] = ptt::from_f<T>(acc[r * ld + c] * m);
    }
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int sq, int sk,
                                        int offset, bool causal) {
  return qp < sq && kp < sk && (!causal || kp <= qp + offset);
}

// kv tiles a q block [q0, q0 + BQ) needs: up to its last visible key
__device__ __forceinline__ int kv_tiles(int q0, int bq, int bk, int sk,
                                        int offset, bool causal) {
  const int all = (sk + bk - 1) / bk;
  if (!causal) return all;
  const int last = q0 + bq + offset;  // one past the last visible key
  if (last <= 0) return 0;
  return min((last + bk - 1) / bk, all);
}

// ---- forward ---------------------------------------------------------------

template <typename T, int D>
struct FwdSmem {
  static constexpr int BQ = Tiles<T>::kQ, BK = Tiles<T>::kK;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * BQ * ld_t<T>(D));
  static constexpr size_t v = k + align128(sizeof(T) * BK * ld_t<T>(D));
  static constexpr size_t s = v + align128(sizeof(T) * BK * ld_t<T>(D));
  static constexpr size_t p = s + align128(sizeof(float) * BQ * ld_f(BK));
  static constexpr size_t o = p + align128(sizeof(T) * BQ * ld_t<T>(BK));
  static constexpr size_t l = o + align128(sizeof(float) * BQ * ld_f(D));
  static constexpr size_t bytes = l + align128(sizeof(float) * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                     float scale, bool causal) {
  using L = FwdSmem<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int kRowsPerWarp = BQ / kWarps;
  constexpr int kColsPerLane = BK / 32;
  constexpr int LDT = ld_t<T>(D), LDP = ld_t<T>(BK), LDS = ld_f(BK),
                LDO = ld_f(D);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);
  float* ls = reinterpret_cast<float*>(smem + L::l);

  // heaviest (last) q blocks first under causal masking
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y, h = blockIdx.z;
  const int hk = h / (H / KVH);
  const int q0 = qb * BQ;
  const int offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const T* qh = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kh = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const T* vh = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;

  load_rows<T, BQ, D>(qs, LDT, qh, q_stride, q0, Sq);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads)
    os[(i / D) * LDO + i % D] = 0.f;
  float m_r[kRowsPerWarp], l_r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }

  const int n_tiles = kv_tiles(q0, BQ, BK, Sk, offset, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, BK, D>(ks, LDT, kh, kv_stride, k0, Sk);
    load_rows<T, BK, D>(vs, LDT, vh, kv_stride, k0, Sk);
    __syncthreads();
    TileMM<T, BQ, BK, D, false, true>::run(qs, LDT, ks, LDT, ss, LDS, false);
    __syncthreads();
    // online softmax: warp w owns rows w*kRowsPerWarp.., lane the columns
    // lane + 32*j; it also rescales its rows of O
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      float sv[kColsPerLane];
      bool ok[kColsPerLane];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        ok[j] = visible(q0 + r, k0 + c, Sq, Sk, offset, causal);
        sv[j] = ok[j] ? ss[r * LDS + c] * scale : kNegInf;
        mt = fmaxf(mt, sv[j]);
      }
      const float m_new = fmaxf(m_r[i], ptt::warp_max(mt));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const float p = ok[j] ? expf(sv[j] - m_new) : 0.f;
        sum += p;
        ps[r * LDP + lane + 32 * j] = ptt::from_f<T>(p);
      }
      const float alpha = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha + ptt::warp_sum(sum);
      m_r[i] = m_new;
      for (int c = lane; c < D; c += 32) os[r * LDO + c] *= alpha;
    }
    __syncthreads();
    TileMM<T, BQ, D, BK, false, false>::run(ps, LDP, vs, LDT, os, LDO, true);
  }
  // 1 / l per row and lse; a row that saw no key has l = 0: out 0
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (lane == 0) {
      const float l = fmaxf(l_r[i], 1e-30f);
      ls[r] = l_r[i] > 0.f ? 1.f / l : 0.f;
      if (q0 + r < Sq)
        lse[((size_t)b * H + h) * Sq + q0 + r] =
            l_r[i] > 0.f ? m_r[i] + logf(l) : kNegInf;
    }
  }
  __syncthreads();
  store_rows<T, BQ, D>(out + (size_t)b * Sq * q_stride + (size_t)h * D,
                       q_stride, q0, Sq, os, LDO, ls);
}

// ---- backward: shared pieces -------------------------------------------------

// p and ds of one (q tile, kv tile) pair from S = Q K^T and dP = dO V^T
// (f32 in shared memory), into P and dS (type T); masked entries are 0
template <typename T, int BQ, int BK>
__device__ __forceinline__ void bwd_probs(const float* ss, const float* dps,
                                          int lds, T* ps, T* dss, int ldp,
                                          const float* lse_s,
                                          const float* delta_s, int q0,
                                          int k0, int Sq, int Sk, int offset,
                                          bool causal, float scale) {
  for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
    const int r = i / BK, c = i % BK;
    float p = 0.f, ds = 0.f;
    if (visible(q0 + r, k0 + c, Sq, Sk, offset, causal)) {
      p = expf(ss[r * lds + c] * scale - lse_s[r]);
      ds = p * (dps[r * lds + c] - delta_s[r]) * scale;
    }
    if (ps) ps[r * ldp + c] = ptt::from_f<T>(p);
    dss[r * ldp + c] = ptt::from_f<T>(ds);
  }
}

// lse and delta of rows q0.. of head h ([B, H, Sq] f32) into shared memory
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse,
                                           const float* delta, size_t base,
                                           int q0, int rows, int Sq) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const bool ok = q0 + r < Sq;
    lse_s[r] = ok ? lse[base + q0 + r] : 0.f;
    delta_s[r] = ok ? delta[base + q0 + r] : 0.f;
  }
}

// ---- dk, dv ------------------------------------------------------------------

template <typename T, int D>
struct DkvSmem {
  static constexpr int BQ = Tiles<T>::kQ, BK = Tiles<T>::kK;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + align128(sizeof(T) * BK * ld_t<T>(D));
  static constexpr size_t q = v + align128(sizeof(T) * BK * ld_t<T>(D));
  static constexpr size_t g = q + align128(sizeof(T) * BQ * ld_t<T>(D));
  static constexpr size_t s = g + align128(sizeof(T) * BQ * ld_t<T>(D));
  static constexpr size_t dp = s + align128(sizeof(float) * BQ * ld_f(BK));
  static constexpr size_t p = dp + align128(sizeof(float) * BQ * ld_f(BK));
  static constexpr size_t ds = p + align128(sizeof(T) * BQ * ld_t<T>(BK));
  static constexpr size_t st = ds + align128(sizeof(T) * BQ * ld_t<T>(BK));
  static constexpr size_t bytes = st + align128(sizeof(float) * 2 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                     float scale, bool causal) {
  using L = DkvSmem<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int LDT = ld_t<T>(D), LDP = ld_t<T>(BK), LDS = ld_f(BK);
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* gs = reinterpret_cast<T*>(smem + L::g);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  T* dss = reinterpret_cast<T*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::st);
  float* delta_s = lse_s + BQ;

  // kv block 0 sees every q block under causal masking: launch it first
  const int kb = blockIdx.x;
  const int b = blockIdx.y, hk = blockIdx.z;
  const int rep = H / KVH;
  const int k0 = kb * BK;
  const int offset = Sk - Sq;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  load_rows<T, BK, D>(ks, LDT, k + (size_t)b * Sk * kv_stride + hk * D,
                      kv_stride, k0, Sk);
  load_rows<T, BK, D>(vs, LDT, v + (size_t)b * Sk * kv_stride + hk * D,
                      kv_stride, k0, Sk);
  Acc<T, BK, D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  const int n_qb = (Sq + BQ - 1) / BQ;
  // first q block whose last row can see key k0
  int first = 0;
  if (causal) first = k0 - offset <= 0 ? 0 : min((k0 - offset) / BQ, n_qb);

  for (int hq = hk * rep; hq < (hk + 1) * rep; ++hq) {
    const T* qh = q + (size_t)b * Sq * q_stride + (size_t)hq * D;
    const T* gh = dout + (size_t)b * Sq * q_stride + (size_t)hq * D;
    const size_t st_base = ((size_t)b * H + hq) * Sq;
    for (int qb = first; qb < n_qb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous q block's readers are done
      load_rows<T, BQ, D>(qs, LDT, qh, q_stride, q0, Sq);
      load_rows<T, BQ, D>(gs, LDT, gh, q_stride, q0, Sq);
      load_stats(lse_s, delta_s, lse, delta, st_base, q0, BQ, Sq);
      __syncthreads();
      TileMM<T, BQ, BK, D, false, true>::run(qs, LDT, ks, LDT, ss, LDS,
                                             false);
      TileMM<T, BQ, BK, D, false, true>::run(gs, LDT, vs, LDT, dps, LDS,
                                             false);
      __syncthreads();
      bwd_probs<T, BQ, BK>(ss, dps, LDS, ps, dss, LDP, lse_s, delta_s, q0, k0,
                           Sq, Sk, offset, causal, scale);
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q
      dv_acc.template mma<BQ, true, false>(ps, LDP, gs, LDT);
      dk_acc.template mma<BQ, true, false>(dss, LDP, qs, LDT);
    }
  }
  dk_acc.store(dk + (size_t)b * Sk * kv_stride + hk * D, kv_stride, k0, Sk);
  dv_acc.store(dv + (size_t)b * Sk * kv_stride + hk * D, kv_stride, k0, Sk);
}

// ---- dq ----------------------------------------------------------------------

template <typename T, int D>
struct DqSmem {
  static constexpr int BQ = Tiles<T>::kQ, BK = Tiles<T>::kK;
  static constexpr size_t q = 0;
  static constexpr size_t g = q + align128(sizeof(T) * BQ * ld_t<T>(D));
  static constexpr size_t k = g + align128(sizeof(T) * BQ * ld_t<T>(D));
  static constexpr size_t v = k + align128(sizeof(T) * BK * ld_t<T>(D));
  static constexpr size_t s = v + align128(sizeof(T) * BK * ld_t<T>(D));
  static constexpr size_t dp = s + align128(sizeof(float) * BQ * ld_f(BK));
  static constexpr size_t ds = dp + align128(sizeof(float) * BQ * ld_f(BK));
  static constexpr size_t st = ds + align128(sizeof(T) * BQ * ld_t<T>(BK));
  static constexpr size_t bytes = st + align128(sizeof(float) * 2 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int KVH, float scale,
                    bool causal) {
  using L = DqSmem<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  constexpr int LDT = ld_t<T>(D), LDP = ld_t<T>(BK), LDS = ld_f(BK);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* gs = reinterpret_cast<T*>(smem + L::g);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  T* dss = reinterpret_cast<T*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::st);
  float* delta_s = lse_s + BQ;

  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y, h = blockIdx.z;
  const int hk = h / (H / KVH);
  const int q0 = qb * BQ;
  const int offset = Sk - Sq;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const T* kh = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const T* vh = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  load_rows<T, BQ, D>(qs, LDT, q + (size_t)b * Sq * q_stride + h * D,
                      q_stride, q0, Sq);
  load_rows<T, BQ, D>(gs, LDT, dout + (size_t)b * Sq * q_stride + h * D,
                      q_stride, q0, Sq);
  load_stats(lse_s, delta_s, lse, delta, ((size_t)b * H + h) * Sq, q0, BQ,
             Sq);
  Acc<T, BQ, D> dq_acc;
  dq_acc.zero();

  const int n_tiles = kv_tiles(q0, BQ, BK, Sk, offset, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_rows<T, BK, D>(ks, LDT, kh, kv_stride, k0, Sk);
    load_rows<T, BK, D>(vs, LDT, vh, kv_stride, k0, Sk);
    __syncthreads();
    TileMM<T, BQ, BK, D, false, true>::run(qs, LDT, ks, LDT, ss, LDS, false);
    TileMM<T, BQ, BK, D, false, true>::run(gs, LDT, vs, LDT, dps, LDS, false);
    __syncthreads();
    bwd_probs<T, BQ, BK>(ss, dps, LDS, (T*)nullptr, dss, LDP, lse_s, delta_s,
                         q0, k0, Sq, Sk, offset, causal, scale);
    __syncthreads();
    // dq += dS K
    dq_acc.template mma<BK, false, false>(dss, LDP, ks, LDT);
  }
  dq_acc.store(dq + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0,
               Sq);
}

// ---- bf16: register-resident mma.sync kernels -------------------------------
//
// mma.sync m16n8k16 fragments (lane = 4 g + t): A (16 x 16, row-major)
// a0 = A[g][2t, 2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
// a3 = A[g+8][2t+8..]; B (16 x 8) b0 = B[2t, 2t+1][g], b1 = B[2t+8..][g];
// C (16 x 8, f32) c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// Two C fragments side by side (16 columns) are, once rounded to bf16,
// the A fragment of the next product over those 16 columns (c_to_a).
// Shared-memory rows are D + 8 elements long: the rows a warp reads for
// one fragment then fall in distinct banks.

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // four warps
constexpr int kMmaRows = 64;      // rows a CTA owns: 16 a warp
constexpr int kMmaKeys = 64;      // keys a forward or dq tile holds
constexpr int kMmaQ = 32;         // queries a dkv tile holds

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of rows r0.., columns k0.. of a row-major tile X
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* X, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = X + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment with B[k][n] = Y[n0 + n][k0 + k]: rows of Y (K for Q K^T)
__device__ __forceinline__ void frag_b_rows(uint32_t b[2], const bf16* Y,
                                            int ld, int n0, int k0, int g,
                                            int t) {
  const bf16* p = Y + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment with B[k][n] = Z[k0 + k][n0 + n]: down the columns of Z (V
// for P V), two 16-bit loads a register
__device__ __forceinline__ void frag_b_cols(uint32_t b[2], const bf16* Z,
                                            int ld, int k0, int n0, int g,
                                            int t) {
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(Z + (k0 + 2 * t) * ld + n0 + g);
  b[0] = (uint32_t)p[0] | ((uint32_t)p[ld] << 16);
  b[1] = (uint32_t)p[8 * ld] | ((uint32_t)p[9 * ld] << 16);
}

__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}

// accumulator fragments [D/8][4] of a warp's 16 rows to rows r, r + 8 of
// one head of a [B, S, heads, D] tensor (dst at row 0 of that head), each
// times mul[0] or mul[1]; rows at or past n_valid skipped
template <int DB>
__device__ __forceinline__ void store_frags(bf16* dst, size_t stride, int r,
                                            int n_valid, const float (*acc)[4],
                                            const float mul[2], int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= n_valid) continue;
    bf16* out = dst + (size_t)row * stride + 2 * t;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<uint32_t*>(out + db * 8) =
          pack2(acc[db][2 * half] * mul[half],
                acc[db][2 * half + 1] * mul[half]);
  }
}

// cp.async: 16 (or 4) bytes from global to shared memory without a trip
// through registers. Each stage's copies form one commit group, and
// cp_async_wait<1> waits for all but the newest group: the next stage
// streams in while the current one is multiplied.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// load_rows through cp.async; rows at or past n_valid are zeroed with
// plain stores (visible after the next __syncthreads)
template <int ROWS, int D>
__device__ __forceinline__ void async_rows(bf16* dst, int ld,
                                           const bf16* src, size_t stride,
                                           int row0, int n_valid) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    bf16* d = dst + r * ld + c;
    if (row0 + r < n_valid)
      cp_async16(d, src + (size_t)(row0 + r) * stride + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out,
                   float* __restrict__ lse, int Sq, int Sk, int H, int KVH,
                   float scale, bool causal) {
  constexpr int LD = D + 8, KK = D / 16, DB = D / 8, NB = kMmaKeys / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kMmaRows * LD;
  bf16* vs = ks + kMmaKeys * LD;
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y, h = blockIdx.z, hk = h / (H / KVH);
  const int q0 = qb * kMmaRows, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = q0 + warp * 16 + g;  // this thread's rows: r and r + 8
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const bf16* kh = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const bf16* vh = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  load_rows<bf16, kMmaRows, D, kMmaThreads>(
      qs, LD, q + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, q0,
      Sq);
  __syncthreads();
  uint32_t qa[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) frag_a(qa[kk], qs, LD, warp * 16, kk * 16, g, t);
  float o[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  // running max (finite, so exp of a difference is never NaN) and this
  // thread's part of the row sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int n_tiles = kv_tiles(q0, kMmaRows, kMmaKeys, Sk, offset, causal);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kMmaKeys;
    __syncthreads();  // the previous tile's readers are done
    load_rows<bf16, kMmaKeys, D, kMmaThreads>(ks, LD, kh, kv_stride, k0, Sk);
    load_rows<bf16, kMmaKeys, D, kMmaThreads>(vs, LD, vh, kv_stride, k0, Sk);
    __syncthreads();
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t bk[2];
        frag_b_rows(bk, ks, LD, nb * 8, kk * 16, g, t);
        mma16816(s[nb], qa[kk], bk);
      }
    }
    // masked scores are -inf: exp gives 0 against the finite max
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + nb * 8 + 2 * t + (e & 1);
        s[nb][e] = visible(r + 8 * (e >> 1), kp, Sq, Sk, offset, causal)
                       ? s[nb][e] * scale
                       : __int_as_float(0xff800000);  // -inf
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nb][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the quad holds the row's columns
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        l[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      o[db][0] *= alpha[0];
      o[db][1] *= alpha[0];
      o[db][2] *= alpha[1];
      o[db][3] *= alpha[1];
    }
    // O += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        uint32_t bv[2];
        frag_b_cols(bv, vs, LD, kc * 16, db * 8, g, t);
        mma16816(o[db], pa, bv);
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no visible key: 0
    const int row = r + 8 * i;
    if (t == 0 && row < Sq)
      lse[((size_t)b * H + h) * Sq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
  }
  store_frags<DB>(out + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride,
                  r, Sq, o, inv, t);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq,
                  int Sq, int Sk, int H, int KVH, float scale, bool causal) {
  constexpr int LD = D + 8, KK = D / 16, DB = D / 8, NB = kMmaKeys / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + kMmaRows * LD;
  bf16* ks = gs + kMmaRows * LD;
  bf16* vs = ks + kMmaKeys * LD;
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y, h = blockIdx.z, hk = h / (H / KVH);
  const int q0 = qb * kMmaRows, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = q0 + warp * 16 + g;
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const bf16* kh = k + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const bf16* vh = v + (size_t)b * Sk * kv_stride + (size_t)hk * D;
  const size_t head = (size_t)b * Sq * q_stride + (size_t)h * D;
  load_rows<bf16, kMmaRows, D, kMmaThreads>(qs, LD, q + head, q_stride, q0,
                                            Sq);
  load_rows<bf16, kMmaRows, D, kMmaThreads>(gs, LD, dout + head, q_stride,
                                            q0, Sq);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r + 8 * i;
    const size_t at = ((size_t)b * H + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    delta_r[i] = row < Sq ? delta[at] : 0.f;
  }
  float acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
    acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.f;

  const int n_tiles = kv_tiles(q0, kMmaRows, kMmaKeys, Sk, offset, causal);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kMmaKeys;
    __syncthreads();
    load_rows<bf16, kMmaKeys, D, kMmaThreads>(ks, LD, kh, kv_stride, k0, Sk);
    load_rows<bf16, kMmaKeys, D, kMmaThreads>(vs, LD, vh, kv_stride, k0, Sk);
    __syncthreads();
    // S = Q K^T and dP = dO V^T
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t aq[4], ag[4];
      frag_a(aq, qs, LD, warp * 16, kk * 16, g, t);
      frag_a(ag, gs, LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        uint32_t bk[2], bv[2];
        frag_b_rows(bk, ks, LD, nb * 8, kk * 16, g, t);
        frag_b_rows(bv, vs, LD, nb * 8, kk * 16, g, t);
        mma16816(s[nb], aq, bk);
        mma16816(dp[nb], ag, bv);
      }
    }
    // dS = P * (dP - delta) * scale into s; masked entries 0
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = k0 + nb * 8 + 2 * t + (e & 1);
        float ds = 0.f;
        if (visible(r + 8 * i, kp, Sq, Sk, offset, causal)) {
          const float p = expf(s[nb][e] * scale - lse_r[i]);
          ds = p * (dp[nb][e] - delta_r[i]) * scale;
        }
        s[nb][e] = ds;
      }
    // dQ += dS K
#pragma unroll
    for (int kc = 0; kc < NB / 2; ++kc) {
      uint32_t da[4];
      c_to_a(da, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        uint32_t bk[2];
        frag_b_cols(bk, ks, LD, kc * 16, db * 8, g, t);
        mma16816(acc[db], da, bk);
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_frags<DB>(dq + head, q_stride, r, Sq, acc, one, t);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Sq, int Sk, int H, int KVH,
                   float scale, bool causal) {
  constexpr int LD = D + 8, KK = D / 16, DB = D / 8, NQ = kMmaQ / 8;
  // one stage: Q and dO tiles, then lse and delta of their rows
  constexpr int kStage = 2 * kMmaQ * LD + 2 * kMmaQ * 2;  // in bf16 units
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kMmaRows * LD;
  bf16* stage0 = vs + kMmaRows * LD;
  // kv block 0 sees every q block under causal masking: launched first
  const int b = blockIdx.y, hk = blockIdx.z;
  const int rep = H / KVH;
  const int k0 = blockIdx.x * kMmaRows, offset = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = k0 + warp * 16 + g;  // this thread's keys: r and r + 8
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const size_t kv_head = (size_t)b * Sk * kv_stride + (size_t)hk * D;
  async_rows<kMmaRows, D>(ks, LD, k + kv_head, kv_stride, k0, Sk);
  async_rows<kMmaRows, D>(vs, LD, v + kv_head, kv_stride, k0, Sk);
  float dk_acc[DB][4], dv_acc[DB][4];
#pragma unroll
  for (int db = 0; db < DB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[db][e] = dv_acc[db][e] = 0.f;
  const int n_qb = (Sq + kMmaQ - 1) / kMmaQ;
  // first q block whose last row can see key k0
  int first = 0;
  if (causal) first = k0 - offset <= 0 ? 0 : min((k0 - offset) / kMmaQ, n_qb);

  // the (query head, q block) pairs in order, one stage each
  const int per_head = n_qb - first, n_iter = rep * per_head;
  auto fetch = [&](int it) {  // Q, dO, lse and delta of a pair
    const int hq = hk * rep + it / per_head;
    const int q0 = (first + it % per_head) * kMmaQ;
    const size_t head = (size_t)b * Sq * q_stride + (size_t)hq * D;
    const size_t st_base = ((size_t)b * H + hq) * Sq;
    bf16* qd = stage0 + (it & 1) * kStage;
    async_rows<kMmaQ, D>(qd, LD, q + head, q_stride, q0, Sq);
    async_rows<kMmaQ, D>(qd + kMmaQ * LD, LD, dout + head, q_stride, q0,
                         Sq);
    float* st = reinterpret_cast<float*>(qd + 2 * kMmaQ * LD);
    if (threadIdx.x < 2 * kMmaQ) {
      const int i = threadIdx.x % kMmaQ, row = q0 + i;
      const float* src = threadIdx.x < kMmaQ ? lse : delta;
      float* dst = st + threadIdx.x;
      if (row < Sq)
        cp_async4(dst, src + st_base + row);
      else
        *dst = 0.f;
    }
  };
  if (n_iter > 0) fetch(0);
  cp_async_commit();  // with K and V

  for (int it = 0; it < n_iter; ++it) {
    const int q0 = (first + it % per_head) * kMmaQ;
    if (it + 1 < n_iter) fetch(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this pair's group has landed
    __syncthreads();
    const bf16* qs = stage0 + (it & 1) * kStage;
    const bf16* gs = qs + kMmaQ * LD;
    const float* lse_s = reinterpret_cast<const float*>(gs + kMmaQ * LD);
    const float* delta_s = lse_s + kMmaQ;
    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's keys
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, ks, LD, warp * 16, kk * 16, g, t);
      frag_a(av, vs, LD, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb) {
        uint32_t bq[2], bg[2];
        frag_b_rows(bq, qs, LD, nb * 8, kk * 16, g, t);
        frag_b_rows(bg, gs, LD, nb * 8, kk * 16, g, t);
        mma16816(st[nb], ak, bq);
        mma16816(dpt[nb], av, bg);
      }
    }
    // P^T into st and dS^T into dpt; masked entries 0
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + 2 * t + (e & 1);
        float p = 0.f, ds = 0.f;
        if (visible(q0 + col, r + 8 * (e >> 1), Sq, Sk, offset, causal)) {
          p = expf(st[nb][e] * scale - lse_s[col]);
          ds = p * (dpt[nb][e] - delta_s[col]) * scale;
        }
        st[nb][e] = p;
        dpt[nb][e] = ds;
      }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kc = 0; kc < NQ / 2; ++kc) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kc], st[2 * kc + 1]);
      c_to_a(da, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int db = 0; db < DB; ++db) {
        uint32_t bg[2], bq[2];
        frag_b_cols(bg, gs, LD, kc * 16, db * 8, g, t);
        frag_b_cols(bq, qs, LD, kc * 16, db * 8, g, t);
        mma16816(dv_acc[db], pa, bg);
        mma16816(dk_acc[db], da, bq);
      }
    }
    __syncthreads();  // this stage's readers are done before its refill
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f};
  store_frags<DB>(dk + kv_head, kv_stride, r, Sk, dk_acc, one, t);
  store_frags<DB>(dv + kv_head, kv_stride, r, Sk, dv_acc, one, t);
}

// ---- bf16 at D 64 and 128: warp-specialised wgmma kernels -------------------
//
// Three warpgroups a CTA. Warpgroups 0 and 1 are the consumers: they
// raise their registers to 232 (setmaxnreg) and run the products as
// wgmma, the score-like products from shared memory (SS) and the products
// with the probabilities or dS as A from registers (RS). Warpgroup 2 is
// the producer: it lowers its registers to 40, and its first warp fills a
// ring of stages guarded by a full and an empty mbarrier each, one thread
// issuing the TMA loads of the tiles and, in the backward, the warp's
// lanes copying the per-row lse and delta (rows of [B, H, Sq] f32 start
// on any 4 bytes; TMA wants 16). Shared-memory tiles follow the layout
// conventions of hopper.cuh.

namespace hw = ptt::hopper;

constexpr int kWsThreads = 384;  // two consumer warpgroups, one producer
constexpr int kProducer = 256;   // the producer warpgroup's first thread
constexpr int kBox = 64;         // columns of one TMA box: 128 bytes of bf16
constexpr uint32_t kRowBytes = 128;
constexpr int kStages = 2;  // dq's ring
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kHalf = 32;  // queries of one dkv score tile

__host__ __device__ constexpr uint32_t align1024(uint32_t n) {
  return (n + 1023) / 1024 * 1024;
}

// K-major (a k16 step is 32 bytes along the row) and MN-major (a k16
// step is 16 rows) descriptors of the 128-byte swizzled boxes; box_bytes
// is the distance to the next 64 columns
__device__ __forceinline__ uint64_t kmajor(uint32_t box0, uint32_t box_bytes,
                                           int kk) {
  return hw::sw128_desc(box0 + (kk / 4) * box_bytes + (kk % 4) * 32, 16,
                        1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t box0,
                                            uint32_t box_bytes, int kc) {
  return hw::sw128_desc(box0 + kc * 16 * kRowBytes, box_bytes, 1024);
}

// the A fragment of k16 step kc of an m64nN accumulator d (hopper.cuh):
// its 8-column blocks 2kc and 2kc + 1 are two mma.sync C fragments
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float* d) {
  c_to_a(a, d, d + 4);
}

// rows r and r + 8 of an m64nD accumulator (this thread's part) to one
// head of a [B, S, heads, D] tensor: its layout is store_frags's
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, size_t stride, int r,
                                          int n_valid, const float* acc,
                                          int t) {
  const float one[2] = {1.f, 1.f};
  store_frags<D / 8>(dst, stride, r, n_valid,
                     reinterpret_cast<const float(*)[4]>(acc), one, t);
}

// dkv: a CTA holds 64 keys (K and V loaded once) and streams (Q, dO, lse,
// delta) stages of 64 queries, for every query head of its kv head. The
// two consumer warpgroups take the stages in turn, each summing its own
// dK and dV for the 64 keys in registers (2 x 64 x D f32); at the end the
// second hands its sums to the first through shared memory, which adds
// them in a fixed order and stores: no atomics, the same bits every run.
template <int D>
struct DkvWs {
  static constexpr int BK = 64, BQ = 64, NB = D / kBox;
  static constexpr int kRing = 4;  // stages: two a consumer warpgroup
  static constexpr uint32_t kv_box = BK * kRowBytes, q_box = BQ * kRowBytes;
  static constexpr uint32_t k = 0, v = NB * kv_box, stage0 = 2 * NB * kv_box;
  // one stage: Q boxes, dO boxes, lse (in log2 units), delta
  static constexpr uint32_t s_g = NB * q_box, s_lse = 2 * NB * q_box,
                            s_delta = s_lse + BQ * 4;
  static constexpr uint32_t stage = align1024(s_delta + BQ * 4);
  static constexpr uint32_t bars = stage0 + kRing * stage;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kRing) + 1024;
  static constexpr uint32_t tx_kv = 2 * BK * D * 2;
  static constexpr uint32_t tx_stage = 2 * BQ * D * 2;  // Q and dO
  static_assert(kRing * stage >= 2 * 64 * D * sizeof(float),
                "the stages hold the second warpgroup's sums at the end");
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_g,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                    int Sk, int H, int KVH, float scale, bool causal) {
  using L = DkvWs<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // barriers: K/V landed, full[kRing], empty[kRing]
  const uint32_t bar_kv = base + L::bars;
  const uint32_t full0 = bar_kv + 8, empty0 = full0 + 8 * L::kRing;

  // key tile 0 sees every query under causal masking: launched first
  const int b = blockIdx.y, hk = blockIdx.z, rep = H / KVH;
  const int k0 = blockIdx.x * L::BK, offset = Sk - Sq;
  const int n_qb = (Sq + L::BQ - 1) / L::BQ;
  // first q block whose last row can see key k0
  int first = 0;
  if (causal) first = k0 - offset <= 0 ? 0 : min((k0 - offset) / L::BQ, n_qb);
  // the (query head, q block) pairs in order, one stage each
  const int per_head = n_qb - first, n_iter = rep * per_head;

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_kv, 1);
    for (int s = 0; s < L::kRing; ++s) {
      hw::mbar_init(full0 + 8 * s, 32);  // the producer warp's lanes
      hw::mbar_init(empty0 + 8 * s, 4);  // the consuming warpgroup's warps
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (hw::warpgroup_idx() == 2) {  // the producer warpgroup: one warp loads
    hw::setmaxnreg_dec<40>();
    const int lane = threadIdx.x - kProducer;
    if (lane == 0) {
      hw::mbar_arrive_expect_tx(bar_kv, L::tx_kv);
      for (int c = 0; c < L::NB; ++c) {
        hw::tma_load_4d(base + L::k + c * L::kv_box, &tm_k, bar_kv, c * kBox,
                        hk, k0, b);
        hw::tma_load_4d(base + L::v + c * L::kv_box, &tm_v, bar_kv, c * kBox,
                        hk, k0, b);
      }
    }
    for (int it = 0; lane < 32 && it < n_iter; ++it) {
      const int s = it % L::kRing;
      const int hq = hk * rep + it / per_head;
      const int q0 = (first + it % per_head) * L::BQ;
      const uint32_t st = base + L::stage0 + s * L::stage;
      const uint32_t full = full0 + 8 * s;
      hw::mbar_wait(empty0 + 8 * s, ((it / L::kRing) & 1) ^ 1);
      if (lane == 0) {  // Q and dO by TMA
        hw::mbar_expect_tx(full, L::tx_stage);
        for (int c = 0; c < L::NB; ++c) {
          hw::tma_load_4d(st + c * L::q_box, &tm_q, full, c * kBox, hq, q0,
                          b);
          hw::tma_load_4d(st + L::s_g + c * L::q_box, &tm_g, full, c * kBox,
                          hq, q0, b);
        }
      }
      // lse and delta by the lanes (their rows need not start on the 16
      // bytes TMA wants); rows past Sq are 0
      float* stats = reinterpret_cast<float*>(smem + L::stage0 +
                                              s * L::stage + L::s_lse);
      const size_t at = ((size_t)b * H + hq) * Sq;
      for (int i = lane; i < L::BQ; i += 32) {
        const bool ok = q0 + i < Sq;
        stats[i] = ok ? lse[at + q0 + i] * kLog2e : 0.f;
        stats[L::BQ + i] = ok ? delta[at + q0 + i] : 0.f;
      }
      hw::mbar_arrive(full);
    }
  } else {  // consumer warpgroup wg: keys k0 .. k0 + 63, stages wg, wg + 2..
    hw::setmaxnreg_inc<232>();
    const int wg = hw::warpgroup_idx(), ct = threadIdx.x & 127;
    const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    const int r = k0 + warp * 16 + g;  // this thread's keys: r and r + 8
    const float scale_log2 = scale * kLog2e;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    hw::mbar_wait(bar_kv, 0);

    // a stage is released once the products that read it are done: the
    // last dV and dK of a stage are waited for under the next tile's
    // scores, so `held` is the stage they may still be reading
    int held = -1;
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(empty0 + 8 * stage);
    };
    for (int it = wg; it < n_iter; it += 2) {
      const int s = it % L::kRing;
      const uint32_t st = base + L::stage0 + s * L::stage;
      const float* lse_s = reinterpret_cast<const float*>(
          smem + L::stage0 + s * L::stage + L::s_lse);
      const float* delta_s = lse_s + L::BQ;
      hw::mbar_wait(full0 + 8 * s, (it / L::kRing) & 1);
      // the stage's queries in score tiles of kHalf (m64 x kHalf), which
      // keep the consumers inside their registers next to dK and dV
      bool used = false;
#pragma unroll 1
      for (int hf = 0; hf < L::BQ / kHalf; ++hf) {
        const int q0 = (first + it % per_head) * L::BQ + hf * kHalf;
        // skip a tile none of whose queries sees these keys
        if (causal && k0 > q0 + kHalf - 1 + offset) continue;
        used = true;
        const uint32_t q_s = st + hf * kHalf * kRowBytes;
        const uint32_t g_s = q_s + L::s_g;
        // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
        float s_t[kHalf / 2], dp_t[kHalf / 2];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::Wgmma<kHalf>::ss<0>(s_t, kmajor(base + L::k, L::kv_box, kk),
                                  kmajor(q_s, L::q_box, kk), kk);
        hw::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::Wgmma<kHalf>::ss<0>(dp_t, kmajor(base + L::v, L::kv_box, kk),
                                  kmajor(g_s, L::q_box, kk), kk);
        hw::wgmma_commit();
        // P^T = exp(scale S^T - lse) while dP^T is multiplied; masked
        // entries 0 (explicitly: a query that sees no key has lse -1e30).
        // The wait also completes the previous tile's dV and dK.
        hw::wgmma_wait<1>();
        hw::fence_regs(s_t);
        if (held >= 0) {
          release(held);
          held = -1;
        }
        const bool edge = k0 + L::BK > Sk || q0 + kHalf > Sq ||
                          (causal && k0 + L::BK - 1 > q0 + offset);
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          const int col = hf * kHalf + 8 * j + 2 * t;
          const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = !edge || visible(q0 + 8 * j + 2 * t + (e & 1),
                                             r + 8 * (e >> 1), Sq, Sk,
                                             offset, causal);
            const float p = exp2f(fmaf(s_t[4 * j + e], scale_log2,
                                       -((e & 1) ? ls.y : ls.x)));
            s_t[4 * j + e] = ok ? p : 0.f;
          }
        }
        uint32_t pa[kHalf / 16][4];
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc)
          acc_to_a(pa[kc], s_t + 8 * kc);
        // dV += P^T dO (B: the stage's dO, MN-major) while dS^T is computed
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc)
          hw::Wgmma<D>::template rs<1>(dv_acc, pa[kc],
                                       mnmajor(g_s, L::q_box, kc), 1);
        hw::wgmma_commit();
        // dS^T = P^T (dP^T - delta) scale: 0 where P^T is
        hw::wgmma_wait<1>();
        hw::fence_regs(dp_t);
#pragma unroll
        for (int j = 0; j < kHalf / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(
              delta_s + hf * kHalf + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp_t[4 * j + e] = s_t[4 * j + e] *
                              (dp_t[4 * j + e] - ((e & 1) ? dl.y : dl.x)) *
                              scale;
        }
        uint32_t da[kHalf / 16][4];
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc)
          acc_to_a(da[kc], dp_t + 8 * kc);
        // dK += dS^T Q (B: the stage's Q, MN-major)
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < kHalf / 16; ++kc)
          hw::Wgmma<D>::template rs<1>(dk_acc, da[kc],
                                       mnmajor(q_s, L::q_box, kc), 1);
        hw::wgmma_commit();  // waited for under the next tile's scores
      }
      if (used)
        held = s;
      else
        release(s);
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(dv_acc);
    hw::fence_regs(dk_acc);
    if (held >= 0) release(held);
    // the second warpgroup's sums to the first through the stages (all
    // consumed once both warpgroups are here), added in a fixed order
    float* red = reinterpret_cast<float*>(smem + L::stage0);
    hw::named_barrier_sync(1, 256);
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        red[i * 128 + ct] = dk_acc[i];
        red[(D / 2 + i) * 128 + ct] = dv_acc[i];
      }
    }
    hw::named_barrier_sync(1, 256);
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        dk_acc[i] += red[i * 128 + ct];
        dv_acc[i] += red[(D / 2 + i) * 128 + ct];
      }
      const size_t kv_stride = (size_t)KVH * D;
      const size_t kv_head = (size_t)b * Sk * kv_stride + (size_t)hk * D;
      store_acc<D>(dk + kv_head, kv_stride, r, Sk, dk_acc, t);
      store_acc<D>(dv + kv_head, kv_stride, r, Sk, dv_acc, t);
    }
  }
}

// dq: a CTA holds 128 queries (Q, dO, lse and delta loaded once), streams
// (K, V) stages of 64 keys up to the tile's last visible key
template <int D>
struct DqWs {
  static constexpr int BQ = 128, BK = 64, NB = D / kBox;
  static constexpr uint32_t q_box = BQ * kRowBytes, kv_box = BK * kRowBytes;
  static constexpr uint32_t q = 0, g = NB * q_box, lse = 2 * NB * q_box,
                            delta = lse + BQ * 4;
  static constexpr uint32_t stage0 = align1024(delta + BQ * 4);
  // one stage: K boxes, V boxes
  static constexpr uint32_t s_v = NB * kv_box, stage = 2 * NB * kv_box;
  static constexpr uint32_t bars = stage0 + kStages * stage;
  static constexpr uint32_t bytes = bars + 64 + 1024;  // + alignment slack
  static constexpr uint32_t tx_q = 2 * BQ * D * 2;  // Q and dO
  static constexpr uint32_t tx_stage = 2 * BK * D * 2;
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   bf16* __restrict__ dq, int Sq, int Sk, int H, int KVH,
                   float scale, bool causal) {
  using L = DqWs<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // barriers: Q/dO/lse/delta landed, full[kStages], empty[kStages]
  const uint32_t bar_q = base + L::bars;
  const uint32_t full0 = bar_q + 8, empty0 = full0 + 8 * kStages;

  // heaviest (last) q blocks first under causal masking
  const int qb = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y, h = blockIdx.z, hk = h / (H / KVH);
  const int q0 = qb * L::BQ, offset = Sk - Sq;
  const int n_tiles = kv_tiles(q0, L::BQ, L::BK, Sk, offset, causal);

  if (threadIdx.x == 0) {
    hw::mbar_init(bar_q, 32);  // the producer warp's lanes
    for (int s = 0; s < kStages; ++s) {
      hw::mbar_init(full0 + 8 * s, 1);
      hw::mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (hw::warpgroup_idx() == 2) {  // the producer warpgroup: one warp loads
    hw::setmaxnreg_dec<40>();
    const int lane = threadIdx.x - kProducer;
    if (lane == 0) {  // Q and dO by TMA
      hw::mbar_expect_tx(bar_q, L::tx_q);
      for (int c = 0; c < L::NB; ++c) {
        hw::tma_load_4d(base + L::q + c * L::q_box, &tm_q, bar_q, c * kBox, h,
                        q0, b);
        hw::tma_load_4d(base + L::g + c * L::q_box, &tm_g, bar_q, c * kBox, h,
                        q0, b);
      }
    }
    if (lane < 32) {  // lse and delta by the lanes; rows past Sq are 0
      float* stats = reinterpret_cast<float*>(smem + L::lse);
      const size_t at = ((size_t)b * H + h) * Sq;
      for (int i = lane; i < L::BQ; i += 32) {
        const bool ok = q0 + i < Sq;
        stats[i] = ok ? lse[at + q0 + i] : 0.f;
        stats[L::BQ + i] = ok ? delta[at + q0 + i] : 0.f;
      }
      hw::mbar_arrive(bar_q);
    }
    for (int it = 0; lane == 0 && it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t st = base + L::stage0 + s * L::stage;
      const uint32_t full = full0 + 8 * s;
      hw::mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
      hw::mbar_arrive_expect_tx(full, L::tx_stage);
      for (int c = 0; c < L::NB; ++c) {
        hw::tma_load_4d(st + c * L::kv_box, &tm_k, full, c * kBox, hk,
                        it * L::BK, b);
        hw::tma_load_4d(st + L::s_v + c * L::kv_box, &tm_v, full, c * kBox,
                        hk, it * L::BK, b);
      }
    }
  } else {  // consumer warpgroup wg: queries qw .. qw + 63
    hw::setmaxnreg_inc<232>();
    const int wg = hw::warpgroup_idx(), ct = threadIdx.x & 127;
    const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    const int qw = q0 + wg * 64;
    const int r = qw + warp * 16 + g;  // this thread's queries: r and r + 8
    const uint32_t q_a = base + L::q + wg * 64 * kRowBytes;
    const uint32_t g_a = base + L::g + wg * 64 * kRowBytes;
    const float scale_log2 = scale * kLog2e;
    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
    hw::mbar_wait(bar_q, 0);
    const float* lse_s = reinterpret_cast<const float*>(smem + L::lse);
    const float* delta_s = reinterpret_cast<const float*>(smem + L::delta);
    const float lse_r[2] = {lse_s[r - q0] * kLog2e,
                            lse_s[r - q0 + 8] * kLog2e};
    const float delta_r[2] = {delta_s[r - q0], delta_s[r - q0 + 8]};

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int k0 = it * L::BK;
      const uint32_t st = base + L::stage0 + s * L::stage;
      hw::mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      // skip a tile none of whose keys this warpgroup's queries see
      if (qw < Sq && (!causal || k0 <= qw + 63 + offset)) {
        // S = Q K^T and dP = dO V^T
        float s_a[32], dp_a[32];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::Wgmma<64>::ss<0>(s_a, kmajor(q_a, L::q_box, kk),
                               kmajor(st, L::kv_box, kk), kk);
        hw::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::Wgmma<64>::ss<0>(dp_a, kmajor(g_a, L::q_box, kk),
                               kmajor(st + L::s_v, L::kv_box, kk), kk);
        hw::wgmma_commit();
        // P = exp(scale S - lse) while dP is multiplied; masked entries 0
        hw::wgmma_wait<1>();
        hw::fence_regs(s_a);
        const bool edge = qw + 63 >= Sq || k0 + L::BK > Sk ||
                          (causal && k0 + L::BK - 1 > qw + offset);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const bool ok = !edge || visible(r + 8 * i,
                                             k0 + 8 * j + 2 * t + (e & 1),
                                             Sq, Sk, offset, causal);
            const float p =
                exp2f(fmaf(s_a[4 * j + e], scale_log2, -lse_r[i]));
            s_a[4 * j + e] = ok ? p : 0.f;
          }
        // dS = P (dP - delta) scale into s_a: 0 where P is
        hw::wgmma_wait<0>();
        hw::fence_regs(dp_a);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_a[4 * j + e] *= (dp_a[4 * j + e] - delta_r[e >> 1]) * scale;
        uint32_t da[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(da[kc], s_a + 8 * kc);
        // dQ += dS K: B is the stage's K, MN-major
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          hw::Wgmma<D>::template rs<1>(dq_acc, da[kc],
                                       mnmajor(st, L::kv_box, kc), 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(dq_acc);
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(empty0 + 8 * s);  // this warp is done
    }
    const size_t q_stride = (size_t)H * D;
    store_acc<D>(dq + (size_t)b * Sq * q_stride + (size_t)h * D, q_stride, r,
                 Sq, dq_acc, t);
  }
}

// forward: persistent, one CTA per SM walking the (q block of 128
// queries, batch, head) items, heaviest q blocks first; the producer
// loads an item's Q into one of two buffers (the next item's Q lands
// while this one is multiplied) and streams its (K, V) stages of 128
// keys up to the block's last visible key through one ring that runs on
// across items; each consumer warpgroup keeps the online softmax of its
// 64 queries in registers
template <int D>
struct FwdWs {
  static constexpr int BQ = 128, BK = 128, NB = D / kBox;
  static constexpr int kRing = 2;
  static constexpr uint32_t q_box = BQ * kRowBytes, kv_box = BK * kRowBytes;
  static constexpr uint32_t q_buf = NB * q_box;  // Q buffer 0, then 1
  static constexpr uint32_t stage0 = 2 * q_buf;
  // one stage: K boxes, V boxes
  static constexpr uint32_t s_v = NB * kv_box, stage = 2 * NB * kv_box;
  static constexpr uint32_t bars = stage0 + kRing * stage;
  static constexpr uint32_t bytes =
      bars + 8 * (4 + 2 * kRing) + 1024;  // + alignment slack
  static constexpr uint32_t tx_q = BQ * D * 2;
  static constexpr uint32_t tx_stage = 2 * BK * D * 2;
};

// 2^x by the SFU alone (ex2.approx.ftz: about 2 ulp, results below 2^-126
// flushed to 0), for the forward's softmax: a probability that small is 0
// in bf16 and in the row sum alike
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// item i of the forward's walk: q block qb (the heaviest first under
// causal masking), batch b, head h
struct FwdItem {
  int qb, b, h;
  __device__ FwdItem(int i, int n_qb, int B, int H, bool causal) {
    const int rank = i / (B * H), bh = i % (B * H);
    qb = causal ? n_qb - 1 - rank : rank;
    b = bh / H;
    h = bh % H;
  }
};

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    bf16* __restrict__ out, float* __restrict__ lse, int B,
                    int Sq, int Sk, int H, int KVH, float scale,
                    bool causal) {
  using L = FwdWs<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // barriers: Q landed [2], Q free [2], full[kRing], empty[kRing]
  const uint32_t q_full0 = base + L::bars, q_empty0 = q_full0 + 16;
  const uint32_t full0 = q_empty0 + 16, empty0 = full0 + 8 * L::kRing;
  const int n_qb = (Sq + L::BQ - 1) / L::BQ, n_items = n_qb * B * H;
  const int offset = Sk - Sq;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hw::mbar_init(q_full0 + 8 * i, 1);
      hw::mbar_init(q_empty0 + 8 * i, 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < L::kRing; ++s) {
      hw::mbar_init(full0 + 8 * s, 1);
      hw::mbar_init(empty0 + 8 * s, 8);
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (hw::warpgroup_idx() == 2) {  // the producer warpgroup: one thread loads
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == kProducer) {
      int it = 0, n = 0;  // stages filled and items begun, so far
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        const FwdItem w(i, n_qb, B, H, causal);
        const int q0 = w.qb * L::BQ, hk = w.h / (H / KVH);
        const uint32_t qb_ = base + (n & 1) * L::q_buf;
        hw::mbar_wait(q_empty0 + 8 * (n & 1), ((n >> 1) & 1) ^ 1);
        hw::mbar_arrive_expect_tx(q_full0 + 8 * (n & 1), L::tx_q);
        for (int c = 0; c < L::NB; ++c)
          hw::tma_load_4d(qb_ + c * L::q_box, &tm_q, q_full0 + 8 * (n & 1),
                          c * kBox, w.h, q0, w.b);
        const int n_tiles = kv_tiles(q0, L::BQ, L::BK, Sk, offset, causal);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % L::kRing;
          const uint32_t st = base + L::stage0 + s * L::stage;
          const uint32_t full = full0 + 8 * s;
          hw::mbar_wait(empty0 + 8 * s, ((it / L::kRing) & 1) ^ 1);
          hw::mbar_arrive_expect_tx(full, L::tx_stage);
          for (int c = 0; c < L::NB; ++c) {
            hw::tma_load_4d(st + c * L::kv_box, &tm_k, full, c * kBox, hk,
                            t * L::BK, w.b);
            hw::tma_load_4d(st + L::s_v + c * L::kv_box, &tm_v, full,
                            c * kBox, hk, t * L::BK, w.b);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: queries 64 wg .. 64 wg + 63 of a block
    hw::setmaxnreg_inc<232>();
    const int wg = hw::warpgroup_idx(), ct = threadIdx.x & 127;
    const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    const float scale_log2 = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(bar);  // this warp is done
    };
    int it = 0, n = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
      const FwdItem w(i, n_qb, B, H, causal);
      const int q0 = w.qb * L::BQ, qw = q0 + wg * 64;
      const int r = qw + warp * 16 + g;  // this thread's queries: r, r + 8
      const uint32_t q_s = (n & 1) * L::q_buf;  // this item's Q buffer
      const uint32_t q_a = base + q_s + wg * 64 * kRowBytes;
      const int n_tiles = kv_tiles(q0, L::BQ, L::BK, Sk, offset, causal);
      // the key tiles this warpgroup's queries see
      const int n_mine =
          qw < Sq ? kv_tiles(qw, 64, L::BK, Sk, offset, causal) : 0;
      float o[D / 2];
#pragma unroll
      for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
      // running max in log2 units (finite, so exp2 of a difference is
      // never NaN) and this thread's part of the row sum
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
      hw::mbar_wait(q_full0 + 8 * (n & 1), (n >> 1) & 1);

      for (int tl = 0; tl < n_tiles; ++tl, ++it) {
        const int s = it % L::kRing;
        const int k0 = tl * L::BK;
        const uint32_t st = base + L::stage0 + s * L::stage;
        hw::mbar_wait(full0 + 8 * s, (it / L::kRing) & 1);
        if (tl >= n_mine) {  // no query of this warpgroup sees these keys
          release(empty0 + 8 * s);
          continue;
        }
        // S = Q K^T
        float sc[L::BK / 2];
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::Wgmma<L::BK>::template ss<0>(sc, kmajor(q_a, L::q_box, kk),
                                           kmajor(st, L::kv_box, kk), kk);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(sc);
        // masked scores are -inf (exp2 gives 0 against the finite max);
        // only tiles at the sequence's end or the diagonal need the mask
        const bool edge =
            k0 + L::BK > Sk || (causal && k0 + L::BK - 1 > qw + offset);
        float mt[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < L::BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r + 8 * (e >> 1);
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (edge && !visible(row, key, Sq, Sk, offset, causal))
              sc[4 * j + e] = __int_as_float(0xff800000);  // -inf
            mt[e >> 1] = fmaxf(mt[e >> 1], sc[4 * j + e]);
          }
        float alpha[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {  // the quad holds the row's columns
          mt[k] = fmaxf(mt[k], __shfl_xor_sync(0xffffffffu, mt[k], 1));
          mt[k] = fmaxf(mt[k], __shfl_xor_sync(0xffffffffu, mt[k], 2));
          const float m_new = fmaxf(m[k], mt[k] * scale_log2);
          alpha[k] = fast_exp2(m[k] - m_new);
          m[k] = m_new;
          l[k] *= alpha[k];
        }
#pragma unroll
        for (int j = 0; j < L::BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                fast_exp2(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
            sc[4 * j + e] = p;
            l[e >> 1] += p;
          }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        // O += P V: P rounded to bf16 as the A operand straight from the
        // score registers, B the stage's V read MN-major
        uint32_t pa[L::BK / 16][4];
#pragma unroll
        for (int kc = 0; kc < L::BK / 16; ++kc)
          acc_to_a(pa[kc], sc + 8 * kc);
        hw::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < L::BK / 16; ++kc)
          hw::Wgmma<D>::template rs<1>(
              o, pa[kc], mnmajor(st + L::s_v, L::kv_box, kc), 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(o);
        release(empty0 + 8 * s);
      }

      // 1 / l per row and lse; a row that saw no key has l = 0: out 0
      float inv[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
        l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
        inv[k] = l[k] > 0.f ? 1.f / l[k] : 0.f;
        const int row = r + 8 * k;
        if (t == 0 && row < Sq)
          lse[((size_t)w.b * H + w.h) * Sq + row] =
              l[k] > 0.f ? (m[k] + log2f(l[k])) * kLn2 : kNegInf;
      }
      // O / l rounded once to bf16 into this warpgroup's rows of the Q
      // buffer (its products are done with them), in the boxes' swizzled
      // layout, then out in 16-byte rows; rows past Sq are clipped
      const int lr = wg * 64 + warp * 16 + g;  // the row in Q's boxes
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int row = lr + 8 * k;
          const uint32_t at = q_s + (j / 8) * L::q_box + row * kRowBytes +
                              (((j % 8) ^ (row & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(smem + at) =
              pack2(o[4 * j + 2 * k] * inv[k], o[4 * j + 2 * k + 1] * inv[k]);
        }
      hw::named_barrier_sync(1 + wg, 128);
      constexpr int kChunks = D / 8;  // 16-byte chunks of a row
      const size_t q_stride = (size_t)H * D;
      bf16* oh = out + (size_t)w.b * Sq * q_stride + (size_t)w.h * D;
      for (int idx = ct; idx < 64 * kChunks; idx += 128) {
        const int row = wg * 64 + idx / kChunks, cc = idx % kChunks;
        if (q0 + row >= Sq) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(
            smem + q_s + (cc / 8) * L::q_box + row * kRowBytes +
            (((cc % 8) ^ (row & 7)) << 4));
        *reinterpret_cast<uint4*>(oh + (size_t)(q0 + row) * q_stride +
                                  cc * 8) = val;
      }
      // the buffer may take a later item's Q (a TMA write after these
      // generic accesses)
      hw::fence_async_smem();
      release(q_empty0 + 8 * (n & 1));
    }
  }
}

// ---- launchers ---------------------------------------------------------------

struct Shape {
  int B, Sq, Sk, H, KVH, D;
  float scale;
  bool causal;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
cudaError_t fwd_f32(const Shape& s, const void* q, const void* k,
                    const void* v, void* out, float* lse,
                    cudaStream_t stream) {
  using L = FwdSmem<float, D>;
  auto kernel = flash_fwd_kernel<float, D>;
  cudaError_t e = set_smem(kernel, L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((s.Sq + L::BQ - 1) / L::BQ, s.B, s.H);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, s.Sq,
      s.Sk, s.H, s.KVH, s.scale, s.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_f32(const Shape& s, const void* q, const void* k,
                    const void* v, const void* g, const float* lse,
                    const float* delta, void* dk, void* dv,
                    cudaStream_t stream) {
  using L = DkvSmem<float, D>;
  auto kernel = flash_dkv_kernel<float, D>;
  cudaError_t e = set_smem(kernel, L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((s.Sk + L::BK - 1) / L::BK, s.B, s.KVH);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), s.Sq, s.Sk, s.H,
      s.KVH, s.scale, s.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_f32(const Shape& s, const void* q, const void* k,
                   const void* v, const void* g, const float* lse,
                   const float* delta, void* dqp, cudaStream_t stream) {
  using L = DqSmem<float, D>;
  auto kernel = flash_dq_kernel<float, D>;
  cudaError_t e = set_smem(kernel, L::bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((s.Sq + L::BQ - 1) / L::BQ, s.B, s.H);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dqp), s.Sq, s.Sk, s.H, s.KVH, s.scale, s.causal);
  return cudaGetLastError();
}

// D 64 and 128 take the warp-specialised wgmma kernel; D 16 and 32 (no
// model of the repo trains at those widths) keep the mma.sync kernel
template <int D>
cudaError_t fwd_bf16(const Shape& s, const void* q, const void* k,
                     const void* v, void* out, float* lse,
                     cudaStream_t stream) {
  if constexpr (D >= kBox) {
    using L = FwdWs<D>;
    CUtensorMap tq, tk, tv;
    if (!hw::rows_map(&tq, q, s.B, s.Sq, s.H, D, L::BQ) ||
        !hw::rows_map(&tk, k, s.B, s.Sk, s.KVH, D, L::BK) ||
        !hw::rows_map(&tv, v, s.B, s.Sk, s.KVH, D, L::BK))
      return cudaErrorInvalidValue;
    auto kernel = flash_fwd_wgmma<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const int items = (s.Sq + L::BQ - 1) / L::BQ * s.B * s.H;
    kernel<<<items < sms ? items : sms, kWsThreads, L::bytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(out), lse, s.B, s.Sq, s.Sk, s.H,
        s.KVH, s.scale, s.causal);
    return cudaGetLastError();
  } else {
    constexpr size_t bytes =
        sizeof(bf16) * (kMmaRows + 2 * kMmaKeys) * (D + 8);
    auto kernel = flash_fwd_bf16<D>;
    cudaError_t e = set_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((s.Sq + kMmaRows - 1) / kMmaRows, s.B, s.H);
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, s.Sq,
        s.Sk, s.H, s.KVH, s.scale, s.causal);
    return cudaGetLastError();
  }
}

// the TMA maps of a backward kernel: q and dO in boxes of bq rows, k and
// v in boxes of bk rows
struct BwdMaps {
  CUtensorMap q, g, k, v;
  bool make(const Shape& s, const void* qp, const void* kp, const void* vp,
            const void* gp, int bq, int bk) {
    return hw::rows_map(&q, qp, s.B, s.Sq, s.H, s.D, bq) &&
           hw::rows_map(&g, gp, s.B, s.Sq, s.H, s.D, bq) &&
           hw::rows_map(&k, kp, s.B, s.Sk, s.KVH, s.D, bk) &&
           hw::rows_map(&v, vp, s.B, s.Sk, s.KVH, s.D, bk);
  }
};

// D 64 and 128 take the warp-specialised wgmma kernels; D 16 and 32 (no
// model of the repo trains at those widths) keep the mma.sync kernels
template <int D>
cudaError_t dkv_bf16(const Shape& s, const void* q, const void* k,
                     const void* v, const void* g, const float* lse,
                     const float* delta, void* dk, void* dv,
                     cudaStream_t stream) {
  if constexpr (D >= kBox) {
    using L = DkvWs<D>;
    BwdMaps m;
    if (!m.make(s, q, k, v, g, L::BQ, L::BK))
      return cudaErrorInvalidValue;
    auto kernel = flash_dkv_wgmma<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((s.Sk + L::BK - 1) / L::BK, s.B, s.KVH);
    kernel<<<grid, kWsThreads, L::bytes, stream>>>(
        m.q, m.g, m.k, m.v, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), s.Sq, s.Sk, s.H, s.KVH, s.scale, s.causal);
    return cudaGetLastError();
  } else {
    constexpr size_t bytes =
        sizeof(bf16) * (2 * kMmaRows + 4 * kMmaQ) * (D + 8) +
        sizeof(float) * 4 * kMmaQ;
    auto kernel = flash_dkv_bf16<D>;
    cudaError_t e = set_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((s.Sk + kMmaRows - 1) / kMmaRows, s.B, s.KVH);
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.Sq, s.Sk, s.H,
        s.KVH, s.scale, s.causal);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t dq_bf16(const Shape& s, const void* q, const void* k,
                    const void* v, const void* g, const float* lse,
                    const float* delta, void* dqp, cudaStream_t stream) {
  if constexpr (D >= kBox) {
    using L = DqWs<D>;
    BwdMaps m;
    if (!m.make(s, q, k, v, g, L::BQ, L::BK))
      return cudaErrorInvalidValue;
    auto kernel = flash_dq_wgmma<D>;
    cudaError_t e = set_smem(kernel, L::bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((s.Sq + L::BQ - 1) / L::BQ, s.B, s.H);
    kernel<<<grid, kWsThreads, L::bytes, stream>>>(
        m.q, m.g, m.k, m.v, lse, delta, static_cast<bf16*>(dqp), s.Sq,
        s.Sk, s.H, s.KVH, s.scale, s.causal);
    return cudaGetLastError();
  } else {
    constexpr size_t bytes =
        sizeof(bf16) * (2 * kMmaRows + 2 * kMmaKeys) * (D + 8);
    auto kernel = flash_dq_bf16<D>;
    cudaError_t e = set_smem(kernel, bytes);
    if (e != cudaSuccess) return e;
    dim3 grid((s.Sq + kMmaRows - 1) / kMmaRows, s.B, s.H);
    kernel<<<grid, kMmaThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
        static_cast<bf16*>(dqp), s.Sq, s.Sk, s.H, s.KVH, s.scale, s.causal);
    return cudaGetLastError();
  }
}

// dispatch on (dtype, D) to name##_bf16<D> or name##_f32<D>
#define PTT_FLASH_DISPATCH(name, dtype, D, ...)                        \
  do {                                                                 \
    if ((dtype) == ptt::kBFloat16) {                                   \
      switch (D) {                                                     \
        case 16: return name##_bf16<16>(__VA_ARGS__);                  \
        case 32: return name##_bf16<32>(__VA_ARGS__);                  \
        case 64: return name##_bf16<64>(__VA_ARGS__);                  \
        case 128: return name##_bf16<128>(__VA_ARGS__);                \
      }                                                                \
    } else if ((dtype) == ptt::kFloat32) {                             \
      switch (D) {                                                     \
        case 16: return name##_f32<16>(__VA_ARGS__);                   \
        case 32: return name##_f32<32>(__VA_ARGS__);                   \
        case 64: return name##_f32<64>(__VA_ARGS__);                   \
        case 128: return name##_f32<128>(__VA_ARGS__);                 \
      }                                                                \
    }                                                                  \
    return cudaErrorInvalidValue;                                      \
  } while (0)

cudaError_t fwd_any(int dtype, const Shape& s, const void* q, const void* k,
                    const void* v, void* out, float* lse, cudaStream_t st) {
  PTT_FLASH_DISPATCH(fwd, dtype, s.D, s, q, k, v, out, lse, st);
}

cudaError_t dkv_any(int dtype, const Shape& s, const void* q, const void* k,
                    const void* v, const void* g, const float* lse,
                    const float* delta, void* dk, void* dv, cudaStream_t st) {
  PTT_FLASH_DISPATCH(dkv, dtype, s.D, s, q, k, v, g, lse, delta, dk, dv, st);
}

cudaError_t dq_any(int dtype, const Shape& s, const void* q, const void* k,
                   const void* v, const void* g, const float* lse,
                   const float* delta, void* dqp, cudaStream_t st) {
  PTT_FLASH_DISPATCH(dq, dtype, s.D, s, q, k, v, g, lse, delta, dqp, st);
}

bool shape_ok(int B, int Sq, int Sk, int H, int KVH) {
  return B > 0 && Sq > 0 && Sk > 0 && KVH > 0 && H % KVH == 0;
}

}  // namespace

// All tensors contiguous: q, out, dout, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KVH, D]; lse, delta [B, H, Sq] f32. D in {16, 32, 64, 128};
// KVH divides H. Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for a shape or type it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Sk, int H, int KVH,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  if (!shape_ok(B, Sq, Sk, H, KVH))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Sq, Sk, H, KVH, D, scale, causal != 0};
  return static_cast<int>(fwd_any(dtype, s, q, k, v, out,
                                  static_cast<float*>(lse),
                                  static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int Sq, int Sk,
                                   int H, int KVH, int D, float scale,
                                   int causal, int dtype, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, KVH))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Sq, Sk, H, KVH, D, scale, causal != 0};
  return static_cast<int>(dkv_any(dtype, s, q, k, v, dout,
                                  static_cast<const float*>(lse),
                                  static_cast<const float*>(delta), dk, dv,
                                  static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, int B, int Sq, int Sk, int H,
                                  int KVH, int D, float scale, int causal,
                                  int dtype, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, KVH))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Sq, Sk, H, KVH, D, scale, causal != 0};
  return static_cast<int>(dq_any(dtype, s, q, k, v, dout,
                                 static_cast<const float*>(lse),
                                 static_cast<const float*>(delta), dq,
                                 static_cast<cudaStream_t>(stream)));
}
