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
// read once, for some 2 * rep flops a byte.
//
// bf16 at D 64 and 128, pages of a power of two up to 64 (split::
// paged_split; both served models): split keys, a bulk-copy ring, and a
// merge inside a thread-block cluster, one launch.
//   * The wrapper's plan, from the shapes alone (ops/kernels/
//     paged_attention.py::decode_split_plan), cuts a sequence's keys into
//     n_splits <= 8 splits of split_len keys, a multiple of 64 (whole
//     pages). One CTA of four warps per (split, kv head, sequence) holds
//     the rep <= 8 query rows of its kv head, so K and V are read once for
//     all of them; the n_splits CTAs of a (sequence, kv head) form a
//     cluster.
//   * Loads: a page of one kv head is page * D * 2 contiguous bytes, so a
//     ring stage of 32 keys is filled by 1-D bulk copies of whole pages
//     (cp.async.bulk, no tensor map; a page of 64 in two halves), K and V,
//     counted on the stage's mbarrier. One thread starts them, two stages
//     ahead of the tile being multiplied; the split's block-table entries
//     are read into shared memory once, and keys are found by shifts.
//     Pages that hold no key below the split's end are never copied.
//   * Products on the CUDA cores in f32, a warp taking 8 keys of each
//     stage. A key row is read by G = D / 8 lanes (16 bytes each, the warp
//     reads 512 contiguous bytes: no bank conflict in the page layout the
//     copies leave, which would serialise mma.sync's fragment loads 8
//     ways), each lane's partial dot products against its q columns are
//     folded over the G lanes (a transposing reduction: each shuffle
//     level halves the values a lane holds), and every lane ends with one
//     key's score. P stays f32 (never rounded to bf16) and P V is taken by
//     the same lanes on the same addresses. Scores of keys at or past the
//     split's end are replaced, and their value rows selected to zero, so
//     a non-finite page tail never reaches an output.
//   * The merge: each CTA combines its warps (in warp order) into (m, l,
//     o[rep][D]) in its own shared memory; after a cluster barrier, rank 0
//     reads every rank's partial through distributed shared memory, merges
//     them in rank order and writes the output; a second cluster barrier
//     keeps the other CTAs alive until it has read them. A CTA whose split
//     starts at or past the context loads nothing, leaves an empty partial
//     (m at the floor, l = 0) and still reaches both barriers. No atomics,
//     no scratch, no second launch: the same bits every run.
//   What bounds it on an H100 (PERF.md, K16): at B 8 it reaches about 42%
//   of the bytes bound. The CUDA-core products keep the SMs that hold four
//   working CTAs busy; the card holds 62 clusters of 8 CTAs at once where
//   B 8 at 8 kv heads makes 64; and the merge costs some 4.5 us of 24,
//   most of it the two cluster barriers' wait for a cluster's slowest
//   split. At B 64 the plan has one split (the (sequence, kv head) pairs
//   fill the card) and it reaches about three quarters: bytes.
//
// f32, and bf16 at other page sizes (paged_decode_kernel): the first
// version's body, on the CUDA cores in f32. One CTA per (sequence, kv
// head) holds the rep query rows of that kv head. Its 8 warps split the
// sequence's keys in chunks of 16, chunk c to warp c % 8. In a chunk, two
// lanes share a key: each loads every other 16-byte vector of the key row,
// takes its half of the rep dot products against q in shared memory, and
// one shuffle adds the halves. Each warp keeps an online softmax in f32
// for the rep rows; for P.V a lane owns D/32 columns, so a value row is
// one coalesced read by the warp. Keys at or past context_lens[b] are
// never loaded and get no weight. At the end the warps' (max, sum,
// accumulator) are combined through shared memory.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

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

// ---- bf16 at D 64/128: split keys, bulk copies, a cluster merge -----------

namespace split {

using bf16 = __nv_bfloat16;
namespace hw = ptt::hopper;
constexpr int kThreads = 128;                 // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                     // keys a ring stage
constexpr int kStages = 3;
constexpr int kWarpKeys = kTile / kWarps;     // keys a warp takes a stage
constexpr int kMaxSplits = 8;                 // the portable cluster size
constexpr int kSplitUnit = 64;                // split_len is a multiple
constexpr int kMaxPageShift = 6;              // pages of at most 64 keys
constexpr int kMaxTablePages = 4096;          // table entries a split
constexpr float kNegInf = -1e30f;

// Shared memory of one CTA: the ring (stage s: K then V, kTile rows of D
// bf16 each, as the copies leave them), its mbarriers, then the split's
// table entries (sized at launch). Once the ring has drained it holds the
// four warps' states and then the CTA's partial, which the cluster reads.
template <int D, int R>
struct Smem {
  static constexpr uint32_t stage = 2 * kTile * D * 2;
  static constexpr uint32_t ring = kStages * stage;
  static constexpr uint32_t warp_o = 0;                        // [4][R][D]
  static constexpr uint32_t warp_ml = warp_o + kWarps * R * D * 4;  // [4][R]
  static constexpr uint32_t part_o = warp_ml + kWarps * R * 8;  // [R][D]
  static constexpr uint32_t part_ml = part_o + R * D * 4;       // [R]
  static_assert(part_ml + R * 8 <= ring, "the states fit in the ring");
  static constexpr uint32_t bars = ring;
  static constexpr uint32_t pages = bars + kStages * 8;
};

// eight bf16 (one 16-byte vector) as f32
__device__ __forceinline__ void unpack8(const uint4 w, float (&f)[8]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

// R: query rows a CTA (rep rounded up to 1, 2, 4 or 8; rows past rep are
// computed on zero q and never written)
template <int D, int R>
__global__ void __launch_bounds__(kThreads, R <= 4 ? 4 : 2)
    paged_split(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                const bf16* __restrict__ vpool,
                const int* __restrict__ tables,
                const int* __restrict__ ctx_lens, bf16* __restrict__ out,
                int H, int num_pages, int page_shift, int pages_per_seq,
                int rep, float scale_log2, int split_len) {
  using S = Smem<D, R>;
  constexpr int G = D / 8;             // lanes a key row, 16 bytes each
  constexpr int KL = 32 / G;           // keys a warp load
  constexpr int NL = kWarpKeys / KL;   // loads a warp a stage
  constexpr int kRun = G / NL;         // lanes left holding one key's score
  static_assert(NL >= 1 && kRun >= 1, "D not taken");
  extern __shared__ __align__(128) unsigned char smem[];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;      // the cluster: splits of (b, h)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / G, c = lane % G;
  const int page = 1 << page_shift;
  const int n = min(ctx_lens[b], pages_per_seq << page_shift);
  const int k_lo = split * split_len, k_hi = min(k_lo + split_len, n);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTile - 1) / kTile : 0;

  // the split's block-table entries (all of them: the loads need not wait
  // for the context), and the ring's barriers
  int* pg = reinterpret_cast<int*>(smem + S::pages);
  const int p_lo = k_lo >> page_shift;
  const int n_pg = max(0, min(split_len >> page_shift, pages_per_seq - p_lo));
  const int* tbl = tables + (size_t)b * pages_per_seq + p_lo;
  for (int i = tid; i < n_pg; i += kThreads) pg[i] = tbl[i];
  // q columns 8c .. 8c + 7 of each row, f32 (its loads in flight with
  // the table's and the context's)
  float qf[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < rep)
      w = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + (size_t)h * rep + r) * D + 8 * c);
    unpack8(w, qf[r]);
  }
  const uint32_t bar0 = hw::smem_u32(smem + S::bars);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hw::mbar_init(bar0 + 8 * s, 1);
    hw::mbar_fence_init();
  }
  __syncthreads();

  // tile t of the split into stage t % kStages (thread 0): the pages (or
  // 32-key halves of a page of 64) that hold a key below k_hi
  const size_t head = (size_t)h * num_pages << page_shift;
  const int chunk_shift = min(page_shift, 5);
  auto load_tile = [&](int t) {
    const int st = t % kStages, k0 = k_lo + t * kTile;
    const int chunk = 1 << chunk_shift;
    const int nc = (min(kTile, k_hi - k0) + chunk - 1) >> chunk_shift;
    const uint32_t bytes = (uint32_t)chunk * D * 2;
    const uint32_t bar = bar0 + 8 * st;
    const uint32_t kdst = hw::smem_u32(smem + st * S::stage);
    const uint32_t vdst = kdst + kTile * D * 2;
    hw::mbar_arrive_expect_tx(bar, 2 * nc * bytes);
    for (int i = 0; i < nc; ++i) {
      const int kp = k0 + (i << chunk_shift);
      const size_t row = head +
                         ((size_t)pg[(kp >> page_shift) - p_lo] << page_shift) +
                         (kp & (page - 1));
      hw::bulk_load(kdst + i * bytes, kpool + row * D, bytes, bar);
      hw::bulk_load(vdst + i * bytes, vpool + row * D, bytes, bar);
    }
  };
  if (tid == 0)
    for (int t = 0; t < min(kStages - 1, n_tiles); ++t) load_tile(t);

  // per row: the warp's running max (uniform), this lane's share of the
  // row sum (the p of the key it holds) and its 8 columns of P V
  float m[R], l[R], o[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[r][e] = 0.f;
  }
  // the key whose score this lane ends with, of the warp's kWarpKeys
  const int my_key = (c / kRun) * KL + grp;

  for (int t = 0; t < n_tiles; ++t) {
    hw::mbar_wait(bar0 + 8 * (t % kStages), (t / kStages) & 1);
    __syncthreads();  // every warp is done with tile t - 1: refill its stage
    if (tid == 0 && t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    const bf16* kt = reinterpret_cast<const bf16*>(
                         smem + (t % kStages) * S::stage) +
                     warp * kWarpKeys * D;
    const bf16* vt = kt + kTile * D;
    const int k0 = k_lo + t * kTile + warp * kWarpKeys;  // this warp's keys

    // scores: lane (grp, c) takes key u * KL + grp of load u
    uint4 kv[NL];
#pragma unroll
    for (int u = 0; u < NL; ++u)
      kv[u] = *reinterpret_cast<const uint4*>(kt + (u * KL + grp) * D + 8 * c);
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float v[NL];
#pragma unroll
      for (int u = 0; u < NL; ++u) {
        float kf[8];
        unpack8(kv[u], kf);
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(qf[r][e], kf[e], d);
        v[u] = d;
      }
      // fold the NL partials over the G lanes of a key: at each level a
      // lane keeps one half of its values and adds its partner's
#pragma unroll
      for (int w = NL, mask = G / 2; w > 1; w >>= 1, mask >>= 1) {
        const bool hi = lane & mask;
#pragma unroll
        for (int i = 0; i < w / 2; ++i) {
          const float keep = hi ? v[i + w / 2] : v[i];
          const float send = hi ? v[i] : v[i + w / 2];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
      }
#pragma unroll
      for (int mask = kRun / 2; mask > 0; mask >>= 1)
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
      x[r] = v[0];
    }
    // online softmax in log2 units; keys at or past k_hi replaced
    const bool valid = k0 + my_key < k_hi;
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xr = valid ? x[r] * scale_log2 : kNegInf;
      float mx = xr;
#pragma unroll
      for (int mask = kRun; mask < 32; mask <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, mask));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      p[r] = xr > kNegInf ? exp2f(xr - m_new) : 0.f;
      l[r] = l[r] * alpha + p[r];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[r][e] *= alpha;
    }
    // P V: lane (grp, c) takes value row u * KL + grp, columns 8c .. 8c + 7
#pragma unroll
    for (int u = 0; u < NL; ++u) {
      const int j = u * KL + grp;
      uint4 w = *reinterpret_cast<const uint4*>(vt + j * D + 8 * c);
      if (k0 + j >= k_hi) w = make_uint4(0u, 0u, 0u, 0u);
      float vf[8];
      unpack8(w, vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], grp * G + u * kRun);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[r][e] = fmaf(pj, vf[e], o[r][e]);
      }
    }
  }

  // the warp's state: l over its keys, o over the lanes of a column block
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int mask = kRun; mask < 32; mask <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], mask);
#pragma unroll
    for (int mask = G; mask < 32; mask <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o[r][e] += __shfl_xor_sync(0xffffffffu, o[r][e], mask);
  }
  // every copy has landed (each tile was waited for): the ring is free
  __syncthreads();
  float* wo = reinterpret_cast<float*>(smem + S::warp_o);
  float2* wml = reinterpret_cast<float2*>(smem + S::warp_ml);
  float* po = reinterpret_cast<float*>(smem + S::part_o);
  float2* pml = reinterpret_cast<float2*>(smem + S::part_ml);
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float4* dst = reinterpret_cast<float4*>(wo + (warp * R + r) * D + 8 * c);
      dst[0] = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      dst[1] = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) wml[warp * R + r] = make_float2(m[r], l[r]);
  }
  __syncthreads();
  // the CTA's partial: the warps' states merged in warp order (a warp that
  // saw no key has l = 0 and o = 0)
  for (int i = tid; i < R * D / 4; i += kThreads) {
    const int r = i / (D / 4), d = 4 * (i % (D / 4));
    float big = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, wml[w * R + r].x);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = wml[w * R + r];
      const float f = exp2f(ml.x - big);
      const float4 v =
          *reinterpret_cast<const float4*>(wo + (w * R + r) * D + d);
      sum += f * ml.y;
      acc.x += f * v.x;
      acc.y += f * v.y;
      acc.z += f * v.z;
      acc.w += f * v.w;
    }
    *reinterpret_cast<float4*>(po + r * D + d) = acc;
    if (d == 0) pml[r] = make_float2(big, sum);
  }

  // rank 0 merges the cluster's partials in rank order (ranks are splits)
  hw::cluster_arrive();
  hw::cluster_wait();
  if (split == 0) {
    for (int i = tid; i < rep * D / 4; i += kThreads) {
      const int r = i / (D / 4), d = 4 * (i % (D / 4));
      const uint32_t ml_at = hw::smem_u32(pml + r);
      const uint32_t o_at = hw::smem_u32(po + r * D + d);
      // every rank's (m, l) and o at once: one round trip
      float2 ml[kMaxSplits];
      float4 ov[kMaxSplits];
      float big = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        ml[s] = make_float2(kNegInf, 0.f);
        if (s < n_splits) {
          ml[s] = hw::ld_cluster_f2(hw::map_rank(ml_at, s));
          ov[s] = hw::ld_cluster_f4(hw::map_rank(o_at, s));
        }
        big = fmaxf(big, ml[s].x);
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (ml[s].x <= kNegInf) continue;  // a split that saw no key
        const float f = exp2f(ml[s].x - big);
        const float4 v = ov[s];
        sum += f * ml[s].y;
        acc.x += f * v.x;
        acc.y += f * v.y;
        acc.z += f * v.z;
        acc.w += f * v.w;
      }
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      const __nv_bfloat162 lo2 =
          __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
      const __nv_bfloat162 hi2 =
          __floats2bfloat162_rn(acc.z * inv, acc.w * inv);
      bf16* dst = out + ((size_t)b * H + (size_t)h * rep + r) * D + d;
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                     *reinterpret_cast<const uint32_t*>(&hi2));
    }
  }
  // the other CTAs stay until rank 0 has read them
  hw::cluster_arrive();
  hw::cluster_wait();
}

}  // namespace split

// the split body takes bf16 at D 64/128, pages of a power of two up to 64
// and the wrapper's plan
bool split_takes(int D, int page, int n_splits, int split_len) {
  if (D != 64 && D != 128) return false;
  if (page <= 0 || (page & (page - 1)) || page > (1 << split::kMaxPageShift))
    return false;
  return n_splits >= 1 && n_splits <= split::kMaxSplits && split_len > 0 &&
         split_len % split::kSplitUnit == 0 &&
         split_len / page <= split::kMaxTablePages;
}

template <int D, int R>
cudaError_t launch_split(const void* q, const void* kp, const void* vp,
                         const void* tables, const void* ctx, void* out,
                         int B, int H, int KVH, int num_pages, int page,
                         int pages_per_seq, float scale, int n_splits,
                         int split_len, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int shift = __builtin_ctz(page);
  const uint32_t smem =
      split::Smem<D, R>::pages + 4 * ((split_len >> shift) + 2);
  auto kernel = split::paged_split<D, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, KVH, B);
  cfg.blockDim = dim3(split::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(q),
                         static_cast<const bf16*>(kp),
                         static_cast<const bf16*>(vp),
                         static_cast<const int*>(tables),
                         static_cast<const int*>(ctx), static_cast<bf16*>(out),
                         H, num_pages, shift, pages_per_seq, H / KVH,
                         scale * 1.4426950408889634f, split_len);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_split_rep(const void* q, const void* kp, const void* vp,
                             const void* tables, const void* ctx, void* out,
                             int B, int H, int KVH, int num_pages, int page,
                             int pages_per_seq, float scale, int n_splits,
                             int split_len, cudaStream_t s) {
  const int rep = H / KVH;
  auto go = [&](auto rows) {
    return launch_split<D, decltype(rows)::value>(
        q, kp, vp, tables, ctx, out, B, H, KVH, num_pages, page,
        pages_per_seq, scale, n_splits, split_len, s);
  };
  if (rep <= 1) return go(std::integral_constant<int, 1>{});
  if (rep <= 2) return go(std::integral_constant<int, 2>{});
  if (rep <= 4) return go(std::integral_constant<int, 4>{});
  return go(std::integral_constant<int, 8>{});
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

// All tensors contiguous; D in {64, 128}; H / KVH at most 8. n_splits and
// split_len are the wrapper's plan for the split body (bf16, D 64/128,
// pages of a power of two up to 64), n_splits 0 for the first version's
// body. Returns cudaGetLastError() (or cudaErrorInvalidValue for a shape
// or plan the kernel does not take).
extern "C" int paged_attention_fwd(const void* q, const void* key_pages,
                                   const void* value_pages,
                                   const void* tables, const void* ctx_lens,
                                   void* out, int B, int H, int KVH, int D,
                                   int num_pages, int page, int pages_per_seq,
                                   float scale, int dtype, int n_splits,
                                   int split_len, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxRep)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_splits != 0) {
    if (dtype != ptt::kBFloat16 || !split_takes(D, page, n_splits, split_len))
      return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64)
      return launch_split_rep<64>(q, key_pages, value_pages, tables,
                                  ctx_lens, out, B, H, KVH, num_pages, page,
                                  pages_per_seq, scale, n_splits, split_len,
                                  s);
    return launch_split_rep<128>(q, key_pages, value_pages, tables, ctx_lens,
                                 out, B, H, KVH, num_pages, page,
                                 pages_per_seq, scale, n_splits, split_len, s);
  }
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
