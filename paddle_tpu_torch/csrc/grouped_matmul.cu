// Grouped matmul for the dropless MoE on Hopper: the forward y[t] =
// x[t] @ w[gid(t)], its transposed form dx[t] = dy[t] @ w[gid(t)]^T, and
// the per-expert weight gradient dw[e] = x[group e]^T @ dy[group e].
//
// Replaces: paddle_tpu/ops/pallas/grouped_matmul.py::_fwd_kernel (K14,
// launched from _gmm_call with transpose_rhs False or True) and
// ::_dw_kernel (K15, launched from _dw_call).
//
// Layout (ops/moe.py sort_rows_by_expert): x [P, k] holds the routed
// rows sorted by expert and group-padded, so each tile of bm rows
// belongs to one expert, tile_gid [P / bm] (int32, non-decreasing) names
// it; w [E, d, h]. The forward contracts d (out [P, h]); the transposed
// form contracts h (out [P, d]); dw is [E, d, h] and an expert without
// rows gets zeros. Products accumulate in f32 and each output is
// rounded once, as the Pallas kernels' preferred_element_type=f32 and
// .astype do.
//
// Bound on the H100: operations. At the wide training shape (P 40576,
// d 3584, h 1408) one call is 409.5 GFLOP against some 0.5 GB moved:
// far above the card's flops-per-byte line.
//
// bf16 design (mma.sync m16n8k16, f32 accumulators):
//   K14: one CTA per (128-row tile, 128-column tile). The CTA reads its
//     expert id from tile_gid once (bm is a multiple of 128, so its rows
//     lie in one bm tile) and loops over the whole contraction in steps
//     of 32 through a ring of four shared-memory stages that cp.async
//     fills three tiles ahead. Eight warps, 2 x 4, each own a 64 x 32
//     block of the output in registers. The transposed form differs only in how the
//     B tile is stored ([n][k] instead of [k][n]) and so in how its
//     fragment is loaded: ldmatrix without .trans instead of with it.
//   K15: one CTA per (expert, 128 x 128 tile of [d, h]). The CTA finds
//     its expert's run of row tiles by a binary search of tile_gid on
//     the device, loops over those rows (the contraction) and writes its
//     tile once: zeros when the run is empty. The A operand is x^T: the
//     tile is stored [row][d] and its fragment loaded with .trans. No
//     atomics: every output element is written by one CTA, in one order.
//   Edges: rows, columns and the contraction are predicated with
//   cp.async's zero fill, so widths need only be multiples of 8 (16
//   bytes); offsets are 64-bit. Shared memory rows are padded (80 and
//   272 bytes) so that every ldmatrix is free of bank conflicts: 80 KB
//   a CTA (dynamic shared memory), two CTAs an SM. No wgmma or TMA yet
//   (later work).
//
// f32 (parity checks): the same grids over 64 x 64 tiles on the CUDA
// cores in f32 (not TF32), each thread a 4 x 4 block.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kLdK = kBK + 8;     // a tile stored [rows][k]: 80-byte rows
constexpr int kLdN = kBN + 8;     // a tile stored [k][cols]: 272-byte rows
constexpr int kStageA = (kBM * kLdK > kBK * kLdN ? kBM * kLdK : kBK * kLdN);
constexpr int kStageB = kStageA;  // the same two shapes
constexpr int kStages = 4;        // the cp.async ring
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) * kStages * (kStageA + kStageB);

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: no bytes read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The operands of one CTA's product C[m][n] = sum_k A[m][k] B[k][n] over
// k < klen, m < mlim, n < nlim (the CTA's tile origin already applied):
//   kTA false: A[m][k] at a[m * lda + k]; true: at a[k * lda + m].
//   kTB false: B[k][n] at b[k * ldb + n]; true: at b[n * ldb + k].
struct Operands {
  const bf16* a;
  const bf16* b;
  size_t lda, ldb;
  int mlim, nlim, klen;
};

// cp.async of k-tile kt into one stage; out-of-range chunks are zeros
template <bool kTA, bool kTB>
__device__ __forceinline__ void load_stage(bf16* as, bf16* bs,
                                           const Operands& op, int kt) {
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;  // 512 16-byte chunks a tile
    if (!kTA) {
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool ok = r < op.mlim && k0 + kc < op.klen;
      cp_async16(as + r * kLdK + kc,
                 ok ? op.a + (size_t)r * op.lda + k0 + kc : op.a, ok);
    } else {
      const int r = c >> 4, mc = (c & 15) * 8;
      const bool ok = k0 + r < op.klen && mc < op.mlim;
      cp_async16(as + r * kLdN + mc,
                 ok ? op.a + (size_t)(k0 + r) * op.lda + mc : op.a, ok);
    }
    if (!kTB) {
      const int r = c >> 4, nc = (c & 15) * 8;
      const bool ok = k0 + r < op.klen && nc < op.nlim;
      cp_async16(bs + r * kLdN + nc,
                 ok ? op.b + (size_t)(k0 + r) * op.ldb + nc : op.b, ok);
    } else {
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool ok = r < op.nlim && k0 + kc < op.klen;
      cp_async16(bs + r * kLdK + kc,
                 ok ? op.b + (size_t)r * op.ldb + k0 + kc : op.b, ok);
    }
  }
}

// acc[mi][ni] is the m16 x n8 block at rows wm*64 + mi*16, columns
// wn*32 + ni*8 of the CTA's 128 x 128 output (mma C fragment layout).
template <bool kTA, bool kTB>
__device__ __forceinline__ void mainloop(float acc[4][4][4],
                                         const Operands& op, bf16* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int j = lane >> 3, i8 = lane & 7;
  const int nk = (op.klen + kBK - 1) / kBK;
  // prologue: k-tiles 0 .. kStages - 2 in flight (one commit group each,
  // empty past the end, so the group count stays uniform)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nk)
      load_stage<kTA, kTB>(smem + st * (kStageA + kStageB),
                           smem + st * (kStageA + kStageB) + kStageA, op, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // k-tile kt has landed (this thread's)
    __syncthreads();  // ... everyone's; and k-tile kt - 1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      bf16* st = smem + (nxt % kStages) * (kStageA + kStageB);
      load_stage<kTA, kTB>(st, st + kStageA, op, nxt);
    }
    cp_async_commit();
    const bf16* as = smem + (kt % kStages) * (kStageA + kStageB);
    const bf16* bs = as + kStageA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r0 = wm * 64 + mi * 16;
        if (!kTA) {
          // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), rows of A
          ldsm_x4(af[mi], as + (r0 + (lane & 15)) * kLdK + kk +
                              (lane >> 4) * 8);
        } else {
          // A^T stored [k][m]: lane group j reads k half j/2, m half j%2
          ldsm_x4_t(af[mi], as + (kk + (j >> 1) * 8 + i8) * kLdN + r0 +
                                (j & 1) * 8);
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int c0 = wn * 32 + nj * 16;
        uint32_t r[4];
        if (!kTB) {
          // B stored [k][n]: lane group j reads k half j%2, n half j/2
          ldsm_x4_t(r, bs + (kk + (j & 1) * 8 + i8) * kLdN + c0 +
                           (j >> 1) * 8);
        } else {
          // B stored [n][k] (w[g] read as [out, k]): the same halves
          ldsm_x4(r, bs + (c0 + (j >> 1) * 8 + i8) * kLdK + kk +
                         (j & 1) * 8);
        }
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the CTA
}

// the accumulators, rounded once, to out (the CTA's origin, row stride
// ldo); rows past mlim and columns past nlim are skipped
__device__ __forceinline__ void store_tile(bf16* out, size_t ldo, int mlim,
                                           int nlim, float acc[4][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * 64 + mi * 16 + g + 8 * half;
      if (row >= mlim) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = wn * 32 + ni * 8 + 2 * t;
        if (col >= nlim) continue;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * ldo + col) = v;
      }
    }
}

__device__ __forceinline__ void zero(float acc[4][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// first index of tile_gid[0..n) (non-decreasing) that is >= v
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// K14: x [P, K]; w [E, K, N] (kTB false) or [E, N, K] (kTB true); y [P, N]
template <bool kTB>
__global__ void __launch_bounds__(kThreads)
    gmm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ tile_gid, bf16* __restrict__ y, int K,
             int N, int bm) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int e = tile_gid[m0 / bm];
  const bf16* we = w + (size_t)e * K * N;
  Operands op;
  op.a = x + (size_t)m0 * K;
  op.lda = K;
  op.b = kTB ? we + (size_t)n0 * K : we + n0;
  op.ldb = kTB ? K : N;
  op.mlim = kBM;
  op.nlim = N - n0;
  op.klen = K;
  float acc[4][4][4];
  zero(acc);
  mainloop<false, kTB>(acc, op, smem);
  store_tile(y + (size_t)m0 * N + n0, N, kBM, N - n0, acc);
}

// K15: x [P, D], dy [P, H] -> dw [E, D, H]
__global__ void __launch_bounds__(kThreads)
    gdw_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
             const int* __restrict__ tile_gid, bf16* __restrict__ dw, int D,
             int H, int nr, int bm) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  __shared__ int run[2];
  const int h0 = blockIdx.x * kBN, d0 = blockIdx.y * kBM, e = blockIdx.z;
  if (threadIdx.x == 0) {
    run[0] = lower_bound(tile_gid, nr, e);
    run[1] = lower_bound(tile_gid, nr, e + 1);
  }
  __syncthreads();
  const size_t r0 = (size_t)run[0] * bm;
  Operands op;
  op.a = x + r0 * D + d0;
  op.lda = D;
  op.b = dy + r0 * H + h0;
  op.ldb = H;
  op.mlim = D - d0;
  op.nlim = H - h0;
  op.klen = (run[1] - run[0]) * bm;
  float acc[4][4][4];
  zero(acc);
  if (op.klen > 0) mainloop<true, false>(acc, op, smem);
  store_tile(dw + (size_t)e * D * H + (size_t)d0 * H + h0, H, D - d0, H - h0,
             acc);
}

// ---- f32: 64 x 64 tiles on the CUDA cores ------------------------------------

constexpr int kFT = 64, kFK = 16;

// C[m][n] += sum_k A[m][k] B[k][n] over the operands of `op` (the same
// conventions as the bf16 Operands); each thread owns a 4 x 4 block
template <bool kTA, bool kTB>
__device__ __forceinline__ void simt_loop(float acc[4][4], const float* a,
                                          size_t lda, const float* b,
                                          size_t ldb, int mlim, int nlim,
                                          int klen) {
  __shared__ float as[kFK][kFT + 4];
  __shared__ float bs[kFK][kFT + 4];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int k0 = 0; k0 < klen; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * kThreads;
      int m, k, n, kb;
      if (!kTA) {
        m = idx / kFK;
        k = idx % kFK;
      } else {
        k = idx / kFT;
        m = idx % kFT;
      }
      const bool oka = m < mlim && k0 + k < klen;
      as[k][m] = oka ? (kTA ? a[(size_t)(k0 + k) * lda + m]
                            : a[(size_t)m * lda + k0 + k])
                     : 0.f;
      if (!kTB) {
        kb = idx / kFT;
        n = idx % kFT;
      } else {
        n = idx / kFK;
        kb = idx % kFK;
      }
      const bool okb = n < nlim && k0 + kb < klen;
      bs[kb][n] = okb ? (kTB ? b[(size_t)n * ldb + k0 + kb]
                             : b[(size_t)(k0 + kb) * ldb + n])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = as[k][ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = bs[k][tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void simt_store(float* out, size_t ldo, int mlim,
                                           int nlim, float acc[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = ty * 4 + r, n = tx * 4 + c;
      if (m < mlim && n < nlim) out[(size_t)m * ldo + n] = acc[r][c];
    }
}

template <bool kTB>
__global__ void __launch_bounds__(kThreads)
    gmm_f32(const float* __restrict__ x, const float* __restrict__ w,
            const int* __restrict__ tile_gid, float* __restrict__ y, int K,
            int N, int bm) {
  const int m0 = blockIdx.x * kFT, n0 = blockIdx.y * kFT;
  const int e = tile_gid[m0 / bm];
  const float* we = w + (size_t)e * K * N;
  float acc[4][4] = {};
  simt_loop<false, kTB>(acc, x + (size_t)m0 * K, K,
                        kTB ? we + (size_t)n0 * K : we + n0, kTB ? K : N,
                        kFT, N - n0, K);
  simt_store(y + (size_t)m0 * N + n0, N, kFT, N - n0, acc);
}

__global__ void __launch_bounds__(kThreads)
    gdw_f32(const float* __restrict__ x, const float* __restrict__ dy,
            const int* __restrict__ tile_gid, float* __restrict__ dw, int D,
            int H, int nr, int bm) {
  __shared__ int run[2];
  const int h0 = blockIdx.x * kFT, d0 = blockIdx.y * kFT, e = blockIdx.z;
  if (threadIdx.x == 0) {
    run[0] = lower_bound(tile_gid, nr, e);
    run[1] = lower_bound(tile_gid, nr, e + 1);
  }
  __syncthreads();
  const size_t r0 = (size_t)run[0] * bm;
  float acc[4][4] = {};
  simt_loop<true, false>(acc, x + r0 * D + d0, D, dy + r0 * H + h0, H,
                         D - d0, H - h0, (run[1] - run[0]) * bm);
  simt_store(dw + (size_t)e * D * H + (size_t)d0 * H + h0, H, D - d0, H - h0,
             acc);
}

// the bf16 kernels' dynamic shared memory is above the default 48 KB
template <typename F>
cudaError_t allow_smem(F* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace

// K14. x [P, K]; w [E, K, N], or [E, N, K] when transpose_rhs; tile_gid
// [P / bm] int32; y [P, N]. The caller checked: contiguous, 16-byte
// aligned, bm a multiple of 128, K and N multiples of 8.
extern "C" int grouped_matmul_fwd(const void* x, const void* w,
                                  const void* tile_gid, void* y, int P, int K,
                                  int N, int bm, int transpose_rhs, int dtype,
                                  void* stream) {
  if (P <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(tile_gid);
  if (dtype == ptt::kBFloat16) {
    const dim3 grid(P / kBM, (N + kBN - 1) / kBN);
    const bf16* xp = static_cast<const bf16*>(x);
    const bf16* wp = static_cast<const bf16*>(w);
    bf16* yp = static_cast<bf16*>(y);
    cudaError_t e;
    if (transpose_rhs) {
      if ((e = allow_smem(gmm_bf16<true>)) != cudaSuccess) return e;
      gmm_bf16<true><<<grid, kThreads, kSmemBytes, s>>>(xp, wp, gid, yp, K,
                                                        N, bm);
    } else {
      if ((e = allow_smem(gmm_bf16<false>)) != cudaSuccess) return e;
      gmm_bf16<false><<<grid, kThreads, kSmemBytes, s>>>(xp, wp, gid, yp, K,
                                                         N, bm);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == ptt::kFloat32) {
    const dim3 grid(P / kFT, (N + kFT - 1) / kFT);
    const float* xp = static_cast<const float*>(x);
    const float* wp = static_cast<const float*>(w);
    float* yp = static_cast<float*>(y);
    if (transpose_rhs)
      gmm_f32<true><<<grid, kThreads, 0, s>>>(xp, wp, gid, yp, K, N, bm);
    else
      gmm_f32<false><<<grid, kThreads, 0, s>>>(xp, wp, gid, yp, K, N, bm);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K15. x [P, D], dy [P, H], tile_gid [nr] int32 (P = nr * bm) -> dw
// [E, D, H]; every expert's block is written.
extern "C" int grouped_matmul_dw(const void* x, const void* dy,
                                 const void* tile_gid, void* dw, int D, int H,
                                 int E, int nr, int bm, int dtype,
                                 void* stream) {
  if (E <= 0 || D <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(tile_gid);
  if (dtype == ptt::kBFloat16) {
    const dim3 grid((H + kBN - 1) / kBN, (D + kBM - 1) / kBM, E);
    const cudaError_t e = allow_smem(gdw_bf16);
    if (e != cudaSuccess) return e;
    gdw_bf16<<<grid, kThreads, kSmemBytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dy), gid,
        static_cast<bf16*>(dw), D, H, nr, bm);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == ptt::kFloat32) {
    const dim3 grid((H + kFT - 1) / kFT, (D + kFT - 1) / kFT, E);
    gdw_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), gid,
        static_cast<float*>(dw), D, H, nr, bm);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
