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
// bf16 K14, both modes: a warp-specialised Hopper kernel (wgmma, TMA;
// hopper.cuh). Persistent: one CTA per SM walks the output tiles of 128
// rows x 256 columns, the column tiles of a row tile one after another,
// so that the CTAs running at once share their row tiles and their
// experts' w[e] in L2. A CTA reads a tile's expert from tile_gid once (bm
// is a multiple of 128, so the tile's rows lie in one bm tile). A
// producer warp TMA-loads the contraction in steps of 64 into a ring of
// four 128-byte-swizzled stages (48 KB each) behind mbarriers, running
// ahead into the next tile while the consumers store; two consumer
// warpgroups (setmaxnreg 232, the producer 40) each multiply 64 rows x
// 256 columns with SS wgmma (m64n256k16) and keep their f32 sums in
// registers, 128 a thread. A stage is released once the wgmmas of the
// step after it are issued, so two steps are in flight. The modes differ
// only in how the bank is read: the forward's B is w[e] [d, h] itself,
// boxes of 64 h-columns x 64 d-rows read MN-major (kTransB 1); the
// transposed form's B is w[e]^T, one box of 64 h-columns x 256 d-rows
// read K-major. TMA fills the contraction's tail and the columns past the
// edge with zeros. The output leaves by TMA stores from a staging buffer
// in shared memory, which clip it at N: widths need only be multiples of
// 8 (16-byte rows). Every output element is written once, in one order:
// no atomics, the same bits every run.
// What bounds it: the tile's epilogue, while the tensor cores wait. With
// every thread storing its sums straight to device memory the epilogue
// left them idle a large share of the time, most in the transposed form
// (its output is 2.5x wider); staged and stored by TMA, the last stores
// run under the next tile's products. 128-column tiles (a ring of six)
// ran slower on the card: they load 37% more bytes a flop from L2.
// Clusters of two CTAs on adjacent row tiles that multicast a shared
// expert's w tile (half the bank's traffic from L2) ran no faster.
// bf16 K15 (mma.sync m16n8k16, f32 accumulators): one CTA per (expert,
//   128 x 128 tile of [d, h]). The CTA finds its expert's run of row tiles
//   by a binary search of tile_gid on the device, loops over those rows
//   (the contraction) in steps of 32 through a ring of four shared-memory
//   stages that cp.async fills three ahead, and writes its tile once:
//   zeros when the run is empty. Eight warps, 2 x 4, each own a 64 x 32
//   block in registers. Both operands are stored [row][d or h] (x^T and
//   dy as the product reads them) and loaded with ldmatrix .trans; rows
//   are padded to 272 bytes so that every ldmatrix is free of bank
//   conflicts; cp.async's zero fill predicates the edges. No atomics.
//
// f32 (parity checks): on the CUDA cores in f32 (not TF32), one CTA per
// 64 x 64 output tile (K15: per expert and tile), each thread a 4 x 4
// block.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kLd = kBN + 8;      // a tile stored [k][128 cols]: 272-byte rows
constexpr int kStage = kBK * kLd;  // one operand's tile
constexpr int kStages = 4;        // the cp.async ring
constexpr size_t kSmemBytes = sizeof(__nv_bfloat16) * kStages * 2 * kStage;

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
// A[m][k] at a[k * lda + m] (x^T), B[k][n] at b[k * ldb + n] (dy).
struct Operands {
  const bf16* a;
  const bf16* b;
  size_t lda, ldb;
  int mlim, nlim, klen;
};

// cp.async of k-tile kt into one stage; out-of-range chunks are zeros
__device__ __forceinline__ void load_stage(bf16* as, bf16* bs,
                                           const Operands& op, int kt) {
  const int k0 = kt * kBK;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;  // 512 16-byte chunks a tile
    const int r = c >> 4, cc = (c & 15) * 8;
    const bool oka = k0 + r < op.klen && cc < op.mlim;
    cp_async16(as + r * kLd + cc,
               oka ? op.a + (size_t)(k0 + r) * op.lda + cc : op.a, oka);
    const bool okb = k0 + r < op.klen && cc < op.nlim;
    cp_async16(bs + r * kLd + cc,
               okb ? op.b + (size_t)(k0 + r) * op.ldb + cc : op.b, okb);
  }
}

// acc[mi][ni] is the m16 x n8 block at rows wm*64 + mi*16, columns
// wn*32 + ni*8 of the CTA's 128 x 128 output (mma C fragment layout).
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
      load_stage(smem + st * 2 * kStage, smem + (st * 2 + 1) * kStage, op,
                 st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // k-tile kt has landed (this thread's)
    __syncthreads();  // ... everyone's; and k-tile kt - 1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk) {
      bf16* st = smem + (nxt % kStages) * 2 * kStage;
      load_stage(st, st + kStage, op, nxt);
    }
    cp_async_commit();
    const bf16* as = smem + (kt % kStages) * 2 * kStage;
    const bf16* bs = as + kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // A^T stored [k][m]: lane group j reads k half j/2, m half j%2
        const int r0 = wm * 64 + mi * 16;
        ldsm_x4_t(af[mi], as + (kk + (j >> 1) * 8 + i8) * kLd + r0 +
                              (j & 1) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // B stored [k][n]: lane group j reads k half j%2, n half j/2
        const int c0 = wn * 32 + nj * 16;
        uint32_t r[4];
        ldsm_x4_t(r, bs + (kk + (j & 1) * 8 + i8) * kLd + c0 + (j >> 1) * 8);
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
  if (op.klen > 0) mainloop(acc, op, smem);
  store_tile(dw + (size_t)e * D * H + (size_t)d0 * H + h0, H, D - d0, H - h0,
             acc);
}

// ---- K14, bf16: warp-specialised wgmma ----------------------------------------

namespace hw = ptt::hopper;

constexpr int kWsThreads = 384;  // two consumer warpgroups, one producer
constexpr int kProducer = 256;   // the producer warpgroup's first thread
constexpr uint32_t kRowBytes = 128;  // one row of a 64-column box

// a CTA's output tile: BM rows x BN columns, the contraction in steps of
// BK; a ring of kRing stages (48 KB each), then the staging of the output
// for its TMA stores: 16 KB a warpgroup, two boxes of 64 rows x 64
// columns, which take its 64 x 256 sums in two halves
struct GmmWs {
  static constexpr int BM = 128, BN = 256, BK = 64;
  static constexpr int kRing = 4;
  static constexpr uint32_t a_box = BM * kRowBytes;  // x: one 128-row box
  static constexpr uint32_t b_bytes = BN * kRowBytes;
  static constexpr uint32_t stage = a_box + b_bytes;
  static constexpr uint32_t out_box = 64 * kRowBytes;  // 64 rows x 64 cols
  static constexpr uint32_t out = kRing * stage;
  static constexpr uint32_t out_wg = 2 * out_box;
  static constexpr uint32_t bars = out + 2 * out_wg;
  static constexpr uint32_t bytes = bars + 16 * kRing + 1024;  // + slack
};

// x [P, K] (map tm_x, boxes of 64 columns x 128 rows); the bank (map
// tm_w over [E, rows, cols]): w [E, K, N] in boxes of 64 x 64 (kTB
// false), or [E, N, K] in boxes of 64 x BN (kTB true); y [P, N]
template <bool kTB>
__global__ void __launch_bounds__(kWsThreads, 1)
    gmm_wgmma(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_w,
              const __grid_constant__ CUtensorMap tm_y,
              const int* __restrict__ tile_gid, int P, int K, int N,
              int bm) {
  using L = GmmWs;
  constexpr int BN = L::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::bars, empty0 = full0 + 8 * L::kRing;
  const int n_cols = (N + BN - 1) / BN;
  const int n_tiles = P / L::BM * n_cols;
  const int n_k = (K + L::BK - 1) / L::BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kRing; ++s) {
      hw::mbar_init(full0 + 8 * s, 1);
      hw::mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    hw::mbar_fence_init();
  }
  __syncthreads();

  if (hw::warpgroup_idx() == 2) {  // the producer warpgroup: one thread loads
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == kProducer) {
      int it = 0;  // stages filled so far, across tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_cols * L::BM, n0 = tile % n_cols * BN;
        const int e = tile_gid[m0 / bm];
        // the forward's boxes that hold columns below N (the others would
        // only feed columns the store clips)
        const int n_box = kTB ? 1 : min(BN / 64, (N - n0 + 63) / 64);
        const uint32_t tx =
            L::a_box + (kTB ? L::b_bytes : n_box * 64 * kRowBytes);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % L::kRing;
          const uint32_t st = base + s * L::stage, full = full0 + 8 * s;
          hw::mbar_wait(empty0 + 8 * s, ((it / L::kRing) & 1) ^ 1);
          hw::mbar_arrive_expect_tx(full, tx);
          hw::tma_load_2d(st, &tm_x, full, kt * L::BK, m0);
          if (kTB) {
            hw::tma_load_3d(st + L::a_box, &tm_w, full, kt * L::BK, n0, e);
          } else {
            for (int i = 0; i < n_box; ++i)
              hw::tma_load_3d(st + L::a_box + i * 64 * kRowBytes, &tm_w, full,
                              n0 + 64 * i, kt * L::BK, e);
          }
        }
      }
    }
  } else {  // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each tile
    hw::setmaxnreg_inc<232>();
    const int wg = hw::warpgroup_idx(), ct = threadIdx.x & 127;
    const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(empty0 + 8 * stage);
    };
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / n_cols * L::BM, n0 = tile % n_cols * BN;
      float acc[BN / 2];
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % L::kRing;
        const uint32_t st = base + s * L::stage;
        hw::mbar_wait(full0 + 8 * s, (it / L::kRing) & 1);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::BK / 16; ++kk) {
          // A: this warpgroup's 64 rows of x, K-major; B: K-major rows of
          // w[e]^T, or MN-major boxes of w[e] (a k16 step is 16 rows)
          const uint64_t a = hw::sw128_desc(
              st + wg * 64 * kRowBytes + kk * 32, 16, 1024);
          const uint64_t b =
              kTB ? hw::sw128_desc(st + L::a_box + kk * 32, 16, 1024)
                  : hw::sw128_desc(st + L::a_box + kk * 16 * kRowBytes,
                                   64 * kRowBytes, 1024);
          hw::Wgmma<BN>::ss<kTB ? 0 : 1>(acc, a, b, kt > 0 || kk > 0);
        }
        hw::wgmma_commit();
        // the step before this one is done: its stage may be refilled
        hw::wgmma_wait<1>();
        if (kt > 0) release((it - 1) % L::kRing);
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      release((it - 1) % L::kRing);
      // the sums rounded once to bf16 into this warpgroup's staging
      // boxes (swizzled as TMA reads them), 128 columns at a time, then
      // one TMA store a box; the last half's stores run on while the next
      // tile is multiplied. The previous stores must have read the boxes
      // first.
      const uint32_t ep = L::out + wg * L::out_wg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (ct == 0) hw::tma_store_wait_read<0>();
        hw::named_barrier_sync(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int j = half * (BN / 16) + jj;
            const int row = warp * 16 + g + 8 * i;
            const uint32_t at = ep + (jj / 8) * L::out_box +
                                row * kRowBytes +
                                (((jj % 8) ^ (row & 7)) << 4) + 4 * t;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(smem + at) = v;
          }
        hw::fence_async_smem();
        hw::named_barrier_sync(1 + wg, 128);
        if (ct == 0) {
          const int c0 = n0 + half * (BN / 2);
          const int n_box = min(2, (N - c0 + 63) / 64);
          for (int c = 0; c < n_box; ++c)
            hw::tma_store_2d(&tm_y, base + ep + c * L::out_box, c0 + 64 * c,
                             m0 + wg * 64);
          hw::tma_store_commit();
        }
      }
    }
    if (ct == 0) hw::tma_store_wait<0>();  // the last stores are done
  }
}

// launch K14 in bf16: one CTA per SM, or per tile when there are fewer
template <bool kTB>
cudaError_t gmm_bf16(const void* x, const void* w, const int* gid, void* y,
                     int E, int P, int K, int N, int bm, cudaStream_t s) {
  using L = GmmWs;
  constexpr int BN = L::BN;
  CUtensorMap tx, tw, ty;
  if (!hw::matrix_map(&tx, x, P, K, L::BM) ||
      !(kTB ? hw::bank_map(&tw, w, E, N, K, BN)
            : hw::bank_map(&tw, w, E, K, N, 64)) ||
      !hw::matrix_map(&ty, y, P, N, 64))
    return cudaErrorInvalidValue;
  auto kernel = gmm_wgmma<kTB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_tiles = P / L::BM * ((N + BN - 1) / BN);
  kernel<<<n_tiles < sms ? n_tiles : sms, kWsThreads, L::bytes, s>>>(
      tx, tw, ty, gid, P, K, N, bm);
  return cudaGetLastError();
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

// K15's dynamic shared memory is above the default 48 KB
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
                                  const void* tile_gid, void* y, int E,
                                  int P, int K, int N, int bm,
                                  int transpose_rhs, int dtype,
                                  void* stream) {
  if (P <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gid = static_cast<const int*>(tile_gid);
  if (K <= 0)  // an empty contraction: zeros
    return static_cast<int>(cudaMemsetAsync(
        y, 0, (size_t)P * N * (dtype == ptt::kFloat32 ? 4 : 2), s));
  if (dtype == ptt::kBFloat16) {
    return static_cast<int>(
        transpose_rhs ? gmm_bf16<true>(x, w, gid, y, E, P, K, N, bm, s)
                      : gmm_bf16<false>(x, w, gid, y, E, P, K, N, bm, s));
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
