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
// bf16 K15, the same design turned to the weight gradient dw[e] =
//   x[run e]^T @ dy[run e]: the output tile is 128 d-rows x 256 h-columns
//   of dw[e] and the contraction runs over the expert's rows, from
//   run[0] * bm to run[1] * bm in steps of 64, so both operands are read
//   MN-major: A = x^T in boxes of 64 d x 64 rows (wgmma's tnspA), B = dy
//   in boxes of 64 h x 64 rows, as the forward reads w[e]. Persistent CTAs
//   walk the tiles expert by expert, then d tile, then h tile: the CTAs
//   running at once share one expert's x and dy rows in L2. A CTA finds an
//   expert's run by a binary search of tile_gid on the device, once per
//   expert it visits (no host sync). The output leaves by K14's staged TMA
//   stores through a 3-D map over [E, d, h], which clip at d and h; an
//   expert without rows gets a tile of zeros through the same stores.
//   What bounds it: the per-tile epilogue against a short contraction (an
//   expert's ~676 rows at the wide shape are about 11 steps of 64), and
//   dw's 605 MB of stores. A three-stage ring with a second staging
//   buffer (no wait between the halves' stores), and tiles walked h
//   before d, ran no faster on the card. The mma.sync version it replaces
//   (one CTA per expert and 128 x 128 tile, 18480 CTAs at the wide shape,
//   a cp.async ring of 32-row steps, stores straight from registers) took
//   1.69 ms there on an H100 (PERF.md).
//
// f32 (parity checks): on the CUDA cores in f32 (not TF32), one CTA per
// 64 x 64 output tile (K15: per expert and tile), each thread a 4 x 4
// block.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // the f32 kernels' CTA

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

// ---- K15, bf16: warp-specialised wgmma ----------------------------------------

// dw[e] [D, H] = x[run e]^T @ dy[run e]: GmmWs's tile, ring and staging
// with the contraction over the expert's rows. A = x^T, two boxes of 64 d-columns x 64 rows of
// x, one a warpgroup, read MN-major (kTransA); B = dy, four boxes of 64
// h-columns x 64 rows, read MN-major (kTransB), as the forward reads the
// bank. Tiles run expert, then d tile, then h tile.
__global__ void __launch_bounds__(kWsThreads, 1)
    gdw_wgmma(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_dy,
              const __grid_constant__ CUtensorMap tm_dw,
              const int* __restrict__ tile_gid, int D, int H, int E, int nr,
              int bm) {
  using L = GmmWs;
  constexpr int BN = L::BN;
  constexpr uint32_t box = 64 * kRowBytes;  // 64 columns x 64 rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hw::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::bars, empty0 = full0 + 8 * L::kRing;
  const int n_h = (H + BN - 1) / BN, n_d = (D + L::BM - 1) / L::BM;
  const int n_tiles = E * n_d * n_h;
  // a tile's expert, origin and contraction: the expert's run of row
  // tiles, found once per expert by a binary search of tile_gid (runs are
  // multiples of bm, a multiple of 128 rows: a 64-row step never leaves
  // the expert)
  struct Tile {
    int e, d0, h0, r0, n_k;
  };
  int e_run = -1, r0_run = 0, nk_run = 0;
  auto tile_at = [&](int tile) {
    Tile T;
    T.e = tile / (n_d * n_h);
    const int rem = tile % (n_d * n_h);
    T.d0 = rem / n_h * L::BM;
    T.h0 = rem % n_h * BN;
    if (T.e != e_run) {
      const int lo = lower_bound(tile_gid, nr, T.e);
      const int hi = lower_bound(tile_gid, nr, T.e + 1);
      e_run = T.e;
      r0_run = lo * bm;
      nk_run = (hi - lo) * bm / L::BK;
    }
    T.r0 = r0_run;
    T.n_k = nk_run;
    return T;
  };

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
        const Tile T = tile_at(tile);
        // dy's boxes that hold columns below H (the others would only
        // feed columns the store clips)
        const int n_box = min(BN / 64, (H - T.h0 + 63) / 64);
        const uint32_t tx = 2 * box + n_box * box;
        for (int kt = 0; kt < T.n_k; ++kt, ++it) {
          const int s = it % L::kRing;
          const uint32_t st = base + s * L::stage, full = full0 + 8 * s;
          const int row = T.r0 + kt * L::BK;
          hw::mbar_wait(empty0 + 8 * s, ((it / L::kRing) & 1) ^ 1);
          hw::mbar_arrive_expect_tx(full, tx);
          hw::tma_load_2d(st, &tm_x, full, T.d0, row);
          hw::tma_load_2d(st + box, &tm_x, full, T.d0 + 64, row);
          for (int i = 0; i < n_box; ++i)
            hw::tma_load_2d(st + L::a_box + i * box, &tm_dy, full,
                            T.h0 + 64 * i, row);
        }
      }
    }
  } else {  // consumer warpgroup wg: d rows 64 wg .. 64 wg + 63 of a tile
    hw::setmaxnreg_inc<232>();
    const int wg = hw::warpgroup_idx(), ct = threadIdx.x & 127;
    const int warp = ct >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(empty0 + 8 * stage);
    };
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const Tile T = tile_at(tile);
      float acc[BN / 2];
      if (T.n_k == 0) {  // an expert without rows: a tile of zeros
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      }
      for (int kt = 0; kt < T.n_k; ++kt, ++it) {
        const int s = it % L::kRing;
        const uint32_t st = base + s * L::stage;
        hw::mbar_wait(full0 + 8 * s, (it / L::kRing) & 1);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::BK / 16; ++kk) {
          // both MN-major: a k16 step is 16 rows of the box further
          const uint64_t a =
              hw::sw128_desc(st + wg * box + kk * 16 * kRowBytes, box, 1024);
          const uint64_t b = hw::sw128_desc(
              st + L::a_box + kk * 16 * kRowBytes, box, 1024);
          hw::Wgmma<BN>::ss<1, 1>(acc, a, b, kt > 0 || kk > 0);
        }
        hw::wgmma_commit();
        // the step before this one is done: its stage may be refilled
        hw::wgmma_wait<1>();
        if (kt > 0) release((it - 1) % L::kRing);
      }
      if (T.n_k > 0) {
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        release((it - 1) % L::kRing);
      }
      // K14's epilogue: rounded once into the staging boxes, one TMA
      // store a box into dw[e] (clipped at D and H); the last half's
      // stores run on under the next tile's products
      const uint32_t ep = L::out + wg * L::out_wg;
      const int dr = T.d0 + wg * 64;
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
        if (ct == 0 && dr < D) {
          const int c0 = T.h0 + half * (BN / 2);
          const int n_box = min(2, (H - c0 + 63) / 64);
          for (int c = 0; c < n_box; ++c)
            hw::tma_store_3d(&tm_dw, base + ep + c * L::out_box, c0 + 64 * c,
                             dr, T.e);
          hw::tma_store_commit();
        }
      }
    }
    if (ct == 0) hw::tma_store_wait<0>();  // the last stores are done
  }
}

// launch K15 in bf16: one CTA per SM, or per tile when there are fewer
cudaError_t gdw_bf16(const void* x, const void* dy, const int* gid, void* dw,
                     int D, int H, int E, int nr, int bm, cudaStream_t s) {
  using L = GmmWs;
  const int P = nr * bm;
  CUtensorMap tx, tdy, tdw;
  if (!hw::matrix_map(&tx, x, P, D, 64) ||
      !hw::matrix_map(&tdy, dy, P, H, 64) ||
      !hw::bank_map(&tdw, dw, E, D, H, 64))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gdw_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int n_tiles =
      E * ((D + L::BM - 1) / L::BM) * ((H + L::BN - 1) / L::BN);
  gdw_wgmma<<<n_tiles < sms ? n_tiles : sms, kWsThreads, L::bytes, s>>>(
      tx, tdy, tdw, gid, D, H, E, nr, bm);
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
  if (dtype == ptt::kBFloat16)
    return static_cast<int>(gdw_bf16(x, dy, gid, dw, D, H, E, nr, bm, s));
  if (dtype == ptt::kFloat32) {
    const dim3 grid((H + kFT - 1) / kFT, (D + kFT - 1) / kFT, E);
    gdw_f32<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), gid,
        static_cast<float*>(dw), D, H, nr, bm);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
