// Block-floating-point integer matmul over int8 limb planes, in the three
// layouts of the integer layers' forward and backward products, on
// Hopper's int8 tensor cores (wgmma).
//
// Replaces the TPU kernels of repro/kernels/bfp_matmul.py (body
// _bfp_matmul_kernel :89, epilogue _combine_partials :66, _bfp_call :122,
// pallas_call :127):
//
//   bfp_matmul    (:147)  NN  out (M,N) = X (M,K) . W (K,N)     forward
//   bfp_matmul_nt (:176)  NT  dX  (M,K) = G (M,N) . W (K,N)^T   backward dX
//   bfp_matmul_tn (:210)  TN  dW  (K,N) = X (M,K)^T . G (M,N)   backward dW
//
// Written here for one output tile out (M,N) = A (M,K) . B (K,N):
//
//   acc[ja, jb] = A[ja] . B[jb]                    exact int32 per limb pair
//   out = sum_{ja outer, jb inner} (f32(acc) * 2^exp) * 2^(7(ja+jb))
//
// The batched (expert-axis) kernels of the same file are the same kernel
// with the expert on blockIdx.z (body _bfp_matmul_batched_kernel :244,
// _bfp_batched_call :276, pallas_call :281):
//
//   bfp_matmul_batched    (:302)  NN  out[e] = X[e] . W[e]     MoE forward
//   bfp_matmul_batched_nt (:332)  NT  dX[e]  = G[e] . W[e]^T   MoE dX
//   bfp_matmul_batched_tn (:362)  TN  dW[e]  = X[e]^T . G[e]   MoE dW
//
// Operands are plane-major (L, E, rows, cols): plane j of expert e starts at
// (j*E + e) * rows*cols.  Expert e scales by out_exp[e] and writes out[e];
// one launch covers every expert and every limb pair.  The unbatched
// products are the E = 1 case.
//
// The f32 combine runs in that fixed order with the same two exact
// power-of-two multiplies, so every int32 partial and every rounding of the
// sum is the reference's (the scale itself is built exactly, see pow2f).
// Every product is an exact integer, so the order of the MMA steps changes
// no bit; int32 wraps on overflow (no .satfinite): the tied head's dX
// contracts 152,064 terms, past the bound below.  A non-final limb digit
// lies in [-64, 63] and the final plane holds the carry (|carry| <= 64 for
// b <= 16 bits), an 8-bit mantissa plane |m| <= 127, so one product is
// < 2^14 and a sum over C terms is exact for C < 2^17 full-range terms.
//
// Layouts.  wgmma takes 8-bit operands only K-major (contraction-contiguous)
// from shared memory, so each operand is staged K-major into a tile of
// 128-byte rows (128 contraction steps) under the 128-byte swizzle:
//   A: (M,K) row-major (NN, NT: X or G as they are), or stored (K,M)
//      row-major, M-contiguous (TN: the saved activation X), staged
//      transposed.
//   B: (K,N) row-major (NN: a linear layer's weight; TN: the gradient G),
//      staged transposed; or stored (N,K) row-major, K-contiguous (the tied
//      LM head's planes, and NT's weight W (K,N), whose contraction axis N
//      is contiguous), staged as it is.
//
// Bound on the H100 (1,979 int8 TOP/s, 3.35 TB/s; every time here is
// `chip_smoke.py` phase 2 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md):
// in training and prefill (M = batch x sequence, or 256 capacity rows per
// expert) by operations: bert-base's w1 forward 4096x768x3072 at 2x1 limbs
// is 38.7 G int8 operations, 0.0195 ms at peak; qwen1.5-0.5b's MLP
// products 2048x1024x2816 0.0119 ms at 2x1.  At decode (M = 4 slots, or 16
// rows per expert) by bytes: the tied head streams 156 MB of int8 planes
// (0.0472 ms), the MoE experts' planes 173 MB (0.0544 ms); the 64-row MMA
// then multiplies mostly zero rows, which costs less than the bytes.
//
// Design.  One CTA computes a (64 * CW) x BN output tile, CW = 2 consumer
// warpgroups of 64 rows (CW = 1 when M <= 64: decode), beside one producer
// warpgroup, over a ring of up to 6 stages of 128 contraction steps:
// - Consumers issue wgmma.mma_async m64nBNk32 s32.s8.s8, one int32
//   accumulator per limb pair (BN / 2 registers a thread each), so the tile
//   width follows the pair count: BN = 128 for 1-2 pairs, 64 for 3-4, 32 for
//   6-9 (int16's 3x3), at most 144 accumulator registers of a thread's 168
//   (384 threads a CTA; ptxas allocates the consumers within that launch
//   bound, so setmaxnreg would buy nothing).  One group of MMAs stays in
//   flight while the next stage's is issued; a stage is released (its
//   `empty` mbarrier) when the MMAs reading it are done.
// - Thread 0 of the producer lands each stage by TMA (cuTensorMapEncodeTiled,
//   fetched through the runtime so the library needs no -lcuda;
//   SWIZZLE_128B; out-of-range bytes zero-filled): K-major operands as the
//   MMA reads them; operands stored contraction-major (B of NN, both of TN)
//   as they are stored, 128 contraction rows of 128 row bytes, which the
//   producer's warps then transpose in place — never in a separate pass
//   over device memory.  Each warp loads its items (64 tile rows x 32
//   contraction bytes; a lane 4 contraction rows of 16 bytes) into
//   registers, the warpgroup syncs on a named barrier, and the lanes
//   transpose 4 x 4 bytes with __byte_perm and store words of 4
//   contraction bytes; the lane-to-chunk map and per-lane selectors make
//   both the loads and the stores bank-conflict free under the swizzle.  A
//   fence.proxy.async orders the stores before the consumers' wgmma reads.
// - The ring is up to 6 stages deep.  Where TMA alone fills a stage (NT,
//   the tied head) its bytes complete the stage's `full` barrier and S - 1
//   stages stay in flight; where the warps transpose, thread 0 refills the
//   slot two stages back, whose MMAs are done, so the warpgroup never
//   waits on the MMAs its next stage could overlap (S - 2 in flight).
// - TMA needs 16-byte aligned rows, as every main-path K, M and N is (768
//   ... 3072); a ragged operand, or a transposed one whose tile is not 128
//   rows, is staged by the producer's threads from device memory into the
//   same swizzled layout (16-byte loads where rows are 16-byte aligned, 4
//   bytes or single bytes where not: cp.async cannot copy from rows that are
//   not 4-byte aligned either).
// - Every mbarrier wait but the consumers' on TMA-filled stages asks to
//   sleep until its phase completes, so idle warps leave the issue slots
//   to the producer; a wait past 2 s traps.
// - The epilogue reads the wgmma fragment layout, combines the pairs in the
//   reference's order and stores two adjacent columns as one 8-byte store.
// What bounds it now: the in-place transposes.  TN transposes both operands
// (48 KB a stage at 2x1 limbs) and runs at 13-15% of the int8 peak; NN
// (one operand) and NT (none) at 28-35%, on tiles that re-read their
// operands through L2 (no clusters or TMA multicast yet).  No split-K:
// int32 partials would add exactly, but the main-path shapes give 128-1,188
// tiles a launch, and launches per step stay one per call.
#include <cuda.h>

#include <algorithm>
#include <cstring>

#include "dfx_common.cuh"
#include "sm90_wgmma.cuh"

namespace {

constexpr int BK = 128;  // contraction bytes per stage: one swizzled row
constexpr int kMaxStages = 6;
// ring bytes a CTA may take: the card's 227 KB of shared memory a block,
// less the 1024-byte alignment slack and the barriers
constexpr int kSmemMax = 227 * 1024;
constexpr int kSmemBudget = kSmemMax - 1024 - 3 * kMaxStages * 8;
// One producer warpgroup beside up to two consumer warpgroups: 384
// threads of at most 168 registers.
constexpr int kProducerWarps = 4, kProducerThreads = 32 * kProducerWarps;

// Output-tile width by limb-pair count (accumulators stay <= 144 a thread).
__host__ __device__ constexpr int bn_for(int pairs) {
  return pairs <= 2 ? 128 : pairs <= 4 ? 64 : 32;
}

struct Params {
  const int8_t* A;
  const int8_t* B;
  const int* exp;
  float* out;
  int M, N, K, E;
  int stages;        // ring depth
  int staged;        // the producer's threads work on every stage
  int tma_a, tma_b;  // operand lands by TMA (a transposed one as stored,
                     // then transposed in place), else by the threads
  int vec_a, vec_b;  // rows staged by threads allow 4-byte loads (K-major)
                     // or 16-byte ones (transposed)
};

// Byte offset of (row r, contraction byte kk) in a swizzled K-major tile.
__device__ __forceinline__ int swz(int r, int kk) {
  return r * BK + ((((kk >> 4) ^ r) & 7) << 4) + (kk & 15);
}

__device__ __forceinline__ void st32(uint8_t* tile, int off, uint32_t w) {
  sm90::st_shared_u32(sm90::smem_u32(tile) + off, w);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Operands stored contraction-major, (Kc, R) row-major with R contiguous,
// are transposed into the K-major tile (rows r0 .. r0 + rows - 1 of R by
// 128 contraction bytes) in items of 64 tile rows x 32 contraction bytes,
// 4 a plane's 64 rows.  Item li covers rows 64 (li / 4) .. and the 16-byte
// contraction chunks g and g ^ 4, g = li % 4: lane (kq = lane / 4,
// c = lane % 4) takes rows +16c .. +16c + 15 of the 4 contraction bytes
// kk .. kk + 3, kk = 16 (g ^ 4 (kq / 4)) + 4 (kq % 4), and its __byte_perm
// selectors put row 4b + (w ^ c) in its word w of block b.  So at every
// 4-byte store the warp's lanes write 8 distinct swizzled chunks x 4
// words (32 banks), and each quarter warp's 16-byte loads of a raw tile
// (below) hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ void item_pos(int li, int lane, int& row,
                                         int& kk) {
  const int kq = lane >> 2;
  row = (li >> 2) * 64 + (lane & 3) * 16;
  kk = ((li & 3) ^ ((kq >> 2) << 2)) * 16 + (kq & 3) * 4;
}

// Transpose the 4 rows of 16 bytes in v (contraction bytes kk .. kk + 3)
// and store them as 16 words of the swizzled tile, rows row .. row + 15.
__device__ __forceinline__ void store_item(const uint4 (&v)[4], uint8_t* dst,
                                           int row, int kk, int lane) {
  const int c = lane & 3;
  const uint32_t s1a = c & 2 ? 0x7362 : 0x5140, s1b = c & 2 ? 0x5140 : 0x7362;
  const uint32_t s2a = c & 1 ? 0x7632 : 0x5410, s2b = c & 1 ? 0x5410 : 0x7632;
  const uint32_t base = sm90::smem_u32(dst) + row * BK + (kk & 15);
  const int kc = kk >> 4;  // row % 8 == 0
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t r0 = word(v[0], b), r1 = word(v[1], b),
                   r2 = word(v[2], b), r3 = word(v[3], b);
    const uint32_t t0 = __byte_perm(r0, r1, s1a), t1 = __byte_perm(r0, r1, s1b),
                   t2 = __byte_perm(r2, r3, s1a), t3 = __byte_perm(r2, r3, s1b);
    const uint32_t o[4] = {__byte_perm(t0, t2, s2a), __byte_perm(t0, t2, s2b),
                           __byte_perm(t1, t3, s2a), __byte_perm(t1, t3, s2b)};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int r = b * 4 + (w ^ c);
      sm90::st_shared_u32(base + r * BK + (((kc ^ r) & 7) << 4), o[w]);
    }
  }
}

// The direct path (tiles of fewer than 128 rows, or rows not 16-byte
// aligned): stage L planes straight from device memory, two items' loads
// in flight a warp, 16-byte loads where the rows allow (`vec`); bytes past
// R or Kc are zeros.
template <int L>
__device__ __forceinline__ void stage_transposed(
    const int8_t* src, long long plane, int R, int r0, int rows, uint8_t* dst,
    int k0, int Kc, bool vec, int warp, int lane) {
  constexpr int G = 2;                  // items' loads in flight a warp
  const int per = rows == 128 ? 8 : 4;  // items a plane (32 rows: half idle)
  for (int g = warp; g < L * per; g += G * kProducerWarps) {
    uint4 v[G][4];
    int row[G], kk[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int i = g + u * kProducerWarps;
      item_pos(i % per, lane, row[u], kk[u]);
      const int8_t* s = src + (i / per) * plane;
      const int r = r0 + row[u];
      const bool live = i < L * per && row[u] < rows && r < R;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kk[u] + j;
        v[u][j] = make_uint4(0, 0, 0, 0);
        if (!live || k >= Kc) continue;
        const int8_t* q = s + (long long)k * R + r;
        if (vec) {
          v[u][j] = __ldg(reinterpret_cast<const uint4*>(q));
        } else {
          uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int c = 0; c < 16; ++c)
            if (r + c < R) w[c >> 2] |= (uint32_t)(uint8_t)q[c] << (8 * (c & 3));
          v[u][j] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const int i = g + u * kProducerWarps;
      if (i < L * per && row[u] < rows)
        store_item(v[u], dst + (i / per) * BK * rows, row[u], kk[u], lane);
    }
  }
}

// In-place transposes: an aligned contraction-major tile of 128 rows lands
// by TMA in its stage slot as it is stored (128 contraction rows of 128
// bytes, SWIZZLE_128B: the 16-byte chunk rc of contraction row k at chunk
// rc ^ (k % 8)); each producer warp loads all its items of the stage into
// registers, the warpgroup syncs, and the items are stored back
// transposed into the same bytes, now the K-major tile.
__device__ __forceinline__ void load_raw_item(uint4 (&v)[4], uint32_t raw,
                                              int row, int kk) {
  const int rc = row >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = kk + j;
    v[j] = sm90::ld_shared_v4(raw + k * BK + (((rc ^ k) & 7) << 4));
  }
}

// Stage L planes of a K-major operand (rows, K) row-major by the producer's
// threads (a ragged K, or an unaligned base): one warp per tile row, a lane
// per 4-byte word; rows past `R` and bytes past K are zeros.
template <int L>
__device__ __forceinline__ void stage_kmajor(const int8_t* src,
                                             long long plane, int R, int r0,
                                             int rows, uint8_t* dst,
                                             int dst_plane, int k0, int K,
                                             bool vec, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < L; ++j)
    for (int r = warp; r < rows; r += kProducerWarps) {
      const int gr = r0 + r, k = k0 + lane * 4;
      uint32_t w = 0;
      if (gr < R) {
        const int8_t* p = src + j * plane + (long long)gr * K + k;
        if (vec && k + 4 <= K) {
          w = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k + c < K) w |= (uint32_t)(uint8_t)p[c] << (8 * c);
        }
      }
      st32(dst + j * dst_plane, swz(r, lane * 4), w);
    }
}

template <int BN>
__device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t a,
                                    uint64_t b) {
  if constexpr (BN == 128)
    sm90::wgmma_s8_n128(d, a, b);
  else if constexpr (BN == 64)
    sm90::wgmma_s8_n64(d, a, b);
  else
    sm90::wgmma_s8_n32(d, a, b);
}

// LAYOUT 0: A (M,K) K-major, B (K,N) staged transposed  (NN)
//        1: A (M,K) K-major, B stored (N,K) K-major     (tied head NN; NT)
//        2: A stored (K,M), B (K,N), both transposed    (TN)
template <int LX, int LW, int LAYOUT>
__global__ void __launch_bounds__(kProducerThreads + 256, 1)
bfp_mma_kernel(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_b, const Params p) {
  constexpr int P = LX * LW, BN = bn_for(P), NACC = BN / 2;
  constexpr bool a_t = LAYOUT == 2, b_t = LAYOUT != 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int cw = (blockDim.x - kProducerThreads) / 128, bm = 64 * cw;
  const int S = p.stages;
  const int a_tile = bm * BK, b_tile = BN * BK;
  const int stage_bytes = LX * a_tile + LW * b_tile;
  // per stage: `land` counts the TMA bytes, `full` the producer threads
  // (the tiles are ready), `empty` the consumer warps (the slot is free)
  uint64_t* land = reinterpret_cast<uint64_t*>(smem + S * stage_bytes);
  uint64_t* full = land + S;
  uint64_t* empty = full + S;
  const int e = blockIdx.z, m0 = blockIdx.y * bm, n0 = blockIdx.x * BN;
  const int nk = (p.K + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&land[s], 1);
      sm90::mbar_init(&full[s], p.staged ? kProducerThreads : 1);
      sm90::mbar_init(&empty[s], 4 * cw);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp < kProducerWarps) {
    // ---- producer warpgroup ------------------------------------------
    const long long mat_a = (long long)p.M * p.K, mat_b = (long long)p.K * p.N;
    const int8_t* A = p.A + e * mat_a;
    const int8_t* B = p.B + e * mat_b;
    // a transposed operand lands raw for in-place transposes when its tile
    // is 128 rows (TMA boxes of 128 row bytes): always for B (BN = 128 for
    // 1-2 pairs), for A unless CW = 1
    constexpr bool b_raw_ok = b_t && BN == 128;
    constexpr int kBItem = a_t ? 2 * LX : 0;
    constexpr int kItems = kBItem + (b_raw_ok ? 2 * LW : 0) > 0
                               ? kBItem + (b_raw_ok ? 2 * LW : 0) : 1;
    const bool raw_a = a_t && p.tma_a, raw_b = b_raw_ok && p.tma_b;
    const uint32_t tx = (p.tma_a ? LX * a_tile : 0) + (p.tma_b ? LW * b_tile : 0);
    // thread 0: stage t's TMA loads, once its slot is free (t - S done)
    auto issue = [&](int t) {
      const int u = t % S;
      sm90::mbar_wait(&empty[u], ((t / S) & 1) ^ 1);
      if (!tx) return;
      uint8_t* sa = smem + u * stage_bytes;
      uint8_t* sb = sa + LX * a_tile;
      // with no thread work on the stage, the bytes complete `full` itself
      uint64_t* bar = p.staged ? &land[u] : &full[u];
      sm90::fence_proxy_async();
      sm90::mbar_arrive_expect_tx(bar, tx);
      if (p.tma_a)  // K-major: (k, row) boxes; transposed: (row, k) boxes
        for (int j = 0; j < LX; ++j)
          sm90::tma_load_3d(sa + j * a_tile, &tm_a, bar, a_t ? m0 : t * BK,
                            a_t ? t * BK : m0, j * p.E + e);
      if (p.tma_b)
        for (int j = 0; j < LW; ++j)
          sm90::tma_load_3d(sb + j * b_tile, &tm_b, bar, b_t ? n0 : t * BK,
                            b_t ? t * BK : n0, j * p.E + e);
    };
    // Thread 0 keeps S - 1 stages in flight where TMA alone fills them; on
    // a stage the producer's warps work on, it refills the slot two stages
    // back (whose MMAs are done), so it never waits on the MMAs the
    // warpgroup's next stage could overlap: S - 2 stages in flight
    const int ahead = p.staged ? S - 2 : S - 1;
    if (threadIdx.x == 0)
      for (int t = 0; t < ahead && t < nk; ++t) issue(t);
    for (int kt = 0; kt < nk; ++kt) {
      if (!p.staged) {
        if (threadIdx.x == 0 && kt + ahead < nk) issue(kt + ahead);
        continue;
      }
      const int s = kt % S, k0 = kt * BK;
      uint8_t* sa = smem + s * stage_bytes;
      uint8_t* sb = sa + LX * a_tile;
      if (tx) sm90::mbar_wait(&land[s], (kt / S) & 1);
      // the raw items (8 a plane, 2 a warp), loaded before the
      // warpgroup's barrier and stored back transposed after it
      uint4 v[kItems][4];
      if (raw_a)
#pragma unroll
        for (int i = 0; i < 2 * LX; ++i) {
          int row, kk;
          item_pos(warp + 4 * (i & 1), lane, row, kk);
          load_raw_item(v[i], sm90::smem_u32(sa + (i >> 1) * a_tile), row, kk);
        }
      if (raw_b)
#pragma unroll
        for (int i = 0; i < 2 * LW; ++i) {
          int row, kk;
          item_pos(warp + 4 * (i & 1), lane, row, kk);
          load_raw_item(v[kBItem + i], sm90::smem_u32(sb + (i >> 1) * b_tile),
                        row, kk);
        }
      sm90::bar_sync(1, kProducerThreads);
      if (raw_a)
#pragma unroll
        for (int i = 0; i < 2 * LX; ++i) {
          int row, kk;
          item_pos(warp + 4 * (i & 1), lane, row, kk);
          store_item(v[i], sa + (i >> 1) * a_tile, row, kk, lane);
        }
      if (raw_b)
#pragma unroll
        for (int i = 0; i < 2 * LW; ++i) {
          int row, kk;
          item_pos(warp + 4 * (i & 1), lane, row, kk);
          store_item(v[kBItem + i], sb + (i >> 1) * b_tile, row, kk, lane);
        }
      if (a_t && !raw_a)
        stage_transposed<LX>(A, mat_a * p.E, p.M, m0, bm, sa, k0, p.K,
                             p.vec_a, warp, lane);
      if (b_t && !raw_b)
        stage_transposed<LW>(B, mat_b * p.E, p.N, n0, BN, sb, k0, p.K,
                             p.vec_b, warp, lane);
      if (!a_t && !p.tma_a)
        stage_kmajor<LX>(A, mat_a * p.E, p.M, m0, bm, sa, a_tile, k0, p.K,
                         p.vec_a, warp, lane);
      if (!b_t && !p.tma_b)
        stage_kmajor<LW>(B, mat_b * p.E, p.N, n0, BN, sb, b_tile, k0, p.K,
                         p.vec_b, warp, lane);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[s]);
      if (threadIdx.x == 0 && kt + ahead < nk) issue(kt + ahead);
    }
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------
  const int wg = (warp - kProducerWarps) / 4;
  int acc[P][NACC];
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[q][i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    if (p.staged)
      sm90::mbar_wait(&full[s], (kt / S) & 1);
    else  // TMA's bytes complete it: poll for the shortest wake-up
      sm90::mbar_wait<false>(&full[s], (kt / S) & 1);
    const uint8_t* sa = smem + s * stage_bytes;
    const uint64_t da = sm90::desc_sw128(sa + wg * 64 * BK);
    const uint64_t db = sm90::desc_sw128(sa + LX * a_tile);
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int i = 0; i < NACC; ++i) sm90::reg_fence(acc[q][i]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
      for (int ja = 0; ja < LX; ++ja)
#pragma unroll
        for (int jb = 0; jb < LW; ++jb)
          mma<BN>(acc[ja * LW + jb], da + ((ja * a_tile) >> 4) + 2 * kk,
                  db + ((jb * b_tile) >> 4) + 2 * kk);
    sm90::wgmma_commit();
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int i = 0; i < NACC; ++i) sm90::reg_fence(acc[q][i]);
    // the previous stage's MMAs are done: hand its slot back
    sm90::wgmma_wait<1>();
    if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % S]);
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < P; ++q)
#pragma unroll
    for (int i = 0; i < NACC; ++i) sm90::reg_fence(acc[q][i]);

  // Epilogue: ordered f32 combine of the per-pair partials (x-limbs outer,
  // w-limbs inner), each term (f32(acc) * 2^exp) * 2^(7(jx+jw)); thread
  // (warp wi of the warpgroup, lane l) holds rows 16 wi + l/4 (+8) and
  // columns 8t + 2(l%4) (+1) of its warpgroup's 64 rows.
  const float s0 = dfx::pow2f(p.exp[e]);
  float* out = p.out + (long long)e * p.M * p.N;
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const bool v2 = (p.N % 2) == 0;
#pragma unroll
  for (int t = 0; t < BN / 8; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h, n = n0 + 8 * t + 2 * (lane % 4);
      if (m >= p.M || n >= p.N) continue;
      float o[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = t * 4 + h * 2 + c;
#pragma unroll
        for (int jx = 0; jx < LX; ++jx)
#pragma unroll
          for (int jw = 0; jw < LW; ++jw) {
            const float part =
                __fmul_rn(__fmul_rn((float)acc[jx * LW + jw][i], s0),
                          dfx::pow2f(dfx::kLimbBits * (jx + jw)));
            o[c] = (jx == 0 && jw == 0) ? part : __fadd_rn(o[c], part);
          }
      }
      float* dst = out + (long long)m * p.N + n;
      if (v2) {
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      } else {
        dst[0] = o[0];
        if (n + 1 < p.N) dst[1] = o[1];
      }
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), fetched through the
// runtime so the library links without -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// 3-d map over `mats` row-major int8 matrices (rows, cols): boxes of 128
// bytes of a row x box_rows rows of one matrix, 128-byte swizzle, zeros
// outside.  A K-major operand maps (rows, K); one stored contraction-major
// maps (K, rows), its boxes 128 contraction rows.
int tile_map(CUtensorMap* map, const int8_t* base, int cols, int rows,
             int mats, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)rows * cols};
  const cuuint32_t box[3] = {BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                         const_cast<int8_t*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int LX, int LW, int LAYOUT>
int launch_layout(Params p, cudaStream_t stream) {
  constexpr int BN = bn_for(LX * LW);
  constexpr bool a_k = LAYOUT != 2, b_k = LAYOUT == 1;
  const int cw = p.M <= 64 ? 1 : 2, bm = 64 * cw;
  if ((p.M + bm - 1) / bm > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  std::memset(&ta, 0, sizeof(ta));
  std::memset(&tb, 0, sizeof(tb));
  // K-major operands by TMA when their rows are 16-byte aligned; stored
  // contraction-major ones by TMA too (transposed in place) when theirs are
  // and the tile is 128 rows, else by the producer's threads
  p.tma_a = a_k ? p.K % 16 == 0 && aligned(p.A, 16)
                : bm == 128 && p.M % 16 == 0 && aligned(p.A, 16);
  p.tma_b = b_k ? p.K % 16 == 0 && aligned(p.B, 16)
                : BN == 128 && p.N % 16 == 0 && aligned(p.B, 16);
  p.vec_a = a_k ? p.K % 4 == 0 && aligned(p.A, 4)
                : p.M % 16 == 0 && aligned(p.A, 16);
  p.vec_b = b_k ? p.K % 4 == 0 && aligned(p.B, 4)
                : p.N % 16 == 0 && aligned(p.B, 16);
  int err;
  if (p.tma_a && (err = a_k ? tile_map(&ta, p.A, p.K, p.M, LX * p.E, bm)
                            : tile_map(&ta, p.A, p.M, p.K, LX * p.E, BK)))
    return err;
  if (p.tma_b && (err = b_k ? tile_map(&tb, p.B, p.K, p.N, LW * p.E, BN)
                            : tile_map(&tb, p.B, p.N, p.K, LW * p.E, BK)))
    return err;
  p.staged = !(a_k && p.tma_a && b_k && p.tma_b);
  const int stage_bytes = (LX * bm + LW * BN) * BK;
  p.stages = std::min(kMaxStages, kSmemBudget / stage_bytes);
  if (p.stages < 3) return (int)cudaErrorInvalidConfiguration;
  const int smem = p.stages * (stage_bytes + 3 * 8) + 1024;
  auto kernel = bfp_mma_kernel<LX, LW, LAYOUT>;
  static bool smem_set = false;
  if (!smem_set) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err) return err;
    smem_set = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + bm - 1) / bm, p.E);
  kernel<<<grid, kProducerThreads + 128 * cw, smem, stream>>>(ta, tb, p);
  return 0;
}

template <int LX, int LW>
int launch(const Params& p, int layout, cudaStream_t stream) {
  switch (layout) {
    case 0: return launch_layout<LX, LW, 0>(p, stream);
    case 1: return launch_layout<LX, LW, 1>(p, stream);
    case 2: return launch_layout<LX, LW, 2>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out (E, M, N) f32, out[e] = A[e] (M, K) . B[e] (K, N) over int8 limb
// planes (la of A, lb of B, plane-major: (la, E, ...) and (lb, E, ...)),
// each expert's matrices stored as `layout` says:
//   0  A (M,K) row-major, B (K,N) row-major         NN: X . W
//   1  A (M,K) row-major, B stored (N,K) row-major   NN tied head; NT: G . W^T
//   2  A stored (K,M) row-major, B (K,N) row-major   TN: X^T . G
// exp: E int32 in device memory (each expert's two operands' exponents
// summed).  The unbatched products are E = 1.
extern "C" int bfp_matmul_launch(const int8_t* A, const int8_t* B,
                                 const int* exp, float* out, int M, int N,
                                 int K, int E, int la, int lb, int layout,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || E <= 0) return 0;
  if (K < 0 || E > 65535) return (int)cudaErrorInvalidValue;
  Params p{};
  p.A = A;
  p.B = B;
  p.exp = exp;
  p.out = out;
  p.M = M;
  p.N = N;
  p.K = K;
  p.E = E;
  int err;
  switch (la * 4 + lb) {
    case 5: err = launch<1, 1>(p, layout, stream); break;
    case 6: err = launch<1, 2>(p, layout, stream); break;
    case 7: err = launch<1, 3>(p, layout, stream); break;
    case 9: err = launch<2, 1>(p, layout, stream); break;
    case 10: err = launch<2, 2>(p, layout, stream); break;
    case 11: err = launch<2, 3>(p, layout, stream); break;
    case 13: err = launch<3, 1>(p, layout, stream); break;
    case 14: err = launch<3, 2>(p, layout, stream); break;
    case 15: err = launch<3, 3>(p, layout, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
