// Integer flash-attention backward over int8 limb planes: dq, and dk + dv.
//
// Replaces the TPU kernels repro/kernels/int_attention.py::int_attn_bwd_dq
// (:328, pallas_call :359; body _int_attn_bwd_dq_kernel :286) and
// ::int_attn_bwd_dkv (:441, pallas_call :472; body
// _int_attn_bwd_dkv_kernel :390).  Both recompute the scores and P from
// the forward's per-row lse (no S x S residual), exactly as the forward
// (csrc/int_attention.cu) computes them:
//
//   s   = sc * sum_pairs (f32(q_limb . k_limb) * 2^(qe+ke)) * 2^(7(ja+jb))
//   p   = ok ? exp(s - lse) : 0,  ok = kpos < Sk & causal & window
//                                       on qpos = q_off[b] + i
//   dp  = sum_pairs (f32(g_limb . v_limb) * 2^(ge+ve)) * 2^(7(ja+jb))
//   ds  = p * (dp - delta)
//   dsm = clip(rint(ds * 2^-dse), +-(2^(ds_bits-1) - 1))   limb planes
//   pm  = clip(rint(p * 2^(pb-1)))                         limb planes
//
//   dq  = sc * sum_keyblocks sum_pairs (f32(dsm_limb . k_limb) * 2^(dse+ke))
//                                      * 2^(7(ja+jb))
//   dv  =      sum_qblocks   sum_pairs (f32(pm_limb . g_limb) * 2^ge)
//                                      * 2^(7(ja+jb) - (pb-1))
//   dk  = sc * sum_qblocks   sum_pairs (f32(dsm_limb . q_limb) * 2^(dse+qe))
//                                      * 2^(7(ja+jb))
//
// kept_ops="integer" (template flag IntExp, the same launch): p's exp is
// iapprox::i_exp (Q.14, iapprox.cuh), as the reference's _p_exp :147.
//
// Each limb pair is its own exact int32 dot, converted and combined in f32
// in pair order (first operand's limbs outer); each f32 expression is the
// reference's, in its order (explicit _rn intrinsics, no FMA contraction;
// expf, not __expf).  The f32 sums over blocks are part of the result, so
// the blocks are the reference's: dq sums over 128-key blocks (its bk), dk
// and dv over blocks of bq query rows (its bq = min(128, Sq rounded up to
// 8)) of each group head in turn, group-major, so for GQA dk and dv are the
// sums over the G query heads of the kv head, in a fixed order.  A 32-wide
// sub-tile that the mask hides from every row of a warp contributes exactly
// 0 to the block's int32 sums and is skipped.
//
// Layout: the model layout, as the forward: q and g (L, B, Sq, KV, G, hd),
// k and v (L, B, Sk, KV, hd); lse (B, KV, G, Sq); delta (B, Sq, KV, G); dq
// (B, Sq, KV, G, hd), dk and dv (B, Sk, KV, hd) f32.  No transpose or
// padding pass runs in device memory: hd is zero-padded to the MMA depth
// (32) in shared memory.
//
// Bound on the H100 at the qwen1.5-0.5b training shape (8 x 256, 16 heads
// of 64, causal, int8 preset): bytes, 7.0 us (dq) and 9.5 us (dkv) for each
// plane, row and output moved once, against 4.3 / 5.4 G int8 operations
// (2.2 / 2.7 us at 1,979 TOP/s) and the f32 recompute of 4.2 M visible
// scores at ~70 operations each (~4.4 us at 67 TFLOP/s).
//
// Design.  Every integer product is a tensor-core mma.sync m16n8k32
// (s8 x s8 -> s32, sm90_ptx.cuh), its fragments read with ldmatrix; 8-bit
// MMA takes both operands K-major, so each product is arranged to contract
// along a contiguous axis:
//   dq:  a CTA of nw warps (4 where shared memory allows) owns 16 nw query
//        rows of one (batch, kv head, group head); Q and dO rows stay
//        resident.  K and V stream through a two-stage cp.async ring of
//        32-key sub-tiles.  Per sub-tile each warp computes S = Q K^T and
//        dP = dO V^T (16 x 32, one limb pair at a time over hd), then p and
//        dS in the accumulator registers, and packs dS's digits straight
//        into A fragments (warp-private shared memory).  K is transposed
//        into K^T rows by word loads and a 4x4 byte transpose
//        (__byte_perm).  At a 128-key block's end, dQ's pairs over the
//        block's keys (one pair at a time, int32 carried over its four
//        sub-tiles) are combined and added to the warp's f32 sums
//        (registers).
//   dkv: a CTA owns 16 nw keys of one (batch, kv head); K and V rows stay
//        resident.  Q, dO, lse and delta stream through the ring in 32-row
//        sub-tiles, group head by group head.  Each warp computes the
//        transposed S^T = K Q^T and dP^T = V dO^T (A = K / V rows, B = Q /
//        dO rows, both natively K-major), so P^T and dS^T come out with
//        keys as rows: the A operand of dV = P^T dO and dK = dS^T Q.  Q and
//        dO are transposed into Q^T / dO^T rows of the reference's q block;
//        at the block's end the pairs contract over its rows and are
//        combined into the warp's f32 dk / dv sums (registers up to hd 64,
//        shared memory beyond).
// C-layout scores become A fragments without a shuffle: a thread holds
// columns 8j + 2t, 8j + 2t + 1 of each 8-wide tile j, so the k order of the
// second contraction is permuted within each 32-wide step (kpos below) and
// the transposed B rows are written in that same order.  Int32 sums are
// exact, so the permutation changes no bit.  Accumulator registers do not
// grow with the limb-pair count: each pair's contraction completes before
// the next starts.  A smaller CTA (2 or 1 warps) is taken at launch where
// the limb counts and hd need more shared memory than 227 KB.  These
// staged bodies take hd <= 256: one instantiation per 32-column chunk
// count up to 4 (hd 128), and one of 8 chunks for 128 < hd <= 256
// (zero-padded to 256 in shared memory), whose f32 sums live in shared
// memory (dq too) and whose CTA is narrower (dkv: 1 warp at the int8
// preset's limb counts).  Every other shape (hd > 256, or 2-3 limb planes
// at 128 < hd <= 256, over 227 KB even for one warp) takes the direct
// bodies at the end of this file: fragments straight from global memory,
// each dot converted exactly (cvt.rn) however deep, shared memory bounded
// at any hd (attn_mma.cuh).
//
// What the card measured (chip_smoke.py phase 2, PERF.md): with the MMAs
// in place the f32 recompute per score is the larger cost, so it avoids
// the quarter-rate conversion pipe (int <-> float by magic-number
// arithmetic, one exact fma per pair combine where the scales allow) and
// runs branch-free per element (masks as selects, and no mask at all on a
// tile every row of which sees every key).
#include "attn_mma.cuh"

#include <type_traits>

namespace {

struct Params {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const int8_t* g;
  const float* lse;
  const float* delta;
  const int* off;
  const int* exps;  // [q, k, v, g, dS] exponents
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, KV, G, hd;
  int lqk, lv, lg, lds;  // limb planes of q/k, v (and P), g, dS
  int p_bits, ds_bits, causal, window, bq;
  float sc;
  int nw, hdp, vec;  // warps per CTA, hd rounded up to 32, copy bytes
};

// dkv keeps its f32 dk / dv sums in registers up to hd 64 (two 32-column
// chunks: 64 registers), dq its dq sums up to hd 128 (64 registers); in
// shared memory beyond.
__host__ __device__ constexpr bool sums_in_regs(bool dkv, int chunks) {
  return chunks <= (dkv ? 2 : 4);
}

// Shared-memory carve-up (byte offsets, each a multiple of 16).
struct Smem {
  int hp;        // byte stride of a staged row (hdp + 16: conflict-free)
  size_t res;    // resident rows: dq Q + dO (16 nw rows); dkv K + V
  size_t stage;  // one ring stage: dq K + V of 32 keys; dkv Q + dO of 32
                 // query rows, then their lse and delta (f32)
  size_t ring, tr, priv, acc, end;
};

__host__ __device__ inline Smem smem_layout(const Params& p, bool dkv) {
  Smem m;
  m.hp = p.hdp + 16;
  const size_t R = 16 * p.nw;
  size_t o = 0;
  m.res = o;
  o += (size_t)(dkv ? p.lqk + p.lv : p.lqk + p.lg) * R * m.hp;
  m.stage = (size_t)(dkv ? p.lqk + p.lg : p.lqk + p.lv) * KS * m.hp +
            (dkv ? 2 * KS * sizeof(float) : 0);
  m.ring = o;
  o += kStages * m.stage;
  m.tr = o;  // dq K^T [lqk][hdp][TP]; dkv Q^T [lqk] then dO^T [lg]
  o += (size_t)(dkv ? p.lqk + p.lg : p.lqk) * p.hdp * TP;
  m.priv = o;  // per warp: A fragments, dq dS limbs; dkv P then dS limbs
  o += (size_t)p.nw * (dkv ? p.lv + p.lds : p.lds) * kLimbWords * 4;
  m.acc = o;  // per warp: the f32 sums (dkv: dk then dv) not in registers
  if (!sums_in_regs(dkv, p.hdp / KS))
    o += (size_t)p.nw * (dkv ? 2 : 1) * p.hdp * 16 * sizeof(float);
  m.end = o;
  return m;
}

// ---------------------------------------------------------------- dq ----

template <int NDC, bool IntExp>
__global__ void __launch_bounds__(128) dq_kernel(const Params p) {
  constexpr int HDP = KS * NDC, HP = HDP + 16;
  constexpr bool kRegSums = sums_in_regs(false, NDC);
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = smem_layout(p, false);
  const int hd = p.hd, R = 16 * p.nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int sq0 = blockIdx.x * R;
  const int rows = min(R, p.Sq - sq0);
  int8_t* res = reinterpret_cast<int8_t*>(smem + m.res);  // Q, then dO
  int8_t* gres = res + p.lqk * R * HP;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + m.ring);
  int8_t* kt = reinterpret_cast<int8_t*>(smem + m.tr);
  uint4* fa = reinterpret_cast<uint4*>(smem + m.priv) +
              warp * p.lds * kLimbWords / 4;
  float* sums = reinterpret_cast<float*>(smem + m.acc) + warp * HDP * 16;
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const long long qrow = (long long)p.KV * p.G * hd;  // q row stride
  const long long krow = (long long)p.KV * hd;        // k row stride
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float sdp = dfx::pow2f(p.exps[3] + p.exps[2]);
  const int dse = p.exps[4];
  const float sdq = dfx::pow2f(dse + p.exps[1]);
  const float inv_ds = dfx::pow2f(-dse);
  const bool fast = fma_exact(p.exps[0] + p.exps[1], 0) &&
                    fma_exact(p.exps[3] + p.exps[2], 0) &&
                    fma_exact(dse + p.exps[1], 0);
  const int a_off = 16 * warp * HP + a_lane(lane, HP);
  const int b_off = b_lane(lane, HP), t_off = b_lane(lane, TP);

  zero_pad(res, (p.lqk + p.lg) * R, HP, hd, HDP);
  zero_pad(ring, kStages * (p.lqk + p.lv) * KS, HP, hd, HDP);
  const long long q_base = (((long long)b * p.Sq + sq0) * p.KV + h) * p.G * hd +
                           (long long)g * hd;
  stage_rows(p, HP, res, p.q + q_base, qplane, qrow, p.lqk, R, rows);
  stage_rows(p, HP, gres, p.g + q_base, qplane, qrow, p.lg, R, rows);

  // This lane's rows r_lo and r_lo + 8 (of the CTA's), their lse, delta.
  const int r_lo = 16 * warp + (lane >> 2);
  float lse_r[2], del_r[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = sq0 + r_lo + 8 * i;
    row_ok[i] = r < p.Sq;
    lse_r[i] = row_ok[i]
        ? p.lse[(((long long)b * p.KV + h) * p.G + g) * p.Sq + r] : 0.0f;
    del_r[i] = row_ok[i]
        ? p.delta[(((long long)b * p.Sq + r) * p.KV + h) * p.G + g] : 0.0f;
  }
  const int q_lo = off + sq0, q_hi = off + sq0 + rows - 1;
  const int wrows = min(16, p.Sq - sq0 - 16 * warp);
  const int wq_lo = q_lo + 16 * warp, wq_hi = wq_lo + wrows - 1;
  const int n_st = (p.Sk + KS - 1) / KS;
  // Sub-tile st (keys 32st..) visible to some query position in lo..hi?
  auto live = [&](int st, int lo, int hi) {
    const int k0 = st * KS, k1 = min(k0 + KS, p.Sk) - 1;
    return !(p.causal && k0 > hi) && !(p.window >= 0 && k1 <= lo - p.window);
  };
  auto next = [&](int st) {
    while (st < n_st && !live(st, q_lo, q_hi)) ++st;
    return st;
  };
  auto issue = [&](int st, int stage) {
    const int k0 = st * KS;
    int8_t* dst = ring + stage * m.stage;
    const long long k_base = (((long long)b * p.Sk + k0) * p.KV + h) * hd;
    const int nk = min(KS, p.Sk - k0);
    stage_rows(p, HP, dst, p.k + k_base, kplane, krow, p.lqk, KS, nk);
    stage_rows(p, HP, dst + p.lqk * KS * HP, p.v + k_base, kplane, krow,
               p.lv, KS, nk);
  };

  int prod = next(0);
  for (int s = 0; s < kStages - 1; ++s) {  // group 0 holds Q and dO too
    if (prod < n_st) {
      issue(prod, s);
      prod = next(prod + 1);
    }
    ptx::cp_async_commit();
  }
  Sums<NDC, kRegSums> acc(sums, lane);
  unsigned live_ks = 0;  // the warp's k-steps of the current key block
  for (int cur = next(0), it = 0; cur < n_st; ++it) {
    if (prod < n_st) {
      issue(prod, (it + kStages - 1) % kStages);
      prod = next(prod + 1);
    }
    ptx::cp_async_commit();
    ptx::cp_async_wait<kStages - 1>();
    __syncthreads();  // sub-tile `cur` landed; the last block's dQ is done
    const int8_t* kst = ring + (it % kStages) * m.stage;
    const int ks = cur % KSB;
    transpose_tile<HDP>(kt, kst, p.lqk, ks);
    if (wrows > 0 && live(cur, wq_lo, wq_hi)) {
      float s[4][4], dp[4][4];
      pair_scores<NDC, true>(s, res + a_off, p.lqk, R * HP, kst + b_off,
                             p.lqk, KS * HP, s0, fast);
      pair_scores<NDC, true>(dp, gres + a_off, p.lg, R * HP,
                             kst + p.lqk * KS * HP + b_off, p.lv, KS * HP,
                             sdp, fast);
      int dsm[4][4];
      // p and dS per element, computed everywhere and selected (no branch
      // per element); the mask only where the warp's tile is not all
      // visible.
      auto to_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            bool ok = true;
            if constexpr (decltype(masked)::value)
              ok = row_ok[i] & visible(p, q_lo + r_lo + 8 * i,
                                       cur * KS + 8 * j + 2 * (lane & 3) +
                                           (e & 1));
            const float ex =
                p_exp<IntExp>(__fsub_rn(__fmul_rn(s[j][e], p.sc), lse_r[i]));
            const float pr = ok ? ex : 0.0f;
            const float ds = __fmul_rn(pr, __fsub_rn(dp[j][e], del_r[i]));
            const int m = round_clip(__fmul_rn(ds, inv_ds), p.ds_bits);
            dsm[j][e] = ok ? m : 0;
          }
      };
      const int k1 = cur * KS + KS - 1;
      if (wrows == 16 && k1 < p.Sk && (!p.causal || k1 <= wq_lo) &&
          (p.window < 0 || cur * KS > wq_hi - p.window))
        to_ds(std::false_type());
      else
        to_ds(std::true_type());
      store_limbs(fa, dsm, p.lds, ks, lane);
      live_ks |= 1u << ks;
    }
    __syncthreads();  // K^T of the sub-tile written; its stage read
    const int nxt = next(cur + 1);
    if (live_ks && (nxt >= n_st || nxt / KSB != cur / KSB)) {  // block end
#pragma unroll
      for (int dc = 0; dc < NDC; ++dc) {
        float part[4][4];
        block_partial<NDC>(part, fa, p.lds, kt + t_off, p.lqk, dc, live_ks,
                           sdq, 0, fast, lane);
        acc.add(dc, part);
      }
      live_ks = 0;
    }
    cur = nxt;
  }
  ptx::cp_async_wait<0>();

#pragma unroll
  for (int dc = 0; dc < NDC; ++dc)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // rows r_lo, r_lo + 8: columns d, d+1
        const int r = sq0 + r_lo + 8 * i;
        const int d = dc * KS + 8 * j + 2 * (lane & 3);
        float* o = p.dq + (((long long)b * p.Sq + r) * p.KV + h) * p.G * hd +
                   (long long)g * hd + d;
        store_pair(o, __fmul_rn(acc.get(dc, j, 2 * i), p.sc),
                   __fmul_rn(acc.get(dc, j, 2 * i + 1), p.sc), r < p.Sq,
                   d, hd);
      }
}

// --------------------------------------------------------------- dkv ----

template <int NDC, bool IntExp>
__global__ void __launch_bounds__(128) dkv_kernel(const Params p) {
  constexpr int HDP = KS * NDC, HP = HDP + 16;
  constexpr bool kRegSums = sums_in_regs(true, NDC);
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = smem_layout(p, true);
  const int hd = p.hd, R = 16 * p.nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int k_lo = blockIdx.x * R;
  const int nk = min(R, p.Sk - k_lo);
  const int k_hi = k_lo + nk - 1;
  int8_t* res = reinterpret_cast<int8_t*>(smem + m.res);  // K, then V
  int8_t* vres = res + p.lqk * R * HP;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + m.ring);
  int8_t* qt = reinterpret_cast<int8_t*>(smem + m.tr);  // Q^T, then dO^T
  int8_t* gt = qt + p.lqk * HDP * TP;
  uint4* fa = reinterpret_cast<uint4*>(smem + m.priv) +
              warp * (p.lv + p.lds) * kLimbWords / 4;  // P, then dS
  uint4* fds = fa + p.lv * kLimbWords / 4;
  float* sums = reinterpret_cast<float*>(smem + m.acc) + warp * 2 * HDP * 16;
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const long long qrow = (long long)p.KV * p.G * hd;
  const long long krow = (long long)p.KV * hd;
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float sdp = dfx::pow2f(p.exps[3] + p.exps[2]);
  const int dse = p.exps[4];
  const float inv_ds = dfx::pow2f(-dse);
  const float sdk = dfx::pow2f(dse + p.exps[0]);
  const float sdv = dfx::pow2f(p.exps[3]);
  const float pscale = dfx::pow2f(p.p_bits - 1);
  const bool fast = fma_exact(p.exps[0] + p.exps[1], 0) &&
                    fma_exact(p.exps[3] + p.exps[2], 0) &&
                    fma_exact(p.exps[3], -(p.p_bits - 1)) &&
                    fma_exact(dse + p.exps[0], 0);
  const int lse_at = (p.lqk + p.lg) * KS * HP;  // in a stage
  const int a_off = 16 * warp * HP + a_lane(lane, HP);
  const int b_off = b_lane(lane, HP), t_off = b_lane(lane, TP);

  zero_pad(res, (p.lqk + p.lv) * R, HP, hd, HDP);
  for (int s = 0; s < kStages; ++s)
    zero_pad(ring + s * m.stage, (p.lqk + p.lg) * KS, HP, hd, HDP);
  const long long k_base = (((long long)b * p.Sk + k_lo) * p.KV + h) * hd;
  stage_rows(p, HP, res, p.k + k_base, kplane, krow, p.lqk, R, nk);
  stage_rows(p, HP, vres, p.v + k_base, kplane, krow, p.lv, R, nk);

  const int wk0 = k_lo + 16 * warp;  // this warp's keys wk0..wk1
  const int wk1 = min(wk0 + 16, p.Sk) - 1;
  const int n_st = (p.Sq + KS - 1) / KS;
  const int n_t = p.G * n_st;  // sub-tiles, group head major
  // Tile i (group head i / n_st, query rows 32 (i % n_st)..) visible to
  // some key of klo..khi?
  auto live = [&](int i, int klo, int khi) {
    const int r0 = (i % n_st) * KS, r1 = min(r0 + KS, p.Sq) - 1;
    return !(p.causal && klo > off + r1) &&
           !(p.window >= 0 && khi <= off + r0 - p.window);
  };
  auto next = [&](int i) {
    while (i < n_t && !live(i, k_lo, k_hi)) ++i;
    return i;
  };
  auto issue = [&](int i, int stage) {
    const int g = i / n_st, r0 = (i % n_st) * KS;
    const int nr = min(KS, p.Sq - r0);
    int8_t* dst = ring + stage * m.stage;
    const long long q_base =
        (((long long)b * p.Sq + r0) * p.KV + h) * p.G * hd + (long long)g * hd;
    stage_rows(p, HP, dst, p.q + q_base, qplane, qrow, p.lqk, KS, nr);
    stage_rows(p, HP, dst + p.lqk * KS * HP, p.g + q_base, qplane, qrow,
               p.lg, KS, nr);
    float* rows = reinterpret_cast<float*>(dst + lse_at);  // lse, delta
    for (int e = threadIdx.x; e < 2 * KS; e += blockDim.x) {
      const int r = e % KS;
      const bool ok = r < nr;
      const float* src =
          e < KS
              ? p.lse + (((long long)b * p.KV + h) * p.G + g) * p.Sq + r0 + r
              : p.delta + (((long long)b * p.Sq + r0 + r) * p.KV + h) * p.G +
                    g;
      ptx::cp_async<4>(rows + e, ok ? src : p.lse, ok);
    }
  };

  int prod = next(0);
  for (int s = 0; s < kStages - 1; ++s) {  // group 0 holds K and V too
    if (prod < n_t) {
      issue(prod, s);
      prod = next(prod + 1);
    }
    ptx::cp_async_commit();
  }
  Sums<NDC, kRegSums> sk(sums, lane), sv(sums + HDP * 16, lane);
  unsigned live_ks = 0;  // the warp's k-steps of the current q block
  for (int cur = next(0), it = 0; cur < n_t; ++it) {
    if (prod < n_t) {
      issue(prod, (it + kStages - 1) % kStages);
      prod = next(prod + 1);
    }
    ptx::cp_async_commit();
    ptx::cp_async_wait<kStages - 1>();
    __syncthreads();  // sub-tile `cur` landed; the last block's dK/dV done
    const int8_t* qst = ring + (it % kStages) * m.stage;
    const float* lse_s = reinterpret_cast<const float*>(qst + lse_at);
    const float* del_s = lse_s + KS;
    const int r0 = (cur % n_st) * KS;
    const int ks = r0 % p.bq / KS;
    transpose_tile<HDP>(qt, qst, p.lqk + p.lg, ks);
    if (wk0 <= wk1 && live(cur, wk0, wk1)) {
      float s[4][4], dp[4][4];
      pair_scores<NDC, false>(s, res + a_off, p.lqk, R * HP, qst + b_off,
                              p.lqk, KS * HP, s0, fast);
      pair_scores<NDC, false>(dp, vres + a_off, p.lv, R * HP,
                              qst + p.lqk * KS * HP + b_off, p.lg, KS * HP,
                              sdp, fast);
      int pm[4][4], dsm[4][4];
      // p, P and dS per element, as in dq_kernel
      auto to_pds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rl = 8 * j + 2 * (lane & 3) + (e & 1);
            bool ok = true;
            if constexpr (decltype(masked)::value)
              ok = (r0 + rl < p.Sq) &
                   visible(p, off + r0 + rl, wk0 + (lane >> 2) + 8 * (e >> 1));
            const float ex =
                p_exp<IntExp>(__fsub_rn(__fmul_rn(s[j][e], p.sc), lse_s[rl]));
            const float pr = ok ? ex : 0.0f;
            const int pmv = round_clip(__fmul_rn(pr, pscale), p.p_bits);
            const float ds = __fmul_rn(pr, __fsub_rn(dp[j][e], del_s[rl]));
            const int m = round_clip(__fmul_rn(ds, inv_ds), p.ds_bits);
            pm[j][e] = ok ? pmv : 0;
            dsm[j][e] = ok ? m : 0;
          }
      };
      const int wk15 = wk0 + 15;
      if (r0 + KS <= p.Sq && wk15 < p.Sk && (!p.causal || wk15 <= off + r0) &&
          (p.window < 0 || wk0 > off + r0 + KS - 1 - p.window))
        to_pds(std::false_type());
      else
        to_pds(std::true_type());
      store_limbs(fa, pm, p.lv, ks, lane);
      store_limbs(fds, dsm, p.lds, ks, lane);
      live_ks |= 1u << ks;
    }
    __syncthreads();  // Q^T / dO^T of the sub-tile written; its stage read
    const int nxt = next(cur + 1);
    if (live_ks && (nxt >= n_t || nxt / n_st != cur / n_st ||
                    (nxt % n_st) * KS / p.bq != r0 / p.bq)) {  // block end
#pragma unroll
      for (int dc = 0; dc < NDC; ++dc) {
        float part[4][4];
        block_partial<NDC>(part, fa, p.lv, gt + t_off, p.lg, dc, live_ks,
                           sdv, -(p.p_bits - 1), fast, lane);
        sv.add(dc, part);
        block_partial<NDC>(part, fds, p.lds, qt + t_off, p.lqk, dc, live_ks,
                           sdk, 0, fast, lane);
        sk.add(dc, part);
      }
      live_ks = 0;
    }
    cur = nxt;
  }
  ptx::cp_async_wait<0>();

#pragma unroll
  for (int dc = 0; dc < NDC; ++dc)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // keys wk0 + g + 8i: columns d, d+1
        const int kpos = wk0 + (lane >> 2) + 8 * i;
        const int d = dc * KS + 8 * j + 2 * (lane & 3);
        const long long o = (((long long)b * p.Sk + kpos) * p.KV + h) * hd + d;
        store_pair(p.dk + o, __fmul_rn(sk.get(dc, j, 2 * i), p.sc),
                   __fmul_rn(sk.get(dc, j, 2 * i + 1), p.sc), kpos < p.Sk, d,
                   hd);
        store_pair(p.dv + o, sv.get(dc, j, 2 * i), sv.get(dc, j, 2 * i + 1),
                   kpos < p.Sk, d, hd);
      }
}

// ------------------------------------------------------------ direct ----
// The bodies for any hd and limb count ("direct", attn_mma.cuh), taken
// where the staged bodies above do not fit: hd > 256, or a CTA of one warp
// over 227 KB (128 < hd <= 256 at 2-3 limbs).  Each warp of a CTA owns 16
// rows alone, loads its fragments straight from global memory and keeps
// its f32 sums in the output (each element read and written by one lane),
// so shared memory holds only its digit fragments.  Same recurrence,
// blocks, pair orders and f32 expressions as the staged bodies, and the
// exact conversion of every dot.

template <bool IntExp>
__global__ void __launch_bounds__(128) dq_direct_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int sq0 = (blockIdx.x * 4 + warp) * 16;  // the warp's query rows
  if (sq0 >= p.Sq) return;
  uint4* fa = reinterpret_cast<uint4*>(smem) + warp * p.lds * kLimbWords / 4;
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float sdp = dfx::pow2f(p.exps[3] + p.exps[2]);
  const float sdq = dfx::pow2f(p.exps[4] + p.exps[1]);
  const float inv_ds = dfx::pow2f(-p.exps[4]);
  const bool vec = p.vec >= 4;
  const int r_lo = lane >> 2, t2 = 2 * (lane & 3);
  float lse_r[2], del_r[2];
  bool row_ok[2];
  long long qo[2];  // rows r_lo, r_lo + 8: offsets in a q / g plane and dq
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = sq0 + r_lo + 8 * i;
    row_ok[i] = r < p.Sq;
    qo[i] = row_ok[i]
        ? ((((long long)b * p.Sq + r) * p.KV + h) * p.G + g) * hd : 0;
    lse_r[i] = row_ok[i]
        ? p.lse[(((long long)b * p.KV + h) * p.G + g) * p.Sq + r] : 0.0f;
    del_r[i] = row_ok[i]
        ? p.delta[(((long long)b * p.Sq + r) * p.KV + h) * p.G + g] : 0.0f;
  }
  auto each = [&](auto f) {  // f(pointer at column d, row i, d, j)
    for (int d0 = 0; d0 < hd; d0 += KS)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = d0 + 8 * j + t2;
          f(p.dq + qo[i] + d, i, d, j);
        }
  };
  each([&](float* x, int i, int d, int) {
    update_pair(x, row_ok[i], d, hd, [](int, float) { return 0.0f; });
  });
  const int wq_lo = off + sq0, wq_hi = wq_lo + min(16, p.Sq - sq0) - 1;
  const int n_st = (p.Sk + KS - 1) / KS;
  auto key_row = [&](const int8_t* base, int key) -> const int8_t* {
    return key < p.Sk ? base + (((long long)b * p.Sk + key) * p.KV + h) * hd
                      : nullptr;
  };
  for (int kb = 0; kb * KSB < n_st; ++kb) {
    unsigned live_ks = 0;
#pragma unroll
    for (int ks = 0; ks < KSB; ++ks) {
      const int st = kb * KSB + ks, k0 = st * KS;
      if (st >= n_st || (p.causal && k0 > wq_hi) ||
          (p.window >= 0 && min(k0 + KS, p.Sk) - 1 <= wq_lo - p.window))
        continue;
      const int8_t* kr[4];
      const int8_t* vr[4];
      bool kok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kok[j] = k0 + 8 * j + r_lo < p.Sk;
        kr[j] = kok[j] ? key_row(p.k, k0 + 8 * j + r_lo) : p.k;
        vr[j] = kok[j] ? key_row(p.v, k0 + 8 * j + r_lo) : p.v;
      }
      float s[4][4], dp[4][4];
      direct_scores<true>(s, p.q + qo[0], p.q + qo[1], row_ok[0], row_ok[1],
                          qplane, p.lqk, kr, kok, kplane, p.lqk, hd, vec, s0,
                          lane);
      direct_scores<true>(dp, p.g + qo[0], p.g + qo[1], row_ok[0],
                          row_ok[1], qplane, p.lg, vr, kok, kplane, p.lv, hd,
                          vec, sdp, lane);
      int dsm[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const bool ok = row_ok[i] & visible(p, wq_lo + r_lo + 8 * i,
                                              k0 + 8 * j + t2 + (e & 1));
          const float ex =
              p_exp<IntExp>(__fsub_rn(__fmul_rn(s[j][e], p.sc), lse_r[i]));
          const float pr = ok ? ex : 0.0f;
          const float ds = __fmul_rn(pr, __fsub_rn(dp[j][e], del_r[i]));
          const int m = round_clip(__fmul_rn(ds, inv_ds), p.ds_bits);
          dsm[j][e] = ok ? m : 0;
        }
      store_limbs(fa, dsm, p.lds, ks, lane);
      live_ks |= 1u << ks;
    }
    if (!live_ks) continue;
    for (int d0 = 0; d0 < hd; d0 += KS) {
      float part[4][4];
      direct_partial(part, fa, p.lds, kplane, p.lqk, d0, hd, live_ks,
                     [&](int ks, int r) {
                       return key_row(p.k, (kb * KSB + ks) * KS + r);
                     },
                     sdq, 0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = d0 + 8 * j + t2;
          update_pair(p.dq + qo[i] + d, row_ok[i], d, hd, [&](int e, float x) {
            return __fadd_rn(x, part[j][2 * i + e]);
          });
        }
    }
  }
  each([&](float* x, int i, int d, int) {
    update_pair(x, row_ok[i], d, hd,
                [&](int, float v) { return __fmul_rn(v, p.sc); });
  });
}

template <bool IntExp>
__global__ void __launch_bounds__(128) dkv_direct_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int wk0 = (blockIdx.x * 4 + warp) * 16;  // the warp's keys
  if (wk0 >= p.Sk) return;
  const int wk1 = min(wk0 + 16, p.Sk) - 1;
  uint4* fa = reinterpret_cast<uint4*>(smem) +
              warp * (p.lv + p.lds) * kLimbWords / 4;  // P, then dS
  uint4* fds = fa + p.lv * kLimbWords / 4;
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float sdp = dfx::pow2f(p.exps[3] + p.exps[2]);
  const float inv_ds = dfx::pow2f(-p.exps[4]);
  const float sdk = dfx::pow2f(p.exps[4] + p.exps[0]);
  const float sdv = dfx::pow2f(p.exps[3]);
  const float pscale = dfx::pow2f(p.p_bits - 1);
  const bool vec = p.vec >= 4;
  const int r_lo = lane >> 2, t2 = 2 * (lane & 3);
  bool key_ok[2];
  long long ko[2];  // keys wk0 + r_lo (+ 8): offsets in a k / v plane, dk, dv
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = wk0 + r_lo + 8 * i;
    key_ok[i] = key < p.Sk;
    ko[i] = key_ok[i] ? (((long long)b * p.Sk + key) * p.KV + h) * hd : 0;
  }
  auto each = [&](auto f) {  // f(offset at column d, key i, d)
    for (int d0 = 0; d0 < hd; d0 += KS)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = d0 + 8 * j + t2;
          f(ko[i] + d, i, d);
        }
  };
  each([&](long long o, int i, int d) {
    update_pair(p.dk + o, key_ok[i], d, hd, [](int, float) { return 0.0f; });
    update_pair(p.dv + o, key_ok[i], d, hd, [](int, float) { return 0.0f; });
  });
  for (int g = 0; g < p.G; ++g) {
    auto q_row = [&](const int8_t* base, int row) -> const int8_t* {
      return row < p.Sq
          ? base + ((((long long)b * p.Sq + row) * p.KV + h) * p.G + g) * hd
          : nullptr;
    };
    for (int qb0 = 0; qb0 < p.Sq; qb0 += p.bq) {  // the reference's q blocks
      unsigned live_ks = 0;
#pragma unroll
      for (int ks = 0; ks < KSB; ++ks) {
        const int r0 = qb0 + ks * KS;
        if (ks * KS >= p.bq || r0 >= p.Sq) continue;
        const int r1 = min(r0 + KS, p.Sq) - 1;
        if ((p.causal && wk0 > off + r1) ||
            (p.window >= 0 && wk1 <= off + r0 - p.window))
          continue;
        const int8_t* qr[4];
        const int8_t* gr[4];
        bool rok[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          rok[j] = r0 + 8 * j + r_lo < p.Sq;
          qr[j] = rok[j] ? q_row(p.q, r0 + 8 * j + r_lo) : p.q;
          gr[j] = rok[j] ? q_row(p.g, r0 + 8 * j + r_lo) : p.g;
        }
        float s[4][4], dp[4][4];
        direct_scores<false>(s, p.k + ko[0], p.k + ko[1], key_ok[0],
                             key_ok[1], kplane, p.lqk, qr, rok, qplane,
                             p.lqk, hd, vec, s0, lane);
        direct_scores<false>(dp, p.v + ko[0], p.v + ko[1], key_ok[0],
                             key_ok[1], kplane, p.lv, gr, rok, qplane, p.lg,
                             hd, vec, sdp, lane);
        int pm[4][4], dsm[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * j + t2 + (e & 1);
            const bool rv = row < p.Sq;
            const bool ok =
                rv & visible(p, off + row, wk0 + r_lo + 8 * (e >> 1));
            const float lse_v =
                rv ? p.lse[(((long long)b * p.KV + h) * p.G + g) * p.Sq + row]
                   : 0.0f;
            const float del_v =
                rv ? p.delta[(((long long)b * p.Sq + row) * p.KV + h) * p.G +
                             g]
                   : 0.0f;
            const float ex =
                p_exp<IntExp>(__fsub_rn(__fmul_rn(s[j][e], p.sc), lse_v));
            const float pr = ok ? ex : 0.0f;
            const int pmv = round_clip(__fmul_rn(pr, pscale), p.p_bits);
            const float ds = __fmul_rn(pr, __fsub_rn(dp[j][e], del_v));
            const int m = round_clip(__fmul_rn(ds, inv_ds), p.ds_bits);
            pm[j][e] = ok ? pmv : 0;
            dsm[j][e] = ok ? m : 0;
          }
        store_limbs(fa, pm, p.lv, ks, lane);
        store_limbs(fds, dsm, p.lds, ks, lane);
        live_ks |= 1u << ks;
      }
      if (!live_ks) continue;
      for (int d0 = 0; d0 < hd; d0 += KS) {
        float pv[4][4], pk[4][4];
        direct_partial(pv, fa, p.lv, qplane, p.lg, d0, hd, live_ks,
                       [&](int ks, int r) {
                         return q_row(p.g, qb0 + ks * KS + r);
                       },
                       sdv, -(p.p_bits - 1), lane);
        direct_partial(pk, fds, p.lds, qplane, p.lqk, d0, hd, live_ks,
                       [&](int ks, int r) {
                         return q_row(p.q, qb0 + ks * KS + r);
                       },
                       sdk, 0, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int d = d0 + 8 * j + t2;
            update_pair(p.dv + ko[i] + d, key_ok[i], d, hd,
                        [&](int e, float x) {
                          return __fadd_rn(x, pv[j][2 * i + e]);
                        });
            update_pair(p.dk + ko[i] + d, key_ok[i], d, hd,
                        [&](int e, float x) {
                          return __fadd_rn(x, pk[j][2 * i + e]);
                        });
          }
      }
    }
  }
  each([&](long long o, int i, int d) {
    update_pair(p.dk + o, key_ok[i], d, hd,
                [&](int, float v) { return __fmul_rn(v, p.sc); });
  });
}

int set_smem(const void* kernel, size_t smem, size_t* granted) {
  if (smem > *granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *granted = smem;
  }
  return 0;
}

// Limb counts in range and the widest copy the alignment allows; then the
// staged body (hd <= 256) with the widest CTA (4, 2 or 1 warps) whose
// shared memory fits, or else the direct body (p.nw = 0: CTAs of 4
// independent warps, their digit fragments in shared memory).
int configure(Params& p, bool dkv, size_t* smem) {
  if (p.lqk < 1 || p.lqk > 3 || p.lv < 1 || p.lv > 3 || p.lg < 1 ||
      p.lg > 3 || p.lds < 1 || p.lds > 3)
    return (int)cudaErrorInvalidValue;
  p.hdp = (p.hd + KS - 1) / KS * KS;
  if (p.hdp > KS * 4) p.hdp = KS * kMaxChunks;  // the one wide staged body
  const uintptr_t base = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v |
                         (uintptr_t)p.g;
  p.vec = 1;
  for (int v = 16; v >= 4; v /= 2)
    if (p.hd % v == 0 && base % v == 0) {
      p.vec = v;
      break;
    }
  if (p.hd <= KS * kMaxChunks)
    for (p.nw = 4; p.nw >= 1; p.nw /= 2) {
      *smem = smem_layout(p, dkv).end;
      if (*smem <= kSmemMax) return 0;
    }
  p.nw = 0;
  *smem = (size_t)4 * (dkv ? p.lv + p.lds : p.lds) * kLimbWords * 4;
  return 0;
}

template <int NDC, bool IntExp>
int launch_dq(const Params& p, size_t smem, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const int err =
      set_smem((const void*)dq_kernel<NDC, IntExp>, smem, &granted);
  if (err) return err;
  const dim3 grid((p.Sq + 16 * p.nw - 1) / (16 * p.nw), p.G, p.B * p.KV);
  dq_kernel<NDC, IntExp><<<grid, 32 * p.nw, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int NDC, bool IntExp>
int launch_dkv(const Params& p, size_t smem, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const int err =
      set_smem((const void*)dkv_kernel<NDC, IntExp>, smem, &granted);
  if (err) return err;
  const dim3 grid((p.Sk + 16 * p.nw - 1) / (16 * p.nw), p.B * p.KV);
  dkv_kernel<NDC, IntExp><<<grid, 32 * p.nw, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool IntExp>
int launch_direct(const Params& p, bool dkv, size_t smem,
                  cudaStream_t stream) {
  int err;
  if (dkv) {
    static size_t granted = 48 * 1024;
    err = set_smem((const void*)dkv_direct_kernel<IntExp>, smem, &granted);
    if (err) return err;
    const dim3 grid((p.Sk + 63) / 64, p.B * p.KV);
    dkv_direct_kernel<IntExp><<<grid, 128, smem, stream>>>(p);
  } else {
    static size_t granted = 48 * 1024;
    err = set_smem((const void*)dq_direct_kernel<IntExp>, smem, &granted);
    if (err) return err;
    const dim3 grid((p.Sq + 63) / 64, p.G, p.B * p.KV);
    dq_direct_kernel<IntExp><<<grid, 128, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// The instantiation for the chunk count (1-4, or 8) and the exp body, or
// the direct body.
template <bool Dkv, bool IntExp>
int launch_body(const Params& p, size_t smem, cudaStream_t stream) {
  if (p.nw == 0) return launch_direct<IntExp>(p, Dkv, smem, stream);
  switch (p.hdp / KS) {
    case 1: return Dkv ? launch_dkv<1, IntExp>(p, smem, stream)
                       : launch_dq<1, IntExp>(p, smem, stream);
    case 2: return Dkv ? launch_dkv<2, IntExp>(p, smem, stream)
                       : launch_dq<2, IntExp>(p, smem, stream);
    case 3: return Dkv ? launch_dkv<3, IntExp>(p, smem, stream)
                       : launch_dq<3, IntExp>(p, smem, stream);
    case 4: return Dkv ? launch_dkv<4, IntExp>(p, smem, stream)
                       : launch_dq<4, IntExp>(p, smem, stream);
    case kMaxChunks:
      return Dkv ? launch_dkv<kMaxChunks, IntExp>(p, smem, stream)
                 : launch_dq<kMaxChunks, IntExp>(p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool Dkv>
int launch(const Params& p, int integer_exp, size_t smem,
           cudaStream_t stream) {
  return integer_exp ? launch_body<Dkv, true>(p, smem, stream)
                     : launch_body<Dkv, false>(p, smem, stream);
}

}  // namespace

// q, g: (lqk | lg, B, Sq, KV, G, hd); k, v: (lqk | lv, B, Sk, KV, hd) int8
// limb planes; lse (B, KV, G, Sq) and delta (B, Sq, KV, G) f32; off (B,)
// int32 query offsets; exps (5,) int32 [q, k, v, g, dS] exponents (device
// memory).  dq: (B, Sq, KV, G, hd) f32.  window < 0: no sliding window.
// Any hd.  integer_exp != 0 takes the kept_ops="integer" body.
extern "C" int int_attn_bwd_dq_launch(
    const int8_t* q, const int8_t* k, const int8_t* v, const int8_t* g,
    const float* lse, const float* delta, const int* off, const int* exps,
    float* dq, int B, int Sq, int Sk, int KV, int G, int hd, int lqk, int lv,
    int lg, int lds, int ds_bits, int causal, int window, float sc,
    int integer_exp, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if (G > 65535 || (long long)B * KV > 65535) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, g, lse, delta, off, exps, dq, nullptr, nullptr,
           B, Sq, Sk, KV, G, hd, lqk, lv, lg, lds, 0, ds_bits, causal,
           window, 0, sc, 0, 0, 0};
  size_t smem = 0;
  const int err = configure(p, false, &smem);
  if (err) return err;
  return launch<false>(p, integer_exp, smem, stream);
}

// Arguments as int_attn_bwd_dq_launch; bq is the reference's query block
// (min(128, Sq rounded up to 8)), p_bits P's bits (v has n_limbs(p_bits)
// planes).  dk, dv: (B, Sk, KV, hd) f32.
extern "C" int int_attn_bwd_dkv_launch(
    const int8_t* q, const int8_t* k, const int8_t* v, const int8_t* g,
    const float* lse, const float* delta, const int* off, const int* exps,
    float* dk, float* dv, int B, int Sq, int Sk, int KV, int G, int hd,
    int lqk, int lv, int lg, int lds, int p_bits, int ds_bits, int bq,
    int causal, int window, float sc, int integer_exp, cudaStream_t stream) {
  if (B <= 0 || Sk <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  // the q blocks are whole 32-row sub-tiles (bq = 128) or all of Sq
  if ((long long)B * KV > 65535 || bq <= 0 || (bq % KS && bq < Sq))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, g, lse, delta, off, exps, nullptr, dk, dv,
           B, Sq, Sk, KV, G, hd, lqk, lv, lg, lds, p_bits, ds_bits, causal,
           window, bq, sc, 0, 0, 0};
  size_t smem = 0;
  const int err = configure(p, true, &smem);
  if (err) return err;
  return launch<true>(p, integer_exp, smem, stream);
}
