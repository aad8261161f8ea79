// Integer flash-attention forward over int8 limb planes.
//
// Replaces the TPU kernel repro/kernels/int_attention.py::int_attn_fwd
// (:217, pallas_call :249; body _int_attn_fwd_kernel :162; helpers
// _limb_dot :80, _plane_dot :106, _valid_mask :125, _p_exp :147).
// Per 128-wide block of keys, exactly as the TPU kernel:
//
//   s     = sc * sum_pairs (f32(q_limb . k_limb) * 2^(qe+ke)) * 2^(7(ja+jb))
//   s     = ok ? s : -1e30,  ok = kpos < Sk & causal & window (q_off[b]+i)
//   m_new = max(m, rowmax(s));  p = ok ? exp(s - m_new) : 0
//   alpha = exp(m - m_new);     l = l * alpha + rowsum(p)
//   pm    = clip(rint(p * 2^(pb-1)))  split into limb planes in registers
//   acc   = acc * alpha + sum_pairs (f32(pm_limb . v_limb) * 2^ve)
//                                   * 2^(7(ja+jb) - (pb-1))
//   o = acc / max(l, 1e-20),  lse = m + log(max(l, 1e-37))
//
// kept_ops="integer" (template flag IntExp, the same launch): both exps
// are iapprox::i_exp (Q.14, iapprox.cuh; the reference's _p_exp :147) and
// the epilogue is o = acc * i_recip(max(l, 1e-20)); the lse keeps logf,
// as the reference's (:209).
//
// The running max, l and the P quantization move per 128-key block, as on
// the TPU: P is quantized against the running max of the whole block, so
// the block width is part of the result.  Integer dots are exact int32;
// each f32 expression is the reference's, in its order (explicit _rn
// intrinsics, no FMA contraction).  rowsum(p) is taken in this kernel's
// order (each lane's 32 columns 8j + 2t + e of a row in column order, then
// the quad's four partials as (t0 + t1) + (t2 + t3)), which the plain
// version repeats (kernels/int_attention.py::_block_row_sum).  A key block
// masked for every row of a CTA is skipped: there it would leave m, l and
// acc unchanged (p = 0, alpha = exp(0) = 1), so skipping it is exact.  Not
// so under IntExp, where i_exp(0) = 16381 / 2^14: a skipped block still
// scales l and acc by it, as the reference's grid step does.
//
// Layout: the planes arrive in the model layout, q (Lq, B, Sq, KV, G, hd)
// and k/v (L, B, Sk, KV, hd); o (B, Sq, KV, G, hd), lse (B, KV, G, Sq).  The
// kernel computes its own offsets, so no transpose or padding pass runs in
// device memory; the ragged Sq, Sk and hd edges are masked here (hd is
// zero-padded to the MMA depth, 32, in shared memory).
//
// Bound on the H100: bytes.  At the qwen1.5-0.5b training shape (8 x 256,
// 16 heads of 64, causal, 2 limbs) the planes read once and o written once
// in f32 are 21 MB, 6.3 us, against 4.3 G int8 operations (2.2 us); at
// decode a row reads the K/V planes of every cached key it may see.  The
// kernel runs far above both: its time goes to the f32 online softmax (per
// lane and block 64 expf, roundings and digit packs) and to the latency
// of 16-row tiles, at 3 CTAs of 4 warps per SM up to hd 64.
//
// Design (the attention backward's vocabulary, attn_mma.cuh):
//   staged body (hd <= 256 where the tiles fit in 227 KB): a CTA of nw
//   warps (4 where shared memory and the rows allow) owns 16 nw rows of the
//   reference's group-major row axis R = G * Sq of one (batch, kv head),
//   so for GQA the G query heads of a kv head share one K/V stream.  The
//   Q rows stay resident; K and V stream through a two-stage cp.async ring
//   of 32-key sub-tiles.  Per sub-tile each warp computes S = Q K^T (16 x
//   32, mma.sync m16n8k32 s8, one limb pair at a time over hd) into
//   registers, and V is transposed into V^T rows by word loads and a 4x4
//   byte transpose (__byte_perm), in the permuted k order in which a
//   lane's C-layout columns form its A fragment.  At the block's end the
//   whole 16 x 128 score tile is in the warp's registers (64 f32 a lane):
//   row max and row sum by quad shuffles, p and its mantissa in the C
//   fragments, the digits packed straight into A fragments (warp-private
//   shared memory), and P V by MMA, acc in registers up to hd 128 and in
//   shared memory beyond.
//   direct body (any hd and limb count: hd > 256, or 3 limbs at hd 256):
//   CTAs of 4 independent warps of 16 rows, fragments loaded straight from
//   global memory, acc kept in o itself (each element one lane's), shared
//   memory only for the P digit fragments.
#include "attn_mma.cuh"

namespace {

constexpr float kBigNeg = -1e30f;

struct Params {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const int* off;
  const int* exps;  // [q, k, v] exponents
  float* o;
  float* lse;
  int B, Sq, Sk, KV, G, hd;
  int lqk, lv;  // limb planes of q/k and of v (and P: n_limbs(p_bits))
  int p_bits, causal, window;
  float sc;
  int nw, hdp, vec;  // warps per CTA (0: direct body), hd rounded up to
                     // 32, copy bytes
};

// Shared-memory carve-up of the staged body (byte offsets, multiples of 16).
struct Smem {
  int hp;        // byte stride of a staged row (hdp + 16: conflict-free)
  size_t stage;  // one ring stage: K then V planes of 32 keys
  size_t res, ring, tr, priv, acc, end;
};

__host__ __device__ inline Smem smem_layout(const Params& p) {
  Smem m;
  m.hp = p.hdp + 16;
  const size_t R = 16 * p.nw;
  size_t o = 0;
  m.res = o;  // Q [lqk][R][hp]
  o += (size_t)p.lqk * R * m.hp;
  m.stage = (size_t)(p.lqk + p.lv) * KS * m.hp;
  m.ring = o;
  o += kStages * m.stage;
  m.tr = o;  // V^T [lv][hdp][TP] of the current key block
  o += (size_t)p.lv * p.hdp * TP;
  m.priv = o;  // per warp: P's A fragments [lv][KSB][32 lanes]
  o += (size_t)p.nw * p.lv * kLimbWords * 4;
  m.acc = o;  // per warp: acc beyond hd 128
  if (p.hdp > KS * 4) o += (size_t)p.nw * p.hdp * 16 * sizeof(float);
  m.end = o;
  return m;
}

// The query positions of R-axis rows ra..ra+n-1 (row g * Sq + i has
// position off + i) lie in [lo, hi]: exactly within one group head, all
// of 0..Sq-1 across a group boundary.
__device__ __forceinline__ void q_range(const Params& p, int off, int ra,
                                        int n, int& lo, int& hi) {
  const int rb = ra + n - 1;
  const bool one = ra / p.Sq == rb / p.Sq;
  lo = off + (one ? ra % p.Sq : 0);
  hi = off + (one ? rb % p.Sq : p.Sq - 1);
}

// Stage the Q planes of R-axis rows r0..r0+R-1 (row g * Sq + i is query
// row i of group head g) into rows of hp bytes, plane j at qs + j * R * hp;
// rows at or past `rows` zero-filled.  V-byte cp.async copies (V = 1:
// synchronous bytes, for an hd or a base that is not 4-byte aligned).
template <int V>
__device__ __forceinline__ void stage_q(const Params& p, int8_t* qs, int hp,
                                        int R, int rows, int r0, int b,
                                        int h) {
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * p.hd;
  const int cpr = p.hd / V;
  for (int e = threadIdx.x; e < p.lqk * R * cpr; e += blockDim.x) {
    const int c = e % cpr, r = (e / cpr) % R, j = e / (cpr * R);
    const int rr = r0 + r;
    const bool ok = r < rows;
    const int8_t* src =
        ok ? p.q + j * qplane +
                 ((((long long)b * p.Sq + rr % p.Sq) * p.KV + h) * p.G +
                  rr / p.Sq) * p.hd + V * c
           : p.q;
    int8_t* dst = qs + (j * R + r) * hp + V * c;
    if constexpr (V == 1)
      *dst = ok ? *src : 0;
    else
      ptx::cp_async<V>(dst, src, ok);
  }
}

// The online-softmax update of one 128-key block for a lane's rows g and
// g + 8 (i = 0, 1), from the block's scores in C layout, s[ks][j][e] for
// key 32 ks + 8 j + 2 t + (e & 1) of row i = e / 2, valid where bit
// 4 j + e of ok[ks] is set.  Updates m and l, returns alpha, and hands each
// k-step's P mantissas (C layout) to put(ks, pm).
template <bool IntExp, class Put>
__device__ __forceinline__ void block_softmax(const float (&s)[KSB][4][4],
                                              const unsigned (&ok)[KSB],
                                              float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], float pscale,
                                              int p_bits, Put put) {
  float mx[2] = {kBigNeg, kBigNeg};
#pragma unroll
  for (int ks = 0; ks < KSB; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[ks][j][e]);
  float m_new[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    m_new[i] = fmaxf(m[i], mx[i]);
  }
#pragma unroll
  for (int ks = 0; ks < KSB; ++ks) {
    int pm[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float ex = p_exp<IntExp>(__fsub_rn(s[ks][j][e], m_new[i]));
        const float pr = (ok[ks] >> (4 * j + e) & 1) ? ex : 0.0f;
        ls[i] = __fadd_rn(ls[i], pr);
        pm[j][e] = round_clip(__fmul_rn(pr, pscale), p_bits);
      }
    put(ks, pm);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ls[i] = __fadd_rn(ls[i], __shfl_xor_sync(0xffffffffu, ls[i], 1));
    ls[i] = __fadd_rn(ls[i], __shfl_xor_sync(0xffffffffu, ls[i], 2));
    alpha[i] = p_exp<IntExp>(__fsub_rn(m[i], m_new[i]));
    l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), ls[i]);
    m[i] = m_new[i];
  }
}

// o = acc / max(l, 1e-20) (IntExp: acc * i_recip(max(l, 1e-20))).
template <bool IntExp>
__device__ __forceinline__ float normalize(float acc, float l) {
  const float lc = fmaxf(l, 1e-20f);
  return IntExp ? __fmul_rn(acc, iapprox::i_recip(lc)) : __fdiv_rn(acc, lc);
}

__device__ __forceinline__ float lse_of(float m, float l) {
  return __fadd_rn(m, logf(fmaxf(l, 1e-37f)));
}

// ------------------------------------------------------------ staged ----

// Up to hd 64 three CTAs share an SM (their shared memory allows it): the
// register cap that lets them (168) beats the spills it costs, as measured
// on the card (PERF.md); wider heads are held to two CTAs by shared memory.
template <int NDC, bool IntExp>
__global__ void __launch_bounds__(128, NDC <= 2 ? 3 : 1)
fwd_kernel(const Params p) {
  constexpr int HDP = KS * NDC, HP = HDP + 16;
  constexpr bool kRegSums = NDC <= 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem m = smem_layout(p);
  const int hd = p.hd, R = 16 * p.nw, GS = p.G * p.Sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  // Tiles in reverse, every head's last (under a causal mask the longest)
  // first, so that the grid's tail holds the shortest.
  const int r0 = (gridDim.y - 1 - blockIdx.y) * R;  // first R-axis row
  const int rows = min(R, GS - r0);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + m.res);
  int8_t* ring = reinterpret_cast<int8_t*>(smem + m.ring);
  int8_t* vt = reinterpret_cast<int8_t*>(smem + m.tr);
  uint4* fa = reinterpret_cast<uint4*>(smem + m.priv) +
              warp * p.lv * kLimbWords / 4;
  float* sums = reinterpret_cast<float*>(smem + m.acc) + warp * HDP * 16;
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const long long krow = (long long)p.KV * hd;
  const int e_s = p.exps[0] + p.exps[1], e_v = p.exps[2];
  const float s0 = dfx::pow2f(e_s), sv = dfx::pow2f(e_v);
  const float pscale = dfx::pow2f(p.p_bits - 1);
  const bool fast_s = fma_exact(e_s, 0);
  const bool fast_pv = fma_exact(e_v, -(p.p_bits - 1));
  const int a_off = 16 * warp * HP + a_lane(lane, HP);
  const int b_off = b_lane(lane, HP), t_off = b_lane(lane, TP);

  zero_pad(qs, p.lqk * R, HP, hd, HDP);
  zero_pad(ring, kStages * (p.lqk + p.lv) * KS, HP, hd, HDP);
  switch (p.vec) {
    case 16: stage_q<16>(p, qs, HP, R, rows, r0, b, h); break;
    case 8: stage_q<8>(p, qs, HP, R, rows, r0, b, h); break;
    case 4: stage_q<4>(p, qs, HP, R, rows, r0, b, h); break;
    default: stage_q<1>(p, qs, HP, R, rows, r0, b, h);
  }

  // This lane's rows r_lo and r_lo + 8 (of the CTA's): position, validity.
  const int r_lo = 16 * warp + (lane >> 2);
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r0 + r_lo + 8 * i;
    row_ok[i] = rr < GS;
    qpos[i] = off + rr % p.Sq;
  }
  int q_lo, q_hi, wq_lo = 0, wq_hi = -1;
  q_range(p, off, r0, rows, q_lo, q_hi);
  const int wrows = min(16, rows - 16 * warp);
  if (wrows > 0) q_range(p, off, r0 + 16 * warp, wrows, wq_lo, wq_hi);
  const int n_st = (p.Sk + KS - 1) / KS, n_kb = (p.Sk + KS * KSB - 1) / (KS * KSB);
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
  for (int s = 0; s < kStages - 1; ++s) {  // group 0 holds Q too
    if (prod < n_st) {
      issue(prod, s);
      prod = next(prod + 1);
    }
    ptx::cp_async_commit();
  }
  Sums<NDC, kRegSums> acc(sums, lane);
  float mrow[2] = {kBigNeg, kBigNeg}, lrow[2] = {0.0f, 0.0f};
  int cur = next(0), it = 0;
  for (int kb = 0; kb < n_kb; ++kb) {
    const bool seen = cur < n_st && cur / KSB == kb;  // uniform in the CTA
    if (!IntExp && !seen) continue;  // exact skip
    float s[KSB][4][4];
    unsigned ok[KSB], live_ks = 0;
#pragma unroll
    for (int ks = 0; ks < KSB; ++ks) {
      ok[ks] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ks][j][e] = kBigNeg;
      if (cur != kb * KSB + ks) continue;  // not live for the CTA (uniform)
      ptx::cp_async_wait<kStages - 2>();
      // Sub-tile `cur` landed; every thread is done with the stage read in
      // the last iteration (refilled below) and with the last block's P V.
      __syncthreads();
      if (prod < n_st) {
        issue(prod, (it + kStages - 1) % kStages);
        prod = next(prod + 1);
      }
      ptx::cp_async_commit();
      const int8_t* kst = ring + (it % kStages) * m.stage;
      transpose_tile<HDP>(vt, kst + p.lqk * KS * HP, p.lv, ks);
      if (wrows > 0 && live(cur, wq_lo, wq_hi)) {
        float sc4[4][4];
        pair_scores<NDC, true>(sc4, qs + a_off, p.lqk, R * HP, kst + b_off,
                               p.lqk, KS * HP, s0, fast_s);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const bool v = row_ok[i] &
                           visible(p, qpos[i],
                                   cur * KS + 8 * j + 2 * (lane & 3) + (e & 1));
            s[ks][j][e] = v ? __fmul_rn(sc4[j][e], p.sc) : kBigNeg;
            ok[ks] |= (unsigned)v << (4 * j + e);
          }
        live_ks |= 1u << ks;
      }
      ++it;
      cur = next(cur + 1);
    }
    if (seen) __syncthreads();  // the block's V^T written
    float alpha[2];
    block_softmax<IntExp>(s, ok, mrow, lrow, alpha, pscale, p.p_bits,
                          [&](int ks, int (&pm)[4][4]) {
                            if (live_ks >> ks & 1)
                              store_limbs(fa, pm, p.lv, ks, lane);
                          });
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc) {
      float part[4][4];
      block_partial<NDC>(part, fa, p.lv, vt + t_off, p.lv, dc, live_ks, sv,
                         -(p.p_bits - 1), fast_pv, lane);
      acc.scale_add(dc, alpha, part);
    }
  }
  ptx::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int rr = r0 + r_lo + 8 * i, gg = rr / p.Sq, iq = rr % p.Sq;
    float* o = p.o + ((((long long)b * p.Sq + iq) * p.KV + h) * p.G + gg) * hd;
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = dc * KS + 8 * j + 2 * (lane & 3);
        store_pair(o + d, normalize<IntExp>(acc.get(dc, j, 2 * i), lrow[i]),
                   normalize<IntExp>(acc.get(dc, j, 2 * i + 1), lrow[i]),
                   true, d, hd);
      }
    if ((lane & 3) == 0)
      p.lse[(((long long)b * p.KV + h) * p.G + gg) * p.Sq + iq] =
          lse_of(mrow[i], lrow[i]);
  }
}

// ------------------------------------------------------------ direct ----

template <bool IntExp>
__global__ void __launch_bounds__(128) fwd_direct_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd, GS = p.G * p.Sq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int r0 = (blockIdx.x * 4 + warp) * 16;  // the warp's R-axis rows
  if (r0 >= GS) return;
  uint4* fa = reinterpret_cast<uint4*>(smem) + warp * p.lv * kLimbWords / 4;
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float sv = dfx::pow2f(p.exps[2]);
  const float pscale = dfx::pow2f(p.p_bits - 1);
  const bool vec = p.vec >= 4;
  const int r_lo = lane >> 2, t2 = 2 * (lane & 3);
  int qpos[2];
  bool row_ok[2];
  long long qo[2];  // rows r_lo, r_lo + 8: offsets in a q plane and in o
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rr = r0 + r_lo + 8 * i, gg = rr / p.Sq, iq = rr % p.Sq;
    row_ok[i] = rr < GS;
    qpos[i] = off + iq;
    qo[i] = row_ok[i]
        ? ((((long long)b * p.Sq + iq) * p.KV + h) * p.G + gg) * hd : 0;
  }
  auto each = [&](auto f) {  // f(pointer at column d, row i, d)
    for (int d0 = 0; d0 < hd; d0 += KS)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          f(p.o + qo[i] + d0 + 8 * j + t2, i, d0 + 8 * j + t2);
  };
  each([&](float* x, int i, int d) {
    update_pair(x, row_ok[i], d, hd, [](int, float) { return 0.0f; });
  });
  int wq_lo, wq_hi;
  q_range(p, off, r0, min(16, GS - r0), wq_lo, wq_hi);
  const int n_st = (p.Sk + KS - 1) / KS, n_kb = (p.Sk + KS * KSB - 1) / (KS * KSB);
  auto live = [&](int st) {
    const int k0 = st * KS, k1 = min(k0 + KS, p.Sk) - 1;
    return st < n_st && !(p.causal && k0 > wq_hi) &&
           !(p.window >= 0 && k1 <= wq_lo - p.window);
  };
  auto key_row = [&](const int8_t* base, int key) -> const int8_t* {
    return key < p.Sk ? base + (((long long)b * p.Sk + key) * p.KV + h) * hd
                      : nullptr;
  };
  float mrow[2] = {kBigNeg, kBigNeg}, lrow[2] = {0.0f, 0.0f};
  for (int kb = 0; kb < n_kb; ++kb) {
    bool any = false;
#pragma unroll
    for (int ks = 0; ks < KSB; ++ks) any |= live(kb * KSB + ks);
    if (!IntExp && !any) continue;  // exact skip
    float s[KSB][4][4];
    unsigned ok[KSB], live_ks = 0;
#pragma unroll
    for (int ks = 0; ks < KSB; ++ks) {
      ok[ks] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[ks][j][e] = kBigNeg;
      const int st = kb * KSB + ks, k0 = st * KS;
      if (!live(st)) continue;
      const int8_t* kr[4];
      bool kok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kok[j] = k0 + 8 * j + r_lo < p.Sk;
        kr[j] = kok[j] ? key_row(p.k, k0 + 8 * j + r_lo) : p.k;
      }
      float sc4[4][4];
      direct_scores<true>(sc4, p.q + qo[0], p.q + qo[1], row_ok[0],
                          row_ok[1], qplane, p.lqk, kr, kok, kplane, p.lqk,
                          hd, vec, s0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const bool v =
              row_ok[i] & visible(p, qpos[i], k0 + 8 * j + t2 + (e & 1));
          s[ks][j][e] = v ? __fmul_rn(sc4[j][e], p.sc) : kBigNeg;
          ok[ks] |= (unsigned)v << (4 * j + e);
        }
      live_ks |= 1u << ks;
    }
    float alpha[2];
    block_softmax<IntExp>(s, ok, mrow, lrow, alpha, pscale, p.p_bits,
                          [&](int ks, int (&pm)[4][4]) {
                            if (live_ks >> ks & 1)
                              store_limbs(fa, pm, p.lv, ks, lane);
                          });
    for (int d0 = 0; d0 < hd; d0 += KS) {
      float part[4][4];
      direct_partial(part, fa, p.lv, kplane, p.lv, d0, hd, live_ks,
                     [&](int ks, int r) {
                       return key_row(p.v, (kb * KSB + ks) * KS + r);
                     },
                     sv, -(p.p_bits - 1), lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int d = d0 + 8 * j + t2;
          update_pair(p.o + qo[i] + d, row_ok[i], d, hd, [&](int e, float x) {
            return __fadd_rn(__fmul_rn(x, alpha[i]), part[j][2 * i + e]);
          });
        }
    }
  }
  each([&](float* x, int i, int d) {
    update_pair(x, row_ok[i], d, hd, [&](int, float a) {
      return normalize<IntExp>(a, lrow[i]);
    });
  });
  if ((lane & 3) == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row_ok[i]) {
        const int rr = r0 + r_lo + 8 * i;
        p.lse[(((long long)b * p.KV + h) * p.G + rr / p.Sq) * p.Sq +
              rr % p.Sq] = lse_of(mrow[i], lrow[i]);
      }
}

// ------------------------------------------------------------ launch ----

int set_smem(const void* kernel, size_t smem, size_t* granted) {
  if (smem > *granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *granted = smem;
  }
  return 0;
}

// The widest copy the alignment allows; then the staged body (hd <= 256)
// with the narrowest CTA that covers the rows of one (batch, kv head), at
// most 4 warps, narrowed further until its shared memory fits (and its
// tiles fit grid.y); else the direct body (p.nw = 0).
size_t configure(Params& p) {
  p.hdp = (p.hd + KS - 1) / KS * KS;
  if (p.hdp > KS * 4) p.hdp = KS * kMaxChunks;  // the one wide staged body
  const uintptr_t base = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v;
  p.vec = 1;
  for (int v = 16; v >= 4; v /= 2)
    if (p.hd % v == 0 && base % v == 0) {
      p.vec = v;
      break;
    }
  if (p.hd <= KS * kMaxChunks) {
    const long long rows = (long long)p.G * p.Sq;
    for (p.nw = 4; p.nw > 1 && rows <= 8 * p.nw;) p.nw /= 2;
    for (; p.nw >= 1; p.nw /= 2) {
      const size_t smem = smem_layout(p).end;
      if (smem <= kSmemMax && (rows + 16 * p.nw - 1) / (16 * p.nw) <= 65535)
        return smem;  // (the tiles are grid.y)
    }
  }
  p.nw = 0;
  return (size_t)4 * p.lv * kLimbWords * 4;
}

template <int NDC, bool IntExp>
int launch_staged(const Params& p, size_t smem, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const int err = set_smem((const void*)fwd_kernel<NDC, IntExp>, smem,
                           &granted);
  if (err) return err;
  const int R = 16 * p.nw;
  const dim3 grid(p.B * p.KV, (p.G * p.Sq + R - 1) / R);
  fwd_kernel<NDC, IntExp><<<grid, 32 * p.nw, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool IntExp>
int launch_body(const Params& p, size_t smem, cudaStream_t stream) {
  if (p.nw == 0) {
    static size_t granted = 48 * 1024;
    const int err = set_smem((const void*)fwd_direct_kernel<IntExp>, smem,
                             &granted);
    if (err) return err;
    const dim3 grid((p.G * p.Sq + 63) / 64, p.B * p.KV);
    fwd_direct_kernel<IntExp><<<grid, 128, smem, stream>>>(p);
    return (int)cudaGetLastError();
  }
  switch (p.hdp / KS) {
    case 1: return launch_staged<1, IntExp>(p, smem, stream);
    case 2: return launch_staged<2, IntExp>(p, smem, stream);
    case 3: return launch_staged<3, IntExp>(p, smem, stream);
    case 4: return launch_staged<4, IntExp>(p, smem, stream);
    case kMaxChunks: return launch_staged<kMaxChunks, IntExp>(p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (lqk, B, Sq, KV, G, hd), k: (lqk, B, Sk, KV, hd), v: (lpv, B, Sk, KV,
// hd) int8 limb planes; off: (B,) int32 query offsets; exps: (3,) int32
// [q, k, v] exponents (device memory).  o: (B, Sq, KV, G, hd) f32; lse:
// (B, KV, G, Sq) f32.  window < 0 means no sliding window; integer_exp
// != 0 takes the kept_ops="integer" body.  Any hd; 1..3 planes each.
extern "C" int int_attn_fwd_launch(const int8_t* q, const int8_t* k,
                                   const int8_t* v, const int* off,
                                   const int* exps, float* o, float* lse,
                                   int B, int Sq, int Sk, int KV, int G,
                                   int hd, int lqk, int lpv, int p_bits,
                                   int causal, int window, float sc,
                                   int integer_exp, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if ((long long)B * KV > 65535 || lqk < 1 || lqk > 3 || lpv < 1 || lpv > 3)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, off, exps, o, lse, B, Sq, Sk, KV, G, hd, lqk, lpv,
           p_bits, causal, window, sc, 0, 0, 0};
  const size_t smem = configure(p);
  return integer_exp ? launch_body<true>(p, smem, stream)
                     : launch_body<false>(p, smem, stream);
}
