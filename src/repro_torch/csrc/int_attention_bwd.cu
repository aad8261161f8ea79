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
// Integer dots are exact int32; each f32 expression is the reference's, in
// its order (no FMA contraction).  The f32 sums over blocks are part of the
// result, so the blocks are the reference's: dq sums over 128-key blocks
// (its bk), dk and dv over blocks of bq query rows (its bq = min(128,
// Sq rounded up to 8)) of each group head in turn, group-major, so for GQA
// dk and dv are the sums over the G query heads of the kv head, in a fixed
// order (bit-identical from run to run).  A key block (dq) or a query
// sub-tile (dkv) that the mask hides from every row of the tile
// contributes exactly 0 and is skipped.
//
// Layout: the model layout, as the forward: q and g (L, B, Sq, KV, G, hd),
// k and v (L, B, Sk, KV, hd); lse (B, KV, G, Sq); delta (B, Sq, KV, G); dq
// (B, Sq, KV, G, hd), dk and dv (B, Sk, KV, hd) f32.  No rows-layout
// transpose or padding pass runs in device memory.  __dp4a wants both
// operands contiguous along the contraction: s = q.k^T and dp = g.v^T
// contract over hd and read rows as they lie; dq += dS.k, dk += dS^T.q and
// dv += P^T.g contract over keys or query rows, so their operands are
// staged transposed into shared memory (as the forward does for V), and
// dS and P are written transposed there, split into limb planes in
// registers (the digit split of csrc/dfx_common.cuh).
//
// Bound on the H100: bytes at the training shapes (each CTA re-reads its
// tile's K/V or Q/dO planes from L2, but the card needs to move each plane
// once); int8 operations only for sequences of many hundreds of rows.
// Design (the simple first version): dq: a CTA of 128 threads owns 16 query
// rows of one (batch, kv head, group head) and walks the 128-key blocks;
// one thread per key column computes s, p, dp, dS for all 16 rows (no
// reduction is needed), then the threads accumulate dq in shared memory.
// dkv: a CTA owns 32 keys (16 where shared memory is short) of one (batch,
// kv head) and walks the query rows of every group head in sub-tiles of 32;
// the limb-pair products of one reference q block accumulate in int32 in
// shared memory and are combined into the f32 sums at the block's end.
// Tensor-core MMA and a pipelined stream are later work.
#include "dfx_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 16;           // dq: query rows per CTA
constexpr int BKV = 128;         // dq: keys per block (the reference's bk)
constexpr int PS = BKV + 4;      // dq: byte stride of a dS / K^T smem row
constexpr int QS = 32;           // dkv: query rows per staged sub-tile
constexpr int QP = QS + 4;       // dkv: byte stride of a transposed row
constexpr float kBigNeg = -1e30f;

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
  int p_bits, ds_bits, causal, window, bq, kt;
  float sc;
};

__device__ __forceinline__ int word_at(const int8_t* base, int byte_off) {
  return *reinterpret_cast<const int*>(base + byte_off);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos,
                                        int kpos) {
  return kpos < p.Sk && (!p.causal || kpos <= qpos) &&
         (p.window < 0 || kpos > qpos - p.window);
}

// Ordered limb-pair dot of two int8 plane stacks, each row contiguous over
// the contraction (n4 bytes, a multiple of 4), planes a_plane / b_plane
// bytes apart; combined in f32 as the reference's _limb_dot / _plane_dot:
// sum_{ja, jb} (f32(a_ja . b_jb) * s0) * 2^(7(ja+jb) + shift).
__device__ __forceinline__ float limb_dot(const int8_t* a, int la,
                                          int a_plane, const int8_t* b,
                                          int lb, int b_plane, int n4,
                                          float s0, int shift) {
  float out = 0.0f;
  for (int ja = 0; ja < la; ++ja)
    for (int jb = 0; jb < lb; ++jb) {
      const int8_t* ar = a + ja * a_plane;
      const int8_t* br = b + jb * b_plane;
      int dot = 0;
      for (int c = 0; c < n4; c += 4)
        dot = __dp4a(word_at(ar, c), word_at(br, c), dot);
      const float part =
          __fmul_rn(__fmul_rn((float)dot, s0),
                    dfx::pow2f(dfx::kLimbBits * (ja + jb) + shift));
      out = (ja == 0 && jb == 0) ? part : __fadd_rn(out, part);
    }
  return out;
}

__device__ __forceinline__ int round_clip(float y, int bits) {
  const float lim = (float)((1 << (bits - 1)) - 1);
  return (int)fminf(fmaxf(rintf(y), -lim), lim);
}

// Copy `rows` rows of `n` int8 values (row r at src + r * src_stride) into
// smem rows of `dst_stride` bytes, zero past `valid` rows and past n (up to
// n4 bytes).  Word loads where a whole aligned word lies inside the row.
__device__ __forceinline__ void stage_rows(int8_t* dst, int dst_stride,
                                           const int8_t* src,
                                           long long src_stride, int rows,
                                           int valid, int n, int n4) {
  const int w = n4 / 4;
  for (int e = threadIdx.x; e < rows * w; e += kThreads) {
    const int r = e / w, c = (e % w) * 4;
    unsigned int word = 0;
    if (r < valid) {
      const int8_t* s = src + r * src_stride + c;
      if (c + 4 <= n && (reinterpret_cast<uintptr_t>(s) & 3) == 0) {
        word = *reinterpret_cast<const unsigned int*>(s);
      } else {
        for (int i = 0; i < 4; ++i)
          if (c + i < n) word |= (unsigned int)(uint8_t)s[i] << (8 * i);
      }
    }
    *reinterpret_cast<unsigned int*>(dst + r * dst_stride + c) = word;
  }
}

// Copy `rows` rows of `n` int8 values transposed: dst[d * dst_stride + r] =
// src[r * src_stride + d], zero past `valid` rows.
__device__ __forceinline__ void stage_cols(int8_t* dst, int dst_stride,
                                           const int8_t* src,
                                           long long src_stride, int rows,
                                           int valid, int n) {
  for (int e = threadIdx.x; e < rows * n; e += kThreads) {
    const int r = e / n, d = e % n;
    dst[d * dst_stride + r] = r < valid ? src[r * src_stride + d] : 0;
  }
}

// ---------------------------------------------------------------- dq ----

__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd, hd4 = (hd + 3) & ~3, HP = hd4 + 4;
  int8_t* qs = reinterpret_cast<int8_t*>(smem);  // [lqk][BQ][HP]
  int8_t* gs = qs + p.lqk * BQ * HP;             // [lg][BQ][HP]
  int8_t* ks = gs + p.lg * BQ * HP;              // [lqk][BKV][HP]
  int8_t* vs = ks + p.lqk * BKV * HP;            // [lv][BKV][HP]
  int8_t* kt = vs + p.lv * BKV * HP;             // [lqk][hd][PS]
  int8_t* dss = kt + p.lqk * hd * PS;            // [lds][BQ][PS]
  float* acc = reinterpret_cast<float*>(dss + p.lds * BQ * PS);  // [BQ][hd]
  float* lse_s = acc + BQ * hd;                  // [BQ]
  float* del_s = lse_s + BQ;                     // [BQ]

  const int t = threadIdx.x;
  const int qt = blockIdx.x, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int sq0 = qt * BQ;
  const int rows = min(BQ, p.Sq - sq0);
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const long long qrow = (long long)p.KV * p.G * hd;  // q row stride
  const long long krow = (long long)p.KV * hd;        // k row stride
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float sdp = dfx::pow2f(p.exps[3] + p.exps[2]);
  const int dse = p.exps[4];
  const float sdq = dfx::pow2f(dse + p.exps[1]);
  const float inv_ds = dfx::pow2f(-dse);

  const long long q_base = (((long long)b * p.Sq + sq0) * p.KV + h) * p.G * hd +
                           (long long)g * hd;
  for (int j = 0; j < p.lqk; ++j)
    stage_rows(qs + j * BQ * HP, HP, p.q + j * qplane + q_base, qrow, BQ,
               rows, hd, hd4);
  for (int j = 0; j < p.lg; ++j)
    stage_rows(gs + j * BQ * HP, HP, p.g + j * qplane + q_base, qrow, BQ,
               rows, hd, hd4);
  for (int e = t; e < BQ * hd; e += kThreads) acc[e] = 0.0f;
  if (t < rows) {
    lse_s[t] = p.lse[(((long long)b * p.KV + h) * p.G + g) * p.Sq + sq0 + t];
    del_s[t] = p.delta[(((long long)b * p.Sq + sq0 + t) * p.KV + h) * p.G + g];
  }
  const int q_lo = off + sq0, q_hi = off + sq0 + rows - 1;

  const int n_kb = (p.Sk + BKV - 1) / BKV;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_lo = kb * BKV;
    const int k_hi = min(k_lo + BKV, p.Sk) - 1;
    if (p.causal && k_lo > q_hi) continue;                   // all k > q
    if (p.window >= 0 && k_hi <= q_lo - p.window) continue;  // all outside
    __syncthreads();  // the previous block's smem reads are done
    const int nk = k_hi - k_lo + 1;
    const long long k_base = (((long long)b * p.Sk + k_lo) * p.KV + h) * hd;
    for (int j = 0; j < p.lqk; ++j) {
      stage_rows(ks + j * BKV * HP, HP, p.k + j * kplane + k_base, krow, BKV,
                 nk, hd, hd4);
      stage_cols(kt + j * hd * PS, PS, p.k + j * kplane + k_base, krow, BKV,
                 nk, hd);
    }
    for (int j = 0; j < p.lv; ++j)
      stage_rows(vs + j * BKV * HP, HP, p.v + j * kplane + k_base, krow, BKV,
                 nk, hd, hd4);
    __syncthreads();

    // Thread t owns key column t: s, p, dp, dS for every row of the tile.
    {
      const int kpos = k_lo + t;
      for (int r = 0; r < BQ; ++r) {
        int dsm = 0;
        if (r < rows && visible(p, off + sq0 + r, kpos)) {
          const float s = __fmul_rn(
              limb_dot(qs + r * HP, p.lqk, BQ * HP, ks + t * HP, p.lqk,
                       BKV * HP, hd4, s0, 0),
              p.sc);
          const float pr = expf(__fsub_rn(s, lse_s[r]));
          const float dp = limb_dot(gs + r * HP, p.lg, BQ * HP, vs + t * HP,
                                    p.lv, BKV * HP, hd4, sdp, 0);
          const float ds = __fmul_rn(pr, __fsub_rn(dp, del_s[r]));
          dsm = round_clip(__fmul_rn(ds, inv_ds), p.ds_bits);
        }
        dfx::split_limbs(dsm, p.lds, [&](int j, int dgt) {
          dss[(j * BQ + r) * PS + t] = (int8_t)dgt;
        });
      }
    }
    __syncthreads();

    // dq[r][d] += ordered sum over (dS limb, K limb) of dS . K over keys.
    for (int e = t; e < BQ * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float part = limb_dot(dss + r * PS, p.lds, BQ * PS, kt + d * PS,
                                  p.lqk, hd * PS, BKV, sdq, 0);
      acc[e] = __fadd_rn(acc[e], part);
    }
  }
  __syncthreads();
  for (int e = t; e < rows * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    p.dq[(((long long)b * p.Sq + sq0 + r) * p.KV + h) * p.G * hd +
         (long long)g * hd + d] = __fmul_rn(acc[e], p.sc);
  }
}

// --------------------------------------------------------------- dkv ----

struct DkvSmem {
  int HP, kt;
  size_t ks, vs, qr, gr, qt, gt, dst, pmt, idk, idv, fdk, fdv, lse, del, end;
};

// Shared-memory carve-up of the dkv kernel (byte offsets; every region is a
// multiple of 4 bytes).
__host__ __device__ inline DkvSmem dkv_smem(const Params& p, int kt) {
  DkvSmem m;
  const int hd4 = (p.hd + 3) & ~3;
  m.HP = hd4 + 4;
  m.kt = kt;
  size_t o = 0;
  m.ks = o;  o += (size_t)p.lqk * kt * m.HP;        // K rows [lqk][kt][HP]
  m.vs = o;  o += (size_t)p.lv * kt * m.HP;         // V rows [lv][kt][HP]
  m.qr = o;  o += (size_t)p.lqk * QS * m.HP;        // Q rows [lqk][QS][HP]
  m.gr = o;  o += (size_t)p.lg * QS * m.HP;         // dO rows [lg][QS][HP]
  m.qt = o;  o += (size_t)p.lqk * p.hd * QP;        // Q^T [lqk][hd][QP]
  m.gt = o;  o += (size_t)p.lg * p.hd * QP;         // dO^T [lg][hd][QP]
  m.dst = o; o += (size_t)p.lds * kt * QP;          // dS^T [lds][kt][QP]
  m.pmt = o; o += (size_t)p.lv * kt * QP;           // P^T [lv][kt][QP]
  m.idk = o; o += 4 * (size_t)p.lds * p.lqk * kt * p.hd;  // int32 dk pairs
  m.idv = o; o += 4 * (size_t)p.lv * p.lg * kt * p.hd;    // int32 dv pairs
  m.fdk = o; o += 4 * (size_t)kt * p.hd;            // f32 dk
  m.fdv = o; o += 4 * (size_t)kt * p.hd;            // f32 dv
  m.lse = o; o += 4 * QS;
  m.del = o; o += 4 * QS;
  m.end = o;
  return m;
}

__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DkvSmem m = dkv_smem(p, p.kt);
  const int hd = p.hd, hd4 = (hd + 3) & ~3, HP = m.HP, KT = p.kt;
  int8_t* ks = reinterpret_cast<int8_t*>(smem + m.ks);
  int8_t* vs = reinterpret_cast<int8_t*>(smem + m.vs);
  int8_t* qr = reinterpret_cast<int8_t*>(smem + m.qr);
  int8_t* gr = reinterpret_cast<int8_t*>(smem + m.gr);
  int8_t* qtr = reinterpret_cast<int8_t*>(smem + m.qt);
  int8_t* gtr = reinterpret_cast<int8_t*>(smem + m.gt);
  int8_t* dst = reinterpret_cast<int8_t*>(smem + m.dst);
  int8_t* pmt = reinterpret_cast<int8_t*>(smem + m.pmt);
  int* idk = reinterpret_cast<int*>(smem + m.idk);
  int* idv = reinterpret_cast<int*>(smem + m.idv);
  float* fdk = reinterpret_cast<float*>(smem + m.fdk);
  float* fdv = reinterpret_cast<float*>(smem + m.fdv);
  float* lse_s = reinterpret_cast<float*>(smem + m.lse);
  float* del_s = reinterpret_cast<float*>(smem + m.del);

  const int t = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int k_lo = blockIdx.x * KT;
  const int nk = min(KT, p.Sk - k_lo);
  const int k_hi = k_lo + nk - 1;
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
  const int ndk = p.lds * p.lqk, ndv = p.lv * p.lg;
  const int n_out = KT * hd;

  const long long k_base = (((long long)b * p.Sk + k_lo) * p.KV + h) * hd;
  for (int j = 0; j < p.lqk; ++j)
    stage_rows(ks + j * KT * HP, HP, p.k + j * kplane + k_base, krow, KT, nk,
               hd, hd4);
  for (int j = 0; j < p.lv; ++j)
    stage_rows(vs + j * KT * HP, HP, p.v + j * kplane + k_base, krow, KT, nk,
               hd, hd4);
  for (int e = t; e < n_out; e += kThreads) {
    fdk[e] = 0.0f;
    fdv[e] = 0.0f;
    for (int i = 0; i < ndk; ++i) idk[i * n_out + e] = 0;
    for (int i = 0; i < ndv; ++i) idv[i * n_out + e] = 0;
  }

  for (int g = 0; g < p.G; ++g) {
    for (int qb0 = 0; qb0 < p.Sq; qb0 += p.bq) {
      const int qb_end = min(qb0 + p.bq, p.Sq);
      for (int r0 = qb0; r0 < qb_end; r0 += QS) {
        const int nr = min(QS, qb_end - r0);
        const int q_lo = off + r0, q_hi = off + r0 + nr - 1;
        if (p.causal && k_lo > q_hi) continue;                   // k > q
        if (p.window >= 0 && k_hi <= q_lo - p.window) continue;  // outside
        __syncthreads();  // the previous sub-tile's smem reads are done
        const long long q_base =
            (((long long)b * p.Sq + r0) * p.KV + h) * p.G * hd +
            (long long)g * hd;
        for (int j = 0; j < p.lqk; ++j) {
          stage_rows(qr + j * QS * HP, HP, p.q + j * qplane + q_base, qrow,
                     QS, nr, hd, hd4);
          stage_cols(qtr + j * hd * QP, QP, p.q + j * qplane + q_base, qrow,
                     QS, nr, hd);
        }
        for (int j = 0; j < p.lg; ++j) {
          stage_rows(gr + j * QS * HP, HP, p.g + j * qplane + q_base, qrow,
                     QS, nr, hd, hd4);
          stage_cols(gtr + j * hd * QP, QP, p.g + j * qplane + q_base, qrow,
                     QS, nr, hd);
        }
        if (t < nr) {
          lse_s[t] =
              p.lse[(((long long)b * p.KV + h) * p.G + g) * p.Sq + r0 + t];
          del_s[t] =
              p.delta[(((long long)b * p.Sq + r0 + t) * p.KV + h) * p.G + g];
        }
        __syncthreads();

        // s, p, dp, dS for every (row, key) of the sub-tile; P and dS limb
        // digits written transposed (row-contiguous per key).
        for (int e = t; e < QS * KT; e += kThreads) {
          const int r = e / KT, c = e % KT;
          int pm = 0, dsm = 0;
          if (r < nr && visible(p, off + r0 + r, k_lo + c)) {
            const float s = __fmul_rn(
                limb_dot(qr + r * HP, p.lqk, QS * HP, ks + c * HP, p.lqk,
                         KT * HP, hd4, s0, 0),
                p.sc);
            const float pr = expf(__fsub_rn(s, lse_s[r]));
            pm = round_clip(__fmul_rn(pr, pscale), p.p_bits);
            const float dp = limb_dot(gr + r * HP, p.lg, QS * HP,
                                      vs + c * HP, p.lv, KT * HP, hd4, sdp,
                                      0);
            const float ds = __fmul_rn(pr, __fsub_rn(dp, del_s[r]));
            dsm = round_clip(__fmul_rn(ds, inv_ds), p.ds_bits);
          }
          dfx::split_limbs(pm, p.lv, [&](int j, int dgt) {
            pmt[(j * KT + c) * QP + r] = (int8_t)dgt;
          });
          dfx::split_limbs(dsm, p.lds, [&](int j, int dgt) {
            dst[(j * KT + c) * QP + r] = (int8_t)dgt;
          });
        }
        __syncthreads();

        // int32 limb-pair sums over the sub-tile's rows, per (key, d).
        for (int e = t; e < n_out; e += kThreads) {
          const int c = e / hd, d = e % hd;
          for (int ja = 0; ja < p.lv; ++ja)
            for (int jb = 0; jb < p.lg; ++jb) {
              const int8_t* a = pmt + (ja * KT + c) * QP;
              const int8_t* bb = gtr + (jb * hd + d) * QP;
              int dot = idv[(ja * p.lg + jb) * n_out + e];
              for (int i = 0; i < QS; i += 4)
                dot = __dp4a(word_at(a, i), word_at(bb, i), dot);
              idv[(ja * p.lg + jb) * n_out + e] = dot;
            }
          for (int ja = 0; ja < p.lds; ++ja)
            for (int jb = 0; jb < p.lqk; ++jb) {
              const int8_t* a = dst + (ja * KT + c) * QP;
              const int8_t* bb = qtr + (jb * hd + d) * QP;
              int dot = idk[(ja * p.lqk + jb) * n_out + e];
              for (int i = 0; i < QS; i += 4)
                dot = __dp4a(word_at(a, i), word_at(bb, i), dot);
              idk[(ja * p.lqk + jb) * n_out + e] = dot;
            }
        }
      }
      // End of a reference q block: the ordered f32 combine of its
      // limb-pair sums, added to the running dk / dv (each thread its own
      // elements, as in the loop above).
      for (int e = t; e < n_out; e += kThreads) {
        float pv = 0.0f;
        for (int ja = 0; ja < p.lv; ++ja)
          for (int jb = 0; jb < p.lg; ++jb) {
            int* cell = idv + (ja * p.lg + jb) * n_out + e;
            const float part = __fmul_rn(
                __fmul_rn((float)*cell, sdv),
                dfx::pow2f(dfx::kLimbBits * (ja + jb) - (p.p_bits - 1)));
            pv = (ja == 0 && jb == 0) ? part : __fadd_rn(pv, part);
            *cell = 0;
          }
        fdv[e] = __fadd_rn(fdv[e], pv);
        float pk = 0.0f;
        for (int ja = 0; ja < p.lds; ++ja)
          for (int jb = 0; jb < p.lqk; ++jb) {
            int* cell = idk + (ja * p.lqk + jb) * n_out + e;
            const float part =
                __fmul_rn(__fmul_rn((float)*cell, sdk),
                          dfx::pow2f(dfx::kLimbBits * (ja + jb)));
            pk = (ja == 0 && jb == 0) ? part : __fadd_rn(pk, part);
            *cell = 0;
          }
        fdk[e] = __fadd_rn(fdk[e], pk);
      }
    }
  }

  for (int e = t; e < nk * hd; e += kThreads) {
    const int c = e / hd, d = e % hd;
    const long long o = (((long long)b * p.Sk + k_lo + c) * p.KV + h) * hd + d;
    p.dk[o] = __fmul_rn(fdk[e], p.sc);
    p.dv[o] = fdv[e];
  }
}

constexpr size_t kSmemMax = 227 * 1024;

int set_smem(const void* kernel, size_t smem, size_t* granted) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > *granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *granted = smem;
  }
  return 0;
}

bool bad_limbs(const Params& p) {
  return p.lqk < 1 || p.lqk > 3 || p.lv < 1 || p.lv > 3 || p.lg < 1 ||
         p.lg > 3 || p.lds < 1 || p.lds > 3;
}

}  // namespace

// q, g: (lqk | lg, B, Sq, KV, G, hd); k, v: (lqk | lv, B, Sk, KV, hd) int8
// limb planes; lse (B, KV, G, Sq) and delta (B, Sq, KV, G) f32; off (B,)
// int32 query offsets; exps (5,) int32 [q, k, v, g, dS] exponents (device
// memory).  dq: (B, Sq, KV, G, hd) f32.  window < 0: no sliding window.
extern "C" int int_attn_bwd_dq_launch(
    const int8_t* q, const int8_t* k, const int8_t* v, const int8_t* g,
    const float* lse, const float* delta, const int* off, const int* exps,
    float* dq, int B, int Sq, int Sk, int KV, int G, int hd, int lqk, int lv,
    int lg, int lds, int ds_bits, int causal, int window, float sc,
    cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if (G > 65535 || (long long)B * KV > 65535) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, g, lse, delta, off, exps, dq, nullptr, nullptr,
                 B, Sq, Sk, KV, G, hd, lqk, lv, lg, lds, 0, ds_bits, causal,
                 window, 0, 0, sc};
  if (bad_limbs(p)) return (int)cudaErrorInvalidValue;
  const int hd4 = (hd + 3) & ~3, HP = hd4 + 4;
  const size_t smem = (size_t)(lqk + lg) * BQ * HP +
                      (size_t)(lqk + lv) * BKV * HP + (size_t)lqk * hd * PS +
                      (size_t)lds * BQ * PS +
                      sizeof(float) * ((size_t)BQ * hd + 2 * BQ);
  static size_t granted = 48 * 1024;
  const int err = set_smem((const void*)dq_kernel, smem, &granted);
  if (err) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, G, B * KV);
  dq_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Arguments as int_attn_bwd_dq_launch; bq is the reference's query block
// (min(128, Sq rounded up to 8)), p_bits P's bits (v has n_limbs(p_bits)
// planes).  dk, dv: (B, Sk, KV, hd) f32.
extern "C" int int_attn_bwd_dkv_launch(
    const int8_t* q, const int8_t* k, const int8_t* v, const int8_t* g,
    const float* lse, const float* delta, const int* off, const int* exps,
    float* dk, float* dv, int B, int Sq, int Sk, int KV, int G, int hd,
    int lqk, int lv, int lg, int lds, int p_bits, int ds_bits, int bq,
    int causal, int window, float sc, cudaStream_t stream) {
  if (B <= 0 || Sk <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if ((long long)B * KV > 65535 || bq <= 0) return (int)cudaErrorInvalidValue;
  Params p{q, k, v, g, lse, delta, off, exps, nullptr, dk, dv,
           B, Sq, Sk, KV, G, hd, lqk, lv, lg, lds, p_bits, ds_bits, causal,
           window, bq, 32, sc};
  if (bad_limbs(p)) return (int)cudaErrorInvalidValue;
  // 32 keys per CTA, 16 where the int32 pair sums would not fit.
  size_t smem = dkv_smem(p, 32).end;
  if (smem > kSmemMax) {
    p.kt = 16;
    smem = dkv_smem(p, 16).end;
  }
  static size_t granted = 48 * 1024;
  const int err = set_smem((const void*)dkv_kernel, smem, &granted);
  if (err) return err;
  const dim3 grid((Sk + p.kt - 1) / p.kt, B * KV);
  dkv_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}
