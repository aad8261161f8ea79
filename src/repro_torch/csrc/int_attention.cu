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
// the TPU: P is quantized against the running max, so the block width is
// part of the result.  Integer dots are exact int32; each f32 expression
// is the reference's, in its order (no FMA contraction).  A key block that
// is masked for every row of the tile is skipped: there it would leave m,
// l and acc unchanged (p = 0, alpha = exp(0) = 1), so skipping it is exact.
// Not so under IntExp, where i_exp(0) = 16381 / 2^14: a skipped block
// still scales l and acc by it, as the reference's grid step does.
//
// Layout: the planes arrive in the model layout, q (Lq, B, Sq, KV, G, hd)
// and k/v (L, B, Sk, KV, hd), and the kernel computes its own offsets, so
// no rows-layout transpose or padding pass runs in device memory; the
// ragged Sq, Sk and hd edges are masked here.  GQA: G query heads share one
// kv head (grid axis y = g).
//
// Bound on the H100: bytes on the serving path (a decode row reads the K/V
// planes of every cached key it may see for a few int8 operations per
// byte; a 64-token prefill over a 256-deep cache is still byte-bound);
// int8 operations only for prompts of many hundreds of rows.
// Design (the simple first version): a CTA of 128 threads owns 16 query
// rows of one (batch, kv head, group head) and walks the key blocks; the
// block's K planes and transposed V planes (K-contiguous for __dp4a) are
// staged in shared memory, one thread per key column computes the scores,
// 8 threads per row run the softmax update and the in-register P split, and
// the PV product accumulates in shared memory.  Tensor-core MMA and a
// pipelined K/V stream are later work.
#include "dfx_common.cuh"
#include "iapprox.cuh"

namespace {

constexpr int BQ = 16;           // query rows per CTA
constexpr int BKV = 128;         // keys per online-softmax update
constexpr int kThreads = 128;    // == BKV: one thread per key column
constexpr int PS = BKV + 4;      // byte stride of a P / V^T smem row
constexpr int RPT = 8;           // threads per row in the softmax phase
constexpr float kBigNeg = -1e30f;

struct Params {
  const int8_t* q;
  const int8_t* k;
  const int8_t* v;
  const int* off;
  const int* exps;
  float* o;
  float* lse;
  int B, Sq, Sk, KV, G, hd, p_bits, causal, window;
  float sc;
};

__device__ __forceinline__ int word_at(const int8_t* base, int byte_off) {
  return *reinterpret_cast<const int*>(base + byte_off);
}

// The online softmax's exp: FP32, or the Q.14 form.
template <bool IntExp>
__device__ __forceinline__ float p_exp(float x) {
  if constexpr (IntExp) return iapprox::i_exp(x);
  return expf(x);
}

template <int LQK, int LPV, bool IntExp>
__global__ void __launch_bounds__(kThreads)
int_attn_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = p.hd;
  const int hd4 = (hd + 3) & ~3;
  const int HP = hd4 + 4;  // byte stride of a q / k smem row
  int8_t* qs = reinterpret_cast<int8_t*>(smem);       // [LQK][BQ][HP]
  int8_t* ks = qs + LQK * BQ * HP;                    // [LQK][BKV][HP]
  int8_t* vt = ks + LQK * BKV * HP;                   // [LPV][hd][PS]
  int8_t* ps = vt + LPV * hd * PS;                    // [LPV][BQ][PS]
  float* sf = reinterpret_cast<float*>(ps + LPV * BQ * PS);  // [BQ][BKV]
  float* red = sf + BQ * BKV;                         // [BQ][RPT]
  float* acc = red + BQ * RPT;                        // [BQ][hd]
  float* mrow = acc + BQ * hd;                         // [BQ]
  float* lrow = mrow + BQ;                            // [BQ]
  float* arow = lrow + BQ;                            // [BQ]

  const int t = threadIdx.x;
  const int qt = blockIdx.x, g = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.KV, h = bh % p.KV;
  const int off = p.off[b];
  const int sq0 = qt * BQ;
  const int rows = min(BQ, p.Sq - sq0);   // valid query rows of this tile
  const long long qplane = (long long)p.B * p.Sq * p.KV * p.G * hd;
  const long long kplane = (long long)p.B * p.Sk * p.KV * hd;
  const float s0 = dfx::pow2f(p.exps[0] + p.exps[1]);
  const float ve = dfx::pow2f(p.exps[2]);
  const float pscale = dfx::pow2f(p.p_bits - 1);
  const float plim = (float)((1 << (p.p_bits - 1)) - 1);

  // Stage the tile's query planes (zero rows past Sq, zero columns past hd).
  for (int e = t; e < LQK * BQ * HP; e += kThreads) {
    const int j = e / (BQ * HP), r = (e / HP) % BQ, d = e % HP;
    int8_t val = 0;
    if (r < rows && d < hd)
      val = p.q[j * qplane +
                ((((long long)b * p.Sq + sq0 + r) * p.KV + h) * p.G + g) * hd +
                d];
    qs[e] = val;
  }
  for (int e = t; e < BQ * hd; e += kThreads) acc[e] = 0.0f;
  if (t < BQ) {
    mrow[t] = kBigNeg;
    lrow[t] = 0.0f;
  }
  const int q_lo = off + sq0, q_hi = off + sq0 + rows - 1;
  __syncthreads();

  const int n_kb = (p.Sk + BKV - 1) / BKV;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k_lo = kb * BKV;
    const int k_hi = min(k_lo + BKV, p.Sk) - 1;
    if ((p.causal && k_lo > q_hi) ||                   // all k > q
        (p.window >= 0 && k_hi <= q_lo - p.window)) {  // all outside
      if constexpr (IntExp) {
        // m stays, p = 0: l = l * i_exp(0) + 0, acc = acc * i_exp(0) + 0
        const float a0 = iapprox::i_exp(0.0f);
        for (int e = t; e < BQ * hd; e += kThreads)
          acc[e] = __fadd_rn(__fmul_rn(acc[e], a0), 0.0f);
        if (t < BQ) lrow[t] = __fadd_rn(__fmul_rn(lrow[t], a0), 0.0f);
        __syncthreads();
      }
      continue;
    }

    // Stage K (row-major, K-contiguous rows) and V transposed (d-major).
    for (int e = t; e < LPV * BKV * (hd4 / 4); e += kThreads) {
      const int j = e / (BKV * (hd4 / 4)), kr = (e / (hd4 / 4)) % BKV;
      const int c = (e % (hd4 / 4)) * 4, kpos = k_lo + kr;
      const int8_t* src = p.v + j * kplane +
                          (((long long)b * p.Sk + kpos) * p.KV + h) * hd;
      for (int i = 0; i < 4; ++i) {
        int8_t val = 0;
        if (kpos < p.Sk && c + i < hd) val = src[c + i];
        if (c + i < hd) vt[(j * hd + c + i) * PS + kr] = val;
      }
    }
    for (int e = t; e < LQK * BKV * (hd4 / 4); e += kThreads) {
      const int j = e / (BKV * (hd4 / 4)), kr = (e / (hd4 / 4)) % BKV;
      const int c = (e % (hd4 / 4)) * 4, kpos = k_lo + kr;
      const int8_t* src = p.k + j * kplane +
                          (((long long)b * p.Sk + kpos) * p.KV + h) * hd;
      unsigned int word = 0;
      if (kpos < p.Sk) {
        if ((hd & 3) == 0) {
          word = *reinterpret_cast<const unsigned int*>(src + c);
        } else {
          for (int i = 0; i < 4; ++i)
            if (c + i < hd) word |= (unsigned int)(uint8_t)src[c + i] << (8 * i);
        }
      }
      *reinterpret_cast<unsigned int*>(ks + (j * BKV + kr) * HP + c) = word;
    }
    __syncthreads();

    // Scores: thread t owns key column t of the block, all BQ rows.
    {
      const int kpos = k_lo + t;
      for (int r = 0; r < BQ; ++r) {
        float s = 0.0f;
#pragma unroll
        for (int ja = 0; ja < LQK; ++ja)
#pragma unroll
          for (int jb = 0; jb < LQK; ++jb) {
            const int8_t* qa = qs + (ja * BQ + r) * HP;
            const int8_t* kbp = ks + (jb * BKV + t) * HP;
            int dot = 0;
            for (int c = 0; c < hd4; c += 4)
              dot = __dp4a(word_at(qa, c), word_at(kbp, c), dot);
            const float part =
                __fmul_rn(__fmul_rn((float)dot, s0),
                          dfx::pow2f(dfx::kLimbBits * (ja + jb)));
            s = (ja == 0 && jb == 0) ? part : __fadd_rn(s, part);
          }
        s = __fmul_rn(s, p.sc);
        const int qpos = off + sq0 + r;
        const bool ok = r < rows && kpos < p.Sk &&
                        (!p.causal || kpos <= qpos) &&
                        (p.window < 0 || kpos > qpos - p.window);
        sf[r * BKV + t] = ok ? s : kBigNeg;
      }
    }
    __syncthreads();

    // Online softmax update: RPT threads per row, 16 columns each.
    const int r = t / RPT, part = t % RPT;
    const int qpos = off + sq0 + r;
    float* srow = sf + r * BKV;
    float mloc = kBigNeg;
    for (int i = 0; i < BKV / RPT; ++i)
      mloc = fmaxf(mloc, srow[part * (BKV / RPT) + i]);
    red[r * RPT + part] = mloc;
    __syncthreads();
    const float m_prev = mrow[r];
    float m_new = m_prev;
    for (int i = 0; i < RPT; ++i) m_new = fmaxf(m_new, red[r * RPT + i]);
    __syncthreads();  // every thread has read red before it is reused
    float lsum = 0.0f;
    for (int i = 0; i < BKV / RPT; ++i) {
      const int col = part * (BKV / RPT) + i, kpos = k_lo + col;
      const bool ok = r < rows && kpos < p.Sk &&
                      (!p.causal || kpos <= qpos) &&
                      (p.window < 0 || kpos > qpos - p.window);
      const float pv =
          ok ? p_exp<IntExp>(__fsub_rn(srow[col], m_new)) : 0.0f;
      lsum = i == 0 ? pv : __fadd_rn(lsum, pv);
      const int pm = (int)fminf(fmaxf(rintf(__fmul_rn(pv, pscale)), -plim),
                                plim);
      dfx::split_limbs(pm, LPV, [&](int j, int dgt) {
        ps[(j * BQ + r) * PS + col] = (int8_t)dgt;
      });
    }
    red[r * RPT + part] = lsum;
    __syncthreads();
    if (part == 0) {
      float rs = red[r * RPT];
      for (int i = 1; i < RPT; ++i) rs = __fadd_rn(rs, red[r * RPT + i]);
      const float alpha = p_exp<IntExp>(__fsub_rn(m_prev, m_new));
      arow[r] = alpha;
      lrow[r] = __fadd_rn(__fmul_rn(lrow[r], alpha), rs);
      mrow[r] = m_new;
    }
    __syncthreads();

    // PV: acc[r][d] = acc * alpha + ordered sum over (P limb, V limb).
    for (int e = t; e < BQ * hd; e += kThreads) {
      const int rr = e / hd, d = e % hd;
      float pv = 0.0f;
#pragma unroll
      for (int ja = 0; ja < LPV; ++ja)
#pragma unroll
        for (int jb = 0; jb < LPV; ++jb) {
          const int8_t* pa = ps + (ja * BQ + rr) * PS;
          const int8_t* vb = vt + (jb * hd + d) * PS;
          int dot = 0;
          for (int c = 0; c < BKV; c += 4)
            dot = __dp4a(word_at(pa, c), word_at(vb, c), dot);
          const float part2 = __fmul_rn(
              __fmul_rn((float)dot, ve),
              dfx::pow2f(dfx::kLimbBits * (ja + jb) - (p.p_bits - 1)));
          pv = (ja == 0 && jb == 0) ? part2 : __fadd_rn(pv, part2);
        }
      acc[e] = __fadd_rn(__fmul_rn(acc[e], arow[rr]), pv);
    }
    __syncthreads();
  }

  for (int e = t; e < rows * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const float l = fmaxf(lrow[r], 1e-20f);
    p.o[((((long long)b * p.Sq + sq0 + r) * p.KV + h) * p.G + g) * hd + d] =
        IntExp ? __fmul_rn(acc[e], iapprox::i_recip(l)) : __fdiv_rn(acc[e], l);
  }
  if (t < rows)
    p.lse[(((long long)b * p.KV + h) * p.G + g) * p.Sq + sq0 + t] =
        __fadd_rn(mrow[t], logf(fmaxf(lrow[t], 1e-37f)));
}

template <int LQK, int LPV, bool IntExp>
int launch(const Params& p, cudaStream_t stream) {
  const int hd4 = (p.hd + 3) & ~3, HP = hd4 + 4;
  const size_t smem = (size_t)LQK * BQ * HP + (size_t)LQK * BKV * HP +
                      (size_t)LPV * p.hd * PS + (size_t)LPV * BQ * PS +
                      sizeof(float) * ((size_t)BQ * BKV + BQ * RPT +
                                       (size_t)BQ * p.hd + 3 * BQ);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        int_attn_fwd_kernel<LQK, LPV, IntExp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    granted = smem;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.G, p.B * p.KV);
  int_attn_fwd_kernel<LQK, LPV, IntExp><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int LQK, int LPV>
int dispatch(const Params& p, int integer_exp, cudaStream_t stream) {
  return integer_exp ? launch<LQK, LPV, true>(p, stream)
                     : launch<LQK, LPV, false>(p, stream);
}

}  // namespace

// q: (lqk, B, Sq, KV, G, hd), k: (lqk, B, Sk, KV, hd), v: (lpv, B, Sk, KV,
// hd) int8 limb planes; off: (B,) int32 query offsets; exps: (3,) int32
// [q, k, v] exponents (device memory).  o: (B, Sq, KV, G, hd) f32; lse:
// (B, KV, G, Sq) f32.  window < 0 means no sliding window; integer_exp
// != 0 takes the kept_ops="integer" body.
extern "C" int int_attn_fwd_launch(const int8_t* q, const int8_t* k,
                                   const int8_t* v, const int* off,
                                   const int* exps, float* o, float* lse,
                                   int B, int Sq, int Sk, int KV, int G,
                                   int hd, int lqk, int lpv, int p_bits,
                                   int causal, int window, float sc,
                                   int integer_exp, cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || G <= 0 || hd <= 0) return 0;
  if (G > 65535 || (long long)B * KV > 65535) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, off, exps, o, lse, B, Sq, Sk, KV, G, hd, p_bits,
                 causal, window, sc};
  switch (lqk * 4 + lpv) {
    case 5: return dispatch<1, 1>(p, integer_exp, stream);
    case 6: return dispatch<1, 2>(p, integer_exp, stream);
    case 7: return dispatch<1, 3>(p, integer_exp, stream);
    case 9: return dispatch<2, 1>(p, integer_exp, stream);
    case 10: return dispatch<2, 2>(p, integer_exp, stream);
    case 11: return dispatch<2, 3>(p, integer_exp, stream);
    case 13: return dispatch<3, 1>(p, integer_exp, stream);
    case 14: return dispatch<3, 2>(p, integer_exp, stream);
    case 15: return dispatch<3, 3>(p, integer_exp, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
