// Tensor-core building blocks of the integer attention kernels
// (int_attention.cu, the forward; int_attention_bwd.cu, dq and dk + dv):
// int8 limb-plane staging, the m16n8k32 s8 MMA fragments, the ordered f32
// combine of a limb pair's exact int32 dot, and the packing of C-layout
// digits straight into A fragments.  Every f32 expression is an explicit
// _rn intrinsic (no FMA contraction) in the reference's order, so each
// kernel matches its plain PyTorch version bit for bit.
//
// Two ways to feed the MMAs:
//   staged  (the bodies for hd <= 256 whose tiles fit in 227 KB): rows
//           copied into shared memory by cp.async, fragments read with
//           ldmatrix, transposed operands written by a 4x4 byte transpose.
//           Their score dots run over at most 256 columns, so every int32
//           dot is below 256 * 127^2 = 4,129,024 < 2^22 and the int ->
//           float conversion by magic-number arithmetic (i2f, combine) is
//           exact.
//   direct  (any hd and limb count: the "direct" bodies): each lane loads
//           its fragment words straight from global memory (L1 / L2), so
//           shared memory holds only the warp's digit fragments, whatever
//           hd is.  A score dot's int32 sum is carried over all of hd and
//           converted once, by cvt.rn (__int2float_rn, round to nearest
//           like the reference's f32(int32 dot)): exact for |dot| < 2^24,
//           rounded as the reference rounds beyond.
#pragma once

#include "dfx_common.cuh"
#include "iapprox.cuh"
#include "sm90_ptx.cuh"

namespace {

constexpr int KS = 32;                      // sub-tile rows: one MMA k-step
constexpr int KSB = 4;                      // k-steps of a 128-row block
constexpr int TP = KS * KSB + 16;           // byte stride of a transposed row
constexpr int kStages = 2;                  // depth of the cp.async ring
constexpr int kMaxChunks = 8;               // hd <= 32 * kMaxChunks
constexpr int kLimbWords = KSB * 32 * 4;    // a warp's A fragments of one
                                            // limb over a block, in words
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void st32(int8_t* p, unsigned x) {
  *reinterpret_cast<unsigned*>(p) = x;
}

// Branch-free (& and |), so the element loops below stay straight-line
// code the compiler can interleave.
template <class P>
__device__ __forceinline__ bool visible(const P& p, int qpos, int kpos) {
  return (kpos < p.Sk) & (!p.causal | (kpos <= qpos)) &
         ((p.window < 0) | (kpos > qpos - p.window));
}

// The conversions between int and float go through the FMA pipe (I2F,
// F2I and FRND run at a quarter of its rate, and were this kernel's
// bottleneck): 1.5 * 2^23 + x has the float bits 0x4B400000 + x for
// |x| < 2^22, and adding 1.5 * 2^23 rounds to an integer half to even,
// as rintf does.  Exact in the staged bodies: every dot is below 127^2 *
// 256 = 4,129,024 < 2^22 (their hd contractions at most 256 deep, the
// block contractions 128; the direct bodies, whose hd contractions may be
// deeper, convert with combine_rn instead;
// every limb digit, the top limb's raw carry included, at most 127 in
// magnitude: a 12-bit mantissa's carry is at most 16, a 16-bit one's 2),
// and a mantissa is clipped to 2^15 before it is rounded.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float i2f(int x) {
  return __fsub_rn(__int_as_float(kMagicBits + x), kMagic);
}

// clip(rint(y), +-(2^(bits-1) - 1)); lim is an integer, so clipping first
// gives the same value.
__device__ __forceinline__ int round_clip(float y, int bits) {
  const float lim = (float)((1 << (bits - 1)) - 1);
  return __float_as_int(__fadd_rn(fminf(fmaxf(y, -lim), lim), kMagic)) -
         kMagicBits;
}

// This lane's ldmatrix row address, relative to a 16-row x 32-byte tile
// with rows `stride` bytes apart, for an A fragment (matrices: rows 0-7
// bytes 0-15, rows 8-15 bytes 0-15, rows 0-7 bytes 16-31, rows 8-15 bytes
// 16-31) and for the B fragments of two 8-row n-tiles (rows 0-7 bytes
// 0-15 and 16-31, then rows 8-15).
__device__ __forceinline__ int a_lane(int lane, int stride) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * stride + 16 * (lane >> 4);
}

__device__ __forceinline__ int b_lane(int lane, int stride) {
  return ((lane & 7) + 8 * (lane >> 4)) * stride + 16 * ((lane >> 3) & 1);
}

// Issue the copies of `rows` rows of hd int8 values (row r of plane j at
// src + j * plane + r * row) into shared rows of hp bytes (plane j at
// dst + j * rows * hp); rows at or past `valid` are zero-filled.
template <int V>
__device__ __forceinline__ void copy_rows(int8_t* dst, int hp,
                                          const int8_t* src, long long plane,
                                          long long row, int planes, int rows,
                                          int valid, int hd) {
  const int cpr = hd / V, nt = blockDim.x;
  const int dc = nt % cpr, dr = nt / cpr;
  int c = threadIdx.x % cpr, r = threadIdx.x / cpr, j = 0;
  while (r >= rows) {
    r -= rows;
    ++j;
  }
  while (j < planes) {
    const bool ok = r < valid;
    ptx::cp_async<V>(dst + (j * rows + r) * hp + c * V,
                     ok ? src + j * plane + r * row + c * V : src, ok);
    c += dc;
    r += dr;
    if (c >= cpr) {
      c -= cpr;
      ++r;
    }
    while (r >= rows) {
      r -= rows;
      ++j;
    }
  }
}

template <class P>
__device__ __forceinline__ void stage_rows(const P& p, int hp,
                                           int8_t* dst, const int8_t* src,
                                           long long plane, long long row,
                                           int planes, int rows, int valid) {
  switch (p.vec) {
    case 16:
      copy_rows<16>(dst, hp, src, plane, row, planes, rows, valid, p.hd);
      break;
    case 8:
      copy_rows<8>(dst, hp, src, plane, row, planes, rows, valid, p.hd);
      break;
    case 4:
      copy_rows<4>(dst, hp, src, plane, row, planes, rows, valid, p.hd);
      break;
    default:  // hd or a base pointer not 4-byte aligned: synchronous bytes
      for (int e = threadIdx.x; e < planes * rows * p.hd; e += blockDim.x) {
        const int c = e % p.hd, r = (e / p.hd) % rows, j = e / (p.hd * rows);
        dst[(j * rows + r) * hp + c] =
            r < valid ? src[j * plane + r * row + c] : 0;
      }
  }
}

// Zero bytes hd..hdp-1 of n staged rows (the copies never write them).
__device__ __forceinline__ void zero_pad(int8_t* rows, int n, int hp,
                                         int hd, int hdp) {
  const int w = hdp - hd;
  for (int e = threadIdx.x; e < n * w; e += blockDim.x)
    rows[(e / w) * hp + hd + e % w] = 0;
}

// Transpose a staged 32-row sub-tile of `planes` planes (plane j at
// src + j * 32 * HP) into transposed rows (plane j, column d at
// tr + (j * HDP + d) * TP), at bytes ks * 32 + kpos(r) for sub-tile row r,
// where kpos(16h + 8a + 2t + b) = 16h + 4t + 2a + b: the k order in which
// a thread's C-layout columns 8j + 2t + b form its A fragment (pack4).
// Each unit reads one word of rows 16h+2t, +1, +8, +9 and writes the 4x4
// byte transpose as one word to each of 4 transposed rows.
template <int HDP>
__device__ __forceinline__ void transpose_tile(int8_t* tr, const int8_t* src,
                                               int planes, int ks) {
  constexpr int HP = HDP + 16, W = HDP / 4;
  for (int u = threadIdx.x; u < planes * W * 8; u += blockDim.x) {
    const int grp = u & 7, w = (u >> 3) % W, j = (u >> 3) / W;
    const int h = grp >> 2, t = grp & 3;
    const int8_t* s = src + (j * KS + 16 * h + 2 * t) * HP + 4 * w;
    const unsigned r0 = ld32(s), r1 = ld32(s + HP), r2 = ld32(s + 8 * HP),
                   r3 = ld32(s + 9 * HP);
    const unsigned t0 = __byte_perm(r0, r1, 0x5140),
                   t1 = __byte_perm(r0, r1, 0x7362),
                   t2 = __byte_perm(r2, r3, 0x5140),
                   t3 = __byte_perm(r2, r3, 0x7362);
    int8_t* d = tr + (j * HDP + 4 * w) * TP + ks * KS + 16 * h + 4 * t;
    st32(d, __byte_perm(t0, t2, 0x5410));
    st32(d + TP, __byte_perm(t0, t2, 0x7632));
    st32(d + 2 * TP, __byte_perm(t1, t3, 0x5410));
    st32(d + 3 * TP, __byte_perm(t1, t3, 0x7632));
  }
}

// The combine of a pair's dots: out (+)= (f32(c) * s0) * w, s0 = 2^e and
// w = 2^(7n + shift).  Where every scale 2^e and 2^(e + 7n + shift) (n <= 4
// for at most 3 limbs a side) is a normal power of two with room for
// |c| < 2^22, both products are exact and equal c * (s0 * w), which one
// fma yields exactly from the magic-number bits: fma(1.5 * 2^23 + c, sw,
// -1.5 * 2^23 * sw) = c * sw before its single rounding.  `fast` says so
// (fma_exact); else the two rounded products are taken as written.
__device__ __forceinline__ bool fma_exact(int e, int shift) {
  return e >= -120 && e + shift >= -120 && e + 28 + max(shift, 0) <= 100;
}

__device__ __forceinline__ void combine(float (&out)[4][4],
                                        const int (&c)[4][4], float s0,
                                        float w, bool first, bool fast) {
  if (fast) {
    const float sw = __fmul_rn(s0, w), nm = __fmul_rn(-kMagic, sw);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float part =
            __fmaf_rn(__int_as_float(kMagicBits + c[j][e]), sw, nm);
        out[j][e] = first ? part : __fadd_rn(out[j][e], part);
      }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float part = __fmul_rn(__fmul_rn(i2f(c[j][e]), s0), w);
      out[j][e] = first ? part : __fadd_rn(out[j][e], part);
    }
}

// c[j] += A . B over 32 k for the four n-tiles j of a 16 x 32 tile: A's
// fragment af, B's 32 rows at b (ldmatrix lane address, rows `stride`
// bytes apart).
__device__ __forceinline__ void mma_row(int (&c)[4][4], const unsigned (&af)[4],
                                        const int8_t* b, int stride) {
  unsigned b01[4], b23[4];
  ptx::ldmatrix_x4(b01, b);
  ptx::ldmatrix_x4(b23, b + 16 * stride);
  ptx::mma_s8(c[0], af, b01[0], b01[1]);
  ptx::mma_s8(c[1], af, b01[2], b01[3]);
  ptx::mma_s8(c[2], af, b23[0], b23[1]);
  ptx::mma_s8(c[3], af, b23[2], b23[3]);
}

// 16 x 32 scores in C layout (out[j][e]: row g + 8(e/2), column
// 8j + 2t + e%2): the ordered limb-pair sum of (f32(dot) * s0) *
// 2^(7(jo+ji)) over the HDP columns of 16 A rows (la planes a_plane bytes
// apart; a at this lane's a_lane address) and 32 B rows (lb planes; b at
// its b_lane address), rows HDP + 16 bytes apart.  AOuter: the A
// operand's limbs are the outer loop of the pair order, else B's.
template <int NDC, bool AOuter>
__device__ __forceinline__ void pair_scores(float (&out)[4][4],
                                            const int8_t* a, int la,
                                            int a_plane, const int8_t* b,
                                            int lb, int b_plane, float s0,
                                            bool fast) {
  constexpr int HP = KS * NDC + 16;
  const int no = AOuter ? la : lb, ni = AOuter ? lb : la;
  for (int jo = 0; jo < no; ++jo)
    for (int ji = 0; ji < ni; ++ji) {
      const int8_t* ap = a + (AOuter ? jo : ji) * a_plane;
      const int8_t* bp = b + (AOuter ? ji : jo) * b_plane;
      int c[4][4] = {};
#pragma unroll
      for (int kc = 0; kc < NDC; ++kc) {
        unsigned af[4];
        ptx::ldmatrix_x4(af, ap + kc * KS);
        mma_row(c, af, bp + kc * KS, HP);
      }
      combine(out, c, s0, dfx::pow2f(dfx::kLimbBits * (jo + ji)),
              jo == 0 && ji == 0, fast);
    }
}

// The low bytes of x0..x3 as one word, x0 lowest.
__device__ __forceinline__ unsigned pack4(int x0, int x1, int x2, int x3) {
  return __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040),
                     0x5410);
}

// Split C-layout mantissas m into n limb digits (dfx::split_limbs) and
// store each limb's A fragment (k order kpos) at k-step ks of the warp's
// fragments fa ([limb][KSB][32 lanes] x 16 bytes; each lane its own).
__device__ __forceinline__ void store_limbs(uint4* fa, int (&m)[4][4], int n,
                                            int ks, int lane) {
  for (int l = 0; l < n; ++l) {
    int d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (l < n - 1) {
          const int carry = (m[j][e] + 64) >> dfx::kLimbBits;
          d[j][e] = m[j][e] - carry * (1 << dfx::kLimbBits);
          m[j][e] = carry;
        } else {
          d[j][e] = m[j][e];
        }
      }
    fa[(l * KSB + ks) * 32 + lane] =
        make_uint4(pack4(d[0][0], d[0][1], d[1][0], d[1][1]),
                   pack4(d[0][2], d[0][3], d[1][2], d[1][3]),
                   pack4(d[2][0], d[2][1], d[3][0], d[3][1]),
                   pack4(d[2][2], d[2][3], d[3][2], d[3][3]));
  }
}

// A block's partial of output columns 32dc..32dc+31 (16 x 32, C layout):
// the ordered limb-pair sum (A limbs outer: the warp's fragments fa; B
// limbs inner: transposed rows tr, at this lane's b_lane address) of
// (f32(dot) * s0) * 2^(7(ja+jb) + shift), each dot an int32 sum over the
// block's k-steps in `live`.
template <int NDC>
__device__ __forceinline__ void block_partial(float (&out)[4][4],
                                              const uint4* fa, int la,
                                              const int8_t* tr, int lb,
                                              int dc, unsigned live, float s0,
                                              int shift, bool fast, int lane) {
  for (int ja = 0; ja < la; ++ja)
    for (int jb = 0; jb < lb; ++jb) {
      const int8_t* bp = tr + (jb * KS * NDC + dc * KS) * TP;
      int c[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSB; ++ks) {
        if (!(live >> ks & 1)) continue;
        const uint4 f = fa[(ja * KSB + ks) * 32 + lane];
        const unsigned af[4] = {f.x, f.y, f.z, f.w};
        mma_row(c, af, bp + ks * KS, TP);
      }
      combine(out, c, s0, dfx::pow2f(dfx::kLimbBits * (ja + jb) + shift),
              ja == 0 && jb == 0, fast);
    }
}

// A lane's f32 sums over 16 rows x 32 NDC columns (C layout), in registers
// or in the warp's shared memory ([NDC][4][32 lanes][4]).
template <int NDC, bool InRegs>
struct Sums;

template <int NDC>
struct Sums<NDC, true> {
  float v[NDC][4][4];
  __device__ __forceinline__ Sums(float*, int) {
#pragma unroll
    for (int dc = 0; dc < NDC; ++dc)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[dc][j][e] = 0.0f;
  }
  __device__ __forceinline__ void add(int dc, const float (&part)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[dc][j][e] = __fadd_rn(v[dc][j][e], part[j][e]);
  }
  // v = v * a[row] + part (the forward's acc * alpha + pv), row = e / 2
  __device__ __forceinline__ void scale_add(int dc, const float (&a)[2],
                                            const float (&part)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[dc][j][e] =
            __fadd_rn(__fmul_rn(v[dc][j][e], a[e >> 1]), part[j][e]);
  }
  __device__ __forceinline__ float get(int dc, int j, int e) const {
    return v[dc][j][e];
  }
};

template <int NDC>
struct Sums<NDC, false> {
  float4* s;
  __device__ __forceinline__ Sums(float* base, int lane)
      : s(reinterpret_cast<float4*>(base) + lane) {
    for (int i = 0; i < NDC * 4; ++i) s[i * 32] = make_float4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void add(int dc, const float (&part)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 x = s[(dc * 4 + j) * 32];
      x.x = __fadd_rn(x.x, part[j][0]);
      x.y = __fadd_rn(x.y, part[j][1]);
      x.z = __fadd_rn(x.z, part[j][2]);
      x.w = __fadd_rn(x.w, part[j][3]);
      s[(dc * 4 + j) * 32] = x;
    }
  }
  __device__ __forceinline__ void scale_add(int dc, const float (&a)[2],
                                            const float (&part)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 x = s[(dc * 4 + j) * 32];
      x.x = __fadd_rn(__fmul_rn(x.x, a[0]), part[j][0]);
      x.y = __fadd_rn(__fmul_rn(x.y, a[0]), part[j][1]);
      x.z = __fadd_rn(__fmul_rn(x.z, a[1]), part[j][2]);
      x.w = __fadd_rn(__fmul_rn(x.w, a[1]), part[j][3]);
      s[(dc * 4 + j) * 32] = x;
    }
  }
  __device__ __forceinline__ float get(int dc, int j, int e) const {
    const float4 x = s[(dc * 4 + j) * 32];
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
  }
};

// Store columns d and d+1 of a row (at o) where they lie inside hd: one
// 8-byte store for an even hd (d is even).
__device__ __forceinline__ void store_pair(float* o, float x0, float x1,
                                           bool row_ok, int d, int hd) {
  if (!row_ok || d >= hd) return;
  if (hd % 2 == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
  } else {
    o[0] = x0;
    if (d + 1 < hd) o[1] = x1;
  }
}

// p's exp: FP32 (expf, not __expf), or the Q.14 form.
template <bool IntExp>
__device__ __forceinline__ float p_exp(float x) {
  if constexpr (IntExp) return iapprox::i_exp(x);
  return expf(x);
}

// ------------------------------------------------------------ direct ----

// Bytes k..k+3 of a row of hd int8 values as one word: zero past hd, and
// everywhere when !ok (the row is then not read).  vec: the row is 4-byte
// aligned and hd % 4 == 0.
__device__ __forceinline__ unsigned row_word(const int8_t* row, int k, int hd,
                                             bool ok, bool vec) {
  if (!ok || k >= hd) return 0u;
  if (vec) return ld32(row + k);
  unsigned w = 0;
  for (int i = 0; i < 4 && k + i < hd; ++i)
    w |= (unsigned)(uint8_t)row[k + i] << (8 * i);
  return w;
}

// A pair's combine with the exact conversion: out (+)= (f32(c) * s0) * w,
// f32(c) rounded to nearest as the reference's f32(int32 dot).
__device__ __forceinline__ void combine_rn(float (&out)[4][4],
                                           const int (&c)[4][4], float s0,
                                           float w, bool first) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float part = __fmul_rn(__fmul_rn(__int2float_rn(c[j][e]), s0), w);
      out[j][e] = first ? part : __fadd_rn(out[j][e], part);
    }
}

// 16 x 32 scores in C layout, as pair_scores, from fragments loaded
// straight from global memory: A rows g and g+8 at a0 / a1 (plane j at
// + j * a_plane), B rows (n-tile j's row g) at bn[j] (+ j * b_plane); each
// pair's dot one int32 sum over all hd columns, converted once.
template <bool AOuter>
__device__ __forceinline__ void direct_scores(
    float (&out)[4][4], const int8_t* a0, const int8_t* a1, bool aok0,
    bool aok1, long long a_plane, int la, const int8_t* const (&bn)[4],
    const bool (&bok)[4], long long b_plane, int lb, int hd, bool vec,
    float s0, int lane) {
  const int t4 = 4 * (lane & 3);
  const int no = AOuter ? la : lb, ni = AOuter ? lb : la;
  for (int jo = 0; jo < no; ++jo)
    for (int ji = 0; ji < ni; ++ji) {
      const long long oa = (AOuter ? jo : ji) * a_plane;
      const long long ob = (AOuter ? ji : jo) * b_plane;
      int c[4][4] = {};
      for (int k0 = 0; k0 < hd; k0 += KS) {
        const unsigned af[4] = {row_word(a0 + oa, k0 + t4, hd, aok0, vec),
                                row_word(a1 + oa, k0 + t4, hd, aok1, vec),
                                row_word(a0 + oa, k0 + 16 + t4, hd, aok0, vec),
                                row_word(a1 + oa, k0 + 16 + t4, hd, aok1, vec)};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ptx::mma_s8(c[j], af, row_word(bn[j] + ob, k0 + t4, hd, bok[j], vec),
                      row_word(bn[j] + ob, k0 + 16 + t4, hd, bok[j], vec));
      }
      combine_rn(out, c, s0, dfx::pow2f(dfx::kLimbBits * (jo + ji)),
                 jo == 0 && ji == 0);
    }
}

// A block's partial of output columns d0..d0+31 (16 x 32, C layout), as
// block_partial, with B^T read straight from global memory: A limbs outer
// (the warp's fragments fa), B limbs inner; row r (0..31) of k-step ks of
// the transposed operand at row_at(ks, r) + jb * b_plane (null past the
// edge), column d of it for output column d.  The fragment's k order is
// kpos's: b0 holds rows 2t, 2t+1, 8+2t, 9+2t and b1 rows 16+2t, 17+2t,
// 24+2t, 25+2t, the columns a lane's C-layout digits came from.
template <class RowAt>
__device__ __forceinline__ void direct_partial(
    float (&out)[4][4], const uint4* fa, int la, long long b_plane, int lb,
    int d0, int hd, unsigned live, RowAt row_at, float s0, int shift,
    int lane) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int rsel[8] = {t2, t2 + 1, 8 + t2, 9 + t2,
                       16 + t2, 17 + t2, 24 + t2, 25 + t2};
  for (int ja = 0; ja < la; ++ja)
    for (int jb = 0; jb < lb; ++jb) {
      int c[4][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSB; ++ks) {
        if (!(live >> ks & 1)) continue;
        const uint4 f = fa[(ja * KSB + ks) * 32 + lane];
        const unsigned af[4] = {f.x, f.y, f.z, f.w};
        const int8_t* rows[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int8_t* r = row_at(ks, rsel[i]);
          rows[i] = r ? r + jb * b_plane : nullptr;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + 8 * j + g;
          unsigned w[2] = {0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (rows[i] && d < hd)
              w[i >> 2] |= (unsigned)(uint8_t)rows[i][d] << (8 * (i & 3));
          ptx::mma_s8(c[j], af, w[0], w[1]);
        }
      }
      combine_rn(out, c, s0, dfx::pow2f(dfx::kLimbBits * (ja + jb) + shift),
                 ja == 0 && jb == 0);
    }
}

// Columns d and d + 1 of a row at o (x points at column d), where they lie
// inside hd: x[e] = f(e, x[e]).  The direct bodies keep their f32 sums in
// the output itself, each element read and written by one lane only.
template <class F>
__device__ __forceinline__ void update_pair(float* x, bool row_ok, int d,
                                            int hd, F f) {
  if (!row_ok) return;
  for (int e = 0; e < 2; ++e)
    if (d + e < hd) x[e] = f(e, x[e]);
}

}  // namespace
