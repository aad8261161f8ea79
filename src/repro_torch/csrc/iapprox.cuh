// Integer exp, reciprocal and rsqrt in Q.14 fixed point, for the kernels'
// kept_ops="integer" bodies (int_attention.cu, int_attention_bwd.cu,
// int_norm.cu).
//
// The device form of repro_torch/core/iapprox.py (i_exp, i_recip,
// i_rsqrt), the counterpart of repro/core/iapprox.py as the TPU kernels
// call it (repro/kernels/int_attention.py::_p_exp :147, the epilogue's
// i_recip :206; repro/kernels/int_norm.py::_rstd :79).  Integer
// intermediates in int32 with arithmetic shifts; every float operation an
// explicit _rn intrinsic (no FMA contraction), the reference's order;
// powers of two exact (dfx::pow2f), where the reference's jnp.exp2 of an
// integer is exact on XLA:CPU only in about [-12, 12].  The roundings to
// an integer are half to even (as jnp.round), exact here: |x log2 e 2^14|
// <= 30 * 1.45 * 2^14 < 7.2e5 and the normalised d lies in [2^13, 2^15].
#pragma once

#include "dfx_common.cuh"

namespace iapprox {

constexpr int kF = 14;                       // fraction bits
constexpr float kExpClamp = 30.0f;
constexpr float kLog2e = 1.44269502162933349609375f;   // f32(log2 e)
constexpr float kInvSqrt2 = 0.707106769084930419921875f;  // f32(1/sqrt 2)

// 2^f on [0, 1) in Q.14, r = round(f * 2^14): a degree-3 Horner.
__device__ __forceinline__ int exp2_frac(int r) {
  int acc = 1295;
  acc = ((acc * r) >> kF) + 3672;
  acc = ((acc * r) >> kF) + 11417;
  acc = ((acc * r) >> kF) + 16381;
  return acc;
}

// exp(x) on |x| <= 30 (clamped): 2^q * 2^f, q = floor(x log2 e) by an
// arithmetic shift.  Branch-free, and its conversions on the FMA pipe
// (the attention backward runs it per score): adding 1.5 * 2^23 rounds a
// float below 2^22 in magnitude to an integer half to even, with the
// integer in the low bits, and undoes the other way; 2^(q-14) is a normal
// power, its exponent field written directly (q - 14 in [-58, 29]).
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float i_exp(float x) {
  x = fminf(fmaxf(x, -kExpClamp), kExpClamp);
  const int ti = __float_as_int(__fadd_rn(
                     __fmul_rn(__fmul_rn(x, kLog2e), (float)(1 << kF)),
                     kMagic)) -
                 kMagicBits;
  const int q = ti >> kF;
  const int acc = exp2_frac(ti - (q << kF));
  return __fmul_rn(__fsub_rn(__int_as_float(kMagicBits + acc), kMagic),
                   __int_as_float((q - kF + 127) << 23));
}

// floor(log2 y) of a positive normal float, from its exponent field.
__device__ __forceinline__ int floor_log2(float y) {
  return (__float_as_int(y) >> 23) - 127;
}

// 1/y for a positive normal float: d = y 2^-(e+1) in [0.5, 1) in Q.14, a
// linear start and three Newton steps x <- x (2 - d x).
__device__ __forceinline__ float i_recip(float y) {
  const int e = floor_log2(y);
  const int d = __float2int_rn(
      __fmul_rn(__fmul_rn(y, dfx::pow2f(-(e + 1))), (float)(1 << kF)));
  int x = 46261 - ((30840 * d) >> kF);
#pragma unroll
  for (int i = 0; i < 3; ++i) x = (x * ((2 << kF) - ((d * x) >> kF))) >> kF;
  return __fmul_rn((float)x, dfx::pow2f(-(kF + e + 1)));
}

// 1/sqrt(y) for a positive normal float: d = y 2^-e in [1, 2) in Q.14, a
// linear start and three Newton steps x <- x (3 - d x^2) / 2; 2^(-e/2) as
// an exact power of two, times f32(1/sqrt 2) where e is odd.
__device__ __forceinline__ float i_rsqrt(float y) {
  const int e = floor_log2(y);
  const int k = e >> 1;
  const int d = __float2int_rn(
      __fmul_rn(__fmul_rn(y, dfx::pow2f(-e)), (float)(1 << kF)));
  int x = 20559 - ((4658 * d) >> kF);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int t = (((d * x) >> kF) * x) >> kF;
    x = (x * ((3 << kF) - t)) >> (kF + 1);
  }
  const float r = __fmul_rn((float)x, dfx::pow2f(-(kF + k)));
  return (e - 2 * k) == 1 ? __fmul_rn(r, kInvSqrt2) : r;
}

}  // namespace iapprox
