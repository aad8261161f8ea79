// Integer RMS-norm forward over DFX mantissas.
//
// Replaces the TPU kernel repro/kernels/int_norm.py::int_rmsnorm_fwd (:246,
// pallas_call :260; body _rms_fwd_kernel :231; moments _exact_moments :48):
//
//   x = hi*2^8 + lo  (balanced base-2^8 digits, |hi|, |lo| <= 128)
//   s2 = f32(sum hi^2) * 65536 + f32(sum hi*lo) * 512 + f32(sum lo^2)
//   ms = (s2 / D) * (2^exp)^2;  rstd = 1 / sqrt(ms + eps)
//   y  = ((x * 2^exp) * rstd) * gamma
//
// The three digit sums are exact int32 in any order (14 + log2 D <= 31 for
// D < 2^17); the f32 recombination is the reference's expression, in its
// order.  rstd is 1/sqrt with IEEE sqrt and division (no rsqrtf
// approximation).
//
// Bound on the H100: bytes (2 bytes in and 4 out per element for a few
// integer ops).  Design: one 256-thread block per row, a shared-memory tree
// reduction of the three int32 sums, then one coalesced pass writing y.
#include "dfx_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename InT>
__global__ void __launch_bounds__(kThreads)
rms_fwd_kernel(const InT* __restrict__ x, const int* __restrict__ exp,
               const float* __restrict__ gamma, float* __restrict__ y,
               float* __restrict__ rstd, int D, float eps) {
  __shared__ int red[3][kThreads];
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const InT* xr = x + row * D;
  int a = 0, b = 0, c = 0;
  for (int i = t; i < D; i += kThreads) {
    const int xi = xr[i];
    const int lo = ((xi + 128) & 255) - 128;
    const int hi = (xi - lo) >> 8;
    a += hi * hi;
    b += hi * lo;
    c += lo * lo;
  }
  red[0][t] = a;
  red[1][t] = b;
  red[2][t] = c;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      red[0][t] += red[0][t + s];
      red[1][t] += red[1][t + s];
      red[2][t] += red[2][t + s];
    }
    __syncthreads();
  }
  const float s2 =
      __fadd_rn(__fadd_rn(__fmul_rn((float)red[0][0], 65536.0f),
                          __fmul_rn((float)red[1][0], 512.0f)),
                (float)red[2][0]);
  const float scale = dfx::pow2f(exp[0]);
  const float ms = __fmul_rn(__fdiv_rn(s2, (float)D), __fmul_rn(scale, scale));
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, eps)));
  float* yr = y + row * D;
  for (int i = t; i < D; i += kThreads)
    yr[i] = __fmul_rn(__fmul_rn(__fmul_rn((float)xr[i], scale), rs), gamma[i]);
  if (t == 0) rstd[row] = rs;
}

}  // namespace

// xm: (R, D) int8 (in_bytes = 1) or int16 (in_bytes = 2) mantissas; exp one
// int32 in device memory; gamma (D,) f32; y (R, D) f32; rstd (R,) f32.
extern "C" int int_rmsnorm_fwd_launch(const void* xm, int in_bytes,
                                      const int* exp, const float* gamma,
                                      float* y, float* rstd, int R, int D,
                                      float eps, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return 0;
  if (in_bytes == 1)
    rms_fwd_kernel<int8_t><<<R, kThreads, 0, stream>>>(
        (const int8_t*)xm, exp, gamma, y, rstd, D, eps);
  else if (in_bytes == 2)
    rms_fwd_kernel<int16_t><<<R, kThreads, 0, stream>>>(
        (const int16_t*)xm, exp, gamma, y, rstd, D, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
