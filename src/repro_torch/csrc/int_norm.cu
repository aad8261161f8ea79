// Integer layer-norm and RMS-norm, forward and backward, over DFX
// mantissas.
//
// Replaces the TPU kernels of repro/kernels/int_norm.py (moments
// _exact_moments :48):
//
//   int_layernorm_fwd (:113, body _ln_fwd_kernel :89)
//     s1 = sum x (exact int32); x = hi*2^8 + lo (balanced base-2^8 digits,
//     |hi|, |lo| <= 128); s2 = f32(sum hi^2) * 65536 + f32(sum hi*lo) * 512
//     + f32(sum lo^2); mu_m = f32(s1) / D; var_m = max(s2 / D - mu_m^2, 0)
//     mu = mu_m * 2^exp;  rstd = 1 / sqrt(var_m * (2^exp)^2 + eps)
//     y  = ((x * 2^exp - mu) * rstd) * gamma + beta       -> y, mu, rstd
//   int_layernorm_bwd (:181, body _ln_bwd_kernel :152)
//     xn = (x * 2^xe - mu) * rstd;  gq = g * 2^ge;  gg = gq * gamma
//     dx = rstd * ((gg - mean(gg)) - xn * mean(gg * xn))       per row
//     dgamma = sum_rows gq * xn;  dbeta = f32(sum_rows g) * 2^ge
//   int_rmsnorm_fwd (:246, body _rms_fwd_kernel :231)
//     ms = (s2 / D) * (2^exp)^2;  rstd = 1 / sqrt(ms + eps)
//     y  = ((x * 2^exp) * rstd) * gamma
//   int_rmsnorm_bwd (:298, body _rms_bwd_kernel :282)
//     xn = (x * 2^xe) * rstd;  gq = g * 2^ge;  gg = gq * gamma
//     dx = rstd * (gg - xn * mean(gg * xn))                    per row
//     dgamma = sum_rows gq * xn
//
// The digit sums and s1 are exact int32 in any order (14 + log2 D <= 31
// and (b-1) + log2 D < 31 for D < 2^16); the f32 arithmetic is the
// reference's expressions in its order, each operation rounded on its own
// (__fmul_rn / __fadd_rn, no FMA contraction).  rstd is 1/sqrt with IEEE
// sqrt and division (no rsqrtf approximation).  mu and rstd are the
// statistics the forward normalised with, saved as the backward's
// residuals, so the backward differentiates exactly the forward that ran.
//
// Bound on the H100: bytes (2 bytes in and 4 out per element for the
// forwards, 3 in and 4 out for the backwards, a few dozen operations each).
// Design: the forwards run one 256-thread block per row, a shared-memory
// tree reduction of the int32 sums, then one coalesced pass writing y.  The
// backwards' blocks run in no order, so the column sums dgamma / dbeta
// cannot be carried from block to block as the TPU grid carries them:
// each block of kLnRows rows writes its own column partials (f32 for
// dgamma, exact int32 for dbeta) and a second kernel sums them over the
// blocks in block order — no float atomics, the same result on every run.
// Within a block a first pass reduces each row's f32 sums (two for the
// layer-norm, one for the RMS-norm) in shared memory; a second,
// column-major pass (neighbouring threads on neighbouring columns) writes
// dx and accumulates the column partials in registers.  The RMS-norm
// backward is the layer-norm's with mu = 0 and without mean(gg) and dbeta.
#include "dfx_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLnRows = 16;  // rows per backward block (dgamma partials)

// Shared-memory tree sum, in a fixed order, of NS arrays of per-thread
// values: red[i][t] summed into red[i][0].
template <typename T, int NS>
__device__ __forceinline__ void block_sum(T (*red)[kThreads]) {
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
#pragma unroll
      for (int i = 0; i < NS; ++i) red[i][threadIdx.x] += red[i][threadIdx.x + s];
    __syncthreads();
  }
}

template <typename InT>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const InT* __restrict__ x, const int* __restrict__ exp,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              float* __restrict__ y, float* __restrict__ mu_out,
              float* __restrict__ rstd_out, int D, float eps) {
  __shared__ int red[4][kThreads];
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const InT* xr = x + row * D;
  int s1 = 0, a = 0, b = 0, c = 0;
  for (int i = t; i < D; i += kThreads) {
    const int xi = xr[i];
    const int lo = ((xi + 128) & 255) - 128;
    const int hi = (xi - lo) >> 8;
    s1 += xi;
    a += hi * hi;
    b += hi * lo;
    c += lo * lo;
  }
  red[0][t] = s1;
  red[1][t] = a;
  red[2][t] = b;
  red[3][t] = c;
  block_sum<int, 4>(red);
  const float s2 =
      __fadd_rn(__fadd_rn(__fmul_rn((float)red[1][0], 65536.0f),
                          __fmul_rn((float)red[2][0], 512.0f)),
                (float)red[3][0]);
  const float d = (float)D;
  const float mu_m = __fdiv_rn((float)red[0][0], d);
  const float var_m =
      fmaxf(__fsub_rn(__fdiv_rn(s2, d), __fmul_rn(mu_m, mu_m)), 0.0f);
  const float scale = dfx::pow2f(exp[0]);
  const float mu = __fmul_rn(mu_m, scale);
  const float rs = __fdiv_rn(
      1.0f, __fsqrt_rn(__fadd_rn(__fmul_rn(var_m, __fmul_rn(scale, scale)),
                                 eps)));
  float* yr = y + row * D;
  for (int i = t; i < D; i += kThreads) {
    const float xn = __fmul_rn(__fsub_rn(__fmul_rn((float)xr[i], scale), mu),
                               rs);
    yr[i] = __fadd_rn(__fmul_rn(xn, gamma[i]), beta[i]);
  }
  if (t == 0) {
    mu_out[row] = mu;
    rstd_out[row] = rs;
  }
}

// One block per kLnRows rows: dx, and this block's column partials of
// dgamma (f32) and dbeta (int32) in row nb of dg_part / db_part.
template <typename XT, typename GT>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const XT* __restrict__ x, const GT* __restrict__ g,
              const int* __restrict__ xexp, const int* __restrict__ gexp,
              const float* __restrict__ gamma, const float* __restrict__ mu,
              const float* __restrict__ rstd, float* __restrict__ dx,
              float* __restrict__ dg_part, int* __restrict__ db_part, int R,
              int D) {
  __shared__ float red[2][kThreads];
  __shared__ float mean_gg[kLnRows], mean_ggxn[kLnRows];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kLnRows;
  const int nr = min(kLnRows, R - r0);
  const float xs = dfx::pow2f(xexp[0]), gs = dfx::pow2f(gexp[0]);
  const float d = (float)D;
  for (int r = 0; r < nr; ++r) {
    const long long off = (long long)(r0 + r) * D;
    const float m = mu[r0 + r], rs = rstd[r0 + r];
    float sg = 0.0f, sgx = 0.0f;
    for (int i = t; i < D; i += kThreads) {
      const float xn = __fmul_rn(__fsub_rn(__fmul_rn((float)x[off + i], xs), m),
                                 rs);
      const float gg = __fmul_rn(__fmul_rn((float)g[off + i], gs), gamma[i]);
      sg = __fadd_rn(sg, gg);
      sgx = __fadd_rn(sgx, __fmul_rn(gg, xn));
    }
    red[0][t] = sg;
    red[1][t] = sgx;
    block_sum<float, 2>(red);
    if (t == 0) {
      mean_gg[r] = __fdiv_rn(red[0][0], d);
      mean_ggxn[r] = __fdiv_rn(red[1][0], d);
    }
    __syncthreads();
  }
  for (int i = t; i < D; i += kThreads) {
    float dg = 0.0f;
    int db = 0;
    const float gam = gamma[i];
    for (int r = 0; r < nr; ++r) {
      const long long off = (long long)(r0 + r) * D + i;
      const float rs = rstd[r0 + r];
      const float xn = __fmul_rn(
          __fsub_rn(__fmul_rn((float)x[off], xs), mu[r0 + r]), rs);
      const int gi = g[off];
      const float gq = __fmul_rn((float)gi, gs);
      const float gg = __fmul_rn(gq, gam);
      dx[off] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gg, mean_gg[r]),
                                        __fmul_rn(xn, mean_ggxn[r])));
      dg = __fadd_rn(dg, __fmul_rn(gq, xn));
      db += gi;
    }
    dg_part[(long long)blockIdx.x * D + i] = dg;
    db_part[(long long)blockIdx.x * D + i] = db;
  }
}

// One block per kLnRows rows: dx, and this block's column partials of
// dgamma in row blockIdx.x of dg_part.
template <typename XT, typename GT>
__global__ void __launch_bounds__(kThreads)
rms_bwd_kernel(const XT* __restrict__ x, const GT* __restrict__ g,
               const int* __restrict__ xexp, const int* __restrict__ gexp,
               const float* __restrict__ gamma,
               const float* __restrict__ rstd, float* __restrict__ dx,
               float* __restrict__ dg_part, int R, int D) {
  __shared__ float red[1][kThreads];
  __shared__ float mean_ggxn[kLnRows];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kLnRows;
  const int nr = min(kLnRows, R - r0);
  const float xs = dfx::pow2f(xexp[0]), gs = dfx::pow2f(gexp[0]);
  const float d = (float)D;
  for (int r = 0; r < nr; ++r) {
    const long long off = (long long)(r0 + r) * D;
    const float rs = rstd[r0 + r];
    float sgx = 0.0f;
    for (int i = t; i < D; i += kThreads) {
      const float xn = __fmul_rn(__fmul_rn((float)x[off + i], xs), rs);
      const float gg = __fmul_rn(__fmul_rn((float)g[off + i], gs), gamma[i]);
      sgx = __fadd_rn(sgx, __fmul_rn(gg, xn));
    }
    red[0][t] = sgx;
    block_sum<float, 1>(red);
    if (t == 0) mean_ggxn[r] = __fdiv_rn(red[0][0], d);
    __syncthreads();
  }
  for (int i = t; i < D; i += kThreads) {
    float dg = 0.0f;
    const float gam = gamma[i];
    for (int r = 0; r < nr; ++r) {
      const long long off = (long long)(r0 + r) * D + i;
      const float rs = rstd[r0 + r];
      const float xn = __fmul_rn(__fmul_rn((float)x[off], xs), rs);
      const float gq = __fmul_rn((float)g[off], gs);
      const float gg = __fmul_rn(gq, gam);
      dx[off] = __fmul_rn(rs, __fsub_rn(gg, __fmul_rn(xn, mean_ggxn[r])));
      dg = __fadd_rn(dg, __fmul_rn(gq, xn));
    }
    dg_part[(long long)blockIdx.x * D + i] = dg;
  }
}

// Column sums of the per-block partials, in block order (db_part null: no
// dbeta, the RMS-norm).
__global__ void __launch_bounds__(kThreads)
ln_bwd_reduce_kernel(const float* __restrict__ dg_part,
                     const int* __restrict__ db_part,
                     const int* __restrict__ gexp, float* __restrict__ dgamma,
                     float* __restrict__ dbeta, int nb, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= D) return;
  float dg = 0.0f;
  int db = 0;
  for (int b = 0; b < nb; ++b) {
    dg = __fadd_rn(dg, dg_part[(long long)b * D + i]);
    if (db_part) db += db_part[(long long)b * D + i];
  }
  dgamma[i] = dg;
  if (db_part) dbeta[i] = __fmul_rn((float)db, dfx::pow2f(gexp[0]));
}

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
  block_sum<int, 3>(red);
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

// xm: (R, D) int8 (in_bytes = 1) or int16 (2) mantissas; exp one int32 in
// device memory; gamma, beta (D,) f32; y (R, D) f32; mu, rstd (R,) f32.
extern "C" int int_layernorm_fwd_launch(const void* xm, int in_bytes,
                                        const int* exp, const float* gamma,
                                        const float* beta, float* y,
                                        float* mu, float* rstd, int R, int D,
                                        float eps, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return 0;
  if (in_bytes == 1)
    ln_fwd_kernel<int8_t><<<R, kThreads, 0, stream>>>(
        (const int8_t*)xm, exp, gamma, beta, y, mu, rstd, D, eps);
  else if (in_bytes == 2)
    ln_fwd_kernel<int16_t><<<R, kThreads, 0, stream>>>(
        (const int16_t*)xm, exp, gamma, beta, y, mu, rstd, D, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Rows per backward block: the wrapper sizes the partials (nb, D) with
// nb = ceil(R / rows).
extern "C" int int_layernorm_bwd_rows() { return kLnRows; }

// xm (R, D) and gm (R, D): int8 or int16 mantissas (x_bytes, g_bytes);
// xexp, gexp one int32 each in device memory; gamma (D,) f32; mu, rstd
// (R,) f32.  Writes dx (R, D), dgamma and dbeta (D,) f32, using dg_part
// (nb, D) f32 and db_part (nb, D) int32 as scratch.
extern "C" int int_layernorm_bwd_launch(
    const void* xm, int x_bytes, const void* gm, int g_bytes,
    const int* xexp, const int* gexp, const float* gamma, const float* mu,
    const float* rstd, float* dx, float* dgamma, float* dbeta,
    float* dg_part, int* db_part, int R, int D, cudaStream_t stream) {
  if (D <= 0) return 0;
  const int nb = (R + kLnRows - 1) / kLnRows;
  if (nb > 0) {
    // launch the instantiation for the two mantissa types (tags x, g)
    auto run = [&](auto x, auto g) {
      using X = decltype(x);
      using G = decltype(g);
      ln_bwd_kernel<X, G><<<nb, kThreads, 0, stream>>>(
          (const X*)xm, (const G*)gm, xexp, gexp, gamma, mu, rstd, dx,
          dg_part, db_part, R, D);
    };
    switch (x_bytes * 4 + g_bytes) {
      case 5: run(int8_t(), int8_t()); break;
      case 6: run(int8_t(), int16_t()); break;
      case 9: run(int16_t(), int8_t()); break;
      case 10: run(int16_t(), int16_t()); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ln_bwd_reduce_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dg_part, db_part, gexp, dgamma, dbeta, nb, D);
  return (int)cudaGetLastError();
}

// xm (R, D) and gm (R, D): int8 or int16 mantissas (x_bytes, g_bytes);
// xexp, gexp one int32 each in device memory; gamma (D,) f32; rstd (R,)
// f32.  Writes dx (R, D) and dgamma (D,) f32, using dg_part (nb, D) f32 as
// scratch (nb = ceil(R / int_layernorm_bwd_rows())).
extern "C" int int_rmsnorm_bwd_launch(
    const void* xm, int x_bytes, const void* gm, int g_bytes,
    const int* xexp, const int* gexp, const float* gamma, const float* rstd,
    float* dx, float* dgamma, float* dg_part, int R, int D,
    cudaStream_t stream) {
  if (D <= 0) return 0;
  const int nb = (R + kLnRows - 1) / kLnRows;
  if (nb > 0) {
    auto run = [&](auto x, auto g) {
      using X = decltype(x);
      using G = decltype(g);
      rms_bwd_kernel<X, G><<<nb, kThreads, 0, stream>>>(
          (const X*)xm, (const G*)gm, xexp, gexp, gamma, rstd, dx, dg_part,
          R, D);
    };
    switch (x_bytes * 4 + g_bytes) {
      case 5: run(int8_t(), int8_t()); break;
      case 6: run(int8_t(), int16_t()); break;
      case 9: run(int16_t(), int8_t()); break;
      case 10: run(int16_t(), int16_t()); break;
      default: return (int)cudaErrorInvalidValue;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ln_bwd_reduce_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dg_part, nullptr, gexp, dgamma, nullptr, nb, D);
  return (int)cudaGetLastError();
}
