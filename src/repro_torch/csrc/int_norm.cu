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
//     (kept_ops="integer", the reference's _rstd :79: rstd = i_rsqrt(...)
//     in Q.14, iapprox.cuh; template flag IntRsqrt, the same launch)
//     y  = ((x * 2^exp - mu) * rstd) * gamma + beta       -> y, mu, rstd
//   int_layernorm_bwd (:181, body _ln_bwd_kernel :152)
//     xn = (x * 2^xe - mu) * rstd;  gq = g * 2^ge;  gg = gq * gamma
//     dx = rstd * ((gg - mean(gg)) - xn * mean(gg * xn))       per row
//     dgamma = sum_rows gq * xn;  dbeta = f32(sum_rows g) * 2^ge
//   int_rmsnorm_fwd (:246, body _rms_fwd_kernel :231)
//     ms = (s2 / D) * (2^exp)^2;  rstd = 1 / sqrt(ms + eps)  (or i_rsqrt)
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
// Bound on the H100: bytes.  The forwards move 2 bytes in and 4 out per
// element, the backwards 3 in (int16 x, int8 g) and 4 out (dx), against a
// few dozen operations each.
//
// The forwards (norm_fwd_cached below; the RMS-norm is the layer-norm
// without s1, mu and beta) are one launch each, with no column sums:
//   - A group of WR = 1, 2, 4 or 8 warps per row (the fewest whose 512
//     columns each cover D), each lane holding 4 units of 4 columns,
//     loaded once with 8-byte (int16) or 4-byte (int8) loads and kept in
//     registers from the row sums to the y pass: x is read from device
//     memory once, y written once, a unit's 4 values in one float4 store,
//     so that each load and each store instruction of a warp covers one
//     contiguous span (8-column units, whose two float4 stores 32 bytes
//     apart half-fill each store's sectors, ran slower).  gamma and beta
//     are loaded by float4 for the lane's columns once and held across
//     the group's rows.  Mantissas become exact floats by the 2^23 magic
//     number, as in the backwards.
//   - The grid holds about 16 resident warps a SM (the host's plan,
//     kernels/int_norm.py::fwd_blocks) and the groups stride over the
//     rows, each loading its next row while the current one is reduced
//     and stored (one block per group of rows, without that overlap, runs
//     slower: tools/norm_fwd_grid.py).
//   - The int32 sums (s1 and the three digit sums): a warp's by
//     __reduce_add_sync, a group's by adding its warps' sums in shared
//     memory after a named barrier of the group's warps (double-buffered,
//     one barrier a row).  They are exact, so mu, rstd and y are bit for
//     bit those of the any-shape body and the plain version.
//   - ln_fwd_kernel / rms_fwd_kernel take every other shape (D % 8 != 0,
//     a base not aligned for the unit loads, D > 4096): one 256-thread
//     block per row, a shared-memory tree of the sums, scalar loads, x
//     read twice.
//
// The backwards (norm_bwd_cached / norm_bwd_rows below; the RMS-norm is
// the layer-norm with mu = 0 and without mean(gg) and dbeta) are one
// cooperative launch each.  The TPU grid carries the column sums dgamma /
// dbeta from step to step; here the blocks run in no order, so each block
// keeps its own column partials and, after a grid barrier, the blocks sum
// the partials of all blocks in a fixed order: no float atomics, the same
// bits on every run, no second launch.
//   - A warp per row (a group of WR = 1, 2, 4 or 8 warps for D > 512:
//     the register budget is 2 units of 8 columns a lane, so 512 columns
//     a warp).  Each lane loads its units once with 16-byte (int16) or
//     8-byte (int8) loads and keeps xn and gg of its 16 columns in
//     registers from the row sums to the dx pass: x and g are read from
//     device memory once, dx written once.  The group's next row is loaded
//     as soon as the current row's units are consumed, so its loads are in
//     flight during the row sums, the barrier and the dx stores.
//     Mantissas become exact floats by the 2^23 magic-number trick (a
//     __byte_perm and an add), not by I2F, whose quarter-rate pipe would
//     rival the memory time.
//   - Row sums: a warp's by an xor butterfly of shuffles, a group's by
//     adding its warps' sums in warp order after a named barrier of the
//     group's warps (double-buffered, one barrier a row); no
//     __syncthreads on the row path.
//   - Column partials: each lane keeps its columns' dgamma (f32) and
//     dbeta (int32) partials in registers over the group's rows; at the
//     end the block adds its groups in group order through shared memory
//     and writes one partial row.
//   - The grid is the co-resident block count (occupancy x SMs, at most
//     the rows need), launched cooperatively; the grid barrier is
//     cooperative_groups' own, on the word the cooperative launch
//     provides and flips back itself (no counter of ours, no memset).
//     After it, block b sums column slices b, b + nb, ... of 8 columns
//     over the nb partial rows: thread t adds rows t / 8, t / 8 + 32, ...
//     in order, then the 32 sums of a column are added in a fixed tree
//     (shuffles within a warp, then the warps in order).
//   - norm_bwd_rows takes every other shape (D % 8 != 0, a base not
//     aligned for the unit loads, D > 4096): one block per row at a time,
//     scalar loads, x and g read twice, its partial row accumulated in
//     place in device memory (each column by one thread).
#include "dfx_common.cuh"
#include "iapprox.cuh"

#include <cooperative_groups.h>

#include <type_traits>

namespace {

// rstd = 1 / sqrt(ms + eps) with IEEE sqrt and division, or the Q.14
// Newton form.
template <bool IntRsqrt>
__device__ __forceinline__ float rstd_of(float ms, float eps) {
  const float y = __fadd_rn(ms, eps);
  if constexpr (IntRsqrt) return iapprox::i_rsqrt(y);
  return __fdiv_rn(1.0f, __fsqrt_rn(y));
}

constexpr int kWarps = 8;                     // warps per block, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 8;                       // columns per unit
constexpr int kUnits = 2;                     // units per lane (registers)
constexpr int kWarpCols = 32 * kUnits * kVec; // 512 columns per warp
// The forwards' unit: 4 columns, so that a warp's loads of a unit and its
// float4 stores of y are each one contiguous span (4 units a lane, the
// same 512 columns a warp)
constexpr int kFVec = 4;
constexpr int kFUnits = kWarpCols / (32 * kFVec);

// A unit: 8 mantissas of type T, loaded in one 8- or 16-byte load (Raw4,
// bits4: the forwards' unit of 4).  bits()
// is the float bit pattern of 2^23 + (m + 2^(b-1)) for mantissa e (the
// sign bit flipped makes m + 2^(b-1) >= 0, __byte_perm puts it under the
// exponent of 2^23); subtracting kBias in f32 gives m exactly, and
// bits - kBits the integer m.
template <typename T>
struct Mant;

template <>
struct Mant<int8_t> {
  using Raw = uint2;
  using Raw4 = uint32_t;  // the forwards' 4-column unit
  static constexpr float kBias = 8388736.0f;  // 2^23 + 2^7
  static constexpr int kBits = 0x4B000080;
  static __device__ __forceinline__ uint32_t bits(const Raw& r, int e) {
    const uint32_t w = (e < 4 ? r.x : r.y) ^ 0x80808080u;
    return __byte_perm(w, 0x4B000000u, 0x7650 | (e & 3));
  }
  static __device__ __forceinline__ uint32_t bits4(Raw4 r, int e) {
    return __byte_perm(r ^ 0x80808080u, 0x4B000000u, 0x7650 | e);
  }
};

template <>
struct Mant<int16_t> {
  using Raw = uint4;
  using Raw4 = uint2;
  static constexpr float kBias = 8421376.0f;  // 2^23 + 2^15
  static constexpr int kBits = 0x4B008000;
  static __device__ __forceinline__ uint32_t bits(const Raw& r, int e) {
    const uint32_t v = e < 2 ? r.x : e < 4 ? r.y : e < 6 ? r.z : r.w;
    return __byte_perm(v ^ 0x80008000u, 0x4B000000u,
                       (e & 1) ? 0x7632 : 0x7610);
  }
  static __device__ __forceinline__ uint32_t bits4(const Raw4& r, int e) {
    return __byte_perm((e < 2 ? r.x : r.y) ^ 0x80008000u, 0x4B000000u,
                       (e & 1) ? 0x7632 : 0x7610);
  }
};

template <typename T>
__device__ __forceinline__ float mant_value(uint32_t bits) {
  return __fsub_rn(__int_as_float((int)bits), Mant<T>::kBias);
}

// Butterfly sum over the warp: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

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

template <typename InT, bool IntRsqrt>
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
  const float rs =
      rstd_of<IntRsqrt>(__fmul_rn(var_m, __fmul_rn(scale, scale)), eps);
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

template <typename InT, bool IntRsqrt>
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
  const float rs = rstd_of<IntRsqrt>(ms, eps);
  float* yr = y + row * D;
  for (int i = t; i < D; i += kThreads)
    yr[i] = __fmul_rn(__fmul_rn(__fmul_rn((float)xr[i], scale), rs), gamma[i]);
  if (t == 0) rstd[row] = rs;
}

// The register path's arguments.  beta and mu are null for the RMS-norm.
// wr: warps per row.
struct NormFwdArgs {
  const void* x;
  const int* exp;
  const float* gamma;
  const float* beta;
  float* y;
  float* mu;
  float* rstd;
  int R, D, wr;
  float eps;
};

// D % 8 == 0, D <= wr * 512, x aligned to its unit, gamma, beta and y to
// 16 bytes.  A block holds gpb = blockDim.x / (32 wr) groups of wr warps;
// group grp of block b takes rows b * gpb + grp + j * gridDim.x * gpb, and
// warp q of the group holds units (q * kFUnits + k) * 32 + lane, k <
// kFUnits, of each (columns 4 u .. 4 u + 3 of unit u).
template <typename T, bool kLN, bool IntRsqrt>
__global__ void __launch_bounds__(kThreads)
norm_fwd_cached(NormFwdArgs a) {
  using M = Mant<T>;
  __shared__ int red[2][kWarps][4];  // the group sums' double buffer
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = a.wr, gpb = (blockDim.x >> 5) / wr;
  const int q = warp % wr, grp = warp / wr;
  const int D = a.D, nu = D / kFVec;
  const long long groups = (long long)gridDim.x * gpb;
  const float scale = dfx::pow2f(a.exp[0]), d = (float)D;
  typename M::Raw4 xv[kFUnits];
  const auto load = [&](long long r) {
    const auto* xr = reinterpret_cast<const typename M::Raw4*>(
        static_cast<const T*>(a.x) + r * D);
#pragma unroll
    for (int k = 0; k < kFUnits; ++k) {
      const int u = (q * kFUnits + k) * 32 + lane;
      if (u < nu) xv[k] = xr[u];
    }
  };
  long long r = (long long)blockIdx.x * gpb + grp;
  if (r < a.R) load(r);
  float4 gam[kFUnits], bet[kFUnits];
  const float4* g4 = reinterpret_cast<const float4*>(a.gamma);
  const float4* b4 = reinterpret_cast<const float4*>(a.beta);
#pragma unroll
  for (int k = 0; k < kFUnits; ++k) {
    const int u = (q * kFUnits + k) * 32 + lane;
    if (u < nu) {
      gam[k] = g4[u];
      if constexpr (kLN) bet[k] = b4[u];
    }
  }
  int parity = 0;
  for (; r < a.R; r += groups) {
    // the digit sums (and s1) of the lane's columns, and x * 2^exp
    int s1 = 0, sa = 0, sb = 0, sc = 0;
    float xs[kFUnits][kFVec];
#pragma unroll
    for (int k = 0; k < kFUnits; ++k) {
      const int u = (q * kFUnits + k) * 32 + lane;
      if (u < nu) {
#pragma unroll
        for (int e = 0; e < kFVec; ++e) {
          const uint32_t bits = M::bits4(xv[k], e);
          const int m = (int)bits - M::kBits;
          if constexpr (sizeof(T) == 1) {
            sc += m * m;  // |m| <= 128: hi = 0, lo = m
          } else {
            const int lo = ((m + 128) & 255) - 128;
            const int hi = (m - lo) >> 8;
            sa += hi * hi;
            sb += hi * lo;
            sc += lo * lo;
          }
          if constexpr (kLN) s1 += m;
          xs[k][e] = __fmul_rn(mant_value<T>(bits), scale);
        }
      }
    }
    if (r + groups < a.R) load(r + groups);
    if constexpr (kLN) s1 = __reduce_add_sync(0xffffffffu, s1);
    if constexpr (sizeof(T) == 2) {
      sa = __reduce_add_sync(0xffffffffu, sa);
      sb = __reduce_add_sync(0xffffffffu, sb);
    }
    sc = __reduce_add_sync(0xffffffffu, sc);
    if (wr > 1) {
      int* rb = red[parity][0];
      if (lane == 0) {
        rb[warp * 4] = s1;
        rb[warp * 4 + 1] = sa;
        rb[warp * 4 + 2] = sb;
        rb[warp * 4 + 3] = sc;
      }
      named_barrier(1 + grp, wr * 32);
      const int* gs = rb + grp * wr * 4;
      s1 = gs[0];
      sa = gs[1];
      sb = gs[2];
      sc = gs[3];
      for (int j = 1; j < wr; ++j) {
        s1 += gs[j * 4];
        sa += gs[j * 4 + 1];
        sb += gs[j * 4 + 2];
        sc += gs[j * 4 + 3];
      }
      parity ^= 1;
    }
    // the statistics, in the any-shape body's expressions and order
    const float s2 = __fadd_rn(__fadd_rn(__fmul_rn((float)sa, 65536.0f),
                                         __fmul_rn((float)sb, 512.0f)),
                               (float)sc);
    float m = 0.0f, rs;
    if constexpr (kLN) {
      const float mu_m = __fdiv_rn((float)s1, d);
      const float var_m =
          fmaxf(__fsub_rn(__fdiv_rn(s2, d), __fmul_rn(mu_m, mu_m)), 0.0f);
      m = __fmul_rn(mu_m, scale);
      rs = rstd_of<IntRsqrt>(__fmul_rn(var_m, __fmul_rn(scale, scale)),
                             a.eps);
    } else {
      rs = rstd_of<IntRsqrt>(
          __fmul_rn(__fdiv_rn(s2, d), __fmul_rn(scale, scale)), a.eps);
    }
    float4* yr = reinterpret_cast<float4*>(a.y + r * D);
#pragma unroll
    for (int k = 0; k < kFUnits; ++k) {
      const int u = (q * kFUnits + k) * 32 + lane;
      if (u < nu) {
        const float g[kFVec] = {gam[k].x, gam[k].y, gam[k].z, gam[k].w};
        float o[kFVec];
#pragma unroll
        for (int e = 0; e < kFVec; ++e)
          o[e] = __fmul_rn(kLN ? __fmul_rn(__fsub_rn(xs[k][e], m), rs)
                               : __fmul_rn(xs[k][e], rs),
                           g[e]);
        if constexpr (kLN) {
          o[0] = __fadd_rn(o[0], bet[k].x);
          o[1] = __fadd_rn(o[1], bet[k].y);
          o[2] = __fadd_rn(o[2], bet[k].z);
          o[3] = __fadd_rn(o[3], bet[k].w);
        }
        yr[u] = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    if (q == 0 && lane == 0) {
      if constexpr (kLN) a.mu[r] = m;
      a.rstd[r] = rs;
    }
  }
}

// Launch the forward for the mantissa type (in_bytes 1 or 2) and the
// rsqrt body (tags x, r).
template <typename Run>
int run_fwd(int in_bytes, int integer_rsqrt, Run run) {
  switch (in_bytes * 2 + (integer_rsqrt != 0)) {
    case 2: run(int8_t(), std::false_type()); break;
    case 3: run(int8_t(), std::true_type()); break;
    case 4: run(int16_t(), std::false_type()); break;
    case 5: run(int16_t(), std::true_type()); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One launch of the register path: nb blocks of gpb groups of a.wr warps.
int norm_fwd_launch(const NormFwdArgs& a, int in_bytes, int integer_rsqrt,
                    bool ln, int gpb, int nb, cudaStream_t stream) {
  const auto off = [](const void* p, int align) {
    return reinterpret_cast<uintptr_t>(p) % align;
  };
  if ((a.wr != 1 && a.wr != 2 && a.wr != 4 && a.wr != 8) ||
      a.D % kVec != 0 || a.D > a.wr * kWarpCols || gpb < 1 ||
      gpb * a.wr > kWarps || nb < 1 || off(a.x, kFVec * in_bytes) ||
      off(a.gamma, 16) || (ln && off(a.beta, 16)) || off(a.y, 16))
    return (int)cudaErrorInvalidValue;
  return run_fwd(in_bytes, integer_rsqrt, [&](auto x, auto r) {
    using X = decltype(x);
    constexpr bool kInt = decltype(r)::value;
    const dim3 block(32 * a.wr * gpb);
    if (ln)
      norm_fwd_cached<X, true, kInt><<<nb, block, 0, stream>>>(a);
    else
      norm_fwd_cached<X, false, kInt><<<nb, block, 0, stream>>>(a);
  });
}

// ---- backward ----

constexpr int kSlice = 8;                     // columns per final slice
constexpr int kSliceGroups = kThreads / kSlice;

// The backward's arguments (one struct: one pointer for the cooperative
// launch).  mu, dbeta and db_part are null for the RMS-norm.  wr: warps
// per row of norm_bwd_cached (0 for norm_bwd_rows).  dg_part / db_part:
// (gridDim.x, D) partial rows.
struct NormBwdArgs {
  const void* x;
  const void* g;
  const int* xexp;
  const int* gexp;
  const float* gamma;
  const float* mu;
  const float* rstd;
  float* dx;
  float* dgamma;
  float* dbeta;
  float* dg_part;
  int* db_part;
  int R, D, wr;
};

using BwdKernel = void (*)(NormBwdArgs);

// After the grid barrier: dgamma (and dbeta) from the gridDim.x partial
// rows.  Block b takes column slices b, b + nb, ... of kSlice columns;
// thread t adds partial rows t / kSlice, t / kSlice + kSliceGroups, ...
// in order; the kSliceGroups sums of a column are then added by an xor
// butterfly over the 4 groups of a warp (lanes e, e ^ 8, e ^ 16, e ^ 24)
// and the 8 warps' sums in warp order.  red: 2 * kWarps * kSlice
// words of shared memory.
template <bool kLN>
__device__ __forceinline__ void bwd_column_sums(const NormBwdArgs& a,
                                                float* red) {
  int* redb = reinterpret_cast<int*>(red + kWarps * kSlice);
  const int t = threadIdx.x, e = t % kSlice, grp = t / kSlice;
  const int lane = t & 31, warp = t >> 5;
  const int nb = gridDim.x, D = a.D;
  const int slices = (D + kSlice - 1) / kSlice;
  for (int s = blockIdx.x; s < slices; s += nb) {
    const int c = s * kSlice + e;
    float acc = 0.0f;
    int accb = 0;
    if (c < D) {
#pragma unroll 8
      for (int p = grp; p < nb; p += kSliceGroups) {
        acc = __fadd_rn(acc, a.dg_part[(long long)p * D + c]);
        if constexpr (kLN) accb += a.db_part[(long long)p * D + c];
      }
    }
#pragma unroll
    for (int o = kSlice; o < 32; o <<= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
      if constexpr (kLN) accb += __shfl_xor_sync(0xffffffffu, accb, o);
    }
    __syncthreads();
    if (lane < kSlice) {
      red[warp * kSlice + e] = acc;
      redb[warp * kSlice + e] = accb;
    }
    __syncthreads();
    if (t < kSlice && c < D) {
      float tot = red[t];
      int totb = redb[t];
      for (int w = 1; w < kWarps; ++w) {
        tot = __fadd_rn(tot, red[w * kSlice + t]);
        totb += redb[w * kSlice + t];
      }
      a.dgamma[c] = tot;
      if constexpr (kLN)
        a.dbeta[c] = __fmul_rn((float)totb, dfx::pow2f(a.gexp[0]));
    }
  }
}

// Shared memory of norm_bwd_cached: each warp's column partials (f32, and
// int32 for the layer-norm), then the row sums' double buffer.
constexpr int cached_smem(bool ln) {
  return (ln ? 2 : 1) * kWarps * kWarpCols * 4 + 2 * kWarps * 2 * 4;
}
// norm_bwd_rows: the row sums' double buffer, then the column sums
constexpr int kRowsSmem = 2 * kWarps * kSlice * 4;

// D % 8 == 0, D <= wr * 512, x, g aligned to their unit, gamma and dx to
// 16 bytes.  Group grp of warps wr * grp .. wr * grp + wr - 1 takes rows
// blockIdx.x * (8 / wr) + grp + j * gridDim.x * (8 / wr); warp q of the
// group holds units (q * kUnits + k) * 32 + lane, k < kUnits, of its rows.
// Two blocks per SM (16 warps, at most 128 registers: 107-127 used);
// three would cap them at 80, below what the bodies hold live.
template <typename XT, typename GT, bool kLN>
__global__ void __launch_bounds__(kThreads, 2)
norm_bwd_cached(NormBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using MX = Mant<XT>;
  using MG = Mant<GT>;
  float* sdg = reinterpret_cast<float*>(smem);
  int* sdb = reinterpret_cast<int*>(sdg + kWarps * kWarpCols);
  float* red = kLN ? reinterpret_cast<float*>(sdb + kWarps * kWarpCols)
                   : reinterpret_cast<float*>(sdb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = a.wr, gpb = kWarps / wr;
  const int q = warp % wr, grp = warp / wr;
  const int D = a.D, nu = D / kVec;
  const long long groups = (long long)gridDim.x * gpb;
  const float xs = dfx::pow2f(a.xexp[0]), gs = dfx::pow2f(a.gexp[0]);
  const float d = (float)D;
  const float4* gam4 = reinterpret_cast<const float4*>(a.gamma);
  float dg[kUnits][kVec];
  int db[kUnits][kVec];
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      dg[k][e] = 0.0f;
      db[k][e] = 0;
    }
  // the group's first row is loaded ahead of the loop, each next row
  // right after the current one's units are consumed, so its loads are in
  // flight during the row sums, the barrier and the dx pass
  typename MX::Raw xv[kUnits];
  typename MG::Raw gv[kUnits];
  const auto load = [&](long long r) {
    const auto* xr = reinterpret_cast<const typename MX::Raw*>(
        static_cast<const XT*>(a.x) + r * D);
    const auto* gr = reinterpret_cast<const typename MG::Raw*>(
        static_cast<const GT*>(a.g) + r * D);
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = (q * kUnits + k) * 32 + lane;
      if (u < nu) {
        xv[k] = xr[u];
        gv[k] = gr[u];
      }
    }
  };
  long long r = (long long)blockIdx.x * gpb + grp;
  if (r < a.R) load(r);
  int parity = 0;
  for (; r < a.R; r += groups) {
    const float m = kLN ? a.mu[r] : 0.0f, rs = a.rstd[r];
    float xn[kUnits][kVec], gg[kUnits][kVec];
    float sg = 0.0f, sgx = 0.0f;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = (q * kUnits + k) * 32 + lane;
      if (u < nu) {
        const float4 g0 = gam4[2 * u], g1 = gam4[2 * u + 1];
        const float gam[kVec] = {g0.x, g0.y, g0.z, g0.w,
                                 g1.x, g1.y, g1.z, g1.w};
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xs_e =
              __fmul_rn(mant_value<XT>(MX::bits(xv[k], e)), xs);
          xn[k][e] = kLN ? __fmul_rn(__fsub_rn(xs_e, m), rs)
                         : __fmul_rn(xs_e, rs);
          const uint32_t gb = MG::bits(gv[k], e);
          const float gq = __fmul_rn(mant_value<GT>(gb), gs);
          gg[k][e] = __fmul_rn(gq, gam[e]);
          if constexpr (kLN) {
            sg = __fadd_rn(sg, gg[k][e]);
            db[k][e] += (int)gb - MG::kBits;
          }
          sgx = __fadd_rn(sgx, __fmul_rn(gg[k][e], xn[k][e]));
          dg[k][e] = __fadd_rn(dg[k][e], __fmul_rn(gq, xn[k][e]));
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) xn[k][e] = gg[k][e] = 0.0f;
      }
    }
    if (r + groups < a.R) load(r + groups);
    if constexpr (kLN) sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    if (wr > 1) {
      float* rb = red + parity * kWarps * 2;
      if (lane == 0) {
        rb[warp * 2] = sg;
        rb[warp * 2 + 1] = sgx;
      }
      named_barrier(1 + grp, wr * 32);
      const float* gb = rb + grp * wr * 2;
      sg = gb[0];
      sgx = gb[1];
      for (int j = 1; j < wr; ++j) {
        sg = __fadd_rn(sg, gb[j * 2]);
        sgx = __fadd_rn(sgx, gb[j * 2 + 1]);
      }
      parity ^= 1;
    }
    const float mgg = __fdiv_rn(sg, d), mgx = __fdiv_rn(sgx, d);
    float4* dxr = reinterpret_cast<float4*>(a.dx + r * D);
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = (q * kUnits + k) * 32 + lane;
      if (u < nu) {
        float o[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float c = kLN ? __fsub_rn(gg[k][e], mgg) : gg[k][e];
          o[e] = __fmul_rn(rs, __fsub_rn(c, __fmul_rn(xn[k][e], mgx)));
        }
        dxr[2 * u] = make_float4(o[0], o[1], o[2], o[3]);
        dxr[2 * u + 1] = make_float4(o[4], o[5], o[6], o[7]);
      }
    }
  }
  // this warp's column partials -> shared memory (column c of group j at
  // j * wr * kWarpCols + c); the block's partial row is the sum over its
  // groups, in group order
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    float4* s4 = reinterpret_cast<float4*>(
        sdg + warp * kWarpCols + (k * 32 + lane) * kVec);
    s4[0] = make_float4(dg[k][0], dg[k][1], dg[k][2], dg[k][3]);
    s4[1] = make_float4(dg[k][4], dg[k][5], dg[k][6], dg[k][7]);
    if constexpr (kLN) {
      int4* b4 = reinterpret_cast<int4*>(
          sdb + warp * kWarpCols + (k * 32 + lane) * kVec);
      b4[0] = make_int4(db[k][0], db[k][1], db[k][2], db[k][3]);
      b4[1] = make_int4(db[k][4], db[k][5], db[k][6], db[k][7]);
    }
  }
  __syncthreads();
  float* pg = a.dg_part + (long long)blockIdx.x * D;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float s = 0.0f;
    int sb = 0;
    for (int j = 0; j < gpb; ++j) {
      s = __fadd_rn(s, sdg[j * wr * kWarpCols + c]);
      if constexpr (kLN) sb += sdb[j * wr * kWarpCols + c];
    }
    pg[c] = s;
    if constexpr (kLN) a.db_part[(long long)blockIdx.x * D + c] = sb;
  }
  cooperative_groups::this_grid().sync();
  bwd_column_sums<kLN>(a, reinterpret_cast<float*>(smem));
}

// Any shape: block b takes rows b, b + nb, ... one at a time, thread t
// columns t, t + 256, ...; x and g are read in the row-sum pass and again
// in the dx pass; the block's partial row lives in dg_part / db_part
// (zeroed first, each column read and written by its one thread).
template <typename XT, typename GT, bool kLN>
__global__ void __launch_bounds__(kThreads)
norm_bwd_rows(NormBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int D = a.D;
  const XT* x = static_cast<const XT*>(a.x);
  const GT* g = static_cast<const GT*>(a.g);
  const float xs = dfx::pow2f(a.xexp[0]), gs = dfx::pow2f(a.gexp[0]);
  const float d = (float)D;
  float* pg = a.dg_part + (long long)blockIdx.x * D;
  int* pb = kLN ? a.db_part + (long long)blockIdx.x * D : nullptr;
  for (int c = t; c < D; c += kThreads) {
    pg[c] = 0.0f;
    if constexpr (kLN) pb[c] = 0;
  }
  int parity = 0;
  for (long long r = blockIdx.x; r < a.R; r += gridDim.x) {
    const long long off = r * D;
    const float m = kLN ? a.mu[r] : 0.0f, rs = a.rstd[r];
    float sg = 0.0f, sgx = 0.0f;
    for (int c = t; c < D; c += kThreads) {
      const float xv = __fmul_rn((float)x[off + c], xs);
      const float xn = kLN ? __fmul_rn(__fsub_rn(xv, m), rs)
                           : __fmul_rn(xv, rs);
      const float gg = __fmul_rn(__fmul_rn((float)g[off + c], gs),
                                 a.gamma[c]);
      if constexpr (kLN) sg = __fadd_rn(sg, gg);
      sgx = __fadd_rn(sgx, __fmul_rn(gg, xn));
    }
    if constexpr (kLN) sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    float* rb = red + parity * kWarps * 2;
    if (lane == 0) {
      rb[warp * 2] = sg;
      rb[warp * 2 + 1] = sgx;
    }
    __syncthreads();
    sg = rb[0];
    sgx = rb[1];
    for (int j = 1; j < kWarps; ++j) {
      sg = __fadd_rn(sg, rb[j * 2]);
      sgx = __fadd_rn(sgx, rb[j * 2 + 1]);
    }
    parity ^= 1;
    const float mgg = __fdiv_rn(sg, d), mgx = __fdiv_rn(sgx, d);
    for (int c = t; c < D; c += kThreads) {
      const float xv = __fmul_rn((float)x[off + c], xs);
      const float xn = kLN ? __fmul_rn(__fsub_rn(xv, m), rs)
                           : __fmul_rn(xv, rs);
      const int gi = g[off + c];
      const float gq = __fmul_rn((float)gi, gs);
      const float gg = __fmul_rn(gq, a.gamma[c]);
      const float cc = kLN ? __fsub_rn(gg, mgg) : gg;
      a.dx[off + c] = __fmul_rn(rs, __fsub_rn(cc, __fmul_rn(xn, mgx)));
      pg[c] = __fadd_rn(pg[c], __fmul_rn(gq, xn));
      if constexpr (kLN) pb[c] += gi;
    }
  }
  cooperative_groups::this_grid().sync();
  bwd_column_sums<kLN>(a, red);
}

// The backward instantiation for the mantissa types (bytes 1 or 2), the
// norm and the path; null for other types.
BwdKernel bwd_kernel(int x_bytes, int g_bytes, bool ln, bool cached) {
  BwdKernel k = nullptr;
  auto pick = [&](auto x, auto g) {
    using X = decltype(x);
    using G = decltype(g);
    if (cached)
      k = ln ? norm_bwd_cached<X, G, true> : norm_bwd_cached<X, G, false>;
    else
      k = ln ? norm_bwd_rows<X, G, true> : norm_bwd_rows<X, G, false>;
  };
  switch (x_bytes * 4 + g_bytes) {
    case 5: pick(int8_t(), int8_t()); break;
    case 6: pick(int8_t(), int16_t()); break;
    case 9: pick(int16_t(), int8_t()); break;
    case 10: pick(int16_t(), int16_t()); break;
    default: break;
  }
  return k;
}

int bwd_smem(bool ln, bool cached) {
  return cached ? cached_smem(ln) : kRowsSmem;
}

// One cooperative launch of nb blocks (nb <= int_norm_bwd_resident).
int norm_bwd_launch(NormBwdArgs a, int x_bytes, int g_bytes, bool ln,
                    int nb, cudaStream_t stream) {
  if (a.D <= 0) return 0;
  const bool cached = a.wr > 0;
  BwdKernel k = bwd_kernel(x_bytes, g_bytes, ln, cached);
  if (!k || nb < 1 || a.R < 0) return (int)cudaErrorInvalidValue;
  if (cached) {
    const auto off = [](const void* p, int align) {
      return reinterpret_cast<uintptr_t>(p) % align;
    };
    if ((a.wr != 1 && a.wr != 2 && a.wr != 4 && a.wr != 8) ||
        a.D % kVec != 0 || a.D > a.wr * kWarpCols ||
        off(a.x, kVec * x_bytes) || off(a.g, kVec * g_bytes) ||
        off(a.gamma, 16) || off(a.dx, 16))
      return (int)cudaErrorInvalidValue;
  }
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)k, dim3(nb),
                                          dim3(kThreads), args,
                                          bwd_smem(ln, cached), stream);
}

}  // namespace

// xm: (R, D) int8 (in_bytes = 1) or int16 (in_bytes = 2) mantissas; exp one
// int32 in device memory; gamma (D,) f32; y (R, D) f32; rstd (R,) f32.
// integer_rsqrt != 0: the rsqrt's Q.14 Newton body.  wr: warps per row of
// the register path (1, 2, 4 or 8), gpb rows a block, nb blocks; wr = 0:
// the any-shape body (a block per row; gpb and nb unused).
extern "C" int int_rmsnorm_fwd_launch(const void* xm, int in_bytes,
                                      const int* exp, const float* gamma,
                                      float* y, float* rstd, int R, int D,
                                      float eps, int integer_rsqrt, int wr,
                                      int gpb, int nb, cudaStream_t stream) {
  if (R <= 0 || D <= 0) return 0;
  if (wr > 0)
    return norm_fwd_launch({xm, exp, gamma, nullptr, y, nullptr, rstd, R, D,
                            wr, eps},
                           in_bytes, integer_rsqrt, false, gpb, nb, stream);
  return run_fwd(in_bytes, integer_rsqrt, [&](auto x, auto r) {
    using X = decltype(x);
    rms_fwd_kernel<X, decltype(r)::value><<<R, kThreads, 0, stream>>>(
        (const X*)xm, exp, gamma, y, rstd, D, eps);
  });
}

// As int_rmsnorm_fwd_launch, with beta (D,) f32 and mu (R,) f32.
extern "C" int int_layernorm_fwd_launch(const void* xm, int in_bytes,
                                        const int* exp, const float* gamma,
                                        const float* beta, float* y,
                                        float* mu, float* rstd, int R, int D,
                                        float eps, int integer_rsqrt, int wr,
                                        int gpb, int nb,
                                        cudaStream_t stream) {
  if (R <= 0 || D <= 0) return 0;
  if (wr > 0)
    return norm_fwd_launch({xm, exp, gamma, beta, y, mu, rstd, R, D, wr,
                            eps},
                           in_bytes, integer_rsqrt, true, gpb, nb, stream);
  return run_fwd(in_bytes, integer_rsqrt, [&](auto x, auto r) {
    using X = decltype(x);
    ln_fwd_kernel<X, decltype(r)::value><<<R, kThreads, 0, stream>>>(
        (const X*)xm, exp, gamma, beta, y, mu, rstd, D, eps);
  });
}

// Co-resident blocks of the backward instantiation on device dev (the
// most a cooperative launch may take): occupancy x SMs, or a negative
// CUDA error.  ln: the layer-norm (else the RMS-norm); cached: the
// register path (wr > 0).
extern "C" int int_norm_bwd_resident(int dev, int x_bytes, int g_bytes,
                                     int ln, int cached) {
  BwdKernel k = bwd_kernel(x_bytes, g_bytes, ln != 0, cached != 0);
  if (!k) return -(int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k, kThreads, bwd_smem(ln != 0, cached != 0));
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// xm (R, D) and gm (R, D): int8 or int16 mantissas (x_bytes, g_bytes);
// xexp, gexp one int32 each in device memory; gamma (D,) f32; mu, rstd
// (R,) f32.  Writes dx (R, D), dgamma and dbeta (D,) f32, using dg_part
// (nb, D) f32 and db_part (nb, D) int32 as scratch.  wr: warps per row
// (1, 2, 4 or 8; 0 for the any-shape path); nb: blocks, 1 <= nb <=
// int_norm_bwd_resident(...).  One cooperative kernel launch.
extern "C" int int_layernorm_bwd_launch(
    const void* xm, int x_bytes, const void* gm, int g_bytes,
    const int* xexp, const int* gexp, const float* gamma, const float* mu,
    const float* rstd, float* dx, float* dgamma, float* dbeta,
    float* dg_part, int* db_part, int R, int D, int wr, int nb,
    cudaStream_t stream) {
  return norm_bwd_launch({xm, gm, xexp, gexp, gamma, mu, rstd, dx, dgamma,
                          dbeta, dg_part, db_part, R, D, wr},
                         x_bytes, g_bytes, true, nb, stream);
}

// As int_layernorm_bwd_launch without mu, dbeta and db_part: writes dx
// (R, D) and dgamma (D,), dg_part (nb, D) f32 as scratch.
extern "C" int int_rmsnorm_bwd_launch(
    const void* xm, int x_bytes, const void* gm, int g_bytes,
    const int* xexp, const int* gexp, const float* gamma, const float* rstd,
    float* dx, float* dgamma, float* dg_part, int R, int D, int wr, int nb,
    cudaStream_t stream) {
  return norm_bwd_launch({xm, gm, xexp, gexp, gamma, nullptr, rstd, dx,
                          dgamma, nullptr, dg_part, nullptr, R, D, wr},
                         x_bytes, g_bytes, false, nb, stream);
}
