// DFX quantize: the shift-round-clip pass of the linear fixed-point mapping.
//
// Replaces the TPU kernel repro/kernels/dfx_quant.py::dfx_quantize
// (pallas_call at :153 round-to-nearest and :159 stochastic; bodies
// _quant_kernel, _quant_kernel_stoch, _quant_kernel_limbs,
// _quant_kernel_limbs_stoch at :83-106):
//
//   m = clip(rint(x * 2^-exp)      , +-(2^(b-1)-1))   (half to even)
//   m = clip(floor(x * 2^-exp + u), +-(2^(b-1)-1))   (u given: stochastic)
//
// written as the logical int8/int16/int32 mantissa or, fused, as the
// (L, M, N) stack of balanced base-2^7 int8 limb planes the matmul and
// attention kernels take.  The scale exponent (absmax + frexp) is computed
// before the launch in plain PyTorch and read here from device memory, so
// no host synchronisation is needed.
//
// The same source replaces repro/kernels/dfx_quant.py::dfx_quantize_grouped
// (pallas_call at :238 round-to-nearest and :243 stochastic; bodies
// _quant_kernel_grouped{,_stoch,_limbs,_limbs_stoch}): x is an (E, M, N)
// stack and slice e shifts by its own exponent exp[e] (the MoE experts'
// per-expert scales).  The slice is blockIdx.y, so each thread reads its
// slice's exponent once and no index is divided; the plane-major (L, E, M,
// N) limb output is plane j at j * E*M*N + i, the ungrouped layout of the
// flattened stack.  The per-tensor form is the one-slice case.
//
// Bound on the H100: bytes.  Each element reads 4 bytes (8 with u) and
// writes 1-4, for one multiply, one round and a few integer ops, far below
// the ~295 operations per byte where the card turns compute-bound.  Design:
// a grid-stride elementwise loop with neighbouring threads on neighbouring
// elements (coalesced), enough blocks to cover all 132 SMs several times,
// and the limb split done in registers so the logical mantissa never goes
// through device memory.
#include "dfx_common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int round_clip(float x, float scale,
                                          const float* __restrict__ u,
                                          long long i, float lim) {
  float y = __fmul_rn(x, scale);
  y = u ? floorf(__fadd_rn(y, u[i])) : rintf(y);
  return (int)fminf(fmaxf(y, -lim), lim);
}

// Slice blockIdx.y of `slice` elements (all of x for the per-tensor
// form): grid-stride over the slice at the slice's exponent.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, const int* __restrict__ exp,
             const float* __restrict__ u, OutT* __restrict__ out,
             long long slice, int bits) {
  const float scale = dfx::pow2f(-exp[blockIdx.y]);
  const float lim = (float)((1 << (bits - 1)) - 1);
  const long long base = (long long)blockIdx.y * slice;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < slice; r += stride) {
    const long long i = base + r;
    out[i] = (OutT)round_clip(x[i], scale, u, i, lim);
  }
}

__global__ void __launch_bounds__(kThreads)
quant_limbs_kernel(const float* __restrict__ x, const int* __restrict__ exp,
                   const float* __restrict__ u, int8_t* __restrict__ out,
                   long long slice, int bits, int limbs) {
  const float scale = dfx::pow2f(-exp[blockIdx.y]);
  const float lim = (float)((1 << (bits - 1)) - 1);
  const long long n = (long long)gridDim.y * slice;   // one plane
  const long long base = (long long)blockIdx.y * slice;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < slice; r += stride) {
    const long long i = base + r;
    const int m = round_clip(x[i], scale, u, i, lim);
    dfx::split_limbs(m, limbs,
                     [&](int j, int d) { out[j * n + i] = (int8_t)d; });
  }
}

}  // namespace

// x is `groups` contiguous slices of `slice` elements ((E, M, N) with
// slice = M*N; the per-tensor form is one slice of all of x), exp holds one
// int32 per slice.  out_kind: 0 int8, 1 int16, 2 int32 logical mantissa; 3
// int8 limb planes (`limbs` of them, plane-major: (L, E, M, N)).  `u` may
// be null (round to nearest).
extern "C" int dfx_quantize_launch(const float* x, const int* exp,
                                   const float* u, void* out, int groups,
                                   long long slice, int bits, int out_kind,
                                   int limbs, cudaStream_t stream) {
  if (groups <= 0 || slice <= 0) return 0;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  // about 132 x 32 blocks in all, at least one per slice
  long long bx = (slice + kThreads - 1) / kThreads;
  const long long cap = (132 * 32 + groups - 1) / groups;
  if (bx > cap) bx = cap;
  const dim3 grid((unsigned)bx, (unsigned)groups);
  switch (out_kind) {
    case 0:
      quant_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
          x, exp, u, (int8_t*)out, slice, bits);
      break;
    case 1:
      quant_kernel<int16_t><<<grid, kThreads, 0, stream>>>(
          x, exp, u, (int16_t*)out, slice, bits);
      break;
    case 2:
      quant_kernel<int32_t><<<grid, kThreads, 0, stream>>>(
          x, exp, u, (int32_t*)out, slice, bits);
      break;
    case 3:
      quant_limbs_kernel<<<grid, kThreads, 0, stream>>>(
          x, exp, u, (int8_t*)out, slice, bits, limbs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
