// Shared helpers of the port's CUDA kernels (built for sm_90a, plain C
// interface, loaded with ctypes by repro_torch/kernels/_lib.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dfx {

// Balanced base-2^7 limb radix: must match LIMB_BITS in
// repro_torch/kernels/dfx_quant.py (and the reference's dfx_quant.py).
constexpr int kLimbBits = 7;

// Exact 2^e as float32.  Normal powers get their exponent field written
// directly; e in [-149, -127] gives the subnormal power, below that 0,
// above 127 inf.  Same rule as repro_torch.core.dfx.pow2, so every kernel
// agrees with its plain PyTorch version at every exponent.  (The reference
// builds its scales with exp2(), which XLA:CPU rounds for most integers
// outside [-12, 12].)
__device__ __forceinline__ float pow2f(int e) {
  if (e > 127) return __int_as_float(0x7f800000);
  if (e >= -126) return __int_as_float((e + 127) << 23);
  if (e >= -149) return __int_as_float(1 << (e + 149));
  return 0.0f;
}

// Balanced digit split of an integer mantissa into `n` int8 limb planes,
// m = sum_j plane_j * 2^(7j): every non-final digit lies in [-64, 63], the
// final plane keeps the raw carry (|carry| <= 64 for b <= 16).  Integer
// form of the reference's _split_planes (floor((m + 64) / 128) is the
// arithmetic shift).  `put(j, digit)` stores plane j.
template <typename Put>
__device__ __forceinline__ void split_limbs(int m, int n, Put put) {
  for (int j = 0; j < n - 1; ++j) {
    const int carry = (m + 64) >> kLimbBits;
    put(j, m - carry * (1 << kLimbBits));
    m = carry;
  }
  put(n - 1, m);
}

}  // namespace dfx
