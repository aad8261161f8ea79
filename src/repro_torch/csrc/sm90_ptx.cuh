// Inline-PTX wrappers of the port's tensor-core kernels: the int8 warp MMA
// and the asynchronous global -> shared copies (sm_80 and later; the port
// builds for sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ptx {

// D = A . B + D over one warp: A 16x32 s8 (row-major, 4 registers of 4
// bytes), B 32x8 s8 (column-major, 2 registers), D 16x8 s32 (4 registers).
// Fragments, with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix
// Fragments for mma.m16n8k32"):
//   a[0] row g,   k 4t..4t+3     a[1] row g+8, k 4t..4t+3
//   a[2] row g,   k 16+4t..      a[3] row g+8, k 16+4t..
//   b0   col g,   k 4t..4t+3     b1   col g,   k 16+4t..
//   d[0] (g, 2t)  d[1] (g, 2t+1) d[2] (g+8, 2t)  d[3] (g+8, 2t+1)
// Integer accumulation is exact (no saturation is asked for, and the
// callers' sums stay far inside int32).
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, one per register: lane l gives
// the address of row l % 8 of matrix l / 8 (16 contiguous bytes, 16-byte
// aligned), and receives word l % 4 of row l / 4 of each matrix.  For
// int8 data that is the m16n8k32 fragment: row g, bytes 4t..4t+3.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory;
// the destination is zero-filled instead where `valid` is false (the
// source is then not read).  Both addresses aligned to BYTES.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ptx
