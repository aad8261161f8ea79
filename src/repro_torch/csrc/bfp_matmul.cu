// Block-floating-point integer matmul over int8 limb planes (NN layout).
//
// Replaces the TPU kernel repro/kernels/bfp_matmul.py::bfp_matmul
// (:147; _bfp_call :122, pallas_call :127; body _bfp_matmul_kernel :89,
// epilogue _combine_partials :66):
//
//   acc[jx, jw] = X[jx] (M,K) . W[jw] (K,N)        exact int32 per limb pair
//   out = sum_{jx outer, jw inner} (f32(acc) * 2^exp) * 2^(7(jx+jw))
//
// The f32 combine runs in that fixed order with the same two exact
// power-of-two multiplies, so every int32 partial and every rounding of the
// sum is the reference's (the scale itself is built exactly, see pow2f).
//
// W may arrive N-contiguous ((K,N) row-major, every linear layer) or
// K-contiguous (the tied LM head, W = embed^T, whose planes are quantized in
// the table's own (N,K) layout).  An int8 dot wants both operands
// K-contiguous, so an N-contiguous W tile is transposed while it is staged
// into shared memory — never in a separate pass over device memory.
//
// Bound on the H100: at decode (M = batch slots, 4 rows) the kernel reads
// each W byte once for ~8 operations, so it is bound by bytes (the tied head
// alone is 156 MB of int8 planes); at prefill (M = slots x prompt) it reads
// each W tile for 64 rows and the int8 work grows with M.  Design (the
// simple first version): 64x64 output tiles, 32-deep K steps staged through
// shared memory, 256 threads each holding a 4x4 block of int32
// accumulators per limb pair, __dp4a for four int8 products per
// instruction.  Tensor-core MMA (wgmma), TMA and a double-buffered pipeline
// are later work.
#include "dfx_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int KP = BK + 4;  // padded smem row (bytes): conflict-free words
constexpr int kThreads = 256;

// Stage a 64-row x BK tile of a K-contiguous int8 matrix (row stride ld
// bytes) into smem[64][KP]; rows >= rows_total and k >= K read as zero.
__device__ __forceinline__ void stage_kmajor(int8_t (*dst)[KP],
                                             const int8_t* __restrict__ src,
                                             int row0, int rows_total, int k0,
                                             int K, long long ld, bool vec) {
  for (int w = threadIdx.x; w < 64 * (BK / 4); w += kThreads) {
    const int r = w / (BK / 4), c = (w % (BK / 4)) * 4;
    const int gr = row0 + r, gk = k0 + c;
    unsigned int word = 0;
    if (gr < rows_total) {
      const int8_t* p = src + gr * ld + gk;
      if (vec && gk + 3 < K) {
        word = *reinterpret_cast<const unsigned int*>(p);
      } else {
        for (int i = 0; i < 4; ++i)
          if (gk + i < K) word |= (unsigned int)(uint8_t)p[i] << (8 * i);
      }
    }
    *reinterpret_cast<unsigned int*>(&dst[r][c]) = word;
  }
}

// Stage the BK x 64 tile (k0.., n0..) of an N-contiguous (K,N) int8 matrix
// transposed into smem[64][KP] (row = n, K-contiguous).
__device__ __forceinline__ void stage_nmajor(int8_t (*dst)[KP],
                                             const int8_t* __restrict__ src,
                                             int n0, int N, int k0, int K,
                                             bool vec) {
  for (int w = threadIdx.x; w < BK * (BN / 4); w += kThreads) {
    const int kk = w / (BN / 4), c = (w % (BN / 4)) * 4;
    const int gk = k0 + kk, gn = n0 + c;
    unsigned int word = 0;
    if (gk < K) {
      const int8_t* p = src + (long long)gk * N + gn;
      if (vec && gn + 3 < N) {
        word = *reinterpret_cast<const unsigned int*>(p);
      } else {
        for (int i = 0; i < 4; ++i)
          if (gn + i < N) word |= (unsigned int)(uint8_t)p[i] << (8 * i);
      }
    }
    for (int i = 0; i < 4; ++i) dst[c + i][kk] = (int8_t)(word >> (8 * i));
  }
}

template <int LX, int LW, bool WK>
__global__ void __launch_bounds__(kThreads)
bfp_matmul_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                  const int* __restrict__ exp, float* __restrict__ out, int M,
                  int N, int K) {
  __shared__ __align__(16) int8_t xs[LX][BM][KP];
  __shared__ __align__(16) int8_t ws[LW][BN][KP];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const long long xplane = (long long)M * K, wplane = (long long)K * N;
  const bool vx = (K % 4) == 0;
  const bool vw = WK ? (K % 4) == 0 : (N % 4) == 0;

  int acc[LX * LW][4][4];
#pragma unroll
  for (int p = 0; p < LX * LW; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) acc[p][i][ii] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < LX; ++j)
      stage_kmajor(xs[j], X + j * xplane, m0, M, k0, K, K, vx);
#pragma unroll
    for (int j = 0; j < LW; ++j) {
      if (WK)
        stage_kmajor(ws[j], W + j * wplane, n0, N, k0, K, K, vw);
      else
        stage_nmajor(ws[j], W + j * wplane, n0, N, k0, K, vw);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      int a[LX][4], b[LW][4];
#pragma unroll
      for (int j = 0; j < LX; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[j][i] = *reinterpret_cast<const int*>(&xs[j][ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < LW; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          b[j][i] = *reinterpret_cast<const int*>(&ws[j][tx + 16 * i][kk]);
#pragma unroll
      for (int jx = 0; jx < LX; ++jx)
#pragma unroll
        for (int jw = 0; jw < LW; ++jw)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
              acc[jx * LW + jw][i][ii] =
                  __dp4a(a[jx][i], b[jw][ii], acc[jx * LW + jw][i][ii]);
    }
    __syncthreads();
  }

  // Epilogue: ordered f32 combine of the per-pair partials (x-limbs outer,
  // w-limbs inner), each term (f32(acc) * 2^exp) * 2^(7(jx+jw)).
  const float s0 = dfx::pow2f(exp[0]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int n = n0 + tx + 16 * ii;
      if (m < M && n < N) {
        float o = 0.0f;
#pragma unroll
        for (int jx = 0; jx < LX; ++jx)
#pragma unroll
          for (int jw = 0; jw < LW; ++jw) {
            const float part =
                __fmul_rn(__fmul_rn((float)acc[jx * LW + jw][i][ii], s0),
                          dfx::pow2f(dfx::kLimbBits * (jx + jw)));
            o = (jx == 0 && jw == 0) ? part : __fadd_rn(o, part);
          }
        out[(long long)m * N + n] = o;
      }
    }
  }
}

template <int LX, int LW>
void launch(const int8_t* X, const int8_t* W, const int* exp, float* out,
            int M, int N, int K, int w_kmajor, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (w_kmajor)
    bfp_matmul_kernel<LX, LW, true>
        <<<grid, kThreads, 0, stream>>>(X, W, exp, out, M, N, K);
  else
    bfp_matmul_kernel<LX, LW, false>
        <<<grid, kThreads, 0, stream>>>(X, W, exp, out, M, N, K);
}

}  // namespace

// X: (lx, M, K) int8 planes, row-major.  W: (lw, K, N) int8 planes, either
// N-contiguous (w_kmajor = 0) or stored as (lw, N, K) (w_kmajor = 1).
// exp: one int32 in device memory (x_exp + w_exp).  out: (M, N) f32.
extern "C" int bfp_matmul_launch(const int8_t* X, const int8_t* W,
                                 const int* exp, float* out, int M, int N,
                                 int K, int lx, int lw, int w_kmajor,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M > 65535 * BM) return (int)cudaErrorInvalidValue;
  switch (lx * 4 + lw) {
    case 5: launch<1, 1>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 6: launch<1, 2>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 7: launch<1, 3>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 9: launch<2, 1>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 10: launch<2, 2>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 11: launch<2, 3>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 13: launch<3, 1>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 14: launch<3, 2>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    case 15: launch<3, 3>(X, W, exp, out, M, N, K, w_kmajor, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
