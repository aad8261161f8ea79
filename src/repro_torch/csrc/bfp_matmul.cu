// Block-floating-point integer matmul over int8 limb planes, in the three
// layouts of the integer layers' forward and backward products.
//
// Replaces the TPU kernels of repro/kernels/bfp_matmul.py (body
// _bfp_matmul_kernel :89, epilogue _combine_partials :66, _bfp_call :122,
// pallas_call :127):
//
//   bfp_matmul    (:147)  NN  out (M,N) = X (M,K) . W (K,N)     forward
//   bfp_matmul_nt (:176)  NT  dX  (M,K) = G (M,N) . W (K,N)^T   backward dX
//   bfp_matmul_tn (:210)  TN  dW  (K,N) = X (M,K)^T . G (M,N)   backward dW
//
// Written here for one output tile out (M,N) = A (M,K) . B (K,N):
//
//   acc[ja, jb] = A[ja] . B[jb]                    exact int32 per limb pair
//   out = sum_{ja outer, jb inner} (f32(acc) * 2^exp) * 2^(7(ja+jb))
//
// The batched (expert-axis) kernels of the same file are the same kernel
// with the expert on blockIdx.z (body _bfp_matmul_batched_kernel :244,
// _bfp_batched_call :276, pallas_call :281):
//
//   bfp_matmul_batched    (:302)  NN  out[e] = X[e] . W[e]     MoE forward
//   bfp_matmul_batched_nt (:332)  NT  dX[e]  = G[e] . W[e]^T   MoE dX
//   bfp_matmul_batched_tn (:362)  TN  dW[e]  = X[e]^T . G[e]   MoE dW
//
// Operands are plane-major (L, E, rows, cols): plane j of expert e starts at
// (j*E + e) * rows*cols.  Expert e scales by out_exp[e] and writes out[e];
// one launch covers every expert and every limb pair.  The unbatched
// products are the E = 1 case.
//
// The f32 combine runs in that fixed order with the same two exact
// power-of-two multiplies, so every int32 partial and every rounding of the
// sum is the reference's (the scale itself is built exactly, see pow2f).
//
// An int8 dot wants both operands contraction-contiguous in shared memory.
// Each operand arrives in the layout its producer wrote and is transposed,
// where it must be, while its tile is staged into shared memory — never in
// a separate pass over device memory:
//   A: (M,K) row-major (NN, NT: X or G as they are), or stored (K,M)
//      row-major, i.e. M-contiguous (TN: the saved activation X, whose
//      feature axis is dW's row axis), staged transposed (XT).
//   B: (K,N) row-major (NN: a linear layer's weight; TN: the gradient G),
//      staged transposed; or stored (N,K) row-major, i.e. K-contiguous (WK:
//      the tied LM head's planes, quantized in the table's own layout, and
//      NT's weight W (K,N), whose contraction axis N is contiguous), staged
//      as it is.  So NT is the tied head's instantiation, and TN stages both
//      operands transposed.
//
// int32 stays exact: a non-final limb digit lies in [-64, 63] and the final
// plane holds the carry (|carry| <= 64 for b <= 16 bits), and an 8-bit
// mantissa plane holds |m| <= 127, so one product is < 2^13 and a sum over
// a contraction of length C is < 2^13 * C: exact for C < 2^18.  TN
// contracts the token axis M = batch x sequence (4,096 at batch 32 x seq
// 128, 4,608 at 12 x 384), far inside that.
//
// Bound on the H100 (batched): at MoE decode each expert's W planes are
// read once for the few rows routed to it (bytes: 173 MB of planes per
// expert matrix of qwen2-moe-a2.7b); in training, capacity Cg = 256 rows
// per expert, operations.  The drop-free dispatch of a prefill (Cg = T*K
// rows per expert, most of them zero) multiplies zero tiles too: skipping
// the tiles past an expert's fill count is later work.
//
// Bound on the H100: at decode (M = batch slots, 4 rows) the kernel reads
// each W byte once for ~8 operations, so it is bound by bytes (the tied head
// alone is 156 MB of int8 planes); at prefill and in training (M = slots x
// prompt, or batch x sequence) it reads each tile for 64 rows and the int8
// work grows with M, so it is bound by operations.  Design (the simple
// first version): 64x64 output tiles, 32-deep contraction steps staged
// through shared memory, 256 threads each holding a 4x4 block of int32
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
// transposed into smem[64][KP] (row = n, K-contiguous).  Stages B of NN and
// TN, and (with N = M) TN's A, the activation stored (K,M).
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

// XT: A stored (K,M) M-contiguous (else (M,K) K-contiguous).  WK: B stored
// (N,K) K-contiguous (else (K,N) N-contiguous).
template <int LX, int LW, bool XT, bool WK>
__global__ void __launch_bounds__(kThreads)
bfp_matmul_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                  const int* __restrict__ exp, float* __restrict__ out, int M,
                  int N, int K) {
  __shared__ __align__(16) int8_t xs[LX][BM][KP];
  __shared__ __align__(16) int8_t ws[LW][BN][KP];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // expert e = blockIdx.z of gridDim.z: its slice of every plane, its
  // exponent and its output block
  const int e = blockIdx.z;
  const long long xmat = (long long)M * K, wmat = (long long)K * N;
  const long long xplane = xmat * gridDim.z, wplane = wmat * gridDim.z;
  X += e * xmat;
  W += e * wmat;
  out += e * (long long)M * N;
  const bool vx = XT ? (M % 4) == 0 : (K % 4) == 0;
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
    for (int j = 0; j < LX; ++j) {
      if (XT)
        stage_nmajor(xs[j], X + j * xplane, m0, M, k0, K, vx);
      else
        stage_kmajor(xs[j], X + j * xplane, m0, M, k0, K, K, vx);
    }
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
  const float s0 = dfx::pow2f(exp[e]);
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
int launch(const int8_t* X, const int8_t* W, const int* exp, float* out,
           int M, int N, int K, int E, int layout, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
  switch (layout) {
    case 0:
      bfp_matmul_kernel<LX, LW, false, false>
          <<<grid, kThreads, 0, stream>>>(X, W, exp, out, M, N, K);
      break;
    case 1:
      bfp_matmul_kernel<LX, LW, false, true>
          <<<grid, kThreads, 0, stream>>>(X, W, exp, out, M, N, K);
      break;
    case 2:
      bfp_matmul_kernel<LX, LW, true, false>
          <<<grid, kThreads, 0, stream>>>(X, W, exp, out, M, N, K);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// out (E, M, N) f32, out[e] = A[e] (M, K) . B[e] (K, N) over int8 limb
// planes (la of A, lb of B, plane-major: (la, E, ...) and (lb, E, ...)),
// each expert's matrices stored as `layout` says:
//   0  A (M,K) row-major, B (K,N) row-major         NN: X . W
//   1  A (M,K) row-major, B stored (N,K) row-major   NN tied head; NT: G . W^T
//   2  A stored (K,M) row-major, B (K,N) row-major   TN: X^T . G
// exp: E int32 in device memory (each expert's two operands' exponents
// summed).  The unbatched products are E = 1.
extern "C" int bfp_matmul_launch(const int8_t* A, const int8_t* B,
                                 const int* exp, float* out, int M, int N,
                                 int K, int E, int la, int lb, int layout,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || E <= 0) return 0;
  if (M > 65535 * BM || E > 65535) return (int)cudaErrorInvalidValue;
  int err;
  switch (la * 4 + lb) {
    case 5:
      err = launch<1, 1>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 6:
      err = launch<1, 2>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 7:
      err = launch<1, 3>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 9:
      err = launch<2, 1>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 10:
      err = launch<2, 2>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 11:
      err = launch<2, 3>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 13:
      err = launch<3, 1>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 14:
      err = launch<3, 2>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    case 15:
      err = launch<3, 3>(A, B, exp, out, M, N, K, E, layout, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

