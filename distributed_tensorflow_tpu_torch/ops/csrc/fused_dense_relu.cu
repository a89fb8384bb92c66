// relu(x @ w + b) on Hopper (sm_90a): the CUDA port of the TPU kernel
// distributed_tensorflow_tpu/ops/pallas_ops.py `_kernel` (launched by the
// pl.pallas_call in `_forward`), the `wd1` layer of the deep CNN.
//
// What it computes: x [M,K], w [K,N], b [N], all float32 or all bfloat16;
// the sum runs in float32, the epilogue adds the bias in float32, applies
// ReLU (NaN passes through, as jnp.maximum does), and stores in x's dtype.
// The kernel masks ragged M, N and K itself: the host pads nothing.
//
// Bound on the card: at the serving shapes (M <= 8, K = 3136, N = 1024)
// the work is reading w once — 12.85 MB in f32, >= 3.8 us at 3.35 TB/s;
// 6.42 MB in bf16, >= 1.9 us. The arithmetic (2*M*K*N <= 51 MFLOP) is far
// below either peak. At M = 256 in f32 the FMA rate bounds it instead
// (1.64 GFLOP at 67 TFLOP/s = 24.5 us).
//
// Design against that bound: the TPU grid gave each 128x128 output tile
// the whole K in VMEM; a Hopper block cannot hold that, so each block
// loops over K in 32-deep chunks staged through shared memory, with the
// f32 accumulator in registers. N = 1024 in 64-wide tiles gives only 16
// blocks for M <= 16, far too few to stream w from 132 SMs, so K is also
// SPLIT across blocks (blockIdx.z): the host picks the split count so the
// grid holds about four blocks per SM. Each split writes its partial sums
// to a float32 workspace and a second small kernel adds the splits in a
// fixed order (deterministic), then bias, ReLU and the cast. With one
// split the main kernel runs the epilogue itself. The M tile is 16 rows
// for M <= 16 and 64 otherwise; threads (f32) or warps (bf16) whose rows
// all lie past M skip the arithmetic. Tiles are staged with 16-byte
// vector loads when a row's length and the base pointer allow it (every
// wd1 shape), else one element at a time (ragged shapes).
//
//   f32:  plain FMA, no TF32 (the JAX tests run at `highest` precision);
//         256 threads, each a (BM/16) x 4 register tile.
//   bf16: WMMA 16x16x16 bf16 fragments with f32 accumulation; 4 warps,
//         warp j owns output columns [16j, 16j+16) of the 64-wide tile.
//
// Plain C interface for ctypes: fused_dense_relu_launch returns
// cudaGetLastError() after its launches. wgmma, TMA and a persistent
// schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int BN = 64;  // output columns per block
constexpr int BK = 32;  // K depth staged per shared-memory round

__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage a ROWS x COLS tile of a row-major source (leading dimension ld)
// into shared memory: dst[r * lds + c], or dst[c * lds + r] when
// TRANSPOSE. Elements at row >= row_end or col >= col_end read as zero.
// With `vec` each thread moves 16-byte vectors along a row; the caller
// guarantees that col0, col_end and ld are multiples of the vector width
// and that src is 16-byte aligned, so a vector lies wholly in range or
// wholly out. Without it, one element at a time.
template <typename T, int ROWS, int COLS, int THREADS, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile(T* dst, int lds, const T* __restrict__ src,
                                           int ld, int row0, int row_end, int col0,
                                           int col_end, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(COLS % VEC == 0, "a tile row holds whole vectors");
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (COLS / VEC); i += THREADS) {
      const int r = i / (COLS / VEC), c = (i % (COLS / VEC)) * VEC;
      const int gr = row0 + r, gc = col0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < row_end && gc < col_end)
        v = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
      if constexpr (TRANSPOSE) {
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[(c + j) * lds + r] = e[j];
      } else {
        *reinterpret_cast<uint4*>(dst + r * lds + c) = v;
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      const int r = i / COLS, c = i % COLS, gr = row0 + r, gc = col0 + c;
      const T v = (gr < row_end && gc < col_end) ? src[(size_t)gr * ld + gc]
                                                 : from_f32<T>(0.f);
      dst[TRANSPOSE ? c * lds + r : r * lds + c] = v;
    }
  }
}

// True when rows of length `ld` starting at `p` can be read as 16-byte
// vectors (k_per_split is a multiple of BK, so split edges stay aligned).
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int ld) {
  return ld % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------------ f32
constexpr int F32_THREADS = 256;  // a 16 x 16 grid of threads

template <int BM>
__global__ void __launch_bounds__(F32_THREADS)
fdr_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ out,
               float* __restrict__ ws, int M, int N, int K, int k_per_split) {
  constexpr int TM = BM / 16;
  __shared__ float As[BK][BM + 1];  // x tile, transposed; +1 breaks bank conflicts
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool active = m0 + ty < M;  // rows ty + 16*i; the first decides
  const bool vec_x = vec_ok(x, K), vec_w = vec_ok(w, N);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    stage_tile<float, BM, BK, F32_THREADS, true>(&As[0][0], BM + 1, x, K, m0, M,
                                                  k0, k_end, vec_x);
    stage_tile<float, BK, BN, F32_THREADS, false>(&Bs[0][0], BN, w, N, k0, k_end,
                                                   n0, N, vec_w);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty + 16 * i, gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        if (gridDim.z == 1)
          out[(size_t)gm * N + gn] = relu_nan(acc[i][j] + b[gn]);
        else
          ws[((size_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      }
    }
  }
}

// ----------------------------------------------------------------- bf16
constexpr int BF16_THREADS = 128;  // 4 warps x 16 output columns

template <int BM>
__global__ void __launch_bounds__(BF16_THREADS)
fdr_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const __nv_bfloat16* __restrict__ b,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                int M, int N, int K, int k_per_split) {
  using namespace nvcuda;
  constexpr int FM = BM / 16;                 // 16-row fragments per warp
  constexpr int LDA = BK + 8, LDB = BN + 8;   // bf16 strides: multiples of 8,
  constexpr int LDC = BN + 4;                 // f32 stride: multiple of 4
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  const int tid = threadIdx.x, warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool vec_x = vec_ok(x, K), vec_w = vec_ok(w, N);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    stage_tile<__nv_bfloat16, BM, BK, BF16_THREADS, false>(As, LDA, x, K, m0, M, k0,
                                                            k_end, vec_x);
    stage_tile<__nv_bfloat16, BK, BN, BF16_THREADS, false>(Bs, LDB, w, N, k0, k_end,
                                                            n0, N, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, Bs + kk * LDB + warp * 16, LDB);
#pragma unroll
      for (int f = 0; f < FM; ++f) {
        if (m0 + f * 16 < M) {  // warp-uniform: skip fragments past M
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, As + f * 16 * LDA + kk, LDA);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int f = 0; f < FM; ++f)
    wmma::store_matrix_sync(Cs + f * 16 * LDC + warp * 16, acc[f], LDC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += BF16_THREADS) {
    const int r = i / BN, c = i % BN, gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const float v = Cs[r * LDC + c];
      if (gridDim.z == 1)
        out[(size_t)gm * N + gn] = __float2bfloat16(relu_nan(v + __bfloat162float(b[gn])));
      else
        ws[((size_t)blockIdx.z * M + gm) * N + gn] = v;
    }
  }
}

// ------------------------------------------------- split-K epilogue
// Adds the splits' partial sums in split order, then bias, ReLU, cast.
template <typename T>
__global__ void fdr_splitk_epilogue(const float* __restrict__ ws,
                                    const T* __restrict__ b, T* __restrict__ out,
                                    int M, int N, int splits) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * mn + idx];
  out[idx] = from_f32<T>(relu_nan(s + to_f32(b[idx % N])));
}

template <typename T, int BM>
void launch_main(const void* x, const void* w, const void* b, void* out, void* ws,
                 int M, int N, int K, int splits, int k_per_split, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if constexpr (sizeof(T) == 4) {
    fdr_f32_kernel<BM><<<grid, F32_THREADS, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)out,
        (float*)ws, M, N, K, k_per_split);
  } else {
    fdr_bf16_kernel<BM><<<grid, BF16_THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
        (const __nv_bfloat16*)b, (__nv_bfloat16*)out, (float*)ws, M, N, K,
        k_per_split);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* out, void* ws,
                   int M, int N, int K, int block_m, int splits, int k_per_split,
                   cudaStream_t st) {
  if (block_m == 16)
    launch_main<T, 16>(x, w, b, out, ws, M, N, K, splits, k_per_split, st);
  else
    launch_main<T, 64>(x, w, b, out, ws, M, N, K, splits, k_per_split, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  fdr_splitk_epilogue<T><<<(unsigned)((mn + threads - 1) / threads), threads, 0, st>>>(
      (const float*)ws, (const T*)b, (T*)out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. ws: float32 [splits, M, N] (unused,
// may be null, when splits == 1). Returns a cudaError_t as int.
int fused_dense_relu_launch(int dtype, const void* x, const void* w, const void* b,
                            void* out, void* ws, int M, int N, int K, int block_m,
                            int splits, int k_per_split, int device, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (block_m != 16 && block_m != 64) || splits < 1 ||
      k_per_split < BK || k_per_split % BK != 0 ||
      (long long)splits * k_per_split < K ||
      (long long)(splits - 1) * k_per_split >= K || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device: follow the
  // tensors' device (a no-op, safe during graph capture, when it matches)
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    err = launch<float>(x, w, b, out, ws, M, N, K, block_m, splits, k_per_split, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, w, b, out, ws, M, N, K, block_m, splits, k_per_split, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

const char* fused_dense_relu_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
