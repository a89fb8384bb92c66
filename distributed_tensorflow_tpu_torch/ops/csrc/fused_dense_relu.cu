// relu(x @ w + b) on Hopper (sm_90a): the CUDA port of the TPU kernel
// distributed_tensorflow_tpu/ops/pallas_ops.py `_kernel` (launched by the
// pl.pallas_call in `_forward`), the `wd1` layer of the deep CNN.
//
// What it computes: x [M,K], w [K,N], b [N], all float32 or all bfloat16;
// the sum runs in float32, the epilogue adds the bias in float32, applies
// ReLU (NaN passes through, as jnp.maximum does), and stores in x's dtype.
//
// Bound on the card: at the serving shapes (M <= 8, K = 3136, N = 1024)
// the work is reading w once: 12.85 MB in f32, >= 3.8 us at 3.35 TB/s;
// 6.42 MB in bf16, >= 1.9 us. The arithmetic (2*M*K*N <= 51 MFLOP) is far
// below either peak. At M = 256 the f32 FMA rate bounds it (1.64 GFLOP at
// 67 TFLOP/s = 24.5 us); bf16 stays bound by bytes (2.55 us).
//
// Design against that bound, one skeleton for both dtypes (variant "tma"):
//
// * The output is cut into 64-column tiles of N by BM rows of M (BM in
//   8..128, picked by the host). N = 1024 gives only 16 tiles at M <= 8,
//   so K is split as well, across the CTAs of a thread-block cluster (a
//   power of two up to 8): 16 tiles x 8 splits = 128 CTAs stream w from
//   128 SMs. Split r of S takes the K chunks [r*chunks/S, (r+1)*chunks/S).
// * One producer warp issues TMA loads of the w tile [BK x 64] and the x
//   tile [BM x BK] (BK = 64 in bf16, 32 in f32: 128-byte x rows) into a
//   ring of up to 12 stages, with a full and an empty mbarrier per stage,
//   so at the serving shapes a CTA's whole K range is in flight (in f32,
//   all but one of its 13 stages). A launch stays under 112 KB of shared
//   memory so that two CTAs fit on an SM and 8-CTA clusters run in one
//   wave. TMA fills rows and columns past the tensor with zeros: no masks
//   on loads, no host padding. The producer's other lanes fetch the bias.
// * bf16: one consumer warpgroup runs wgmma m64nBMk16 with the product
//   swapped, out^T = w^T x^T, so the tile's 64 columns of N fill wgmma's
//   64-row slot and M (rounded up to BM) its N slot. Both tiles arrive with
//   the 128-byte swizzle; w is read MN-major (transposed), x K-major.
// * f32: two consumer warpgroups of plain FMA (no TF32: the JAX tests run
//   at `highest`), each thread an 8 x 4 register tile that reads each w
//   element it needs once, with 16-byte shared loads straight from the
//   tiles as TMA lays them (x swizzled, so no bank conflicts). The two
//   warpgroups take turns on chunks over a ring of an even number of
//   stages, so each owns every second stage; at small M the threads of
//   one split a stage's K steps as well; their partial tiles are added
//   when the tile leaves the CTA.
// * Split-K stays on chip, in one launch, with no workspace: each CTA
//   stores 1/S of its float32 partial tile into the shared memory of each
//   CTA of its cluster (st.async, counted on the receiver's mbarrier); a
//   CTA waits only for the S slices it owns, adds them in rank order
//   (deterministic), then bias, ReLU, cast, and stores. A cluster barrier
//   split around the main loop guards the first remote store.
//
// TMA needs 16-byte aligned base pointers and row strides (K and N
// multiples of 4 in f32, of 8 in bf16). Other shapes take variant "simt":
// a plain tiled kernel (16- or 64-row M tiles x 64 columns, 32-deep K
// chunks staged through registers into shared memory, FMA in f32, WMMA in
// bf16) that masks ragged edges itself, with the same cluster split-K and
// exchange. The host picks the variant (ops/fused_dense.py
// `launch_config`).
//
// Plain C interface for ctypes: fused_dense_relu_launch returns
// cudaGetLastError() after its one launch, or FDR_ERR_TENSOR_MAP + the
// CUresult when a tensor map cannot be encoded.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int FDR_ERR_TENSOR_MAP = 100000;

__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ===================================================== variant "tma"
constexpr int TILE_N = 64;               // output columns per CTA
constexpr int LDP = TILE_N + 4;          // partial tile row stride (floats)
constexpr int MAX_STAGES = 12;
constexpr int MAX_CLUSTER = 8;           // portable cluster size
// Dynamic shared memory a launch aims to stay under, so that two CTAs fit
// on one SM (228 KB) and clusters of 8 still run in one wave.
constexpr int SMEM_TARGET = 112 * 1024;

// f32 work split for a BM x 64 tile (BM <= 64) over two consumer
// warpgroups. Each thread owns 8 rows (interleaved: tm + RG*i) by 4
// columns and reads each w element it needs once from shared memory.
// With too few outputs to go round the 256 threads, they split the K
// steps instead: the two warpgroups take turns on ring stages, and KG groups
// within one take turns on the 16-byte steps of a stage. The PARTS
// partial tiles this leaves are added when the tile leaves the CTA.
template <int BM>
struct F32Tile {
  static constexpr int WGS = 2;
  static constexpr int TM = 8;                    // rows per thread
  static constexpr int TN = 4;                    // columns per thread
  static constexpr int G = TILE_N / TN;           // column groups
  static constexpr int RG = BM / TM;              // row groups
  static constexpr int KG = 128 / (G * RG);       // k groups
  static constexpr int PARTS = WGS * KG;
  static_assert(KG >= 1 && KG * G * RG == 128 && 8 % KG == 0, "the split covers the tile");
};

// Per-instantiation layout: the ring stage, the consumer warpgroups, and
// the float32 partial tiles left in shared memory after the loop.
template <typename T, int BM> struct TmaShape;

template <int BM>
struct TmaShape<__nv_bfloat16, BM> {
  static constexpr int BK = 64;
  static constexpr int WGS = 1;           // one warpgroup runs wgmma
  static constexpr int CONSUMERS = 128;
  static constexpr int EMPTY_ARRIVALS = 128;
  static constexpr int PARTS = 1;
  static constexpr int W_BYTES = BK * TILE_N * 2;  // w tile [BK][64]
  static constexpr int X_BYTES = BM * BK * 2;      // x tile [BM][BK]
  static constexpr int STAGE = W_BYTES + X_BYTES;  // a multiple of 1024
  static constexpr int PARTIAL = PARTS * BM * LDP * 4;
  static constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
  static_assert(W_BYTES % 1024 == 0 && X_BYTES % 1024 == 0, "1024-byte aligned tiles");
};

template <int BM>
struct TmaShape<float, BM> {
  using F = F32Tile<BM>;
  static constexpr int BK = 32;
  static constexpr int WGS = F::WGS;               // warpgroups that take turns on chunks
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int EMPTY_ARRIVALS = 128;       // one warpgroup reads a stage
  static constexpr int PARTS = F::PARTS;
  static constexpr int W_BYTES = BK * TILE_N * 4;
  static constexpr int X_BYTES = BM * BK * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int PARTIAL = PARTS * BM * LDP * 4;
  static constexpr int THREADS = CONSUMERS + 32;
  static_assert(W_BYTES % 1024 == 0 && X_BYTES % 1024 == 0, "1024-byte aligned tiles");
};

// Dynamic shared memory, in order: alignment slack; the ring, which the
// partial tiles reuse after the loop; a full and an empty mbarrier per
// stage; the mbarrier of the split-K exchange; the tile's 64 bias values;
// and the exchange buffer, where the cluster's S CTAs leave this CTA its
// 1/S slice of their partial tiles (S x GROUPS/S float4 = BM x 256 bytes).
struct Layout {
  int full, empty, xbar, bias, recv, bytes;
  __host__ __device__ Layout(int stage, int stages, int partial, int bm) {
    const int ring = stage * stages > partial ? stage * stages : partial;
    full = ring;
    empty = full + stages * 8;
    xbar = empty + stages * 8;
    bias = xbar + 16;
    recv = bias + TILE_N * 4;
    bytes = 1024 + recv + bm * TILE_N * 4;
  }
};

// First K chunk of split r of s (the last split ends at `chunks`).
__host__ __device__ __forceinline__ int split_begin(int r, int s, int chunks) {
  return (int)((long long)r * chunks / s);
}

template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// bf16 consumer: wgmma over the ring, float32 partial tile to `partial`
// as [BM][LDP] (row m, column n).
template <int BM>
__device__ __forceinline__ void consume_bf16(unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, int n_chunks, int stages,
                                             float* partial) {
  using S = TmaShape<__nv_bfloat16, BM>;
  float d[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) d[i] = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % stages;
    hopper::mbar_wait(&full[s], (i / stages) & 1);
    const unsigned char* wt = ring + s * S::STAGE;  // [64 k][64 n], 128 B swizzle
    const unsigned char* xt = wt + S::W_BYTES;      // [BM m][64 k], 128 B swizzle
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::BK / 16; ++kk) {
      // A = w^T, MN-major: 16 k rows of 128 B; 8-row groups 1024 B apart
      const uint64_t da = hopper::desc_sw128(wt + kk * 16 * 128, S::W_BYTES, 1024);
      // B = x^T, K-major: 16 k are 32 B along each 128 B row of x
      const uint64_t db = hopper::desc_sw128(xt + kk * 32, 16, 1024);
      hopper::Wgmma<BM>::mma(d, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous chunk's products are done
    if (i > 0) hopper::mbar_arrive(&empty[(i - 1) % stages]);
  }
  hopper::wgmma_wait<0>();
  consumers_sync<S::CONSUMERS>();  // every consumer is done with the ring before it is reused
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 16 * warp + lane / 4 + 8 * h, m = 8 * j + 2 * (lane % 4) + c;
        partial[m * LDP + n] = d[4 * j + 2 * h + c];
      }
}

// f32 consumer: FMA over the ring, split as F32Tile says; partial tile
// `part` of thread's group to `partial` + part * BM * LDP. The w tile is
// [32 k][64 n] as TMA lays it; the x tile [BM m][32 k] arrives with the
// 128-byte swizzle (16-byte step c of row m sits at step c ^ (m % 8)),
// so the threads of a warp, on neighbouring rows, read different banks.
template <int BM>
__device__ __forceinline__ void consume_f32(unsigned char* ring, uint64_t* full,
                                            uint64_t* empty, int n_chunks, int stages,
                                            float* partial) {
  using S = TmaShape<float, BM>;
  using F = F32Tile<BM>;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tn = t % F::G, tm = (t / F::G) % F::RG, kg = t / (F::G * F::RG);
  float acc[F::TM][F::TN];
#pragma unroll
  for (int r = 0; r < F::TM; ++r)
#pragma unroll
    for (int c = 0; c < F::TN; ++c) acc[r][c] = 0.f;
  // The warpgroups take turns on chunks. `stages` is a multiple of WGS
  // (tma_stages), so warpgroup wg reads stages wg, wg + WGS, ... on every
  // lap and waits on each phase of their barriers in turn; with an odd
  // ring it would skip the other warpgroup's laps, and a wait on parity p
  // also passes while the phase after p is still in flight.
  for (int i = wg; i < n_chunks; i += F::WGS) {
    const int s = i % stages;
    hopper::mbar_wait(&full[s], (i / stages) & 1);
    const float* wt = reinterpret_cast<const float*>(ring + s * S::STAGE);
    const unsigned char* xt = ring + s * S::STAGE + S::W_BYTES;
#pragma unroll
    for (int j = 0; j < S::BK / 4 / F::KG; ++j) {
      const int k4 = kg + j * F::KG;  // this thread's 16-byte step of the x rows
      float4 wv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wv[kk] = *reinterpret_cast<const float4*>(wt + (4 * k4 + kk) * TILE_N + tn * 4);
#pragma unroll
      for (int r = 0; r < F::TM; ++r) {
        const int row = tm + F::RG * r;
        const float4 xv =
            *reinterpret_cast<const float4*>(xt + row * 128 + ((k4 ^ (row & 7)) << 4));
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[r][0] = fmaf(xs[kk], wv[kk].x, acc[r][0]);
          acc[r][1] = fmaf(xs[kk], wv[kk].y, acc[r][1]);
          acc[r][2] = fmaf(xs[kk], wv[kk].z, acc[r][2]);
          acc[r][3] = fmaf(xs[kk], wv[kk].w, acc[r][3]);
        }
      }
    }
    hopper::mbar_arrive(&empty[s]);
  }
  consumers_sync<S::CONSUMERS>();  // every consumer is done with the ring before it is reused
  float* part = partial + (wg * F::KG + kg) * BM * LDP;
#pragma unroll
  for (int r = 0; r < F::TM; ++r)
    *reinterpret_cast<float4*>(part + (tm + F::RG * r) * LDP + tn * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// Split-K on chip, the tail of both variants; every thread of the CTA
// calls it. `partial` holds this CTA's float32 partial tile as PARTS
// tiles [BM][LDP], to be added in part order; `bias` the tile's 64 bias
// values. Group g (a float4 of a row) goes to rank g / slice, into row
// `rank` of that CTA's exchange buffer `recv` [S][slice], counted on its
// mbarrier `xbar` (armed for BM x 256 bytes). No CTA waits for its stores
// to land. Then this CTA waits for the S rows of its own buffer, adds them
// in rank order (deterministic), and applies bias, ReLU and the cast.
// VEC_OUT: N is a multiple of 4 and out 16-byte aligned per row of 4
// groups, so a group is stored at once; otherwise element by element.
template <typename T, int BM, int THREADS, int PARTS, bool VEC_OUT>
__device__ __forceinline__ void exchange_and_store(const float* partial, float* recv,
                                                   uint64_t* xbar, const float* bias,
                                                   T* __restrict__ out, int rank, int splits,
                                                   int m0, int n0, int M, int N) {
  constexpr int GROUPS = BM * TILE_N / 4;  // float4 groups of the tile
  const int slice = GROUPS / splits;       // groups each rank finishes
  __syncthreads();         // the partial tiles and the bias are written
  hopper::cluster_wait();  // every CTA's exchange barrier is ready
  for (int g = threadIdx.x; g < GROUPS; g += THREADS) {
    const float* p = partial + (g / (TILE_N / 4)) * LDP + (g % (TILE_N / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int q = 1; q < PARTS; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(p + q * BM * LDP);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int owner = g / slice;
    hopper::st_async_f4(hopper::cluster_addr(recv + (rank * slice + g % slice) * 4, owner), v,
                        hopper::cluster_addr(xbar, owner));
  }

  hopper::mbar_wait(xbar, 0);
  for (int i = threadIdx.x; i < slice; i += THREADS) {
    const int g = rank * slice + i;
    const int m = g / (TILE_N / 4), n = (g % (TILE_N / 4)) * 4;
    const int gm = m0 + m, gn = n0 + n;
    if (gm >= M || gn >= N) continue;
    float4 u[MAX_CLUSTER];  // all S loads in flight, then the adds in rank order
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < splits) u[r] = *reinterpret_cast<const float4*>(recv + (r * slice + i) * 4);
    float4 acc = u[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < splits) {
        acc.x += u[r].x;
        acc.y += u[r].y;
        acc.z += u[r].z;
        acc.w += u[r].w;
      }
    const float4 bv = *reinterpret_cast<const float4*>(bias + n);
    const float o[4] = {relu_nan(acc.x + bv.x), relu_nan(acc.y + bv.y),
                        relu_nan(acc.z + bv.z), relu_nan(acc.w + bv.w)};
    T* dst = out + (size_t)gm * N + gn;
    if constexpr (!VEC_OUT) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gn + q < N) dst[q] = from_f32<T>(o[q]);
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(dst) = pk;
    }
  }
}

// Arms this CTA's exchange barrier (thread 0, before the CTA's first
// __syncthreads and cluster_arrive): one arrival, this one, and the bytes
// of every CTA's slice.
template <int BM>
__device__ __forceinline__ void exchange_init(uint64_t* xbar) {
  hopper::mbar_init(xbar, 1);
  hopper::mbar_arrive_expect_tx(xbar, BM * TILE_N * 4);
}

// Grid (S, N tiles, M tiles), cluster (S, 1, 1): the S CTAs of a cluster
// share one output tile and split its K. S is a power of two.
template <typename T, int BM>
__global__ void __launch_bounds__(TmaShape<T, BM>::THREADS, 2)
fdr_tma_kernel(const __grid_constant__ CUtensorMap map_w,
               const __grid_constant__ CUtensorMap map_x, const T* __restrict__ b,
               T* __restrict__ out, int M, int N, int K, int stages) {
  using S = TmaShape<T, BM>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled TMA tiles want 1024-byte alignment; the host adds the slack
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay(S::STAGE, stages, S::PARTIAL, BM);
  float* partial = reinterpret_cast<float*>(ring);  // reuses the ring after the loop
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + lay.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(ring + lay.empty);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(ring + lay.xbar);
  float* bias = reinterpret_cast<float*>(ring + lay.bias);
  float* recv = reinterpret_cast<float*>(ring + lay.recv);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int chunks = (K + S::BK - 1) / S::BK;
  const int c0 = split_begin(rank, splits, chunks);
  const int n_chunks = split_begin(rank + 1, splits, chunks) - c0;
  const int n0 = blockIdx.y * TILE_N, m0 = blockIdx.z * BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], S::EMPTY_ARRIVALS);
    }
    exchange_init<BM>(xbar);
    hopper::mbar_fence_init();
  } else if (threadIdx.x == S::CONSUMERS) {
    hopper::tma_prefetch_map(&map_w);
    hopper::tma_prefetch_map(&map_x);
  }
  __syncthreads();
  hopper::cluster_arrive();  // this CTA's barriers are ready for the cluster

  if (threadIdx.x >= S::CONSUMERS) {  // the producer warp
    const int lane = threadIdx.x - S::CONSUMERS;
    if (lane == 0) {  // keeps the ring full with TMA loads
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % stages;
        if (i >= stages) hopper::mbar_wait(&empty[s], (i / stages - 1) & 1);
        hopper::mbar_arrive_expect_tx(&full[s], S::STAGE);
        const int k = (c0 + i) * S::BK;
        unsigned char* dst = ring + s * S::STAGE;
        hopper::tma_load_2d(dst, &map_w, &full[s], n0, k);
        hopper::tma_load_2d(dst + S::W_BYTES, &map_x, &full[s], k, m0);
      }
    } else {  // the other lanes fetch the bias while the loop runs
      for (int j = lane - 1; j < TILE_N; j += 31)
        bias[j] = n0 + j < N ? to_f32(b[n0 + j]) : 0.f;
    }
    __syncwarp();
  } else if constexpr (sizeof(T) == 2) {
    consume_bf16<BM>(ring, full, empty, n_chunks, stages, partial);
  } else {
    consume_f32<BM>(ring, full, empty, n_chunks, stages, partial);
  }
  exchange_and_store<T, BM, S::THREADS, S::PARTS, true>(partial, recv, xbar, bias, out, rank,
                                                         splits, m0, n0, M, N);
}

// ==================================================== variant "simt"
constexpr int SIMT_BN = 64;  // output columns per block
constexpr int SIMT_BK = 32;  // K depth staged per shared-memory round

// Stage a ROWS x COLS tile of a row-major source (leading dimension ld)
// into shared memory: dst[r * lds + c], or dst[c * lds + r] when
// TRANSPOSE. Elements at row >= row_end or col >= col_end read as zero.
// With `vec` each thread moves 16-byte vectors along a row; the caller
// guarantees that col0, col_end and ld are multiples of the vector width
// and that src is 16-byte aligned, so a vector lies wholly in range or
// wholly out. Without it, one element at a time. Each thread issues all
// its loads before its first store, so they are in flight together.
template <typename T, int ROWS, int COLS, int THREADS, bool TRANSPOSE>
__device__ __forceinline__ void stage_tile(T* dst, int lds, const T* __restrict__ src,
                                           int ld, int row0, int row_end, int col0,
                                           int col_end, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  static_assert(COLS % VEC == 0, "a tile row holds whole vectors");
  if (vec) {
    constexpr int ITEMS = ROWS * (COLS / VEC), PER = (ITEMS + THREADS - 1) / THREADS;
    uint4 v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int gr = row0 + i / (COLS / VEC), gc = col0 + (i % (COLS / VEC)) * VEC;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < ITEMS && gr < row_end && gc < col_end)
        v[j] = *reinterpret_cast<const uint4*>(src + (size_t)gr * ld + gc);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / (COLS / VEC), c = (i % (COLS / VEC)) * VEC;
      if (i >= ITEMS) break;
      if constexpr (TRANSPOSE) {
        const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
        for (int q = 0; q < VEC; ++q) dst[(c + q) * lds + r] = e[q];
      } else {
        *reinterpret_cast<uint4*>(dst + r * lds + c) = v[j];
      }
    }
  } else {
    constexpr int ITEMS = ROWS * COLS, PER = (ITEMS + THREADS - 1) / THREADS;
    T v[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int gr = row0 + i / COLS, gc = col0 + i % COLS;
      v[j] = (i < ITEMS && gr < row_end && gc < col_end) ? src[(size_t)gr * ld + gc]
                                                        : from_f32<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * THREADS, r = i / COLS, c = i % COLS;
      if (i >= ITEMS) break;
      dst[TRANSPOSE ? c * lds + r : r * lds + c] = v[j];
    }
  }
}

// True when rows of length `ld` starting at `p` can be read as 16-byte
// vectors.
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int ld) {
  return ld % (16 / (int)sizeof(T)) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Dynamic shared memory of variant "simt", in order: the partial tile
// [BM][LDP] when the kernel has no static tile to reuse for it; the
// exchange barrier; the tile's 64 bias values; the exchange buffer.
struct SimtLayout {
  int xbar, bias, recv, bytes;
  __host__ __device__ SimtLayout(int bm, bool partial) {
    xbar = partial ? bm * LDP * 4 : 0;
    bias = xbar + 16;
    recv = bias + TILE_N * 4;
    bytes = recv + bm * TILE_N * 4;
  }
};

// The K range [begin, end) of split `rank` of `splits`, in whole
// SIMT_BK-deep chunks (the last ends at K).
__device__ __forceinline__ int2 simt_k_range(int rank, int splits, int K) {
  const int chunks = (K + SIMT_BK - 1) / SIMT_BK;
  const int end = split_begin(rank + 1, splits, chunks) * SIMT_BK;
  return make_int2(split_begin(rank, splits, chunks) * SIMT_BK, end < K ? end : K);
}

// Grid (S, N tiles, M tiles), cluster (S, 1, 1), as in variant "tma".
// f32: plain FMA; a 16 x 16 grid of threads, each a (BM/16) x 4 tile.
constexpr int SIMT_F32_THREADS = 256;

template <int BM>
__global__ void __launch_bounds__(SIMT_F32_THREADS)
fdr_f32_simt(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ out, int M, int N, int K) {
  constexpr int TM = BM / 16;
  __shared__ float As[SIMT_BK][BM + 1];  // x tile, transposed; +1 breaks bank conflicts
  __shared__ __align__(16) float Bs[SIMT_BK][SIMT_BN];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SimtLayout lay(BM, true);
  float* partial = reinterpret_cast<float*>(smem_raw);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem_raw + lay.xbar);
  float* bias = reinterpret_cast<float*>(smem_raw + lay.bias);
  float* recv = reinterpret_cast<float*>(smem_raw + lay.recv);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int2 kr = simt_k_range(rank, splits, K);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.y * SIMT_BN, m0 = blockIdx.z * BM;
  const bool active = m0 + ty < M;  // rows ty + 16*i; the first decides
  const bool vec_x = vec_ok(x, K), vec_w = vec_ok(w, N);

  if (tid == 0) {
    exchange_init<BM>(xbar);
    hopper::mbar_fence_init();
  }
  if (tid < TILE_N) bias[tid] = n0 + tid < N ? b[n0 + tid] : 0.f;
  __syncthreads();
  hopper::cluster_arrive();

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kr.x; k0 < kr.y; k0 += SIMT_BK) {
    stage_tile<float, BM, SIMT_BK, SIMT_F32_THREADS, true>(&As[0][0], BM + 1, x, K, m0, M,
                                                            k0, kr.y, vec_x);
    stage_tile<float, SIMT_BK, SIMT_BN, SIMT_F32_THREADS, false>(&Bs[0][0], SIMT_BN, w, N,
                                                                  k0, kr.y, n0, N, vec_w);
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < SIMT_BK; ++kk) {
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
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) partial[(ty + 16 * i) * LDP + tx + 16 * j] = acc[i][j];
  exchange_and_store<float, BM, SIMT_F32_THREADS, 1, false>(partial, recv, xbar, bias, out,
                                                            rank, splits, m0, n0, M, N);
}

// bf16: WMMA 16x16x16 fragments with f32 accumulation; warp j owns
// output columns [16j, 16j+16) of the 64-wide tile.
constexpr int SIMT_BF16_THREADS = 128;

template <int BM>
__global__ void __launch_bounds__(SIMT_BF16_THREADS)
fdr_bf16_simt(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
              const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int M,
              int N, int K) {
  using namespace nvcuda;
  constexpr int FM = BM / 16;                           // 16-row fragments per warp
  constexpr int LDA = SIMT_BK + 8, LDB = SIMT_BN + 8;   // bf16 strides: multiples of 8
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[SIMT_BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDP];         // the partial tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SimtLayout lay(BM, false);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem_raw + lay.xbar);
  float* bias = reinterpret_cast<float*>(smem_raw + lay.bias);
  float* recv = reinterpret_cast<float*>(smem_raw + lay.recv);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank(), splits = (int)cluster.num_blocks();
  const int2 kr = simt_k_range(rank, splits, K);
  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.y * SIMT_BN, m0 = blockIdx.z * BM;
  const bool vec_x = vec_ok(x, K), vec_w = vec_ok(w, N);

  if (tid == 0) {
    exchange_init<BM>(xbar);
    hopper::mbar_fence_init();
  }
  if (tid < TILE_N) bias[tid] = n0 + tid < N ? __bfloat162float(b[n0 + tid]) : 0.f;
  __syncthreads();
  hopper::cluster_arrive();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM];
#pragma unroll
  for (int f = 0; f < FM; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = kr.x; k0 < kr.y; k0 += SIMT_BK) {
    stage_tile<__nv_bfloat16, BM, SIMT_BK, SIMT_BF16_THREADS, false>(As, LDA, x, K, m0, M,
                                                                      k0, kr.y, vec_x);
    stage_tile<__nv_bfloat16, SIMT_BK, SIMT_BN, SIMT_BF16_THREADS, false>(
        Bs, LDB, w, N, k0, kr.y, n0, N, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SIMT_BK; kk += 16) {
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
    wmma::store_matrix_sync(Cs + f * 16 * LDP + warp * 16, acc[f], LDP, wmma::mem_row_major);
  exchange_and_store<__nv_bfloat16, BM, SIMT_BF16_THREADS, 1, false>(Cs, recv, xbar, bias, out,
                                                                     rank, splits, m0, n0, M, N);
}

// ================================================================ host
// The dynamic shared memory a launch of variant "tma" may ask for (the
// card's per-block maximum); launches aim for SMEM_TARGET.
constexpr int SMEM_LIMIT = 227 * 1024;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// A 2-D row-major tensor [outer, inner] read in boxes [box_outer, box_inner],
// laid out in shared memory with the 128-byte swizzle when `swizzle`.
int make_map(CUtensorMap* map, bool bf16, const void* ptr, int inner, int outer,
             int box_inner, int box_outer, bool swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return FDR_ERR_TENSOR_MAP + (int)CUDA_ERROR_NOT_FOUND;
  const int es = bf16 ? 2 : 4;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)inner * es};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t unit[2] = {1, 1};
  CUresult r = encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      2, const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FDR_ERR_TENSOR_MAP + (int)r;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the 48 KB
// default) on `device`, once per device; `mu` and `done` belong to the
// caller's instantiation.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int device, std::mutex& mu, uint64_t& done) {
  std::lock_guard<std::mutex> lock(mu);
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (done >> device & 1) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done |= uint64_t(1) << device;
  return (int)e;
}

// A launch attribute that groups `splits` CTAs along x into a cluster.
cudaLaunchAttribute cluster_attr(int splits) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// The ring's depth for a split of K over `splits` CTAs: as many stages as
// a split has chunks, up to MAX_STAGES and while the launch stays under
// SMEM_TARGET, then rounded down to a multiple of the consumer
// warpgroups that take turns on chunks (at least WGS), so that each
// stage has one reader warpgroup on every lap (consume_f32).
template <typename T, int BM>
int tma_stages(int K, int splits) {
  using S = TmaShape<T, BM>;
  const int chunks = (K + S::BK - 1) / S::BK;
  const int per_split = (chunks + splits - 1) / splits;
  int stages = per_split < MAX_STAGES ? per_split : MAX_STAGES;
  while (stages > 1 && Layout(S::STAGE, stages, S::PARTIAL, BM).bytes > SMEM_TARGET) --stages;
  stages -= stages % S::WGS;
  return stages > S::WGS ? stages : S::WGS;
}

// The launch of variant "tma" for an [M,K] @ [K,N] product split over
// `splits` CTAs per cluster.
template <typename T, int BM>
int launch_tma(const void* x, const void* w, const void* b, void* out, int M, int N, int K,
               int splits, int device, cudaStream_t st) {
  using S = TmaShape<T, BM>;
  auto kernel = fdr_tma_kernel<T, BM>;
  static std::mutex mu;
  static uint64_t done = 0;
  if (int err = allow_smem(kernel, SMEM_LIMIT, device, mu, done)) return err;
  const int stages = tma_stages<T, BM>(K, splits);
  if (stages % S::WGS != 0) return (int)cudaErrorInvalidValue;  // consume_f32's invariant

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + TILE_N - 1) / TILE_N, (M + BM - 1) / BM);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = Layout(S::STAGE, stages, S::PARTIAL, BM).bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr = cluster_attr(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  CUtensorMap map_w, map_x;
  // w: 128-byte rows swizzled for wgmma in bf16, 256-byte rows as they are
  // in f32; x: 128-byte rows, swizzled in both
  int err = make_map(&map_w, sizeof(T) == 2, w, N, K, TILE_N, S::BK, sizeof(T) == 2);
  if (err == 0) err = make_map(&map_x, sizeof(T) == 2, x, K, M, S::BK, BM, true);
  if (err != 0) return err;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, map_w, map_x, static_cast<const T*>(b),
                                     static_cast<T*>(out), M, N, K, stages);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int dispatch_tma(const void* x, const void* w, const void* b, void* out, int M, int N, int K,
                 int block_m, int splits, int device, cudaStream_t st) {
  switch (block_m) {
    case 8: return launch_tma<T, 8>(x, w, b, out, M, N, K, splits, device, st);
    case 16: return launch_tma<T, 16>(x, w, b, out, M, N, K, splits, device, st);
    case 32: return launch_tma<T, 32>(x, w, b, out, M, N, K, splits, device, st);
    case 64: return launch_tma<T, 64>(x, w, b, out, M, N, K, splits, device, st);
    case 128:  // bf16 only: f32 takes 64-row tiles past 64 rows
      if constexpr (sizeof(T) == 2)
        return launch_tma<T, 128>(x, w, b, out, M, N, K, splits, device, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch of variant "simt", K split over `splits` CTAs per cluster.
template <typename T, int BM>
int launch_simt(const void* x, const void* w, const void* b, void* out, int M, int N, int K,
                int splits, int device, cudaStream_t st) {
  constexpr bool f32 = sizeof(T) == 4;
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int);
  if constexpr (f32)
    kernel = fdr_f32_simt<BM>;
  else
    kernel = fdr_bf16_simt<BM>;
  const SimtLayout lay(BM, f32);
  static std::mutex mu;
  static uint64_t done = 0;
  if (int err = allow_smem(kernel, lay.bytes, device, mu, done)) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + SIMT_BN - 1) / SIMT_BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(f32 ? SIMT_F32_THREADS : SIMT_BF16_THREADS);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr = cluster_attr(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                     static_cast<const T*>(w), static_cast<const T*>(b),
                                     static_cast<T*>(out), M, N, K);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The checks the host side of ops/fused_dense.py `launch_config` makes.
bool args_ok(int dtype, int variant, const void* x, const void* w, int M, int N, int K,
             int block_m, int cluster) {
  if (M < 1 || N < 1 || K < 1 || (dtype != 0 && dtype != 1)) return false;
  const bool pow2 = cluster >= 1 && (cluster & (cluster - 1)) == 0 && cluster <= MAX_CLUSTER;
  if (variant == 1)
    return (block_m == 16 || block_m == 64) && pow2 && cluster <= (K + SIMT_BK - 1) / SIMT_BK;
  if (variant != 0) return false;
  const int es = dtype == 1 ? 2 : 4, bk = dtype == 1 ? 64 : 32;
  const bool bm_ok = block_m == 8 || block_m == 16 || block_m == 32 || block_m == 64 ||
                     (block_m == 128 && dtype == 1);
  return bm_ok && pow2 && cluster <= (K + bk - 1) / bk &&
         ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0 &&
         ((long long)K * es) % 16 == 0 && ((long long)N * es) % 16 == 0;
}

int set_device(int device) {
  // this library's runtime keeps its own current device: follow the
  // tensors' device (a no-op, safe during graph capture, when it matches)
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return (int)err;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = "tma", 1 = "simt".
// block_m: the M tile; cluster: CTAs per cluster that split K (a power of
// two up to 8). Enqueues one kernel on `stream`. Returns a cudaError_t as
// int, or FDR_ERR_TENSOR_MAP + a CUresult.
int fused_dense_relu_launch(int dtype, int variant, const void* x, const void* w,
                            const void* b, void* out, int M, int N, int K, int block_m,
                            int cluster, int device, void* stream) {
  if (!args_ok(dtype, variant, x, w, M, N, K, block_m, cluster))
    return (int)cudaErrorInvalidValue;
  int err = set_device(device);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1) {
    using bf = __nv_bfloat16;
    if (dtype == 1)
      return block_m == 16 ? launch_simt<bf, 16>(x, w, b, out, M, N, K, cluster, device, st)
                           : launch_simt<bf, 64>(x, w, b, out, M, N, K, cluster, device, st);
    return block_m == 16 ? launch_simt<float, 16>(x, w, b, out, M, N, K, cluster, device, st)
                         : launch_simt<float, 64>(x, w, b, out, M, N, K, cluster, device, st);
  }
  if (dtype == 1)
    return dispatch_tma<__nv_bfloat16>(x, w, b, out, M, N, K, block_m, cluster, device, st);
  return dispatch_tma<float>(x, w, b, out, M, N, K, block_m, cluster, device, st);
}

const char* fused_dense_relu_error_string(int err) {
  if (err >= FDR_ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
