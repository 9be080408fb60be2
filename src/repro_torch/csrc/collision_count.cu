// Signature agreement counts for the SSH probe stage: two kernels.
//
// 1. collision_count_batch_kernel replaces the TPU kernel
//    repro/kernels/collision_count.py::collision_count_batch (keys on
//    sublanes, candidates on lanes, grid (N/128, B) with queries
//    innermost); the batched searcher's probe.
// 2. collision_count_kernel replaces
//    repro/kernels/collision_count.py::collision_count (one query, the
//    database transposed to (K, N) with candidates on the 128 lanes); the
//    sequential searcher's probe, launched once per multiprobe row.  Its
//    note is above the kernel.
//
//   queries (B, K) i32, db (N, K) i32  ->  out (B, N) i32
//   out[b, n] = #{k : db[n, k] == queries[b, k]}
//
// Bound on the H100: memory.  The kernel reads N*K*4 bytes of database
// once per batch and writes B*N*4 bytes of counts; at the serving shape
// (B = 192 probe rows, K = 40) the count matrix is five times the
// database, so the write dominates.
//
// Design: one block takes a tile of TILE_N database rows.  The tile is
// staged through shared memory with coalesced loads, then each thread
// copies its own row into registers (KMAX-wide, unrolled, so the row
// never touches local memory).  The block then walks the B query rows,
// staged QCHUNK at a time in shared memory where every thread reads the
// same word (a broadcast), and each thread writes its row's count for
// every query: consecutive threads write consecutive n, so every store is
// coalesced.  The database therefore streams from device memory once per
// batch, as on the TPU.  Counts are exact integers.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 128;   // database rows per block (= threads)
constexpr int QCHUNK = 32;    // query rows staged per pass

template <int KMAX>
__global__ void collision_count_batch_kernel(const int* __restrict__ q,
                                             const int* __restrict__ db,
                                             int* __restrict__ out,
                                             int B, int N, int K) {
  __shared__ int tile[TILE_N * (KMAX + 1)];   // +1: conflict-free row reads
  __shared__ int qs[QCHUNK * KMAX];

  const long long n0 = static_cast<long long>(blockIdx.x) * TILE_N;
  const int rows = static_cast<int>(min(static_cast<long long>(TILE_N), N - n0));
  const int stride = KMAX + 1;

  for (int idx = threadIdx.x; idx < rows * K; idx += blockDim.x) {
    const int r = idx / K, k = idx - r * K;
    tile[r * stride + k] = db[n0 * K + idx];
  }
  __syncthreads();

  int row[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    row[k] = (k < K && threadIdx.x < rows) ? tile[threadIdx.x * stride + k] : 0;

  for (int b0 = 0; b0 < B; b0 += QCHUNK) {
    const int nq = min(QCHUNK, B - b0);
    __syncthreads();   // previous chunk fully consumed
    for (int idx = threadIdx.x; idx < nq * K; idx += blockDim.x) {
      const int r = idx / K, k = idx - r * K;
      qs[r * KMAX + k] = q[static_cast<long long>(b0) * K + idx];
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      for (int j = 0; j < nq; ++j) {
        const int* qr = qs + j * KMAX;
        int cnt = 0;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) cnt += (row[k] == qr[k]);
        out[static_cast<long long>(b0 + j) * N + n0 + threadIdx.x] = cnt;
      }
    }
  }
}

template <int KMAX>
int launch(const int* q, const int* db, int* out, int B, int N, int K,
           cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((N + TILE_N - 1) / TILE_N);
  collision_count_batch_kernel<KMAX><<<grid, TILE_N, 0, stream>>>(
      q, db, out, B, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Single query: q (K,) i32, db (N, K) i32  ->  out (N,) i32.
//
// Bound on the H100: memory.  N*K*4 bytes of database are read once and
// N*4 bytes of counts written (168 MB + 4 MB at N = 2^20, K = 40: about
// 0.05 ms at 3.35 TB/s); the K compares and adds per row are ~40x below
// the int32 rate.  So the design is about reading the row-major (N, K)
// matrix at full width.  A thread per row reading its own 160 bytes
// would touch 32 rows, 32 different lines, per warp load.  Instead each
// warp copies whole rows of a ONE_TILE-row tile into shared memory, the
// lanes over the row's K consecutive keys, so every warp load reads
// consecutive words; the row stride in shared memory is odd (K | 1) so
// that afterwards thread t walking row t hits 32 distinct banks.  The
// query sits in registers (KMAX unrolled), each thread writes its row's
// count, and consecutive threads write consecutive n.  The copy loop is
// unrolled so that each warp has several rows in flight.
constexpr int ONE_TILE = 256;   // database rows per block (= threads)

template <int KMAX>
__global__ void collision_count_kernel(const int* __restrict__ q,
                                       const int* __restrict__ db,
                                       int* __restrict__ out, int N, int K) {
  extern __shared__ int rows_s[];
  const int stride = K | 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const long long n0 = static_cast<long long>(blockIdx.x) * ONE_TILE;
  const int rows = static_cast<int>(min(static_cast<long long>(ONE_TILE),
                                        N - n0));
  const int* src = db + n0 * K;

#pragma unroll 4
  for (int r = warp; r < rows; r += nwarps) {
#pragma unroll
    for (int k0 = 0; k0 < KMAX; k0 += 32) {
      const int k = k0 + lane;
      if (k < K) rows_s[r * stride + k] = src[static_cast<long long>(r) * K + k];
    }
  }

  int qk[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) qk[k] = k < K ? __ldg(q + k) : 0;
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const int* row = rows_s + t * stride;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < K) cnt += (row[k] == qk[k]);
    out[n0 + t] = cnt;
  }
}

template <int KMAX>
int launch_one(const int* q, const int* db, int* out, int N, int K,
               cudaStream_t stream) {
  const int smem = ONE_TILE * (K | 1) * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        collision_count_kernel<KMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((N + ONE_TILE - 1) / ONE_TILE);
  collision_count_kernel<KMAX><<<grid, ONE_TILE, smem, stream>>>(q, db, out,
                                                                 N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Widest signature the kernel takes; the wrapper refuses wider ones.
extern "C" int collision_count_max_k() { return 64; }

extern "C" int collision_count_batch_launch(const int* q, const int* db,
                                            int* out, int B, int N, int K,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 16) return launch<16>(q, db, out, B, N, K, s);
  if (K <= 32) return launch<32>(q, db, out, B, N, K, s);
  if (K <= 64) return launch<64>(q, db, out, B, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int collision_count_launch(const int* q, const int* db, int* out,
                                      int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 16) return launch_one<16>(q, db, out, N, K, s);
  if (K <= 32) return launch_one<32>(q, db, out, N, K, s);
  if (K <= 64) return launch_one<64>(q, db, out, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* collision_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
