// Signature agreement counts for the SSH probe stage: two kernels.
//
//   batch:  queries (B, K) i32, db (N, K) i32  ->  out (B, N) i32
//           out[b, n] = #{k : db[n, k] == queries[b, k]}
//   single: query (K,) i32, db (N, K) i32  ->  out (N,) i32
//
// Both pad the key axis to KP, K rounded up to a multiple of 8 (a
// compile-time width, up to 64), with the TPU kernel's own sentinels
// (repro/kernels/collision_count.py:30-31): database slots INT32_MIN,
// query slots INT32_MAX.  A padded slot compares the two sentinels and
// never matches, so the hot loops run exactly KP slots with no bounds
// test, and a real key equal to either sentinel still counts as it
// should (the pads sit in the same slots on both sides).  Counts are
// exact integers.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KEY_MAX = 64;                   // widest signature taken
constexpr int DB_PAD = INT32_MIN;             // database-side sentinel
constexpr int Q_PAD = INT32_MAX;              // query-side sentinel

// c += (a == b) as a setp and a predicated add, which ptxas keeps as an
// ISETP and a predicated VIADD: 2 instructions a key.  Written in C, the
// same line became chains of SEL and predicated IMAD.MOV, ~3.3 a key and
// 1.6x the time of the batch kernel on the H100.
__device__ __forceinline__ void match(int& c, int a, int b) {
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}\n"
      : "+r"(c)
      : "r"(a), "r"(b));
}

// Slot k of a row of K real keys, or the sentinel past them.  Only the
// last 7 slots of KP can lie past K, so the test is compile-time for the
// rest.
template <int KP>
__device__ __forceinline__ bool real_slot(int k, int K) {
  return k < KP - 7 || k < K;
}

// ---------------------------------------------------------------------------
// 1. collision_count_batch_kernel replaces the TPU kernel
//    repro/kernels/collision_count.py:68 (collision_count_batch: keys on
//    sublanes, candidates on lanes, grid (N/128, B) with queries
//    innermost), the batched searcher's probe.
//
// Bound on the H100: operations.  2 integer operations a key compared (a
// compare and an add), B·N·K of them: 2·192·1,048,576·40 at the serving
// shape, 0.48 ms at 33.5e12 a second (one per FP32 lane per clock).
// That is also one warp instruction a clock on each SM sub-partition at
// two instructions a compare.  The (B, N) counts, 805 MB at the serving
// shape, take 0.24 ms at 3.35 TB/s and overlap the compares.
//
// Design: each thread keeps R = 2 database rows in registers (KP keys
// each, padded with DB_PAD), rows t and t + 128 of the block's 256, so a
// warp's stores of one query row's counts are 32 consecutive words.  The
// block stages the query rows in shared memory once per 48 KB (all 192
// rows of the serving shape at once, KP keys each, padded with Q_PAD) and
// walks them; each 16-byte shared load is a broadcast (every lane reads
// the same address) that feeds 4 keys x R rows of compares, so the hot
// loop is the compare and the add per key plus one load per 8 keys: 2.26
// SASS instructions a key at KP = 40 (nvcc unrolls two query rows, 160
// keys: 161 ISETP, one of them the loop's test, 153 predicated VIADD and
// 8 SEL for the adds, 20 LDS.128, 4 STG and 16 of loop and addresses).
// Two partial counts per row halve the add chain.  No runtime guard in
// the loop: KP is a template argument.
constexpr int BATCH_THREADS = 128;
constexpr int BATCH_R = 2;                          // rows per thread
constexpr int BATCH_TILE = BATCH_THREADS * BATCH_R; // rows per block
constexpr int QSTAGE_BYTES = 48 * 1024;             // query rows per pass

template <int KP>
__global__ void __launch_bounds__(BATCH_THREADS, KP <= 48 ? 4 : 2)
    collision_count_batch_kernel(const int* __restrict__ q,
                                 const int* __restrict__ db,
                                 int* __restrict__ out, int B, int N, int K,
                                 int qrows) {
  extern __shared__ int4 qs4[];               // qrows x KP/4
  int* qs = reinterpret_cast<int*>(qs4);
  const long long n0 =
      static_cast<long long>(blockIdx.x) * BATCH_TILE + threadIdx.x;

  int row[BATCH_R][KP];
  bool live[BATCH_R];
#pragma unroll
  for (int r = 0; r < BATCH_R; ++r) {
    const long long n = n0 + r * BATCH_THREADS;
    live[r] = n < N;
    const int* src = db + n * K;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      row[r][k] = (live[r] && real_slot<KP>(k, K)) ? __ldg(src + k) : DB_PAD;
  }

  for (int b0 = 0; b0 < B; b0 += qrows) {
    const int nq = min(qrows, B - b0);
    if (b0 > 0) __syncthreads();              // previous pass consumed
    const int* qsrc = q + static_cast<long long>(b0) * K;
    for (int i = threadIdx.x; i < nq * KP; i += BATCH_THREADS) {
      const int j = i / KP, k = i - j * KP;
      qs[i] = k < K ? __ldg(qsrc + j * K + k) : Q_PAD;
    }
    __syncthreads();

    int* o = out + static_cast<long long>(b0) * N + n0;
    for (int j = 0; j < nq; ++j, o += N) {
      const int4* qv = qs4 + j * (KP / 4);
      int c[BATCH_R][2] = {};
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const int4 v = qv[k4];
#pragma unroll
        for (int r = 0; r < BATCH_R; ++r) {
          match(c[r][0], row[r][4 * k4 + 0], v.x);
          match(c[r][1], row[r][4 * k4 + 1], v.y);
          match(c[r][0], row[r][4 * k4 + 2], v.z);
          match(c[r][1], row[r][4 * k4 + 3], v.w);
        }
      }
#pragma unroll
      for (int r = 0; r < BATCH_R; ++r)
        if (live[r]) o[r * BATCH_THREADS] = c[r][0] + c[r][1];
    }
  }
}

template <int KP>
int launch_batch(const int* q, const int* db, int* out, int B, int N, int K,
                 cudaStream_t stream) {
  const int qrows = std::min(B, QSTAGE_BYTES / (KP * 4));
  const int smem = qrows * KP * 4;            // <= 48 KB: no opt-in
  const unsigned grid = static_cast<unsigned>((N + BATCH_TILE - 1) /
                                              BATCH_TILE);
  collision_count_batch_kernel<KP><<<grid, BATCH_THREADS, smem, stream>>>(
      q, db, out, B, N, K, qrows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. collision_count_kernel replaces the TPU kernel
//    repro/kernels/collision_count.py:42 (collision_count: one query, the
//    database transposed to (K, N) with candidates on the 128 lanes), the
//    sequential searcher's probe, launched once per multiprobe row.
//
// Bound on the H100: bytes.  N·K·4 bytes of database read once and N·4
// bytes of counts written: 168 MB + 4 MB at N = 2^20, K = 40, 0.051 ms at
// 3.35 TB/s; the 2·N·K compares and adds are 40x below the int32 rate.
//
// Design: a persistent grid, one block a SM (its ring takes most of the
// shared memory), walks tiles of ONE_TILE = 256 rows.  A tile of the
// row-major (N, K) matrix is one contiguous span of 256·K words, so one
// thread moves it with one 1-D bulk copy (cp.async.bulk, the TMA's
// tensor-map-free form) into a ring of up to 8 stages, completion counted
// on the stage's mbarrier; the ring holds 220 KB, 5 stages of 41 KB at
// K = 40, so 4 tiles (164 KB a SM) stay in flight while one is compared.
// A bulk copy wants a 16-byte-aligned source and a size that is a
// multiple of 16: the span is widened to the aligned words at or below
// its start and at or above its end (never past the 16-byte chunks that
// hold real keys, so never outside a page the tensor touches), and the
// rows are read at the word offset that leaves.  This takes any view,
// db[5:] at K = 33 included.  Each thread then compares its row with the
// query in registers (KP keys, padded with Q_PAD), reading the row with
// 16-byte shared loads where K % 4 == 0 and the base is aligned (VEC;
// 2-way bank conflicts at K = 40, shared memory has ~10x the HBM rate),
// else word by word; slots past K read DB_PAD.  Consecutive threads write
// consecutive counts.
constexpr int ONE_TILE = 256;                 // rows per tile (= threads)
constexpr int ONE_MAX_STAGES = 8;
constexpr int ONE_RING_BYTES = 220 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity ``parity`` has completed; a copy that
// never lands traps (a launch error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// words of one ring stage: the tile, up to 3 words of lead and 3 of tail
// from the alignment, and the up to 7 slots the last row reads past K
__host__ __device__ constexpr int one_stage_words(int K) {
  return (ONE_TILE * K + 16 + 31) / 32 * 32;
}

template <int KP, bool VEC>
__global__ void __launch_bounds__(ONE_TILE, 1)
    collision_count_kernel(const int* __restrict__ q,
                           const int* __restrict__ db, int* __restrict__ out,
                           int N, int K, int stages) {
  extern __shared__ __align__(128) int ring[];
  __shared__ __align__(8) uint64_t full[ONE_MAX_STAGES];
  const int stage_words = one_stage_words(K);
  // db is 4-byte aligned; ``a`` words lie between it and the 16-byte
  // aligned address below, from which every span is counted
  const int a = static_cast<int>((reinterpret_cast<uintptr_t>(db) & 15) >> 2);
  const int* base = db - a;
  const int tiles = (N + ONE_TILE - 1) / ONE_TILE;

  int qk[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) qk[k] = k < K ? __ldg(q + k) : Q_PAD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile ``t`` into stage ``s``: words [w0, w1) of ``base``, widened to
  // 16-byte boundaries
  auto issue = [&](int t, int s) {
    const long long w0 = static_cast<long long>(t) * ONE_TILE * K + a;
    const long long rows_end =
        min(static_cast<long long>(t + 1) * ONE_TILE,
            static_cast<long long>(N));
    const long long w1 = rows_end * K + a;
    const long long s0 = w0 & ~3LL, s1 = (w1 + 3) & ~3LL;
    const uint32_t bytes = static_cast<uint32_t>((s1 - s0) * 4);
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + s * stage_words), base + s0, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < tiles) issue(t, s);
    }
  }

  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int s = it % stages;
    mbar_wait(smem_u32(&full[s]), (it / stages) & 1);
    const long long n = static_cast<long long>(t) * ONE_TILE + threadIdx.x;
    if (n < N) {
      const int off = static_cast<int>(
          (static_cast<long long>(t) * ONE_TILE * K + a) & 3);
      const int* row = ring + s * stage_words + off + threadIdx.x * K;
      int c0 = 0, c1 = 0;
      if (VEC) {
        const int4* row4 = reinterpret_cast<const int4*>(row);
#pragma unroll
        for (int k4 = 0; k4 < KP / 4; ++k4) {
          const int4 v = row4[k4];
          const int k = 4 * k4;
          match(c0, real_slot<KP>(k + 0, K) ? v.x : DB_PAD, qk[k + 0]);
          match(c1, real_slot<KP>(k + 1, K) ? v.y : DB_PAD, qk[k + 1]);
          match(c0, real_slot<KP>(k + 2, K) ? v.z : DB_PAD, qk[k + 2]);
          match(c1, real_slot<KP>(k + 3, K) ? v.w : DB_PAD, qk[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < KP; k += 2) {
          match(c0, real_slot<KP>(k, K) ? row[k] : DB_PAD, qk[k]);
          match(c1, real_slot<KP>(k + 1, K) ? row[k + 1] : DB_PAD,
                qk[k + 1]);
        }
      }
      out[n] = c0 + c1;
    }
    __syncthreads();                          // every row of stage s read
    if (threadIdx.x == 0) {
      const int next = t + stages * gridDim.x;
      if (next < tiles) {
        // order this block's reads of the stage before the copy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(next, s);
      }
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int KP, bool VEC>
int launch_one_as(const int* q, const int* db, int* out, int N, int K,
                  cudaStream_t stream) {
  const int stage_bytes = one_stage_words(K) * 4;
  const int stages =
      std::max(2, std::min(ONE_MAX_STAGES, ONE_RING_BYTES / stage_bytes));
  const int smem = stages * stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      collision_count_kernel<KP, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (N + ONE_TILE - 1) / ONE_TILE;
  const unsigned grid = static_cast<unsigned>(std::min(tiles, sm_count()));
  collision_count_kernel<KP, VEC><<<grid, ONE_TILE, smem, stream>>>(
      q, db, out, N, K, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
int launch_one(const int* q, const int* db, int* out, int N, int K,
               cudaStream_t stream) {
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(db) & 15) == 0;
  return vec ? launch_one_as<KP, true>(q, db, out, N, K, stream)
             : launch_one_as<KP, false>(q, db, out, N, K, stream);
}

}  // namespace

// Widest signature the kernels take; the wrapper refuses wider ones.
extern "C" int collision_count_max_k() { return KEY_MAX; }

// Both dispatch on KP = K rounded up to a multiple of 8.
extern "C" int collision_count_batch_launch(const int* q, const int* db,
                                            int* out, int B, int N, int K,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K > 0 ? (K + 7) / 8 : 0) {
    case 1: return launch_batch<8>(q, db, out, B, N, K, s);
    case 2: return launch_batch<16>(q, db, out, B, N, K, s);
    case 3: return launch_batch<24>(q, db, out, B, N, K, s);
    case 4: return launch_batch<32>(q, db, out, B, N, K, s);
    case 5: return launch_batch<40>(q, db, out, B, N, K, s);
    case 6: return launch_batch<48>(q, db, out, B, N, K, s);
    case 7: return launch_batch<56>(q, db, out, B, N, K, s);
    case 8: return launch_batch<64>(q, db, out, B, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int collision_count_launch(const int* q, const int* db, int* out,
                                      int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K > 0 ? (K + 7) / 8 : 0) {
    case 1: return launch_one<8>(q, db, out, N, K, s);
    case 2: return launch_one<16>(q, db, out, N, K, s);
    case 3: return launch_one<24>(q, db, out, N, K, s);
    case 4: return launch_one<32>(q, db, out, N, K, s);
    case 5: return launch_one<40>(q, db, out, N, K, s);
    case 6: return launch_one<48>(q, db, out, N, K, s);
    case 7: return launch_one<56>(q, db, out, N, K, s);
    case 8: return launch_one<64>(q, db, out, N, K, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* collision_count_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
