// Banded squared DTW for the SSH re-rank stage: two kernels over one
// warp-per-pair device routine (dtw_warp).
//
// 1. dtw_pairs_kernel replaces the TPU kernel
//    repro/kernels/dtw_wavefront.py::dtw_wavefront_pairs (_kernel,
//    _kernel_thr, _make_step: pairs on the 128 lanes, band offsets on
//    sublanes, one vector op per anti-diagonal, a whole-block exit test);
//    the batched searcher's seed and survivor DTW.
//
//      queries (P, m) f32, candidates (P, m) f32, radius r, thr (P,) or
//      none  ->  out (P,) f32
//      out[p] = banded (|i - j| <= r) squared DTW of the pair; with thr,
//      the exact cost when it is <= thr[p] and BIG = 1e30 otherwise.
//
// 2. dtw_one_kernel replaces repro/kernels/dtw_wavefront.py::dtw_wavefront
//    (one query against a candidate block, the same lane layout); the
//    sequential re-rank and the UCR-suite scan.
//
//      query (m,) f32, candidates (C, m) f32, radius r, thr scalar, (C,)
//      or none  ->  out (C,) f32, the same contract per candidate.
//
//    It runs the same dtw_warp, so its values are bit-identical to the
//    pairs kernel and to the plain wavefront.  The query is loaded into
//    shared memory once per block and read by all ONE_WARPS warps, each
//    of which owns one candidate row; a block holds 16 warps (the pairs
//    kernel holds 4, each with its own query row), so a 512-long query
//    costs 2 KB of a 34 KB block.  Bound and limit are the pairs
//    kernel's, below; the UCR scan, at hundreds of thousands of
//    candidates, is where the kernel's own rate shows.
//
// Bound on the H100: operations.  About 6 flops per DP cell (a subtract,
// a multiply, an add and three mins) over P*m*(2r+1) cells, minus the
// cells an early-abandoned pair never computes, against only 8*P*m bytes
// of input.
//
// Design: one warp per pair, so abandoning is per pair and never holds
// a neighbour back (the TPU kernel could only leave a 128-lane block
// when all of its lanes were dead).  The query and candidate rows sit in
// shared memory.  The Sakoe-Chiba band slots u in [0, 2r+2) of one
// anti-diagonal lie across the lanes in blocks of S consecutive slots
// (S = 2 at r = 25, 7 at r = 102), held in registers.  The wavefront
// walks the 2m-1 anti-diagonals with the TPU kernel's index algebra:
// diagonal d stores cell (i, j = d - i) at u = i - (d/2 - r), so
//   D[i-1, j]   = prev1[u]   (d even) / prev1[u-1] (d odd)
//   D[i, j-1]   = prev1[u+1] (d even) / prev1[u]   (d odd)
//   D[i-1, j-1] = prev2[u]
// and the answer sits at u = r on the last diagonal.  The one-slot
// shifts cross a lane boundary only at the block edges, which one
// __shfl_up_sync and one __shfl_down_sync per diagonal supply.  The cell
// update is __fadd_rn(__fmul_rn(diff, diff), best) with diff from
// __fsub_rn: the explicit round-to-nearest intrinsics keep nvcc from
// contracting into an FMA, so every value is the one the plain PyTorch
// wavefront computes, bit for bit.  With a threshold, the warp takes the
// minimum over the two live diagonals after each step (a sound lower
// bound on the final cost: every warping path crosses one of any two
// adjacent anti-diagonals) and abandons once it exceeds thr, strictly.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;             // pairs per block (dtw_pairs_kernel)
constexpr int ONE_WARPS = 16;        // candidates per block (dtw_one_kernel)
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

// One warp's banded DTW of the rows qs, xs (both in shared memory).
// Returns the result on every lane: the exact cost, or BIG when has_thr
// and the pair was abandoned or ends above t.
template <int S>
__device__ __forceinline__ float dtw_warp(const float* qs, const float* xs,
                                          int m, int r, bool has_thr,
                                          float t, int lane) {
  const int bw = 2 * r + 2;

  float prev1[S], prev2[S];
#pragma unroll
  for (int s = 0; s < S; ++s) prev1[s] = prev2[s] = BIG;

  bool abandoned = false;
  for (int d = 0; d < 2 * m - 1; ++d) {
    const int offset = d / 2 - r;
    const bool even = (d & 1) == 0;
    // prev1[u-1] for this lane's first slot, prev1[u+1] for its last
    float from_below = __shfl_up_sync(FULL, prev1[S - 1], 1);
    float from_above = __shfl_down_sync(FULL, prev1[0], 1);
    if (lane == 0) from_below = BIG;
    if (lane == 31) from_above = BIG;

    float cur[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int u = lane * S + s;
      const int i = offset + u;
      const int j = d - i;
      const float down = s > 0 ? prev1[s - 1] : from_below;      // a[u-1]
      const float up = s < S - 1 ? prev1[s + 1] : from_above;    // a[u+1]
      const float top = even ? prev1[s] : down;
      const float left = even ? up : prev1[s];
      float best = fminf(fminf(top, left), prev2[s]);
      if (i == 0 && j == 0) best = 0.0f;
      const bool valid = u < bw && i >= 0 && i < m && j >= 0 && j < m &&
                         abs(i - j) <= r;
      float v = BIG;
      if (valid) {
        const float diff = __fsub_rn(qs[i], xs[j]);
        v = fminf(__fadd_rn(__fmul_rn(diff, diff), best), BIG);
      }
      cur[s] = v;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      prev2[s] = prev1[s];
      prev1[s] = cur[s];
    }

    if (has_thr) {
      float lo = BIG;
#pragma unroll
      for (int s = 0; s < S; ++s) lo = fminf(lo, fminf(prev1[s], prev2[s]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
      if (lo > t) {                  // warp-uniform after the reduction
        abandoned = true;
        break;
      }
    }
  }

  const int owner = r / S, slot = r - owner * S;
  float v = BIG;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s == slot) v = prev1[s];
  v = __shfl_sync(FULL, v, owner);
  if (has_thr && (abandoned || v > t)) v = BIG;
  return v;
}

template <int S>
__global__ void dtw_pairs_kernel(const float* __restrict__ q,
                                 const float* __restrict__ x,
                                 const float* __restrict__ thr,
                                 float* __restrict__ out,
                                 int P, int m, int r) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long p = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (p >= P) return;                // warp-uniform

  float* qs = smem + warp * 2 * m;
  float* xs = qs + m;
  for (int k = lane; k < m; k += 32) {
    qs[k] = q[p * m + k];
    xs[k] = x[p * m + k];
  }
  __syncwarp();

  const bool has_thr = thr != nullptr;
  const float v = dtw_warp<S>(qs, xs, m, r, has_thr,
                              has_thr ? thr[p] : 0.0f, lane);
  if (lane == 0) out[p] = v;
}

// thr_stride 0: one scalar threshold for every candidate; 1: thr[c].
template <int S>
__global__ void dtw_one_kernel(const float* __restrict__ q,
                               const float* __restrict__ x,
                               const float* __restrict__ thr, int thr_stride,
                               float* __restrict__ out, int C, int m, int r) {
  extern __shared__ float smem[];
  float* qs = smem;                                  // m
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = threadIdx.x; k < m; k += blockDim.x) qs[k] = q[k];
  __syncthreads();                   // before any warp may leave

  const long long c = static_cast<long long>(blockIdx.x) * ONE_WARPS + warp;
  if (c >= C) return;                // warp-uniform
  float* xs = smem + m + warp * m;
  for (int k = lane; k < m; k += 32) xs[k] = x[c * m + k];
  __syncwarp();

  const bool has_thr = thr != nullptr;
  const float v = dtw_warp<S>(qs, xs, m, r, has_thr,
                              has_thr ? thr[c * thr_stride] : 0.0f, lane);
  if (lane == 0) out[c] = v;
}

template <int S>
int launch_one(const float* q, const float* x, const float* thr,
               int thr_stride, float* out, int C, int m, int r,
               cudaStream_t stream) {
  const int smem = (ONE_WARPS + 1) * m * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dtw_one_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((C + ONE_WARPS - 1) / ONE_WARPS);
  dtw_one_kernel<S><<<grid, ONE_WARPS * 32, smem, stream>>>(
      q, x, thr, thr_stride, out, C, m, r);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch(const float* q, const float* x, const float* thr, float* out,
           int P, int m, int r, cudaStream_t stream) {
  const int smem = WARPS * 2 * m * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dtw_pairs_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>((P + WARPS - 1) / WARPS);
  dtw_pairs_kernel<S><<<grid, WARPS * 32, smem, stream>>>(q, x, thr, out, P,
                                                          m, r);
  return static_cast<int>(cudaGetLastError());
}

// Calls f.template operator()<S>() with S = band slots per lane for
// radius r (1..8 exactly, then 16, 32, 64); cudaErrorInvalidValue when r
// is too wide.
template <typename F>
int with_slots(int r, F f) {
  const int need = (2 * r + 2 + 31) / 32;
  switch (need) {
    case 1: return f.template operator()<1>();
    case 2: return f.template operator()<2>();
    case 3: return f.template operator()<3>();
    case 4: return f.template operator()<4>();
    case 5: return f.template operator()<5>();
    case 6: return f.template operator()<6>();
    case 7: return f.template operator()<7>();
    case 8: return f.template operator()<8>();
    default: break;
  }
  if (need <= 16) return f.template operator()<16>();
  if (need <= 32) return f.template operator()<32>();
  if (need <= 64) return f.template operator()<64>();
  return static_cast<int>(cudaErrorInvalidValue);
}

struct PairsLaunch {
  const float *q, *x, *thr;
  float* out;
  int P, m, r;
  cudaStream_t st;
  template <int S>
  int operator()() const { return launch<S>(q, x, thr, out, P, m, r, st); }
};

struct OneLaunch {
  const float *q, *x, *thr;
  int thr_stride;
  float* out;
  int C, m, r;
  cudaStream_t st;
  template <int S>
  int operator()() const {
    return launch_one<S>(q, x, thr, thr_stride, out, C, m, r, st);
  }
};

}  // namespace

// Widest band the kernels take: 2r + 2 slots over 32 lanes of 64 each.
extern "C" int dtw_pairs_max_radius() { return 32 * 64 / 2 - 1; }

extern "C" int dtw_wavefront_pairs_launch(const float* q, const float* x,
                                          const float* thr, float* out,
                                          int P, int m, int r,
                                          void* stream) {
  return with_slots(r, PairsLaunch{q, x, thr, out, P, m, r,
                                   static_cast<cudaStream_t>(stream)});
}

extern "C" int dtw_wavefront_launch(const float* q, const float* x,
                                    const float* thr, int thr_stride,
                                    float* out, int C, int m, int r,
                                    void* stream) {
  return with_slots(r, OneLaunch{q, x, thr, thr_stride, out, C, m, r,
                                 static_cast<cudaStream_t>(stream)});
}

// Series length the single-query kernel takes: the query plus one row
// per warp in shared memory.
extern "C" int dtw_one_max_length() {
  return 227 * 1024 / ((ONE_WARPS + 1) * static_cast<int>(sizeof(float)));
}

extern "C" const char* dtw_wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
