// Strided sliding-window filter projections for the SSH sketch stage.
//
// Replaces the TPU kernel repro/kernels/sketch_conv.py::sketch_conv
// (_kernel, a phase-decomposed shifted FMA per filter tap).
//
//   x (B, m) f32, filters (W, F) f32  ->  out (B, N_B, F) f32
//   out[b, t, f] = sum_{w=0}^{W-1} x[b, t*step + w] * filters[w, f]
//   N_B = (m - W) / step + 1
//
// Bound on the H100: memory.  The kernel reads B*m*4 bytes and writes
// B*N_B*F*4 bytes against 2*B*N_B*F*W flops, about W/2 flops per byte at
// F = 1, far below the card's ~20 flops/byte f32 ridge point.  At a
// 4096-row build chunk of the ssh-ecg config (m 512, W 80, step 3) that
// is 10.8 MB, 3.2 us at 3.35 TB/s.
//
// What held the first version below that bound was shared-memory issue,
// not bytes: one thread an output, each tap one FFMA and two scalar
// shared loads (the segment and the filter).  The design cuts the
// instructions a tap to about 1.25:
//
// * A warp owns a tile of TILE = 32 * P consecutive window positions of
//   one row (P = 5: 160 slots, one tile for the 145 windows of a 512-long
//   row), and each lane owns P consecutive positions t .. t + P - 1.
//   The warp's segment of the row ((TILE - 1) * step + W floats) is
//   copied into shared memory with 16-byte loads when the rows are
//   16-byte aligned, scalar loads otherwise.
// * A lane walks the x values of its span once, step * (P - 1) + W of
//   them, and applies each x_j to every output p whose tap w = j - step*p
//   lies in [0, W): one shared load for up to P FFMAs.  Lanes read at a
//   stride of P * step floats, odd at the shipped step 3, so the reads hit
//   distinct banks.
// * For the written (W, step) pairs (80, 3) of ssh-ecg and (24, 3) of its
//   SMOKE config, at one filter, the walk is unrolled at compile time and
//   the filter taps sit in registers (read as 16-byte broadcast loads
//   from shared memory), so a tap costs one FFMA and 1/P + 1/(4P) loads.
//   Any other (W, step, F) takes the same walk with run-time bounds, a
//   filter at a time, the taps read from shared memory as broadcasts.
//
// Arithmetic order: every output is one __fmaf_rn chain over its taps in
// the order w = 0 .. W-1 from 0.0f, which the walk keeps (j rises, so w
// does).  That is the order of the first version, so the two are
// bit-identical, and kernels/ref.py::sketch_conv_fma_ref emulates the
// chain exactly on any device.
//
// Shared memory a block: the filter bank (W*F floats, rounded up to 4)
// and one segment per warp; the launcher takes 4 warps a block, or fewer
// when 4 segments do not fit (kernels/sketch_conv.py computes the same
// sizes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 5;                 // window positions a lane owns
constexpr int TILE = 32 * P;         // window positions a warp owns
constexpr int MAX_WARPS = 4;         // warps a block
constexpr int SMEM_LIMIT = 227 * 1024;

// floats of one warp's segment: the span, 3 more for a 16-byte-aligned
// start, rounded up to a multiple of 4
__host__ __device__ constexpr int seg_floats(int W, int step) {
  return ((TILE - 1) * step + W + 3 + 3) / 4 * 4;
}

__host__ __device__ constexpr int filt_floats(int W, int F) {
  return (W * F + 3) / 4 * 4;
}

constexpr int smem_bytes(int W, int F, int step, int warps) {
  return static_cast<int>(sizeof(float)) *
         (filt_floats(W, F) + warps * seg_floats(W, step));
}

// W_ > 0: one filter (F == 1), the walk unrolled for (W_, STEP_) with the
// taps in registers; W_ == 0: W, step and F at run time
// (min blocks 1: with the block size alone ptxas holds the kernels to 40
// registers and spills the taps and accumulators to local memory)
template <int W_, int STEP_>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
sketch_conv_kernel(const float* __restrict__ x,
                   const float* __restrict__ filters,
                   float* __restrict__ out, int B, int m, int W_rt, int F,
                   int step_rt, int n_b, int tiles_per_row, int vec) {
  constexpr bool FIXED = W_ > 0;
  static_assert(!FIXED || W_ % 4 == 0, "register taps load as float4");
  const int W = FIXED ? W_ : W_rt;
  const int step = FIXED ? STEP_ : step_rt;
  extern __shared__ __align__(16) float smem[];
  float* filt = smem;                                  // W * F
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* seg = smem + filt_floats(W, F) + warp * seg_floats(W, step);

  for (int k = threadIdx.x; k < W * F; k += blockDim.x) filt[k] = filters[k];
  __syncthreads();

  const long long item =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (item >= static_cast<long long>(B) * tiles_per_row) return;
  const int b = static_cast<int>(item / tiles_per_row);
  const int t0 = static_cast<int>(item - static_cast<long long>(b) *
                                             tiles_per_row) * TILE;
  const long long g0 = static_cast<long long>(b) * m + t0 * step;
  const int len = min((TILE - 1) * step + W, m - t0 * step);
  const int nseg = seg_floats(W, step);

  // the warp's segment x[b, t0*step ..][: len] -> seg[lead ..], zeros after
  int lead = 0;
  if (vec) {   // rows 16-byte aligned (m % 4 == 0): no float4 leaves the row
    lead = static_cast<int>(g0 & 3);
    const float4* src = reinterpret_cast<const float4*>(x + (g0 - lead));
    const int n4 = (lead + len + 3) >> 2;
    for (int k = lane; k < n4; k += 32)
      reinterpret_cast<float4*>(seg)[k] = src[k];
    for (int k = 4 * n4 + lane; k < nseg; k += 32) seg[k] = 0.0f;
  } else {
    for (int k = lane; k < nseg; k += 32)
      seg[k] = k < len ? x[g0 + k] : 0.0f;
  }
  __syncwarp();

  const float* xs = seg + lead + lane * (P * step);
  const int tl = t0 + lane * P;                        // the lane's first t
  float* o = out + (static_cast<long long>(b) * n_b + tl) * F;
  if constexpr (FIXED) {   // F == 1: one straight-line walk, taps in registers
    float fr[W_], acc[P];
#pragma unroll
    for (int w = 0; w < W_; w += 4) {
      const float4 t4 = reinterpret_cast<const float4*>(filt)[w >> 2];
      fr[w] = t4.x;
      fr[w + 1] = t4.y;
      fr[w + 2] = t4.z;
      fr[w + 3] = t4.w;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.0f;
#pragma unroll
    for (int j = 0; j < STEP_ * (P - 1) + W_; ++j) {
      const float xj = xs[j];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int w = j - STEP_ * p;
        if (w >= 0 && w < W_) acc[p] = __fmaf_rn(xj, fr[w], acc[p]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (tl + p < n_b) o[p] = acc[p];
  } else {
    const int span = step * (P - 1) + W;
    for (int f = 0; f < F; ++f) {
      float acc[P];
#pragma unroll
      for (int p = 0; p < P; ++p) acc[p] = 0.0f;
      for (int j = 0; j < span; ++j) {
        const float xj = xs[j];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int w = j - step * p;
          if (w >= 0 && w < W) acc[p] = __fmaf_rn(xj, filt[w * F + f], acc[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (tl + p < n_b) o[p * F + f] = acc[p];
    }
  }
}

template <int W_, int STEP_>
int launch(const float* x, const float* filters, float* out, int B, int m,
           int W, int F, int step, int n_b, int warps,
           cudaStream_t stream) {
  auto kernel = sketch_conv_kernel<W_, STEP_>;
  const int smem = smem_bytes(W, F, step, warps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (n_b + TILE - 1) / TILE;
  const long long items = static_cast<long long>(B) * tiles;
  const long long blocks = (items + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem, stream>>>(
      x, filters, out, B, m, W, F, step, n_b, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shared memory of a one-warp block, the least a launch needs
extern "C" int sketch_conv_smem_bytes(int W, int F, int step) {
  return smem_bytes(W, F, step, 1);
}

extern "C" int sketch_conv_launch(const float* x, const float* filters,
                                  float* out, int B, int m, int W, int F,
                                  int step, int n_b, void* stream) {
  int warps = MAX_WARPS;
  while (warps > 1 && smem_bytes(W, F, step, warps) > SMEM_LIMIT) warps >>= 1;
  if (W < 1 || F < 1 || step < 1 || m < W ||
      smem_bytes(W, F, step, warps) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F == 1 && W == 80 && step == 3)
    return launch<80, 3>(x, filters, out, B, m, W, F, step, n_b, warps, s);
  if (F == 1 && W == 24 && step == 3)
    return launch<24, 3>(x, filters, out, B, m, W, F, step, n_b, warps, s);
  return launch<0, 0>(x, filters, out, B, m, W, F, step, n_b, warps, s);
}

extern "C" const char* sketch_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
