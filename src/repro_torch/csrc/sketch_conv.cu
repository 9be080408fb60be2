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
// F = 1, far below the card's ~20 flops/byte f32 ridge point.
//
// Design: one block takes one series row b and a tile of TILE_T window
// positions.  The row segment those windows read ((TILE_T-1)*step + W
// floats) and the whole filter bank sit in shared memory, so each input
// float is read from device memory once per tile.  One thread owns one
// window position t and loops over the F filters, so at F = 1 every
// thread computes exactly one output.  The tap loop runs w = 0..W-1 in
// order with one fused multiply-add per tap, the order of the TPU
// kernel's unrolled tap loop.  Neighbouring threads read the segment at
// a stride of `step` floats: step is odd for every shipped config, so the
// shared-memory reads hit distinct banks.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_T = 128;   // window positions per block (= threads)

__global__ void sketch_conv_kernel(const float* __restrict__ x,
                                   const float* __restrict__ filters,
                                   float* __restrict__ out,
                                   int m, int W, int F, int step, int n_b) {
  extern __shared__ float smem[];
  float* filt = smem;                 // W * F
  float* seg = smem + W * F;          // (TILE_T - 1) * step + W

  const int b = blockIdx.x;
  const int t0 = blockIdx.y * TILE_T;
  const int seg_len = (TILE_T - 1) * step + W;
  const float* row = x + static_cast<long long>(b) * m;
  const int base = t0 * step;

  for (int k = threadIdx.x; k < W * F; k += blockDim.x) filt[k] = filters[k];
  for (int k = threadIdx.x; k < seg_len; k += blockDim.x) {
    const int src = base + k;
    seg[k] = src < m ? row[src] : 0.0f;
  }
  __syncthreads();

  const int t = t0 + threadIdx.x;
  if (t >= n_b) return;
  const float* win = seg + threadIdx.x * step;
  float* o = out + (static_cast<long long>(b) * n_b + t) * F;
  for (int f = 0; f < F; ++f) {
    float acc = 0.0f;
    for (int w = 0; w < W; ++w) acc = __fmaf_rn(win[w], filt[w * F + f], acc);
    o[f] = acc;
  }
}

}  // namespace

extern "C" int sketch_conv_smem_bytes(int W, int F, int step) {
  return static_cast<int>(sizeof(float)) * (W * F + (TILE_T - 1) * step + W);
}

extern "C" int sketch_conv_launch(const float* x, const float* filters,
                                  float* out, int B, int m, int W, int F,
                                  int step, int n_b, void* stream) {
  const int smem = sketch_conv_smem_bytes(W, F, step);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sketch_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // rows on x (up to 2^31 - 1 blocks), window tiles on y
  dim3 grid(B, (n_b + TILE_T - 1) / TILE_T);
  sketch_conv_kernel<<<grid, TILE_T, smem, static_cast<cudaStream_t>(stream)>>>(
      x, filters, out, m, W, F, step, n_b);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sketch_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
