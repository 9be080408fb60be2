// Signed count-sketch tables for the "ssh-cs" encoder's weighted-set stage.
//
// Replaces the TPU kernel repro/kernels/count_sketch.py::cs_tables (the
// TPU has no scatter-add, so it compares each chunk of 128 buckets with
// every bin index, a (128, width) one-hot, and sums the signs down the
// sublanes; grid (B, R, S / 128) with the row's table resident in VMEM).
// The H100 has shared-memory atomics, so the one-hot goes away.
//
//   bucket (B, R, S) i32 (-1: no contribution), sign (B, R, S) f32
//     ->  out (B, R, width) f32
//   out[b, r, w] = sum over s with bucket[b, r, s] == w of sign[b, r, s]
//
// Buckets outside [0, width) contribute nothing, as the plain version's
// dump bin.
//
// Bound on the H100: memory, and the dense output dominates it.  At a
// build chunk (B = 4096, R = 4, width = 4096, S = 131) the kernel writes
// 268 MB of tables and reads 17 MB of buckets and signs: about 0.085 ms
// at 3.35 TB/s, against 2.1 M additions.
//
// Design: one block per (b, r) row.  Its table of `width` floats lives
// in shared memory (16 KB at width 4096): the block zeroes it, every
// thread adds the signs of its shingles with shared-memory atomicAdd,
// and the block then writes the row out with 16-byte stores, consecutive
// threads on consecutive addresses.  The signs are +-1 (0 on invalid
// entries), so each bin holds an integer below 2^24 at every step and
// every order of the atomics gives the same bits: the kernel equals the
// plain scatter-add bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void cs_tables_kernel(const int* __restrict__ bucket,
                                 const float* __restrict__ sign,
                                 float* __restrict__ out, int S, int width) {
  extern __shared__ float table[];
  const long long row = blockIdx.x;
  for (int w = threadIdx.x; w < width; w += blockDim.x) table[w] = 0.0f;
  __syncthreads();

  const int* bk = bucket + row * S;
  const float* sg = sign + row * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int w = bk[s];
    if (w >= 0 && w < width) atomicAdd(table + w, sg[s]);
  }
  __syncthreads();

  // width is a multiple of 4 (the wrapper checks), and so is every row's
  // offset: 16-byte stores
  float4* dst = reinterpret_cast<float4*>(out + row * width);
  const float4* src = reinterpret_cast<const float4*>(table);
  for (int v = threadIdx.x; v < width / 4; v += blockDim.x) dst[v] = src[v];
}

}  // namespace

// Widest table a block holds in shared memory.
extern "C" int cs_tables_max_width() {
  return 227 * 1024 / static_cast<int>(sizeof(float));
}

extern "C" int cs_tables_launch(const int* bucket, const float* sign,
                                float* out, int rows, int S, int width,
                                void* stream) {
  const int smem = width * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cs_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cs_tables_kernel<<<rows, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      bucket, sign, out, S, width);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* count_sketch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
