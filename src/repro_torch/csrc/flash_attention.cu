// Fused attention forward (online softmax) for the LM prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (grid (B*H, S / q_block), the head's whole K/V row resident in VMEM, a
// fori_loop over KV blocks carrying the running max, sum and accumulator).
//
//   q (B, H, S, D), k/v (B, Hk, T, D), H % Hk == 0, f32 or bf16
//     ->  o (B, H, S, D) in q's type
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//   with g = H / Hk (query head h reads KV head h / g, as jnp.repeat of the
//   KV heads gives) and, when causal, only keys j <= i, query positions
//   absolute from 0 as in the TPU kernel.
//
// Every tensor comes with its element strides for (b, h, s); the last
// axis must be contiguous.  So the model's (B, S, H, D) activations go in
// as transposed views without a copy, and the output is written wherever
// its strides point.
//
// Bound on the H100: operations.  The work is 4*B*H*S*T*D (two products
// of 2*S*T*D each), halved under causal masking; at the granite-3-2b
// prefill of 1 x 32,768 tokens (H = 32, D = 64) that is 4.4e12 a layer,
// 4.45 ms at the 989 TFLOP/s of the bf16 tensor cores.  The bytes (q, k,
// v read once, o written once) are 0.27 GB, 0.08 ms at 3.35 TB/s.
//
// Design: one block of 256 threads owns one (b*h, 64-row query tile).  It
// stages the scaled query tile in shared memory as float32 once, then
// loops over 64-key tiles of K and V staged the same way, and keeps the
// online-softmax recurrence (running max m, sum l, 64 x D accumulator) in
// float32 registers: thread (ty, tx) of the 16 x 16 grid owns query rows
// 4*ty..4*ty+3, logit columns tx + 16*j and output columns tx + 16*j.  The
// row max and row sum reduce over the 16 lanes of a half-warp by
// shuffles; the probabilities pass through shared memory to the P.V
// product.  No (S, T) logits reach device memory, so the bytes bound is
// met by construction; the products run on the float32 CUDA cores (at
// most 67 TFLOP/s), so the kernel sits 15x or more above its tensor-core
// bound.  That is the simple first version: moving both products onto
// the tensor cores (mma.sync, then wgmma fed by TMA) is the next step.
// Under causal masking the loop stops at the diagonal tile (tiles above
// it are wholly masked: the TPU kernel adds exp(-1e30 - m) = 0 for them),
// and the blocks of the last query tiles, which carry the most keys, are
// started first.  Masked logits (ragged T, causal) contribute exactly 0;
// ragged S and T are masked in the kernel, not padded.  Shared rows are
// padded to D + 1 floats, so every shared-memory read in the two products
// is conflict-free or a broadcast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  long long b, h, s;   // elements; the head-dim axis is contiguous
};

constexpr int smem_floats(int dp) {
  return (BM + 2 * BN) * (dp + 1) + BM * (BN + 1);
}

// DP: the head dim rounded up to a multiple of 16 (columns D..DP-1 are
// zero in the shared tiles and never stored).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int group, int S, int Tk, int D, Strides sq,
                       Strides sk, Strides sv, Strides so, float scale,
                       int causal) {
  constexpr int LD = DP + 1;
  constexpr int LP = BN + 1;
  constexpr int NJ = DP / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BM x LD, scaled
  float* Ks = Qs + BM * LD;     // BN x LD
  float* Vs = Ks + BN * LD;     // BN x LD
  float* Ps = Vs + BN * LD;     // BM x LP

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;
  T* op = o + b * so.b + h * so.h;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int i = tid; i < BM * DP; i += THREADS) {
    const int r = i / DP, d = i - r * DP;
    float x = 0.0f;
    if (q0 + r < S && d < D) x = to_float(qp[(q0 + r) * sq.s + d]) * scale;
    Qs[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // keys past the tile's last query row are masked for every row of it
  const int kv_end = causal ? min(Tk, q0 + BM) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    for (int i = tid; i < BN * DP; i += THREADS) {
      const int r = i / DP, d = i - r * DP;
      float kx = 0.0f, vx = 0.0f;
      if (k0 + r < Tk && d < D) {
        kx = to_float(kp[(k0 + r) * sk.s + d]);
        vx = to_float(vp[(k0 + r) * sv.s + d]);
      }
      Ks[r * LD + d] = kx;
      Vs[r * LD + d] = vx;
    }
    __syncthreads();

    // logits of the thread's 4 x 4: rows 4*ty + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(4 * ty + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      bool ok[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < Tk && (!causal || kj <= qi);
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        rs += p;
        Ps[(4 * ty + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4], w[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * LP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(op + r * so.s + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hk, int S, int Tk, int D, const Strides* st,
              float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, DP>;
  const int smem = smem_floats(DP) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * H, (S + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hk, S, Tk, D,
      st[0], st[1], st[2], st[3], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hk, int S, int Tk, int D, const Strides* st,
             float scale, int causal, cudaStream_t stream) {
  if (D <= 16)
    return launch_dp<T, 16>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                            causal, stream);
  if (D <= 32)
    return launch_dp<T, 32>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                            causal, stream);
  if (D <= 64)
    return launch_dp<T, 64>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                            causal, stream);
  if (D <= 96)
    return launch_dp<T, 96>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                            causal, stream);
  return launch_dp<T, 128>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale, causal,
                           stream);
}

}  // namespace

extern "C" int flash_attention_max_head_dim() { return MAX_D; }

// dtype: 0 float32, 1 bfloat16 (q, k, v and o alike).  Strides in
// elements, (b, h, s) of q, k, v, o in that order.  The wrapper checks
// shapes, D <= MAX_D, H % Hk == 0 and grid limits; returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hk, int S, int Tk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, void* stream) {
  if (D < 1 || D > MAX_D || Hk < 1 || H % Hk != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                         {osb, osh, oss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                           causal, s);
  return launch_t<__nv_bfloat16>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                                 causal, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
