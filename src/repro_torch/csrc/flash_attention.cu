// Fused attention forward (online softmax) for the LM prefill: two kernels.
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
// its strides point.  Ragged S and T are masked in the kernels, never
// padded in memory; masked logits contribute exactly 0; under causal
// masking the key loop stops at the diagonal tile, only tiles that cross
// the diagonal (or the end of T) are masked elementwise, and the query
// tiles with the most keys are started first.
//
// Bound on the H100: operations.  The work is 4*B*H*S*T*D (two products
// of 2*S*T*D each), halved under causal masking; at the granite-3-2b
// prefill of 1 x 32,768 tokens (H = 32, D = 64) that is 4.4e12 a layer,
// 4.45 ms at the 989 TFLOP/s of the bf16 tensor cores.  The bytes (q, k,
// v read once, o written once) are 0.27 GB, 0.08 ms at 3.35 TB/s.
//
// Which kernel runs is a written rule of the wrapper
// (kernels/flash_attention.py::takes_tensor_cores), never a fallback:
//
// 1. flash_attention_tc_kernel: bf16 inputs with D a multiple of 8 up to
//    128, 16-byte-aligned base pointers and (b, h, s) strides, and a
//    positive scale (folded into the exponent after the row max).  It puts
//    both products on the tensor cores through wgmma, which is the only
//    way to the 989 TFLOP/s the bound is counted at.  A block is three
//    consumer warpgroups of 64 query rows each (192 rows) and a producer
//    warpgroup, which gives most of its registers to the consumers
//    (setmaxnreg) and of which one thread works: it loads the block's Q
//    tile once and then K and V tiles of BN keys into a ring of STAGES
//    shared-memory stages with TMA (cp.async.bulk.tensor on a 4-d tensor
//    map over (D, L, heads, B) built from the strides, mbarrier
//    completion, 128-byte swizzle), so the next tiles land while the
//    current one is computed; TMA's out-of-bounds zero fill pads ragged S
//    and T tiles and the head dim up to 64 or 128 columns.  Each consumer
//    warpgroup runs S = Q K^T as wgmma m64nBNk16 (Q and K both K-major in
//    shared memory, float32 accumulator) and O += P V as wgmma m64nDk16
//    with P as the A operand from registers (the S accumulator's fragment
//    layout is the A-register layout, so P is converted to bf16 in place)
//    and V from shared memory read transposed (tnspB).  The online
//    softmax stays in float32 registers: exp2 as one MUFU op, with
//    log2(e) and the scale folded into one FFMA, the row max and sum
//    reduced over the 4 lanes that share a row, 1/l applied once in the
//    epilogue; rows >= S are never stored.  P enters the second product
//    rounded to bf16, as the reference rounds its weights
//    (repro/kernels/ref.py:136); l is summed from the unrounded p.
//    What bounds it on this card, by count: the softmax beside the
//    products.  At D = 64 the exponentials of a 128-key tile take the
//    special-function units (16 a clock per SM) as many cycles as the
//    tile's two products take the tensor cores, and its other float32
//    work (row max, FFMA, sums, bf16 packing, the rescale of O) about as
//    many issue slots again, so the kernel reaches its bound only if all
//    of it hides under the products.  Which of these holds it below the
//    bound on the card is not measured.  The design overlaps them in two
//    ways: inside a warpgroup, S of tile j and P V of tile j - 1 are
//    issued together and tile j's softmax runs while P V is on the tensor
//    cores (O is rescaled when P V has landed, before P V of tile j is
//    issued); across the three warpgroups, the scheduler runs one's
//    products beside another's softmax.
//
// 2. flash_attention_simt_kernel: float32 inputs and every other bf16
//    input.  One block of 256 threads owns one (b*h, 64-row query tile).
//    It stages the scaled query tile in shared memory as float32 once,
//    then loops over 64-key tiles of K and V staged the same way, and
//    keeps the online-softmax recurrence (running max m, sum l, 64 x D
//    accumulator) in float32 registers: thread (ty, tx) of the 16 x 16
//    grid owns query rows 4*ty..4*ty+3, logit columns tx + 16*j and
//    output columns tx + 16*j.  The row max and row sum reduce over the 16
//    lanes of a half-warp by shuffles; the probabilities pass through
//    shared memory to the P.V product.  What bounds it: both products run
//    as float32 FMAs on the CUDA cores (at most 67 TFLOP/s), 15x or more
//    above the tensor-core bound, with synchronous loads.  It keeps full
//    float32 products, which is what the float32 route needs (a 1e-4 bar
//    on the float32 model).  Shared rows are padded to D + 1 floats, so
//    every shared-memory read in the two products is conflict-free or a
//    broadcast.
#include <cuda.h>            // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;   // elements; the head-dim axis is contiguous
};

constexpr int MAX_D = 128;

}  // namespace

// ---------------------------------------------------------------------------
// 2. CUDA-core kernel (float32, and bf16 inputs the tensor-core rule refuses)
namespace simt {

constexpr int BM = 64;         // query rows per block
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr int smem_floats(int dp) {
  return (BM + 2 * BN) * (dp + 1) + BM * (BN + 1);
}

// DP: the head dim rounded up to a multiple of 16 (columns D..DP-1 are
// zero in the shared tiles and never stored).
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
  auto kernel = flash_attention_simt_kernel<T, DP>;
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


}  // namespace simt

// ---------------------------------------------------------------------------
// 1. Tensor-core kernel (bf16): wgmma fed by TMA
namespace tc {

constexpr int WG = 3;                    // consumer warpgroups
constexpr int BM = 64 * WG;              // query rows per block
constexpr int THREADS = 128 * (WG + 1);  // and a producer warpgroup
// registers a thread of each role keeps (setmaxnreg): the producer needs
// few, and the consumers share what it gives back
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = 160;
static_assert(128 * (WG * CONSUMER_REGS + PRODUCER_REGS) <= 65536,
              "register file");
constexpr int STAGES = 3;                // K/V ring
constexpr int CHUNK = 64;                // bf16 columns in a 128-byte row
constexpr int ROW = 128;                 // bytes of a swizzled row
constexpr float LOG2E = 1.4426950408889634f;

// DP: the head dim rounded up to 64 or 128 (TMA fills the rest with 0);
// BN: keys per tile.  Shared memory holds Q (NCH chunks of BM rows) and
// STAGES stages of K and V (NCH chunks of BN rows each), every chunk a
// [rows][64] bf16 tile in the 128-byte swizzle, 1024-byte aligned.
template <int DP>
struct Cfg {
  static constexpr int BN = DP == 64 ? 128 : 64;
  static constexpr int NCH = DP / CHUNK;
  static constexpr int Q_BYTES = NCH * BM * ROW;
  static constexpr int KV_BYTES = NCH * BN * ROW;       // K or V, one stage
  static constexpr int BARS = 1 + 3 * STAGES;           // q, k, v, empty
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARS;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA tile of a 4-d tensor map, completion counted on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses of an accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x, one MUFU op (exp2(-inf) = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, float32) += A (64 x 16) * B (16 x 64): A and B both
// K-major in shared memory (descriptors), D zeroed first unless scale_d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16) * B (16 x 128): A and B both
// K-major in shared memory (descriptors), D zeroed first unless scale_d.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64):
// B MN-major in shared memory (tnspB = 1), D zeroed first unless scale_d.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128):
// B MN-major in shared memory (tnspB = 1), D zeroed first unless scale_d.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else wgmma_rs_n128(d, a, db, scale_d);
}

// scale > 0 (the launcher refuses any other): the row max of the raw
// logits is the max of the scaled ones, so the logits and m stay raw and
// the scale folds into one FFMA with the subtraction
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, Strides so, int H,
                          int group, int S, int Tk, int D, float scale_log2,
                          int causal) {
  using C = Cfg<DP>;
  constexpr int BN = C::BN, NCH = C::NCH;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + C::Q_BYTES;                  // + stage * KV_BYTES
  const uint32_t sv = sk + STAGES * C::KV_BYTES;
  const uint32_t bars = sv + STAGES * C::KV_BYTES;
  const uint32_t bar_q = bars;
  // full barriers of the K and V stages, and the stage's empty barrier
  auto bar_k = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  // keys past the tile's last query row are masked for every row of it
  const int kv_end = causal ? min(Tk, q0 + BM) : Tk;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 128 * WG);     // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * WG) {
    // producer warpgroup: one thread loads Q once, then K and V tiles
    // into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == 4 * WG && lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load(sq + c * BM * ROW, &tq, bar_q, c * CHUNK, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_e(s), ((j / STAGES) - 1) & 1);
        const uint32_t kd = sk + s * C::KV_BYTES, vd = sv + s * C::KV_BYTES;
        mbar_expect_tx(bar_k(s), C::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(kd + c * BN * ROW, &tk, bar_k(s), c * CHUNK, j * BN, hk, b);
        mbar_expect_tx(bar_v(s), C::KV_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load(vd + c * BN * ROW, &tv, bar_v(s), c * CHUNK, j * BN, hk, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  // consumer warpgroup wg: query rows q0 + 64 * wg .. + 63.  In the
  // accumulator layout a thread holds rows r0 and r0 + 8, columns
  // 8 * j + 2 * (lane % 4) + {0, 1} at registers 4 * j + 2 * half + {0, 1}.
  const int wg = warp / 4;
  const int r0 = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t qa = sq + 64 * wg * ROW;
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float sc[BN / 2];              // S of a tile, then its p
  uint32_t pa[BN / 16][4];       // p in bf16: the A operand of P V

  // S = Q K^T of tile j into sc, issued, not waited for
  auto issue_s = [&](int j) {
    const uint32_t kb = sk + (j % STAGES) * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;    // 16 columns a step
      wgmma_ss<BN>(sc, desc_sw128(qa + (kk / 4) * BM * ROW + col, 16, 8 * ROW),
                   desc_sw128(kb + (kk / 4) * BN * ROW + col, 16, 8 * ROW),
                   kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile j, issued, not waited for; V is read transposed and
  // 16 keys a step are 2 swizzle atoms
  auto issue_pv = [&](int j) {
    const uint32_t vb = sv + (j % STAGES) * C::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DP>(acc, pa[kk],
                   desc_sw128(vb + kk * 16 * ROW,
                              NCH > 1 ? BN * ROW : 8 * ROW, 8 * ROW),
                   1);
    wgmma_commit();
  };
  // online softmax of tile j in sc, in log2 units: sc becomes p, l and m
  // move on, and corr is what O must be scaled by before P V of tile j
  auto softmax = [&](int j, float* corr) {
    const int k0 = j * BN;
    const bool masked =
        k0 + BN > Tk || (causal && k0 + BN - 1 > q0 + 64 * wg);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int half = (i >> 1) & 1;
      float x = sc[i];
      if (masked) {
        const int col = k0 + 8 * (i / 4) + c0 + (i & 1);
        if (col >= Tk || (causal && col > r0 + 8 * half)) x = -INFINITY;
      }
      sc[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the running and the new row max, scaled (-inf: no key seen yet)
      const float was = m[r] * scale_log2;
      const float now = mx[r] * scale_log2;
      mu[r] = now == -INFINITY ? 0.0f : now;
      corr[r] = ex2(was - mu[r]);
      m[r] = mx[r];
      l[r] *= corr[r];           // l: this thread's part of the row sum
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int half = (i >> 1) & 1;
      // masked: exp2(-inf) = 0
      sc[i] = ex2(fmaf(sc[i], scale_log2, -mu[half]));
      l[half] += sc[i];
    }
  };
  // p to bf16 A fragments: the S accumulator's layout is the A layout
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };
  auto parity = [](int j) { return static_cast<uint32_t>(j / STAGES) & 1; };

  // tile 0 alone; then each step issues S of tile j and P V of tile j - 1
  // together and runs tile j's softmax while P V is on the tensor cores
  float corr[2];
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k(0), 0);
  __syncwarp();                  // after a wait: wgmma need the warp whole
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs<BN / 2>(sc);
  softmax(0, corr);
  pack_p();
  for (int j = 1; j < n_tiles; ++j) {
    mbar_wait(bar_k(j % STAGES), parity(j));
    mbar_wait(bar_v((j - 1) % STAGES), parity(j - 1));
    __syncwarp();
    fence_regs<DP / 2>(acc);
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();             // S of tile j is in
    fence_regs<BN / 2>(sc);
    softmax(j, corr);
    wgmma_wait<0>();             // P V of tile j - 1 is in
    fence_regs<DP / 2>(acc);
    mbar_arrive(bar_e((j - 1) % STAGES));
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    pack_p();
  }
  mbar_wait(bar_v((n_tiles - 1) % STAGES), parity(n_tiles - 1));
  __syncwarp();
  fence_regs<DP / 2>(acc);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs<DP / 2>(acc);
  mbar_arrive(bar_e((n_tiles - 1) % STAGES));

  // epilogue: 1/l once, rows >= S and columns >= D never stored
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int jn = 0; jn < DP / 8; ++jn) {
      const int col = 8 * jn + c0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(op + row * so.s + col) =
            __floats2bfloat162_rn(acc[4 * jn + 2 * r] * inv,
                                  acc[4 * jn + 2 * r + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time, so the
// library links against the runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// codes above this one are a failed encode: TMA_ERROR + CUresult
constexpr int TMA_ERROR = 10000;

// a (B, heads, L, D) bf16 tensor as a 4-d map, boxes of 64 columns by
// ``rows``; columns >= D and rows >= L read as 0
int encode(CUtensorMap* map, const void* ptr, int B, int heads, int L, int D,
           Strides st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return TMA_ERROR + CUDA_ERROR_NOT_FOUND;
  const long long ext[3] = {L, heads, B}, str[3] = {st.s, st.h, st.b};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ext[i]);
    // a dimension of extent 1 is never stepped: any legal stride will do
    strides[i] = 2ull * static_cast<cuuint64_t>(ext[i] > 1 ? str[i] : D);
  }
  const cuuint32_t box[4] = {CHUNK, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TMA_ERROR + static_cast<int>(r);
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hk, int S, int Tk, int D, const Strides* st,
              float scale, int causal, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap maps[3];
  int rc = encode(&maps[0], q, B, H, S, D, st[0], BM);
  if (rc == 0) rc = encode(&maps[1], k, B, Hk, Tk, D, st[1], C::BN);
  if (rc == 0) rc = encode(&maps[2], v, B, Hk, Tk, D, st[2], C::BN);
  if (rc != 0) return rc;
  auto kernel = flash_attention_tc_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + BM - 1) / BM);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), st[3], H,
      H / Hk, S, Tk, D, scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" int flash_attention_max_head_dim() { return MAX_D; }

// The CUDA-core kernel.  dtype: 0 float32, 1 bfloat16 (q, k, v and o
// alike).  Strides in elements, (b, h, s) of q, k, v, o in that order.
// The wrapper checks shapes, D <= MAX_D, H % Hk == 0 and grid limits;
// returns cudaGetLastError() of the launch.
extern "C" int flash_attention_simt_launch(
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
    return simt::launch_t<float>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                                 causal, s);
  return simt::launch_t<__nv_bfloat16>(q, k, v, o, B, H, Hk, S, Tk, D, st,
                                       scale, causal, s);
}

// The tensor-core kernel: bf16 only, D a multiple of 8 up to MAX_D, every
// base pointer 16-byte aligned, every (b, h, s) stride of an axis longer
// than 1 a positive multiple of 16 bytes and scale > 0 (the wrapper's rule;
// refused here with cudaErrorInvalidValue otherwise).  Same arguments as
// above without dtype; returns cudaGetLastError() of the launch, or
// TMA_ERROR + the CUresult of a tensor map that would not encode.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hk, int S, int Tk, int D, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, void* stream) {
  const Strides st[4] = {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                         {osb, osh, oss}};
  const void* ptrs[4] = {q, k, v, o};
  const int ext[4][3] = {{B, H, S}, {B, Hk, Tk}, {B, Hk, Tk}, {B, H, S}};
  // a stride of an axis of extent 1 is never used
  auto fits = [](long long stride, int extent) {
    return extent == 1 || (stride > 0 && stride % 8 == 0);
  };
  bool ok = D >= 8 && D <= MAX_D && D % 8 == 0 && Hk >= 1 &&
            H % Hk == 0 && scale > 0.0f;
  for (int i = 0; i < 4; ++i)
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 &&
         fits(st[i].b, ext[i][0]) && fits(st[i].h, ext[i][1]) &&
         fits(st[i].s, ext[i][2]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return tc::launch_dp<64>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                             causal, s);
  return tc::launch_dp<128>(q, k, v, o, B, H, Hk, S, Tk, D, st, scale,
                            causal, s);
}

// dynamic shared memory of the tensor-core kernel at head dim D
extern "C" int flash_attention_tc_smem_bytes(int D) {
  return D <= 64 ? tc::Cfg<64>::SMEM : tc::Cfg<128>::SMEM;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= tc::TMA_ERROR)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 10000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
