// Fused attention forward (online softmax) for the LM prefill: two kernels.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (grid (B*H, S / q_block), the head's whole K/V row resident in VMEM, a
// fori_loop over KV blocks carrying the running max, sum and accumulator).
//
//   q (B, H, S, D), k (B, Hk, T, D), v (B, Hk, T, Dv), H % Hk == 0,
//   f32 or bf16  ->  o (B, H, S, Dv) in q's type
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / g, j]) v[b, h / g, j]
//   with g = H / Hk (query head h reads KV head h / g, as jnp.repeat of the
//   KV heads gives), over the keys j < kv_len[b] and, when causal, only
//   j <= i + off.  kv_len[b] = min(T, kv_valid[b]) (T without kv_valid, a
//   nullable (B,) int32 device array read once by each block, never on the
//   host), and off the query offset: query i sits at position i + off.
//   off = 0 is the TPU kernel's alignment; the model's chunked_attention
//   passes T - S, the bottom-right alignment of its decode and prefill
//   continuation.  A row that sees no key (kv_len[b] = 0, or i + off < 0
//   under causal) has l = 0 and is written as 0.
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
// The Q/K head dim D and the V head dim Dv may differ: the MLA prefill
// of deepseek-v2-lite attends with D = 128 + 64 (the rope part of the
// key shared by every head) and Dv = 128.  D goes up to MAX_D = 192, Dv
// up to MAX_DV = 128; the dense models have D = Dv = 64, 96 or 128.
//
// Bound on the H100: operations.  The work is 2*B*H*S*T*(D + Dv) (the
// products S = Q K^T and P V), halved under causal masking; at the
// granite-3-2b prefill of 1 x 32,768 tokens (H = 32, D = Dv = 64) that
// is 4.4e12 a layer, 4.45 ms at the 989 TFLOP/s of the bf16 tensor
// cores.  The bytes (q, k, v read once, o written once) are 0.27 GB,
// 0.08 ms at 3.35 TB/s.
//
// Which kernel runs is a written rule of the wrapper
// (kernels/flash_attention.py::takes_tensor_cores), never a fallback:
//
// 1. flash_attention_tc_kernel: bf16 inputs with D a multiple of 8 up to
//    192 and Dv one up to 128, 16-byte-aligned base pointers and (b, h,
//    s) strides, and a
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
//    and T tiles and the head dims up to the instance's tile widths (DQ,
//    DV) = (64, 64), (128, 128) or (192, 128).  Each consumer warpgroup
//    runs S = Q K^T as wgmma m64nBNk16 over DQ / 16 steps (Q and K both
//    K-major in shared memory, float32 accumulator) and O += P V as wgmma
//    m64nDVk16
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
//    input, on the CUDA cores in full float32 (the float32 route is held
//    to 1e-4 on the float32 model, which 3xTF32 would be a different
//    contract for).  Bound: both products as float32 FMAs, 4*D flops a
//    unmasked (query, key) pair at 67 TFLOP/s; at the float32 serve
//    gate's layer (q 8 x 32 heads x 128, 8 KV heads, D 64, causal) that
//    is 0.0081 ms, and its q, k, v and o bytes take 0.0063 ms.  What holds
//    it there is latency, not either rate: one warp on a SM sub-partition
//    issues these FFMA streams at under half an instruction a clock even
//    with every operand loaded first (measured, PERF.md), so the design
//    keeps several warps on each sub-partition and each warp's chain short:
//    * A block is 64 query rows of one head, 4 warps of 16 rows.  A thread
//      owns 4 rows (tr + 4 i of its warp) and 8 keys (tc + 8 j of a 64-key
//      tile) of the logits, and the same rows by 4 * DV / 32 output
//      columns: register micro-tiles read with 16-byte shared loads (D
//      four at a time in S = Q K^T; 4 keys at a time in P V), 1.5 bytes of
//      shared memory a FFMA.  The tiles are DQ = the larger head dim
//      rounded up to 32 columns (Q, K) and DV = min(DQ, 128) (V); rows are
//      padded to DQ + 4 or DV + 4 floats, so the 16-byte loads of 4
//      consecutive rows (Q) or 8 (K) or of one row's 8 chunks (V) fall in
//      distinct bank groups.
//    * One stage of K and V, filled by cp.async 16-byte copies (float32
//      inputs whose base pointers, (b, h, s) strides and D are 16-byte
//      multiples; everything else, bf16 or odd views, by plain loads that
//      convert to float32), the first with Q.  P leaves registers once:
//      each warp writes its rows of P over the consumed K tile (a block
//      barrier after the logits) and reads them back as 16-byte
//      broadcasts.  That is 52 KB of shared memory a block at D <= 64, so
//      the registers (168 a thread, 3 blocks a SM) and not shared memory
//      set the residency: 12 warps a SM, and every block of the gate's
//      layer (512 of them, the heaviest query tiles first) on the card at
//      once.  A second K/V stage would hold 2 blocks a SM, and the next
//      tile lands under the other blocks' compute instead.  At (DQ, DV) =
//      (192, 128), the MLA shape, a block takes 131 KB and a SM holds one.
//    * The causal diagonal is cut in the warp's own row span: tiles past it
//      (and past kv_len) are not visited; when off is a multiple of 16, in
//      the tile that crosses it the 16-key sub-blocks past it are never
//      read, and on the diagonal sub-block (keys wq0 + off + 8 jj + tc
//      against rows wq0 + 4 i + tr, aligned because both start at
//      multiples of 16; any other off computes the tile whole and masks
//      it elementwise) the (row group i, key group jj) pairs
//      with 8 jj > 4 i + 3, all masked, are skipped in both products
//      (compile-time variants of the logits' loop, a uniform branch a
//      block of 4 keys in P V).  The softmax and P V are one copy of code
//      for every variant: long straight-line code runs at the speed of
//      instruction fetch.
//    * The scale (times log2 e) is folded into Q once; p = 2^(x - m) by
//      one MUFU op; each lane keeps its partial row sum and the 8 lanes of
//      a row add them once at the end, where one reciprocal a row scales
//      the output.  Columns >= D and rows >= S or T are zero in shared
//      memory.
#include <cuda.h>            // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, s;   // elements; the head-dim axis is contiguous
};

constexpr int MAX_D = 192;    // the Q/K head dim
constexpr int MAX_DV = 128;   // the V head dim

}  // namespace

// ---------------------------------------------------------------------------
// 2. CUDA-core kernel (float32, and bf16 inputs the tensor-core rule refuses)
namespace simt {

constexpr int BM = 64;         // query rows a block
constexpr int BN = 64;         // keys a tile: 8 groups of 8
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// DQ: the larger of the two head dims rounded up to a multiple of 32, the
// width of the Q and K tiles; DV = min(DQ, MAX_DV), the V tile's (columns
// past D or Dv are zero in the shared tiles and never stored)
template <int DQ_, int DV_>
struct Cfg {
  static constexpr int DQ = DQ_, DV = DV_;
  static_assert(DQ % 32 == 0 && DQ <= MAX_D &&
                DV == (DQ < MAX_DV ? DQ : MAX_DV), "head-dim tiles");
  static constexpr int MR = 4;                  // query rows a thread
  static constexpr int WR = 4 * MR;             // query rows a warp
  static constexpr int WARPS = BM / WR;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int GPS = WR / 8;            // key groups a sub-block
  static constexpr int SB = BN / WR;            // WR-key sub-blocks a tile
  static_assert(SB == 4, "logits() has a case for each sub-block");
  static constexpr int LD = DQ + 4;             // floats a Q or K row
  static constexpr int LDV = DV + 4;            // floats a V row
  static constexpr int NC = DV / 32;            // 4-column O chunks a thread
  static constexpr int Q_FLOATS = BM * LD;
  static constexpr int K_FLOATS = BN * LD;
  static constexpr int V_FLOATS = BN * LDV;
  // P takes the K tile's place once every warp has its logits, where a
  // 64-key row fits in a K row; otherwise a region of its own
  static constexpr bool P_IN_K = LD >= BN + 4;
  static constexpr int LDP = P_IN_K ? LD : BN + 8;   // floats a P row
  static constexpr int SMEM = static_cast<int>(sizeof(float)) *
                              (Q_FLOATS + K_FLOATS + V_FLOATS +
                               (P_IN_K ? 0 : BM * LDP));
  static_assert(SMEM <= 232448, "shared memory of a block");
  // blocks a SM asked of ptxas's register allocation: 3 at D <= 64 (168
  // registers a thread; 4, which shared memory would allow, spills), else
  // as many as shared memory holds (2 up to DQ 128, 1 above)
  static constexpr int MIN_BLOCKS =
      SMEM <= 56 * 1024 ? 3 : SMEM <= 113 * 1024 ? 2 : 1;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// component c (0..3, known at compile time) of a float4
__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// 16 bytes global -> shared, or 16 zero bytes when !full
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0 + ROWS - 1 of one head (row stride ss, D columns) into a
// ROWS x W float tile whose rows are LDW floats apart; rows >= L and
// columns >= D become zero
template <typename T, class C, int W, int LDW, int ROWS, bool ASYNC>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int L, long long ss, int D) {
  if constexpr (ASYNC) {
    constexpr int CH = W / 4;
    for (int i = threadIdx.x; i < ROWS * CH; i += C::THREADS) {
      const int r = i / CH, c = (i - r * CH) * 4;
      const bool ok = r0 + r < L && c < D;
      cp_async16(dst + r * LDW + c, ok ? src + (r0 + r) * ss + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * W; i += C::THREADS) {
      const int r = i / W, c = i - r * W;
      float x = 0.0f;
      if (r0 + r < L && c < D) x = to_float(src[(r0 + r) * ss + c]);
      dst[r * LDW + c] = x;
    }
  }
}

// Does the thread's logit pair (row group i, key group j) hold a key that
// a row of the group sees?  Always outside the diagonal (TRI < 0); on the
// diagonal sub-block TRI only where 8 jj <= 4 i + 3 (jj = j - TRI * GPS);
// never past it.
template <class C, int TRI>
__host__ __device__ constexpr bool active(int i, int j) {
  constexpr int G = C::GPS;
  return TRI < 0 || j / G < TRI ||
         (j / G == TRI && 8 * (j - TRI * G) <= 4 * i + 3);
}

// S = Q K^T of one 64-key tile on the thread's active pairs (the only
// part specialised by TRI: the products are where the diagonal's skipped
// pairs save time; the rest of the tile is one copy of code)
template <class C, int TRI>
__device__ __forceinline__ void tile_logits(
    const float* __restrict__ Qw, const float* __restrict__ Kt, int tr,
    int tc, float (&s)[C::MR][8]) {
  constexpr int MR = C::MR, LD = C::LD, DP = C::DQ;
  constexpr int JN = TRI < 0 ? 8 : (TRI + 1) * C::GPS;   // groups touched
#pragma unroll 1
  for (int d = 0; d < DP; d += 4) {
    // every operand of the step first, so that one load latency is paid
    // a step and not one a row
    float4 kf[JN], qf[MR];
#pragma unroll
    for (int j = 0; j < JN; ++j)
      kf[j] = *reinterpret_cast<const float4*>(Kt + (tc + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < MR; ++i)
      qf[i] = *reinterpret_cast<const float4*>(Qw + (tr + 4 * i) * LD + d);
#pragma unroll
    for (int i = 0; i < MR; ++i)
      // a column of D at a time over every key, so that consecutive FFMAs
      // of a logit lie JN instructions apart
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < JN; ++j)
          if (active<C, TRI>(i, j))
            s[i][j] = fmaf(lane4(qf[i], c), lane4(kf[j], c), s[i][j]);
  }
}

// 2^x in one MUFU op (denormal results flush to 0: a weight below 2^-126
// of the row's largest, as the bound allows)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of a 64-key tile on the thread's pairs: ``tri`` is the warp's
// diagonal sub-block in this tile, or -1.  Key groups past it are never
// read (masked for every row of the warp), and the pairs that active()
// skips are masked by causality, so the softmax needs no other test.
template <class C>
__device__ __forceinline__ void logits(const float* __restrict__ Qw,
                                       const float* __restrict__ Kt, int tr,
                                       int tc, int tri,
                                       float (&s)[C::MR][8]) {
#pragma unroll
  for (int i = 0; i < C::MR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
  switch (tri) {
    case -1: tile_logits<C, -1>(Qw, Kt, tr, tc, s); break;
    case 0: tile_logits<C, 0>(Qw, Kt, tr, tc, s); break;
    case 1: tile_logits<C, 1>(Qw, Kt, tr, tc, s); break;
    case 2: tile_logits<C, 2>(Qw, Kt, tr, tc, s); break;
    case 3: tile_logits<C, 3>(Qw, Kt, tr, tc, s); break;
  }
}

// The online softmax of the tile's logits, P to the warp's shared rows,
// O += P V.
template <class C>
__device__ __forceinline__ void softmax_pv(
    float (&s)[C::MR][8], const float* __restrict__ Vt,
    float* __restrict__ Pw, int tr, int tc, int wq0, int k0, int kv_len,
    int causal, int off, int tri, float (&m)[C::MR], float (&l)[C::MR],
    float (&acc)[C::MR][4 * C::NC]) {
  constexpr int MR = C::MR, LDV = C::LDV, LDP = C::LDP, NC = C::NC;
  const int jn = tri < 0 ? 8 : (tri + 1) * C::GPS;      // groups touched
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int row = wq0 + tr + 4 * i;
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + tc + 8 * j;
      const bool ok = key < kv_len && (!causal || key <= row + off);
      s[i][j] = ok ? s[i][j] : -INFINITY;
      mt = fmaxf(mt, s[i][j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
    const float m_new = fmaxf(m[i], mt);
    const float corr = fast_exp2(m[i] - m_new);
    m[i] = m_new;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = fast_exp2(s[i][j] - m_new);   // masked: 2^-inf = 0
      rs += p;
      Pw[(tr + 4 * i) * LDP + tc + 8 * j] = p;
    }
    l[i] = l[i] * corr + rs;                      // this lane's keys only
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
  }
  __syncwarp();

#pragma unroll 1
  for (int j = 0; j < jn; ++j) {
    // the first row group with a key of group j (active() by rows)
    const int imin = (tri < 0 || j < tri * C::GPS) ? 0
                                                    : 2 * (j - tri * C::GPS);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // 4 keys: their V rows and every row's 4 weights, loaded first
      const int c0 = 8 * j + 4 * h;
      float4 vv[4][NC], pp[MR];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int u = 0; u < NC; ++u)
          vv[e][u] = *reinterpret_cast<const float4*>(
              Vt + (c0 + e) * LDV + 32 * u + 4 * tc);
#pragma unroll
      for (int i = 0; i < MR; ++i)
        pp[i] = *reinterpret_cast<const float4*>(Pw + (tr + 4 * i) * LDP + c0);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        if (i < imin) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < NC; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][4 * u + c] = fmaf(lane4(pp[i], e), lane4(vv[e][u], c),
                                       acc[i][4 * u + c]);
      }
    }
  }
}

template <typename T, int DQ, int DV, bool ASYNC>
__global__ void __launch_bounds__(Cfg<DQ, DV>::THREADS,
                                  Cfg<DQ, DV>::MIN_BLOCKS)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int H, int group, int S, int Tk, int D, int Dv,
                            Strides sq, Strides sk, Strides sv, Strides so,
                            float scale, int causal, int off,
                            const int* __restrict__ kv_valid) {
  using C = Cfg<DQ, DV>;
  constexpr int MR = C::MR, NC = C::NC, LD = C::LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                               // BM x LD, scaled
  float* Ks = Qs + C::Q_FLOATS;                   // BN x LD, then P
  float* Vs = Ks + C::K_FLOATS;                   // BN x LDV
  float* Ps = C::P_IN_K ? Ks : Vs + C::V_FLOATS;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;
  T* op = o + b * so.b + h * so.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = lane >> 3, tc = lane & 7;
  const int wq0 = q0 + warp * C::WR;              // the warp's first row

  // keys past kv_len, and under causal past the last query row's
  // diagonal, are masked for every row of the block (of the warp)
  const int kv_len =
      kv_valid == nullptr ? Tk : min(Tk, max(0, __ldg(kv_valid + b)));
  const int dq = wq0 + off;                       // the warp's diagonal key
  const int kv_end = max(0, causal ? min(kv_len, q0 + BM + off) : kv_len);
  const int w_end =
      wq0 >= S ? 0 : max(0, causal ? min(kv_len, dq + C::WR) : kv_len);
  const int ntiles = (kv_end + BN - 1) / BN;
  // the diagonal sub-blocks line up with the key groups only when off is a
  // multiple of WR; otherwise every tile is computed whole and masked
  const bool aligned = off % C::WR == 0;

  if (ntiles > 0) load_rows<T, C, DQ, LD, BM, ASYNC>(Qs, qp, q0, S, sq.s, D);
  float m[MR], l[MR], acc[MR][4 * NC];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    // the tile's K and V (the slots were freed by the last barrier); the
    // first comes with Q
    load_rows<T, C, DQ, LD, BN, ASYNC>(Ks, kp, t * BN, Tk, sk.s, D);
    load_rows<T, C, DV, C::LDV, BN, ASYNC>(Vs, vp, t * BN, Tk, sv.s, Dv);
    if constexpr (ASYNC) {
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {   // fold scale * log2(e) into Q once
      const float c = scale * LOG2E;
      for (int i = threadIdx.x; i < BM * DQ; i += C::THREADS) {
        const int r = i / DQ, d = i - r * DQ;
        Qs[r * LD + d] *= c;
      }
      __syncthreads();
    }
    const int k0 = t * BN;
    const bool busy = k0 < w_end;
    // the sub-block of this tile on the warp's diagonal, or -1
    const int tri =
        causal && aligned && k0 + BN - 1 > dq ? (dq - k0) / C::WR : -1;
    float s[MR][8];
    if (busy) logits<C>(Qs + warp * C::WR * LD, Ks, tr, tc, tri, s);
    if (C::P_IN_K) __syncthreads();   // every warp is done with K: P may land
    if (busy)
      softmax_pv<C>(s, Vs, Ps + warp * C::WR * C::LDP, tr, tc, wq0, k0,
                     kv_len, causal, off, tri, m, l, acc);
    __syncthreads();   // K, V and P are consumed
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
    float ls = l[i];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    ls += __shfl_xor_sync(0xffffffffu, ls, 4);
    const int r = wq0 + tr + 4 * i;
    if (r >= S) continue;
    const float inv = 1.0f / fmaxf(ls, 1e-30f);
    T* orow = op + r * so.s;
#pragma unroll
    for (int u = 0; u < NC; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 32 * u + 4 * tc + e;
        if (d < Dv) store(orow + d, acc[i][4 * u + e] * inv);
      }
  }
}

template <typename T, int DQ, int DV, bool ASYNC>
int launch_cfg(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hk, int S, int Tk, int D, int Dv, const Strides* st,
               float scale, int causal, int off, const int* kv_valid,
               cudaStream_t stream) {
  using C = Cfg<DQ, DV>;
  auto kernel = flash_attention_simt_kernel<T, DQ, DV, ASYNC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + BM - 1) / BM);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / Hk, S, Tk, D, Dv,
      st[0], st[1], st[2], st[3], scale, causal, off, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DQ>
int launch_dq(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hk, int S, int Tk, int D, int Dv, const Strides* st,
              float scale, int causal, int off, const int* kv_valid,
              bool async, cudaStream_t stream) {
  constexpr int DV = DQ < MAX_DV ? DQ : MAX_DV;
  if constexpr (sizeof(T) == 4) {
    if (async)
      return launch_cfg<T, DQ, DV, true>(q, k, v, o, B, H, Hk, S, Tk, D, Dv,
                                         st, scale, causal, off, kv_valid,
                                         stream);
  }
  return launch_cfg<T, DQ, DV, false>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st,
                                      scale, causal, off, kv_valid, stream);
}

// float32 rows that cp.async can copy 16 bytes at a time: base pointers,
// D, Dv and every (b, h, s) stride of an axis longer than 1 in 16-byte
// units
inline bool copies_async(const void* const* ptrs, const Strides* st, int B,
                         int H, int Hk, int S, int Tk, int D, int Dv) {
  auto fits = [](long long stride, int extent) {
    return extent == 1 || stride % 4 == 0;
  };
  if (D % 4 || Dv % 4) return false;
  const int ext[3][3] = {{B, H, S}, {B, Hk, Tk}, {B, Hk, Tk}};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 ||
        !fits(st[i].b, ext[i][0]) || !fits(st[i].h, ext[i][1]) ||
        !fits(st[i].s, ext[i][2]))
      return false;
  return true;
}

// the Q/K tile: the larger head dim rounded up to a multiple of 32
template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hk, int S, int Tk, int D, int Dv, const Strides* st,
             float scale, int causal, int off, const int* kv_valid,
             cudaStream_t stream) {
  const void* ptrs[3] = {q, k, v};
  const bool async =
      sizeof(T) == 4 && copies_async(ptrs, st, B, H, Hk, S, Tk, D, Dv);
  const int w = D > Dv ? D : Dv;
  if (w <= 32)
    return launch_dq<T, 32>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st, scale,
                            causal, off, kv_valid, async, stream);
  if (w <= 64)
    return launch_dq<T, 64>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st, scale,
                            causal, off, kv_valid, async, stream);
  if (w <= 96)
    return launch_dq<T, 96>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st, scale,
                            causal, off, kv_valid, async, stream);
  if (w <= 128)
    return launch_dq<T, 128>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st, scale,
                             causal, off, kv_valid, async, stream);
  if (w <= 160)
    return launch_dq<T, 160>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st, scale,
                             causal, off, kv_valid, async, stream);
  return launch_dq<T, 192>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st, scale,
                           causal, off, kv_valid, async, stream);
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

// DQ, DV: the tile widths of Q/K and of V, the head dims rounded up to
// (64, 64), (128, 128) or (192, 128) (TMA fills the rest with 0); BN: keys
// per tile.  Shared memory holds Q (NQ chunks of BM rows) and STAGES
// stages of K (NQ chunks of BN rows) and V (NV chunks of BN rows), every
// chunk a [rows][64] bf16 tile in the 128-byte swizzle, 1024-byte
// aligned.  At (192, 128): 73,728 bytes of Q and three stages of 24,576 +
// 16,384, 197,712 bytes in all.
template <int DQ, int DV>
struct Cfg {
  static_assert(DQ % CHUNK == 0 && DV % CHUNK == 0 && DV <= DQ &&
                DQ <= MAX_D && DV <= MAX_DV, "head-dim tiles");
  static constexpr int BN = DQ == 64 ? 128 : 64;
  static constexpr int NQ = DQ / CHUNK;
  static constexpr int NV = DV / CHUNK;
  static constexpr int Q_BYTES = NQ * BM * ROW;
  static constexpr int K_BYTES = NQ * BN * ROW;         // one stage
  static constexpr int V_BYTES = NV * BN * ROW;         // one stage
  static constexpr int BARS = 1 + 3 * STAGES;           // q, k, v, empty
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * (K_BYTES + V_BYTES) + 8 * BARS;
  static_assert(SMEM <= 232448, "shared memory of a block");
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
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, Strides so, int H,
                          int group, int S, int Tk, int Dv, float scale_log2,
                          int causal, int off,
                          const int* __restrict__ kv_valid) {
  using C = Cfg<DQ, DV>;
  constexpr int BN = C::BN, NQ = C::NQ, NV = C::NV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + C::Q_BYTES;                  // + stage * K_BYTES
  const uint32_t sv = sk + STAGES * C::K_BYTES;         // + stage * V_BYTES
  const uint32_t bars = sv + STAGES * C::V_BYTES;
  const uint32_t bar_q = bars;
  // full barriers of the K and V stages, and the stage's empty barrier
  auto bar_k = [&](int s) { return bars + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto bar_e = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest tiles first
  // keys past kv_len, and under causal past the tile's last query row's
  // diagonal, are masked for every row of it.  At least one tile is
  // visited, so that a block whose rows see no key (l = 0) runs the same
  // code and writes 0; its keys may be loaded and are all masked.
  const int kv_len =
      kv_valid == nullptr ? Tk : min(Tk, max(0, __ldg(kv_valid + b)));
  const int kv_end = max(0, causal ? min(kv_len, q0 + BM + off) : kv_len);
  const int n_tiles = max(1, (kv_end + BN - 1) / BN);
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
      for (int c = 0; c < NQ; ++c)
        tma_load(sq + c * BM * ROW, &tq, bar_q, c * CHUNK, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_e(s), ((j / STAGES) - 1) & 1);
        const uint32_t kd = sk + s * C::K_BYTES, vd = sv + s * C::V_BYTES;
        mbar_expect_tx(bar_k(s), C::K_BYTES);
        for (int c = 0; c < NQ; ++c)
          tma_load(kd + c * BN * ROW, &tk, bar_k(s), c * CHUNK, j * BN, hk, b);
        mbar_expect_tx(bar_v(s), C::V_BYTES);
        for (int c = 0; c < NV; ++c)
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
  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float sc[BN / 2];              // S of a tile, then its p
  uint32_t pa[BN / 16][4];       // p in bf16: the A operand of P V

  // S = Q K^T of tile j into sc, issued, not waited for
  auto issue_s = [&](int j) {
    const uint32_t kb = sk + (j % STAGES) * C::K_BYTES;
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
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
    const uint32_t vb = sv + (j % STAGES) * C::V_BYTES;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs<DV>(acc, pa[kk],
                   desc_sw128(vb + kk * 16 * ROW,
                              NV > 1 ? BN * ROW : 8 * ROW, 8 * ROW),
                   1);
    wgmma_commit();
  };
  // online softmax of tile j in sc, in log2 units: sc becomes p, l and m
  // move on, and corr is what O must be scaled by before P V of tile j
  auto softmax = [&](int j, float* corr) {
    const int k0 = j * BN;
    const bool masked =
        k0 + BN > kv_len || (causal && k0 + BN - 1 > q0 + 64 * wg + off);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int half = (i >> 1) & 1;
      float x = sc[i];
      if (masked) {
        const int col = k0 + 8 * (i / 4) + c0 + (i & 1);
        if (col >= kv_len || (causal && col > r0 + 8 * half + off))
          x = -INFINITY;
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
    fence_regs<DV / 2>(acc);
    wgmma_fence();
    issue_s(j);
    issue_pv(j - 1);
    wgmma_wait<1>();             // S of tile j is in
    fence_regs<BN / 2>(sc);
    softmax(j, corr);
    wgmma_wait<0>();             // P V of tile j - 1 is in
    fence_regs<DV / 2>(acc);
    mbar_arrive(bar_e((j - 1) % STAGES));
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    pack_p();
  }
  mbar_wait(bar_v((n_tiles - 1) % STAGES), parity(n_tiles - 1));
  __syncwarp();
  fence_regs<DV / 2>(acc);
  wgmma_fence();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs<DV / 2>(acc);
  mbar_arrive(bar_e((n_tiles - 1) % STAGES));

  // epilogue: 1/l once, rows >= S and columns >= Dv never stored
  __nv_bfloat16* op = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    const int row = r0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int jn = 0; jn < DV / 8; ++jn) {
      const int col = 8 * jn + c0;
      if (col < Dv)
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

template <int DQ, int DV>
int launch_dp(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hk, int S, int Tk, int D, int Dv, const Strides* st,
              float scale, int causal, int off, const int* kv_valid,
              cudaStream_t stream) {
  using C = Cfg<DQ, DV>;
  CUtensorMap maps[3];
  int rc = encode(&maps[0], q, B, H, S, D, st[0], BM);
  if (rc == 0) rc = encode(&maps[1], k, B, Hk, Tk, D, st[1], C::BN);
  if (rc == 0) rc = encode(&maps[2], v, B, Hk, Tk, Dv, st[2], C::BN);
  if (rc != 0) return rc;
  auto kernel = flash_attention_tc_kernel<DQ, DV>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + BM - 1) / BM);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), st[3], H,
      H / Hk, S, Tk, Dv, scale * LOG2E, causal, off, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

extern "C" int flash_attention_max_head_dim() { return MAX_D; }
extern "C" int flash_attention_max_v_head_dim() { return MAX_DV; }


// The CUDA-core kernel.  dtype: 0 float32, 1 bfloat16 (q, k, v and o
// alike).  D is the head dim of q and k, Dv that of v and o.  Strides in
// elements, (b, h, s) of q, k, v, o in that order.  q_offset: query i sits
// at key position i + q_offset under causal; kv_valid: nullptr or a (B,)
// int32 device array, keys j >= kv_valid[b] masked.  The wrapper checks
// shapes, D <= MAX_D, Dv <= MAX_DV, H % Hk == 0 and grid limits; returns
// cudaGetLastError() of the launch.
extern "C" int flash_attention_simt_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Hk, int S, int Tk, int D, int Dv, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, float scale, int causal,
    int q_offset, const int* kv_valid, void* stream) {
  if (D < 1 || D > MAX_D || Dv < 1 || Dv > MAX_DV || Hk < 1 ||
      H % Hk != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                         {osb, osh, oss}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return simt::launch_t<float>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st,
                                 scale, causal, q_offset, kv_valid, s);
  return simt::launch_t<__nv_bfloat16>(q, k, v, o, B, H, Hk, S, Tk, D, Dv,
                                       st, scale, causal, q_offset, kv_valid,
                                       s);
}

// The instance of the tensor-core kernel that takes head dims (D, Dv):
// (64, 64) when both are at most 64, (128, 128) when both are at most 128,
// else (192, 128); 0 where there is none.
inline int tc_instance(int D, int Dv) {
  if (D <= 64 && Dv <= 64) return 64;
  if (D <= 128 && Dv <= 128) return 128;
  return D <= MAX_D && Dv <= MAX_DV ? 192 : 0;
}

// The tensor-core kernel: bf16 only, D and Dv multiples of 8 up to MAX_D
// and MAX_DV, every base pointer 16-byte aligned, every (b, h, s) stride
// of an axis longer than 1 a positive multiple of 16 bytes and scale > 0
// (the wrapper's rule; refused here with cudaErrorInvalidValue
// otherwise).  Same arguments as above without dtype; returns
// cudaGetLastError() of the launch, or TMA_ERROR + the CUresult of a
// tensor map that would not encode.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hk, int S, int Tk, int D, int Dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, int q_offset,
    const int* kv_valid, void* stream) {
  const Strides st[4] = {{qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
                         {osb, osh, oss}};
  const void* ptrs[4] = {q, k, v, o};
  const int ext[4][3] = {{B, H, S}, {B, Hk, Tk}, {B, Hk, Tk}, {B, H, S}};
  // a stride of an axis of extent 1 is never used
  auto fits = [](long long stride, int extent) {
    return extent == 1 || (stride > 0 && stride % 8 == 0);
  };
  bool ok = D >= 8 && D % 8 == 0 && Dv >= 8 && Dv % 8 == 0 &&
            tc_instance(D, Dv) != 0 && Hk >= 1 && H % Hk == 0 &&
            scale > 0.0f;
  for (int i = 0; i < 4; ++i)
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0 &&
         fits(st[i].b, ext[i][0]) && fits(st[i].h, ext[i][1]) &&
         fits(st[i].s, ext[i][2]);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tc_instance(D, Dv)) {
    case 64:
      return tc::launch_dp<64, 64>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st,
                                   scale, causal, q_offset, kv_valid, s);
    case 128:
      return tc::launch_dp<128, 128>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st,
                                     scale, causal, q_offset, kv_valid, s);
    default:
      return tc::launch_dp<192, 128>(q, k, v, o, B, H, Hk, S, Tk, D, Dv, st,
                                     scale, causal, q_offset, kv_valid, s);
  }
}

// dynamic shared memory of the tensor-core kernel at head dims (D, Dv),
// 0 where no instance takes them
extern "C" int flash_attention_tc_smem_bytes(int D, int Dv) {
  switch (tc_instance(D, Dv)) {
    case 64: return tc::Cfg<64, 64>::SMEM;
    case 128: return tc::Cfg<128, 128>::SMEM;
    case 192: return tc::Cfg<192, 128>::SMEM;
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= tc::TMA_ERROR)
    return "cuTensorMapEncodeTiled refused a tensor map (code - 10000 is "
           "its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
