// Banded squared DTW for the SSH re-rank stage: two entry points, each
// with two schedules.
//
// 1. dtw_wavefront_pairs_launch replaces the TPU kernel
//    repro/kernels/dtw_wavefront.py::dtw_wavefront_pairs (_kernel,
//    _kernel_thr, _make_step): the batched searcher's seed and survivor
//    DTW.
//
//      queries (P, m) f32, candidates (P, m) f32, radius r, thr (P,) or
//      none  ->  out (P,) f32, and cells (P,) int32 when not null
//      out[p] = banded (|i - j| <= r) squared DTW of the pair; with thr,
//      the exact cost when it is <= thr[p] and BIG = 1e30 otherwise.
//      cells[p] = the band's cells the pair's schedule computed before it
//      ended or was abandoned: A, those of the rows its block swept; B,
//      those of the diagonals its warp stepped.  A closed form at exit,
//      one store a pair (band_rows, band_diagonals); the loops count
//      nothing.  The count is a template flag (COUNT), so a launch with
//      cells null runs the instance that has no trace of it.
//
// 2. dtw_wavefront_launch replaces repro/kernels/dtw_wavefront.py::
//    dtw_wavefront (one query against a candidate block): the sequential
//    re-rank and the UCR-suite scan.
//
//      query (m,) f32, candidates (C, m) f32, radius r, thr scalar, (C,)
//      or none  ->  out (C,) f32, the same contract per candidate.
//
// Every cell is fminf(__fadd_rn(__fmul_rn(d, d), best), BIG) with
// d = __fsub_rn(q[i], x[j]) and best the minimum of its three
// neighbours (0 at (0, 0), BIG outside the band or the matrix).  The
// explicit round-to-nearest intrinsics keep nvcc from contracting into
// an FMA, and min is exact and commutative, so any schedule that computes
// each cell once from its three finished neighbours gives the bits of the
// plain anti-diagonal wavefront (kernels.ref.dtw_pairs_ref).  An early
// abandon may use any sound lower bound: only the output is contracted
// (exact where <= thr, else BIG, strict >).
//
// Bound on the H100: operations.  A cell is a subtract, a multiply, an
// add and three mins, none of which fuses, against 8 bytes of input per
// row and pair.  The min-plus recurrence has no tensor-core form, so the
// limit is instruction issue (4 warp instructions a clock on each SM),
// and for few pairs the dependency chain of one pair.
//
// Schedule A, "rows" (dtw_rows_kernel): one thread per pair, many pairs.
// The thread sweeps the rows j of the candidate in band coordinates,
// u = i - j + r in [0, 2r], and keeps the row's 2r + 1 costs in
// registers R[k], k = u + off, updated in place from left to right:
//   D[j-1, i-1] = R[k] (old), D[j-1, i] = R[k+1] (old), D[j, i-1] = left.
// (Rows run along the candidate: the DP is symmetric under transposing,
// cell for cell.)  R holds W slots, a compile-time multiple of 8 up to
// 128, and the band sits at its right end (off = W - 1 - 2r < 8), so the
// slots left of the band stay BIG and a row starts with a jump to slot
// off among the first 8, then runs the rest straight: no slot tests its
// bounds.  A cell is computed as min(fl(c + left), min(fl(c + min(diag,
// top)), BIG)), equal to the clamped fl(c + best) bit for bit (row_slot),
// so that only an add and a min lie on the chain from one cell to the
// next.  The query side is padded with +inf, so a cell left or right of
// the matrix costs inf and clamps to BIG by the cell formula itself.  The
// one operand that changes per cell is read from shared memory at an
// immediate offset: the padded query, a broadcast read, for the
// single-query kernel; a (time, pair) tile, one bank per lane, for pairs.
// The candidates come in 32-row (time, pair) tiles.  A block is one warp
// of 32 pairs; with a threshold, the row minimum (a sound bound: every
// warping path crosses every row) is tested after each tile, and the
// block ends when all 32 pairs are past their thresholds.  8 instructions
// a cell: one shared load, the sub and mul, two adds, three mins.
//
// Schedule B, "diagonals" (dtw_diag_kernel): one warp per pair, for few
// pairs (the latency of one pair then sets the time) and for bands wider
// than A's registers, up to r = 1023.  The warp walks the 2m - 1
// anti-diagonals, an even and an odd one a turn; only the in-band cells
// of diagonal d get slots, i = lo(d) + s with lo(d) = ceil((d - r) / 2)
// and s in [0, r + 1), S consecutive slots a lane (S = 1 up to r = 31).
// Then
//   D[i-1, j-1] = prev2[s], and {D[i-1, j], D[i, j-1]} =
//   {prev1[s-1], prev1[s]} when d - r is even, {prev1[s], prev1[s+1]}
//   when it is odd,
// one shuffle a diagonal across lanes.  The rows sit in shared memory
// padded on both sides (+inf next to the matrix), so no load is guarded;
// a slot past the band gets an infinite cost and so BIG, and only an add
// and a min follow the shuffle on the chain.  With a threshold the warp
// reduces the minimum of its two live diagonals (a sound bound: every
// path crosses one of them) every check_every diagonals and abandons once
// it exceeds thr.  A block is one warp, so 300 candidates spread over the
// 132 SMs.
//
// kernels/dtw_wavefront.py::dtw_schedule is the written rule that picks
// A or B; either can be asked for directly.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 32;           // candidate rows per shared-memory tile (A)
constexpr int LD = 33;             // row stride of A's (time, pair) tiles
constexpr int ROWS_MAX_W = 128;    // widest slot class of A: r <= 63
constexpr int DIAG_MAX_S = 32;     // slots a lane of B: r <= 1023
constexpr int SMEM_MAX = 232448;   // 227 KB a block

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// Band cells (i, j), |i - j| <= r, of an m x m matrix in rows j < J:
// row j holds min(m, j + r + 1) - max(0, j - r) of them.
__device__ __forceinline__ long long band_rows(int m, int r, int J) {
  const long long t = max(0, min(m - r, J));    // rows with j + r + 1 <= m
  const long long u = max(0, J - r - 1);        // rows with j > r
  return t * (t - 1) / 2 + t * (r + 1) + (J - t) * m - u * (u + 1) / 2;
}

// Band cells on the anti-diagonals d = i + j < D.  Up to d = m - 1 the
// matrix clips nothing: diagonal d holds d + 1 cells while d <= r, then
// r + 1 and r in turn (r + 1 where d - r is even); past the middle the
// count is the whole band's less that of the 2m - 1 - D diagonals at the
// far corner, by the symmetry (i, j) -> (m - 1 - i, m - 1 - j).
__device__ __forceinline__ long long band_diagonals(int m, int r, int D) {
  const bool far = D > m;
  const long long e = far ? 2 * m - 1 - D : D;
  const long long a = min(e, static_cast<long long>(r) + 1);
  const long long n = max(0LL, e - r - 1);
  const long long near = a * (a + 1) / 2 + n * r + n / 2;
  return far ? band_rows(m, r, m) - near : near;
}

// dst = src[i] for i in [0, m), else +inf: an asynchronous 4-byte copy
// global -> shared (cp.async), so that a lane's copies are all in flight
// at once; copies_done() waits for them
__device__ __forceinline__ void copy_or_inf(float* dst, const float* src,
                                            int i, int m) {
  if (i >= 0 && i < m) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src + i) : "memory");
  } else {
    *dst = pos_inf();
  }
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c ? a : b, opaque to the compiler: a chain of these over a register
// array (R[k] picked where k equals a runtime index) is not folded into a
// dynamically indexed load, which would move the array to local memory
__device__ __forceinline__ float pick(bool c, float a, float b) {
  float out;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(out) : "f"(a), "f"(b), "r"(static_cast<unsigned>(c)));
  return out;
}

// -- schedule A ----------------------------------------------------------

// Slot K of a row: D[j, i] from R[K] (diagonal), R[K + 1] (top) and the
// slot just computed (left), as
//   min(fl(c + left), min(fl(c + min(diag, top)), BIG)),  c = fl(d * d),
// which is fl(c + min(diag, top, left)) clamped to BIG, bit for bit:
// x -> fl(c + x) is monotone, so it commutes with min.  The chain from
// one slot to the next is then one add and one min.
template <int K, int W>
__device__ __forceinline__ void row_slot(float (&R)[W], float qv, float xv,
                                         float& left) {
  float top;
  if constexpr (K + 1 < W) top = R[K + 1];
  else top = BIG;
  const float d = __fsub_rn(qv, xv);
  const float c = __fmul_rn(d, d);
  const float y = fminf(__fadd_rn(c, fminf(R[K], top)), BIG);
  const float v = fminf(__fadd_rn(c, left), y);
  R[K] = v;
  left = v;
}

template <int W, int QS, int... K>
__device__ __forceinline__ void row_tail(float (&R)[W], const float* qb,
                                         float xv, float& left,
                                         std::integer_sequence<int, K...>) {
  (row_slot<K + 8, W>(R, qb[(K + 8) * QS], xv, left), ...);
}

#define DTW_CASE(k)                               \
  case (k):                                       \
    row_slot<(k), W>(R, head[(k)], xv, left);     \
    [[fallthrough]];

// One row: slots off .. W-1 (the band), off in [0, 8).  qb[k * QS] is the
// query of slot k; the operand is padded so that the first 8 exist even
// left of the band, and they are loaded before the jump to slot off, so
// that no load waits behind it.
template <int W, int QS>
__device__ __forceinline__ void row_sweep(float (&R)[W], const float* qb,
                                          float xv, int off) {
  float head[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) head[k] = qb[k * QS];
  float left = BIG;
  switch (off) {
    DTW_CASE(0) DTW_CASE(1) DTW_CASE(2) DTW_CASE(3)
    DTW_CASE(4) DTW_CASE(5) DTW_CASE(6) DTW_CASE(7)
    default: break;
  }
  row_tail<W, QS>(R, qb, xv, left, std::make_integer_sequence<int, W - 8>{});
}

#undef DTW_CASE

// W: slot class (2r + 1 <= W); ONE: one query for every pair (q is (m,)),
// else q is (P, m).  thr_stride 0: one threshold for all, 1: thr[p].
// COUNT: cells[p] = the band cells of the rows the block swept.
template <int W, bool HAS_THR, bool ONE, bool COUNT>
__global__ void __launch_bounds__(32)
dtw_rows_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const float* __restrict__ thr, int thr_stride,
                float* __restrict__ out, int* __restrict__ cells, int P,
                int m, int r) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long long p0 = static_cast<long long>(blockIdx.x) * 32;
  const long long p = p0 + lane;
  const int n_here = static_cast<int>(min(32LL, P - p0));
  const bool live = lane < n_here;
  // the query operand: ONE, the padded query qp[t] = q[t - r] (inf off
  // the series), m + 2r values; else a (TILE + 2r, LD) tile of each
  // pair's padded query for the rows of the current tile
  // (8 entries, or rows, in front: row_sweep loads 8 slots ahead of the
  // band's first)
  const int span = ONE ? m + 2 * r : TILE + 2 * r;
  float* qw = smem + (ONE ? 8 : 8 * LD);
  float* xt = qw + (ONE ? span : span * LD);       // (TILE, LD) candidates
  if (ONE) {
    for (int t = lane; t < span; t += 32) copy_or_inf(qw + t, q, t - r, m);
  }
  const int off = W - 1 - 2 * r;
  float R[W];
#pragma unroll
  for (int k = 0; k < W; ++k)              // row -1: 0 at u = r, the
    R[k] = pick(k == r + off, 0.0f, BIG);    // diagonal of cell (0, 0)
  const float t = (HAS_THR && live) ? thr[p * thr_stride] : 0.0f;
  bool dead = !live;

  [[maybe_unused]] int swept = m;            // rows the block swept
  for (int j0 = 0; j0 < m; j0 += TILE) {
    const int rows = min(TILE, m - j0);
    __syncthreads();                         // the last tile is consumed
    for (int pp = 0; pp < n_here; ++pp)      // coalesced along time
      if (lane < rows)
        copy_or_inf(xt + lane * LD + pp, x + (p0 + pp) * m, j0 + lane, m);
    if (!ONE) {
      for (int pp = 0; pp < n_here; ++pp)
        for (int tt = lane; tt < span; tt += 32)
          copy_or_inf(qw + tt * LD + pp, q + (p0 + pp) * m, j0 + tt - r, m);
    }
    copies_done();
    __syncthreads();
#pragma unroll 1
    for (int jj = 0; jj < rows; ++jj) {
      const float xv = xt[jj * LD + lane];
      if (ONE)
        row_sweep<W, 1>(R, qw + (j0 + jj - off), xv, off);
      else
        row_sweep<W, LD>(R, qw + (jj - off) * LD + lane, xv, off);
    }
    if (HAS_THR) {
      float lo = BIG;
#pragma unroll
      for (int k = 0; k < W; ++k) lo = fminf(lo, R[k]);
      dead = dead || lo > t;
      if (__syncthreads_and(dead)) {         // every pair past its bound
        if constexpr (COUNT) swept = j0 + rows;
        break;
      }
    }
  }
  if (!live) return;
  float v = BIG;
#pragma unroll
  for (int k = 0; k < W; ++k) v = pick(k == r + off, R[k], v);
  if (HAS_THR && (dead || v > t)) v = BIG;
  out[p] = v;
  if constexpr (COUNT) cells[p] = static_cast<int>(band_rows(m, r, swept));
}

// -- schedule B ----------------------------------------------------------

// Anti-diagonal d of B; EVEN: d - r is even (the neighbour set
// {prev1[s-1], prev1[s]}, r + 1 cells), else {prev1[s], prev1[s+1]}, r
// cells.  Slot s holds i = lo + s, j = d - i, lo = ceil((d - r) / 2).
template <int S, bool EVEN>
__device__ __forceinline__ void diag_step(float (&prev1)[S],
                                          float (&prev2)[S],
                                          const float* qp, const float* xp,
                                          int pad, int d, int r, int s0,
                                          int lane) {
  const int lo = (d - r + 1) >> 1;
  const int count = EVEN ? r + 1 : r;
  const float* qb = qp + pad + lo + s0;         // q[lo + s]
  const float* xb = xp + pad + d - lo - s0;     // x[d - lo - s]
  // off the chain: each slot's cost c, inf where the slot lies past the
  // band (its value is then BIG), and the cost the neighbour term adds,
  // inf also where that neighbour lies across the warp's edge
  const float inf = pos_inf();
  float c[S], cn[S];
#pragma unroll
  for (int e = 0; e < S; ++e) {
    const float dq = __fsub_rn(qb[e], xb[-e]);
    c[e] = s0 + e < count ? __fmul_rn(dq, dq) : inf;
    cn[e] = c[e];
  }
  if (EVEN ? lane == 0 : lane == 31) cn[EVEN ? 0 : S - 1] = inf;
  // the neighbour slot across the lane boundary
  const float nbx = EVEN ? __shfl_up_sync(FULL, prev1[S - 1], 1)
                         : __shfl_down_sync(FULL, prev1[0], 1);
  // min(fl(c + nb), min(fl(c + min(top or left, diag)), BIG)): the
  // clamped fl(c + best) bit for bit (row_slot says why), with one add and
  // one min after the shuffle
  float cur[S];
#pragma unroll
  for (int e = 0; e < S; ++e) {
    float nb;
    if (EVEN) nb = e > 0 ? prev1[e - 1] : nbx;
    else nb = e < S - 1 ? prev1[e + 1] : nbx;
    const float y = fminf(__fadd_rn(c[e], fminf(prev1[e], prev2[e])), BIG);
    cur[e] = fminf(__fadd_rn(cn[e], nb), y);
  }
#pragma unroll
  for (int e = 0; e < S; ++e) {
    prev2[e] = prev1[e];
    prev1[e] = cur[e];
  }
}

// COUNT: cells[p] = the band cells of the diagonals the warp stepped.
template <int S, bool HAS_THR, bool ONE, bool COUNT>
__global__ void __launch_bounds__(32)
dtw_diag_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const float* __restrict__ thr, int thr_stride,
                float* __restrict__ out, int* __restrict__ cells, int P,
                int m, int r, int check_every) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long long p = blockIdx.x;
  // in-band cells reach r/2 + 1 past either end of the matrix, and the
  // slots past the band up to 32 S more: their loads need no guard
  const int pad = r / 2 + 1 + 32 * S;
  const int len = m + 2 * pad;
  float* qp = smem;
  float* xp = smem + len;
  const float* qrow = ONE ? q : q + p * m;
  const float* xrow = x + p * m;
  for (int t = lane; t < len; t += 32) {
    copy_or_inf(qp + t, qrow, t - pad, m);
    copy_or_inf(xp + t, xrow, t - pad, m);
  }
  copies_done();
  __syncwarp();
  const float t = HAS_THR ? thr[p * thr_stride] : 0.0f;

  const int s0 = lane * S;
  float prev1[S], prev2[S];
#pragma unroll
  for (int e = 0; e < S; ++e) {
    prev1[e] = BIG;
    prev2[e] = pick(s0 + e == r / 2, 0.0f, BIG);  // (0, 0)'s diagonal
  }
  // d - r alternates parity: the loop takes an even and an odd diagonal
  // a turn (no branch on parity inside); an odd r starts with one odd
  // diagonal, an even number left ends with one even diagonal
  const int n_diag = 2 * m - 1;
  int d = 0;
  if (r & 1) {
    diag_step<S, false>(prev1, prev2, qp, xp, pad, 0, r, s0, lane);
    d = 1;
  }
  bool abandoned = false;
  int next_check = check_every - 1;
#pragma unroll 1
  for (; d + 1 < n_diag; d += 2) {
    diag_step<S, true>(prev1, prev2, qp, xp, pad, d, r, s0, lane);
    diag_step<S, false>(prev1, prev2, qp, xp, pad, d + 1, r, s0, lane);
    if (HAS_THR && d + 1 >= next_check) {
      next_check += check_every;
      float low = BIG;
#pragma unroll
      for (int e = 0; e < S; ++e) low = fminf(low, fminf(prev1[e], prev2[e]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        low = fminf(low, __shfl_xor_sync(FULL, low, o));
      if (low > t) {                  // warp-uniform after the reduction
        abandoned = true;
        break;
      }
    }
  }
  if (!abandoned && d < n_diag)
    diag_step<S, true>(prev1, prev2, qp, xp, pad, d, r, s0, lane);
  // (m-1, m-1) on the last diagonal
  const int s_end = (m - 1) - ((2 * m - 2 - r + 1) >> 1);
  float v = BIG;
#pragma unroll
  for (int e = 0; e < S; ++e) v = pick(s0 + e == s_end, prev1[e], v);
  v = __shfl_sync(FULL, v, s_end / S);
  if (HAS_THR && (abandoned || v > t)) v = BIG;
  if (lane == 0) out[p] = v;
  if (COUNT && lane == 0)              // an abandon leaves after d + 1
    cells[p] = static_cast<int>(
        band_diagonals(m, r, abandoned ? d + 2 : n_diag));
}

// -- launch ----------------------------------------------------------------

int rows_smem(bool one, int m, int r) {
  const int q = one ? 8 + m + 2 * r : (8 + TILE + 2 * r) * LD;
  return (q + TILE * LD) * static_cast<int>(sizeof(float));
}

int diag_slots(int r) {             // S of the launch (dispatch_diag)
  const int need = (r + 1 + 31) / 32;
  return need <= 8 ? need : need <= 16 ? 16 : DIAG_MAX_S;
}

int diag_smem(int m, int r) {
  const int pad = r / 2 + 1 + 32 * diag_slots(r);
  return 2 * (m + 2 * pad) * static_cast<int>(sizeof(float));
}

template <typename K>
int prepare(K kernel, int smem) {
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

struct Args {
  const float *q, *x, *thr;
  int thr_stride;
  float* out;
  int* cells;
  int P, m, r, check_every;
  cudaStream_t st;
};

template <int W, bool HAS_THR, bool ONE, bool COUNT>
int launch_rows(const Args& a) {
  auto kernel = dtw_rows_kernel<W, HAS_THR, ONE, COUNT>;
  const int smem = rows_smem(ONE, a.m, a.r);
  if (const int e = prepare(kernel, smem)) return e;
  const unsigned grid = static_cast<unsigned>((a.P + 31) / 32);
  kernel<<<grid, 32, smem, a.st>>>(a.q, a.x, a.thr, a.thr_stride, a.out,
                                   a.cells, a.P, a.m, a.r);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool HAS_THR, bool ONE, bool COUNT>
int launch_diag(const Args& a) {
  auto kernel = dtw_diag_kernel<S, HAS_THR, ONE, COUNT>;
  const int smem = diag_smem(a.m, a.r);
  if (const int e = prepare(kernel, smem)) return e;
  kernel<<<static_cast<unsigned>(a.P), 32, smem, a.st>>>(
      a.q, a.x, a.thr, a.thr_stride, a.out, a.cells, a.P, a.m, a.r,
      a.check_every);
  return static_cast<int>(cudaGetLastError());
}

template <bool HAS_THR, bool ONE, bool COUNT, int... C>
int rows_class(const Args& a, std::integer_sequence<int, C...>) {
  // the class W = 8 (c + 1) with 2r + 1 <= W: off = W - 1 - 2r in [0, 8)
  const int c = 2 * a.r / 8;
  int rc = static_cast<int>(cudaErrorInvalidValue);
  ((c == C ? (rc = launch_rows<8 * (C + 1), HAS_THR, ONE, COUNT>(a), 0)
            : 0), ...);
  return rc;
}

template <bool HAS_THR, bool ONE, bool COUNT>
int dispatch_rows(const Args& a) {
  return rows_class<HAS_THR, ONE, COUNT>(
      a, std::make_integer_sequence<int, ROWS_MAX_W / 8>{});
}

// S = slots a lane for r + 1 in-band cells: 1..8 exactly, then 16, 32
template <bool HAS_THR, bool ONE, bool COUNT>
int dispatch_diag(const Args& a) {
  switch ((a.r + 1 + 31) / 32) {
    case 1: return launch_diag<1, HAS_THR, ONE, COUNT>(a);
    case 2: return launch_diag<2, HAS_THR, ONE, COUNT>(a);
    case 3: return launch_diag<3, HAS_THR, ONE, COUNT>(a);
    case 4: return launch_diag<4, HAS_THR, ONE, COUNT>(a);
    case 5: return launch_diag<5, HAS_THR, ONE, COUNT>(a);
    case 6: return launch_diag<6, HAS_THR, ONE, COUNT>(a);
    case 7: return launch_diag<7, HAS_THR, ONE, COUNT>(a);
    case 8: return launch_diag<8, HAS_THR, ONE, COUNT>(a);
    default: break;
  }
  const int need = (a.r + 1 + 31) / 32;
  if (need <= 16) return launch_diag<16, HAS_THR, ONE, COUNT>(a);
  if (need <= DIAG_MAX_S)
    return launch_diag<DIAG_MAX_S, HAS_THR, ONE, COUNT>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool ONE, bool COUNT>
int dispatch_schedule(const Args& a, int schedule) {
  const bool thr = a.thr != nullptr;
  if (schedule == 0)
    return thr ? dispatch_rows<true, ONE, COUNT>(a)
               : dispatch_rows<false, ONE, COUNT>(a);
  if (schedule == 1)
    return thr ? dispatch_diag<true, ONE, COUNT>(a)
               : dispatch_diag<false, ONE, COUNT>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// schedule 0: rows (A), 1: diagonals (B); the counting instances exist
// for the pairs entry point alone (cells is null for the other)
template <bool ONE>
int dispatch(const Args& a, int schedule) {
  if (a.m < 1 || a.r < 0 || a.r > a.m - 1 || a.check_every < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!ONE) {
    if (a.cells != nullptr) return dispatch_schedule<false, true>(a, schedule);
  }
  return dispatch_schedule<ONE, false>(a, schedule);
}

}  // namespace

// Widest band of each schedule: A's registers (2r + 1 <= 128), B's
// slots (r + 1 <= 32 lanes of 32).
extern "C" int dtw_rows_max_radius() { return (ROWS_MAX_W - 1) / 2; }
extern "C" int dtw_pairs_max_radius() { return 32 * DIAG_MAX_S - 1; }

// Dynamic shared memory of a launch (schedule 0 rows, 1 diagonals;
// one: the single-query entry point); more than 232,448 is refused.
extern "C" int dtw_smem_bytes(int schedule, int one, int m, int r) {
  return schedule == 0 ? rows_smem(one != 0, m, r) : diag_smem(m, r);
}

// Longest series the diagonal schedule takes at every radius it takes.
extern "C" int dtw_max_length() {
  const int r_max = 32 * DIAG_MAX_S - 1;
  int m = 1;
  while (diag_smem(m + 1, m < r_max ? m : r_max) <= SMEM_MAX) ++m;
  return m;
}

extern "C" int dtw_wavefront_pairs_launch(const float* q, const float* x,
                                          const float* thr, float* out,
                                          int* cells, int P, int m, int r,
                                          int schedule, int check_every,
                                          void* stream) {
  return dispatch<false>(Args{q, x, thr, 1, out, cells, P, m, r,
                              check_every, static_cast<cudaStream_t>(stream)},
                         schedule);
}

extern "C" int dtw_wavefront_launch(const float* q, const float* x,
                                    const float* thr, int thr_stride,
                                    float* out, int C, int m, int r,
                                    int schedule, int check_every,
                                    void* stream) {
  return dispatch<true>(Args{q, x, thr, thr_stride, out, nullptr, C, m, r,
                             check_every, static_cast<cudaStream_t>(stream)},
                        schedule);
}

extern "C" const char* dtw_wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
