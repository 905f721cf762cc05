// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a), on the tensor cores.
//
// No Pallas counterpart: the TPU side differentiates its scan with jax.grad
// (`ssd_chunked`, src/repro/models/mamba.py:127, the function the Pallas
// kernel src/repro/kernels/ssd_scan.py `ssd_scan` computes). This is the
// gradient of csrc/ssd_scan.cu's scan, in closed form. Per chunk of Q
// positions, with cs the in-chunk cumsum of dt * A, E_ij = exp(cs_i - cs_j)
// (j <= i), G = C B^T, M_ij = G_ij E_ij dt_j, P_ij = dM_ij E_ij dt_j, w_j =
// dt_j exp(cs_last - cs_j), S_in the chunk's incoming state, dS its final
// state's cotangent, dM_ij = dy_i . x_j and SB_j = dS B_j:
//
//   dx_j  = sum_{i >= j} M_ij dy_i + w_j SB_j
//   dC_i  = sum_{j <= i} P_ij B_j + exp(cs_i) S_in^T dy_i
//   dB_j  = sum_{i >= j} P_ij C_i + w_j dS^T x_j
//   ddt_j = sum_i G_ij E_ij dM_ij + exp(cs_last - cs_j) x_j . SB_j + A rev_j
//   dA    = sum over batch, chunks and positions of dt_j rev_j
//
// with rev the reverse in-chunk cumsum of cs's cotangent (see
// `ssd_scan.py`). Everything in fp32, from inputs of the caller's type;
// gradients in their input's type (dt and A fp32). Positions past `s` act as
// dt = 0 and get no gradient. It reads the training forward's scratch (the
// G tiles, the cumsums, the incoming states) instead of recomputing it.
//
// Bound on this card: operations. At mamba2-780m's training layer (b 8,
// s 2048, h 48, p 64, n 128, Q 256) a call does ~1.3e11 FLOP of products
// against ~0.65 GB of inputs and outputs: 0.79 ms as three TF32 products at
// 495 TFLOP/s, 0.13 ms in bf16 at 989, 1.94 ms on the fp32 pipes. So every
// product runs on `mma.sync`, through the warp step the attention kernels
// use (attn_warp.cuh: `warp_scores` for A B^T with both operands' rows in
// shared memory, `warp_accumulate` for W B with W in accumulator layout):
//  * fp32 as 3xTF32 on `m16n8k8`: tiles stay fp32 in shared memory and are
//    split into TF32 hi and lo at the fragment load; a long sum takes each
//    stage's product in a fresh fragment and adds it by an fp32 add.
//  * bf16 on `m16n8k16`, tiles bf16 in shared memory, fetched by `ldmatrix`.
//    P and M enter their products rounded once to bf16 (as the attention
//    backward rounds its dS). The operands computed in fp32 that feed cs's
//    cotangent, and so ddt and dA (the states S_in and dS, and U's
//    exp(cs_i) dy_i), go in as two bf16 parts, hi = bf16(v) and lo =
//    bf16(v - hi), over two products: ~16 bits of each survive.
// What stays on the fp32 pipes, each in a fixed order: the decays
// E_ij = expf(cs_i - cs_j) (expf, not ex2.approx: dA's sum over every
// position has little margin), the row sums sum_j G_ij P_ij and
// sum_i G_ij E_ij dM_ij, the dots with C, x and dS, the reverse cumsum, ddt
// and dA.
//
// The layouts. The fp32 accumulator of `m16n8k8` (c0, c1 at row g, columns
// 2t, 2t + 1) is not its TF32 A fragment (a0 at row g, column t; a2 at
// column t + 4), so P and M feed their second products from registers with
// k permuted: the accumulators' column 2t is taken as k = t and 2t + 1 as
// k = t + 4, and the B operand's rows are read in the same order
// (`warp_accumulate`); nothing goes through shared memory or a shuffle. The
// transposed products (dx_j = sum_i M_ij dy_i, dB_j = sum_i P_ij C_i) take
// dM^T = x dy^T, whose accumulator rows are the positions j, so M^T and P^T
// come out of it in the same layout.
//
// Six kernels a call, on the stream in order, through fp32 scratch the
// wrapper allocates (`ssd_scan_backward_plan` gives `splits`):
//   1. `dstates` (`ssd_bwd_dstates_kernel`): one block of 4 warps per (batch,
//      head, chunk), each warp 16 rows of p: U_c = sum_i exp(cs_i) dy_i (x)
//      C_i, positions 32 at a time through a 2-stage cp.async ring.
//   2. `dpass` (`ssd_bwd_pass_kernel`): one thread per (batch, head, state
//      entry) walks the chunks from last to first: dS_c = D; D = D
//      exp(cs_last[c]) + U_c, from the final state's cotangent (or 0). dS
//      overwrites U. D past chunk 0 is the initial state's cotangent, which
//      it writes where the caller asks for it (`dinit`): a rank's block of a
//      sequence split over ranks hands it back to the earlier blocks. The
//      scan's initial state enters nothing else: the rows take it through
//      the incoming states the training forward kept.
//   3. `rows` (`ssd_bwd_rows_kernel`): one block of 4 warps per (64-row tile
//      i, batch, group, split of the group's heads, chunk), each warp 16
//      rows; the block walks its split's heads in order and, for each, the
//      state part exp(cs_i) S_in^T dy_i and the key stages j <= i (x, B and
//      the G tile through a 2-stage ring): dM = dy x^T and P in registers,
//      dC += P B. dC of the heads summed in registers; cs's row terms
//      (sum_j G_ij P_ij + C_i . exp(cs_i) S_in^T dy_i) a head and position.
//   4. `cols` (`ssd_bwd_cols_kernel`): one block per (64-column tile j, ...)
//      likewise: the state parts w_j dS^T x_j and SB_j = dS B_j, then the
//      row stages i >= j: dM^T = x dy^T, M^T and P^T in registers, dx +=
//      M^T dy, dB += P^T C; rs_j = sum_i G_ij E_ij dM_ij and x_j . SB_j.
//   5. `finish` (`ssd_bwd_finish_kernel`): one block per (batch, head, chunk):
//      cs's cotangent, its reverse cumsum, ddt and the chunk's share of dA.
//   6. `reduce` (`ssd_bwd_reduce_kernel`): dB and dC from the splits'
//      partials, summed in split order (where there is more than one split);
//      dA, the chunks' shares summed over batch and chunks in a fixed order.
// dM is computed twice, in `rows` and in `cols` (one product more than the
// bound counts, ~17 % of the tile products): a block that owned a whole
// chunk to compute it once would hold dC for every row tile, or stage P
// through shared memory, and the card would get b h nc blocks at most.
// The heads of a group share B, C and G, and dB and dC are sums over those
// heads: a block sums its split's heads in registers, so the scratch is
// `splits` partials of (b, s, g, n) and not one of (b, s, h, n) (805 MB at the
// main shape); the plan takes the fewest splits that still give the card
// about eight blocks an SM (two fit at once).
// No atomics: every value is written by one thread and every sum is taken
// in an order that does not depend on how blocks are scheduled, so two calls
// give the same bits.
//
// What still stands between `rows` and `cols` and the bound (fp32, measured
// with the products or the copies made no-ops): instruction issue more than
// the tensor pipes. A 3xTF32 product splits each operand in registers at
// every fragment load (two integer-and-subtract pairs a value, in each of
// the four warps that read a tile), and a stage's sum goes through a fresh
// fragment and fp32 adds, so a warp issues ~3 other instructions for each
// `mma`; tiles are staged with one 16-byte column a thread stepping down the
// rows, so a copy costs two adds of addressing. Splitting a tile once a block
// into shared memory would double its bytes, and two blocks an SM would no
// longer fit. (ssd_bwd_variants.py times the kernels with the products or the
// copies made no-ops.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_warp.cuh"

namespace {

constexpr int kTile = 64;      // positions of a row or column tile; p columns (padded to 64)
constexpr int kStage = 32;     // positions a ring stage streams
constexpr int kThreads = 128;  // dstates, rows, cols: 4 warps, 16 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 256;
constexpr int kLdGr = kStage + 8;  // `rows`' G stage (64 rows i x 32 keys): float2 row reads
constexpr int kLdGc = kTile + 4;   // `cols`' G stage (32 rows i x 64 keys): column reads
constexpr int kMaxChunk = 1024;
constexpr int kMaxHeadDim = 64;
// chains of hi x hi products in `scores`: with one, A_log's gradient in
// chip_smoke.py's train_mamba_check falls outside its bound (ssd_bwd_variants.py)
constexpr int kHiChains = 2;

struct BwdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  const float* dstate;  // (b, h, p, n), or null: no cotangent on the final state
  const float* G;       // (b, g, nc, qp, qp): C B^T tiles on and below the diagonal
  const float* cs;      // (b, h, nc, qp): in-chunk cumsums, flat past the last position
  const float* S_in;    // (b, h, nc, p, n): incoming states
  float* dS;            // (b, h, nc, p, n): U, then the final states' cotangents
  float* dinit;         // (b, h, p, n) or null: the initial state's cotangent
  int init;             // the forward started from an initial state (chunk 0's S_in)
  float* dcs;           // (b, h, nc, 3, qp): cs's row terms; rs_j; x_j . SB_j
  float* dA_part;       // (b, h, nc, 2): exp(cs_last) <dS, S_in>; the chunk's share of dA
  float* dB_part;       // (splits, b, s, g, n): each split's dB, splits > 1 only
  float* dC_part;       // (splits, b, s, g, n): each split's dC, splits > 1 only
  void* dx;             // (b, s, h, p), contiguous, x's type
  float* ddt;           // (b, s, h), contiguous
  float* dA;            // (h,)
  void* dB;             // (b, s, g, n), contiguous, B's type
  void* dC;             // (b, s, g, n), contiguous, C's type
  int b, s, h, p, g, n, Q, splits;
  int nc, qp, tiles;           // chunks; Q rounded up to kTile; qp / kTile
  long long x_sb, x_ss, x_sh;  // strides in elements; the last dim has stride 1
  long long dt_sb, dt_ss, dt_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long dy_sb, dy_ss, dy_sh;
};

// Positions of chunk c inside the sequence.
__device__ __forceinline__ int chunk_len(const BwdParams& p, int c) {
  return min(p.Q, p.s - c * p.Q);
}

__device__ __forceinline__ float2 load2(const float* src) {
  return *reinterpret_cast<const float2*>(src);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* src) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Rows [0, ROWS) of a slab of W columns of T (row stride `ss` elements) into
// shared memory with pitch `pitch<T, W>()`, by 16-byte cp.async; rows at or
// beyond `rows` and columns at or beyond `cols` (a multiple of 16 bytes)
// become zeros. A thread keeps one 16-byte column and steps down the rows,
// so a copy costs two adds of addressing. The empty asm hands the compiler
// a fresh source pointer each call: otherwise it keeps one 64-bit induction
// pointer a copy across the caller's ring loop, and `cols` spilled ~200
// bytes a thread in fp32. The caller commits.
template <typename T, int W, int ROWS>
__device__ __forceinline__ void stage_tile(const T* base, long long ss, int rows, int cols,
                                           T* dst) {
  constexpr int PER = 16 / (int)sizeof(T);
  constexpr int CH = W / PER;            // 16-byte columns a row
  constexpr int STEP = kThreads / CH;    // rows a pass of the block
  constexpr int LD = pitch<T, W>();
  static_assert(kThreads % CH == 0, "a row's columns divide the block");
  const int c = (threadIdx.x % CH) * PER;
  const int r0 = threadIdx.x / CH;
  const bool col_in = c < cols;
  const T* src = base + (long long)r0 * ss + c;
  asm("" : "+l"(src));
  T* d = dst + r0 * LD + c;
#pragma unroll
  for (int k = 0; k < (ROWS + STEP - 1) / STEP; ++k) {
    if (ROWS % STEP != 0 && r0 + k * STEP >= ROWS) break;
    const bool in = col_in && r0 + k * STEP < rows;
    cp_async16(d + k * STEP * LD, in ? src + k * STEP * ss : base, in);
  }
}

// A ROWS x COLS block of G (row stride `ss`) into shared memory with pitch
// LD, by cp.async, addressed as `stage_tile` is. The caller commits.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_g(const float* base, long long ss, float* dst) {
  constexpr int CH = COLS / 4;
  constexpr int STEP = kThreads / CH;
  static_assert(kThreads % CH == 0 && ROWS % STEP == 0, "the block covers the block of G");
  const int c = (threadIdx.x % CH) * 4;
  const int r0 = threadIdx.x / CH;
  const float* src = base + (long long)r0 * ss + c;
  asm("" : "+l"(src));
  float* d = dst + r0 * LD + c;
#pragma unroll
  for (int k = 0; k < ROWS / STEP; ++k) cp_async16(d + k * STEP * LD, src + k * STEP * ss, true);
}

// Positions [from, to) of a head's cumsums and dt into cs_s and dt_s (dt 0
// at or past qv), by 4-byte cp.async. The caller commits.
__device__ __forceinline__ void stage_scalars(const float* csg, const float* dtb, long long dt_ss,
                                              int from, int to, int qv, float* cs_s,
                                              float* dt_s) {
  for (int j = from + threadIdx.x; j < to; j += kThreads) {
    cp_async4(cs_s + j, csg + j, true);
    cp_async4(dt_s + j, j < qv ? dtb + (long long)j * dt_ss : dtb, j < qv);
  }
}

// A p x N fp32 state (S_in or dS of one chunk; rows from p to 64 zeros) as
// an operand of the products: fp32, by cp.async (the caller commits), with
// pitch `pitch<float, N>()`; bf16, as two planes hi = bf16(v) and lo =
// bf16(v - hi), one after the other, with pitch `pitch<bf16, N>()`.
template <typename T, int N>
__host__ __device__ constexpr int state_elems() {
  return (kBf16<T> ? 2 : 1) * kTile * pitch<T, N>();
}

template <typename T, int N>
__device__ __forceinline__ void stage_state(const float* src, int rows, T* dst) {
  if constexpr (kBf16<T>) {
    constexpr int LD = pitch<T, N>();
    constexpr int CH = N / 4;
    constexpr int IT = kTile * CH / kThreads;  // 16-byte loads a thread
    constexpr int K = IT < 4 ? IT : 4;         // of them in flight at once
    T* lo = dst + kTile * LD;
#pragma unroll
    for (int k0 = 0; k0 < IT; k0 += K) {
      float4 v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int idx = threadIdx.x + (k0 + k) * kThreads;
        v[k] = idx / CH < rows ? *reinterpret_cast<const float4*>(src + (long long)idx * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int idx = threadIdx.x + (k0 + k) * kThreads;
        const int r = idx / CH;
        const int c = (idx % CH) * 4;
        uint32_t h0, l0, h1, l1;
        split_bf16(v[k].x, v[k].y, h0, l0);
        split_bf16(v[k].z, v[k].w, h1, l1);
        *reinterpret_cast<uint2*>(dst + r * LD + c) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(lo + r * LD + c) = make_uint2(l0, l1);
      }
    }
  } else {
    stage_tile<float, N, kTile>(src, N, rows, N, dst);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&a)[NC][4]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// c += A B^T as `warp_scores` computes it (A the warp's 16 rows of a tile, B
// the rows of another, both (rows, D) with pitch `pitch<T, D>()`), for the
// products whose sums feed cs's cotangent (dM, dM^T, SB) and through it ddt
// and dA, sums over every position with much cancellation. The tensor
// cores' accumulation rounds toward zero, and one chain of 3 D / 8 products
// a value biases them enough to show in A_log's gradient; so in fp32 the
// two cross terms of 3xTF32 go to a fragment of their own, the hi x hi terms
// to kHiChains chains taken in turn over the k-steps, and the chains are
// added in fp32 at the end, in a fixed order. bf16 is `warp_scores` itself.
template <typename T, int D, int NC>
__device__ __forceinline__ void scores(float (&c)[NC][4], const T* A, const T* B, int lane) {
  constexpr int HH = kHiChains;
  if constexpr (kBf16<T>) {
    warp_scores<T, D, NC>(c, A, B, lane);
  } else {
    constexpr int LD = pitch<float, D>();
    float x[NC][4], h[HH][NC][4];
    zero(x);
#pragma unroll
    for (int k = 0; k < HH; ++k) zero(h[k]);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      tf32_a_fragment<D>(A, kk, lane, ah, al);
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        uint32_t b[4], bh[4], bl[4];
        ldmatrix_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 8 +
                           ((lane >> 3) & 1) * 4);
        split_tf32x4(b, bh, bl);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma_tf32(x[2 * np + q], ah, bl[2 * q], bl[2 * q + 1]);
          mma_tf32(x[2 * np + q], al, bh[2 * q], bh[2 * q + 1]);
          mma_tf32(h[kk % HH][2 * np + q], ah, bh[2 * q], bh[2 * q + 1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = x[n][e];
#pragma unroll
        for (int k = 0; k < HH; ++k) v += h[k][n][e];
        c[n][e] += v;
      }
  }
}

// acc += W S for a staged state S (both planes in bf16).
template <typename T, int N, int NC>
__device__ __forceinline__ void accumulate_state(float (&acc)[N / 8][4], const float (&w)[NC][4],
                                                 const T* S, int lane) {
  warp_accumulate<T, N, NC>(acc, w, S, lane);
  if constexpr (kBf16<T>) warp_accumulate<T, N, NC>(acc, w, S + kTile * pitch<T, N>(), lane);
}

// c += A S^T for a staged state S (both planes in bf16), as `scores`.
template <typename T, int N, int NC>
__device__ __forceinline__ void scores_state(float (&c)[NC][4], const T* A, const T* S,
                                             int lane) {
  scores<T, N, NC>(c, A, S, lane);
  if constexpr (kBf16<T>) scores<T, N, NC>(c, A, S + kTile * pitch<T, N>(), lane);
}

// A warp's 16 rows of a tile (W columns, pitch `pitch<T, W>()`) in fp32, in
// accumulator layout: w[n] holds columns [8 n, 8 n + 8).
template <typename T, int W, int NC>
__device__ __forceinline__ void acc_fragment(float (&w)[NC][4], const T* rows, int lane) {
  constexpr int LD = pitch<T, W>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 v = load2(rows + (g + 8 * half) * LD + n * 8 + 2 * t);
      w[n][2 * half] = v.x;
      w[n][2 * half + 1] = v.y;
    }
}

// A warp's (16, D) accumulator into rows [row0, row0 + 16) of a slab with
// row stride `ss`, columns below `cols` only; rows at or beyond `valid`
// skipped.
template <typename OUT, int D>
__device__ __forceinline__ void store_cols(OUT* base, long long ss, int row0, int valid, int cols,
                                           const float (&acc)[D / 8][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= valid) continue;
    OUT* row = base + (long long)r * ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      if (n * 8 + 2 * t < cols) store2(row + n * 8, acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// The sum over the 4 lanes of an accumulator row (t = 0..3), in a fixed order.
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The sum over a block of NT threads in a fixed order; every thread gets
// the same value. `red` holds NT / 32 floats.
template <int NT>
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous user of `red` is done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) total += red[w];
  return total;
}

// v[i] <- sum_{i <= k < len} v[k], in place, by a block of NT threads:
// segments of NT positions from the top, warp scans, then the warps' sums.
// `red` holds NT / 32 floats. Ends with a barrier.
template <int NT>
__device__ void reverse_cumsum(float* v, int len, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int top = len; top > 0; top -= NT) {
    const int i = top - 1 - threadIdx.x;  // thread 0 takes the highest position
    float x = i >= 0 ? v[i] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += t;
    }
    __syncthreads();  // the previous segment's readers of `red` are done
    if (lane == 31) red[warp] = x;
    __syncthreads();
    float before = 0.f, seg = 0.f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) before += red[w];
      seg += red[w];
    }
    if (i >= 0) v[i] = carry + before + x;
    carry += seg;
  }
  __syncthreads();
}

// Block index of `rows` and `cols` -> (tile rank, batch, group, split,
// chunk): rank 0, the tiles with the most work, first.
struct TileBlock {
  int rank, bi, gi, sp, c;
};

__device__ __forceinline__ TileBlock tile_block(const BwdParams& p) {
  const int per = p.b * p.g * p.splits * p.nc;
  TileBlock k;
  k.rank = blockIdx.x / per;
  int r = blockIdx.x % per;
  k.c = r % p.nc;
  r /= p.nc;
  k.sp = r % p.splits;
  r /= p.splits;
  k.gi = r % p.g;
  k.bi = r / p.g;
  return k;
}

// ------------------------------------------------------------------------- //
// Stage 1. Grid (b * h * nc): U[pp][nn] = sum_i exp(cs_i) dy_i[pp] C_i[nn] of
// one (batch, head, chunk). A warp owns rows pp = 16 warp + [0, 16); W =
// (exp(cs) dy)^T comes out of the dy stage in accumulator layout, C's rows
// are the B operand.
// ------------------------------------------------------------------------- //

template <typename T, int N>
__host__ __device__ constexpr int dstates_stage_bytes() {
  return kStage * (pitch<T, kTile>() + pitch<T, N>()) * (int)sizeof(T);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 3) ssd_bwd_dstates_kernel(BwdParams p) {
  constexpr int LDP = pitch<T, kTile>();
  constexpr int NI = kStage / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ecs = reinterpret_cast<float*>(smem_raw + 2 * dstates_stage_bytes<T, N>());

  const int bhc = blockIdx.x;
  const int c = bhc % p.nc;
  const int bh = bhc / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int qv = chunk_len(p, c);
  const int nst = (qv + kStage - 1) / kStage;
  const long long t0 = (long long)c * p.Q;
  const T* yb = static_cast<const T*>(p.dy) + bi * p.dy_sb + hi * p.dy_sh + t0 * p.dy_ss;
  const T* Cb = static_cast<const T*>(p.C) + bi * p.C_sb + gi * p.C_sg + t0 * p.C_ss;
  const float* csg = p.cs + (long long)bhc * p.qp;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto stage = [&](int k) { return reinterpret_cast<T*>(smem_raw + (k & 1) * dstates_stage_bytes<T, N>()); };
  auto issue = [&](int k) {
    T* Ys = stage(k);
    stage_tile<T, kTile, kStage>(yb + k * kStage * p.dy_ss, p.dy_ss, qv - k * kStage, p.p, Ys);
    stage_tile<T, N, kStage>(Cb + k * kStage * p.C_ss, p.C_ss, qv - k * kStage, N,
                             Ys + kStage * LDP);
  };
  float U[N / 8][4];
  zero(U);
  issue(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < nst * kStage; i += kThreads) ecs[i] = i < qv ? expf(csg[i]) : 0.f;
  for (int k = 0; k < nst; ++k) {
    if (k + 1 < nst) issue(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ys = stage(k);
    if (16 * warp < p.p) {
      // W[n][e]: row pp = 16 warp + g (+ 8), column i = 8 n + 2 t (+ 1)
      float w[NI][4];
#pragma unroll
      for (int n = 0; n < NI; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = n * 8 + 2 * t + (e & 1);
          w[n][e] = ecs[k * kStage + i] * to_float(Ys[i * LDP + 16 * warp + g + 8 * (e >> 1)]);
        }
      if constexpr (kBf16<T>) {
        float lo[NI][4];
#pragma unroll
        for (int n = 0; n < NI; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float top = __bfloat162float(__float2bfloat16_rn(w[n][e]));
            lo[n][e] = w[n][e] - top;
            w[n][e] = top;
          }
        warp_accumulate<T, N, NI>(U, w, Ys + kStage * LDP, lane);
        warp_accumulate<T, N, NI>(U, lo, Ys + kStage * LDP, lane);
      } else {
        warp_accumulate<T, N, NI>(U, w, Ys + kStage * LDP, lane);
      }
    }
    __syncthreads();  // the stage is read before it is refilled
  }
  cp_async_commit();
  cp_async_wait<0>();
  store_rows<float, N>(p.dS + (long long)bhc * p.p * N, N, 16 * warp, p.p, U, 1.f, lane);
}

// ------------------------------------------------------------------------- //
// Stage 2: one thread per (batch, head, state entry), the chunks from last to
// first. Each chunk's U is overwritten by its final state's cotangent.
// ------------------------------------------------------------------------- //

__global__ void __launch_bounds__(256) ssd_bwd_pass_kernel(BwdParams p) {
  constexpr int U = 8;  // chunks whose loads are in flight together
  const long long pn = (long long)p.p * p.n;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)p.b * p.h * pn) return;
  const long long bh = e / pn, k = e % pn;
  float D = p.dstate ? p.dstate[e] : 0.f;
  for (int top = p.nc - 1; top >= 0; top -= U) {
    float u[U], dec[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int c = top - j;
      u[j] = 0.f;
      dec[j] = 0.f;
      if (c >= 0) {
        const long long bhc = bh * p.nc + c;
        u[j] = p.dS[bhc * pn + k];
        dec[j] = expf(p.cs[bhc * p.qp + chunk_len(p, c) - 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int c = top - j;
      if (c >= 0) {
        p.dS[(bh * p.nc + c) * pn + k] = D;
        D = fmaf(D, dec[j], u[j]);
      }
    }
  }
  if (p.dinit) p.dinit[e] = D;
}

// ------------------------------------------------------------------------- //
// Stage 3: `rows`. A warp owns rows i = iw + [0, 16) of the block's 64-row
// tile; per head, the state part and then the key stages j <= i.
// ------------------------------------------------------------------------- //

// P = dM E dt in place of dM for a warp's rows iw + g (+ 8) against keys
// j0 + column (cumsums of the rows in cs_r), and dcs += G P. MASK where the
// stage crosses the diagonal or the chunk's end.
template <bool MASK, int NK>
__device__ __forceinline__ void rows_probs(float (&s)[NK][4], const float* Gw, const float* cs_s,
                                           const float* dt_s, const float (&cs_r)[2], int iw,
                                           int j0, int qv, float (&dcs)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    const int col = n * 8 + 2 * t;
    const float2 cj = load2(cs_s + j0 + col);
    const float2 dj = load2(dt_s + j0 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 gv = load2(Gw + (g + 8 * half) * kLdGr + col);
      const int i = iw + g + 8 * half;
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float E = expf(cs_r[half] - (o ? cj.y : cj.x));
        const float P = s[n][2 * half + o] * E * (o ? dj.y : dj.x);
        const bool keep = !MASK || (j0 + col + o <= i && i < qv);
        s[n][2 * half + o] = keep ? P : 0.f;
        if (keep) dcs[half] = fmaf(o ? gv.y : gv.x, P, dcs[half]);
      }
    }
  }
}

template <typename T, int N>
__host__ __device__ constexpr int rows_stage_bytes() {
  return kStage * (pitch<T, kTile>() + pitch<T, N>()) * (int)sizeof(T) +
         kTile * kLdGr * (int)sizeof(float);
}

// The ring's two stages, or a head's state part (S_in, then C's tile).
template <typename T, int N>
__host__ __device__ constexpr int rows_region_bytes() {
  return 2 * rows_stage_bytes<T, N>() >
                 (state_elems<T, N>() + kTile * pitch<T, N>()) * (int)sizeof(T)
             ? 2 * rows_stage_bytes<T, N>()
             : (state_elems<T, N>() + kTile * pitch<T, N>()) * (int)sizeof(T);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_rows_kernel(BwdParams p) {
  constexpr int LDP = pitch<T, kTile>();
  constexpr int LDN = pitch<T, N>();
  constexpr int NK = kStage / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ys = reinterpret_cast<T*>(smem_raw);  // the tile's dy rows, 64 x LDP
  unsigned char* region = smem_raw + kTile * LDP * sizeof(T);
  float* cs_s = reinterpret_cast<float*>(region + rows_region_bytes<T, N>());  // qp each
  float* dt_s = cs_s + p.qp;                                                  // 0 past qv
  float* red = dt_s + p.qp;                                                   // kWarps

  const TileBlock k = tile_block(p);
  const int qv = chunk_len(p, k.c);
  const int ti = p.tiles - 1 - k.rank;  // the tiles with the most keys first
  if (ti * kTile >= qv) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int i0 = ti * kTile, iw = i0 + 16 * warp;
  const int kend = min(i0 + kTile, qv);  // keys [0, kend)
  const int nks = (kend + kStage - 1) / kStage;
  const int heads = p.h / p.g / p.splits;
  const int h0 = k.gi * (p.h / p.g) + k.sp * heads;
  const long long t0 = (long long)k.c * p.Q;
  const bool carry = k.c > 0 || p.init;  // chunk 0's incoming state: zero but for an init
  const bool live = iw < qv;   // this warp has rows
  const T* Bb = static_cast<const T*>(p.B) + k.bi * p.B_sb + k.gi * p.B_sg + t0 * p.B_ss;
  const T* Cb = static_cast<const T*>(p.C) + k.bi * p.C_sb + k.gi * p.C_sg + t0 * p.C_ss;
  const float* Gb =
      p.G + ((long long)(k.bi * p.g + k.gi) * p.nc + k.c) * p.qp * p.qp + (long long)i0 * p.qp;
  T* Sin = reinterpret_cast<T*>(region);
  T* Ct = Sin + state_elems<T, N>();

  float acc[N / 8][4];  // dC of the split's heads
  zero(acc);
  for (int hh = 0; hh < heads; ++hh) {
    const int hi = h0 + hh;
    const long long bhc = ((long long)k.bi * p.h + hi) * p.nc + k.c;
    const T* xb = static_cast<const T*>(p.x) + k.bi * p.x_sb + hi * p.x_sh + t0 * p.x_ss;
    const T* yb = static_cast<const T*>(p.dy) + k.bi * p.dy_sb + hi * p.dy_sh + t0 * p.dy_ss;
    const float* csg = p.cs + bhc * p.qp;
    const float* dtb = p.dt + k.bi * p.dt_sb + hi * p.dt_sh + t0 * p.dt_ss;

    __syncthreads();  // the previous head is done with shared memory
    stage_tile<T, kTile, kTile>(yb + i0 * p.dy_ss, p.dy_ss, qv - i0, p.p, Ys);
    if (carry) {
      stage_state<T, N>(p.S_in + bhc * p.p * N, p.p, Sin);
      stage_tile<T, N, kTile>(Cb + i0 * p.C_ss, p.C_ss, qv - i0, N, Ct);
    }
    stage_scalars(csg, dtb, p.dt_ss, 0, i0 + kTile, qv, cs_s, dt_s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float cs_r[2] = {cs_s[iw + g], cs_s[iw + g + 8]};
    float dcs[2] = {0.f, 0.f};

    if (carry && live) {
      // tt = exp(cs_i) S_in^T dy_i; cs's row term C_i . tt; dC += tt
      float w[kTile / 8][4], tt[N / 8][4];
      acc_fragment<T, kTile, kTile / 8>(w, Ys + 16 * warp * LDP, lane);
      zero(tt);
      accumulate_state<T, N, kTile / 8>(tt, w, Sin, lane);
      const int t = lane & 3;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float e = expf(cs_r[half]);  // rows past qv: dy is zero
        const T* crow = Ct + (16 * warp + g + 8 * half) * LDN + 2 * t;
#pragma unroll
        for (int n = 0; n < N / 8; ++n) {
          const float2 cv = load2(crow + n * 8);
          const float a = tt[n][2 * half] * e, b = tt[n][2 * half + 1] * e;
          dcs[half] = fmaf(cv.y, b, fmaf(cv.x, a, dcs[half]));
          acc[n][2 * half] += a;
          acc[n][2 * half + 1] += b;
        }
      }
    }
    if (ti == 0) {
      // the chunk's last position's term exp(cs_last) <dS, S_in> (zero in
      // the first chunk), for `finish`
      float part = 0.f;
      if (carry) {
        const float4* a = reinterpret_cast<const float4*>(p.dS + bhc * p.p * N);
        const float4* b = reinterpret_cast<const float4*>(p.S_in + bhc * p.p * N);
#pragma unroll 2
        for (int idx = threadIdx.x; idx < p.p * N / 4; idx += kThreads) {
          const float4 u = a[idx], v = b[idx];
          part = fmaf(u.x, v.x, part);
          part = fmaf(u.y, v.y, part);
          part = fmaf(u.z, v.z, part);
          part = fmaf(u.w, v.w, part);
        }
      }
      part = block_sum<kThreads>(part, red);
      if (threadIdx.x == 0) p.dA_part[bhc * 2] = carry ? expf(csg[qv - 1]) * part : 0.f;
    }
    __syncthreads();  // the state part's readers are done: the ring takes the region

    auto stage = [&](int ks) { return reinterpret_cast<T*>(region + (ks & 1) * rows_stage_bytes<T, N>()); };
    auto issue = [&](int ks) {
      const int j0 = ks * kStage;
      T* Xst = stage(ks);
      T* Bst = Xst + kStage * LDP;
      stage_tile<T, kTile, kStage>(xb + j0 * p.x_ss, p.x_ss, qv - j0, p.p, Xst);
      stage_tile<T, N, kStage>(Bb + j0 * p.B_ss, p.B_ss, qv - j0, N, Bst);
      stage_g<kTile, kStage, kLdGr>(Gb + j0, p.qp, reinterpret_cast<float*>(Bst + kStage * LDN));
    };
    issue(0);
    cp_async_commit();
    for (int ks = 0; ks < nks; ++ks) {
      if (ks + 1 < nks) issue(ks + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int j0 = ks * kStage;
      if (live && j0 <= iw + 15) {  // some key of the stage is at or before a row
        const T* Xst = stage(ks);
        const T* Bst = Xst + kStage * LDP;
        const float* Gw = reinterpret_cast<const float*>(Bst + kStage * LDN) + 16 * warp * kLdGr;
        float s[NK][4];
        zero(s);
        scores<T, kTile, NK>(s, Ys + 16 * warp * LDP, Xst, lane);  // dM
        if (j0 + kStage - 1 <= iw && iw + 16 <= qv)
          rows_probs<false, NK>(s, Gw, cs_s, dt_s, cs_r, iw, j0, qv, dcs, lane);
        else
          rows_probs<true, NK>(s, Gw, cs_s, dt_s, cs_r, iw, j0, qv, dcs, lane);
        warp_accumulate<T, N, NK>(acc, s, Bst, lane);  // dC += P B
      }
      __syncthreads();  // the stage is read before it is refilled
    }
    cp_async_commit();
    cp_async_wait<0>();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v = row_sum(dcs[half]);
      const int i = iw + g + 8 * half;
      if ((lane & 3) == 0 && i < qv) p.dcs[bhc * 3 * p.qp + i] = v;
    }
  }
  const long long row0 = ((long long)k.bi * p.s + t0) * p.g + k.gi;  // (b, s, g) of row 0
  if (p.splits == 1)
    store_rows<T, N>(static_cast<T*>(p.dC) + row0 * N, (long long)p.g * N, iw, qv, acc, 1.f, lane);
  else
    store_rows<float, N>(p.dC_part + (long long)k.sp * p.b * p.s * p.g * N + row0 * N,
                         (long long)p.g * N, iw, qv, acc, 1.f, lane);
}

// ------------------------------------------------------------------------- //
// Stage 4: `cols`. A warp owns columns j = jw + [0, 16) of the block's
// 64-column tile as the rows of its accumulators; per head, the state parts
// and then the row stages i >= j.
// ------------------------------------------------------------------------- //

// From dM^T of a warp's columns jw + g (+ 8) against rows i0 + column: M^T
// = G E dt_j into m, P^T = dM E dt_j in place of dM, rs += G E dM. G's
// stage holds rows i, so it is read down a column. MASK as in `rows`.
template <bool MASK, int NI>
__device__ __forceinline__ void cols_probs(float (&d)[NI][4], float (&m)[NI][4],
                                           const float* Gw, const float* cs_s,
                                           const float (&cs_j)[2], const float (&dt_j)[2],
                                           int jw, int i0, int qv, float (&rs)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int col = n * 8 + 2 * t;
    const float2 ci = load2(cs_s + i0 + col);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int i = i0 + col + o;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int e = 2 * half + o;
        const float gv = Gw[(col + o) * kLdGc + g + 8 * half];
        const float E = expf((o ? ci.y : ci.x) - cs_j[half]);
        const float ed = E * dt_j[half];
        const bool keep = !MASK || (jw + g + 8 * half <= i && i < qv);
        if (keep) rs[half] = fmaf(gv * E, d[n][e], rs[half]);
        m[n][e] = keep ? gv * ed : 0.f;
        d[n][e] = keep ? d[n][e] * ed : 0.f;
      }
    }
  }
}

template <typename T, int N>
__host__ __device__ constexpr int cols_stage_bytes() {
  return kStage * (pitch<T, kTile>() + pitch<T, N>()) * (int)sizeof(T) +
         kStage * kLdGc * (int)sizeof(float);
}

// The ring's two stages, or a head's state part (B's tile, then dS).
template <typename T, int N>
__host__ __device__ constexpr int cols_region_bytes() {
  return 2 * cols_stage_bytes<T, N>() >
                 (kTile * pitch<T, N>() + state_elems<T, N>()) * (int)sizeof(T)
             ? 2 * cols_stage_bytes<T, N>()
             : (kTile * pitch<T, N>() + state_elems<T, N>()) * (int)sizeof(T);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_cols_kernel(BwdParams p) {
  constexpr int LDP = pitch<T, kTile>();
  constexpr int LDN = pitch<T, N>();
  constexpr int NI = kStage / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);  // the tile's x rows, 64 x LDP
  unsigned char* region = smem_raw + kTile * LDP * sizeof(T);
  float* cs_s = reinterpret_cast<float*>(region + cols_region_bytes<T, N>());  // qp each
  float* dt_s = cs_s + p.qp;

  const TileBlock k = tile_block(p);
  const int qv = chunk_len(p, k.c);
  const int tj = k.rank;  // the tiles with the most rows first
  const int j0 = tj * kTile;
  if (j0 >= qv) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int jw = j0 + 16 * warp;
  const int nrs = (qv - j0 + kStage - 1) / kStage;  // row stages: rows [j0, qv)
  const int heads = p.h / p.g / p.splits;
  const int h0 = k.gi * (p.h / p.g) + k.sp * heads;
  const long long t0 = (long long)k.c * p.Q;
  const bool live = jw < qv;
  const T* Bb = static_cast<const T*>(p.B) + k.bi * p.B_sb + k.gi * p.B_sg + t0 * p.B_ss;
  const T* Cb = static_cast<const T*>(p.C) + k.bi * p.C_sb + k.gi * p.C_sg + t0 * p.C_ss;
  const float* Gb =
      p.G + ((long long)(k.bi * p.g + k.gi) * p.nc + k.c) * p.qp * p.qp + j0;
  T* Bt = reinterpret_cast<T*>(region);
  T* dSt = Bt + kTile * LDN;

  float dB[N / 8][4];  // dB of the split's heads
  zero(dB);
  for (int hh = 0; hh < heads; ++hh) {
    const int hi = h0 + hh;
    const long long bhc = ((long long)k.bi * p.h + hi) * p.nc + k.c;
    const T* xb = static_cast<const T*>(p.x) + k.bi * p.x_sb + hi * p.x_sh + t0 * p.x_ss;
    const T* yb = static_cast<const T*>(p.dy) + k.bi * p.dy_sb + hi * p.dy_sh + t0 * p.dy_ss;
    const float* csg = p.cs + bhc * p.qp;
    const float* dtb = p.dt + k.bi * p.dt_sb + hi * p.dt_sh + t0 * p.dt_ss;

    __syncthreads();  // the previous head is done with shared memory
    stage_tile<T, kTile, kTile>(xb + j0 * p.x_ss, p.x_ss, qv - j0, p.p, Xs);
    stage_tile<T, N, kTile>(Bb + j0 * p.B_ss, p.B_ss, qv - j0, N, Bt);
    stage_state<T, N>(p.dS + bhc * p.p * N, p.p, dSt);
    stage_scalars(csg, dtb, p.dt_ss, j0, p.qp, qv, cs_s, dt_s);
    cp_async_commit();
    const float cs_last = csg[qv - 1];
    cp_async_wait<0>();
    __syncthreads();
    float cs_j[2], dt_j[2], f[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = jw + g + 8 * half;
      cs_j[half] = cs_s[j];
      dt_j[half] = dt_s[j];
      f[half] = j < qv ? expf(cs_last - cs_j[half]) : 0.f;
    }
    float dx[kTile / 8][4], rs[2] = {0.f, 0.f}, xsb[2] = {0.f, 0.f};
    zero(dx);
    if (live) {
      // dB += w_j dS^T x_j (w_j x_j as the A operand)
      float w[kTile / 8][4];
      acc_fragment<T, kTile, kTile / 8>(w, Xs + 16 * warp * LDP, lane);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[n][e] *= dt_j[e >> 1] * f[e >> 1];
      accumulate_state<T, N, kTile / 8>(dB, w, dSt, lane);
      // SB_j = dS B_j: dx = w_j SB_j, x_j . SB_j
      scores_state<T, N, kTile / 8>(dx, Bt + 16 * warp * LDN, dSt, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const T* xrow = Xs + (16 * warp + g + 8 * half) * LDP + 2 * t;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
          const float2 xv = load2(xrow + n * 8);
          xsb[half] = fmaf(xv.y, dx[n][2 * half + 1], fmaf(xv.x, dx[n][2 * half], xsb[half]));
          dx[n][2 * half] *= dt_j[half] * f[half];
          dx[n][2 * half + 1] *= dt_j[half] * f[half];
        }
      }
    }
    __syncthreads();  // the state parts' readers are done: the ring takes the region

    auto stage = [&](int rs_) { return reinterpret_cast<T*>(region + (rs_ & 1) * cols_stage_bytes<T, N>()); };
    auto issue = [&](int rs_) {
      const int i0 = j0 + rs_ * kStage;
      T* Yst = stage(rs_);
      T* Cst = Yst + kStage * LDP;
      stage_tile<T, kTile, kStage>(yb + i0 * p.dy_ss, p.dy_ss, qv - i0, p.p, Yst);
      stage_tile<T, N, kStage>(Cb + i0 * p.C_ss, p.C_ss, qv - i0, N, Cst);
      stage_g<kStage, kTile, kLdGc>(Gb + (long long)i0 * p.qp, p.qp,
                                    reinterpret_cast<float*>(Cst + kStage * LDN));
    };
    issue(0);
    cp_async_commit();
    for (int r = 0; r < nrs; ++r) {
      if (r + 1 < nrs) issue(r + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int i0 = j0 + r * kStage;
      if (live && i0 + kStage - 1 >= jw) {  // some row of the stage is at or after a column
        const T* Yst = stage(r);
        const T* Cst = Yst + kStage * LDP;
        const float* Gw = reinterpret_cast<const float*>(Cst + kStage * LDN) + 16 * warp;
        float d[NI][4], m[NI][4];
        zero(d);
        scores<T, kTile, NI>(d, Xs + 16 * warp * LDP, Yst, lane);  // dM^T
        if (i0 >= jw + 15 && i0 + kStage <= qv)
          cols_probs<false, NI>(d, m, Gw, cs_s, cs_j, dt_j, jw, i0, qv, rs, lane);
        else
          cols_probs<true, NI>(d, m, Gw, cs_s, cs_j, dt_j, jw, i0, qv, rs, lane);
        warp_accumulate<T, kTile, NI>(dx, m, Yst, lane);  // dx += M^T dy
        warp_accumulate<T, N, NI>(dB, d, Cst, lane);      // dB += P^T C
      }
      __syncthreads();  // the stage is read before it is refilled
    }
    cp_async_commit();
    cp_async_wait<0>();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float r = row_sum(rs[half]), x = row_sum(xsb[half]);
      const int j = jw + g + 8 * half;
      if (t == 0 && j < qv) {
        p.dcs[(bhc * 3 + 1) * p.qp + j] = r;
        p.dcs[(bhc * 3 + 2) * p.qp + j] = x;
      }
    }
    store_cols<T, kTile>(static_cast<T*>(p.dx) + (((long long)k.bi * p.s + t0) * p.h + hi) * p.p,
                         (long long)p.h * p.p, jw, qv, p.p, dx, lane);
  }
  const long long row0 = ((long long)k.bi * p.s + t0) * p.g + k.gi;  // (b, s, g) of row 0
  if (p.splits == 1)
    store_rows<T, N>(static_cast<T*>(p.dB) + row0 * N, (long long)p.g * N, jw, qv, dB, 1.f, lane);
  else
    store_rows<float, N>(p.dB_part + (long long)k.sp * p.b * p.s * p.g * N + row0 * N,
                         (long long)p.g * N, jw, qv, dB, 1.f, lane);
}

// ------------------------------------------------------------------------- //
// Stage 5. Grid (b * h * nc): cs's cotangent from the row and column terms,
// its reverse cumsum, ddt, and the chunk's share of dA.
// ------------------------------------------------------------------------- //

__global__ void __launch_bounds__(kFinishThreads) ssd_bwd_finish_kernel(BwdParams p) {
  extern __shared__ __align__(16) float fsm[];
  float* dcs_s = fsm;           // qp each: cs's cotangent, then its reverse cumsum
  float* ddt_s = fsm + p.qp;    // dt's direct part
  float* dt_s = ddt_s + p.qp;
  float* red = dt_s + p.qp;     // kFinishThreads / 32

  const int bhc = blockIdx.x;
  const int c = bhc % p.nc;
  const int hi = (bhc / p.nc) % p.h, bi = bhc / p.nc / p.h;
  const int qv = chunk_len(p, c);
  const long long t0 = (long long)c * p.Q;
  const float* csg = p.cs + (long long)bhc * p.qp;
  const float* dtb = p.dt + bi * p.dt_sb + hi * p.dt_sh + t0 * p.dt_ss;
  const float* terms = p.dcs + (long long)bhc * 3 * p.qp;
  const float cs_last = csg[qv - 1];
  float xw = 0.f;
  for (int j = threadIdx.x; j < qv; j += kFinishThreads) {
    const float dt = dtb[(long long)j * p.dt_ss];
    const float f = expf(cs_last - csg[j]);
    const float w = dt * f;
    const float rs = terms[p.qp + j], xsb = terms[2 * p.qp + j];
    dcs_s[j] = terms[j] - dt * rs - w * xsb;
    ddt_s[j] = fmaf(f, xsb, rs);
    dt_s[j] = dt;
    xw = fmaf(w, xsb, xw);
  }
  const float tot = block_sum<kFinishThreads>(xw, red);
  if (threadIdx.x == 0) dcs_s[qv - 1] += tot + p.dA_part[2 * bhc];
  __syncthreads();
  reverse_cumsum<kFinishThreads>(dcs_s, qv, red);
  const float a_h = p.A[hi];
  float part = 0.f;
  for (int j = threadIdx.x; j < qv; j += kFinishThreads) {
    p.ddt[((long long)bi * p.s + t0 + j) * p.h + hi] = fmaf(a_h, dcs_s[j], ddt_s[j]);
    part = fmaf(dt_s[j], dcs_s[j], part);
  }
  part = block_sum<kFinishThreads>(part, red);
  if (threadIdx.x == 0) p.dA_part[2 * bhc + 1] = part;
}

// ------------------------------------------------------------------------- //
// Stage 6: one thread per 4 values of (batch, position, group, n) for dB
// and dC, the splits in order (none where there is one split: `rows` and
// `cols` wrote them); then one per head for dA, the shares in (batch, chunk)
// order.
// ------------------------------------------------------------------------- //

template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(BwdParams p) {
  const long long total = p.splits > 1 ? (long long)p.b * p.s * p.g * p.n / 4 : 0;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < total) {
    const float4* pb = reinterpret_cast<const float4*>(p.dB_part);
    const float4* pc = reinterpret_cast<const float4*>(p.dC_part);
    float4 sb = pb[e], sc = pc[e];
    for (int k = 1; k < p.splits; ++k) {
      const float4 b = pb[k * total + e], c = pc[k * total + e];
      sb.x += b.x; sb.y += b.y; sb.z += b.z; sb.w += b.w;
      sc.x += c.x; sc.y += c.y; sc.z += c.z; sc.w += c.w;
    }
    T* db = static_cast<T*>(p.dB) + 4 * e;
    T* dc = static_cast<T*>(p.dC) + 4 * e;
    store2(db, sb.x, sb.y);
    store2(db + 2, sb.z, sb.w);
    store2(dc, sc.x, sc.y);
    store2(dc + 2, sc.z, sc.w);
  } else if (e < total + p.h) {
    const int hi = (int)(e - total);
    float sum = 0.f;
    for (int bi = 0; bi < p.b; ++bi)
      for (int c = 0; c < p.nc; ++c) sum += p.dA_part[(((long long)bi * p.h + hi) * p.nc + c) * 2 + 1];
    p.dA[hi] = sum;
  }
}

// ------------------------------------------------------------------------- //
// Launches.
// ------------------------------------------------------------------------- //

template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned blocks, int threads, size_t smem, const BwdParams& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kDstates = 1, kDpass = 2, kRows = 4, kCols = 8, kFinish = 16, kReduce = 32;

template <typename T, int N>
cudaError_t run(const BwdParams& p, int stages, cudaStream_t st) {
  const unsigned bhc = (unsigned)(p.b * p.h * p.nc);
  const unsigned tile_blocks = (unsigned)(p.tiles * p.b * p.g * p.splits * p.nc);
  const size_t qp_bytes = (size_t)p.qp * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (stages & kDstates) {
    err = launch(ssd_bwd_dstates_kernel<T, N>, bhc, kThreads,
                 2 * dstates_stage_bytes<T, N>() + qp_bytes, p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kDpass) {
    const long long total = (long long)p.b * p.h * p.p * p.n;
    ssd_bwd_pass_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & kRows) {
    err = launch(ssd_bwd_rows_kernel<T, N>, tile_blocks, kThreads,
                 kTile * pitch<T, kTile>() * sizeof(T) + rows_region_bytes<T, N>() +
                     2 * qp_bytes + kWarps * sizeof(float),
                 p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kCols) {
    err = launch(ssd_bwd_cols_kernel<T, N>, tile_blocks, kThreads,
                 kTile * pitch<T, kTile>() * sizeof(T) + cols_region_bytes<T, N>() + 2 * qp_bytes,
                 p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kFinish) {
    err = launch(ssd_bwd_finish_kernel, bhc, kFinishThreads,
                 3 * qp_bytes + kFinishThreads / 32 * sizeof(float), p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kReduce) {
    const long long total = (p.splits > 1 ? (long long)p.b * p.s * p.g * p.n / 4 : 0) + p.h;
    ssd_bwd_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t run_n(const BwdParams& p, int stages, cudaStream_t st) {
  if (p.n == 16) return run<T, 16>(p, stages, st);
  if (p.n == 32) return run<T, 32>(p, stages, st);
  if (p.n == 64) return run<T, 64>(p, stages, st);
  if (p.n == 128) return run<T, 128>(p, stages, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The inputs as `repro_ssd_scan` takes them (x, B, C and dy of `dtype`: 0 =
// float32, 1 = bfloat16; dt and A float32; strides in elements, last dims
// contiguous, rows 16-byte aligned); dstate: (b, h, p, n) float32 or null;
// the training forward's scratch: scores (b, g, nc, qp, qp), cs (b, h, nc,
// qp), incoming (b, h, nc, p, n), float32. Scratch, float32, contiguous:
// dS (b, h, nc, p, n), dcs (b, h, nc, 3, qp), dA_part (b, h, nc, 2), and,
// when splits > 1, dB_part and dC_part (splits, b, s, g, n). Outputs,
// contiguous: dx (b, s, h, p) and dB, dC (b, s, g, n) of `dtype`, ddt (b, s,
// h) and dA (h,) float32. p % 8 == 0 and p <= 64; n: 16, 32, 64 or 128;
// chunk <= 1024 and <= s; splits divides h / g (the heads of a group a
// block sums). stages: a mask of the kernels to launch, in order (1
// dstates, 2 dpass, 4 rows, 8 cols, 16 finish, 32 reduce; 63 for the whole
// backward). init: 1 where the forward started from an initial state (then
// `incoming` holds it as chunk 0's, which the rows read), else 0. dinit: (b,
// h, p, n) float32, contiguous, or null; dpass writes the initial state's
// cotangent there. Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_scan_backward(
    const void* x, const void* dt, const void* A, const void* B, const void* C, const void* dy,
    const void* dstate, const void* scores, const void* cs, const void* incoming, int init,
    void* dinit, void* dS,
    void* dcs, void* dA_part, void* dB_part, void* dC_part, void* dx, void* ddt, void* dA,
    void* dB, void* dC, int b, int s, int h, int p, int g, int n, int chunk, int splits,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long B_sb, long long B_ss, long long B_sg, long long C_sb,
    long long C_ss, long long C_sg, long long dy_sb, long long dy_ss, long long dy_sh, int dtype,
    int stages, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p % 8 != 0 || p > kMaxHeadDim || g <= 0 ||
      h % g != 0 || chunk <= 0 || chunk > kMaxChunk || chunk > s || splits <= 0 ||
      (h / g) % splits != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams prm;
  prm.x = x; prm.dt = static_cast<const float*>(dt); prm.A = static_cast<const float*>(A);
  prm.B = B; prm.C = C; prm.dy = dy; prm.dstate = static_cast<const float*>(dstate);
  prm.G = static_cast<const float*>(scores); prm.cs = static_cast<const float*>(cs);
  prm.S_in = static_cast<const float*>(incoming); prm.dS = static_cast<float*>(dS);
  prm.dinit = static_cast<float*>(dinit);
  prm.init = init;
  prm.dcs = static_cast<float*>(dcs); prm.dA_part = static_cast<float*>(dA_part);
  prm.dB_part = static_cast<float*>(dB_part); prm.dC_part = static_cast<float*>(dC_part);
  prm.dx = dx; prm.ddt = static_cast<float*>(ddt); prm.dA = static_cast<float*>(dA);
  prm.dB = dB; prm.dC = dC;
  prm.b = b; prm.s = s; prm.h = h; prm.p = p; prm.g = g; prm.n = n; prm.Q = chunk;
  prm.splits = splits;
  prm.nc = (s + chunk - 1) / chunk;
  prm.qp = (chunk + kTile - 1) / kTile * kTile;
  prm.tiles = prm.qp / kTile;
  if ((long long)b * h * prm.nc > 0x7fffffffLL ||
      (long long)prm.tiles * b * g * splits * prm.nc > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  prm.x_sb = x_sb; prm.x_ss = x_ss; prm.x_sh = x_sh;
  prm.dt_sb = dt_sb; prm.dt_ss = dt_ss; prm.dt_sh = dt_sh;
  prm.B_sb = B_sb; prm.B_ss = B_ss; prm.B_sg = B_sg;
  prm.C_sb = C_sb; prm.C_ss = C_ss; prm.C_sg = C_sg;
  prm.dy_sb = dy_sb; prm.dy_ss = dy_ss; prm.dy_sh = dy_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_n<float>(prm, stages, st);
  if (dtype == 1) return (int)run_n<__nv_bfloat16>(prm, stages, st);
  return (int)cudaErrorInvalidValue;
}
