// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (`_flash_kernel`,
// called from `flash_attention_fwd`): softmax(Q K^T / sqrt(d)) V with grouped
// KV heads, causal (top-left aligned, `kpos <= qpos`) or not, online softmax
// with a running maximum `m`, a running denominator `l` and an fp32
// accumulator, probabilities rounded to the input type before P V, and
// `acc / max(l, 1e-30)` at the end. Scores are accumulated in fp32 and scaled
// after the product; `l` sums the unrounded fp32 probabilities. Neither the
// scores nor the probabilities ever reach device memory.
//
// What changed against the TPU kernel, and why:
//  * The TPU grid runs in order and carries m, l and acc in scratch memory
//    across its kv axis. Blocks on this card run in no order, so the kv axis is
//    a loop inside one block and m, l, acc live in registers.
//  * Inputs come by strides (only the last dim is contiguous), so the model
//    hands over its (b, s, h, d) activations and its (b, S, hkv, d) cache as
//    transposed views. Nothing is padded or copied: the ragged edges of q and
//    kv are masked (rows past an edge are staged as zeros). A query head reads
//    its KV head by index (`h / group`).
//  * Serving needs two per-sequence numbers that the TPU kernel does not have:
//    `kv_len[b]` (keys at or beyond it are masked) and `q_offset[b]` (the causal
//    mask becomes `kpos <= qpos + q_offset[b]`). The kv loop stops at the last
//    key any row of the tile may see, so a decode tick over a long cache reads
//    only the positions that are filled. A row with no visible key gives zeros.
//  * Training needs the rows' log-sum-exp m + log(l) (natural log, scaled
//    scores) for the backward (flash_attention_backward.cu), which recomputes
//    the probabilities from it instead of storing them. The prefill kernels
//    write it at their finalize, where m and l are in registers anyway, when
//    the caller passes `lse` (`repro_flash_attention_lse`); that entry point
//    takes them at any length. Serving over a cache split along its sequence
//    (one block of the keys a rank) needs it too, to combine the ranks'
//    partial rows: `repro_flash_attention_partial` takes the decode kernels
//    at sq <= 8, whose cluster merge (`merge_slots`) holds each row's max and
//    sum in fp32 and writes the log-sum-exp from them, and writes the
//    partial output in fp32 (`o_f32`), so that the combine rounds once.
//    The training route takes `q_offset` too: a rank's block of the rows of
//    a sequence split over ranks attends over the whole sequence's keys.
//    The training route also takes head_dim 16 (the reduced test configs), in
//    the prefill kernels only; serving takes 64, 128 and 160 (zamba2's shared
//    block: 32 heads of 160, ten k-steps of 16 for bf16, twenty of 8 for
//    3xTF32, twenty 8-column n-tiles of the output).
//
// Four kernels, chosen by the type and the number of query rows. Both bf16
// kernels run the same warp step (`mma_attend`): 16 query rows against a kv
// tile, Q K^T and P V as `mma.sync.m16n8k16` (bf16 in, fp32 accumulators),
// operands fetched from shared memory by `ldmatrix` (`.trans` for V), the
// scores' accumulator fragments taking the online softmax in registers (row
// max by quad shuffles) and re-packed, rounded to bf16, straight into the A
// operand of P V. K/V tiles stay bf16 and arrive by 16-byte `cp.async` into
// rings of stages, so a tile loads while an earlier one computes; rows are
// padded by 16 bytes, which puts the eight rows of an `ldmatrix` phase on
// distinct banks.
//  * `flash_mma_kernel` (bf16, sq > 8). Bound: operations (2*2*s^2*d per head,
//    half of it when causal), at the main path's shapes (s <= 2048, 9 heads,
//    at most 144 blocks) by latency and occupancy rather than by the issue
//    rate. A block owns 64 query rows of one head; its warps are G groups of
//    four, each warp 16 rows, and group g takes the kv tiles j = g mod G, so
//    the critical path of the longest causal rows is cut G-fold. The groups'
//    (m, l, acc) are merged through shared memory at the end. Blocks start
//    with the longest causal rows.
//  * `flash_decode_mma_kernel` (bf16, sq <= 8). Bound: bytes, the K and V rows
//    of the filled cache. A block holds 16 query rows of one (batch, KV head):
//    the group's heads times the sq positions, packed into the rows of the
//    mma (more rows take more blocks in grid y, each re-reading the keys), so
//    each K/V row is read once for the whole group. The keys, in tiles of 32,
//    are dealt over a thread block cluster of up to 8 blocks (grid x; 4 by
//    default, the fastest at a decode tick) and over each block's 4 warps: a
//    decode tick of 8 sequences x 3 KV heads runs 96 blocks, 384 warps, and
//    a warp gets at most four tiles. Each warp streams its own tiles through
//    its own ring, deep enough at d 64 to hold them all, with no block
//    barrier in its loop. The warps' partial (m, l, acc) are merged in shared
//    memory; each block stores its partial into block 0 through distributed
//    shared memory and leaves, and block 0 merges them (`merge_slots`): no
//    global scratch, no second launch. A block with no keys in range still
//    stores and arrives. What is left is latency: about 5 us even when every
//    sequence has one key (launch, the `q_offset` read before any K/V load,
//    the merges and the cluster barrier).
//  * `flash_tf32_kernel` (fp32, sq > 8): both products on the tensor cores
//    as 3xTF32 (`mma.sync.m16n8k8`, each operand split into TF32 hi and lo,
//    hi lo + lo hi + hi hi summed in fp32: ~20 bits of each product, where
//    one TF32 product keeps 10 and could not hold fp32's 2e-5), through the
//    backward's warp step (attn_warp.cuh: `warp_scores`, `warp_accumulate`).
//    Bound: operations, 2 products of 2 s^2 d a head (half when causal) at
//    495/3 TFLOP/s: 0.234 ms at the train_lm layer (b 8, h 9, s 2048, d 64),
//    0.577 on the fp32 pipes. One block of 4 warps per (head, batch, 64 query
//    rows), query tiles in reverse so the longest causal rows start first;
//    each warp owns 16 rows, its Q as TF32 parts in registers at d <= 64.
//    K/V tiles of `tile_rows<D>()` keys (64; 32 at d 128) stay fp32 in
//    shared memory, rows padded by 16 bytes, and arrive by 16-byte
//    `cp.async` into a ring of two stages (two blocks an SM at every head
//    dim; three, with 32-key tiles, ran no faster at the train_lm layer and
//    slower on long prompts); Q's and K's fragments come by `ldmatrix`. The
//    online softmax runs on S's accumulator fragments (row max by quad
//    shuffles, log2 domain), and P enters P V from them with no trip through
//    shared memory; each tile's P V is summed in a fresh fragment and added
//    to acc by fp32 adds (the tensor cores' accumulation truncates). Only
//    tiles that cross a row's limit (the diagonal, kv_len) take the
//    per-element mask; a warp skips tiles past its last row. Deterministic:
//    every sum in a fixed order, each output written once.
//  * `flash_decode_f32_kernel` (fp32, sq <= 8): the bf16 decode kernel's split
//    of the keys and its merges, on the fp32 pipes, 4 query rows a block: a
//    lane scores one key of a 32-key tile against every row (q in shared
//    memory), keeps the online softmax, and owns D/32 output columns of each
//    row for P V.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_warp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kDecodeMaxSq = 8;
constexpr int kDecodeMaxCluster = 8;  // the portable cluster size
constexpr int kDecodeDefaultCluster = 4;  // the fastest of 1, 2, 4, 8 at a decode tick
constexpr int kDecodeTile = 32;       // keys a decode warp takes at a time

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;    // (b,) or nullptr: every key of skv counts
  const int* q_offset;  // (b,) or nullptr: 0
  float* lse;           // (b, h, sq) fp32 or nullptr: the rows' log-sum-exp
  int o_f32;            // o is fp32 whatever the inputs' type (the split route's partial)
  int b, h, hkv, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim has stride 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
};

__device__ __forceinline__ int seq_kv_len(const Params& p, int bi) {
  return p.kv_len ? min(p.kv_len[bi], p.skv) : p.skv;
}

// The log-sum-exp of query row `row` of head `hi` (natural log, scores
// scaled), which the backward recomputes the probabilities from: `m` the row
// maximum, `l` the sum of exp(score - m). A row that saw no key gets +inf,
// so that every probability recomputed from it is 0.
__device__ __forceinline__ void store_lse(const Params& p, int bi, int hi, int row, float m,
                                          float l) {
  p.lse[((long long)bi * p.h + hi) * p.sq + row] = l > 0.f ? m + logf(l) : INFINITY;
}

// Four output values at p (16 or 8 bytes, aligned), rounded once.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// ------------------------------------------------------------------------- //
// Cluster barriers (the copies and mma instructions are in mma.cuh).
// ------------------------------------------------------------------------- //

// The cluster barrier in two halves (every thread of every block takes part):
// `arrive` marks this thread's arrival, `wait` blocks until every thread of
// the cluster that has not exited has arrived. The relaxed arrive orders
// nothing; the plain one releases this thread's earlier writes, shared
// memory of other blocks included, to whoever waits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ------------------------------------------------------------------------- //
// The bf16 warp step: 16 query rows against one kv tile on the tensor cores.
// ------------------------------------------------------------------------- //

// A warp's 16 rows in mma fragment layout: this lane holds rows g and g + 8
// (g = lane / 4), and of each n-tile of 8 output columns the pair 2 (lane % 4).
// m is in the log2 domain (scores times scale * log2 e); l is this lane's
// share of its rows until `quad_sum_l`.
template <int D>
struct MmaRows {
  float m0, m1, l0, l1;
  float acc[D / 8][4];

  __device__ __forceinline__ void init() {
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  __device__ __forceinline__ void quad_sum_l() {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
  }
};

// One kv tile of BN keys, starting at key k0, K and V with pitch D + 8 in
// shared memory. `lim0`, `lim1`: one past the last key rows g and g + 8 may
// see; `sl`: scale * log2 e.
template <int D, int BN>
__device__ __forceinline__ void mma_attend(MmaRows<D>& st, const uint32_t (&qf)[D / 16][4],
                                           const __nv_bfloat16* Kt, const __nv_bfloat16* Vt,
                                           int k0, int lim0, int lim1, float sl, int lane) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int NS = BN / 8;  // n-tiles of S (8 keys each)
  constexpr int NO = D / 8;   // n-tiles of O (8 dims each)
  const int t4 = lane & 3;

  // S = Q K^T: 16 rows x BN keys, fp32.
  float s[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }

  // Scale after the product (into the log2 domain: t = s * scale * log2 e),
  // mask, online softmax; a row's values of one n-tile live in the four lanes
  // of a quad. Only a tile that crosses a row's limit is masked.
  float mx0 = kNegInf, mx1 = kNegInf;
  if (k0 + BN <= min(lim0, lim1)) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] *= sl;
        s[n][2 + e] *= sl;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + n * 8 + 2 * t4 + e;
        s[n][e] = kpos < lim0 ? s[n][e] * sl : kNegInf;
        s[n][2 + e] = kpos < lim1 ? s[n][2 + e] * sl : kNegInf;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  // A row with no visible key yet keeps m = kNegInf and subtracts 0, so a
  // masked score (kNegInf) gives probability 0 either way.
  const float mu0 = mn0 == kNegInf ? 0.f : mn0, mu1 = mn1 == kNegInf ? 0.f : mn1;
  const float alpha0 = fast_exp2(st.m0 - mu0), alpha1 = fast_exp2(st.m1 - mu1);
  st.m0 = mn0;
  st.m1 = mn1;
  // P, rounded to bf16, as the A operand of P V: k-step kk covers the score
  // n-tiles 2 kk (registers 0, 1) and 2 kk + 1 (registers 2, 3).
  uint32_t pf[NS / 2][4];
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float p0 = fast_exp2(s[n][0] - mu0), p1 = fast_exp2(s[n][1] - mu0);
    const float p2 = fast_exp2(s[n][2] - mu1), p3 = fast_exp2(s[n][3] - mu1);
    rs0 += p0 + p1;
    rs1 += p2 + p3;
    pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
    pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  st.l0 = st.l0 * alpha0 + rs0;
  st.l1 = st.l1 * alpha1 + rs1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    st.acc[n][0] *= alpha0;
    st.acc[n][1] *= alpha0;
    st.acc[n][2] *= alpha1;
    st.acc[n][3] *= alpha1;
  }

  // acc += P V: V is (keys, dims) row-major, so `ldmatrix.trans` gives the
  // column-major B operand.
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                               (lane >> 4) * 8);
      mma_bf16(st.acc[2 * dp], pf[kk], b[0], b[1]);
      mma_bf16(st.acc[2 * dp + 1], pf[kk], b[2], b[3]);
    }
  }
}

// Warps that hold the same 16 rows over different keys ("partners") merge
// through shared memory: partners 1 .. P-1 store their state, partner 0
// absorbs them. `x` is this lane's first slot in its partner's area, one
// float a thread per slot and NT threads a partner (neighbouring lanes on
// neighbouring banks). l must be quad-summed first.
template <int D>
__host__ __device__ constexpr int mma_rows_slots() {
  return 4 + 4 * (D / 8);
}

template <int D, int NT>
__device__ __forceinline__ void mma_rows_store(const MmaRows<D>& st, float* x) {
  x[0 * NT] = st.m0;
  x[1 * NT] = st.m1;
  x[2 * NT] = st.l0;
  x[3 * NT] = st.l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[(4 + n * 4 + e) * NT] = st.acc[n][e];
}

// `xfer(pp)`: partner pp's slot for this lane, as given to `mma_rows_store`.
template <int D, int NT, int P, typename Xfer>
__device__ __forceinline__ void mma_rows_merge(MmaRows<D>& st, Xfer xfer) {
  float M0 = st.m0, M1 = st.m1;
#pragma unroll
  for (int pp = 1; pp < P; ++pp) {
    M0 = fmaxf(M0, xfer(pp)[0]);
    M1 = fmaxf(M1, xfer(pp)[NT]);
  }
  const float mu0 = M0 == kNegInf ? 0.f : M0, mu1 = M1 == kNegInf ? 0.f : M1;
  const float sc0 = fast_exp2(st.m0 - mu0), sc1 = fast_exp2(st.m1 - mu1);
  st.l0 *= sc0;
  st.l1 *= sc1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.acc[n][0] *= sc0;
    st.acc[n][1] *= sc0;
    st.acc[n][2] *= sc1;
    st.acc[n][3] *= sc1;
  }
#pragma unroll
  for (int pp = 1; pp < P; ++pp) {
    const float* x = xfer(pp);
    const float s0 = fast_exp2(x[0] - mu0);
    const float s1 = fast_exp2(x[NT] - mu1);
    st.l0 += x[2 * NT] * s0;
    st.l1 += x[3 * NT] * s1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      st.acc[n][0] += x[(4 + n * 4 + 0) * NT] * s0;
      st.acc[n][1] += x[(4 + n * 4 + 1) * NT] * s0;
      st.acc[n][2] += x[(4 + n * 4 + 2) * NT] * s1;
      st.acc[n][3] += x[(4 + n * 4 + 3) * NT] * s1;
    }
  }
  st.m0 = M0;
  st.m1 = M1;
}

// ------------------------------------------------------------------------- //
// Prefill, bf16: tensor cores.
// ------------------------------------------------------------------------- //

constexpr int MM_BM = 64;  // query rows per block, 16 per warp of a group
constexpr int MM_BN = 64;  // keys per kv tile
constexpr int MM_GROUP_THREADS = 128;

// Warp groups (group g takes the kv tiles j = g mod G): two (256 threads a
// block) ran faster than four at every prefill length measured.
// Stages of each group's K/V ring: three fit shared memory at d 64, two at
// d 128 and 160 (193,536 bytes a block at d 160).
constexpr int MM_GROUPS = 2;

template <int D>
__host__ __device__ constexpr int mma_stages() {
  return D == 64 ? 3 : 2;
}

template <int D>
__host__ __device__ constexpr int mma_ring_elems() {  // one group's ring
  return mma_stages<D>() * 2 * MM_BN * (D + 8);
}

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (MM_BM * (D + 8) + MM_GROUPS * mma_ring_elems<D>()) * (int)sizeof(__nv_bfloat16);
}

// The 128 threads of warp group `grp` wait for each other (barrier 0 is
// __syncthreads').
__device__ __forceinline__ void group_barrier(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "r"(MM_GROUP_THREADS) : "memory");
}

template <int D>
__global__ void __launch_bounds__(MM_GROUPS * MM_GROUP_THREADS) flash_mma_kernel(Params p) {
  constexpr int G = MM_GROUPS;
  constexpr int ST = mma_stages<D>();
  constexpr int NTH = G * MM_GROUP_THREADS;
  constexpr int LD = D + 8;   // row pitch in shared memory (elements)
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // n-tiles of O (8 dims each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const float sl = p.scale * kLog2e;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = warp / 4;
  const int rw = warp % 4;  // the warp's 16 rows of the block
  const int tg = threadIdx.x % MM_GROUP_THREADS;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t4 = lane & 3;  // fragment column pair
  const int hi = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MM_BM;  // longest causal rows first
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const int kvlen = seq_kv_len(p, bi);
  const int off = p.q_offset ? p.q_offset[bi] : 0;
  // One past the last key that any row of this tile may see.
  int kv_hi = kvlen;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + MM_BM, p.sq) + off);
  const int ntiles = kv_hi > 0 ? (kv_hi + MM_BN - 1) / MM_BN : 0;
  const int ng = ntiles > grp ? (ntiles - grp + G - 1) / G : 0;  // this group's tiles
  __nv_bfloat16* Ks = Qs + MM_BM * LD + grp * mma_ring_elems<D>();
  __nv_bfloat16* Vs = Ks + ST * MM_BN * LD;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_sb + hi * p.o_sh;
  // The group's i-th tile into ring slot i % ST.
  auto issue = [&](int i) {
    const int row0 = (grp + G * i) * MM_BN;
    const int st = i % ST;
    stage_rows<__nv_bfloat16, D, MM_BN, MM_GROUP_THREADS>(kb, p.k_ss, row0, kvlen,
                                                          Ks + st * MM_BN * LD, tg);
    stage_rows<__nv_bfloat16, D, MM_BN, MM_GROUP_THREADS>(vb, p.v_ss, row0, kvlen,
                                                          Vs + st * MM_BN * LD, tg);
  };

  // Q by every thread and each group's first tile; then Q's fragments for
  // the whole loop; then the group's next ST - 2 tiles.
  stage_rows<__nv_bfloat16, D, MM_BM, NTH>(qb, p.q_ss, q0, p.sq, Qs, threadIdx.x);
  if (ng > 0) issue(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], Qs + (rw * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
  for (int i = 1; i < ST - 1; ++i) {
    if (i < ng) issue(i);
    cp_async_commit();
  }

  // This thread's two rows: r0 (fragment row g) and r0 + 8.
  const int r0 = q0 + rw * 16 + g;
  const int lim0 = p.causal ? min(kvlen, r0 + off + 1) : kvlen;
  const int lim1 = p.causal ? min(kvlen, r0 + 8 + off + 1) : kvlen;
  MmaRows<D> st;
  st.init();

  for (int i = 0; i < ng; ++i) {
    if (i + ST - 1 < ng) issue(i + ST - 1);
    cp_async_commit();        // possibly empty: the group count stays uniform
    cp_async_wait<ST - 1>();  // tile i has landed for this thread...
    group_barrier(grp);       // ...and for the group
    const __nv_bfloat16* Kt = Ks + (i % ST) * MM_BN * LD;
    mma_attend<D, MM_BN>(st, qf, Kt, Vs + (i % ST) * MM_BN * LD, (grp + G * i) * MM_BN, lim0,
                         lim1, sl, lane);
    group_barrier(grp);  // the group is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  st.quad_sum_l();

  // Groups 1 .. G-1 hand their state to the thread of group 0 that owns the
  // same fragment, each through its own ring.
  static_assert(mma_rows_slots<D>() * MM_GROUP_THREADS * 4 <= mma_ring_elems<D>() * 2,
                "a ring holds a hand-over");
  auto xfer = [&](int gr) {
    return reinterpret_cast<float*>(Qs + MM_BM * LD + gr * mma_ring_elems<D>()) + tg;
  };
  if (grp > 0) mma_rows_store<D, MM_GROUP_THREADS>(st, xfer(grp));
  __syncthreads();
  if (grp > 0) return;
  mma_rows_merge<D, MM_GROUP_THREADS, G>(st, xfer);
  const float inv0 = 1.0f / fmaxf(st.l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(st.l1, 1e-30f);
  if (p.lse && t4 == 0) {  // m is in the log2 domain
    if (r0 < p.sq) store_lse(p, bi, hi, r0, st.m0 * kLn2, st.l0);
    if (r0 + 8 < p.sq) store_lse(p, bi, hi, r0 + 8, st.m1 * kLn2, st.l1);
  }
  if (p.o_f32) {  // the split route's partial: fp32, unrounded
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      st.acc[n][0] *= inv0;
      st.acc[n][1] *= inv0;
      st.acc[n][2] *= inv1;
      st.acc[n][3] *= inv1;
    }
    store_rows<float, D>(static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh, p.o_ss,
                         q0 + rw * 16, p.sq, st.acc, 1.f, lane);
    return;
  }
  if (r0 < p.sq) {
    __nv_bfloat16* orow = ob + (long long)r0 * p.o_ss + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(st.acc[n][0] * inv0, st.acc[n][1] * inv0);
  }
  if (r0 + 8 < p.sq) {
    __nv_bfloat16* orow = ob + (long long)(r0 + 8) * p.o_ss + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(st.acc[n][2] * inv1, st.acc[n][3] * inv1);
  }
}

// ------------------------------------------------------------------------- //
// Prefill, fp32: tensor cores, 3xTF32.
// ------------------------------------------------------------------------- //

constexpr int TF_ROWS = 64;      // query rows a block, 16 a warp
constexpr int TF_THREADS = 128;  // 4 warps
constexpr int TF_STAGES = 2;     // of the K/V ring: two blocks an SM at every head dim

// A warp keeps its Q rows as TF32 parts in registers at d <= 64 (64 of
// them a thread; a few percent faster at the train_lm layer than loading
// and splitting them again each tile, as d 128 must).
template <int D>
__host__ __device__ constexpr bool tf32_keep_q() {
  return D <= 64;
}

template <int D>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return (TF_ROWS + TF_STAGES * 2 * tile_rows<D>()) * pitch<float, D>() * (int)sizeof(float);
}

// The online softmax of one key tile on S's accumulator fragments, in
// place (S becomes P): the tile's row maximum by quad shuffles, m in the
// log2 domain, P = 2^(S scale log2 e - m), l and acc rescaled by
// 2^(m_old - m). MASK where the tile crosses a row's limit (`lim0`, `lim1`:
// one past the last key rows g and g + 8 may see).
template <bool MASK, int D, int NK>
__device__ __forceinline__ void tf32_softmax(MmaRows<D>& st, float (&s)[NK][4], float sl, int k0,
                                             int lim0, int lim1, int lane) {
  const int t4 = lane & 3;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (MASK) {
        const int kpos = k0 + n * 8 + 2 * t4 + e;
        s[n][e] = kpos < lim0 ? s[n][e] : kNegInf;
        s[n][2 + e] = kpos < lim1 ? s[n][2 + e] : kNegInf;
      }
      mx0 = fmaxf(mx0, s[n][e]);
      mx1 = fmaxf(mx1, s[n][2 + e]);
    }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }
  // A row with no visible key keeps m = kNegInf and subtracts 0, so a masked
  // score gives probability 0 either way (a masked maximum is not scaled:
  // sl < 1 would lift it above kNegInf).
  const float mn0 = fmaxf(st.m0, mx0 == kNegInf ? kNegInf : mx0 * sl);
  const float mn1 = fmaxf(st.m1, mx1 == kNegInf ? kNegInf : mx1 * sl);
  const float mu0 = mn0 == kNegInf ? 0.f : mn0, mu1 = mn1 == kNegInf ? 0.f : mn1;
  const float alpha0 = fast_exp2(st.m0 - mu0), alpha1 = fast_exp2(st.m1 - mu1);
  st.m0 = mn0;
  st.m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < NK; ++n) {
    s[n][0] = fast_exp2(fmaf(s[n][0], sl, -mu0));
    s[n][1] = fast_exp2(fmaf(s[n][1], sl, -mu0));
    s[n][2] = fast_exp2(fmaf(s[n][2], sl, -mu1));
    s[n][3] = fast_exp2(fmaf(s[n][3], sl, -mu1));
    rs0 += s[n][0] + s[n][1];
    rs1 += s[n][2] + s[n][3];
  }
  st.l0 = st.l0 * alpha0 + rs0;
  st.l1 = st.l1 * alpha1 + rs1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.acc[n][0] *= alpha0;
    st.acc[n][1] *= alpha0;
    st.acc[n][2] *= alpha1;
    st.acc[n][3] *= alpha1;
  }
}

template <int D>
__global__ void __launch_bounds__(TF_THREADS, 2) flash_tf32_kernel(Params p) {
  constexpr int LD = pitch<float, D>();
  constexpr int BN = tile_rows<D>();  // keys a tile
  constexpr int NK = BN / 8;          // n-tiles of S (8 keys each)
  constexpr int ST = TF_STAGES;
  constexpr bool KEEP = tf32_keep_q<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + TF_ROWS * LD;  // ST stages of (K, V), BN rows each

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int hi = blockIdx.x;
  const int bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TF_ROWS;  // longest causal rows first
  const int hk = hi / (p.h / p.hkv);
  const int kvlen = seq_kv_len(p, bi);
  const int off = p.q_offset ? p.q_offset[bi] : 0;
  const float sl = p.scale * kLog2e;
  // One past the last key that any row of this tile may see.
  int kv_hi = kvlen;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + TF_ROWS, p.sq) + off);
  const int tiles = kv_hi > 0 ? (kv_hi + BN - 1) / BN : 0;
  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  stage_rows<float, D, TF_ROWS, TF_THREADS>(
      static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh, p.q_ss, q0, p.sq, Qs,
      threadIdx.x);
  auto issue = [&](int i) {
    float* Kd = ring + (i % ST) * 2 * BN * LD;
    stage_rows<float, D, BN, TF_THREADS>(kb, p.k_ss, i * BN, kvlen, Kd, threadIdx.x);
    stage_rows<float, D, BN, TF_THREADS>(vb, p.v_ss, i * BN, kvlen, Kd + BN * LD, threadIdx.x);
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) issue(i);
    cp_async_commit();  // Q joins the first group
  }

  // This warp's rows qw .. qw + 15; this lane's r0 (fragment row g) and r0 + 8.
  const int qw = q0 + warp * 16;
  const int r0 = qw + g;
  const int lim0 = p.causal ? min(kvlen, r0 + off + 1) : kvlen;
  const int lim1 = p.causal ? min(kvlen, r0 + 8 + off + 1) : kvlen;
  // Keys below `full` are seen by every row of the warp; none at or past
  // `warp_hi` by any (a warp wholly past sq computes nothing).
  const int full = p.causal ? min(kvlen, qw + off + 1) : kvlen;
  const int warp_hi = qw >= p.sq ? 0 : p.causal ? min(kvlen, qw + 16 + off) : kvlen;
  const float* Qw = Qs + warp * 16 * LD;
  uint32_t qf[KEEP ? D / 4 : 1][4];  // k-step kk: hi in qf[2 kk], lo in qf[2 kk + 1]
  MmaRows<D> st;
  st.init();

  for (int i = 0; i < tiles; ++i) {
    if (i + ST - 1 < tiles) issue(i + ST - 1);
    cp_async_commit();        // possibly empty: the group count stays uniform
    cp_async_wait<ST - 1>();  // tile i has landed for this thread...
    __syncthreads();          // ...and for the block
    const int k0 = i * BN;
    const float* Kt = ring + (i % ST) * 2 * BN * LD;
    if (KEEP && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (KEEP ? D / 8 : 0); ++kk)
        tf32_a_fragment<D>(Qw, kk, lane, qf[2 * kk], qf[2 * kk + 1]);
    }
    if (k0 < warp_hi) {
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      warp_scores<float, D, NK>(s, Qw, Kt, lane, KEEP ? qf : nullptr);  // S = Q K^T
      if (k0 + BN <= full)
        tf32_softmax<false, D, NK>(st, s, sl, k0, lim0, lim1, lane);
      else
        tf32_softmax<true, D, NK>(st, s, sl, k0, lim0, lim1, lane);
      warp_accumulate<float, D, NK>(st.acc, s, Kt + BN * LD, lane);  // acc += P V
    }
    __syncthreads();  // the block is done with this stage before it is refilled
  }
  cp_async_commit();
  cp_async_wait<0>();
  st.quad_sum_l();

  const float inv0 = 1.0f / fmaxf(st.l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(st.l1, 1e-30f);
  if (p.lse && (lane & 3) == 0) {  // m is in the log2 domain
    if (r0 < p.sq) store_lse(p, bi, hi, r0, st.m0 * kLn2, st.l0);
    if (r0 + 8 < p.sq) store_lse(p, bi, hi, r0 + 8, st.m1 * kLn2, st.l1);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.acc[n][0] *= inv0;
    st.acc[n][1] *= inv0;
    st.acc[n][2] *= inv1;
    st.acc[n][3] *= inv1;
  }
  store_rows<float, D>(static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh, p.o_ss, qw, p.sq,
                       st.acc, 1.f, lane);
}

// ------------------------------------------------------------------------- //
// Decode: one (batch, KV head) per cluster, its keys dealt over the
// cluster's warps; the partials merged within each block, then across the
// cluster.
// ------------------------------------------------------------------------- //

// Which keys a decode block's warp takes: tiles of kDecodeTile keys below
// `kv_hi`, tile t to warp t mod (cluster blocks * warps), consecutive tiles
// on different blocks (SMs) first.
struct DecodeSplit {
  int kvlen, off, kv_hi;
  int gw, nw, ntiles;  // this warp's index among nw, the tiles dealt

  __device__ __forceinline__ DecodeSplit(const Params& p, int bi, int warps, int warp) {
    kvlen = seq_kv_len(p, bi);
    off = p.q_offset ? p.q_offset[bi] : 0;
    kv_hi = kvlen;  // one past the last key any row may see
    if (p.causal) kv_hi = min(kv_hi, p.sq + off);
    kv_hi = max(kv_hi, 0);
    cg::cluster_group cluster = cg::this_cluster();
    const int csize = (int)cluster.num_blocks();
    nw = csize * warps;
    gw = warp * csize + (int)cluster.block_rank();
    ntiles = (kv_hi + kDecodeTile - 1) / kDecodeTile;
  }
  __device__ __forceinline__ int tiles() const {  // this warp's
    return ntiles > gw ? (ntiles - gw + nw - 1) / nw : 0;
  }
  __device__ __forceinline__ int key0(int i) const {  // first key of this warp's i-th tile
    return (gw + nw * i) * kDecodeTile;
  }
  // One past the last key of query position `pos` (0 .. sq - 1).
  __device__ __forceinline__ int lim(const Params& p, int pos) const {
    return p.causal ? min(kvlen, pos + off + 1) : kvlen;
  }
};

// The cluster's merge. Block 0 of a cluster has one slot per block, each
// (RM, D) unnormalised output, then RM values of m (log2 domain) and RM of l,
// padded to whole 16 bytes. Every block stores its partial into its slot of
// block 0 through distributed shared memory, arrives at the cluster barrier
// and leaves; block 0 waits and merges its slots. One barrier that only
// block 0 waits at, no global scratch, no second launch. The barrier's first
// phase, opened at each kernel's start and closed before these stores,
// makes sure block 0 has started (and its shared memory exists) before any
// block stores into it.
template <int RM, int D>
__host__ __device__ constexpr int merge_slot_floats() {
  return RM * D + (2 * RM + 3) / 4 * 4;
}

// This block's slot in block 0.
template <int RM, int D>
__device__ __forceinline__ float* merge_slot(float* slots) {
  cg::cluster_group cluster = cg::this_cluster();
  return cluster.map_shared_rank(slots, 0) + (int)cluster.block_rank() * merge_slot_floats<RM, D>();
}

// Output row r of a decode block: packed row r0 + r of the KV head's group,
// query head hk * group + (r0 + r) / sq at position (r0 + r) % sq.
template <typename T>
__device__ __forceinline__ T* decode_out_row(const Params& p, int bi, int hk, int r0, int r) {
  const int row = r0 + r;
  return static_cast<T*>(p.o) + bi * p.o_sb + (long long)(hk * (p.h / p.hkv) + row / p.sq) * p.o_sh +
         (long long)(row % p.sq) * p.o_ss;
}

// Block 0's threads: rows [0, nr) of the block's rows r0 .. of KV head hk
// from the `csize` slots, into the output as OUT; with `lse`, each row's
// log-sum-exp too: the slots' m are in the log2 domain, so it is
// big * ln 2 + ln(total), +inf for a row that saw no key (total 0).
template <int RM, int D, typename OUT>
__device__ __forceinline__ void merge_slots(const float* slots, int csize, int nr, const Params& p,
                                            int bi, int hk, int r0) {
  constexpr int SLOT = merge_slot_floats<RM, D>();
  constexpr int Q4 = D / 4;
  for (int e = threadIdx.x; e < nr * Q4; e += blockDim.x) {
    const int r = e / Q4;
    const int col = (e % Q4) * 4;
    float big = kNegInf;
    for (int c = 0; c < csize; ++c) big = fmaxf(big, slots[c * SLOT + RM * D + r]);
    float total = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < csize; ++c) {
      const float* sl = slots + c * SLOT;
      const float sc = fast_exp2(sl[RM * D + r] - big);
      total += sl[RM * D + RM + r] * sc;
      const float4 pv = *reinterpret_cast<const float4*>(sl + r * D + col);
      o[0] = fmaf(pv.x, sc, o[0]);
      o[1] = fmaf(pv.y, sc, o[1]);
      o[2] = fmaf(pv.z, sc, o[2]);
      o[3] = fmaf(pv.w, sc, o[3]);
    }
    const float inv = 1.0f / fmaxf(total, 1e-30f);
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] *= inv;
    if (p.lse && col == 0) {
      const int row = r0 + r;
      store_lse(p, bi, hk * (p.h / p.hkv) + row / p.sq, row % p.sq, big * kLn2, total);
    }
    store4(decode_out_row<OUT>(p, bi, hk, r0, r) + col, o);
  }
}

template <typename T>
__device__ __forceinline__ const T* decode_q_row(const Params& p, int bi, int hk, int row) {
  return static_cast<const T*>(p.q) + bi * p.q_sb +
         (long long)(hk * (p.h / p.hkv) + row / p.sq) * p.q_sh + (long long)(row % p.sq) * p.q_ss;
}

// ---- bf16: tensor cores ---------------------------------------------------- //

constexpr int DM_ROWS = 16;  // query rows a block: one mma row tile

constexpr int DM_WARPS = 4;  // warps a block, each with keys of its own

// Stages of a warp's ring. At d 64, four: a decode tick's longest sequence
// gives a warp up to four tiles at cluster 4, and with all of them in flight
// at once the tick ran faster than with two or three (and than with more
// warps a block or 64-key tiles). The block then takes 163 KiB with its
// merge slots, one a SM, which a decode tick's 96 blocks allow. At d 128 two
// stages and the slots take 173 KiB. At d 160 two stages take 177,408 bytes
// and each block of the cluster adds a 10,368-byte slot: a cluster of 4 fits
// a block's 232,448, one of 8 does not (the attribute call refuses it, so
// it is never launched; the wrapper refuses it first).
template <int D>
__host__ __device__ constexpr int dm_stages() {
  return D == 64 ? 4 : 2;
}

template <int D>
__host__ __device__ constexpr int dm_stage_elems() {  // K, then V
  return 2 * kDecodeTile * (D + 8);
}

template <int D>
__host__ __device__ constexpr int dm_ring_elems() {
  return dm_stages<D>() * dm_stage_elems<D>();
}

// Q (16, D + 8) and the warps' rings as bf16; the merge's slots (one a
// block of the cluster) follow.
template <int D>
__host__ __device__ constexpr int dm_smem_bytes() {
  return (DM_ROWS * (D + 8) + DM_WARPS * dm_ring_elems<D>()) * (int)sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(DM_WARPS * 32) flash_decode_mma_kernel(Params p) {
  constexpr int W = DM_WARPS;
  constexpr int ST = dm_stages<D>();
  constexpr int TILE = kDecodeTile;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int NO = D / 8;
  constexpr int QCH = D / 8;  // 16-byte chunks of a q row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* rings = Qs + DM_ROWS * LD;
  float* slots = reinterpret_cast<float*>(rings + W * dm_ring_elems<D>());
  static_assert(mma_rows_slots<D>() * 32 * 4 <= dm_ring_elems<D>() * 2,
                "a warp's ring holds its hand-over");
  cluster_arrive_relaxed();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rows_all = p.h / p.hkv * p.sq;
  const int chunks = (rows_all + DM_ROWS - 1) / DM_ROWS;
  const int hk = blockIdx.y / chunks;
  const int r0 = (blockIdx.y % chunks) * DM_ROWS;
  const int nr = min(DM_ROWS, rows_all - r0);
  const int bi = blockIdx.z;

  // The block's q rows first (they depend on nothing), zeros past nr.
  for (int c = threadIdx.x; c < DM_ROWS * QCH; c += W * 32) {
    const int r = c / QCH;
    const int col = (c % QCH) * 8;
    const bool in = r < nr;
    const __nv_bfloat16* src = in ? decode_q_row<__nv_bfloat16>(p, bi, hk, r0 + r) + col
                                  : static_cast<const __nv_bfloat16*>(p.q);
    cp_async16(Qs + r * LD + col, src, in);
  }
  cp_async_commit();

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  const DecodeSplit split(p, bi, W, warp);
  const int ng = split.tiles();
  __nv_bfloat16* ring = rings + warp * dm_ring_elems<D>();
  // This warp's i-th tile into ring slot i % ST, K rows then V rows,
  // neighbouring lanes on neighbouring 16 bytes; keys from kv_hi on are zeros.
  auto issue = [&](int i) {
    __nv_bfloat16* dst = ring + (i % ST) * dm_stage_elems<D>();
    stage_rows<__nv_bfloat16, D, TILE, 32>(kb, p.k_ss, split.key0(i), split.kv_hi, dst, lane);
    stage_rows<__nv_bfloat16, D, TILE, 32>(vb, p.v_ss, split.key0(i), split.kv_hi,
                                           dst + TILE * LD, lane);
  };
#pragma unroll
  for (int i = 0; i < ST; ++i) {
    if (i < ng) issue(i);
    cp_async_commit();
  }
  cp_async_wait<ST>();  // q has landed for this thread...
  __syncthreads();         // ...and for every thread
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], Qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);

  // Rows past nr see no key: they stay zero and are not written.
  const int lim0 = g < nr ? split.lim(p, (r0 + g) % p.sq) : 0;
  const int lim1 = g + 8 < nr ? split.lim(p, (r0 + g + 8) % p.sq) : 0;
  const float sl = p.scale * kLog2e;
  MmaRows<D> st;
  st.init();
  for (int i = 0; i < ng; ++i) {
    cp_async_wait<ST - 1>();  // tile i has landed for this lane...
    __syncwarp();                // ...and for the warp
    const __nv_bfloat16* Kt = ring + (i % ST) * dm_stage_elems<D>();
    mma_attend<D, TILE>(st, qf, Kt, Kt + TILE * LD, split.key0(i), lim0, lim1, sl, lane);
    __syncwarp();  // the warp is done with the stage before it is refilled
    if (i + ST < ng) issue(i + ST);
    cp_async_commit();
  }
  cp_async_wait<0>();
  st.quad_sum_l();

  // Warps 1 .. W-1 hand their state to warp 0 through their own rings; warp 0
  // stores the block's partial into its slot of block 0.
  auto xfer = [&](int w) { return reinterpret_cast<float*>(rings + w * dm_ring_elems<D>()) + lane; };
  if (warp > 0) mma_rows_store<D, 32>(st, xfer(warp));
  __syncthreads();
  cluster_wait();  // block 0 has started
  if (warp == 0) {
    mma_rows_merge<D, 32, W>(st, xfer);
    float* slot = merge_slot<DM_ROWS, D>(slots);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(slot + g * D + n * 8 + 2 * t4) =
          make_float2(st.acc[n][0], st.acc[n][1]);
      *reinterpret_cast<float2*>(slot + (g + 8) * D + n * 8 + 2 * t4) =
          make_float2(st.acc[n][2], st.acc[n][3]);
    }
    if (t4 == 0) {
      slot[DM_ROWS * D + g] = st.m0;
      slot[DM_ROWS * D + g + 8] = st.m1;
      slot[DM_ROWS * D + DM_ROWS + g] = st.l0;
      slot[DM_ROWS * D + DM_ROWS + g + 8] = st.l1;
    }
  }
  cluster_arrive();  // this block's slot is written
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.block_rank() != 0) return;
  cluster_wait();
  if (p.o_f32)
    merge_slots<DM_ROWS, D, float>(slots, (int)cluster.num_blocks(), nr, p, bi, hk, r0);
  else
    merge_slots<DM_ROWS, D, __nv_bfloat16>(slots, (int)cluster.num_blocks(), nr, p, bi, hk, r0);
}

// ---- fp32: the fp32 pipes ------------------------------------------------ //

constexpr int DEC_WARPS = 4;
// Query rows a block holds when there is more than one: a lane's scalar work
// grows with them, so 4 (chunks of 4, each re-reading the keys) ran faster
// than 16 and than 1 (PERF.md).
constexpr int DEC_ROWS = 4;
constexpr int DEC_PITCH_PAD = 4;  // floats of pad a staged K or V row

template <int D>
__host__ __device__ constexpr int dec_stages() {  // a warp's ring: two stages up to 256-byte rows
  return D * (int)sizeof(float) <= 256 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int dec_warp_ring_floats() {
  return dec_stages<D>() * 2 * kDecodeTile * (D + DEC_PITCH_PAD);
}

// Shared memory: the warps' rings (then their partial outputs), q (RM, D),
// each warp's probabilities (RM, 32); the merge's slots follow.
template <int D, int RM>
__host__ __device__ constexpr int decode_f32_smem_bytes() {
  return 4 * (DEC_WARPS * dec_warp_ring_floats<D>() + RM * D + DEC_WARPS * RM * kDecodeTile);
}

// N consecutive floats at p (N * 4 bytes, aligned).
// Five at d 160 (a lane's 20 bytes are not 8-byte aligned): scalar loads.
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) out[u] = p[u];
  }
}

// RM: query rows a block holds (its chunk of the group * sq rows, padded
// with zero rows that are computed and dropped, so the row loops have no
// branches; more rows take more chunks in grid y, each re-reading the keys).
template <int D, int RM>
__global__ void __launch_bounds__(DEC_WARPS * 32) flash_decode_f32_kernel(Params p) {
  constexpr int PITCH = D + DEC_PITCH_PAD;  // floats
  constexpr int CH = D / 4;                 // 16-byte chunks a row
  constexpr int WS = dec_stages<D>();
  constexpr int DL = D / 32;                // output columns a lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rings = reinterpret_cast<float*>(smem_raw);
  float* qs = rings + DEC_WARPS * dec_warp_ring_floats<D>();
  float* slots = qs + RM * D + DEC_WARPS * RM * kDecodeTile;
  cluster_arrive_relaxed();

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows_all = p.h / p.hkv * p.sq;
  const int chunks = (rows_all + RM - 1) / RM;
  const int hk = blockIdx.y / chunks;
  const int r0 = (blockIdx.y % chunks) * RM;
  const int nr = min(RM, rows_all - r0);
  const int bi = blockIdx.z;
  float* wring = rings + warp * dec_warp_ring_floats<D>();
  float* ps = qs + RM * D + warp * RM * kDecodeTile;

  // The block's q rows first (they depend on nothing), zeros past nr.
  for (int c = tid; c < RM * CH; c += DEC_WARPS * 32) {
    const int r = c / CH;
    const int col = (c % CH) * 4;
    const bool in = r < nr;
    const float* src = in ? decode_q_row<float>(p, bi, hk, r0 + r) + col
                          : static_cast<const float*>(p.q);
    cp_async16(qs + r * D + col, src, in);
  }
  cp_async_commit();

  const DecodeSplit split(p, bi, DEC_WARPS, warp);
  const int nst = split.tiles();
  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  // This warp's i-th tile: K rows then V rows, neighbouring lanes on
  // neighbouring 16 bytes; keys from kv_hi on are zeros.
  auto issue = [&](int i) {
    float* kdst = wring + (i % WS) * 2 * kDecodeTile * PITCH;
    float* vdst = kdst + kDecodeTile * PITCH;
    const int kbase = split.key0(i);
#pragma unroll
    for (int c = lane; c < kDecodeTile * CH; c += 32) {
      const int r = c / CH;
      const int col = (c % CH) * 4;
      const bool in = kbase + r < split.kv_hi;
      const long long kr = in ? (long long)(kbase + r) : 0;
      cp_async16(kdst + r * PITCH + col, kb + kr * p.k_ss + col, in);
      cp_async16(vdst + r * PITCH + col, vb + kr * p.v_ss + col, in);
    }
  };
#pragma unroll
  for (int i = 0; i < WS; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();
  }
  cp_async_wait<WS>();  // q has landed for this thread...
  __syncthreads();      // ...and for every thread

  // m is the same in every lane; l is this lane's keys' share, summed at the
  // end; acc holds columns lane * DL .. + DL - 1 of each row.
  float m[RM], l[RM], acc[RM][DL];
  int lim[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    lim[r] = split.lim(p, (r0 + r) % p.sq);
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }

  for (int i = 0; i < nst; ++i) {
    cp_async_wait<WS - 1>();  // tile i has landed for this lane...
    __syncwarp();             // ...and for the warp
    const float* Kt = wring + (i % WS) * 2 * kDecodeTile * PITCH;
    const float* Vt = Kt + kDecodeTile * PITCH;
    const int kpos = split.key0(i) + lane;

    // This lane's key against every row (q broadcast, K rows on distinct
    // banks).
    float s[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      float kf[4];
      load_cols<4>(Kt + lane * PITCH + c, kf);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        float qf[4];
        load_cols<4>(qs + r * D + c, qf);
#pragma unroll
        for (int u = 0; u < 4; ++u) s[r] = fmaf(qf[u], kf[u], s[r]);
      }
    }

    // Online softmax, every row at once.
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const bool valid = kpos < lim[r];
      const float sc = valid ? s[r] * p.scale : kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = __expf(m[r] - m_new);
      const float pe = valid ? __expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + pe;
      m[r] = m_new;
      ps[r * kDecodeTile + lane] = pe;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();

    // acc += P V over the tile's 32 keys.
#pragma unroll 2
    for (int j = 0; j < kDecodeTile; j += 4) {
      float vf[4][DL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) load_cols<DL>(Vt + (j + jj) * PITCH + lane * DL, vf[jj]);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(ps + r * kDecodeTile + j);
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          acc[r][e] = fmaf(pv.x, vf[0][e], acc[r][e]);
          acc[r][e] = fmaf(pv.y, vf[1][e], acc[r][e]);
          acc[r][e] = fmaf(pv.z, vf[2][e], acc[r][e]);
          acc[r][e] = fmaf(pv.w, vf[3][e], acc[r][e]);
        }
      }
    }
    __syncwarp();  // the stage and the probabilities are refilled next
    if (i + WS < nst) issue(i + WS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The warp's partial (m, l, acc) into its own ring, (RM, D) then m, l.
  float* wacc = wring;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float lr = l[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lr += __shfl_xor_sync(0xffffffffu, lr, o);
    if (r < nr) {
#pragma unroll
      for (int e = 0; e < DL; ++e) wacc[r * D + lane * DL + e] = acc[r][e];
      if (lane == 0) {
        wacc[RM * D + r] = m[r];
        wacc[RM * D + RM + r] = lr;
      }
    }
  }
  __syncthreads();

  // The block's partial, the four warps merged, into its slot of block 0; m
  // into the log2 domain the cluster's merge takes.
  // Four columns a thread, so each remote store is 16 bytes.
  cluster_wait();  // block 0 has started
  float* slot = merge_slot<RM, D>(slots);
  constexpr int Q4 = D / 4;
  for (int e = tid; e < nr * Q4; e += DEC_WARPS * 32) {
    const int r = e / Q4;
    float big = kNegInf;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w)
      big = fmaxf(big, rings[w * dec_warp_ring_floats<D>() + RM * D + r]);
    float total = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float* wp = rings + w * dec_warp_ring_floats<D>();
      const float sc = __expf(wp[RM * D + r] - big);
      total += wp[RM * D + RM + r] * sc;
      const float4 pv = reinterpret_cast<const float4*>(wp)[e];
      o[0] = fmaf(pv.x, sc, o[0]);
      o[1] = fmaf(pv.y, sc, o[1]);
      o[2] = fmaf(pv.z, sc, o[2]);
      o[3] = fmaf(pv.w, sc, o[3]);
    }
    store4(slot + 4 * e, o);
    if (e % Q4 == 0) {
      slot[RM * D + r] = big * kLog2e;
      slot[RM * D + RM + r] = total;
    }
  }
  cluster_arrive();  // this block's slot is written
  cg::cluster_group cluster = cg::this_cluster();
  if (cluster.block_rank() != 0) return;
  cluster_wait();
  merge_slots<RM, D, float>(slots, (int)cluster.num_blocks(), nr, p, bi, hk, r0);
}

// ------------------------------------------------------------------------- //
// Launch
// ------------------------------------------------------------------------- //

// One block per (cluster rank, KV head x row chunk, batch), clusters along x;
// shared memory: the kernel's own, then one merge slot a block of the cluster.
cudaError_t launch_decode(void (*kernel)(Params), const Params& p, int rows_a_block, int threads,
                          int smem_own, int slot_floats, int csize, cudaStream_t stream) {
  const int smem = smem_own + csize * slot_floats * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (p.h / p.hkv * p.sq + rows_a_block - 1) / rows_a_block;
  if ((long long)p.hkv * chunks > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, p.hkv * chunks, p.b);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, int cluster, cudaStream_t stream) {
  // The training route's log-sum-exp comes from the prefill kernels at any
  // length; the split serving route (o_f32) takes the decode kernels at
  // sq <= 8, which then write it too. Neither decode kernel has d 16 (that
  // head dim is the training route's alone).
  if constexpr (D == 16) {
    if (p.lse == nullptr || p.o_f32) return cudaErrorInvalidValue;
  } else if (p.sq <= kDecodeMaxSq && (p.lse == nullptr || p.o_f32)) {
    int csize = cluster > 0 ? cluster : kDecodeDefaultCluster;
    csize = max(1, min(csize, (p.skv + kDecodeTile - 1) / kDecodeTile));  // no wider than the keys
    while (csize & (csize - 1)) --csize;  // 1, 2, 4 or 8: other sizes ran far slower (PERF.md)
    if constexpr (kBf16<T>) {
      return launch_decode(flash_decode_mma_kernel<D>, p, DM_ROWS, DM_WARPS * 32,
                           dm_smem_bytes<D>(), merge_slot_floats<DM_ROWS, D>(), csize, stream);
    } else {
      if (p.h / p.hkv * p.sq == 1)
        return launch_decode(flash_decode_f32_kernel<D, 1>, p, 1, DEC_WARPS * 32,
                             decode_f32_smem_bytes<D, 1>(), merge_slot_floats<1, D>(), csize,
                             stream);
      return launch_decode(flash_decode_f32_kernel<D, DEC_ROWS>, p, DEC_ROWS, DEC_WARPS * 32,
                           decode_f32_smem_bytes<D, DEC_ROWS>(), merge_slot_floats<DEC_ROWS, D>(),
                           csize, stream);
    }
  }
  if constexpr (kBf16<T>) {
    constexpr int smem = mma_smem_bytes<D>();
    cudaError_t err =
        cudaFuncSetAttribute(flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_mma_kernel<D><<<dim3(p.h, (p.sq + MM_BM - 1) / MM_BM, p.b),
                          MM_GROUPS * MM_GROUP_THREADS, smem, stream>>>(p);
  } else {
    constexpr int smem = tf32_smem_bytes<D>();
    const int qtiles = (p.sq + TF_ROWS - 1) / TF_ROWS;
    if (qtiles > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(flash_tf32_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_tf32_kernel<D><<<dim3(p.h, p.b, qtiles), TF_THREADS, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, int cluster, cudaStream_t stream) {
  if (d == 16) return launch<T, 16>(p, cluster, stream);
  if (d == 64) return launch<T, 64>(p, cluster, stream);
  if (d == 128) return launch<T, 128>(p, cluster, stream);
  if (d == 160) return launch<T, 160>(p, cluster, stream);
  return cudaErrorInvalidValue;
}

// q, o: (b, h, sq, d); k, v: (b, hkv, skv, d); strides in elements, last dim
// contiguous, every row 16-byte aligned. kv_len and q_offset are int32 (b,) on
// the device or null. lse is fp32 (b, h, sq) contiguous or null. o_f32: o is
// fp32 whatever the inputs' type, and sq <= 8 takes the decode kernels even
// with lse (the split serving route). dtype: 0 = float32, 1 = bfloat16. d:
// 64, 128 or 160, or 16 with lse and not o_f32. cluster: blocks a (batch, KV
// head) splits its keys over on the decode kernels (1, 2, 4 or 8; 0 for the
// default). Returns the CUDA error code of the launch (0 on success).
int run(const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_len,
        const void* q_offset, int b, int h, int hkv, int sq, int skv, int d, long long q_sb,
        long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
        long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
        long long o_ss, float scale, int causal, int cluster, int o_f32, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0 || h > 65535 ||
      b > 65535 || cluster < 0 || cluster > kDecodeMaxCluster)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.kv_len = static_cast<const int*>(kv_len);
  p.q_offset = static_cast<const int*>(q_offset);
  p.lse = static_cast<float*>(lse);
  p.o_f32 = o_f32;
  p.b = b; p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(p, d, cluster, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(p, d, cluster, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The serving entry point: no log-sum-exp. Arguments as `run`.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* kv_len,
    const void* q_offset, int b, int h, int hkv, int sq, int skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int cluster, int dtype,
    void* stream) {
  return run(q, k, v, o, nullptr, kv_len, q_offset, b, h, hkv, sq, skv, d, q_sb, q_sh, q_ss,
             k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, cluster, 0,
             dtype, stream);
}

// The training entry point: also writes the rows' log-sum-exp into `lse`
// (fp32 (b, h, sq), contiguous), with the prefill kernels at every length.
// q_offset as the serving entry point's (null: 0): a rank's block of the
// query rows of a sequence split over ranks, over the whole sequence's keys.
extern "C" int repro_flash_attention_lse(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* q_offset,
    int b, int h, int hkv, int sq, int skv, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, float scale, int causal,
    int dtype, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, k, v, o, lse, nullptr, q_offset, b, h, hkv, sq, skv, d, q_sb, q_sh, q_ss, k_sb,
             k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, 0, 0, dtype, stream);
}

// The split serving route: one rank's partial of rows whose keys are split
// over ranks, for their combine by log-sum-exp. `o` is fp32 (b, h, sq, d)
// whatever the inputs' type (the row as the kernel holds it, not rounded
// before the combine) and `lse` the rows' log-sum-exp (+inf for a row that
// sees no key). The decode kernels at sq <= 8, else the prefill kernels;
// kv_len, q_offset and cluster as the serving entry point's.
extern "C" int repro_flash_attention_partial(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_len,
    const void* q_offset, int b, int h, int hkv, int sq, int skv, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, float scale, int causal, int cluster, int dtype, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, k, v, o, lse, kv_len, q_offset, b, h, hkv, sq, skv, d, q_sb, q_sh, q_ss, k_sb,
             k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, cluster, 1, dtype,
             stream);
}
