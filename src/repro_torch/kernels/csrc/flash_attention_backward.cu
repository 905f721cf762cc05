// Flash attention backward for Hopper (sm_90a), on the tensor cores.
//
// The JAX package has no Pallas backward: `jax.grad` differentiates the
// attention of src/repro/models/common.py. This is the gradient of the
// forward kernel (flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py `_flash_kernel`) for training: given
// q, k, v, the forward's output o, its rows' log-sum-exp lse and dO, it
// returns dQ, dK, dV. GQA (query head i reads KV head i / (h / hkv)), causal
// top-left (`kpos <= qpos`) or not, with the forward's per-sequence
// `q_offset[b]` (`kpos <= qpos + q_offset[b]`: a rank's block of the query
// rows of a sequence split over ranks, over the whole sequence's keys); no
// kv_len.
//
// The arithmetic is the forward's: S = Q K^T * scale, P = exp(S - lse) (0
// where masked), with P rounded to the input type where the forward rounds it
// (before P V, so dV = P^T dO takes the rounded P); dP = dO V^T; D =
// rowsum(dO * O); dS = P * (dP - D); dQ = dS K * scale, dK = dS^T Q * scale.
// Every sum is fp32; the results are rounded once.
//
// Bound on this card: operations, 5 products of 2 s^2 d a head (half when
// causal) against 2 x 4 s d + 2 x 2 s d values moved: at smollm-135m's
// training layer (b 8, h 9, hkv 3, s 2048, d 64, causal) 0.098 ms in bf16 at
// 989 TFLOP/s; in fp32 1.443 ms on the fp32 pipes (67 TFLOP/s) or 0.586 ms as
// three TF32 products at 495 TFLOP/s. Every product runs on `mma.sync`:
//  * bf16: `m16n8k16` (bf16 in, fp32 accumulators). Tiles stay bf16 in shared
//    memory and are fetched by `ldmatrix` (`.trans` where the tile is the B
//    operand along its rows); a warp's own 16 rows of K and V (dK/dV) or of
//    Q and dO (dQ) stay in registers as A fragments at d <= 64. P and dS
//    enter their second products rounded once to bf16, re-packed from the
//    score accumulators straight into A operands in registers, as the
//    forward's `mma_attend` packs P.
//  * fp32: 3xTF32 on `m16n8k8`: each operand split into hi (its low 13 bits
//    cleared) and lo = v - hi (`split_tf32`) on its way out of shared memory
//    or out of the score accumulators, and hi lo + lo hi + hi hi summed in
//    fp32: ~20 bits of each product, where one TF32 product keeps 10 and
//    could not hold fp32's 2e-5. Tiles stay fp32 in shared memory, rows
//    padded by 16 bytes, which puts the fragment loads of a warp on 32
//    distinct banks; a fragment whose rows run along k comes by `ldmatrix`
//    (on fp32 rows it hands lane (g, t) row g's value t, the TF32 fragment
//    layout), the others by scalar loads; the k index of a product whose A
//    operand comes from accumulators is taken in the accumulators' own
//    column order (k = t <-> column 2 t, k = t + 4 <-> 2 t + 1), so no
//    shuffle re-packs them. The
//    tensor cores' accumulation rounds toward zero, so a long sum (dK and dV
//    over ~6,000 queries) takes each tile's product in a fresh fragment and
//    adds it by an fp32 add.
// Tiles arrive by 16-byte `cp.async` into rings of stages, so the next tile
// loads while one computes; the causal mask is applied only in the tiles that
// cross the diagonal or an edge (the others take an unmasked copy of the
// element-wise step, whose predicated form was its largest cost). What
// stands between these kernels and the bound: the two recomputed products,
// and `mma.sync` itself; `wgmma`, at twice its rate with larger warp tiles,
// is later work. The warp step (`warp_scores`, `warp_accumulate`) and the
// staging of tiles live in attn_warp.cuh, shared with the fp32 forward.
//
// Deterministic: no float atomics, each result written once, every sum in a
// fixed order. Kernels, in order on the stream:
//  (a) `bwd_delta_kernel`: D, 16 bytes of a row a lane.
//  (b) `bwd_dkdv_kernel`: one block of 4 warps per (batch, KV head, 64-key
//      tile, split). Each warp owns 16 keys: it computes S^T = K Q^T and dP^T =
//      V dO^T as accumulator fragments for a tile of queries, builds P^T and
//      dS^T in registers, and adds dV += P^T dO and dK += dS^T Q, which stay in
//      registers over the loop. The block walks the query heads of its split
//      of the GQA group and, for each, the query tiles that may see its keys,
//      so the reduction over the group is a sum in registers in a fixed order.
//      Where one split (the whole group) would leave the card with fewer than
//      about two blocks an SM, the host splits the group's heads over blocks
//      (`flash_attention_backward_plan`); each block then writes fp32
//      partials of dK, dV to scratch (b, hkv, splits, skv, d) and
//  (b') `bwd_sum_kernel` adds them in split order and rounds once.
//  (c) `bwd_dq_kernel`: one block of 4 warps per (batch, head, 64-query tile),
//      each warp 16 queries, looping over the key tiles its rows may see: S
//      and dP again, dS in registers, dQ += dS K.
// S and dP are recomputed in (b) and (c), two products more than the bound
// counts (7 against 5); storing dS or adding dQ by atomics would cost s^2
// bytes a head or the determinism. At d 128 a streamed tile is 32 rows (the
// dK and dV accumulators take 128 registers a thread), and fp32 at d 128 has
// a ring of one stage, so two blocks fit an SM.
//
// Head dim 160 (zamba2's shared attention block: 32 heads of 160) has tiles
// of its own (`bwd_rows`, `bwd_stages`; the forward keeps `tile_rows`):
//  * registers: a warp's dK and dV over its 16 keys are 2 x 20 n-tiles x 4
//    = 160 fp32 registers a thread for the whole loop, beside S^T and dP^T
//    (8 registers for each 8 queries a streamed tile holds) and the TF32
//    splits. fp32 streams 16 queries a tile, bf16 32. The fp32 dK/dV
//    kernel still takes all 255 registers and spills 8 bytes (48 at 32
//    queries; d 128 spills 92).
//  * shared memory: an fp32 row is 164 floats (656 bytes); two stages of 64
//    rows of Q and dO beside the 64 keys' K and V would take 251,904 bytes,
//    over a block's 232,448. fp32 streams 16 rows in one stage: 105,088
//    bytes a dK/dV block and 104,960 a dQ block, so two blocks share an SM,
//    as at d 128; bf16 32 rows in two stages, 86,528 and 86,016.
//    (`attn_bwd_variants.py` times these against other rows and stages.)
//  * D's row of 40 (fp32) or 20 (bf16) 16-byte chunks is not a power of two
//    of lanes: 8 or 4 lanes take 5 chunks each, in order.
//
// With `q_offset` every causal test reads `qpos + off`: the first query tile
// of a dK/dV block is the one whose rows may see its first key, the diagonal
// tiles are those that cross `kpos = qpos + off`, and a dQ block stops at the
// last key its rows may see. A key tile that no query of the call sees (the
// keys of a later rank's block, with a small offset) has no (head, query
// tile) item: its block stages nothing and writes dK = dV = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_warp.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;      // keys of a dK/dV block, queries of a dQ block
constexpr int kThreads = 128;  // 4 warps, 16 of those rows each

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (b, h, sq), contiguous
  float* delta;      // (b, h, sq), contiguous: scratch for D
  float* part;       // (2, b, hkv, splits, skv, d) fp32 partial dK, dV; splits > 1 only
  const int* q_offset;  // (b,) or null: 0; causal only
  void* dq;
  void* dk;
  void* dv;
  int b, h, hkv, sq, skv, splits;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim has stride 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  float scale;
  int causal;
};

// (a) D = rowsum(dO * O) in fp32 for the rows of (b, h, sq): a row's 16-byte
// chunks over L lanes, the largest power of two up to 32 that divides them
// (one chunk a lane but at d 160), each lane summing its chunks in order,
// then the lanes by shuffles in a fixed order.
template <typename T, int D>
__host__ __device__ constexpr int delta_chunks() {
  return D * (int)sizeof(T) / 16;
}

template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  int l = 32;
  while (delta_chunks<T, D>() % l) l >>= 1;
  return l;
}

__device__ __forceinline__ float dot16(const float* o, const float* g) {
  const float4 a = *reinterpret_cast<const float4*>(o), b = *reinterpret_cast<const float4*>(g);
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float dot16(const __nv_bfloat16* o, const __nv_bfloat16* g) {
  const uint4 ra = *reinterpret_cast<const uint4*>(o), rb = *reinterpret_cast<const uint4*>(g);
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&ra);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&rb);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(a[i]), y = __bfloat1622float2(b[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_delta_kernel(BwdParams p) {
  constexpr int L = delta_lanes<T, D>();
  constexpr int PER = 16 / (int)sizeof(T);  // values a chunk
  constexpr int N = delta_chunks<T, D>() / L;
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / L;
  const int c = (threadIdx.x % L) * PER;
  const bool in = row < (long long)p.b * p.h * p.sq;
  float acc = 0.f;
  if (in) {
    const int qi = (int)(row % p.sq);
    const int hi = (int)((row / p.sq) % p.h);
    const int bi = (int)(row / ((long long)p.sq * p.h));
    const T* o = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh + qi * p.o_ss + c;
    const T* g = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh + qi * p.do_ss + c;
    acc = dot16(o, g);
#pragma unroll
    for (int i = 1; i < N; ++i) acc += dot16(o + i * L * PER, g + i * L * PER);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && c == 0) p.delta[row] = acc;
}

// P^T and dS^T of a warp's 16 keys (kw + g, kw + g + 8) against a tile's
// queries q0 + column, in place of S^T and dP^T: lse and D of the columns in
// shared memory; MASK where the tile crosses the causal diagonal or an edge.
template <bool MASK, int NQ>
__device__ __forceinline__ void dkdv_probs(float (&s)[NQ][4], float (&dp)[NQ][4],
                                           const float* lse, const float* del, float sl, int kw,
                                           int q0, int off, const BwdParams& p, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NQ; ++n) {
    const int col = n * 8 + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(lse + col);
    const float2 d = *reinterpret_cast<const float2*>(del + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = fast_exp2(fmaf(s[n][e], sl, -(e & 1 ? l.y : l.x) * kLog2e));
      float keep = pr;
      if (MASK) {
        const int key = kw + g + (e >> 1) * 8;
        const int q = q0 + col + (e & 1);
        keep = key < p.skv && q < p.sq && (!p.causal || key <= q + off) ? pr : 0.f;
      }
      s[n][e] = keep;                                 // P^T (rounded to T on its way into dV)
      dp[n][e] = keep * (dp[n][e] - (e & 1 ? d.y : d.x));  // dS^T
    }
  }
}

// dS of a warp's 16 query rows (qw + g, qw + g + 8; lse in the log2 domain
// and D of each in registers) against a tile's keys k0 + column, in place
// of dP; MASK as above.
template <bool MASK, int NK>
__device__ __forceinline__ void dq_grads(const float (&s)[NK][4], float (&dp)[NK][4],
                                         const float (&lse2)[2], const float (&del)[2], float sl,
                                         int k0, int qw, int off, const BwdParams& p, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = fast_exp2(fmaf(s[n][e], sl, -lse2[e >> 1]));
      if (MASK) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = qw + g + (e >> 1) * 8;
        pr = key < p.skv && row < p.sq && (!p.causal || key <= row + off) ? pr : 0.f;
      }
      dp[n][e] = pr * (dp[n][e] - del[e >> 1]);  // dS
    }
}

// The streamed tiles' rows and the rings' stages at d 160, fp32 and bf16
// (the header's note on d 160); the other head dims take the forward's tile
// and `ring_stages`.
constexpr int kF32Rows160 = 16;
constexpr int kF32Stages160 = 1;
constexpr int kBf16Rows160 = 32;
constexpr int kBf16Stages160 = 2;

template <typename T, int D>
__host__ __device__ constexpr int bwd_rows() {
  return D != 160 ? tile_rows<D>() : kBf16<T> ? kBf16Rows160 : kF32Rows160;
}

template <typename T, int D>
__host__ __device__ constexpr int bwd_stages() {
  return D != 160 ? ring_stages<T, D>() : kBf16<T> ? kBf16Stages160 : kF32Stages160;
}

template <typename T, int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  constexpr int BQ = bwd_rows<T, D>();
  constexpr int ST = bwd_stages<T, D>();
  return (2 * kRows + ST * 2 * BQ) * pitch<T, D>() * (int)sizeof(T) +
         ST * 2 * BQ * (int)sizeof(float);
}

// (b) dK, dV of one 64-key tile of one KV head, over one split of its group.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) bwd_dkdv_kernel(BwdParams p) {
  constexpr int LD = pitch<T, D>();
  constexpr int BQ = bwd_rows<T, D>();
  constexpr int NQ = BQ / 8;  // n-tiles of S^T (8 queries each)
  constexpr int ST = bwd_stages<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kRows * LD;
  T* ring = Vs + kRows * LD;  // ST stages of (Q, dO), BQ rows each
  float* stats = reinterpret_cast<float*>(ring + ST * 2 * BQ * LD);  // ST of (lse, D)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kRows;  // tile 0 first: the most query tiles when causal
  const int hk = blockIdx.y / p.splits;
  const int sp = blockIdx.y % p.splits;
  const int bi = blockIdx.z;
  const int heads = p.h / p.hkv / p.splits;  // query heads of this split
  const int h0 = hk * (p.h / p.hkv) + sp * heads;
  // Causal: query tiles from the one holding the first row that sees key k0
  // (row k0 - off); none where that row is past the last.
  const int off = p.causal && p.q_offset ? p.q_offset[bi] : 0;
  const int qt0 = p.causal ? max(0, k0 - off) / BQ : 0;
  const int nqt = p.causal && k0 - off >= p.sq ? 0 : (p.sq + BQ - 1) / BQ - qt0;
  const int items = nqt > 0 ? heads * nqt : 0;  // (head, query tile) pairs
  const float sl = p.scale * kLog2e;

  if (items > 0) {  // a tile no query sees reads nothing and writes zeros
    stage_rows<T, D, kRows, kThreads>(static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh,
                                      p.k_ss, k0, p.skv, Ks, threadIdx.x);
    stage_rows<T, D, kRows, kThreads>(static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh,
                                      p.v_ss, k0, p.skv, Vs, threadIdx.x);
  }
  // Item i (head h0 + i / nqt, query tile qt0 + i % nqt) into stage i % ST,
  // with its rows' lse and D (zeros past sq, where the mask holds).
  auto issue = [&](int i) {
    const int hi = h0 + i / nqt;
    const int q0 = (qt0 + i % nqt) * BQ;
    T* Qd = ring + (i % ST) * 2 * BQ * LD;
    stage_rows<T, D, BQ, kThreads>(static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh,
                                   p.q_ss, q0, p.sq, Qd, threadIdx.x);
    stage_rows<T, D, BQ, kThreads>(static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh,
                                   p.do_ss, q0, p.sq, Qd + BQ * LD, threadIdx.x);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      const long long row = ((long long)bi * p.h + hi) * p.sq + (r < p.sq ? r : 0);
      float* st = stats + (i % ST) * 2 * BQ + threadIdx.x;
      cp_async4(st, p.lse + row, r < p.sq);
      cp_async4(st + BQ, p.delta + row, r < p.sq);
    }
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < items) issue(i);
    cp_async_commit();  // K and V join the first group
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int kw = k0 + warp * 16;  // this warp's first key
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  constexpr bool KEEP = kBf16<T> && D <= 64;
  uint32_t kf[KEEP ? D / 16 : 1][4], vf[KEEP ? D / 16 : 1][4];

  for (int i = 0; i < items; ++i) {
    if (i + ST - 1 < items) issue(i + ST - 1);
    cp_async_commit();        // possibly empty: the group count stays uniform
    cp_async_wait<ST - 1>();  // item i has landed for this thread...
    __syncthreads();          // ...and for the block
    const int q0 = (qt0 + i % nqt) * BQ;
    const T* Qt = ring + (i % ST) * 2 * BQ * LD;
    const T* Gt = Qt + BQ * LD;
    const float* lse = stats + (i % ST) * 2 * BQ;
    const float* del = lse + BQ;
    if (KEEP && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (KEEP ? D / 16 : 0); ++kk) {
        ldmatrix_x4(kf[kk], Kw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(vf[kk], Vw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    // Causal: nothing to do when every query of the tile precedes every key.
    if (!p.causal || q0 + BQ - 1 + off >= kw) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      warp_scores<T, D, NQ>(s, Kw, Qt, lane, KEEP ? kf : nullptr);   // S^T: keys x queries
      warp_scores<T, D, NQ>(dp, Vw, Gt, lane, KEEP ? vf : nullptr);  // dP^T
      // The mask only where the tile crosses the diagonal or an edge.
      if (q0 + BQ <= p.sq && kw + 16 <= p.skv && (!p.causal || q0 + off >= kw + 15))
        dkdv_probs<false, NQ>(s, dp, lse, del, sl, kw, q0, off, p, lane);
      else
        dkdv_probs<true, NQ>(s, dp, lse, del, sl, kw, q0, off, p, lane);
      warp_accumulate<T, D, NQ>(dv, s, Gt, lane);   // dV += P^T dO
      warp_accumulate<T, D, NQ>(dk, dp, Qt, lane);  // dK += dS^T Q
    }
    __syncthreads();  // the block is done with this stage before it is refilled
  }
  cp_async_commit();
  cp_async_wait<0>();

  if (p.splits == 1) {
    store_rows<T, D>(static_cast<T*>(p.dk) + bi * p.dk_sb + hk * p.dk_sh, p.dk_ss, kw, p.skv, dk,
                     p.scale, lane);
    store_rows<T, D>(static_cast<T*>(p.dv) + bi * p.dv_sb + hk * p.dv_sh, p.dv_ss, kw, p.skv, dv,
                     1.f, lane);
  } else {
    const long long slab = (long long)p.skv * D;  // one (b, hkv, split)'s partial
    const long long half = (long long)p.b * p.hkv * p.splits * slab;
    float* pk = p.part + (((long long)bi * p.hkv + hk) * p.splits + sp) * slab;
    store_rows<float, D>(pk, D, kw, p.skv, dk, 1.f, lane);
    store_rows<float, D>(pk + half, D, kw, p.skv, dv, 1.f, lane);
  }
}

// (b') dK and dV from the splits' partials: each sum in split order, dK times
// the scale, rounded once. A thread takes 4 values.
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_sum_kernel(BwdParams p) {
  const long long quads = (long long)p.b * p.hkv * p.skv * (D / 4);
  long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= 2 * quads) return;
  const bool is_dv = idx >= quads;
  if (is_dv) idx -= quads;
  const int c = (int)(idx % (D / 4)) * 4;
  const long long r = idx / (D / 4);
  const int key = (int)(r % p.skv);
  const int hk = (int)((r / p.skv) % p.hkv);
  const int bi = (int)(r / ((long long)p.skv * p.hkv));
  const long long slab = (long long)p.skv * D;
  const float* src = p.part + (is_dv ? (long long)p.b * p.hkv * p.splits * slab : 0) +
                     ((long long)bi * p.hkv + hk) * p.splits * slab + (long long)key * D + c;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < p.splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(src + sp * slab);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float mul = is_dv ? 1.f : p.scale;
  T* out = is_dv ? static_cast<T*>(p.dv) + bi * p.dv_sb + hk * p.dv_sh + key * p.dv_ss
                 : static_cast<T*>(p.dk) + bi * p.dk_sb + hk * p.dk_sh + key * p.dk_ss;
  store2(out + c, acc.x * mul, acc.y * mul);
  store2(out + c + 2, acc.z * mul, acc.w * mul);
}

template <typename T, int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (2 * kRows + bwd_stages<T, D>() * 2 * bwd_rows<T, D>()) * pitch<T, D>() * (int)sizeof(T);
}

// (c) dQ of one 64-row tile of one query head. Three bf16 blocks an SM up to
// d 128; at d 160 two fit its shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBf16<T> && D <= 128 ? 3 : 2)
    bwd_dq_kernel(BwdParams p) {
  constexpr int LD = pitch<T, D>();
  constexpr int BN = bwd_rows<T, D>();
  constexpr int NK = BN / 8;  // n-tiles of S (8 keys each)
  constexpr int ST = bwd_stages<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Gs = Qs + kRows * LD;    // dO
  T* ring = Gs + kRows * LD;  // ST stages of (K, V), BN rows each

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest causal rows first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const float sl = p.scale * kLog2e;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  stage_rows<T, D, kRows, kThreads>(static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh,
                                    p.q_ss, q0, p.sq, Qs, threadIdx.x);
  stage_rows<T, D, kRows, kThreads>(static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh,
                                    p.do_ss, q0, p.sq, Gs, threadIdx.x);
  // One past the last key any row of this tile may see.
  const int off = p.causal && p.q_offset ? p.q_offset[bi] : 0;
  const int kv_hi = p.causal ? max(0, min(p.skv, min(q0 + kRows, p.sq) + off)) : p.skv;
  const int tiles = (kv_hi + BN - 1) / BN;
  auto issue = [&](int i) {
    T* Kd = ring + (i % ST) * 2 * BN * LD;
    stage_rows<T, D, BN, kThreads>(kb, p.k_ss, i * BN, p.skv, Kd, threadIdx.x);
    stage_rows<T, D, BN, kThreads>(vb, p.v_ss, i * BN, p.skv, Kd + BN * LD, threadIdx.x);
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < tiles) issue(i);
    cp_async_commit();  // Q and dO join the first group
  }

  // This lane's two rows: qw + g and qw + g + 8.
  const int qw = q0 + warp * 16;
  float lse2[2], del[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = qw + g + 8 * half;
    const long long row = ((long long)bi * p.h + hi) * p.sq + r;
    lse2[half] = r < p.sq ? p.lse[row] * kLog2e : INFINITY;
    del[half] = r < p.sq ? p.delta[row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const T* Qw = Qs + warp * 16 * LD;
  const T* Gw = Gs + warp * 16 * LD;
  constexpr bool KEEP = kBf16<T> && D <= 64;
  uint32_t qf[KEEP ? D / 16 : 1][4], gf[KEEP ? D / 16 : 1][4];

  for (int i = 0; i < tiles; ++i) {
    if (i + ST - 1 < tiles) issue(i + ST - 1);
    cp_async_commit();
    cp_async_wait<ST - 1>();
    __syncthreads();
    const int k0 = i * BN;
    const T* Kt = ring + (i % ST) * 2 * BN * LD;
    const T* Vt = Kt + BN * LD;
    if (KEEP && i == 0) {
#pragma unroll
      for (int kk = 0; kk < (KEEP ? D / 16 : 0); ++kk) {
        ldmatrix_x4(qf[kk], Qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(gf[kk], Gw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      }
    }
    // Causal: nothing to do when every key of the tile follows every row.
    if (!p.causal || k0 <= qw + 15 + off) {
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      warp_scores<T, D, NK>(s, Qw, Kt, lane, KEEP ? qf : nullptr);   // S: queries x keys
      warp_scores<T, D, NK>(dp, Gw, Vt, lane, KEEP ? gf : nullptr);  // dP
      if (k0 + BN <= p.skv && qw + 16 <= p.sq && (!p.causal || k0 + BN - 1 <= qw + off))
        dq_grads<false, NK>(s, dp, lse2, del, sl, k0, qw, off, p, lane);
      else
        dq_grads<true, NK>(s, dp, lse2, del, sl, k0, qw, off, p, lane);
      warp_accumulate<T, D, NK>(dq, dp, Kt, lane);  // dQ += dS K
    }
    __syncthreads();
  }
  cp_async_commit();
  cp_async_wait<0>();
  store_rows<T, D>(static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh, p.dq_ss, qw, p.sq, dq,
                   p.scale, lane);
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.b * p.h * p.sq;
  const long long delta_blocks = (rows * delta_lanes<T, D>() + 255) / 256;
  if (delta_blocks > 2147483647LL) return cudaErrorInvalidValue;
  bwd_delta_kernel<T, D><<<(unsigned)delta_blocks, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_kv = dkdv_smem_bytes<T, D>();
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, D><<<dim3((p.skv + kRows - 1) / kRows, p.hkv * p.splits, p.b), kThreads,
                          smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (p.splits > 1) {
    const long long quads = 2LL * p.b * p.hkv * p.skv * (D / 4);
    if ((quads + 255) / 256 > 2147483647LL) return cudaErrorInvalidValue;
    bwd_sum_kernel<T, D><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  constexpr int smem_q = dq_smem_bytes<T, D>();
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<dim3((p.sq + kRows - 1) / kRows, p.h, p.b), kThreads, smem_q, stream>>>(
      p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int d, cudaStream_t stream) {
  if (d == 16) return launch<T, 16>(p, stream);
  if (d == 64) return launch<T, 64>(p, stream);
  if (d == 128) return launch<T, 128>(p, stream);
  if (d == 160) return launch<T, 160>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq: (b, h, sq, d); k, v, dk, dv: (b, hkv, skv, d); strides in
// elements, last dim contiguous, every row 16-byte aligned. lse (the forward's)
// and delta (scratch) are fp32 (b, h, sq), contiguous. `splits` divides the
// group h / hkv; when it is above 1, `part` is fp32 scratch of 2 b hkv splits
// skv d values (16-byte aligned), else it may be null. dtype: 0 = float32, 1 =
// bfloat16. d: 16, 64, 128 or 160 (zamba2's shared block; its own tiles, see
// the note at the top). q_offset: int32 (b,) on the device or null, as the
// forward's (causal only). Three launches on `stream`, four when splits > 1;
// returns the CUDA error code of the first that failed (0 on success).
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, const void* q_offset, void* delta, void* part, void* dq, void* dk,
    void* dv, int b, int h,
    int hkv, int sq, int skv, int d, int splits, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss, long long do_sb,
    long long do_sh, long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0 || h > 65535 ||
      b > 65535 || hkv > 65535 || splits <= 0 || (h / hkv) % splits != 0 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.part = static_cast<float*>(part);
  p.q_offset = static_cast<const int*>(q_offset);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.b = b; p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv; p.splits = splits;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.dq_sb = dq_sb; p.dq_sh = dq_sh; p.dq_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(p, d, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(p, d, s);
  return (int)cudaErrorInvalidValue;
}
