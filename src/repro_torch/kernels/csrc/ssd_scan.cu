// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (`_ssd_kernel`, called
// from `ssd_scan`). Per chunk of Q positions, with dA = dt * A (A < 0, dt >= 0)
// and cs its inclusive cumsum inside the chunk:
//
//   y_i = sum_{j <= i} exp(cs_i - cs_j) (C_i . B_j) dt_j x_j  +  exp(cs_i) C_i S_in^T
//   S  <- S exp(cs_last) + sum_j (dt_j exp(cs_last - cs_j) x_j)^T B_j
//
// in fp32 from inputs of the caller's type, y rounded to that type, the final
// state S (p x n per head) in fp32. Positions past `s` act as dt = 0.
//
// What changed against the TPU kernel, and why:
//  * The TPU grid runs (b, h, chunk) in order and carries S in VMEM scratch.
//    Blocks on this card run in no order and a card needs hundreds of them, so
//    the scan is split over the chunks into four kernels that run one after
//    another on the stream, through fp32 scratch in device memory that the
//    wrapper allocates (no atomics: every value is written by one thread, so
//    the result does not depend on the order blocks run in):
//      1. `scores`: G = C B^T once per (batch, group, chunk), in 64 x 64 tiles
//         on and below the diagonal. Every head of a group reads the same G;
//         a head never recomputes it.
//      2. `states`: one block per (batch, head, chunk, 64 columns of p): the
//         chunk's cumsum by a block scan, written out, and the chunk's own
//         state (x * dt exp(cs_last - cs))^T B, a p x n tile, 64 positions
//         at a time through a 2-stage ring.
//      3. `pass`: one thread per (batch, head, state entry) walks the chunks
//         in order: S_in[c] = S, S = S exp(cs_last[c]) + S_c. It is the only
//         sequential part and touches each state entry once a chunk. S starts
//         from the caller's initial state (b, h, p, n) fp32, or from zero:
//         a rank's block of a sequence split over ranks starts from the
//         state the earlier blocks leave. The training forward keeps S_in,
//         so chunk 0's incoming state is the initial state.
//      4. `outputs`: one block per (batch, head, chunk, 64 rows, 64 columns of
//         p): exp(cs_i) C_i . S_in^T, then the in-chunk term over the key
//         tiles j <= i only (x and G through a 2-stage ring), the scores
//         G o exp(cs_i - cs_j) o dt_j built in registers, never written out.
//         The longest row tiles start first.
//  * The TPU kernel takes exp over the whole Q x Q square and masks it after.
//    Here exp(cs_i - cs_j) is taken only for j <= i, where the exponent is <= 0
//    (A < 0, dt >= 0), so no exp overflows and no inf * 0 makes a NaN.
//  * Layout is the model's: x (b, s, h, p), dt (b, s, h), B and C (b, s, g, n)
//    taken by strides, so the model hands over views of its conv output. A head
//    reads its group's B and C and G by index (`h / (h / g)`), never by a repeat.
//
// Arithmetic by input type:
//  * bf16: the three products (C B^T, X^T B, scores x X and C S^T) run on the
//    tensor cores, `mma.sync.m16n8k16` (bf16 in, fp32 accumulators) fed by
//    `ldmatrix` from shared memory, rows staged by 16-byte `cp.async`. C, B and
//    x are bf16 already and go in exactly. An operand computed in fp32 (the
//    decayed scores, x * dt exp(cs_last - cs), S_in) goes in as two bf16 parts,
//    hi = bf16(v) and lo = bf16(v - hi), over two products: about 16 bits of
//    it survive, where one rounding (8 bits) would spend most of the bf16
//    tolerance on the largest outputs.
//  * fp32: every product on fp32 FMAs from shared memory; TF32 would not keep
//    the fp32 tolerance.
//
// Bound: at the main prefill (b 1, s 1024, h 48, p 64, n 128, Q 256) the bytes
// (x, y, B, C, dt once and the state) take ~4.4 us at 3.35 TB/s and the
// operations (2.45 GFLOP) ~2.5 us at the bf16 tensor-core rate, so the card's
// bound is bytes; in fp32 it is the operations (~37 us at 67 TFLOP/s). The
// scratch (1 MB of G, 6.3 MB of states, 0.2 MB of cumsums) stays in the 50 MB
// L2 between the kernels. What holds the design back: four launches in a row,
// each with its ramp and tail, and the outputs kernel, which reads C, S_in
// and the G tiles anew for every (row tile, head), ~84 MB from L2 at the main
// prefill; sharing G and C across the heads of a group and S_in across row
// tiles would cut that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kTile = 64;       // rows i, keys j of a score tile; p columns a block
constexpr int kMaxChunk = 1024;
constexpr int kMmaThreads = 128;   // stages 1 and 4 (bf16): 4 warps, 16 rows each
constexpr int kWideThreads = 256;  // stage 2 (bf16): 8 warps
constexpr int kF32Threads = 256;  // 16 x 16 threads, a 4 x 4 patch each
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;   // (b, h, p, n)
  const float* init;  // (b, h, p, n) or null: the scan starts from zero
  float* G;       // (b, g, nc, qp, qp)
  float* cs;      // (b, h, nc, qp)
  float* S;       // (b, h, nc, p, n): chunk states, then incoming states
  int b, s, h, p, g, n, Q;
  int nc, qp, tiles;  // chunks; Q rounded up to kTile; qp / kTile
  long long x_sb, x_ss, x_sh;  // strides in elements; the last dim has stride 1
  long long dt_sb, dt_ss, dt_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long y_sb, y_ss, y_sh;
};

// Positions of chunk c inside the sequence.
__device__ __forceinline__ int chunk_len(const Params& p, int c) {
  return min(p.Q, p.s - c * p.Q);
}

// Rows [0, 64) of a bf16 slab of W columns (row stride `ss`) into shared
// memory with pitch W + 8, by cp.async from NT threads; rows at or beyond
// `rows` and 8-column packs at or beyond `cols` become zeros. The caller
// commits and waits.
template <int W, int NT>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* base, long long ss, int rows,
                                           int cols, __nv_bfloat16* dst) {
  constexpr int CH = W / 8;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    const bool in = r < rows && c < cols;
    cp_async16(dst + r * (W + 8) + c, in ? base + (long long)r * ss + c : base, in);
  }
}

// The same for an fp32 slab of W columns, pitch W + 8 (row r's float2 at
// column 2t then sits on its own banks for the rows of a half warp).
template <int W, int NT>
__device__ __forceinline__ void stage_f32(const float* base, long long ss, int rows, int cols,
                                          float* dst) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    const bool in = r < rows && c < cols;
    cp_async16(dst + r * (W + 8) + c, in ? base + (long long)r * ss + c : base, in);
  }
}

// Rows [0, 64) of an fp32 slab of W columns into shared memory with pitch
// W + 4, row r times scale[r] if `scale` is given; rows at or beyond `rows`
// and 4-column packs at or beyond `cols` become zeros.
template <int W, int NT>
__device__ __forceinline__ void load_f32(const float* base, long long ss, int rows, int cols,
                                         const float* scale, float* dst) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < cols) {
      v = *reinterpret_cast<const float4*>(base + (long long)r * ss + c);
      if (scale) {
        const float f = scale[r];
        v.x *= f; v.y *= f; v.z *= f; v.w *= f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * (W + 4) + c) = v;
  }
}

// dt of the chunk's Q positions (0 past the valid `qv`) into dt_s, and the
// inclusive cumsum of dt * a into cs_s, by a block scan of NT threads (warp
// shuffles, then the warps' sums). `red` holds NT / 32 floats. Ends with a
// barrier.
template <int NT>
__device__ __forceinline__ void chunk_cumsum(const float* dtb, long long dt_ss, int Q, int qv,
                                             float a, float* dt_s, float* cs_s, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int NWARP = NT / 32;
  float carry = 0.f;
  for (int seg = 0; seg < Q; seg += NT) {
    const int i = seg + threadIdx.x;
    const float d = i < qv ? dtb[(long long)i * dt_ss] : 0.f;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float w = lane < NWARP ? red[lane] : 0.f;
#pragma unroll
      for (int off = 1; off < NWARP; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += t;
      }
      if (lane < NWARP) red[lane] = w;
    }
    __syncthreads();
    if (i < Q) {
      dt_s[i] = d;
      cs_s[i] = carry + (warp > 0 ? red[warp - 1] : 0.f) + v;
    }
    carry += red[NWARP - 1];
    __syncthreads();  // `red` is rewritten by the next segment
  }
}

// The start of a stage-2 block (both types): the chunk's dt and cumsum into
// shared memory, the cumsum out to `cs` (p-tile 0 only; past the chunk's
// last position it holds that position's value), then dt_s[j] becomes the
// weight dt_j exp(cs_last - cs_j). Ends with a barrier.
template <int NT>
__device__ __forceinline__ void chunk_weights(const Params& p, int bi, int hi, int c, int pt,
                                              float* dt_s, float* cs_s, float* red) {
  const int qv = chunk_len(p, c);
  const float* dtb = p.dt + bi * p.dt_sb + hi * p.dt_sh + (long long)c * p.Q * p.dt_ss;
  chunk_cumsum<NT>(dtb, p.dt_ss, p.Q, qv, p.A[hi], dt_s, cs_s, red);
  const float cs_last = cs_s[qv - 1];  // positions past qv add dA = 0
  if (pt == 0) {
    float* csg = p.cs + ((long long)(bi * p.h + hi) * p.nc + c) * p.qp;
    for (int i = threadIdx.x; i < p.qp; i += NT) csg[i] = i < p.Q ? cs_s[i] : cs_last;
  }
  for (int i = threadIdx.x; i < qv; i += NT) dt_s[i] *= expf(cs_last - cs_s[i]);
  __syncthreads();
}

// ------------------------------------------------------------------------- //
// bf16: the tensor-core kernels. A warp owns 16 rows of a 64-row output tile
// (4 warps a block; stage 2 has 8, two over its n columns). Fragment layout of an mma: this lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8, and of each 8-column n-tile the
// columns 2t and 2t + 1.
// ------------------------------------------------------------------------- //

// Stage 1. Grid (nc * b * g, tiles * (tiles + 1) / 2): tile (ti, tj), tj <= ti,
// of G for one (batch, group, chunk): C rows i as the A operand, B rows j as
// the (column-major) B operand, both [position][n] in shared memory.
template <int N>
__global__ void __launch_bounds__(kMmaThreads) scores_mma_kernel(Params p) {
  constexpr int LD = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = Cs + kTile * LD;

  const int c = blockIdx.x % p.nc;
  const int bg = blockIdx.x / p.nc;
  const int bi = bg / p.g, gi = bg % p.g;
  int ti = 0, tj = blockIdx.y;
  while (tj > ti) tj -= ++ti;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int qv = chunk_len(p, c);
  const long long t0 = (long long)c * p.Q;
  const __nv_bfloat16* Cb = static_cast<const __nv_bfloat16*>(p.C) + bi * p.C_sb + gi * p.C_sg;
  const __nv_bfloat16* Bb = static_cast<const __nv_bfloat16*>(p.B) + bi * p.B_sb + gi * p.B_sg;
  stage_bf16<N, kMmaThreads>(Cb + (t0 + i0) * p.C_ss, p.C_ss, qv - i0, N, Cs);
  stage_bf16<N, kMmaThreads>(Bb + (t0 + j0) * p.B_ss, p.B_ss, qv - j0, N, Bs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float acc[kTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, Cs + (16 * w + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kTile / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, Bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
  float* Gt = p.G + ((long long)blockIdx.x * p.qp + i0 + 16 * w + (lane >> 2)) * p.qp + j0 +
              2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    *reinterpret_cast<float2*>(Gt + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(Gt + 8LL * p.qp + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Stage 2. Grid (nc * b * h, ceil(p / 64)): the chunk state of 64 columns of
// p, S_c[pp][nn] = sum_j x_j[pp] w_j B_j[nn] with w_j = dt_j exp(cs_last -
// cs_j): (x o w) as the A operand (transposed: stored [j][pp]), in hi and lo
// parts, B as the B operand ([j][nn], transposed). 8 warps: warp w owns p
// rows 16 (w % 4) and half (w / 4) of the n columns (all of them at n = 16).
// Positions come 64 at a time through a 2-stage ring, B by cp.async and x
// through registers (weighted, split, stored), the next tile's loads in
// flight while this one computes; the first tile's loads are issued before
// the block scan.
template <int N>
__global__ void __launch_bounds__(kWideThreads) states_mma_kernel(Params p) {
  constexpr int LDB = N + 8;
  constexpr int LDX = kTile + 8;
  constexpr int NSPLIT = N >= 32 ? 2 : 1;  // warps over the n columns
  constexpr int NW = N / NSPLIT;           // n columns a warp
  constexpr int XCH = kTile * (kTile / 8) / kWideThreads;  // x packs a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 stages
  __nv_bfloat16* Xh = Bs + 2 * kTile * LDB;                     // 2 stages
  __nv_bfloat16* Xl = Xh + 2 * kTile * LDX;                     // 2 stages
  float* red = reinterpret_cast<float*>(Xl + 2 * kTile * LDX);
  float* dt_s = red + kWideThreads / 32;
  float* cs_s = dt_s + p.Q;

  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int pt = blockIdx.y, p0 = pt * kTile;
  const int pv = p.p - p0;
  const int qv = chunk_len(p, c);
  const int ntiles = (qv + kTile - 1) / kTile;
  const long long t0 = (long long)c * p.Q;
  const __nv_bfloat16* xb =
      static_cast<const __nv_bfloat16*>(p.x) + bi * p.x_sb + hi * p.x_sh + p0 + t0 * p.x_ss;
  const __nv_bfloat16* Bb =
      static_cast<const __nv_bfloat16*>(p.B) + bi * p.B_sb + gi * p.B_sg + t0 * p.B_ss;

  auto stage_b = [&](int jt) {
    stage_bf16<N, kWideThreads>(Bb + (long long)jt * kTile * p.B_ss, p.B_ss, qv - jt * kTile,
                                N, Bs + (jt & 1) * kTile * LDB);
    cp_async_commit();
  };
  auto load_x = [&](int jt, uint4 (&raw)[XCH]) {
#pragma unroll
    for (int u = 0; u < XCH; ++u) {
      const int idx = threadIdx.x + u * kWideThreads;
      const int r = jt * kTile + (idx >> 3), cc = (idx & 7) * 8;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (r < qv && cc < pv)
        raw[u] = *reinterpret_cast<const uint4*>(xb + (long long)r * p.x_ss + cc);
    }
  };
  auto store_x = [&](int jt, const uint4 (&raw)[XCH]) {
#pragma unroll
    for (int u = 0; u < XCH; ++u) {
      const int idx = threadIdx.x + u * kWideThreads;
      const int r = idx >> 3, cc = (idx & 7) * 8;
      const float f = jt * kTile + r < qv ? dt_s[jt * kTile + r] : 0.f;
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw[u]);
      uint4 hv, lv;
      uint32_t* hh = reinterpret_cast<uint32_t*>(&hv);
      uint32_t* ll = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(v2[e]);
        split_bf16(v.x * f, v.y * f, hh[e], ll[e]);
      }
      const int o = (jt & 1) * kTile * LDX + r * LDX + cc;
      *reinterpret_cast<uint4*>(Xh + o) = hv;
      *reinterpret_cast<uint4*>(Xl + o) = lv;
    }
  };

  uint4 raw[XCH];
  stage_b(0);
  load_x(0, raw);
  chunk_weights<kWideThreads>(p, bi, hi, c, pt, dt_s, cs_s, red);

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rw = 16 * (w & 3), nb = (w >> 2) * NW;
  const bool busy = rw < pv && (w >> 2) < NSPLIT;  // other warps only stage tiles
  float acc[NW / 8][4];
#pragma unroll
  for (int nt = 0; nt < NW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int jt = 0; jt < ntiles; ++jt) {
    store_x(jt, raw);
    if (jt + 1 < ntiles) {
      stage_b(jt + 1);
      load_x(jt + 1, raw);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (busy) {
      const __nv_bfloat16* xh = Xh + (jt & 1) * kTile * LDX;
      const __nv_bfloat16* xl = Xl + (jt & 1) * kTile * LDX;
      const __nv_bfloat16* bs = Bs + (jt & 1) * kTile * LDB;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t ah[4], al[4];
        const int xo = (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDX + rw +
                       ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(ah, xh + xo);
        ldmatrix_x4_trans(al, xl + xo);
#pragma unroll
        for (int np = 0; np < NW / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + nb +
                                   np * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * np], ah, b[0], b[1]);
          mma_bf16(acc[2 * np], al, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
          mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  if (!busy) return;
  const int r0 = rw + (lane >> 2);
  float* Sb = p.S + ((long long)blockIdx.x * p.p + p0 + r0) * N + nb + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NW / 8; ++nt) {
    if (r0 < pv) *reinterpret_cast<float2*>(Sb + nt * 8) = make_float2(acc[nt][0], acc[nt][1]);
    if (r0 + 8 < pv)
      *reinterpret_cast<float2*>(Sb + 8 * N + nt * 8) = make_float2(acc[nt][2], acc[nt][3]);
  }
}

// Stage 4. Grid (nc * b * h, ceil(p / 64), tiles): rows [i0, i0 + 64) of one
// (batch, head, chunk) and 64 columns of p, the last row tile first.
// Off-diagonal: C rows (A operand) against S_in (B operand, its fp32 [pp][nn]
// fragments split into hi and lo in registers), each row scaled by exp(cs_i)
// after. Diagonal: for each key tile j0 <= i0, the scores G o exp(cs_i -
// cs_j) o dt_j are built from the G tile in registers straight into the A
// operand, in hi and lo parts, against x (B operand, [j][pp], transposed).
// Everything arrives by cp.async: C and S_in once, the x and G tiles through
// a 2-stage ring, so the next tile loads while this one computes.
template <int N>
__global__ void __launch_bounds__(kMmaThreads) outputs_mma_kernel(Params p) {
  constexpr int LDC = N + 8;      // bf16
  constexpr int LDS = N + 8;      // fp32
  constexpr int LDX = kTile + 8;  // bf16
  constexpr int LDG = kTile + 8;  // fp32
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Xs = Cs + kTile * LDC;                          // 2 stages
  float* Ss = reinterpret_cast<float*>(Xs + 2 * kTile * LDX);    // S_in [pp][nn]
  float* Gs = Ss + kTile * LDS;                                  // 2 stages
  float* cs_s = Gs + 2 * kTile * LDG;
  float* dt_s = cs_s + p.qp;

  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int p0 = blockIdx.y * kTile;
  const int pv = p.p - p0;
  const int ti = p.tiles - 1 - blockIdx.z;
  const int i0 = ti * kTile;
  const int qv = chunk_len(p, c);
  if (i0 >= qv) return;  // rows past a ragged last chunk
  const long long t0 = (long long)c * p.Q;
  const int rows_end = i0 + kTile;  // cumsums and dt needed for [0, rows_end)
  const bool carry = c > 0 || p.init;  // chunk 0's incoming state: zero but for an init

  const __nv_bfloat16* xb =
      static_cast<const __nv_bfloat16*>(p.x) + bi * p.x_sb + hi * p.x_sh + p0 + t0 * p.x_ss;
  const __nv_bfloat16* Cb =
      static_cast<const __nv_bfloat16*>(p.C) + bi * p.C_sb + gi * p.C_sg + t0 * p.C_ss;
  const float* Gb = p.G + (((long long)(bi * p.g + gi) * p.nc + c) * p.qp + i0) * p.qp;
  auto stage_tile = [&](int tj) {
    stage_bf16<kTile, kMmaThreads>(xb + (long long)tj * kTile * p.x_ss, p.x_ss,
                                   qv - tj * kTile, pv, Xs + (tj & 1) * kTile * LDX);
    stage_f32<kTile, kMmaThreads>(Gb + tj * kTile, p.qp, kTile, kTile,
                                  Gs + (tj & 1) * kTile * LDG);
    cp_async_commit();
  };
  stage_bf16<N, kMmaThreads>(Cb + i0 * p.C_ss, p.C_ss, qv - i0, N, Cs);
  if (carry)
    stage_f32<N, kMmaThreads>(p.S + ((long long)blockIdx.x * p.p + p0) * N, N, pv, N, Ss);
  stage_tile(0);
  const float* csg = p.cs + (long long)blockIdx.x * p.qp;
  const float* dtb = p.dt + bi * p.dt_sb + hi * p.dt_sh + t0 * p.dt_ss;
  for (int i = threadIdx.x; i < rows_end; i += kMmaThreads) {
    cs_s[i] = csg[i];
    dt_s[i] = i < qv ? dtb[(long long)i * p.dt_ss] : 0.f;
  }

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rw = 16 * w;
  const int r0 = i0 + rw + g8, r1 = r0 + 8;  // this lane's rows in the chunk
  float acc[kTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int tj = 0; tj <= ti; ++tj) {
    const int j0 = tj * kTile;
    if (tj < ti) {  // the next tile into the other stage
      stage_tile(tj + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (tj == 0 && carry) {
      // Off-diagonal, once: exp(cs_i) C_i . S_in^T.
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, Cs + (rw + (lane & 7) + ((lane >> 3) & 1) * 8) * LDC + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt) {
          const float* sp = Ss + (nt * 8 + g8) * LDS + kk * 16 + 2 * t4;
          const float2 s0 = *reinterpret_cast<const float2*>(sp);
          const float2 s1 = *reinterpret_cast<const float2*>(sp + 8);
          uint32_t h0, l0, h1, l1;
          split_bf16(s0.x, s0.y, h0, l0);
          split_bf16(s1.x, s1.y, h1, l1);
          mma_bf16(acc[nt], a, h0, h1);
          mma_bf16(acc[nt], a, l0, l1);
        }
      }
      const float e0 = fast_exp2(cs_s[r0] * kLog2e), e1 = fast_exp2(cs_s[r1] * kLog2e);
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }

    // Diagonal: keys [j0, j0 + 64); in the diagonal tile warp w needs only
    // the k-steps up to its own rows.
    {
      const __nv_bfloat16* Xt = Xs + (tj & 1) * kTile * LDX;
      const float* G0 = Gs + (tj & 1) * kTile * LDG + (rw + g8) * LDG + 2 * t4;
      const float* G1 = G0 + 8 * LDG;
      const float cs0 = cs_s[r0], cs1 = cs_s[r1];
      const int ksteps = tj < ti ? kTile / 16 : w + 1;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk < ksteps) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kl = kk * 16 + half * 8;  // key offset in the tile
            const int k = j0 + kl + 2 * t4;     // this lane's first key
            const float2 ga = *reinterpret_cast<const float2*>(G0 + kl);
            const float2 gb = *reinterpret_cast<const float2*>(G1 + kl);
            const float d0 = dt_s[k], d1 = dt_s[k + 1];
            const float c0 = cs_s[k], c1 = cs_s[k + 1];
            const float s00 = k <= r0 ? ga.x * fast_exp2((cs0 - c0) * kLog2e) * d0 : 0.f;
            const float s01 = k + 1 <= r0 ? ga.y * fast_exp2((cs0 - c1) * kLog2e) * d1 : 0.f;
            const float s10 = k <= r1 ? gb.x * fast_exp2((cs1 - c0) * kLog2e) * d0 : 0.f;
            const float s11 = k + 1 <= r1 ? gb.y * fast_exp2((cs1 - c1) * kLog2e) * d1 : 0.f;
            split_bf16(s00, s01, ah[2 * half], al[2 * half]);
            split_bf16(s10, s11, ah[2 * half + 1], al[2 * half + 1]);
          }
#pragma unroll
          for (int np = 0; np < kTile / 16; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, Xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                                     np * 16 + (lane >> 4) * 8);
            mma_bf16(acc[2 * np], ah, b[0], b[1]);
            mma_bf16(acc[2 * np], al, b[0], b[1]);
            mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
            mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }

  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(p.y) + bi * p.y_sb + hi * p.y_sh + p0 + 2 * t4;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    if (nt * 8 >= pv) break;
    if (r0 < qv)
      *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + r0) * p.y_ss + nt * 8) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    if (r1 < qv)
      *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + r1) * p.y_ss + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// ------------------------------------------------------------------------- //
// fp32: the same stages on the FMA pipes. A block is 16 x 16 threads (tx, ty);
// a thread owns rows ty + 16 a and columns tx + 16 b (or 4 tx + e) of a tile.
// ------------------------------------------------------------------------- //

// Stage 1, fp32; grid as `scores_mma_kernel`.
template <int N>
__global__ void __launch_bounds__(kF32Threads) scores_f32_kernel(Params p) {
  constexpr int LD = N + 4;
  extern __shared__ __align__(16) float fsmem[];
  float* Cs = fsmem;
  float* Bs = Cs + kTile * LD;

  const int c = blockIdx.x % p.nc;
  const int bg = blockIdx.x / p.nc;
  const int bi = bg / p.g, gi = bg % p.g;
  int ti = 0, tj = blockIdx.y;
  while (tj > ti) tj -= ++ti;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int qv = chunk_len(p, c);
  const long long t0 = (long long)c * p.Q;
  const float* Cb = static_cast<const float*>(p.C) + bi * p.C_sb + gi * p.C_sg;
  const float* Bb = static_cast<const float*>(p.B) + bi * p.B_sb + gi * p.B_sg;
  load_f32<N, kF32Threads>(Cb + (t0 + i0) * p.C_ss, p.C_ss, qv - i0, N, nullptr, Cs);
  load_f32<N, kF32Threads>(Bb + (t0 + j0) * p.B_ss, p.B_ss, qv - j0, N, nullptr, Bs);
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < N; d += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) cv[a] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * a) * LD + d]);
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * b) * LD + d]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sc[a][b] = fmaf(cv[a].x, bv[b].x, sc[a][b]);
        sc[a][b] = fmaf(cv[a].y, bv[b].y, sc[a][b]);
        sc[a][b] = fmaf(cv[a].z, bv[b].z, sc[a][b]);
        sc[a][b] = fmaf(cv[a].w, bv[b].w, sc[a][b]);
      }
  }
  float* Gt = p.G + ((long long)blockIdx.x * p.qp + i0 + ty) * p.qp + j0 + tx;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) Gt[16LL * a * p.qp + 16 * b] = sc[a][b];
}

// Stage 2, fp32; grid as `states_mma_kernel`. A thread owns p columns
// p0 + 4 ty + e and state rows tx + 16 k.
template <int N>
__global__ void __launch_bounds__(kF32Threads) states_f32_kernel(Params p) {
  constexpr int LDB = N + 4;
  constexpr int LDX = kTile + 4;
  constexpr int NK = N / 16;
  extern __shared__ __align__(16) float fsmem[];
  float* Bs = fsmem;
  float* Xs = Bs + kTile * LDB;
  float* red = Xs + kTile * LDX;
  float* dt_s = red + kF32Threads / 32;
  float* cs_s = dt_s + p.Q;

  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int pt = blockIdx.y, p0 = pt * kTile;
  const int pv = p.p - p0;
  const int qv = chunk_len(p, c);
  const long long t0 = (long long)c * p.Q;
  chunk_weights<kF32Threads>(p, bi, hi, c, pt, dt_s, cs_s, red);

  const float* xb = static_cast<const float*>(p.x) + bi * p.x_sb + hi * p.x_sh + p0 + t0 * p.x_ss;
  const float* Bb = static_cast<const float*>(p.B) + bi * p.B_sb + gi * p.B_sg + t0 * p.B_ss;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sacc[4][NK];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k < NK; ++k) sacc[e][k] = 0.f;
  for (int j0 = 0; j0 < qv; j0 += kTile) {
    if (j0 > 0) __syncthreads();
    const int rows = qv - j0;
    load_f32<N, kF32Threads>(Bb + j0 * p.B_ss, p.B_ss, rows, N, nullptr, Bs);
    load_f32<kTile, kF32Threads>(xb + j0 * p.x_ss, p.x_ss, rows, pv, dt_s + j0, Xs);
    __syncthreads();
    const int kv = min(kTile, rows);
#pragma unroll 4
    for (int j = 0; j < kv; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * LDX + 4 * ty]);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float bv = Bs[j * LDB + tx + 16 * k];
        sacc[0][k] = fmaf(xv.x, bv, sacc[0][k]);
        sacc[1][k] = fmaf(xv.y, bv, sacc[1][k]);
        sacc[2][k] = fmaf(xv.z, bv, sacc[2][k]);
        sacc[3][k] = fmaf(xv.w, bv, sacc[3][k]);
      }
    }
  }
  float* Sb = p.S + ((long long)blockIdx.x * p.p + p0 + 4 * ty) * N + tx;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (4 * ty + e >= pv) break;
#pragma unroll
    for (int k = 0; k < NK; ++k) Sb[e * N + 16 * k] = sacc[e][k];
  }
}

// Stage 4, fp32; grid as `outputs_mma_kernel`. A thread owns rows ty + 16 a
// and p columns 4 tx + e. S_in is held transposed (St[nn][pp]); the decayed
// scores of a key tile go through shared memory (Ps).
template <int N>
__global__ void __launch_bounds__(kF32Threads) outputs_f32_kernel(Params p) {
  constexpr int LDC = N + 4;
  constexpr int LDX = kTile + 4;
  extern __shared__ __align__(16) float fsmem[];
  float* Cs = fsmem;              // kTile x LDC
  float* St = Cs + kTile * LDC;   // N x LDX
  float* Xs = St + N * LDX;       // kTile x LDX
  float* Ps = Xs + kTile * LDX;   // kTile x LDX
  float* cs_s = Ps + kTile * LDX;
  float* dt_s = cs_s + p.qp;

  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int p0 = blockIdx.y * kTile;
  const int pv = p.p - p0;
  const int ti = p.tiles - 1 - blockIdx.z;
  const int i0 = ti * kTile;
  const int qv = chunk_len(p, c);
  if (i0 >= qv) return;
  const long long t0 = (long long)c * p.Q;
  const int rows_end = i0 + kTile;

  const float* xb = static_cast<const float*>(p.x) + bi * p.x_sb + hi * p.x_sh + p0 + t0 * p.x_ss;
  const float* Cb = static_cast<const float*>(p.C) + bi * p.C_sb + gi * p.C_sg + t0 * p.C_ss;
  load_f32<N, kF32Threads>(Cb + i0 * p.C_ss, p.C_ss, qv - i0, N, nullptr, Cs);
  const float* csg = p.cs + (long long)blockIdx.x * p.qp;
  const float* dtb = p.dt + bi * p.dt_sb + hi * p.dt_sh + t0 * p.dt_ss;
  for (int i = threadIdx.x; i < rows_end; i += kF32Threads) {
    cs_s[i] = csg[i];
    dt_s[i] = i < qv ? dtb[(long long)i * p.dt_ss] : 0.f;
  }
  const bool carry = c > 0 || p.init;  // as the bf16 kernel's
  if (carry) {
    const float* Sb = p.S + ((long long)blockIdx.x * p.p + p0) * N;
    for (int idx = threadIdx.x; idx < kTile * N; idx += kF32Threads) {
      const int pp = idx / N, nn = idx % N;
      St[nn * LDX + pp] = pp < pv ? Sb[(long long)pp * N + nn] : 0.f;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  if (carry) {
#pragma unroll 2
    for (int nn = 0; nn < N; nn += 4) {
      float4 cv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * a) * LDC + nn]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 sv = *reinterpret_cast<const float4*>(&St[(nn + cc) * LDX + 4 * tx]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float cf = cc == 0 ? cv[a].x : cc == 1 ? cv[a].y : cc == 2 ? cv[a].z : cv[a].w;
          acc[a][0] = fmaf(cf, sv.x, acc[a][0]);
          acc[a][1] = fmaf(cf, sv.y, acc[a][1]);
          acc[a][2] = fmaf(cf, sv.z, acc[a][2]);
          acc[a][3] = fmaf(cf, sv.w, acc[a][3]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float dec = expf(cs_s[i0 + ty + 16 * a]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][e] *= dec;
    }
  }

  const float* Gc = p.G + ((long long)(bi * p.g + gi) * p.nc + c) * p.qp * p.qp;
  for (int tj = 0; tj <= ti; ++tj) {
    const int j0 = tj * kTile;
    __syncthreads();  // the previous tile's readers of Xs and Ps are done
    load_f32<kTile, kF32Threads>(xb + j0 * p.x_ss, p.x_ss, qv - j0, pv, nullptr, Xs);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = i0 + ty + 16 * a;
      const float* Gr = Gc + (long long)r * p.qp + j0 + tx;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = j0 + tx + 16 * b;
        Ps[(ty + 16 * a) * LDX + tx + 16 * b] =
            k <= r ? Gr[16 * b] * expf(cs_s[r] - cs_s[k]) * dt_s[k] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kTile; k += 4) {
      float4 pr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pr[a] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * a) * LDX + k]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[(k + cc) * LDX + 4 * tx]);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pf = cc == 0 ? pr[a].x : cc == 1 ? pr[a].y : cc == 2 ? pr[a].z : pr[a].w;
          acc[a][0] = fmaf(pf, xv.x, acc[a][0]);
          acc[a][1] = fmaf(pf, xv.y, acc[a][1]);
          acc[a][2] = fmaf(pf, xv.z, acc[a][2]);
          acc[a][3] = fmaf(pf, xv.w, acc[a][3]);
        }
      }
    }
  }

  if (4 * tx >= pv) return;
  float* yb = static_cast<float*>(p.y) + bi * p.y_sb + hi * p.y_sh + p0 + 4 * tx;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = i0 + ty + 16 * a;
    if (r < qv)
      *reinterpret_cast<float4*>(yb + (t0 + r) * p.y_ss) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
}

// ------------------------------------------------------------------------- //
// Stage 3, both types: one thread per (batch, head, state entry), the chunks
// in order. The chunk states are overwritten by the incoming states.
// ------------------------------------------------------------------------- //

__global__ void __launch_bounds__(256) pass_kernel(Params p) {
  constexpr int U = 8;  // chunks whose loads are in flight together
  const long long pn = (long long)p.p * p.n;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)p.b * p.h * pn) return;
  const long long bh = e / pn, k = e % pn;
  float S = p.init ? p.init[e] : 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += U) {
    float own[U], cs_last[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bhc = bh * p.nc + c0 + u;
      if (c0 + u < p.nc) {
        own[u] = p.S[bhc * pn + k];
        cs_last[u] = p.cs[bhc * p.qp + chunk_len(p, c0 + u) - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < p.nc) {
        p.S[(bh * p.nc + c0 + u) * pn + k] = S;
        S = fmaf(S, expf(cs_last[u]), own[u]);
      }
    }
  }
  p.state[e] = S;
}

// ------------------------------------------------------------------------- //
// Launches.
// ------------------------------------------------------------------------- //

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kScores = 1, kStates = 2, kPass = 4, kOutputs = 8;

// The stages named in `stages`, in order, with bf16 (BF16) or fp32 inputs.
template <bool BF16, int N>
cudaError_t run(const Params& p, int stages, cudaStream_t st) {
  const unsigned bhc = (unsigned)(p.b * p.h * p.nc);
  const unsigned ptiles = (unsigned)((p.p + kTile - 1) / kTile);
  const size_t e16 = sizeof(__nv_bfloat16), e32 = sizeof(float);
  constexpr int LD16 = kTile + 8;  // pitch of the bf16 and fp32 64-column tiles
  cudaError_t err = cudaSuccess;
  if (stages & kScores) {
    const dim3 grid((unsigned)(p.b * p.g * p.nc), (unsigned)(p.tiles * (p.tiles + 1) / 2));
    err = BF16 ? launch(scores_mma_kernel<N>, grid, kMmaThreads, 2 * kTile * (N + 8) * e16, p,
                        st)
               : launch(scores_f32_kernel<N>, grid, kF32Threads, 2 * kTile * (N + 4) * e32, p,
                        st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kStates) {
    const dim3 grid(bhc, ptiles);
    const size_t scan = (kWideThreads / 32 + 2 * p.Q) * e32;
    err = BF16 ? launch(states_mma_kernel<N>, grid, kWideThreads,
                        (2 * kTile * (N + 8) + 4 * kTile * LD16) * e16 + scan, p, st)
               : launch(states_f32_kernel<N>, grid, kF32Threads,
                        (kTile * (N + 4) + kTile * (kTile + 4)) * e32 + scan, p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kPass) {
    const long long total = (long long)p.b * p.h * p.p * p.n;
    pass_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & kOutputs) {
    const dim3 grid(bhc, ptiles, (unsigned)p.tiles);
    const size_t rows = 2 * p.qp * e32;  // cumsums and dt
    err = BF16 ? launch(outputs_mma_kernel<N>, grid, kMmaThreads,
                        (kTile * (N + 8) + 2 * kTile * LD16) * (e16 + e32) + rows, p, st)
               : launch(outputs_f32_kernel<N>, grid, kF32Threads,
                        (kTile * (N + 4) + (N + 2 * kTile) * (kTile + 4)) * e32 + rows, p, st);
  }
  return err;
}

template <bool BF16>
cudaError_t run_n(const Params& p, int stages, cudaStream_t st) {
  if (p.n == 16) return run<BF16, 16>(p, stages, st);
  if (p.n == 32) return run<BF16, 32>(p, stages, st);
  if (p.n == 64) return run<BF16, 64>(p, stages, st);
  if (p.n == 128) return run<BF16, 128>(p, stages, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (b, s, h, p), B and C: (b, s, g, n) of `dtype` (0 = float32, 1 =
// bfloat16); dt: (b, s, h) and A: (h,) float32; strides in elements, last dims
// contiguous, rows of x, B and C 16-byte aligned. y: (b, s, h, p) of `dtype`
// (strides given); state: (b, h, p, n) float32, contiguous. Scratch, float32,
// contiguous, with nc = ceil(s / chunk) and qp = chunk rounded up to 64:
// scores (b, g, nc, qp, qp), cs (b, h, nc, qp), states (b, h, nc, p, n).
// chunk: positions per chunk (<= 1024, <= s); n: 16, 32, 64 or 128; p % 8 == 0.
// stages: a mask of the kernels to launch, in order (1 scores, 2 states, 4 the
// state pass, 8 outputs; 15 for the whole scan). init: the initial state (b, h,
// p, n) float32, contiguous, or null for zero; the pass reads it. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* init, void* y, void* state,
                              void* scores, void* cs,
                              void* states, int b, int s, int h, int p, int g, int n, int chunk,
                              long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                              long long dt_ss, long long dt_sh, long long B_sb, long long B_ss,
                              long long B_sg, long long C_sb, long long C_ss, long long C_sg,
                              long long y_sb, long long y_ss, long long y_sh, int dtype,
                              int stages, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p % 8 != 0 || g <= 0 || h % g != 0 ||
      chunk <= 0 || chunk > kMaxChunk || chunk > s || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.x = x; prm.dt = static_cast<const float*>(dt); prm.A = static_cast<const float*>(A);
  prm.B = B; prm.C = C; prm.y = y; prm.state = static_cast<float*>(state);
  prm.init = static_cast<const float*>(init);
  prm.G = static_cast<float*>(scores); prm.cs = static_cast<float*>(cs);
  prm.S = static_cast<float*>(states);
  prm.b = b; prm.s = s; prm.h = h; prm.p = p; prm.g = g; prm.n = n; prm.Q = chunk;
  prm.nc = (s + chunk - 1) / chunk;
  prm.tiles = (chunk + kTile - 1) / kTile;
  prm.qp = prm.tiles * kTile;
  if ((long long)b * h * prm.nc > 0x7fffffffLL || (p + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  prm.x_sb = x_sb; prm.x_ss = x_ss; prm.x_sh = x_sh;
  prm.dt_sb = dt_sb; prm.dt_ss = dt_ss; prm.dt_sh = dt_sh;
  prm.B_sb = B_sb; prm.B_ss = B_ss; prm.B_sg = B_sg;
  prm.C_sb = C_sb; prm.C_ss = C_ss; prm.C_sg = C_sg;
  prm.y_sb = y_sb; prm.y_ss = y_ss; prm.y_sh = y_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)run_n<false>(prm, stages, st);
  if (dtype == 1) return (int)run_n<true>(prm, stages, st);
  return (int)cudaErrorInvalidValue;
}
