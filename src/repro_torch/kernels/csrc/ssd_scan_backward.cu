// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// No Pallas counterpart: the TPU side differentiates its scan with jax.grad
// (`ssd_chunked`, src/repro/models/mamba.py:127, the function the Pallas
// kernel src/repro/kernels/ssd_scan.py `ssd_scan` computes). This is the
// gradient of csrc/ssd_scan.cu's scan, in closed form. Per chunk of Q
// positions, with cs the in-chunk cumsum of dt * A, E_ij = exp(cs_i - cs_j)
// (j <= i), G = C B^T, M_ij = G_ij E_ij dt_j, w_j = dt_j exp(cs_last - cs_j),
// S_in the chunk's incoming state, dS its final state's cotangent and
// dM_ij = dy_i . x_j:
//
//   dx_j  = sum_{i >= j} M_ij dy_i + w_j dS B_j
//   dC_i  = sum_{j <= i} dM_ij E_ij dt_j B_j + exp(cs_i) S_in^T dy_i
//   dB_j  = sum_{i >= j} dM_ij E_ij dt_j C_i + w_j dS^T x_j
//   ddt_j = sum_i G_ij E_ij dM_ij + exp(cs_last - cs_j) x_j . dS B_j + A rev_j
//   dA    = sum over batch, chunks and positions of dt_j rev_j
//
// with rev the reverse in-chunk cumsum of cs's cotangent (see
// `ssd_scan.py`). Everything in fp32, from inputs of the caller's type;
// gradients in their input's type (dt and A fp32). Positions past `s` act as
// dt = 0 and get no gradient. It reads the training forward's scratch (the
// G tiles, the cumsums, the incoming states) instead of recomputing it.
//
// Four kernels a call, on the stream in order, through fp32 scratch the
// wrapper allocates:
//   1. `dstates` (`ssd_bwd_dstates_kernel`): one block per (batch, head,
//      chunk): U_c = sum_i exp(cs_i) dy_i (x) C_i, the cotangent the chunk's
//      outputs send its incoming state.
//   2. `dpass` (`ssd_bwd_pass_kernel`): one thread per (batch, head, state
//      entry) walks the chunks from last to first: dS_c = D; D = D
//      exp(cs_last[c]) + U_c, from the final state's cotangent (or 0). dS
//      overwrites U.
//   3. `chunk` (`ssd_bwd_chunk_kernel`): one block per (batch, head, chunk)
//      walks the chunk's 64-row tiles. For tile t it runs the row terms of
//      its positions (dC_i and cs's row terms, over key tiles j <= t) and then
//      the column terms (dx_j, each head's dB_j, dt's direct part and cs's
//      column terms, over row tiles i >= t), recomputing dM tile by tile from
//      dy and x; then the chunk's reverse cumsum, ddt, and its share of dA.
//      Each pair of tiles is visited twice (once as rows, once as columns) so
//      that every output is summed in one block, in a fixed order.
//   4. `reduce` (`ssd_bwd_reduce_kernel`): dB and dC, each group's heads
//      summed in head order; dA, the chunks' shares summed over batch and
//      chunks in a fixed order.
// No atomics: every value is written by one thread and every sum is taken
// in an order that does not depend on how blocks are scheduled, so two calls
// give the same bits.
//
// Bound: at mamba2-780m's training layer (b 8, s 2048, h 48, p 64, n 128,
// Q 256) a call does ~130 GFLOP of products against ~0.65 GB of inputs and
// outputs, so the card's bound is its operations. This first version runs
// them on fp32 FMAs from shared memory (a 16 x 16 thread block, a 4 x 4 or
// 4 x n/16 patch a thread), one block of 256 threads an SM (~175 KB of
// shared memory at n 128): right and deterministic before fast. The
// products are the tensor cores' work in a redesign (3xTF32 / bf16 mma), and
// the per-head dB/dC scratch (4 b s h n bytes each) would go with a
// group-major block order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // positions of a tile; head_dim columns (padded to 64)
constexpr int kThreads = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;        // a shared row's pitch is its width + 4 floats
constexpr int kLdt = kTile + kPad;
constexpr int kMaxChunk = 1024;
constexpr int kMaxHeadDim = 64;

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
  float* dB_h;          // (b, s, h, n): each head's dB
  float* dC_h;          // (b, s, h, n): each head's dC
  float* dA_part;       // (b, h, nc): each chunk's share of dA
  void* dx;             // (b, s, h, p), contiguous, x's type
  float* ddt;           // (b, s, h), contiguous
  float* dA;            // (h,)
  void* dB;             // (b, s, g, n), contiguous, B's type
  void* dC;             // (b, s, g, n), contiguous, C's type
  int b, s, h, p, g, n, Q;
  int nc, qp;                  // chunks; Q rounded up to kTile
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

__device__ __forceinline__ float4 load4(const float* src) {
  return *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows [0, 64) of a slab of W columns of T (row stride `ss` elements) into
// shared memory as fp32 with pitch W + kPad, row r times scale[r] if `scale`
// is given; rows at or beyond `rows` and 4-column packs at or beyond `cols`
// become zeros. The caller synchronises.
template <int W, typename T>
__device__ __forceinline__ void load_tile(const T* base, long long ss, int rows, int cols,
                                          const float* scale, float* dst) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < kTile * CH; idx += kThreads) {
    const int r = idx / CH;
    const int c = (idx % CH) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < cols) {
      v = load4(base + (long long)r * ss + c);
      if (scale) {
        const float f = scale[r];
        v.x *= f; v.y *= f; v.z *= f; v.w *= f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * (W + kPad) + c) = v;
  }
}

// The sum over the 16 lanes of a half warp (one ty's tx), every lane taking
// part; lane tx = 0's result is the one used.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the block in a fixed order; every thread gets the same value.
// `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the previous user of `red` is done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

// v[i] <- sum_{i <= k < len} v[k], in place, by the block: segments of
// kThreads positions from the top, warp scans, then the warps' sums. `red`
// holds kWarps floats. Ends with a barrier.
__device__ void reverse_cumsum(float* v, int len, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int top = len; top > 0; top -= kThreads) {
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
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += red[w];
      seg += red[w];
    }
    if (i >= 0) v[i] = carry + before + x;
    carry += seg;
  }
  __syncthreads();
}

// ------------------------------------------------------------------------- //
// Stage 1. Grid (nc * b * h): U_c[pp][nn] = sum_i exp(cs_i) dy_i[pp] C_i[nn]
// of one (batch, head, chunk), positions 64 at a time. A thread owns p rows
// 4 ty + e and n columns tx + 16 k.
// ------------------------------------------------------------------------- //

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_dstates_kernel(BwdParams p) {
  constexpr int LDN = N + kPad;
  constexpr int NK = N / 16;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                // kTile x LDN
  float* Ys = Cs + kTile * LDN;    // kTile x kLdt, row i times exp(cs_i)
  float* ecs = Ys + kTile * kLdt;  // qp

  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int qv = chunk_len(p, c);
  const long long t0 = (long long)c * p.Q;
  const float* csg = p.cs + (long long)blockIdx.x * p.qp;
  for (int i = threadIdx.x; i < qv; i += kThreads) ecs[i] = expf(csg[i]);
  const T* yb = static_cast<const T*>(p.dy) + bi * p.dy_sb + hi * p.dy_sh + t0 * p.dy_ss;
  const T* Cb = static_cast<const T*>(p.C) + bi * p.C_sb + gi * p.C_sg + t0 * p.C_ss;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][NK];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int k = 0; k < NK; ++k) acc[e][k] = 0.f;
  for (int i0 = 0; i0 < qv; i0 += kTile) {
    __syncthreads();  // ecs is written; the previous tile's readers are done
    load_tile<N>(Cb + i0 * p.C_ss, p.C_ss, qv - i0, N, nullptr, Cs);
    load_tile<kTile>(yb + i0 * p.dy_ss, p.dy_ss, qv - i0, p.p, ecs + i0, Ys);
    __syncthreads();
    const int kv = min(kTile, qv - i0);
#pragma unroll 4
    for (int i = 0; i < kv; ++i) {
      const float4 yv = *reinterpret_cast<const float4*>(&Ys[i * kLdt + 4 * ty]);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float cv = Cs[i * LDN + tx + 16 * k];
        acc[0][k] = fmaf(yv.x, cv, acc[0][k]);
        acc[1][k] = fmaf(yv.y, cv, acc[1][k]);
        acc[2][k] = fmaf(yv.z, cv, acc[2][k]);
        acc[3][k] = fmaf(yv.w, cv, acc[3][k]);
      }
    }
  }
  float* Ub = p.dS + ((long long)blockIdx.x * p.p + 4 * ty) * N + tx;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (4 * ty + e >= p.p) break;
#pragma unroll
    for (int k = 0; k < NK; ++k) Ub[e * N + 16 * k] = acc[e][k];
  }
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
}

// ------------------------------------------------------------------------- //
// Stage 3. Grid (nc * b * h): one (batch, head, chunk). A thread (tx, ty)
// owns positions ty + 16 a of a tile and either key columns tx + 16 b, p
// columns tx + 16 e or n columns tx + 16 k. Shared memory: the tile's dy, x,
// C and B rows as fp32, a work area (a G tile and two tiles built from it, or
// a p x n state), and the chunk's cumsums, dt and per-position sums.
// ------------------------------------------------------------------------- //

template <int N>
__host__ __device__ constexpr int work_floats() {
  return 3 * kTile * kLdt > kTile * (N + kPad) ? 3 * kTile * kLdt : kTile * (N + kPad);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(BwdParams p) {
  constexpr int LDN = N + kPad;
  constexpr int NK = N / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ys = smem;                  // dy rows, kTile x kLdt
  float* Xs = Ys + kTile * kLdt;     // x rows
  float* Cs = Xs + kTile * kLdt;     // C rows, kTile x LDN
  float* Bs = Cs + kTile * LDN;      // B rows
  float* Gs = Bs + kTile * LDN;      // a G tile (rows i, keys j), kTile x kLdt,
  float* T1 = Gs + kTile * kLdt;     // and two tiles built from it
  float* T2 = T1 + kTile * kLdt;
  float* Ss = Gs;                    // or a state (p rows, zeros past p), kTile x LDN
  float* cs_s = Gs + work_floats<N>();  // qp each:
  float* dt_s = cs_s + p.qp;         // dt, 0 past the chunk's end
  float* dcs_s = dt_s + p.qp;        // cs's cotangent
  float* ddt_s = dcs_s + p.qp;       // dt's direct part
  float* xw_s = ddt_s + p.qp;        // w_j x_j . SB_j
  float* red = xw_s + p.qp;          // kWarps
  float* last_s = red + kWarps;      // exp(cs_last) <dS, S_in>

  const int c = blockIdx.x % p.nc;
  const int bh = blockIdx.x / p.nc;
  const int bi = bh / p.h, hi = bh % p.h;
  const int gi = hi / (p.h / p.g);
  const int qv = chunk_len(p, c);
  const int ntiles = (qv + kTile - 1) / kTile;
  const long long t0 = (long long)c * p.Q;
  const bool carry = c > 0;  // the first chunk's incoming state is zero
  const T* xb = static_cast<const T*>(p.x) + bi * p.x_sb + hi * p.x_sh + t0 * p.x_ss;
  const T* yb = static_cast<const T*>(p.dy) + bi * p.dy_sb + hi * p.dy_sh + t0 * p.dy_ss;
  const T* Bb = static_cast<const T*>(p.B) + bi * p.B_sb + gi * p.B_sg + t0 * p.B_ss;
  const T* Cb = static_cast<const T*>(p.C) + bi * p.C_sb + gi * p.C_sg + t0 * p.C_ss;
  const float* Gc = p.G + ((long long)(bi * p.g + gi) * p.nc + c) * p.qp * p.qp;
  const float* Sin = p.S_in + (long long)blockIdx.x * p.p * N;
  const float* dSc = p.dS + (long long)blockIdx.x * p.p * N;
  const float* csg = p.cs + (long long)blockIdx.x * p.qp;
  const float* dtb = p.dt + bi * p.dt_sb + hi * p.dt_sh + t0 * p.dt_ss;
  for (int i = threadIdx.x; i < p.qp; i += kThreads) {
    cs_s[i] = csg[i];
    dt_s[i] = i < qv ? dtb[(long long)i * p.dt_ss] : 0.f;
  }
  if (threadIdx.x == 0) *last_s = 0.f;
  __syncthreads();
  const float cs_last = cs_s[qv - 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * kTile;  // the tile's first position

    // ---- Rows i in [r0, r0 + 64): dC_i and cs's row terms.
    {
      __syncthreads();  // every reader of Ys, Cs and the work area is done
      load_tile<kTile>(yb + r0 * p.dy_ss, p.dy_ss, qv - r0, p.p, nullptr, Ys);
      load_tile<N>(Cb + r0 * p.C_ss, p.C_ss, qv - r0, N, nullptr, Cs);
      if (carry) load_tile<N>(Sin, N, p.p, N, nullptr, Ss);
      __syncthreads();
      float acc[4][NK], dcs[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        dcs[a] = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) acc[a][k] = 0.f;
      }
      if (carry) {
        // exp(cs_i) S_in^T dy_i, and its share of dcs_i: exp(cs_i) dy_i . S_in C_i
        for (int pp = 0; pp < p.p; pp += 4) {
          float4 yv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            yv[a] = *reinterpret_cast<const float4*>(&Ys[(ty + 16 * a) * kLdt + pp]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int k = 0; k < NK; ++k) {
              const float sv = Ss[(pp + cc) * LDN + tx + 16 * k];
#pragma unroll
              for (int a = 0; a < 4; ++a) acc[a][k] = fmaf(comp(yv[a], cc), sv, acc[a][k]);
            }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = r0 + ty + 16 * a;
          const float e = i < qv ? expf(cs_s[i]) : 0.f;
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            acc[a][k] *= e;
            dcs[a] = fmaf(Cs[(ty + 16 * a) * LDN + tx + 16 * k], acc[a][k], dcs[a]);
          }
        }
        if (qv - 1 - r0 < kTile) {
          // the tile holds the last position: exp(cs_last) <dS, S_in>
          float part = 0.f;
          for (int idx = threadIdx.x; idx < p.p * N; idx += kThreads)
            part = fmaf(Ss[(idx / N) * LDN + idx % N], dSc[idx], part);
          part = block_sum(part, red);
          if (threadIdx.x == 0) *last_s = expf(cs_last) * part;
        }
      }
      for (int tj = 0; tj <= t; ++tj) {
        const int j0 = tj * kTile;
        __syncthreads();  // the state, or the previous key tile, is no longer read
        load_tile<kTile>(xb + j0 * p.x_ss, p.x_ss, qv - j0, p.p, nullptr, Xs);
        load_tile<N>(Bb + j0 * p.B_ss, p.B_ss, qv - j0, N, nullptr, Bs);
        load_tile<kTile>(Gc + (long long)r0 * p.qp + j0, p.qp, kTile, kTile, nullptr, Gs);
        __syncthreads();
        // dM_ij = dy_i . x_j, i = r0 + ty + 16 a, j = j0 + tx + 16 b
        float d[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) d[a][b] = 0.f;
        for (int pp = 0; pp < p.p; pp += 4) {
          float4 yv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            yv[a] = *reinterpret_cast<const float4*>(&Ys[(ty + 16 * a) * kLdt + pp]);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            xv[b] = *reinterpret_cast<const float4*>(&Xs[(tx + 16 * b) * kLdt + pp]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) d[a][b] = dot4(yv[a], xv[b], d[a][b]);
        }
        // P_ij = dM_ij E_ij dt_j into T1; dcs_i += G_ij P_ij
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int i = r0 + ty + 16 * a, j = j0 + tx + 16 * b;
            float P = 0.f;
            if (j <= i && i < qv) {
              P = d[a][b] * expf(cs_s[i] - cs_s[j]) * dt_s[j];
              dcs[a] = fmaf(Gs[(ty + 16 * a) * kLdt + tx + 16 * b], P, dcs[a]);
            }
            T1[(ty + 16 * a) * kLdt + tx + 16 * b] = P;
          }
        __syncthreads();
        // dC_i += sum_j P_ij B_j
#pragma unroll 2
        for (int jj = 0; jj < kTile; jj += 4) {
          float4 pv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            pv[a] = *reinterpret_cast<const float4*>(&T1[(ty + 16 * a) * kLdt + jj]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int k = 0; k < NK; ++k) {
              const float bv = Bs[(jj + cc) * LDN + tx + 16 * k];
#pragma unroll
              for (int a = 0; a < 4; ++a) acc[a][k] = fmaf(comp(pv[a], cc), bv, acc[a][k]);
            }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = r0 + ty + 16 * a;
        const float v = sum16(dcs[a]);
        if (i < qv) {
          if (tx == 0) dcs_s[i] = v;
          float* out = p.dC_h + (((long long)bi * p.s + t0 + i) * p.h + hi) * N + tx;
#pragma unroll
          for (int k = 0; k < NK; ++k) out[16 * k] = acc[a][k];
        }
      }
    }

    // ---- Columns j in [r0, r0 + 64): dx_j, dB_j, dt's direct part, cs's
    // column terms.
    {
      const int j0 = r0;
      __syncthreads();  // the row terms' readers of Xs, Bs and T1 are done
      load_tile<kTile>(xb + j0 * p.x_ss, p.x_ss, qv - j0, p.p, nullptr, Xs);
      load_tile<N>(Bb + j0 * p.B_ss, p.B_ss, qv - j0, N, nullptr, Bs);
      load_tile<N>(dSc, N, p.p, N, nullptr, Ss);
      __syncthreads();
      float dx[4][4], dB[4][NK], rs[4], xs[4], w[4];
      {
        // SB_j = dS B_j for p columns tx + 16 e
        float sb[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) sb[a][e] = 0.f;
        for (int nn = 0; nn < N; nn += 4) {
          float4 bv[4], sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            bv[a] = *reinterpret_cast<const float4*>(&Bs[(ty + 16 * a) * LDN + nn]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sv[e] = *reinterpret_cast<const float4*>(&Ss[(tx + 16 * e) * LDN + nn]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) sb[a][e] = dot4(bv[a], sv[e], sb[a][e]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int j = j0 + ty + 16 * a;
          w[a] = j < qv ? dt_s[j] * expf(cs_last - cs_s[j]) : 0.f;
          rs[a] = 0.f;
          xs[a] = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dx[a][e] = w[a] * sb[a][e];
            xs[a] = fmaf(Xs[(ty + 16 * a) * kLdt + tx + 16 * e], sb[a][e], xs[a]);
          }
        }
      }
      // w_j dS^T x_j: the state's part of dB_j
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NK; ++k) dB[a][k] = 0.f;
      for (int pp = 0; pp < p.p; pp += 4) {
        float4 xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          xv[a] = *reinterpret_cast<const float4*>(&Xs[(ty + 16 * a) * kLdt + pp]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            const float sv = Ss[(pp + cc) * LDN + tx + 16 * k];
#pragma unroll
            for (int a = 0; a < 4; ++a) dB[a][k] = fmaf(comp(xv[a], cc), sv, dB[a][k]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NK; ++k) dB[a][k] *= w[a];

      for (int ti = t; ti < ntiles; ++ti) {
        const int i0 = ti * kTile;
        __syncthreads();  // the state, or the previous row tile, is no longer read
        load_tile<kTile>(yb + i0 * p.dy_ss, p.dy_ss, qv - i0, p.p, nullptr, Ys);
        load_tile<N>(Cb + i0 * p.C_ss, p.C_ss, qv - i0, N, nullptr, Cs);
        load_tile<kTile>(Gc + (long long)i0 * p.qp + j0, p.qp, kTile, kTile, nullptr, Gs);
        __syncthreads();
        // dM_ij = dy_i . x_j, j = j0 + ty + 16 a, i = i0 + tx + 16 b
        float d[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) d[a][b] = 0.f;
        for (int pp = 0; pp < p.p; pp += 4) {
          float4 xv[4], yv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            xv[a] = *reinterpret_cast<const float4*>(&Xs[(ty + 16 * a) * kLdt + pp]);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            yv[b] = *reinterpret_cast<const float4*>(&Ys[(tx + 16 * b) * kLdt + pp]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) d[a][b] = dot4(xv[a], yv[b], d[a][b]);
        }
        // M^T into T1, P^T into T2 ([j][i]); dt's direct part sum_i G E dM
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int j = j0 + ty + 16 * a, i = i0 + tx + 16 * b;
            float m = 0.f, P = 0.f;
            if (j <= i && i < qv) {
              const float E = expf(cs_s[i] - cs_s[j]);
              const float g = Gs[(tx + 16 * b) * kLdt + ty + 16 * a];
              const float ed = E * dt_s[j];
              m = g * ed;
              P = d[a][b] * ed;
              rs[a] = fmaf(g * E, d[a][b], rs[a]);
            }
            T1[(ty + 16 * a) * kLdt + tx + 16 * b] = m;
            T2[(ty + 16 * a) * kLdt + tx + 16 * b] = P;
          }
        __syncthreads();
        // dx_j += sum_i M_ij dy_i; dB_j += sum_i P_ij C_i
#pragma unroll 2
        for (int ii = 0; ii < kTile; ii += 4) {
          float4 mv[4], pv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            mv[a] = *reinterpret_cast<const float4*>(&T1[(ty + 16 * a) * kLdt + ii]);
            pv[a] = *reinterpret_cast<const float4*>(&T2[(ty + 16 * a) * kLdt + ii]);
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float yv = Ys[(ii + cc) * kLdt + tx + 16 * e];
#pragma unroll
              for (int a = 0; a < 4; ++a) dx[a][e] = fmaf(comp(mv[a], cc), yv, dx[a][e]);
            }
#pragma unroll
            for (int k = 0; k < NK; ++k) {
              const float cv = Cs[(ii + cc) * LDN + tx + 16 * k];
#pragma unroll
              for (int a = 0; a < 4; ++a) dB[a][k] = fmaf(comp(pv[a], cc), cv, dB[a][k]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = j0 + ty + 16 * a;
        const float r = sum16(rs[a]), xsb = sum16(xs[a]);
        if (j < qv) {
          if (tx == 0) {
            ddt_s[j] = fmaf(expf(cs_last - cs_s[j]), xsb, r);
            dcs_s[j] += -dt_s[j] * r - w[a] * xsb;
            xw_s[j] = w[a] * xsb;
          }
          const long long row = ((long long)bi * p.s + t0 + j) * p.h + hi;
          T* dxr = static_cast<T*>(p.dx) + row * p.p + tx;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (tx + 16 * e < p.p) store(dxr + 16 * e, dx[a][e]);
          float* dbr = p.dB_h + row * N + tx;
#pragma unroll
          for (int k = 0; k < NK; ++k) dbr[16 * k] = dB[a][k];
        }
      }
    }
  }

  // ---- The chunk: the last position's terms, the reverse cumsum, ddt and
  // the chunk's share of dA.
  __syncthreads();
  float tot = 0.f;
  for (int j = threadIdx.x; j < qv; j += kThreads) tot += xw_s[j];
  tot = block_sum(tot, red);
  if (threadIdx.x == 0) dcs_s[qv - 1] += tot + *last_s;
  __syncthreads();
  reverse_cumsum(dcs_s, qv, red);
  const float a_h = p.A[hi];
  float part = 0.f;
  for (int j = threadIdx.x; j < qv; j += kThreads) {
    p.ddt[((long long)bi * p.s + t0 + j) * p.h + hi] = fmaf(a_h, dcs_s[j], ddt_s[j]);
    part = fmaf(dt_s[j], dcs_s[j], part);
  }
  part = block_sum(part, red);
  if (threadIdx.x == 0) p.dA_part[blockIdx.x] = part;
}

// ------------------------------------------------------------------------- //
// Stage 4: one thread per (batch, position, group, n) for dB and dC, the
// group's heads in order; then one per head for dA, the shares in (batch,
// chunk) order.
// ------------------------------------------------------------------------- //

template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(BwdParams p) {
  const long long gn = (long long)p.g * p.n;
  const long long total = (long long)p.b * p.s * gn;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < total) {
    const int r = p.h / p.g;
    const long long bs = e / gn;
    const long long within = e % gn;  // gi * n + nn
    const long long base = bs * p.h * p.n + (within / p.n) * r * p.n + within % p.n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < r; ++k) {
      sb += p.dB_h[base + (long long)k * p.n];
      sc += p.dC_h[base + (long long)k * p.n];
    }
    store(static_cast<T*>(p.dB) + e, sb);
    store(static_cast<T*>(p.dC) + e, sc);
  } else if (e < total + p.h) {
    const int hi = (int)(e - total);
    float sum = 0.f;
    for (int bi = 0; bi < p.b; ++bi)
      for (int c = 0; c < p.nc; ++c) sum += p.dA_part[((long long)bi * p.h + hi) * p.nc + c];
    p.dA[hi] = sum;
  }
}

// ------------------------------------------------------------------------- //
// Launches.
// ------------------------------------------------------------------------- //

template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned blocks, size_t smem, const BwdParams& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

constexpr int kDstates = 1, kDpass = 2, kChunk = 4, kReduce = 8;

template <typename T, int N>
cudaError_t run(const BwdParams& p, int stages, cudaStream_t st) {
  const unsigned bhc = (unsigned)(p.b * p.h * p.nc);
  const size_t f32 = sizeof(float);
  constexpr int LDN = N + kPad;
  cudaError_t err = cudaSuccess;
  if (stages & kDstates) {
    err = launch(ssd_bwd_dstates_kernel<T, N>, bhc, (kTile * LDN + kTile * kLdt + p.qp) * f32,
                 p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kDpass) {
    const long long total = (long long)p.b * p.h * p.p * p.n;
    ssd_bwd_pass_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & kChunk) {
    const size_t floats =
        2 * kTile * kLdt + 2 * kTile * LDN + work_floats<N>() + 5 * p.qp + kWarps + 1;
    err = launch(ssd_bwd_chunk_kernel<T, N>, bhc, floats * f32, p, st);
    if (err != cudaSuccess) return err;
  }
  if (stages & kReduce) {
    const long long total = (long long)p.b * p.s * p.g * p.n + p.h;
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
// dS (b, h, nc, p, n), dB_h and dC_h (b, s, h, n), dA_part (b, h, nc).
// Outputs, contiguous: dx (b, s, h, p) and dB, dC (b, s, g, n) of `dtype`,
// ddt (b, s, h) and dA (h,) float32. p % 8 == 0 and p <= 64; n: 16, 32, 64
// or 128; chunk <= 1024 and <= s. stages: a mask of the kernels to launch, in
// order (1 dstates, 2 dpass, 4 chunk, 8 reduce; 15 for the whole backward).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int repro_ssd_scan_backward(
    const void* x, const void* dt, const void* A, const void* B, const void* C, const void* dy,
    const void* dstate, const void* scores, const void* cs, const void* incoming, void* dS,
    void* dB_h, void* dC_h, void* dA_part, void* dx, void* ddt, void* dA, void* dB, void* dC,
    int b, int s, int h, int p, int g, int n, int chunk, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh, long long B_sb,
    long long B_ss, long long B_sg, long long C_sb, long long C_ss, long long C_sg,
    long long dy_sb, long long dy_ss, long long dy_sh, int dtype, int stages, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || p % 8 != 0 || p > kMaxHeadDim || g <= 0 ||
      h % g != 0 || chunk <= 0 || chunk > kMaxChunk || chunk > s)
    return (int)cudaErrorInvalidValue;
  BwdParams prm;
  prm.x = x; prm.dt = static_cast<const float*>(dt); prm.A = static_cast<const float*>(A);
  prm.B = B; prm.C = C; prm.dy = dy; prm.dstate = static_cast<const float*>(dstate);
  prm.G = static_cast<const float*>(scores); prm.cs = static_cast<const float*>(cs);
  prm.S_in = static_cast<const float*>(incoming); prm.dS = static_cast<float*>(dS);
  prm.dB_h = static_cast<float*>(dB_h); prm.dC_h = static_cast<float*>(dC_h);
  prm.dA_part = static_cast<float*>(dA_part);
  prm.dx = dx; prm.ddt = static_cast<float*>(ddt); prm.dA = static_cast<float*>(dA);
  prm.dB = dB; prm.dC = dC;
  prm.b = b; prm.s = s; prm.h = h; prm.p = p; prm.g = g; prm.n = n; prm.Q = chunk;
  prm.nc = (s + chunk - 1) / chunk;
  prm.qp = (chunk + kTile - 1) / kTile * kTile;
  if ((long long)b * h * prm.nc > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
