// Flash attention backward for Hopper (sm_90a).
//
// The JAX package has no Pallas backward: `jax.grad` differentiates the
// attention of src/repro/models/common.py. This is the gradient of the
// forward kernel (flash_attention.cu, which replaces
// src/repro/kernels/flash_attention.py `_flash_kernel`) for training: given
// q, k, v, the forward's output o, its rows' log-sum-exp lse and dO, it
// returns dQ, dK, dV. GQA (query head i reads KV head i / (h / hkv)), causal
// top-left (`kpos <= qpos`) or not; no kv_len, no q_offset.
//
// The arithmetic is the forward's, in fp32: S = Q K^T * scale, P = exp(S -
// lse) (0 where masked), with P rounded to the input type where the forward
// rounds it (before P V, so dV = P^T dO takes the rounded P); dP = dO V^T;
// D = rowsum(dO * O); dS = P * (dP - D); dQ = dS K * scale, dK = dS^T Q *
// scale. Inputs are read in their type and widened to fp32 in shared memory;
// every sum is fp32; the results are rounded once.
//
// Bound on this card: operations, 5 products of 2 s^2 d a head (half when
// causal) against 2 x 4 s d + 2 x 2 s d values moved. This first version is
// the simple FlashAttention-2 schedule on the fp32 pipes (no tensor cores),
// and deterministic: no float atomics, each result written once, every sum
// in a fixed order.
//  (a) `bwd_delta_kernel`: D, one warp a query row.
//  (b) `bwd_dkdv_kernel`: one block per (batch, KV head, 64-key tile). It
//      keeps the tile's K and V in shared memory and dK, dV in registers, and
//      loops over the query heads of its group and, for each, over the query
//      tiles that may see its keys. So the GQA reduction over the group is a
//      sum in registers, in a fixed order, and dK, dV are written once.
//  (c) `bwd_dq_kernel`: one block per (batch, head, 64-query tile), looping
//      over the key tiles its rows may see, dQ in registers.
// S and P are recomputed in (b) and (c), two products more than the bound
// counts (7 against 5); the price of no atomics. A block is 256 threads, each
// owning a 4 x 4 patch of a 64 x 64 score tile (16 lanes along the columns,
// so a row's reduction stays within a warp), as in the forward's fp32 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;        // query rows a tile
constexpr int BN = 64;        // keys a tile
constexpr int TX = 16;        // threads along a patch's columns
constexpr int TY = 16;        // threads along its rows
constexpr int NT = TX * TY;   // threads a block
constexpr int RP = 4;         // rows of a thread's patch (ty + 16 i)
constexpr int CP = 4;         // columns of it (tx + 16 j)
constexpr int LDP = 64 + 16;  // row pitch of a score tile: 16 banks apart

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (b, h, sq), contiguous
  float* delta;      // (b, h, sq), contiguous: scratch for D
  void* dq;
  void* dk;
  void* dv;
  int b, h, hkv, sq, skv;
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// A probability as the forward's P V saw it: rounded to the input type.
template <typename T>
__device__ __forceinline__ float round_like_input(float p) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16(p));
  return p;
}

// Eight values of a row at p (32 or 16 bytes, aligned), widened to fp32.
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = reinterpret_cast<const float4*>(p)[0];
  b = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a, float4& b) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
  const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
  a = make_float4(f0.x, f0.y, f1.x, f1.y);
  b = make_float4(f2.x, f2.y, f3.x, f3.y);
}

// Rows [row0, row0 + 64) of a (rows, D) slab with row stride `ss` into shared
// memory as fp32 with pitch D + 4; rows at or beyond `valid` become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, long long ss, int row0, int valid,
                                          float* dst) {
  constexpr int CH = D / 8;  // 8-value chunks a row
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NT) {
    const int r = idx / CH;
    const int c = (idx % CH) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < valid) load8(base + (long long)(row0 + r) * ss + c, a, b);
    *reinterpret_cast<float4*>(&dst[r * LD + c]) = a;
    *reinterpret_cast<float4*>(&dst[r * LD + c + 4]) = b;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], A and B with pitch D + 4.
template <int D>
__device__ __forceinline__ void patch_product(const float* A, const float* B, int tx, int ty,
                                              float (&acc)[RP][CP]) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < CP; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RP], bv[CP];
#pragma unroll
    for (int i = 0; i < RP; ++i) av[i] = *reinterpret_cast<const float4*>(&A[(ty + TY * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < CP; ++j) bv[j] = *reinterpret_cast<const float4*>(&B[(tx + TX * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// A thread's columns of a (rows, D) result: 64 jj + 4 tx + e (four at a
// time) when D is a multiple of 64, else tx + 16 j (d 16, the reduced
// configs' head).
template <int D>
__host__ __device__ constexpr bool wide_columns() {
  static_assert(D % TX == 0 && (D % 64 == 0 || D < 64), "head_dim");
  return D % 64 == 0;
}

// out[i][c] += sum_n W[ty + 16 i][n] * X[n][col(c)] over n < 64, W with pitch
// LDP, X with pitch D + 4; col(c) is this thread's c-th column.
template <int D>
__device__ __forceinline__ void patch_accumulate(const float* W, const float* X, int tx, int ty,
                                                 float (&out)[RP][D / TX]) {
  constexpr int LD = D + 4;
  constexpr int DC = D / TX;
#pragma unroll 2
  for (int n = 0; n < 64; n += 4) {
    float4 wv[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) wv[i] = *reinterpret_cast<const float4*>(&W[(ty + TY * i) * LDP + n]);
    if constexpr (!wide_columns<D>()) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float x = X[(n + nn) * LD + tx + TX * j];
#pragma unroll
          for (int i = 0; i < RP; ++i) {
            const float w = nn == 0 ? wv[i].x : nn == 1 ? wv[i].y : nn == 2 ? wv[i].z : wv[i].w;
            out[i][j] = fmaf(w, x, out[i][j]);
          }
        }
      continue;
    }
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
      for (int jj = 0; jj < DC / 4; ++jj) {
        const float4 xv = *reinterpret_cast<const float4*>(&X[(n + nn) * LD + jj * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          const float w = nn == 0 ? wv[i].x : nn == 1 ? wv[i].y : nn == 2 ? wv[i].z : wv[i].w;
          out[i][jj * 4 + 0] = fmaf(w, xv.x, out[i][jj * 4 + 0]);
          out[i][jj * 4 + 1] = fmaf(w, xv.y, out[i][jj * 4 + 1]);
          out[i][jj * 4 + 2] = fmaf(w, xv.z, out[i][jj * 4 + 2]);
          out[i][jj * 4 + 3] = fmaf(w, xv.w, out[i][jj * 4 + 3]);
        }
      }
    }
  }
}

// Rows [row0, row0 + 64) of a thread's patch columns, times `mul`, into a
// (rows, D) slab of T with row stride `ss`; rows at or beyond `valid` skipped.
template <typename T, int D>
__device__ __forceinline__ void store_patch(T* base, long long ss, int row0, int valid, int tx,
                                            int ty, const float (&acc)[RP][D / TX], float mul) {
  constexpr int DC = D / TX;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= valid) continue;
    T* row = base + (long long)r * ss;
    if constexpr (wide_columns<D>()) {
#pragma unroll
      for (int jj = 0; jj < DC / 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          from_float(acc[i][jj * 4 + e] * mul, &row[jj * 64 + tx * 4 + e]);
    } else {
#pragma unroll
      for (int j = 0; j < DC; ++j) from_float(acc[i][j] * mul, &row[tx + TX * j]);
    }
  }
}

// (a) D = rowsum(dO * O) in fp32: one warp a row of (b, h, sq).
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_delta_kernel(BwdParams p) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.b * p.h * p.sq) return;
  const int qi = (int)(row % p.sq);
  const int hi = (int)((row / p.sq) % p.h);
  const int bi = (int)(row / ((long long)p.sq * p.h));
  const T* o = static_cast<const T*>(p.o) + bi * p.o_sb + hi * p.o_sh + qi * p.o_ss;
  const T* g = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh + qi * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(o[c]), to_float(g[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return (int)sizeof(float) * (4 * 64 * (D + 4) + 2 * BN * LDP + 2 * BM);
}

// (b) dK, dV of one 64-key tile of one KV head.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dkdv_kernel(BwdParams p) {
  constexpr int LD = D + 4;
  constexpr int DC = D / TX;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * LD;
  float* Qs = Vs + BN * LD;
  float* Gs = Qs + BM * LD;   // dO
  float* Ps = Gs + BM * LD;   // P^T (keys x queries), rounded like the forward's
  float* Ds = Ps + BN * LDP;  // dS^T
  float* lse_s = Ds + BN * LDP;
  float* del_s = lse_s + BM;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int k0 = blockIdx.x * BN;  // tile 0 first: the most query tiles when causal
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = p.h / p.hkv;

  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  load_tile<T, D>(kb, p.k_ss, k0, p.skv, Ks);
  load_tile<T, D>(vb, p.v_ss, k0, p.skv, Vs);

  float dk[RP][DC], dv[RP][DC];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Causal: query tiles from the one holding row k0 (BM == BN).
  const int qt0 = p.causal ? k0 / BM : 0;
  const int nqt = (p.sq + BM - 1) / BM;
  for (int hh = 0; hh < group; ++hh) {
    const int hi = hk * group + hh;
    const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
    const T* gb = static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh;
    const long long row_base = ((long long)bi * p.h + hi) * p.sq;
    for (int qt = qt0; qt < nqt; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(qb, p.q_ss, q0, p.sq, Qs);
      load_tile<T, D>(gb, p.do_ss, q0, p.sq, Gs);
      if (threadIdx.x < BM) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < p.sq ? p.lse[row_base + r] : 0.f;
        del_s[threadIdx.x] = r < p.sq ? p.delta[row_base + r] : 0.f;
      }
      __syncthreads();

      // Patches over (keys ty + 16 i, queries tx + 16 j).
      float s[RP][CP], dp[RP][CP];
      patch_product<D>(Ks, Qs, tx, ty, s);
      patch_product<D>(Vs, Gs, tx, ty, dp);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const int key = k0 + ty + TY * i;
#pragma unroll
        for (int j = 0; j < CP; ++j) {
          const int qc = tx + TX * j;
          const int qpos = q0 + qc;
          const bool valid = key < p.skv && qpos < p.sq && (!p.causal || key <= qpos);
          const float pr = valid ? expf(s[i][j] * p.scale - lse_s[qc]) : 0.f;
          Ps[(ty + TY * i) * LDP + qc] = round_like_input<T>(pr);
          Ds[(ty + TY * i) * LDP + qc] = pr * (dp[i][j] - del_s[qc]);
        }
      }
      // A row of Ps and Ds is written and read by the same 16 lanes.
      __syncwarp();
      patch_accumulate<D>(Ps, Gs, tx, ty, dv);
      patch_accumulate<D>(Ds, Qs, tx, ty, dk);
    }
  }
  T* dkb = static_cast<T*>(p.dk) + bi * p.dk_sb + hk * p.dk_sh;
  T* dvb = static_cast<T*>(p.dv) + bi * p.dv_sb + hk * p.dv_sh;
  store_patch<T, D>(dkb, p.dk_ss, k0, p.skv, tx, ty, dk, p.scale);
  store_patch<T, D>(dvb, p.dv_ss, k0, p.skv, tx, ty, dv, 1.f);
}

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return (int)sizeof(float) * (4 * 64 * (D + 4) + BM * LDP + 2 * BM);
}

// (c) dQ of one 64-row tile of one query head.
template <typename T, int D>
__global__ void __launch_bounds__(NT) bwd_dq_kernel(BwdParams p) {
  constexpr int LD = D + 4;
  constexpr int DC = D / TX;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + BM * LD;  // dO
  float* Ks = Gs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ds = Vs + BN * LD;  // dS (queries x keys)
  float* lse_s = Ds + BM * LDP;
  float* del_s = lse_s + BM;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest causal rows first
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const long long row_base = ((long long)bi * p.h + hi) * p.sq;

  load_tile<T, D>(static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh, p.q_ss, q0, p.sq, Qs);
  load_tile<T, D>(static_cast<const T*>(p.dout) + bi * p.do_sb + hi * p.do_sh, p.do_ss, q0, p.sq,
                  Gs);
  if (threadIdx.x < BM) {
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < p.sq ? p.lse[row_base + r] : 0.f;
    del_s[threadIdx.x] = r < p.sq ? p.delta[row_base + r] : 0.f;
  }
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  float dq[RP][DC];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  // One past the last key any row of this tile may see.
  const int kv_hi = p.causal ? min(p.skv, min(q0 + BM, p.sq)) : p.skv;
  for (int k0 = 0; k0 < kv_hi; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(kb, p.k_ss, k0, p.skv, Ks);
    load_tile<T, D>(vb, p.v_ss, k0, p.skv, Vs);
    __syncthreads();

    // Patches over (queries ty + 16 i, keys tx + 16 j).
    float s[RP][CP], dp[RP][CP];
    patch_product<D>(Qs, Ks, tx, ty, s);
    patch_product<D>(Gs, Vs, tx, ty, dp);
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      const int qr = ty + TY * i;
      const int qpos = q0 + qr;
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const int key = k0 + tx + TX * j;
        const bool valid = key < p.skv && qpos < p.sq && (!p.causal || key <= qpos);
        const float pr = valid ? expf(s[i][j] * p.scale - lse_s[qr]) : 0.f;
        Ds[qr * LDP + tx + TX * j] = pr * (dp[i][j] - del_s[qr]);
      }
    }
    __syncwarp();  // a row of Ds is written and read by the same 16 lanes
    patch_accumulate<D>(Ds, Ks, tx, ty, dq);
  }
  store_patch<T, D>(static_cast<T*>(p.dq) + bi * p.dq_sb + hi * p.dq_sh, p.dq_ss, q0, p.sq, tx,
                    ty, dq, p.scale);
}

template <typename T, int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.b * p.h * p.sq;
  const long long delta_blocks = (rows + 7) / 8;
  if (delta_blocks > 2147483647LL) return cudaErrorInvalidValue;
  bwd_delta_kernel<T, D><<<(unsigned)delta_blocks, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_kv = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T, D><<<dim3((p.skv + BN - 1) / BN, p.hkv, p.b), NT, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_q = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, D><<<dim3((p.sq + BM - 1) / BM, p.h, p.b), NT, smem_q, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const BwdParams& p, int d, cudaStream_t stream) {
  if (d == 16) return launch<T, 16>(p, stream);
  if (d == 64) return launch<T, 64>(p, stream);
  if (d == 128) return launch<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o, dout, dq: (b, h, sq, d); k, v, dk, dv: (b, hkv, skv, d); strides in
// elements, last dim contiguous, every row 16-byte aligned. lse (the forward's)
// and delta (scratch) are fp32 (b, h, sq), contiguous. dtype: 0 = float32, 1 =
// bfloat16. d: 16, 64 or 128. Three launches on `stream`; returns the CUDA error
// code of the first that failed (0 on success).
extern "C" int repro_flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* delta, void* dq, void* dk, void* dv, int b, int h, int hkv, int sq,
    int skv, int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, long long do_sb, long long do_sh,
    long long do_ss, long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh, long long dv_ss,
    float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0 || h > 65535 ||
      b > 65535 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.b = b; p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
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
