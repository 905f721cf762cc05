// The warp step of the attention kernels that run on `mma.sync`: the fp32
// forward (flash_attention.cu, `flash_tf32_kernel`) and the backward
// (flash_attention_backward.cu), with the staging of their tiles. bf16
// operands go to `m16n8k16` through `ldmatrix`; fp32 operands are split into
// TF32 hi and lo and go to `m16n8k8` as 3xTF32 (mma.cuh). Each source
// includes this header; the library's build hashes it with the sources
// (`_build._source_digest`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

// The n-tiles a pass of `warp_accumulate`'s fp32 route sums at once: the
// largest divisor of the n-tiles that is at most 8 (8 at d 64 and 128, 5 at
// d 160's twenty).
__host__ __device__ constexpr int n_tiles_a_pass(int n) {
  int c = n < 8 ? n : 8;
  while (n % c) --c;
  return c;
}

// Rows of a streamed tile (keys for the forward and dQ, queries for dK/dV).
template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D == 128 ? 32 : 64;
}

// Stages of the backward's rings: one for fp32 at d 128, else two.
template <typename T, int D>
__host__ __device__ constexpr int ring_stages() {
  return sizeof(T) == 4 && D == 128 ? 1 : 2;
}

// Row pitch in shared memory, in elements: 16 bytes of padding, which puts
// the fragment loads of a warp (and the eight rows of an `ldmatrix` phase) on
// distinct banks.
template <typename T, int D>
__host__ __device__ constexpr int pitch() {
  return D + 16 / (int)sizeof(T);
}

// Two neighbouring values of a row, rounded once.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Rows [row0, row0 + ROWS) of a (rows, D) slab with row stride `ss` into
// shared memory with pitch `pitch<T, D>()`, by 16-byte cp.async from NT
// threads (`t` is this thread's index among them); rows at or beyond `valid`
// become zeros. The caller commits.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(const T* base, long long ss, int row0, int valid,
                                           T* dst, int t) {
  constexpr int PER = 16 / (int)sizeof(T);  // values a chunk
  constexpr int CH = D / PER;               // chunks a row
  constexpr int LD = pitch<T, D>();
  constexpr int N = (ROWS * CH + NT - 1) / NT;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = t + i * NT;
    if (ROWS * CH % NT != 0 && idx >= ROWS * CH) break;  // fewer chunks than threads
    const int r = idx / CH;
    const int c = (idx % CH) * PER;
    const bool in = row0 + r < valid;
    cp_async16(dst + r * LD + c, in ? base + (long long)(row0 + r) * ss + c : base, in);
  }
}

// Four fp32 fragment registers, split into TF32 parts.
__device__ __forceinline__ void split_tf32x4(const uint32_t (&v)[4], uint32_t (&h)[4],
                                             uint32_t (&l)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(v[e]), h[e], l[e]);
}

// k-step kk of the A operand (16 rows x 8 of a fp32 tile in shared memory,
// pitch `pitch<float, D>()`), split into TF32 parts. `ldmatrix` moves 16-bit
// pairs, so on fp32 rows of 4 values lane (g, t) gets row g's value t, the
// layout of a TF32 fragment: one `ldmatrix.x4` loads what four scalar loads
// would.
template <int D>
__device__ __forceinline__ void tf32_a_fragment(const float* A, int kk, int lane,
                                                uint32_t (&ah)[4], uint32_t (&al)[4]) {
  constexpr int LD = pitch<float, D>();
  uint32_t a[4];
  ldmatrix_x4(a, A + (lane & 15) * LD + kk * 8 + (lane >> 4) * 4);
  split_tf32x4(a, ah, al);
}

// c[n] += A B_n^T for n < NC: A the warp's 16 rows of a tile, B_n rows
// [8 n, 8 n + 8) of another, both (rows, D) in shared memory. c in mma
// accumulator layout: this lane holds rows g and g + 8 (g = lane / 4) and
// columns 2 t, 2 t + 1 (t = lane % 4) of each 8-column n-tile. `af`, where
// given, holds A's fragments in registers instead: bf16, af[kk] of k-step
// kk; fp32, its TF32 parts af[2 kk] (hi) and af[2 kk + 1] (lo).
template <typename T, int D, int NC>
__device__ __forceinline__ void warp_scores(float (&c)[NC][4], const T* A, const T* B, int lane,
                                            const uint32_t (*af)[4] = nullptr) {
  constexpr int LD = pitch<T, D>();
  static_assert(NC % 2 == 0, "n-tiles come in pairs");
  if constexpr (kBf16<T>) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if (af) {
        a[0] = af[kk][0]; a[1] = af[kk][1]; a[2] = af[kk][2]; a[3] = af[kk][3];
      } else {
        ldmatrix_x4(a, A + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(c[2 * np], a, b[0], b[1]);
        mma_bf16(c[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      if (af) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = af[2 * kk][e];
          al[e] = af[2 * kk + 1][e];
        }
      } else {
        tf32_a_fragment<D>(A, kk, lane, ah, al);
      }
#pragma unroll
      for (int np = 0; np < NC / 2; ++np) {
        // n-tile 2 np: registers 0, 1; n-tile 2 np + 1: registers 2, 3.
        uint32_t b[4], bh[4], bl[4];
        ldmatrix_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 8 +
                           ((lane >> 3) & 1) * 4);
        split_tf32x4(b, bh, bl);
        const uint32_t h0[2] = {bh[0], bh[1]}, l0[2] = {bl[0], bl[1]};
        const uint32_t h1[2] = {bh[2], bh[3]}, l1[2] = {bl[2], bl[3]};
        mma_3xtf32(c[2 * np], ah, al, h0, l0);
        mma_3xtf32(c[2 * np + 1], ah, al, h1, l1);
      }
    }
  }
}

// acc += W B: W the warp's 16 rows x 8 NC columns as accumulator fragments
// (w[j]: columns [8 j, 8 j + 8)), rounded to bf16 or split into TF32 parts on
// the way into the A operand; B a (8 NC, D) tile in shared memory, taken
// along its rows; acc (16, D) in accumulator layout.
template <typename T, int D, int NC>
__device__ __forceinline__ void warp_accumulate(float (&acc)[D / 8][4], const float (&w)[NC][4],
                                                const T* B, int lane) {
  constexpr int LD = pitch<T, D>();
  if constexpr (kBf16<T>) {
    // k-step kk: W's n-tiles 2 kk (registers 0, 1) and 2 kk + 1 (2, 3).
#pragma unroll
    for (int kk = 0; kk < NC / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(w[2 * kk][0], w[2 * kk][1]),
                             pack_bf16(w[2 * kk][2], w[2 * kk][3]),
                             pack_bf16(w[2 * kk + 1][0], w[2 * kk + 1][1]),
                             pack_bf16(w[2 * kk + 1][2], w[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, B + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  } else {
    // k-step j: W's columns 8 j + 2 t as k = t and 8 j + 2 t + 1 as k = t + 4,
    // B's rows in the same order. The tile's sum goes into a fresh fragment,
    // CH n-tiles at a time, and then into acc by fp32 adds: the tensor
    // cores' accumulation rounds toward zero, which over the ~2,300 mma steps
    // of a long sum (dK at the train_lm layer) drifts 6e-5 of the largest
    // gradient, where one tile's 3 NC steps stay near fp32.
    constexpr int CH = n_tiles_a_pass(D / 8);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c0 = 0; c0 < D / 8; c0 += CH) {
      float tile[CH][4];
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        uint32_t ah[4], al[4];
        split_tf32(w[j][0], ah[0], al[0]);
        split_tf32(w[j][2], ah[1], al[1]);
        split_tf32(w[j][1], ah[2], al[2]);
        split_tf32(w[j][3], ah[3], al[3]);
        const float* br = B + (j * 8 + 2 * t) * LD + c0 * 8 + g;
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          uint32_t bh[2], bl[2];
          split_tf32(br[n * 8], bh[0], bl[0]);
          split_tf32(br[LD + n * 8], bh[1], bl[1]);
          mma_3xtf32(tile[n], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c0 + n][e] += tile[n][e];
    }
  }
}

// A warp's (16, D) accumulator, times `mul`, into rows [row0, row0 + 16) of
// a (rows, D) slab with row stride `ss`; rows at or beyond `valid` skipped.
template <typename OUT, int D>
__device__ __forceinline__ void store_rows(OUT* base, long long ss, int row0, int valid,
                                           const float (&acc)[D / 8][4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= valid) continue;
    OUT* row = base + (long long)r * ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(row + n * 8, acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
  }
}

}  // namespace
