// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (`_ssd_kernel`, called
// from `ssd_scan`). Per chunk of Q positions, with dA = dt * A (A < 0, dt >= 0)
// and cs its inclusive cumsum inside the chunk:
//
//   y_i = sum_{j <= i} exp(cs_i - cs_j) (C_i . B_j) dt_j x_j  +  exp(cs_i) C_i S^T
//   S  <- S exp(cs_last) + sum_j (dt_j exp(cs_last - cs_j) x_j)^T B_j
//
// in fp32 from inputs of the caller's type, y rounded to that type, the final
// state S (p x n per head) in fp32. Positions past `s` act as dt = 0.
//
// What changed against the TPU kernel, and why:
//  * The TPU grid runs (b, h, chunk) in order and carries S in VMEM scratch.
//    Blocks on this card run in no order, so one block owns a (batch, head,
//    p-tile) and loops over the chunks itself, with S resident in shared memory
//    (stored transposed, St[n][p]). Each chunk computes y from the old S, then
//    updates S; barriers keep the two apart.
//  * The TPU tile holds the whole chunk: Q x n tiles of B and C and the Q x Q
//    matrix (C B^T) o L. At Q = 256, n = 128 those are 128 KB, 128 KB and
//    256 KB, more than a block's 227 KB of shared memory. The within-chunk term
//    is causal "attention" with score exp(cs_i - cs_j) (C_i . B_j) and no
//    softmax, so it is tiled as `flash_tile_kernel` in flash_attention.cu tiles
//    attention: 64 query rows at a time, key tiles of 64 with j <= i only, the
//    score matrix never written out. The off-diagonal term and the state update
//    go tile by tile over the same staged rows.
//  * The TPU kernel takes exp over the whole Q x Q square and masks it after.
//    Here exp(cs_i - cs_j) is taken only for j <= i, where the exponent is <= 0
//    (A < 0, dt >= 0), so no exp overflows and no inf * 0 makes a NaN.
//  * The in-chunk cumsum is a block scan (warp shuffles, then the warps' sums),
//    kept in shared memory with dt.
//  * Layout is the model's: x (b, s, h, p), dt (b, s, h), B and C (b, s, g, n)
//    taken by strides, so the model hands over views of its conv output. A head
//    reads its group's B and C by index (`h / (h / g)`), never by a repeat.
//
// Bound: at the main prefill (b 1, s 1024, h 48, p 64, n 128, Q 256) the bytes
// (x, y, B, C, dt once and the state) take ~4 us at 3.35 TB/s and the
// operations ~2.5 us at the bf16 tensor-core rate, so the card's bound is
// bytes. This first kernel runs every product as fp32 FMAs on the CUDA cores
// (exact for fp32 inputs, far below the tensor-core rate for bf16), and each
// head recomputes C B^T although with one group it is the same for all heads:
// sharing it across the heads of a group, and `mma.sync`/`wgmma`, are the
// obvious later gains. Occupancy: a prefill has b * h = 48 (batch, head) pairs
// for 132 SMs; the p-tile (a launch argument, 16, 32 or 64 columns of p) trades
// more blocks against recomputing C B^T once per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int TX = 16;        // threads along keys / p columns
constexpr int TY = 16;        // threads along query rows / n rows
constexpr int BM = 64;        // query rows (positions i) per row tile
constexpr int BN = 64;        // keys (positions j) per key tile
constexpr int RM = BM / TY;   // query rows per thread
constexpr int CN = BN / TX;   // keys per thread
constexpr int LDP = BN + 4;   // row pitch of the score tile (floats)
constexpr int kMaxChunk = 1024;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  int b, s, h, p, g, chunk;
  long long x_sb, x_ss, x_sh;  // strides in elements; the last dim has stride 1
  long long dt_sb, dt_ss, dt_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long y_sb, y_ss, y_sh;
};

// 16 bytes of T, read as one vector and widened to fp32.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int PER = 4;
  __device__ static __forceinline__ void load(const float* p, float* out) {
    float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int PER = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float* out) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// Rows [0, 64) of a slab of W columns (row stride `ss`) into shared memory as
// fp32 with pitch W + 4. Rows at or beyond `rows` and columns at or beyond
// `cols` become zeros; row r is multiplied by scale[r] if `scale` is given.
template <typename T, int W>
__device__ __forceinline__ void load_rows(const T* base, long long ss, int rows, int cols,
                                          const float* scale, float* dst) {
  constexpr int PER = Pack<T>::PER;
  constexpr int CHUNKS = W / PER;
  constexpr int LD = W + 4;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += NT) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * PER;
    float vals[PER];
    if (r < rows && c < cols) {
      Pack<T>::load(base + (long long)r * ss + c, vals);
      if (scale) {
        const float f = scale[r];
#pragma unroll
        for (int e = 0; e < PER; ++e) vals[e] *= f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < PER; e += 4)
      *reinterpret_cast<float4*>(&dst[r * LD + c + e]) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

// CP consecutive floats of shared memory (CP = 1, 2 or 4, aligned to CP).
template <int CP>
__device__ __forceinline__ void load_cols(const float* src, float* out) {
  if constexpr (CP == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (CP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = src[0];
  }
}

// dt of the chunk's Q positions (0 past the valid `qv`) into dt_s, and the
// inclusive cumsum of dt * a into cs_s. `red` holds NT / 32 floats. Ends with
// a barrier.
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

template <int N, int PT>
constexpr int fixed_smem_floats() {
  return BM * (N + 4) + BN * (N + 4) + BN * (PT + 4) + BM * LDP + N * (PT + 4) + NT / 32;
}

template <typename T, int N, int PT>
__global__ void __launch_bounds__(NT) ssd_chunk_kernel(Params p) {
  constexpr int CP = PT / TX;  // p columns per thread
  constexpr int NK = N / TY;   // state rows (n) per thread in the update
  constexpr int LDN = N + 4;
  constexpr int LDX = PT + 4;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;             // BM x LDN: C of the row tile
  float* Bs = Cs + BM * LDN;    // BN x LDN: B of the key tile
  float* Xs = Bs + BN * LDN;    // BN x LDX: x * dt (* decay) of the key tile
  float* Ps = Xs + BN * LDX;    // BM x LDP: masked, decayed scores
  float* St = Ps + BM * LDP;    // N x LDX: the carried state, St[nn][pp]
  float* red = St + N * LDX;    // NT / 32: the scan's warp sums
  float* dt_s = red + NT / 32;  // Q
  float* cs_s = dt_s + p.chunk; // Q

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int p0 = blockIdx.x * PT;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int gi = hi / (p.h / p.g);
  const int Q = p.chunk;
  const int nc = (p.s + Q - 1) / Q;
  const int pv = p.p - p0;  // valid p columns of this tile
  const float a = p.A[hi];

  const T* xb = static_cast<const T*>(p.x) + bi * p.x_sb + hi * p.x_sh + p0;
  const float* dtb = p.dt + bi * p.dt_sb + hi * p.dt_sh;
  const T* Bb = static_cast<const T*>(p.B) + bi * p.B_sb + gi * p.B_sg;
  const T* Cb = static_cast<const T*>(p.C) + bi * p.C_sb + gi * p.C_sg;
  T* yb = static_cast<T*>(p.y) + bi * p.y_sb + hi * p.y_sh + p0;

  for (int idx = threadIdx.x; idx < N * LDX; idx += NT) St[idx] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * Q;
    const int qv = min(Q, p.s - t0);  // positions of this chunk inside the sequence
    __syncthreads();  // the previous chunk's update of St is complete
    chunk_cumsum(dtb + (long long)t0 * p.dt_ss, p.dt_ss, Q, qv, a, dt_s, cs_s, red);

    // ---- y from the old state, one row tile at a time ---------------------- //
    for (int i0 = 0; i0 < qv; i0 += BM) {
      load_rows<T, N>(Cb + (long long)(t0 + i0) * p.C_ss, p.C_ss, min(BM, qv - i0), N, nullptr,
                      Cs);
      __syncthreads();

      float csr[RM], acc[RM][CP];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = i0 + ty + TY * i;
        csr[i] = row < qv ? cs_s[row] : 0.f;
#pragma unroll
        for (int e = 0; e < CP; ++e) acc[i][e] = 0.f;
      }
      // Off-diagonal: exp(cs_i) * C_i . S^T (S is zero before the first chunk).
      if (c > 0) {
#pragma unroll 2
        for (int nn = 0; nn < N; nn += 4) {
          float4 cv[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + TY * i) * LDN + nn]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float sv[CP];
            load_cols<CP>(&St[(nn + cc) * LDX + tx * CP], sv);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float cf = cc == 0 ? cv[i].x : cc == 1 ? cv[i].y : cc == 2 ? cv[i].z : cv[i].w;
#pragma unroll
              for (int e = 0; e < CP; ++e) acc[i][e] = fmaf(cf, sv[e], acc[i][e]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float dec = expf(csr[i]);
#pragma unroll
          for (int e = 0; e < CP; ++e) acc[i][e] *= dec;
        }
      }

      // Diagonal: key tiles up to the tile's last valid row.
      const int last_row = min(i0 + BM, qv) - 1;
      for (int j0 = 0; j0 <= last_row; j0 += BN) {
        __syncthreads();  // the previous key tile's readers are done
        const int kv = min(BN, qv - j0);
        load_rows<T, N>(Bb + (long long)(t0 + j0) * p.B_ss, p.B_ss, kv, N, nullptr, Bs);
        load_rows<T, PT>(xb + (long long)(t0 + j0) * p.x_ss, p.x_ss, kv, pv, dt_s + j0, Xs);
        __syncthreads();

        float sc[RM][CN];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < N; d += 4) {
          float4 cv[RM], bv[CN];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + TY * i) * LDN + d]);
#pragma unroll
          for (int j = 0; j < CN; ++j)
            bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + TX * j) * LDN + d]);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < CN; ++j) {
              sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
              sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
              sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
              sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
            }
        }
        // Decay and causal mask; exp only where j <= i (exponent <= 0).
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = i0 + ty + TY * i;
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            const int key = j0 + tx + TX * j;
            const float pe = (key <= row && row < qv) ? sc[i][j] * expf(csr[i] - cs_s[key]) : 0.f;
            Ps[(ty + TY * i) * LDP + tx + TX * j] = pe;
          }
        }
        // A row of Ps is written and read by the same 16 lanes of one warp.
        __syncwarp();

#pragma unroll 2
        for (int k = 0; k < BN; k += 4) {
          float4 pr[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            pr[i] = *reinterpret_cast<const float4*>(&Ps[(ty + TY * i) * LDP + k]);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            float xv[CP];
            load_cols<CP>(&Xs[(k + cc) * LDX + tx * CP], xv);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
              const float pf = cc == 0 ? pr[i].x : cc == 1 ? pr[i].y : cc == 2 ? pr[i].z : pr[i].w;
#pragma unroll
              for (int e = 0; e < CP; ++e) acc[i][e] = fmaf(pf, xv[e], acc[i][e]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int row = i0 + ty + TY * i;
        if (row >= qv) continue;
        T* yrow = yb + (long long)(t0 + row) * p.y_ss;
#pragma unroll
        for (int e = 0; e < CP; ++e) {
          const int col = tx * CP + e;
          if (col < pv) Pack<T>::store(&yrow[col], acc[i][e]);
        }
      }
      __syncthreads();  // Cs, Bs, Xs, Ps are free for the next row tile
    }

    // ---- state update: S exp(cs_last) + sum_j (w_j x_j)^T B_j --------------- //
    const float cs_last = cs_s[qv - 1];  // positions past qv add dA = 0
    for (int i = threadIdx.x; i < qv; i += NT) dt_s[i] *= expf(cs_last - cs_s[i]);
    const float total = expf(cs_last);
    float sacc[NK][CP];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      float sv[CP];
      load_cols<CP>(&St[(ty + TY * k) * LDX + tx * CP], sv);
#pragma unroll
      for (int e = 0; e < CP; ++e) sacc[k][e] = sv[e] * total;
    }
    for (int j0 = 0; j0 < qv; j0 += BN) {
      __syncthreads();  // dt_s holds the weights; the previous key tile is consumed
      const int kv = min(BN, qv - j0);
      load_rows<T, N>(Bb + (long long)(t0 + j0) * p.B_ss, p.B_ss, kv, N, nullptr, Bs);
      load_rows<T, PT>(xb + (long long)(t0 + j0) * p.x_ss, p.x_ss, kv, pv, dt_s + j0, Xs);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kv; ++j) {
        float xv[CP];
        load_cols<CP>(&Xs[j * LDX + tx * CP], xv);
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float bf = Bs[j * LDN + ty + TY * k];
#pragma unroll
          for (int e = 0; e < CP; ++e) sacc[k][e] = fmaf(bf, xv[e], sacc[k][e]);
        }
      }
    }
    // Each thread writes back the entries it alone read: no other thread
    // touches them until the barrier at the top of the next chunk.
#pragma unroll
    for (int k = 0; k < NK; ++k)
#pragma unroll
      for (int e = 0; e < CP; ++e) St[(ty + TY * k) * LDX + tx * CP + e] = sacc[k][e];
  }
  __syncthreads();

  // Final state (b, h, p, n), fp32: state[pp][nn] = St[nn][pp].
  float* sb = p.state + ((long long)bi * p.h + hi) * (long long)p.p * N;
  for (int idx = threadIdx.x; idx < PT * N; idx += NT) {
    const int pp = idx / N;
    const int nn = idx % N;
    if (pp < pv) sb[(long long)(p0 + pp) * N + nn] = St[nn * LDX + pp];
  }
}

template <typename T, int N, int PT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * (fixed_smem_floats<N, PT>() + 2 * p.chunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<T, N, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.p + PT - 1) / PT, p.h, p.b);
  ssd_chunk_kernel<T, N, PT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_pt(const Params& p, int p_tile, cudaStream_t stream) {
  if (p_tile == 16) return launch<T, N, 16>(p, stream);
  if (p_tile == 32) return launch<T, N, 32>(p, stream);
  if (p_tile == 64) return launch<T, N, 64>(p, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_n(const Params& p, int n, int p_tile, cudaStream_t stream) {
  if (n == 16) return launch_pt<T, 16>(p, p_tile, stream);
  if (n == 32) return launch_pt<T, 32>(p, p_tile, stream);
  if (n == 64) return launch_pt<T, 64>(p, p_tile, stream);
  if (n == 128) return launch_pt<T, 128>(p, p_tile, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (b, s, h, p), B and C: (b, s, g, n) of `dtype` (0 = float32, 1 =
// bfloat16); dt: (b, s, h) and A: (h,) float32; strides in elements, last dims
// contiguous, rows of x, B and C 16-byte aligned. y: (b, s, h, p) of `dtype`
// (strides given); state: (b, h, p, n) float32, contiguous. chunk: positions per
// chunk (<= 1024); p_tile: 16, 32 or 64 columns of p per block; n: 16, 32, 64
// or 128. Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, void* y, void* state, int b, int s, int h, int p,
                              int g, int n, int chunk, int p_tile, long long x_sb, long long x_ss,
                              long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
                              long long B_sb, long long B_ss, long long B_sg, long long C_sb,
                              long long C_ss, long long C_sg, long long y_sb, long long y_ss,
                              long long y_sh, int dtype, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || g <= 0 || h % g != 0 || chunk <= 0 ||
      chunk > kMaxChunk || b > 65535 || h > 65535)
    return (int)cudaErrorInvalidValue;
  Params prm;
  prm.x = x; prm.dt = static_cast<const float*>(dt); prm.A = static_cast<const float*>(A);
  prm.B = B; prm.C = C; prm.y = y; prm.state = static_cast<float*>(state);
  prm.b = b; prm.s = s; prm.h = h; prm.p = p; prm.g = g; prm.chunk = chunk;
  prm.x_sb = x_sb; prm.x_ss = x_ss; prm.x_sh = x_sh;
  prm.dt_sb = dt_sb; prm.dt_ss = dt_ss; prm.dt_sh = dt_sh;
  prm.B_sb = B_sb; prm.B_ss = B_ss; prm.B_sg = B_sg;
  prm.C_sb = C_sb; prm.C_ss = C_ss; prm.C_sg = C_sg;
  prm.y_sb = y_sb; prm.y_ss = y_ss; prm.y_sh = y_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_n<float>(prm, n, p_tile, st);
  if (dtype == 1) return (int)launch_n<__nv_bfloat16>(prm, n, p_tile, st);
  return (int)cudaErrorInvalidValue;
}
