// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (`_flash_kernel`,
// called from `flash_attention_fwd`): softmax(Q K^T / sqrt(d)) V with grouped
// KV heads, causal (top-left aligned, `kpos <= qpos`) or not, online softmax
// with a running maximum `m`, a running denominator `l` and an fp32
// accumulator, probabilities rounded to the input type before P V, and
// `acc / max(l, 1e-30)` at the end. Neither the scores nor the probabilities
// ever reach device memory.
//
// What changed against the TPU kernel, and why:
//  * The TPU grid runs in order and carries m, l and acc in scratch memory
//    across its kv axis. Blocks on this card run in no order, so the kv axis is
//    a loop inside one block and m, l, acc live in registers.
//  * Inputs come by strides (only the last dim is contiguous), so the model
//    hands over its (b, s, h, d) activations and its (b, S, hkv, d) cache as
//    transposed views. Nothing is padded or copied: the ragged edges of q and
//    kv are masked. A query head reads its KV head by index (`h / group`).
//  * Serving needs two per-sequence numbers that the TPU kernel does not have:
//    `kv_len[b]` (keys at or beyond it are masked) and `q_offset[b]` (the causal
//    mask becomes `kpos <= qpos + q_offset[b]`). The kv loop stops at the last
//    key any row of the tile may see, so a decode tick over a long cache reads
//    only the positions that are filled. A row with no visible key gives zeros.
//
// Two kernels, chosen by the number of query rows:
//  * `flash_tile_kernel` (prefill, sq > 8): one block of 256 threads per
//    (batch, head, 64 query rows), kv tiles of 64 keys staged in shared memory
//    as fp32. A thread owns a 4x4 patch of the scores and the same 4 rows of the
//    output, so the softmax statistics stay in its registers and a row reduction
//    is a shuffle over 16 lanes. Bound: operations (2*2*s^2*d per head, half of
//    it when causal). Both products run on the fp32 pipes, which keeps fp32
//    inputs exact but leaves bf16 inputs far below the tensor-core rate: moving
//    the bf16 path to `mma.sync`/`wgmma` is the first step of making this fast.
//  * `flash_row_kernel` (decode, sq <= 8): one block of 32 warps per (batch,
//    head, query row). Bound: bytes, the K and V rows of the filled cache. A
//    decode batch has few rows (72 blocks at 8 sequences x 9 heads), so what
//    limits it is how many loads are in flight: the 32 warps split the keys in
//    chunks of 32, each lane scores one key (a 16-byte-vector dot product
//    against q held in shared memory), the probabilities cross lanes by
//    shuffle, the P V loop has a fixed trip count so that it unrolls, and the
//    partial (m, l, acc) of the warps are merged in shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRowKernelMaxSq = 8;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;    // (b,) or nullptr: every key of skv counts
  const int* q_offset;  // (b,) or nullptr: 0
  int b, h, hkv, sq, skv;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim has stride 1
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
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
  // N consecutive values (N = 2 or 4), N * 4 bytes aligned.
  template <int N>
  __device__ static __forceinline__ void load_few(const float* p, float* out) {
    if (N == 4) {
      float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x; out[1] = v.y;
    }
  }
  __device__ static __forceinline__ float widen(float v) { return v; }
  __device__ static __forceinline__ float round(float v) { return v; }
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
  template <int N>
  __device__ static __forceinline__ void load_few(const __nv_bfloat16* p, float* out) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
  __device__ static __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

__device__ __forceinline__ int seq_kv_len(const Params& p, int bi) {
  return p.kv_len ? min(p.kv_len[bi], p.skv) : p.skv;
}

// ------------------------------------------------------------------------- //
// Prefill: 64 query rows per block.
// ------------------------------------------------------------------------- //

constexpr int BM = 64;  // query rows per block
constexpr int BN = 64;  // keys per kv tile
constexpr int TX = 16;  // threads along keys / output columns
constexpr int TY = 16;  // threads along query rows
constexpr int RM = BM / TY;
constexpr int CN = BN / TX;
constexpr int LDP = BN + 16;  // row pitch of the probabilities (floats)

template <int D>
constexpr int tile_smem_bytes() {
  return (int)sizeof(float) * ((BM + 2 * BN) * (D + 4) + BM * LDP);
}

// Rows [row0, row0 + 64) of a (rows, D) slab with row stride `ss` into shared
// memory as fp32 with pitch D + 4; rows at or beyond `valid_rows` become zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* base, long long ss, int row0, int valid_rows,
                                          float* dst) {
  constexpr int PER = Pack<T>::PER;
  constexpr int CHUNKS = D / PER;
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += TX * TY) {
    const int r = idx / CHUNKS;
    const int c = (idx % CHUNKS) * PER;
    float vals[PER];
    if (row0 + r < valid_rows) {
      Pack<T>::load(base + (long long)(row0 + r) * ss + c, vals);
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

template <typename T, int D>
__global__ void __launch_bounds__(TX * TY) flash_tile_kernel(Params p) {
  constexpr int LD = D + 4;    // row pitch of Q, K, V tiles (floats), keeps float4 alignment
  constexpr int DC = D / TX;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * LD;
  float* Vs = Ks + BN * LD;
  float* Ps = Vs + BN * LD;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BM;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const int kvlen = seq_kv_len(p, bi);
  const int off = p.q_offset ? p.q_offset[bi] : 0;
  // One past the last key that any row of this tile may see.
  int kv_hi = kvlen;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + BM, p.sq) + off);

  const T* qb = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;
  T* ob = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh;

  load_tile<T, D>(qb, p.q_ss, q0, p.sq, Qs);

  float m[RM], l[RM], acc[RM][DC];
  int lim[RM];  // one past the last key row i may see
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    lim[i] = p.causal ? min(kvlen, q0 + ty + TY * i + off + 1) : kvlen;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_hi; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done with Ks, Vs, Ps
    load_tile<T, D>(kb, p.k_ss, k0, kvlen, Ks);
    load_tile<T, D>(vb, p.v_ss, k0, kvlen, Vs);
    __syncthreads();

    // S = Q K^T for this thread's 4x4 patch: rows ty + 16 i, keys tx + 16 j.
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + TY * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + TX * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax. The 16 threads of one row are 16 neighbouring lanes.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool valid[CN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        valid[j] = (k0 + tx + TX * j) < lim[i];
        s[i][j] = valid[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float pe = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        rowsum += pe;
        Ps[(ty + TY * i) * LDP + tx + TX * j] = Pack<T>::round(pe);
      }
#pragma unroll
      for (int o = TX / 2; o > 0; o >>= 1) rowsum += __shfl_xor_sync(0xffffffffu, rowsum, o);
      l[i] = l[i] * alpha + rowsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    // A row of Ps is written and read by the same 16 lanes of one warp.
    __syncwarp();

    // acc += P V: rows ty + 16 i, columns 64 jj + 4 tx .. + 3.
#pragma unroll 2
    for (int c = 0; c < BN; c += 4) {
      float4 pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + TY * i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < DC / 4; ++jj) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[(c + cc) * LD + jj * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float pe = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][jj * 4 + 0] = fmaf(pe, vv.x, acc[i][jj * 4 + 0]);
            acc[i][jj * 4 + 1] = fmaf(pe, vv.y, acc[i][jj * 4 + 1]);
            acc[i][jj * 4 + 2] = fmaf(pe, vv.z, acc[i][jj * 4 + 2]);
            acc[i][jj * 4 + 3] = fmaf(pe, vv.w, acc[i][jj * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty + TY * i;
    if (qpos >= p.sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* orow = ob + (long long)qpos * p.o_ss;
#pragma unroll
    for (int jj = 0; jj < DC / 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Pack<T>::store(&orow[jj * 64 + tx * 4 + e], acc[i][jj * 4 + e] * inv);
  }
}

// ------------------------------------------------------------------------- //
// Decode: one query row per block, the keys split over its warps.
// ------------------------------------------------------------------------- //

constexpr int NW = 32;  // warps per block: the kv positions in flight per query row

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32) flash_row_kernel(Params p) {
  constexpr int PER = Pack<T>::PER;
  constexpr int DL = D / 32;  // output columns per lane
  __shared__ __align__(16) float qs[D];
  __shared__ float red_m[NW];
  __shared__ float red_l[NW];
  __shared__ float red_acc[NW][D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x;
  const int hi = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hi / (p.h / p.hkv);
  const int off = p.q_offset ? p.q_offset[bi] : 0;
  int limit = seq_kv_len(p, bi);  // one past the last key this row may see
  if (p.causal) limit = min(limit, qi + off + 1);

  const T* qr = static_cast<const T*>(p.q) + bi * p.q_sb + hi * p.q_sh + (long long)qi * p.q_ss;
  const T* kb = static_cast<const T*>(p.k) + bi * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + bi * p.v_sb + hk * p.v_sh;

  for (int d = threadIdx.x; d < D; d += NW * 32) qs[d] = Pack<T>::widen(qr[d]);
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[DL];
#pragma unroll
  for (int e = 0; e < DL; ++e) acc[e] = 0.f;

  for (int k0 = warp * 32; k0 < limit; k0 += NW * 32) {
    const int kpos = k0 + lane;
    const bool valid = kpos < limit;
    float s = kNegInf;
    if (valid) {
      const T* kr = kb + (long long)kpos * p.k_ss;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += PER) {
        float kf[PER];
        Pack<T>::load(kr + c, kf);
#pragma unroll
        for (int e = 0; e < PER; ++e) dot = fmaf(qs[c + e], kf[e], dot);
      }
      s = dot * p.scale;
    }
    float mx = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    const float pe = valid ? expf(s - m_new) : 0.f;
    float psum = pe;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    const float pr = Pack<T>::round(pe);
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[e] *= alpha;

    // All 32 keys of the chunk with a fixed trip count, so the loop unrolls
    // and its V loads are in flight together. A key at or beyond `limit` has
    // probability 0 and reads the last visible row again, which is in range.
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pr, j);
      const int row = min(k0 + j, limit - 1);
      const T* vr = vb + (long long)row * p.v_ss + lane * DL;
      float vf[DL];
      Pack<T>::template load_few<DL>(vr, vf);
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[e] = fmaf(pj, vf[e], acc[e]);
    }
  }

  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < DL; ++e) red_acc[warp][lane * DL + e] = acc[e];
  __syncthreads();

  if (warp == 0) {
    float big = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) big = fmaxf(big, red_m[w]);
    float total = 0.f, o[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(red_m[w] - big);
      total += red_l[w] * sc;
#pragma unroll
      for (int e = 0; e < DL; ++e) o[e] = fmaf(red_acc[w][lane * DL + e], sc, o[e]);
    }
    const float inv = 1.0f / fmaxf(total, 1e-30f);
    T* orow = static_cast<T*>(p.o) + bi * p.o_sb + hi * p.o_sh + (long long)qi * p.o_ss;
#pragma unroll
    for (int e = 0; e < DL; ++e) Pack<T>::store(&orow[lane * DL + e], o[e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.sq <= kRowKernelMaxSq) {
    dim3 grid(p.sq, p.h, p.b);
    flash_row_kernel<T, D><<<grid, NW * 32, 0, stream>>>(p);
    return cudaGetLastError();
  }
  constexpr int smem = tile_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_tile_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + BM - 1) / BM, p.h, p.b);
  flash_tile_kernel<T, D><<<grid, TX * TY, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  if (d == 64) return launch<T, 64>(p, stream);
  if (d == 128) return launch<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (b, h, sq, d); k, v: (b, hkv, skv, d); strides in elements, last dim
// contiguous, every row 16-byte aligned. kv_len and q_offset are int32 (b,) on
// the device or null. dtype: 0 = float32, 1 = bfloat16. d: 64 or 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, const void* kv_len,
    const void* q_offset, int b, int h, int hkv, int sq, int skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, float scale, int causal, int dtype, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || sq <= 0 || skv <= 0 || h % hkv != 0 || h > 65535 ||
      b > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.kv_len = static_cast<const int*>(kv_len);
  p.q_offset = static_cast<const int*>(q_offset);
  p.b = b; p.h = h; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(p, d, s);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(p, d, s);
  return (int)cudaErrorInvalidValue;
}
