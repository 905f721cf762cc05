// Pooled (sum) embedding-bag lookup, forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel src/repro/kernels/embedding_bag.py
// (`_bag_kernel`, called from `embedding_bag`): out[b, t, :] = sum over l of
// tables[t, idx[b, t, l], :], summed in fp32 and rounded once into the table's
// type. Backward (the Pallas kernel has none; the gradient of the DLRM flows
// through this lookup): dtables[t, idx[b, t, l], :] += dout[b, t, :], a dense
// (T, R, E) result, because the reference's gradient is dense and its AdamW
// decays and moves every row.
//
// Index semantics, those of the JAX package's jnp gather and its gradient:
// a negative index wraps by +R; in the forward an index still outside [0, R)
// is clamped into it; in the backward it is dropped. No read or write leaves
// the table in either kernel.
//
// Bound on this card: bytes. Each looked-up row is read (forward) or added to
// (backward) once per lookup with one floating-point operation per element,
// far below the ~295 operations per byte at which an H100 turns compute-bound.
// At the DLRM training step's shape (batch 4096, 64 tables of 200,000 x 128
// fp32, 32 lookups a bag) the forward gathers 4.29 GB, 3.15 GB of it distinct
// rows, and the backward writes a 6.55 GB dense gradient.
// The rows lie at random in a table of gigabytes, so the design is about
// keeping enough independent row reads in flight: one warp owns one bag
// (b, t); its lanes load the bag's indices once (32 at a time) and pass them
// on by shuffle, so each lookup is one 16-byte load per lane and the whole
// warp reads one row of up to 512 bytes (E 128 in fp32: 32 lanes x float4).
// The sum stays in registers. The TPU kernel's grid of (sample, table) DMA row
// fetches becomes this warp loop; nothing carries between blocks. Rows that
// are not a whole number of 16-byte packs take a scalar path, one element a
// lane. The backward reads dout[b, t, :] once into registers and adds it into
// each looked-up row with fp32 atomics (float4 atomics on the vector path),
// into the output itself for fp32 tables and into fp32 scratch, rounded once
// afterwards, for bf16 tables. The order of the atomics changes from run to
// run; a sort-by-row, segmented-sum design would make it deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kConvertThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// The row lane `lane` holds for lookups l0 .. l0 + 31 of one bag: wrapped, and
// clamped (forward) or -1 for a dropped index (backward).
template <bool CLAMP>
__device__ __forceinline__ int bag_row(const int* bag_idx, long long st_l, int l, int L, int R) {
  if (l >= L) return -1;
  int r = bag_idx[(long long)l * st_l];
  if (r < 0) r += R;
  if (CLAMP) return min(max(r, 0), R - 1);
  return (r >= 0 && r < R) ? r : -1;
}

// One warp per bag. VEC: each lane reads 16 bytes of a row at a time.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_forward_kernel(const T* __restrict__ tables, const int* __restrict__ idx, T* __restrict__ out,
                   int B, int nT, int L, int R, int E, long long tab_st_t, long long tab_st_r,
                   long long idx_st_b, long long idx_st_t, long long idx_st_l) {
  constexpr int PER = VEC ? 16 / (int)sizeof(T) : 1;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= (long long)B * nT) return;  // whole warps leave; no block barrier below
  const long long b = bag / nT, t = bag % nT;
  const int* bag_idx = idx + b * idx_st_b + t * idx_st_t;
  const T* table = tables + t * tab_st_t;
  T* out_row = out + bag * E;

  for (int c0 = 0; c0 < E; c0 += 32 * PER) {
    const int col = c0 + lane * PER;
    const bool active = col < E;
    float acc[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[k] = 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int my_row = bag_row<true>(bag_idx, idx_st_l, l0 + lane, L, R);
      const int n = min(32, L - l0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int row = __shfl_sync(0xffffffffu, my_row, j);
        if (active) {
          const T* src = table + (long long)row * tab_st_r + col;
          if constexpr (VEC) {
            const uint4 raw = *reinterpret_cast<const uint4*>(src);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int k = 0; k < PER; ++k) acc[k] += to_float(e[k]);
          } else {
            acc[0] += to_float(*src);
          }
        }
      }
    }
    if (active) {
      if constexpr (VEC) {
        uint4 res;
        T* r = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int k = 0; k < PER; ++k) from_float(acc[k], &r[k]);
        *reinterpret_cast<uint4*>(out_row + col) = res;
      } else {
        from_float(acc[0], &out_row[col]);
      }
    }
  }
}

// One warp per bag: dout[b, t, :] into every looked-up row of dtab (fp32,
// (T, R, E) contiguous, zero-filled by the caller). VEC: E % 4 == 0, so four
// consecutive fp32 of a row form one aligned float4.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_backward_kernel(const T* __restrict__ dout, const int* __restrict__ idx, float* __restrict__ dtab,
                    int B, int nT, int L, int R, int E, long long dout_st_b, long long dout_st_t,
                    long long idx_st_b, long long idx_st_t, long long idx_st_l) {
  constexpr int PER = VEC ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const long long bag = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= (long long)B * nT) return;
  const long long b = bag / nT, t = bag % nT;
  const int* bag_idx = idx + b * idx_st_b + t * idx_st_t;
  const T* grad = dout + b * dout_st_b + t * dout_st_t;
  float* table = dtab + t * (long long)R * E;

  for (int c0 = 0; c0 < E; c0 += 32 * PER) {
    const int col = c0 + lane * PER;
    const bool active = col < E;
    float g[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) g[k] = active ? to_float(grad[col + k]) : 0.f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int my_row = bag_row<false>(bag_idx, idx_st_l, l0 + lane, L, R);
      const int n = min(32, L - l0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int row = __shfl_sync(0xffffffffu, my_row, j);
        if (active && row >= 0) {
          float* dst = table + (long long)row * E + col;
          if constexpr (VEC) {
            atomicAdd(reinterpret_cast<float4*>(dst), make_float4(g[0], g[1], g[2], g[3]));
          } else {
            atomicAdd(dst, g[0]);
          }
        }
      }
    }
  }
}

__global__ void round_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                     long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

cudaError_t bag_grid(int B, int nT, unsigned* blocks) {
  const long long n = ((long long)B * nT + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (n <= 0 || n > 2147483647LL) return cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_forward(const void* tables, const int* idx, void* out, int B, int nT, int L,
                           int R, int E, long long tab_st_t, long long tab_st_r, long long idx_st_b,
                           long long idx_st_t, long long idx_st_l, cudaStream_t stream) {
  unsigned blocks;
  cudaError_t err = bag_grid(B, nT, &blocks);
  if (err != cudaSuccess) return err;
  const size_t sz = sizeof(T);
  const bool vec = (E * sz) % 16 == 0 && (tab_st_t * sz) % 16 == 0 && (tab_st_r * sz) % 16 == 0 &&
                   aligned16(tables) && aligned16(out);
  auto kernel = vec ? bag_forward_kernel<T, true> : bag_forward_kernel<T, false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(tables), idx, static_cast<T*>(out), B, nT, L, R, E, tab_st_t, tab_st_r,
      idx_st_b, idx_st_t, idx_st_l);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* dout, const int* idx, float* dtab, int B, int nT, int L,
                            int R, int E, long long dout_st_b, long long dout_st_t,
                            long long idx_st_b, long long idx_st_t, long long idx_st_l,
                            cudaStream_t stream) {
  unsigned blocks;
  cudaError_t err = bag_grid(B, nT, &blocks);
  if (err != cudaSuccess) return err;
  const bool vec = E % 4 == 0 && aligned16(dtab);
  auto kernel = vec ? bag_backward_kernel<T, true> : bag_backward_kernel<T, false>;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(dout), idx, dtab, B, nT, L, R, E, dout_st_b, dout_st_t, idx_st_b,
      idx_st_t, idx_st_l);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tables (T, R, E) with unit stride along E;
// idx (B, T, L) int32 by strides; out (B, T, E) contiguous. Strides in
// elements. Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_embedding_bag(const void* tables, const void* idx, void* out, int B, int nT,
                                   int L, int R, int E, long long tab_st_t, long long tab_st_r,
                                   long long idx_st_b, long long idx_st_t, long long idx_st_l,
                                   int dtype, void* stream) {
  if (B <= 0 || nT <= 0 || L < 0 || R <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  if (dtype == 0)
    return (int)launch_forward<float>(tables, ix, out, B, nT, L, R, E, tab_st_t, tab_st_r,
                                      idx_st_b, idx_st_t, idx_st_l, s);
  if (dtype == 1)
    return (int)launch_forward<__nv_bfloat16>(tables, ix, out, B, nT, L, R, E, tab_st_t, tab_st_r,
                                              idx_st_b, idx_st_t, idx_st_l, s);
  return (int)cudaErrorInvalidValue;
}

// dout (B, T, E) of the table's type with unit stride along E; idx as above.
// dtab_f32: fp32 (T, R, E) contiguous, zero-filled by the caller. For fp32
// (dtype 0) it is the result; for bf16 (dtype 1) it is scratch, rounded once
// into dtab_out (bf16, (T, R, E) contiguous) after the atomics.
extern "C" int repro_embedding_bag_backward(const void* dout, const void* idx, void* dtab_f32,
                                            void* dtab_out, int B, int nT, int L, int R, int E,
                                            long long dout_st_b, long long dout_st_t,
                                            long long idx_st_b, long long idx_st_t,
                                            long long idx_st_l, int dtype, void* stream) {
  if (B <= 0 || nT <= 0 || L < 0 || R <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* acc = static_cast<float*>(dtab_f32);
  if (dtype == 0)
    return (int)launch_backward<float>(dout, ix, acc, B, nT, L, R, E, dout_st_b, dout_st_t,
                                       idx_st_b, idx_st_t, idx_st_l, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_backward<__nv_bfloat16>(dout, ix, acc, B, nT, L, R, E, dout_st_b,
                                                   dout_st_t, idx_st_b, idx_st_t, idx_st_l, s);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)nT * R * E;
  const long long blocks = (n + kConvertThreads - 1) / kConvertThreads;
  round_to_bf16_kernel<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), kConvertThreads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(dtab_out), n);
  return (int)cudaGetLastError();
}
