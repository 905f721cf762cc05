// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (`_rmsnorm_kernel`,
// called from `rmsnorm`): out = x * rsqrt(mean(x^2, -1) + eps) * gamma, all
// arithmetic in fp32, one rounding into x's type at the end.
//
// Bound on this card: bytes. Each element is read once and written once and
// takes three floating-point operations, far below the ~295 operations per
// byte at which an H100 turns compute-bound. At the main path's sizes (a
// decode tick's 8 rows of 576 to 3072 values) the time is latency: the launch
// and one trip to memory. So the design makes the trip once:
//  * `rmsnorm_regs_kernel` (rows of up to 1024 units a lane can hold: 16-byte
//    packs where rows are whole packs, so bf16 d <= 8192 and fp32 d <= 4096,
//    else single elements, d <= 1024): a team of TW warps owns a row and each
//    lane a compile-time number NP of its units, neighbouring lanes on
//    neighbouring addresses. The loads of x and of gamma are issued together
//    before the reduction, the row stays in registers, and the sum of
//    squares is a warp shuffle (and, with two warps a row, one exchange in
//    shared memory). A launch of at most 8 rows is one block, so the rows run
//    side by side; more rows take blocks of 4 warps.
//  * `rmsnorm_smem_kernel` (wider rows): one warp a row parks the raw row in
//    shared memory while the sum is reduced, then reads gamma.
// The TPU kernel's 256-row blocks and its row padding have no counterpart: the
// ragged last block has warps that do nothing, and `d` needs to be neither a
// power of two nor a multiple of the warp size.
//
// The backward (no Pallas counterpart: `jax.grad` of
// src/repro/models/common.py `rms_norm` is the oracle): with x^ = x * rstd
// and g = dy * gamma, dx = rstd * (g - x^ * mean(g * x^)) and dgamma =
// sum over rows of dy * x^, all in fp32, each rounded once into its type.
// Bound: bytes (x and dy read, dx written). This first version is simple and
// deterministic, with no atomics:
//  * `rmsnorm_bwd_kernel`: a block owns a fixed run of rows, one warp a row
//    at a time; a row is read twice (the second time from cache), and each
//    warp sums dy * x^ into its own fp32 row of shared memory. The block
//    then adds its warps' rows in order and writes one partial row of dgamma.
//  * `rmsnorm_dgamma_kernel`: one thread a column adds the blocks' partial
//    rows in order. The grid depends on the shape alone, so every call sums
//    in the same order and gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmemWarps = 4;
constexpr int kMaxDynamicSmem = 232448;  // 227 KB, the most one block can take

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// A team of TW warps a row, NP units a lane, in registers. VEC: a unit is a
// 16-byte pack (rows are 16-byte aligned and hold a whole number of packs);
// otherwise one element.
template <typename T, bool VEC>
struct Unit {
  using type = T;
  static constexpr int ELEMS = 1;
};

template <typename T>
struct Unit<T, true> {
  using type = uint4;
  static constexpr int ELEMS = 16 / sizeof(T);
};

template <typename T, int NP, int TW, bool VEC>
__global__ void __launch_bounds__(256)
rmsnorm_regs_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
                    long long rows, int d, float eps) {
  using U = typename Unit<T, VEC>::type;
  constexpr int PER = Unit<T, VEC>::ELEMS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int team = warp / TW;
  const int slot0 = (warp % TW) * 32 + lane;
  const long long row = (long long)blockIdx.x * (blockDim.x / (32 * TW)) + team;
  const bool live = row < rows;
  const int nvec = d / PER;
  const U* xv = reinterpret_cast<const U*>(x + (live ? row : 0) * d);
  const U* gv = reinterpret_cast<const U*>(gamma);

  U xr[NP], gr[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = slot0 + j * 32 * TW;
    if (live && i < nvec) {
      xr[j] = xv[i];
      gr[j] = gv[i];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = slot0 + j * 32 * TW;
    if (live && i < nvec) {
      const T* e = reinterpret_cast<const T*>(&xr[j]);
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const float f = to_float(e[u]);
        ss += f * f;
      }
    }
  }
  ss = warp_sum(ss);
  if (TW > 1) {
    __shared__ float part[8];
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < TW; ++w) ss += part[team * TW + w];
  }
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);

  U* ov = reinterpret_cast<U*>(out + (live ? row : 0) * d);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = slot0 + j * 32 * TW;
    if (live && i < nvec) {
      U res;
      const T* e = reinterpret_cast<const T*>(&xr[j]);
      const T* g = reinterpret_cast<const T*>(&gr[j]);
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int u = 0; u < PER; ++u) from_float(to_float(e[u]) * inv * to_float(g[u]), &r[u]);
      ov[i] = res;
    }
  }
}

// One warp per row, the raw row parked in shared memory. VEC: rows are
// 16-byte aligned and hold a whole number of 16-byte packs, so loads and
// stores are uint4; otherwise scalar.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kSmemWarps * 32)
rmsnorm_smem_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
                    long long rows, int d, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kSmemWarps + warp;
  if (row >= rows) return;  // no block-wide barrier below, so a warp may leave

  T* srow = reinterpret_cast<T*>(smem_raw) + (size_t)warp * d;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  constexpr int PER = 16 / sizeof(T);

  float ss = 0.f;
  if (VEC) {
    const int nvec = d / PER;
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* sv = reinterpret_cast<uint4*>(srow);
    for (int i = lane; i < nvec; i += 32) {
      uint4 raw = xv[i];
      sv[i] = raw;
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        float f = to_float(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      T raw = xr[i];
      srow[i] = raw;
      float f = to_float(raw);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  __syncwarp();

  if (VEC) {
    const int nvec = d / PER;
    const uint4* sv = reinterpret_cast<const uint4*>(srow);
    const uint4* gv = reinterpret_cast<const uint4*>(gamma);
    uint4* ov = reinterpret_cast<uint4*>(outr);
    for (int i = lane; i < nvec; i += 32) {
      uint4 raw = sv[i];
      uint4 graw = gv[i];
      uint4 res;
      const T* e = reinterpret_cast<const T*>(&raw);
      const T* g = reinterpret_cast<const T*>(&graw);
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < PER; ++j) from_float(to_float(e[j]) * inv * to_float(g[j]), &r[j]);
      ov[i] = res;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      from_float(to_float(srow[i]) * inv * to_float(gamma[i]), &outr[i]);
  }
}

template <typename T, int NP, int TW, bool VEC>
cudaError_t launch_regs(const T* x, const T* gamma, T* out, long long rows, int d, float eps,
                        cudaStream_t stream) {
  // At most 8 rows: one block, a team a row. Otherwise 4 warps a block.
  const long long teams = rows * TW <= 8 ? rows : 4 / TW;
  const long long blocks = (rows + teams - 1) / teams;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  rmsnorm_regs_kernel<T, NP, TW, VEC><<<(unsigned)blocks, (unsigned)(teams * TW * 32), 0, stream>>>(
      x, gamma, out, rows, d, eps);
  return cudaGetLastError();
}

// The fewest unit slots a lane that cover a row of `units`; false when the
// row is wider than 1024 units.
template <typename T, bool VEC>
bool launch_regs_for(const T* x, const T* gamma, T* out, long long rows, int d, float eps,
                     cudaStream_t stream, cudaError_t* err) {
  const int units = VEC ? (int)((size_t)d * sizeof(T) / 16) : d;
  const int lane_units = (units + 31) / 32;
  if (lane_units <= 1) *err = launch_regs<T, 1, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 2) *err = launch_regs<T, 2, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 3) *err = launch_regs<T, 3, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 4) *err = launch_regs<T, 4, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 6) *err = launch_regs<T, 6, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 8) *err = launch_regs<T, 8, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 12) *err = launch_regs<T, 12, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 16) *err = launch_regs<T, 16, 1, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 24) *err = launch_regs<T, 12, 2, VEC>(x, gamma, out, rows, d, eps, stream);
  else if (lane_units <= 32) *err = launch_regs<T, 16, 2, VEC>(x, gamma, out, rows, d, eps, stream);
  else return false;
  return true;
}

template <typename T>
cudaError_t launch(const void* xp, const void* gp, void* op, long long rows, int d, float eps,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(xp);
  const T* gamma = static_cast<const T*>(gp);
  T* out = static_cast<T*>(op);
  const bool vec = ((size_t)d * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)gamma % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaError_t err = cudaSuccess;
  if (vec ? launch_regs_for<T, true>(x, gamma, out, rows, d, eps, stream, &err)
          : launch_regs_for<T, false>(x, gamma, out, rows, d, eps, stream, &err))
    return err;
  const size_t smem = (size_t)kSmemWarps * d * sizeof(T);
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  auto kernel = vec ? rmsnorm_smem_kernel<T, true> : rmsnorm_smem_kernel<T, false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (rows + kSmemWarps - 1) / kSmemWarps;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kSmemWarps * 32, smem, stream>>>(x, gamma, out, rows, d, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------- //
// Backward
// ------------------------------------------------------------------------- //

constexpr int kBwdWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part, long long rows, int d, float eps,
                   long long rows_per_block) {
  extern __shared__ __align__(16) float acc_s[];  // (kBwdWarps, d)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* acc = acc_s + (size_t)warp * d;
  for (int c = lane; c < d; c += 32) acc[c] = 0.f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  for (long long row = r0 + warp; row < r1; row += kBwdWarps) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, dot = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xf = to_float(xr[c]);
      ss = fmaf(xf, xf, ss);
      dot = fmaf(to_float(gr[c]) * to_float(gamma[c]), xf, dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const float rstd = 1.0f / sqrtf(ss / (float)d + eps);
    const float mean_gx = dot * rstd / (float)d;  // mean(g * x^)
    T* out = dx + row * d;
    for (int c = lane; c < d; c += 32) {
      const float xh = to_float(xr[c]) * rstd;
      const float dyf = to_float(gr[c]);
      from_float(rstd * (dyf * to_float(gamma[c]) - xh * mean_gx), &out[c]);
      acc[c] = fmaf(dyf, xh, acc[c]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += kBwdWarps * 32) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) total += acc_s[(size_t)w * d + c];
    part[(size_t)blockIdx.x * d + c] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_dgamma_kernel(const float* __restrict__ part, T* __restrict__ dgamma, int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float total = 0.f;
  for (int b = 0; b < blocks; ++b) total += part[(size_t)b * d + c];
  from_float(total, &dgamma[c]);
}

template <typename T>
cudaError_t launch_backward(const void* xp, const void* gp, const void* dyp, void* dxp,
                            void* dgp, float* part, long long rows, int d, float eps, int blocks,
                            cudaStream_t stream) {
  const size_t smem = (size_t)kBwdWarps * d * sizeof(float);
  if (smem > (size_t)kMaxDynamicSmem || blocks <= 0) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long per_block = (rows + blocks - 1) / blocks;
  rmsnorm_bwd_kernel<T><<<blocks, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(xp), static_cast<const T*>(gp), static_cast<const T*>(dyp),
      static_cast<T*>(dxp), part, rows, d, eps, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dgamma_kernel<T><<<(d + 255) / 256, 256, 0, stream>>>(part, static_cast<T*>(dgp),
                                                                blocks, d);
  return cudaGetLastError();
}

}  // namespace

// The backward. x, dy and dx are (rows, d) contiguous, gamma and dgamma are
// (d,); part is fp32 (blocks, d) scratch, blocks from the caller (the grid
// of the first kernel; rows are split evenly over it). dtype as the forward's.
// Returns the CUDA error code of the first launch that failed (0 on success).
extern "C" int repro_rmsnorm_backward(const void* x, const void* gamma, const void* dy, void* dx,
                                      void* dgamma, void* part, long long rows, int d, float eps,
                                      int blocks, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return (int)launch_backward<float>(x, gamma, dy, dx, dgamma, pf, rows, d, eps, blocks, s);
  if (dtype == 1)
    return (int)launch_backward<__nv_bfloat16>(x, gamma, dy, dx, dgamma, pf, rows, d, eps,
                                               blocks, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. x and out are (rows, d) contiguous, gamma is (d,).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int repro_rmsnorm(const void* x, const void* gamma, void* out, long long rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, gamma, out, rows, d, eps, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, gamma, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
