// RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py (`_rmsnorm_kernel`,
// called from `rmsnorm`): out = x * rsqrt(mean(x^2, -1) + eps) * gamma, all
// arithmetic in fp32, one rounding into x's type at the end.
//
// Bound on this card: bytes. Each element is read once and written once and
// takes three floating-point operations, far below the ~295 operations per
// byte at which an H100 turns compute-bound. So the design moves each byte
// once: one warp owns one row, reads it with 16-byte loads (neighbouring lanes
// on neighbouring addresses), parks the raw values in shared memory while the
// sum of squares is reduced with warp shuffles, and writes the scaled row from
// shared memory without touching device memory again. The TPU kernel's 256-row
// blocks and its row padding have no counterpart: the ragged last block is a
// warp that returns, and `d` needs to be neither a power of two nor a multiple
// of the warp size (a scalar path covers rows that are not 16-byte aligned).
// At the few rows of a decode tick the kernel is launch- and latency-bound;
// fusing it into its neighbours is the cure, in a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
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

// One warp per row. VEC: rows are 16-byte aligned and hold a whole number of
// 16-byte packs, so loads and stores are uint4.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
               long long rows, int d, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
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

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* out, long long rows, int d, float eps,
                   cudaStream_t stream) {
  const size_t smem = (size_t)kWarpsPerBlock * d * sizeof(T);
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  const bool vec = ((size_t)d * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)gamma % 16 == 0 && (uintptr_t)out % 16 == 0;
  auto kernel = vec ? rmsnorm_kernel<T, true> : rmsnorm_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

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
