// RMSNorm, forward and backward, for Hopper (sm_90a).
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
// src/repro/models/common.py `rms_norm`, the reference model's norm, whose
// forward the TPU kernel above computes, is the oracle): with x^ = x * rstd
// and g = dy * gamma, dx = rstd * (g - x^ * mean(g * x^)) and dgamma = sum
// over rows of dy * x^, all in fp32, each rounded once into its type.
// Bound: bytes. x and dy are read once and dx written once (10 operations
// an element, far below the card's ~20 fp32 operations a byte). Two kernels
// a call, no atomics, every launch shape a function of (rows, d, dtype)
// alone (`rmsnorm_backward_plan`), so every call at a shape sums in the same
// order and gives the same bits:
//  * `rmsnorm_bwd_rows_kernel`: the forward's scheme. A team of TW warps
//    owns a row and each lane NP 16-byte units of it in registers; x and dy
//    are read once, dx written as 16-byte stores. A lane's columns are the
//    same in every row its team walks, so its gamma is loaded once, and it
//    sums dy * x^ for them in fp32 registers; the team's next row is loaded
//    before the current row's two reductions. A team is the fewest warps
//    whose lanes have registers for that (4 fp32 units, 3 bf16: d 576 takes
//    2 / 1 warps a row, d 4096 8; rows too wide for 8 such warps take up to
//    16 / 8 units a lane and load nothing early); a block is up to 8 warps
//    (fewer where the rows are too few to give every SM a block), the grid
//    one wave. The teams' sums meet in shared memory once a block; each
//    column is added over the teams in order into the block's partial row.
//    Rows that are not whole aligned 16-byte units take two instances a
//    type (NP 1 where a lane holds one unit, else the widest NP, its units
//    past the row skipped) that load them element by element: the same
//    lanes, columns and fused multiply-adds in the same order, so the same
//    bits as the 16-byte route on the same plan.
//  * `rmsnorm_dgamma_kernel`: strips of 32 columns; 8 warps each add a fixed
//    share of the partial rows in order, 16 loads in flight, then the 8
//    sums in order.
// Measured on the H100 (kernel_ab.py against a copy of this source that
// loads no row early): the early load takes 5-10 % off bf16 rows of 576
// and 4096 (two runs), and nothing off fp32's. No instance spills (the same
// script's resource lines).

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

constexpr int kBwdMaxWarps = 8;    // a block of the rows pass
constexpr int kDgammaWarps = 8;    // a block of the dgamma sum: 8 shares of the partial rows
constexpr int kDgammaCols = 32;    // ... over a strip of 32 columns
constexpr int kDgammaBatch = 16;   // partial rows a warp loads at once

// A unit of a row is 16 bytes, PER = 16 / sizeof(T) elements: one 16-byte
// load or store (VEC: the row is 16-byte aligned and a whole number of
// units), or PER single elements, the columns past d read as zeros and not
// written. Either way a lane holds a unit as a uint4.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_unit(const T* __restrict__ row, int i, int d) {
  if (VEC) return reinterpret_cast<const uint4*>(row)[i];
  constexpr int PER = 16 / sizeof(T);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (i * PER + k < d) e[k] = row[i * PER + k];
  return u;
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_unit(T* __restrict__ row, int i, int d, const uint4& u) {
  if (VEC) {
    reinterpret_cast<uint4*>(row)[i] = u;
    return;
  }
  constexpr int PER = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (i * PER + k < d) row[i * PER + k] = e[k];
}

// A lane's NP units of one row of x and of dy: units slot0 + j * stride.
template <typename T, int NP, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ x, const T* __restrict__ dy,
                                         int slot0, int stride, int units, int d, uint4 (&xr)[NP],
                                         uint4 (&dr)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = slot0 + j * stride;
    if (i < units) {
      xr[j] = load_unit<T, VEC>(x, i, d);
      dr[j] = load_unit<T, VEC>(dy, i, d);
    }
  }
}

// The TW warps of one team meet; the other teams of the block go on.
__device__ __forceinline__ void team_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A lane's registers for NP units of a row: x and dy (4 registers a unit
// each) and the fp32 dgamma sums (PER) always; within a budget, gamma's
// units (4 each; KEEP_G, else read from cache each row) and the next row's
// x and dy (8 each; PREFETCH). Up to 96 such registers a lane, two blocks
// of 8 warps fit an SM (128 registers a thread); beyond, one does. The plan
// (rmsnorm.py's `_bwd_registers`) reckons MIN_BLOCKS and PREFETCH the same
// way for its team width and grid; a CPU test evaluates these lines and
// holds the two together.
template <typename T, int NP>
struct BwdRegs {
  static constexpr int PER = 16 / sizeof(T);
  static constexpr int BASE = NP * (8 + PER);
  static constexpr int MIN_BLOCKS = BASE <= 96 ? 2 : 1;
  static constexpr int BUDGET = MIN_BLOCKS == 2 ? 96 : 192;
  static constexpr bool KEEP_G = BASE + 4 * NP <= BUDGET;
  static constexpr bool PREFETCH = BASE + 12 * NP <= BUDGET;
};

// The rows pass. A team of `tw` warps owns a row at a time and each lane NP
// units of it (units slot0 + j * 32 tw, the same for every row, so a lane's
// gamma is loaded once). Block b walks rows [b rpb, (b + 1) rpb), team t of
// the block rows t, t + teams, ... of them, in that order; with PREFETCH
// the team's next row is loaded before the current row's sums. Each lane
// sums dy * x^ for its columns over its team's rows in fp32 registers; the
// teams' sums meet in shared memory, where each column is added over the
// teams in order into the block's partial row of dgamma (units * PER
// floats), part[b].
template <typename T, int NP, bool VEC>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, (BwdRegs<T, NP>::MIN_BLOCKS))
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                        long long rows, int d, float eps, int tw, long long rows_per_block) {
  constexpr int PER = 16 / sizeof(T);
  constexpr bool KEEP_G = BwdRegs<T, NP>::KEEP_G;
  constexpr bool PREFETCH = BwdRegs<T, NP>::PREFETCH;
  extern __shared__ __align__(16) float block_sum[];  // (teams, units * PER) where teams > 1
  __shared__ float red[2][kBwdMaxWarps][2];          // a row's two sums, warp by warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int teams = blockDim.x / (32 * tw);
  const int team = warp / tw;
  const int units = (d + PER - 1) / PER;
  const int stride = 32 * tw;
  const int slot0 = (warp % tw) * 32 + lane;

  uint4 gr[KEEP_G ? NP : 1];
  if constexpr (KEEP_G) {
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int i = slot0 + j * stride;
      if (i < units) gr[j] = load_unit<T, VEC>(gamma, i, d);
    }
  }
  float acc[NP][PER];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[j][k] = 0.f;

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  long long row = r0 + team;
  uint4 xr[NP], dr[NP];
  if (row < r1) load_row<T, NP, VEC>(x + row * d, dy + row * d, slot0, stride, units, d, xr, dr);
  int parity = 0;
  for (; row < r1; row += teams) {
    const long long next = row + teams;
    uint4 xn[PREFETCH ? NP : 1], dn[PREFETCH ? NP : 1];
    if constexpr (PREFETCH) {
      if (next < r1)
        load_row<T, NP, VEC>(x + next * d, dy + next * d, slot0, stride, units, d, xn, dn);
    }
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int i = slot0 + j * stride;
      if (i < units) {
        uint4 g;
        if constexpr (KEEP_G) g = gr[j];
        else g = load_unit<T, VEC>(gamma, i, d);
        const T* xe = reinterpret_cast<const T*>(&xr[j]);
        const T* de = reinterpret_cast<const T*>(&dr[j]);
        const T* ge = reinterpret_cast<const T*>(&g);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const float xf = to_float(xe[k]);
          ss = fmaf(xf, xf, ss);
          dot = fmaf(to_float(de[k]) * to_float(ge[k]), xf, dot);
        }
      }
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (tw > 1) {
      // two buffers a row apart: a warp writes one only after the whole
      // team has passed the barrier of the row that read it last
      if (lane == 0) {
        red[parity][warp][0] = ss;
        red[parity][warp][1] = dot;
      }
      team_barrier(1 + team, stride);
      ss = 0.f;
      dot = 0.f;
      for (int w = 0; w < tw; ++w) {
        ss += red[parity][team * tw + w][0];
        dot += red[parity][team * tw + w][1];
      }
      parity ^= 1;
    }
    const float rstd = 1.0f / sqrtf(ss / (float)d + eps);
    const float mean_gx = dot * rstd / (float)d;  // mean(g * x^)
    T* out = dx + row * d;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int i = slot0 + j * stride;
      if (i < units) {
        uint4 g;
        if constexpr (KEEP_G) g = gr[j];
        else g = load_unit<T, VEC>(gamma, i, d);
        const T* xe = reinterpret_cast<const T*>(&xr[j]);
        const T* de = reinterpret_cast<const T*>(&dr[j]);
        const T* ge = reinterpret_cast<const T*>(&g);
        uint4 res;
        T* re = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const float xh = to_float(xe[k]) * rstd;
          const float dyf = to_float(de[k]);
          from_float(rstd * fmaf(dyf, to_float(ge[k]), -(xh * mean_gx)), &re[k]);
          acc[j][k] = fmaf(dyf, xh, acc[j][k]);
        }
        store_unit<T, VEC>(out, i, d, res);
      }
    }
    if constexpr (PREFETCH) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        xr[j] = xn[j];
        dr[j] = dn[j];
      }
    } else {
      if (next < r1)
        load_row<T, NP, VEC>(x + next * d, dy + next * d, slot0, stride, units, d, xr, dr);
    }
  }

  // The block's partial row: each team's sums into its row of block_sum,
  // then each column's sum over the teams in order, (acc_0 + acc_1) + ...
  float4* out = reinterpret_cast<float4*>(part + (size_t)blockIdx.x * units * PER);
  float4* mine = reinterpret_cast<float4*>(block_sum + (size_t)team * units * PER);
  if (teams == 1) mine = out;
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int i = slot0 + j * stride;
    if (i < units) {
#pragma unroll
      for (int q = 0; q < PER / 4; ++q)
        mine[i * (PER / 4) + q] = make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                                              acc[j][4 * q + 3]);
    }
  }
  if (teams == 1) return;
  __syncthreads();
  const int quads = units * (PER / 4);
  const float4* sums = reinterpret_cast<const float4*>(block_sum);
  for (int c = threadIdx.x; c < quads; c += blockDim.x) {
    float4 v = sums[c];
    for (int t = 1; t < teams; ++t) {
      const float4 a = sums[(size_t)t * quads + c];
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    out[c] = v;
  }
}

// dgamma: a block a strip of 32 columns; warp w adds partial rows w, w + 8,
// ... in order, then the 8 warps' sums are added in order, warp 0's first.
template <typename T>
__global__ void __launch_bounds__(kDgammaWarps * 32)
rmsnorm_dgamma_kernel(const float* __restrict__ part, T* __restrict__ dgamma, int parts, int d,
                      int part_cols) {
  __shared__ float sums[kDgammaWarps][kDgammaCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kDgammaCols + lane;
  float s = 0.f;
  if (c < d) {
    // kDgammaBatch loads in flight, then their sum in order (a row past the
    // last adds 0)
    for (int p0 = warp; p0 < parts; p0 += kDgammaBatch * kDgammaWarps) {
      float v[kDgammaBatch];
#pragma unroll
      for (int u = 0; u < kDgammaBatch; ++u) {
        const int p = p0 + u * kDgammaWarps;
        v[u] = p < parts ? part[(size_t)p * part_cols + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kDgammaBatch; ++u) s += v[u];
    }
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kDgammaWarps; ++w) total += sums[w][lane];
    from_float(total, &dgamma[c]);
  }
}

template <typename T, int NP, bool VEC>
cudaError_t launch_rows(const T* x, const T* gamma, const T* dy, T* dx, float* part,
                        long long rows, int d, float eps, int tw, int teams, int blocks,
                        long long rows_per_block, cudaStream_t stream) {
  constexpr int PER = 16 / sizeof(T);
  const int units = (d + PER - 1) / PER;
  const size_t smem = teams > 1 ? (size_t)teams * units * PER * sizeof(float) : 0;
  if (smem > (size_t)kMaxDynamicSmem) return cudaErrorInvalidValue;
  auto kernel = rmsnorm_bwd_rows_kernel<T, NP, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, teams * tw * 32, smem, stream>>>(x, gamma, dy, dx, part, rows, d, eps, tw,
                                                    rows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const void* xp, const void* gp, const void* dyp, void* dxp,
                            void* dgp, float* part, long long rows, int d, float eps,
                            int team_warps, int lane_units, int teams, int blocks,
                            long long rows_per_block, int stages, cudaStream_t stream) {
  constexpr int PER = 16 / sizeof(T);
  const int units = (d + PER - 1) / PER;
  const int tw = team_warps;
  if (!(tw == 1 || tw == 2 || tw == 4 || tw == 8) || teams < 1 || teams * tw > kBwdMaxWarps ||
      lane_units < 1 || (long long)lane_units * 32 * tw < units || blocks < 1 ||
      rows_per_block < 1 || (long long)blocks * rows_per_block < rows)
    return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xp);
  const T* gamma = static_cast<const T*>(gp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  const bool vec = d % PER == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)gamma % 16 == 0 &&
                   (uintptr_t)dy % 16 == 0 && (uintptr_t)dx % 16 == 0;
  cudaError_t err = cudaSuccess;
  // the widest NP of a type; the scalar route takes it, or 1 where a lane
  // holds one unit (the few short rows it mostly serves)
  constexpr int kMaxNP = sizeof(T) == 4 ? 16 : 8;
  if (stages & 1) {
#define REPRO_ROWS(NP, VEC)                                                                  \
  launch_rows<T, NP, VEC>(x, gamma, dy, dx, part, rows, d, eps, tw, teams, blocks,        \
                          rows_per_block, stream)
    if (lane_units > kMaxNP) return cudaErrorInvalidValue;
    if (!vec) {
      err = lane_units == 1 ? REPRO_ROWS(1, false) : REPRO_ROWS(kMaxNP, false);
    } else {
      switch (lane_units) {
        case 1: err = REPRO_ROWS(1, true); break;
        case 2: err = REPRO_ROWS(2, true); break;
        case 3: err = REPRO_ROWS(3, true); break;
        case 4: err = REPRO_ROWS(4, true); break;
        case 5: err = REPRO_ROWS(5, true); break;
        case 6: err = REPRO_ROWS(6, true); break;
        case 7: err = REPRO_ROWS(7, true); break;
        case 8: err = REPRO_ROWS(8, true); break;
        default: err = REPRO_ROWS(kMaxNP, true); break;
      }
    }
#undef REPRO_ROWS
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    rmsnorm_dgamma_kernel<T><<<(d + kDgammaCols - 1) / kDgammaCols, kDgammaWarps * 32, 0,
                               stream>>>(part, static_cast<T*>(dgp), blocks, d, units * PER);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// The backward, as the plan of rmsnorm_backward_plan (repro_torch/kernels/
// rmsnorm.py) gives it: teams of team_warps warps, `teams` of them a block,
// lane_units 16-byte units a lane, `blocks` blocks of rows_per_block rows.
// x, dy and dx are (rows, d) contiguous, gamma and dgamma are (d,); part is
// fp32 (blocks, ceil(d / PER) * PER) scratch, PER = 16 / the element size.
// stages: bit 0 the rows pass (dx and part), bit 1 the dgamma sum (reads
// part); 3 for a whole call. dtype as the forward's. Returns the CUDA error
// code of the first launch that failed (0 on success).
extern "C" int repro_rmsnorm_backward(const void* x, const void* gamma, const void* dy, void* dx,
                                      void* dgamma, void* part, long long rows, int d, float eps,
                                      int team_warps, int lane_units, int teams, int blocks,
                                      long long rows_per_block, int stages, int dtype,
                                      void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return (int)launch_backward<float>(x, gamma, dy, dx, dgamma, pf, rows, d, eps, team_warps,
                                       lane_units, teams, blocks, rows_per_block, stages, s);
  if (dtype == 1)
    return (int)launch_backward<__nv_bfloat16>(x, gamma, dy, dx, dgamma, pf, rows, d, eps,
                                               team_warps, lane_units, teams, blocks,
                                               rows_per_block, stages, s);
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
