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
// rows; the backward reads dout (134 MB) and the indices (34 MB) and writes a
// 6.55 GB dense gradient (3.28 GB in bf16): 2.006 ms (1.008 ms) at 3.35 TB/s.
//
// Forward design. The rows lie at random in a table of gigabytes, so the
// design is about keeping enough independent row reads in flight: one warp
// owns one bag (b, t); its lanes load the bag's indices once (32 at a time)
// and pass them on by shuffle, so each lookup is one 16-byte load per lane and
// the whole warp reads one row of up to 512 bytes (E 128 in fp32: 32 lanes x
// float4). The sum stays in registers. The TPU kernel's grid of (sample,
// table) DMA row fetches becomes this warp loop; nothing carries between
// blocks. Rows that are not a whole number of 16-byte packs take a scalar
// path, one element a lane.
//
// Backward design: sort the lookups by the row they add to, then sum each
// row's segment in order and write every row of dtables exactly once. It
// replaces a design (one warp a bag, float atomics into a zero-filled fp32
// (T, R, E), rounded afterwards for bf16) that wrote the 6.55 GB twice, did
// 8.4 M random read-modify-writes and added in an order that changed from run
// to run. Here there is no zero-fill, no fp32 scratch of the table's size and
// no float atomic, and the sum of each element is taken in an order fixed by
// the input, so the result is bitwise the same in every run. Stages, each a
// few kernels, with no read back to the host (the call can be captured in a
// CUDA graph):
//
//   sort    key t * R + wrap(idx) for lookup i = (b * T + t) * L + l (the
//           sentinel T * R for a dropped index), payload b. A stable LSD
//           radix sort of (key, payload) over the key's significant bits, 8
//           bits a pass (3 passes at T * R = 12.8 M). A pass is three
//           kernels: per-tile digit counts (integer shared-memory atomics:
//           a count does not depend on order), an exclusive scan of the
//           counts over (digit, tile), and a stable scatter. The scatter
//           ranks a key within its tile in lookup order: each warp takes its
//           keys 32 at a time in order, peers of one digit found with
//           __match_any_sync, a per-warp running count per digit, the warps'
//           counts then scanned in warp order; the tile is then laid out
//           by digit in shared memory and written as runs of one digit on
//           consecutive addresses. The first pass reads the indices by
//           their strides and makes the keys on the way. A stable
//           sort leaves each segment in increasing i, a function of the
//           input alone.
//   pieces  one warp a piece of kPiece consecutive sorted entries: the fp32
//           sums, in order, of the entries of its first key (head, and
//           their count) and of its last key (tail). A piece of one key has
//           head == tail == its whole sum.
//   write   one warp owns kRunBytes of consecutive rows of the flat (T * R,
//           E) output (16 fp32 or 32 bf16 rows at E 128). It finds its
//           first row's segment by a 32-way search of the sorted keys (a
//           few dependent loads), then walks forward, rounds each row's fp32
//           sum once into dtables' type and stores it; a row with no lookup
//           stores zeros. A segment inside one piece is summed entry by
//           entry (kInFlight dout rows loaded at once, added in order); one
//           that crosses pieces a .. z is tail[a] + head[a + 1] + ... +
//           head[z], with 32 pieces probed at once. So a Zipf-hot row of
//           ~13 k lookups costs its warp a few hundred loads in flight and
//           not 13 k dependent adds: the pieces kernel spreads them over
//           one warp a piece.
//
// On an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py, the DLRM step's
// shape): fp32 3.02 ms against the 2.006 ms bound (sort 0.55, pieces 0.10,
// write 2.36), bf16 1.92 against 1.008; at Zipf(1.05) indices fp32 3.43,
// bf16 2.33. The writer moves its 6.55 GB at 2.8 TB/s, so dout's reads
// (134 MB, walked in row order) did stay in L2; what is left over the bound
// is the sort's three passes (each a count, a scan and a scatter) and, at
// skewed indices, the pieces and the writer's walk at the hot rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

// ------------------------------------------------------------------------- //
// Backward: sort, pieces, write.
// ------------------------------------------------------------------------- //

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortWarps = 8;
constexpr int kSortThreads = kSortWarps * 32;  // == kRadix: thread d owns digit d
constexpr int kSortItems = 8;                  // keys a lane ranks in a tile
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kScanThreads = 1024;
constexpr int kPiece = 128;    // sorted entries a piece
constexpr int kRunBytes = 8192;  // a writer warp owns this much of the output
constexpr int kWriteWarps = 8;
constexpr int kInFlight = 8;   // dout rows a warp loads before it adds them
static_assert(kSortThreads == kRadix, "one thread a digit");

// Where the keys of a pass come from: pass 0 makes them from the indices (by
// their strides), later passes read the previous pass's output.
struct KeySource {
  const int* idx;
  long long st_b, st_t, st_l;
  int nT, L, R;
  const int* keys;
  const int* vals;
};

template <bool FIRST>
__device__ __forceinline__ void load_key(const KeySource& s, long long i, int* key, int* val) {
  if constexpr (FIRST) {
    const long long bag = i / s.L;
    const int l = (int)(i - bag * s.L);
    const long long b = bag / s.nT;
    const int t = (int)(bag - b * s.nT);
    int r = s.idx[b * s.st_b + t * s.st_t + l * s.st_l];
    if (r < 0) r += s.R;
    *key = (r >= 0 && r < s.R) ? t * s.R + r : s.nT * s.R;
    *val = (int)b;
  } else {
    *key = s.keys[i];
    *val = s.vals[i];
  }
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Digit counts of one tile: hist[digit * tiles + tile].
template <bool FIRST>
__global__ void __launch_bounds__(kSortThreads)
radix_hist_kernel(KeySource src, long long n, int shift, int* __restrict__ hist, int tiles) {
  __shared__ int count[kRadix];
  count[threadIdx.x] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortTile;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = base + j * kSortThreads + threadIdx.x;
    if (i < n) {
      int key, val;
      load_key<FIRST>(src, i, &key, &val);
      atomicAdd(&count[(key >> shift) & (kRadix - 1)], 1);
    }
  }
  __syncthreads();
  hist[(long long)threadIdx.x * tiles + blockIdx.x] = count[threadIdx.x];
}

// One block a digit: its tiles' counts become exclusive offsets in place;
// totals[digit] is the digit's count over all tiles.
__global__ void __launch_bounds__(kScanThreads)
radix_scan_kernel(int* __restrict__ hist, int* __restrict__ totals, int tiles) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* row = hist + (long long)blockIdx.x * tiles;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int begin = min(tiles, (int)threadIdx.x * per), end = min(tiles, begin + per);
  int sum = 0;
  for (int i = begin; i < end; ++i) sum += row[i];
  const int incl = warp_inclusive_scan(sum, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    const int w_incl = warp_inclusive_scan(w, lane);
    warp_sums[lane] = w_incl - w;
    if (lane == 31) totals[blockIdx.x] = w_incl;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = begin; i < end; ++i) {
    const int c = row[i];
    row[i] = run;
    run += c;
  }
}

// The stable scatter of one tile. Warp w ranks keys w * 32 * kSortItems ..
// of the tile, 32 at a time in lookup order. The tile is then laid out in
// shared memory by digit, so that the writes to global memory go out as
// runs of one digit on consecutive addresses.
template <bool FIRST>
__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(KeySource src, long long n, int shift, const int* __restrict__ hist,
                     const int* __restrict__ totals, int tiles, int* __restrict__ keys_out,
                     int* __restrict__ vals_out) {
  __shared__ int warp_count[kSortWarps][kRadix];
  __shared__ int digit_base[kRadix];   // global position of this tile's first key of a digit
  __shared__ int local_base[kRadix];   // the same inside the tile
  __shared__ int scan_tmp[kSortWarps];
  __shared__ int tile_keys[kSortTile];
  __shared__ int tile_vals[kSortTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, d = threadIdx.x;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) warp_count[w][d] = 0;
  {
    const int c = totals[d];
    const int incl = warp_inclusive_scan(c, lane);
    if (lane == 31) scan_tmp[warp] = incl;
    __syncthreads();
    int before = incl - c;
    for (int w = 0; w < warp; ++w) before += scan_tmp[w];
    digit_base[d] = before + hist[(long long)d * tiles + blockIdx.x];
  }

  const long long tile0 = (long long)blockIdx.x * kSortTile;
  const long long base = tile0 + warp * 32 * kSortItems;
  const unsigned lower = (1u << lane) - 1;
  int key[kSortItems], val[kSortItems], rank[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = base + j * 32 + lane;
    const bool valid = i < n;
    int digit = kRadix;  // a lane past the end ranks with nobody
    if (valid) {
      load_key<FIRST>(src, i, &key[j], &val[j]);
      digit = (key[j] >> shift) & (kRadix - 1);
    }
    const unsigned peers = __match_any_sync(kFull, digit);
    const int before = valid ? warp_count[warp][digit] : 0;
    __syncwarp();
    if (valid && (peers & lower) == 0) warp_count[warp][digit] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lower);
  }
  __syncthreads();
  {  // per digit, the warps' counts become offsets in warp order; then the
     // digits' starts inside the tile
    int run = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = warp_count[w][d];
      warp_count[w][d] = run;
      run += c;
    }
    const int incl = warp_inclusive_scan(run, lane);
    __syncthreads();  // scan_tmp is free again
    if (lane == 31) scan_tmp[warp] = incl;
    __syncthreads();
    int before = incl - run;
    for (int w = 0; w < warp; ++w) before += scan_tmp[w];
    local_base[d] = before;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (base + j * 32 + lane < n) {
      const int dj = (key[j] >> shift) & (kRadix - 1);
      const int at = local_base[dj] + warp_count[warp][dj] + rank[j];
      tile_keys[at] = key[j];
      tile_vals[at] = val[j];
    }
  }
  __syncthreads();
  const int count = (int)min((long long)kSortTile, n - tile0);
  for (int i = threadIdx.x; i < count; i += kSortThreads) {
    const int k = tile_keys[i];
    const int dk = (k >> shift) & (kRadix - 1);
    const int pos = digit_base[dk] + i - local_base[dk];
    keys_out[pos] = k;
    vals_out[pos] = tile_vals[i];
  }
}

// PER consecutive elements of a row as fp32: PER 4 is one 16-byte (fp32) or
// 8-byte (bf16) load.
template <typename T, int PER>
__device__ __forceinline__ void load_row(const T* src, float (&x)[PER]) {
  if constexpr (PER == 1) {
    x[0] = to_float(*src);
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < PER; ++k) x[k] = to_float(e[k]);
  }
}

template <typename T, int PER>
__device__ __forceinline__ void store_row(T* dst, const float (&x)[PER]) {
  if constexpr (PER == 1) {
    from_float(x[0], dst);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    uint2 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < PER; ++k) from_float(x[k], &e[k]);
    *reinterpret_cast<uint2*>(dst) = raw;
  }
}

// The fp32 sum, in order, of dout[vals[i], t, :] over sorted entries
// i in [from, to), into acc (this lane's PER columns from col).
template <typename T, int PER>
__device__ __forceinline__ void sum_entries(const T* grad, const int* vals, long long from,
                                            long long to, long long st_b, int col, bool active,
                                            int lane, float (&acc)[PER]) {
  for (long long q = from; q < to; q += 32) {
    const int v = q + lane < to ? vals[q + lane] : 0;
    const int cnt = (int)min(32LL, to - q);
    for (int j0 = 0; j0 < cnt; j0 += kInFlight) {
      float x[kInFlight][PER];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int b = __shfl_sync(kFull, v, (j0 + u) & 31);
        if (active && j0 + u < cnt) {
          load_row<T, PER>(grad + b * st_b + col, x[u]);
        } else {
#pragma unroll
          for (int k = 0; k < PER; ++k) x[u][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
#pragma unroll
        for (int k = 0; k < PER; ++k) acc[k] += x[u][k];
    }
  }
}

template <int PER>
__device__ __forceinline__ void store_f32(float* dst, const float (&x)[PER]) {
#pragma unroll
  for (int k = 0; k < PER; ++k) dst[k] = x[k];
}

// One warp a piece: kPiece consecutive sorted entries (the last piece may be
// shorter). head[piece]: the fp32 sum, in order, of the entries that carry
// the piece's first key, and head_len[piece] their count; tail[piece]: the
// same for its last key. A piece of one key has head == tail == its sum.
// Pieces of the sentinel are left unwritten.
template <typename T, int PER>
__global__ void __launch_bounds__(kWriteWarps * 32)
piece_sum_kernel(const T* __restrict__ dout, const int* __restrict__ keys,
                 const int* __restrict__ vals, float* __restrict__ head, float* __restrict__ tail,
                 int* __restrict__ head_len, long long n, int TR, int R, int E, long long st_b,
                 long long st_t) {
  const int lane = threadIdx.x & 31;
  const long long piece = (long long)blockIdx.x * kWriteWarps + (threadIdx.x >> 5);
  const long long p0 = piece * kPiece;
  if (p0 >= n) return;
  const long long p1 = min(n, p0 + kPiece);
  const int first = keys[p0], last = keys[p1 - 1];
  if (first >= TR) return;
  int n_head = 0, n_tail = 0;
  for (long long q = p0; q < p1; q += 32) {
    const int k = q + lane < p1 ? keys[q + lane] : -1;
    n_head += __popc(__ballot_sync(kFull, k == first));
    n_tail += __popc(__ballot_sync(kFull, k == last));
  }
  if (lane == 0) head_len[piece] = n_head;
  for (int c0 = 0; c0 < E; c0 += 32 * PER) {
    const int col = c0 + lane * PER;
    const bool active = col < E;
    float acc[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[k] = 0.f;
    sum_entries<T, PER>(dout + (long long)(first / R) * st_t, vals, p0, p0 + n_head, st_b, col,
                        active, lane, acc);
    if (active) store_f32<PER>(head + piece * E + col, acc);
    if (last >= TR) continue;
    if (last != first) {
#pragma unroll
      for (int k = 0; k < PER; ++k) acc[k] = 0.f;
      sum_entries<T, PER>(dout + (long long)(last / R) * st_t, vals, p1 - n_tail, p1, st_b, col,
                          active, lane, acc);
    }
    if (active) store_f32<PER>(tail + piece * E + col, acc);
  }
}

template <typename T>
__host__ __device__ __forceinline__ int run_rows(int E) {
  return (int)max(1LL, kRunBytes / ((long long)E * (long long)sizeof(T)));
}

// The first position p in keys[0, n) with keys[p] >= target, found by the
// whole warp: 32 probes a step, so a few dependent loads for millions of keys.
__device__ __forceinline__ long long lower_bound_warp(const int* keys, long long n, int target,
                                                      int lane) {
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const bool less = keys[lo + span * (lane + 1) / 33] < target;
    const int c = __popc(__ballot_sync(kFull, less));
    const long long new_lo = c ? lo + span * c / 33 + 1 : lo;
    if (c < 32) hi = lo + span * (c + 1) / 33;
    lo = new_lo;
  }
  const bool less = lo + lane < hi && keys[lo + lane] < target;
  return lo + __popc(__ballot_sync(kFull, less));
}

// One warp owns kRunBytes of the flat (T * R, E) output (run_rows<T>(E)
// rows; 16 fp32 or 32 bf16 rows at E 128) and writes each row once. It walks the sorted entries from its
// first row's segment on. A segment that lies inside one piece is summed
// entry by entry; one that crosses a piece boundary, from its first piece a
// to its last z, is tail[a] + head[a + 1] + ... + head[z].
template <typename T, int PER>
__global__ void __launch_bounds__(kWriteWarps * 32)
segment_write_kernel(const T* __restrict__ dout, const int* __restrict__ keys,
                     const int* __restrict__ vals, const float* __restrict__ head,
                     const float* __restrict__ tail, const int* __restrict__ head_len,
                     T* __restrict__ dtab, long long n, int TR, int R, int E, long long st_b,
                     long long st_t) {
  const int lane = threadIdx.x & 31;
  const int run = run_rows<T>(E);
  const long long row0 = ((long long)blockIdx.x * kWriteWarps + (threadIdx.x >> 5)) * run;
  if (row0 >= TR) return;  // whole warps leave; no block barrier below
  const int row_end = (int)min((long long)TR, row0 + run);
  const long long first = lower_bound_warp(keys, n, (int)row0, lane);
  for (int c0 = 0; c0 < E; c0 += 32 * PER) {
    const int col = c0 + lane * PER;
    const bool active = col < E;
    int cur = (int)row0;  // the next row to store
    float acc[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) acc[k] = 0.f;
    auto store_until = [&](int row) {  // rows cur .. row - 1 are complete
      for (; cur < row; ++cur) {
        if (active) store_row<T, PER>(dtab + (long long)cur * E + col, acc);
#pragma unroll
        for (int k = 0; k < PER; ++k) acc[k] = 0.f;
      }
    };
    long long p = first;
    int prev = -1;  // the key of entry p - 1 where p continues a segment
    while (true) {
      int key = 0x7fffffff;
      long long off = 0;  // where entry p + lane's dout row starts
      if (p + lane < n) {
        key = keys[p + lane];
        if (key < row_end) off = vals[p + lane] * st_b + (long long)(key / R) * st_t;
      }
      const int m = __popc(__ballot_sync(kFull, key < row_end));  // this run's entries
      int before = __shfl_up_sync(kFull, key, 1);
      if (lane == 0) before = prev;
      // a segment that starts here and reaches past the next piece boundary
      const long long boundary = ((p + lane) / kPiece + 1) * kPiece;
      const bool crosses = lane < m && key != before && boundary < n && keys[boundary] == key;
      const unsigned cross_at = __ballot_sync(kFull, crosses);
      const int stop = cross_at ? __ffs(cross_at) - 1 : m;  // entries added one by one
      for (int j0 = 0; j0 < stop; j0 += kInFlight) {
        float x[kInFlight][PER];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const long long oj = __shfl_sync(kFull, off, (j0 + u) & 31);
          if (j0 + u < stop && active) {
            load_row<T, PER>(dout + oj + col, x[u]);
          } else {
#pragma unroll
            for (int k = 0; k < PER; ++k) x[u][k] = 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int kj = __shfl_sync(kFull, key, (j0 + u) & 31);
          if (j0 + u < stop) {
            store_until(kj);
#pragma unroll
            for (int k = 0; k < PER; ++k) acc[k] += x[u][k];
          }
        }
      }
      if (cross_at) {
        const int kq = __shfl_sync(kFull, key, stop);
        store_until(kq);
        const long long a = (p + stop) / kPiece;
        if (active) {
#pragma unroll
          for (int k = 0; k < PER; ++k) acc[k] += tail[a * E + col + k];
        }
        // the pieces after a that start with kq: lanes probe 32 at once
        long long z = a + 1;
        int c = 32;
        while (c == 32) {
          const long long pc = (z + lane) * kPiece;
          const unsigned not_kq = ~__ballot_sync(kFull, pc < n && keys[pc] == kq);
          c = not_kq ? __ffs(not_kq) - 1 : 32;  // lane 0's piece starts with kq
          const float* y = head + z * E + col;
          for (int j0 = 0; j0 < c; j0 += kInFlight) {
            float x[kInFlight][PER];
#pragma unroll
            for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
              for (int k = 0; k < PER; ++k)
                x[u][k] = (active && j0 + u < c) ? y[(long long)(j0 + u) * E + k] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kInFlight; ++u)
#pragma unroll
              for (int k = 0; k < PER; ++k) acc[k] += x[u][k];
          }
          z += c;
        }
        p = (z - 1) * kPiece + head_len[z - 1];  // the segment ends in piece z - 1
        prev = kq;
        continue;
      }
      if (m < 32) break;
      prev = __shfl_sync(kFull, key, 31);
      p += 32;
    }
    store_until(row_end);
  }
}

cudaError_t radix_sort(KeySource src, long long n, int TR, int* keys, int* vals, int* keys_tmp,
                       int* vals_tmp, int* hist, cudaStream_t stream) {
  const int tiles = (int)((n + kSortTile - 1) / kSortTile);
  int* totals = hist + (long long)kRadix * tiles;
  int bits = 0;
  while ((1LL << bits) <= TR) ++bits;  // the sentinel TR is the largest key
  const int passes = (bits + kRadixBits - 1) / kRadixBits;
  for (int pass = 0; pass < passes; ++pass) {
    // the last pass lands in keys / vals
    const bool to_final = (passes - 1 - pass) % 2 == 0;
    int* k_out = to_final ? keys : keys_tmp;
    int* v_out = to_final ? vals : vals_tmp;
    const int shift = pass * kRadixBits;
    if (pass == 0) {
      radix_hist_kernel<true><<<tiles, kSortThreads, 0, stream>>>(src, n, shift, hist, tiles);
    } else {
      radix_hist_kernel<false><<<tiles, kSortThreads, 0, stream>>>(src, n, shift, hist, tiles);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    radix_scan_kernel<<<kRadix, kScanThreads, 0, stream>>>(hist, totals, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (pass == 0) {
      radix_scatter_kernel<true><<<tiles, kSortThreads, 0, stream>>>(src, n, shift, hist, totals,
                                                                      tiles, k_out, v_out);
    } else {
      radix_scatter_kernel<false><<<tiles, kSortThreads, 0, stream>>>(src, n, shift, hist, totals,
                                                                       tiles, k_out, v_out);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    src.keys = k_out;
    src.vals = v_out;
  }
  return cudaSuccess;
}

struct Pieces {
  float* head;
  float* tail;
  int* head_len;
};

template <typename T, int PER>
cudaError_t launch_pieces_and_write(const T* dout, const int* keys, const int* vals, Pieces pc,
                                    T* dtab, long long n, int TR, int R, int E, long long st_b,
                                    long long st_t, int stages, cudaStream_t stream) {
  if ((stages & 2) && n > 0) {
    const long long pieces = (n + kPiece - 1) / kPiece;
    piece_sum_kernel<T, PER><<<(unsigned)((pieces + kWriteWarps - 1) / kWriteWarps),
                               kWriteWarps * 32, 0, stream>>>(dout, keys, vals, pc.head, pc.tail,
                                                              pc.head_len, n, TR, R, E, st_b, st_t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    const long long warps = ((long long)TR + run_rows<T>(E) - 1) / run_rows<T>(E);
    segment_write_kernel<T, PER><<<(unsigned)((warps + kWriteWarps - 1) / kWriteWarps),
                                   kWriteWarps * 32, 0, stream>>>(
        dout, keys, vals, pc.head, pc.tail, pc.head_len, dtab, n, TR, R, E, st_b, st_t);
    return cudaGetLastError();
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_pieces_and_write(const void* dout, const int* keys, const int* vals, Pieces pc,
                                    void* dtab, long long n, int TR, int R, int E, long long st_b,
                                    long long st_t, int stages, cudaStream_t stream) {
  // four elements a lane: one 16-byte (fp32) or 8-byte (bf16) access
  const uintptr_t pack = 4 * sizeof(T);
  const bool vec = E % 4 == 0 && st_b % 4 == 0 && st_t % 4 == 0 &&
                   (uintptr_t)dout % pack == 0 && (uintptr_t)dtab % pack == 0;
  const T* d = static_cast<const T*>(dout);
  T* out = static_cast<T*>(dtab);
  if (vec)
    return launch_pieces_and_write<T, 4>(d, keys, vals, pc, out, n, TR, R, E, st_b, st_t, stages,
                                         stream);
  return launch_pieces_and_write<T, 1>(d, keys, vals, pc, out, n, TR, R, E, st_b, st_t, stages,
                                       stream);
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

// dout (B, T, E) of the table's type with unit stride along E; idx as above;
// dtab (T, R, E) contiguous, of dout's type. Scratch, all int32 but head and
// tail: keys, vals, keys_tmp, vals_tmp of n = B * T * L entries each; hist
// of 256 * ceil(n / 2048) + 256; head, tail fp32 (ceil(n / kPiece), E);
// head_len (ceil(n / kPiece),). After the sort stage keys / vals hold the
// sorted (key, payload) pairs. stages: a mask of 1 = sort, 2 = pieces,
// 4 = write; each stage reads what the stages before it wrote. T * R + 1 and
// n must fit in int32. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int repro_embedding_bag_backward(const void* dout, const void* idx, void* dtab,
                                            void* keys, void* vals, void* keys_tmp,
                                            void* vals_tmp, void* hist, void* head, void* tail,
                                            void* head_len, int B, int nT, int L, int R, int E,
                                            long long dout_st_b, long long dout_st_t,
                                            long long idx_st_b, long long idx_st_t,
                                            long long idx_st_l, int dtype, int stages,
                                            void* stream) {
  if (B <= 0 || nT <= 0 || L < 0 || R <= 0 || E <= 0) return (int)cudaErrorInvalidValue;
  const long long TR = (long long)nT * R, n = (long long)B * nT * L;
  if (TR + 1 > 2147483647LL || n > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* k = static_cast<int*>(keys);
  int* v = static_cast<int*>(vals);
  if ((stages & 1) && n > 0) {
    const KeySource src{static_cast<const int*>(idx), idx_st_b, idx_st_t, idx_st_l, nT, L, R,
                        nullptr, nullptr};
    const cudaError_t err = radix_sort(src, n, (int)TR, k, v, static_cast<int*>(keys_tmp),
                                       static_cast<int*>(vals_tmp), static_cast<int*>(hist), s);
    if (err != cudaSuccess) return (int)err;
  }
  const Pieces pc{static_cast<float*>(head), static_cast<float*>(tail),
                  static_cast<int*>(head_len)};
  if (dtype == 0)
    return (int)launch_pieces_and_write<float>(dout, k, v, pc, dtab, n, (int)TR, R, E, dout_st_b,
                                               dout_st_t, stages, s);
  return (int)launch_pieces_and_write<__nv_bfloat16>(dout, k, v, pc, dtab, n, (int)TR, R, E,
                                                     dout_st_b, dout_st_t, stages, s);
}
