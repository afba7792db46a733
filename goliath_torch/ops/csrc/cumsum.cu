// K4, K3 and K7: inclusive prefix sums.
//
// K4 (int32, one vector) serves the tile binning (goliath_torch/ops/
// binning.py, twice per render) and the sorted scatter-add
// (goliath_torch/ops/scatter.py), and replaces the JAX package's
// ops/gsplat_pallas.py `_cumsum1d_kernel` via `cumsum1d_pl`. K3 and K7 scan
// F independent float32 columns of n items each: the rows of a contiguous
// [F, n] array (K3) or the columns of a contiguous [n, F] array (K7). K3
// (F = 6 + C columns of per-pair gradients, n = the pair budget) serves the
// per-prim gradient reduce of the compositor backward (goliath_torch/ops/
// gsplat.py `reduce_sorted_pair_grads`) and the sorted scatter-add; it
// replaces `_cumsum1d_batched_kernel` via `cumsum_cols_pl` (pallas_call at
// gsplat_pallas.py:230). K7 (axis 0 of a row-major [M, F] array) serves
// the presort reduce (goliath_torch/ops/gsplat.py
// `reduce_presort_pair_grads`, which the render path does not take, as in
// the JAX package) and goliath_torch/scripts/profile_reduce.py; it replaces
// `_cumsum_rows_kernel` via `cumsum_rows_pl` (pallas_call at
// gsplat_pallas.py:98).
//
// The TPU kernels walk a sequential grid with an f32 carry in VMEM scratch
// (exact for integers only below 2^24); the batched one packs all F columns
// into one block because each sequential grid step pays a DMA latency.
// Hopper blocks run in no order.
//
// K4 is a single-pass scan with decoupled look-back (`scan_lookback`): one
// launch, after one memset of its flag words. Each block draws its tile of
// SP_TILE items by an atomic ticket, so a block only ever waits on blocks
// that started before it and the look-back cannot deadlock whatever order
// the card schedules blocks in. It loads its items with 16-byte loads,
// scans them in registers and warps, publishes its tile's aggregate, looks
// back over its predecessors' flag words (a warp reads 32 at a time) until
// it meets an inclusive prefix, publishes its own inclusive prefix, and
// writes its outputs once. A flag word packs the status and the 32-bit
// value into one 64-bit word, written by one volatile store and read by
// volatile loads, so a reader never sees a status without its value. The
// carry is 32-bit unsigned arithmetic: exact over the whole int32 range,
// wrapping where torch.cumsum(dtype=int32) wraps. Bound: bytes, 4 read + 4
// written per item (a 3M-item scan ~25 MB, ~7.5 us at 3.35 TB/s); at the
// binning's 1M and 3M items the launch and the look-back chain are of the
// same order.
//
// K3 is a single pass too (`scan_cols_lookback`): one memset of its flag
// words, then one kernel that reads each item once and writes it once.
// Bound: bytes, 4 read + 4 written per item: 0.0751 ms at [10, 3,145,728]
// (the per-sample training step's reduce, 252 MB) and 0.300 ms at
// [10, 12,582,912] (the folded step's, 1.0 GB), at 3.35 TB/s.
//   - Tiles: 4096 items of one column (256 threads x 4 float4 loads), drawn
//     by an atomic ticket k -> (tile k / F, column k % F), so a tile's
//     predecessors in its column hold smaller tickets: a block waits only
//     on blocks that started before it. A row of [F, n] with n not a
//     multiple of 4 may start unaligned; such a row takes scalar loads.
//   - In the tile: float32 scans of each thread's float4s, then warp
//     shuffles, then the 32 (vector, warp) totals by one warp, in a fixed
//     order; the tile's aggregate A(t) is their float32 total.
//   - The carry is float64. E(t), the sum of the column's tiles before t,
//     is defined as the left fold in tile order,
//       E(t) = ((0 + A(0)) + A(1)) + ... + A(t - 1)   (float64 adds),
//     and I(t) = E(t) + A(t). Each tile publishes A(t), then I(t), each as
//     one 64-bit word (two arrays, agg and incl). Look-back: lane l of one
//     warp reads the flags of tile t - 1 - l (a virtual I(-1) = 0 before
//     tile 0) until one of the 32 shows I; the nearest such tile a then
//     gives E(t) = (I(a) + A(a + 1)) + ... + A(t - 1), added one at a time
//     in increasing tile order (the aggregates of the tiles between a and
//     t are awaited: they started earlier and publish A without waiting).
//     At most 31 aggregates are folded, and no stash is needed.
//   - Why the bits do not depend on timing: A(t) is a function of the
//     tile's items alone. By induction I(a) is the left fold up to a, so
//     folding on from it gives the left fold up to t - 1 whichever a the
//     look-back found: E(t), I(t) and every output, (float)(E(t) +
//     (double)local prefix), are the same on every call.
//   - Flag words: the bitwise complement of the double's bits, so the
//     memset's 0 means "not yet published" (the complement of the NaN
//     pattern 0xffffffffffffffff); a NaN is published as the canonical
//     0x7ff8000000000000, so no published word is 0. The ticket counter is
//     the first word, zeroed by the same memset.
//   - Precision: a float64 carry does not grow with the chain of 768 (or
//     3,072) tiles; each output is the float32 tile-local prefix (error a
//     few ulp of the tile's partial sums) added to E in float64 and rounded
//     once.
// K4 keeps its own kernel (int32, one column): sharing would put K3's
// float64 fold on the binning's path.
//
// K7 is the classic three-step float32 scan, with the column as the grid's
// second axis and the layout as a template flag (kRowMajor false: a column
// is a contiguous row of [F, n], used by the recursion on the block totals;
// true: a column of [n, F], its items F apart):
//   1. scan_blocks: each block scans 4096 items of one column (1024
//      threads x 4) with warp shuffles and writes its total to scratch;
//   2. the block totals [F, blocks] are scanned by the same routine
//      (recursively);
//   3. add_offsets adds the scanned total of the blocks before each block.
// Float addition is not associative: K3 and K7 add in their own orders,
// torch.cumsum in its own, so they agree to rounding, a few ulp of the
// largest running sum of the column. K7 reads its columns F items apart,
// so neighbouring threads do not read neighbouring words: each column's
// block pulls the same cache lines as the other F - 1 (from L2); a block
// that scanned all F columns of its rows at once would read each line once.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the scratch (`goliath_cumsum_scratch_len`,
// `goliath_cumsum_f32_scratch_len`, `goliath_cumsum_i32_scratch_len`): the
// launchers allocate nothing, launch on the given stream and do not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCAN_THREADS 1024
#define SCAN_ITEMS 4
#define SCAN_BLOCK (SCAN_THREADS * SCAN_ITEMS)

// `in` and `out` are not __restrict__: the scan of the block totals runs in
// place (in == out). blockIdx.y is the column of the gridDim.y columns
// (layout as kRowMajor says); their block totals are gridDim.x apart (a
// contiguous [F, blocks] array).
template <bool kRowMajor>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_blocks(const float* in, float* out, float* __restrict__ block_sums,
            long long n) {
  __shared__ float warp_sums[SCAN_THREADS / 32];
  const long long col = kRowMajor ? blockIdx.y : (long long)blockIdx.y * n;
  const long long step = kRowMajor ? gridDim.y : 1;
  in += col;
  out += col;
  const long long base = (long long)blockIdx.x * SCAN_BLOCK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // each thread scans SCAN_ITEMS consecutive items in registers. Every
  // item is read and written by the same thread only, and every read comes
  // before the barriers below, so in == out is safe.
  float v[SCAN_ITEMS];
  float local = 0.0f;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long idx = base + (long long)tid * SCAN_ITEMS + i;
    local += (idx < n) ? in[idx * step] : 0.0f;
    v[i] = local;
  }

  // inclusive scan of the thread totals within the warp
  float x = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();

  // inclusive scan of the 32 warp totals by warp 0
  if (warp == 0) {
    float s = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();

  const float prefix = (x - local) + (warp > 0 ? warp_sums[warp - 1] : 0.0f);
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long idx = base + (long long)tid * SCAN_ITEMS + i;
    if (idx < n) out[idx * step] = v[i] + prefix;
  }
  if (block_sums != nullptr && tid == 0)
    block_sums[(long long)blockIdx.y * gridDim.x + blockIdx.x] =
        warp_sums[SCAN_THREADS / 32 - 1];
}

template <bool kRowMajor>
__global__ void __launch_bounds__(SCAN_THREADS)
add_offsets(float* __restrict__ out, const float* __restrict__ scanned,
            long long n) {
  if (blockIdx.x == 0) return;
  const long long step = kRowMajor ? gridDim.y : 1;
  out += kRowMajor ? blockIdx.y : (long long)blockIdx.y * n;
  const float off =
      scanned[(long long)blockIdx.y * gridDim.x + blockIdx.x - 1];
  const long long base = (long long)blockIdx.x * SCAN_BLOCK;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const long long idx = base + (long long)i * SCAN_THREADS + threadIdx.x;
    if (idx < n) out[idx * step] += off;
  }
}

// Scratch items the scan of one column of n items needs: the block totals
// of every level above the first. F columns need F times as many.
extern "C" long long goliath_cumsum_scratch_len(long long n) {
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  return nb <= 1 ? 0 : nb + goliath_cumsum_scratch_len(nb);
}

// Inclusive scan of each of the n_cols columns of n items (layout as
// kRowMajor says) of `in` into `out`, which has the same layout. Returns the
// first CUDA error of the launches (0 on success).
template <bool kRowMajor>
static int cumsum_cols(const float* in, float* out, float* scratch,
                       int n_cols, long long n, cudaStream_t stream) {
  if (n <= 0 || n_cols <= 0) return 0;
  if (n_cols > 65535) return (int)cudaErrorInvalidValue;  // grid y limit
  const long long nb = (n + SCAN_BLOCK - 1) / SCAN_BLOCK;
  const dim3 grid((unsigned)nb, (unsigned)n_cols);
  scan_blocks<kRowMajor><<<grid, SCAN_THREADS, 0, stream>>>(
      in, out, nb > 1 ? scratch : nullptr, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return (int)err;
  // the block totals form a contiguous [n_cols, nb] array
  const int rec = cumsum_cols<false>(scratch, scratch, scratch + n_cols * nb,
                                     n_cols, nb, stream);
  if (rec != 0) return rec;
  add_offsets<kRowMajor><<<grid, SCAN_THREADS, 0, stream>>>(out, scratch, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: single-pass int32 scan with decoupled look-back
// ---------------------------------------------------------------------------

#define SP_THREADS 256
#define SP_VECS 4                             // int4 loads per thread
#define SP_TILE (SP_THREADS * SP_VECS * 4)    // 4096 items per tile
#define SP_WARPS (SP_THREADS / 32)
// flag word: status in the high 32 bits, value in the low 32
#define SP_EMPTY 0ull
#define SP_AGGREGATE 1ull
#define SP_INCLUSIVE 2ull

__device__ __forceinline__ unsigned warp_incl_scan(unsigned x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// scratch: [0] the ticket counter (zeroed by the launcher's memset), then
// one flag word per tile. Vector v = j * SP_THREADS + threadIdx.x of the
// tile holds items [4v, 4v + 4): every load and store of a warp covers 512
// contiguous bytes.
__global__ void __launch_bounds__(SP_THREADS)
scan_lookback(const int32_t* __restrict__ in, int32_t* __restrict__ out,
              unsigned long long* __restrict__ scratch, long long n,
              bool vec_ok) {
  __shared__ unsigned s_warp[SP_VECS * SP_WARPS];  // [j][warp] totals
  __shared__ unsigned s_tile;
  __shared__ unsigned s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd((unsigned*)scratch, 1u);
  __syncthreads();
  const unsigned tile = s_tile;
  volatile unsigned long long* flags =
      (volatile unsigned long long*)(scratch + 1);
  const long long base = (long long)tile * SP_TILE;

  // load and scan each 4-item vector in registers
  unsigned v[SP_VECS][4];
#pragma unroll
  for (int j = 0; j < SP_VECS; ++j) {
    const long long i0 = base + 4ll * (j * SP_THREADS + tid);
    if (vec_ok && i0 + 4 <= n) {
      const int4 q = *reinterpret_cast<const int4*>(in + i0);
      v[j][0] = q.x; v[j][1] = q.y; v[j][2] = q.z; v[j][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = i0 + k < n ? in[i0 + k] : 0;
    }
#pragma unroll
    for (int k = 1; k < 4; ++k) v[j][k] += v[j][k - 1];
  }
  // scan the vectors' totals: within each warp, then the SP_VECS x
  // SP_WARPS warp totals (one warp's worth) in vector order (j, then warp)
  unsigned wx[SP_VECS];
#pragma unroll
  for (int j = 0; j < SP_VECS; ++j) {
    wx[j] = warp_incl_scan(v[j][3], lane);
    if (lane == 31) s_warp[j * SP_WARPS + warp] = wx[j];
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned tot = s_warp[lane];
    const unsigned incl = warp_incl_scan(tot, lane);
    s_warp[lane] = incl - tot;  // exclusive
    if (lane == 31) {            // the tile's aggregate
      flags[tile] = ((tile == 0 ? SP_INCLUSIVE : SP_AGGREGATE) << 32) | incl;
      if (tile == 0) s_prefix = 0u;
    }
    if (tile > 0) {
      // look back: lane l reads the flag of tile (w - 1 - l) until every
      // lane of the window has one, then adds the aggregates up to the
      // nearest inclusive prefix (tile 0 always publishes one)
      unsigned excl = 0u;
      long long w = tile;
      while (true) {
        const long long pred = w - 1 - lane;
        // before tile 0: an inclusive prefix of 0
        unsigned long long f = pred >= 0 ? flags[pred] : SP_INCLUSIVE << 32;
        while (!__all_sync(0xffffffffu, (f >> 32) != SP_EMPTY)) {
          if ((f >> 32) == SP_EMPTY) f = flags[pred];
        }
        const unsigned incl_mask =
            __ballot_sync(0xffffffffu, (f >> 32) == SP_INCLUSIVE);
        const int stop = incl_mask ? __ffs(incl_mask) - 1 : 31;
        unsigned part = lane <= stop ? (unsigned)f : 0u;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        excl += part;
        if (incl_mask) break;
        w -= 32;
      }
      if (lane == 31) {
        flags[tile] = (SP_INCLUSIVE << 32) | (excl + incl);
        s_prefix = excl;
      }
    }
  }
  __syncthreads();
  const unsigned prefix = s_prefix;
#pragma unroll
  for (int j = 0; j < SP_VECS; ++j) {
    const unsigned off = prefix + s_warp[j * SP_WARPS + warp] + wx[j] -
                         v[j][3];
    const long long i0 = base + 4ll * (j * SP_THREADS + tid);
    if (vec_ok && i0 + 4 <= n) {
      *reinterpret_cast<int4*>(out + i0) =
          make_int4((int)(off + v[j][0]), (int)(off + v[j][1]),
                    (int)(off + v[j][2]), (int)(off + v[j][3]));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) out[i0 + k] = (int)(off + v[j][k]);
    }
  }
}

// 64-bit scratch words K4 needs for n items: the ticket and one flag word
// per tile.
extern "C" long long goliath_cumsum_i32_scratch_len(long long n) {
  return 1 + (n + SP_TILE - 1) / SP_TILE;
}

// K4. `scratch` holds at least goliath_cumsum_i32_scratch_len(n) 64-bit
// words; the launcher zeroes them with one memset, then launches one
// kernel. Returns the first CUDA error (0 on success).
extern "C" int goliath_cumsum_i32(const int32_t* in, int32_t* out,
                                  unsigned long long* scratch, long long n,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long tiles = (n + SP_TILE - 1) / SP_TILE;
  if (tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(tiles + 1) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec_ok = ((uintptr_t)in % 16 == 0) && ((uintptr_t)out % 16 == 0);
  scan_lookback<<<(unsigned)tiles, SP_THREADS, 0, stream>>>(in, out, scratch,
                                                            n, vec_ok);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3: single-pass float32 column scan, float64 carry folded in tile order
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_incl_scan_f(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// a published flag word: the complement of the (canonical-NaN) bits
__device__ __forceinline__ unsigned long long k3_word(double v) {
  const long long bits =
      v != v ? 0x7ff8000000000000ll : __double_as_longlong(v);
  return ~(unsigned long long)bits;
}

__device__ __forceinline__ double k3_value(unsigned long long w) {
  return __longlong_as_double((long long)~w);
}

// scratch: [0] the ticket counter, then agg [n_cols, tiles] and incl
// [n_cols, tiles] flag words, all zeroed by the launcher's memset. Vector
// v = j * SP_THREADS + threadIdx.x of the tile holds items [4v, 4v + 4).
__global__ void __launch_bounds__(SP_THREADS)
scan_cols_lookback(const float* __restrict__ in, float* __restrict__ out,
                   unsigned long long* __restrict__ scratch, int n_cols,
                   long long n, long long tiles) {
  __shared__ float s_warp[SP_VECS * SP_WARPS];  // [j][warp] exclusive
  __shared__ unsigned s_ticket;
  __shared__ double s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd((unsigned*)scratch, 1u);
  __syncthreads();
  const long long tile = s_ticket / (unsigned)n_cols;
  const int col = (int)(s_ticket % (unsigned)n_cols);
  volatile unsigned long long* agg =
      (volatile unsigned long long*)(scratch + 1) + (long long)col * tiles;
  volatile unsigned long long* incl = agg + (long long)n_cols * tiles;
  in += (long long)col * n;
  out += (long long)col * n;
  const bool vec_ok = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  const long long base = tile * SP_TILE;

  float v[SP_VECS][4];
#pragma unroll
  for (int j = 0; j < SP_VECS; ++j) {
    const long long i0 = base + 4ll * (j * SP_THREADS + tid);
    if (vec_ok && i0 + 4 <= n) {
      const float4 q = *reinterpret_cast<const float4*>(in + i0);
      v[j][0] = q.x; v[j][1] = q.y; v[j][2] = q.z; v[j][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[j][k] = i0 + k < n ? in[i0 + k] : 0.0f;
    }
  }
  // each float4 scanned in registers, its total scanned within the warp
  // (the thread's exclusive prefix by a shuffle, not a subtraction)
  float wex[SP_VECS];
#pragma unroll
  for (int j = 0; j < SP_VECS; ++j) {
#pragma unroll
    for (int k = 1; k < 4; ++k) v[j][k] += v[j][k - 1];
    const float wx = warp_incl_scan_f(v[j][3], lane);
    const float up = __shfl_up_sync(0xffffffffu, wx, 1);
    wex[j] = lane > 0 ? up : 0.0f;
    if (lane == 31) s_warp[j * SP_WARPS + warp] = wx;
  }
  __syncthreads();
  if (warp == 0) {
    // the SP_VECS x SP_WARPS totals in vector order (j, then warp)
    const float incl_f = warp_incl_scan_f(s_warp[lane], lane);
    const float up = __shfl_up_sync(0xffffffffu, incl_f, 1);
    s_warp[lane] = lane > 0 ? up : 0.0f;
    const double a_t = (double)__shfl_sync(0xffffffffu, incl_f, 31);
    if (lane == 0) agg[tile] = k3_word(a_t);
    double e_t = 0.0;
    if (tile > 0) {
      // look back until one of the 32 nearest predecessors shows I
      const long long pred = tile - 1 - lane;
      unsigned long long fi = pred >= 0 ? incl[pred] : k3_word(0.0);
      unsigned mask;
      while ((mask = __ballot_sync(0xffffffffu, fi != 0ull)) == 0u)
        fi = incl[pred];  // every lane has pred >= 0 here
      const int stop = __ffs(mask) - 1;  // the nearest tile with I
      // the aggregates of the tiles between it and this one
      unsigned long long fa = lane < stop ? agg[pred] : 1ull;
      while (!__all_sync(0xffffffffu, fa != 0ull)) {
        if (fa == 0ull) fa = agg[pred];
      }
      const double a_l = lane < stop ? k3_value(fa) : 0.0;
      // fold in increasing tile order: lane stop - 1 first, lane 0 last
      e_t = __shfl_sync(0xffffffffu, k3_value(fi), stop);
#pragma unroll
      for (int l = 30; l >= 0; --l) {
        const double x = __shfl_sync(0xffffffffu, a_l, l);
        if (l < stop) e_t += x;
      }
    }
    if (lane == 0) {
      incl[tile] = k3_word(e_t + a_t);
      s_prefix = e_t;
    }
  }
  __syncthreads();
  const double e_t = s_prefix;
#pragma unroll
  for (int j = 0; j < SP_VECS; ++j) {
    const float off = s_warp[j * SP_WARPS + warp] + wex[j];
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = (float)(e_t + (double)(off + v[j][k]));
    const long long i0 = base + 4ll * (j * SP_THREADS + tid);
    if (vec_ok && i0 + 4 <= n) {
      *reinterpret_cast<float4*>(out + i0) = make_float4(o[0], o[1], o[2],
                                                         o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i0 + k < n) out[i0 + k] = o[k];
    }
  }
}

// 64-bit scratch words K3 needs for n_cols columns of n items: the ticket
// and two flag words per tile.
extern "C" long long goliath_cumsum_f32_scratch_len(int n_cols, long long n) {
  return 1 + 2 * (long long)n_cols * ((n + SP_TILE - 1) / SP_TILE);
}

// K3. in/out: [n_cols, n] f32; `scratch` holds at least
// goliath_cumsum_f32_scratch_len(n_cols, n) 64-bit words; the launcher
// zeroes them with one memset, then launches one kernel. Returns the first
// CUDA error (0 on success).
extern "C" int goliath_cumsum_cols_f32(const float* in, float* out,
                                       unsigned long long* scratch,
                                       int n_cols, long long n,
                                       cudaStream_t stream) {
  if (n <= 0 || n_cols <= 0) return 0;
  const long long tiles = (n + SP_TILE - 1) / SP_TILE;
  if (tiles * n_cols > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0,
      (size_t)goliath_cumsum_f32_scratch_len(n_cols, n) *
          sizeof(unsigned long long),
      stream);
  if (err != cudaSuccess) return (int)err;
  scan_cols_lookback<<<(unsigned)(tiles * n_cols), SP_THREADS, 0, stream>>>(
      in, out, scratch, n_cols, n, tiles);
  return (int)cudaGetLastError();
}

// K7. in/out: [n, n_cols] f32, scanned along axis 0; `scratch` holds at
// least n_cols * goliath_cumsum_scratch_len(n) floats.
extern "C" int goliath_cumsum_rows_f32(const float* in, float* out,
                                       float* scratch, int n_cols,
                                       long long n, cudaStream_t stream) {
  return cumsum_cols<true>(in, out, scratch, n_cols, n, stream);
}
