// K4, K3 and K7: inclusive prefix sums.
//
// K4 (int32, one vector) serves the tile binning (goliath_torch/ops/
// binning.py, twice per render) and the sorted scatter-add
// (goliath_torch/ops/scatter.py), and replaces the JAX package's
// ops/gsplat_pallas.py `_cumsum1d_kernel` via `cumsum1d_pl`. K3 and K7 scan
// F independent float32 columns of n items each: the rows of a contiguous
// [F, n] array (K3) or the columns of a contiguous row-major [n, F] array
// (K7). K3 (F = 6 + C columns of per-pair gradients, n = the pair budget)
// serves the per-prim gradient reduce of the compositor backward
// (goliath_torch/ops/gsplat.py `reduce_sorted_pair_grads`) and the sorted
// scatter-add; it replaces `_cumsum1d_batched_kernel` via `cumsum_cols_pl`
// (pallas_call at gsplat_pallas.py:230). K7 (axis 0 of [n, F]) serves the
// presort reduce (goliath_torch/ops/gsplat.py `reduce_presort_pair_grads`,
// which the render path does not take, as in the JAX package) and
// goliath_torch/scripts/profile_reduce.py; it replaces `_cumsum_rows_kernel`
// via `cumsum_rows_pl` (pallas_call at gsplat_pallas.py:98).
//
// The TPU kernels walk a sequential grid with an f32 carry in VMEM scratch
// (exact for integers only below 2^24); the batched one packs all F columns
// into one block because each sequential grid step pays a DMA latency, and
// the row kernel scans each [block, F] block by a triangular matmul.
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
// K7 is a single pass too (`scan_rows_lookback`): one memset of its flag
// words, then one kernel that reads each item once and writes it once.
// Bound: bytes, 4 read + 4 written per item: 0.0501 ms at [2,097,152, 10]
// (profile_reduce's budget, 168 MB), 0.0751 ms at [3,145,728, 10] (the
// per-sample pair budget) and 0.300 ms at [12,582,912, 10] (the folded
// one), at 3.35 TB/s. It reads whole lines: a block that scanned one
// column would load words F floats apart, each line pulled by F blocks.
//   - Tiles: R consecutive rows and all the columns of a window (the F
//     columns when F <= 32, else ceil(F / 32) windows of equal width),
//     drawn by an atomic ticket k -> (tile k / windows, window k % windows),
//     so a tile's predecessors in its window hold smaller tickets and a
//     block waits only on blocks that started before it. With one window a
//     tile is R * F contiguous floats, read with 16-byte loads when `in`
//     and `out` start on 16-byte boundaries (R is a multiple of 32, so
//     every tile does too) and with scalar loads otherwise (x[1:] of an
//     F = 3 tensor starts 12 bytes in); several windows read row segments
//     with scalar loads. Any F >= 1: no grid axis per column.
//   - The block stages the tile in shared memory, flat (row-major) with one
//     pad word after every 32 (`k7_pad`), so that a warp's stores of the
//     j-th words of its 32 float4s land in 32 banks.
//   - Warp w scans the columns w, w + warps, ... of the window, a warp a
//     column at F = 10: lane l sums a run of K consecutive rows of the
//     column, a warp scan (shuffles) of the 32 run totals follows, and the
//     tile's chunks of 32 K rows follow each other with a carry. A warp
//     owns its column, so no cross-warp pass and no barrier stand between
//     the scan and the look-back, and the warps look back on their columns
//     at once. Every add is float64: pass 1 gives the tile's aggregate
//     A(t, c); after the look-back, pass 2 reads the runs again, repeats
//     the same adds from E(t, c) on and writes each item's output, rounded
//     once to float32, in its place in shared memory. K = 32 / 2^a, where 2^a
//     is the largest power of two (at most 32) that divides the window's
//     width W: neighbouring lanes' runs then start 32 q words apart with
//     q = K W / 32 odd, which the pad turns into 32 different banks. K is
//     halved while one chunk (32 K W items) exceeds K7_TILE_ITEMS (16,384,
//     66 KB with the pad), and the tile holds as many chunks as fit:
//     F = 10 takes K = 16, R = 1,536 rows (15,360 items, 63 KB) and 10
//     warps (64 registers a thread: 3 blocks an SM).
//   - Why tiles that large: the block's phases (load, pass 1, look-back,
//     pass 2, store) do not overlap, so the bytes in flight are what the
//     blocks in their load phase ask for. At [2,097,152, 10] tiles of 512
//     rows took 0.149 ms, 1,024 rows 0.088 ms, 1,536 rows 0.080 ms and
//     2,048 rows (2 blocks an SM) 0.082 ms (scripts/time_scans.py, NVIDIA
//     H100 80GB HBM3 at 700 W; a float32 scan above the runs then).
//   - The carry is K3's, per column: E(t, c) is the left fold of the
//     column's tile aggregates in tile order, found by the look-back from
//     the nearest published inclusive prefix (`fold_lookback`, shared with
//     K3); one aggregate word and one inclusive word per (tile, column) in
//     K3's encoding, zeroed by the memset. A(t, c) depends on the tile's
//     items alone, so every output has the same bits on every call
//     whatever the timing.
//   - The block stores the outputs from shared memory with 16-byte stores
//     (scalar ones where the loads were).
//   - Precision: float32 inputs are exact in float64, so each output's
//     error is its one rounding to float32 plus the float64 adds' (K3, whose
//     tile prefix is float32, is 2-3e-7 of the running sum from a float64
//     scan; a float32 aggregate here gave 4.7e-7 at [2,097,152, 10] on the
//     card, its roundings gathered along the chain of 1,366 tiles).
// K4, K3 and K7 add in their own orders and torch.cumsum in its own, so
// the float scans agree with it to rounding, a few ulp of the largest
// running sum of the column.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the scratch (`goliath_cumsum_i32_scratch_len`,
// `goliath_cumsum_f32_scratch_len`, `goliath_cumsum_rows_scratch_len`): the
// launchers allocate nothing, launch on the given stream and do not
// synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

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

// a warp's inclusive scan: K4 (unsigned), K3 (float) and K7 (double)
template <typename T>
__device__ __forceinline__ T warp_incl_scan(T x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
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

// a published flag word: the complement of the (canonical-NaN) bits
__device__ __forceinline__ unsigned long long k3_word(double v) {
  const long long bits =
      v != v ? 0x7ff8000000000000ll : __double_as_longlong(v);
  return ~(unsigned long long)bits;
}

__device__ __forceinline__ double k3_value(unsigned long long w) {
  return __longlong_as_double((long long)~w);
}

// E(t) of one column for a whole warp (K3 and K7): the left fold in tile
// order of the aggregates of the tiles before `tile`, from the nearest
// inclusive prefix among the 32 predecessors the warp reads at a time (a
// virtual I(-1) = 0 before tile 0). agg and incl are the column's flag
// words; the tiles between that prefix and this tile started earlier and
// publish their aggregates without waiting, so the wait ends.
__device__ __forceinline__ double fold_lookback(
    const volatile unsigned long long* agg,
    const volatile unsigned long long* incl, long long tile, int lane) {
  if (tile == 0) return 0.0;
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
  double e_t = __shfl_sync(0xffffffffu, k3_value(fi), stop);
#pragma unroll
  for (int l = 30; l >= 0; --l) {
    const double x = __shfl_sync(0xffffffffu, a_l, l);
    if (l < stop) e_t += x;
  }
  return e_t;
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
    const float wx = warp_incl_scan(v[j][3], lane);
    const float up = __shfl_up_sync(0xffffffffu, wx, 1);
    wex[j] = lane > 0 ? up : 0.0f;
    if (lane == 31) s_warp[j * SP_WARPS + warp] = wx;
  }
  __syncthreads();
  if (warp == 0) {
    // the SP_VECS x SP_WARPS totals in vector order (j, then warp)
    const float incl_f = warp_incl_scan(s_warp[lane], lane);
    const float up = __shfl_up_sync(0xffffffffu, incl_f, 1);
    s_warp[lane] = lane > 0 ? up : 0.0f;
    const double a_t = (double)__shfl_sync(0xffffffffu, incl_f, 31);
    if (lane == 0) agg[tile] = k3_word(a_t);
    const double e_t = fold_lookback(agg, incl, tile, lane);
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

// ---------------------------------------------------------------------------
// K7: single-pass float32 row scan of [n, F], K3's carry per column
// ---------------------------------------------------------------------------

#define K7_TILE_ITEMS 16384  // the most floats a tile stages
#define K7_WINDOW_COLS 32    // the most columns of a window
#define K7_MIN_WARPS 8       // warps that load and store, scanning or not
#define K7_MAX_WARPS 16
#define K7_LOADS 8           // float4 loads a thread keeps in flight

// the tile's flat item i in shared memory: one pad word after every 32
__host__ __device__ __forceinline__ int k7_pad(int i) {
  return i + (i >> 5);
}

// The tiling of n rows of n_cols columns (see the note at the top).
struct K7Tiling {
  int windows, width;  // column windows and their width (the last narrower)
  int run, rows;       // K rows a lane scans at once; R rows a tile
  int warps;
  long long tiles;     // tiles of R rows
};

static K7Tiling k7_tiling(int n_cols, long long n) {
  K7Tiling t;
  t.windows = (n_cols + K7_WINDOW_COLS - 1) / K7_WINDOW_COLS;
  t.width = (n_cols + t.windows - 1) / t.windows;
  t.run = 32;
  for (int w = t.width; t.run > 1 && w % 2 == 0; w /= 2) t.run /= 2;
  while (t.run > 1 && 32 * t.run * t.width > K7_TILE_ITEMS) t.run /= 2;
  t.rows = 32 * t.run * (K7_TILE_ITEMS / (32 * t.run * t.width));
  const int per_warp = (t.width + K7_MAX_WARPS - 1) / K7_MAX_WARPS;
  t.warps = (t.width + per_warp - 1) / per_warp;
  if (t.warps < K7_MIN_WARPS) t.warps = K7_MIN_WARPS;
  t.tiles = (n + t.rows - 1) / t.rows;
  return t;
}

// scratch: [0] the ticket counter, then agg [n_cols, tiles] and incl
// [n_cols, tiles] flag words, all zeroed by the launcher's memset. Dynamic
// shared memory: the tile, rows x width floats with their pad words.
template <int K>
__global__ void __launch_bounds__(K7_MAX_WARPS * 32)
scan_rows_lookback(const float* __restrict__ in, float* __restrict__ out,
                   unsigned long long* __restrict__ scratch, int n_cols,
                   long long n, long long tiles, int windows, int width,
                   int rows, bool vec_ok) {
  extern __shared__ float s_tile[];
  __shared__ double s_e[K7_WINDOW_COLS];  // A(t, c)
  __shared__ unsigned s_ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  if (tid == 0) s_ticket = atomicAdd((unsigned*)scratch, 1u);
  __syncthreads();
  const long long tile = s_ticket / (unsigned)windows;
  const int c0 = (int)(s_ticket % (unsigned)windows) * width;
  const int wc = min(width, n_cols - c0);      // this window's columns
  const long long r0 = tile * rows;
  const int nr = (int)min((long long)rows, n - r0);  // rows of the tile
  const int items = rows * wc;  // staged; rows past n as zeros
  const bool vec = vec_ok && windows == 1;
  const int valid = nr * wc;    // with one window: the tile's floats

  // stage the tile
  if (vec) {
    const float* src = in + r0 * n_cols;
    for (int v0 = 0; v0 < items / 4; v0 += K7_LOADS * blockDim.x) {
      float4 q[K7_LOADS];
#pragma unroll
      for (int m = 0; m < K7_LOADS; ++m) {
        const int i = 4 * (v0 + m * blockDim.x + tid);
        if (i + 4 <= valid) {
          q[m] = *reinterpret_cast<const float4*>(src + i);
        } else {
          q[m].x = i < valid ? src[i] : 0.0f;
          q[m].y = i + 1 < valid ? src[i + 1] : 0.0f;
          q[m].z = i + 2 < valid ? src[i + 2] : 0.0f;
          q[m].w = i + 3 < valid ? src[i + 3] : 0.0f;
        }
      }
#pragma unroll
      for (int m = 0; m < K7_LOADS; ++m) {
        const int i = 4 * (v0 + m * blockDim.x + tid);
        if (i < items) {
          s_tile[k7_pad(i)] = q[m].x;
          s_tile[k7_pad(i + 1)] = q[m].y;
          s_tile[k7_pad(i + 2)] = q[m].z;
          s_tile[k7_pad(i + 3)] = q[m].w;
        }
      }
    }
  } else {
    for (int i = tid; i < items; i += blockDim.x) {
      const int r = i / wc;
      s_tile[k7_pad(i)] =
          r < nr ? in[(r0 + r) * n_cols + c0 + (i - r * wc)] : 0.0f;
    }
  }
  __syncthreads();

  // pass 1, each warp on its columns: the float64 totals of runs of K
  // rows a lane, scanned across the warp, chunk after chunk, give A(t, c)
  volatile unsigned long long* agg =
      (volatile unsigned long long*)(scratch + 1);
  volatile unsigned long long* incl = agg + (long long)n_cols * tiles;
  for (int c = warp; c < wc; c += warps) {
    double a_t = 0.0;
    for (int j = 0; j < rows; j += 32 * K) {
      const int i0 = (j + lane * K) * wc + c;
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < K; ++k) run += (double)s_tile[k7_pad(i0 + k * wc)];
      a_t += __shfl_sync(0xffffffffu, warp_incl_scan(run, lane), 31);
    }
    if (lane == 0) {
      agg[(long long)(c0 + c) * tiles + tile] = k3_word(a_t);
      s_e[c] = a_t;
    }
  }
  // the look-back on each of them; then pass 2 writes each item's
  // (float)(E(t, c) + the float64 prefix of the tile's items up to it) in
  // its place, the same adds in the same order as pass 1
  for (int c = warp; c < wc; c += warps) {
    const long long col = (long long)(c0 + c) * tiles;
    const double e_t = fold_lookback(agg + col, incl + col, tile, lane);
    if (lane == 0) incl[col + tile] = k3_word(e_t + s_e[c]);
    double carry = e_t;
    for (int j = 0; j < rows; j += 32 * K) {
      const int i0 = (j + lane * K) * wc + c;
      float v[K];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[k] = s_tile[k7_pad(i0 + k * wc)];
        run += (double)v[k];
      }
      const double wx = warp_incl_scan(run, lane);
      const double up = __shfl_up_sync(0xffffffffu, wx, 1);
      double acc = carry + (lane > 0 ? up : 0.0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc += (double)v[k];
        s_tile[k7_pad(i0 + k * wc)] = (float)acc;
      }
      carry += __shfl_sync(0xffffffffu, wx, 31);
    }
  }
  __syncthreads();

  // store the outputs as the items were staged
  if (vec) {
    float* dst = out + r0 * n_cols;
    for (int v = tid; 4 * v < valid; v += blockDim.x) {
      const int i = 4 * v;
      if (i + 4 <= valid) {
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(s_tile[k7_pad(i)], s_tile[k7_pad(i + 1)],
                        s_tile[k7_pad(i + 2)], s_tile[k7_pad(i + 3)]);
      } else {
        for (int k = 0; i + k < valid; ++k) dst[i + k] = s_tile[k7_pad(i + k)];
      }
    }
  } else {
    for (int i = tid; i < nr * wc; i += blockDim.x) {
      const int r = i / wc;
      out[(r0 + r) * n_cols + c0 + (i - r * wc)] = s_tile[k7_pad(i)];
    }
  }
}

// 64-bit scratch words K7 needs for n rows of n_cols columns: the ticket
// and two flag words per (tile, column).
extern "C" long long goliath_cumsum_rows_scratch_len(int n_cols, long long n) {
  if (n <= 0 || n_cols <= 0) return 1;
  return 1 + 2 * (long long)n_cols * k7_tiling(n_cols, n).tiles;
}

// R, the rows of one K7 tile at n_cols columns.
extern "C" int goliath_cumsum_rows_tile_rows(int n_cols) {
  return n_cols > 0 ? k7_tiling(n_cols, 1).rows : 0;
}

template <int K>
static cudaError_t launch_scan_rows(const float* in, float* out,
                                    unsigned long long* scratch, int n_cols,
                                    long long n, const K7Tiling& t,
                                    bool vec_ok, cudaStream_t stream) {
  const size_t smem = (size_t)k7_pad(t.rows * t.width) * sizeof(float);
  if (smem > 48 * 1024) {  // above the default limit of dynamic shared
    const cudaError_t err = cudaFuncSetAttribute(
        scan_rows_lookback<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  scan_rows_lookback<K>
      <<<(unsigned)(t.tiles * t.windows), t.warps * 32, smem, stream>>>(
          in, out, scratch, n_cols, n, t.tiles, t.windows, t.width, t.rows,
          vec_ok);
  return cudaGetLastError();
}

// K7. in/out: [n, n_cols] f32, scanned along axis 0; `scratch` holds at
// least goliath_cumsum_rows_scratch_len(n_cols, n) 64-bit words; the
// launcher zeroes them with one memset, then launches one kernel. Returns
// the first CUDA error (0 on success).
extern "C" int goliath_cumsum_rows_f32(const float* in, float* out,
                                       unsigned long long* scratch,
                                       int n_cols, long long n,
                                       cudaStream_t stream) {
  if (n <= 0 || n_cols <= 0) return 0;
  const K7Tiling t = k7_tiling(n_cols, n);
  if (t.tiles * t.windows > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0,
      (size_t)goliath_cumsum_rows_scratch_len(n_cols, n) *
          sizeof(unsigned long long),
      stream);
  if (err != cudaSuccess) return (int)err;
  const bool vec_ok = (((uintptr_t)in | (uintptr_t)out) & 15) == 0;
  switch (t.run) {
#define K7_CASE(K)                                                          \
  case K:                                                                   \
    err = launch_scan_rows<K>(in, out, scratch, n_cols, n, t, vec_ok,       \
                              stream);                                      \
    break;
    K7_CASE(32) K7_CASE(16) K7_CASE(8) K7_CASE(4) K7_CASE(2) K7_CASE(1)
#undef K7_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
