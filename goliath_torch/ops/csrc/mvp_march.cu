// K8: the forward of the tiled MVP march, every tile's rays through the
// prims binned to it, rgba [T, 4, P].
//
// Replaces no Pallas kernel: the JAX package marches in XLA, in
// goliath_tpu/ops/mvp.py `mvp_raymarch_tiled` (:352), whose `march_group`
// (:482) it computes (the reference Goliath ran the march as the CUDA
// extension extensions/mvpraymarch). The port's plain version is
// goliath_torch/ops/mvp.py `march_group`, run over the same per-tile inputs
// (`march_inputs`, `march_tiles_plain`); its steps, in its order, are:
//   1. the ray's span through each of the tile's first min(count, M) listed
//      prims' world AABBs (`_ray_box_span_g`): hit, t_enter, t_exit,
//      any_hit;
//   2. the ray's R nearest hit prims by AABB entry depth, in the order of a
//      stable sort (equal depths by list position);
//   3. the step grid's origin t0, aligned to the ray's tmin;
//   4. for each of those slots, its oriented-slab span (Ac, Bc, tmin_c,
//      tmax_c) and first step s_lo, then the Sp window steps from s_lo,
//      masked (msk), each a trilinear tap of the packed template rows
//      (through the warp field's rows where there is one) faded at the
//      border and zero outside the box, deposited as (rgb * a, a) onto
//      the ray's grid of S steps;
//   5. the steps past t_exit dropped (live_s), the alpha-weighted mean
//      colour, and the saturating accumulation (`saturate`);
// and with counts asked for, the in-group drops of the march's `drops`
// (rays_over_r, rays_step_capped, window_cut_pairs and the prims of
// window_cut_prims) and the deposited taps.
//
// Design: a block per tile over all T tiles (an empty tile writes its
// zeros and exits: no host sync, no tile list), 8 warps, a warp per ray
// (each warp takes every 8th of the tile's P rays). The tile's prim ids
// and, for lists of up to K8_STAGE_MAX prims, their AABBs, positions,
// rotations and scales (21 floats, a conflict-free stride) are staged in
// shared memory once; longer lists read the same rows from the global
// prim table. Per ray, in the warp's own shared memory:
//   * lanes take the prims 32 at a time; hits are compacted in list order
//     (ballot), t_enter and t_exit are warp minima and maxima (exact);
//   * each hit's rank is the number of hits before it in (depth, list
//     position) order, which is the stable sort's position; ranks below R
//     name the ray's slots;
//   * slots go 32 at a time: lane r computes slot r's Ac, Bc, span, s_lo,
//     ok and its window-cut test; then the (slot, window step) taps of the
//     batch are spread over the lanes, 32 at a time, and each lane that
//     holds a masked-in tap samples it. A masked tap deposits nothing (the
//     plain version adds an exact 0 there: its sample is finite wherever
//     the prims' parameters are). Deposits go into the ray's step grid
//     [S][4] (a float4 a step) one slot at a time, in slot order, so each
//     step's sum is taken in the plain version's order (a slot's taps land
//     on distinct steps); the grid is 2 KiB a ray at S = 128, and a warp
//     holds one ray's at a time (33 KiB a block: the whole tile's 512 KiB
//     would not fit);
//   * the composite: each lane takes S/32 consecutive steps; A's prefix
//     sums of alpha * stepsize are carried in float64 (the CPU's
//     torch.cumsum accumulates float32 in float64) through a warp scan,
//     each step's A rounded to float32 and clipped at 1; contrib, the mean
//     colour and the rgb sums as in `saturate`, the rgb summed over the
//     lanes.
// Counts: each lane keeps its own and a block adds them in shared memory
// and then once into the global counters (integer atomics); a prim whose
// window was cut gets its flag set to 1.
//
// Rounding: the mask tests decide which taps exist, so t0, tj = t0 +
// sidx*stepsize, y = Ac*tj + Bc, the slab spans and s_lo are computed with
// each product and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc
// contracts no multiply-add into them), divisions and reciprocals are
// IEEE (__fdiv_rn; PyTorch's 1.0 / x is a reciprocal), float-to-int
// conversions saturate as `sat_int` (NaN to 0), and the constants are the
// float32 values PyTorch's scalar arguments round to (1e-5, 1e-12,
// stepsize, (S - 1) * stepsize). Ac's and Bc's three products are summed
// in the einsum's order; the plain version's einsum runs as a batched
// matrix product, so those may differ by rounding. `_pow_abs` with an
// integer fadeexp is repeated squaring (((y^2)^2)^2 at 8). The sampler
// keeps the packed rows' quirk (a row holds x and min(x + 1, W - 1), so
// at x in [-1, -1 + 1/W) the second corner is vol[1]) and decides zero
// padding per axis, as `sample_packed_cf`.
//
// Bound: device-memory bytes (each input read once: the tiles' rays, 32 B
// a ray; the rows of the prims the tile lists keep, 32 B a row; the rgba
// written, 16 B a ray) against 143 float32 operations a deposited tap
// (chip_smoke.py `K8_OPS_PER_TAP`). Its time is latency: each tap's four
// row gathers (32 B each) are random reads that mostly hit L2, and a warp
// walks its rays one after another.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the outputs. The launcher allocates nothing, launches on the
// given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K8_WARPS 8
#define K8_PRIM_COLS 24   // the global prim table: pmin pmax pos rot scale pad
#define K8_STAGE_COLS 21  // a staged prim row (21 is coprime with 32 banks)
#define K8_STAGE_MAX 256  // the longest tile list staged in shared memory
#define K8_SLOT_COLS 12   // Ac 3, Bc 3, tmax_c, s_lo, ok, prim id, 2 pad
#define K8_SMEM_MAX (226 * 1024)  // dynamic, below the 227 KB with the static
#define K8_FULL 0xffffffffu

struct MarchArgs {
  const float* raypos;   // [T, P, 3]
  const float* raydir;   // [T, P, 3]
  const float* tminmax;  // [T, P, 2]
  const int32_t* tile_start;
  const int32_t* tile_end;
  const int32_t* sorted_prim;
  const float* prims;  // [K, 24]
  const float* rows;   // [K * tD * tH * tW, 8]
  const float* wrows;  // [K * wD * wH * wW, 6] or null
  int tile_size, ntx, img_h, img_w;
  int tD, tH, tW, wD, wH, wW;
  int S, Sp, M, R, fadeexp, count;
  float stepsize, cap_off, neg_fadescale;
  int warp_floats;  // a warp's shared memory, in floats (a multiple of 4)
  int staged;
  float* out;                   // [T, 4, P]
  unsigned long long* counts;   // taps, rays_over_r, step_capped, cut pairs
  int32_t* cut;                 // [K]
};

// sat_int: float to int as XLA converts, saturating, NaN to 0
__device__ __forceinline__ long long k8_sat(float x) {
  if (isnan(x)) return 0;
  return (long long)fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
}

__device__ __forceinline__ float k8_mask(bool b) { return b ? 1.0f : 0.0f; }

// PyTorch's 1.0 / where(|x| < 1e-12, 1e-12, x)
__device__ __forceinline__ float k8_inv(float x) {
  return __fdiv_rn(1.0f, fabsf(x) < 1e-12f ? 1e-12f : x);
}

// `_pow_abs` at an integer exponent n >= 1: repeated squaring
__device__ __forceinline__ float k8_pow_abs(float y, int n) {
  float acc = 0.0f, bit = fabsf(y);
  bool have = false;
  while (n) {
    if (n & 1) {
      acc = have ? __fmul_rn(acc, bit) : bit;
      have = true;
    }
    n >>= 1;
    if (n) bit = __fmul_rn(bit, bit);
  }
  return acc;
}

// `sample_packed_cf`: trilinear taps of prim `pid`'s packed rows (2C floats
// a row: x and min(x + 1, W - 1)) at (yx, yy, yz) in [-1, 1], zeros outside,
// decided per axis; corners summed (z, y) = (0, 0), (0, 1), (1, 0), (1, 1).
template <int C>
__device__ __forceinline__ void k8_sample(const float* __restrict__ rows,
                                          int D, int H, int W, int pid,
                                          float yx, float yy, float yz,
                                          float* out) {
  const float x = __fsub_rn(__fmul_rn(__fadd_rn(yx, 1.0f), 0.5f * W), 0.5f);
  const float v = __fsub_rn(__fmul_rn(__fadd_rn(yy, 1.0f), 0.5f * H), 0.5f);
  const float z = __fsub_rn(__fmul_rn(__fadd_rn(yz, 1.0f), 0.5f * D), 0.5f);
  const float x0 = floorf(x), y0 = floorf(v), z0 = floorf(z);
  const float wx = __fsub_rn(x, x0), wy = __fsub_rn(v, y0);
  const float wz = __fsub_rn(z, z0);
  const long long x0i = k8_sat(x0), y0i = k8_sat(y0), z0i = k8_sat(z0);
  const float w0 = __fmul_rn(__fsub_rn(1.0f, wx), k8_mask(x0i >= 0 && x0i < W));
  const float w1 = __fmul_rn(wx, k8_mask(x0i + 1 >= 0 && x0i + 1 < W));
  const long long xc = x0i < 0 ? 0 : (x0i > W - 1 ? W - 1 : x0i);
  float acc[C];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const long long zi = z0i + dz;
    const bool zv = zi >= 0 && zi < D;
    const long long zc = zi < 0 ? 0 : (zi > D - 1 ? D - 1 : zi);
    const float wzz = dz ? wz : __fsub_rn(1.0f, wz);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const long long yi = y0i + dy;
      const bool yv = yi >= 0 && yi < H;
      const long long yc = yi < 0 ? 0 : (yi > H - 1 ? H - 1 : yi);
      const long long ridx = (((long long)pid * D + zc) * H + yc) * W + xc;
      const float wyy = __fmul_rn(
          __fmul_rn(dy ? wy : __fsub_rn(1.0f, wy), wzz), k8_mask(zv && yv));
      float r[2 * C];
      if constexpr (C == 4) {  // a 32-byte row: two 16-byte loads
        const float4* q = reinterpret_cast<const float4*>(rows + ridx * 8);
        const float4 a = __ldg(q), b = __ldg(q + 1);
        r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
        r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
      } else {
#pragma unroll
        for (int c = 0; c < 2 * C; ++c) r[c] = __ldg(rows + ridx * 2 * C + c);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float term = __fmul_rn(
            __fadd_rn(__fmul_rn(r[c], w0), __fmul_rn(r[C + c], w1)), wyy);
        acc[c] = (dz | dy) ? __fadd_rn(acc[c], term) : term;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = acc[c];
}

// `sample_prims_cf` at one tap: rgba with alpha faded and zero outside the
// box; the fade and validity at the coordinate before the warp.
__device__ __forceinline__ float4 k8_sample_prim(const MarchArgs& a, int pid,
                                                 float yx, float yy,
                                                 float yz) {
  const float fade = expf(__fmul_rn(
      a.neg_fadescale,
      __fadd_rn(__fadd_rn(k8_pow_abs(yx, a.fadeexp),
                          k8_pow_abs(yy, a.fadeexp)),
                k8_pow_abs(yz, a.fadeexp))));
  const bool valid = fabsf(yx) < 1.0f && fabsf(yy) < 1.0f && fabsf(yz) < 1.0f;
  float sx = yx, sy = yy, sz = yz;
  if (a.wrows != nullptr) {
    float w3[3];
    k8_sample<3>(a.wrows, a.wD, a.wH, a.wW, pid, yx, yy, yz, w3);
    sx = w3[0]; sy = w3[1]; sz = w3[2];
  }
  float c[4];
  k8_sample<4>(a.rows, a.tD, a.tH, a.tW, pid, sx, sy, sz, c);
  return make_float4(c[0], c[1], c[2],
                     __fmul_rn(__fmul_rn(c[3], fade), k8_mask(valid)));
}

__device__ __forceinline__ float k8_warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(K8_FULL, v, o));
  return v;
}

__device__ __forceinline__ float k8_warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(K8_FULL, v, o));
  return v;
}

__device__ __forceinline__ float k8_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(K8_FULL, v, o));
  return v;
}

__global__ void __launch_bounds__(K8_WARPS * 32)
mvp_march_kernel(const MarchArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned int s_cnt[4];
  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int start = a.tile_start[t];
  const int nm = min(max(a.tile_end[t] - start, 0), a.M);
  float* out_t = a.out + (long long)t * 4 * P;
  if (nm == 0) {  // an empty tile marches nothing: its rgba is 0
    for (int i = threadIdx.x; i < 4 * P; i += blockDim.x) out_t[i] = 0.0f;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int S = a.S, Sp = a.Sp, R = a.R;
  const float step = a.stepsize;

  // [M] prim ids, [M][21] staged prim rows (if staged), then each warp's
  // area, starting on a 16-byte boundary
  int* s_pid = reinterpret_cast<int*>(smem);
  float* s_prim = smem + a.M;
  const int head = (a.M + (a.staged ? a.M * K8_STAGE_COLS : 0) + 3) & ~3;
  float* wbase = smem + head + warp * a.warp_floats;
  float4* acc = reinterpret_cast<float4*>(wbase);   // [S] steps
  float* hkey = wbase + 4 * S;                      // [M] hit depths
  int* hidx = reinterpret_cast<int*>(hkey + a.M);   // [M] hit list positions
  int* slot = hidx + a.M;                           // [R] the ray's slots
  float* sp = reinterpret_cast<float*>(slot + R);   // [32][12] a slot batch

  if (threadIdx.x < 4) s_cnt[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < nm; i += blockDim.x)
    s_pid[i] = a.sorted_prim[start + i];
  __syncthreads();
  if (a.staged) {
    for (int i = threadIdx.x; i < nm * K8_STAGE_COLS; i += blockDim.x) {
      const int m = i / K8_STAGE_COLS, c = i - m * K8_STAGE_COLS;
      s_prim[i] = a.prims[(long long)s_pid[m] * K8_PRIM_COLS + c];
    }
  }
  __syncthreads();

  const int gx0 = (t % a.ntx) * ts, gy0 = (t / a.ntx) * ts;
  unsigned int c_taps = 0, c_over = 0, c_capped = 0, c_cut = 0;
  for (int p = warp; p < P; p += nwarps) {
    const long long ray = (long long)t * P + p;
    const float o[3] = {a.raypos[ray * 3], a.raypos[ray * 3 + 1],
                        a.raypos[ray * 3 + 2]};
    const float d[3] = {a.raydir[ray * 3], a.raydir[ray * 3 + 1],
                        a.raydir[ray * 3 + 2]};
    const float tm0 = a.tminmax[ray * 2], tm1 = a.tminmax[ray * 2 + 1];
    const bool ins = gx0 + p % ts < a.img_w && gy0 + p / ts < a.img_h;
    const float inv[3] = {k8_inv(d[0]), k8_inv(d[1]), k8_inv(d[2])};

    // 1. spans through the listed prims' AABBs; hits compacted in order
    float te = INFINITY, tx = -INFINITY;
    int nhit = 0;
    for (int m0 = 0; m0 < nm; m0 += 32) {
      const int m = m0 + lane;
      bool hit = false;
      float lo = 0.0f, hi = 0.0f;
      if (m < nm) {
        const float* pr = a.staged ? s_prim + m * K8_STAGE_COLS
                                   : a.prims + (long long)s_pid[m] * K8_PRIM_COLS;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float t1 = __fmul_rn(__fsub_rn(pr[j], o[j]), inv[j]);
          const float t2 = __fmul_rn(__fsub_rn(pr[3 + j], o[j]), inv[j]);
          const float mn = fminf(t1, t2), mx = fmaxf(t1, t2);
          lo = j ? fmaxf(lo, mn) : mn;
          hi = j ? fminf(hi, mx) : mx;
        }
        hit = hi > lo;
      }
      const unsigned mask = __ballot_sync(K8_FULL, hit);
      if (hit) {
        const int pos = nhit + __popc(mask & ((1u << lane) - 1u));
        hkey[pos] = lo;
        hidx[pos] = m;
        te = fminf(te, lo);
        tx = fmaxf(tx, hi);
      }
      nhit += __popc(mask);
    }
    te = fmaxf(k8_warp_min(te), tm0);
    tx = fminf(k8_warp_max(tx), tm1);
    const bool any_hit = isfinite(te) && tx > te;
    if (!any_hit) {
      te = 0.0f;
      tx = -1.0f;
    }
    // 3. the step grid's origin, aligned to the ray's tmin
    const float t0 = __fadd_rn(
        tm0, __fmul_rn(floorf(__fdiv_rn(fmaxf(__fsub_rn(te, tm0), 0.0f), step)),
                       step));
    if (a.count && lane == 0 && ins) {
      c_over += nhit > R;
      c_capped += any_hit && __fadd_rn(__fadd_rn(t0, a.cap_off), 1e-5f) < tx;
    }
    __syncwarp();

    // 2. ranks in (depth, list position) order: the stable sort's slots
    for (int h = lane; h < nhit; h += 32) {
      const float k = hkey[h];
      int rank = 0;
      for (int h2 = 0; h2 < nhit; ++h2) {
        const float k2 = hkey[h2];
        rank += (k2 < k) || (k2 == k && h2 < h);
      }
      if (rank < R) slot[rank] = hidx[h];
    }
    if (any_hit)
      for (int s = lane; s < S; s += 32) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();

    // 4. the slots, 32 at a time: their spans, then their taps
    const int nR = min(nhit, R);
    for (int r0 = 0; r0 < nR; r0 += 32) {
      const int nb = min(32, nR - r0);
      if (lane < nb) {
        const int m = slot[r0 + lane];
        const int pid = s_pid[m];
        const float* pr = a.staged ? s_prim + m * K8_STAGE_COLS
                                   : a.prims + (long long)pid * K8_PRIM_COLS;
        const float* pos = pr + 6;
        const float* rot = pr + 9;  // [i][j]
        const float* scl = pr + 18;
        const float rel[3] = {__fsub_rn(o[0], pos[0]), __fsub_rn(o[1], pos[1]),
                              __fsub_rn(o[2], pos[2])};
        float* q = sp + lane * K8_SLOT_COLS;
        float tmin_c = 0.0f, tmax_c = 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float Ac = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(rot[j], d[0]),
                                  __fmul_rn(rot[3 + j], d[1])),
                        __fmul_rn(rot[6 + j], d[2])),
              scl[j]);
          const float Bc = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(rot[j], rel[0]),
                                  __fmul_rn(rot[3 + j], rel[1])),
                        __fmul_rn(rot[6 + j], rel[2])),
              scl[j]);
          const float ia = k8_inv(Ac);
          const float t1 = __fmul_rn(__fsub_rn(-1.0f, Bc), ia);
          const float t2 = __fmul_rn(__fsub_rn(1.0f, Bc), ia);
          const float mn = fminf(t1, t2), mx = fmaxf(t1, t2);
          tmin_c = j ? fmaxf(tmin_c, mn) : mn;
          tmax_c = j ? fminf(tmax_c, mx) : mx;
          q[j] = Ac;
          q[3 + j] = Bc;
        }
        const bool ok = tmax_c > tmin_c;
        const float v = ceilf(
            __fsub_rn(__fdiv_rn(__fsub_rn(tmin_c, t0), step), 1e-5f));
        const int s_lo = isnan(v) ? 0 : (int)fminf(fmaxf(v, 0.0f), (float)(S - 1));
        q[6] = tmax_c;
        q[7] = __int_as_float(s_lo);
        q[8] = k8_mask(ok);
        q[9] = __int_as_float(pid);
        if (a.count && ok && ins && s_lo + Sp < S &&
            __fadd_rn(t0, __fmul_rn((float)(s_lo + Sp), step)) <=
                __fadd_rn(tmax_c, 1e-5f)) {
          ++c_cut;
          a.cut[pid] = 1;
        }
      }
      __syncwarp();
      if (any_hit) {
        const int nq = nb * Sp;
        for (int q0 = 0; q0 < nq; q0 += 32) {
          const int qi = q0 + lane;
          const int r = qi / Sp;
          int sidx = 0;
          bool msk = false;
          float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
          if (qi < nq) {
            const float* q = sp + r * K8_SLOT_COLS;
            sidx = __float_as_int(q[7]) + (qi - r * Sp);
            const float tj = __fadd_rn(t0, __fmul_rn((float)sidx, step));
            msk = q[8] != 0.0f && sidx < S && tj <= __fadd_rn(q[6], 1e-5f);
            if (msk) {
              const float4 s = k8_sample_prim(
                  a, __float_as_int(q[9]), __fadd_rn(__fmul_rn(q[0], tj), q[3]),
                  __fadd_rn(__fmul_rn(q[1], tj), q[4]),
                  __fadd_rn(__fmul_rn(q[2], tj), q[5]));
              val = make_float4(__fmul_rn(s.x, s.w), __fmul_rn(s.y, s.w),
                                __fmul_rn(s.z, s.w), s.w);
            }
          }
          // deposits one slot at a time, in slot order: a slot's taps land
          // on distinct steps
          const int r_hi = min(q0 + 31, nq - 1) / Sp;
          for (int rr = q0 / Sp; rr <= r_hi; ++rr) {
            if (msk && r == rr) {
              float4 c = acc[sidx];
              c.x = __fadd_rn(c.x, val.x);
              c.y = __fadd_rn(c.y, val.y);
              c.z = __fadd_rn(c.z, val.z);
              c.w = __fadd_rn(c.w, val.w);
              acc[sidx] = c;
            }
            __syncwarp();
          }
          c_taps += msk;
        }
      }
      __syncwarp();  // the batch's slot rows are read: the next may write
    }

    // 5. live steps, mean colour, saturating accumulation
    float rgb0 = 0.0f, rgb1 = 0.0f, rgb2 = 0.0f, a_out = 0.0f;
    if (any_hit) {
      const int per = (S + 31) / 32;
      const int s_lo = min(lane * per, S), s_hi = min(s_lo + per, S);
      const float t_live = __fadd_rn(tx, 1e-5f);
      double part = 0.0;
      for (int s = s_lo; s < s_hi; ++s) {
        const bool live = __fadd_rn(t0, __fmul_rn(step, (float)s)) <= t_live;
        part += (double)__fmul_rn(__fmul_rn(acc[s].w, k8_mask(live)), step);
      }
      double incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double n = __shfl_up_sync(K8_FULL, incl, o);
        if (lane >= o) incl += n;
      }
      double cum = __shfl_up_sync(K8_FULL, incl, 1);
      if (lane == 0) cum = 0.0;
      float prev = lane == 0 ? 0.0f : fminf((float)cum, 1.0f);
      for (int s = s_lo; s < s_hi; ++s) {
        const float4 c = acc[s];
        const bool live = __fadd_rn(t0, __fmul_rn(step, (float)s)) <= t_live;
        const float al = __fmul_rn(c.w, k8_mask(live));
        cum += (double)__fmul_rn(al, step);
        const float A = fminf((float)cum, 1.0f);
        const float contrib = __fsub_rn(A, prev);
        prev = A;
        const float safe = al > 0.0f ? al : 1.0f;
        rgb0 = __fadd_rn(rgb0, __fmul_rn(__fdiv_rn(c.x, safe), contrib));
        rgb1 = __fadd_rn(rgb1, __fmul_rn(__fdiv_rn(c.y, safe), contrib));
        rgb2 = __fadd_rn(rgb2, __fmul_rn(__fdiv_rn(c.z, safe), contrib));
      }
      if (s_lo < S && s_hi == S) a_out = prev;  // A_clip at step S - 1
      rgb0 = k8_warp_sum(rgb0);
      rgb1 = k8_warp_sum(rgb1);
      rgb2 = k8_warp_sum(rgb2);
      a_out = k8_warp_sum(a_out);  // one lane holds it, the others 0
    }
    if (lane == 0) {
      out_t[p] = rgb0;
      out_t[P + p] = rgb1;
      out_t[2 * P + p] = rgb2;
      out_t[3 * P + p] = a_out;
    }
    __syncwarp();  // the ray's shared rows are read: the next ray may write
  }

  if (a.count) {
    c_taps = __reduce_add_sync(K8_FULL, c_taps);
    c_over = __reduce_add_sync(K8_FULL, c_over);
    c_capped = __reduce_add_sync(K8_FULL, c_capped);
    c_cut = __reduce_add_sync(K8_FULL, c_cut);
    if (lane == 0) {
      atomicAdd(&s_cnt[0], c_taps);
      atomicAdd(&s_cnt[1], c_over);
      atomicAdd(&s_cnt[2], c_capped);
      atomicAdd(&s_cnt[3], c_cut);
    }
    __syncthreads();
    if (threadIdx.x < 4 && s_cnt[threadIdx.x])
      atomicAdd(&a.counts[threadIdx.x],
                (unsigned long long)s_cnt[threadIdx.x]);
  }
}

// Shared memory of a block of `warps` warps, in floats.
static long long k8_smem_floats(int M, int staged, int warp_floats,
                                int warps) {
  const long long head = (M + (staged ? (long long)M * K8_STAGE_COLS : 0) + 3)
                         & ~3LL;
  return head + (long long)warps * warp_floats;
}

// raypos/raydir [T, P, 3], tminmax [T, P, 2] f32 (P = tile_size^2);
// tile_start/tile_end [T] i32 into sorted_prim [budget] i32; prims [K, 24]
// f32 (pmin, pmax, primpos, primrot row-major, primscale, 3 pad); rows
// [K*tD*tH*tW, 8] f32, the packed template; wrows [K*wD*wH*wW, 6] f32 or
// null. counts [4] u64 and cut [K] i32 zeroed by the caller (written only
// with count != 0). Returns the launch's CUDA error.
extern "C" int goliath_mvp_march(
    const float* raypos, const float* raydir, const float* tminmax,
    const int32_t* tile_start, const int32_t* tile_end,
    const int32_t* sorted_prim, const float* prims, const float* rows,
    const float* wrows, int n_tiles, int tile_size, int ntx, int img_h,
    int img_w, int tD, int tH, int tW, int wD, int wH, int wW, int S, int Sp,
    int M, int R, int fadeexp, float stepsize, float cap_off, float fadescale,
    int count, float* out, unsigned long long* counts, int32_t* cut,
    cudaStream_t stream) {
  if (tile_size < 1 || S < 1 || Sp < 1 || Sp > S || M < 1 || R < 1 ||
      R > M || fadeexp < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  MarchArgs a;
  a.raypos = raypos; a.raydir = raydir; a.tminmax = tminmax;
  a.tile_start = tile_start; a.tile_end = tile_end;
  a.sorted_prim = sorted_prim; a.prims = prims; a.rows = rows;
  a.wrows = wrows;
  a.tile_size = tile_size; a.ntx = ntx; a.img_h = img_h; a.img_w = img_w;
  a.tD = tD; a.tH = tH; a.tW = tW; a.wD = wD; a.wH = wH; a.wW = wW;
  a.S = S; a.Sp = Sp; a.M = M; a.R = R; a.fadeexp = fadeexp;
  a.count = count;
  a.stepsize = stepsize; a.cap_off = cap_off; a.neg_fadescale = -fadescale;
  a.staged = M <= K8_STAGE_MAX;
  // a warp's area: the step grid, the hit depths and positions, the slots
  // and a batch of 32 slot rows
  a.warp_floats = (4 * S + 2 * M + R + 32 * K8_SLOT_COLS + 3) & ~3;
  a.out = out; a.counts = counts; a.cut = cut;
  int warps = K8_WARPS;
  while (warps > 1 &&
         k8_smem_floats(M, a.staged, a.warp_floats, warps) * 4 > K8_SMEM_MAX)
    --warps;
  const long long smem = k8_smem_floats(M, a.staged, a.warp_floats, warps) * 4;
  if (smem > K8_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mvp_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mvp_march_kernel<<<n_tiles, warps * 32, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}
