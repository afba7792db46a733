// The MVP march's device code, shared by K8 (mvp_march.cu, the forward) and
// K10 (mvp_march_bwd.cu, its backward), so that K10 replays K8's forward
// with the same arithmetic: the march's arguments, the sampler, the fade,
// each ray's spans, ranks and slots, a slot's window taps, and the
// composite's float64 scan. Every product and sum that decides a mask is
// rounded on its own (__fmul_rn / __fadd_rn: nvcc contracts no
// multiply-add into them); see mvp_march.cu for the rounding rules and the
// plain version each step follows.

#pragma once

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

// One ray of a tile: its origin, direction, 1 / direction and tminmax.
struct K8Ray {
  float o[3], d[3], inv[3];
  float tm0, tm1;
};

__device__ __forceinline__ K8Ray k8_ray(const MarchArgs& a, long long ray) {
  K8Ray r;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.o[j] = a.raypos[ray * 3 + j];
    r.d[j] = a.raydir[ray * 3 + j];
    r.inv[j] = k8_inv(r.d[j]);
  }
  r.tm0 = a.tminmax[ray * 2];
  r.tm1 = a.tminmax[ray * 2 + 1];
  return r;
}

// The prim row of the tile's list position m: staged in shared memory, or
// the global table's.
__device__ __forceinline__ const float* k8_prim_row(const MarchArgs& a,
                                                    const float* s_prim,
                                                    const int* s_pid, int m) {
  return a.staged ? s_prim + m * K8_STAGE_COLS
                  : a.prims + (long long)s_pid[m] * K8_PRIM_COLS;
}

// Step 1: the ray's spans through the tile's first nm listed prims' AABBs,
// the hits compacted in list order into hkey (entry depth) and hidx (list
// position); returns the number of hits, and te, tx and any_hit as the
// plain version's t_enter, t_exit and any_hit (warp-uniform).
__device__ __forceinline__ int k8_ray_spans(const MarchArgs& a,
                                            const float* s_prim,
                                            const int* s_pid, int nm,
                                            int lane, const K8Ray& r,
                                            float* hkey, int* hidx,
                                            float& te_out, float& tx_out,
                                            bool& any_hit) {
  float te = INFINITY, tx = -INFINITY;
  int nhit = 0;
  for (int m0 = 0; m0 < nm; m0 += 32) {
    const int m = m0 + lane;
    bool hit = false;
    float lo = 0.0f, hi = 0.0f;
    if (m < nm) {
      const float* pr = k8_prim_row(a, s_prim, s_pid, m);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float t1 = __fmul_rn(__fsub_rn(pr[j], r.o[j]), r.inv[j]);
        const float t2 = __fmul_rn(__fsub_rn(pr[3 + j], r.o[j]), r.inv[j]);
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
  te = fmaxf(k8_warp_min(te), r.tm0);
  tx = fminf(k8_warp_max(tx), r.tm1);
  any_hit = isfinite(te) && tx > te;
  if (!any_hit) {
    te = 0.0f;
    tx = -1.0f;
  }
  te_out = te;
  tx_out = tx;
  return nhit;
}

// Step 3: the step grid's origin, aligned to the ray's tmin.
__device__ __forceinline__ float k8_t0(float te, float tm0, float step) {
  return __fadd_rn(
      tm0, __fmul_rn(floorf(__fdiv_rn(fmaxf(__fsub_rn(te, tm0), 0.0f), step)),
                     step));
}

// Step 2: each hit's rank in (depth, list position) order, the stable
// sort's position; ranks below R name the ray's slots (list positions).
__device__ __forceinline__ void k8_ray_slots(const float* hkey,
                                             const int* hidx, int nhit,
                                             int R, int lane, int* slot) {
  for (int h = lane; h < nhit; h += 32) {
    const float k = hkey[h];
    int rank = 0;
    for (int h2 = 0; h2 < nhit; ++h2) {
      const float k2 = hkey[h2];
      rank += (k2 < k) || (k2 == k && h2 < h);
    }
    if (rank < R) slot[rank] = hidx[h];
  }
}

// Step 4, a slot: prim `pid` (row pr) on ray r, its oriented-slab span and
// first step; writes q[0..9]: Ac 3, Bc 3, tmax_c, s_lo (int bits), ok (0 or
// 1), pid (int bits).
__device__ __forceinline__ void k8_slot_row(const float* pr, int pid,
                                            const K8Ray& r, float t0,
                                            float step, int S, float* q) {
  const float* pos = pr + 6;
  const float* rot = pr + 9;  // [i][j]
  const float* scl = pr + 18;
  const float rel[3] = {__fsub_rn(r.o[0], pos[0]), __fsub_rn(r.o[1], pos[1]),
                        __fsub_rn(r.o[2], pos[2])};
  float tmin_c = 0.0f, tmax_c = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float Ac = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(rot[j], r.d[0]),
                            __fmul_rn(rot[3 + j], r.d[1])),
                  __fmul_rn(rot[6 + j], r.d[2])),
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
}

// Window tap j of the slot row q: its step sidx, its depth tj, and whether
// the mask lets it through (msk).
__device__ __forceinline__ bool k8_tap(const float* q, int j, float t0,
                                       float step, int S, int& sidx,
                                       float& tj) {
  sidx = __float_as_int(q[7]) + j;
  tj = __fadd_rn(t0, __fmul_rn((float)sidx, step));
  return q[8] != 0.0f && sidx < S && tj <= __fadd_rn(q[6], 1e-5f);
}

// The prim coordinates y = Ac * tj + Bc of a tap of the slot row q.
__device__ __forceinline__ void k8_tap_coords(const float* q, float tj,
                                              float& yx, float& yy,
                                              float& yz) {
  yx = __fadd_rn(__fmul_rn(q[0], tj), q[3]);
  yy = __fadd_rn(__fmul_rn(q[1], tj), q[4]);
  yz = __fadd_rn(__fmul_rn(q[2], tj), q[5]);
}

// Step 5: whether step s lies before the ray's exit (live_s).
__device__ __forceinline__ bool k8_live(float t0, float step, int s,
                                        float t_live) {
  return __fadd_rn(t0, __fmul_rn(step, (float)s)) <= t_live;
}

// Step 5: the exclusive prefix over the warp's lanes of each lane's float64
// partial sum (the CPU's torch.cumsum accumulates float32 in float64).
__device__ __forceinline__ double k8_scan_excl(double part, int lane) {
  double incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(K8_FULL, incl, o);
    if (lane >= o) incl += n;
  }
  double cum = __shfl_up_sync(K8_FULL, incl, 1);
  if (lane == 0) cum = 0.0;
  return cum;
}
