// K10: the backward of the tiled MVP march (K8, mvp_march.cu): from the
// upstream gradient of rgba [T, 4, P], the gradients of the packed template
// rows, of the warp field's rows (where there is one) and of primpos,
// primrot and primscale.
//
// Replaces no Pallas kernel: the JAX package differentiates its march in
// XLA, `jax.checkpoint(march_group)` mapped over the tile groups
// (goliath_tpu/ops/mvp.py:680-682, `march_group` :482). The port's plain
// version is autograd through goliath_torch/ops/mvp.py `march_group` over
// the same per-tile inputs (ops/mvp_cuda.py `mvp_march_backward_plain`).
// What it differentiates, in the plain version's terms:
//   * the composite (`saturate` and the mean colour): contrib[s] = A_clip[s]
//     - A_clip[s - 1], A_clip = minimum(cumsum(alpha * stepsize), 1) (half
//     the gradient where A is 1 exactly, none above), rgb = sum_s
//     acc_rgb[s] / safe[s] * contrib[s] with safe = where(alpha > 0, alpha,
//     1), alpha = acc_a * live_s, and a_out = A_clip[S - 1];
//   * each deposited tap, (rgb * a, a) with a = alpha * fade * valid * msk:
//     the trilinear samples of the template rows (through the warp field's
//     rows where there is one: the template at the warped coordinate, the
//     fade and the validity at the coordinate before the warp), the fade
//     exp(-fadescale * sum |y_j|^fadeexp), and the coordinate y_j = Ac_j *
//     tj + Bc_j, Ac = (R^T d) * scale, Bc = (R^T (o - pos)) * scale.
// No gradient reaches the AABBs, t0, tj, the spans, s_lo or any mask (the
// AABBs are detached in both packages; the rest are integers, comparisons
// or functions of the rays alone). K10 computes no gradient of the rays.
//
// Design: K8's layout, a block per tile over all T tiles (an empty tile
// exits), a warp per ray, the tile's list (and, up to K8_STAGE_MAX prims,
// its prim rows) staged in shared memory. Per ray whose upstream gradient
// is not all zero:
//   (a) the forward replayed: K8's steps 1-4 through mvp_march.cuh's code
//       into the ray's step grid [S][4] in shared memory, so the slots,
//       s_lo, the masks and every deposit are K8's bit for bit (the forward
//       saves no step grid: 2 KiB a ray over the live tiles' rays would be
//       hundreds of MiB a sample);
//   (b) the composite reversed in place: each lane takes S/32 consecutive
//       steps, replays A's float64 prefix sums as K8, and turns the grid
//       into d(rgb * a, a) a step; the reverse prefix sum of dA is carried
//       in float64 through a warp scan; contrib / alpha is taken as
//       stepsize below saturation, its exact value, which autograd of the
//       plain version's float64 composite (ops/mvp.py `composite`) comes
//       within ~1e-16 * A / (alpha * stepsize) of: the float32 ratio is
//       ill-conditioned at steps whose alpha * stepsize is a few ulps of A;
//   (c) the taps replayed: each masked-in tap inside its box samples again
//       and takes its step's gradient; it adds the rows' gradient (4 corner
//       rows, two float4 halves a row: vector atomics on sm_90) and, where
//       the prims need a gradient, turns dy into dAc += dy * tj and dBc +=
//       dy, summed over the slot's window in the warp (a warp sum per slot
//       of the batch); each slot then folds its dAc, dBc into its prim's 15
//       floats (d pos, d rot row-major, d scale) in shared memory, flushed
//       once a block with global atomics (straight into global memory for
//       lists past K8_STAGE_MAX, which K8 reads from there too).
// Float atomics sum in an order that changes from run to run: the
// gradients are not bit-reproducible.
//
// Bound: device-memory bytes (the rays of the tiles with prims, 32 B a ray,
// and grad_out, 16 B a ray, read; the template rows and the table rows of
// every prim the tile lists keep read, 32 B a row and 96 B a prim; the
// whole rows' gradient written, 32 B a row, and the prims' 15 gradients,
// 60 B a prim) against the forward's operations a deposited tap (K8's,
// once) plus the backward's own (chip_smoke.py `K10_OPS_PER_TAP`, or
// `K10_ROWS_OPS_PER_TAP` without the prims' gradients). Like K8's, its time is latency: each
// tap's gathers and its atomics to the same few prims' rows.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates and zeroes the gradients. The launcher allocates nothing,
// launches on the given stream and does not synchronise.

#include "mvp_march.cuh"

#define K10_SLOT_COLS 17  // K8's slot row (10), dAc 3, dBc 3, 1 pad
#define K10_GRAD_COLS 15  // d primpos 3, d primrot 9 (row-major), d primscale 3

struct MarchBwdArgs {
  MarchArgs a;            // K8's inputs (out, counts and cut unused)
  const float* grad_out;  // [T, 4, P]
  float* d_rows;          // [K * tD * tH * tW, 8]
  float* d_wrows;         // [K * wD * wH * wW, 6] or null
  float* d_prims;         // [K, 15]
  int prim_grad;          // 0: the prims' parameters take no gradient
};

// p[0..3] += (x, y, z, w): one vector atomic on sm_90 (global memory only;
// CUDA 12.1 on), four scalar ones otherwise
__device__ __forceinline__ void k10_add4(float* p, float x, float y, float z,
                                         float w) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 ||                      \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(x, y, z, w));
#else
  atomicAdd(p, x);
  atomicAdd(p + 1, y);
  atomicAdd(p + 2, z);
  atomicAdd(p + 3, w);
#endif
}

__device__ __forceinline__ float k10_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(K8_FULL, v, o);
  return v;
}

// d |y|^n / dy at an integer n >= 1 (0 at y = 0, as abs's gradient)
__device__ __forceinline__ float k10_dpow_abs(float y, int n) {
  const float sgn = y > 0.0f ? 1.0f : (y < 0.0f ? -1.0f : 0.0f);
  return n == 1 ? sgn : (float)n * k8_pow_abs(y, n - 1) * sgn;
}

// The backward of k8_sample<C> at (yx, yy, yz) under the upstream gradient
// g[C]: adds each corner row's gradient into d_rows (atomics) and, with
// want_dy, writes the coordinates' gradient into dy[3].
template <int C>
__device__ __forceinline__ void k10_sample_bwd(const float* __restrict__ rows,
                                               float* d_rows, int D, int H,
                                               int W, int pid, float yx,
                                               float yy, float yz,
                                               const float* g, bool want_dy,
                                               float* dy) {
  const float x = __fsub_rn(__fmul_rn(__fadd_rn(yx, 1.0f), 0.5f * W), 0.5f);
  const float v = __fsub_rn(__fmul_rn(__fadd_rn(yy, 1.0f), 0.5f * H), 0.5f);
  const float z = __fsub_rn(__fmul_rn(__fadd_rn(yz, 1.0f), 0.5f * D), 0.5f);
  const float x0 = floorf(x), y0 = floorf(v), z0 = floorf(z);
  const float wx = __fsub_rn(x, x0), wy = __fsub_rn(v, y0);
  const float wz = __fsub_rn(z, z0);
  const long long x0i = k8_sat(x0), y0i = k8_sat(y0), z0i = k8_sat(z0);
  const float m0 = k8_mask(x0i >= 0 && x0i < W);
  const float m1 = k8_mask(x0i + 1 >= 0 && x0i + 1 < W);
  const float w0 = __fmul_rn(__fsub_rn(1.0f, wx), m0);
  const float w1 = __fmul_rn(wx, m1);
  const long long xc = x0i < 0 ? 0 : (x0i > W - 1 ? W - 1 : x0i);
  float dw0 = 0.0f, dw1 = 0.0f, dwy = 0.0f, dwz = 0.0f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const long long zi = z0i + dz;
    const bool zv = zi >= 0 && zi < D;
    const long long zc = zi < 0 ? 0 : (zi > D - 1 ? D - 1 : zi);
    const float wzz = dz ? wz : __fsub_rn(1.0f, wz);
#pragma unroll
    for (int dyi = 0; dyi < 2; ++dyi) {
      const long long yi = y0i + dyi;
      const bool yv = yi >= 0 && yi < H;
      if (!(zv && yv)) continue;  // a corner outside: weight 0, no gradient
      const long long yc = yi < 0 ? 0 : (yi > H - 1 ? H - 1 : yi);
      const long long ridx = (((long long)pid * D + zc) * H + yc) * W + xc;
      const float wyf = dyi ? wy : __fsub_rn(1.0f, wy);
      const float wyy = wyf * wzz;
      float* drow = d_rows + ridx * 2 * C;
      if constexpr (C == 4) {
        if (w0 != 0.0f)
          k10_add4(drow, g[0] * wyy * w0, g[1] * wyy * w0, g[2] * wyy * w0,
                   g[3] * wyy * w0);
        if (w1 != 0.0f)
          k10_add4(drow + 4, g[0] * wyy * w1, g[1] * wyy * w1,
                   g[2] * wyy * w1, g[3] * wyy * w1);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (w0 != 0.0f) atomicAdd(drow + c, g[c] * wyy * w0);
          if (w1 != 0.0f) atomicAdd(drow + C + c, g[c] * wyy * w1);
        }
      }
      if (want_dy) {
        const float* row = rows + ridx * 2 * C;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s0 += g[c] * __ldg(row + c);
          s1 += g[c] * __ldg(row + C + c);
        }
        const float h = s0 * w0 + s1 * w1;  // d wyy
        dw0 += s0 * wyy;
        dw1 += s1 * wyy;
        dwy += dyi ? h * wzz : -h * wzz;
        dwz += dz ? h * wyf : -h * wyf;
      }
    }
  }
  if (want_dy) {
    dy[0] = (dw1 * m1 - dw0 * m0) * (0.5f * W);
    dy[1] = dwy * (0.5f * H);
    dy[2] = dwz * (0.5f * D);
  }
}

// A masked-in tap of prim pid at y = (yx, yy, yz) under its step's gradient
// dv = d(rgb * a, a): the rows' (and warp rows') gradients added, and the
// gradient of y in dy[3] (where the prims take a gradient; else 0).
__device__ __forceinline__ void k10_tap(const MarchBwdArgs& b, int pid,
                                        float yx, float yy, float yz,
                                        float4 dv, float* dy) {
  const MarchArgs& a = b.a;
  dy[0] = dy[1] = dy[2] = 0.0f;
  if (!(fabsf(yx) < 1.0f && fabsf(yy) < 1.0f && fabsf(yz) < 1.0f)) return;
  if (dv.x == 0.0f && dv.y == 0.0f && dv.z == 0.0f && dv.w == 0.0f) return;
  const float fade = expf(__fmul_rn(
      a.neg_fadescale,
      __fadd_rn(__fadd_rn(k8_pow_abs(yx, a.fadeexp),
                          k8_pow_abs(yy, a.fadeexp)),
                k8_pow_abs(yz, a.fadeexp))));
  float sx = yx, sy = yy, sz = yz;
  if (a.wrows != nullptr) {
    float w3[3];
    k8_sample<3>(a.wrows, a.wD, a.wH, a.wW, pid, yx, yy, yz, w3);
    sx = w3[0]; sy = w3[1]; sz = w3[2];
  }
  float c[4];
  k8_sample<4>(a.rows, a.tD, a.tH, a.tW, pid, sx, sy, sz, c);
  const float al = __fmul_rn(c[3], fade);  // a: the tap is valid and in
  const float da = dv.x * c[0] + dv.y * c[1] + dv.z * c[2] + dv.w;
  const float g[4] = {dv.x * al, dv.y * al, dv.z * al, da * fade};
  const bool warped = a.wrows != nullptr;
  float ds[3];
  k10_sample_bwd<4>(a.rows, b.d_rows, a.tD, a.tH, a.tW, pid, sx, sy, sz, g,
                    b.prim_grad || warped, ds);
  if (warped) {
    k10_sample_bwd<3>(a.wrows, b.d_wrows, a.wD, a.wH, a.wW, pid, yx, yy, yz,
                      ds, b.prim_grad != 0, dy);
  } else if (b.prim_grad) {
    dy[0] = ds[0]; dy[1] = ds[1]; dy[2] = ds[2];
  }
  if (!b.prim_grad) return;
  const float dsum = da * c[3] * fade * a.neg_fadescale;  // d of |y|^n's sum
  dy[0] += dsum * k10_dpow_abs(yx, a.fadeexp);
  dy[1] += dsum * k10_dpow_abs(yy, a.fadeexp);
  dy[2] += dsum * k10_dpow_abs(yz, a.fadeexp);
}

__global__ void __launch_bounds__(K8_WARPS * 32)
mvp_march_bwd_kernel(const MarchBwdArgs b) {
  extern __shared__ __align__(16) float smem[];
  const MarchArgs& a = b.a;
  const int t = blockIdx.x;
  const int ts = a.tile_size;
  const int P = ts * ts;
  const int start = a.tile_start[t];
  const int nm = min(max(a.tile_end[t] - start, 0), a.M);
  if (nm == 0) return;  // an empty tile's rgba is 0: no gradient
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int S = a.S, Sp = a.Sp, R = a.R;
  const float step = a.stepsize;

  // [M] prim ids, [M][21] staged prim rows and [M][15] their gradients (if
  // staged), then each warp's area, starting on a 16-byte boundary
  int* s_pid = reinterpret_cast<int*>(smem);
  float* s_prim = smem + a.M;
  float* s_grad = s_prim + (a.staged ? a.M * K8_STAGE_COLS : 0);
  const int head =
      (a.M + (a.staged ? a.M * (K8_STAGE_COLS + K10_GRAD_COLS) : 0) + 3) & ~3;
  float* wbase = smem + head + warp * a.warp_floats;
  float4* acc = reinterpret_cast<float4*>(wbase);   // [S] steps
  float* hkey = wbase + 4 * S;                      // [M] hit depths
  int* hidx = reinterpret_cast<int*>(hkey + a.M);   // [M] hit list positions
  int* slot = hidx + a.M;                           // [R] the ray's slots
  float* sp = reinterpret_cast<float*>(slot + R);   // [32][17] a slot batch

  for (int i = threadIdx.x; i < nm; i += blockDim.x)
    s_pid[i] = a.sorted_prim[start + i];
  __syncthreads();
  if (a.staged) {
    for (int i = threadIdx.x; i < nm * K8_STAGE_COLS; i += blockDim.x) {
      const int m = i / K8_STAGE_COLS, c = i - m * K8_STAGE_COLS;
      s_prim[i] = a.prims[(long long)s_pid[m] * K8_PRIM_COLS + c];
    }
    for (int i = threadIdx.x; i < nm * K10_GRAD_COLS; i += blockDim.x)
      s_grad[i] = 0.0f;
  }
  __syncthreads();

  const float* g_t = b.grad_out + (long long)t * 4 * P;
  for (int p = warp; p < P; p += nwarps) {
    const float g0 = g_t[p], g1 = g_t[P + p], g2 = g_t[2 * P + p];
    const float ga = g_t[3 * P + p];
    if (g0 == 0.0f && g1 == 0.0f && g2 == 0.0f && ga == 0.0f) continue;
    const K8Ray rr = k8_ray(a, (long long)t * P + p);

    // (a) K8's steps 1-4: spans, t0, slots, the deposits
    float te, tx;
    bool any_hit;
    const int nhit = k8_ray_spans(a, s_prim, s_pid, nm, lane, rr, hkey, hidx,
                                  te, tx, any_hit);
    if (!any_hit) {  // its rgba is 0: no gradient
      __syncwarp();
      continue;
    }
    const float t0 = k8_t0(te, rr.tm0, step);
    __syncwarp();
    k8_ray_slots(hkey, hidx, nhit, R, lane, slot);
    for (int s = lane; s < S; s += 32) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    const int nR = min(nhit, R);
    for (int r0 = 0; r0 < nR; r0 += 32) {
      const int nb = min(32, nR - r0);
      if (lane < nb) {
        const int m = slot[r0 + lane];
        k8_slot_row(k8_prim_row(a, s_prim, s_pid, m), s_pid[m], rr, t0, step,
                    S, sp + lane * K10_SLOT_COLS);
      }
      __syncwarp();
      const int nq = nb * Sp;
      for (int q0 = 0; q0 < nq; q0 += 32) {
        const int qi = q0 + lane;
        const int r = qi / Sp;
        int sidx = 0;
        bool msk = false;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qi < nq) {
          const float* q = sp + r * K10_SLOT_COLS;
          float tj;
          msk = k8_tap(q, qi - r * Sp, t0, step, S, sidx, tj);
          if (msk) {
            float yx, yy, yz;
            k8_tap_coords(q, tj, yx, yy, yz);
            const float4 s = k8_sample_prim(a, __float_as_int(q[9]), yx, yy,
                                            yz);
            val = make_float4(__fmul_rn(s.x, s.w), __fmul_rn(s.y, s.w),
                              __fmul_rn(s.z, s.w), s.w);
          }
        }
        const int r_hi = min(q0 + 31, nq - 1) / Sp;
        for (int rr2 = q0 / Sp; rr2 <= r_hi; ++rr2) {
          if (msk && r == rr2) {
            float4 c = acc[sidx];
            c.x = __fadd_rn(c.x, val.x);
            c.y = __fadd_rn(c.y, val.y);
            c.z = __fadd_rn(c.z, val.z);
            c.w = __fadd_rn(c.w, val.w);
            acc[sidx] = c;
          }
          __syncwarp();
        }
      }
      __syncwarp();
    }

    // (b) the composite reversed: acc[s] becomes d(rgb * a, a) at step s
    {
      const int per = (S + 31) / 32;
      const int s_lo = min(lane * per, S), s_hi = min(s_lo + per, S);
      const float t_live = __fadd_rn(tx, 1e-5f);
      double part = 0.0;
      for (int s = s_lo; s < s_hi; ++s)
        part += (double)__fmul_rn(
            __fmul_rn(acc[s].w, k8_mask(k8_live(t0, step, s, t_live))), step);
      const double cum0 = k8_scan_excl(part, lane);
      // d contrib[s] = sum_k g_k * rgb_mean_k[s]
      auto dcontrib = [&](int s) -> float {
        const float4 c = acc[s];
        const float al = __fmul_rn(c.w, k8_mask(k8_live(t0, step, s, t_live)));
        const float safe = al > 0.0f ? al : 1.0f;
        return g0 * __fdiv_rn(c.x, safe) + g1 * __fdiv_rn(c.y, safe) +
               g2 * __fdiv_rn(c.z, safe);
      };
      // dA[s] = (d contrib[s] - d contrib[s + 1] + [s = S - 1] g_a) times
      // minimum's share: 1 below 1, 1/2 at 1, 0 above
      auto dA = [&](int s, float A, float dc, float dc_next) -> float {
        const float d = dc - dc_next + (s == S - 1 ? ga : 0.0f);
        return A < 1.0f ? d : (A == 1.0f ? 0.5f * d : 0.0f);
      };
      // the next lane's first step, read before any lane writes
      const float dc_hi = s_hi < S ? dcontrib(s_hi) : 0.0f;
      double epart = 0.0;
      {
        double cum = cum0;
        float dc = s_lo < s_hi ? dcontrib(s_lo) : 0.0f;
        for (int s = s_lo; s < s_hi; ++s) {
          const float al = __fmul_rn(acc[s].w,
                                     k8_mask(k8_live(t0, step, s, t_live)));
          cum += (double)__fmul_rn(al, step);
          const float dcn = s + 1 < s_hi ? dcontrib(s + 1) : dc_hi;
          epart += (double)dA(s, (float)cum, dc, dcn);
          dc = dcn;
        }
      }
      // the reverse prefix sum at s_lo: this lane's steps and every later
      // lane's
      double run = epart;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double n = __shfl_down_sync(K8_FULL, run, o);
        if (lane + o < 32) run += n;
      }
      __syncwarp();
      double cum = cum0;
      float prev = lane == 0 ? 0.0f : fminf((float)cum0, 1.0f);
      float dc = s_lo < s_hi ? dcontrib(s_lo) : 0.0f;
      for (int s = s_lo; s < s_hi; ++s) {
        const float4 c = acc[s];
        const bool live = k8_live(t0, step, s, t_live);
        const float al = __fmul_rn(c.w, k8_mask(live));
        cum += (double)__fmul_rn(al, step);
        const float A = (float)cum;
        const float Aclip = fminf(A, 1.0f);
        const float contrib = __fsub_rn(Aclip, prev);
        prev = Aclip;
        const float dcn = s + 1 < s_hi ? dcontrib(s + 1) : dc_hi;
        const float revc = (float)run;  // sum of dA over steps >= s
        run -= (double)dA(s, A, dc, dcn);
        // contrib / alpha, exact (stepsize) below saturation
        const float safe = al > 0.0f ? al : 1.0f;
        const float ratio =
            A < 1.0f && al > 0.0f ? step : __fdiv_rn(contrib, safe);
        // d alpha: the prefix sums' and the mean colour's (d safe)
        const float dal = revc * step - (al > 0.0f ? dc * ratio : 0.0f);
        acc[s] = make_float4(g0 * ratio, g1 * ratio, g2 * ratio,
                             live ? dal : 0.0f);
        dc = dcn;
      }
    }
    __syncwarp();

    // (c) the taps again, now with their steps' gradients
    for (int r0 = 0; r0 < nR; r0 += 32) {
      const int nb = min(32, nR - r0);
      if (lane < nb) {
        const int m = slot[r0 + lane];
        float* q = sp + lane * K10_SLOT_COLS;
        k8_slot_row(k8_prim_row(a, s_prim, s_pid, m), s_pid[m], rr, t0, step,
                    S, q);
        for (int j = 10; j < 16; ++j) q[j] = 0.0f;
      }
      __syncwarp();
      const int nq = nb * Sp;
      for (int q0 = 0; q0 < nq; q0 += 32) {
        const int qi = q0 + lane;
        const int r = qi / Sp;
        float dy[3] = {0.0f, 0.0f, 0.0f};
        float tj = 0.0f;
        if (qi < nq) {
          const float* q = sp + r * K10_SLOT_COLS;
          int sidx;
          if (k8_tap(q, qi - r * Sp, t0, step, S, sidx, tj)) {
            float yx, yy, yz;
            k8_tap_coords(q, tj, yx, yy, yz);
            k10_tap(b, __float_as_int(q[9]), yx, yy, yz, acc[sidx], dy);
          }
        }
        if (b.prim_grad) {  // dAc += dy * tj, dBc += dy: a warp sum a slot
          const int r_hi = min(q0 + 31, nq - 1) / Sp;
          for (int rr2 = q0 / Sp; rr2 <= r_hi; ++rr2) {
            const bool on = qi < nq && r == rr2;
            float* q = sp + rr2 * K10_SLOT_COLS;
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              const float sa = k10_warp_sum(on ? dy[j] * tj : 0.0f);
              const float sb = k10_warp_sum(on ? dy[j] : 0.0f);
              if (lane == 0) {
                q[10 + j] += sa;
                q[13 + j] += sb;
              }
            }
          }
        }
      }
      __syncwarp();
      // each slot's dAc, dBc into its prim's 15 gradients
      if (b.prim_grad && lane < nb) {
        const float* q = sp + lane * K10_SLOT_COLS;
        const float dAc[3] = {q[10], q[11], q[12]};
        const float dBc[3] = {q[13], q[14], q[15]};
        if (dAc[0] != 0.0f || dAc[1] != 0.0f || dAc[2] != 0.0f ||
            dBc[0] != 0.0f || dBc[1] != 0.0f || dBc[2] != 0.0f) {
          const int m = slot[r0 + lane];
          const float* pr = k8_prim_row(a, s_prim, s_pid, m);
          const float* pos = pr + 6;
          const float* rot = pr + 9;  // [i][j]
          const float* scl = pr + 18;
          const float rel[3] = {__fsub_rn(rr.o[0], pos[0]),
                                __fsub_rn(rr.o[1], pos[1]),
                                __fsub_rn(rr.o[2], pos[2])};
          float* dst = a.staged ? s_grad + m * K10_GRAD_COLS
                                : b.d_prims + (long long)s_pid[m] * K10_GRAD_COLS;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float rtd = rot[j] * rr.d[0] + rot[3 + j] * rr.d[1] +
                              rot[6 + j] * rr.d[2];
            const float rtr = rot[j] * rel[0] + rot[3 + j] * rel[1] +
                              rot[6 + j] * rel[2];
            atomicAdd(dst + 12 + j, dAc[j] * rtd + dBc[j] * rtr);
#pragma unroll
            for (int i = 0; i < 3; ++i)
              atomicAdd(dst + 3 + 3 * i + j,
                        scl[j] * (dAc[j] * rr.d[i] + dBc[j] * rel[i]));
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
            atomicAdd(dst + i, -(rot[3 * i] * scl[0] * dBc[0] +
                                 rot[3 * i + 1] * scl[1] * dBc[1] +
                                 rot[3 * i + 2] * scl[2] * dBc[2]));
        }
      }
      __syncwarp();  // the batch's slot rows are read: the next may write
    }
  }

  if (b.prim_grad && a.staged) {
    __syncthreads();
    for (int i = threadIdx.x; i < nm * K10_GRAD_COLS; i += blockDim.x) {
      const float v = s_grad[i];
      if (v != 0.0f)
        atomicAdd(b.d_prims + (long long)s_pid[i / K10_GRAD_COLS] *
                                  K10_GRAD_COLS + i % K10_GRAD_COLS, v);
    }
  }
}

// Shared memory of a block of `warps` warps, in floats.
static long long k10_smem_floats(int M, int staged, int warp_floats,
                                 int warps) {
  const long long head =
      (M + (staged ? (long long)M * (K8_STAGE_COLS + K10_GRAD_COLS) : 0) + 3)
      & ~3LL;
  return head + (long long)warps * warp_floats;
}

// K8's inputs (goliath_mvp_march) and grad_out [T, 4, P] f32; d_rows
// [K*tD*tH*tW, 8], d_wrows [K*wD*wH*wW, 6] (or null, with wrows), d_prims
// [K, 15] f32, zeroed by the caller (d_prims written only with prim_grad).
// Returns the launch's CUDA error.
extern "C" int goliath_mvp_march_bwd(
    const float* raypos, const float* raydir, const float* tminmax,
    const int32_t* tile_start, const int32_t* tile_end,
    const int32_t* sorted_prim, const float* prims, const float* rows,
    const float* wrows, const float* grad_out, int n_tiles, int tile_size,
    int tD, int tH, int tW, int wD, int wH, int wW, int S, int Sp, int M,
    int R, int fadeexp, float stepsize, float fadescale, int prim_grad,
    float* d_rows, float* d_wrows, float* d_prims, cudaStream_t stream) {
  if (tile_size < 1 || S < 1 || Sp < 1 || Sp > S || M < 1 || R < 1 ||
      R > M || fadeexp < 1 || (wrows != nullptr) != (d_wrows != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  MarchBwdArgs b = {};
  MarchArgs& a = b.a;
  a.raypos = raypos; a.raydir = raydir; a.tminmax = tminmax;
  a.tile_start = tile_start; a.tile_end = tile_end;
  a.sorted_prim = sorted_prim; a.prims = prims; a.rows = rows;
  a.wrows = wrows;
  a.tile_size = tile_size;
  a.tD = tD; a.tH = tH; a.tW = tW; a.wD = wD; a.wH = wH; a.wW = wW;
  a.S = S; a.Sp = Sp; a.M = M; a.R = R; a.fadeexp = fadeexp;
  a.stepsize = stepsize; a.neg_fadescale = -fadescale;
  a.staged = M <= K8_STAGE_MAX;
  // a warp's area: the step grid, the hit depths and positions, the slots
  // and a batch of 32 slot rows
  a.warp_floats = (4 * S + 2 * M + R + 32 * K10_SLOT_COLS + 3) & ~3;
  b.grad_out = grad_out;
  b.d_rows = d_rows; b.d_wrows = d_wrows; b.d_prims = d_prims;
  b.prim_grad = prim_grad;
  int warps = K8_WARPS;
  while (warps > 1 &&
         k10_smem_floats(M, a.staged, a.warp_floats, warps) * 4 > K8_SMEM_MAX)
    --warps;
  const long long smem =
      k10_smem_floats(M, a.staged, a.warp_floats, warps) * 4;
  if (smem > K8_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mvp_march_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mvp_march_bwd_kernel<<<n_tiles, warps * 32, (size_t)smem, stream>>>(b);
  return (int)cudaGetLastError();
}
