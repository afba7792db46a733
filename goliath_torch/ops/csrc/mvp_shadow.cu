// K9: the OLAT teacher's deep-shadow integral, the accumulated alpha from a
// light to each query point through a density grid, [M].
//
// Replaces no Pallas kernel: the JAX package integrates in XLA, in
// goliath_tpu/ops/mvp.py `shadow_at_points` (:789) /
// `_shadow_at_points_impl` (:814) (the reference Goliath splatted its
// shadows in the CUDA extension extensions/mvpraymarch). The port's plain
// version is goliath_torch/ops/mvp.py `_shadow_at_points_impl`. For each
// point, as it computes it:
//   d = point - light; dist = sqrt((dx*dx + dy*dy) + dz*dz) (`_norm`'s
//   order); dirn = d / max(dist, 1e-8);
//   the segment clipped to the [-1, 1] volume: a direction component below
//   1e-12 in magnitude becomes +1e-12 (its sign dropped), t_enter the
//   slabs' largest entry clamped at 0, seg = max(dist - t_enter, 0), so the
//   segment ends at the point;
//   n_steps midpoint samples at t_enter + seg * (i + 0.5) / n_steps, each
//   `grid_sample_3d`'s trilinear tap with zero padding (align_corners
//   false: each axis's coordinate ((c + 1) * size - 1) / 2, its taps
//   floor(.) and floor(.) + 1, the weight c - c0, an out-of-range tap's
//   weight 0; the weights multiplied x * y * z in that order, the eight
//   corners summed z-major, then y, then x);
//   the samples' sum times seg / n_steps, clamped to [0, 1].
// Each product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// multiply-add contraction), divisions, reciprocals and the square root
// are IEEE, float-to-int conversions saturate (NaN to 0). The samples are
// summed in step order (the plain version's torch.sum takes its own
// order). The texture unit's filtering is not used: its weights are 8-bit
// fixed point. An all-zero grid is integrated like any other.
//
// Design: one thread per point, every point in one launch (no chunks).
// The grid (64^3 float32, 1 MiB at the teacher's size) stays in L2 and the
// read-only cache; a thread's eight corner loads of a sample are
// independent. The light's position is read from device memory (a
// broadcast), so the launch needs no host copy.
//
// Bound: device-memory bytes (12 B a point read, 4 B written, the grid
// once) against the float32 operations (chip_smoke.py `K9_OPS_PER_POINT`
// and `K9_OPS_PER_SAMPLE`: 43 a point and 69 a sample as written here).
// At the teacher's 8,388,608 points and 32 steps the operations bound it.
//
// Plain C interface, bound to PyTorch by csrc/bindings.cpp, which
// allocates the output. The launcher allocates nothing, launches on the
// given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K9_THREADS 256

__device__ __forceinline__ long long k9_sat(float x) {
  if (isnan(x)) return 0;
  return (long long)fminf(fmaxf(x, -2147483648.0f), 2147483520.0f);
}

// One axis of `grid_sample_3d` (align_corners false, zeros): the clamped
// taps and their weights, an out-of-range tap's weight 0.
__device__ __forceinline__ void k9_axis(float c, int n, int& i0, int& i1,
                                        float& w0, float& w1) {
  const float u = __fmul_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(c, 1.0f), (float)n), 1.0f), 0.5f);
  const float c0 = floorf(u);
  const float w = __fsub_rn(u, c0);
  const long long a = k9_sat(c0), b = a + 1;
  w0 = __fmul_rn(__fsub_rn(1.0f, w), (a >= 0 && a < n) ? 1.0f : 0.0f);
  w1 = __fmul_rn(w, (b >= 0 && b < n) ? 1.0f : 0.0f);
  i0 = (int)(a < 0 ? 0 : (a > n - 1 ? n - 1 : a));
  i1 = (int)(b < 0 ? 0 : (b > n - 1 ? n - 1 : b));
}

__global__ void __launch_bounds__(K9_THREADS)
shadow_integral_kernel(const float* __restrict__ density, int D, int H,
                       int W, const float* __restrict__ points, long long n,
                       const float* __restrict__ light, int n_steps,
                       float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float l[3] = {__ldg(light), __ldg(light + 1), __ldg(light + 2)};
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = __fsub_rn(points[i * 3 + k], l[k]);
  const float dist = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
      __fmul_rn(d[2], d[2])));
  const float dn = fmaxf(dist, 1e-8f);
  float dirn[3];
  float t_enter = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dirn[k] = __fdiv_rn(d[k], dn);
    const float inv =
        __fdiv_rn(1.0f, fabsf(dirn[k]) < 1e-12f ? 1e-12f : dirn[k]);
    const float t1 = __fmul_rn(__fsub_rn(-1.0f, l[k]), inv);
    const float t2 = __fmul_rn(__fsub_rn(1.0f, l[k]), inv);
    const float lo = fminf(t1, t2);
    t_enter = k ? fmaxf(t_enter, lo) : lo;
  }
  t_enter = fmaxf(t_enter, 0.0f);
  const float seg = fmaxf(__fsub_rn(dist, t_enter), 0.0f);
  const float nf = (float)n_steps;
  float sum = 0.0f;
  for (int s = 0; s < n_steps; ++s) {
    const float frac = __fdiv_rn(__fadd_rn((float)s, 0.5f), nf);
    const float ts = __fadd_rn(t_enter, __fmul_rn(seg, frac));
    int x0, x1, y0, y1, z0, z1;
    float wx0, wx1, wy0, wy1, wz0, wz1;
    k9_axis(__fadd_rn(l[0], __fmul_rn(dirn[0], ts)), W, x0, x1, wx0, wx1);
    k9_axis(__fadd_rn(l[1], __fmul_rn(dirn[1], ts)), H, y0, y1, wy0, wy1);
    k9_axis(__fadd_rn(l[2], __fmul_rn(dirn[2], ts)), D, z0, z1, wz0, wz1);
    const int zs[2] = {z0, z1}, ys[2] = {y0, y1}, xs[2] = {x0, x1};
    const float wzs[2] = {wz0, wz1}, wys[2] = {wy0, wy1}, wxs[2] = {wx0, wx1};
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = __ldg(density + (zs[c >> 2] * H + ys[(c >> 1) & 1]) * W +
                   xs[c & 1]);
    float smp = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float term = __fmul_rn(
          v[c], __fmul_rn(__fmul_rn(wxs[c & 1], wys[(c >> 1) & 1]),
                          wzs[c >> 2]));
      smp = c ? __fadd_rn(smp, term) : term;
    }
    sum = s ? __fadd_rn(sum, smp) : smp;
  }
  const float acc = __fmul_rn(sum, __fdiv_rn(seg, nf));
  out[i] = fminf(fmaxf(acc, 0.0f), 1.0f);
}

// density [D, H, W] f32 (z, y, x); points [n, 3] f32; light [3] f32 on the
// same device; out [n] f32. Returns the launch's CUDA error.
extern "C" int goliath_shadow_integral(const float* density, int D, int H,
                                       int W, const float* points,
                                       long long n, const float* light,
                                       int n_steps, float* out,
                                       cudaStream_t stream) {
  if (D < 1 || H < 1 || W < 1 || n_steps < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + K9_THREADS - 1) / K9_THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  shadow_integral_kernel<<<(unsigned)blocks, K9_THREADS, 0, stream>>>(
      density, D, H, W, points, n, light, n_steps, out);
  return (int)cudaGetLastError();
}
