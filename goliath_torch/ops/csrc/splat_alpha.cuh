// Per-(pair, pixel) arithmetic shared by the compositor forward (K1,
// compositor_fwd.cu) and backward (K2, compositor_bwd.cu).
//
// The drop tests (sigma < 0, alpha < 1/255) are discontinuous: a pair kept
// by one version and dropped by another changes a pixel by up to
// alpha*T ~ 0.004*T, and the backward must replay the forward's
// transmittance pair by pair. So sigma, the raw alpha and the T update are
// written once, here, and rounded step by step in the plain PyTorch
// version's order: the _rn intrinsics keep nvcc from contracting the
// products and sums into FMAs, which round differently.

#pragma once

#include <cuda_runtime.h>

#define ALPHA_CLIP 0.999f
#define ALPHA_MIN (1.0f / 255.0f)
#define T_EPS 1e-4f
#define MAX_C 8
#define ROW_HEAD 8  // x, y, a, b, c, op, 0, 0 then C color channels

struct PairAlpha {
  float dx, dy;  // pair center minus pixel center
  float raw;     // op * exp(-clip(sigma, 0, 60)), before the 0.999 clip
  float alpha;   // min(0.999, raw)
  bool keep;     // sigma >= 0 and alpha >= 1/255
};

// d: one pair row (x, y, conic a/b/c, opacity, ...); (px, py): pixel center.
// NOEXP is the ablation probe P1's `noexp` variant: op * max(1 - sigma, 0)
// in place of the exp (never on the render path).
template <bool NOEXP = false>
__device__ __forceinline__ PairAlpha pair_alpha(const float* d, float px,
                                                float py) {
  PairAlpha r;
  r.dx = __fsub_rn(d[0], px);
  r.dy = __fsub_rn(d[1], py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(d[2], r.dx), r.dx),
                               __fmul_rn(__fmul_rn(d[4], r.dy), r.dy));
  const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                __fmul_rn(__fmul_rn(d[3], r.dx), r.dy));
  r.raw = NOEXP ? __fmul_rn(d[5], fmaxf(__fsub_rn(1.0f, sigma), 0.0f))
                : __fmul_rn(d[5], expf(-fminf(fmaxf(sigma, 0.0f), 60.0f)));
  r.alpha = fminf(ALPHA_CLIP, r.raw);
  r.keep = !(sigma < 0.0f || r.alpha < ALPHA_MIN);
  return r;
}

// Transmittance behind a kept pair.
__device__ __forceinline__ float transmit(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}
