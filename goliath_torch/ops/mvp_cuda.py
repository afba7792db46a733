"""The MVP march's forward K8 and the OLAT teacher's deep-shadow integral
K9, their plain versions and their wrappers (counterparts of XLA functions
of the JAX package's ops/mvp.py, which has no Pallas kernel for them; the
reference Goliath ran its march as the CUDA extension mvpraymarch).

K8 ``mvp_march`` (``csrc/mvp_march.cu``) replaces ``march_group`` of the
JAX ``mvp_raymarch_tiled``: every tile's rays marched through the prims
binned to it, rgba [T, 4, P], one launch for all T tiles. Plain version:
``mvp_march_plain``, ``ops/mvp.py`` ``march_tiles_plain`` (the port's
``march_group`` over groups of tiles) on the same ``MarchInputs``, built by
``ops/mvp.py`` ``march_inputs`` for both. K8 computes the forward only:
``mvp_raymarch_tiled`` takes it on CUDA tensors without gradient, and
marches the plain groups otherwise; on the card it takes an integer
``fadeexp`` of at least 1 and raises for any other.

K9 ``shadow_integral`` (``csrc/mvp_shadow.cu``) replaces
``_shadow_at_points_impl`` of the JAX ``shadow_at_points``: one launch for
all the points. Plain version: ``shadow_integral_plain``, the port's
``_shadow_at_points_impl``.

Each wrapper takes the kernel for a CUDA tensor and the plain version for a
CPU tensor (ops/backend.py), and adds one to ``gsplat_cuda.LAUNCHES[name]``
(``gsplat_cuda.count_launch``) each time it launches its kernel. The
kernels are built with the others (``gsplat_cuda.load_kernels``), never at
import time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from goliath_torch.ops import gsplat_cuda
from goliath_torch.ops.backend import target_backend
from goliath_torch.ops.mvp import (MARCH_COUNTS, MarchInputs,
                                   _shadow_at_points_impl, march_tiles_plain)

PRIM_COLS = 24  # pmin 3, pmax 3, primpos 3, primrot 9 (row-major), primscale 3, pad 3


def prim_table(inp: MarchInputs) -> torch.Tensor:
    """K8's per-prim rows [K, 24] float32: the AABB, position, rotation and
    scale of each prim, staged a tile list at a time by the kernel."""
    K = inp.primpos.shape[0]
    return torch.cat([inp.pmin, inp.pmax, inp.primpos.detach(),
                      inp.primrot.detach().reshape(K, 9),
                      inp.primscale.detach(),
                      inp.pmin.new_zeros(K, PRIM_COLS - 21)], 1).float()


def mvp_march_plain(inp: MarchInputs, count: bool = False
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Plain K8: (rgba [T, 4, P], MARCH_COUNTS as 0-dim int64 tensors when
    ``count``, else None). The plain tile groups without recompute."""
    counts = {} if count else None
    return march_tiles_plain(inp, counts), counts


def mvp_march(inp: MarchInputs, count: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """K8 on CUDA tensors, ``mvp_march_plain`` on CPU tensors: (rgba
    [T, 4, P], the counts or None). The kernel computes the forward only
    (its output takes no gradient) and takes an integer ``fadeexp`` of at
    least 1 (ValueError otherwise)."""
    if target_backend(inp.raypos) == "cpu":
        return mvp_march_plain(inp, count)
    fe = float(inp.fadeexp)
    if fe != int(fe) or int(fe) < 1:
        # _pow_abs takes any other exponent through torch.pow
        raise ValueError(f"K8 takes an integer fadeexp of at least 1, got "
                         f"{inp.fadeexp}")
    K, C, D, H, W = inp.template.shape
    if C != 4:
        raise ValueError(f"K8 takes an RGBA template, got {C} channels")
    wshape = (1, 1, 1)
    wrows = inp.raypos.new_zeros(0)
    if inp.warp is not None:
        if inp.warp.shape[1] != 3 or inp.warp.shape[0] != K:
            raise ValueError(f"the warp field must be [K, 3, ...], got "
                             f"{inp.warp.shape}")
        wshape = tuple(inp.warp.shape[2:])
        wrows = inp.warp.rows.detach().float().contiguous()
    S, stepsize = inp.max_steps, inp.stepsize
    out, counts, cut = gsplat_cuda.load_kernels().mvp_march(
        inp.raypos.contiguous(), inp.raydir.contiguous(),
        inp.tminmax.contiguous(), inp.tile_start.contiguous(),
        inp.tile_end.contiguous(), inp.sorted_prim.contiguous(),
        prim_table(inp).contiguous(),
        inp.template.rows.detach().float().contiguous(), wrows,
        inp.tile_size, inp.ntx, inp.img_h, inp.img_w, (D, H, W), wshape, S,
        inp.window_steps, inp.max_prims_per_tile, inp.max_prims_per_ray,
        int(inp.fadeexp), stepsize, (S - 1) * stepsize, inp.fadescale, count)
    gsplat_cuda.count_launch("mvp_march", inp.raypos)
    if not count:
        return out, None
    return out, dict(zip(MARCH_COUNTS, [*counts.unbind(), cut.sum()]))


def shadow_integral_plain(density: torch.Tensor, points: torch.Tensor,
                          light_pos: torch.Tensor, n_steps: int
                          ) -> torch.Tensor:
    """Plain K9: ``_shadow_at_points_impl`` on every point at once, [M]."""
    return _shadow_at_points_impl(density, points, light_pos, n_steps)


def shadow_integral(density: torch.Tensor, points: torch.Tensor,
                    light_pos: torch.Tensor, n_steps: int) -> torch.Tensor:
    """K9 on CUDA tensors, ``shadow_integral_plain`` on CPU tensors: the
    accumulated alpha from ``light_pos`` [3] to each of ``points`` [M, 3]
    through ``density`` [D, H, W] (z, y, x), ``n_steps`` midpoint samples,
    clamped to [0, 1]: [M]."""
    if density.dim() != 3 or points.dim() != 2 or points.shape[1] != 3 \
            or light_pos.shape != (3,):
        raise ValueError(f"shadow_integral takes density [D, H, W], points "
                         f"[M, 3] and light_pos [3], got "
                         f"{tuple(density.shape)}, {tuple(points.shape)}, "
                         f"{tuple(light_pos.shape)}")
    if target_backend(density) == "cpu":
        return shadow_integral_plain(density, points, light_pos, n_steps)
    out = gsplat_cuda.load_kernels().shadow_integral(
        density.float().contiguous(), points.float().contiguous(),
        light_pos.float().contiguous(), n_steps)
    gsplat_cuda.count_launch("shadow_integral", density)
    return out
