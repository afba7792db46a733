"""The MVP march's forward K8 and backward K10 and the OLAT teacher's
deep-shadow integral K9, their plain versions and their wrappers
(counterparts of XLA functions of the JAX package's ops/mvp.py, which has no
Pallas kernel for them; the reference Goliath ran its march as the CUDA
extension mvpraymarch).

K8 ``mvp_march`` (``csrc/mvp_march.cu``) replaces ``march_group`` of the
JAX ``mvp_raymarch_tiled``: every tile's rays marched through the prims
binned to it, rgba [T, 4, P], one launch for all T tiles. Plain version:
``mvp_march_plain``, ``ops/mvp.py`` ``march_tiles_plain`` (the port's
``march_group`` over groups of tiles) on the same ``MarchInputs``, built by
``ops/mvp.py`` ``march_inputs`` for both. On the card it takes an integer
``fadeexp`` of at least 1 and raises for any other.

K10 ``mvp_march_backward`` (``csrc/mvp_march_bwd.cu``) replaces XLA's
backward of the JAX ``march_group`` (under ``jax.checkpoint``, ops/mvp.py:681):
from the gradient of K8's rgba, the gradients of the packed template rows,
the warp field's rows and primpos, primrot and primscale, replaying K8's
forward tile by tile (the device code of both is ``csrc/mvp_march.cuh``).
Plain version: ``mvp_march_backward_plain``, ``torch.autograd.grad`` of
``march_tiles_plain`` over the same leaves. ``MVPMarch`` joins the two into
one differentiable function, which ``mvp_raymarch_tiled`` calls on CUDA
tensors under autograd; it computes no gradient of the rays and raises
ValueError where one is asked for.

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
from goliath_torch.ops.mvp import (MARCH_COUNTS, MarchInputs, PackedVolume,
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


def _kernel_inputs(inp: MarchInputs):
    """The tensors and shapes K8 and K10 take from ``inp``: (raypos, raydir,
    tminmax, tile_start, tile_end, sorted_prim, the prim table, the template
    rows, the warp rows (empty without a warp), the template's (D, H, W),
    the warp's (D, H, W)), detached. Raises ValueError for a fadeexp that is
    not an integer of at least 1, a template that is not RGBA or a warp
    field that is not [K, 3, ...]."""
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
    return (inp.raypos.detach().contiguous(), inp.raydir.detach().contiguous(),
            inp.tminmax.detach().contiguous(), inp.tile_start.contiguous(),
            inp.tile_end.contiguous(), inp.sorted_prim.contiguous(),
            prim_table(inp).contiguous(),
            inp.template.rows.detach().float().contiguous(), wrows,
            (D, H, W), wshape)


def mvp_march(inp: MarchInputs, count: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """K8 on CUDA tensors, ``mvp_march_plain`` on CPU tensors: (rgba
    [T, 4, P], the counts or None). The kernel's output takes no gradient
    (``MVPMarch`` is the differentiable march) and it takes an integer
    ``fadeexp`` of at least 1 (ValueError otherwise)."""
    if target_backend(inp.raypos) == "cpu":
        return mvp_march_plain(inp, count)
    (rp, rd, tm, start, end, sp, prims, rows, wrows, tshape,
     wshape) = _kernel_inputs(inp)
    S, stepsize = inp.max_steps, inp.stepsize
    out, counts, cut = gsplat_cuda.load_kernels().mvp_march(
        rp, rd, tm, start, end, sp, prims, rows, wrows, inp.tile_size,
        inp.ntx, inp.img_h, inp.img_w, tshape, wshape, S, inp.window_steps,
        inp.max_prims_per_tile, inp.max_prims_per_ray, int(inp.fadeexp),
        stepsize, (S - 1) * stepsize, inp.fadescale, count)
    gsplat_cuda.count_launch("mvp_march", inp.raypos)
    if not count:
        return out, None
    return out, dict(zip(MARCH_COUNTS, [*counts.unbind(), cut.sum()]))


# the gradients K10 and its plain version give, in this order
MARCH_GRADS = ("rows", "wrows", "primpos", "primrot", "primscale")


def mvp_march_backward_plain(inp: MarchInputs, grad_out: torch.Tensor,
                             prim_grad: bool = True
                             ) -> Dict[str, Optional[torch.Tensor]]:
    """Plain K10: the gradients of ``sum(march_tiles_plain(inp) *
    grad_out)`` with respect to the template rows, the warp rows (None
    without a warp), primpos, primrot and primscale (MARCH_GRADS), by
    ``torch.autograd.grad`` over fresh leaves of the same values (each tile
    group recomputed in the backward); with ``prim_grad`` False the prims'
    gradients are zeros."""
    leaves = {"rows": inp.template.rows, "primpos": inp.primpos,
              "primrot": inp.primrot, "primscale": inp.primscale}
    if inp.warp is not None:
        leaves["wrows"] = inp.warp.rows
    wanted = [k for k in leaves if prim_grad or not k.startswith("prim")]
    leaves = {k: v.detach().requires_grad_(k in wanted)
              for k, v in leaves.items()}
    with torch.enable_grad():
        fresh = inp._replace(
            primpos=leaves["primpos"], primrot=leaves["primrot"],
            primscale=leaves["primscale"],
            template=PackedVolume(leaves["rows"], inp.template.shape),
            warp=None if inp.warp is None else PackedVolume(
                leaves["wrows"], inp.warp.shape),
            raypos=inp.raypos.detach(), raydir=inp.raydir.detach(),
            tminmax=inp.tminmax.detach())
        out = march_tiles_plain(fresh, recompute=True)
        got = (torch.autograd.grad(out, [leaves[k] for k in wanted],
                                   grad_out, allow_unused=True)
               if out.requires_grad else [None] * len(wanted))
    found = dict(zip(wanted, got))
    grads = dict.fromkeys(MARCH_GRADS)
    grads.update((k, torch.zeros_like(v) if found.get(k) is None
                  else found[k]) for k, v in leaves.items())
    return grads


def mvp_march_backward(inp: MarchInputs, grad_out: torch.Tensor,
                       prim_grad: bool = True
                       ) -> Dict[str, Optional[torch.Tensor]]:
    """K10 on CUDA tensors, ``mvp_march_backward_plain`` on CPU tensors:
    the gradients MARCH_GRADS of K8's rgba [T, 4, P] under ``grad_out``
    [T, 4, P] (the warp rows' None without a warp); with ``prim_grad``
    False the prims' gradients are zeros (and K10 does not compute them).
    Float atomics sum them in an order that changes from run to run."""
    if target_backend(inp.raypos) == "cpu":
        return mvp_march_backward_plain(inp, grad_out, prim_grad)
    (rp, rd, tm, start, end, sp, prims, rows, wrows, tshape,
     wshape) = _kernel_inputs(inp)
    d_rows, d_wrows, d_prims = gsplat_cuda.load_kernels().mvp_march_bwd(
        rp, rd, tm, start, end, sp, prims, rows, wrows,
        grad_out.detach().float().contiguous(), inp.tile_size, tshape, wshape,
        inp.max_steps, inp.window_steps, inp.max_prims_per_tile,
        inp.max_prims_per_ray, int(inp.fadeexp), inp.stepsize,
        inp.fadescale, prim_grad)
    gsplat_cuda.count_launch("mvp_march_bwd", inp.raypos)
    K = d_prims.shape[0]
    return {"rows": d_rows, "wrows": None if inp.warp is None else d_wrows,
            "primpos": d_prims[:, :3], "primrot": d_prims[:, 3:12].reshape(
                K, 3, 3), "primscale": d_prims[:, 12:]}


# MarchInputs' tensors, in MVPMarch's argument order, then its other fields
_TENSOR_FIELDS = ("raypos", "raydir", "tminmax", "tile_start", "tile_end",
                  "sorted_prim", "pmin", "pmax", "primpos", "primrot",
                  "primscale")
_OTHER_FIELDS = ("stepsize", "max_steps", "window_steps",
                 "max_prims_per_tile", "max_prims_per_ray", "chunk",
                 "fadescale", "fadeexp", "img_h", "img_w", "ntx",
                 "tile_size")


class MVPMarch(torch.autograd.Function):
    """The tiled march's tiles, differentiable: K8 forward (no counts, no
    host sync), K10 backward. Takes the ``MarchInputs``' tensors (the
    template's and the warp's packed rows, the warp's None without one),
    then the template's and the warp's shapes and the other fields as plain
    Python values (``march``); keeps only the tensors. Gives the gradients
    of the template rows, the warp rows, primpos, primrot and primscale,
    and raises ValueError where a ray input (raypos, raydir, tminmax)
    needs one: K10 computes none."""

    @staticmethod
    def forward(ctx, raypos, raydir, tminmax, tile_start, tile_end,
                sorted_prim, pmin, pmax, primpos, primrot, primscale, rows,
                wrows, tshape, wshape, *other):
        if any(ctx.needs_input_grad[:3]):
            raise ValueError(
                "the march on the card computes no gradient of the rays "
                "(raypos, raydir, tminmax): detach them, or march on the "
                "CPU")
        ctx.dims = (tshape, wshape, other)
        ctx.save_for_backward(raypos, raydir, tminmax, tile_start, tile_end,
                              sorted_prim, pmin, pmax, primpos, primrot,
                              primscale, rows, wrows)
        return mvp_march(_march_inputs(
            (raypos, raydir, tminmax, tile_start, tile_end, sorted_prim,
             pmin, pmax, primpos, primrot, primscale, rows, wrows),
            tshape, wshape, other))[0]

    @staticmethod
    def backward(ctx, grad_out):
        tshape, wshape, other = ctx.dims
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = mvp_march_backward(_march_inputs(saved, tshape, wshape, other),
                               grad_out, prim_grad=any(need[8:11]))

        def cast(key, i):
            return g[key].to(saved[i].dtype) if need[i] else None

        return ((None,) * 8 + (cast("primpos", 8), cast("primrot", 9),
                               cast("primscale", 10), cast("rows", 11),
                               cast("wrows", 12) if saved[12] is not None
                               else None) + (None,) * (2 + len(other)))


def _march_inputs(tensors, tshape, wshape, other) -> MarchInputs:
    """MarchInputs from MVPMarch's arguments."""
    fields = dict(zip(_TENSOR_FIELDS, tensors[:11]))
    rows, wrows = tensors[11], tensors[12]
    fields.update(zip(_OTHER_FIELDS, other))
    return MarchInputs(
        **fields, template=PackedVolume(rows, tshape),
        warp=None if wrows is None else PackedVolume(wrows, wshape))


def march(inp: MarchInputs) -> torch.Tensor:
    """``MVPMarch`` on ``inp``: the tiles' rgba [T, 4, P], differentiable
    (K8 forward, K10 backward)."""
    return MVPMarch.apply(
        *(getattr(inp, f) for f in _TENSOR_FIELDS), inp.template.rows,
        None if inp.warp is None else inp.warp.rows, inp.template.shape,
        None if inp.warp is None else inp.warp.shape,
        *(getattr(inp, f) for f in _OTHER_FIELDS))


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
