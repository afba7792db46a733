"""The rest of tests/test_torch_mvp_bwd.py's holds (its fifth case), in a
file of their own: a port test file that runs long holds at most four
tests, so that pytest-xdist's --dist loadfile queues it after
tests/test_tile_shard.py. And the march's route under autograd: on the
card's route (``target_backend`` made to say cuda, the kernels' loader made
to raise) a march whose prims or template need a gradient reaches the
loader through ``MVPMarch`` (K8 forward, K10 backward) and never the plain
groups or ``torch.utils.checkpoint``; K10 computes no gradient of the rays,
so there a ray input that needs one raises ValueError, while on the CPU the
rays take their gradient through the plain groups, held against
``jax.grad`` at tests/test_torch_mvp_grad.py's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.ops import gsplat_cuda as gc
from goliath_torch.ops import mvp as tm
from goliath_torch.ops import mvp_cuda as mc
from goliath_tpu.ops import mvp as jm

from tests.test_torch_mvp import T
from tests.test_torch_mvp_bwd import hold
from tests.test_torch_mvp_grad import CASES, GRAD_OF_SCALE, GRAD_RTOL, _inputs

torch.set_num_threads(1)

RAYS = ("raypos", "raydir", "tminmax")


@pytest.mark.parametrize("case", sorted(CASES)[4:5])
def test_plain_k10_matches_jax_grad(case):
    hold(case)


def _refuse(*a, **kw):
    raise AssertionError("the kernels' extension was loaded")


def _no_plain(*a, **kw):
    raise AssertionError("the plain groups or checkpoint ran")


def _card_route(monkeypatch):
    monkeypatch.setattr(gc, "load_kernels", _refuse)
    for mod in (tm, mc):
        monkeypatch.setattr(mod, "target_backend", lambda t: "cuda")
        monkeypatch.setattr(mod, "march_tiles_plain", _no_plain)
    monkeypatch.setattr(tm, "checkpoint", _no_plain)


def _args(needs=()):
    """The exact case's march arguments, those named in ``needs`` (of RAYS
    and primpos, primrot, primscale, template) needing a gradient."""
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, _ = _inputs("exact")
    named = dict(zip(RAYS, (T(rp), T(rd), T(tminmax))))
    named.update((k, T(diff[k])) for k in ("primpos", "primrot", "primscale",
                                           "template"))
    for k in needs:
        named[k].requires_grad_()
    return ([named["raypos"], named["raydir"], stepsize, named["tminmax"],
             named["primpos"], named["primrot"], named["primscale"],
             named["template"], T(K_cam), T(Rt)], kw)


def test_card_route_marches_through_k8_and_k10(monkeypatch):
    """Under autograd, with any of the prims' parameters or the template
    needing a gradient, the card's march reaches the loader (K8's forward
    in MVPMarch); K10's wrapper reaches it too; neither runs the plain
    groups or checkpoint, and no launch is counted."""
    _card_route(monkeypatch)
    before = dict(gc.LAUNCHES)
    for need in ("primpos", "primrot", "primscale", "template"):
        args, kw = _args([need])
        with pytest.raises(AssertionError, match="extension was loaded"):
            tm.mvp_raymarch_tiled(*args, **kw)
    args, kw = _args()
    inp, _, _ = tm.march_inputs(*args, **kw)
    T_, P = inp.raypos.shape[:2]
    with pytest.raises(AssertionError, match="extension was loaded"):
        mc.mvp_march_backward(inp, torch.ones(T_, 4, P))
    assert gc.LAUNCHES == before


def test_card_route_refuses_ray_gradients(monkeypatch):
    """On the card's route a raypos, raydir or tminmax that needs a
    gradient raises ValueError naming the rays, alone or beside a prim
    input that needs one, before any kernel is loaded."""
    _card_route(monkeypatch)
    for ray in RAYS:
        for prims in ([], ["primpos"]):
            args, kw = _args([ray] + prims)
            with pytest.raises(ValueError, match="raypos, raydir, tminmax"):
                tm.mvp_raymarch_tiled(*args, **kw)
            with torch.no_grad(), pytest.raises(
                    AssertionError, match="extension was loaded"):
                tm.mvp_raymarch_tiled(*args, **kw)   # without gradient: K8


def test_cpu_route_gives_ray_gradients():
    """On the CPU the rays take their gradient through the plain groups:
    raypos, raydir and tminmax held against ``jax.grad`` of the jitted JAX
    march, alone and beside the template's."""
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, up = _inputs("exact")

    def f(rp_, rd_, tm_, tpl):
        out = jm.mvp_raymarch_tiled(
            rp_, rd_, stepsize, tm_, jnp.asarray(diff["primpos"]),
            jnp.asarray(diff["primrot"]), jnp.asarray(diff["primscale"]),
            tpl, jnp.asarray(K_cam), jnp.asarray(Rt), **kw)
        return jnp.sum(out * up)

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(a) for a in (rp, rd, tminmax, diff["template"])))
    for needs in (RAYS, RAYS + ("template",)):
        args, kw = _args(needs)
        out = tm.mvp_raymarch_tiled(*args, **kw)
        (out * T(up)).sum().backward()
        for name, leaf, r in zip(RAYS + ("template",),
                                 (args[0], args[1], args[3], args[7]), ref):
            if name not in needs:
                assert leaf.grad is None
                continue
            r = np.asarray(r)
            scale = float(np.abs(r).max())
            assert scale > 0 and np.isfinite(r).all(), name
            np.testing.assert_allclose(leaf.grad.numpy(), r, rtol=GRAD_RTOL,
                                       atol=GRAD_OF_SCALE * scale,
                                       err_msg=name)
