"""Parity of the rest of the JAX package's layer library with the port on
the CPU: the tied-bias transposed conv, the upsampling conv, the list
factories and ``Sequential``, the blur ``Downsample``, the equalized-lr
linear and conv (nn/layers.py). The cheaper cases (``LAYER_CASES`` less
``CONV_CASES``) run in tests/test_torch_library_elr.py, ``ConcatPyramid``
and the inits in tests/test_torch_library_pyramid.py; both import the
helpers here.

Weights go from the port to the JAX package: the port's seeded
initialization is written into the flax tree by name, with the names and
shapes read from ``jax.eval_shape`` of the JAX module's ``init``, and
``params_from_jax`` of that tree loads back into the port's module with
``strict=True`` (no rename table). Both packages then run the same numpy
inputs; forward outputs and the gradients of a seeded projection of them
(``jax.grad`` against autograd; every parameter and every input) are held
at atol ``TOL`` x the largest entry of the reference, rtol ``TOL``: float32
convolutions and interpolation-matrix products summed in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.nn import layers as tl
from goliath_tpu.nn import layers as jl
from tests.test_torch_quality import flax_tree

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

TOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def carry(jmod, tmod, *xs):
    """The port module's parameters as the flax variables of ``jmod`` (the
    names and shapes of ``jax.eval_shape`` of its init must be the port's
    ``state_dict``'s); loads them back through ``params_from_jax``."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(x) for x in xs])
    want = {k: tuple(v.shape) for k, v in _flat(
        dict(shapes.get("params", {}))).items()}
    state = tmod.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    tree = {"params": flax_tree(state)} if state else {}
    tmod.load_state_dict(params_from_jax(tree) if state else {}, strict=True)
    return tree


def _leaves(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    return [out]


def close(got, ref, tol=TOL, what="", outliers=0.0):
    """got within rtol ``tol`` and atol ``tol`` x the largest |ref|; a share
    ``outliers`` of the entries may lie beyond that, each within half the
    largest |ref|."""
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    if outliers:
        bad = np.abs(got - ref) > tol * scale + tol * np.abs(ref)
        assert bad.mean() <= outliers, (what, int(bad.sum()))
        np.testing.assert_allclose(got, ref, atol=0.5 * scale, err_msg=what)
        got = np.where(bad, ref, got)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                               err_msg=what)


def hold(jmod, tmod, xs, tol=TOL, grad_inputs=None, jargs=(), targs=(),
         grad_tol=None, grad_outliers=0.0):
    """Forward outputs and gradients of ``jmod`` (flax) against ``tmod``
    (the port) on the numpy inputs ``xs`` (float inputs take a gradient
    unless ``grad_inputs`` lists which do); ``jargs`` / ``targs`` are
    extra inputs (integers) that follow them in each package's own type.
    ``grad_tol`` (``tol`` unless given) holds the gradients, with a share
    ``grad_outliers`` of each gradient's entries beyond it (``close``).
    Returns the port's outputs."""
    grad_tol = tol if grad_tol is None else grad_tol
    if grad_inputs is None:
        grad_inputs = [i for i, x in enumerate(xs) if x.dtype.kind == "f"]
    variables = carry(jmod, tmod, *xs, *jargs)
    jx = [jnp.asarray(x) for x in xs]
    ref = jax.jit(jmod.apply)(variables, *jx, *jargs)
    rng = np.random.RandomState(11)
    cots = [rng.standard_normal(np.shape(r)).astype(np.float32)
            for r in _leaves(ref)]

    def loss(v, *x):
        out = _leaves(jmod.apply(v, *x, *jargs))
        return sum(jnp.vdot(o, jnp.asarray(c)) for o, c in zip(out, cots))

    argnums = (0, *(1 + i for i in grad_inputs))
    jgrads = jax.jit(jax.grad(loss, argnums=argnums))(variables, *jx)
    tx = [torch.from_numpy(x.copy()) for x in xs]
    for i in grad_inputs:
        tx[i].requires_grad_(True)
    got = tmod(*tx, *targs)
    for g, r in zip(_leaves(got), _leaves(ref)):
        close(g, r, tol, "forward")
    sum((g * torch.from_numpy(c)).sum()
        for g, c in zip(_leaves(got), cots)).backward()
    params = _flat(dict(jgrads[0].get("params", {})))
    for name, p in tmod.named_parameters():
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        close(grad, params[name], grad_tol, f"gradient of {name}",
              grad_outliers)
    for i, jg in zip(grad_inputs, jgrads[1:]):
        close(tx[i].grad, jg, grad_tol, f"gradient of input {i}",
              grad_outliers)
    return got


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _gen():
    return torch.Generator().manual_seed(0)


LAYER_CASES = {
    "conv_transpose_wn": (
        lambda: jl.ConvTranspose2dWN(3, 5, 4, 2, 1),
        lambda: tl.ConvTranspose2dWN(3, 5, 4, 2, 1, generator=_gen()),
        [(2, 3, 8, 8)]),
    "conv_transpose_wn_no_bias": (
        lambda: jl.ConvTranspose2dWN(3, 4, 4, 2, 1, use_bias=False),
        lambda: tl.ConvTranspose2dWN(3, 4, 4, 2, 1, use_bias=False,
                                     generator=_gen()),
        [(1, 3, 6, 6)]),
    "up_conv_wn": (
        lambda: jl.UpConv2dWN(3, 4, 3, 1, 1),
        lambda: tl.UpConv2dWN(3, 4, 3, 1, 1, generator=_gen()),
        [(2, 3, 6, 7)]),
    "sequential": (
        lambda: jl.Sequential([
            *jl.make_conv(3, 4, 3, 1, 1, act=jl.LeakyReLU(0.2)),
            *jl.make_conv_trans(4, 4, 4, 2, 1, ub=(16, 16),
                                act=jl.LeakyReLU(0.1)),
            *jl.make_conv(4, 2, 3, 2, 1, ub=(8, 8), bias=False)]),
        lambda: tl.Sequential([
            *tl.make_conv(3, 4, 3, 1, 1, act=tl.LeakyReLU(0.2),
                          generator=_gen()),
            *tl.make_conv_trans(4, 4, 4, 2, 1, ub=(16, 16),
                                act=tl.LeakyReLU(0.1), generator=_gen()),
            *tl.make_conv(4, 2, 3, 2, 1, ub=(8, 8), bias=False,
                          generator=_gen())]),
        [(2, 3, 8, 8)]),
    "linear_sequential": (
        lambda: jl.Sequential([*jl.make_linear(6, 5, act=jl.LeakyReLU()),
                               *jl.make_linear(5, 3, bias=False)]),
        lambda: tl.Sequential([
            *tl.make_linear(6, 5, act=tl.LeakyReLU(), generator=_gen()),
            *tl.make_linear(5, 3, bias=False, generator=_gen())]),
        [(4, 6)]),
    "downsample": (lambda: jl.Downsample(), lambda: tl.Downsample(),
                   [(2, 3, 9, 10)]),
    "downsample_k3": (lambda: jl.Downsample(3), lambda: tl.Downsample(3),
                      [(1, 2, 8, 8)]),
    "linear_elr": (
        lambda: jl.LinearELR(6, 4, lr_mul=0.5),
        lambda: tl.LinearELR(6, 4, lr_mul=0.5, generator=_gen()),
        [(3, 6)]),
    "linear_elr_gain": (
        lambda: jl.LinearELR(5, 3, use_bias=False, gain=1.0),
        lambda: tl.LinearELR(5, 3, use_bias=False, gain=1.0,
                             generator=_gen()),
        [(2, 5)]),
    "conv_elr": (
        lambda: jl.Conv2dELR(3, 4, 3, 2, 1, lr_mul=2.0),
        lambda: tl.Conv2dELR(3, 4, 3, 2, 1, lr_mul=2.0, generator=_gen()),
        [(2, 3, 8, 8)]),
}


# the cases of this file; the others are in tests/test_torch_library_elr.py
CONV_CASES = ("conv_transpose_wn", "conv_transpose_wn_no_bias", "up_conv_wn",
              "sequential")


@pytest.mark.parametrize("name", CONV_CASES)
def test_layer_matches_jax(name):
    hold_layer(name)


def hold_layer(name):
    make_j, make_t, shapes = LAYER_CASES[name]
    xs = [_x(s, i) for i, s in enumerate(shapes)]
    tmod = make_t()
    # the ELR layers' bias is 0 at init: move it so that lr_mul shows
    with torch.no_grad():
        for pname, p in tmod.named_parameters():
            if pname.endswith("bias"):
                p.copy_(torch.from_numpy(_x(tuple(p.shape), 5)))
    hold(make_j(), tmod, xs)
