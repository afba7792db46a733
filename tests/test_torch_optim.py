"""Parity of the port's optimizer chain (scrub non-finite -> clip by global
norm -> per-module Adam / AdamW) with the JAX package's optax chain on the
CPU: the same parameters and the same gradients, NaN/Inf entries and a norm
above the clip included, for three steps.

Tolerance: parameters equal to 1e-6 (absolute; the parameters are O(1) and
float32 on both sides, and the two Adam forms round their divisions in
other places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from goliath_tpu import optim as joptim
from goliath_torch import optim as toptim
from goliath_torch.convert import params_from_jax

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ATOL = 1e-6


def _tree(rng):
    """A flax-shaped parameter tree with three top-level modules."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"encoder": {"fc": {"weight": arr(4, 3), "bias": arr(4)}},
            "decoder": {"up0": {"weight": arr(2, 4, 3, 3)}, "albedo": arr(5, 3)},
            "cal": {"cal_params": arr(3, 6)}}


class _Net(nn.Module):
    """Parameters named as the tree's paths."""

    def __init__(self, tree):
        super().__init__()
        for top, sub in tree.items():
            self.add_module(top, self._build(sub))

    @classmethod
    def _build(cls, node):
        m = nn.Module()
        for k, v in node.items():
            if isinstance(v, dict):
                m.add_module(k, cls._build(v))
            else:
                m.register_parameter(k, nn.Parameter(torch.from_numpy(v.copy())))
        return m


def _grads(rng, tree, step):
    """Gradients with a global norm above 1; step 1 carries NaN and Inf."""
    g = jax.tree_util.tree_map(
        lambda p: (3.0 * rng.standard_normal(p.shape)).astype(np.float32), tree)
    if step == 1:
        g["encoder"]["fc"]["weight"][0, 0] = np.nan
        g["decoder"]["albedo"][2, 1] = np.inf
        g["cal"]["cal_params"][1, 3] = -np.inf
    if step == 2:  # a norm below the clip: the gradients pass unscaled
        g = jax.tree_util.tree_map(lambda x: (x * 1e-3).astype(np.float32), g)
    return g


_CASES = {
    "adam_single_group": dict(class_name="goliath_tpu.optim.Adam", lr=1e-2),
    "adam_per_module": dict(
        class_name="torch.optim.Adam", lr=5e-3,
        per_module={"encoder": {"lr": 1e-2}, "decoder": {"lr": 2e-3}}),
    "adamw": dict(class_name="goliath_tpu.optim.AdamW", lr=1e-2,
                  weight_decay=0.1, betas=[0.8, 0.95], eps=1e-6),
    "adam_with_weight_decay": dict(class_name="goliath_tpu.optim.Adam",
                                   lr=1e-2, weight_decay=0.05),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_build_optimizer_matches_optax_chain(case, caplog):
    cfg = _CASES[case]
    rng = np.random.RandomState(0)
    tree = _tree(rng)
    net = _Net(tree)
    assert set(dict(net.named_parameters())) == set(params_from_jax(tree))

    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = joptim.build_optimizer(dict(cfg), jparams)
    jstate = jopt.init(jparams)
    with caplog.at_level("WARNING"):
        topt = toptim.build_optimizer(dict(cfg), net)
    if "per_module" in cfg:  # `cal` has no group: warned about, base lr
        assert "cal" in caplog.text
        assert [g["name"] for g in topt.inner.param_groups] == [
            "encoder", "decoder", "__default__"]
        assert [g["lr"] for g in topt.inner.param_groups] == [1e-2, 2e-3, 5e-3]

    for step in range(3):
        g = _grads(rng, tree, step)
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat_g = params_from_jax(g)
        topt.zero_grad()
        for name, p in net.named_parameters():
            p.grad = flat_g[name].clone()
        topt.step()
        ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        for name, p in net.named_parameters():
            assert torch.isfinite(p).all(), (step, name)
            np.testing.assert_allclose(
                p.detach().numpy(), ref[name].numpy(), rtol=0, atol=ATOL,
                err_msg=f"{case} step {step} {name}")
    # the steps moved the parameters by far more than the tolerance
    moved = max(float((p.detach() - params_from_jax(tree)[n]).abs().max())
                for n, p in net.named_parameters())
    assert moved > 1e-2
