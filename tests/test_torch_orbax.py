"""The port's reader of the JAX package's orbax checkpoints
(``goliath_torch.convert.read_orbax``, ``train_state_from_orbax``) and the
checkpoint dispatch of ``load_checkpoint`` / ``load_params`` /
``train.restore_train_state``, on the CPU.

The JAX package's ``save_checkpoint`` writes the train state of the RGCA
model of a small cut of ``configs/rgca_synthetic_quality.yml``: the port's
initialization put into the flax tree by name, and the optax state after
two updates with seeded gradients, built with the config's ``per_module``
groups and without them. What the port reads must be bit-equal to what
``params_from_jax`` and ``opt_state_from_jax`` make of the same trees in
memory (no arithmetic happens on the way).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch import train as t_train
from goliath_torch.config import load_config as t_load_config
from goliath_torch.convert import (
    load_checkpoint,
    opt_state_from_jax,
    params_from_jax,
    read_orbax,
    train_state_from_orbax,
)
from goliath_torch.optim import build_optimizer
from goliath_tpu import optim as j_optim
from goliath_tpu import train as j_train
from tests.test_torch_quality import (
    QUALITY_CFG,
    SMALL,
    flax_tree,
    merged_moments,
    port_model,
)

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

ITERATION = 7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_model():
    cfg = t_load_config(QUALITY_CFG, overrides=SMALL)
    return cfg, port_model(cfg)


def _opt_cfg(cfg, per_module):
    opt = dict(cfg.optimizer)
    opt.setdefault("lr", cfg.lr)
    if not per_module:
        opt.pop("per_module")
    return opt


@pytest.fixture(scope="module", params=["per_module", "single_group"])
def written(request, tmp_path_factory):
    """The JAX package's checkpoint directory of the port's initialization
    and an optax state after two updates."""
    per_module = request.param == "per_module"
    cfg, model = _port_model()
    params = {"params": flax_tree(model.module.state_dict())}
    opt = j_optim.build_optimizer(_opt_cfg(cfg, per_module), params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = jax.jit(opt.init)(jparams)
    update = jax.jit(opt.update)
    rng = np.random.RandomState(3)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
            jparams)
        _, state = update(grads, state, jparams)
    ckpt_dir = str(tmp_path_factory.mktemp(request.param))
    j_train.save_checkpoint(ckpt_dir, {"model": jax.device_get(jparams),
                                       "optimizer": jax.device_get(state)},
                            iteration=ITERATION)
    return dict(per_module=per_module, cfg=cfg, params=params, state=state,
                ckpt_dir=ckpt_dir)


def test_orbax_train_state_is_bit_equal(written):
    """read_orbax's tree, train_state_from_orbax's parameters and moments,
    and the optimizer restore_train_state fills, against params_from_jax
    and opt_state_from_jax on the trees in memory."""
    path = os.path.join(written["ckpt_dir"], f"{ITERATION:06d}")
    tree = read_orbax(path)
    assert set(tree) == {"model", "optimizer", "iteration"}
    assert isinstance(tree["iteration"], np.integer)
    ref_params = params_from_jax(written["params"])
    got_params = params_from_jax(tree["model"])
    assert set(got_params) == set(ref_params)
    for k, v in ref_params.items():
        assert torch.equal(got_params[k], v), k

    restored = train_state_from_orbax(tree)
    assert restored["iteration"] == ITERATION
    assert restored["adam"]["count"] == 2
    mu, nu, count = merged_moments(written["state"])
    assert count == 2
    for got, ref in ((restored["adam"]["mu"], mu),
                     (restored["adam"]["nu"], nu)):
        got, ref = params_from_jax(got), params_from_jax(ref)
        assert set(got) == set(ref) == set(ref_params)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k

    cfg = written["cfg"]
    _, model = _port_model()
    optimizer = build_optimizer(_opt_cfg(cfg, written["per_module"]),
                                model.module)
    it = t_train.restore_train_state(
        model, optimizer, load_checkpoint(written["ckpt_dir"]))
    assert it == ITERATION
    _, ref_model = _port_model()
    ref_opt = build_optimizer(_opt_cfg(cfg, written["per_module"]),
                              ref_model.module)
    opt_state_from_jax(ref_opt, ref_model.module, mu, nu, count)
    ref_named = dict(ref_model.module.named_parameters())
    for name, p in model.module.named_parameters():
        assert torch.equal(p.detach(), ref_params[name]), name
        got_s = optimizer.inner.state[p]
        ref_s = ref_opt.inner.state[ref_named[name]]
        assert set(got_s) == set(ref_s) == {"step", "exp_avg", "exp_avg_sq"}
        for k in got_s:
            assert torch.equal(got_s[k], ref_s[k]), (name, k)


def test_reader_leaves_jax_out(written):
    """A fresh interpreter reads the checkpoint directory without
    importing JAX."""
    code = ("import sys; from goliath_torch.convert import load_checkpoint; "
            f"s = load_checkpoint({written['ckpt_dir']!r}); "
            "print(s['iteration'], s['adam']['count'], len(s['model']), "
            "'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    n = len(params_from_jax(written["params"]))
    assert out.stdout.split() == [str(ITERATION), "2", str(n), "False"]
