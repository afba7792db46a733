"""Parity of the port's data-parallel step (goliath_torch.parallel.sharding)
with the JAX package on the CPU: ``shard_batch``'s rules, and one RGCA
step of ``make_sharded_train_step`` on a 2-shard mesh against the JAX
package's at ``__graft_entry__._build(img=48, uv=32, n_cams=2, batch=2)``
with the dry run's loss terms and optimizer.

The two packages draw different random numbers, so the JAX run's draws
(the encoder noise and the backlit direction under its ``noise`` key) are
captured from a jitted JAX forward with the same key and fed to the port
in the batch (``noise``, ``light_dir``), which the port's step splits
with the batch.

Tolerances: the loss at rtol 1e-4 and the updated parameters' norms at
rtol 1e-3, as tests/test_parallel.py holds the JAX sharded step against
the JAX single-device step (Adam's first update is lr times the sign of
each gradient entry, so reduction-order noise flips the entries whose
gradient is ~0; an element-wise comparison of the parameters says
nothing). The sharded step's gradients are held against the port's
unsharded step's at the port's rule, rtol 1e-3 + 1e-3 of each parameter's
largest entry (the shards' gradients are summed by autograd, the
unsharded step's inside each batched kernel: other float32 orders).
"""

import copy
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch import train as t_train
from goliath_torch.convert import params_from_jax
from goliath_torch.parallel import make_sharded_train_step, shard_batch
from goliath_torch.parallel.sharding import Mesh, replicate
from goliath_torch.scripts import dryrun_multichip as port_dryrun
from goliath_tpu.losses import ModularLoss as JModularLoss
from goliath_tpu.optim import build_optimizer as j_build_optimizer
from goliath_tpu.parallel import (
    make_mesh as j_make_mesh,
    make_sharded_train_step as j_make_sharded_train_step,
    shard_batch as j_shard_batch,
)
from goliath_tpu.parallel.sharding import replicate as j_replicate

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__ as graft  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_shard_batch_follows_the_jax_rules():
    """On a 4-shard mesh: list and str fields dropped, a leading dim of 8
    split in 4 contiguous pieces, a leading dim of 6 and a scalar
    replicated; the port's shards are the JAX array's shards."""
    rs = np.random.RandomState(0)
    batch = {"split": rs.rand(8, 3).astype(np.float32),
             "ints": np.arange(8, dtype=np.int32),
             "odd": rs.rand(6, 2).astype(np.float32),
             "scalar": np.float32(2.5),
             "names": ["a"] * 8, "tag": "x"}
    jmesh = j_make_mesh(4)
    sb = j_shard_batch(batch, jmesh)
    shards = shard_batch(batch, Mesh(["cpu"] * 4, ("data",)))
    assert len(shards) == 4
    assert set(sb) == set(shards[0]) == {"split", "ints", "odd", "scalar"}
    for k, arr in sb.items():
        jax_split = arr.sharding.spec == jax.sharding.PartitionSpec("data")
        assert jax_split == (k in ("split", "ints")), k
        pieces = sorted(arr.addressable_shards, key=lambda s: s.index)
        for i, s in enumerate(shards):
            assert s[k].device == CPU
            want = np.asarray(pieces[i].data) if jax_split else batch[k]
            np.testing.assert_array_equal(s[k].numpy(), want, err_msg=k)
    # replicate: one copy a device, tensors in nested containers
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
    copies = replicate(tree, Mesh(["cpu"] * 2, ("data",)))
    assert len(copies) == 2 and copies[1]["b"][1] == 3


@functools.lru_cache(maxsize=None)
def jax_rgca_step():
    """The JAX dry run's RGCA step on a 2-device mesh (donate off), and its
    draws: the parameters before and after, the loss, the batch."""
    ds, model, jb = graft._build(img=48, uv=32, n_cams=2, batch=2)
    rng = jax.random.PRNGKey(1)
    loss_fn = JModularLoss(
        {"rgb_l1": {"src_key": "rgb", "tgt_key": "image",
                    "mask_key": "image_weight", "weight": 10.0},
         "geom_l2": 0.4, "kl": 0.002, "learn_blur": 0.001},
        assets=ds.static_assets)
    params = model.init(jax.random.PRNGKey(0), jb)
    optimizer = j_build_optimizer(
        {"class_name": "torch.optim.Adam", "lr": 1e-3,
         "per_module": {"encoder": {"lr": 1e-3}, "decoder": {"lr": 1e-3}}},
        params)
    opt_state = optimizer.init(params)

    # the forward's draws: the encoder noise as drawn; the backlit
    # direction (drawn inside the rematerialized decoder, out of reach) is
    # recovered from cos_weight = spec_nml @ light_dir, as
    # tests/test_torch_rgca_train.py recovers it
    def drawn(p):
        seen = []
        normal = jax.random.normal

        def wrapped(*a, **kw):
            seen.append(normal(*a, **kw))
            return seen[-1]

        jax.random.normal = wrapped
        try:
            preds = model.apply(p, jb, train=True, rngs={"noise": rng})
        finally:
            jax.random.normal = normal
        return seen, preds["spec_nml"], preds["cos_weight"]

    (noise,), spec_nml, cos_weight = jax.device_get(jax.jit(drawn)(params))
    light_dir = np.stack([
        np.linalg.lstsq(spec_nml[b].astype(np.float64),
                        cos_weight[b, :, 0].astype(np.float64),
                        rcond=None)[0]
        for b in range(2)])[:, None].astype(np.float32)

    mesh = j_make_mesh(2)
    step = j_make_sharded_train_step(model, loss_fn, optimizer, mesh,
                                     donate=False)
    new_params, _, total, ldict = step(
        j_replicate(params, mesh), j_replicate(opt_state, mesh),
        j_shard_batch(jb, mesh), j_replicate(rng, mesh),
        j_replicate(jnp.asarray(0), mesh))
    return dict(params=jax.device_get(params),
                new_params=jax.device_get(new_params), total=float(total),
                ldict={k: float(v) for k, v in ldict.items()},
                noise=np.asarray(noise), light_dir=light_dir)


def _rgca_port(ref):
    ds, model, batch = port_dryrun.build_rgca(48, 32, 2, 2, CPU)
    model.module.load_state_dict(params_from_jax(ref["params"]), strict=True)
    loss_fn, optimizer = port_dryrun.family_loss_and_optimizer(
        "rgca", ds, model)
    batch = dict(batch, noise=np.array(ref["noise"]),
                 light_dir=ref["light_dir"])
    return ds, model, loss_fn, optimizer, batch


def test_rgca_sharded_step_matches_jax():
    """One sharded RGCA step on 2 CPU shards against the JAX sharded step:
    the same batch (the JAX fixture's, bit for bit) and draws, every loss
    term, the updated parameters' norms; and its gradients against the
    port's unsharded step from the same state."""
    ref = jax_rgca_step()
    ds, model, loss_fn, optimizer, batch = _rgca_port(ref)
    state0 = copy.deepcopy(model.module.state_dict())
    jds = graft._build(img=48, uv=32, n_cams=2, batch=2)[2]
    for k, v in jds.items():
        np.testing.assert_array_equal(batch[k], np.asarray(v), err_msg=k)

    step = make_sharded_train_step(model, loss_fn, optimizer,
                                   Mesh(["cpu"] * 2, ("data",)))
    total, ldict = step(batch, 0)
    np.testing.assert_allclose(total.item(), ref["total"], rtol=1e-4)
    assert set(ldict) == set(ref["ldict"])
    for k, v in ref["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), v, rtol=1e-4,
                                   atol=1e-8, err_msg=k)
    got = model.module.state_dict()
    want = params_from_jax(ref["new_params"])
    before = params_from_jax(ref["params"])
    for name, w in want.items():
        n_got = float(got[name].double().norm())
        n_want = float(w.double().norm())
        np.testing.assert_allclose(n_got, n_want, rtol=1e-3, err_msg=name)
        # a parameter moves in both packages or in neither (the calibration
        # of a batch that holds only the identity camera takes no gradient)
        assert torch.equal(got[name], state0[name]) == torch.equal(
            w, before[name]), name
    grads = {n: p.grad.clone() for n, p in model.module.named_parameters()}

    # the port's unsharded step from the same state and draws
    model.module.load_state_dict(state0)
    loss_fn, optimizer = port_dryrun.family_loss_and_optimizer(
        "rgca", ds, model)
    total1, _ = t_train.make_train_step(model, loss_fn, optimizer)(
        {k: torch.as_tensor(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(total.item(), total1.item(), rtol=1e-6)
    for name, p in model.module.named_parameters():
        scale = float(p.grad.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), p.grad.numpy(),
                                   rtol=1e-3, atol=1e-3 * scale + 1e-30,
                                   err_msg=name)
