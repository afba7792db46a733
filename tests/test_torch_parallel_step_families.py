"""The port's data-parallel step (goliath_torch.parallel.sharding
``make_sharded_train_step``) against its unsharded step
(``goliath_torch.train.make_train_step``) on the CPU for the other four
families of the dry run (goliath_torch/scripts/dryrun_multichip.py, the
JAX entry's tiny shapes and loss terms): batch 4 on 4 shards, one step
from the same parameters and the same generator state.

The JAX package's sharded step is one global program, equal to its
single-device step by construction; the port's runs each shard's forward
apart and sums the gradients, so it is held to its own unsharded step:
the loss at rtol 1e-5 and every loss term at rtol 1e-5 + 1e-7, each
gradient at the port's rule (rtol 1e-3 + 1e-3 of its largest entry: the
shards' sums are taken by autograd, the batch's inside each kernel) or,
for at most MAX_SPREAD_PARAMS parameters, within SPREAD_MULT times its
spread beyond it (its largest move when every parameter is scaled by
1 + 1e-7 N(0, 1), about one ulp, over SPREAD_SEEDS; URHand's gradients
move by percents under such moves, ROADMAP), and the parameters that
move.
"""

import copy

import numpy as np
import pytest
import torch

from goliath_torch import train as t_train
from goliath_torch.parallel import make_sharded_train_step
from goliath_torch.parallel.sharding import Mesh
from goliath_torch.scripts import dryrun_multichip as dr

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPREAD_MULT = 4.0
SPREAD_SEEDS = (1, 2, 3)
MAX_SPREAD_PARAMS = 5


def _one_step(name, model, ds, state0, gen0, batch, mesh):
    model.module.load_state_dict(state0)
    gen = getattr(model.module, "generator", None)
    if gen is not None:
        gen.set_state(gen0)
    loss_fn, optimizer = dr.family_loss_and_optimizer(name, ds, model)
    step = (make_sharded_train_step(model, loss_fn, optimizer, mesh)
            if mesh is not None
            else t_train.make_train_step(model, loss_fn, optimizer))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    total, ldict = step(tb, 0)
    grads = {n: p.grad.clone() for n, p in model.module.named_parameters()}
    params = {n: p.detach().clone()
              for n, p in model.module.named_parameters()}
    return total, ldict, grads, params


@pytest.mark.parametrize("name", ["hand_mvp", "hand_teacher", "urhand",
                                  "mesh_vae"])
def test_sharded_step_matches_unsharded(name):
    ds, model, batch = dr.build_family(name, 4, CPU)
    state0 = copy.deepcopy(model.module.state_dict())
    gen = getattr(model.module, "generator", None)
    gen0 = gen.get_state() if gen is not None else None
    ref = _one_step(name, model, ds, state0, gen0, batch, None)
    got = _one_step(name, model, ds, state0, gen0, batch,
                    Mesh(["cpu"] * 4, ("data",)))
    assert np.isfinite(ref[0].item())
    np.testing.assert_allclose(got[0].item(), ref[0].item(), rtol=1e-5)
    assert set(got[1]) == set(ref[1])
    for k, v in ref[1].items():
        np.testing.assert_allclose(got[1][k].item(), v.item(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    def spread():
        moves = {n: 0.0 for n in ref[2]}
        for seed in SPREAD_SEEDS:
            gen = torch.Generator().manual_seed(seed)
            moved = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                     if v.is_floating_point() else v
                     for k, v in state0.items()}
            grads = _one_step(name, model, ds, moved, gen0, batch, None)[2]
            for n, g in grads.items():
                moves[n] = max(moves[n], float((g - ref[2][n]).abs().max()))
        return moves

    nonzero, need, moves = 0, [], {}
    for n, r in ref[2].items():
        scale = float(r.abs().max())
        nonzero += scale > 0
        usual = 1e-3 * r.abs() + 1e-3 * scale
        diff = (got[2][n] - r).abs()
        if not bool((diff <= usual).all()):
            moves = moves or spread()
            need.append(n)
            np.testing.assert_array_less(
                diff.numpy(), (usual + SPREAD_MULT * moves[n]).numpy(),
                err_msg=n)
        assert torch.equal(got[3][n], state0[n]) == torch.equal(
            ref[3][n], state0[n]), n
    assert len(need) <= MAX_SPREAD_PARAMS, need
    assert nonzero > len(ref[2]) // 2
