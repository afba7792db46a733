"""The replicas of the port's data-parallel step (goliath_torch.parallel
.sharding: ``replicate_model``, ``reduce_gradients``, the row of a 2-D
mesh that a replica's bands take) on the CPU, for the five families of the
dry run at its shapes (goliath_torch/scripts/dryrun_multichip.py).

A shard on another device than the model's runs on a replica of the model
built there. Here the replicas are built on the CPU beside a model on the
CPU: the same code that copies a model to another card, with every
comparison bit for bit where the arithmetic is the same. The step itself
over distinct devices (the card and the host) is held in
tests/test_torch_cuda.py.

Tolerances: a replica's tensors and its forward equal the model's bit for
bit; the gradients of the model and a replica over two halves of a batch,
added, against one backward over the whole batch (the same sums in
another order): rtol 1e-5 plus 1e-5 of each gradient's largest entry on
the MVP hand, whose loss goes through no splat or rasterizer gradient, and
the port's rule (rtol 1e-3 plus 1e-3 of the largest entry) on RGCA.
"""

import numpy as np
import pytest
import torch

from goliath_torch.parallel import make_sharded_train_step
from goliath_torch.parallel import sharding as sh
from goliath_torch.scripts import dryrun_multichip as dr

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_replica_holds_the_model_on_its_device():
    """For each family: the replica is another facade over another module,
    every tensor it reaches (parameters, buffers, the geometry's,
    skinning's and renderers' tables) is another tensor on its device
    equal to the model's, a tensor moved off it is named by the check, and
    its forward gives the model's outputs bit for bit."""
    for name in dr.FAMILIES:
        _ds, model, batch = dr.build_family(name, 2, CPU)
        replica = sh.replicate_model(model, "cpu")
        assert replica is not model and replica.module is not model.module
        assert replica.device == CPU
        ours = sh.reachable_tensors(model)
        theirs = sh.reachable_tensors(replica)
        assert list(theirs) == list(ours), name
        assert any(".geo_fn." in k for k in ours), name
        for k, t in ours.items():
            assert theirs[k] is not t, k
            assert theirs[k].device == CPU, k
            assert torch.equal(theirs[k], t), k
        assert sh.replica_mismatches(state(model), replica) == []
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        with torch.no_grad():
            want = model.apply(tb, train=False)
            got = replica.apply(tb, train=False)
        assert set(got) == set(want), name
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), f"{name}: {k}"
        replica.geo_fn.vi = replica.geo_fn.vi.to("meta")
        with pytest.raises(ValueError, match=r"replica\.geo_fn\.vi on meta"):
            sh.check_replica(replica, "cpu")


def state(model):
    """The model's parameters and buffers by name."""
    return {**dict(model.module.named_parameters()),
            **dict(model.module.named_buffers())}


def halves_against_whole(name):
    """(gradients of the model on the first half of a batch of 2 and of a
    replica on the second, reduced into the model's; gradients of one
    backward of the model over the whole batch). The training draws are
    made once for the whole batch, as the sharded step makes them."""
    ds, model, batch = dr.build_family(name, 2, CPU)
    loss_fn, optimizer = dr.family_loss_and_optimizer(name, ds, model)
    replica = sh.replicate_model(model, CPU)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    draws = getattr(model.module, "training_draws", None)
    if draws is not None:
        tb.update(draws(2, CPU, tb))
    halves = sh.shard_batch(tb, sh.Mesh([CPU, CPU], ("data",)))
    optimizer.zero_grad()
    preds = sh.gather_preds([model.apply(halves[0], train=True),
                             replica.apply(halves[1], train=True)],
                            1, name, CPU)
    loss_fn(preds, tb, 0)[0].backward()
    assert all(p.grad is not None for p in replica.module.parameters()
               if p.requires_grad)
    sh.reduce_gradients(model, [replica])
    # a forward moves no buffer: the replica's equal the model's still
    assert sh.replica_mismatches(dict(model.module.named_buffers()),
                                 replica) == []
    got = {n: p.grad.clone() for n, p in model.module.named_parameters()
           if p.grad is not None}
    optimizer.zero_grad()
    loss_fn(model.apply(tb, train=True), tb, 0)[0].backward()
    ref = {n: p.grad.clone() for n, p in model.module.named_parameters()
           if p.grad is not None}
    return got, ref


@pytest.mark.parametrize("name,rtol", [("hand_mvp", 1e-5), ("rgca", 1e-3)])
def test_replica_gradients_add_up_to_the_whole_batch(name, rtol):
    got, ref = halves_against_whole(name)
    assert set(got) == set(ref) and ref
    nonzero = 0
    for n, r in ref.items():
        scale = float(r.abs().max())
        nonzero += scale > 0
        np.testing.assert_allclose(got[n].numpy(), r.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=n)
    assert nonzero > len(ref) // 2


def test_mesh_rows_and_refused_devices():
    """A data shard's bands take its own row of a ("data", "tile") mesh
    over distinct devices, the row that starts at its device; a mesh that
    names a card that is not there, or a device kind the port does not run
    on, is refused when the step is made, by name."""
    mesh = sh.Mesh([["cuda:0", "cpu"], ["cpu", "cuda:0"]], ("data", "tile"))
    assert mesh.axis_devices("data") == [torch.device("cuda:0"), CPU]
    for dev, row in (("cuda:0", ["cuda:0", "cpu"]),
                     ("cpu", ["cpu", "cuda:0"])):
        assert mesh.axis_devices("tile", through=dev) == [
            torch.device(d) for d in row]
    _ds, model, _batch = dr.build_family("rgca", 2, CPU)
    loss_fn, optimizer = dr.family_loss_and_optimizer("rgca", _ds, model)
    absent = f"cuda:{torch.cuda.device_count()}"
    for dev in (absent, "meta"):
        with pytest.raises(ValueError, match=f"cannot replicate the model "
                           f"to {dev}"):
            make_sharded_train_step(model, loss_fn, optimizer,
                                    sh.Mesh(["cpu", dev], ("data",)))
