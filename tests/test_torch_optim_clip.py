"""Part of tests/test_torch_optim.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from goliath_torch import optim as toptim
from goliath_torch.convert import opt_state_from_jax, params_from_jax
from goliath_tpu import optim as joptim

from tests.test_torch_optim import ATOL, _CASES, _Net, _grads, _tree

torch.set_num_threads(1)


def test_clip_uses_the_optax_form():
    """Exactly ``g / norm * clip`` above the clip and ``g`` below it, with
    no epsilon on the norm."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([[12.0]])]   # norm 13
    norm = toptim.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 13.0
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]) / 13.0 * 1.0)
    small = [torch.tensor([0.3, 0.4])]
    toptim.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.tensor([0.3, 0.4]))
    bad = [torch.tensor([float("nan"), 1.0, float("inf"), -float("inf")])]
    toptim.scrub_nonfinite_(bad)
    assert torch.equal(bad[0], torch.tensor([0.0, 1.0, 0.0, 0.0]))


def test_opt_state_from_jax_gives_the_same_second_step():
    """An optax state after one step, carried into the port's optimizer with
    ``opt_state_from_jax`` (per-module groups merged into one tree), makes
    both take the same second step."""
    cfg = _CASES["adam_per_module"]
    rng = np.random.RandomState(1)
    tree = _tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jopt = joptim.build_optimizer(dict(cfg), jparams)
    jstate = jopt.init(jparams)
    g0, g1 = _grads(rng, tree, 0), _grads(rng, tree, 2)
    updates, jstate = jopt.update(
        jax.tree_util.tree_map(jnp.asarray, g0), jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)

    # merge the groups' masked moment trees: each leaf is set in one group
    inner = jstate[2].inner_states
    adam = [s.inner_state[0] for s in inner.values()]
    counts = {int(a.count) for a in adam}
    assert counts == {1}

    def merge(field):
        trees = [getattr(a, field) for a in adam]
        out = {}
        for name in params_from_jax(tree):
            for t in trees:
                node = t
                for part in name.split("."):
                    node = node[part] if isinstance(node, dict) else None
                    if node is None:
                        break
                if node is not None and hasattr(node, "shape"):
                    out[name] = np.asarray(node)
        return out

    def unflatten(flat):
        nested = {}
        for name, v in flat.items():
            node = nested
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
        return nested

    net = _Net(jax.tree_util.tree_map(np.asarray, jparams))
    topt = toptim.build_optimizer(dict(cfg), net)
    opt_state_from_jax(topt, net, unflatten(merge("mu")),
                       unflatten(merge("nu")), 1)

    updates, jstate = jopt.update(
        jax.tree_util.tree_map(jnp.asarray, g1), jstate, jparams)
    jparams = optax.apply_updates(jparams, updates)
    flat_g = params_from_jax(g1)
    for name, p in net.named_parameters():
        p.grad = flat_g[name].clone()
    topt.step()
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=0, atol=ATOL, err_msg=name)
    # the state survives a checkpoint round trip
    state = topt.state_dict()
    assert len(state["state"]) == len(list(net.parameters()))
    topt.load_state_dict(state)
