"""The band-split render inside a model and on a 2-D mesh, on the CPU:

* the RGCA model with ``render.tile_shard_mesh`` / ``tile_shard_axis`` (the
  shapes of tests/test_tile_shard.py's model test: 48x48, uv 32, 4 bands)
  against the JAX model so configured, jitted (atol 3e-5, as that test
  holds the JAX one against its unsharded model), and against the port's
  unsharded model;
* the dry run's tile axis (goliath_torch/scripts/dryrun_multichip.py) on
  a 2 x 4 ("data", "tile") mesh against the JAX band render on a 2 x 4
  mesh of virtual CPU devices: outputs at atol 2e-5, the loss at rtol 2e-4
  (XLA's float32 mean), gradients at 1e-4 of their largest entry;
* the port's sharded step on a 2 x 2 ("data", "tile") mesh, the model's
  bands on the same mesh, against its unsharded step (loss rtol 1e-5,
  gradients at the port's rule, rtol 1e-3 + 1e-3 of the largest entry).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh as JMesh

from goliath_torch import train as t_train
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_torch.models.rgca import AutoEncoder
from goliath_torch.parallel import make_sharded_train_step
from goliath_torch.parallel.sharding import Mesh
from goliath_torch.scripts import dryrun_multichip as dr
from goliath_torch.test import to_device
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from goliath_tpu.models.rgca import AutoEncoder as JAutoEncoder
from goliath_tpu.parallel.sharding import make_mesh as j_make_mesh
from goliath_tpu.parallel.tile_shard import (
    render_tile_sharded as j_render_tile_sharded,
)

from tests.test_torch_mesh_vae_train import _jax_params

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rgca_kw(ds, render):
    return dict(encoder={"noise_std": 0.0}, decoder={"n_color_sh": 1},
                assets=ds.static_assets, image_height=48, image_width=48,
                cal=None, n_embs=8, n_diff_sh=2, learn_blur=False,
                uv_size=32, render=render)


def _batch(ds):
    samples = [ds.get(frame, 0) for frame in range(2)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if not isinstance(samples[0][k], str)}


def test_rgca_model_with_tile_sharded_render_matches_jax():
    kw = dict(n_cams=2, n_frames=2, img_h=48, img_w=48, uv_size=32, seed=7)
    ds, jds = SyntheticDataset(**kw), JSyntheticDataset(**kw)
    render = {"max_pairs_per_tile": 64, "chunk": 16}
    tm_ref = AutoEncoder(**_rgca_kw(ds, render), device="cpu")
    tm = AutoEncoder(**_rgca_kw(ds, dict(
        render, tile_shard_mesh=Mesh(["cpu"] * 4, ("tile",)),
        tile_shard_axis="tile")), device="cpu")
    state = tm_ref.module.state_dict()
    tm.module.load_state_dict(state)
    batch = _batch(ds)
    jbatch = _batch(jds)
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()}
    jm = JAutoEncoder(**_rgca_kw(jds, dict(
        render, tile_shard_mesh=j_make_mesh(4, axis_name="tile"),
        tile_shard_axis="tile")))
    params = _jax_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb),
                         state)
    ref = jax.jit(lambda p: jm.apply(p, jb, train=False)["rgb"])(params)

    tb = to_device(batch, CPU)
    with torch.no_grad():
        got = tm.apply(tb)["rgb"]
        single = tm_ref.apply(tb)["rgb"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=3e-5)
    assert float(got.abs().max()) > 0


def test_dryrun_tile_axis_on_a_2d_mesh_matches_jax():
    scene = dr.tile_axis_scene(CPU)
    mesh = Mesh([["cpu"] * 4] * 2, ("data", "tile"))
    v, grads = dr.tile_axis_loss(mesh, scene)

    K, Rt, pos, quat, scale, op, col = [jnp.asarray(t.numpy())
                                        for t in scene]
    jmesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                  ("data", "tile"))
    H, W = dr.TILE_AXIS["H"], dr.TILE_AXIS["W"]

    def loss(pos, scale, op, col):
        r = j_render_tile_sharded(jmesh, "tile", W, H, K, Rt, pos, quat,
                                  scale, op, col, **dr.TILE_AXIS["render"])
        return (r["render"] ** 2).mean() + r["alpha"].mean()

    ref_v, ref_g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3)))(
        pos, scale, op, col)
    np.testing.assert_allclose(v, float(ref_v), rtol=2e-4)
    for g, r, name in zip(grads, ref_g, ("pos", "scale", "op", "col")):
        r = np.asarray(r)
        s = np.abs(r).max() + 1e-8
        assert s > 1e-6, name
        np.testing.assert_allclose(g.numpy() / s, r / s, atol=1e-4,
                                   err_msg=name)
    # and the dry run's own check, against the unsharded render
    loss_v, ref_loss, shape = dr.dryrun_tile_axis(8, CPU)
    assert shape == (2, 4) and abs(loss_v - v) < 1e-6


def test_sharded_step_on_a_2d_mesh_matches_unsharded():
    """RGCA at the dry run's shapes, batch 4: 2 data shards of 2 samples,
    each rendered in 2 bands, against the unsharded step."""
    ds, model, batch = dr.build_rgca(48, 32, 2, 4, CPU)
    mesh = Mesh([["cpu"] * 2] * 2, ("data", "tile"))
    state0 = copy.deepcopy(model.module.state_dict())
    gen0 = model.module.generator.get_state()

    def run(sharded):
        model.module.load_state_dict(state0)
        model.module.generator.set_state(gen0)
        model.module.render_cfg.pop("tile_shard_mesh", None)
        model.module.render_cfg.pop("tile_shard_axis", None)
        loss_fn, opt = dr.family_loss_and_optimizer("rgca", ds, model)
        if sharded:
            model.module.render_cfg.update(tile_shard_mesh=mesh,
                                           tile_shard_axis="tile")
            step = make_sharded_train_step(model, loss_fn, opt, mesh)
        else:
            step = t_train.make_train_step(model, loss_fn, opt)
        total, _ = step({k: torch.as_tensor(v) for k, v in batch.items()},
                        0)
        return total, {n: p.grad.clone()
                       for n, p in model.module.named_parameters()}

    ref_total, ref_g = run(False)
    total, g = run(True)
    np.testing.assert_allclose(total.item(), ref_total.item(), rtol=1e-5)
    for n, r in ref_g.items():
        scale = float(r.abs().max())
        np.testing.assert_allclose(g[n].numpy(), r.numpy(), rtol=1e-3,
                                   atol=1e-3 * scale + 1e-30, err_msg=n)
    assert sum(float(r.abs().max()) > 0 for r in ref_g.values()) > 20
