"""The RGCA head recipe on a capture, the port against the JAX package on
the CPU: a small fake Head capture (``tests/goliath_capture.py``) at
``configs/rgca_synthetic.yml`` widths (64x64 images, uv 32, 3 cameras, the
identity camera 400000 among them; its frames alternate a fully-lit and a
5-light pattern; segmentation at half size, backgrounds of another size),
read by each package's ``BodyDataset`` and ``DataLoader``.

- The first collated, filtered batch of each package's loader: equal bit
  for bit.
- One training step on it (``train=True``, the Pallas kernels interpreted
  on the JAX side, the plain versions on the port's): every loss term at
  rtol 1e-4, every parameter gradient at rtol 1e-3 plus 1e-3 of the
  parameter's largest gradient entry, the tolerances of
  ``tests/test_torch_rgca_train.py`` (and its reasons: float32 sums in other
  orders, per-prim sums that are differences of float32 prefixes). The
  step runs at ``encoder.noise_std=0`` and the port gets the backlit
  direction the JAX run drew, as there. The capture has no
  ``image_weight``: both losses take a mask of ones.
- ``run_train.main`` for 2 steps, then ``run_test.main`` from its
  checkpoint directory on the test split's cameras: finite means.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_capture import CaptureSpec, write_capture, write_shared_assets
from goliath_torch.config import load_config as t_load_config
from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import params_from_jax
from goliath_torch.data.dataloader import BodyDataset
from goliath_torch.data.pipeline import DataLoader
from goliath_torch.data.synthetic import SyntheticDataset, make_camera_ring
from goliath_torch.scripts import run_test as t_run_test
from goliath_torch.scripts import run_train as t_run_train
from goliath_torch.test import to_device
from goliath_tpu.config import load_config, load_from_config
from goliath_tpu.data.pipeline import DataLoader as JDataLoader
from goliath_tpu.ops import gsplat_pallas
from goliath_tpu.scripts.run_train import build_dataset as j_build_dataset
from tests.test_torch_quality import flax_tree

torch.set_num_threads(1)

CFG = "configs/rgca_synthetic.yml"
CAMERAS = ["400000", "400001", "400002"]
TRAIN, TEST = [0, 1, 2, 3, 4, 5], [6, 7]
# the step parity overrides of tests/test_torch_rgca_train.py
STEP = ["model.render.use_pallas=true", "model.encoder.noise_std=0",
        "model.render.max_pairs_per_tile=1024"]
CPU = torch.device("cpu")


def flow(d) -> str:
    return "{" + ", ".join(f"{k}: {json.dumps(v)}" for k, v in d.items()) \
        + "}"


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The capture and the config overrides that point the recipe at it."""
    base = tmp_path_factory.mktemp("goliath")
    fixture = SyntheticDataset(n_cams=3, n_frames=1, img_h=64, img_w=64,
                               uv_size=32, device="cpu")
    a = fixture.static_assets
    K, Rt, _ = make_camera_ring(3, 64, 64)
    root = write_capture(base, "m--test--AXE977--Head", CaptureSpec(
        kind="Head", cameras=CAMERAS, K=K, Rt=Rt, frames=TRAIN + TEST,
        test_frames=TEST, template=a["verts_mean"], image_hw=(64, 64),
        uv_size=32, color_mean=a["color_mean"], seg_half=True,
        background_hw=(48, 40)))
    shared = write_shared_assets(base / "shared" / "static_assets_head.pt",
                                 {"topology": dict(a["topology"])})
    data = {"root_path": str(root), "shared_assets_path": str(shared),
            "split": "train", "fully_lit_only": False}
    test_data = dict(data, split="test", cameras_subset=CAMERAS[1:])
    return [f"data={flow(data)}", f"test.data={flow(test_data)}"]


@pytest.fixture(scope="module")
def step(capture):
    """The first batch of each package's loader, the port's model, and one
    JAX training step from the port's initial parameters."""
    cfg = t_load_config(CFG, overrides=capture + STEP)
    ds = t_run_train.build_dataset(cfg.data, device="cpu")
    batch = ds.batch_filter(next(iter(DataLoader(
        ds, device="cpu", **cfg.dataloader))))
    model = t_load_from_config(cfg.model, assets=ds.static_assets,
                               device="cpu")
    loss_fn = t_load_from_config(cfg.loss, assets=ds.static_assets)

    jcfg = load_config(CFG, overrides=capture + STEP)
    jds = j_build_dataset(jcfg.data)
    jbatch = jds.batch_filter(next(iter(JDataLoader(jds, **jcfg.dataloader))))
    jmodel = load_from_config(jcfg.model, assets=jds.static_assets)
    jloss = load_from_config(jcfg.loss, assets=jds.static_assets)
    jb = {k: jnp.asarray(v) for k, v in jbatch.items()
          if not isinstance(v, (list, str))}
    params = {"params": flax_tree(model.module.state_dict())}

    def loss_inner(p):
        preds = jmodel.apply(p, jb, train=True,
                             rngs={"noise": jax.random.PRNGKey(3)})
        total, ldict = jloss(preds, jb, 0)
        return total, (ldict, preds)

    gsplat_pallas.INTERPRET = True
    try:
        (total, (ldict, preds)), grads = jax.jit(jax.value_and_grad(
            loss_inner, has_aux=True))(params)
    finally:
        gsplat_pallas.INTERPRET = False
    preds = {k: np.asarray(v) for k, v in preds.items()}
    # the backlit direction the JAX run drew: cos_weight = spec_nml @ d
    light_dir = np.stack([
        np.linalg.lstsq(preds["spec_nml"][b].astype(np.float64),
                        preds["cos_weight"][b, :, 0].astype(np.float64),
                        rcond=None)[0]
        for b in range(len(preds["spec_nml"]))])[:, None]
    return dict(batch=batch, jbatch=jbatch, model=model, loss_fn=loss_fn,
                total=float(total),
                ldict={k: float(v) for k, v in ldict.items()},
                grads=params_from_jax(jax.device_get(grads)),
                light_dir=light_dir.astype(np.float32))


def test_first_loader_batch_matches_jax(step):
    batch, jbatch = step["batch"], step["jbatch"]
    assert set(batch) == set(jbatch)
    assert "image_weight" not in batch
    for k, v in batch.items():
        r = jbatch[k]
        if isinstance(v, list):
            assert v == r, k
            continue
        assert v.dtype == r.dtype and v.shape == r.shape, k
        assert np.array_equal(v, r), k
    assert batch["image"].shape == (2, 3, 64, 64)
    assert batch["image"].dtype == np.float32 and batch["image"].max() <= 1
    assert batch["light_pos"].shape == (2, 8, 3)


def test_train_step_on_the_capture_matches_jax(step):
    model, loss_fn = step["model"], step["loss_fn"]
    tb = to_device(step["batch"], CPU)
    tb["light_dir"] = torch.from_numpy(step["light_dir"])
    preds = model.apply(tb, train=True)
    total, ldict = loss_fn(preds, tb, 0)
    total.backward()

    assert set(ldict) == set(step["ldict"])
    np.testing.assert_allclose(total.item(), step["total"], rtol=1e-4)
    for k, ref in step["ldict"].items():
        np.testing.assert_allclose(ldict[k].item(), ref, rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    named = dict(model.module.named_parameters())
    assert set(named) == set(step["grads"])
    for name, p in named.items():
        r = step["grads"][name].numpy()
        assert p.grad is not None and np.isfinite(r).all(), name
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=1e-3,
                                   atol=1e-3 * scale + 1e-12, err_msg=name)
    for top in ("encoder", "geomdecoder", "decoder", "learn_blur"):
        assert any(float(p.grad.abs().max()) > 0
                   for n, p in named.items() if n.startswith(top + ".")), top


def test_run_train_then_run_test_on_the_capture(capture, tmp_path):
    run_dir = tmp_path / "run"
    cfg = t_load_config(CFG, overrides=capture + [
        f"train.run_dir={run_dir}", "train.n_max_iters=2",
        "train.log_every_n_steps=1", "train.summary_every_n_steps=100",
        "dataloader.num_workers=2", f"test.ckpt.ckpt_path={run_dir}/"
        "checkpoints", "test.vis_path=null", "test.n_test_frames=2"])
    iteration, last = t_run_train.main(cfg, device="cpu")
    assert iteration == 2 and all(np.isfinite(v) for v in last.values())
    assert (run_dir / "checkpoints" / "latest").exists()

    # run_test reads the test split through the config's test.data, as the
    # JAX run_test passes it: the cameras of cameras_subset, split test
    ds = t_run_test.build_dataset(dict(cfg.test.data))
    assert isinstance(ds, BodyDataset) and ds.split == "test"
    assert ds.get_camera_list() == CAMERAS[1:]
    assert len(ds) == len(TEST) * 2
    means = t_run_test.main(cfg, device="cpu")
    assert {"loss_psnr", "loss_rgb_l1"} <= set(means)
    assert all(np.isfinite(v) for v in means.values())
