"""Parity of the port's leaf utilities with the JAX package on the CPU:
``utils/arrayutils.py`` (``index``, ``to_device`` on a nested batch,
``ParamHolder``), ``utils/obj.py`` ``load_obj`` on OBJ files the test
writes, every function of ``utils/vis.py``, and the ``region_rgb_l1`` loss
(value and gradient, none through the region mask), on the same seeded
inputs.

Tolerances: the host-side numpy functions (obj, vis' colormaps and
drawing, ``ParamHolder``) bit for bit; gathers and batch moves exactly;
the heatmaps and ``region_rgb_l1`` at rtol 1e-6 plus 1e-6 of the largest
|value| (float32 elementwise arithmetic and a sum in other orders).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_torch.losses import ModularLoss as TModularLoss
from goliath_torch.losses import get_loss as t_get_loss
from goliath_torch.utils import arrayutils as ta
from goliath_torch.utils import obj as tobj
from goliath_torch.utils import vis as tv
from goliath_tpu.losses import get_loss as j_get_loss
from goliath_tpu.utils import arrayutils as ja
from goliath_tpu.utils import obj as jobj
from goliath_tpu.utils import vis as jv

torch.set_num_threads(1)

TOL = 1e-6


def close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * float(np.abs(ref).max()),
                               err_msg=err_msg)


def test_arrayutils_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 4).astype(np.float32)
    for idxs, dim in ((np.array([4, 0, 2, 2]), 1),
                      (np.array([[1, 0], [2, 2]]), 0),
                      (np.array([3, -1]), -1)):
        got = ta.index(torch.from_numpy(x), torch.from_numpy(idxs), dim)
        ref = np.asarray(ja.index(jnp.asarray(x), jnp.asarray(idxs), dim))
        assert tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref)

    batch = {
        "image": rng.rand(2, 3, 4, 4),                    # float64
        "camera_idx": np.array([3, 1]),                   # int64
        "mask": rng.rand(2, 1, 4, 4).astype(np.float32),
        "flags": np.array([True, False]),
        "frame": 7,
        "scale": 0.5,
        "cameras": ["401", "402"],
        "none": None,
        "name": "frame",
        "nested": {"K": rng.rand(2, 3, 3).astype(np.float32),
                   "ids": [np.array([1, 2]), np.array([3])]},
    }
    got = ta.to_device(batch, torch.device("cpu"))
    ref = ja.to_device(batch)

    def walk(g, r, path):
        if isinstance(r, dict):
            assert set(g) == set(r), path
            for k in r:
                walk(g[k], r[k], f"{path}.{k}")
        elif (isinstance(r, (list, tuple))
              and not (r and isinstance(r[0], str))):
            assert type(g) is type(r) and len(g) == len(r), path
            for i, (gi, ri) in enumerate(zip(g, r)):
                walk(gi, ri, f"{path}[{i}]")
        elif r is None or isinstance(r, (str, list)):
            assert g == r, path
        else:
            r = np.asarray(r)
            assert isinstance(g, torch.Tensor), path
            assert str(g.numpy().dtype) == str(r.dtype), path
            np.testing.assert_array_equal(g.numpy(), r, err_msg=path)

    walk(got, ref, "batch")
    # a tensor keeps its dtype
    assert ta.to_device(torch.ones(2, dtype=torch.float64),
                        "cpu").dtype == torch.float64

    keys = ["401", "402", "403"]
    init = rng.randn(3, 2).astype(np.float32)
    t_ph, j_ph = ta.ParamHolder(2, keys, init), ja.ParamHolder(2, keys, init)
    np.testing.assert_array_equal(t_ph.to_idx(["403", "401"]),
                                  j_ph.to_idx(["403", "401"]))
    assert t_ph.from_idx([2, 0]) == j_ph.from_idx([2, 0]) == ["403", "401"]
    np.testing.assert_array_equal(t_ph([2, 1]), j_ph([2, 1]))
    np.testing.assert_array_equal(ta.ParamHolder((2, 3), keys).params,
                                  ja.ParamHolder((2, 3), keys).params)


OBJ_TEXT = """# a quad, a pentagon and a triangle
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vt 0.5 0.75
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4/4/1
f 1/1 2/2 3/3 5/5 4/4

f 2/2 3/3 5/5
"""


def test_load_obj_matches_jax(tmp_path):
    no_uv = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\nf 1 2 3\nf 2//1 4//1 3//1\n"
    for name, text in (("uv.obj", OBJ_TEXT), ("no_uv.obj", no_uv)):
        path = tmp_path / name
        path.write_text(text)
        got = tobj.load_obj(str(path))
        ref = jobj.load_obj(str(path))
        with open(path, "rb") as f:
            from_fh = tobj.load_obj(f)
        got_text = tobj.load_obj(io.StringIO(text))
        assert set(got) == set(ref) == set(from_fh) == set(got_text)
        for k in ref:
            for g in (got[k], from_fh[k], got_text[k]):
                assert g.dtype == ref[k].dtype, (name, k)
                np.testing.assert_array_equal(g, ref[k], err_msg=k)
    assert set(got) == {"v", "vi"}
    assert ref["vi"].tolist() == [[0, 1, 2], [1, 3, 2]]
    full = tobj.load_obj(io.StringIO(OBJ_TEXT))
    assert len(full["vi"]) == 2 + 3 + 1 and full["vti"].shape == (6, 3)


def test_vis_matches_jax():
    rng = np.random.RandomState(1)
    kpts = rng.uniform(-2, 20, (2, 3, 2)).astype(np.float32)
    for fn in ("kpts2delta", "kpts2heatmap"):
        got = getattr(tv, fn)(torch.from_numpy(kpts), (12, 16))
        ref = getattr(jv, fn)(jnp.asarray(kpts), (12, 16))
        assert tuple(got.shape) == ref.shape, fn
        close(got, ref, fn)
    close(tv.kpts2heatmap(torch.from_numpy(kpts), (12, 16), sigma=3),
          jv.kpts2heatmap(jnp.asarray(kpts), (12, 16), sigma=3))

    scalar = rng.randn(1, 9, 11).astype(np.float32)
    feat = rng.randn(2, 5, 9, 11).astype(np.float32)
    depth = rng.uniform(-10, 300, (9, 11)).astype(np.float32)
    img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    cases = [
        ("get_color_map", ()),
        ("tensor2rgbjet", (scalar,)),
        ("tensor2rgbjet", (scalar, 1.0, -1.0)),
        ("tensor2rgb", (scalar,)),
        ("feature2rgb", (feat,)),
        ("feature2rgb", (feat[0, :2], 3)),
        ("visualize_scalar_image", (depth, 0.0, 250.0)),
        ("visualize_scalar_image", (depth, 10.0, 100.0, "COLORMAP_JET",
                                    False)),
        ("process_depth_image", (depth, 200.0, 50.0)),
        ("resize_to_match", (img, (20, 7))),
        ("tensor_to_rgb_array", (feat,)),
    ]
    for fn, args in cases:
        got = getattr(tv, fn)(*args)
        ref = getattr(jv, fn)(*args)
        got, ref = (got, ref) if isinstance(ref, tuple) else ((got,), (ref,))
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype, fn
            np.testing.assert_array_equal(g, r, err_msg=fn)
    # the host helpers take tensors too
    np.testing.assert_array_equal(tv.tensor2rgbjet(torch.from_numpy(scalar)),
                                  jv.tensor2rgbjet(scalar))

    kpt = np.concatenate([rng.uniform(-1, 12, (6, 2)),
                          rng.rand(6, 1)], 1).astype(np.float32)
    corrs = np.concatenate([np.zeros((4, 1)), rng.uniform(0, 10, (4, 4))],
                           1).astype(np.float32)
    draws = [
        ("draw_keypoints", lambda m: m.draw_keypoints(
            img.astype(np.float32).copy(), kpt, 0.8)),
        ("draw_keypoints_with_color", lambda m: m.draw_keypoints_with_color(
            img.copy(), kpt, (200.0, 10.0, 90.0))),
        ("draw_contour", lambda m: m.draw_contour(
            img.astype(np.float32).copy(), corrs)),
    ]
    for name, draw in draws:
        got, ref = draw(tv), draw(jv)
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
        assert not np.array_equal(got, img), name


def test_region_rgb_l1_matches_jax():
    rng = np.random.RandomState(2)
    preds = {"rgb": rng.randn(2, 3, 8, 8).astype(np.float32),
             "rendered_region_mask": rng.rand(2, 1, 8, 8).astype(np.float32)}
    targets = {"image": rng.randn(2, 3, 8, 8).astype(np.float32),
               "seg_fg": (rng.rand(2, 1, 8, 8) > 0.4).astype(np.float32)}
    # exact zeros of the difference: |x|'s gradient +1 there in both
    preds["rgb"][0, :, :2] = targets["image"][0, :, :2]

    t_loss = t_get_loss("region_rgb_l1")
    j_loss = j_get_loss("region_rgb_l1")
    t_preds = {k: torch.tensor(v, requires_grad=True)
               for k, v in preds.items()}
    value = t_loss(t_preds, {k: torch.from_numpy(v)
                             for k, v in targets.items()})
    value.backward()

    def j_fn(p):
        return j_loss(p, {k: jnp.asarray(v) for k, v in targets.items()})

    j_value, j_grads = jax.value_and_grad(j_fn)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    close(value, j_value, "value")
    close(t_preds["rgb"].grad, j_grads["rgb"], "gradient")
    assert not np.asarray(j_grads["rendered_region_mask"]).any()
    assert t_preds["rendered_region_mask"].grad is None
    # named keys, and through ModularLoss with a weight
    kw = dict(src_key="pred", tgt_key="gt", mask_key="fg",
              region_mask_key="region")
    renamed_p = {"pred": preds["rgb"], "region": preds["rendered_region_mask"]}
    renamed_t = {"gt": targets["image"], "fg": targets["seg_fg"]}
    close(t_get_loss("region_rgb_l1", init_kwargs=kw)(
              {k: torch.from_numpy(v) for k, v in renamed_p.items()},
              {k: torch.from_numpy(v) for k, v in renamed_t.items()}),
          j_get_loss("region_rgb_l1", init_kwargs=kw)(
              {k: jnp.asarray(v) for k, v in renamed_p.items()},
              {k: jnp.asarray(v) for k, v in renamed_t.items()}))
    total, ldict = TModularLoss({"region_rgb_l1": 0.5})(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        {k: torch.from_numpy(v) for k, v in targets.items()}, iteration=0)
    close(ldict["loss_region_rgb_l1"], j_value)
    close(total, 0.5 * np.asarray(j_value))
