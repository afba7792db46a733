"""The synthetic fixture's rendered targets (``render_targets=True``) and the
data loader's ``cache_device`` mode, on the CPU, against the JAX package at
a small size (3 cameras, 3 frames, 64x64 images, uv 32).

The JAX fixture renders its targets under ``jax.jit``, whose CPU FMAs can
move a pixel centre across a face edge; the port renders eagerly through
its own rasterizer (K5's and K4's plain versions here). So the masks may
differ in at most ``MASK_PIXELS`` pixels in all (0 measured at this size;
2 of the 48 views of the quality config at 256x256), and the images are
held at ``IMAGE_ATOL`` where both masks cover a pixel, away from a 1-pixel
band around the masks' edges (8.1e-5 measured: float32 barycentrics and
texture lookups in other orders). Every other field, ``color_mean`` and
``tex_mean`` included, is bit-equal.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import binary_erosion

from goliath_torch.data.pipeline import DataLoader
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

KW = dict(n_cams=3, n_frames=3, img_h=64, img_w=64, uv_size=32,
          render_targets=True)
MASK_PIXELS = 4
IMAGE_ATOL = 2e-4


@pytest.fixture(scope="module")
def both():
    return SyntheticDataset(device="cpu", **KW), JSyntheticDataset(**KW)


def test_rendered_targets_match_jax(both):
    t, j = both
    assert len(t) == len(j) == 9
    for k in ("color_mean", "tex_mean"):
        np.testing.assert_array_equal(t.static_assets[k], j.static_assets[k])
    mask_diff = 0
    for idx in range(len(t)):
        ts, js = t[idx], j[idx]
        assert set(ts) == set(js)
        for k in ts:
            if k not in ("image", "image_mask"):
                np.testing.assert_array_equal(np.asarray(ts[k]),
                                              np.asarray(js[k]), err_msg=k)
        for k in ("image", "image_mask"):
            assert ts[k].dtype == js[k].dtype and ts[k].shape == js[k].shape
        tm, jm = ts["image_mask"][0] > 0, js["image_mask"][0] > 0
        mask_diff += int((tm != jm).sum())
        inner = binary_erosion(tm & jm, np.ones((3, 3), bool))
        assert inner.sum() > 0.05 * inner.size   # the sphere is in view
        np.testing.assert_allclose(ts["image"][:, inner],
                                   js["image"][:, inner], rtol=0,
                                   atol=IMAGE_ATOL, err_msg=str(idx))
        # a lambert-lit texture in [0, 1]: not flat, zero off the sphere
        img = ts["image"]
        assert 0.0 <= img.min() and img.max() <= 1.0 and img.std() > 0.05
        assert not img[:, ~tm].any()
    assert mask_diff <= MASK_PIXELS
    # the views of a frame share its geometry and lights
    a, b = t.get(1, 0), t.get(1, 2)
    for k in ("registration_vertices", "light_pos", "pose"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_targets_render_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    ds = SyntheticDataset(**KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(iter(DataLoader(SyntheticDataset(n_cams=2, n_frames=2),
                             cache_device=True)))


def test_cache_device_batches_equal_the_host_loader(both):
    """Two shuffled epochs of batches gathered from the dataset stacked on
    the device equal the host loader's collated batches, without the
    string fields."""
    t, _ = both
    kw = dict(batch_size=4, shuffle=True, seed=5, n_epochs=2)
    host = list(DataLoader(t, num_workers=0, **kw))
    cached = list(DataLoader(t, cache_device=True, device="cpu", **kw))
    assert len(host) == len(cached) == 2 * (len(t) // 4)
    assert host[0]["camera_id"] != host[2]["camera_id"]   # reshuffled
    for h, c in zip(host, cached):
        assert set(c) == {k for k, v in h.items()
                          if not isinstance(v, list)}
        assert "camera_id" in h
        for k, v in c.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), h[k], err_msg=k)
