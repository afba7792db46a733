"""Parity of the drivable model's face modules with the JAX package on the
CPU: ``nn/face.py`` ``FaceDecoderFrontal`` at two depths of its width
arithmetic (32^2: up-convolutions 256, 8; 64^2: 256, 32, 8), and
``models/mesh_vae_drivable.py``'s ``Encoder`` (the binarized resized body
mask, the unposed vertices' UV map) and ``FaceEncoder`` (the mugsy mask
resized with ``align_corners``, the texture without), each alone, with the
JAX parameters carried across by ``params_from_jax``.

Tolerances: every output at rtol 1e-5 plus 1e-5 of the output's largest
|value| (float32 matrix products and convolutions summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.models import mesh_vae_drivable as tmd
from goliath_torch.nn.face import FaceDecoderFrontal as TFace
from goliath_torch.nn.face import up_widths
from goliath_torch.utils.geom import GeometryModule
from goliath_tpu.models import mesh_vae_drivable as jmd
from goliath_tpu.nn.face import FaceDecoderFrontal as JFace
from goliath_tpu.utils.geom import GeometryModule as JGeometryModule
from tests.drivable_fixture import dataset

torch.set_num_threads(1)

TOL = 1e-5


def close(got, ref, err_msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.detach().numpy(), ref, rtol=TOL,
        atol=TOL * float(np.abs(ref).max()), err_msg=err_msg)


def port_params(module):
    """The flax tree of a port module's parameters (the inverse of
    ``params_from_jax``)."""
    tree = {}
    for name, p in module.state_dict().items():
        node = tree
        *parts, last = name.split(".")
        for k in parts:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(p.numpy())
    return {"params": tree}


class _Assets:
    face_frontal_view = np.array([0.3, -0.2, 0.9], np.float32)


@pytest.mark.parametrize("size,widths", [(32, [256, 8]),
                                         (64, [256, 32, 8])])
def test_face_decoder_matches_jax(size, widths):
    assert up_widths(size) == widths
    assert up_widths(1024) == [256, 128, 128, 64, 64, 32, 8]
    tm = TFace(_Assets(), n_latent=8, n_vert_out=3 * 16,
               tex_out_shp=(size, size),
               generator=torch.Generator().manual_seed(1))
    # a non-zero untied bias, so that it shows in face_tex
    with torch.no_grad():
        tm.bias.copy_(torch.from_numpy(np.random.RandomState(2).randn(
            3, size, size).astype(np.float32) * 0.1))
    params = port_params(tm)
    assert set(params_from_jax(params)) == set(tm.state_dict())
    assert [k for k in params["params"] if k.startswith("texmod_up")] == [
        f"texmod_up{i}" for i in range(len(widths))]
    codes = np.random.RandomState(3).randn(2, 8).astype(np.float32)
    jm = JFace(assets=_Assets(), n_latent=8, n_vert_out=3 * 16,
               tex_out_shp=(size, size))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(codes))
    assert jax.tree_util.tree_map(lambda s: s.shape, shapes) == \
        jax.tree_util.tree_map(lambda a: a.shape, params)
    ref = jax.jit(jm.apply)(params, jnp.asarray(codes))
    with torch.no_grad():
        got = tm(torch.from_numpy(codes))
    assert set(got) == set(ref) == {"face_geom", "face_tex_raw", "face_tex"}
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        close(got[k], ref[k], k)
    assert got["face_tex"].shape == (2, 3, size, size)


def test_encoders_match_jax():
    ds = dataset()
    topo = ds.static_assets.topology
    args = (np.asarray(topo.vi), np.asarray(topo.vt), np.asarray(topo.vti),
            np.asarray(topo.v2uv))
    t_geo = GeometryModule(*args, uv_size=64, impaint=True, device="cpu")
    j_geo = JGeometryModule(*args, uv_size=64, impaint=True)
    rng = np.random.RandomState(4)
    # a body mask at another size than enc_size (resized, then > 0) and a
    # mugsy mask with values between 0 and 1 (resized with align_corners)
    body_mask = (rng.rand(48, 48) > 0.3).astype(np.float32)
    mugsy = rng.rand(40, 40).astype(np.float32)
    verts = rng.randn(2, len(topo.v), 3).astype(np.float32)
    motion = rng.randn(2, 12).astype(np.float32)
    face_geom = rng.randn(2, 16, 3).astype(np.float32)
    face_tex = rng.uniform(0, 255, (2, 3, 48, 48)).astype(np.float32)

    cases = [
        (tmd.Encoder(t_geo, n_embs=16, mask=body_mask, enc_size=64,
                     generator=torch.Generator().manual_seed(5)),
         jmd.Encoder(geo_fn=j_geo, n_embs=16, mask=body_mask, enc_size=64),
         (motion, verts)),
        (tmd.FaceEncoder(n_embs=8, mugsy_mask=mugsy, n_vert_in=3 * 16,
                         uv_size=32,
                         generator=torch.Generator().manual_seed(6)),
         jmd.FaceEncoder(n_embs=8, mugsy_mask=mugsy, n_vert_in=3 * 16,
                         uv_size=32),
         (face_geom, face_tex)),
    ]
    for tm, jm, inputs in cases:
        params = port_params(tm)
        ref = jax.jit(lambda p, *x: jm.apply(p, *x, train=False))(
            params, *map(jnp.asarray, inputs))
        with torch.no_grad():
            got = tm(*map(torch.from_numpy, inputs))
        assert set(got) == set(ref), type(tm).__name__
        for k in ref:
            close(got[k], ref[k], f"{type(tm).__name__} {k}")
    assert set(ref) == {"face_embs", "face_embs_mu", "face_embs_logvar",
                        "face_tex_cond"}
    # the binarized mask holds zeros, and the mugsy mask values between
    assert 0 < float(cases[0][0].mask.mean()) < 1
    m = cases[1][0].mask
    assert float(((m > 0) & (m < 1)).float().mean()) > 0.5
