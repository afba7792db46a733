"""Parity of the port's envmap utilities (utils/hdr.py, utils/envmap.py,
utils/mipmap_sampler.py, utils/sampling.avg_pool2d) and of
SingleLightCycleDecorator with the JAX package on the CPU, on the same
numpy inputs made from a seed.

Tolerances: the file readers and ``resize_area`` are numpy in both
packages and held bit for bit (and the .hdr decode against an independent
decode of the bytes). ``dir2uv`` rtol 1e-6 (atan2 and acos of float32,
each within an ulp or two of the other's) plus two ulps of 1 (the
v = 2 acos / pi - 1 of an equator direction cancels to near 0). The samplers (``grid_sample``
at coordinates that went through sin, cos, atan2 and acos) rtol 1e-5 plus
1e-5 of the largest value; the blurred background the same (a 101x101 sum
in another order). ``importance_sample_sg``: torch.erfinv against XLA's
float32 erfinv polynomial differ by a few ulp, and its slope grows
without bound as the argument nears 1; directions and pdf at rtol 1e-5
plus 1e-5 of the largest value. ``avg_pool2d`` and ``mipmap_grid_sample``
rtol 1e-6 plus 1e-6 (sums of the same terms, lerps of the same samples).
The point-light sweep's lights are numpy in both packages: bit for bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.utils import envmap as te
from goliath_torch.utils import hdr as th
from goliath_torch.utils import light_decorator as tl
from goliath_torch.utils import mipmap_sampler as tm
from goliath_torch.utils import sampling as ts
from goliath_tpu.utils import envmap as je
from goliath_tpu.utils import hdr as jh
from goliath_tpu.utils import light_decorator as jl
from goliath_tpu.utils import mipmap_sampler as jm
from goliath_tpu.utils import sampling as js
from goliath_tpu.utils.quaternion import axisangle_to_matrix as j_aa

# tiny shapes: more intra-op threads only contend with the other test
# workers of a parallel run
torch.set_num_threads(1)

SAMPLE_TOL = 1e-5
EXACT_TOL = 1e-6
CPU = types.SimpleNamespace(device=torch.device("cpu"))

# the JAX references jitted: eagerly JAX compiles and dispatches each of
# their gathers one by one
j_rotate = jax.jit(je.rotate_envmap_mat)
j_to_image = jax.jit(je.envmap_to_image, static_argnums=(0, 1),
                     static_argnames=("blurbg",))
j_mirrorball = jax.jit(je.envmap_to_mirrorball, static_argnums=(0, 1))
j_prefilter = jax.jit(je.prefilter_envmap_sg, static_argnums=(0, 4))
j_compose = jax.jit(je.compose_envmap)


def close(got, ref, rtol, of_max):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=of_max * float(np.abs(ref).max()))


def unit(rng, shape, axis):
    v = rng.standard_normal(shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=axis, keepdims=True)


def rotation(rng):
    r = rng.standard_normal(3).astype(np.float32)
    return np.array(j_aa(jnp.asarray(r)))


# --- utils/hdr.py ---------------------------------------------------------

def _hdr_header(H, W):
    return (b"#?RADIANCE\n# made by a test\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {H} +X {W}\n".encode())


def _decode(rgbe):
    """Independent RGBE decode: m * 2^(e - 136), 0 where e == 0."""
    m = rgbe[..., :3].astype(np.float64)
    e = rgbe[..., 3].astype(np.int64)
    return np.where(e[..., None] > 0, m * np.exp2(e - 136)[..., None], 0.0)


def _rle_channel(vals):
    """One channel plane of a scanline as alternating runs and literals."""
    out, x, W = bytearray(), 0, len(vals)
    while x < W:
        run = 1
        while x + run < W and vals[x + run] == vals[x] and run < 127:
            run += 1
        if run >= 3:
            out += bytes([128 + run, vals[x]])
            x += run
            continue
        n = 1
        while x + n < W and n < 128 and not (
                x + n + 2 < W and vals[x + n] == vals[x + n + 1]
                == vals[x + n + 2]):
            n += 1
        out += bytes([n]) + bytes(vals[x: x + n])
        x += n
    return bytes(out)


@pytest.mark.parametrize("rle", [False, True])
def test_read_hdr_matches_jax_and_the_bytes(tmp_path, rle):
    rng = np.random.default_rng(3 + rle)
    H, W = 5, 37
    rgbe = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    rgbe[..., 3] = rng.integers(120, 140, (H, W))
    rgbe[1, 3:20] = rgbe[1, 3]          # runs for the RLE coder
    rgbe[2, :, 3] = 0                   # e == 0 decodes to 0
    rgbe[:, 0, 0] = np.where(rgbe[:, 0, 0] == 2, 3, rgbe[:, 0, 0])
    body = bytearray()
    for y in range(H):
        if rle:
            body += bytes([2, 2, W >> 8, W & 255])
            for c in range(4):
                body += _rle_channel(rgbe[y, :, c].tolist())
        else:
            body += rgbe[y].tobytes()
    path = tmp_path / ("rle.hdr" if rle else "flat.hdr")
    path.write_bytes(_hdr_header(H, W) + bytes(body))
    got = th.load_envmap(str(path))
    ref = jh.load_envmap(str(path))
    # float64, as the JAX reader's (its ldexp scale is float64), though
    # the module says float32; EnvSpinDecorator casts it
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _decode(rgbe))


def test_read_hdr_refuses_other_files(tmp_path):
    path = tmp_path / "x.hdr"
    path.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError, match="not a Radiance HDR"):
        th.load_envmap(str(path))


@pytest.mark.parametrize("ext", [".npy", ".npz"])
def test_load_envmap_arrays_match_jax(tmp_path, ext):
    img = np.random.default_rng(5).random((6, 12, 3))   # float64 on disk
    path = tmp_path / f"env{ext}"
    if ext == ".npy":
        np.save(path, img)
    else:
        np.savez(path, envmap=img)
    got, ref = th.load_envmap(str(path)), jh.load_envmap(str(path))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,dst", [((64, 128), (16, 32)),
                                     ((48, 100), (16, 32)),
                                     ((20, 40), (512, 1024))])
def test_resize_area_matches_jax(src, dst):
    img = np.random.default_rng(6).random(src + (3,)).astype(np.float32)
    got, ref = th.resize_area(img, *dst), jh.resize_area(img, *dst)
    assert got.shape == dst + (3,)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# --- utils/sampling.py, utils/envmap.py ------------------------------------

def test_avg_pool2d_matches_jax():
    x = np.random.default_rng(7).random((2, 3, 8, 12)).astype(np.float32)
    close(ts.avg_pool2d(torch.from_numpy(x), 2),
          js.avg_pool2d(jnp.asarray(x), 2), EXACT_TOL, EXACT_TOL)


@pytest.mark.parametrize("n", [101, 200, 24])
def test_linspace_matches_jnp(n):
    np.testing.assert_array_equal(ts.linspace(-4.0, 4.0, n).numpy(),
                                  np.asarray(jnp.linspace(-4.0, 4.0, n)))
    np.testing.assert_array_equal(ts.linspace(-1.0, 1.0, n).numpy(),
                                  np.asarray(jnp.linspace(-1.0, 1.0, n)))


def test_dir2uv_matches_jax_at_the_poles_and_the_seam():
    rng = np.random.default_rng(8)
    d = unit(rng, (2, 3, 5, 7), 1)
    d[0, :, 0, 0] = [0.0, 1.0, 0.0]      # the poles: y = +-1
    d[0, :, 0, 1] = [0.0, -1.0, 0.0]
    d[0, :, 1, 0] = [0.0, 1.0 + 1e-7, 0.0]   # past 1: the clip
    d[1, :, 0, 0] = [0.0, 0.6, 0.0]      # x = z = 0 off the poles
    d[1, :, 0, 1] = [-0.0, 0.3, -1.0]    # on the seam
    d[1, :, 0, 2] = [1e-30, 0.0, -1.0]
    got = te.dir2uv(torch.from_numpy(d), 1)
    ref = je.dir2uv(jnp.asarray(d), 1)
    # v = 2 acos(y) / pi - 1 cancels near the equator: an ulp of 2 acos /
    # pi (~1) survives as an absolute error there
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=2 * np.finfo(np.float32).eps)
    last = te.dir2uv(torch.from_numpy(np.moveaxis(d, 1, -1)), -1)
    np.testing.assert_array_equal(last.numpy(), got.numpy())


def test_sphere_dirs_match_jax():
    close(te._sphere_dirs(9, 18), je._sphere_dirs(9, 18), EXACT_TOL,
          EXACT_TOL)


def test_rotate_envmap_mat_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.random((3, 16, 32)).astype(np.float32)
    for rot in (rotation(rng), np.eye(3, dtype=np.float32)):
        close(te.rotate_envmap_mat(torch.from_numpy(img),
                                   torch.from_numpy(rot)),
              j_rotate(jnp.asarray(img), jnp.asarray(rot)),
              SAMPLE_TOL, SAMPLE_TOL)
    close(te.rotate_envmap(torch.from_numpy(img), 0.3, -1.1, 2.0),
          je.rotate_envmap(jnp.asarray(img), 0.3, -1.1, 2.0),
          SAMPLE_TOL, SAMPLE_TOL)


def _camera(rng, B, w, h):
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(30, 60, B)
    K[:, 1, 1] = K[:, 0, 0] * rng.uniform(0.9, 1.1, B)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2 + 1.5, h / 2 - 2.0, 1.0
    R = np.stack([rotation(rng) for _ in range(B)])
    return K, R


@pytest.mark.parametrize("blurbg", [False, True])
def test_envmap_to_image_matches_jax(blurbg):
    rng = np.random.default_rng(10)
    B, w, h = 2, 40, 28
    env = rng.random((B, 3, 16, 32)).astype(np.float32)
    K, R = _camera(rng, B, w, h)
    for camrot in (R, None):
        got = te.envmap_to_image(
            w, h, torch.from_numpy(env), torch.from_numpy(K[:, :2, 2]),
            torch.from_numpy(K),
            None if camrot is None else torch.from_numpy(camrot),
            blurbg=blurbg)
        ref = j_to_image(
            w, h, jnp.asarray(env), jnp.asarray(K[:, :2, 2]), jnp.asarray(K),
            None if camrot is None else jnp.asarray(camrot), blurbg=blurbg)
        close(got, ref, SAMPLE_TOL, SAMPLE_TOL)


def test_envmap_to_mirrorball_matches_jax():
    rng = np.random.default_rng(11)
    env = rng.random((2, 3, 16, 32)).astype(np.float32)
    R = np.stack([rotation(rng) for _ in range(2)])
    for camrot in (R, None):
        got = te.envmap_to_mirrorball(
            24, 24, torch.from_numpy(env),
            None if camrot is None else torch.from_numpy(camrot))
        ref = j_mirrorball(
            24, 24, jnp.asarray(env),
            None if camrot is None else jnp.asarray(camrot))
        assert tuple(got.shape) == (2, 4, 24, 24)
        np.testing.assert_array_equal(got[:, 3].numpy(),
                                      np.asarray(ref[:, 3]))
        close(got, ref, SAMPLE_TOL, SAMPLE_TOL)


@pytest.mark.parametrize("sigma", [0.2, 0.6])
def test_importance_sample_sg_matches_jax(sigma):
    rng = np.random.default_rng(12)
    Xi = rng.random((2, 2, 6, 9)).astype(np.float32)
    n = unit(rng, (2, 3, 6, 9), 1)
    n[0, :, 0, 0] = [0.0, 0.0, 1.0]      # the up-vector switch at z >= 0.999
    n[0, :, 0, 1] = [0.0, 0.0445, 0.999]
    got = te.importance_sample_sg(torch.from_numpy(Xi), torch.from_numpy(n),
                                  sigma)
    ref = je.importance_sample_sg(jnp.asarray(Xi), jnp.asarray(n), sigma)
    for g, r in zip(got, ref):
        close(g, r, SAMPLE_TOL, SAMPLE_TOL)


def _jax_draws(level, shape, n):
    key = jax.random.fold_in(jax.random.PRNGKey(7), level)
    return [np.array(jax.random.uniform(jax.random.fold_in(key, i), shape))
            for i in range(n)]


def test_prefilter_envmap_sg_matches_jax_on_its_draws():
    rng = np.random.default_rng(13)
    env = rng.random((1, 3, 8, 16)).astype(np.float32)
    v = unit(rng, (1, 3, 8, 16), 1)
    sigma, n = 0.4, 3
    ref = j_prefilter(
        sigma, jnp.asarray(v), jnp.asarray(env),
        jax.random.fold_in(jax.random.PRNGKey(7), 1), n)
    draws = [torch.from_numpy(d) for d in _jax_draws(1, (1, 2, 8, 16), n)]
    got = te.prefilter_envmap_sg(sigma, torch.from_numpy(v),
                                 torch.from_numpy(env), draws=draws)
    close(got, ref, SAMPLE_TOL, SAMPLE_TOL)
    # the generator route: the same function of its own draws
    g = torch.Generator().manual_seed(7)
    own = te.prefilter_envmap_sg(sigma, torch.from_numpy(v),
                                 torch.from_numpy(env), n, generator=g)
    g = torch.Generator().manual_seed(7)
    again = [torch.rand((1, 2, 8, 16), generator=g) for _ in range(n)]
    torch.testing.assert_close(
        own, te.prefilter_envmap_sg(sigma, torch.from_numpy(v),
                                    torch.from_numpy(env), draws=again),
        rtol=0, atol=0)


def test_compose_envmap_matches_jax():
    rng = np.random.default_rng(14)
    B, w, h = 1, 36, 30
    render = rng.random((B, 3, h, w)).astype(np.float32) * 0.5
    alpha = rng.random((B, 1, h, w)).astype(np.float32)
    env = rng.random((B, 3, 16, 32)).astype(np.float32) * 2.0
    K, R = _camera(rng, B, w, h)
    Rt = np.concatenate([R, rng.standard_normal((B, 3, 1)).astype(
        np.float32)], -1)
    args = (render, alpha, env, K, Rt)
    got = te.compose_envmap(*map(torch.from_numpy, args))
    ref = j_compose(*map(jnp.asarray, args))
    close(got, ref, SAMPLE_TOL, SAMPLE_TOL)


# --- utils/mipmap_sampler.py ------------------------------------------------

@pytest.mark.parametrize("case", ["integer", "between", "top_clip", "q1"])
def test_mipmap_grid_sample_matches_jax(case):
    rng = np.random.default_rng(15)
    q = 1 if case == "q1" else 4
    levels = [rng.random((2, 3, 16 >> i, 32 >> i)).astype(np.float32)
              for i in range(q)]
    grid = rng.uniform(-1.1, 1.1, (2, 5, 7, 2)).astype(np.float32)
    lvl = {"integer": rng.integers(0, q, (2, 5, 7)).astype(np.float32),
           "between": rng.uniform(-0.5, q - 1, (2, 5, 7)),
           "top_clip": np.full((2, 5, 7), q - 1 + 0.5),
           "q1": rng.uniform(-1, 2, (2, 5, 7))}[case].astype(np.float32)
    got = tm.mipmap_grid_sample([torch.from_numpy(x) for x in levels],
                                torch.from_numpy(grid), torch.from_numpy(lvl))
    ref = jm.mipmap_grid_sample([jnp.asarray(x) for x in levels],
                                jnp.asarray(grid), jnp.asarray(lvl))
    assert tuple(got.shape) == (2, 3, 5, 7)
    close(got, ref, EXACT_TOL, EXACT_TOL)
    if case == "top_clip":   # just below the top level: all of it
        top = ts.grid_sample(torch.from_numpy(levels[-1]),
                             torch.from_numpy(grid), padding_mode="border")
        torch.testing.assert_close(got, top, rtol=1e-5, atol=1e-5)


# --- utils/light_decorator.py: the point-light sweep ------------------------

@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("anchor", ["head_pose", "pose", None])
def test_single_light_cycle_augment_matches_jax(axis, anchor):
    rng = np.random.default_rng(22 + axis)
    batch = {"campos": rng.standard_normal((3, 3)).astype(np.float32),
             "index": np.asarray([0, 5, -7])}
    if anchor == "head_pose":
        batch["head_pose"] = rng.standard_normal((3, 3, 4)).astype(np.float32)
    elif anchor == "pose":
        batch["pose"] = rng.standard_normal((3, 6)).astype(np.float32)
    ref = jl.SingleLightCycleDecorator(None, cycle=12,
                                       light_rotate_axis=axis).augment(batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = tl.SingleLightCycleDecorator(CPU, cycle=12,
                                       light_rotate_axis=axis).augment(tb)
    assert set(got) == set(ref)
    for k in ("light_intensity", "light_pos", "n_lights",
              "is_fully_lit_frame"):
        assert got[k].dtype == torch.from_numpy(np.array(ref[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
