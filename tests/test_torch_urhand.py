"""Parity of the port's URHand eval forward (models/urhand.py, with
utils/shadowmap.py, the URHand losses and the quaternion and projection
helpers) with the JAX package on the CPU, at the sizes of
tests/test_urhand.py (48x48 images, uv 32, 32x32 shadow maps, 2 lights),
at batch 2. Both packages take the port's initialization (seed 0), put
into the JAX model's parameter tree by name and carried back by
params_from_jax (a round trip): ``init`` of the JAX model runs its whole
forward and takes ~35 s on one core under ``jax.jit``, where
``jax.eval_shape`` of it takes ~3 s.

The template is moved by N(0, 0.5) per vertex on both sides
(tests/test_torch_mesh_vae.py's ``jitter_template``): the sphere's pole
faces are degenerate, and XLA on the CPU contracts products into fused
multiply-adds under ``jax.jit``, which turns their normals into other
numbers than any separately rounded evaluation gives. The JAX forward
runs under ``jax.jit`` (eagerly it takes ~57 s on one core).

On the CPU the JAX model takes the XLA scan z-buffer and the port K5's
plain version; they differ only in tiles over ``max_faces_per_tile``. Every
z-buffer call of the port's forward (2 x B x L light views and 3 renders a
sample) is asserted to stay inside its window, and the shadow maps' nearest
taps are asserted to fall on the same texels in both packages (a tap moved
across a rounding tie would change a texel's shadow by up to the whole
depth difference).

Tolerances: rtol 1e-4 plus 1e-4 of the output's largest |value| on the
decoder's outputs and the forward's (float32 convolutions and sums taken in
other orders; the spec powers p = 16 and 32 are ``lax.integer_pow`` in JAX
and ``torch.pow`` here, which round apart); tex_rec and its renders at
1e-3 of the largest |value|, because gain and bias are multiplied by
tex_mean (up to 192) and tex_std (64), so a 1e-5 gain moves a texel by
1e-3 of the texture's scale; depth at rtol 5e-4 (1/z interpolated with
barycentrics that divide by face areas), as in the mesh tests, and the
decoder's shadow maps, and the features summed from them, by that rule
carried through the depth compare (``shadow_allowance``); the displaced geometry's normal by its
conditioning (``normal_allowance``), the view conditioning resampled from
its TBN frame by that allowance resampled, and the outputs that follow the
normal texel by texel on the texels where that allowance is within the
usual tolerance; rendered images where the face index agrees
(>= 99.9% of covered pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_torch.convert import params_from_jax
from goliath_torch.models import urhand as tu
from goliath_torch.ops import rasterizer as tr
from goliath_torch.test import to_device
from goliath_torch.utils import geom as tgeom
from goliath_torch.utils import shadowmap as tsm
from goliath_torch.utils.sampling import interpolate_bilinear
from goliath_tpu.data.synthetic import SyntheticDataset
from goliath_tpu.models import urhand as ju
from goliath_tpu.ops import rasterizer as jr
from goliath_tpu.utils import geom as jgeom
from goliath_tpu.utils import shadowmap as jsm

from tests.test_torch_mesh_vae import close_to_scale, jitter_template
from tests.test_torch_mesh_vae_train import _jax_params

torch.set_num_threads(1)

RTOL = 1e-4
DEPTH_RTOL = 5e-4
TEX_OF_SCALE = 1e-3
SHADOW_MAX_FACES, RENDER_MAX_FACES = 128, 128
MODEL_KW = dict(
    renderer={"image_height": 48, "image_width": 48,
              "max_faces_per_tile": RENDER_MAX_FACES, "chunk": 16},
    relight={"uv_size": 32, "init_uv_size": 8, "pose_enc_dims": 12,
             "disp_enc_dims": (8, 8, 8), "disp_scale": 0.3,
             "init_channels": 16, "shadow_max_faces": SHADOW_MAX_FACES},
    global_scaling=1.0, shadow_size=32)
# the decoder's outputs that follow the displaced geometry's normal
# (xyz2normals of the displaced position map) texel by texel: at the
# fixture a few percent of texels (at the UV layout's border, where the
# zero padding or the impainted texels make the central differences short
# or nearly parallel) have a normal that a one-ulp move of the positions
# turns by up to ~1e-2 (``normal_allowance``)
NORMAL_DEPENDENT = ("shadow", "diff_feature", "spec_feature", "phys_tex")
DECODER_KEYS = ("shadow", "diff_feature", "spec_feature", "displacement",
                "roughness", "phys_tex", "feature_normal", "verts_displaced",
                "id_pose_conv", "interm_features2reg", "tex")


def normal_allowance(xyz: torch.Tensor) -> np.ndarray:
    """How far [B, H, W] xyz2normals' unit normals of the position map xyz
    may move when the positions move by a few ulps of their largest
    coordinate P: the normal is the cross product of the central
    differences U, V, so it moves by up to ~P (|U| + |V|) / |U x V| ulps
    (float64 here; 4 ulps of float32 allowed)."""
    pad = torch.nn.functional.pad(xyz.double(), (1, 1, 1, 1))
    U = pad[:, :, 2:, 1:-1] - pad[:, :, :-2, 1:-1]
    V = pad[:, :, 1:-1, 2:] - pad[:, :, 1:-1, :-2]
    n = torch.linalg.cross(U, V, dim=1).norm(dim=1)
    cond = float(xyz.abs().max()) * (U.norm(dim=1) + V.norm(dim=1)) \
        / n.clamp(min=1e-300)
    return (4 * np.finfo(np.float32).eps * cond).numpy()


def shadow_allowance(shadow_ref, light_range):
    """What the depth rule lets a shadow map exp(-sm / 8) of the jitted JAX
    forward move. Under jax.jit XLA contracts render_barys' products into
    FMAs, which moves the light views' depth (1/z interpolated with
    barycentrics that divide by face areas) within the mesh tests' depth
    rule, rtol 5e-4; sm is a weighted mean of depth differences, so
    |d shadow| <= shadow / 8 * 5e-4 * (the largest light-to-vertex
    distance). (get_shadow_map itself is compared with the eager JAX
    function at the usual tolerance.)"""
    return np.asarray(shadow_ref) / 8 * DEPTH_RTOL * light_range


def depth_rule_close(got, ref, allowance, err_msg=""):
    """``got`` within the usual tolerance plus ``allowance`` (the depth
    rule, or the normal's conditioning, carried to this output) everywhere,
    and within the usual one on 99% of its entries."""
    ref = np.asarray(ref)
    usual = RTOL * np.abs(ref) + RTOL * np.abs(ref).max()
    diff = np.abs(got - ref)
    np.testing.assert_array_less(diff, usual + allowance + 1e-30,
                                 err_msg=err_msg)
    assert (diff <= usual).mean() >= 0.99, err_msg


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TileCounts:
    """Records, for every z-buffer call of the port in a with-block, the
    largest number of faces binned to one tile and the call's window."""

    def __enter__(self):
        self.calls, self.orig = [], tr.zbuffer

        def zb(*args):
            self.calls.append((int((args[3] - args[2]).max()), args[10],
                               (args[4], args[5])))
            return self.orig(*args)

        tr.zbuffer = zb
        return self

    def __exit__(self, *exc):
        tr.zbuffer = self.orig

    def assert_inside_windows(self, n_calls):
        assert len(self.calls) == n_calls
        for most, window, hw in self.calls:
            assert most <= window, (most, window, hw)


@pytest.fixture(scope="module")
def both():
    ds = jitter_template(SyntheticDataset(n_cams=2, n_frames=2, img_h=48,
                                          img_w=48, uv_size=32, n_lights=2,
                                          seed=4))
    kw = dict(MODEL_KW, assets=ds.static_assets,
              cal={"identity_camera": ds.static_assets.camera_ids[0]})
    batch = next(ds.batches(2, 1))
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = ju.AutoEncoder(**kw)
    tm = tu.AutoEncoder(**kw, device="cpu")
    params = _jax_params(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jb)), tm.module.state_dict())
    ref = jax.jit(lambda p: jm.apply(p, jb, train=False))(params)
    tm.module.load_state_dict(params_from_jax(jax.device_get(params)),
                              strict=True)
    dec_args = {}
    hook = tm.module.decoder_relight.register_forward_pre_hook(
        lambda _m, args: dec_args.setdefault("args", args))
    with torch.no_grad(), TileCounts() as counts:
        got = tm.apply(to_device(batch, torch.device("cpu")))
    hook.remove()
    return dict(ds=ds, batch=batch, jb=jb, jm=jm, tm=tm, params=params,
                ref=ref, got=got, dec_args=dec_args["args"], counts=counts)


def _light_scene(both, n_lights=4):
    """The fixture's posed, jittered sphere seen from lights around it (one
    straight above, where the look-at moves the camera by 1e-2): the light
    views Rt, the verts, the UV position map and the UV normals."""
    tm, got = both["tm"], both["got"]
    verts = got["geom"][:1].expand(n_lights, -1, -1).contiguous()
    rng = np.random.RandomState(5)
    lp = rng.randn(n_lights, 3).astype(np.float32)
    lp = 500.0 * lp / np.linalg.norm(lp, axis=-1, keepdims=True)
    lp[0] = (0.0, 500.0, 0.0)
    posc = (verts.amax(1) + verts.amin(1)) / 2
    rot = tu.build_cam_rot_mat(_t(lp), posc)
    jrot = ju.build_cam_rot_mat(jnp.asarray(lp), jnp.asarray(posc.numpy()))
    close_to_scale(rot.numpy(), jrot)
    Rt = torch.cat([rot, -torch.einsum("bij,bj->bi", rot, _t(lp))[..., None]],
                   2)
    postex = tm.geo_fn.to_uv(verts)
    nml = tu._norm_cf(tm.geo_fn.to_uv(tm.geo_fn.vn(verts)))
    return Rt, verts, postex, nml


def test_shadow_map_matches_jax(both):
    tm, jm = both["tm"], both["jm"]
    Rt, verts, postex, nml = _light_scene(both)
    trl, jrl = tm.module.decoder_relight.shadow_rl, jm.module.shadow_rl
    with TileCounts() as counts:
        got = tsm.get_shadow_map(trl, Rt, None, verts, postex, nml)
    counts.assert_inside_windows(len(Rt))
    args = [jnp.asarray(x.numpy()) for x in (Rt, verts, postex, nml)]
    # eagerly: under jax.jit XLA contracts render_barys' products into FMAs
    # (see depth_rule_close)
    ref = jsm.get_shadow_map(jrl, args[0], None, *args[1:])
    assert tuple(got.shape) == ref.shape == (len(Rt), 1, 32, 32)

    # the nearest taps fall on the same texels: the JAX package's steps
    # (utils/shadowmap.py) against the port's, from each package's focal
    K = tsm.fit_light_camera(trl, Rt, verts)
    pts = postex.permute(0, 2, 3, 1).reshape(len(Rt), -1, 3)
    p_pix = tgeom.project_points_multi(pts, Rt[:, None], K[:, None])[0][:, 0]
    bx, by = tsm.nearest_taps(p_pix, 32, 32, 32, 32)

    @jax.jit
    def jax_taps(R, v, p):
        K = jnp.zeros((len(Rt), 3, 3)).at[:, 0, 0].set(1000.0)
        K = K.at[:, 1, 1].set(1000.0).at[:, 0, 2].set(16.0)
        K = K.at[:, 1, 2].set(16.0).at[:, 2, 2].set(1.0)
        v_pix = jgeom.project_points_multi(v, R[:, None], K[:, None])[0][:, 0]
        ratio = 1.02 * (v_pix - 16.0) / 16.0
        fit = 1000.0 / jnp.clip(jnp.max(jnp.abs(ratio), axis=(1, 2)),
                                min=1e-6)
        K = K.at[:, 0, 0].set(fit).at[:, 1, 1].set(fit)
        pts = p.transpose(0, 2, 3, 1).reshape(len(Rt), -1, 3)
        vp = jgeom.project_points_multi(pts, R[:, None], K[:, None])[0][:, 0]
        vp = vp.reshape(len(Rt), 32, 32, 2)
        vx = (vp[..., 0] - 32 / 2.0 - 0.5) / (32 / 2.0)
        vy = (vp[..., 1] - 32 / 2.0 - 0.5) / (32 / 2.0)
        return (jnp.round((vx + 1.0) * 32 * 0.5 - 0.5).astype(jnp.int32),
                jnp.round((vy + 1.0) * 32 * 0.5 - 0.5).astype(jnp.int32), K)

    jbx, jby, jK = jax_taps(*args[:3])
    close_to_scale(K.numpy(), jK)
    flipped = (bx.numpy() != np.asarray(jbx)) | (by.numpy() != np.asarray(jby))
    assert int(flipped.sum()) == 0
    inside = (bx >= 0) & (bx < 32) & (by >= 0) & (by < 32)
    assert float(inside.float().mean()) > 0.5

    # the depth compare, the tap validity and the backface blend: texels in
    # a light's shadow, lit ones, and culled ones (1e3) all occur
    close_to_scale(got.numpy(), ref, err_msg="shadow map")
    r = np.asarray(ref)
    assert (r < 1.0).any() and (r > 1.0).any() and (r > 900.0).any()
    no_cull = tsm.get_shadow_map(trl, Rt, None, verts, postex)
    ref_nc = jsm.get_shadow_map(jrl, args[0], None, *args[1:3])
    close_to_scale(no_cull.numpy(), ref_nc, err_msg="shadow map, no cull")
    assert float(no_cull.max()) > 1.0   # some texels are shadowed


def test_decoder_matches_jax(both):
    """ConvTeacherDecoder alone, on the inputs the port's forward handed it,
    with params['params']['decoder_relight'] converted."""
    jm, tm, params = both["jm"], both["tm"], both["params"]
    args = both["dec_args"]
    dec = ju.ConvTeacherDecoder(
        geo_fn=jm.module.geo_fn, raw_index_mask=jm.module.raw_index_mask,
        shadow_rl=jm.module.shadow_rl,
        **dict(jm.module.relight_cfg))
    jargs = [jnp.asarray(a.numpy()) for a in args[:7]]
    ref = jax.jit(lambda p, *a: dec.apply({"params": p}, *a, train=False))(
        params["params"]["decoder_relight"], *jargs)
    tdec = tm.module.decoder_relight
    tdec.load_state_dict(params_from_jax(jax.device_get(
        params["params"]["decoder_relight"])), strict=True)
    seen = []
    orig = tu.xyz2normals
    tu.xyz2normals = lambda x: seen.append(x) or orig(x)
    try:
        with torch.no_grad(), TileCounts() as counts:
            got = tdec(*args[:7], train=False)
    finally:
        tu.xyz2normals = orig
    counts.assert_inside_windows(2 * len(jargs[5].reshape(-1, 3)))
    assert set(DECODER_KEYS) <= set(got)
    assert set(got) == set(ref)
    # the displaced normal's allowance; the outputs that follow it texel by
    # texel are held where it is within the usual tolerance
    n_allow = normal_allowance(seen[0])
    well = n_allow <= RTOL
    assert 0.8 < well.mean() < 1.0   # the fixture has ill-conditioned texels
    # the shadow maps and the features summed from them over the lights
    # (diff <= 1, spec <= 10 a unit of light intensity) by the depth rule
    li = args[6].numpy()[..., None, None]                # [B, L, 1, 1, 1]
    light_range = float((got["verts_displaced"][:, None]
                         - args[5][:, :, None]).norm(dim=-1).max())
    allowances = {k: shadow_allowance(ref[k], light_range)
                  for k in ("shadow", "shadow_raw")}
    for k, src, gain in (("diff_feature", "shadow", 1.0),
                         ("diff_feature_raw", "shadow_raw", 1.0),
                         ("spec_feature", "shadow", 10.0),
                         ("spec_feature_raw", "shadow_raw", 1.0)):
        a = gain * (li * allowances[src]).sum(1) / (li.sum(1) + 1e-6)
        allowances[k] = a if k.startswith("diff") else a[:, None]
    for k in sorted(ref):
        if k == "interm_features2reg":
            assert len(got[k]) == len(ref[k]) == 4
            for i, (g, r) in enumerate(zip(got[k], ref[k])):
                close_to_scale(g.numpy(), r, err_msg=f"{k}[{i}]")
            continue
        assert tuple(got[k].shape) == ref[k].shape, k
        g, r = got[k].numpy(), np.asarray(ref[k])
        if k == "feature_normal":
            depth_rule_close(g, r, n_allow[:, None], err_msg=k)
            continue
        if k == "id_pose_conv":
            # its last 3 channels: the view direction in the displaced TBN
            # frame (t and b are cross products with the normal, so each
            # moves by up to twice its allowance), bilinearly resampled
            a = interpolate_bilinear(torch.from_numpy(n_allow[:, None]),
                                     size=tuple(g.shape[2:])).numpy()
            allow = np.zeros_like(g)
            allow[:, -3:] = 5.0 * a
            depth_rule_close(g, r, allow, err_msg=k)
            continue
        if k in NORMAL_DEPENDENT:
            keep = well.reshape((len(well),) + (1,) * (g.ndim - 3)
                                + well.shape[1:])
            g, r = g * keep, r * keep
        if k in allowances:
            depth_rule_close(g, r, allowances[k], err_msg=k)
        else:
            close_to_scale(g, r, err_msg=k)
    # the shadow maps carry signal: partly shadowed texels in every view
    sh = got["shadow"].numpy()
    assert ((sh > 1e-3) & (sh < 0.99)).mean(axis=(2, 3, 4)).min() > 0.01
    # the displaced geometry's normal is flipped, and the phys branch lit
    assert float(got["phys_tex"].abs().max()) > 0


def _index_images(both):
    """The port's and the JAX package's face index images of the render of
    ``geom`` (the displaced mesh) in the batch's cameras."""
    batch, jm, tm = both["batch"], both["jm"], both["tm"]
    K, Rt = batch["K"], batch["Rt"]
    geom = both["got"]["geom"]
    j_vp = np.asarray(jr.transform(jnp.asarray(both["ref"]["geom"]),
                                   jnp.asarray(K), jnp.asarray(Rt)))
    t_vp = tr.transform(geom, _t(K), _t(Rt))
    kw = dict(max_faces_per_tile=RENDER_MAX_FACES, chunk=16)
    vi = jnp.asarray(jm.module.geo_fn.vi)
    j_idx = np.stack([np.asarray(jax.jit(lambda x: jr.rasterize(
        x, vi, 48, 48, **kw))(jnp.asarray(v))) for v in j_vp])
    t_idx = np.stack([tr.rasterize(v, tm.geo_fn.vi, 48, 48, **kw).numpy()
                      for v in t_vp])
    return j_idx, t_idx


def test_urhand_forward_matches_jax(both):
    ref, got = both["ref"], both["got"]
    # 2 shadow passes x B x L light views and 3 renders a sample, each
    # inside its z-buffer window
    B, L = both["batch"]["light_pos"].shape[:2]
    both["counts"].assert_inside_windows(2 * B * L + 3 * B)
    assert set(got) == set(ref)
    j_idx, t_idx = _index_images(both)
    np.testing.assert_array_equal(t_idx == -1, j_idx == -1)
    covered = t_idx != -1
    assert covered.mean() > 0.2
    assert (t_idx == j_idx)[covered].mean() >= 0.999
    agree = (t_idx == j_idx)[:, None]
    for k in ("rendered_phys_rgb", "alpha", "normals", "depth", "rgb",
              "rendered_rgb", "rendered_mask"):
        assert tuple(got[k].shape) == ref[k].shape, k
        g, r = got[k].numpy() * agree, np.asarray(ref[k]) * agree
        if k == "depth":
            np.testing.assert_allclose(g, r, rtol=5e-4)
        elif k in ("rendered_phys_rgb", "rgb", "rendered_rgb"):
            close_to_scale(g, r, of_scale=TEX_OF_SCALE, err_msg=k)
        else:
            close_to_scale(g, r, err_msg=k)
    for k in ("tex_rec", "texrec_before_warp"):
        close_to_scale(got[k].numpy(), ref[k], of_scale=TEX_OF_SCALE,
                       err_msg=k)
    for k in ("geom", "displacement", "roughness"):
        close_to_scale(got[k].numpy(), ref[k], err_msg=k)
    for i, (g, r) in enumerate(zip(got["interm_features2reg"],
                                   ref["interm_features2reg"])):
        close_to_scale(g.numpy(), r, err_msg=f"interm_features2reg[{i}]")
    # outputs that carry signal (the random-weight texture is near black)
    assert float(np.abs(np.asarray(ref["rendered_phys_rgb"])).mean()) > 0.5
    r = np.asarray(got["roughness"])
    assert r.min() >= 0.3 - 1e-5 and r.max() <= 0.8 + 1e-5


def test_urhand_names_and_summary(both):
    """The config's class names load the port's; the flax parameter names;
    the host-side summary."""
    from goliath_torch.config import load_class

    tm, got, batch = both["tm"], both["got"], both["batch"]
    assert load_class("goliath_tpu.models.urhand.AutoEncoder") \
        is tu.AutoEncoder
    assert load_class("goliath_tpu.models.urhand.URHandSummary") \
        is tu.URHandSummary
    names = set(tm.module.state_dict())
    assert {"decoder_relight.geo_refiner.enc0.weight_v",
            "decoder_relight.geo_refiner.rough2.bias",
            "decoder_relight.featenc.gb3.weight_g",
            "decoder_relight.featenc.enc.bias",
            "decoder_relight.joint_conv_block_tex.conv_resize.weight_v",
            "decoder_relight.texmod1_4.weight_v",
            "decoder_relight.global_albedo_scale",
            "decoder_relight.global_scale", "cal.cal_params"} <= names
    assert "decoder_relight.featenc.proj.bias" not in names
    summary = tu.URHandSummary()(got, to_device(batch, torch.device("cpu")))
    ref = ju.URHandSummary()(both["ref"], batch)
    assert set(summary) == set(ref) == {"render", "phys", "normals", "gt"}
    for k in ref:
        np.testing.assert_allclose(summary[k], ref[k], atol=2e-3, err_msg=k)
