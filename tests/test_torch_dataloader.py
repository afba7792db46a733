"""The port's capture layer against the JAX package's on the CPU: the native
zip reader (the port's own copy, built under build/) against Python
``zipfile``; ``load_ply``; ``load_momentum_cfg``; and ``BodyDataset`` on
fake Head, Hands and Body captures written by ``tests/goliath_capture.py``
(every ``__getitem__`` sample, the None drops included, the frame lists,
the static assets and each capture type's batch filter on a collated
batch; the samples again from 16 threads at once; ``unpack_dataset``'s
files against ``zipfile``), all bit for bit: both packages run the same numpy operations on the
same bytes, so no tolerance is allowed anywhere in this file.
"""

import io
import struct
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goliath_capture import CaptureSpec, write_capture, write_shared_assets
from goliath_torch.data import dataloader as t_dl
from goliath_torch.data.pipeline import collate as t_collate
from goliath_torch.data.synthetic import (
    SyntheticDataset,
    make_camera_ring,
    make_synthetic_lbs,
)
from goliath_torch.native import zipio as t_zipio
from goliath_torch.scripts import unpack_dataset
from goliath_torch.test import to_device
from goliath_torch.utils.lbs import load_momentum_cfg as t_load_cfg
from goliath_torch.utils.ply import load_ply as t_load_ply
from goliath_tpu.data import dataloader as j_dl
from goliath_tpu.data.pipeline import collate as j_collate
from goliath_tpu.utils.lbs import load_momentum_cfg as j_load_cfg
from goliath_tpu.utils.ply import load_ply as j_load_ply, save_ply

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def same(a, b, where="sample"):
    """Equal in type, dtype, shape and every bit (NaN equal to NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, type(a)), (where, type(a), type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# -- the native zip reader -------------------------------------------------


@pytest.fixture(scope="module")
def sample_zip(tmp_path_factory):
    p = tmp_path_factory.mktemp("zips") / "sample.zip"
    rng = np.random.RandomState(0)
    members = {
        "cam001/000001.bin": rng.bytes(100_000),
        "cam001/000002.bin": b"\x00" * 250_000,
        "meta/info.json": b'{"a": 1}',
        "stored.bin": rng.bytes(4096),
        "empty.txt": b"",
    }
    with zipfile.ZipFile(p, "w") as zf:
        for name, data in members.items():
            kind = (zipfile.ZIP_STORED if name in ("stored.bin", "empty.txt")
                    else zipfile.ZIP_DEFLATED)
            zf.writestr(zipfile.ZipInfo(name), data, compress_type=kind)
    return p, members


def test_native_reader_matches_zipfile(sample_zip):
    p, members = sample_zip
    assert t_zipio.have_native(), t_zipio.build_error()
    assert t_zipio.build_error() is None
    assert t_zipio.reader_name().startswith("native")
    # built under build/, beside neither package's sources
    assert t_zipio.SO_PATH.is_file()
    assert t_zipio.SO_PATH.parent == ROOT / "build" / "zipio"
    assert not (ROOT / "goliath_torch" / "native" / "libzipio.so").exists()
    z = t_zipio.NativeZip(p)
    with zipfile.ZipFile(p) as zf:
        assert z.namelist() == zf.namelist()
        for info in zf.infolist():
            assert z.size(info.filename) == info.file_size
            assert z.exists(info.filename)
            assert z.read(info.filename) == zf.read(info.filename)
        assert {i.compress_type for i in zf.infolist()} == {
            zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED}
        with pytest.raises(KeyError):
            zf.read("missing/file.bin")
    assert not z.exists("missing/file.bin")
    with pytest.raises(KeyError):
        z.read("missing/file.bin")
    pairs = [(str(p), name) for name in members] * 3
    assert t_zipio.read_many(pairs, nthreads=4) == [
        members[m] for _, m in pairs]
    assert t_zipio.read_many([(str(p), "missing/file.bin")]) == [None]
    assert t_zipio.open_cached(p) is t_zipio.open_cached(str(p))


# -- PLY --------------------------------------------------------------------


def _ply_files(tmp_path):
    rng = np.random.RandomState(1)
    v = rng.randn(11, 3).astype(np.float32)
    f = rng.randint(0, 11, (7, 3))
    le = tmp_path / "le.ply"
    save_ply(str(le), v, f)
    header = ("ply\nformat {} 1.0\ncomment made by a test\n"
              "element vertex 11\nproperty float x\nproperty float y\n"
              "property float z\nproperty uchar red\nelement face 7\n"
              "property list {} {} vertex_indices\nend_header\n")
    asc = tmp_path / "ascii.ply"
    asc.write_text(header.format("ascii", "uchar", "int") + "".join(
        f"{x!r} {y!r} {z!r} 7\n" for x, y, z in v.tolist()) + "".join(
        f"3 {a} {b} {c}\n" for a, b, c in f.tolist()))
    be = tmp_path / "be.ply"
    with open(be, "wb") as fh:
        fh.write(header.format("binary_big_endian", "uchar",
                               "uint").encode())
        for row in v:
            fh.write(row.astype(">f4").tobytes() + b"\x07")
        for row in f:
            fh.write(struct.pack(">B", 3) + row.astype(">u4").tobytes())
    return v, f, [le, asc, be]


def test_load_ply_matches_jax(tmp_path):
    v, f, paths = _ply_files(tmp_path)
    for path in paths:
        got = t_load_ply(str(path))
        ref = j_load_ply(str(path))
        same(got, ref, path.name)
        np.testing.assert_array_equal(got[0], v)
        np.testing.assert_array_equal(got[1], f)
        # a file object reads as the path does (the dataset reads members)
        same(t_load_ply(io.BytesIO(path.read_bytes())), got, path.name)


# -- the momentum .cfg parser -------------------------------------------------

MOMENTUM_CFG = """\
# parameter transform of a three-joint chain
root.tx = 1.0 * root_tx
root.ty = 1.0 * root_ty  # trailing comment
root.rx = 1.0 * root_rx + 0.5 * spine_rx
joint1.rx = -2 * spine_rx + 1 * joint1_rx
joint2.sc = 1.0 * scale_global
joint2.sc = 0.25 * scale_hand
nobody.tx = 1.0 * ignored
parameterset fingers joint1_rx spine_rx
limit root_tx minmax [-1.0, 1.0] 2.0
limit joint1.rx minmax_passive [-0.5, .5]
limit spine_rx minmax [ -0.2 , 0.3 ]
limit scale_hand minmax [0, 1] 0.1
limit unknown minmax [0, 1]
limit root_ty ellipsoid [0, 1]
"""


def test_load_momentum_cfg_matches_jax():
    model = {"Skeleton": {"Bones": [{"Name": n}
                                    for n in ("root", "joint1", "joint2")]}}
    for nr in (None, 1):
        got = t_load_cfg(model, io.StringIO(MOMENTUM_CFG),
                         nr_scaling_params=nr)
        ref = j_load_cfg(model, io.StringIO(MOMENTUM_CFG),
                         nr_scaling_params=nr)
        same(got, ref, f"cfg (nr_scaling_params={nr})")
    assert got["model_param_names"] == [
        "root_tx", "root_ty", "root_rx", "spine_rx", "joint1_rx",
        "scale_global", "scale_hand"]
    assert [lim["str"] for lim in got["limits"]] == [
        "root_tx", "joint1.rx", "spine_rx", "scale_hand"]
    assert got["transform"][7 + 3, 3] == -2.0
    assert got["transform"][14 + 6, 6] == 0.25


# -- BodyDataset ------------------------------------------------------------------


def _sphere_assets(seed):
    ds = SyntheticDataset(n_cams=1, n_frames=1, img_h=32, img_w=32,
                          uv_size=16, seed=seed, device="cpu")
    return ds.static_assets


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    """A Head, a Hands and a Body capture, each with members left out."""
    base = tmp_path_factory.mktemp("captures")
    a = _sphere_assets(0)
    cams = ["400000", "400001", "400002"]
    K, Rt, _ = make_camera_ring(3, 40, 32)
    v = np.asarray(a["verts_mean"])
    topo = {k: np.asarray(x) for k, x in a["topology"].items()}
    out = {}
    out["Head"] = (write_capture(base, "m--test--Head", CaptureSpec(
        kind="Head", cameras=cams, K=K, Rt=Rt, frames=list(range(10, 17)),
        test_frames=[15, 16], template=v, image_hw=(40, 32), uv_size=16,
        color_mean=a["color_mean"], seg_half=True, background_hw=(24, 20),
        n_light_positions=9,
        pattern_of_frame={10: 0, 11: 1, 12: 0, 13: 2, 14: 0, 15: 0, 16: 1},
        light_patterns=[[[0, 5555]], [[i, 5555] for i in range(1, 6)],
                        [[i, 2222] for i in range(4, 9)]],
        missing=[("segmentation_parts", 12, "400001"),
                 ("color", 13, None), ("image", 16, "400002")])),
        write_shared_assets(base / "shared" / "static_assets_head.pt",
                            {"topology": topo}))
    lbs_json, lbs_cfg = make_synthetic_lbs(v, topo["vi"], topo["vt"],
                                           topo["vti"])
    out["Hands"] = (write_capture(base, "m--test--Hands--left", CaptureSpec(
        kind="Hands", cameras=cams[:2], K=K[:2], Rt=Rt[:2],
        frames=list(range(6)), test_frames=[5], template=v,
        faces=topo["vi"], image_hw=(40, 32), uv_size=16, seed=1,
        missing=[("pose", 3, None), ("segmentation_fgbg", 0, "400001")])),
        write_shared_assets(base / "shared" / "static_assets_hand_left.pt", {
            "topology": topo, "lbs_model_json": lbs_json,
            "lbs_config_dict": lbs_cfg}))
    out["Body"] = (write_capture(base, "m--test--Body", CaptureSpec(
        kind="Body", cameras=cams[:2], K=K[:2], Rt=Rt[:2],
        frames=[3, 4, 5, 6], test_frames=[6], template=v, faces=topo["vi"],
        image_hw=(40, 32), uv_size=16, color_mean=a["color_mean"], seed=2,
        missing=[("ambient_occlusion", 4, None)])),
        write_shared_assets(base / "shared" / "static_assets_body.pt",
                            {"topology": topo}))
    return out


# (capture, split, dataset options, samples expected to be dropped)
CASES = [
    ("Head", "train", {"fully_lit_only": False}, 3 + 1),
    ("Head", "train", {"fully_lit_only": True}, 1),
    ("Head", "test", {"fully_lit_only": False,
                      "cameras_subset": ["400001", "400002"]}, 1),
    ("Hands", "train", {"fully_lit_only": False,
                        "partially_lit_only": True}, 2),
    ("Hands", "train", {"fully_lit_only": True}, 1),
    ("Body", "train", {"frames_subset": [3, 4, 6]}, 2),
]


def _pair(captures, kind, split, opts):
    root, shared = captures[kind]
    kw = dict(root_path=str(root), shared_assets_path=str(shared),
              split=split, **opts)
    return t_dl.BodyDataset(**kw), j_dl.BodyDataset(**kw)


@pytest.mark.parametrize("kind,split,opts,dropped", CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}" for i, c in
                              enumerate(CASES)])
def test_body_dataset_matches_jax(captures, kind, split, opts, dropped):
    got, ref = _pair(captures, kind, split, opts)
    assert got.capture_type.name == ref.capture_type.name
    assert len(got) == len(ref) > 0
    assert got.get_camera_list() == ref.get_camera_list()
    for lit in ({}, {"fully_lit_only": True}, {"partially_lit_only": True}):
        same(got.get_frame_list(**lit), ref.get_frame_list(**lit))
    t_samples = [got[i] for i in range(len(got))]
    j_samples = [ref[i] for i in range(len(ref))]
    assert sum(s is None for s in t_samples) == dropped
    for i, (s, r) in enumerate(zip(t_samples, j_samples)):
        assert (s is None) == (r is None), i
        if s is not None:
            same(s, r, f"{kind} sample {i}")
    same(dict(got.static_assets), dict(ref.static_assets), "static_assets")
    kept = [s for s in t_samples if s is not None]
    batch = t_collate(kept[:3])
    same(batch, j_collate([s for s in j_samples if s is not None][:3]))
    same(got.batch_filter(batch), ref.batch_filter(batch), "filtered")
    if kind == "Head":
        # segmentation at half size, repeated; background of another size,
        # area-resized; the images scaled to [0, 1] by the filter
        assert kept[0]["segmentation_parts"].shape == (1, 40, 32)
        assert kept[0]["background"].shape == (3, 40, 32)
        assert got.batch_filter(batch)["image"].max() <= 1.0
    elif "keypoints_3d" in kept[0]:
        # parsed JSON, which stacks into an object array: both harnesses
        # refuse the batch where they move it to the device (ROADMAP
        # queue 3)
        assert isinstance(kept[0]["keypoints_3d"], dict)
        assert batch["keypoints_3d"].dtype == object
        with pytest.raises(TypeError):
            jnp.asarray(batch["keypoints_3d"])
        with pytest.raises(TypeError):
            to_device(got.batch_filter(batch), torch.device("cpu"))


def test_zipfile_fallback_reads_the_same_samples(captures, monkeypatch):
    """Where the native core cannot be built the dataset reads through
    ``zipfile``: the same samples."""
    got, ref = _pair(captures, "Head", "train", {"fully_lit_only": False})
    native = [got[i] for i in range(len(got))]
    monkeypatch.setattr(t_zipio, "have_native", lambda: False)
    fresh, _ = _pair(captures, "Head", "train", {"fully_lit_only": False})
    for i, s in enumerate(native):
        r = fresh[i]
        assert (s is None) == (r is None), i
        if s is not None:
            same(s, r, f"zipfile sample {i}")


def test_loader_threads_read_the_same_samples(captures):
    """16 threads (more than this machine's cores) read one fresh dataset at
    once, sharing its caches and the zip handles, with a short switch
    interval: every sample equals the one read alone."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    got, _ = _pair(captures, "Head", "train", {"fully_lit_only": False})
    alone = [got[i] for i in range(len(got))]
    fresh, _ = _pair(captures, "Head", "train", {"fully_lit_only": False})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            futures = [ex.submit(fresh.__getitem__, i)
                       for i in list(range(len(fresh))) * 4]
            results = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    for i, r in enumerate(results):
        s = alone[i % len(alone)]
        assert (s is None) == (r is None), i
        if s is not None:
            same(r, s, f"threaded sample {i}")


def test_unpack_dataset_extracts_every_zip(captures, tmp_path):
    root, _ = captures["Hands"]
    unpack_dataset.main([str(root), str(tmp_path), "--workers", "2"])
    zips = sorted(root.glob("*/*.zip"))
    assert zips
    for z in zips:
        with zipfile.ZipFile(z) as zf:
            for name in zf.namelist():
                out = tmp_path / z.parent.name / name
                assert out.read_bytes() == zf.read(name), out
