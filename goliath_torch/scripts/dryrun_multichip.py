"""The port's multi-shard dry run (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): one data-parallel training step for
each model family at tiny shapes, and the tile axis of the render on a 2-D
("data", "tile") mesh held against the unsharded render.

    python -m goliath_torch.scripts.dryrun_multichip [n_shards] [--device cpu]

The JAX dry run runs on n virtual CPU devices. Here the n shards lie on the
first min(n, count) visible cards in turn (``shard_devices``; as the JAX
``make_mesh(n)`` takes the first n devices), so on one card all n repeat
it, or all on the host when ``--device cpu`` asks for it
(``parallel.sharding.Mesh``); the model lives on the first. Each family
takes one step of
``make_sharded_train_step`` at batch max(n, 2) with the JAX entry's loss
terms (rgb_l1 x 10; RGCA also geom_l2, kl and learn_blur) and Adam at
lr 1e-3, and must give a finite loss.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from goliath_torch.data.synthetic import SyntheticDataset
from goliath_torch.losses import ModularLoss
from goliath_torch.ops import gsplat
from goliath_torch.ops.backend import resolve_device
from goliath_torch.optim import build_optimizer
from goliath_torch.parallel import make_sharded_train_step
from goliath_torch.parallel.sharding import Mesh
from goliath_torch.parallel.tile_shard import render_tile_sharded

FAMILIES = ("rgca", "hand_mvp", "hand_teacher", "urhand", "mesh_vae")
# the tile axis' scene (__graft_entry__._dryrun_tile_axis)
TILE_AXIS = dict(B=2, N=256, H=64, W=48,
                 render=dict(tile_size=16, max_pairs_per_tile=128, chunk=32,
                             pair_budget_mult=8))


def first_batch(ds, batch_size: int) -> Dict[str, np.ndarray]:
    """The JAX fixture's first ``batches(batch_size, 1)`` batch: samples
    0..batch_size-1 in its order (frame fastest), strings dropped."""
    samples = []
    for idx in range(batch_size):
        frame = idx % ds.n_frames
        cam = (idx // ds.n_frames) % len(ds.camera_ids)
        samples.append(ds.get(frame, cam))
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]
            if not isinstance(samples[0][k], str)}


def build_rgca(img: int, uv: int, n_cams: int, batch: int,
               device: torch.device, seed: int = 0):
    """(dataset, model, batch) of ``__graft_entry__._build``: the RGCA model
    with noise, calibration and learnable blur at ``img`` x ``img``."""
    from goliath_torch.models.rgca import AutoEncoder

    ds = SyntheticDataset(n_cams=n_cams, n_frames=max(batch, 2), img_h=img,
                          img_w=img, uv_size=uv, seed=seed)
    model = AutoEncoder(
        encoder={"noise_std": 1.0}, decoder={"n_color_sh": 1},
        assets=ds.static_assets, image_height=img, image_width=img,
        cal={"identity_camera": ds.static_assets.camera_ids[0]},
        n_embs=16, n_diff_sh=2, learn_blur=True, uv_size=uv,
        render={"max_pairs_per_tile": 256, "chunk": 32}, device=device)
    return ds, model, first_batch(ds, batch)


def build_other(name: str, batch: int, device: torch.device):
    """(dataset, model, batch) of ``__graft_entry__._build_other``: the
    other families at 48 x 48."""
    if name == "urhand":
        from goliath_torch.models.urhand import AutoEncoder

        ds = SyntheticDataset(n_cams=2, n_frames=max(batch, 2), img_h=48,
                              img_w=48, uv_size=32, n_lights=2, seed=4)
        model = AutoEncoder(
            assets=ds.static_assets,
            cal={"identity_camera": ds.static_assets.camera_ids[0]},
            renderer={"image_height": 48, "image_width": 48,
                      "max_faces_per_tile": 128, "chunk": 16},
            relight={"uv_size": 32, "init_uv_size": 8, "pose_enc_dims": 12,
                     "disp_enc_dims": (8, 8, 8), "disp_scale": 0.3,
                     "init_channels": 16},
            global_scaling=1.0, shadow_size=32, device=device)
    elif name == "mesh_vae":
        from goliath_torch.models.mesh_vae import AutoEncoder

        ds = SyntheticDataset(n_cams=2, n_frames=max(batch, 2), img_h=48,
                              img_w=48, uv_size=64, seed=2)
        model = AutoEncoder(
            encoder={"n_embs": 16, "enc_size": 64},
            encoder_face={"n_embs": 8, "enc_size": 32},
            decoder={"init_uv_size": 16, "n_pose_dims": 6,
                     "n_pose_enc_channels": 8, "n_embs": 16,
                     "n_embs_enc_channels": 8, "n_face_embs": 8,
                     "n_init_channels": 16, "n_min_channels": 4},
            decoder_view={"net_uv_size": 64, "n_init_ftrs": 4},
            shadow_net={"uv_size": 128, "shadow_size": 16, "n_dims": 8},
            upscale_net={"n_ftrs": 4},
            assets=ds.static_assets,
            pose_to_shadow={"n_pose_dims": 12, "uv_size": 128},
            renderer={"image_height": 48, "image_width": 48,
                      "max_faces_per_tile": 128, "chunk": 16},
            cal={"identity_camera": ds.static_assets.camera_ids[0]},
            pixel_cal={"image_height": 48, "image_width": 48, "ds_rate": 8},
            learn_blur=True, uv_size=64, tex_size=128, device=device)
    elif name in ("hand_mvp", "hand_teacher"):
        from goliath_torch.models.hand_mvp import AutoEncoder as HandMVP
        from goliath_torch.models.hand_teacher_mvp import (
            AutoEncoder as HandTeacher,
        )

        ds = SyntheticDataset(n_cams=2, n_frames=max(batch, 2), img_h=48,
                              img_w=48, uv_size=32, n_lights=2, seed=5)
        cls = HandTeacher if name == "hand_teacher" else HandMVP
        model = cls(
            assets=ds.static_assets, image_height=48, image_width=48,
            cal={"identity_camera": ds.static_assets.camera_ids[0]},
            n_pose_dims=6, n_embs=8, volradius=400.0, primsize=(8, 8, 4),
            uv_size=32, prim_scale=12.0, global_scaling=1.0,
            raymarcher={"dt": 4.0, "max_steps": 32,
                        "max_prims_per_tile": 32, "chunk": 8},
            device=device)
    else:
        raise ValueError(name)
    return ds, model, first_batch(ds, batch)


def build_family(name: str, batch: int, device: torch.device):
    if name == "rgca":
        return build_rgca(img=48, uv=32, n_cams=2, batch=batch,
                          device=device)
    return build_other(name, batch, device)


def family_loss_and_optimizer(name: str, ds, model):
    """The JAX dry run's loss terms and optimizer for ``name``."""
    terms: Dict[str, Any] = {
        "rgb_l1": {"src_key": "rgb", "tgt_key": "image",
                   "mask_key": "image_weight", "weight": 10.0},
    }
    opt_cfg: Dict[str, Any] = {"class_name": "torch.optim.Adam", "lr": 1e-3}
    if name == "rgca":
        terms.update({"geom_l2": 0.4, "kl": 0.002, "learn_blur": 0.001})
        opt_cfg["per_module"] = {"encoder": {"lr": 1e-3},
                                 "decoder": {"lr": 1e-3}}
    return (ModularLoss(terms, assets=ds.static_assets),
            build_optimizer(opt_cfg, model.module))


def shard_devices(n_shards: int, device: torch.device
                  ) -> List[torch.device]:
    """The devices of ``n_shards`` shards: on the card, the first
    min(n_shards, count) visible cards in turn; on the host, the CPU n
    times."""
    if device.type != "cuda":
        return [device] * n_shards
    k = min(n_shards, torch.cuda.device_count())
    return [torch.device("cuda", i % k) for i in range(n_shards)]


def dryrun_one(name: str, n_shards: int, device: torch.device) -> float:
    """One sharded step of family ``name`` on a "data" mesh of
    ``n_shards`` shards (``shard_devices``), the model on the first shard's
    device; returns its finite loss."""
    devices = shard_devices(n_shards, device)
    ds, model, batch = build_family(name, max(n_shards, 2), devices[0])
    loss_fn, optimizer = family_loss_and_optimizer(name, ds, model)
    mesh = Mesh(devices, ("data",))
    step = make_sharded_train_step(model, loss_fn, optimizer, mesh)
    total, _ = step(batch, 0)
    loss = float(total)
    if not np.isfinite(loss):
        raise AssertionError(f"{name}: the sharded train step gave a "
                             f"non-finite loss {loss}")
    return loss


def tile_axis_scene(device: torch.device, seed: int = 2):
    """The tile axis' gaussians (the JAX dry run's distributions, drawn
    from a torch generator): positions in [-2, 2]^2 x [3, 9], unit
    quaternions, scales 0.05 exp(0.3 N), opacities sigmoid(N), grey
    colours, one camera of focal 60."""
    B, N, H, W = (TILE_AXIS[k] for k in ("B", "N", "H", "W"))
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((B, N, 3), generator=g) * 4.0 - 2.0
    pos[..., 2] = torch.rand((B, N), generator=g) * 6.0 + 3.0
    quat = torch.randn((B, N, 4), generator=g)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    scale = torch.exp(torch.randn((B, N, 3), generator=g) * 0.3) * 0.05
    op = torch.sigmoid(torch.randn((B, N, 1), generator=g))
    col = torch.full((B, N, 3), 0.5)
    K = torch.tensor([[[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]] * B)
    Rt = torch.eye(4)[:3].expand(B, 3, 4).contiguous()
    return [t.to(device) for t in (K, Rt, pos, quat, scale, op, col)]


def tile_axis_loss(mesh, scene, axis: str = "tile"):
    """The dry run's loss (mean render^2 + mean alpha) of the band render
    over ``mesh[axis]``, and its gradients with respect to pos, scale, op
    and col."""
    K, Rt, pos, quat, scale, op, col = scene
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (pos, scale, op, col)]
    H, W = TILE_AXIS["H"], TILE_AXIS["W"]
    r = render_tile_sharded(mesh, axis, W, H, K, Rt, leaves[0], quat,
                            *leaves[1:], **TILE_AXIS["render"])
    v = (r["render"] ** 2).mean() + r["alpha"].mean()
    grads = torch.autograd.grad(v, leaves)
    return float(v.detach()), grads


def dryrun_tile_axis(n_shards: int, device: torch.device
                     ) -> Tuple[float, float, Tuple[int, int]]:
    """The band render on a 2-D ("data", "tile") mesh of ``n_shards``
    shards (``shard_devices`` in row-major order; 4 bands when n divides by
    4, else 2), the scene on the first: its loss against the unsharded
    render's, within 1e-4 of max(1, |loss|), and finite gradients. Returns
    (loss, unsharded loss, (n_data, n_tile))."""
    n_tile = 4 if n_shards % 4 == 0 else 2
    n_data = n_shards // n_tile
    devices = shard_devices(n_shards, device)
    mesh = Mesh(np.asarray(devices, dtype=object).reshape(n_data, n_tile),
                ("data", "tile"))
    scene = tile_axis_scene(devices[0])
    v, grads = tile_axis_loss(mesh, scene)
    K, Rt, pos, quat, scale, op, col = scene
    with torch.no_grad():
        ref = gsplat.render(TILE_AXIS["W"], TILE_AXIS["H"], K, Rt, pos,
                            quat, scale, op, col, **TILE_AXIS["render"])
        v_ref = float((ref["render"] ** 2).mean() + ref["alpha"].mean())
    if abs(v - v_ref) >= 1e-4 * max(1.0, abs(v_ref)):
        raise AssertionError(f"tile-sharded loss {v} != unsharded {v_ref}")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("tile-sharded gradients are not finite")
    return v, v_ref, (n_data, n_tile)


def main(n_shards: int = 4, device: str | torch.device = "cuda"
         ) -> Dict[str, float]:
    """The dry run: RGCA, the tile axis, then the other families (the
    cheapest first, as the JAX dry run orders them). Returns each part's
    loss."""
    dev = resolve_device(device)
    t0 = time.time()
    print(f"dryrun_multichip({n_shards}): mesh devices "
          f"{[str(d) for d in shard_devices(n_shards, dev)]}", flush=True)
    losses = {}
    for name in ("rgca", "tile_axis") + FAMILIES[1:]:
        if name == "tile_axis":
            v, v_ref, (n_data, n_tile) = dryrun_tile_axis(n_shards, dev)
            losses[name] = v
            print(f"dryrun_multichip({n_shards})[tile-axis "
                  f"{n_data}x{n_tile}]: loss={v:.4f} OK (unsharded "
                  f"{v_ref:.4f})", flush=True)
        else:
            losses[name] = dryrun_one(name, n_shards, dev)
            print(f"dryrun_multichip({n_shards})[{name}]: "
                  f"loss={losses[name]:.4f} OK", flush=True)
        print(f"# dryrun [{name}] done at +{time.time() - t0:.0f}s",
              flush=True)
    print(f"dryrun_multichip({n_shards}) on {dev}: ALL MODELS OK",
          flush=True)
    return losses


if __name__ == "__main__":
    logging.basicConfig(level=logging.WARNING)
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_shards", type=int, nargs="?", default=4)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    main(args.n_shards, args.device)
