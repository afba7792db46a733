"""Shared inputs of the drivable mesh-VAE parity tests
(tests/test_torch_mesh_vae_drivable*.py, tests/test_torch_face.py): the
model sizes of tests/test_mesh_vae_drivable.py, the synthetic fixture with
the jittered template of tests/test_torch_mesh_vae.py, the batch with the
drivable model's input keys beside its own, and the JAX parameter tree
filled from the port's initialization. Not a test module: pytest does not
collect it.
"""

from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import torch

from goliath_tpu.data.synthetic import SyntheticDataset
from tests.test_torch_mesh_vae import jitter_template

IMG = 32
N_FACE_CODE = 8


def model_kw(ds, noise_std=None, pose_to_shadow=True):
    """tests/test_mesh_vae_drivable.py's model (uv 64, tex 128, the face
    decoder at 32^2 on 16 face vertices), with PoseToShadow unless
    ``pose_to_shadow`` is false and both encoders at ``noise_std`` when it
    is given."""
    kw = dict(
        encoder={"n_embs": 16, "enc_size": 64},
        encoder_face={"n_embs": 8, "uv_size": 32, "n_vert_in": 3 * 16},
        decoder_face={"n_latent": N_FACE_CODE, "n_vert_out": 3 * 16,
                      "tex_out_shp": (32, 32)},
        decoder={"init_uv_size": 16, "n_pose_dims": 6,
                 "n_pose_enc_channels": 8, "n_embs": 16,
                 "n_embs_enc_channels": 8, "n_face_embs": 8,
                 "n_init_channels": 16, "n_min_channels": 4},
        decoder_view={"net_uv_size": 64, "n_init_ftrs": 4},
        shadow_net={"uv_size": 128, "shadow_size": 32, "n_dims": 8},
        upscale_net={"n_ftrs": 4},
        assets=ds.static_assets,
        renderer={"image_height": IMG, "image_width": IMG,
                  "max_faces_per_tile": 128, "chunk": 16},
        pixel_cal={"image_height": IMG, "image_width": IMG, "ds_rate": 8},
        cal={"identity_camera": ds.static_assets.camera_ids[0]},
        learn_blur=True, uv_size=64, tex_size=128)
    if pose_to_shadow:
        kw["pose_to_shadow"] = {"n_pose_dims": 12, "uv_size": 128}
    if noise_std is not None:
        for k in ("encoder", "encoder_face"):
            kw[k] = dict(kw[k], noise_std=noise_std)
    return kw


def dataset():
    return jitter_template(SyntheticDataset(
        n_cams=2, n_frames=2, img_h=IMG, img_w=IMG, uv_size=64, seed=6))


def drivable_batch(ds, batch_size=2, seed=0):
    """The fixture's first batch (string fields dropped) with the drivable
    keys beside its own: lbs_motion = pose, geom = registration_vertices,
    ao = ambient_occlusion, and a seeded [B, 8] face code."""
    batch = next(ds.batches(batch_size, 1))
    batch = {k: v for k, v in batch.items() if not isinstance(v, list)}
    batch["lbs_motion"] = batch["pose"]
    batch["geom"] = batch["registration_vertices"]
    batch["ao"] = batch["ambient_occlusion"]
    batch["face_embs"] = np.random.RandomState(seed).randn(
        batch_size, N_FACE_CODE).astype(np.float32)
    return batch


def jax_tree(shapes: Mapping, state: Mapping[str, torch.Tensor]):
    """The flax parameter tree of ``shapes`` (``jax.eval_shape`` of the JAX
    model's init) filled from the port's ``state_dict``, whose keys join
    the tree's path with dots."""
    def fill(node, prefix):
        return {k: fill(v, f"{prefix}{k}.") if isinstance(v, Mapping)
                else jnp.asarray(state[prefix + k].numpy().reshape(v.shape))
                for k, v in node.items()}

    return {"params": fill(shapes["params"], "")}


def jax_params(jm, jb, state):
    """The JAX model's parameters: its init's tree shapes, the port's
    values."""
    return jax_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb),
                    state)
