"""Momentum-format skeleton linear blend skinning (port of the JAX
package's utils/lbs.py:29-323).

The forward-kinematics solve composes joints level by level of the joint
tree (all joints of one depth in one batched quaternion product), as the
JAX package does, instead of one joint at a time. The per-joint state is
the 8-vector (tx ty tz | qx qy qz qw | scale); parameters are 7 channels
per joint (tx ty tz rx ry rz sc) from a sparse parameter transform.

Host-side tables (joint tree, skinning weights and indices, bind state)
are numpy; the ones the device math reads are kept on ``device`` (the card
unless ``device="cpu"``). ``load_momentum_cfg`` parses the momentum .cfg
text (the JAX package's utils/lbs.py:326-421) into the config dict.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from goliath_torch.ops.backend import resolve_device
from goliath_torch.utils import quaternion as quat


class ParameterTransform:
    """pose params -> per-joint 7-dof channels."""

    def __init__(self, lbs_cfg_dict: Dict[str, Any]):
        self.channel_names = list(lbs_cfg_dict["channel_names"])
        self.transform_offsets_np = np.asarray(
            lbs_cfg_dict["transform_offsets"], dtype=np.float32)
        self.transform_np = np.asarray(lbs_cfg_dict["transform"],
                                       dtype=np.float32)
        self.limits = lbs_cfg_dict.get("limits", [])
        self.nr_scaling_params = lbs_cfg_dict["nr_scaling_params"]
        self.nr_position_params = lbs_cfg_dict["nr_position_params"]
        self.nr_total_params = self.nr_scaling_params + self.nr_position_params
        self.to(torch.device("cpu"))

    def to(self, device: torch.device) -> "ParameterTransform":
        self.transform = torch.from_numpy(self.transform_np).to(device)
        self.transform_offsets = torch.from_numpy(
            self.transform_offsets_np).to(device)
        return self

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        # pose: [B, P] -> [B, 7*J]
        return pose @ self.transform.T + self.transform_offsets


def _levels_from_parents(parents: np.ndarray) -> List[np.ndarray]:
    """Group joint indices by depth; roots (parent -1) are level 0."""
    J = len(parents)
    depth = np.full(J, -1, dtype=np.int64)
    for j in range(J):
        d, k = 0, j
        while parents[k] != -1:
            k = int(parents[k])
            d += 1
            if d > J:
                raise ValueError("cycle in joint parents")
        depth[j] = d
    return [np.nonzero(depth == d)[0] for d in range(depth.max() + 1)]


def solve_skeleton_state(
    params: torch.Tensor,
    joint_offset: torch.Tensor,
    joint_rotation: torch.Tensor,
    joint_parents: np.ndarray,
    levels: Optional[List[np.ndarray]] = None,
) -> torch.Tensor:
    """FK: [B, 7J] channel params -> [B, J, 8] global joint states."""
    joint_parents = np.asarray(joint_parents).reshape(-1)
    if levels is None:
        levels = _levels_from_parents(joint_parents)
    B = params.shape[0]
    jp = params.reshape(B, -1, 7)
    lt = jp[:, :, 0:3] + joint_offset[None]
    lr = quat.quat_mul(joint_rotation[None], quat.quat_from_xyz(jp[:, :, 3:6]))
    ls = torch.pow(2.0, jp[:, :, 6:7])

    gt, gr, gs = lt.clone(), lr.clone(), ls.clone()
    dev = params.device
    for level in levels[1:]:  # level 0 joints are already global
        idx = torch.from_numpy(level).to(dev)
        par = torch.from_numpy(joint_parents[level]).to(dev)
        pr = gr[:, par]
        pt = gt[:, par]
        ps = gs[:, par]
        new_r = quat.quat_mul(pr, lr[:, idx])
        new_t = quat.quat_rotate(pr, lt[:, idx] * ps) + pt
        new_s = ps * ls[:, idx]
        # out of place, so autograd sees each level's inputs unchanged
        gt = gt.index_copy(1, idx, new_t)
        gr = gr.index_copy(1, idx, new_r)
        gs = gs.index_copy(1, idx, new_s)
    return torch.cat([gt, gr, gs], dim=-1)


def states_to_matrix(bind_state: torch.Tensor, target_states: torch.Tensor,
                     return_transform: bool = False):
    """Compose target state with inverse bind state -> [B, J, 3, 4] affines."""
    br = quat.quat_invert(bind_state[:, :, 3:7])
    bs = 1.0 / bind_state[:, :, 7:8]
    bt = quat.quat_rotate(br, -bind_state[:, :, 0:3]) * bs

    tr = quat.quat_mul(target_states[:, :, 3:7], br)
    ts = target_states[:, :, 7:8] * bs
    tt = (quat.quat_rotate(target_states[:, :, 3:7],
                           bt * target_states[:, :, 7:8])
          + target_states[:, :, 0:3])
    R = quat.quat_to_matrix(tr) * ts[..., None]
    mat = torch.cat([R, tt[..., None]], dim=-1)  # [B, J, 3, 4]
    if return_transform:
        return mat, (tr, tt, ts)
    return mat


class LinearBlendSkinning:
    """Parses the momentum model json and applies (un)skinning."""

    def __init__(self, model_json: Dict[str, Any],
                 lbs_config_dict: Dict[str, Any],
                 num_max_skin_joints: int = 8,
                 device: Union[str, torch.device] = "cuda"):
        model = model_json
        self.param_transform = ParameterTransform(lbs_config_dict)

        bones = model["Skeleton"]["Bones"]
        nr_joints = len(bones)
        self.joint_names = [b["Name"] for b in bones]
        joint_parents = np.zeros(nr_joints, dtype=np.int64)
        joint_rotation = np.zeros((nr_joints, 4), dtype=np.float32)
        joint_offset = np.zeros((nr_joints, 3), dtype=np.float32)
        for idx, bone in enumerate(bones):
            joint_parents[idx] = (-1 if bone["Parent"] > nr_joints
                                  else bone["Parent"])
            joint_rotation[idx] = np.asarray(bone["PreRotation"], np.float32)
            joint_offset[idx] = np.asarray(bone["TranslationOffset"],
                                           np.float32)

        skin = model["SkinnedModel"]
        self.mesh_vertices_np = np.asarray(skin["RestPositions"], np.float32)
        self.mesh_normals = np.asarray(skin["RestVertexNormals"], np.float32)

        weights = np.asarray([e[1] for e in skin["SkinningWeights"]],
                             np.float32)
        indices = np.asarray([e[0] for e in skin["SkinningWeights"]],
                             np.int64)
        offsets = np.asarray(skin["SkinningOffsets"], np.int64)
        nr_vertices = len(offsets) - 1
        skin_weights = np.zeros((nr_vertices, num_max_skin_joints), np.float32)
        skin_indices = np.zeros((nr_vertices, num_max_skin_joints), np.int64)
        right = offsets[1:]
        for o in range(num_max_skin_joints):
            left = offsets[:-1] + o
            sel = left < right
            skin_weights[sel, o] = weights[left[sel]]
            skin_indices[sel, o] = indices[left[sel]]

        self.mesh_faces = np.asarray(skin["Faces"]["Indices"],
                                     np.int32).reshape(-1, 3)
        self.mesh_texture_faces = np.asarray(
            skin["Faces"]["TextureIndices"], np.int32).reshape(-1, 3)
        self.mesh_texture_coords = np.asarray(
            skin["TextureCoordinates"], np.float32).reshape(-1, 2)

        self.joint_parents = joint_parents
        self.joint_rotation_np = joint_rotation
        self.joint_offset_np = joint_offset
        self.skin_weights_np = skin_weights
        self.skin_indices_np = skin_indices
        self.levels = _levels_from_parents(joint_parents)
        self.to(torch.device("cpu"))
        zero_pose = torch.zeros((1, self.param_transform.nr_total_params))
        self.bind_state_np = solve_skeleton_state(
            self.param_transform(zero_pose), self.joint_offset,
            self.joint_rotation, joint_parents, self.levels).numpy()
        self.to(resolve_device(device))

    def to(self, device: torch.device) -> "LinearBlendSkinning":
        """Keep the tables the device math reads on ``device``."""
        self.param_transform.to(device)
        for name in ("joint_rotation", "joint_offset", "skin_weights",
                     "skin_indices", "mesh_vertices", "bind_state"):
            if hasattr(self, name + "_np"):
                setattr(self, name,
                        torch.from_numpy(getattr(self, name + "_np")).to(
                            device))
        return self

    @property
    def num_verts(self) -> int:
        return self.mesh_vertices_np.shape[0]

    @property
    def num_joints(self) -> int:
        return self.joint_offset_np.shape[0]

    def _solve(self, poses: torch.Tensor, scales: torch.Tensor
               ) -> torch.Tensor:
        params = torch.cat([poses, scales], dim=1)
        return solve_skeleton_state(
            self.param_transform(params), self.joint_offset,
            self.joint_rotation, self.joint_parents, self.levels)

    def compute_rigid_transforms(self, global_pose, local_pose, scale):
        params = torch.cat([global_pose, local_pose, scale], dim=-1)
        return solve_skeleton_state(
            self.param_transform(params), self.joint_offset,
            self.joint_rotation, self.joint_parents, self.levels)

    def compute_rigid_transforms_matrix(self, global_pose, local_pose, scale):
        states = self.compute_rigid_transforms(global_pose, local_pose, scale)
        return states_to_matrix(self.bind_state, states)

    def skinning(self, bind_state, vertices, target_states) -> torch.Tensor:
        """[B?, V, 3] vertices skinned by [B, J, 8] states."""
        mat = states_to_matrix(bind_state, target_states)  # [B, J, 3, 4]
        m = mat[:, self.skin_indices]                     # [B, V, 8, 3, 4]
        vh = torch.cat([vertices, torch.ones_like(vertices[..., :1])], dim=-1)
        if vh.dim() == 2:
            vh = vh[None]
        vs = torch.einsum("bvkij,bvj->bvki", m, vh.expand(
            m.shape[0], -1, -1))                          # [B, V, 8, 3]
        w = self.skin_weights[None, :, :, None]
        return torch.sum(vs * w, dim=2)

    def unskinning(self, bind_state, target_states, verts) -> torch.Tensor:
        """Closed-form inverse skinning."""
        mat = states_to_matrix(bind_state, target_states)
        m = mat[:, self.skin_indices]                     # [B, V, 8, 3, 4]
        w = self.skin_weights[None, :, :, None, None]
        summ = torch.sum(m * w, dim=2)                    # [B, V, 3, 4]
        A = summ[..., :3]
        t = summ[..., 3]
        Ainv = torch.linalg.inv(A)
        return torch.einsum("bvij,bvj->bvi", Ainv, verts - t)

    def unpose(self, poses, scales, verts) -> torch.Tensor:
        states = self._solve(poses, scales)
        return self.unskinning(self.bind_state, states, verts)

    def __call__(self, poses, scales, verts_unposed=None) -> torch.Tensor:
        states = self._solve(poses, scales)
        verts = (self.mesh_vertices[None] if verts_unposed is None
                 else verts_unposed)
        return self.skinning(self.bind_state, verts, states)


class LBSModule:
    """Facade: pose/unpose/template_pose with global scaling."""

    def __init__(self, lbs_model_json, lbs_config_dict, lbs_template_verts,
                 lbs_scale, global_scaling,
                 device: Union[str, torch.device] = "cuda"):
        device = resolve_device(device)
        self.lbs_fn = LinearBlendSkinning(lbs_model_json, lbs_config_dict,
                                          device=device)
        self.lbs_scale = torch.from_numpy(
            np.asarray(lbs_scale, np.float32)).to(device)
        self.lbs_template_verts = torch.from_numpy(
            np.asarray(lbs_template_verts, np.float32)).to(device)
        self.global_scaling = torch.from_numpy(
            np.asarray(global_scaling, np.float32)).to(device)

    def _scales(self, B: int) -> torch.Tensor:
        s = self.lbs_scale
        if s.dim() == 1:
            s = s[None]
        return s.expand(B, s.shape[-1])

    def pose(self, verts_unposed, motion, template=None):
        template = self.lbs_template_verts if template is None else template
        return self.lbs_fn(motion, self._scales(motion.shape[0]),
                           verts_unposed + template) * self.global_scaling

    def unpose(self, verts, motion):
        return (self.lbs_fn.unpose(motion, self._scales(motion.shape[0]),
                                   verts / self.global_scaling)
                - self.lbs_template_verts)

    def template_pose(self, motion):
        B = motion.shape[0]
        verts = self.lbs_template_verts[None].expand(
            (B,) + tuple(self.lbs_template_verts.shape[-2:]))
        return self.lbs_fn(motion, self._scales(B), verts) \
            * self.global_scaling


# ---------------------------------------------------------------------------
# momentum .cfg text parsing (reference lbs.py:432-633)
# ---------------------------------------------------------------------------


def load_momentum_cfg(model: Dict[str, Any], lbs_config_txt_fh,
                      nr_scaling_params: Optional[int] = None) -> Dict[str, Any]:
    channel_names = ["tx", "ty", "tz", "rx", "ry", "rz", "sc"]
    joint_names = [b["Name"] for b in model["Skeleton"]["Bones"]]
    param_names: List[str] = []
    limits: List[Dict[str, Any]] = []
    triplets: List[tuple] = []

    def find_joint(x):
        return joint_names.index(x) if x in joint_names else None

    def find_param(x):
        return param_names.index(x) if x in param_names else None

    for line in lbs_config_txt_fh.readlines():
        line = line[: line.find("#")] if "#" in line else line

        if "limit" in line:
            r = re.search(r"limit ([\w.]+) (\w+) (.*)", line)
            if r is None:
                continue
            fullname, ltype, remaining = r.groups()
            parameter_index = find_param(fullname)
            joint_name = fullname.split(".")
            joint_index = find_joint(joint_name[0])
            channel_index = -1
            if joint_index is not None and len(joint_name) == 2:
                channel_index = channel_names.index(joint_name[1])
            if ltype in ("minmax_passive", "minmax"):
                rp = re.search(
                    r"\[\s*([-+]?[0-9]*\.?[0-9]+)\s*,\s*([-+]?[0-9]*\.?[0-9]+)\s*\]"
                    r"(\s*[-+]?[0-9]*\.?[0-9]+)?",
                    remaining,
                )
                if rp is None:
                    continue
                min_v, max_v = float(rp.groups()[0]), float(rp.groups()[1])
                weight = float(rp.groups()[2]) if rp.groups()[2] else 1.0
                if channel_index >= 0:
                    limits.append({
                        "type": "LimitMinMaxJointValue", "str": fullname,
                        "valueIndex": joint_index * 7 + channel_index,
                        "limits": [min_v, max_v], "weight": weight,
                    })
                elif parameter_index is not None:
                    limits.append({
                        "type": "LimitMinMaxParameter", "str": fullname,
                        "parameterIndex": parameter_index,
                        "limits": [min_v, max_v], "weight": weight,
                    })
            continue

        if "parameterset" in line:
            continue

        r = re.search(r"(\w+).(\w+)\s*=\s*(.*)", line)
        if r is None:
            continue
        joint_index = find_joint(r.groups()[0])
        if joint_index is None:
            continue
        channel_index = channel_names.index(r.groups()[1])
        value_index = joint_index * 7 + channel_index
        for pair in r.groups()[2].split("+"):
            rr = re.search(r"\s*([+-]?[0-9]*\.?[0-9]*)\s\*\s(\w+)\s*", pair.strip())
            if rr is None:
                continue
            val = float(rr.groups()[0])
            pname = rr.groups()[1]
            pidx = find_param(pname)
            if pidx is None:
                pidx = len(param_names)
                param_names.append(pname)
            triplets.append((value_index, pidx, val))

    transform = np.zeros((7 * len(joint_names), len(param_names)), np.float32)
    for i, j, v in triplets:
        transform[i, j] = v

    out = {
        "model_param_names": param_names,
        "joint_names": joint_names,
        "channel_names": channel_names,
        "limits": limits,
        "transform": transform,
        "transform_offsets": np.zeros((1, 7 * len(joint_names)), np.float32),
    }
    if nr_scaling_params is None:
        out["nr_scaling_params"] = len(
            [s for s in param_names if s.startswith("scale")]
        )
        out["nr_position_params"] = len(param_names) - out["nr_scaling_params"]
    else:
        out["nr_scaling_params"] = nr_scaling_params
        out["nr_position_params"] = len(param_names) - nr_scaling_params
    return out
