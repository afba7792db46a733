"""Part of tests/test_torch_edge_grad.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import numpy as np
import torch

from goliath_torch.ops import rasterizer as tr

torch.set_num_threads(1)


def test_edge_grad_direction():
    """The port's mirror of tests/test_rasterizer.py::test_edge_grad_direction:
    moving a white quad right raises sum(render * ramp), where the ramp
    weights right pixels higher, and the edge gradient says so."""
    Hq = Wq = 32
    v = np.asarray([[-0.3, -0.3, 2.0], [0.3, -0.3, 2.0], [0.3, 0.3, 2.0],
                    [-0.3, 0.3, 2.0]], np.float32)
    vi = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    vt = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    K = np.asarray([[[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]]], np.float32)
    Rt = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None].astype(
        np.float32)
    rl = tr.RenderLayer(Hq, Wq, vi, vt, vi, device="cpu",
                        max_faces_per_tile=64, chunk=16)
    tex = torch.ones((1, 3, 8, 8))
    ramp = torch.linspace(0, 1, Wq)[None, None, None, :]
    verts = torch.from_numpy(v[None]).requires_grad_(True)
    out = rl(verts, tex, torch.from_numpy(K), torch.from_numpy(Rt))
    (out["render"] * ramp).sum().backward()
    # moving +x covers high-ramp pixels on the right edge and uncovers
    # low-ramp pixels on the left: net positive dL/dx
    assert float(verts.grad[0, :, 0].sum()) > 0
