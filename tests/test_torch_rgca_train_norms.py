"""Part of tests/test_torch_rgca_train.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import torch

from goliath_torch.models import rgca as t_rgca
from goliath_torch.ops import sg as t_sg
from goliath_torch.utils import geom as t_geom

torch.set_num_threads(1)


def test_norms_have_finite_gradients_at_zero_vectors():
    """Every normalisation on the training path at a zero vector: the
    model's ``_normalize`` (quaternions, normals, view and light
    directions), the spherical-Gaussian ``_unit`` and ``vert_normals`` on a
    degenerate face."""
    for fn in (t_rgca._normalize, t_sg._unit):
        v = torch.zeros(2, 3, requires_grad=True)
        out = fn(v)
        out.sum().backward()
        assert torch.isfinite(out).all() and torch.isfinite(v.grad).all(), fn
    v = torch.zeros(1, 4, 3, requires_grad=True)   # all vertices coincide
    vi = torch.tensor([[0, 1, 2], [1, 2, 3]])
    out = t_geom.vert_normals(v, vi)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(v.grad).all()
