"""Part of tests/test_torch_mvp_grad.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import pytest
import torch

from goliath_torch.ops import mvp as tm

from tests.test_torch_mvp import T
from tests.test_torch_mvp_grad import _inputs

torch.set_num_threads(1)


def test_march_refuses_drops_under_autograd():
    kw, diff, (rp, rd, tminmax, K_cam, Rt), stepsize, _ = _inputs("exact")
    args = [T(rp), T(rd), stepsize, T(tminmax),
            T(diff["primpos"]).requires_grad_(), T(diff["primrot"]),
            T(diff["primscale"]), T(diff["template"]), T(K_cam), T(Rt)]
    with pytest.raises(ValueError, match="drops"):
        tm.mvp_raymarch_tiled(*args, drops={}, **kw)
    with torch.no_grad():
        drops = {}
        tm.mvp_raymarch_tiled(*args, drops=drops, **kw)
    assert int(drops["tiles_marched"]) == 4
