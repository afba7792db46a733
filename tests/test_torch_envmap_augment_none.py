"""Part of tests/test_torch_envmap.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch

from goliath_torch.utils import light_decorator as tl
from goliath_tpu.utils import light_decorator as jl

from tests.test_torch_envmap import CPU

torch.set_num_threads(1)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("anchor", (["head_pose", "pose", None])[2:3])
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
