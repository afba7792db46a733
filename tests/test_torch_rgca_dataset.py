"""Part of tests/test_torch_rgca.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import numpy as np
import pytest
import torch

from goliath_torch.config import load_config as t_load_config
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_torch.scripts import run_test as t_run_test
from goliath_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset

from tests.test_torch_rgca import _CFG, _data_kwargs

torch.set_num_threads(1)


def test_synthetic_dataset_matches_jax():
    """The port's fixture draws the JAX fixture's numbers in its order."""
    t, j = SyntheticDataset(**_data_kwargs()), JSyntheticDataset(**_data_kwargs())
    assert len(t) == len(j)
    for k in ("v", "vi", "vt", "vti", "v2uv", "nbs_idxs", "nbs_weights"):
        np.testing.assert_array_equal(t.static_assets.topology[k],
                                      j.static_assets.topology[k], err_msg=k)
    np.testing.assert_array_equal(t.static_assets.color_mean,
                                  j.static_assets.color_mean)
    for idx in (0, 7, len(t) - 1):
        ts, js = t[idx], j[idx]
        assert set(ts) == set(js)
        for k in ts:
            np.testing.assert_array_equal(np.asarray(ts[k]),
                                          np.asarray(js[k]), err_msg=k)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = t_load_config(_CFG, overrides=["test.ckpt=null"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_run_test.main(cfg)
