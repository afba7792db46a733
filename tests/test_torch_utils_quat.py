"""Part of tests/test_torch_utils.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_utils import _close

torch.set_num_threads(1)


def test_quat_to_matrix_matches_jax():
    from goliath_torch.utils.quaternion import quat_to_matrix
    from goliath_tpu.utils.quaternion import quat_to_matrix as j_quat

    q = np.random.RandomState(4).randn(6, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    _close(quat_to_matrix(torch.from_numpy(q)), j_quat(jnp.asarray(q)))
