"""``utils/sh.eval_sh`` against the JAX package on the CPU: outputs and the
gradients of the coefficients and directions (tests/test_torch_library_utils
.py's ``_grads``) at rtol and atol-of-the-largest 1e-5, at degree 8 1e-4
(the basis reaches ~1e3).
"""

import numpy as np
import pytest
import torch

from goliath_torch.utils import sh as tsh
from goliath_tpu.utils import sh as jsh
from tests.test_torch_library_utils import _grads

torch.set_num_threads(1)


@pytest.mark.parametrize("deg", [2, 8])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    d = rng.randn(5, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    coeffs = rng.randn(5, 3, (deg + 1) ** 2).astype(np.float32)
    _grads(lambda c, x: jsh.eval_sh(deg, c, x),
           lambda c, x: tsh.eval_sh(deg, c, x), [coeffs, d],
           tol=1e-5 if deg < 8 else 1e-4)
