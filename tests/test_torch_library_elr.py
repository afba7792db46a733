"""The cheaper cases of tests/test_torch_library.py's ``LAYER_CASES`` (the
linear list factories, ``Downsample``, ``LinearELR``, ``Conv2dELR``), with
that file's weight carry, gradients and tolerance.
"""

import pytest
import torch

from tests.test_torch_library import CONV_CASES, LAYER_CASES, hold_layer

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(set(LAYER_CASES) - set(CONV_CASES)))
def test_layer_matches_jax(name):
    hold_layer(name)
