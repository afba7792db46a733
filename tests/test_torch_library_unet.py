"""The UNets ``UNetWBConcat`` (untied biases, concatenated skips) and
``UNetW`` (tied biases, additive skips, a non-square input, ``out_scale``)
of nn/unet.py against the JAX package on the CPU, with
tests/test_torch_library.py's weight carry, gradients and tolerance.
"""

import pytest
import torch

from goliath_torch.nn import unet as tu
from goliath_tpu.nn import unet as ju
from tests.test_torch_library import _gen
from tests.test_torch_library_blocks import hold_with_biases

torch.set_num_threads(1)

CASES = {
    "unet_wb_concat": (lambda: ju.UNetWBConcat(4, 3, 64, n_init_ftrs=4),
                       lambda: tu.UNetWBConcat(4, 3, 64, n_init_ftrs=4,
                                               generator=_gen()),
                       (1, 4, 64, 64)),
    "unet_w": (lambda: ju.UNetW(4, 3, n_init_ftrs=4, out_scale=0.5),
               lambda: tu.UNetW(4, 3, n_init_ftrs=4, out_scale=0.5,
                                generator=_gen()),
               (2, 4, 32, 64)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_unet_matches_jax(name):
    hold_with_biases(*CASES[name])
