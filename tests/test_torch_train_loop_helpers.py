"""Part of tests/test_torch_train_loop.py's tests, in a file of their own: a
port test file that runs long holds at most four tests, so that pytest-
xdist's --dist loadfile queues it after tests/test_tile_shard.py. The
inputs, helpers and tolerances are that file's.
"""

import os

import numpy as np
import torch

from goliath_capture import CaptureSpec, write_capture, write_shared_assets
from goliath_torch import train as train_lib
from goliath_torch.data.dataloader import BodyDataset
from goliath_torch.data.synthetic import make_camera_ring
from goliath_torch.scripts import run_test, run_train

torch.set_num_threads(1)


def test_checkpoint_helpers_and_moved_build_dataset(tmp_path):
    d = tmp_path / "ckpts"
    assert not train_lib.has_checkpoint(str(d))
    state = {"model": {"w": torch.arange(3.0)}, "optimizer": {"state": {}}}
    train_lib.save_checkpoint(str(d), state, iteration=12)
    train_lib.save_checkpoint(str(d), state)
    assert train_lib.has_checkpoint(str(d))
    assert sorted(os.listdir(d)) == ["000012.pt", "final.pt", "latest"]
    assert "iteration" not in train_lib.load_checkpoint(str(d))
    got = train_lib.load_checkpoint(str(d), iteration=12)
    assert got["iteration"] == 12 and torch.equal(got["model"]["w"],
                                                  torch.arange(3.0))
    assert train_lib.process_losses(
        {"a": torch.tensor(2.0), "b": torch.tensor([1.0, 3.0]),
         "c": torch.zeros(2, 2)}) == {"a": 2.0, "b": 2.0}
    # build_dataset lives in run_train; run_test uses the same function.
    # A config without data.synthetic names a capture: a BodyDataset
    assert run_test.build_dataset is run_train.build_dataset
    K, Rt, _ = make_camera_ring(2, 16, 16)
    root = write_capture(tmp_path, "m--test--Head", CaptureSpec(
        kind="Head", cameras=["400000", "400001"], K=K, Rt=Rt,
        frames=[0, 1, 2], test_frames=[2], template=np.zeros((4, 3)),
        image_hw=(16, 16), uv_size=8))
    shared = write_shared_assets(tmp_path / "shared.pt", {"topology": {}})
    ds = run_train.build_dataset({"root_path": str(root),
                                  "shared_assets_path": str(shared),
                                  "split": "train", "fully_lit_only": False})
    assert isinstance(ds, BodyDataset) and len(ds) == 2 * 2
