"""Part of tests/test_torch_orbax.py's tests, in a file of their own: a port
test file that runs long holds at most four tests, so that pytest-xdist's
--dist loadfile queues it after tests/test_tile_shard.py. The inputs,
helpers and tolerances are that file's.
"""

import os
import sys

import pytest
import torch

from goliath_torch import train as t_train
from goliath_torch.config import load_from_config as t_load_from_config
from goliath_torch.convert import (
    load_checkpoint,
    load_params,
    read_orbax,
    save_params,
)
from goliath_torch.data.synthetic import SyntheticDataset
from goliath_torch.optim import build_optimizer
from goliath_tpu import train as j_train

from tests.test_torch_orbax import ITERATION, _opt_cfg, _port_model, written
from tests.test_torch_quality import flax_tree

torch.set_num_threads(1)


def test_reader_names_a_missing_tensorstore(written, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        read_orbax(os.path.join(written["ckpt_dir"], f"{ITERATION:06d}"))


def test_load_checkpoint_dispatch(tmp_path):
    """.pt files, .pt checkpoint directories and orbax directories, each
    as a directory with ``latest`` and as one checkpoint; anything else
    raises and names the path."""
    cfg, model = _port_model()
    optimizer = build_optimizer(_opt_cfg(cfg, True), model.module)
    state = {"model": model.module.state_dict(),
             "optimizer": optimizer.state_dict()}
    pt_dir = tmp_path / "pt"
    t_train.save_checkpoint(str(pt_dir), state, iteration=3)
    for path, it in ((pt_dir, None), (pt_dir, 3), (pt_dir / "000003.pt", None)):
        got = load_checkpoint(str(path), iteration=it)
        assert set(got) == {"model", "optimizer", "iteration"}
        assert got["iteration"] == 3
    params_pt = tmp_path / "params.pt"
    save_params(str(params_pt), model.module)
    assert set(load_checkpoint(str(params_pt))) == set(state["model"])

    ox_dir = tmp_path / "orbax"
    j_train.save_checkpoint(
        str(ox_dir), {"model": {"params": flax_tree(state["model"])}},
        iteration=5)
    for path, it in ((ox_dir, None), (ox_dir, 5), (ox_dir / "000005", None)):
        got = load_checkpoint(str(path), iteration=it)
        assert set(got) == {"model", "iteration"} and got["iteration"] == 5

    # load_params reads each form; the eval model (no cal, no learn_blur)
    # skips the training modules' parameters, as the JAX apply ignores them
    eval_cfg = dict(cfg.model)
    eval_cfg.pop("cal")
    eval_cfg["learn_blur"] = False
    kw = dict(cfg.data)
    kw.pop("synthetic")
    eval_model = t_load_from_config(
        eval_cfg, assets=SyntheticDataset(**kw).static_assets, device="cpu")
    for path in (pt_dir, pt_dir / "000003.pt", params_pt, ox_dir,
                 ox_dir / "000005"):
        for p in eval_model.module.parameters():
            p.data.zero_()
        load_params(eval_model.module, str(path))
        for name, p in eval_model.module.named_parameters():
            assert torch.equal(p.detach(), state["model"][name]), (path, name)
    # a key the model lacks inside a submodule it has is an error
    bad = dict(state["model"])
    bad["decoder.nowhere"] = torch.zeros(1)
    torch.save(bad, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="decoder.nowhere"):
        load_params(eval_model.module, str(tmp_path / "bad.pt"))

    (tmp_path / "empty").mkdir()
    (tmp_path / "weights.npz").write_bytes(b"")
    for path in (tmp_path / "empty", tmp_path / "weights.npz",
                 tmp_path / "missing.pt"):
        with pytest.raises(ValueError, match=str(path.name)):
            load_checkpoint(str(path))
