"""Hold the batch-folded compositor backward (K6's) against its plain version
on the inputs of every step of full-width folded training runs, where
``chip_smoke.py`` checks the first step only:

    python -m goliath_torch.scripts.fold_grads_check [--runs N]

On the card, from the root of a checkout (it reuses ``chip_smoke.py``'s
training path and K2 tolerance). Runs ``chip_smoke.py``'s folded training
path (``configs/rgca.yml``, random weights, synthetic data at 2048x1334,
batch 4, 3 steps) N times (default 2) and keeps the inputs of each K6
backward it launches (host copies). Then, per step, it launches K6 twice on
them and runs the plain version, and prints per gradient column the share
of the check's absolute allowance the largest difference uses
(``chip_smoke.entries_over`` at K2's tolerances: over 1 fails) and whether
the two launches gave the same bits. Exits 1 if any step fails.

It captures the arguments ``RasterizeTiled.backward`` hands to
``pair_grads`` and replays them as they are, so a copy of this file runs
unchanged in a tree whose ``pair_grads`` takes other arguments before the
image count (earlier versions also took the forward's color)."""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


class CaptureFold:
    """GOLIATH_GSPLAT_FOLD=1 for a with-block, and every batch-folded
    ``pair_grads`` call's arguments appended to ``store`` as host copies."""

    def __init__(self, gc, store):
        self.gc, self.store = gc, store

    def __enter__(self):
        self.before = os.environ.get("GOLIATH_GSPLAT_FOLD")
        os.environ["GOLIATH_GSPLAT_FOLD"] = "1"
        self.orig = orig = self.gc.pair_grads
        store = self.store

        def pair_grads(*args):
            if args[-2] > 1:          # (..., n_imgs, window)
                store.append(tuple(
                    a.detach().to("cpu", non_blocking=True)
                    if isinstance(a, torch.Tensor) else a for a in args))
            return orig(*args)

        self.gc.pair_grads = pair_grads
        return self

    def __exit__(self, *exc):
        self.gc.pair_grads = self.orig
        if self.before is None:
            os.environ.pop("GOLIATH_GSPLAT_FOLD", None)
        else:
            os.environ["GOLIATH_GSPLAT_FOLD"] = self.before


def column_shares(cs, got, ref, n_cols):
    """Per column: (share of the absolute allowance used, entries over)."""
    carries = ref.abs().sum(1) > 0
    out = []
    for k in range(n_cols):
        r = cs.entries_over(got[:, k], ref[:, k], carries, cs.K2_RTOL,
                            cs.K2_ATOL_OF_TYPICAL)
        out.append((r[4], r[3]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    runs = ap.parse_args(argv).runs
    if not torch.cuda.is_available():
        print("fold_grads_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from goliath_torch.ops import gsplat_cuda as gc

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.load_kernels()
    card = cs.card()
    samples = []
    for run in range(runs):
        cs.run_training(gc, torch, card, f"fold run {run}", dict(
            compositor_fwd_fold=cs.TRAIN_STEPS + 1,
            pair_grads_fold=cs.TRAIN_STEPS, cumsum_cols=cs.TRAIN_STEPS,
            cumsum1d=2 * (cs.TRAIN_STEPS + 1)), {},
            patch=CaptureFold(gc, samples))
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    failed = 0
    for i, sample in enumerate(samples):
        args = tuple(a.to("cuda") if isinstance(a, torch.Tensor) else a
                     for a in sample)
        n_cols = 6 + args[0].shape[1] - 8
        t0 = time.perf_counter()
        got = gc.pair_grads(*args)
        same = torch.equal(got.view(torch.int32),
                           gc.pair_grads(*args).view(torch.int32))
        ref = gc.pair_grads_plain(*args)
        torch.cuda.synchronize()
        shares = column_shares(cs, got, ref, n_cols)
        bad = [k for k, (_, n_over) in enumerate(shares) if n_over]
        failed += bool(bad) or not same
        print(f"run {i // cs.TRAIN_STEPS} step {i % cs.TRAIN_STEPS}: rows "
              f"with a gradient {int((ref.abs().sum(1) > 0).sum())}, share "
              f"of the allowance used per column (x, y, conic a/b/c, "
              f"opacity, colors) {[round(s, 3) for s, _ in shares]}, columns "
              f"over {bad}, two launches bit-equal {same} "
              f"({time.perf_counter() - t0:.1f} s) on {card}", flush=True)
        del args, got, ref
        torch.cuda.empty_cache()
    print(f"fold_grads_check: {len(samples)} steps, {failed} failed",
          flush=True)
    return 1 if failed or not samples else 0


if __name__ == "__main__":
    sys.exit(main())
