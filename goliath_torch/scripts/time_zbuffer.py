"""Where K5's time goes on the full-width mesh_vae frame:

    python -m goliath_torch.scripts.time_zbuffer [--save PATH | --load PATH]

On the card, from the root of a checkout. Runs ``chip_smoke.py``'s mesh
eval path (``configs/mesh_vae.yml`` at 2048x1334 on the 65,536-face
synthetic sphere, random weights from seed 0) and keeps the arguments of
its first frame's K5 call (``--save`` writes them to PATH, about 36 MB;
``--load`` reads them instead of running the path, so two trees time the
same inputs). Then it times K5 on those arguments and on the same rows
with the tile bounds cut: every tile empty (the blocks' own cost), each
window cut to its first chunk and to 32 rows, only the tiles of at most 64
rows, and only those of more than 64 and of more than 128 rows (the tail).
Two times each, beside the card's name and power limit, twice over: CUDA
events around 50 calls after 2 (they time the host's enqueue too, ~0.02
ms a call through the wrapper) and the device time a call from
``torch.profiler`` (``chip_smoke.profiled_device_ms``, 20 calls).

It uses only ``chip_smoke.mesh_eval_path`` and ``profiled_device_ms``,
``rasterizer_cuda.zbuffer`` and ``utils.timing``, all there before the
z-buffer's redesign, so a copy runs unchanged in the tree before it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--save", type=Path)
    group.add_argument("--load", type=Path)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from goliath_torch.ops import gsplat_cuda
    from goliath_torch.ops import rasterizer_cuda as rc
    from goliath_torch.utils.timing import cuda_ms

    card = cs.card()
    gsplat_cuda.load_kernels()
    if args.load:
        host = torch.load(args.load)
    else:
        captured = {}
        cs.mesh_eval_path(gsplat_cuda, torch, card, captured)
        host = captured["k5"]
        if args.save:
            torch.save(host, args.save)
    (rows, prim, start, end, H, W, ts, ntx, nty, chunk,
     mfpt) = [a.cuda() if isinstance(a, torch.Tensor) else a for a in host]
    n = end - start
    print(f"K5 frame: {n.numel()} tiles; over 32 rows {int((n > 32).sum())},"
          f" over 64 {int((n > 64).sum())}, over 128 "
          f"{int((n > 128).sum())}, over {mfpt} {int((n > mfpt).sum())}",
          flush=True)
    cuts = {"frame": (end, mfpt),
            "every tile empty": (start, mfpt),
            "windows of one chunk": (end, chunk - 1),
            "windows cut to 32 rows": (torch.minimum(end, start + 32), mfpt),
            "tiles of at most 64 rows": (torch.where(n > 64, start, end),
                                         mfpt),
            "tiles over 64 rows": (torch.where(n > 64, end, start), mfpt),
            "tiles over 128 rows": (torch.where(n > 128, end, start), mfpt)}
    for _ in range(2):
        for label, (stop, window) in cuts.items():
            a = (rows, prim, start, stop, H, W, ts, ntx, nty, chunk, window)
            ms = cuda_ms(lambda: rc.zbuffer(*a), reps=50)
            device_ms, _, _ = cs.profiled_device_ms(
                torch, lambda: rc.zbuffer(*a), 20)
            print(f"K5 {label}: {ms:.4f} ms by events, {device_ms:.4f} ms of"
                  f" device time a call (profiler) on {card}", flush=True)


if __name__ == "__main__":
    main()
