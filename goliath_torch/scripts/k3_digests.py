"""K3's output bits, to hold a change of ``ops/csrc/cumsum.cu`` against the
tree before it:

    python -m goliath_torch.scripts.k3_digests [--save PATH | --compare PATH]

On the card, from the root of a checkout. K3 (``gsplat_cuda.cumsum_cols``)
runs on seeded inputs (a generator on the card, seed 0): [10, 3,145,728],
[10, 12,582,912], a ragged [3, 1,000,003] and the same rows 4 bytes past a
16-byte boundary. The script prints the sha256 of each output's bytes;
``--save`` writes them to PATH as JSON, ``--compare`` reads a file that
another tree saved and exits 1 unless every digest agrees (K3 is
bit-identical from call to call, so equal digests mean equal outputs).
K7's and K3's times are ``chip_smoke.py``'s (check_k7, check_k3).

It uses only ``gsplat_cuda.cumsum_cols``, there since K3 was ported, so a
copy runs unchanged in an older tree.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch


def k3_digests() -> dict:
    from goliath_torch.ops import gsplat_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    ragged = torch.randn(3 * 1_000_003 + 1, generator=g, device="cuda")
    cases = {
        "[10, 3145728]": torch.randn(10, 3_145_728, generator=g,
                                     device="cuda"),
        "[10, 12582912]": torch.randn(10, 12_582_912, generator=g,
                                      device="cuda"),
        "[3, 1000003]": ragged[:-1].view(3, 1_000_003),
        "[3, 1000003] unaligned": ragged[1:].view(3, 1_000_003),
    }
    out = {}
    for name, x in cases.items():
        y = gsplat_cuda.cumsum_cols(x).cpu().numpy()
        out[name] = hashlib.sha256(y.tobytes()).hexdigest()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--save", type=Path)
    group.add_argument("--compare", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_digests needs an NVIDIA GPU", file=sys.stderr)
        return 2
    digests = k3_digests()
    for name, d in digests.items():
        print(f"K3 {name}: sha256 {d}")
    if args.save:
        args.save.write_text(json.dumps(digests, indent=1))
    if args.compare:
        saved = json.loads(args.compare.read_text())
        differ = sorted(k for k in saved if saved[k] != digests.get(k))
        print(f"K3 digests against {args.compare}: "
              f"{'all equal' if not differ else f'differ in {differ}'}")
        return 1 if differ or saved.keys() != digests.keys() else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
