"""Unpack a capture's zips into a directory tree (port of the JAX
package's scripts/unpack_dataset.py; reference:
scripts/unpack_dataset.py:18-201).

    python -m goliath_torch.scripts.unpack_dataset <capture_root> <out_dir> \
        [--workers N] [--subdirs image segmentation_parts ...]

Uses a thread pool (zip decompression releases the GIL in zlib).
"""

from __future__ import annotations

import argparse
import logging
import os
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

logger = logging.getLogger(__name__)

DEFAULT_SUBDIRS = [
    "image", "segmentation_parts", "segmentation_fgbg", "uv_image",
    "kinematic_tracking", "keypoints_3d", "head_pose",
    "per_view_background", "scan_mesh",
]


def unzip_one(zip_path: Path, out_dir: Path) -> None:
    logger.info(f"unpacking {zip_path}")
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(out_dir)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("capture_root")
    p.add_argument("out_dir")
    p.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    p.add_argument("--subdirs", nargs="*", default=DEFAULT_SUBDIRS)
    args = p.parse_args(argv)

    root = Path(args.capture_root)
    out = Path(args.out_dir)
    jobs = []
    for sub in args.subdirs:
        d = root / sub
        if not d.exists():
            continue
        for z in sorted(d.glob("*.zip")):
            (out / sub).mkdir(parents=True, exist_ok=True)
            jobs.append((z, out / sub))
    with ThreadPoolExecutor(max_workers=args.workers) as ex:
        list(ex.map(lambda jz: unzip_one(*jz), jobs))
    logger.info(f"unpacked {len(jobs)} zips to {out}")


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
