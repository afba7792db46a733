"""Build the port's CUDA kernels on the card's machine and print what ptxas
reports for each kernel (registers, shared memory, spill stores and loads):

    python -m goliath_torch.scripts.build_kernels

It deletes the object files in ``build/kernels/`` so that every source is
compiled again, then builds there with the flags of every other build
(``gsplat_cuda.NVCC_FLAGS``, ``-Xptxas=-v`` among them), so a later
``load_kernels()`` reuses this build. Needs ``nvcc`` and ``ninja``. A kernel
that spills shows ``bytes spill stores`` above 0 on its ``ptxas info``
lines.
"""

from __future__ import annotations

import time

from goliath_torch.ops import gsplat_cuda


def main() -> None:
    t0 = time.perf_counter()
    for obj in gsplat_cuda.BUILD_DIR.glob("*.o"):
        obj.unlink()
    gsplat_cuda.load_kernels(verbose=True)
    print(f"build_kernels: built {sorted(set(gsplat_cuda.SOURCES.values()))} "
          f"in {time.perf_counter() - t0:.1f} s into {gsplat_cuda.BUILD_DIR}",
          flush=True)


if __name__ == "__main__":
    main()
