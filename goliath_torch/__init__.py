"""goliath_torch — the PyTorch/CUDA port of the repo's JAX package for
NVIDIA Hopper.

The JAX package beside this one is the reference: every module here mirrors
the file of the same path there (named "the JAX package's <path>" in the
docstrings), and the parity tests (``tests/test_torch_*.py``) hold each one
against it on the CPU.

This package imports ``torch`` and ``numpy`` only. Every Pallas TPU kernel on
a ported path is a hand-written CUDA C++ kernel for ``sm_90a`` under
``ops/csrc/``, built with ``nvcc`` at first use. A CUDA tensor runs the
kernel; a CPU tensor runs the kernel's plain PyTorch version
(``ops/backend.py``).

Ported so far: the RGCA eval render (``scripts/run_test.py``), the RGCA
training step (``scripts/run_train.py``) and the mesh_vae full-body eval
render (``scripts/run_test.py`` on ``configs/mesh_vae.yml``, with the mesh
z-buffer kernel K5). The other model paths and the remaining kernels are
queued in ROADMAP.md.
"""

__version__ = "0.1.0"
