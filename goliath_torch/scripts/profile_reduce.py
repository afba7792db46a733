"""Timing of the pair-gradient reduce (sorted pair gradients -> per-prim
sums) on the card, at the JAX package's scripts/profile_reduce.py sizes:

    python -m goliath_torch.scripts.profile_reduce      # N, PBM, F from env

N prims (default 1,048,576) with 0..8 pairs each (Poisson(2), clipped), a
pair budget of PBM * N (default 2) and F gradient columns (default 10);
random pair gradients and a random permutation from a seeded generator.
Timed with CUDA events, in ms per call:
  * the two ways to put the rows into pre-sort order: one indexed store
    (``index_copy_`` at perm, the port's route) and a row gather at the
    inverse permutation (an int scatter, then the gather);
  * K7 (``gsplat_cuda.cumsum_rows``) on the [budget, F] pre-sort rows;
  * the whole presort reduce (``ops.gsplat.reduce_presort_pair_grads``, on
    K7) after each permutation;
  * the channel-first reduce the render path takes
    (``ops.gsplat.reduce_sorted_pair_grads``, on K3), for comparison.
"""

from __future__ import annotations

import os

import torch

from goliath_torch.ops import gsplat, gsplat_cuda
from goliath_torch.utils import timing


def make_inputs(n: int, pbm: float, F: int, device, seed: int = 0):
    """(sorted_g [budget, F], perm [budget] int32, offsets [n], ends [n])."""
    budget = int(pbm * n)
    g = torch.Generator(device=device).manual_seed(seed)
    sorted_g = torch.randn(budget, F, generator=g, device=device)
    perm = torch.randperm(budget, generator=g, device=device).to(torch.int32)
    counts = torch.poisson(torch.full((n,), 2.0, device=device),
                           generator=g).clamp(0, 8).to(torch.int32)
    ends = torch.cumsum(counts, 0, dtype=torch.int32).clamp(max=budget)
    offsets = torch.cat([ends.new_zeros(1), ends[:-1]])
    return sorted_g, perm, offsets, ends


def via_index_copy(sorted_g, perm):
    """Pre-sort rows by one indexed store: row s goes to slot perm[s]."""
    return torch.empty_like(sorted_g).index_copy_(0, perm.long(), sorted_g)


def via_gather(sorted_g, perm):
    """Pre-sort rows by a row gather at the inverse permutation."""
    inv = torch.empty_like(perm).scatter_(
        0, perm.long(), torch.arange(len(perm), dtype=perm.dtype,
                                     device=perm.device))
    return sorted_g[inv.long()]


def main(n: int | None = None, pbm: float | None = None,
         F: int | None = None, reps: int = 5) -> dict:
    """Print and return the timings (ms) on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("profile_reduce times kernels on an NVIDIA GPU; "
                           "torch.cuda.is_available() is False")
    n = n or int(os.environ.get("N", 1024 * 1024))
    pbm = pbm or float(os.environ.get("PBM", 2))
    F = F or int(os.environ.get("F", 10))
    sorted_g, perm, offsets, ends = make_inputs(n, pbm, F, "cuda")
    budget = sorted_g.shape[0]
    presort = via_index_copy(sorted_g, perm)
    times = {
        "permute index_copy_": timing.cuda_ms(
            lambda: via_index_copy(sorted_g, perm), reps),
        "permute gather": timing.cuda_ms(
            lambda: via_gather(sorted_g, perm), reps),
        f"cumsum_rows (K7) [{budget}, {F}]": timing.cuda_ms(
            lambda: gsplat_cuda.cumsum_rows(presort), reps),
        "full presort reduce (index_copy_, K7)": timing.cuda_ms(
            lambda: gsplat.reduce_presort_pair_grads(
                via_index_copy(sorted_g, perm), offsets, ends), reps),
        "full presort reduce (gather, K7)": timing.cuda_ms(
            lambda: gsplat.reduce_presort_pair_grads(
                via_gather(sorted_g, perm), offsets, ends), reps),
        "channel-first reduce (index_copy_, K3)": timing.cuda_ms(
            lambda: gsplat.reduce_sorted_pair_grads(
                sorted_g, perm, offsets, ends), reps),
    }
    print(f"profile_reduce N={n} budget={budget} F={F} on "
          f"{torch.cuda.get_device_name(0)}")
    for name, ms in times.items():
        print(f"{name:40s} {ms:9.4f} ms")
    return times


if __name__ == "__main__":
    main()
