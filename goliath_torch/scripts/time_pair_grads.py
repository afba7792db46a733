"""Time the compositor backward K2 (``gsplat_cuda.pair_grads``) on the card
on probe_kernel's scene, a frame of real size at tile 16:

    python -m goliath_torch.scripts.time_pair_grads

The scene is ``probe_kernel.build_scene``'s (1M Gaussians, 2048x1344,
tile 16, C = 4, ``max_pairs_per_tile`` 512). For each window (the Pallas
kernel's and the XLA compositor's) and chunk in {64, 256}, K1's forward
gives the image, the final T and ``cnt``; the upstream gradients are drawn
from a torch generator with seed 1. It prints K2's mean time over 10
launches (CUDA events), the plain version's time, the largest error of
each output column against the plain version as a share of the column's
largest |value|, and whether two launches give the same bits.
"""

from __future__ import annotations

import torch

from goliath_torch.ops import gsplat_cuda
from goliath_torch.scripts import probe_kernel
from goliath_torch.utils import timing

CHUNKS = (64, 256)


def main(n: int = 1 << 20, reps: int = 10, img_h: int = probe_kernel.H,
         img_w: int = probe_kernel.W, device: str = "cuda") -> dict:
    """Print and return {(window, chunk): ms} on ``device`` (the card
    unless a smaller rehearsal asks for the CPU)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("time_pair_grads times kernels on an NVIDIA GPU; "
                           "torch.cuda.is_available() is False")
    H, W, TS = img_h, img_w, probe_kernel.TS
    rows, tile_start, tile_end = probe_kernel.build_scene(n, H, W, TS,
                                                          device=device)
    ntx, nty = -(-W // TS), -(-H // TS)
    n_pairs = rows.shape[0]
    C = rows.shape[1] - 8
    print(f"time_pair_grads: {n} Gaussians, {W}x{H}, tile {TS}, C={C}, "
          f"pairs={int((tile_end - tile_start).sum())} on "
          f"{torch.cuda.get_device_name(0) if device == 'cuda' else device}",
          flush=True)
    maxpp = probe_kernel.MAX_PAIRS
    out = {}
    for window in gsplat_cuda.WINDOWS:
        for chunk in CHUNKS:
            nblk = gsplat_cuda.window_blocks(maxpp, chunk, window)
            padded = torch.nn.functional.pad(rows, (0, 0, 0, nblk * chunk))
            img, T, cnt = gsplat_cuda.compositor_fwd(
                padded, tile_start, tile_end, H, W, TS, ntx, nty, chunk,
                maxpp, window=window)
            g = torch.Generator(device=device).manual_seed(1)
            d_out = torch.randn(img.shape, generator=g, device=device)
            d_T = torch.randn(T.shape, generator=g, device=device)
            call = (padded, tile_start, tile_end, cnt, d_out, d_T, T, TS,
                    ntx, nty, chunk, n_pairs, 1, window)
            got = gsplat_cuda.pair_grads(*call)
            same = torch.equal(got.view(torch.int32),
                               gsplat_cuda.pair_grads(*call).view(torch.int32))
            ref, plain_ms = timing.cuda_call_ms(
                lambda: gsplat_cuda.pair_grads_plain(*call))
            scale = ref[:, :6 + C].abs().amax(0).clamp(min=1e-30)
            rel = ((got - ref)[:, :6 + C].abs().amax(0) / scale).tolist()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"K2 {window} chunk {chunk}: not finite")
            ms = timing.cuda_ms(lambda: gsplat_cuda.pair_grads(*call), reps)
            out[(window, chunk)] = ms
            print(f"pair_grads {window:6s} chunk={chunk:4d}: {ms:9.4f} ms, "
                  f"plain {plain_ms:.1f} ms, blocks composited "
                  f"{int(cnt.sum())}, max error / max |ref| per column "
                  f"{[f'{r:.1e}' for r in rel]}, two launches bit-equal "
                  f"{same}", flush=True)
    return out


if __name__ == "__main__":
    main()
