"""Ablation probe of the compositor forward K1 (P1), on the card:

    python -m goliath_torch.scripts.probe_kernel

Times compile-time variants of K1 (``gsplat_cuda.probe_fwd``, sources in
ops/csrc/compositor_fwd.cu) with parts of the per-pair work removed, to see
where K1's time goes. Every variant walks exactly the blocks K1 composited
(K1's ``cnt``), so all read the same rows:
  full      K1's arithmetic (equal to K1 bit for bit)
  noexp     op * max(1 - sigma, 0) in place of the exp
  nochain   no per-pair transmittance chain: each pair weighted by the T at
            the start of its block, T updated once per block
  loadonly  the rows staged and their raw colours added: no alpha math

The scene is the JAX package's scripts/probe_kernel.py's: 1M Gaussians
around z = 400 in front of a 2048x1344 camera (fx = fy = 2000), tile 16,
C = 4, max_pairs_per_tile 512, a 4N pair budget, drawn from a torch
generator with seed 0; projection and binning run through the port (a
global depth sort, then ``bin_to_tiles`` on the depth-sorted prims). For
each variant and chunk in {64, 256, 512} it prints the time (CUDA events)
and the share of ``full``.
"""

from __future__ import annotations

import torch

from goliath_torch.ops import gsplat, gsplat_cuda
from goliath_torch.ops.binning import bin_to_tiles
from goliath_torch.utils import timing

H, W = 2048, 1344
TS = 16
MAX_PAIRS = 512
CHUNKS = (64, 256, 512)


def build_scene(n: int = 1 << 20, img_h: int = H, img_w: int = W,
                tile_size: int = TS, device="cuda", seed: int = 0,
                n_chan: int = 4):
    """Unpadded pair rows [4n, 8 + C] and the tile bounds of the scene."""
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=device)

    pos = normal(n, 3) * 100.0
    quat = normal(n, 4)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    scale = torch.exp(normal(n, 3) * 0.3) * 2.0
    op = torch.sigmoid(normal(n, 1))
    col = torch.sigmoid(normal(n, n_chan))
    Rt = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 400.0]],
                      device=device)
    proj = gsplat.project_gaussians(pos, scale, quat, Rt, 2000.0, 2000.0,
                                    img_w / 2, img_h / 2, img_h, img_w)
    order = torch.argsort(proj["depths"])
    xys = proj["xys"][order]
    radii = proj["radii"][order]
    valid = proj["valid"][order]
    ntx, nty = -(-img_w // tile_size), -(-img_h // tile_size)
    t_min = torch.stack([torch.floor((xys[:, 0] - radii) / tile_size),
                         torch.floor((xys[:, 1] - radii) / tile_size)],
                        -1).to(torch.int32)
    t_max = torch.stack([torch.floor((xys[:, 0] + radii) / tile_size) + 1,
                         torch.floor((xys[:, 1] + radii) / tile_size) + 1],
                        -1).to(torch.int32)
    b = bin_to_tiles(t_min, t_max, valid & (radii > 0), ntx, nty, 64, 4 * n)
    rows = gsplat_cuda.pack_pair_rows(
        xys, proj["conics"][order], op[order], col[order], valid.float(),
        b.sorted_prim, 0)
    return rows, b.tile_start, b.tile_end


def replay_inputs(rows, tile_start, tile_end, img_h, img_w, tile_size,
                  chunk, max_pairs_per_tile):
    """(rows padded for K1's window, K1's ``cnt``, K1's keyword args): what
    every variant is called with at this chunk."""
    ntx, nty = -(-img_w // tile_size), -(-img_h // tile_size)
    padded = torch.nn.functional.pad(
        rows, (0, 0, 0, (max_pairs_per_tile // chunk + 1) * chunk))
    kw = dict(img_h=img_h, img_w=img_w, tile_size=tile_size, ntx=ntx,
              nty=nty, chunk=chunk, max_pairs_per_tile=max_pairs_per_tile)
    _img, _T, cnt = gsplat_cuda.compositor_fwd(padded, tile_start, tile_end,
                                               **kw)
    return padded, cnt, kw


def run_variants(rows, tile_start, tile_end, img_h, img_w, tile_size, chunk,
                 max_pairs_per_tile, time_fn):
    """K1 for ``cnt``, then every variant over K1's blocks: {variant: ms}
    as ``time_fn(thunk)`` measures it."""
    padded, cnt, kw = replay_inputs(rows, tile_start, tile_end, img_h, img_w,
                                    tile_size, chunk, max_pairs_per_tile)
    return {v: time_fn(lambda v=v: gsplat_cuda.probe_fwd(
                padded, tile_start, tile_end, cnt, variant=v, **kw))
            for v in gsplat_cuda.PROBE_VARIANTS}


def main(n: int = 1 << 20, reps: int = 5) -> dict:
    """Print and return {(variant, chunk): ms} on the current CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("probe_kernel times kernels on an NVIDIA GPU; "
                           "torch.cuda.is_available() is False")
    rows, tile_start, tile_end = build_scene(n, H, W, TS)
    pairs = (tile_end - tile_start).long()
    print(f"probe_kernel: {n} Gaussians, {W}x{H}, tile {TS}, pairs="
          f"{int(pairs.sum())} nonempty_tiles={int((pairs > 0).sum())} "
          f"max/tile={int(pairs.max())} mean/tile="
          f"{float(pairs.float().mean()):.1f} on "
          f"{torch.cuda.get_device_name(0)}")
    out = {}
    for chunk in CHUNKS:
        times = run_variants(rows, tile_start, tile_end, H, W, TS, chunk,
                             MAX_PAIRS, lambda f: timing.cuda_ms(f, reps))
        for v, ms in times.items():
            out[(v, chunk)] = ms
            print(f"{v:8s} chunk={chunk:4d}: {ms:9.4f} ms "
                  f"({ms / times['full']:.3f} of full)", flush=True)
    return out


if __name__ == "__main__":
    main()
