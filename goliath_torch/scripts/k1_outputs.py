"""Save K1's and K6's forward outputs on the full-width frames, or compare
this tree's with saved ones, bit for bit:

    python -m goliath_torch.scripts.k1_outputs --save PATH
    python -m goliath_torch.scripts.k1_outputs --compare PATH

On the card, from the root of a checkout. ``--save`` builds the RGCA eval
frame as ``chip_smoke.py``'s ``capture_frame`` does (``configs/rgca.yml``,
random weights from seed 0, synthetic data at 2048x1334) and takes the
inputs of the first step of ``chip_smoke.py``'s batch-folded training path
(batch 4), runs K1 on the frame and K6's forward on the step, and writes
the inputs and the outputs (color, T, cnt) to PATH (about 1 GB).
``--compare`` reads PATH and runs this tree's K1 and K6 on the saved
inputs: the frames' bits depend on the convolution algorithms cuDNN picks
in each process, so both trees must see the same inputs. It prints, per
output, the elements whose bits differ and the largest difference, and
exits 1 if T or cnt differ in any bit or color by more than K1's
tolerance (atol = rtol = 1e-4; the colour sums may round otherwise where
the compiler contracts them otherwise). Both modes print the kernels'
times on these inputs.

It uses only what ``chip_smoke.py``, ``gsplat_cuda`` and
``fold_grads_check`` (its capture of the fold steps) held before the
compositor forward's redesign, so a copy runs unchanged in the tree before
it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from goliath_torch.scripts.fold_grads_check import CaptureFold

ROOT = Path(__file__).resolve().parents[2]
ATOL = RTOL = 1e-4   # K1's tolerance against its plain version
OUTPUTS = ("color", "T", "cnt")


def compare_outputs(label, ref, got):
    """Print, per output, the elements whose bits differ and the largest
    difference; True if T and cnt are bit-equal and color within K1's
    tolerance."""
    ok = True
    for name, r, g in zip(OUTPUTS, ref, got):
        r, g = r.cpu(), g.cpu()
        bits = r.view(torch.int32) != g.view(torch.int32)
        diff = float((g.double() - r.double()).abs().max()) if r.numel() \
            else 0.0
        held = (not bool(bits.any()) if name != "color"
                else bool(torch.allclose(g, r, atol=ATOL, rtol=RTOL)))
        ok &= held and r.shape == g.shape
        print(f"{label} {name} {tuple(r.shape)}: {int(bits.sum())} elements "
              f"differ in their bits, largest difference {diff:.3e} "
              f"({'ok' if held else 'FAILED'})", flush=True)
    return ok


def frame_inputs(cs, gc, card):
    """K1's (rows, tile_start, tile_end, kwargs) on the captured eval frame
    and K6's on the first folded training step, on the host."""
    seen = cs.capture_frame(torch, torch.device(cs.DEVICE), card)
    (xys, conics, op_s, chan, valid, sorted_prim, tile_start, tile_end,
     _perm, _offsets, _ends, img_h, img_w, ts, maxpp, chunk, ntx,
     nty) = seen["k1"]
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             sorted_prim, (maxpp // chunk + 1) * chunk)
    k1 = ((rows.cpu(), tile_start.cpu(), tile_end.cpu()),
          dict(img_h=img_h, img_w=img_w, tile_size=ts, ntx=ntx, nty=nty,
               chunk=chunk, max_pairs_per_tile=maxpp))
    del seen, rows
    store = []
    cs.run_training(gc, torch, card, "fold run", dict(
        compositor_fwd_fold=cs.TRAIN_STEPS + 1,
        pair_grads_fold=cs.TRAIN_STEPS, cumsum_cols=cs.TRAIN_STEPS,
        cumsum1d=2 * (cs.TRAIN_STEPS + 1)), {},
        patch=CaptureFold(gc, store))
    (rows, tile_start, tile_end, _cnt, d_out, *_rest, ts, ntx, nty, chunk,
     _n_pairs, n_imgs, _window) = store[0]
    B, _C, H, W = d_out.shape
    k6 = ((rows, tile_start, tile_end),
          dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=chunk,
               max_pairs_per_tile=cs.load_max_pairs(), n_imgs=n_imgs))
    return {"K1": k1, "K6": k6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--save", metavar="PATH")
    mode.add_argument("--compare", metavar="PATH")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_outputs: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from goliath_torch.ops import gsplat_cuda as gc
    from goliath_torch.utils.timing import cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.load_kernels()
    card = cs.card()
    if opts.save:
        saved = {k: (inputs, kw, None)
                 for k, (inputs, kw) in frame_inputs(cs, gc, card).items()}
    else:
        saved = torch.load(opts.compare, weights_only=False)
    ok = True
    for label, (inputs, kw, ref) in saved.items():
        inputs = tuple(t.to(cs.DEVICE) for t in inputs)
        got = gc.compositor_fwd(*inputs, **kw)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: gc.compositor_fwd(*inputs, **kw), reps=10)
        print(f"{label} on {tuple(inputs[0].shape)} rows, {kw}: {ms:.4f} ms "
              f"on {card}", flush=True)
        got = tuple(t.cpu() for t in got)
        if ref is None:
            saved[label] = (tuple(t.cpu() for t in inputs), kw, got)
        else:
            ok &= compare_outputs(label, ref, got)
        del inputs
        torch.cuda.empty_cache()
    if opts.save:
        torch.save(saved, opts.save)
        print(f"k1_outputs: saved to {opts.save}", flush=True)
        return 0
    print(f"k1_outputs: {'equal' if ok else 'DIFFERENT'} to {opts.compare}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
