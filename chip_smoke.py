#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (goliath_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:
  1. the card's name and power limit (nvidia-smi);
  2. build of the hand-written CUDA kernels (torch.utils.cpp_extension.load:
     one nvcc per source and the bindings, run in parallel by ninja) and its
     time;
  3. K4 (int32 inclusive scan) against torch.cumsum at M = 1,048,576 and
     3,145,728, exactly equal, totals above 2^24 included;
  4. K1 (tile compositor forward) against its plain PyTorch version on the
     pair rows of a full-width frame (configs/rgca.yml: uv 1024, i.e.
     1,048,576 Gaussians, 2048x1334 image, random weights from seed 0);
  5. K2 (tile compositor backward) against its plain version on the same
     frame with seeded upstream gradients, all 16 columns; the whole
     backward (K2, then the per-prim reduce on K3) against autograd through
     the plain forward on one row of tiles, and the K3 reduce against
     index_add_ of the same pair gradients;
  6. K3 (float32 column scan) against torch.cumsum at [10, 3,145,728], on
     random values and on K2's pair gradients;
  7. the eval path: goliath_torch.scripts.run_test.main on configs/rgca.yml
     with synthetic data at full width and 3 test frames, with every
     kernel's launch count set to 0 just before and read just after;
  8. the training path: goliath_torch.scripts.run_train.main on
     configs/rgca.yml with synthetic data at full width, the config's batch
     size 4 and 3 steps, counts again set to 0 just before and read just
     after: finite losses, moving parameters, a gradient in every parameter
     group, the expected launch counts, step times, peak memory and one
     profiled step;
  9. both entry points on configs/rgca_synthetic.yml on the card against
     the CPU (plain versions) as the small-input reference;
 10. per kernel: check result, launches on the two paths, time, the plain
     version's time, the least time the card could take (bound) and the
     library call's time, as one JSON line.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"  # every phase runs here; only the small references use the CPU

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # outside the tensor cores; also used for int32 adds

K1_ATOL = K1_RTOL = 1e-4
SMALL_RTOL = 1e-3
# K2 against its plain version, per column, over the rows that carry a
# gradient: rtol of the entry plus a fraction of the column's typical entry
# (the median |reference|; the columns are heavy-tailed, so a fraction of
# the largest entry would exceed most entries). The same float32 sums over a
# tile's pixels are taken in other orders, and terms of both signs cancel.
K2_RTOL, K2_ATOL_OF_TYPICAL = 1e-3, 5e-2
# gradients of the compositor against autograd through the plain forward,
# per gradient, over the prims that carry one: as above, plus the rounding
# of the per-prim reduce, whose sums are differences of two float32 prefixes:
# a fraction of the column's largest running sum (K3 itself is measured at
# 2.5e-7 to 3e-7 of it per prefix). That rounding also reaches the prims
# that carry no gradient, so every prim is held to the tolerance.
BWD_RTOL, BWD_ATOL_OF_TYPICAL, BWD_ATOL_OF_RUNNING = 1e-3, 5e-2, 1e-6
# K3 against a float64 scan and against the float32 torch.cumsum, as
# fractions of each row's largest running sum (float32 sums of 3M items in
# other orders; torch.cumsum itself is that far from the float64 scan)
K3_TOL_F64, K3_TOL_F32 = 2e-6, 1e-5
TRAIN_STEPS, TRAIN_BATCH = 3, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def entries_over(got, ref, carries, rtol: float, atol_of_typical: float,
                 atol_extra: float = 0.0):
    """Hold ``got`` against ``ref`` ([rows] or [rows, k]) at ``rtol * |ref| +
    atol_of_typical * typical + atol_extra``, where typical is the median
    |ref| over the rows that ``carries`` marks (those with a gradient).
    Returns (largest abs error, largest |ref|, typical, entries over the
    tolerance, and the margin used: the largest error beyond ``rtol * |ref|``
    as a fraction of the absolute allowance, over 1 exactly where an entry
    fails)."""
    if not bool(carries.any()):
        return 0.0, 0.0, 0.0, int((got != ref).sum()), 0.0
    diff = (got - ref).abs()
    typical = float(ref[carries].abs().median())
    atol = atol_of_typical * typical + atol_extra
    beyond = diff - rtol * ref.abs()
    n_over = int((beyond > atol).sum())
    worst = float(beyond.max().clamp(min=0.0))
    used = worst / atol if atol > 0 else (math.inf if worst > 0 else 0.0)
    return float(diff.max()), float(ref.abs().max()), typical, n_over, used


def replaces(gc, name: str) -> str:
    """file:line in the repo of the TPU kernel that `name` replaces. The
    port names no module of the JAX reference package, so the package is
    the directory beside it that holds the file."""
    path, line = gc.REPLACES[name].split(":")
    hits = sorted(ROOT.glob(f"*/{path}"))
    return f"{hits[0].relative_to(ROOT)}:{line}" if hits else gc.REPLACES[name]


def check_k4(gc, torch):
    """Phase 3: K4 equals torch.cumsum exactly."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    worst = 0
    for M, hi in ((1_048_576, 64), (3_145_728, 64), (3_145_728, 2)):
        x = torch.randint(0, hi, (M,), generator=gen, device=DEVICE,
                          dtype=torch.int32)
        got = gc.cumsum1d(x)
        ref = torch.cumsum(x, 0, dtype=torch.int32)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        total = int(ref[-1])
        log(f"K4 M={M} total={total} (2^24={1 << 24}) max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"K4 differs from torch.cumsum at M={M}")
        worst = max(worst, err)
    return worst


def capture_frame(torch, device, card_line):
    """Run the full-width model on one synthetic frame: keep the inputs the
    main path hands to K1 (per-prim arrays and binning) and to K4 (the two
    scans of the binning), then profile a second run of the same frame
    (device time by kernel, and the device's idle share of the wall time)."""
    from goliath_torch.config import Config, load_config, load_from_config
    from goliath_torch.ops import binning, gsplat_cuda
    from goliath_torch.scripts.run_train import build_dataset
    from goliath_torch.test import to_device

    cfg = load_config(str(ROOT / "configs" / "rgca.yml"))
    ds = build_dataset(FULL_DATA)
    mc = Config.wrap(dict(cfg.model))
    mc.pop("cal", None)
    mc["learn_blur"] = False
    model = load_from_config(mc, assets=ds.static_assets, device=device)
    sample = ds[0]
    batch = to_device({k: v[None] for k, v in sample.items()
                       if not isinstance(v, str)}, device)
    seen = {"k1": None, "k4": []}
    orig_rt, orig_cs = gsplat_cuda.rasterize_tiled, binning.cumsum1d

    def rt(*args):
        seen["k1"] = args
        return orig_rt(*args)

    def cs(x):
        seen["k4"].append(x.clone())
        return orig_cs(x)

    gsplat_cuda.rasterize_tiled, binning.cumsum1d = rt, cs
    try:
        with torch.no_grad():
            model.apply(batch)
    finally:
        gsplat_cuda.rasterize_tiled, binning.cumsum1d = orig_rt, orig_cs
    torch.cuda.synchronize()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.apply(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an operator's device time repeats its kernels'
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profiled frame (model forward, one sample): wall {wall_ms:.3f} ms,"
        f" device busy {busy:.3f} ms in {sum(r[1] for r in rows)} kernels, "
        f"idle share {max(0.0, 1.0 - busy / wall_ms):.3f} on {card_line}")
    for ms, count, key in rows[:12]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    del model
    return seen


def check_k1(gc, torch, args, frame):
    """Phase 4: K1 against its plain version on a full-width frame. Leaves
    the pair rows, K1's outputs and the evaluation count in ``frame``."""
    (xys, conics, op_s, chan, valid, sorted_prim, tile_start, tile_end,
     _perm, _offsets, _ends, img_h, img_w, ts, maxpp, chunk, ntx,
     nty) = args
    nchunks = maxpp // chunk + 1
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             sorted_prim, nchunks * chunk)
    kw = dict(img_h=img_h, img_w=img_w, tile_size=ts, ntx=ntx, nty=nty,
              chunk=chunk, max_pairs_per_tile=maxpp)
    img, T, cnt = gc.compositor_fwd(rows, tile_start, tile_end, **kw)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, tile_start, tile_end,
                                                **kw)
    torch.cuda.synchronize()
    err_img = float((img - p_img).abs().max())
    err_rgb = float((img[:3] - p_img[:3]).abs().max())
    err_T = float((T - p_T).abs().max())
    cnt_diff = int((cnt != p_cnt).sum())
    close = bool(torch.allclose(img, p_img, atol=K1_ATOL, rtol=K1_RTOL)
                 and torch.allclose(T, p_T, atol=K1_ATOL, rtol=K1_RTOL))
    pairs = tile_end.long() - tile_start.long()
    log(f"K1 rows={tuple(rows.shape)} tiles={ntx * nty} pairs={int(pairs.sum())}"
        f" max_pairs_in_a_tile={int(pairs.max())} tiles_cut_early="
        f"{int((cnt < nchunks).sum())} max_abs_err rgb={err_rgb:.3e} "
        f"all channels (depth ~{float(p_img[3].max()):.0f})={err_img:.3e} "
        f"T={err_T:.3e} cnt_mismatches={cnt_diff} "
        f"(tolerance atol {K1_ATOL} rtol {K1_RTOL}, cnt exact)")
    if not close or cnt_diff:
        raise AssertionError("K1 differs from its plain version")
    if not (torch.isfinite(img).all() and torch.isfinite(T).all()):
        raise AssertionError("K1 output is not finite")

    # data-dependent work: rows each tile composites, per processed block
    start = tile_start.long().cpu()
    end = tile_end.long().cpu()
    c = cnt.long().cpu()
    evals = 0
    for j in range(nchunks):
        base = (start // chunk + j) * chunk
        lo = torch.maximum(base, start)
        hi = torch.minimum(base + chunk, end)
        evals += int(((hi - lo).clamp(min=0) * (c > j)).sum())
    evals *= ts * ts
    ops = 16 * evals  # the alpha test of each (pair, pixel) evaluated
    nbytes = (rows.numel() * 4 + 2 * tile_start.numel() * 4
              + img.numel() * 4 + T.numel() * 4 + cnt.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    ms = cuda_ms(lambda: gc.compositor_fwd(rows, tile_start, tile_end, **kw),
                 reps=20)
    plain_ms = cuda_ms(lambda: gc.compositor_fwd_plain(
        rows, tile_start, tile_end, **kw), reps=2, warmup=1)
    log(f"K1 timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({evals} pair-pixel evaluations, "
        f"{nbytes} bytes)")
    frame.update(rows=rows, img=img, T=T, cnt=cnt, evals=evals)
    return dict(max_abs_err=max(err_img, err_T), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_k2(gc, torch, args, frame):
    """Phase 5a: K2 against its plain version on the full-width frame, with
    seeded upstream gradients. Leaves K2's pair gradients in ``frame``."""
    (_xys, _conics, _op, chan, _valid, sorted_prim, tile_start, tile_end,
     _perm, _offsets, _ends, _h, _w, ts, _maxpp, chunk, ntx, nty) = args
    rows, img, T, cnt = (frame[k] for k in ("rows", "img", "T", "cnt"))
    C = chan.shape[1]
    budget = sorted_prim.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    d_out = torch.randn(img.shape, generator=gen, device=DEVICE)
    d_T = torch.randn(T.shape, generator=gen, device=DEVICE)
    call = (rows, tile_start, tile_end, cnt, d_out, d_T, T, img, ts, ntx, nty,
            chunk, budget)
    got = gc.pair_grads(*call)
    torch.cuda.synchronize()
    counts = {}
    ref = gc.pair_grads_plain(*call, counts=counts)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("K2 output is not finite")
    groups = {"position": (0, 2), "conic": (2, 5), "opacity": (5, 6),
              "color": (6, 6 + C), "pad": (6 + C, gc.PAIR_GRAD_COLS)}
    carries = ref.abs().sum(1) > 0
    worst, bad = 0.0, []
    for name, (lo, hi) in groups.items():
        res = [entries_over(got[:, k], ref[:, k], carries, K2_RTOL,
                            K2_ATOL_OF_TYPICAL) for k in range(lo, hi)]
        worst = max([worst] + [r[0] for r in res])
        log(f"K2 {name} columns {lo}..{hi - 1}: max_abs_err "
            f"{[f'{r[0]:.3e}' for r in res]}, largest |ref| "
            f"{[f'{r[1]:.3e}' for r in res]}, median |ref| "
            f"{[f'{r[2]:.3e}' for r in res]}, entries over tolerance "
            f"{[r[3] for r in res]}, share of the absolute allowance used "
            f"{[f'{r[4]:.3f}' for r in res]}")
        if any(r[3] for r in res):
            bad.append(name)
    written = int(carries.sum())
    same_zero = bool(torch.equal(got.abs().sum(1) == 0, ~carries))
    log(f"K2 out={tuple(got.shape)} rows with a gradient={written} of "
        f"{budget}, zero rows agree={same_zero} (tolerance per column: rtol "
        f"{K2_RTOL} + {K2_ATOL_OF_TYPICAL} of the column's median |ref| over"
        f" those rows; all other rows exactly zero)")
    if bad or not same_zero:
        raise AssertionError(f"K2 differs from its plain version in {bad}")

    # 16 operations for the alpha test of every evaluation the forward's
    # cnt reaches, 22 + 4C more for each that passes it (counted in
    # csrc/compositor_bwd.cu): the terms of the others are zero by definition
    evals = frame["evals"]
    kept = int(counts["kept"])
    ops = 16 * evals + (22 + 4 * C) * kept
    nbytes = (rows.numel() * 4 + 3 * tile_start.numel() * 4
              + (2 * img.numel() + 2 * T.numel()) * 4 + got.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, ops)
    ms = cuda_ms(lambda: gc.pair_grads(*call), reps=10)
    plain_ms = cuda_ms(lambda: gc.pair_grads_plain(*call), reps=1, warmup=0)
    log(f"K2 timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({evals} pair-pixel evaluations of 16 "
        f"operations, {kept} of them kept ({kept / max(evals, 1):.4f}) with "
        f"{22 + 4 * C} more, {nbytes} bytes; {ms / b_ms:.1f}x the bound)")
    frame["pair_grads"] = got
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def check_backward(gc, torch, args, frame):
    """Phase 5b: the whole compositor backward (K2, then the per-prim reduce
    on K3) against torch.autograd.grad through pack_pair_rows and
    compositor_fwd_plain, on the middle row of tiles of the frame (autograd
    keeps every [tiles, chunk, pixels] temporary of the plain version, so
    the whole frame does not fit); then the K3 reduce of the full frame's
    pair gradients against index_add_ of the same rows."""
    from goliath_torch.ops import gsplat

    (xys, conics, op_s, chan, valid, sorted_prim, tile_start, tile_end,
     perm, offsets, ends, _h, img_w, ts, maxpp, chunk, ntx, nty) = args
    C = chan.shape[1]
    row = nty // 2
    band = slice(row * ntx, (row + 1) * ntx)
    b_start = tile_start[band].contiguous()
    b_end = tile_end[band].contiguous()
    shift = torch.tensor([0.0, float(row * ts)], device=xys.device)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    d_out = torch.randn((C, ts, img_w), generator=gen, device=DEVICE)
    d_T = torch.randn((ts, img_w), generator=gen, device=DEVICE)

    def leaves():
        return [t.detach().clone().requires_grad_(True)
                for t in (xys - shift, conics, op_s, chan)]

    def objective(out, T):
        return (out * d_out).sum() + (T * d_T).sum()

    mine = leaves()
    out, T = gc.rasterize_tiled(*mine, valid, sorted_prim, b_start, b_end,
                                perm, offsets, ends, ts, img_w, ts, maxpp,
                                chunk, ntx, 1)
    seen = []   # the band's pair gradients, as the backward hands them on
    orig_pg = gc.pair_grads

    def pg(*a):
        seen.append(orig_pg(*a))
        return seen[-1]

    gc.pair_grads = pg
    try:
        got = torch.autograd.grad(objective(out, T), mine)
    finally:
        gc.pair_grads = orig_pg
    band_presort = torch.empty_like(seen[0][:, :6 + C].T).index_copy_(
        1, perm.long(), seen[0][:, :6 + C].T)
    band_run_max = torch.cumsum(band_presort.double(), 1).abs().amax(1)
    theirs = leaves()
    rows = gc.pack_pair_rows(*theirs, valid.float(), sorted_prim,
                             (maxpp // chunk + 1) * chunk)
    p_out, p_T, _ = gc.compositor_fwd_plain(rows, b_start, b_end, ts, img_w,
                                            ts, ntx, 1, chunk, maxpp)
    ref = torch.autograd.grad(objective(p_out, p_T), theirs)
    torch.cuda.synchronize()
    bad = []
    columns = {"xys": (0, 2), "conics": (2, 5), "opacities": (5, 6),
               "colors": (6, 6 + C)}
    for (name, (lo, hi)), g, r in zip(columns.items(), got, ref):
        carries = r.abs().reshape(len(r), -1).sum(1) > 0
        prefix = BWD_ATOL_OF_RUNNING * float(band_run_max[lo:hi].max())
        err, scale, typical, n_over, used = entries_over(
            g, r, carries, BWD_RTOL, BWD_ATOL_OF_TYPICAL, prefix)
        log(f"backward d{name}: max_abs_err {err:.3e}, largest |ref| "
            f"{scale:.3e}, median |ref| {typical:.3e}, largest running sum "
            f"of the reduce {float(band_run_max[lo:hi].max()):.3e} (allowance"
            f" {prefix:.3e}), prims with a gradient {int(carries.sum())}, "
            f"entries over tolerance {n_over}, share of the absolute "
            f"allowance used {used:.3f}")
        if n_over or not scale > 0 or not torch.isfinite(g).all():
            bad.append(name)
    log(f"backward on tile row {row} ({ntx} tiles, {int((b_end - b_start).sum())}"
        f" pairs) against autograd through the plain forward (tolerance per "
        f"gradient, every prim: rtol {BWD_RTOL} + {BWD_ATOL_OF_TYPICAL} of "
        f"the median |ref| over the prims that carry one + "
        f"{BWD_ATOL_OF_RUNNING} of the reduce's largest running sum)")
    if bad:
        raise AssertionError(f"the compositor backward differs in {bad}")

    # the K3 route of the full frame's pair gradients against index_add_
    sorted_g = frame["pair_grads"][:, :6 + C]
    acc = gsplat.reduce_sorted_pair_grads(sorted_g, perm, offsets, ends)
    lib = sorted_g.new_zeros(6 + C, xys.shape[0]).index_add_(
        1, sorted_prim.long(), sorted_g.T.contiguous())
    presort = torch.empty_like(sorted_g.T).index_copy_(1, perm.long(),
                                                       sorted_g.T)
    run_max = torch.cumsum(presort.double(), 1).abs().amax(1).float()
    err = (acc - lib).abs().amax(1)
    log(f"K3 reduce vs index_add_ per column: max_abs_err "
        f"{[f'{float(e):.3e}' for e in err]}, largest running sums "
        f"{[f'{float(m):.3e}' for m in run_max]}, largest per-prim sums "
        f"{[f'{float(m):.3e}' for m in lib.abs().amax(1)]} (tolerance "
        f"{2 * K3_TOL_F64} of the running sum: two prefixes cancel)")
    if not bool((err <= 2 * K3_TOL_F64 * run_max).all()):
        raise AssertionError("the K3 reduce differs from index_add_")
    frame["presort"] = presort


def check_k3(gc, torch, frame):
    """Phase 6: K3 against torch.cumsum at [10, 3,145,728], on random values
    and on the frame's pair gradients in pre-sort order."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    real = frame["presort"].contiguous()
    F, M = real.shape
    cases = {"random": torch.randn((F, M), generator=gen, device=DEVICE),
             "pair gradients": real}
    worst = 0.0
    for name, x in cases.items():
        got = gc.cumsum_cols(x)
        plain = gc.cumsum_cols_plain(x)
        ref = torch.cumsum(x.double(), dim=1)
        torch.cuda.synchronize()
        scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        diff = (got - plain).abs()
        e64 = float(((got.double() - ref).abs() / scale).max())
        e32 = float((diff.double() / scale).max())
        p64 = float(((plain.double() - ref).abs() / scale).max())
        worst = max(worst, float(diff.max()))
        log(f"K3 [{F}, {M}] {name}: error as a fraction of each row's largest"
            f" running sum: against a float64 scan {e64:.3e} (tolerance "
            f"{K3_TOL_F64}; torch.cumsum float32 itself: {p64:.3e}), against "
            f"torch.cumsum float32 {e32:.3e} (tolerance {K3_TOL_F32})")
        if not (e64 <= K3_TOL_F64 and e32 <= K3_TOL_F32):
            raise AssertionError(f"K3 differs from torch.cumsum on {name}")
    x = cases["pair gradients"]
    ms = cuda_ms(lambda: gc.cumsum_cols(x), reps=50)
    # the plain version is the library call, torch.cumsum(x, 1): one timing
    library_ms = cuda_ms(lambda: gc.cumsum_cols_plain(x), reps=50)
    b_ms, b_by = bound_ms(2 * F * M * 4, F * M)
    log(f"K3 timing [{F}, {M}]: {ms:.4f} ms, plain = torch.cumsum "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({2 * F * M * 4} bytes)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


def time_k4(gc, torch, inputs):
    """K4 per render: both scans of the binning, at the main path's
    inputs ([N] tile counts and [budget] slot marks)."""
    errs = []
    for x in inputs:
        errs.append(int((gc.cumsum1d(x).long()
                         - gc.cumsum1d_plain(x).long()).abs().max()))
    ms = sum(cuda_ms(lambda x=x: gc.cumsum1d(x), reps=100) for x in inputs)
    plain_ms = sum(cuda_ms(lambda x=x: gc.cumsum1d_plain(x), reps=100)
                   for x in inputs)
    library_ms = sum(cuda_ms(lambda x=x: torch.cumsum(x, 0, dtype=x.dtype),
                             reps=100) for x in inputs)
    n = sum(x.numel() for x in inputs)
    b_ms, b_by = bound_ms(8 * n, n)
    log(f"K4 timing per render (M={[x.numel() for x in inputs]}): {ms:.4f} ms"
        f", plain {plain_ms:.4f} ms, torch.cumsum {library_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


FULL_DATA = {"synthetic": True, "img_h": 2048, "img_w": 1334,
             "uv_size": 1024, "n_cams": 4, "n_frames": 8}


def main_path(gc, torch, card_line):
    """Phase 7: run_test.main at full width, counts reset just before."""
    from goliath_torch.config import load_config
    from goliath_torch.scripts import run_test

    cfg = load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
        f"test.data={yaml_flow(FULL_DATA)}", "test.ckpt=null",
        "test.n_test_frames=3",
        "test.vis_path=null"])
    alphas = []
    orig_rt = gc.rasterize_tiled

    def rt(*args):
        out, T = orig_rt(*args)
        alphas.append(T)
        return out, T

    frames = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.rasterize_tiled = rt
    gc.reset_launch_counts()
    try:
        means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    finally:
        gc.rasterize_tiled = orig_rt
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {launches}")
    log(f"eval means: {json.dumps(means)}")
    for i, s in enumerate(frames):
        log(f"frame {i}: wall {s:.4f} s on {card_line}")
    log(f"peak device memory: {peak / 2**30:.3f} GiB on {card_line}")
    covered = [float((1.0 - T > 0.01).float().mean()) for T in alphas]
    log(f"alpha > 0.01 over fractions {covered} of each frame, mean alpha "
        f"{[round(float((1.0 - T).mean()), 4) for T in alphas]}")
    if len(frames) != 3 or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError("eval losses are not finite")
    if not all(f > 0.0 for f in covered):
        raise AssertionError("a frame rendered nothing")
    # the eval path runs no backward: K1 once and K4 twice per frame
    missing = [k for k in ("compositor_fwd", "cumsum1d") if not launches[k]]
    if missing:
        raise AssertionError(f"kernels not launched on the eval path: "
                             f"{missing}")
    return launches


def yaml_flow(d) -> str:
    return "{" + ", ".join(f"{k}: {json.dumps(v)}" for k, v in d.items()) + "}"


class StepProbe:
    """Wraps goliath_torch.train.make_train_step for one run of
    run_train.main: per step, the wall time (ending in a synchronise), the
    total loss and, per parameter group, whether the gradient that reached
    the optimizer was finite and non-zero. ``profile_step`` names one step
    to run under torch.profiler."""

    def __init__(self, torch, train_lib, profile_step=None, keep_grads=False):
        self.torch, self.train_lib = torch, train_lib
        self.profile_step = profile_step
        self.keep_grads = keep_grads
        self.seconds, self.totals, self.groups, self.grads = [], [], {}, {}
        self.profile = None
        self._orig = train_lib.make_train_step

    def __enter__(self):
        self.train_lib.make_train_step = self._make
        return self

    def __exit__(self, *exc):
        self.train_lib.make_train_step = self._orig

    def _make(self, model, loss_fn, optimizer):
        torch = self.torch
        inner_step = optimizer.step

        def probed_optimizer_step():
            for group in optimizer.inner.param_groups:
                gs = [p.grad for p in group["params"] if p.grad is not None]
                seen = self.groups.setdefault(group["name"], [True, False])
                seen[0] &= all(bool(torch.isfinite(g).all()) for g in gs)
                seen[1] |= any(bool(g.abs().sum() > 0) for g in gs)
            if self.keep_grads and not self.grads:   # the first step's
                self.grads.update(
                    (name, p.grad.detach().cpu().clone())
                    for name, p in model.module.named_parameters()
                    if p.grad is not None)
            inner_step()

        optimizer.step = probed_optimizer_step
        step = self._orig(model, loss_fn, optimizer)

        def timed(batch, iteration):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(self.seconds) == self.profile_step:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(batch, iteration)
                    torch.cuda.synchronize()
                self.profile = prof
            else:
                out = step(batch, iteration)
                torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.totals.append(float(out[0]))
            return out

        return timed


def train_path(gc, torch, card_line):
    """Phase 8: run_train.main at full width (configs/rgca.yml, synthetic
    data at 2048x1334 and uv 1024, batch 4, 3 steps, no resume), counts
    reset just before."""
    from torch.autograd import DeviceType

    from goliath_torch import train as train_lib
    from goliath_torch.config import load_config
    from goliath_torch.scripts import run_train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        cfg = load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
            f"data={yaml_flow(FULL_DATA)}", f"train.run_dir={run_dir}",
            f"train.n_max_iters={TRAIN_STEPS}", "train.resume=false",
            "train.log_every_n_steps=1"])
        if cfg.dataloader.batch_size != TRAIN_BATCH:
            raise AssertionError("configs/rgca.yml no longer trains at batch "
                                 f"{TRAIN_BATCH}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gc.reset_launch_counts()
        with StepProbe(torch, train_lib, profile_step=TRAIN_STEPS - 1) as probe:
            iteration, last = run_train.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
            launches = dict(gc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        with open(Path(run_dir) / "tb" / "scalars.jsonl") as f:
            scalars = [json.loads(line) for line in f]
        written = sorted(p.name for p in
                         (Path(run_dir) / "checkpoints").iterdir())
    log(f"train path launches: {launches}")
    logged = {}
    for rec in scalars:
        logged.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
    for step in sorted(logged):
        log(f"step {step} losses: {json.dumps(logged[step])}")
    for i, sec in enumerate(probe.seconds):
        note = " (under torch.profiler)" if i == probe.profile_step else ""
        log(f"train step {i}: wall {sec:.4f} s{note}, total loss "
            f"{probe.totals[i]:.6f}, batch {TRAIN_BATCH} on {card_line}")
    log(f"peak device memory (training, batch {TRAIN_BATCH}): "
        f"{peak / 2**30:.3f} GiB on {card_line}")
    log(f"gradients per parameter group [all finite, some non-zero]: "
        f"{probe.groups}; checkpoints written: {written}")
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in probe.profile.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    wall_ms = probe.seconds[probe.profile_step] * 1e3
    log(f"profiled train step {probe.profile_step}: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms in {sum(r[1] for r in rows)} kernels, "
        f"idle share {max(0.0, 1.0 - busy / wall_ms):.3f} on {card_line}")
    for ms, count, key in rows[:14]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    # the backward nodes by the device time of the kernels under them
    nodes = [(e.device_time_total / 1e3, e.count, e.key.split(": ", 1)[-1])
             for e in probe.profile.key_averages()
             if e.key.startswith("autograd::engine::evaluate_function")]
    nodes.sort(reverse=True)
    log("busiest backward nodes of that step (device ms, calls): " + ", ".join(
        f"{key} {ms:.1f} x{count}" for ms, count, key in nodes[:8]))

    if iteration != TRAIN_STEPS or len(probe.totals) != TRAIN_STEPS:
        raise AssertionError(f"took {len(probe.totals)} steps, not "
                             f"{TRAIN_STEPS}")
    values = [v for step in logged.values() for v in step.values()]
    if not all(math.isfinite(v) for v in values + probe.totals
               + list(last.values())):
        raise AssertionError("a training loss is not finite")
    if len(logged) != TRAIN_STEPS or "Losses/loss_total" not in logged[0]:
        raise AssertionError("the step losses were not logged")
    if probe.totals[-1] == probe.totals[0]:
        raise AssertionError("the total loss did not move in 3 steps")
    expected_groups = set(cfg.optimizer.per_module)
    if set(probe.groups) != expected_groups or not all(
            finite and nonzero for finite, nonzero in probe.groups.values()):
        raise AssertionError(f"parameter groups without a finite, non-zero "
                             f"gradient: {probe.groups}")
    # K2 and K3 once per sample per step; K1 also once per sample of the
    # train=False forward the loop's summary takes at iteration 0; K4 twice
    # per render
    n = TRAIN_BATCH * TRAIN_STEPS
    expected = {"pair_grads": n, "cumsum_cols": n,
                "compositor_fwd": n + TRAIN_BATCH,
                "cumsum1d": 2 * (n + TRAIN_BATCH)}
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if "latest" not in written:
        raise AssertionError("no checkpoint was written")
    return launches


def small_reference(torch):
    """Phase 9: both entry points at configs/rgca_synthetic.yml size on the
    card (kernels) against the CPU (plain versions): the eval means, and two
    training steps (the losses of the second depend on the first one's
    update) with the gradients of the first."""
    from goliath_torch import train as train_lib
    from goliath_torch.config import load_config
    from goliath_torch.scripts import run_test, run_train

    small = str(ROOT / "configs" / "rgca_synthetic.yml")
    cfg = load_config(small, overrides=["test.ckpt=null",
                                        "test.vis_path=null"])
    got = run_test.main(cfg, device=DEVICE)
    ref = run_test.main(cfg, device="cpu")
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    log(f"small-input reference (card vs CPU plain): max rel diff "
        f"{worst:.3e} (tolerance {SMALL_RTOL})")
    if not worst <= SMALL_RTOL:
        raise AssertionError("the card's run disagrees with the CPU run")

    runs = {}
    for device in (DEVICE, "cpu"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_small_") as d:
            cfg = load_config(small, overrides=[
                f"train.run_dir={d}", "train.n_max_iters=2",
                "train.resume=false"])
            with StepProbe(torch, train_lib, keep_grads=True) as probe:
                _it, last = run_train.main(cfg, device=device)
            runs[device] = (last, probe.grads, probe.totals)
    (got, g_got, t_got), (ref, g_ref, t_ref) = runs[DEVICE], runs["cpu"]
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    worst_g, worst_name = 0.0, None
    for name, r in g_ref.items():
        scale = max(float(r.abs().max()), 1e-30)
        err = float((g_got[name] - r).abs().max()) / scale
        if err > worst_g:
            worst_g, worst_name = err, name
    log(f"small-input training reference (card vs CPU plain): step totals "
        f"{t_got} vs {t_ref}; second step's losses max rel diff {worst:.3e}; "
        f"first step's gradients over {len(g_ref)} parameters: largest error "
        f"as a fraction of the parameter's largest gradient {worst_g:.3e} "
        f"({worst_name}) (tolerance {SMALL_RTOL} each)")
    if not (worst <= SMALL_RTOL and worst_g <= SMALL_RTOL
            and set(g_got) == set(g_ref)):
        raise AssertionError("the card's training steps disagree with the "
                             "CPU's")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from goliath_torch.ops import gsplat_cuda as gc
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card_line = card()
    log(f"card: {card_line}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    failed = []
    entries = {}
    try:
        t0 = time.perf_counter()
        gc.load_kernels()
        log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(gc.SOURCES)}"
            f" (torch.utils.cpp_extension.load into {gc.BUILD_DIR})")
    except Exception:
        traceback.print_exc()
        log("phase build: FAILED")
        return 1

    phases = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        try:
            phases[name] = fn(*args)
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAILED")

    phase("k4_exact", check_k4, gc, torch)
    dev = torch.device(DEVICE)
    phase("capture_frame", capture_frame, torch, dev, card_line)
    if "capture_frame" in phases:
        seen = phases.pop("capture_frame")
        frame = {}
        phase("k1_check", check_k1, gc, torch, seen["k1"], frame)
        phase("k4_timing", time_k4, gc, torch, seen["k4"])
        if "k1_check" in phases:
            phase("k2_check", check_k2, gc, torch, seen["k1"], frame)
        if "k2_check" in phases:
            phase("backward_check", check_backward, gc, torch, seen["k1"],
                  frame)
        if "backward_check" in phases:
            phase("k3_check", check_k3, gc, torch, frame)
        del seen, frame
        torch.cuda.empty_cache()
    phase("main_path", main_path, gc, torch, card_line)
    phase("train_path", train_path, gc, torch, card_line)
    phase("small_reference", small_reference, torch)

    eval_launches = phases.get("main_path", {})
    train_launches = phases.get("train_path", {})
    checks = {"compositor_fwd": ("K1", ["k1_check"]),
              "pair_grads": ("K2", ["k2_check", "backward_check"]),
              "cumsum_cols": ("K3", ["k3_check", "backward_check"]),
              "cumsum1d": ("K4", ["k4_timing", "k4_exact"])}
    verdicts = []
    for name, (kid, keys) in checks.items():
        entries[name] = dict(
            name=name, route="cuda",
            source=f"goliath_torch/ops/csrc/{gc.SOURCES[name]}",
            replaces=replaces(gc, name),
            launches=eval_launches.get(name, 0) + train_launches.get(name, 0),
            launches_eval_path=eval_launches.get(name, 0),
            launches_train_path=train_launches.get(name, 0),
            **phases.get(keys[0], {}))
        ok = all(k in phases for k in keys)
        verdicts.append(f"{kid} {name}: {'ok' if ok else 'FAILED'}")
    log(f"kernels: [{', '.join(verdicts)}]")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": list(entries.values())}))
    log(card_line)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
