#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (goliath_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:
  1. the card's name and power limit (nvidia-smi), and whether the
     tensorstore package (the orbax checkpoint reader's) imports;
  2. build of the hand-written CUDA kernels (torch.utils.cpp_extension.load:
     one nvcc per source and the bindings, run in parallel by ninja) and its
     time;
  3. K4 (int32 inclusive scan, single pass) against torch.cumsum at
     M = 1,048,576 and 3,145,728, exactly equal, totals above 2^24
     included; on the captured frame's two scans, K4 and torch.cumsum timed
     by 100-call event loops and by the profiler's device time per call;
  4. K1 (tile compositor forward) against its plain PyTorch version on the
     pair rows of a full-width frame (configs/rgca.yml: uv 1024, i.e.
     1,048,576 Gaussians, 2048x1334 image, random weights from seed 0),
     with its work (evaluations, (row, warp) visits, visits its
     saturated-warp skip removes) beside its time;
  5. K2 (tile compositor backward) against its plain version on the same
     frame with seeded upstream gradients, all 16 columns, two launches
     bit-equal, and its (pair, warp) visits and warp shuffles in the first
     design and the current one beside its time; the whole
     backward (K2, then the per-prim reduce on K3) against autograd through
     the plain forward on one row of tiles, and the K3 reduce against
     index_add_ of the same pair gradients;
  6. K3 (float32 column scan, single pass) against torch.cumsum at
     [10, 3,145,728], on random values and on K2's pair gradients, and
     against a float64 scan at the folded step's [10, 12,582,912] on
     random values; two calls bit-equal; timed at both shapes; then K7 on
     the same pair gradients as [3,145,728, 10] against a float64 scan,
     20 calls bit-equal;
  7. P1 (the compositor ablation probe, variants of K1): full equal to K1
     bit for bit on the frame, every variant against its plain version on
     small frames, every variant timed on the frame, then
     goliath_torch.scripts.probe_kernel.main on its own 1M-Gaussian scene;
  8. the eval path: goliath_torch.scripts.run_test.main on configs/rgca.yml
     with synthetic data at full width and 3 test frames, with every
     kernel's launch count set to 0 just before and read just after;
  9. the training path: goliath_torch.scripts.run_train.main on
     configs/rgca.yml with synthetic data at full width, the config's batch
     size 4 and 3 steps, counts again set to 0 just before and read just
     after: finite losses, moving parameters, a gradient in every parameter
     group, the expected launch counts, step times, peak memory and one
     profiled step; its checkpoints are kept for phase 33;
 10. the batch-folded training path: the same run with
     GOLIATH_GSPLAT_FOLD=1 (one binning, K6 forward and backward and one
     reduce for the 4 samples), the same checks, its own launch counts, and
     its losses beside the per-sample path's; then K6 forward and backward
     against their plain versions on each fold step's own inputs (timed on
     the first);
 11. the XLA block window (use_pallas false): K1 and K2 in that mode
     against their plain versions on a small frame whose tiles overflow,
     and one run_test frame of configs/rgca_synthetic.yml (use_pallas
     unset) that must take that window alone;
 12. K7 (float32 row scan, single pass) against a float64 scan at
     [2,097,152, 10], a ragged [1,000,003, 10], [3,145,728, 10] and
     [12,582,912, 10] (and against torch.cumsum(x, 0) at the first two),
     timed at the three budgets beside the two-transpose route through K3,
     its device operations a call from the profiler;
     goliath_torch.scripts.profile_reduce.main, and the presort reduce on
     K7 against the channel-first reduce on K3 (K7 on the captured frame's
     pair gradients, with 20 calls bit-equal, runs after phase 6);
 13. the mesh eval path: goliath_torch.scripts.run_test.main on
     configs/mesh_vae.yml at full width (65,536-face sphere, 2048x1334
     image), 3 test frames, counts set to 0 just before and read just
     after, keeping the inputs the run hands to K5 and K4, then one
     profiled forward of its last frame;
 14. K5 (mesh z-buffer) against its plain version on the K5 inputs of the
     mesh path's first frame, face index and depth equal bit for bit, with
     the row-pixel evaluations its per-warp cull makes; K4
     against torch.cumsum on the mesh path's six scans, exactly;
 15. the mesh training path: goliath_torch.scripts.run_train.main on
     configs/mesh_vae.yml at full width (the same data, 7 of the config's
     10 losses), the config's batch size 4 and 3 steps, counts set to 0
     just before and read just after: finite losses that move, a gradient
     in every parameter group, a checkpoint, K5 once per sample and K4
     twice per render (the summary's 4-sample forward at iteration 0
     included), step times, peak memory and one profiled step with its
     busiest backward nodes; then K5 against its plain version on the
     first step's first sample, bit for bit, and the edge-gradient
     backward of that sample on the card against the CPU;
 16. the drivable body model (models/mesh_vae_drivable.py) at full width:
     configs/mesh_vae.yml's model block with the drivable class, its
     encoders and frozen face decoder at the JAX modules' widths (a
     1024-d body code at 512^2, a 256-d face code decoded to 7,306
     vertices and a 1024^2 texture) and the body encoder's logvar_scale
     cut to 0.001 (DRIVABLE_CUTS), every batch's keys renamed and a seeded
     face code added by DrivableData: run_test.main (3 frames, the mesh
     eval path's checks, K5 3 and K4 6, the face decoder's ms by CUDA
     events), then run_train.main (3 steps at batch 4, K5 16 and K4 32,
     the mesh training path's checks, the face decoder's group with no
     gradient and its parameters unchanged); K5 bit for bit and K4 exactly
     on the first eval frame and the first training sample, and that
     sample's edge-gradient backward on the card against the CPU;
 17. the URHand eval path: goliath_torch.scripts.run_test.main on
     configs/urhand.yml at full width (the same sphere and renderer, uv
     1024, texture stacks to 2048, 5 lights: 2 x 5 shadow-map light views
     at 1024x1024 and 3 renders a frame), 3 test frames, counts set to 0
     just before and read just after (K5 13 and K4 26 a frame): finite
     losses, every light view and render covered, shadow maps graded,
     rendered_phys_rgb non-zero, frame times, peak memory and one profiled
     frame; then K5 against its plain version, bit for bit, on the first
     light view and on the first render of the run, and K4 against
     torch.cumsum on the first frame's 26 scans, exactly;
 18. the URHand training path: goliath_torch.scripts.run_train.main on
     configs/urhand.yml at full width (the eval path's data and cuts, cal
     kept), the config's batch size 1, its five losses (effnet and
     effnet_phys on fixed-seed random features, asked for in their loss
     config) and 3 steps, counts set to 0 just before and read just after
     (K5 13 and K4 26 a forward, for the 3 training forwards and the
     summary's forward at iteration 0): finite losses that move, a finite
     gradient in both parameter groups (cal's non-zero unless every step
     drew its identity camera), a checkpoint, step times, peak memory and
     one profiled step with its busiest backward nodes; then K5 against its
     plain version, bit for bit, on the first step's first light view and
     rgb render, K4 against torch.cumsum on its 26 scans, and the
     edge-gradient backward of its rgb and phys renders on the card against
     the CPU;
 19. the MVP hand eval path: goliath_torch.scripts.run_test.main on
     configs/hand_mvp.yml at full width (uv 1024, 4,096 prims of 8x16x16
     voxels, 2048x1334, window 16; the same sphere, n_pose_dims 6 and
     global_scaling 1), 3 test frames, counts set to 0 just before and read
     just after (K4 twice a frame, in the march's binning, and K8 once, the
     march's tiles): finite losses, images and prims, a render that is not
     empty, frame and march times, peak memory and one profiled frame; then
     K4 against torch.cumsum on frame 0's two scans, exactly; the march's
     drops on frame 0, the card's march against the CPU's on the whole
     frame, and march_reference against the tiled march on a 32x32 window
     with nothing dropped; then K8 against its plain version on the card on
     frame 0's march (k8_check: rgba at rtol 1e-4 plus 1e-6 of the
     largest, both routes' deposited taps and in-group drops, both times
     and K8's bound);
 20. the OLAT teacher's eval path: goliath_torch.scripts.run_test.main on
     configs/hand_teacher_mvp.yml at full width (hand_mvp's widths and
     cuts, 5 lights, the 64^3 deep-shadow density grid, 32 shadow steps,
     the UNet at uv 1024 over 5 slabs; mask_l1 on image_mask), 3 test
     frames, counts set to 0 just before and read just after (K4 twice a
     frame, in the march's binning, K8 once and K9 once a light, 15 in
     all, and no other kernel): finite losses,
     images, prim colours and shadows in [0, 1], a render that is not
     empty, each frame's march, density grid, shadow integrals and UNet by
     CUDA events, peak memory and one profiled frame; then K4 against
     torch.cumsum on frame 0's two scans, exactly; the density grid and
     its drops card vs CPU and the shadow integral of each light card vs
     CPU on 131,072 points, on the run's grid (all 0 on the sphere: its
     prims are an eighth of a cell) and on the frame's alpha-carrying
     prims grown 32x (whose shadows must be neither all 0 nor all 1), the
     march's drops, and the exact per-prim shadow against the grid path
     on 1,024 points (logged); then K8 against its plain version on frame
     0's march as in phase 19, and K9 against its plain version on the card
     for each light on all 8,388,608 points, on the run's grid and on the
     grown prims' (k9_check: rtol 1e-5 plus 1e-5), timed beside its bound
     and beside F.grid_sample over the same positions;
 21. the MVP hand training path: goliath_torch.scripts.run_train.main on
     configs/hand_mvp.yml at full width (the eval path's widths and cuts,
     cal kept), the config's batch 4, all six of its losses (vgg on
     fixed-seed random features) and 3 steps, counts set to 0 just before
     and read just after (K4 twice a sample a forward, in the march's
     binning, which the backward does not run again: 32 launches with the
     summary's forward at iteration 0; K8 4, the summary's forward, the
     only march without gradient; no other kernel): finite losses that
     move, a finite, non-zero gradient in all five parameter groups, each
     step's wall time and its marches' forward and backward (each tile
     group marched again) by CUDA events, peak memory and one profiled
     step with its busiest backward nodes and the row gathers' backward;
     then K4 against torch.cumsum on step 0's first two scans, exactly;
     the march's drops on step 0's first sample (no_grad), and the march's
     gradients of the template, primpos, primrot and primscale on its
     2 x 2-tile window, card against CPU;
 22. the OLAT teacher's training path: run_train.main on
     configs/hand_teacher_mvp.yml at full width (its eval widths and cuts,
     5 lights, cal kept), the config's batch 1, its three losses and 3
     steps (K4 8 times, K8 once, K9 20 times, nothing else): its four
     groups' gradients finite
     and non-zero, the default group of the detached geometry's zero and
     its parameters moved by AdamW's decay alone, the same timings; then
     K4 on step 0's two scans, exactly;
 23. the relighting entry point: goliath_torch.scripts.run_vis_relight.main
     on configs/rgca.yml at full width (the eval path's data, weights from
     seed 0) with a seeded 1024x2048 envmap (a sky, a sun reaching ~50,
     noise), 3 frames of the point-light sweep and 3 of the HDRI spin (the
     RGCA envmap branch: the prefilter at 64 samples, three renders a
     frame), counts set to 0 just before and read just after (K1 12, K4
     24, nothing else): the 6 PNGs read back at 2048x1334 and 2048x4002,
     finite and non-constant, the decorator's build, each frame's augment,
     forward, compose_envmap and its 101x101 blur by CUDA events and its
     PNG write, peak memory and one profiled spin frame; then K4 against
     torch.cumsum on the first spin frame's six scans, exactly, and K1
     against its plain version on its third render (the spec_color pass);
 24. the quality recipe: goliath_torch.scripts.run_train.main on
     configs/rgca_synthetic_quality.yml as it stands (256x256, uv 128,
     batch 4, the 48 targets rendered on the card with K5 and K4, the data
     cached on the card) for QUALITY_STEPS steps, then run_test.main from
     its checkpoint directory (through latest) and on the untrained model,
     12 frames of the 12-camera ring each (96 target renders each), counts
     set to 0 just before each run and read just after (exact): finite
     losses, the step time (median), the targets' render time, peak
     memory, PSNR, SSIM and rgb_l1 of both models (and over the held-out
     odd cameras), the trained PSNR at least QUALITY_MIN_GAIN_DB above the
     untrained; then 3 steps of configs/rgca_synthetic_quality2.yml
     (512x512, uv 256) and a 2-frame run_test from its checkpoint
     directory; then K5 against its plain version, bit for bit, on the
     first target render, K4 on its two scans, exactly, and K1 and K2 (XLA
     window) and K3 on the first training step's own arguments;
 25. the RGCA entry points on configs/rgca_synthetic.yml, and the mesh eval
     path and one mesh training step, the URHand eval path and one URHand
     training step, and the hand_mvp eval path, at a small size, on the
     card against the CPU (plain versions) as the small-input reference;
     then the teacher's forward, and one training step of hand_mvp and of
     the teacher, at their small sizes, card vs CPU; then one spin frame at
     configs/rgca_synthetic.yml size, card vs CPU (spec_color, the
     diffuse and specular panels, and the composite panel's mirrorball
     inset and the rest of it apart); then the drivable model's eval means
     and one training step at its small size, card vs CPU;
 26. the capture path (captures in Goliath's zip layout written by
     tests/goliath_capture.py, read through goliath_torch's BodyDataset and
     its native zip reader): the zip reader in use and whether Pillow
     decodes AVIF; a Head capture (13 cameras, 2048x1334 PNG images under
     .avif names, segmentation at half size, uv 1024; 6 train frames
     alternating the fully-lit pattern and 5-light ones, 2 test frames) and
     the writer's time; run_train.main on configs/rgca.yml as it stands
     (batch 4, the loader's 4 threads) for 3 steps, counts set to 0 just
     before and read just after (as the training path's), each step's wall
     time and the time the loop waited for its batch, peak memory, the
     loader's samples per second, no sample dropped; then run_test.main
     from its checkpoint directory on the test split's 12 cameras, 3
     frames (K1 3, K4 6); K4 against torch.cumsum on the run's first two
     scans, exactly;
 27. the texture mean: run_gen_texmean.main on configs/urhand.yml with
     data.partially_lit_only=false (the config's OLAT data gives the
     script no view as it stands) on a fresh Hands capture (8 cameras x
     5 fully-lit frames, a 16,384-face sphere at global_scaling 10,
     2048x1334, uv 1024), counts set to 0 just before and read just after
     (K5 40, K4 80), every view textured, the covered texel share, each
     view's and the run's wall time, the new color_mean.png read back by
     the capture dataset; then K5 against its plain version on the first
     view, bit for bit, and K4 on its two scans, exactly;
 28. both capture paths at 48x48 and uv 64, card against CPU: two RGCA
     training steps on a small Head capture (losses and gradients at
     rtol 1e-3) and run_gen_texmean on a small Hands capture (the PNGs
     equal but within 1e-3 px of a pixel edge);
 29. parallel/, the band render (tile_shard_eval): run_test.main on
     configs/rgca.yml at full width, 3 frames, with model.render's
     tile_shard_mesh a "tile" mesh of 4 shards on the card (4 bands of 512
     rows, a band's pair budget 786,432), counts set to 0 just before and
     read just after (K1 12, K4 24, nothing else), then the same frames
     unsharded: each frame's wall time, its difference from the unsharded
     frame (max |rgb|, max |T|, the share of pixels beyond 2e-5) and the
     pairs each band's budget dropped; K1 against its plain version on
     frame 0's busiest band and K4 on its bands' 8 scans, exactly;
 30. the slab render (prim_shard_eval): render_prim_sharded over 4 slabs
     of 262,144 Gaussians on the unsharded frame 0's render arguments
     (K1 4, K4 8), reported as above;
 31. the data-parallel step (sharded_train): make_sharded_train_step at
     full width and batch 4 on a "data" mesh of 4 shards for 3 steps (K1,
     K2, K3 12, K4 24), its losses and parameters after each step held
     against train.make_train_step's from the same state, batches and
     draws; then 2 steps on a ("data", "tile") mesh of 2 x 2 with the
     model's bands on the same mesh (K1, K2, K3 16, K4 32), its losses
     beside the unsharded ones; step walls and peak memory of all three;
     K2 (with the step's own upstream gradients) and K3 against their
     plain versions on the first band of the first 2-D step;
 32. the dry run (dryrun): goliath_torch.scripts.dryrun_multichip.main at
     4 shards on the card (one sharded step of each of the five families
     at the JAX dry run's tiny shapes, the tile axis on its 2-D mesh
     against the unsharded render), counts set to 0 just before and read
     just after (exactly as its mesh sizes give them);
 33. parallel/ across distinct devices, the card and the host
     (cross_device): one step of each of the dry run's five families at
     its shapes and batch 2 on a "data" mesh of (cuda:0, cpu), the model
     on the card and its replica on the host, each held against
     train.make_train_step on the card from the same state and batch (a
     gradient's spread taking in the unsharded step's own card-to-host
     distance), the replica equal to the model after the step, bit for
     bit, and the card's shard launching the kernels of its sample
     exactly; then the tile axis in 2 bands and a frame in 2 depth slabs
     over the same pair against the unsharded renders on the card;
 34. parallel/ across cards (multi_card_train), where two or more are
     visible (else one line says so): make_sharded_train_step on
     make_mesh(4), or make_mesh(2), at full width and batch 4 for 3 steps,
     each held against the unsharded step on cuda:0 from the same state,
     the replicas equal to the model after each; each card's launches,
     peak memory, and busy time against the wall of one more step under
     torch.profiler; then one eval frame in a band a card, its render
     bit for bit against the same bands on cuda:0 on the same arguments
     and beside the unsharded render;
 35. the checkpoint-render example (run right after phase 9):
     goliath_torch.examples.render_example.render on configs/rgca.yml at
     full width (FULL_DATA) from phase 9's last checkpoint (.pt), then on
     configs/mesh_vae.yml at the mesh eval path's width (MESH_DATA, the
     mesh cuts) from fresh weights, 4 samples each, counts set to 0 just
     before each run and read just after (K1 4 and K4 8; K5 4 and K4 8,
     exactly): each run's wall time and peak memory, its PNG read back at
     the grid's size, the grid within 1 LSB of uint8 of the grid of a
     model built here from the same weights on the run's batch; then K1
     on the RGCA run's first sample against its plain version, K5 on the
     mesh run's first sample bit for bit, and K4 on each run's 8 scans
     against torch.cumsum, exactly;
 36. the rest of the layer library (library_path): each module of
     library_cases forward and backward at its full width on the card
     against the same module with the same state_dict on the CPU on the
     first sample (lib_card_vs_cpu: float32 outputs at LIB_TOL, gradients
     at LIB_GRAD_TOL, or for a module with leaky ReLUs outputs and
     gradients in float64 at LIB_F64_TOL), its float32 time at the whole
     batch by CUDA events and its peak memory;
 37. per kernel (and per mode of a kernel): check result, launches on each
     path, time, the plain version's time, the least time the card could
     take (bound) and the library call's time, as one JSON line.
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
# the largest entry would exceed most entries). The same sums over a tile's
# pixels (float64 in both) are taken in other orders, and terms of both
# signs cancel.
K2_RTOL, K2_ATOL_OF_TYPICAL = 1e-3, 5e-2
# K6's backward on the fold steps after the first: a row that is exactly
# zero in one version may differ from zero only by float32 denormals in the
# other. Pairs behind pixels whose T is ~1e-45 take dalpha from a float64
# numerator of that size, which the kernel's and the plain version's sums
# (in other orders) round to 0 or to the smallest denormals; such rows count
# as zero rows in both (every other entry is held to K2's tolerance).
K6_ZERO_BELOW = 2.0 ** -126   # float32's smallest normal number
# gradients of the compositor against autograd through the plain forward,
# per gradient, over the prims that carry one: as above, plus the rounding
# of the per-prim reduce, whose sums are differences of two float32 prefixes:
# a fraction of the column's largest running sum (K3 itself, with its
# float64 carry, is measured at 2.0e-7 to 2.7e-7 of it per prefix at
# [10, 3,145,728] and 3.4e-7 at [10, 12,582,912]). That rounding also
# reaches the prims that carry no gradient, so every prim is held to the
# tolerance.
BWD_RTOL, BWD_ATOL_OF_TYPICAL, BWD_ATOL_OF_RUNNING = 1e-3, 5e-2, 1e-6
# K3 against a float64 scan and against the float32 torch.cumsum, as
# fractions of each row's largest running sum (float32 sums of 3M items in
# other orders; torch.cumsum itself is that far from the float64 scan)
K3_TOL_F64, K3_TOL_F32 = 2e-6, 1e-5
K3_FOLD_M = 12_582_912   # the folded step's pair budget (4 x 3,145,728)
TRAIN_STEPS, TRAIN_BATCH = 3, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines():
    """nvidia-smi's name and power limit of each visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()


def card() -> str:
    return card_lines()[0]


def tensorstore_line() -> str:
    """Whether the tensorstore package imports here, and its version."""
    from importlib import metadata

    try:
        import tensorstore  # noqa: F401
    except ImportError as e:
        return f"does not import ({e})"
    return f"imports, version {metadata.version('tensorstore')}"


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
    if (ROOT / path).is_file():   # a script of the repo itself
        return gc.REPLACES[name]
    hits = sorted(h for h in ROOT.glob(f"*/{path}")
                  if h.relative_to(ROOT).parts[0] != "goliath_torch")
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


def kernel_rows(prof):
    """(device ms, calls, name) of each kernel a torch.profiler run saw,
    busiest first (kernels only: an operator's device time repeats its
    kernels')."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    return sorted(rows, reverse=True)


def profile_forward(torch, model, batch, card_line, label: str,
                    **apply_kw) -> None:
    """One model forward under torch.profiler: wall time (ending in a
    synchronise), device busy time of the kernels, the device's idle share
    of the wall time and the busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.apply(batch, **apply_kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms in "
        f"{sum(r[1] for r in rows)} kernels, idle share "
        f"{max(0.0, 1.0 - busy / wall_ms):.3f} on {card_line}")
    for ms, count, key in rows[:12]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {key[:90]}")


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

    def rt(*args, **kw):
        seen["k1"] = args
        return orig_rt(*args, **kw)

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

    profile_forward(torch, model, batch, card_line,
                    "profiled frame (model forward, one sample)")
    del model
    return seen


def processed_evals(tile_start, tile_end, cnt, chunk, nchunks, ts,
                    window="pallas"):
    """Data-dependent work of K1 and K2: the (pair, pixel) evaluations of
    the rows each tile composites, over the blocks j < cnt[t] of its
    window."""
    start = tile_start.long().cpu()
    end = tile_end.long().cpu()
    c = cnt.long().cpu()
    first = start if window == "xla" else (start // chunk) * chunk
    evals = 0
    for j in range(nchunks):
        base = first + j * chunk
        lo = base.maximum(start)
        hi = (base + chunk).minimum(end)
        evals += int(((hi - lo).clamp(min=0) * (c > j)).sum())
    return evals * ts * ts


def report_k1_work(counts, evals, label):
    """Log K1's work from ``compositor_fwd_plain(..., counts=)``: the
    evaluations its window reaches (which must equal ``processed_evals``,
    the bound's count), its (row, warp) visits and the visits its
    saturated-warp skip removes."""
    visits, skipped = counts["warp_visits"], counts["skipped_visits"]
    log(f"{label} work: {counts['evals']} pair-pixel evaluations in the "
        f"window, {visits} (row, warp) visits, {skipped} of them skipped "
        f"(every pixel of the warp at T == 0 at the block's start: "
        f"{skipped / max(visits, 1):.4f} of the visits; counted on the "
        f"plain version's T)")
    if counts["evals"] != evals:
        raise AssertionError(f"{label}: the plain version counts "
                             f"{counts['evals']} evaluations, the bound "
                             f"{evals}")


def check_k1(gc, torch, args, frame, timed=True):
    """Phase 4: K1 against its plain version on a full-width frame. Leaves
    the pair rows, K1's outputs and the evaluation count in ``frame``.
    Untimed, it returns the error alone."""
    from goliath_torch.utils.timing import cuda_ms

    (xys, conics, op_s, chan, valid, sorted_prim, tile_start, tile_end,
     _perm, _offsets, _ends, img_h, img_w, ts, maxpp, chunk, ntx,
     nty) = args
    nchunks = maxpp // chunk + 1
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             sorted_prim, nchunks * chunk)
    kw = dict(img_h=img_h, img_w=img_w, tile_size=ts, ntx=ntx, nty=nty,
              chunk=chunk, max_pairs_per_tile=maxpp)
    img, T, cnt = gc.compositor_fwd(rows, tile_start, tile_end, **kw)
    counts = {}
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, tile_start, tile_end,
                                                counts=counts, **kw)
    torch.cuda.synchronize()
    err_img = float((img - p_img).abs().max())
    err_rgb = float((img[:3] - p_img[:3]).abs().max())
    err_T = float((T - p_T).abs().max())
    T_bits = int((T.view(torch.int32) != p_T.view(torch.int32)).sum())
    cnt_diff = int((cnt != p_cnt).sum())
    close = bool(torch.allclose(img, p_img, atol=K1_ATOL, rtol=K1_RTOL)
                 and torch.allclose(T, p_T, atol=K1_ATOL, rtol=K1_RTOL))
    pairs = tile_end.long() - tile_start.long()
    log(f"K1 rows={tuple(rows.shape)} tiles={ntx * nty} pairs={int(pairs.sum())}"
        f" max_pairs_in_a_tile={int(pairs.max())} tiles_cut_early="
        f"{int((cnt < nchunks).sum())} max_abs_err rgb={err_rgb:.3e} "
        f"all channels (depth ~{float(p_img[3].max()):.0f})={err_img:.3e} "
        f"T={err_T:.3e} (pixels whose T bits differ: {T_bits}) "
        f"cnt_mismatches={cnt_diff} (tolerance atol {K1_ATOL} rtol "
        f"{K1_RTOL}, cnt exact)")
    if not close or cnt_diff:
        raise AssertionError("K1 differs from its plain version")
    if not (torch.isfinite(img).all() and torch.isfinite(T).all()):
        raise AssertionError("K1 output is not finite")

    evals = processed_evals(tile_start, tile_end, cnt, chunk, nchunks, ts)
    report_k1_work(counts, evals, "K1")
    frame.update(rows=rows, img=img, T=T, cnt=cnt, evals=evals)
    if not timed:
        return dict(max_abs_err=max(err_img, err_T))
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
    return dict(max_abs_err=max(err_img, err_T), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def compare_pair_grads(gc, torch, got, ref, C, label, zero_below=0.0):
    """Hold K2's (or K6's) per-pair gradients against its plain version's,
    per column, over the rows that carry a gradient; every other row must
    be exactly zero in both. With ``zero_below``, a row whose entries are
    all below it in one version and exactly zero in the other counts as a
    zero row in both (reported). Returns the largest absolute error."""
    groups = {"position": (0, 2), "conic": (2, 5), "opacity": (5, 6),
              "color": (6, 6 + C), "pad": (6 + C, gc.PAIR_GRAD_COLS)}
    carries = ref.abs().sum(1) > 0
    worst, bad = 0.0, []
    for name, (lo, hi) in groups.items():
        res = [entries_over(got[:, k], ref[:, k], carries, K2_RTOL,
                            K2_ATOL_OF_TYPICAL) for k in range(lo, hi)]
        worst = max([worst] + [r[0] for r in res])
        log(f"{label} {name} columns {lo}..{hi - 1}: max_abs_err "
            f"{[f'{r[0]:.3e}' for r in res]}, largest |ref| "
            f"{[f'{r[1]:.3e}' for r in res]}, median |ref| "
            f"{[f'{r[2]:.3e}' for r in res]}, entries over tolerance "
            f"{[r[3] for r in res]}, share of the absolute allowance used "
            f"{[f'{r[4]:.3f}' for r in res]}")
        if any(r[3] for r in res):
            bad.append(name)
    written = int(carries.sum())
    same_zero = bool(torch.equal(got.abs().sum(1) == 0, ~carries))
    if not same_zero and zero_below:
        differ = (got.abs().sum(1) == 0) != ~carries
        largest = float(torch.maximum(got[differ].abs().amax(),
                                      ref[differ].abs().amax()))
        same_zero = largest < zero_below
        log(f"{label}: {int(differ.sum())} rows are exactly zero in one "
            f"version only; their largest |entry| {largest:.3e} (zero rows "
            f"below {zero_below:.3e}: {'held' if same_zero else 'FAILED'})")
    log(f"{label} out={tuple(got.shape)} rows with a gradient={written} of "
        f"{got.shape[0]}, zero rows agree={same_zero} (tolerance per column: "
        f"rtol {K2_RTOL} + {K2_ATOL_OF_TYPICAL} of the column's median |ref|"
        f" over those rows; all other rows exactly zero)")
    if bad or not same_zero:
        raise AssertionError(f"{label} differs from its plain version in "
                             f"{bad or 'its zero rows'}")
    return worst


def k2_bound(rows, tile_start, d_out, T, n_out_rows, evals, kept, C):
    """K2's (and K6's backward's) bound: each of its two passes takes the
    alpha test (16 operations) of every evaluation the forward's cnt
    reaches; an evaluation that passes it takes 27 + 6C more over both
    (counted in csrc/compositor_bwd.cu), the terms of the others being zero
    by definition. The rows, tile bounds, cnt, dout, dT and Tf are read
    once and the pair gradients written once."""
    nbytes = (rows.numel() + 3 * tile_start.numel() + d_out.numel()
              + 2 * T.numel() + n_out_rows * 16) * 4
    return (*bound_ms(nbytes, 32 * evals + (27 + 6 * C) * kept), nbytes)


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def report_warp_visits(gc, torch, counts, ms, label):
    """Log the compositor backward's (pair, warp) visits and warp shuffles
    in each design (``pair_grads_plain(..., counts=)``) beside its time:
    the time the shuffles alone take at one warp shuffle a clock per SM at
    the card's highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    hz = sm_clock_hz()
    for d in gc.K2_WARP_MAPS:
        visits = int(counts["warp_visits"][d])
        shuffles = int(counts["shuffles"][d])
        log(f"{label} warp map {d}: {visits} (pair, warp) visits with a kept "
            f"pixel, {shuffles} warp shuffles -> {shuffles / (sms * hz) * 1e3:.4f}"
            f" ms of shuffle pipe ({sms} SMs at {hz / 1e9:.3f} GHz, one warp "
            f"shuffle a clock per SM); kernel time {ms:.4f} ms")


def check_same_bits(torch, a, b, label):
    """Two launches of a deterministic kernel on the same inputs."""
    same = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    log(f"{label}: two launches on the same inputs give identical bits: "
        f"{same}")
    if not same:
        raise AssertionError(f"{label} is not deterministic")


def check_k2(gc, torch, args, frame):
    """Phase 5a: K2 against its plain version on the full-width frame, with
    seeded upstream gradients. Leaves K2's pair gradients in ``frame``."""
    from goliath_torch.utils.timing import cuda_ms

    (_xys, _conics, _op, chan, _valid, sorted_prim, tile_start, tile_end,
     _perm, _offsets, _ends, _h, _w, ts, _maxpp, chunk, ntx, nty) = args
    rows, img, T, cnt = (frame[k] for k in ("rows", "img", "T", "cnt"))
    C = chan.shape[1]
    budget = sorted_prim.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    d_out = torch.randn(img.shape, generator=gen, device=DEVICE)
    d_T = torch.randn(T.shape, generator=gen, device=DEVICE)
    call = (rows, tile_start, tile_end, cnt, d_out, d_T, T, ts, ntx, nty,
            chunk, budget)
    got = gc.pair_grads(*call)
    torch.cuda.synchronize()
    counts = {}
    ref = gc.pair_grads_plain(*call, counts=counts)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError("K2 output is not finite")
    worst = compare_pair_grads(gc, torch, got, ref, C, "K2")
    check_same_bits(torch, got, gc.pair_grads(*call), "K2")

    evals = frame["evals"]
    kept = int(counts["kept"])
    b_ms, b_by, nbytes = k2_bound(rows, tile_start, d_out, T, budget, evals,
                                  kept, C)
    ms = cuda_ms(lambda: gc.pair_grads(*call), reps=10)
    plain_ms = cuda_ms(lambda: gc.pair_grads_plain(*call), reps=1, warmup=0)
    log(f"K2 timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({evals} pair-pixel evaluations of 2 x 16 "
        f"operations, {kept} of them kept ({kept / max(evals, 1):.4f}) with "
        f"{27 + 6 * C} more, {nbytes} bytes; {ms / b_ms:.1f}x the bound)")
    report_warp_visits(gc, torch, counts, ms, "K2")
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
    and on the frame's pair gradients in pre-sort order, and at the folded
    step's [10, 12,582,912] on random values; two calls on the pair
    gradients bit-equal (K3's carry is folded in tile order)."""
    from goliath_torch.utils.timing import cuda_ms

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    real = frame["presort"].contiguous()
    F, M = real.shape
    cases = {"random": torch.randn((F, M), generator=gen, device=DEVICE),
             "pair gradients": real,
             "random, folded shape": torch.randn(
                 (F, K3_FOLD_M), generator=gen, device=DEVICE)}
    worst = 0.0
    for name, x in cases.items():
        # at 12.6M items torch.cumsum float32 is itself ~1e-5 of the running
        # sum from the float64 scan: there K3 is held to the float64 scan
        f32_ref = x.shape[1] <= M
        got = gc.cumsum_cols(x)
        plain = gc.cumsum_cols_plain(x)
        ref = torch.cumsum(x.double(), dim=1)
        torch.cuda.synchronize()
        scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
        diff = (got - plain).abs()
        e64 = float(((got.double() - ref).abs() / scale).max())
        e32 = float((diff.double() / scale).max())
        p64 = float(((plain.double() - ref).abs() / scale).max())
        del ref, scale
        worst = max(worst, float(diff.max()))
        log(f"K3 {list(x.shape)} {name}: error as a fraction of each row's "
            f"largest running sum: against a float64 scan {e64:.3e} "
            f"(tolerance {K3_TOL_F64}; torch.cumsum float32 itself: "
            f"{p64:.3e}), against torch.cumsum float32 {e32:.3e} (tolerance "
            f"{K3_TOL_F32 if f32_ref else 'none: see the float64 scan'})")
        if not (e64 <= K3_TOL_F64 and (e32 <= K3_TOL_F32 or not f32_ref)):
            raise AssertionError(f"K3 differs from torch.cumsum on {name}")
    x = cases["pair gradients"]
    first, second = gc.cumsum_cols(x), gc.cumsum_cols(x)
    n_diff = int((first.view(torch.int32) != second.view(torch.int32)).sum())
    log(f"K3 determinism: two calls on the pair gradients differ in {n_diff}"
        f" of {first.numel()} entries (bits)")
    if n_diff:
        raise AssertionError("K3 gives other bits on another call")
    ms = cuda_ms(lambda: gc.cumsum_cols(x), reps=50)
    # the plain version is the library call, torch.cumsum(x, 1): one timing
    library_ms = cuda_ms(lambda: gc.cumsum_cols_plain(x), reps=50)
    b_ms, b_by = bound_ms(2 * F * M * 4, F * M)
    log(f"K3 timing [{F}, {M}]: {ms:.4f} ms, plain = torch.cumsum "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({2 * F * M * 4} bytes)")
    xf = cases["random, folded shape"]
    f_ms = cuda_ms(lambda: gc.cumsum_cols(xf), reps=20)
    f_lib = cuda_ms(lambda: gc.cumsum_cols_plain(xf), reps=20)
    fb_ms, fb_by = bound_ms(2 * xf.numel() * 4, xf.numel())
    log(f"K3 timing {list(xf.shape)} (the folded step's shape): {f_ms:.4f} "
        f"ms, plain = torch.cumsum {f_lib:.4f} ms, bound {fb_ms:.4f} ms by "
        f"{fb_by} ({2 * xf.numel() * 4} bytes)")
    return dict(max_abs_err=worst, ms=ms, plain_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, folded_ms=f_ms,
                folded_plain_ms=f_lib, folded_bound_ms=fb_ms)


def profiled_device_ms(torch, fn, calls: int):
    """Device time per call of fn() from torch.profiler: the kernels and
    memsets its calls put on the card, summed, over ``calls`` calls after
    one warm-up call. Returns (ms per call, device operations per call,
    {name: count per call}), or (None, None, {}) where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not rows:
        return None, None, {}
    ms = sum(r[2] for r in rows) / 1e3 / calls
    ops = sum(r[1] for r in rows) / calls
    return ms, ops, {r[0][:60]: r[1] / calls for r in rows}


def time_k4(gc, torch, inputs):
    """K4 per render: both scans of the binning, at the main path's
    inputs ([N] tile counts and [budget] slot marks). Two timings of K4 and
    of torch.cumsum on the same inputs: 100-call CUDA-event loops (they
    time the host's enqueue as much as the card) and the
    device time per call from torch.profiler (every kernel and memset of a
    call), with the device operations each call makes."""
    from goliath_torch.utils.timing import cuda_ms

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
    log(f"K4 timing per render (M={[x.numel() for x in inputs]}), 100-call "
        f"event loops: {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.cumsum "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    prof = {}
    for label, fn in (("K4", gc.cumsum1d),
                      ("torch.cumsum",
                       lambda x: torch.cumsum(x, 0, dtype=torch.int32))):
        per_scan = [profiled_device_ms(torch, lambda x=x: fn(x), 50)
                    for x in inputs]
        if any(r[0] is None for r in per_scan):
            log(f"{label} profiled device time: not measured (the profiler "
                f"saw no device activity)")
            prof[label] = None
            continue
        prof[label] = sum(r[0] for r in per_scan)
        log(f"{label} profiled device time per render: {prof[label]:.4f} ms "
            f"(per scan {[f'{r[0]:.4f}' for r in per_scan]} ms); device "
            f"operations per scan {[r[1] for r in per_scan]}: "
            f"{[r[2] for r in per_scan]}")
    if prof["K4"] is not None and prof["torch.cumsum"] is not None:
        log(f"K4 / torch.cumsum device time per render: "
            f"{prof['K4'] / prof['torch.cumsum']:.3f}")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                profiled_ms=prof["K4"],
                library_profiled_ms=prof["torch.cumsum"])


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

    def rt(*args, **kw):
        out, T = orig_rt(*args, **kw)
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
    the optimizer was finite and non-zero, and the batch's ``camera_idx``
    where it has one (and the model's CalV5 identity camera). ``profile_step``
    names one step to run under torch.profiler."""

    def __init__(self, torch, train_lib, profile_step=None, keep_grads=False,
                 watch=()):
        self.torch, self.train_lib = torch, train_lib
        self.profile_step = profile_step
        self.keep_grads = keep_grads
        # the groups whose parameters are kept as they were before the
        # first update: [(name, parameter, its value then, the group's lr
        # and weight decay)]
        self.watch, self.watched = set(watch), []
        self.seconds, self.totals, self.groups, self.grads = [], [], {}, {}
        self.cameras, self.identity_camera = [], None
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

        names = {id(p): n for n, p in model.module.named_parameters()}
        cal = getattr(model.module, "cal", None)
        self.identity_camera = getattr(cal, "identity_idx", None)

        def probed_optimizer_step():
            for group in optimizer.inner.param_groups:
                gs = [p for p in group["params"] if p.grad is not None]
                bad = [names[id(p)] for p in gs
                       if not bool(torch.isfinite(p.grad).all())]
                seen = self.groups.setdefault(group["name"], [True, False])
                seen[0] &= not bad
                seen[1] |= any(bool(p.grad.abs().sum() > 0) for p in gs)
                if bad:
                    log(f"step {len(self.seconds)}: non-finite gradient "
                        f"entries in {bad[:8]}{' ...' if len(bad) > 8 else ''}")
            if self.watch and not self.watched:
                self.watched = [
                    (names[id(p)], p, p.detach().clone(), group["lr"],
                     group.get("weight_decay", 0.0))
                    for group in optimizer.inner.param_groups
                    if group["name"] in self.watch for p in group["params"]]
            if self.keep_grads and not self.grads:   # the first step's
                self.grads.update(
                    (name, p.grad.detach().cpu().clone())
                    for name, p in model.module.named_parameters()
                    if p.grad is not None)
            inner_step()

        optimizer.step = probed_optimizer_step
        step = self._orig(model, loss_fn, optimizer)

        def timed(batch, iteration):
            if len(self.seconds) >= 2 * TRAIN_STEPS:
                raise AssertionError(
                    f"{len(self.seconds)} steps taken for {TRAIN_STEPS}: the "
                    f"loop's explosion check rolled training back")
            if "camera_idx" in batch:
                self.cameras.append(batch["camera_idx"].tolist())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(self.seconds) == self.profile_step:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
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


def rgca_config(overrides=()):
    """configs/rgca.yml on the full-width synthetic data of FULL_DATA."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
        f"data={yaml_flow(FULL_DATA)}", *overrides])


def run_training(gc, torch, card_line, label, expected, record,
                 patch=None, make_config=rgca_config, batch=TRAIN_BATCH,
                 zero_grad_ok=None, default_group=False, run_dir=None,
                 frozen=None):
    """run_train.main at full width (``make_config``: configs/rgca.yml on
    synthetic data at 2048x1334 and uv 1024 unless another is given), the
    config's batch ``batch`` (4 unless given), 3 steps, no resume, counts
    reset just before and read just after: finite losses that move, a
    finite, non-zero gradient in every parameter group (but those that
    ``zero_grad_ok(probe)`` names, which must still be finite), a
    checkpoint, and exactly the launch counts ``expected`` lists (every
    other kernel 0). ``patch`` (a context manager) wraps the run. With
    ``default_group`` the optimizer also has the group of the modules its
    config leaves out (``__default__``), whose gradients may be zero but
    whose parameters must move by AdamW's decay alone. Leaves the step
    totals in ``record[label]``. The run writes into ``run_dir`` where it
    is given (the caller reads its checkpoints after), else into a
    temporary directory. ``frozen`` = (an optimizer group, the top-level
    modules it holds): parameters that take no gradient and must end the
    run exactly where they began."""
    import contextlib

    from goliath_torch import train as train_lib
    from goliath_torch.scripts import run_train

    with (contextlib.nullcontext(run_dir) if run_dir else
          tempfile.TemporaryDirectory(prefix="chip_smoke_train_")) as run_dir:
        cfg = make_config([
            f"train.run_dir={run_dir}", f"train.n_max_iters={TRAIN_STEPS}",
            "train.resume=false", "train.log_every_n_steps=1"])
        if cfg.dataloader.batch_size != batch:
            raise AssertionError(f"{label}: the config no longer trains at "
                                 f"batch {batch}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with patch or contextlib.nullcontext():
            gc.reset_launch_counts()
            watch = {"__default__"} if default_group else set()
            if frozen:
                watch.add(frozen[0])
            with StepProbe(torch, train_lib, profile_step=TRAIN_STEPS - 1,
                           watch=watch) as probe:
                iteration, last = run_train.main(cfg, device=DEVICE)
                torch.cuda.synchronize()
                launches = dict(gc.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        with open(Path(run_dir) / "tb" / "scalars.jsonl") as f:
            scalars = [json.loads(line) for line in f]
        written = sorted(p.name for p in
                         (Path(run_dir) / "checkpoints").iterdir())
    record[label] = probe.totals
    record[label + " seconds"] = probe.seconds
    log(f"{label} launches: {launches}")
    logged = {}
    for rec in scalars:
        logged.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
    for step in sorted(logged):
        log(f"{label} step {step} losses: {json.dumps(logged[step])}")
    for i, sec in enumerate(probe.seconds):
        note = " (under torch.profiler)" if i == probe.profile_step else ""
        log(f"{label} step {i}: wall {sec:.4f} s{note}, total loss "
            f"{probe.totals[i]:.6f}, batch {batch} on {card_line}")
    log(f"{label} peak device memory (training, batch {batch}): "
        f"{peak / 2**30:.3f} GiB on {card_line}")
    log(f"{label} gradients per parameter group [all finite, some non-zero]:"
        f" {probe.groups}; checkpoints written: {written}")
    if probe.cameras:
        log(f"{label} cameras drawn (camera_idx per step): {probe.cameras}")
    rows = kernel_rows(probe.profile)
    busy = sum(r[0] for r in rows)
    # FoldEnv's copies of the step's K6 inputs are of this kind
    pinned = sum(r[0] for r in rows
                 if r[2].startswith("Memcpy DtoH (Device -> Pinned)"))
    wall_ms = probe.seconds[probe.profile_step] * 1e3
    log(f"{label} profiled step {probe.profile_step}: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms in {sum(r[1] for r in rows)} kernels "
        f"({pinned:.3f} ms of it copies to pinned host memory), idle share "
        f"{max(0.0, 1.0 - busy / wall_ms):.3f} on {card_line}")
    for ms, count, key in rows[:14]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    # the backward nodes by the device time of the kernels under them
    nodes = [(e.device_time_total / 1e3, e.count, e.key.split(": ", 1)[-1])
             for e in probe.profile.key_averages()
             if e.key.startswith("autograd::engine::evaluate_function")]
    nodes.sort(reverse=True)
    log("busiest backward nodes of that step (device ms, calls): " + ", ".join(
        f"{key} {ms:.1f} x{count}" for ms, count, key in nodes[:8]))
    # the gathers' backward, by the shapes of the node's inputs (the
    # incoming gradient first), to tell the gathers apart
    gathers = [(e.device_time_total / 1e3, e.count, e.input_shapes)
               for e in probe.profile.key_averages(group_by_input_shape=True)
               if e.key == "IndexBackward0"]
    gathers.sort(key=lambda r: -r[0])
    log("IndexBackward0 by input shapes (device ms, calls): " + ", ".join(
        f"{shapes} {ms:.1f} x{count}" for ms, count, shapes in gathers[:6]))

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
    expected_groups = set(cfg.optimizer.per_module) | (
        {"__default__"} if default_group or frozen else set())
    may_be_zero = zero_grad_ok(probe) if zero_grad_ok else set()
    if frozen:
        may_be_zero = may_be_zero | {frozen[0]}
        check_frozen(probe.watched, *frozen, len(probe.totals), label)
    if set(probe.groups) != expected_groups or not all(
            finite and (nonzero or name in may_be_zero)
            for name, (finite, nonzero) in probe.groups.items()):
        raise AssertionError(f"parameter groups without a finite, non-zero "
                             f"gradient: {probe.groups} (may be zero: "
                             f"{sorted(may_be_zero)})")
    if default_group:
        check_decay(probe.watched, len(probe.totals), label)
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(expected)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if "latest" not in written:
        raise AssertionError("no checkpoint was written")
    return launches


def check_frozen(watched, group, modules, steps, label):
    """The parameters of the optimizer group ``group``, which take no
    gradient: exactly those of the top-level ``modules``, and after
    ``steps`` Adam updates each bit for bit what it was before the
    first."""
    held = {name.split(".", 1)[0] for name, *_ in watched}
    moved = [name for name, p, p0, _lr, _wd in watched
             if not bool((p.detach() == p0).all())]
    log(f"{label}: the {len(watched)} parameters of the group {group} "
        f"({sorted(held)}, no gradient) after {steps} updates: "
        f"{len(moved)} moved {moved[:6]}")
    if held != set(modules) or moved:
        raise AssertionError(f"{label}: the frozen group {group} holds "
                             f"{sorted(held)}, or moved: {moved}")


def check_decay(watched, steps, label):
    """The parameters of a group that took zero gradients after ``steps``
    AdamW updates: each p0 (1 - lr wd)^steps (AdamW's decoupled decay, with
    moments of 0) at rtol 1e-6 (float32 products, one a step), and moved."""
    if not watched:
        raise AssertionError(f"{label}: no parameter of the default group")
    worst, moved, nonzero = 0.0, 0, 0
    for name, p, p0, lr, wd in watched:
        want = p0 * (1.0 - lr * wd) ** steps
        worst = max(worst, float(((p.detach() - want).abs()
                                  / want.abs().clamp(min=1e-30)).max()))
        moved += int(not bool((p.detach() == p0).all()))
        nonzero += int(bool(p0.any()))
    log(f"{label}: the default group's {len(watched)} parameters after "
        f"{steps} updates against p0 (1 - lr wd)^{steps}: largest relative "
        f"error {worst:.3e}; {moved} of the {nonzero} not all 0 moved")
    if not (worst <= 1e-6 and moved == nonzero > 0):
        raise AssertionError(f"{label}: the default group did not decay as "
                             f"AdamW decays parameters with zero gradients")


def train_path(gc, torch, card_line, record, run_dir=None):
    """Phase 8: the per-sample training path. K2 and K3 once per sample per
    step; K1 also once per sample of the train=False forward the loop's
    summary takes at iteration 0; K4 twice per render. Its checkpoints stay
    in ``run_dir`` where it is given (the render example reads them)."""
    n = TRAIN_BATCH * TRAIN_STEPS
    return run_training(gc, torch, card_line, "train path", dict(
        pair_grads=n, cumsum_cols=n, compositor_fwd=n + TRAIN_BATCH,
        cumsum1d=2 * (n + TRAIN_BATCH)), record, run_dir=run_dir)


def latest_checkpoint(run_dir):
    """The .pt file that run_dir/checkpoints/latest names, or None."""
    ckpt_dir = Path(run_dir) / "checkpoints"
    if not (ckpt_dir / "latest").is_file():
        return None
    return str(ckpt_dir / (ckpt_dir / "latest").read_text().strip())


class FoldEnv:
    """GOLIATH_GSPLAT_FOLD=1 for the duration of a with-block (restored
    after), and the inputs of every batch-folded backward (K6's rows,
    bounds, cnt, forward outputs and upstream gradients), in step order
    under ``captured["k6"]``, copied to pinned host memory without a
    synchronise. The first backward allocates the host buffers of all
    TRAIN_STEPS steps (the steps' inputs have one shape), so that the
    later, timed steps only start their copies: allocating ~0.9 GB of
    pinned memory in a step added 0.2-0.3 s to its wall time (the folded
    step on an NVIDIA H100 80GB HBM3 machine)."""

    def __init__(self, gc, torch, captured):
        self.gc, self.torch, self.captured = gc, torch, captured
        self.orig_pg = gc.pair_grads

    def __enter__(self):
        import os

        self.before = os.environ.get("GOLIATH_GSPLAT_FOLD")
        os.environ["GOLIATH_GSPLAT_FOLD"] = "1"
        torch, captured, orig = self.torch, self.captured, self.orig_pg

        def pg(*args):
            if args[12] > 1:
                steps = captured.setdefault("k6", [])
                if not steps:
                    self.buffers = [
                        [torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                         if isinstance(a, torch.Tensor) else None
                         for a in args] for _ in range(TRAIN_STEPS)]
                steps.append(tuple(
                    a if buf is None else buf.copy_(a.detach(),
                                                    non_blocking=True)
                    for a, buf in zip(args, self.buffers[len(steps)])))
            return orig(*args)

        self.gc.pair_grads = pg
        return self

    def __exit__(self, *exc):
        import os

        self.gc.pair_grads = self.orig_pg
        if self.before is None:
            os.environ.pop("GOLIATH_GSPLAT_FOLD", None)
        else:
            os.environ["GOLIATH_GSPLAT_FOLD"] = self.before


def fold_train_path(gc, torch, card_line, record, captured):
    """The batch-folded training path: run_train.main as train_path (same
    seed and overrides) with GOLIATH_GSPLAT_FOLD=1 for this phase only. K6's
    forward once per step and once for the summary's train=False forward
    at iteration 0, its backward and the reduce (K3) once per step, K4
    twice per render; no per-sample kernel. The losses differ from the
    per-sample path's on purpose (17 depth bits instead of 19, one global
    pair budget; the random-weight frame overflows its tiles): the
    difference is printed, not held."""
    launches = run_training(
        gc, torch, card_line, "fold train path", dict(
            compositor_fwd_fold=TRAIN_STEPS + 1, pair_grads_fold=TRAIN_STEPS,
            cumsum_cols=TRAIN_STEPS, cumsum1d=2 * (TRAIN_STEPS + 1)),
        record, patch=FoldEnv(gc, torch, captured))
    if "train path" in record:
        diff = [f - p for f, p in zip(record["fold train path"],
                                      record["train path"])]
        log(f"fold - per-sample total loss per step: "
            f"{[f'{d:.6f}' for d in diff]} (not held: the fold quantizes "
            f"depth to 17 bits, the per-sample path to 19, and its pair "
            f"budget is global)")
    if len(captured.get("k6", ())) != TRAIN_STEPS:
        raise AssertionError("the fold path's backwards were not captured")
    return launches


def grad_error(got, ref):
    """The largest error of a gradient as a fraction of its parameter's
    largest |reference| gradient entry, and that parameter's name."""
    worst, worst_name = 0.0, None
    for name, r in ref.items():
        scale = max(float(r.abs().max()), 1e-30)
        err = float((got[name] - r).abs().max()) / scale
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def jitter_template(ds):
    """``ds`` with its template moved by N(0, 0.5) per vertex (as in
    tests/test_torch_mesh_vae.py): the sphere's pole fans are faces with
    two equal corners, whose normals are 0/0 up to rounding, so the card's
    and the CPU's roundings of the posed mesh turn them into other
    numbers; jittered, every face has a well-defined normal."""
    import numpy as np

    v = ds.static_assets["template_mesh_unscaled"]
    ds.static_assets["template_mesh_unscaled"] = (
        v + np.random.RandomState(7).randn(*v.shape) * 0.5).astype(
            np.float32)
    return ds


def small_reference(torch):
    """Both RGCA entry points at configs/rgca_synthetic.yml size on the
    card (kernels) against the CPU (plain versions): the eval means, and
    two training steps (the losses of the second depend on the first one's
    update) with the gradients of the first; then the mesh eval path and
    one mesh training step (its losses and gradients) at the size of
    tests/test_torch_mesh_vae_run_test.py; then the URHand eval path and
    one URHand training step (urhand_small_train_reference) at the size of
    tests/test_torch_urhand_run_test.py; then the hand_mvp eval path at the
    size of tests/test_torch_hand_mvp.py."""
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
    worst_g, worst_name = grad_error(g_got, g_ref)
    log(f"small-input training reference (card vs CPU plain): step totals "
        f"{t_got} vs {t_ref}; second step's losses max rel diff {worst:.3e}; "
        f"first step's gradients over {len(g_ref)} parameters: largest error "
        f"as a fraction of the parameter's largest gradient {worst_g:.3e} "
        f"({worst_name}) (tolerance {SMALL_RTOL} each)")
    if not (worst <= SMALL_RTOL and worst_g <= SMALL_RTOL
            and set(g_got) == set(g_ref)):
        raise AssertionError("the card's training steps disagree with the "
                             "CPU's")

    build = run_test.build_dataset

    def jittered(data_cfg, **kw):
        return jitter_template(build(data_cfg, **kw))

    cfg = mesh_config(MESH_SMALL, MESH_SMALL_DATA)
    run_test.build_dataset = run_train.build_dataset = jittered
    try:
        got = run_test.main(cfg, device=DEVICE)
        ref = run_test.main(cfg, device="cpu")
        runs = {}
        for device in (DEVICE, "cpu"):
            with tempfile.TemporaryDirectory(prefix="chip_smoke_small_") as d:
                cfg = mesh_config([*MESH_SMALL, f"train.run_dir={d}",
                                   "train.n_max_iters=1",
                                   "train.resume=false"], MESH_SMALL_DATA)
                with StepProbe(torch, train_lib, keep_grads=True) as probe:
                    _it, last = run_train.main(cfg, device=device)
                runs[device] = (last, probe.grads)
    finally:
        run_test.build_dataset = run_train.build_dataset = build
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    log(f"small-input mesh eval reference (card vs CPU plain): means "
        f"{json.dumps(got)}; max rel diff {worst:.3e} (tolerance "
        f"{SMALL_RTOL})")
    if not worst <= SMALL_RTOL:
        raise AssertionError("the card's mesh eval disagrees with the CPU's")
    (got, g_got), (ref, g_ref) = runs[DEVICE], runs["cpu"]
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    worst_g, worst_name = grad_error(g_got, g_ref)
    log(f"small-input mesh training reference (card vs CPU plain), one "
        f"step: losses {json.dumps(got)}, max rel diff {worst:.3e}; "
        f"gradients over {len(g_ref)} parameters: largest error as a "
        f"fraction of the parameter's largest gradient {worst_g:.3e} "
        f"({worst_name}) (tolerance {SMALL_RTOL} each)")
    if not (worst <= SMALL_RTOL and worst_g <= SMALL_RTOL
            and set(got) == set(ref) and set(g_got) == set(g_ref)):
        raise AssertionError("the card's mesh training step disagrees with "
                             "the CPU's")

    cfg = urhand_config(URHAND_SMALL, URHAND_SMALL_DATA)
    run_test.build_dataset = jittered
    try:
        got = run_test.main(cfg, device=DEVICE)
        ref = run_test.main(cfg, device="cpu")
    finally:
        run_test.build_dataset = build
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    log(f"small-input URHand eval reference (card vs CPU plain): means "
        f"{json.dumps(got)}; max rel diff {worst:.3e} (tolerance "
        f"{SMALL_RTOL})")
    if not (worst <= SMALL_RTOL and set(got) == set(ref)):
        raise AssertionError("the card's URHand eval disagrees with the "
                             "CPU's")

    urhand_small_train_reference(torch)

    cfg = hand_mvp_config(HAND_MVP_SMALL, HAND_MVP_SMALL_DATA)
    run_test.build_dataset = jittered
    try:
        got = run_test.main(cfg, device=DEVICE)
        ref = run_test.main(cfg, device="cpu")
    finally:
        run_test.build_dataset = build
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    log(f"small-input hand_mvp eval reference (card vs CPU plain): means "
        f"{json.dumps(got)}; max rel diff {worst:.3e} (tolerance "
        f"{SMALL_RTOL})")
    if not (worst <= SMALL_RTOL and set(got) == set(ref)):
        raise AssertionError("the card's hand_mvp eval disagrees with the "
                             "CPU's")


# The gradients of a training step through a render (URHand's, and the MVP
# march's per-voxel ones) move by up to a few percent of their largest
# entry when the parameters move by one ulp, in either package
# (tests/test_torch_urhand_train.py: the view conditioning of texmod0_* is
# resampled from the displaced geometry's TBN frame, whose normals are
# ill-conditioned at the UV border; tests/test_torch_hand_mvp_train.py: the
# untied biases of the slab decoders' last layers). So the card's
# gradients are held to SMALL_RTOL of the entry and of the parameter's
# largest entry, or else to that plus SPREAD_MULT times the
# parameter's spread: the largest move of its gradient on the card when
# every parameter is scaled by (1 + 1e-7 N(0, 1)), over
# SPREAD_SEEDS, measured only when a gradient needs it; at most
# MAX_SPREAD_PARAMS parameters may need the spread.
SPREAD_MULT = 4.0
SPREAD_SEEDS = (1, 2, 3)
MAX_SPREAD_PARAMS = 5
# The sharded steps' holds sample the reference's own noise more widely:
# at full width the card's atomic sums and the render's thresholds move some
# decoder gradients by per-mille to percents of their largest entry from one
# run to the next, with heavy tails, and a sharded run is one more draw of
# that noise. So their spread takes one-ulp moves from SHARD_SPREAD_SEEDS and
# REFERENCE_RERUNS reruns from the very same state, all of the reference.
SHARD_SPREAD_SEEDS = (1, 2, 3, 4, 5, 6)
REFERENCE_RERUNS = 2


def urhand_small_train_reference(torch):
    """One URHand training step (configs/urhand.yml with every loss, the
    perceptual ones on random features) at the size of
    tests/test_torch_urhand_run_test.py: small_train_step_reference."""
    return small_train_step_reference(
        torch, "URHand", lambda o: urhand_train_config(
            [*URHAND_SMALL, *o], URHAND_SMALL_DATA))


def small_train_step_reference(torch, label, make_config):
    """One training step (run_train.main on ``make_config(overrides)``) on
    the jittered template, on the card against the CPU: its losses at
    SMALL_RTOL, its gradients by the sensitivity rule above."""
    from goliath_torch import train as train_lib
    from goliath_torch.scripts import run_train

    build_data, build_model = run_train.build_dataset, run_train.load_from_config

    def step(device, seed=None):
        def model(*a, **kw):
            obj = build_model(*a, **kw)
            if seed is not None and hasattr(obj, "module"):
                gen = torch.Generator().manual_seed(seed)
                with torch.no_grad():
                    for p in obj.module.parameters():
                        p.mul_(1 + 1e-7 * torch.randn(
                            p.shape, generator=gen).to(p.device))
            return obj

        def jittered(data_cfg, **kw):
            return jitter_template(build_data(data_cfg, **kw))

        run_train.build_dataset, run_train.load_from_config = jittered, model
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_small_") as d:
                cfg = make_config([f"train.run_dir={d}",
                                   "train.n_max_iters=1",
                                   "train.resume=false"])
                with StepProbe(torch, train_lib, keep_grads=True) as probe:
                    _it, last = run_train.main(cfg, device=device)
        finally:
            run_train.build_dataset = build_data
            run_train.load_from_config = build_model
        return last, probe.grads

    got, g_got = step(DEVICE)
    ref, g_ref = step("cpu")
    spread = {}
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    worst_g, worst_name = grad_error(g_got, g_ref)
    need, over = [], []
    for name, r in g_ref.items():
        scale = float(r.abs().max())
        diff = (g_got[name] - r).abs()
        usual = SMALL_RTOL * r.abs() + SMALL_RTOL * scale
        if bool((diff <= usual).all()):
            continue
        if not spread:
            spread = {name: 0.0 for name in g_got}
            for seed in SPREAD_SEEDS:
                _, g_seed = step(DEVICE, seed)
                for n, g in g_seed.items():
                    spread[n] = max(spread[n],
                                    float((g - g_got[n]).abs().max()))
        note = (f"{name} (error {float(diff.max()) / max(scale, 1e-30):.3e}, "
                f"spread {spread[name] / max(scale, 1e-30):.3e} of its "
                f"largest entry)")
        need.append(note)
        if not bool((diff <= usual + SPREAD_MULT * spread[name])
                    .all()):
            over.append(note)
    log(f"small-input {label} training reference (card vs CPU plain), one "
        f"step with {sorted(k for k in ref if k != 'loss_total')}: losses "
        f"{json.dumps(got)}, max rel diff {worst:.3e} (tolerance "
        f"{SMALL_RTOL}); gradients over {len(g_ref)} parameters: largest "
        f"error as a fraction of the parameter's largest gradient "
        f"{worst_g:.3e} ({worst_name}); beyond {SMALL_RTOL} of the entry and "
        f"of that largest gradient, held to {SPREAD_MULT} x their "
        f"one-ulp perturbation spread on the card: {need}")
    if not (worst <= SMALL_RTOL and set(got) == set(ref)
            and set(g_got) == set(g_ref) and not over
            and len(need) <= MAX_SPREAD_PARAMS):
        raise AssertionError(f"the card's {label} training step disagrees "
                             f"with the CPU's: over the rule {over}")
    return {"losses_rel_err": worst, "grad_err_of_scale": worst_g,
            "need_spread": need}


MESH_DATA = {"synthetic": True, "img_h": 2048, "img_w": 1334,
             "uv_size": 1024, "n_lat": 128, "n_lon": 256, "n_cams": 4,
             "n_frames": 3}
# the small mesh config of tests/test_torch_mesh_vae_run_test.py
MESH_SMALL_DATA = {"synthetic": True, "img_h": 48, "img_w": 48,
                   "uv_size": 64, "n_cams": 2, "n_frames": 2, "seed": 2}
MESH_SMALL = [
    'model.encoder={"n_embs": 16, "enc_size": 64}',
    'model.encoder_face={"n_embs": 8, "enc_size": 32}',
    'model.decoder={"init_uv_size": 16, "n_pose_dims": 6, '
    '"n_pose_enc_channels": 8, "n_embs": 16, "n_embs_enc_channels": 8, '
    '"n_face_embs": 8, "n_init_channels": 16, "n_min_channels": 4, '
    '"uv_size": 64}',
    'model.decoder_view={"net_uv_size": 64, "n_init_ftrs": 4}',
    'model.shadow_net={"uv_size": 128, "shadow_size": 32, "n_dims": 8}',
    'model.renderer={"image_height": 48, "image_width": 48, '
    '"max_faces_per_tile": 128, "chunk": 16}',
    'model.pixel_cal={"image_height": 48, "image_width": 48, "ds_rate": 8}']
# K5's float32 operations per (row, pixel) evaluation, counted in
# csrc/zbuffer.cu: 12 for the edge functions, 6 for izp, a max, a division
# and 5 comparisons
K5_OPS_PER_EVAL = 25


# the losses of configs/mesh_vae.yml that need what the repo does not hold:
# effnet EfficientNet weights, head_geom_l2 and head_lap a capture asset
# (full_head_mask_geom)
MESH_DROPPED_LOSSES = ("effnet", "head_geom_l2", "head_lap")
# the synthetic sphere's vertices reach ~100 from its centre; at the
# encoders' default input scale of 1 the random encoder's logvar reaches
# ~16, so train=True draws latents of ~1e6 (exp(logvar) * noise), the first
# step's losses are ~1e9 and jump ~1e3x a step, and the loop's explosion
# check rolls back to iteration 0 again and again. Scaled by 0.01 the
# input is ~1, logvar ~0.2 and the losses move by a few percent a step.
MESH_VERTS_SCALE = 0.01


def mesh_config(overrides=(), data=MESH_DATA):
    """configs/mesh_vae.yml for run_test and run_train on synthetic data:
    ``data`` (the full-width MESH_DATA unless given) for both, the 3-joint
    synthetic skeleton's 6 local pose dims, both encoders' input scaled by
    MESH_VERTS_SCALE, and the config's losses with their schedules and
    weights but those of MESH_DROPPED_LOSSES (rgb_l1, mask_l1, geom_l2,
    geom_lap, learn_blur, kl, face_kl), rgb_l1's mask and mask_l1's target
    being image_mask: no segmentation_fgbg is generated."""
    return mesh_vae_config([
        *overrides, f"model.encoder.verts_scale={MESH_VERTS_SCALE}",
        f"model.encoder_face.verts_scale={MESH_VERTS_SCALE}"], data)


def mesh_vae_config(overrides, data):
    """mesh_config without the encoders' input scale."""
    from goliath_torch.config import Config, load_config

    cfg = load_config(str(ROOT / "configs" / "mesh_vae.yml"), overrides=[
        f"data={yaml_flow(data)}", f"test.data={yaml_flow(data)}",
        "test.ckpt=null", "test.n_test_frames=3", "test.vis_path=null",
        "model.decoder.n_pose_dims=6", *overrides])
    losses = {k: v for k, v in cfg.loss.losses.to_dict().items()
              if k not in MESH_DROPPED_LOSSES}
    losses["rgb_l1"]["mask_key"] = "image_mask"
    losses["mask_l1"]["tgt_key"] = "image_mask"
    cfg.loss.losses = Config.wrap(losses)
    return cfg


# the sphere covers 0.445-0.460 of each mesh frame's image; a binning fault
# upstream of K5 and its plain version would leave holes in both
MESH_MIN_COVERED = 0.3


def mesh_eval_path(gc, torch, card_line, captured, label="mesh",
                   make_config=mesh_config, wrap_data=None):
    """run_test.main on configs/mesh_vae.yml at full width
    (``make_config``: mesh_config unless given), counts reset just before:
    3 frames with finite losses that each cover at least MESH_MIN_COVERED
    of the image, K5 once and K4 twice per frame, no splat kernel. Keeps in
    ``captured`` the run's own inputs to K5 (first frame) and to K4 (every
    scan), copied to the host without a synchronise so that they add
    nothing to the run's device memory, and the run's model and its last
    batch (``"model"``, ``"batch"``), then profiles a second run of the
    last frame on the run's model. ``wrap_data`` wraps the dataset that
    run_test builds."""
    from goliath_torch.ops import binning, rasterizer
    from goliath_torch.scripts import run_test

    cfg = make_config()
    frames, covered, k4_inputs, built = [], [], [], {}
    orig_zb, orig_cs = rasterizer.zbuffer, binning.cumsum1d
    orig_build = run_test.load_from_config
    orig_data = run_test.build_dataset

    def to_host(x):   # pinned memory, no synchronise
        return x.to("cpu", non_blocking=True) \
            if isinstance(x, torch.Tensor) else x

    def zb(*args):
        if "k5" not in captured:
            captured["k5"] = tuple(to_host(a) for a in args)
        index_img, z_img = orig_zb(*args)
        covered.append(((index_img >= 0).sum(), index_img.numel()))
        return index_img, z_img

    def cs(x):
        k4_inputs.append(to_host(x))
        return orig_cs(x)

    def build(*a, **kw):
        model = built["model"] = orig_build(*a, **kw)
        orig_apply = model.apply

        def apply(batch, **akw):
            built["batch"] = batch   # the frame the loop holds anyway
            return orig_apply(batch, **akw)

        model.apply = apply
        return model

    def data(*a, **kw):
        return wrap_data(orig_data(*a, **kw))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rasterizer.zbuffer, binning.cumsum1d = zb, cs
    run_test.load_from_config = build
    if wrap_data is not None:
        run_test.build_dataset = data
    gc.reset_launch_counts()
    try:
        means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    finally:
        rasterizer.zbuffer, binning.cumsum1d = orig_zb, orig_cs
        run_test.load_from_config = orig_build
        run_test.build_dataset = orig_data
    peak = torch.cuda.max_memory_allocated()
    captured["k4"] = k4_inputs
    covered = [int(n) / size for n, size in covered]
    log(f"{label} path launches: {launches}")
    log(f"{label} eval means: {json.dumps(means)}")
    for i, sec in enumerate(frames):
        log(f"{label} frame {i}: wall {sec:.4f} s on {card_line}")
    log(f"peak device memory ({label} eval): {peak / 2**30:.3f} GiB on "
        f"{card_line}")
    log(f"{label} frames: covered share {[round(c, 4) for c in covered]} "
        f"(floor {MESH_MIN_COVERED})")
    if len(frames) != 3 or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"{label} eval losses are not finite")
    if len(covered) != 3 or not all(c >= MESH_MIN_COVERED for c in covered):
        raise AssertionError(f"a {label} frame rendered too little of the "
                             f"mesh")
    expected = {name: 0 for name in gc.LAUNCHES}
    expected.update(zbuffer=3, cumsum1d=6)
    if launches != expected:
        raise AssertionError(f"{label} path launch counts {launches} != "
                             f"{expected}")
    captured["model"], captured["batch"] = built["model"], built["batch"]
    profile_forward(torch, built.pop("model"), built.pop("batch"), card_line,
                    f"profiled {label} frame (the model's forward of the "
                    f"last frame, run again)", train=False)
    return launches


class MeshTrainCapture:
    """For the duration of a with-block: keeps in ``captured`` the
    arguments of the first K5 launch of the run (``"k5"``: step 0, sample
    0) and the inputs and output of the first edge-gradient backward,
    sample 0 of step 0's batch (``"edge"``), copied to pinned host memory
    without a synchronise."""

    def __init__(self, torch, captured):
        from goliath_torch.ops import rasterizer

        self.torch, self.captured = torch, captured
        self.rasterizer = rasterizer
        self.orig = rasterizer.zbuffer, rasterizer.edge_grads

    def to_host(self, x):   # pinned memory, no synchronise
        return x.detach().to("cpu", non_blocking=True) \
            if isinstance(x, self.torch.Tensor) else x

    def __enter__(self):
        orig_zb, orig_eg = self.orig
        captured, to_host = self.captured, self.to_host

        def zb(*args):
            if "k5" not in captured:
                captured["k5"] = tuple(to_host(a) for a in args)
            return orig_zb(*args)

        def eg(g, img, vi, bary_img, index_img, depth_img, n_verts):
            out = orig_eg(g, img, vi, bary_img, index_img, depth_img,
                          n_verts)
            if "edge" not in captured:
                first = tuple(to_host(a[:1]) for a in (
                    g, img, bary_img, index_img, depth_img))
                captured["edge"] = (first, to_host(vi), n_verts,
                                    to_host(out[:1]))
            return out

        self.rasterizer.zbuffer, self.rasterizer.edge_grads = zb, eg
        return self

    def __exit__(self, *exc):
        self.rasterizer.zbuffer, self.rasterizer.edge_grads = self.orig


def mesh_train_path(gc, torch, card_line, record, captured):
    """run_train.main on configs/mesh_vae.yml at full width (MESH_DATA,
    mesh_config's losses), batch 4, 3 steps: K5 once per sample of each
    step and of the summary's train=False forward at iteration 0, K4
    twice per render, no splat kernel; the first K5 launch's arguments and
    the first edge-gradient backward kept in ``captured``."""
    n = TRAIN_BATCH * (TRAIN_STEPS + 1)
    return run_training(
        gc, torch, card_line, "mesh train path",
        dict(zbuffer=n, cumsum1d=2 * n), record,
        patch=MeshTrainCapture(torch, captured), make_config=mesh_config)


# the edge-gradient backward on the card against the CPU, per column (x,
# y) over the vertices that carry a gradient: rtol of the entry plus a
# fraction of the column's typical entry (the median |reference|). The
# card's index_add_ adds each vertex's pair terms atomically in no fixed
# order, the CPU's in pair order; the terms have both signs.
EDGE_RTOL, EDGE_ATOL_OF_TYPICAL = 1e-4, 1e-3


def check_edge_grads(torch, captured, label="edge-gradient backward"):
    """``rasterizer.edge_grads`` of a training path's first sample (the mesh
    path's render, or one of URHand's renders): the run's own output on the
    card, and a second call on the card from host copies of its inputs,
    each against the same function on the CPU (plain PyTorch on both;
    ``index_add_`` atomic on the card)."""
    from goliath_torch.ops import rasterizer
    from goliath_torch.utils.timing import cuda_ms

    (g, img, bary, index_img, depth), vi, n_verts, run_out = captured
    host = (g, img, vi, bary, index_img, depth, n_verts)
    on_card = tuple(a.to(DEVICE) if isinstance(a, torch.Tensor) else a
                    for a in host)
    again = rasterizer.edge_grads(*on_card).cpu()
    ref = rasterizer.edge_grads(*host)
    idx = index_img[0]
    pairs = int((idx[:, 1:] != idx[:, :-1]).sum()
                + (idx[1:] != idx[:-1]).sum())
    failed = []
    for name, got in (("the run's", run_out), ("a second call's", again)):
        for c, axis in ((0, "x"), (1, "y")):
            carries = (ref[0, :, c] != 0) | (got[0, :, c] != 0)
            err, big, typical, n_over, used = entries_over(
                got[0, :, c], ref[0, :, c], carries, EDGE_RTOL,
                EDGE_ATOL_OF_TYPICAL)
            log(f"{label}, {name} card output, {axis}: "
                f"max_abs_err {err:.3e} (largest |ref| {big:.3e}, typical "
                f"{typical:.3e}, {int(carries.sum())} of {n_verts} vertices "
                f"carry one; tolerance rtol {EDGE_RTOL} + "
                f"{EDGE_ATOL_OF_TYPICAL} x typical, {used:.3f} of it used)")
            if n_over:
                failed.append(f"{name} {axis}: {n_over} entries")
        if float(got[0, :, 2].abs().max()) != 0.0:
            failed.append(f"{name} z is not 0")
    ms = cuda_ms(lambda: rasterizer.edge_grads(*on_card), reps=10)
    log(f"{label} at {tuple(idx.shape)}, one sample: "
        f"{pairs} neighbour pairs on two faces or on the background; "
        f"{ms:.4f} ms on the card (index_add_ and its elementwise ops)")
    if failed or not float(ref.abs().max()) > 0:
        raise AssertionError(f"the card's {label} disagrees with the "
                             f"CPU's: {failed}")
    return dict(max_abs_err=float((run_out - ref).abs().max()), ms=ms)


def k4_mesh_check(gc, torch, inputs, expected=6, label="mesh"):
    """K4 on a mesh path's own scans (per render: the [faces] tile counts
    and the [budget] slot marks; the mesh eval path's 3 frames, or the
    URHand path's first frame) against torch.cumsum, exactly."""
    worst = 0
    for i, x in enumerate(inputs):
        x = x.to(DEVICE)
        err = int((gc.cumsum1d(x).long()
                   - torch.cumsum(x, 0, dtype=torch.int32).long())
                  .abs().max())
        log(f"K4 {label} scan {i}: M={x.numel()} total={int(x.long().sum())}"
            f" max_abs_err={err} (tolerance: none, exact)")
        worst = max(worst, err)
    if len(inputs) != expected or worst:
        raise AssertionError(f"K4 differs from torch.cumsum on the {label} "
                             f"path's scans (or not {expected} of them)")
    return worst


def face_box_evals(rows, start, win_end, ts, ntx, img_h, img_w):
    """Row-pixel evaluations the z-buffer needs on this data: for each row
    in a tile's window, the tile's pixel centres inside the face's screen
    bounding box (a pixel outside it fails an edge test whatever the depth).
    The corners are the pairwise intersections of the row's three edge
    lines, in float64; rows that cannot hit (|inv_area|*valid = 0) need
    none."""
    import torch

    n = (win_end - start).clamp(min=0)
    tile = torch.repeat_interleave(torch.arange(len(n), device=n.device), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    r = start[tile] + torch.arange(len(tile), device=n.device) - first
    d = rows[r].double()
    a, b, c = d[:, 0:3], d[:, 3:6], d[:, 6:9]
    xs, ys = [], []
    for i, j in ((0, 1), (1, 2), (2, 0)):
        det = a[:, i] * b[:, j] - a[:, j] * b[:, i]
        xs.append((b[:, i] * c[:, j] - b[:, j] * c[:, i]) / det)
        ys.append((c[:, i] * a[:, j] - c[:, j] * a[:, i]) / det)
    xs, ys = torch.stack(xs, 1), torch.stack(ys, 1)
    x0 = ((tile % ntx) * ts).double()
    y0 = ((tile // ntx) * ts).double()

    def span(lo, hi, t0, size):   # pixels p of the tile with lo <= p+0.5 <= hi
        first_p = torch.maximum(torch.ceil(lo - 0.5), t0)
        last_p = torch.minimum(torch.minimum(torch.floor(hi - 0.5),
                                             t0 + ts - 1),
                               torch.full_like(t0, size - 1))
        return (last_p - first_p + 1).clamp(min=0)

    cnt = (span(xs.amin(1), xs.amax(1), x0, img_w)
           * span(ys.amin(1), ys.amax(1), y0, img_h))
    ok = (d[:, 9] > 0) & torch.isfinite(xs).all(1) & torch.isfinite(ys).all(1)
    return int(cnt[ok].sum())


def check_k5(gc, torch, args, label="K5", min_covered=MESH_MIN_COVERED):
    """K5 against its plain version on the arguments a path's rasterize
    call handed to K5 (the mesh eval path's first frame, the mesh training
    path's first sample): face index equal on every pixel and depth equal
    bit for bit, at least ``min_covered`` of the image covered; the row-pixel evaluations of its per-warp cull (counted by
    the plain version's mirror) beside the first design's and those inside
    the faces' boxes."""
    from goliath_torch.ops import rasterizer_cuda as rc
    from goliath_torch.utils.timing import cuda_ms

    args = tuple(a.to(DEVICE) if isinstance(a, torch.Tensor) else a
                 for a in args)
    (rows, sorted_prim, tile_start, tile_end, img_h, img_w, ts, ntx, nty,
     chunk, mfpt) = args
    idx, z = rc.zbuffer(*args)
    work = {}
    p_idx, p_z = rc.zbuffer_plain(*args, counts=work)
    torch.cuda.synchronize()
    idx_bad = int((idx != p_idx).sum())
    z_bad = int((z.view(torch.int32) != p_z.view(torch.int32)).sum())
    err = float((z - p_z).abs().max())
    covered = float((idx >= 0).float().mean())
    pairs = (tile_end - tile_start).long()
    nchunks = mfpt // chunk + 1
    start = tile_start.long()
    win_end = torch.minimum(tile_end.long(),
                            (start // chunk + nchunks) * chunk)
    in_window = int((win_end - start).clamp(min=0).sum())
    design_evals = in_window * ts * ts
    evals = face_box_evals(rows, start, win_end, ts, ntx, img_h, img_w)
    nbytes = 64 * in_window + 8 * img_h * img_w
    b_ms, b_by = bound_ms(nbytes, K5_OPS_PER_EVAL * evals)
    log(f"{label} rows={tuple(rows.shape)} tiles={ntx * nty} ({ntx}x{nty} of "
        f"{ts}px) pairs={int(pairs.sum())} faces per tile: max "
        f"{int(pairs.max())} mean {float(pairs.float().mean()):.2f} "
        f"(mean over non-empty {float(pairs[pairs > 0].float().mean()):.2f});"
        f" tiles over max_faces_per_tile={mfpt}: {int((pairs > mfpt).sum())}"
        f"; covered share {covered:.4f} (floor {min_covered}); "
        f"mismatches: face index {idx_bad}, depth bits {z_bad} (max abs "
        f"{err:.3e}); tolerance: none, both exact")
    if idx_bad or z_bad:
        bad = torch.nonzero(idx != p_idx)[:10].tolist()
        log(f"{label} first mismatching pixels (y, x): {bad}")
        raise AssertionError("K5 differs from its plain version")
    if not covered >= min_covered:
        raise AssertionError("K5's frame covers too little of the image")
    ms = cuda_ms(lambda: rc.zbuffer(*args), reps=50)
    plain_ms = cuda_ms(lambda: rc.zbuffer_plain(*args), reps=2, warmup=1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = K5_OPS_PER_EVAL * evals / FP32_OPS_PER_S * 1e3
    log(f"{label} timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({ms / b_ms:.1f}x the bound): bytes {nbytes} "
        f"({in_window} rows in the windows at 64 B, 8 B per pixel written) "
        f"-> {t_bytes:.4f} ms; operations: {evals} row-pixel evaluations "
        f"inside the faces' bounding boxes at {K5_OPS_PER_EVAL} each -> "
        f"{t_ops:.4f} ms; library: none (no PyTorch call computes a "
        f"z-buffer)")
    log(f"{label} row-pixel evaluations: {work['evals']} by this design's "
        f"per-warp cull ({work['warp_visits']} (row, warp) visits kept, "
        f"{work['culled_visits']} culled; the mirror k5_may_hit), "
        f"{design_evals} by the first design (every pixel of the tile), "
        f"{evals} inside the faces' bounding boxes: "
        f"{work['evals'] / max(evals, 1):.2f}x and "
        f"{design_evals / max(evals, 1):.2f}x the boxes' count")
    if work["design_evals"] != design_evals:
        raise AssertionError("K5's counts disagree on the window")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


# The drivable body model (models/mesh_vae_drivable.py). No config of the
# repo names it, and no dataset of either package gives its inputs, so:
# configs/mesh_vae.yml's model block as mesh_config reads it (MESH_DATA,
# the synthetic skeleton's 6 local pose dims, MESH_DROPPED_LOSSES) with the
# drivable class and its blocks at the JAX modules' defaults (a 1024-d body
# code from a 512^2 UV map; the frozen face decoder from a 256-d face code
# to 7,306 face vertices and a 1024^2 texture, encoded again at 512^2),
# and DrivableData renaming each batch's keys. The drivable encoders have
# no input scale (mesh_config's verts_scale). Cut instead: the body
# encoder's logvar_scale, 0.001. At the default 0.1 its random logvar
# reaches 43.8 on the sphere (the encoder alone at full width on a CPU),
# so exp(logvar) times the training noise would be ~1e19.
DRIVABLE_BLOCKS = [
    "model.class_name=goliath_tpu.models.mesh_vae_drivable.AutoEncoder",
    'model.encoder={"n_embs": 1024, "enc_size": 512}',
    'model.encoder_face={"n_embs": 256, "uv_size": 512, "n_vert_in": 21918}',
    'model.decoder_face={"n_latent": 256, "n_vert_out": 21918, '
    '"tex_out_shp": [1024, 1024]}']
DRIVABLE_CUTS = ["model.encoder.logvar_scale=0.001"]
# tests/drivable_fixture.py's encoders and face decoder on MESH_SMALL's
# decoder and data
DRIVABLE_SMALL = [
    *MESH_SMALL,
    'model.encoder={"n_embs": 16, "enc_size": 64}',
    'model.encoder_face={"n_embs": 8, "uv_size": 32, "n_vert_in": 48}',
    'model.decoder_face={"n_latent": 8, "n_vert_out": 48, '
    '"tex_out_shp": [32, 32]}']


def drivable_config(overrides=(), data=MESH_DATA):
    """configs/mesh_vae.yml with the drivable model: DRIVABLE_BLOCKS, then
    ``overrides``, then DRIVABLE_CUTS, on ``data`` (MESH_DATA unless
    given), with mesh_config's losses."""
    return mesh_vae_config([*DRIVABLE_BLOCKS, *overrides, *DRIVABLE_CUTS],
                           data)


class DrivableData:
    """A dataset whose batches carry the drivable model's input keys beside
    their own, as tests/test_mesh_vae_drivable.py renames them:
    lbs_motion = pose, geom = registration_vertices, ao =
    ambient_occlusion, and face_embs, a [B, n_face_code] face code from a
    numpy generator seeded ``seed``. Everything else is the dataset's."""

    def __init__(self, dataset, n_face_code, seed=0):
        import numpy as np

        self.dataset, self.n_face_code = dataset, n_face_code
        self.rng = np.random.RandomState(seed)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx]

    def batch_filter(self, batch):
        import numpy as np

        inner = getattr(self.dataset, "batch_filter", None)
        batch = dict(inner(batch) if inner is not None else batch)
        batch.update(
            lbs_motion=batch["pose"], geom=batch["registration_vertices"],
            ao=batch["ambient_occlusion"],
            face_embs=self.rng.randn(len(batch["pose"]), self.n_face_code)
            .astype(np.float32))
        return batch


def drivable_wrap(cfg, seed=0):
    """The dataset wrapper of ``cfg``'s drivable model (its face code
    width)."""
    n = int(cfg.model.decoder_face.n_latent)
    return lambda ds: DrivableData(ds, n, seed)


def drivable_eval_path(gc, torch, card_line, captured):
    """run_test.main on the drivable model at full width (drivable_config),
    its dataset wrapped by DrivableData: mesh_eval_path's checks (3 frames,
    finite losses, coverage, K5 once and K4 twice a frame, no splat
    kernel, one profiled frame); then the frozen face decoder's time on the
    last frame's face code, by CUDA events."""
    from goliath_torch.utils.timing import cuda_ms

    cfg = drivable_config()
    launches = mesh_eval_path(gc, torch, card_line, captured, "drivable",
                              drivable_config, drivable_wrap(cfg))
    model, batch = captured.pop("model"), captured.pop("batch")
    with torch.no_grad():
        ms = cuda_ms(lambda: model.module.decoder_face(batch["face_embs"]),
                     reps=10)
    log(f"drivable frame: the frozen face decoder (face code "
        f"{tuple(batch['face_embs'].shape)} -> 7,306 vertices and a "
        f"{cfg.model.decoder_face.tex_out_shp[0]}^2 texture) {ms:.4f} ms a "
        f"frame (CUDA events, 10 calls) on {card_line}")
    return launches


class DrivableTrainCapture(MeshTrainCapture):
    """MeshTrainCapture (the first K5 launch's arguments, the first
    edge-gradient backward), also the run's first two K4 inputs
    (``"k4"``), with run_train's dataset wrapped by ``wrap``."""

    def __init__(self, torch, captured, wrap):
        from goliath_torch.ops import binning
        from goliath_torch.scripts import run_train

        super().__init__(torch, captured)
        self.binning, self.run_train, self.wrap = binning, run_train, wrap
        self.orig_data = run_train.build_dataset
        self.orig_cs = binning.cumsum1d

    def __enter__(self):
        orig_data, orig_cs, wrap = self.orig_data, self.orig_cs, self.wrap
        k4 = self.captured.setdefault("k4", [])

        def cs(x):
            if len(k4) < 2:
                k4.append(self.to_host(x))
            return orig_cs(x)

        self.run_train.build_dataset = lambda *a, **kw: wrap(
            orig_data(*a, **kw))
        self.binning.cumsum1d = cs
        return super().__enter__()

    def __exit__(self, *exc):
        self.run_train.build_dataset = self.orig_data
        self.binning.cumsum1d = self.orig_cs
        return super().__exit__(*exc)


def drivable_train_path(gc, torch, card_line, record, captured):
    """run_train.main (its loop, train.make_train_step) on the drivable
    model at full width (drivable_config, the config's optimizer and
    mesh_config's losses), batch 4, 3 steps, its dataset wrapped by
    DrivableData: K5 once per sample of each step and of the summary's
    train=False forward at iteration 0, K4 twice per render, no splat
    kernel; every group's gradient finite and non-zero but the default
    group's, which holds the frozen face decoder alone: no gradient, and
    its parameters exactly as they were after the 3 updates."""
    n = TRAIN_BATCH * (TRAIN_STEPS + 1)
    cfg = drivable_config()
    return run_training(
        gc, torch, card_line, "drivable train path",
        dict(zbuffer=n, cumsum1d=2 * n), record,
        patch=DrivableTrainCapture(torch, captured, drivable_wrap(cfg)),
        make_config=drivable_config,
        frozen=("__default__", {"decoder_face"}))


def drivable_small_reference(torch):
    """The drivable model at a small size (DRIVABLE_SMALL on
    MESH_SMALL_DATA, the jittered template), card (kernels) against CPU
    (plain versions): run_test.main's eval means at SMALL_RTOL, and one
    training step through small_train_step_reference (losses at
    SMALL_RTOL, gradients by its rule), both with DrivableData."""
    from goliath_torch.scripts import run_test, run_train

    cfg = drivable_config(DRIVABLE_SMALL, MESH_SMALL_DATA)
    wrap = drivable_wrap(cfg)
    build_test, build_train = run_test.build_dataset, run_train.build_dataset

    def jittered(data_cfg, **kw):
        return wrap(jitter_template(build_test(data_cfg, **kw)))

    run_test.build_dataset = jittered
    try:
        got = run_test.main(cfg, device=DEVICE)
        ref = run_test.main(cfg, device="cpu")
    finally:
        run_test.build_dataset = build_test
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    log(f"small-input drivable eval reference (card vs CPU plain): means "
        f"{json.dumps(got)}; max rel diff {worst:.3e} (tolerance "
        f"{SMALL_RTOL})")
    if not (worst <= SMALL_RTOL and set(got) == set(ref)):
        raise AssertionError("the card's drivable eval disagrees with the "
                             "CPU's")
    run_train.build_dataset = lambda *a, **kw: wrap(build_train(*a, **kw))
    try:
        train = small_train_step_reference(
            torch, "drivable", lambda o: drivable_config(
                [*DRIVABLE_SMALL, *o], MESH_SMALL_DATA))
    finally:
        run_train.build_dataset = build_train
    return {"eval_rel_err": worst, **train}


# URHand (configs/urhand.yml) on the mesh paths' synthetic sphere
# (MESH_DATA: 65,536 faces, 2048x1334, uv 1024, 5 lights). Cuts, each
# forced by the synthetic data or the repo: global_scaling 1 (the default
# 10 puts the sphere's radius of 1,000 around ring cameras at distance
# 400); pose_enc_dims 12 (the synthetic skeleton's 4 joint triplets; the
# config's 60 needs the Goliath hand skeleton); in the eval path effnet
# and effnet_phys dropped (EfficientNet weights are not in the repo; the
# training path runs them on random features) and cal dropped by run_test
# itself.
URHAND_DROPPED_LOSSES = ("effnet", "effnet_phys")
URHAND_CUTS = ["model.global_scaling=1.0", "model.relight.pose_enc_dims=12"]
# the small URHand config of tests/test_torch_urhand_run_test.py
URHAND_SMALL_DATA = {"synthetic": True, "img_h": 48, "img_w": 48,
                     "uv_size": 32, "n_cams": 2, "n_frames": 2,
                     "n_lights": 2, "seed": 4}
URHAND_SMALL = [
    'model.renderer={"image_height": 48, "image_width": 48, '
    '"max_faces_per_tile": 128, "chunk": 16}',
    "model.relight.uv_size=32", "model.relight.init_uv_size=8",
    "model.relight.disp_enc_dims=[8, 8, 8]", "model.relight.disp_scale=0.3",
    "model.relight.init_channels=16", "model.shadow_size=32"]
# URHand renders 2 passes of B x L light views (shadow-map depths, B = 1)
# and 3 images (rgb, phys, normals) a frame
URHAND_LIGHTS = 5
URHAND_K5_PER_FRAME = 2 * URHAND_LIGHTS + 3
# the share of each light view's shadow map strictly between that map's
# smallest and largest value: a view whose maps are one value (all lit, all
# culled) fails
URHAND_MIN_GRADED = 0.1


def urhand_config(overrides=(), data=MESH_DATA):
    """configs/urhand.yml for run_test on synthetic ``data`` (MESH_DATA
    unless given), with URHAND_CUTS and the config's losses but
    URHAND_DROPPED_LOSSES (rgb_l1_focus, rgb_l1_phys, list_l1_reg)."""
    from goliath_torch.config import Config, load_config

    cfg = load_config(str(ROOT / "configs" / "urhand.yml"), overrides=[
        f"data={yaml_flow(data)}", f"test.data={yaml_flow(data)}",
        "test.ckpt=null", "test.n_test_frames=3", "test.vis_path=null",
        *URHAND_CUTS, *overrides])
    cfg.loss.losses = Config.wrap({
        k: v for k, v in cfg.loss.losses.to_dict().items()
        if k not in URHAND_DROPPED_LOSSES})
    return cfg


def urhand_eval_path(gc, torch, card_line, captured):
    """run_test.main on configs/urhand.yml at full width (urhand_config),
    counts reset just before: 3 frames with finite losses; every z-buffer
    output (10 light views and 3 renders a frame) covering at least
    MESH_MIN_COVERED of its image (the renders' alpha > 0 is their index
    image's coverage); rendered_phys_rgb non-zero; each light view's shadow
    map graded (URHAND_MIN_GRADED); K5 13 and K4 26 times a frame, no
    splat kernel. Keeps in ``captured`` the run's own K5 arguments of the
    first light view and of the first render, and the first frame's 26 K4
    scans (pinned host copies, no synchronise), then profiles the last
    frame again on the run's model. The checks add a few reductions a
    frame to the timed frames."""
    from goliath_torch.models import urhand
    from goliath_torch.ops import binning, rasterizer
    from goliath_torch.scripts import run_test

    cfg = urhand_config()
    n_k5 = URHAND_K5_PER_FRAME
    frames, covered, graded, phys, k4_inputs, built = [], [], [], [], [], {}
    orig_zb, orig_cs = rasterizer.zbuffer, binning.cumsum1d
    orig_sm, orig_build = urhand.get_shadow_map, run_test.load_from_config

    def to_host(x):   # pinned memory, no synchronise
        return x.to("cpu", non_blocking=True) \
            if isinstance(x, torch.Tensor) else x

    def zb(*args):
        if len(covered) == 0:
            captured["k5_shadow"] = tuple(to_host(a) for a in args)
        elif len(covered) == 2 * URHAND_LIGHTS:
            captured["k5_render"] = tuple(to_host(a) for a in args)
        index_img, z_img = orig_zb(*args)
        covered.append(((index_img >= 0).sum(), index_img.numel()))
        return index_img, z_img

    def cs(x):
        if len(k4_inputs) < 2 * n_k5:
            k4_inputs.append(to_host(x))
        return orig_cs(x)

    def shadow_map(*args):
        sm = orig_sm(*args)
        v = torch.exp(-sm / 8.0).flatten(1)
        lo, hi = v.amin(1, keepdim=True), v.amax(1, keepdim=True)
        graded.append(((v > lo) & (v < hi)).float().mean(1))
        return sm

    def build(*a, **kw):
        model = built["model"] = orig_build(*a, **kw)
        orig_apply = model.apply

        def apply(batch, **akw):
            built["batch"] = batch   # the frame the loop holds anyway
            preds = orig_apply(batch, **akw)
            phys.append(preds["rendered_phys_rgb"].abs().amax())
            return preds

        model.apply = apply
        built["orig_apply"] = orig_apply
        return model

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rasterizer.zbuffer, binning.cumsum1d = zb, cs
    urhand.get_shadow_map = shadow_map
    run_test.load_from_config = build
    gc.reset_launch_counts()
    try:
        means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    finally:
        rasterizer.zbuffer, binning.cumsum1d = orig_zb, orig_cs
        urhand.get_shadow_map = orig_sm
        run_test.load_from_config = orig_build
    peak = torch.cuda.max_memory_allocated()
    captured["k4"] = k4_inputs
    covered = [int(n) / size for n, size in covered]
    graded = torch.cat(graded).tolist() if graded else []
    phys = [float(p) for p in phys]
    log(f"URHand path launches: {launches}")
    log(f"URHand eval means: {json.dumps(means)}")
    for i, sec in enumerate(frames):
        log(f"URHand frame {i}: wall {sec:.4f} s on {card_line}")
    log(f"peak device memory (URHand eval): {peak / 2**30:.3f} GiB on "
        f"{card_line}")
    for i in range(len(covered) // n_k5):
        c = covered[i * n_k5:(i + 1) * n_k5]
        log(f"URHand frame {i}: covered share of the light views "
            f"{[round(x, 4) for x in c[:-3]]}, of the renders "
            f"{[round(x, 4) for x in c[-3:]]} (floor {MESH_MIN_COVERED})")
    log(f"URHand shadow maps: share strictly between each light view's "
        f"extremes {[round(g, 4) for g in graded]} (floor "
        f"{URHAND_MIN_GRADED}); largest |rendered_phys_rgb| per frame {phys}")
    if len(frames) != 3 or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError("URHand eval losses are not finite")
    if len(covered) != 3 * n_k5 or not all(c >= MESH_MIN_COVERED
                                           for c in covered):
        raise AssertionError("a URHand light view or render covered too "
                             "little of its image")
    if len(graded) != 3 * 2 * URHAND_LIGHTS or not all(
            g >= URHAND_MIN_GRADED for g in graded):
        raise AssertionError("a URHand light view's shadow map is not graded")
    if len(phys) != 3 or not all(p > 0 for p in phys):
        raise AssertionError("rendered_phys_rgb is zero")
    expected = {name: 0 for name in gc.LAUNCHES}
    expected.update(zbuffer=3 * n_k5, cumsum1d=3 * 2 * n_k5)
    if launches != expected:
        raise AssertionError(f"URHand path launch counts {launches} != "
                             f"{expected}")
    model = built.pop("model")
    model.apply = built.pop("orig_apply")
    profile_forward(torch, model, built.pop("batch"), card_line,
                    "profiled URHand frame (forward of the last frame, run "
                    "again)", train=False)
    return launches


# URHand training (run_train on configs/urhand.yml) at full width: the
# eval cuts, cal kept, the config's batch 1 and all five of its losses;
# effnet and effnet_phys on the fixed-seed random EfficientNet-B0 features
# that their loss config asks for (no ImageNet weights are in the repo:
# their cost is the real network's, their values are not)
URHAND_TRAIN_BATCH = 1
URHAND_PERCEPTUAL = ("effnet", "effnet_phys")


def urhand_train_config(overrides=(), data=MESH_DATA):
    """configs/urhand.yml for run_train on synthetic ``data`` (MESH_DATA
    unless given) with URHAND_CUTS and every loss of the config, the
    perceptual ones with ``allow_random_features: true``."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / "urhand.yml"), overrides=[
        f"data={yaml_flow(data)}", *URHAND_CUTS,
        *(f"loss.losses.{k}.allow_random_features=true"
          for k in URHAND_PERCEPTUAL), *overrides])


class URHandTrainCapture(MeshTrainCapture):
    """For the duration of a with-block: keeps in ``captured`` the K5
    arguments of the run's first light view (``"k5_shadow"``) and of its
    rgb render (``"k5_render"``, the launch after the two shadow passes),
    the first step's K4 scans (``"k4"``), and the inputs and output of the
    first step's edge-gradient backward of the rgb and of the phys render
    (``"edge"``, by label), copied to pinned host memory without a
    synchronise."""

    def __init__(self, torch, captured):
        from goliath_torch.ops import binning

        super().__init__(torch, captured)
        self.binning = binning
        self.orig_more = binning.cumsum1d, self.rasterizer.edge_grad_estimator

    def __enter__(self):
        orig_zb, orig_eg = self.orig
        orig_cs, orig_est = self.orig_more
        captured, to_host = self.captured, self.to_host
        n_zb, k4, labels = [0], captured.setdefault("k4", []), {}
        edge = captured.setdefault("edge", {})

        def zb(*args):
            if n_zb[0] == 0:
                captured["k5_shadow"] = tuple(to_host(a) for a in args)
            elif n_zb[0] == 2 * URHAND_LIGHTS:
                captured["k5_render"] = tuple(to_host(a) for a in args)
            n_zb[0] += 1
            return orig_zb(*args)

        def cs(x):
            if len(k4) < 2 * URHAND_K5_PER_FRAME:
                k4.append(to_host(x))
            return orig_cs(x)

        def est(v_pix, vi, bary_img, img, index_img, depth_img):
            # the first step's two estimators: the rgb render, then phys
            if len(labels) < 2:
                labels[img.data_ptr()] = ("rgb", "phys")[len(labels)]
            return orig_est(v_pix, vi, bary_img, img, index_img, depth_img)

        def eg(g, img, vi, bary_img, index_img, depth_img, n_verts):
            out = orig_eg(g, img, vi, bary_img, index_img, depth_img,
                          n_verts)
            label = labels.get(img.data_ptr())
            if label is not None and label not in edge:
                edge[label] = (tuple(to_host(a) for a in (
                    g, img, bary_img, index_img, depth_img)), to_host(vi),
                    n_verts, to_host(out))
            return out

        self.rasterizer.zbuffer, self.rasterizer.edge_grads = zb, eg
        self.rasterizer.edge_grad_estimator = est
        self.binning.cumsum1d = cs
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.binning.cumsum1d, self.rasterizer.edge_grad_estimator = \
            self.orig_more


def urhand_train_path(gc, torch, card_line, record, captured):
    """run_train.main on configs/urhand.yml at full width
    (urhand_train_config), batch 1, 3 steps: K5 13 and K4 26 times a forward
    (2 x L = 10 light views and 3 renders, two binning scans each) for the
    3 training forwards and the summary's train=False forward at iteration
    0, no splat kernel. The cal group's gradient may be zero only if every
    step drew cal's identity camera, which passes the image through. Keeps
    URHandTrainCapture's inputs in ``captured``."""
    n = URHAND_K5_PER_FRAME * URHAND_TRAIN_BATCH * (TRAIN_STEPS + 1)

    def zero_grad_ok(probe):
        # cal.identity_camera "400870" is not a synthetic camera, so CalV5
        # falls back to the first one
        drawn = {c for step in probe.cameras for c in step}
        return {"cal"} if drawn <= {probe.identity_camera} else set()

    launches = run_training(
        gc, torch, card_line, "URHand train path",
        dict(zbuffer=n, cumsum1d=2 * n), record,
        patch=URHandTrainCapture(torch, captured),
        make_config=urhand_train_config, batch=URHAND_TRAIN_BATCH,
        zero_grad_ok=zero_grad_ok)
    time_perceptual(torch, card_line)
    return launches


def time_perceptual(torch, card_line):
    """The step's two perceptual losses alone at the render's shape
    ([1, 3, 2048, 1334], a render's exact-0 background on half the image,
    the mask rendered_mask): each one's forward, and its forward with the
    backward to the rendered image, by CUDA events."""
    from goliath_torch.losses import perceptual
    from goliath_torch.utils.timing import cuda_ms

    H, W = MESH_DATA["img_h"], MESH_DATA["img_w"]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.rand((1, 3, H, W), generator=gen, device=DEVICE) * 255
    x[..., : H // 2, :] = 0.0
    x.requires_grad_()
    y = torch.rand((1, 3, H, W), generator=gen, device=DEVICE) * 255
    mask = (x[:, :1] > 0).float()
    for name, cls in (("effnet", perceptual.EfficientNetLossImpl),
                      ("effnet_phys", perceptual.EfficientNetLossImplPhys)):
        loss = cls(None, tgt_key="image", mask_key="rendered_mask",
                   allow_random_features=True)
        preds = {"rendered_rgb": x, "rendered_phys_rgb": x,
                 "rendered_mask": mask}
        with torch.no_grad():
            fwd = cuda_ms(lambda: loss(preds, {"image": y}), reps=5)

        def both():
            loss(preds, {"image": y}).backward()

        fwd_bwd = cuda_ms(both, reps=5)
        log(f"{name} at [1, 3, {H}, {W}]: forward {fwd:.3f} ms, forward and "
            f"backward to the image {fwd_bwd:.3f} ms (CUDA events, 5 calls) "
            f"on {card_line}")


def k5_urhand_train(gc, torch, captured):
    """K5 bit for bit on the URHand training run's first light view and on
    its first rgb render; returns the light view's measurements."""
    view = check_k5(gc, torch, captured["k5_shadow"],
                    "K5 (URHand training step 0, first light view)")
    check_k5(gc, torch, captured["k5_render"],
             "K5 (URHand training step 0, rgb render)")
    return view


def urhand_edge_grad_check(torch, captured):
    """The edge-gradient backward of the URHand training run's first rgb
    and phys renders, card against CPU (check_edge_grads)."""
    if set(captured) != {"rgb", "phys"}:
        raise AssertionError(f"edge-gradient backward captured for "
                             f"{sorted(captured)}, not rgb and phys")
    return {label: check_edge_grads(
        torch, captured[label],
        f"edge-gradient backward (URHand step 0, {label} render)")
        for label in ("rgb", "phys")}


# MVP hands (run_test on configs/hand_mvp.yml) at full width: uv 1024,
# primsize [16, 16, 8] (4,096 prims of 8x16x16 voxels), n_embs 64,
# volradius 2000, prim_scale 512, 2048x1334 images in 84 x 128 tiles of 16,
# the raymarcher's dt 1, max_steps 128, max_prims_per_tile 64, chunk 16 and
# the config's window_steps 16, on the 65,536-face sphere of MESH_DATA.
# Cuts: n_pose_dims 6 (the synthetic 3-joint skeleton's local pose; 54
# needs the Goliath hand skeleton) and global_scaling 1 (at the default 10
# the sphere's radius of 1,000 puts the cameras, at distance 400, inside
# it). rgb_l2, vgg and mask_l1 read image_mask (synthetic data has no
# segmentation_fgbg) and vgg takes fixed-seed random features (no ImageNet
# weights are in the repo: the real network's cost, not its values).
HAND_MVP_CUTS = ["model.n_pose_dims=6", "model.global_scaling=1.0",
                 "loss.losses.rgb_l2.mask_key=image_mask",
                 "loss.losses.vgg.mask_key=image_mask",
                 "loss.losses.vgg.allow_random_features=true",
                 "loss.losses.mask_l1.tgt_key=image_mask"]
# the small config of tests/test_torch_hand_mvp.py
HAND_MVP_SMALL_DATA = {"synthetic": True, "img_h": 48, "img_w": 48,
                       "uv_size": 64, "n_cams": 2, "n_frames": 2, "seed": 1}
HAND_MVP_SMALL = [
    "model.image_height=48", "model.image_width=48", "model.uv_size=64",
    "model.primsize=[8, 8, 4]", "model.n_embs=8", "model.volradius=400.0",
    "model.prim_scale=12.0", "model.raymarcher.dt=4.0",
    "model.raymarcher.max_steps=64", "model.raymarcher.max_prims_per_tile=32",
    "model.raymarcher.chunk=8"]
# a march makes one binning, whose two prefix sums run on K4
HAND_MVP_K4_PER_FRAME = 2
# the window of march_window_check: 2 x 2 tiles at the image centre
MVP_WINDOW = 32


def k4_mvp_check(gc, torch, inputs, label="hand_mvp frame 0"):
    """K4 on an MVP march's frame 0 scans (the [4,096] prims' tile counts
    and the [32,768] slot marks; the hand_mvp or the teacher path's)
    against torch.cumsum, exactly, and timed there (time_k4)."""
    k4_mesh_check(gc, torch, inputs, HAND_MVP_K4_PER_FRAME, label)
    return time_k4(gc, torch, [x.to(DEVICE) for x in inputs])


def hand_mvp_config(overrides=(), data=MESH_DATA):
    """configs/hand_mvp.yml for run_test on synthetic ``data`` (MESH_DATA
    unless given) with HAND_MVP_CUTS and the config's losses read as
    synthetic data allows (rgb_l2, vgg, mask_l1, alphaprior, primvolsum;
    run_test drops learn_blur)."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / "hand_mvp.yml"), overrides=[
        f"data={yaml_flow(data)}", f"test.data={yaml_flow(data)}",
        "test.ckpt=null", "test.n_test_frames=3", "test.vis_path=null",
        *HAND_MVP_CUTS, *overrides])


def hand_mvp_eval_path(gc, torch, card_line, captured):
    """run_test.main on configs/hand_mvp.yml at full width
    (hand_mvp_config), counts reset just before: 3 frames with finite
    losses, rgb, alpha and mvp_window_overflow and finite prim parameters;
    a render that is not empty; K4 twice a frame (one march, one binning),
    K8 once a frame (the march's tiles, no gradient) and no other kernel.
    Keeps in ``captured`` frame 0's march arguments
    (on the card), its two K4 scans and its posed mesh; times each march
    by CUDA events; then profiles the last frame again on the run's
    model."""
    from goliath_torch.ops import binning
    from goliath_torch.scripts import run_test
    from goliath_torch.utils import render_raymarcher

    cfg = hand_mvp_config()
    frames, marches, k4_inputs, stats, built = [], [], [], [], {}
    orig_cs, orig_march = binning.cumsum1d, render_raymarcher.mvp_raymarch_tiled
    orig_build = run_test.load_from_config

    def cs(x):
        if len(k4_inputs) < HAND_MVP_K4_PER_FRAME:
            k4_inputs.append(x.to("cpu", non_blocking=True))
        return orig_cs(x)

    def march(*args, **kw):
        captured.setdefault("march", (args, kw))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = orig_march(*args, **kw)
        ev[1].record()
        marches.append(ev)
        return out

    def build(*a, **kw):
        model = built["model"] = orig_build(*a, **kw)
        orig_apply = model.apply

        def apply(batch, **akw):
            built["batch"] = batch   # the frame the loop holds anyway
            preds = orig_apply(batch, **akw)
            captured.setdefault("geom_lbs", preds["geom_lbs"])
            alpha = preds["alpha"]
            prims = torch.cat([preds[k].flatten() for k in (
                "primpos", "primrot", "primscale", "primrgb", "primalpha")])
            stats.append(torch.stack([
                alpha.amax(), (alpha > 0.5).float().mean(),
                (alpha > 0).float().mean(),
                torch.isfinite(preds["rgb"]).all().float(),
                torch.isfinite(alpha).all().float(),
                (~torch.isfinite(prims)).sum().float(),
                preds["mvp_window_overflow"].float()]))
            return preds

        model.apply = apply
        built["orig_apply"] = orig_apply
        return model

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    binning.cumsum1d = cs
    render_raymarcher.mvp_raymarch_tiled = march
    run_test.load_from_config = build
    gc.reset_launch_counts()
    try:
        means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    finally:
        binning.cumsum1d = orig_cs
        render_raymarcher.mvp_raymarch_tiled = orig_march
        run_test.load_from_config = orig_build
    peak = torch.cuda.max_memory_allocated()
    captured["k4"] = k4_inputs
    march_ms = [a.elapsed_time(b) for a, b in marches]
    stats = torch.stack(stats).tolist() if stats else []
    log(f"hand_mvp path launches: {launches}")
    log(f"hand_mvp eval means: {json.dumps(means)}")
    for i, sec in enumerate(frames):
        share = march_ms[i] / (sec * 1e3) if i < len(march_ms) else math.nan
        log(f"hand_mvp frame {i}: wall {sec:.4f} s, march {march_ms[i]:.3f} "
            f"ms (CUDA events; {share:.3f} of the frame) on {card_line}")
    log(f"peak device memory (hand_mvp eval): {peak / 2**30:.3f} GiB on "
        f"{card_line}")
    for i, (amax, over_half, covered, rgb_ok, alpha_ok, bad_prims,
            overflow) in enumerate(stats):
        log(f"hand_mvp frame {i}: alpha max {amax:.6g}, share of pixels "
            f"with alpha > 0.5 {over_half:.6f}, > 0 {covered:.6f}; "
            f"non-finite prim parameters {int(bad_prims)}; "
            f"mvp_window_overflow {overflow:.6f}")
    if len(frames) != 3 or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError("hand_mvp eval losses are not finite")
    if len(stats) != 3 or not all(s[3] == 1 and s[4] == 1
                                  and math.isfinite(s[6]) for s in stats):
        raise AssertionError("hand_mvp rgb, alpha or mvp_window_overflow is "
                             "not finite")
    if not all(s[0] > 0 for s in stats):
        raise AssertionError("a hand_mvp frame rendered nothing (alpha 0)")
    expected = {name: 0 for name in gc.LAUNCHES}
    expected.update(cumsum1d=3 * HAND_MVP_K4_PER_FRAME, mvp_march=3)
    if launches != expected:
        raise AssertionError(f"hand_mvp path launch counts {launches} != "
                             f"{expected}")
    model = built.pop("model")
    model.apply = built.pop("orig_apply")
    captured["model"] = model
    profile_forward(torch, model, built.pop("batch"), card_line,
                    "profiled hand_mvp frame (forward of the last frame, "
                    "run again)", train=False)
    return launches


def mvp_march_check(torch, captured, card_line):
    """On frame 0 of hand_mvp_eval_path: the march's drops (its ``drops``
    counts, and the prims whose base frame fell back to the identity);
    the card's mvp_raymarch_tiled against the same function on the CPU
    (plain PyTorch, the whole frame), rgba at rtol 1e-4 plus 1e-6 of the
    largest |value| (the deposit's atomics and the reductions sum in other
    orders); then march_window_check."""
    import numpy as np

    from goliath_torch.models.hand_mvp import prim_bases
    from goliath_torch.ops import mvp
    from goliath_torch.utils.timing import cuda_call_ms

    args, kw = captured["march"]
    gd = captured["model"].module.geomdecoder
    _, rot, fallback = prim_bases(captured["geom_lbs"], gd.geo_fn.vt,
                                  gd.vidx, gd.vtidx, gd.bary)
    log(f"hand_mvp frame 0: {int(fallback.sum())} of {fallback.numel()} "
        f"prim base frames fell back to the identity, "
        f"{int((~torch.isfinite(rot)).any(-1).any(-1).sum())} are not finite")
    drops = {}
    got, ms = cuda_call_ms(lambda: mvp.mvp_raymarch_tiled(
        *args, drops=drops, **kw))
    drops = {k: int(v) for k, v in drops.items()}
    log(f"hand_mvp frame 0 march drops: {json.dumps(drops)}")
    log(f"hand_mvp frame 0 march with the drop counts: {ms:.3f} ms on "
        f"{card_line}")
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    t0 = time.perf_counter()
    ref = mvp.mvp_raymarch_tiled(*cpu, **kw)
    cpu_s = time.perf_counter() - t0
    got, ref = got.cpu().numpy(), ref.numpy()
    err = np.abs(got - ref)
    allowed = 1e-4 * np.abs(ref) + 1e-6 * float(np.abs(ref).max())
    n_over = int((err > allowed).sum())
    log(f"hand_mvp frame 0 march, card vs CPU plain ({cpu_s:.1f} s on "
        f"{torch.get_num_threads()} threads): max abs err "
        f"{float(err.max()):.3e} of largest |rgba| "
        f"{float(np.abs(ref).max()):.6g}, {n_over} entries over rtol 1e-4 "
        f"+ 1e-6 of the largest")
    if n_over or got.shape != ref.shape:
        raise AssertionError("the card's march disagrees with the CPU's")
    march_window_check(torch, args, kw)
    return {"march_ms": ms, "drops": drops}


def march_window_check(torch, args, kw):
    """march_reference (every prim, every step) against the tiled march on
    the card, on frame 0's MVP_WINDOW x MVP_WINDOW pixels at the image
    centre, with nothing dropped: max_prims_per_ray = max_prims_per_tile =
    the window's largest tile list (rounded up to the chunk), no window
    (window_steps None), and both marching from a common tmin in front of
    the sphere for as many steps as reach past it. rgba at rtol 1e-3 plus
    1e-4 of the largest |value| (the two sample on grids from tmin and
    from each ray's aligned first step, equal up to rounding)."""
    import numpy as np

    from goliath_torch.ops import mvp

    raypos, raydir, stepsize, tminmax, pos, rot, scale, tpl, K_cam, Rt = args
    H, W = raypos.shape[:2]
    ts = kw.get("tile_size", 16)
    n = MVP_WINDOW
    y0, x0 = (H // 2) // ts * ts, (W // 2) // ts * ts
    win = (slice(y0, y0 + n), slice(x0, x0 + n))
    rp, rd = raypos[win].contiguous(), raydir[win].contiguous()
    K_w = K_cam.clone()
    K_w[:2, 2] -= K_w.new_tensor([x0, y0])
    # the sphere lies within |p| <= the prims' reach around the origin of
    # the normalized frame; the rays start at the camera
    reach = float((pos.norm(dim=-1) + 2.0 / scale.amin(-1)).amax())
    dist = float(rp[0, 0].norm())
    t_lo, t_hi = max(dist - reach, 0.0), dist + reach
    steps = int(math.ceil((t_hi - t_lo) / stepsize)) + 2
    tm = torch.stack([torch.full_like(tminmax[win][..., 0], t_lo),
                      tminmax[win][..., 1]], -1)
    # the window's longest tile list, from a march of one slot a ray
    drops = {}
    march_kw = dict(kw, max_steps=steps, window_steps=None,
                    max_prims_per_tile=pos.shape[0], max_prims_per_ray=1,
                    chunk=1)
    mvp.mvp_raymarch_tiled(rp, rd, stepsize, tm, pos, rot, scale, tpl, K_w,
                           Rt, drops=drops, **march_kw)
    chunk = kw.get("chunk", 16)
    m = -(-int(max(1, drops["max_tile_list"])) // chunk) * chunk
    march_kw.update(max_prims_per_tile=m, max_prims_per_ray=m, chunk=chunk)
    drops = {}
    tiled = mvp.mvp_raymarch_tiled(rp, rd, stepsize, tm, pos, rot, scale,
                                   tpl, K_w, Rt, drops=drops, **march_kw)
    ref = mvp.march_reference(rp.reshape(-1, 3), rd.reshape(-1, 3),
                              stepsize, tm.reshape(-1, 2), pos, rot, scale,
                              tpl, steps).reshape(n, n, 4).permute(2, 0, 1)
    drops = {k: int(v) for k, v in drops.items()}
    dropped = {k: drops[k] for k in (
        "prims_dropped", "prims_cut", "prims_clipped", "tiles_full",
        "rays_over_r", "window_cut_pairs", "rays_step_capped")}
    got, ref = tiled.cpu().numpy(), ref.cpu().numpy()
    err = np.abs(got - ref)
    allowed = 1e-3 * np.abs(ref) + 1e-4 * float(np.abs(ref).max())
    n_over = int((err > allowed).sum())
    log(f"hand_mvp frame 0, {n}x{n} window at ({x0}, {y0}): every prim on "
        f"{steps} steps from t {t_lo:.6f}, tile lists and rays of {m} "
        f"prims; drops {dropped}; "
        f"largest |rgba| {float(np.abs(ref).max()):.6g}, alpha max "
        f"{float(ref[3].max()):.6g}; max abs err {float(err.max()):.3e}, "
        f"{n_over} entries over rtol 1e-3 + 1e-4 of the largest")
    if any(dropped.values()) or n_over:
        raise AssertionError("march_reference and the tiled march disagree "
                             "on the window (or a drop separated them)")


# K8's operations a deposited tap (csrc/mvp_march.cu, no warp field), each
# float32 multiply, add, abs, floor, division or exp one: tj 2, the mask's
# tmax + 1e-5 1, y 6, the fade 16 (|y| and three squarings a coordinate,
# 2 sums, the scale, exp), the box test's |y| 3, the sampler 106 (x, y, z
# 9, floors 3, fractions 3, the x weights 3; over the four (z, y) corners
# 1 - wz and 1 - wy 4, their weights 8, 4 channels x (2 products, a sum, a
# weight) 64, the running sums 12), alpha 2, (rgb * a) 3, the deposit 4
K8_OPS_PER_TAP = 143
# K9's operations as the function needs them, counted the same way: a
# point 43 (d 3, the norm 6, its floor 1, a coordinate's direction, |.|,
# reciprocal, two slab ends and their minimum 8 x 3, the maxima 2, the
# clamp 1, seg 2, the scale, the product and the clamp 4), a sample 57 (ts
# 2, the position 6, each axis's coordinate 4, floor, fraction and 1 - w
# 7 x 3 (a tap outside the grid is selected away, not multiplied), the
# eight corners' weights 12 (four (z, y) products, then x), terms 8 and
# sums 7, the running sum 1), and a step's fraction 2 once for all points
K9_OPS_PER_POINT, K9_OPS_PER_SAMPLE, K9_OPS_PER_STEP = 43, 57, 2


def march_kept_rows(inp):
    """Rows of the packed template that K8 reads at least once: the rows of
    every prim that some tile list keeps (its first max_prims_per_tile
    pairs)."""
    import torch

    M = inp.max_prims_per_tile
    idx = inp.tile_start.long()[:, None] + torch.arange(
        M, device=inp.tile_start.device)
    keep = idx < inp.tile_end.long()[:, None]
    kept = torch.unique(inp.sorted_prim[idx[keep]]).numel()
    K, C, D, H, W = inp.template.shape
    return kept, kept * D * H * W


def k8_check(gc, torch, captured, card_line, label):
    """K8 against its plain version on the card, on frame 0's march of a
    path (``captured["march"]``: its MarchInputs rebuilt by
    ``mvp.march_inputs``): rgba at rtol 1e-4 plus 1e-6 of the largest
    |value| (the plain deposit's atomics and reductions sum in other
    orders); the deposited taps and in-group drops of both routes logged
    with their differences (a tap's mask can flip between the routes'
    roundings: not held); K8's time (cuda_ms over 10 calls) and the plain
    version's (cuda_call_ms, one call), and K8's bound: the larger of the
    bytes (the rays of the tiles with prims, 32 B a ray: an empty tile's
    rgba is 0 and its rays are not read; the rgba, 16 B a ray; the rows of
    the prims the tile lists keep, 32 B a row) and the operations of the
    deposited taps (K8_OPS_PER_TAP each)."""
    import numpy as np

    from goliath_torch.ops import mvp
    from goliath_torch.ops import mvp_cuda as mc
    from goliath_torch.utils.timing import cuda_call_ms, cuda_ms

    args, kw = captured["march"]
    with torch.no_grad():
        inp = mvp.march_inputs(*args, **kw)[0]
        got, counts = mc.mvp_march(inp, True)
        ref, ref_counts = mc.mvp_march_plain(inp, True)
        torch.cuda.synchronize()
        counts = {k: int(v) for k, v in counts.items()}
        ref_counts = {k: int(v) for k, v in ref_counts.items()}
        ms = cuda_ms(lambda: mc.mvp_march(inp), reps=10, warmup=1)
        _, plain_ms = cuda_call_ms(lambda: mc.mvp_march_plain(inp))
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    err = np.abs(got - ref)
    scale = float(np.abs(ref).max())
    n_over = int((err > 1e-4 * np.abs(ref) + 1e-6 * scale).sum())
    T, P = inp.raypos.shape[:2]
    kept, rows = march_kept_rows(inp)
    live = int(((inp.tile_end - inp.tile_start) > 0).sum())
    nbytes = live * P * 32 + T * P * 16 + rows * 32
    ops = K8_OPS_PER_TAP * counts["taps"]
    b_ms, b_by = bound_ms(nbytes, ops)
    log(f"K8 {label}: {T} tiles ({live} with prims) of {P} rays, M "
        f"{inp.max_prims_per_tile}, R {inp.max_prims_per_ray}, S "
        f"{inp.max_steps}, window {inp.window_steps}; rgba max abs err "
        f"{float(err.max()):.3e} of largest {scale:.6g}, {n_over} entries "
        f"over rtol 1e-4 + 1e-6 of the largest (tolerance)")
    log(f"K8 {label} counts, kernel {json.dumps(counts)}, plain "
        f"{json.dumps(ref_counts)}, kernel - plain "
        f"{json.dumps({k: counts[k] - ref_counts[k] for k in counts})}")
    log(f"K8 {label} timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({ms / b_ms:.1f}x the bound): bytes "
        f"{nbytes} (rays of the live tiles {live * P * 32}, rgba "
        f"{T * P * 16}, {kept} kept prims' {rows} rows at 32 B) -> {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; "
        f"operations {ops} ({counts['taps']} deposited taps at "
        f"{K8_OPS_PER_TAP}) -> {ops / FP32_OPS_PER_S * 1e3:.4f} ms; library: "
        f"none (no PyTorch call marches prims) on {card_line}")
    if n_over or got.shape != ref.shape or not counts["taps"]:
        raise AssertionError(f"K8 disagrees with its plain version on "
                             f"{label} (or deposits nothing)")
    return dict(max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                taps=counts["taps"], taps_plain=ref_counts["taps"])


def k9_check(gc, torch, captured, card_line):
    """K9 against its plain version on the card, on frame 0 of
    hand_teacher_eval_path: each light's shadow integral over all the
    frame's points, on the run's density grid and on the grid of its
    alpha-carrying prims grown TEACHER_GROW times (as teacher_shadow_check
    builds it), at rtol 1e-5 plus TEACHER_SHADOW_ATOL; timed on the grown
    grid's first light (K9 by cuda_ms over 10 calls, the plain version by
    cuda_call_ms), with its bound (the larger of the bytes: 12 B a point
    read, 4 B written, the grid once; and the operations:
    K9_OPS_PER_POINT, K9_OPS_PER_SAMPLE and K9_OPS_PER_STEP) and, as a
    yardstick of the sampling alone, F.grid_sample (5-D, trilinear, zeros,
    align_corners=False) over the same points x steps positions."""
    import torch.nn.functional as F

    from goliath_torch.ops import mvp
    from goliath_torch.ops import mvp_cuda as mc
    from goliath_torch.utils.timing import cuda_call_ms, cuda_ms

    args, kw, density = captured["grid"]
    shadows = captured["shadow"]
    pts = shadows[0][0]
    lights = [s[1] for s in shadows]
    n = TEACHER_SHADOW_STEPS
    keep = args[3].flatten(1).sum(1) > 0
    grown = [a[keep] for a in args[:4]] + list(args[4:])
    grown[2] = grown[2] / TEACHER_GROW
    with torch.no_grad():
        grids = {"the run's grid": density,
                 f"the alpha prims grown {TEACHER_GROW:g}x":
                     mvp.splat_density_grid(*grown, **kw)}
        worst = 0.0
        for name, grid in grids.items():
            for i, light in enumerate(lights):
                got = mc.shadow_integral(grid, pts, light, n)
                ref = mc.shadow_integral_plain(grid, pts, light, n)
                err = (got - ref).abs()
                n_over = int((err > 1e-5 * ref.abs()
                              + TEACHER_SHADOW_ATOL).sum())
                worst = max(worst, float(err.max()))
                log(f"K9 hand_teacher frame 0, {name}, light {i}: "
                    f"{pts.shape[0]} points, max abs err "
                    f"{float(err.max()):.3e}, mean {float(ref.mean()):.6g}, "
                    f"share > 0 {float((ref > 0).float().mean()):.6f}; "
                    f"{n_over} over rtol 1e-5 + {TEACHER_SHADOW_ATOL}")
                if n_over:
                    raise AssertionError(f"K9 disagrees with its plain "
                                         f"version ({name}, light {i})")
                del got, ref, err
        grid = grids[f"the alpha prims grown {TEACHER_GROW:g}x"]
        light = lights[0]
        ms = cuda_ms(lambda: mc.shadow_integral(grid, pts, light, n),
                     reps=10, warmup=1)
        _, plain_ms = cuda_call_ms(
            lambda: mc.shadow_integral_plain(grid, pts, light, n))
        # the plain version's sample positions, then one grid_sample call
        d = pts - light[None]
        dist = mvp._norm(d)
        dirn = d / dist.clamp(min=1e-8)
        inv = 1.0 / torch.where(dirn.abs() < 1e-12,
                                torch.full_like(dirn, 1e-12), dirn)
        t_enter = torch.minimum((-1.0 - light[None]) * inv,
                                (1.0 - light[None]) * inv).amax(
            -1, keepdim=True).clamp(min=0.0)
        seg = (dist - t_enter).clamp(min=0.0)
        frac = (torch.arange(n, dtype=pts.dtype, device=pts.device)
                + 0.5) / n
        pos = light + dirn[:, None] * (t_enter + seg * frac)[..., None]
        coords = pos.reshape(1, pts.shape[0], n, 1, 3)
        del d, dist, dirn, inv, t_enter, seg, pos
        library_ms = cuda_ms(lambda: F.grid_sample(
            grid[None, None], coords, mode="bilinear", padding_mode="zeros",
            align_corners=False), reps=3, warmup=1)
        del coords
    M = pts.shape[0]
    nbytes = M * 16 + grid.numel() * 4 + 12
    ops = M * (K9_OPS_PER_POINT + n * K9_OPS_PER_SAMPLE) \
        + n * K9_OPS_PER_STEP
    b_ms, b_by = bound_ms(nbytes, ops)
    log(f"K9 timing ({M} points, {n} steps, grid {tuple(grid.shape)}): "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by "
        f"{b_by} ({ms / b_ms:.1f}x the bound): bytes {nbytes} -> "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; operations {ops} "
        f"({K9_OPS_PER_POINT} a point, {K9_OPS_PER_SAMPLE} a sample, "
        f"{K9_OPS_PER_STEP} a step) -> "
        f"{ops / FP32_OPS_PER_S * 1e3:.4f} ms; library: F.grid_sample over "
        f"the {M * n} positions {library_ms:.4f} ms (the sampling alone, a "
        f"yardstick) on {card_line}")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# Cuts of configs/hand_teacher_mvp.yml: n_pose_dims 6 and global_scaling 1,
# as hand_mvp's (HAND_MVP_CUTS); mask_l1 reads image_mask (synthetic data
# has no segmentation_fgbg; at eval its start_at / end_at of 0 keep it on).
# run_test drops learn_blur and cal. rgb_l2 runs as written (no mask).
TEACHER_CUTS = ["model.n_pose_dims=6", "model.global_scaling=1.0",
                "loss.losses.mask_l1.tgt_key=image_mask"]
# the small config of tests/test_torch_hand_teacher.py
TEACHER_SMALL_DATA = {"synthetic": True, "img_h": 48, "img_w": 48,
                      "uv_size": 32, "n_cams": 2, "n_frames": 2,
                      "n_lights": 2, "seed": 5}
TEACHER_SMALL = [
    "model.image_height=48", "model.image_width=48", "model.uv_size=32",
    "model.primsize=[8, 8, 4]", "model.n_embs=8", "model.volradius=400.0",
    "model.prim_scale=12.0", "model.raymarcher.dt=4.0",
    "model.raymarcher.max_steps=48", "model.raymarcher.max_prims_per_tile=16",
    "model.raymarcher.chunk=8"]
# the shadow checks: points a light held card against CPU, and points of
# one light for the exact oracle
TEACHER_SHADOW_POINTS = 131_072
# the synthetic data's n_lights default, the reference's chunk of 5 lights
TEACHER_LIGHTS = 5
TEACHER_EXACT_POINTS = 1_024
# the teacher's shadow steps (OLATRGBDecoder's shadow_steps)
TEACHER_SHADOW_STEPS = 32
# teacher_shadow_check's second grid: the frame's prims that carry alpha,
# primscale divided by 32: their half-extent 1/16 of the volume, two grid
# cells at G 64 (grown 16x, the first 64 pairs of a block still miss every
# cell centre but ~11)
TEACHER_GROW = 32.0
# shadow_at_points card vs CPU on the card's density grid, absolute on
# values in [0, 1]: 32 samples of densities of up to ~1e3 summed in other
# orders (the accumulated alpha is clamped to 1, so only points under 1
# carry the rounding, ~1e-7 of 1)
TEACHER_SHADOW_ATOL = 1e-5


def teacher_config(overrides=(), data=MESH_DATA):
    """configs/hand_teacher_mvp.yml for run_test on synthetic ``data``
    (MESH_DATA unless given, with the synthetic data's 5 lights) with
    TEACHER_CUTS: its losses rgb_l2 and mask_l1 (run_test drops
    learn_blur)."""
    from goliath_torch.config import load_config

    return load_config(
        str(ROOT / "configs" / "hand_teacher_mvp.yml"), overrides=[
            f"data={yaml_flow(data)}", f"test.data={yaml_flow(data)}",
            "test.ckpt=null", "test.n_test_frames=3", "test.vis_path=null",
            *TEACHER_CUTS, *overrides])


def hand_teacher_eval_path(gc, torch, card_line, captured):
    """run_test.main on configs/hand_teacher_mvp.yml at full width
    (teacher_config), counts reset just before: 3 frames with finite
    losses, rgb, alpha, primrgb, primshadow and mvp_window_overflow; a
    render that is not empty and shadows in [0, 1] (their share above 0
    logged: teacher_shadow_check says why they can be all 0); K4 twice a
    frame (the march's binning), K8 once a frame (the march's tiles) and K9
    once a light (the shadow integrals), and no other kernel.
    Times each frame's march, density grid, shadow integrals (one a light)
    and UNet by CUDA events, logs the peak memory; keeps in ``captured``
    frame 0's two K4 scans, the density grid's inputs and output, the
    shadow integrals' points, lights and outputs, and the march's
    arguments; then profiles the last frame again on the run's model."""
    from goliath_torch.models import hand_teacher_mvp as teacher
    from goliath_torch.ops import binning
    from goliath_torch.scripts import run_test
    from goliath_torch.utils import render_raymarcher

    cfg = teacher_config()
    frames, k4_inputs, stats, built = [], [], [], {}
    events = {"march": [], "density grid": [], "shadow": [], "UNet": []}
    orig = {"cs": binning.cumsum1d,
            "march": render_raymarcher.mvp_raymarch_tiled,
            "grid": teacher.splat_density_grid,
            "shadow": teacher.shadow_at_points,
            "build": run_test.load_from_config}

    def timed(key, fn):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            events[key].append(ev)
            return out
        return call

    def cs(x):
        if len(k4_inputs) < HAND_MVP_K4_PER_FRAME:
            k4_inputs.append(x.to("cpu", non_blocking=True))
        return orig["cs"](x)

    def march(*args, **kw):
        captured.setdefault("march", (args, kw))
        return timed("march", orig["march"])(*args, **kw)

    def grid(*args, **kw):
        out = timed("density grid", orig["grid"])(*args, **kw)
        captured.setdefault("grid", (args, kw, out))
        return out

    def shadow(density, pts, light, *args, **kw):
        out = timed("shadow", orig["shadow"])(density, pts, light, *args,
                                              **kw)
        if len(captured.setdefault("shadow", [])) < built["L"]:
            captured["shadow"].append((pts, light, args, kw, out))
        return out

    def build(*a, **kw):
        model = built["model"] = orig["build"](*a, **kw)
        unet = model.module.relightdecoder.unet
        unet.forward = timed("UNet", unet.forward)
        orig_apply = model.apply

        def apply(batch, **akw):
            built["batch"] = batch   # the frame the loop holds anyway
            built["L"] = batch["light_pos"].shape[1]
            preds = orig_apply(batch, **akw)
            alpha = preds["alpha"]
            shadow0 = preds["primshadow"]
            stats.append(torch.stack([
                alpha.amax(), (alpha > 0).float().mean(),
                torch.isfinite(preds["rgb"]).all().float(),
                torch.isfinite(alpha).all().float(),
                torch.isfinite(preds["primrgb"]).all().float(),
                torch.isfinite(shadow0).all().float(),
                preds["mvp_window_overflow"].float(),
                shadow0.amin(), shadow0.amax(), shadow0.mean(),
                (shadow0 > 0).float().mean()]))
            return preds

        model.apply = apply
        built["orig_apply"] = orig_apply
        return model

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    binning.cumsum1d = cs
    render_raymarcher.mvp_raymarch_tiled = march
    teacher.splat_density_grid = grid
    teacher.shadow_at_points = shadow
    run_test.load_from_config = build
    gc.reset_launch_counts()
    try:
        means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    finally:
        binning.cumsum1d = orig["cs"]
        render_raymarcher.mvp_raymarch_tiled = orig["march"]
        teacher.splat_density_grid = orig["grid"]
        teacher.shadow_at_points = orig["shadow"]
        run_test.load_from_config = orig["build"]
    peak = torch.cuda.max_memory_allocated()
    captured["k4"] = k4_inputs
    L = built.get("L", 0)
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}
    # one shadow integral a light: a frame's is the sum of its L
    ms["shadow"] = [sum(ms["shadow"][i:i + L])
                    for i in range(0, len(ms["shadow"]), max(L, 1))]
    stats = torch.stack(stats).tolist() if stats else []
    log(f"hand_teacher path launches: {launches}")
    log(f"hand_teacher eval means: {json.dumps(means)}")
    for i, sec in enumerate(frames):
        parts = ", ".join(
            f"{k} {v[i]:.3f} ms ({v[i] / (sec * 1e3):.3f})"
            for k, v in ms.items() if i < len(v))
        log(f"hand_teacher frame {i}: wall {sec:.4f} s; {parts} (CUDA "
            f"events; share of the frame) on {card_line}")
    log(f"peak device memory (hand_teacher eval): {peak / 2**30:.3f} GiB "
        f"on {card_line}")
    for i, s in enumerate(stats):
        log(f"hand_teacher frame {i}: alpha max {s[0]:.6g}, pixels with "
            f"alpha > 0 {s[1]:.6f}; mvp_window_overflow {s[6]:.6f}; "
            f"primshadow min {s[7]:.6g} max {s[8]:.6g} mean {s[9]:.6g}, "
            f"share > 0 {s[10]:.6f}")
    if len(frames) != 3 or not all(math.isfinite(v) for v in means.values()):
        raise AssertionError("hand_teacher eval losses are not finite")
    if len(stats) != 3 or not all(all(v == 1 for v in s[2:6])
                                  and math.isfinite(s[6]) for s in stats):
        raise AssertionError("hand_teacher rgb, alpha, primrgb, primshadow "
                             "or mvp_window_overflow is not finite")
    if not all(s[0] > 0 for s in stats):
        raise AssertionError("a hand_teacher frame rendered nothing")
    if not all(0 <= s[7] and s[8] <= 1 for s in stats):
        raise AssertionError("a hand_teacher shadow lies outside [0, 1]")
    if L != TEACHER_LIGHTS or any(len(v) != 3 for v in ms.values()):
        raise AssertionError(f"hand_teacher frames timed "
                             f"{[len(v) for v in ms.values()]} of 3 "
                             f"(lights {L})")
    expected = {name: 0 for name in gc.LAUNCHES}
    expected.update(cumsum1d=3 * HAND_MVP_K4_PER_FRAME, mvp_march=3,
                    shadow_integral=3 * TEACHER_LIGHTS)
    if launches != expected:
        raise AssertionError(f"hand_teacher path launch counts {launches} "
                             f"!= {expected}")
    model = built.pop("model")
    model.apply = built.pop("orig_apply")
    del model.module.relightdecoder.unet.forward
    captured["model"] = model
    profile_forward(torch, model, built.pop("batch"), card_line,
                    "profiled hand_teacher frame (forward of the last "
                    "frame, run again)", train=False)
    return launches


def hold_density_grid(torch, args, kw, card_grid, label):
    """The card's density grid ``card_grid`` of ``args`` against
    splat_density_grid on the CPU on the same inputs, rtol 1e-5 plus 1e-6
    of its largest value, and the two drop counts equal. Returns (the
    card's drops, the grid's largest value)."""
    import numpy as np

    from goliath_torch.ops import mvp

    drops = {}
    mvp.splat_density_grid(*args, drops=drops, **kw)
    drops = {k: int(v) for k, v in drops.items()}
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    ref_drops = {}
    t0 = time.perf_counter()
    ref = mvp.splat_density_grid(*cpu, drops=ref_drops, **kw).numpy()
    cpu_s = time.perf_counter() - t0
    ref_drops = {k: int(v) for k, v in ref_drops.items()}
    got = card_grid.cpu().numpy()
    err = np.abs(got - ref)
    scale = float(np.abs(ref).max())
    n_over = int((err > 1e-5 * np.abs(ref) + 1e-6 * scale).sum())
    log(f"{label} density grid drops: {json.dumps(drops)}")
    log(f"{label} density grid {got.shape}, card vs CPU plain ({cpu_s:.2f} "
        f"s): max abs err {float(err.max()):.3e} of largest {scale:.6g}, "
        f"{n_over} cells over rtol 1e-5 + 1e-6 of the largest; non-zero "
        f"cells {int((ref != 0).sum())}")
    if n_over or drops != ref_drops:
        raise AssertionError(f"the card's {label} density grid disagrees "
                             f"with the CPU's (drops {drops} vs "
                             f"{ref_drops})")
    return drops, scale


def hold_shadows(torch, grid, pts, lights, outs, label, gen):
    """The card's shadow_at_points of each light (``outs``, over every
    point of ``pts``, or None: computed here on the held points) against
    the CPU's on the card's ``grid`` at TEACHER_SHADOW_POINTS fixed-seed
    points, rtol 1e-5 plus TEACHER_SHADOW_ATOL. Returns (the largest
    error, each light's mean shadow on the held points)."""
    import numpy as np

    from goliath_torch.ops import mvp

    worst, means = 0.0, []
    grid_cpu = grid.cpu()
    for i, light in enumerate(lights):
        sel = torch.randperm(pts.shape[0], generator=gen)[
            :TEACHER_SHADOW_POINTS].to(pts.device)
        sub = pts[sel]
        got = (mvp.shadow_at_points(grid, sub, light, TEACHER_SHADOW_STEPS)
               if outs is None else outs[i][sel]).cpu().numpy()
        t0 = time.perf_counter()
        ref = mvp.shadow_at_points(grid_cpu, sub.cpu(), light.cpu(),
                                   TEACHER_SHADOW_STEPS).numpy()
        cpu_s = time.perf_counter() - t0
        err = np.abs(got - ref)
        n_over = int((err > 1e-5 * np.abs(ref) + TEACHER_SHADOW_ATOL).sum())
        worst = max(worst, float(err.max()))
        means.append(float(ref.mean()))
        log(f"{label} shadow, light {i}: {sub.shape[0]} of {pts.shape[0]} "
            f"points held ({cpu_s:.2f} s on the CPU), card vs CPU max abs "
            f"err {float(err.max()):.3e}; mean {float(ref.mean()):.6g}, "
            f"share > 0 {float((ref > 0).mean()):.6f}, share at 1 "
            f"{float((ref == 1).mean()):.6f}; {n_over} over rtol 1e-5 + "
            f"{TEACHER_SHADOW_ATOL}")
        if n_over:
            raise AssertionError(f"the card's {label} shadow_at_points "
                                 f"disagrees with the CPU's for light {i}")
    return worst, means


def teacher_shadow_check(torch, captured, card_line):
    """On frame 0 of hand_teacher_eval_path: the density grid and its drops
    card vs CPU (hold_density_grid) and each light's shadow integral card
    vs CPU (hold_shadows) on the run's own grid and outputs; the march's
    drops. The prims of the full-width sphere (half-extent 1/512 of the
    volume) are an eighth of a grid cell (1/32) wide, and each block sums
    only its first 64 pairs in prim-index order (the lowest, at the UV
    pole, carry no alpha): the run's grid, sampled at cell centres, can be
    all 0, and its shadows with it, in the JAX package as in the port. So
    the same checks run again on the frame's prims that carry alpha, grown
    TEACHER_GROW times (primscale / TEACHER_GROW), where the grid must not
    be all 0 and the shadows neither all 0 nor all 1. Last,
    the gap between shadow_at_points_exact (every prim's own field) and
    the run's grid path on TEACHER_EXACT_POINTS points of the first light,
    logged, not held to a limit (the grid's resampling and its drops)."""
    from goliath_torch.ops import mvp
    from goliath_torch.utils.timing import cuda_call_ms

    args, kw, density = captured["grid"]
    shadows = captured["shadow"]
    pts = shadows[0][0]
    lights = [s[1] for s in shadows]
    if len(lights) != TEACHER_LIGHTS or any(
            s[0] is not pts or s[2:4] != ((TEACHER_SHADOW_STEPS,), {})
            for s in shadows):
        raise AssertionError(f"frame 0's shadow calls differ from the "
                             f"teacher's ({len(lights)} lights)")
    gen = torch.Generator().manual_seed(0)
    label = "hand_teacher frame 0"
    drops, _ = hold_density_grid(torch, args, kw, density, label)
    worst, means = hold_shadows(torch, density, pts, lights,
                                [s[4] for s in shadows], label, gen)
    _, ms = cuda_call_ms(lambda: mvp.splat_density_grid(*args, **kw))
    log(f"{label} density grid again: {ms:.3f} ms on {card_line}")

    keep = args[3].flatten(1).sum(1) > 0
    grown = [a[keep] for a in args[:4]] + list(args[4:])
    grown[2] = grown[2] / TEACHER_GROW
    label_g = (f"{label}, the {int(keep.sum())} prims with alpha grown "
               f"{TEACHER_GROW:g}x")
    grid_g = mvp.splat_density_grid(*grown, **kw)
    _, scale = hold_density_grid(torch, grown, kw, grid_g, label_g)
    worst_g, means_g = hold_shadows(torch, grid_g, pts, lights, None,
                                    label_g, gen)
    if not (scale > 0 and 0 < min(means_g) and max(means_g) < 1):
        raise AssertionError(f"the grown prims' shadows are all 0 or all 1 "
                             f"(grid max {scale}, means {means_g})")

    margs, mkw = captured["march"]
    mdrops = {}
    mvp.mvp_raymarch_tiled(*margs, drops=mdrops, **mkw)
    log(f"{label} march drops: "
        f"{json.dumps({k: int(v) for k, v in mdrops.items()})}")

    pp, pr, ps, pa = args[:4]
    sel = torch.randperm(pts.shape[0], generator=gen)[
        :TEACHER_EXACT_POINTS].to(pts.device)
    exact, exact_ms = cuda_call_ms(lambda: mvp.shadow_at_points_exact(
        pp, pr, ps, pa, pts[sel], lights[0], TEACHER_SHADOW_STEPS))
    grid_path = shadows[0][4][sel]
    gap = (exact - grid_path).abs()
    log(f"{label}, light 0: shadow_at_points_exact (every prim's field, "
        f"{TEACHER_SHADOW_STEPS} steps) against the grid path on "
        f"{sel.numel()} points: mean |gap| {float(gap.mean()):.6g}, q95 "
        f"{float(gap.quantile(0.95)):.6g}, max {float(gap.max()):.6g}; "
        f"means exact {float(exact.mean()):.6g} grid "
        f"{float(grid_path.mean()):.6g}, exact > 0 on "
        f"{float((exact > 0).float().mean()):.6f}; {exact_ms:.1f} ms on "
        f"{card_line}")
    return {"grid_ms": ms, "drops": drops,
            "shadow_max_abs_err": max(worst, worst_g),
            "grown_shadow_means": means_g}


def teacher_small_reference(torch):
    """The teacher forward at the size of tests/test_torch_hand_teacher.py
    (uv 32, primsize [8, 8, 4], 48x48, 2 lights) on the card against the
    CPU, on one frame of the jittered template with the same seed-0
    weights: rgb, alpha, primrgb and primshadow at rtol SMALL_RTOL plus
    SMALL_RTOL of each output's largest |value|."""
    import numpy as np

    from goliath_torch.config import Config, load_from_config
    from goliath_torch.data.pipeline import collate
    from goliath_torch.scripts import run_test
    from goliath_torch.test import to_device

    cfg = teacher_config(TEACHER_SMALL, TEACHER_SMALL_DATA)
    ds = jitter_template(run_test.build_dataset(dict(cfg.test.data)))
    batch = collate([ds[0]])
    outs = {}
    for device in (DEVICE, "cpu"):
        model_cfg = Config.wrap(dict(cfg.model))
        model_cfg.pop("cal", None)
        model_cfg["learn_blur"] = False
        model = load_from_config(model_cfg, assets=ds.static_assets,
                                 device=device)
        with torch.no_grad():
            preds = model.apply(to_device(batch, model.device), train=False)
        outs[device] = {k: preds[k].cpu().numpy() for k in (
            "rgb", "alpha", "primrgb", "primshadow")}
    worst = {}
    for k, ref in outs["cpu"].items():
        got = outs[DEVICE][k]
        scale = float(np.abs(ref).max())
        err = np.abs(got - ref)
        n_over = int((err > SMALL_RTOL * (np.abs(ref) + scale)).sum())
        worst[k] = float(err.max()) / max(scale, 1e-30)
        if n_over or not np.isfinite(got).all() or not scale > 0:
            raise AssertionError(f"the card's small teacher {k} disagrees "
                                 f"with the CPU's ({n_over} entries)")
    log(f"small-input hand_teacher forward (card vs CPU plain): max abs err "
        f"as a fraction of the largest |value| {json.dumps(worst)} "
        f"(tolerance rtol {SMALL_RTOL} + {SMALL_RTOL} of the largest)")
    return worst


# MVP training (run_train) at full width: configs/hand_mvp.yml at its batch
# 4 with all six of its losses, and configs/hand_teacher_mvp.yml at its
# batch 1 with its three, on MESH_DATA (the teacher's 5 lights), with the
# eval paths' cuts. The march's binning runs twice a sample a forward (its
# two scans on K4) and never in the backward, which marches each tile group
# again: 2 x 4 x (3 steps + the summary's forward at iteration 0) = 32 and
# 2 x 1 x 4 = 8 launches. The steps march under autograd (the plain tile
# groups); only the summary's forward, under torch.no_grad(), marches on
# K8: once a sample, 4 and 1. The teacher's shadow integrals run without
# gradient in every forward: K9 5 lights x 1 sample x 4 forwards = 20.
HAND_MVP_TRAIN_BATCH = 4
TEACHER_TRAIN_BATCH = 1
# the march's gradients card vs CPU on a 2 x 2-tile window: rtol of the
# entry plus a fraction of each gradient's largest entry (the deposit's and
# the gathers' backward atomics add taps in other orders)
MARCH_GRAD_RTOL = MARCH_GRAD_OF_SCALE = 1e-3


def hand_mvp_train_config(overrides=(), data=MESH_DATA):
    """configs/hand_mvp.yml for run_train on synthetic ``data`` (MESH_DATA
    unless given) with HAND_MVP_CUTS: all six losses of the config."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / "hand_mvp.yml"), overrides=[
        f"data={yaml_flow(data)}", *HAND_MVP_CUTS, *overrides])


def teacher_train_config(overrides=(), data=MESH_DATA):
    """configs/hand_teacher_mvp.yml for run_train on synthetic ``data``
    (MESH_DATA unless given: 5 lights) with TEACHER_CUTS: rgb_l2, mask_l1
    (at iteration 0, its start_at and end_at) and learn_blur."""
    from goliath_torch.config import load_config

    return load_config(
        str(ROOT / "configs" / "hand_teacher_mvp.yml"), overrides=[
            f"data={yaml_flow(data)}", *TEACHER_CUTS, *overrides])


class MVPTrainCapture:
    """For the duration of a with-block: CUDA events around each march's
    forward (``render_raymarcher.mvp_raymarch_tiled``) and its backward
    (from its output's gradient to the last of its inputs' gradients:
    the recomputed groups and their backward), kept in ``self.forward`` and
    ``self.backward`` as event pairs in call order; and in ``captured`` the
    first step's two K4 scans (``"k4"``) and its first march's arguments
    (``"march"``, detached, on the host)."""

    def __init__(self, torch, captured):
        from goliath_torch.ops import binning
        from goliath_torch.utils import render_raymarcher

        self.torch, self.captured = torch, captured
        self.binning, self.rm = binning, render_raymarcher
        self.orig = binning.cumsum1d, render_raymarcher.mvp_raymarch_tiled
        self.forward, self.backward = [], []

    def __enter__(self):
        torch = self.torch
        orig_cs, orig_march = self.orig
        captured, k4 = self.captured, self.captured.setdefault("k4", [])
        fwd, bwd = self.forward, self.backward

        def event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev

        def marker(on_backward):
            class Mark(torch.autograd.Function):
                @staticmethod
                def forward(ctx, x):
                    return x.view_as(x)

                @staticmethod
                def backward(ctx, g):
                    on_backward()
                    return g
            return Mark.apply

        def cs(x):
            if len(k4) < HAND_MVP_K4_PER_FRAME:
                k4.append(x.to("cpu", non_blocking=True))
            return orig_cs(x)

        def march(*args, **kw):
            if "march" not in captured:
                captured["march"] = (tuple(
                    a.detach().to("cpu", non_blocking=True)
                    if isinstance(a, torch.Tensor) else a for a in args),
                    dict(kw))
            pair = []
            end = marker(lambda: pair.append(event()))
            args = tuple(end(a) if isinstance(a, torch.Tensor)
                         and a.requires_grad else a for a in args)
            t0 = event()
            out = orig_march(*args, **kw)
            fwd.append((t0, event()))
            if not out.requires_grad:
                return out
            bwd.append(pair)
            return marker(lambda: pair.insert(0, event()))(out)

        self.binning.cumsum1d, self.rm.mvp_raymarch_tiled = cs, march
        return self

    def __exit__(self, *exc):
        self.binning.cumsum1d, self.rm.mvp_raymarch_tiled = self.orig

    def march_ms(self):
        """(forward ms, backward ms) of each march, in call order."""
        return ([a.elapsed_time(b) for a, b in self.forward],
                [p[0].elapsed_time(p[-1]) if len(p) > 1 else math.nan
                 for p in self.backward])


def mvp_train_path(gc, torch, card_line, record, captured, label,
                   make_config, batch, default_group, lights=0):
    """run_training on an MVP config with MVPTrainCapture: K4 twice a
    sample a forward, K8 once a sample of the summary's forward, K9 once a
    light and sample a forward (``lights`` a sample: the teacher's), and no
    other kernel; then each step's marches' forward and backward ms beside
    the step's wall time."""
    capture = MVPTrainCapture(torch, captured)
    n = HAND_MVP_K4_PER_FRAME * batch * (TRAIN_STEPS + 1)
    expected = dict(cumsum1d=n, mvp_march=batch,
                    shadow_integral=lights * batch * (TRAIN_STEPS + 1))

    def zero_grad_ok(probe):
        # cal.identity_camera "400870" is not a synthetic camera, so CalV5
        # falls back to the first one, which passes the image through
        drawn = {c for step in probe.cameras for c in step}
        ok = {"cal"} if drawn <= {probe.identity_camera} else set()
        return ok | ({"__default__"} if default_group else set())

    launches = run_training(
        gc, torch, card_line, label, expected, record,
        patch=capture, make_config=make_config, batch=batch,
        zero_grad_ok=zero_grad_ok, default_group=default_group)
    fwd, bwd = capture.march_ms()
    # the training steps' marches: batch a step; then the summary's batch
    # at iteration 0 (forward only) after step 0's
    steps = [(fwd[:batch], bwd[:batch])]
    rest_f, rest_b = fwd[2 * batch:], bwd[batch:]
    for i in range(1, TRAIN_STEPS):
        steps.append((rest_f[(i - 1) * batch:i * batch],
                      rest_b[(i - 1) * batch:i * batch]))
    if len(fwd) != batch * (TRAIN_STEPS + 1) or len(bwd) != batch \
            * TRAIN_STEPS or not all(math.isfinite(v) for v in bwd):
        raise AssertionError(f"{label}: {len(fwd)} march forwards and "
                             f"{len(bwd)} backwards timed")
    wall = record[label + " seconds"]
    for i, (f, b) in enumerate(steps):
        share = (sum(f) + sum(b)) / (wall[i] * 1e3)
        log(f"{label} step {i}: march forward {sum(f):.3f} ms "
            f"({', '.join(f'{v:.1f}' for v in f)}), backward {sum(b):.3f} "
            f"ms ({', '.join(f'{v:.1f}' for v in b)}) (CUDA events; "
            f"{share:.3f} of the step's wall {wall[i]:.4f} s) on {card_line}")
    summary = fwd[batch:2 * batch]
    log(f"{label} summary forward at iteration 0: march {sum(summary):.3f} "
        f"ms over {batch} samples on {card_line}")
    return launches


def hand_mvp_train_path(gc, torch, card_line, record, captured):
    """run_train.main on configs/hand_mvp.yml at full width
    (hand_mvp_train_config), batch 4, 3 steps: every group's gradient
    finite and non-zero (cal's may be 0 only if every sample drew cal's
    identity camera), K4 32 times, K8 4 times (the summary's forward)."""
    return mvp_train_path(gc, torch, card_line, record, captured,
                          "hand_mvp train path", hand_mvp_train_config,
                          HAND_MVP_TRAIN_BATCH, default_group=False)


def teacher_train_path(gc, torch, card_line, record, captured):
    """run_train.main on configs/hand_teacher_mvp.yml at full width
    (teacher_train_config), batch 1 with 5 lights, 3 steps: the four
    groups' gradients finite and non-zero (cal's as hand_mvp's), the
    default group of the detached geometry finite, zero and decaying
    (check_decay), K4 8 times, K8 once (the summary's forward), K9 20
    times."""
    return mvp_train_path(gc, torch, card_line, record, captured,
                          "hand_teacher train path", teacher_train_config,
                          TEACHER_TRAIN_BATCH, default_group=True,
                          lights=TEACHER_LIGHTS)


def mvp_train_march_check(torch, captured, card_line):
    """On the first march of the hand_mvp training run (step 0, sample 0;
    its arguments kept on the host): the march's drops on the whole frame,
    counted once under no_grad on the card; then on its MVP_WINDOW x
    MVP_WINDOW pixels at the image centre (2 x 2 tiles, the camera's
    principal point moved with them), the march's gradients of the
    template, primpos, primrot and primscale under a seeded upstream
    gradient, each tile group recomputed in the backward, card against
    CPU at MARCH_GRAD_RTOL of the entry plus MARCH_GRAD_OF_SCALE of each
    gradient's largest |value|; K4 twice on the card (the binning once,
    not in the backward)."""
    import numpy as np

    from goliath_torch.ops import gsplat_cuda as gc
    from goliath_torch.ops import mvp
    from goliath_torch.utils.timing import cuda_call_ms

    args, kw = captured["march"]
    raypos, raydir, stepsize, tminmax, pos, rot, scale, tpl, K_cam, Rt = args
    drops = {}
    with torch.no_grad():
        _, ms = cuda_call_ms(lambda: mvp.mvp_raymarch_tiled(
            *[a.to(DEVICE) if isinstance(a, torch.Tensor) else a
              for a in args], drops=drops, **kw))
    drops = {k: int(v) for k, v in drops.items()}
    log(f"hand_mvp training step 0 sample 0 march drops: "
        f"{json.dumps(drops)} ({ms:.3f} ms with the counts, no_grad, on "
        f"{card_line})")
    H, W = raypos.shape[:2]
    ts = kw.get("tile_size", 16)
    n = MVP_WINDOW
    y0, x0 = (H // 2) // ts * ts, (W // 2) // ts * ts
    win = (slice(y0, y0 + n), slice(x0, x0 + n))
    K_w = K_cam.clone()
    K_w[:2, 2] -= K_w.new_tensor([x0, y0])
    gen = torch.Generator().manual_seed(11)
    up = torch.randn((4, n, n), generator=gen)
    grads, outs = {}, {}
    for device in (DEVICE, "cpu"):
        leaves = [a.to(device).requires_grad_() for a in (pos, rot, scale,
                                                          tpl)]
        before = gc.LAUNCHES["cumsum1d"]
        out = mvp.mvp_raymarch_tiled(
            raypos[win].contiguous().to(device),
            raydir[win].contiguous().to(device), stepsize,
            tminmax[win].contiguous().to(device), *leaves, K_w.to(device),
            Rt.to(device), **kw)
        (out * up.to(device)).sum().backward()
        if device == DEVICE and gc.LAUNCHES["cumsum1d"] != before + 2:
            raise AssertionError("the windowed march under autograd did not "
                                 "launch K4 exactly twice")
        outs[device] = out.detach().cpu()
        grads[device] = [x.grad.cpu() for x in leaves]
    worst = {}
    for name, g, r in zip(("primpos", "primrot", "primscale", "template"),
                          grads[DEVICE], grads["cpu"]):
        scale_r = float(r.abs().max())
        err = (g - r).abs()
        allowed = MARCH_GRAD_RTOL * r.abs() + MARCH_GRAD_OF_SCALE * scale_r
        worst[name] = (float(err.max()) / max(scale_r, 1e-30),
                       int((err > allowed).sum()), scale_r,
                       int((r != 0).sum()))
    rgba_err = float((outs[DEVICE] - outs["cpu"]).abs().max())
    log(f"hand_mvp training step 0 march gradients on the {n}x{n} window "
        f"at ({x0}, {y0}), card vs CPU: rgba max abs err {rgba_err:.3e} "
        f"(alpha max {float(outs['cpu'][3].max()):.6g}); per gradient "
        f"(max abs err / largest |ref|, entries over rtol "
        f"{MARCH_GRAD_RTOL} + {MARCH_GRAD_OF_SCALE} of the largest, "
        f"largest |ref|, non-zero entries): {json.dumps(worst)}")
    if any(w[1] for w in worst.values()) or not all(
            w[2] > 0 for w in worst.values()):
        raise AssertionError("the card's march gradients disagree with the "
                             "CPU's (or are all zero) on the window")
    return {"drops": drops, "gradients": worst}


def hand_mvp_small_train_reference(torch):
    """One hand_mvp training step (run_train.main, configs/hand_mvp.yml
    with its six losses, vgg on random features) at HAND_MVP_SMALL on the
    jittered template, card against CPU: small_train_step_reference."""
    return small_train_step_reference(
        torch, "hand_mvp", lambda o: hand_mvp_train_config(
            [*HAND_MVP_SMALL, *o], HAND_MVP_SMALL_DATA))


def teacher_small_train_reference(torch):
    """One teacher training step (configs/hand_teacher_mvp.yml with its
    three losses) at TEACHER_SMALL on the jittered template, card against
    CPU: small_train_step_reference."""
    return small_train_step_reference(
        torch, "hand_teacher", lambda o: teacher_train_config(
            [*TEACHER_SMALL, *o], TEACHER_SMALL_DATA))


# The relighting entry point (run_vis_relight.main on configs/rgca.yml): the
# point-light sweep renders once a frame, the HDRI spin three times (the
# composite's render, then the diffuse and the specular colours alone), each
# render binning anew (K4 twice) and compositing (K1 once).
RELIGHT_FRAMES = 3
RELIGHT_RENDERS = {"sweep": 1, "spin": 3}
RELIGHT_ENV_SHAPE = (1024, 2048)        # resize_area's block-mean branch
RELIGHT_SMALL_ENV_SHAPE = (128, 256)
RELIGHT_SMALL_SAMPLES = 8


def write_envmap(path, shape=RELIGHT_ENV_SHAPE, seed=0):
    """A float32 equirect envmap [H, W, 3] from ``seed``, saved as .npy: a
    sky gradient, a sun disc reaching ~50 (flat-topped, 0.03 H across) and
    uniform noise of 0.05."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = shape
    y = (np.arange(H, dtype=np.float32) + 0.5) / H
    sky = np.stack([0.3 + 0.5 * y, 0.5 + 0.3 * y, 1.0 - 0.4 * y], -1)
    env = np.broadcast_to(sky[:, None], (H, W, 3)).copy()
    yy, xx = np.mgrid[0:H, 0:W]
    r2 = ((yy - 0.3 * H) ** 2 + (xx - 0.7 * W) ** 2) / (0.03 * H) ** 2
    env += (50.0 * np.exp(-r2 ** 2))[..., None]
    env += 0.05 * rng.random((H, W, 3), dtype=np.float32)
    np.save(path, env.astype(np.float32))


def read_png(path):
    """[H, W, 3] uint8 of a PNG that goliath_torch.test._save_png wrote (8-bit
    RGB, filter 0 on every row), each chunk's CRC checked."""
    import struct
    import zlib

    import numpy as np

    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    if (depth, ctype) != (8, 2):
        raise AssertionError(f"{path}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise AssertionError(f"{path}: filtered rows")
    return raw[:, 1:].reshape(h, w, 3)


def relight_config(out_dir, envmap_path):
    """configs/rgca.yml for run_vis_relight: the test data FULL_DATA, no
    checkpoint (weights from seed 0), RELIGHT_FRAMES frames of each half."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
        f"test.data={yaml_flow(FULL_DATA)}", "test.ckpt=null",
        f"vis.n_frames={RELIGHT_FRAMES}", f"vis.envmap_path={envmap_path}",
        f"vis.output_dir={out_dir}"])


def relight_path(gc, torch, card_line, captured):
    """run_vis_relight.main on configs/rgca.yml at full width (FULL_DATA,
    weights from seed 0) with a 1024x2048 envmap (write_envmap) and 3 frames
    of each half, the prefilter at its 64 samples, counts reset just before:
    3 sweep PNGs of 2048x1334 and 3 spin PNGs of 2048x4002 read back, each
    frame finite and non-constant before quantization, K1 12 and K4 24
    times and no other kernel. Times the decorator's build (the prefilter)
    and, per frame, the augment, the model forward, compose_envmap and its
    blur (CUDA events) and the PNG write (host clock after a synchronise);
    logs the peak memory; keeps in ``captured`` the first spin frame's six
    K4 scans and its third render's K1 arguments (the spec_color pass);
    then profiles one spin frame again."""
    import os

    import numpy as np

    from goliath_torch.models import rgca
    from goliath_torch.ops import binning
    from goliath_torch.scripts import run_vis_relight
    from goliath_torch.utils import envmap as envmap_lib
    from goliath_torch.utils import light_decorator as ld

    state = {"half": None, "frame": -1, "renders": 0}
    events = {k: [] for k in ("augment", "forward", "compose", "blur")}
    saved = {"sweep": [], "spin": []}
    built = {}
    orig = {"sweep_aug": ld.SingleLightCycleDecorator.augment,
            "spin_aug": ld.EnvSpinDecorator.augment,
            "spin_cls": run_vis_relight.EnvSpinDecorator,
            "build": run_vis_relight.load_from_config,
            "compose": rgca.compose_envmap,
            "blur": envmap_lib.blur_background,
            "save": run_vis_relight._save_frame,
            "cs": binning.cumsum1d, "rt": gc.rasterize_tiled}

    def timed(key, fn):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args, **kw)
            ev[1].record()
            events[key].append((state["half"], state["frame"], ev))
            return out
        return call

    def augmenter(half, fn):
        def augment(self, data):
            state.update(half=half, frame=int(np.asarray(data["index"])[0]),
                         renders=0)
            if half == "spin":
                built.update(deco=self, batch=data)
            return timed("augment", fn)(self, data)
        return augment

    def spin_cls(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deco = orig["spin_cls"](*args, **kw)
        torch.cuda.synchronize()
        built["build_s"] = time.perf_counter() - t0
        return deco

    def build(*args, **kw):
        model = built["model"] = orig["build"](*args, **kw)
        model.apply = timed("forward", model.apply)
        return model

    def save(path, rgb):
        stats = torch.stack([torch.isfinite(rgb).all().float(),
                             rgb.float().std()]).tolist()   # synchronises
        t0 = time.perf_counter()
        orig["save"](path, rgb)
        saved[state["half"]].append((time.perf_counter() - t0, *stats))

    def cs(x):
        if (state["half"], state["frame"]) == ("spin", 0):
            captured.setdefault("k4", []).append(x.clone())
        return orig["cs"](x)

    def rt(*args, **kw):
        if (state["half"], state["frame"]) == ("spin", 0):
            state["renders"] += 1
            if state["renders"] == RELIGHT_RENDERS["spin"]:
                captured["k1"] = args
        return orig["rt"](*args, **kw)

    def patch(on):
        src = {"sweep_aug": augmenter("sweep", orig["sweep_aug"]),
               "spin_aug": augmenter("spin", orig["spin_aug"]),
               "spin_cls": spin_cls, "build": build,
               "compose": timed("compose", orig["compose"]),
               "blur": timed("blur", orig["blur"]), "save": save,
               "cs": cs, "rt": rt} if on else orig
        ld.SingleLightCycleDecorator.augment = src["sweep_aug"]
        ld.EnvSpinDecorator.augment = src["spin_aug"]
        run_vis_relight.EnvSpinDecorator = src["spin_cls"]
        run_vis_relight.load_from_config = src["build"]
        rgca.compose_envmap = src["compose"]
        envmap_lib.blur_background = src["blur"]
        run_vis_relight._save_frame = src["save"]
        binning.cumsum1d = src["cs"]
        gc.rasterize_tiled = src["rt"]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_relight_") as d:
        env_path = os.path.join(d, "envmap.npy")
        write_envmap(env_path)
        out_dir = os.path.join(d, "out")
        cfg = relight_config(out_dir, env_path)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        patch(True)
        gc.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            run_vis_relight.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(gc.LAUNCHES)
        finally:
            patch(False)
        peak = torch.cuda.max_memory_allocated()
        shapes = {}
        for half, sub in (("sweep", "light_sweep"), ("spin", "env_spin")):
            imgs = [read_png(p) for p in sorted(Path(out_dir, sub).glob(
                "*.png"))]
            shapes[half] = [(im.shape, int(im.min()), int(im.max()))
                            for im in imgs]
    model = built.pop("model")
    del model.apply
    ms = {k: {} for k in events}
    for key, evs in events.items():
        for half, frame, (a, b) in evs:
            ms[key].setdefault((half, frame), []).append(a.elapsed_time(b))
    log(f"relight path launches: {launches}")
    log(f"relight run: wall {wall:.3f} s, of which the spin decorator's "
        f"build (load, resize, the 3 prefiltered levels at 64 samples) "
        f"{built.get('build_s', float('nan')):.3f} s on {card_line}")
    for half in ("sweep", "spin"):
        for i in range(RELIGHT_FRAMES):
            parts = ", ".join(f"{k} {sum(v[(half, i)]):.3f} ms"
                              for k, v in ms.items() if (half, i) in v)
            png_s = saved[half][i][0] if i < len(saved[half]) else math.nan
            log(f"relight {half} frame {i}: {parts} (CUDA events; compose "
                f"and its blur lie inside the forward); PNG write "
                f"{png_s * 1e3:.1f} ms on {card_line}")
    log(f"peak device memory (relight): {peak / 2**30:.3f} GiB on "
        f"{card_line}")
    log(f"relight PNGs (shape, min, max): {shapes}")
    H, W = int(cfg.model.image_height), int(cfg.model.image_width)
    want = {"sweep": (H, W, 3), "spin": (H, RELIGHT_RENDERS["spin"] * W, 3)}
    for half, frames in shapes.items():
        if [s[0] for s in frames] != [want[half]] * RELIGHT_FRAMES:
            raise AssertionError(f"relight {half}: PNGs {frames}, want "
                                 f"{RELIGHT_FRAMES} of {want[half]}")
        if not all(hi > lo for _, lo, hi in frames):
            raise AssertionError(f"relight {half}: a constant PNG")
        stats = saved[half]
        if len(stats) != RELIGHT_FRAMES or not all(
                f == 1.0 and std > 0 for _, f, std in stats):
            raise AssertionError(f"relight {half}: a frame is not finite or "
                                 f"is constant before quantization {stats}")
    if any(len(v) != 2 * RELIGHT_FRAMES for k, v in ms.items()
           if k in ("augment", "forward")) or any(
            len(v) != RELIGHT_FRAMES for k, v in ms.items()
            if k in ("compose", "blur")):
        raise AssertionError(f"relight frames timed "
                             f"{ {k: len(v) for k, v in ms.items()} }")
    renders = RELIGHT_FRAMES * sum(RELIGHT_RENDERS.values())
    expected = {name: 0 for name in gc.LAUNCHES}
    expected.update(compositor_fwd=renders, cumsum1d=2 * renders)
    if launches != expected:
        raise AssertionError(f"relight path launch counts {launches} != "
                             f"{expected}")
    profile_forward(torch, built.pop("deco"), built.pop("batch"), card_line,
                    "profiled relight spin frame (augment and the model "
                    "forward of the last spin frame, run again)", train=False)
    return launches


def check_k1_relight(gc, torch, args):
    """K1 against its plain version (check_k1's tolerances) on the relight
    path's first spin frame, third render: the spec_color pass."""
    log("K1 on the relight path (spin frame 0, the spec_color render):")
    return check_k1(gc, torch, args, {})


def relight_small_reference(torch):
    """One spin frame at configs/rgca_synthetic.yml size (64x64, uv 32; a
    128x256 envmap from write_envmap; RELIGHT_SMALL_SAMPLES prefilter
    samples a level, which EnvSpinDecorator draws on the host from its
    generator seeded 7, so both devices get the same uniforms) on the card
    (kernels) against the CPU (plain versions): spec_color, the diffuse and
    specular panels of rgb, and the composite panel in two parts, each at
    rtol SMALL_RTOL plus SMALL_RTOL of that part's own largest entry: the
    mirrorball inset (the disc of envmap_to_mirrorball's mask, which
    carries the unclamped envmap and its sun) and the rest of the panel
    (the render over the clamped background). Returns {name: (largest
    error, largest entry)}."""
    import numpy as np

    from goliath_torch.config import Config, load_config, load_from_config
    from goliath_torch.data.pipeline import collate
    from goliath_torch.scripts.run_train import build_dataset
    from goliath_torch.test import to_device
    from goliath_torch.utils.envmap import envmap_to_mirrorball
    from goliath_torch.utils.light_decorator import EnvSpinDecorator

    cfg = load_config(str(ROOT / "configs" / "rgca_synthetic.yml"))
    ds = build_dataset(dict(cfg.test.data))
    mc = Config.wrap(dict(cfg.model))
    mc.pop("cal", None)
    mc["learn_blur"] = False
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_relight_small_") as d:
        path = str(Path(d) / "envmap.npy")
        write_envmap(path, RELIGHT_SMALL_ENV_SHAPE)
        for device in (DEVICE, "cpu"):
            model = load_from_config(mc, assets=ds.static_assets,
                                     device=device)
            deco = EnvSpinDecorator(model, path, cycle=RELIGHT_FRAMES,
                                    prefilter_samples=RELIGHT_SMALL_SAMPLES)
            batch = to_device(collate([ds[0]]), torch.device(device))
            batch["index"] = np.asarray([1])
            with torch.no_grad():
                preds = deco.apply(batch, train=False)
            out[device] = {k: preds[k].float().cpu()
                           for k in ("spec_color", "rgb")}
    H, W = int(cfg.model.image_height), int(cfg.model.image_width)
    got, ref = out[DEVICE], out["cpu"]
    parts = {"spec_color": (got["spec_color"], ref["spec_color"])}
    for i, name in enumerate(("composite", "diffuse", "specular")):
        sl = slice(i * W, (i + 1) * W)
        parts[name] = (got["rgb"][..., sl], ref["rgb"][..., sl])
    # compose_envmap's inset: the mask's disc in the bottom-right square
    ms = min(200, H, W)
    ball = torch.zeros((H, W), dtype=torch.bool)
    ball[-ms:, -ms:] = envmap_to_mirrorball(
        ms, ms, torch.zeros((1, 3, 2, 4)))[0, 3] > 0
    a, b = parts.pop("composite")
    if a.shape != b.shape:
        raise AssertionError(f"relight small reference composite: shapes "
                             f"{tuple(a.shape)} / {tuple(b.shape)}")
    parts["mirrorball"] = (a[..., ball], b[..., ball])
    parts["composite_outside_ball"] = (a[..., ~ball], b[..., ~ball])
    errs, bad = {}, []
    for name, (a, b) in parts.items():
        if a.shape != b.shape or a.numel() == 0:
            raise AssertionError(f"relight small reference {name}: shapes "
                                 f"{tuple(a.shape)} / {tuple(b.shape)}")
        largest = float(b.abs().max())
        diff = (a - b).abs()
        errs[name] = (float(diff.max()), largest)
        if not (bool(torch.isfinite(a).all()) and largest > 0 and bool(
                (diff <= SMALL_RTOL * b.abs() + SMALL_RTOL * largest).all())):
            bad.append(name)
    log(f"small-input relight reference (one spin frame at rgca_synthetic "
        f"size, card vs CPU plain): (max abs error, largest entry) "
        f"{errs} (tolerance rtol {SMALL_RTOL} plus {SMALL_RTOL} of each "
        f"part's largest entry)")
    if bad:
        raise AssertionError(f"the card's spin frame disagrees with the "
                             f"CPU's in {bad}")
    return errs


QUALITY_STEPS = 300
QUALITY_PROFILE_STEP = QUALITY_STEPS // 2
# the trained model's PSNR over the untrained one's (same seed, same 12
# test frames), at least: the first run on an H100 gained 12.70 dB after
# 300 steps (30.07 against 17.37 dB)
QUALITY_MIN_GAIN_DB = 8.0
QUALITY2_STEPS, QUALITY2_FRAMES = 3, 2
# the sphere (radius 100 at distance 400, focal 1.2 x the width) covers
# ~0.28 of a target render
QUALITY_MIN_COVERED = 0.2


def quality_config(name, overrides=()):
    """configs/<name> (rgca_synthetic_quality.yml or its quality2) as it
    stands, with ``overrides``."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / name), overrides=list(overrides))


class QualityCapture:
    """For the duration of a with-block: each training step's wall time
    (ending in a synchronise) and total loss, each target render's wall
    time (``SyntheticDataset._ensure_targets``, ending in a synchronise),
    each test frame's camera and PSNR, and in ``captured`` the first
    target render's K5 arguments (``"k5"``) and its two K4 scans
    (``"k4"``), and the first K1 arguments, K2 arguments and K3 input of
    the first training step (``"k1"``, ``"k2"``, ``"k3"``), copied to
    pinned host memory without a synchronise."""

    def __init__(self, gc, torch, captured):
        from goliath_torch import test as test_lib
        from goliath_torch import train as train_lib
        from goliath_torch.data.synthetic import SyntheticDataset
        from goliath_torch.ops import binning, rasterizer

        self.gc, self.torch, self.captured = gc, torch, captured
        self.mods = dict(train=train_lib, test=test_lib, ds=SyntheticDataset,
                         binning=binning, rasterizer=rasterizer)
        self.orig = dict(
            make=train_lib.make_train_step, test=test_lib.test,
            targets=SyntheticDataset._ensure_targets,
            zbuffer=rasterizer.zbuffer, cumsum1d=binning.cumsum1d,
            compositor_fwd=gc.compositor_fwd, pair_grads=gc.pair_grads,
            cumsum_cols=gc.cumsum_cols)
        self.seconds, self.totals, self.target_seconds = [], [], []
        self.frames = []   # (camera_idx, psnr) of each test frame
        self.profile = None   # the torch.profiler run of QUALITY_PROFILE_STEP

    def to_host(self, x):
        return x.detach().to("cpu", non_blocking=True) \
            if isinstance(x, self.torch.Tensor) else x

    def first(self, key, fn):
        captured, to_host = self.captured, self.to_host

        def wrapped(*args, **kw):
            if key not in captured:
                captured[key] = (tuple(to_host(a) for a in args), kw)
            return fn(*args, **kw)

        return wrapped

    def __enter__(self):
        torch, o, m, gc = self.torch, self.orig, self.mods, self.gc
        captured = self.captured
        k4 = captured.setdefault("k4", [])

        def make(model, loss_fn, optimizer):
            step = o["make"](model, loss_fn, optimizer)

            def timed(batch, iteration):
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(self.seconds) == QUALITY_PROFILE_STEP:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        out = step(batch, iteration)
                        torch.cuda.synchronize()
                    self.profile = prof
                else:
                    out = step(batch, iteration)
                    torch.cuda.synchronize()
                self.seconds.append(time.perf_counter() - t0)
                self.totals.append(out[0])
                return out

            return timed

        def targets(ds):
            if ds._targets is not None:
                return
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o["targets"](ds)
            torch.cuda.synchronize()
            self.target_seconds.append(
                (len(ds.camera_ids) * ds.n_frames, ds.img_h,
                 time.perf_counter() - t0))

        def cumsum1d(x):
            if len(k4) < 2:
                k4.append(self.to_host(x))
            return o["cumsum1d"](x)

        def test(model, loss_fn, data, config, **kw):
            def recording(preds, batch, iteration=0):
                total, ldict = loss_fn(preds, batch, iteration=iteration)
                self.frames.append((int(batch["camera_idx"][0]),
                                    float(ldict["loss_psnr"].mean())))
                return total, ldict

            return o["test"](model, recording, data, config, **kw)

        m["train"].make_train_step = make
        m["test"].test = test
        m["ds"]._ensure_targets = targets
        m["binning"].cumsum1d = cumsum1d
        m["rasterizer"].zbuffer = self.first("k5", o["zbuffer"])
        for name, key in (("compositor_fwd", "k1"), ("pair_grads", "k2"),
                          ("cumsum_cols", "k3")):
            setattr(gc, name, self.first(key, o[name]))
        return self

    def __exit__(self, *exc):
        o, m, gc = self.orig, self.mods, self.gc
        m["train"].make_train_step = o["make"]
        m["test"].test = o["test"]
        m["ds"]._ensure_targets = o["targets"]
        m["binning"].cumsum1d = o["cumsum1d"]
        m["rasterizer"].zbuffer = o["zbuffer"]
        for name in ("compositor_fwd", "pair_grads", "cumsum_cols"):
            setattr(gc, name, o[name])


def quality_launches(gc, targets, renders, trained):
    """The launch counts of a quality-config run: each target render K5
    once and K4 twice; each splat render (the steps' samples, the
    summary's, the test frames) K1 in the XLA window once and K4 twice;
    each trained sample K2 in the XLA window and K3 once."""
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(zbuffer=targets, cumsum1d=2 * (targets + renders),
                compositor_fwd_xla=renders, pair_grads_xla=trained,
                cumsum_cols=trained)
    return want


def quality_eval(gc, torch, probe, cfg, label):
    """run_test.main of a quality config, counts reset just before and
    read just after; returns (means, launches, held-out PSNR)."""
    from goliath_torch.scripts import run_test

    probe.frames.clear()
    gc.reset_launch_counts()
    frames = []
    means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
    torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    held = [p for cam, p in probe.frames if cam % 2 == 1]
    held_psnr = sum(held) / len(held) if held else float("nan")
    log(f"{label}: psnr {means['loss_psnr']:.4f} dB, ssim "
        f"{1.0 - means['loss_rgb_ssim']:.4f}, rgb_l1 "
        f"{means['loss_rgb_l1']:.5f} over {len(frames)} frames (cameras "
        f"{[cam for cam, _ in probe.frames]}); held-out odd cameras: "
        f"{len(held)} frames, psnr {held_psnr:.4f} dB; frame walls "
        f"{[round(f, 4) for f in frames]} s; launches {launches}")
    if not all(math.isfinite(v) for v in means.values()):
        raise AssertionError(f"{label}: a loss mean is not finite")
    return means, launches, held_psnr


def quality_path(gc, torch, card_line, captured):
    """The quality recipe at its full width: run_train.main on
    configs/rgca_synthetic_quality.yml as it stands (256x256, uv 128, batch
    4, rendered targets on the card, cache_device) for QUALITY_STEPS steps
    into a temporary run directory, counts reset just before and read just
    after; then run_test.main from that checkpoint DIRECTORY (through
    latest) and again on the untrained model (test.ckpt null, seed 0),
    each on the 12-camera ring's 12 frames, counts reset before each. The
    trained PSNR must beat the untrained one by QUALITY_MIN_GAIN_DB. Then
    QUALITY2_STEPS steps of configs/rgca_synthetic_quality2.yml (512x512,
    uv 256) and a QUALITY2_FRAMES-frame run_test from its checkpoint
    directory. Exact launch counts for each run."""
    from goliath_torch.scripts import run_train

    launches_all = {name: 0 for name in gc.LAUNCHES}

    def add(launches):
        for k, v in launches.items():
            launches_all[k] += v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as d:
        run = Path(d) / "run"
        cfg = quality_config("rgca_synthetic_quality.yml", [
            f"train.run_dir={run}", f"train.n_max_iters={QUALITY_STEPS}",
            f"train.ckpt_every_n_steps={QUALITY_STEPS}",
            f"test.ckpt.ckpt_path={run / 'checkpoints'}",
            "test.vis_path=null"])
        B = int(cfg.dataloader.batch_size)
        n_train = int(cfg.data.n_cams) * int(cfg.data.n_frames)
        n_test = int(cfg.test.data.n_cams) * int(cfg.test.data.n_frames)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with QualityCapture(gc, torch, captured) as probe:
            gc.reset_launch_counts()
            t0 = time.perf_counter()
            iteration, last = run_train.main(cfg, device=DEVICE)
            torch.cuda.synchronize()
            train_wall = time.perf_counter() - t0
            launches = dict(gc.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            with open(run / "tb" / "scalars.jsonl") as f:
                scalars = [json.loads(line) for line in f]
            written = sorted(p.name for p in (run / "checkpoints").iterdir())
            totals = [float(t) for t in probe.totals]
            profiled = probe.seconds.pop(QUALITY_PROFILE_STEP)
            steady = sorted(probe.seconds[1:])
            median = steady[len(steady) // 2]
            log(f"quality train ({QUALITY_STEPS} steps, batch {B}, "
                f"{n_train} target renders at {cfg.data.img_h}x"
                f"{cfg.data.img_w}): run_train wall {train_wall:.2f} s; step "
                f"0 {probe.seconds[0]:.4f} s, steps 1.. median "
                f"{median:.4f} s (min {steady[0]:.4f}, max {steady[-1]:.4f})"
                f"; target render {probe.target_seconds} (renders, height, "
                f"s); peak device memory {peak / 2**30:.3f} GiB; total loss "
                f"first {totals[0]:.4f} last {totals[-1]:.4f}; on "
                f"{card_line}")
            l1 = {r["step"]: round(r["value"], 5) for r in scalars
                  if r["tag"] == "Losses/loss_rgb_l1"}
            log(f"quality train rgb_l1 by step: {l1}; last losses "
                f"{json.dumps(last)}; checkpoints {written}")
            log(f"quality train launches: {launches}")
            rows = kernel_rows(probe.profile)
            busy = sum(r[0] for r in rows)
            log(f"quality profiled step {QUALITY_PROFILE_STEP}: wall "
                f"{profiled * 1e3:.3f} ms, device busy {busy:.3f} ms in "
                f"{sum(r[1] for r in rows)} kernels, idle share "
                f"{max(0.0, 1.0 - busy * 1e-3 / profiled):.3f} on {card_line}")
            for ms, count, key in rows[:10]:
                log(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
            # the summary's train=False forward of the batch at iteration 0
            want = quality_launches(gc, n_train, B * (QUALITY_STEPS + 1),
                                    B * QUALITY_STEPS)
            if iteration != QUALITY_STEPS or len(totals) != QUALITY_STEPS:
                raise AssertionError(f"quality train took {len(totals)} "
                                     f"steps for {QUALITY_STEPS}")
            if not all(math.isfinite(v) for v in totals + list(last.values())):
                raise AssertionError("a quality training loss is not finite")
            if launches != want:
                raise AssertionError(f"quality train launch counts "
                                     f"{launches} != {want}")
            if f"{QUALITY_STEPS:06d}.pt" not in written:
                raise AssertionError("no final checkpoint was written")
            add(launches)

            eval_want = quality_launches(
                gc, n_test, min(int(cfg.test.n_test_frames), n_test), 0)
            trained, launches, held = quality_eval(
                gc, torch, probe, cfg, "quality eval, trained (checkpoint "
                "directory)")
            add(launches)
            untrained, launches_u, held_u = quality_eval(
                gc, torch, probe, quality_config(
                    "rgca_synthetic_quality.yml",
                    ["test.ckpt=null", "test.vis_path=null"]),
                "quality eval, untrained (seed 0)")
            add(launches_u)
            gain = trained["loss_psnr"] - untrained["loss_psnr"]
            log(f"quality: trained psnr {trained['loss_psnr']:.4f} dB, ssim "
                f"{1.0 - trained['loss_rgb_ssim']:.4f}, rgb_l1 "
                f"{trained['loss_rgb_l1']:.5f} (held-out {held:.4f} dB) "
                f"against untrained {untrained['loss_psnr']:.4f} dB, ssim "
                f"{1.0 - untrained['loss_rgb_ssim']:.4f}, rgb_l1 "
                f"{untrained['loss_rgb_l1']:.5f} (held-out {held_u:.4f} dB):"
                f" gain {gain:.4f} dB after {QUALITY_STEPS} steps (at least "
                f"{QUALITY_MIN_GAIN_DB}) on {card_line}")
            for got, what in ((launches, "trained"), (launches_u, "untrained")):
                if got != eval_want:
                    raise AssertionError(f"quality eval ({what}) launch "
                                         f"counts {got} != {eval_want}")
            if not gain >= QUALITY_MIN_GAIN_DB:
                raise AssertionError(f"the trained model gains {gain:.4f} dB"
                                     f" (< {QUALITY_MIN_GAIN_DB})")
            add(quality2_run(gc, torch, probe, Path(d) / "run2", card_line))
    return launches_all


def quality2_run(gc, torch, probe, run, card_line):
    """QUALITY2_STEPS steps of configs/rgca_synthetic_quality2.yml, then a
    QUALITY2_FRAMES-frame run_test from its checkpoint directory."""
    from goliath_torch.scripts import run_train

    cfg = quality_config("rgca_synthetic_quality2.yml", [
        f"train.run_dir={run}", f"train.n_max_iters={QUALITY2_STEPS}",
        f"train.ckpt_every_n_steps={QUALITY2_STEPS}",
        f"test.ckpt.ckpt_path={run / 'checkpoints'}", "test.vis_path=null",
        f"test.n_test_frames={QUALITY2_FRAMES}"])
    B = int(cfg.dataloader.batch_size)
    probe.seconds.clear()
    probe.totals.clear()
    probe.target_seconds.clear()
    torch.cuda.reset_peak_memory_stats()
    gc.reset_launch_counts()
    iteration, last = run_train.main(cfg, device=DEVICE)
    torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_train = int(cfg.data.n_cams) * int(cfg.data.n_frames)
    log(f"quality2 train ({cfg.data.img_h}x{cfg.data.img_w}, uv "
        f"{cfg.model.uv_size}, batch {B}, {QUALITY2_STEPS} steps): step "
        f"walls {[round(s, 4) for s in probe.seconds]} s, totals "
        f"{[round(float(t), 4) for t in probe.totals]}, target render "
        f"{probe.target_seconds}, peak {peak / 2**30:.3f} GiB on "
        f"{card_line}; launches {launches}")
    want = quality_launches(gc, n_train, B * (QUALITY2_STEPS + 1),
                            B * QUALITY2_STEPS)
    if iteration != QUALITY2_STEPS or launches != want:
        raise AssertionError(f"quality2 train: iteration {iteration}, launch"
                             f" counts {launches} != {want}")
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError("a quality2 training loss is not finite")
    means, launches_e, _ = quality_eval(gc, torch, probe, cfg,
                                        "quality2 eval (checkpoint directory)")
    n_test = int(cfg.test.data.n_cams) * int(cfg.test.data.n_frames)
    want = quality_launches(gc, n_test, QUALITY2_FRAMES, 0)
    if launches_e != want:
        raise AssertionError(f"quality2 eval launch counts {launches_e} != "
                             f"{want}")
    return {k: launches[k] + launches_e[k] for k in launches}


def quality_kernels(gc, torch, captured, card_line):
    """K1 and K2 in the XLA window and K3 against their plain versions on
    the arguments the quality path's first training step handed them (K2
    with the step's own upstream gradients), at the tolerances of the
    earlier phases; K1 and K2 timed there."""
    from goliath_torch.utils.timing import cuda_ms

    def dev(args):
        return tuple(a.to(DEVICE) if isinstance(a, torch.Tensor) else a
                     for a in args)

    (fa, fkw), (ba, bkw), (ca, _) = (captured[k] for k in ("k1", "k2", "k3"))
    fa, ba, (x,) = dev(fa), dev(ba), dev(ca)
    (rows, tile_start, tile_end, img_h, img_w, ts, ntx, nty, chunk, maxpp,
     n_imgs, window) = fa
    if window != "xla" or n_imgs != 1 or fkw or bkw:
        raise AssertionError(f"the quality step's K1 call is not the XLA "
                             f"window's: window {window!r}, n_imgs {n_imgs}")
    img, T, cnt = gc.compositor_fwd(*fa)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(*fa)
    torch.cuda.synchronize()
    err_f = max(float((img - p_img).abs().max()),
                float((T - p_T).abs().max()))
    pairs = (tile_end - tile_start).long()
    log(f"K1 XLA window, quality step 0 sample 0 ({img_w}x{img_h}, tile {ts},"
        f" max_pairs_per_tile {maxpp}, chunk {chunk}): {int((pairs > maxpp).sum())}"
        f" of {pairs.numel()} tiles overflow (max {int(pairs.max())} pairs);"
        f" max_abs_err {err_f:.3e}, cnt mismatches "
        f"{int((cnt != p_cnt).sum())} (tolerance atol {K1_ATOL} rtol "
        f"{K1_RTOL}, cnt exact)")
    if not (torch.equal(cnt, p_cnt)
            and torch.allclose(img, p_img, atol=K1_ATOL, rtol=K1_RTOL)
            and torch.allclose(T, p_T, atol=K1_ATOL, rtol=K1_RTOL)):
        raise AssertionError("K1 (XLA window) differs from its plain version"
                             " on the quality step")
    got = gc.pair_grads(*ba)
    ref = gc.pair_grads_plain(*ba)
    torch.cuda.synchronize()
    C = ba[4].shape[-3]
    err_b = compare_pair_grads(gc, torch, got, ref, C,
                               "K2 XLA window, quality step 0")
    check_same_bits(torch, got, gc.pair_grads(*ba), "K2 XLA window (quality)")
    k3 = gc.cumsum_cols(x)
    ref3 = torch.cumsum(x.double(), dim=1)
    f32 = gc.cumsum_cols_plain(x)
    torch.cuda.synchronize()
    scale = ref3.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    e64 = float(((k3.double() - ref3).abs() / scale).max())
    e32 = float(((k3 - f32).abs().double() / scale).max())
    log(f"K3 quality step 0 {list(x.shape)}: error as a fraction of each "
        f"row's largest running sum: against a float64 scan {e64:.3e} "
        f"(tolerance {K3_TOL_F64}), against torch.cumsum float32 {e32:.3e} "
        f"(tolerance {K3_TOL_F32})")
    if not (e64 <= K3_TOL_F64 and e32 <= K3_TOL_F32):
        raise AssertionError("K3 differs on the quality step")
    check_same_bits(torch, k3, gc.cumsum_cols(x), "K3 (quality)")
    ms1 = cuda_ms(lambda: gc.compositor_fwd(*fa), reps=50)
    ms2 = cuda_ms(lambda: gc.pair_grads(*ba), reps=50)
    ms3 = cuda_ms(lambda: gc.cumsum_cols(x), reps=50)
    log(f"quality step 0 kernels: K1 XLA window {ms1:.4f} ms, K2 XLA window "
        f"{ms2:.4f} ms, K3 {list(x.shape)} {ms3:.4f} ms on {card_line}")
    return dict(k1_err=err_f, k2_err=err_b, k3_err=e64)


# The capture phases: fake Goliath captures in the dataset's zip layout
# (no capture is in the repo), written by tests/goliath_capture.py, the
# writer the CPU tests use, then read by goliath_torch's BodyDataset through
# the entry points on the configs as they stand (capture_root, the run and
# checkpoint directories, the step count and test.n_test_frames cut).
CAPTURE_HEAD = "m--20230306--0707--AXE977--pilot--ProjectGoliath--Head"
CAPTURE_HANDS = "m--20230306--0839--AXE977--pilot--ProjectGoliath--Hands--left"
# 6 train frames alternating the fully-lit pattern and a 5-light one, and 2
# test frames
CAPTURE_TRAIN, CAPTURE_TEST = [0, 1, 2, 3, 4, 5], [6, 7]
CAPTURE_LIGHTS = 8
CAPTURE_PATTERNS = [[[i, 694] for i in range(CAPTURE_LIGHTS)],
                    [[i, 5555] for i in range(1, 6)],
                    [[i, 5555] for i in (0, 2, 4, 6, 7)]]
CAPTURE_PATTERN_OF = {0: 0, 1: 1, 2: 0, 3: 2, 4: 0, 5: 1, 6: 0, 7: 2}
CAPTURE_TEST_FRAMES = 3
# the Hands capture: 8 cameras at 4,000 from a sphere of 16,384 faces whose
# radius of 100 is 1,000 at configs/urhand.yml's global_scaling of 10;
# frames 0-4 fully lit (the script's texmean_num_frames of 5), 5-6 OLAT
TEXMEAN_CAMERAS = 8
TEXMEAN_FRAMES = [0, 1, 2, 3, 4, 5, 6]
TEXMEAN_PATTERN_OF = {0: 0, 1: 0, 2: 0, 3: 0, 4: 0, 5: 1, 6: 1}
TEXMEAN_SPHERE = {"n_lat": 64, "n_lon": 128}
TEXMEAN_DIST = 4000.0
# the small configs card vs CPU: 48x48 images, uv 64
CAPTURE_SMALL_HW, CAPTURE_SMALL_UV = (48, 48), 64
# a texel of the small texture means may differ card vs CPU only where its
# projection lies within this many pixels of a pixel edge in a view that
# sees it: float32 projections from other operation orders round to the
# other pixel there
TEXMEAN_EDGE_PX = 1e-3


def capture_writer():
    """tests/goliath_capture.py, the writer the CPU tests use."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import goliath_capture

    return goliath_capture


def avif_line() -> str:
    """Whether this machine's Pillow decodes AVIF (real captures are)."""
    import warnings

    import PIL
    from PIL import features

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ok = features.check("avif")
    return f"Pillow {PIL.__version__}: AVIF {'decodes' if ok else 'does not'}"


def write_head_capture(gcap, base, hw, uv, cameras, seed=0):
    """The Head capture CAPTURE_HEAD under ``base`` at ``hw`` images and
    ``uv`` texture (the synthetic fixture's sphere, verts_mean and color
    mean, as FULL_DATA's; the fixture's camera ring), its segmentation at
    half size, and its shared assets (the fixture's topology). Returns the
    number of image members written."""
    from goliath_torch.data.synthetic import SyntheticDataset, \
        make_camera_ring

    a = SyntheticDataset(n_cams=1, n_frames=1, img_h=hw[0], img_w=hw[1],
                         uv_size=uv, seed=seed, device="cpu").static_assets
    K, Rt, _ = make_camera_ring(len(cameras), *hw)
    gcap.write_capture(base, CAPTURE_HEAD, gcap.CaptureSpec(
        kind="Head", cameras=list(cameras), K=K, Rt=Rt,
        frames=CAPTURE_TRAIN + CAPTURE_TEST, test_frames=CAPTURE_TEST,
        template=a["verts_mean"], image_hw=hw, uv_size=uv,
        color_mean=a["color_mean"], seg_half=True,
        n_light_positions=CAPTURE_LIGHTS, light_patterns=CAPTURE_PATTERNS,
        pattern_of_frame=CAPTURE_PATTERN_OF, seed=seed))
    gcap.write_shared_assets(Path(base) / "shared" / "static_assets_head.pt",
                             {"topology": dict(a["topology"])})
    return len(cameras) * len(CAPTURE_TRAIN + CAPTURE_TEST)


def write_hands_capture(gcap, base, hw, uv, n_cams, sphere, seed=0):
    """The Hands capture CAPTURE_HANDS under ``base``: ``n_cams`` cameras at
    TEXMEAN_DIST around the fixture's ``sphere`` (the template PLYs), poses
    of the fixture's 3-joint skeleton, TEXMEAN_FRAMES, no color mean; its
    shared assets (the topology with v2uv, the skeleton's model and
    config)."""
    from goliath_torch.data.synthetic import make_camera_ring, \
        make_sphere_mesh, make_synthetic_lbs
    from goliath_torch.utils.geom import compute_v2uv

    v, vi, vt, vti = make_sphere_mesh(**sphere)
    K, Rt, _ = make_camera_ring(n_cams, *hw, dist=TEXMEAN_DIST)
    cams = ["400870"] + [f"40{1645 + i:04d}" for i in range(n_cams - 1)]
    gcap.write_capture(base, CAPTURE_HANDS, gcap.CaptureSpec(
        kind="Hands", cameras=cams, K=K, Rt=Rt, frames=TEXMEAN_FRAMES,
        template=v, faces=vi, image_hw=hw, uv_size=uv,
        pattern_of_frame=TEXMEAN_PATTERN_OF, seed=seed))
    lbs_json, lbs_cfg = make_synthetic_lbs(v, vi, vt, vti)
    gcap.write_shared_assets(
        Path(base) / "shared" / "static_assets_hand_left.pt", {
            "topology": {"v": v, "vi": vi, "vt": vt, "vti": vti,
                         "v2uv": compute_v2uv(len(v), vi, vti)},
            "lbs_model_json": lbs_json, "lbs_config_dict": lbs_cfg})
    return Path(base) / CAPTURE_HANDS


def capture_config(base, run_dir, overrides=()):
    """configs/rgca.yml as it stands on the Head capture under ``base``:
    capture_root, the run directory and its checkpoints for run_test,
    CAPTURE_TEST_FRAMES test frames and no visualisations."""
    from goliath_torch.config import load_config

    return load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
        f"capture_root={base}", f"train.run_dir={run_dir}",
        f"test.ckpt.ckpt_path={Path(run_dir) / 'checkpoints'}",
        f"test.n_test_frames={CAPTURE_TEST_FRAMES}", "test.vis_path=null",
        *overrides])


class LoaderProbe:
    """For the duration of a with-block: the time the training loop waited
    for each batch (run_train's DataLoader, timed around each ``next``),
    the time of each ``collate`` (it runs inside the loader's ``next``, on
    the loop's thread, so it is part of that wait), the samples ``collate``
    dropped as None (a broken reader would hide there), and the inputs of
    the first ``k4`` K4 scans (copied to the host without a synchronise)."""

    def __init__(self, k4=2):
        self.k4 = k4
        self.waits, self.collates, self.k4_inputs = [], [], []
        self.dropped, self.samples = 0, 0

    def __enter__(self):
        from goliath_torch.data import pipeline
        from goliath_torch.ops import binning
        from goliath_torch.scripts import run_train

        self.mods = (pipeline, binning, run_train)
        self.orig = (pipeline.collate, binning.cumsum1d, run_train.DataLoader)
        orig_collate, orig_cs, base = self.orig
        probe = self

        def collate(samples):
            probe.samples += len(samples)
            probe.dropped += sum(s is None for s in samples)
            t0 = time.perf_counter()
            out = orig_collate(samples)
            probe.collates.append(time.perf_counter() - t0)
            return out

        def cs(x):
            if len(probe.k4_inputs) < probe.k4:
                probe.k4_inputs.append(x.to("cpu", non_blocking=True))
            return orig_cs(x)

        class TimedLoader(base):
            def __iter__(self):
                it = super().__iter__()
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    probe.waits.append(time.perf_counter() - t0)
                    yield batch

        pipeline.collate, binning.cumsum1d = collate, cs
        run_train.DataLoader = TimedLoader
        return self

    def __exit__(self, *exc):
        pipeline, binning, run_train = self.mods
        pipeline.collate, binning.cumsum1d, run_train.DataLoader = self.orig


def loader_rate(cfg, card_line, batches=4):
    """The capture loader alone (the config's batch and threads):
    samples per second over ``batches`` batches from a fresh iterator, and
    one sample's read on one thread."""
    from goliath_torch.data.pipeline import DataLoader
    from goliath_torch.scripts import run_train

    ds = run_train.build_dataset(cfg.data)
    t0 = time.perf_counter()
    one = ds[0]
    single = time.perf_counter() - t0
    loader = DataLoader(ds, device=DEVICE, **cfg.dataloader)
    t0 = time.perf_counter()
    it = iter(loader)
    n = 0
    for _ in range(batches):
        b = next(it)
        n += len(b["camera_id"])
    rate = n / (time.perf_counter() - t0)
    it.close()
    log(f"capture loader alone: {rate:.2f} samples/s over {n} samples "
        f"({int(cfg.dataloader.num_workers)} threads, batch "
        f"{int(cfg.dataloader.batch_size)}; PNG under .avif names, "
        f"{tuple(one['image'].shape)} images); one sample on one thread "
        f"{single:.4f} s (the host, beside {card_line})")
    return rate


def capture_path(gc, torch, card_line, captured):
    """The Head recipe on a capture at full width: the Head capture (13
    cameras: the CalV5 identity camera 400870 and configs/rgca.yml's 12 test
    cameras; 2048x1334 images, segmentation at half size, uv 1024; 6 train
    frames alternating the fully-lit pattern and 5-light ones, 2 test
    frames), then run_train.main on configs/rgca.yml as it stands (batch 4,
    the loader's 4 threads, fully_lit_only false) through run_training for
    TRAIN_STEPS steps into a run directory, then run_test.main from its
    checkpoint directory on the test split's 12 cameras
    (CAPTURE_TEST_FRAMES frames). Cuts: capture_root, train.n_max_iters,
    the run and checkpoint directories, test.n_test_frames,
    test.vis_path. Counts reset before each run: training as train_path
    (K1, K2, K3 once a sample a step, K1 for the summary's forward, K4
    twice a render), the test K1 once and K4 twice a frame. Per step the
    wall time and the time the loop waited for its batch; the loader's
    samples per second; no sample dropped. Keeps the run's first two K4
    inputs in ``captured["k4"]``. Returns the launches of the test run and
    of the training run."""
    from goliath_torch.native import zipio
    from goliath_torch.scripts import run_test

    gcap = capture_writer()
    log(f"capture zip reader: {zipio.reader_name()}")
    log(f"capture images: {avif_line()}")
    cfg0 = capture_config("/unused", "/unused")
    cameras = ["400870"] + list(cfg0.test.data.cameras_subset)
    hw = (int(cfg0.model.image_height), int(cfg0.model.image_width))
    uv = int(cfg0.model.uv_size)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capture_") as base:
        t0 = time.perf_counter()
        n_img = write_head_capture(gcap, base, hw, uv, cameras)
        log(f"capture writer: the Head capture ({n_img} images of "
            f"{hw[0]}x{hw[1]} and their half-size segmentations, "
            f"{len(CAPTURE_TRAIN + CAPTURE_TEST)} uv {uv} textures) in "
            f"{time.perf_counter() - t0:.2f} s (host)")
        run_dir = Path(base) / "run"
        n = TRAIN_BATCH * TRAIN_STEPS
        with LoaderProbe() as probe:
            train = run_training(
                gc, torch, card_line, "capture train path", dict(
                    pair_grads=n, cumsum_cols=n,
                    compositor_fwd=n + TRAIN_BATCH,
                    cumsum1d=2 * (n + TRAIN_BATCH)), {},
                make_config=lambda o: capture_config(base, run_dir, o),
                run_dir=str(run_dir))
        for i, (w, c) in enumerate(zip(probe.waits, probe.collates)):
            log(f"capture train path step {i}: waited {w:.4f} s for its "
                f"batch, of which collate {c:.4f} s (host clock around the "
                f"loader's next and around collate)")
        captured["k4"] = probe.k4_inputs
        cfg = capture_config(base, run_dir)
        rate = loader_rate(cfg, card_line)

        frames = []
        with LoaderProbe(k4=0) as test_probe:
            torch.cuda.synchronize()
            gc.reset_launch_counts()
            means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
            torch.cuda.synchronize()
            test = dict(gc.LAUNCHES)
    log(f"capture eval launches: {test}")
    log(f"capture eval means (from the checkpoint directory): "
        f"{json.dumps(means)}")
    for i, s in enumerate(frames):
        log(f"capture eval frame {i}: wall {s:.4f} s on {card_line}")
    dropped = probe.dropped + test_probe.dropped
    log(f"capture samples collated: {probe.samples} into the training "
        f"loop's batches, {test_probe.samples} into the eval frames; "
        f"dropped as None: {dropped}")
    if dropped:
        raise AssertionError(f"{dropped} capture samples were dropped")
    if len(frames) != CAPTURE_TEST_FRAMES or not all(
            math.isfinite(v) for v in means.values()):
        raise AssertionError("capture eval means are not finite")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(compositor_fwd=CAPTURE_TEST_FRAMES,
                cumsum1d=2 * CAPTURE_TEST_FRAMES)
    if test != want:
        raise AssertionError(f"capture eval launch counts {test} != {want}")
    if len(probe.waits) < TRAIN_STEPS or not rate > 0:
        raise AssertionError("the capture loader was not timed")
    return test, train


def texmean_path(gc, torch, card_line, captured):
    """run_gen_texmean.main on configs/urhand.yml with
    data.partially_lit_only=false (as the config stands, its OLAT training
    data gives the script no view: a black mean, as in the JAX package) on
    a fresh Hands capture (no uv_image/color_mean.png yet): TEXMEAN_CAMERAS
    cameras x the script's 5 fully-lit frames, each view one render at the
    config's 2048x1334 (K5 once, K4 twice) unprojected at uv 1024, counts
    reset just before and read just after (exact). Every view must give
    texels; the covered texel share must be above 0; the capture dataset
    then reads the new mean as [3, 1024, 1024]. Cut: capture_root. Keeps
    the first view's K5 arguments and K4 inputs in ``captured``."""
    from goliath_torch.config import load_config
    from goliath_torch.ops import binning, rasterizer
    from goliath_torch.scripts import run_gen_texmean, run_train

    gcap = capture_writer()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_texmean_") as base:
        cfg = load_config(str(ROOT / "configs" / "urhand.yml"),
                          overrides=[f"capture_root={base}",
                                     "data.partially_lit_only=false"])
        hw = (int(cfg.model.renderer.image_height),
              int(cfg.model.renderer.image_width))
        uv = int(cfg.get("texmean_uv_size", 1024))
        t0 = time.perf_counter()
        root = write_hands_capture(gcap, base, hw, uv, TEXMEAN_CAMERAS,
                                   TEXMEAN_SPHERE)
        log(f"capture writer: the Hands capture ({TEXMEAN_CAMERAS} cameras "
            f"x {len(TEXMEAN_FRAMES)} frames of {hw[0]}x{hw[1]}) in "
            f"{time.perf_counter() - t0:.2f} s (host)")
        mean_png = root / "uv_image" / "color_mean.png"
        if mean_png.exists():
            raise AssertionError("a fresh capture has no color mean")
        views, k4_inputs = [], []
        orig_zb, orig_cs = rasterizer.zbuffer, binning.cumsum1d

        def zb(*args):
            if "k5" not in captured:
                captured["k5"] = tuple(
                    a.to("cpu", non_blocking=True)
                    if isinstance(a, torch.Tensor) else a for a in args)
            return orig_zb(*args)

        def cs(x):
            if len(k4_inputs) < 2:
                k4_inputs.append(x.to("cpu", non_blocking=True))
            return orig_cs(x)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rasterizer.zbuffer, binning.cumsum1d = zb, cs
        gc.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            out = run_gen_texmean.main(cfg, device=DEVICE, view_seconds=views)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            launches = dict(gc.LAUNCHES)
        finally:
            rasterizer.zbuffer, binning.cumsum1d = orig_zb, orig_cs
        peak = torch.cuda.max_memory_allocated()
        captured["k4"] = k4_inputs
        data = dict(cfg.data)
        color_mean = run_train.build_dataset(data).static_assets.color_mean
    n_views = len(out["rendered"])
    log(f"texmean launches: {launches}")
    log(f"texmean: {n_views} views rendered, skipped {out['skipped']}; "
        f"texels per view {[v[2] for v in out['rendered']]}; covered "
        f"texel share {out['covered']:.4f}; wrote color_mean.png read back "
        f"as {tuple(getattr(color_mean, 'shape', ()))}")
    log(f"texmean wall: {total:.3f} s for the run (its UV tables and the "
        f"capture's static assets included); a view (read, render, "
        f"accumulate) median {sorted(views)[len(views) // 2]:.4f} s, first "
        f"{views[0]:.4f} s, range {min(views):.4f}-{max(views):.4f} s; peak "
        f"device memory {peak / 2**30:.3f} GiB on {card_line}")
    n_fully = len([f for f in TEXMEAN_FRAMES if TEXMEAN_PATTERN_OF[f] == 0])
    want_views = TEXMEAN_CAMERAS * min(5, n_fully)
    if out["skipped"] or n_views != want_views or not all(
            v[2] > 0 for v in out["rendered"]):
        raise AssertionError(f"a (frame, camera) gave no texture: "
                             f"{out['skipped']}")
    if not out["covered"] > 0:
        raise AssertionError("the texture mean covers no texel")
    if getattr(color_mean, "shape", None) != (3, uv, uv):
        raise AssertionError("the capture does not read the new color mean")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(zbuffer=n_views, cumsum1d=2 * n_views)
    if launches != want:
        raise AssertionError(f"texmean launch counts {launches} != {want}")
    return launches


def texmean_edge_distance(torch, tex_module):
    """Wraps ``tex_module.compute_view_texture`` for a with-block: keeps,
    per texel, the smallest distance (pixels) of its projection to a pixel
    edge over the views that see it."""
    import contextlib

    from goliath_torch.utils.geom import project_points

    @contextlib.contextmanager
    def ctx():
        orig = tex_module.compute_view_texture
        best = {}

        def cvt(verts, faces, image, face_index_image, normal_image, K, Rt,
                index_uv, bary_uv, face_index_uv, **kw):
            out = orig(verts, faces, image, face_index_image, normal_image,
                       K, Rt, index_uv, bary_uv, face_index_uv, **kw)
            idx = index_uv.clamp(0, verts.shape[1] - 1).long()
            c = verts[:, idx] * bary_uv[None, ..., None]
            xyz = c[..., 0, :] + c[..., 1, :] + c[..., 2, :]
            pix, _ = project_points(xyz.reshape(verts.shape[0], -1, 3), Rt, K)
            dist = (pix - pix.round()).abs().amin(-1).reshape(
                out[1].shape[0], *index_uv.shape[:2])
            dist = torch.where(out[1][:, 0], dist, torch.inf).amin(0)
            best["edge"] = (dist if "edge" not in best
                            else torch.minimum(best["edge"], dist))
            return out

        tex_module.compute_view_texture = cvt
        try:
            yield best
        finally:
            tex_module.compute_view_texture = orig

    return ctx()


def capture_small_reference(torch):
    """Both capture paths at a small size on the card (kernels) against the
    CPU (plain versions). The RGCA recipe on a small Head capture (48x48,
    uv 64, configs/rgca_synthetic.yml's model at those widths): two
    training steps through run_train.main, the second step's losses and
    the first step's gradients at SMALL_RTOL, as small_reference holds
    configs/rgca_synthetic.yml. run_gen_texmean on a small Hands capture
    (48x48, uv 64, 2 cameras, its first 3 frames, fully lit): the PNGs
    equal but at texels whose projection lies within TEXMEAN_EDGE_PX of a
    pixel edge in a view that sees them (measured, printed)."""
    import numpy as np
    from PIL import Image

    from goliath_torch import train as train_lib
    from goliath_torch.config import load_config
    from goliath_torch.scripts import run_gen_texmean, run_train
    from goliath_torch.utils import tex as tex_module

    gcap = capture_writer()
    hw, uv = CAPTURE_SMALL_HW, CAPTURE_SMALL_UV
    with tempfile.TemporaryDirectory(prefix="chip_smoke_capsmall_") as base:
        write_head_capture(gcap, base, hw, uv, ["400000", "400001",
                                                "400002"], seed=3)
        data = {"root_path": str(Path(base) / CAPTURE_HEAD),
                "shared_assets_path": str(
                    Path(base) / "shared" / "static_assets_head.pt"),
                "split": "train", "fully_lit_only": False}
        runs = {}
        for device in (DEVICE, "cpu"):
            cfg = load_config(str(ROOT / "configs" / "rgca_synthetic.yml"),
                              overrides=[
                f"data={yaml_flow(data)}", f"model.image_height={hw[0]}",
                f"model.image_width={hw[1]}", f"model.uv_size={uv}",
                f"train.run_dir={Path(base) / ('run_' + device)}",
                "train.n_max_iters=2", "train.resume=false"])
            with StepProbe(torch, train_lib, keep_grads=True) as probe:
                _it, last = run_train.main(cfg, device=device)
            runs[device] = (last, probe.grads, probe.totals)
    (got, g_got, t_got), (ref, g_ref, t_ref) = runs[DEVICE], runs["cpu"]
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref)
    worst_g, worst_name = grad_error(g_got, g_ref)
    log(f"small capture RGCA training reference (card vs CPU plain): step "
        f"totals {t_got} vs {t_ref}; second step's losses max rel diff "
        f"{worst:.3e}; first step's gradients over {len(g_ref)} parameters: "
        f"largest error as a fraction of the parameter's largest gradient "
        f"{worst_g:.3e} ({worst_name}) (tolerance {SMALL_RTOL} each)")
    if not (worst <= SMALL_RTOL and worst_g <= SMALL_RTOL
            and set(got) == set(ref) and set(g_got) == set(g_ref)):
        raise AssertionError("the card's capture training steps disagree "
                             "with the CPU's")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_texsmall_") as base:
        root = write_hands_capture(gcap, base, hw, uv, 2,
                                   {"n_lat": 8, "n_lon": 12}, seed=5)
        cfg = load_config(str(ROOT / "configs" / "urhand.yml"), overrides=[
            f"capture_root={base}", f"model.renderer.image_height={hw[0]}",
            f"model.renderer.image_width={hw[1]}",
            f"texmean_uv_size={uv}", "texmean_num_frames=3",
            "data.partially_lit_only=false"])
        pngs = {}
        for device in (DEVICE, "cpu"):
            with texmean_edge_distance(torch, tex_module) as best:
                out = run_gen_texmean.main(cfg, device=device)
            path = Path(out["path"])
            pngs[device] = np.asarray(Image.open(path)).astype(np.int16)
            path.unlink()
            if device == "cpu":
                # the PNG is the mean flipped vertically
                edge = best["edge"].flip(0).cpu().numpy()
    diff = np.abs(pngs[DEVICE] - pngs["cpu"]).max(-1)
    bad = diff > 0
    near = edge < TEXMEAN_EDGE_PX
    seen = np.isfinite(edge)
    far_bad = int((bad & ~near).sum())
    where = (f", the farthest {float(edge[bad].max()):.3e} px from a pixel "
             f"edge" if bad.any() else "")
    log(f"small texmean reference (card vs CPU plain, {uv}x{uv}, "
        f"{len(out['rendered'])} views): {int(bad.sum())} of {int(seen.sum())}"
        f" seen texels differ (by up to {int(diff.max())} of 255{where}); "
        f"{int(near.sum())} "
        f"texels lie within {TEXMEAN_EDGE_PX} px of one (the smallest "
        f"distance {float(edge.min()):.3e} px), where a difference is "
        f"allowed")
    if far_bad or not seen.any() or not pngs["cpu"].any():
        raise AssertionError(f"the card's texture mean differs from the "
                             f"CPU's at {far_bad} texels away from pixel "
                             f"edges")
    return {"losses_rel_err": worst, "grad_err_of_scale": worst_g,
            "texmean_texels_differing": int(bad.sum())}


def check_k6(gc, torch, steps):
    """K6 forward and backward against their plain versions on the own
    inputs of every fold training step (the rows, global tile bounds, cnt,
    forward outputs and upstream gradients each backward was handed), at
    the tolerances of K1 and K2 (after the first step with K6_ZERO_BELOW),
    the backward launched twice with equal bits; times, the plain versions'
    times and bounds on the first step, counted as K1's and K2's."""
    res = {}
    for i, host_args in enumerate(steps):
        args = tuple(a.to(DEVICE) if isinstance(a, torch.Tensor) else a
                     for a in host_args)
        step = check_k6_step(gc, torch, args, f"K6 step {i}", timed=i == 0,
                             zero_below=K6_ZERO_BELOW if i else 0.0)
        del args
        torch.cuda.empty_cache()
        res = res or step
    log(f"K6 forward and backward held on {len(steps)} fold steps")
    return res


def check_k6_step(gc, torch, args, label, timed, zero_below):
    """check_k6 on one fold step: {kernel: its entry of the kernels line}
    when ``timed``, else {}. ``zero_below`` as for compare_pair_grads."""
    from goliath_torch.utils.timing import cuda_ms

    (rows, tile_start, tile_end, cnt, d_out, d_T, T, ts, ntx, nty, chunk,
     n_pairs, n_imgs, window) = args
    if window != "pallas" or n_imgs != TRAIN_BATCH:
        raise AssertionError(f"the fold ran {n_imgs} images, window {window}")
    B, C, H, W = d_out.shape
    maxpp = load_max_pairs()
    nchunks = maxpp // chunk + 1
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=ntx, nty=nty, chunk=chunk,
              max_pairs_per_tile=maxpp, n_imgs=n_imgs)
    f_img, f_T, f_cnt = gc.compositor_fwd(rows, tile_start, tile_end, **kw)
    counts = {}
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, tile_start, tile_end,
                                                counts=counts, **kw)
    torch.cuda.synchronize()
    err_img = float((f_img - p_img).abs().max())
    err_T = float((f_T - p_T).abs().max())
    T_bits = int((f_T.view(torch.int32) != p_T.view(torch.int32)).sum())
    same_run = bool(torch.equal(f_cnt, cnt)) and float(
        (f_T - T).abs().max()) <= K1_ATOL
    pairs = tile_end.long() - tile_start.long()
    log(f"{label} forward: {n_imgs} images, rows={tuple(rows.shape)} tiles="
        f"{tile_start.numel()} pairs={int(pairs.sum())} max_pairs_in_a_tile="
        f"{int(pairs.max())} tiles_cut_early={int((cnt < nchunks).sum())} "
        f"max_abs_err all channels={err_img:.3e} T={err_T:.3e} (pixels "
        f"whose T bits differ: {T_bits}) "
        f"cnt_mismatches={int((f_cnt != p_cnt).sum())}; the training step's "
        f"own cnt and T reproduced: {same_run} (tolerance atol {K1_ATOL} "
        f"rtol {K1_RTOL}, cnt exact)")
    held = {"image": torch.allclose(f_img, p_img, atol=K1_ATOL, rtol=K1_RTOL),
            "T": torch.allclose(f_T, p_T, atol=K1_ATOL, rtol=K1_RTOL),
            "cnt": torch.equal(f_cnt, p_cnt), "own run": same_run}
    if not all(held.values()):
        raise AssertionError(f"{label}: K6's forward differs from its plain "
                             f"version or its own run in "
                             f"{[k for k, v in held.items() if not v]}")
    del p_img, p_T
    evals = processed_evals(tile_start, tile_end, cnt, chunk, nchunks, ts)
    report_k1_work(counts, evals, f"{label} forward")

    call = (rows, tile_start, tile_end, cnt, d_out, d_T, T, ts, ntx, nty,
            chunk, n_pairs, n_imgs)
    got = gc.pair_grads(*call)
    torch.cuda.synchronize()
    counts = {}
    ref = gc.pair_grads_plain(*call, counts=counts)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: K6's backward output is not finite")
    worst = compare_pair_grads(gc, torch, got, ref, C, f"{label} backward",
                               zero_below)
    check_same_bits(torch, got, gc.pair_grads(*call), f"{label} backward")
    del got, ref
    if not timed:
        return {}

    nbytes = (rows.numel() * 4 + 2 * tile_start.numel() * 4
              + f_img.numel() * 4 + T.numel() * 4 + cnt.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 16 * evals)
    ms = cuda_ms(lambda: gc.compositor_fwd(rows, tile_start, tile_end, **kw),
                 reps=10)
    plain_ms = cuda_ms(lambda: gc.compositor_fwd_plain(
        rows, tile_start, tile_end, **kw), reps=1, warmup=0)
    log(f"K6 forward timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({evals} pair-pixel evaluations, {nbytes} "
        f"bytes; {ms / b_ms:.1f}x the bound)")
    fwd = dict(max_abs_err=max(err_img, err_T), ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None)

    kept = int(counts["kept"])
    b_ms, b_by, nbytes = k2_bound(rows, tile_start, d_out, T, n_pairs, evals,
                                  kept, C)
    ms = cuda_ms(lambda: gc.pair_grads(*call), reps=5)
    plain_ms = cuda_ms(lambda: gc.pair_grads_plain(*call), reps=1, warmup=0)
    log(f"K6 backward timing: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({evals} evaluations of 2 x 16 operations,"
        f" {kept} of them kept ({kept / max(evals, 1):.4f}) with {27 + 6 * C}"
        f" more, {nbytes} bytes; {ms / b_ms:.1f}x the bound)")
    report_warp_visits(gc, torch, counts, ms, "K6 backward")
    bwd = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    return {"compositor_fwd_fold": fwd, "pair_grads_fold": bwd}


def load_max_pairs() -> int:
    from goliath_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "rgca.yml"))
    return int(cfg.model.render.max_pairs_per_tile)


def small_frame(gc, torch, opaque, maxpp, chunk, ts, H=72, W=100, N=400,
                seed=0):
    """A small splat frame (the scene of tests/test_torch_cuda.py, seeded
    with numpy) on the card: pair rows, binning and K1's keyword args."""
    import numpy as np

    from goliath_torch.ops import gsplat

    rng = np.random.RandomState(seed)
    means = rng.randn(N, 3).astype(np.float32) * 0.3
    means[:, 2] += 2.5
    scales = (0.02 + 0.1 * rng.rand(N, 3)).astype(np.float32)
    quats = rng.randn(N, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    lo = 0.9 if opaque else 0.05
    opac = (rng.rand(N, 1) * (0.99 - lo) + lo).astype(np.float32)
    colors = rng.rand(N, 3).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    Rt = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    arrays = [torch.from_numpy(a).to(DEVICE)
              for a in (K, Rt, means, quats, scales, opac, colors)]
    xys, conics, op_s, chan, valid, _r, b = gsplat.prepare_sample(
        *arrays, H, W, ts, pair_budget=4 * N)
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             b.sorted_prim, (maxpp // chunk + 1) * chunk)
    kw = dict(img_h=H, img_w=W, tile_size=ts, ntx=-(-W // ts),
              nty=-(-H // ts), chunk=chunk, max_pairs_per_tile=maxpp)
    return rows, b, kw


def xla_window_check(gc, torch, card_line):
    """K1 and K2 in the XLA compositor's window (use_pallas false: blocks
    from each tile's start, no early-out) against their plain versions on a
    small frame whose tiles overflow; then one run_test frame of
    configs/rgca_synthetic.yml (use_pallas unset) on the card, counts reset
    just before: it must take the XLA window and only it; then one training
    step of that config through run_train.main, counts reset again, which
    must run K1 and K2 in the XLA window only. K1 and K2 in that mode are
    then held against their plain versions again, and timed, on the frame
    the eval run handed to rasterize_tiled."""
    from goliath_torch.config import load_config
    from goliath_torch.scripts import run_test
    from goliath_torch.utils.timing import cuda_ms

    rows, b, kw = small_frame(gc, torch, True, 64, 16, 16)
    pairs = (b.tile_end - b.tile_start).long()
    img, T, cnt = gc.compositor_fwd(rows, b.tile_start, b.tile_end,
                                    window="xla", **kw)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, b.tile_start,
                                                b.tile_end, window="xla",
                                                **kw)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    d_out = torch.randn(img.shape, generator=gen, device=DEVICE)
    d_T = torch.randn(T.shape, generator=gen, device=DEVICE)
    call = (rows, b.tile_start, b.tile_end, cnt, d_out, d_T, T, 16,
            kw["ntx"], kw["nty"], 16, b.sorted_prim.shape[0])
    got = gc.pair_grads(*call, window="xla")
    ref = gc.pair_grads_plain(*call, window="xla")
    torch.cuda.synchronize()
    err_f = max(float((img - p_img).abs().max()), float((T - p_T).abs().max()))
    log(f"XLA window, small frame (72x100, tile 16, max_pairs_per_tile 64, "
        f"chunk 16): {int((pairs > 64).sum())} of {pairs.numel()} tiles "
        f"overflow (max {int(pairs.max())} pairs), min T {float(T.min()):.3e}"
        f" (no early-out); K1 max_abs_err {err_f:.3e}, cnt mismatches "
        f"{int((cnt != p_cnt).sum())} (tolerance atol {K1_ATOL} rtol "
        f"{K1_RTOL}, cnt exact)")
    if not (int((pairs > 64).sum()) and torch.equal(cnt, p_cnt)
            and torch.allclose(img, p_img, atol=K1_ATOL, rtol=K1_RTOL)
            and torch.allclose(T, p_T, atol=K1_ATOL, rtol=K1_RTOL)):
        raise AssertionError("K1's XLA window differs from its plain version")
    err_b = compare_pair_grads(gc, torch, got, ref, 4, "K2 XLA window")

    cfg = load_config(str(ROOT / "configs" / "rgca_synthetic.yml"),
                      overrides=["test.ckpt=null", "test.vis_path=null",
                                 "test.n_test_frames=1"])
    if cfg.model.render.get("use_pallas") is not None:
        raise AssertionError("configs/rgca_synthetic.yml sets use_pallas")
    seen = {}
    orig_rt = gc.rasterize_tiled

    def rt(*args, **rkw):
        seen.setdefault("args", args)
        seen.setdefault("kw", rkw)
        return orig_rt(*args, **rkw)

    gc.rasterize_tiled = rt
    gc.reset_launch_counts()
    try:
        means = run_test.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    finally:
        gc.rasterize_tiled = orig_rt
    log(f"xla eval path (configs/rgca_synthetic.yml, use_pallas unset, 1 "
        f"frame, batch 1) launches: {launches}; means {json.dumps(means)}")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(compositor_fwd_xla=1, cumsum1d=2)
    if launches != want or seen["kw"].get("window") != "xla":
        raise AssertionError(f"the use_pallas-unset run did not take the "
                             f"XLA window alone: {launches}")
    if not all(math.isfinite(v) for v in means.values()):
        raise AssertionError("xla eval losses are not finite")
    train_launches = xla_train_step(gc, torch)

    # K1 and K2 in the XLA window on that run's own frame
    (xys, conics, op_s, chan, valid, sorted_prim, tile_start, tile_end, _p,
     _o, _e, img_h, img_w, ts, maxpp, chunk, ntx, nty) = seen["args"]
    nchunks = maxpp // chunk
    rows = gc.pack_pair_rows(xys, conics, op_s, chan, valid.float(),
                             sorted_prim, (nchunks + 1) * chunk)
    fkw = dict(img_h=img_h, img_w=img_w, tile_size=ts, ntx=ntx, nty=nty,
               chunk=chunk, max_pairs_per_tile=maxpp, window="xla")
    img, T, cnt = gc.compositor_fwd(rows, tile_start, tile_end, **fkw)
    p_img, p_T, p_cnt = gc.compositor_fwd_plain(rows, tile_start, tile_end,
                                                **fkw)
    torch.cuda.synchronize()
    pairs = (tile_end - tile_start).long()
    err_fr = max(float((img - p_img).abs().max()),
                 float((T - p_T).abs().max()))
    log(f"XLA window, rgca_synthetic frame ({img_w}x{img_h}, tile {ts}, "
        f"max_pairs_per_tile {maxpp}, chunk {chunk}): "
        f"{int((pairs > maxpp).sum())} of {pairs.numel()} tiles overflow "
        f"(max {int(pairs.max())} pairs), min T {float(T.min()):.3e}; K1 "
        f"max_abs_err {err_fr:.3e}, cnt mismatches "
        f"{int((cnt != p_cnt).sum())} (tolerance atol {K1_ATOL} rtol "
        f"{K1_RTOL}, cnt exact)")
    if not (torch.equal(cnt, p_cnt)
            and torch.allclose(img, p_img, atol=K1_ATOL, rtol=K1_RTOL)
            and torch.allclose(T, p_T, atol=K1_ATOL, rtol=K1_RTOL)
            and torch.isfinite(img).all() and torch.isfinite(T).all()):
        raise AssertionError("K1's XLA window differs from its plain version "
                             "on the rgca_synthetic frame")
    evals = processed_evals(tile_start, tile_end, cnt, chunk, nchunks, ts,
                            "xla")
    nbytes = (rows.numel() * 4 + 2 * tile_start.numel() * 4
              + img.numel() * 4 + T.numel() * 4 + cnt.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 16 * evals)
    ms = cuda_ms(lambda: gc.compositor_fwd(rows, tile_start, tile_end, **fkw),
                 reps=50)
    plain_ms = cuda_ms(lambda: gc.compositor_fwd_plain(
        rows, tile_start, tile_end, **fkw), reps=5)
    fwd = dict(max_abs_err=err_fr, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    call = (rows, tile_start, tile_end, cnt,
            torch.randn(img.shape, generator=gen, device=DEVICE),
            torch.randn(T.shape, generator=gen, device=DEVICE), T, ts, ntx,
            nty, chunk, sorted_prim.shape[0])
    counts = {}
    got = gc.pair_grads(*call, window="xla")
    ref = gc.pair_grads_plain(*call, window="xla", counts=counts)
    torch.cuda.synchronize()
    C = chan.shape[1]
    if not torch.isfinite(got).all():
        raise AssertionError("K2's XLA window output is not finite")
    err_br = compare_pair_grads(gc, torch, got, ref, C,
                                "K2 XLA window, rgca_synthetic frame")
    check_same_bits(torch, got, gc.pair_grads(*call, window="xla"),
                    "K2 XLA window")
    kept = int(counts["kept"])
    bb_ms, bb_by, _ = k2_bound(rows, tile_start, call[4], T,
                               sorted_prim.shape[0], evals, kept, C)
    bms = cuda_ms(lambda: gc.pair_grads(*call, window="xla"), reps=50)
    bplain_ms = cuda_ms(lambda: gc.pair_grads_plain(*call, window="xla"),
                        reps=5)
    log(f"XLA window on the rgca_synthetic frame ({img_w}x{img_h}, "
        f"{tile_start.numel()} tiles, {int((tile_end - tile_start).sum())} "
        f"pairs, {evals} evaluations, {kept} kept): K1 {ms:.4f} ms (plain "
        f"{plain_ms:.4f}, bound {b_ms:.4f} by {b_by}); K2 {bms:.4f} ms (plain"
        f" {bplain_ms:.4f}, bound {bb_ms:.4f} by {bb_by}) on {card_line}; "
        f"max_abs_err there K1 {err_fr:.3e}, K2 {err_br:.3e} (small frame: "
        f"K1 {err_f:.3e}, K2 {err_b:.3e})")
    bwd = dict(max_abs_err=err_br, ms=bms, plain_ms=bplain_ms,
               bound_ms=bb_ms, bound_by=bb_by, library_ms=None)
    return ((launches, train_launches),
            {"compositor_fwd_xla": fwd, "pair_grads_xla": bwd})


def xla_train_step(gc, torch):
    """One run_train.main step of configs/rgca_synthetic.yml (use_pallas
    unset, batch 2) on the card, counts reset just before: K1 in the XLA
    window for the 2 samples of the step and the 2 of the summary's
    train=False forward at iteration 0, K2 in that window and the reduce
    (K3) for the step's 2, K4 twice per render; no other kernel."""
    from goliath_torch.config import load_config
    from goliath_torch.scripts import run_train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_xla_") as run_dir:
        cfg = load_config(str(ROOT / "configs" / "rgca_synthetic.yml"),
                          overrides=[f"train.run_dir={run_dir}",
                                     "train.n_max_iters=1",
                                     "train.resume=false"])
        gc.reset_launch_counts()
        iteration, last = run_train.main(cfg, device=DEVICE)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    B = cfg.dataloader.batch_size
    log(f"xla train path (configs/rgca_synthetic.yml, use_pallas unset, 1 "
        f"step, batch {B}) launches: {launches}; losses {json.dumps(last)}")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(compositor_fwd_xla=2 * B, pair_grads_xla=B, cumsum_cols=B,
                cumsum1d=4 * B)
    if iteration != 1 or launches != want:
        raise AssertionError(f"the use_pallas-unset training step did not "
                             f"take the XLA window alone: {launches} != "
                             f"{want}")
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError("xla training losses are not finite")
    return launches


# K7 against a float64 scan as K3 (a fraction of each column's largest
# running sum, the scan taken along the last dim of a transposed copy:
# torch.cumsum along dim 0 in float64 takes ~0.6 s a call at 2M rows), and,
# at the two shapes where it is timed, against torch.cumsum(x, 0) within
# that call's own distance from the float64 scan plus the same (along dim 0
# torch.cumsum adds sequentially and drifts further than a scan tree: 6.6e-5
# of the running sum at 2^24 rows, tests/test_torch_cuda.py); the presort
# reduce on K7 against the channel-first reduce on K3: each sum is a
# difference of two float32 prefixes on both routes, so 4 x K3_TOL_F64 of
# the column's largest running sum
K7_REDUCE_TOL = 4 * K3_TOL_F64
K7_DETERMINISM_CALLS = 20


def k7_f64_error(torch, got, x):
    """K7's output against a float64 scan of [M, F] x, as the largest
    fraction of each column's largest running sum; (that error, the
    float64 scan [F, M], the scale [F, 1])."""
    ref = torch.cumsum(x.t().contiguous().double(), 1)
    scale = ref.abs().amax(1, keepdim=True).clamp(min=1e-30)
    return float(((got.t().double() - ref).abs() / scale).max()), ref, scale


def check_k7_frame(gc, torch, frame):
    """K7 on the frame's real pair gradients in pre-sort order as
    [budget, F] (what reduce_presort_pair_grads would scan): against a
    float64 scan, and 20 calls bit-equal (K7's carry is folded in tile
    order, as K3's)."""
    x = frame["presort"].t().contiguous()
    first = gc.cumsum_rows(x)
    e64, _, _ = k7_f64_error(torch, first, x)
    n_diff = 0
    for _ in range(K7_DETERMINISM_CALLS):
        n_diff += int((gc.cumsum_rows(x).view(torch.int32)
                       != first.view(torch.int32)).sum())
    torch.cuda.synchronize()
    log(f"K7 {list(x.shape)} the frame's pair gradients (pre-sort order): "
        f"error as a fraction of each column's largest running sum against "
        f"a float64 scan {e64:.3e} (tolerance {K3_TOL_F64}); "
        f"{K7_DETERMINISM_CALLS} more calls differ from the first in "
        f"{n_diff} entries (bits) of {K7_DETERMINISM_CALLS} x {x.numel()}")
    if e64 > K3_TOL_F64:
        raise AssertionError("K7 differs from the float64 scan on the frame's "
                             "pair gradients")
    if n_diff:
        raise AssertionError("K7 gives other bits on another call")
    return dict(frame_err_f64=e64, frame_shape=list(x.shape))


def check_k7(gc, torch, card_line):
    """K7 against a float64 scan at [2,097,152, 10] (profile_reduce's
    budget), a ragged [1,000,003, 10], [3,145,728, 10] (the per-sample pair
    budget) and [12,582,912, 10] (the folded one), and against
    torch.cumsum(x, 0) at the first two; timed at the three budgets beside
    its bound and the two-transpose route through K3, with its device
    operations a call from the profiler (one memset and one kernel); then
    goliath_torch.scripts.profile_reduce.main (its counts reset just before
    and read just after), and the presort reduce on K7 against the
    channel-first reduce on K3 on profile_reduce's inputs."""
    from goliath_torch.ops import gsplat
    from goliath_torch.scripts import profile_reduce
    from goliath_torch.utils.timing import cuda_ms

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    worst, timing = 0.0, {}
    for M, F in ((2_097_152, 10), (1_000_003, 10), (3_145_728, 10),
                 (K3_FOLD_M, 10)):
        x = torch.randn((M, F), generator=gen, device=DEVICE)
        got = gc.cumsum_rows(x)
        e64, ref, scale = k7_f64_error(torch, got, x)
        with_plain = M <= 2_097_152   # torch.cumsum(x, 0): ~0.3 s a call
        if with_plain:
            plain = gc.cumsum_rows_plain(x)
            e32 = float(((got - plain).t().double().abs() / scale).max())
            p64 = float(((plain.t().double() - ref).abs() / scale).max())
            worst = max(worst, float((got - plain).abs().max()))
            del plain
        del ref, scale
        ms = cuda_ms(lambda: gc.cumsum_rows(x), reps=50)
        b_ms, b_by = bound_ms(2 * M * F * 4, M * F)
        line = (f"K7 [{M}, {F}]: error as a fraction of each column's "
                f"largest running sum against a float64 scan {e64:.3e} "
                f"(tolerance {K3_TOL_F64})")
        if with_plain:
            line += (f", against torch.cumsum(x, 0) float32 {e32:.3e} "
                     f"(tolerance: torch.cumsum's own distance from the "
                     f"float64 scan, {p64:.3e}, + {K3_TOL_F64})")
        log(f"{line}; {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({2 * M * F * 4} bytes) on {card_line}")
        if e64 > K3_TOL_F64 or (with_plain and e32 > p64 + K3_TOL_F64):
            raise AssertionError(f"K7 differs from the float64 scan or "
                                 f"torch.cumsum at [{M}, {F}]")
        if M % 1_048_576 == 0:
            # the yardstick: K3 between two transposes
            two_t = cuda_ms(lambda: gc.cumsum_cols(
                x.t().contiguous()).t().contiguous(), reps=20)
            log(f"K7 [{M}, {F}] timing: {ms:.4f} ms; the two-transpose "
                f"route (K3 on x.t().contiguous(), transposed back) "
                f"{two_t:.4f} ms; K7 / bound {ms / b_ms:.2f}")
            # the kernels line's own keys at profile_reduce's budget
            sfx = "" if M == 2_097_152 else f"_{M}"
            timing.update({f"ms{sfx}": ms, f"bound_ms{sfx}": b_ms,
                           f"two_transpose_ms{sfx}": two_t})
        if M == 2_097_152:
            # ~0.3-0.6 s a call along dim 0 (sequential per column)
            lib_ms = cuda_ms(lambda: torch.cumsum(x, 0), reps=2, warmup=1)
            log(f"K7 [{M}, {F}]: plain = torch.cumsum(x, 0) {lib_ms:.4f} ms")
            timing.update(bound_by=b_by, plain_ms=lib_ms, library_ms=lib_ms)
            # the profiler may miss some of the calls' events (or all of
            # them), so the check is on what it did see: no operation but
            # the K7 kernel and a memset, neither more than once a call
            p_ms, _, p_names = profiled_device_ms(
                torch, lambda: gc.cumsum_rows(x), 50)
            if p_ms is None:
                log("K7 profiled device time: not measured (the profiler "
                    "saw no device activity)")
            else:
                kernels = [k for k in p_names if "scan_rows_lookback" in k]
                memsets = [k for k in p_names if "Memset" in k]
                if kernels:   # over the calls whose kernel it recorded
                    p_ms /= p_names[kernels[0]]
                log(f"K7 [{M}, {F}] device operations a call (50 calls; "
                    f"the profiler may miss a few): {p_names}; device time "
                    f"a call it recorded {p_ms:.4f} ms")
                if len(kernels) + len(memsets) != len(p_names) \
                        or len(kernels) > 1 or max(p_names.values()) > 1.0:
                    raise AssertionError("K7 is not one memset and one "
                                         "kernel a call")
            timing["profiled_ms"] = p_ms
        del x, got

    gc.reset_launch_counts()
    profile_reduce.main()
    torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    log(f"profile_reduce launches: {launches}")
    sorted_g, perm, offsets, ends = profile_reduce.make_inputs(
        1 << 20, 2, 10, DEVICE)
    presort = profile_reduce.via_index_copy(sorted_g, perm)
    k7 = gsplat.reduce_presort_pair_grads(presort, offsets, ends)
    k3 = gsplat.reduce_sorted_pair_grads(sorted_g, perm, offsets, ends).T
    run_max = torch.cumsum(presort.t().contiguous().double(), 1).abs().amax(
        1).float()
    err = (k7 - k3).abs().amax(0)
    log(f"presort reduce (K7) vs channel-first reduce (K3), per column: "
        f"max_abs_err {[f'{float(e):.3e}' for e in err]}, largest running "
        f"sums {[f'{float(m):.3e}' for m in run_max]} (tolerance "
        f"{K7_REDUCE_TOL} of the running sum)")
    if not bool((err <= K7_REDUCE_TOL * run_max).all()):
        raise AssertionError("the presort reduce on K7 differs from the "
                             "channel-first reduce on K3")
    if not launches["cumsum_rows"]:
        raise AssertionError("profile_reduce did not launch K7")
    return launches, dict(max_abs_err=worst, **timing)


def p1_variants_check(gc, torch, rows, tile_start, tile_end, cnt, kw,
                      label, time_plain=False):
    """Every P1 variant against its plain version (``compositor_fwd_plain``
    with the variant, replaying ``cnt``) on one frame, at K1's tolerances
    with ``cnt`` exact. Returns {variant: max_abs_err} and, with
    ``time_plain``, {variant: the plain version's ms} (its one call)."""
    from goliath_torch.utils.timing import cuda_call_ms

    errs, plain_ms, largest = {}, {}, {}
    for v in gc.PROBE_VARIANTS:
        got = gc.probe_fwd(rows, tile_start, tile_end, cnt, variant=v, **kw)
        ref, plain_ms[v] = cuda_call_ms(lambda v=v: gc.compositor_fwd_plain(
            rows, tile_start, tile_end, variant=v, replay_cnt=cnt, **kw))
        torch.cuda.synchronize()
        errs[v] = max(float((got[0] - ref[0]).abs().max()),
                      float((got[1] - ref[1]).abs().max()))
        largest[v] = float(ref[0].abs().max())
        if not (torch.allclose(got[0], ref[0], atol=K1_ATOL, rtol=K1_RTOL)
                and torch.allclose(got[1], ref[1], atol=K1_ATOL, rtol=K1_RTOL)
                and torch.equal(got[2], ref[2])
                and torch.isfinite(got[0]).all()
                and torch.isfinite(got[1]).all()):
            raise AssertionError(f"P1 {v} differs from its plain version on "
                                 f"{label}")
    log(f"P1 variants against their plain versions on {label}: max_abs_err "
        f"{errs}, largest |output| {largest} (tolerance atol {K1_ATOL} rtol "
        f"{K1_RTOL}, cnt exact)")
    return (errs, plain_ms) if time_plain else errs


def p1_probe(gc, torch, args, frame, card_line):
    """P1: ``full`` equals K1 bit for bit on the captured RGCA frame; each
    variant against its plain version there (the error and plain time of
    the kernels line), on small frames, and on one chunk of
    probe_kernel's scene; every variant's time and share of full on the
    captured frame, then goliath_torch.scripts.probe_kernel.main on its own
    scene (counts reset just before and read just after)."""
    from goliath_torch.scripts import probe_kernel
    from goliath_torch.utils.timing import cuda_ms

    (_xys, _conics, _op, chan, _valid, _sp, tile_start, tile_end, _perm,
     _off, _ends, img_h, img_w, ts, maxpp, chunk, ntx, nty) = args
    rows, img, T, cnt = (frame[k] for k in ("rows", "img", "T", "cnt"))
    kw = dict(img_h=img_h, img_w=img_w, tile_size=ts, ntx=ntx, nty=nty,
              chunk=chunk, max_pairs_per_tile=maxpp)
    full = gc.probe_fwd(rows, tile_start, tile_end, cnt, variant="full", **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(full, (img, T, cnt)))
    log(f"P1 full on the captured RGCA frame equals K1 bit for bit: "
        f"{bitwise}")
    if not bitwise:
        raise AssertionError("P1's full variant differs from K1")
    errs, plain = p1_variants_check(gc, torch, rows, tile_start, tile_end,
                                    cnt, kw, "the captured RGCA frame",
                                    time_plain=True)
    for opaque, mpp, ch, tsz in ((False, 256, 32, 16), (True, 64, 16, 16),
                                 (True, 128, 32, 32)):
        s_rows, b, skw = small_frame(gc, torch, opaque, mpp, ch, tsz)
        _i, _t, s_cnt = gc.compositor_fwd(s_rows, b.tile_start, b.tile_end,
                                          **skw)
        p1_variants_check(gc, torch, s_rows, b.tile_start, b.tile_end, s_cnt,
                          skw, f"a small frame (72x100, tile {tsz}, "
                          f"max_pairs_per_tile {mpp}, chunk {ch})")

    evals = frame["evals"]
    C = chan.shape[1]
    nbytes = (rows.numel() * 4 + 2 * tile_start.numel() * 4
              + img.numel() * 4 + T.numel() * 4 + cnt.numel() * 4)
    out = {}
    for v in gc.PROBE_VARIANTS:
        ms = cuda_ms(lambda v=v: gc.probe_fwd(rows, tile_start, tile_end, cnt,
                                              variant=v, **kw), reps=20)
        ops = (C if v == "loadonly" else 16) * evals
        b_ms, b_by = bound_ms(nbytes, ops)
        out[f"probe_{v}"] = dict(max_abs_err=errs[v], ms=ms,
                                 plain_ms=plain[v], bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
    for v in gc.PROBE_VARIANTS:
        e = out[f"probe_{v}"]
        log(f"P1 {v:8s} on the captured RGCA frame: {e['ms']:.4f} ms "
            f"({e['ms'] / out['probe_full']['ms']:.3f} of full), plain "
            f"{e['plain_ms']:.4f} ms, bound {e['bound_ms']:.4f} ms by "
            f"{e['bound_by']} on {card_line}")
    gc.reset_launch_counts()
    probe_kernel.main()
    torch.cuda.synchronize()
    launches = dict(gc.LAUNCHES)
    log(f"probe_kernel launches: {launches}")
    if not all(launches[f"probe_{v}"] for v in gc.PROBE_VARIANTS):
        raise AssertionError("probe_kernel did not launch every variant")
    # the variants against their plain versions at probe_kernel's shapes,
    # at its smallest chunk (the most blocks per tile)
    p_chunk = min(probe_kernel.CHUNKS)
    scene = probe_kernel.build_scene()
    p_rows, p_cnt, pkw = probe_kernel.replay_inputs(
        *scene, probe_kernel.H, probe_kernel.W, probe_kernel.TS, p_chunk,
        probe_kernel.MAX_PAIRS)
    p1_variants_check(gc, torch, p_rows, scene[1], scene[2], p_cnt, pkw,
                      f"probe_kernel's scene (chunk {p_chunk})")
    return launches, out


# ---------------------------------------------------------------------------
# parallel/: the band and slab renders and the data-parallel step
# ---------------------------------------------------------------------------

SHARDS = 4               # bands, slabs and data shards, all on one card
SHARD_EVAL_FRAMES = 3
SHARD_TRAIN_STEPS = 3
SHARD_2D_STEPS = 2
SHARD_2D = (2, 2)        # ("data", "tile")
SHARD_DIFF = 2e-5        # the pixels beyond this are counted
DRYRUN_SHARDS = 4
DRYRUN_LIGHTS = 2        # the dry run's URHand fixture
DRYRUN_TEACHER_LIGHTS = 2  # the dry run's MVP fixture (its data's lights)


def shard_mesh(shape, names):
    """A mesh of ``shape`` shards, every one on the card."""
    import numpy as np

    from goliath_torch.parallel.sharding import Mesh

    devs = np.empty(shape, dtype=object)
    devs.fill(DEVICE)
    return Mesh(devs, names)


class RenderTap:
    """Keeps, while it is entered, what the renders of a run give and take:
    the outputs of every gsplat.render call (rgb and T, on the card), the
    arguments of the first call, the pairs each binning wanted (the sum of
    the first of its two K4 scans) and, for the first ``keep`` binnings,
    their two K4 inputs and their compositor arguments."""

    def __init__(self, keep=0):
        self.keep = keep
        self.outputs, self.first_call, self.wanted = [], None, []
        self.k4, self.k1 = [], []

    def __enter__(self):
        from goliath_torch.ops import binning, gsplat, gsplat_cuda

        self._orig = (gsplat.render, binning.cumsum1d,
                      gsplat_cuda.rasterize_tiled)
        render, cumsum, raster = self._orig
        scans = []

        def tap_render(*a, **kw):
            if self.first_call is None:
                self.first_call = (a, dict(kw))
            out = render(*a, **kw)
            self.outputs.append((out["render"].detach(),
                                 out["final_T"].detach()))
            return out

        def tap_cumsum(x):
            if len(scans) % 2 == 0:
                self.wanted.append(int(x.long().sum()))
            if len(scans) < 2 * self.keep:
                self.k4.append(x.clone())
            scans.append(None)
            return cumsum(x)

        def tap_raster(*a, **kw):
            if len(self.k1) < self.keep:
                self.k1.append(a)
            return raster(*a, **kw)

        gsplat.render, binning.cumsum1d = tap_render, tap_cumsum
        gsplat_cuda.rasterize_tiled = tap_raster
        return self

    def __exit__(self, *exc):
        from goliath_torch.ops import binning, gsplat, gsplat_cuda

        (gsplat.render, binning.cumsum1d,
         gsplat_cuda.rasterize_tiled) = self._orig


def frame_difference(got, ref):
    """(max |rgb| difference, max |T| difference, share of pixels whose rgb
    or T differs by more than SHARD_DIFF) of two renders' (rgb, T)."""
    d_rgb = (got[0] - ref[0]).abs()
    d_T = (got[1] - ref[1]).abs()
    beyond = (d_rgb.amax(dim=1, keepdim=True) > SHARD_DIFF) | (
        d_T > SHARD_DIFF)
    return float(d_rgb.max()), float(d_T.max()), float(beyond.float().mean())


def dropped(wanted, budget):
    return [max(0, w - budget) for w in wanted]


def tile_shard_eval(gc, torch, card_line, captured):
    """(a) run_test.main on configs/rgca.yml at full width (the main path's
    data and frames) with model.render.tile_shard_mesh a "tile" mesh of
    SHARDS shards on the card: each frame binned and composited in SHARDS
    bands of 512 rows (16 tile rows of 64 tiles), each with its pair budget
    of round(3 N / SHARDS) = 786,432; counts reset just before and read
    just after (K1 once and K4 twice a band and frame, nothing else); then
    the same frames unsharded. Per frame: the wall time of both, the
    sharded frame's difference from the unsharded one and the pairs each
    band's budget dropped (and the unsharded render's). Keeps frame 0's
    band with the most pairs for K1 and its bands' K4 scans in
    ``captured``, and the unsharded frame 0's render arguments."""
    import inspect

    from goliath_torch.config import load_config
    from goliath_torch.parallel.tile_shard import (
        band_geometry,
        render_tile_sharded,
    )
    from goliath_torch.scripts import run_test

    def config(mesh):
        cfg = load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
            f"test.data={yaml_flow(FULL_DATA)}", "test.ckpt=null",
            f"test.n_test_frames={SHARD_EVAL_FRAMES}", "test.vis_path=null"])
        if mesh is not None:
            cfg.model.render.update(tile_shard_mesh=mesh,
                                    tile_shard_axis="tile")
        return cfg

    cfg = config(shard_mesh((SHARDS,), ("tile",)))
    r = cfg.model.render
    N = cfg.model.uv_size ** 2      # one Gaussian a texel of the uv slab
    max_tiles = r.get("max_tiles_per_prim", inspect.signature(
        render_tile_sharded).parameters["max_tiles_per_prim"].default)
    ntx, band_nty, band_h, band_budget = band_geometry(
        FULL_DATA["img_w"], FULL_DATA["img_h"], r.tile_size, SHARDS, N,
        r.pair_budget_mult, max_tiles)
    full_budget = int(round(r.pair_budget_mult * N))
    log(f"tile_shard_eval: {SHARDS} bands of {band_h} rows ({band_nty} tile "
        f"rows of {ntx}), a band's pair budget {band_budget} against the "
        f"single render's {full_budget}")
    frames = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RenderTap(keep=SHARDS) as tap:
        gc.reset_launch_counts()
        means = run_test.main(cfg, device=DEVICE, frame_seconds=frames)
        torch.cuda.synchronize()
        launches = dict(gc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ref_frames = []
    torch.cuda.reset_peak_memory_stats()
    with RenderTap() as ref_tap:
        ref_means = run_test.main(config(None), device=DEVICE,
                                  frame_seconds=ref_frames)
        torch.cuda.synchronize()
    ref_peak = torch.cuda.max_memory_allocated()
    log(f"tile_shard_eval launches: {launches}")
    log(f"tile_shard_eval means: {json.dumps(means)}; unsharded "
        f"{json.dumps(ref_means)}")
    report = []
    for i in range(SHARD_EVAL_FRAMES):
        diff = frame_difference(tap.outputs[i], ref_tap.outputs[i])
        band_drops = dropped(tap.wanted[SHARDS * i:SHARDS * (i + 1)],
                             band_budget)
        full_drops = dropped(ref_tap.wanted[i:i + 1], full_budget)
        report.append(dict(frame=i, seconds=frames[i],
                           unsharded_seconds=ref_frames[i],
                           max_abs_rgb=diff[0], max_abs_T=diff[1],
                           share_beyond=diff[2],
                           band_pairs=tap.wanted[SHARDS * i:SHARDS * (i + 1)],
                           band_dropped=band_drops,
                           unsharded_pairs=ref_tap.wanted[i],
                           unsharded_dropped=full_drops[0]))
        log(f"tile_shard_eval frame {i}: wall {frames[i]:.4f} s (unsharded "
            f"{ref_frames[i]:.4f} s) on {card_line}; against the unsharded "
            f"frame max |rgb| {diff[0]:.3e}, max |T| {diff[1]:.3e}, share "
            f"of pixels beyond {SHARD_DIFF} {diff[2]:.6f}; pairs wanted by "
            f"band {tap.wanted[SHARDS * i:SHARDS * (i + 1)]}, dropped by "
            f"each band's budget {band_drops}; unsharded wanted "
            f"{ref_tap.wanted[i]}, dropped {full_drops[0]}")
    log(f"tile_shard_eval peak device memory: {peak / 2**30:.3f} GiB "
        f"(unsharded {ref_peak / 2**30:.3f} GiB) on {card_line}")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(compositor_fwd=SHARDS * SHARD_EVAL_FRAMES,
                cumsum1d=2 * SHARDS * SHARD_EVAL_FRAMES)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not all(math.isfinite(v) for v in means.values()):
        raise AssertionError("tile_shard_eval: a loss is not finite")
    if len(frames) != SHARD_EVAL_FRAMES or len(tap.outputs) != len(frames):
        raise AssertionError("tile_shard_eval: frames missing")
    pairs = [int((a[7] - a[6]).sum()) for a in tap.k1]
    captured["k1"] = tap.k1[pairs.index(max(pairs))]
    captured["k4"] = tap.k4
    captured["render_args"] = ref_tap.first_call
    captured["render_out"] = ref_tap.outputs[0]
    captured["report"] = report
    return launches


def check_k1_band(gc, torch, args):
    """K1 against its plain version (check_k1's tolerances) on frame 0's
    busiest band of the tile_shard_eval path."""
    log(f"K1 on a band of tile_shard_eval (frame 0; img_h {args[11]}, "
        f"{args[16]} x {args[17]} tiles):")
    return check_k1(gc, torch, args, {})


def prim_shard_eval(gc, torch, card_line, captured):
    """(b) render_prim_sharded over a "slab" mesh of SHARDS shards on the
    card, on the unsharded frame 0's render arguments of tile_shard_eval
    (1,048,576 Gaussians: SHARDS slabs of 262,144, each with its own pair
    budget), counts reset just before and read just after (K1 once and K4
    twice a slab); its difference from the unsharded frame, the pairs each
    slab's budget dropped, and both renders' times."""
    from goliath_torch.ops import gsplat
    from goliath_torch.parallel.tile_shard import render_prim_sharded

    args, kw = captured["render_args"]
    kw = {k: v for k, v in kw.items()
          if k not in ("tile_shard_mesh", "tile_shard_axis")}
    mesh = shard_mesh((SHARDS,), ("slab",))
    N = args[4].shape[1]
    slab = -(-N // SHARDS)
    budget = int(round(kw["pair_budget_mult"] * slab))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), RenderTap() as tap:
        gc.reset_launch_counts()
        t0 = time.perf_counter()
        out = render_prim_sharded(mesh, "slab", *args, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(gc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        t0 = time.perf_counter()
        gsplat.render(*args, **kw)
        torch.cuda.synchronize()
        ref_seconds = time.perf_counter() - t0
    diff = frame_difference((out["render"], out["final_T"]),
                            captured["render_out"])
    slab_drops = dropped(tap.wanted, budget)
    log(f"prim_shard_eval launches: {launches}")
    log(f"prim_shard_eval: {SHARDS} slabs of {slab} of {N} Gaussians, a "
        f"slab's pair budget {budget}; render {seconds:.4f} s (unsharded "
        f"{ref_seconds:.4f} s) on {card_line}; against the unsharded frame "
        f"max |rgb| {diff[0]:.3e}, max |T| {diff[1]:.3e}, share of pixels "
        f"beyond {SHARD_DIFF} {diff[2]:.6f}; pairs wanted by slab "
        f"{tap.wanted}, dropped by each slab's budget {slab_drops}; peak "
        f"{peak / 2**30:.3f} GiB")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(compositor_fwd=SHARDS, cumsum1d=2 * SHARDS)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not (torch.isfinite(out["render"]).all()
            and torch.isfinite(out["final_T"]).all()):
        raise AssertionError("prim_shard_eval: the render is not finite")
    captured["prim_report"] = dict(
        seconds=seconds, unsharded_seconds=ref_seconds, max_abs_rgb=diff[0],
        max_abs_T=diff[1], share_beyond=diff[2], slab_pairs=tap.wanted,
        slab_dropped=slab_drops)
    return launches


def shard_train_batches(ds, torch, n, batch):
    """``n`` batches of ``batch`` samples of ``ds`` in index order, on the
    card (strings dropped)."""
    import numpy as np

    from goliath_torch.test import to_device

    out = []
    for i in range(n):
        samples = [ds[(i * batch + j) % len(ds)] for j in range(batch)]
        out.append(to_device({k: np.stack([s[k] for s in samples])
                              for k in samples[0]
                              if not isinstance(samples[0][k], str)},
                             torch.device(DEVICE)))
    return out


def hold_sharded_step(got, ref, spread, label):
    """One sharded step (``got``: its loss, per-parameter gradients after
    the optimizer's scrub and clip, and parameters after the update)
    against the unsharded step from the same state (``ref``). Gradients
    at rtol SMALL_RTOL plus SMALL_RTOL of each one's largest |ref| entry,
    or else that plus SPREAD_MULT times its spread under one-ulp moves of
    the state (``spread()``, measured on first need; at full width the
    render's alpha and early-out thresholds make a dozen of the decoder's
    gradients move by percents under such moves, so their number is
    reported, not capped). Parameters: the norm over all of them at rtol
    SMALL_RTOL (as tests/test_parallel.py holds the JAX sharded step), and
    every entry whose gradients agree within rtol SMALL_RTOL at rtol
    SMALL_RTOL plus SMALL_RTOL of its tensor's largest entry. The other
    entries, which the gradient rule holds through its absolute term only,
    are counted, not held: Adam's update does not see a gradient's scale
    (lr g / (|g| + eps) on a first step), so it moves them by up to lr
    whatever their size. Returns (the gradients that needed the spread,
    the entries not held, their largest parameter difference)."""
    need, loose, worst_loose, sq_got, sq_ref = [], 0, 0.0, 0.0, 0.0
    for name, r in ref["grads"].items():
        g = got["grads"][name]
        scale = float(r.abs().max())
        diff = (g - r).abs()
        usual = SMALL_RTOL * r.abs() + SMALL_RTOL * scale
        if not bool((diff <= usual).all()):
            moves = spread()
            note = (f"{name} (error {float(diff.max()) / scale:.3e}, spread "
                    f"{moves[name] / scale:.3e} of its largest entry)")
            need.append(note)
            if not bool((diff <= usual + SPREAD_MULT * moves[name]).all()):
                raise AssertionError(f"{label}: gradient {note} is beyond "
                                     f"the rule")
        p, pr = got["params"][name], ref["params"][name]
        sq_got += float(p.double().square().sum())
        sq_ref += float(pr.double().square().sum())
        held = diff <= SMALL_RTOL * r.abs()
        loose += int((~held).sum())
        if not bool(held.all()):
            worst_loose = max(worst_loose,
                              float((p - pr).abs()[~held].max()))
        bad = held & ((p - pr).abs() > SMALL_RTOL * pr.abs()
                      + SMALL_RTOL * float(pr.abs().max()))
        if bool(bad.any()):
            raise AssertionError(f"{label}: {int(bad.sum())} entries of "
                                 f"{name} differ beyond the rule")
    if abs(sq_got ** 0.5 - sq_ref ** 0.5) > SMALL_RTOL * sq_ref ** 0.5:
        raise AssertionError(f"{label}: the parameters' norm is "
                             f"{sq_got ** 0.5}, unsharded {sq_ref ** 0.5}")
    return need, loose, worst_loose


class KernelArgsTap:
    """Keeps in ``store`` (when one is given) the arguments of the first
    K2 and the first K3 call made while it is entered, copied."""

    def __init__(self, gc, store):
        self.gc, self.store = gc, store

    def __enter__(self):
        if self.store is None:
            return self
        gc, store = self.gc, self.store
        self._orig = gc.pair_grads, gc.cumsum_cols

        def keep(name, fn):
            def wrapped(*a, **kw):
                if name not in store:
                    store[name] = (tuple(x.clone() if hasattr(x, "clone")
                                         else x for x in a), dict(kw))
                return fn(*a, **kw)
            return wrapped

        gc.pair_grads = keep("k2", self._orig[0])
        gc.cumsum_cols = keep("k3", self._orig[1])
        return self

    def __exit__(self, *exc):
        if self.store is not None:
            self.gc.pair_grads, self.gc.cumsum_cols = self._orig


def band_train_kernels(gc, torch, captured, card_line):
    """K2 (with the step's own upstream gradients) and K3 against their
    plain versions on the arguments of the first band of sharded_train's
    first 2-D step, at the tolerances of the earlier phases; both timed
    there."""
    from goliath_torch.utils.timing import cuda_ms

    (ba, bkw), (ca, _) = captured["k2"], captured["k3"]
    (x,) = ca
    got = gc.pair_grads(*ba, **bkw)
    ref = gc.pair_grads_plain(*ba, **bkw)
    torch.cuda.synchronize()
    C = ba[4].shape[-3]
    H, W = ba[6].shape[-2:]
    err_b = compare_pair_grads(gc, torch, got, ref, C,
                               f"K2, a {W}x{H} band of the 2-D step")
    check_same_bits(torch, got, gc.pair_grads(*ba, **bkw), "K2 (band)")
    k3 = gc.cumsum_cols(x)
    ref3 = torch.cumsum(x.double(), dim=1)
    f32 = gc.cumsum_cols_plain(x)
    torch.cuda.synchronize()
    scale = ref3.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    e64 = float(((k3.double() - ref3).abs() / scale).max())
    e32 = float(((k3 - f32).abs().double() / scale).max())
    del ref3, scale
    log(f"K3 band {list(x.shape)}: error as a fraction of each row's "
        f"largest running sum: against a float64 scan {e64:.3e} "
        f"(tolerance {K3_TOL_F64}), against torch.cumsum float32 {e32:.3e} "
        f"(tolerance {K3_TOL_F32})")
    if not (e64 <= K3_TOL_F64 and e32 <= K3_TOL_F32):
        raise AssertionError("K3 differs on the band")
    check_same_bits(torch, k3, gc.cumsum_cols(x), "K3 (band)")
    ms2 = cuda_ms(lambda: gc.pair_grads(*ba, **bkw), reps=10)
    ms3 = cuda_ms(lambda: gc.cumsum_cols(x), reps=50)
    log(f"band kernels of the 2-D step: K2 {ms2:.4f} ms, K3 {list(x.shape)} "
        f"{ms3:.4f} ms on {card_line}")
    return dict(k2_err=err_b, k2_ms=ms2, k3_err=e64, k3_ms=ms3)


def full_width_training(torch, n_steps):
    """(model, loss, optimizer, batches, largest lr) of configs/rgca.yml
    at full width (FULL_DATA), the model on the card with weights and
    draws from seed 0, and ``n_steps`` batches of TRAIN_BATCH on the
    card."""
    from goliath_torch.config import load_from_config
    from goliath_torch.optim import build_optimizer
    from goliath_torch.scripts.run_train import build_dataset

    cfg = rgca_config()
    if cfg.dataloader.batch_size != TRAIN_BATCH:
        raise AssertionError("the config no longer trains at batch 4")
    dev = torch.device(DEVICE)
    ds = build_dataset(cfg.data, device=dev)
    model = load_from_config(cfg.model, assets=ds.static_assets, device=dev,
                             generator=torch.Generator().manual_seed(0))
    loss_fn = load_from_config(cfg.loss, assets=ds.static_assets)
    opt_cfg = dict(cfg.optimizer)
    opt_cfg.setdefault("lr", cfg.get("lr", 1e-3))
    optimizer = build_optimizer(opt_cfg, model.module)
    lr = max(g["lr"] for g in optimizer.inner.param_groups)
    batches = shard_train_batches(ds, torch, n_steps, TRAIN_BATCH)
    return model, loss_fn, optimizer, batches, lr


def train_snapshot(module, optimizer):
    """The training state a step changes: the module's state_dict, the
    optimizer's state and the training draws' generator (None where the
    module has none), copied."""
    import copy

    gen = getattr(module, "generator", None)
    return ({k: v.clone() for k, v in module.state_dict().items()},
            copy.deepcopy(optimizer.state_dict()),
            None if gen is None else gen.get_state())


def train_restore(module, optimizer, snap, params=None):
    """Puts back ``snap`` (``train_snapshot``), with ``params`` in place of
    its state_dict when given."""
    import copy

    module.load_state_dict(params or snap[0])
    optimizer.load_state_dict(copy.deepcopy(snap[1]))
    if snap[2] is not None:
        module.generator.set_state(snap[2])


def sync_cards(torch, cards):
    for c in cards:
        torch.cuda.synchronize(c)


def take_step(gc, torch, module, step, batch, i, cards=(0,), tap=None):
    """One step: its wall (ending in a synchronise of every card of
    ``cards``), loss, gradients, parameters after it, its launches in all
    and on each card, and each card's peak memory above what it held
    before the step (``peak``: the largest of them)."""
    resident = {}
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
        resident[c] = torch.cuda.memory_allocated(c)
    before = dict(gc.LAUNCHES)
    before_card = {c: dict(v) for c, v in gc.CARD_LAUNCHES.items()}
    t0 = time.perf_counter()
    with KernelArgsTap(gc, tap):
        total, _ = step(dict(batch), i)
    sync_cards(torch, cards)
    seconds = time.perf_counter() - t0
    peaks = {c: torch.cuda.max_memory_allocated(c) - resident[c]
             for c in cards}
    return dict(
        seconds=seconds, total=float(total), peaks=peaks,
        peak=max(peaks.values(), default=0),
        grads={n: p.grad.detach().clone()
               for n, p in module.named_parameters()},
        params={n: p.detach().clone() for n, p in module.named_parameters()},
        launches={k: gc.LAUNCHES[k] - before[k] for k in before},
        card_launches={c: {k: v - before_card.get(c, {}).get(k, 0)
                           for k, v in n.items()}
                       for c, n in gc.CARD_LAUNCHES.items()})


def check_replicas(step, model, before, label):
    """Every replica of a sharded step holds, bit for bit, the parameters
    the step ran with (``before``: the module's state_dict before the
    step, which copies them in first) and the model's buffers after it (a
    buffer that a replica's forward moved would differ)."""
    from goliath_torch.parallel.sharding import replica_mismatches

    module = model.module
    want = {n: before[n] for n, _ in module.named_parameters()}
    want.update(module.named_buffers())
    for dev, replica in step.replicas.items():
        bad = replica_mismatches(want, replica)
        if bad:
            raise AssertionError(f"{label}: the replica on {dev} differs "
                                 f"from the model in {bad[:8]}")


def held_sharded_steps(gc, torch, card_line, model, optimizer, sharded,
                       reference, batches, label, lr, cards=(0,),
                       elsewhere=(), ref_name="unsharded", unsharded=None):
    """One step of ``sharded`` per batch, each held (hold_sharded_step)
    against ``reference`` from the same state (parameters, the optimizer's
    state, the generator) and batch, the replicas checked after it
    (check_replicas); the model is left in the sharded step's state. A
    gradient's spread is measured on the reference alone, on first need:
    its largest move under one-ulp moves of the state (SHARD_SPREAD_SEEDS),
    over REFERENCE_RERUNS reruns from the same state (the card's atomic sums
    are not bit-reproducible), and against each of ``elsewhere``: fn(i)
    computes the reference's gradients from the same state on another
    device. With ``unsharded``, that step too runs from the same state, for
    its wall and loss. Returns (sharded runs, reference runs, unsharded
    runs, the gradients that needed their spread, the entries not held)
    per step; the runs keep their wall, loss, peaks and launches."""
    module = model.module
    n_entries = sum(p.numel() for p in module.parameters())
    got, ref, plain, needs, loose = [], [], [], [], []
    for i, batch in enumerate(batches):
        snap = train_snapshot(module, optimizer)
        if unsharded is not None:
            plain.append(take_step(gc, torch, module, unsharded, batch, i,
                                   cards))
            del plain[i]["grads"], plain[i]["params"]
            train_restore(module, optimizer, snap)
        ref.append(take_step(gc, torch, module, reference, batch, i, cards))
        train_restore(module, optimizer, snap)
        got.append(take_step(gc, torch, module, sharded, batch, i, cards))
        check_replicas(sharded, model, snap[0], f"{label} step {i}")
        after = train_snapshot(module, optimizer)
        moves = {}

        def spread(snap=snap, i=i, moves=moves, batch=batch):
            if moves:
                return moves
            base = ref[i]["grads"]
            moves.update((n, 0.0) for n in base)

            def widen(grads):
                for n, g in grads.items():
                    moves[n] = max(moves[n], float(
                        (g.to(base[n].device) - base[n]).abs().max()))

            for seed in SHARD_SPREAD_SEEDS:
                gen = torch.Generator().manual_seed(seed)
                train_restore(module, optimizer, snap, {
                    k: v * (1 + 1e-7 * torch.randn(
                        v.shape, generator=gen).to(v.device))
                    if v.is_floating_point() else v
                    for k, v in snap[0].items()})
                widen(take_step(gc, torch, module, reference, batch, i,
                                cards)["grads"])
            for _ in range(REFERENCE_RERUNS):
                train_restore(module, optimizer, snap)
                widen(take_step(gc, torch, module, reference, batch, i,
                                cards)["grads"])
            for fn in elsewhere:
                train_restore(module, optimizer, snap)
                widen(fn(i))
            return moves

        need, n_loose, worst_loose = hold_sharded_step(
            got[i], ref[i], spread, f"{label} step {i}")
        train_restore(module, optimizer, after)
        for r in (got[i], ref[i]):
            del r["grads"], r["params"]
        needs.append(need)
        loose.append(n_loose)
        also = (f", unsharded {plain[i]['seconds']:.4f} s, loss "
                f"{plain[i]['total']:.6f}" if plain else "")
        log(f"{label} step {i}: wall {got[i]['seconds']:.4f} s ({ref_name} "
            f"{ref[i]['seconds']:.4f} s), loss {got[i]['total']:.6f} "
            f"({ref_name} {ref[i]['total']:.6f}{also}); gradients that need "
            f"their spread beyond rtol {SMALL_RTOL} + {SMALL_RTOL} of the "
            f"largest entry: {need}; parameter entries whose gradients "
            f"differ by more than rtol {SMALL_RTOL} (not held): {n_loose} of "
            f"{n_entries}, their largest parameter difference "
            f"{worst_loose:.3e} ({worst_loose / lr:.3f} lr) on {card_line}")
    return got, ref, plain, needs, loose


def sharded_train(gc, torch, card_line, captured):
    """(c) make_sharded_train_step at full width (configs/rgca.yml on
    FULL_DATA, weights and draws from seed 0, batch 4): SHARD_TRAIN_STEPS
    steps on a "data" mesh of SHARDS shards on the card (K1, K2, K3 once a
    sample and step, K4 twice), each held (hold_sharded_step) against
    train.make_train_step from the same state (parameters, Adam's moments,
    the generator) and batch; then SHARD_2D_STEPS steps from the initial
    state on a 2-D ("data", "tile") mesh of SHARD_2D with the model's
    render on the same mesh (K1, K2, K3 once and K4 twice a band and
    sample), its losses beside the unsharded chain's (the per-band pair
    budgets make it another render where pairs overflow: reported, not
    held). The card's forward and backward are not bit-reproducible
    (atomic sums), so a gradient's spread also takes reruns of the
    unsharded step from the same state. Step walls and peak memory of each;
    keeps the first band's K2 and K3 arguments of the first 2-D step in
    ``captured``."""
    from goliath_torch import train as train_lib
    from goliath_torch.parallel import make_sharded_train_step

    model, loss_fn, optimizer, batches, lr = full_width_training(
        torch, SHARD_TRAIN_STEPS)
    module = model.module
    data_mesh = shard_mesh((SHARDS,), ("data",))
    sharded = make_sharded_train_step(model, loss_fn, optimizer, data_mesh)
    unsharded = train_lib.make_train_step(model, loss_fn, optimizer)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    state0 = train_snapshot(module, optimizer)
    n_entries = sum(p.numel() for p in module.parameters())
    got, ref, _, needs, loose = held_sharded_steps(
        gc, torch, card_line, model, optimizer, sharded, unsharded, batches,
        f"sharded_train data x{SHARDS}", lr)

    train_restore(module, optimizer, state0)
    mesh2 = shard_mesh(SHARD_2D, ("data", "tile"))
    module.render_cfg.update(tile_shard_mesh=mesh2, tile_shard_axis="tile")
    two_d_step = make_sharded_train_step(model, loss_fn, optimizer, mesh2)
    two_d = []
    try:
        for i in range(SHARD_2D_STEPS):
            two_d.append(take_step(gc, torch, module, two_d_step, batches[i],
                                   i, tap=captured if i == 0 else None))
    finally:
        module.render_cfg.pop("tile_shard_mesh")
        module.render_cfg.pop("tile_shard_axis")
    peaks = {label: max(r["peak"] for r in runs) / 2**30
             for label, runs in (("unsharded", ref), ("data", got),
                                 ("two_d", two_d))}
    rel = [abs(g["total"] - r["total"]) / abs(r["total"])
           for g, r in zip(got, ref)]
    rel2 = [abs(g["total"] - r["total"]) / abs(r["total"])
            for g, r in zip(two_d, ref)]
    log(f"sharded_train data x tile {SHARD_2D}: walls "
        f"{[round(r['seconds'], 4) for r in two_d]} s, losses "
        f"{[r['total'] for r in two_d]}, against the unsharded chain's "
        f"{[r['total'] for r in ref[:SHARD_2D_STEPS]]}: rel diff "
        f"{[f'{r:.3e}' for r in rel2]} (per-band pair budgets; reported, "
        f"not held)")
    log(f"sharded_train peak device memory of a step (batch {TRAIN_BATCH}) "
        f"above the model, Adam's moments and this check's copies: "
        f"unsharded {peaks['unsharded']:.3f}, data x{SHARDS} "
        f"{peaks['data']:.3f}, data x tile {SHARD_2D} {peaks['two_d']:.3f} "
        f"GiB ({n_entries * 4 / 2**30:.3f} GiB of parameters) on "
        f"{card_line}")

    def total_launches(runs):
        return {k: sum(r["launches"][k] for r in runs) for k in gc.LAUNCHES}

    data_l, two_d_l = total_launches(got), total_launches(two_d)
    n = TRAIN_BATCH * SHARD_TRAIN_STEPS
    n2 = TRAIN_BATCH * SHARD_2D_STEPS * SHARD_2D[1]
    for label, have, k in (("data mesh", data_l, n), ("2-D mesh", two_d_l,
                                                      n2)):
        want = {name: 0 for name in gc.LAUNCHES}
        want.update(compositor_fwd=k, pair_grads=k, cumsum_cols=k,
                    cumsum1d=2 * k)
        log(f"sharded_train {label} launches: {have}")
        if have != want:
            raise AssertionError(f"{label}: launch counts {have} != {want}")
    totals = [r["total"] for r in got + two_d]
    if not all(math.isfinite(v) for v in totals):
        raise AssertionError("sharded_train: a loss is not finite")
    if max(rel) > SMALL_RTOL:
        raise AssertionError(f"sharded_train: losses rel diff {rel}")
    if two_d[-1]["total"] == two_d[0]["total"]:
        raise AssertionError("sharded_train: the 2-D mesh's loss did not "
                             "move")
    launches = {k: data_l[k] + two_d_l[k] for k in gc.LAUNCHES}
    return launches, dict(
        data=data_l, two_d=two_d_l,
        seconds=[r["seconds"] for r in got],
        unsharded_seconds=[r["seconds"] for r in ref],
        two_d_seconds=[r["seconds"] for r in two_d],
        peak_gib=peaks, loss_rel=rel,
        two_d_loss_rel=rel2, need_spread=[len(n) for n in needs],
        loose_entries=loose)


def family_launches(name, samples):
    """The launches of one training step of the dry run's family ``name``
    over ``samples`` samples on the card: RGCA (the XLA window) K1, K2, K3
    once and K4 twice a sample; the MVP hand and the teacher K4 twice a
    sample (their marches run under autograd: no K8), the teacher K9 once a
    light and sample (its shadows take no gradient); URHand K5 2L + 3 times
    a sample (its light views and renders), K4 twice each; mesh_vae K5 once
    and K4 twice a sample."""
    k5 = 2 * DRYRUN_LIGHTS + 3
    per = {"rgca": dict(compositor_fwd_xla=1, pair_grads_xla=1,
                        cumsum_cols=1, cumsum1d=2),
           "hand_mvp": dict(cumsum1d=2),
           "hand_teacher": dict(cumsum1d=2,
                                shadow_integral=DRYRUN_TEACHER_LIGHTS),
           "urhand": dict(zbuffer=k5, cumsum1d=2 * k5),
           "mesh_vae": dict(zbuffer=1, cumsum1d=2)}[name]
    return {k: v * samples for k, v in per.items()}


def splat_launches(trained, forward_only=0):
    """The launches of ``trained`` per-sample renders of the dry run's tile
    axis under autograd (K1, K2, K3 once and K4 twice each, the XLA
    window) and ``forward_only`` without it (K1 once and K4 twice)."""
    n = trained + forward_only
    return dict(compositor_fwd_xla=n, pair_grads_xla=trained,
                cumsum_cols=trained, cumsum1d=2 * n)


def add_launches(*parts):
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = out.get(k, 0) + v
    return out


def dryrun_expected(n):
    """The dry run's launches at ``n`` shards: one step of each family at
    batch max(n, 2) (``family_launches``); the tile axis K1 once a band
    and sample and once a sample for the unsharded render, K2 and K3 once
    a band and sample, K4 twice a render (``splat_launches``)."""
    from goliath_torch.scripts.dryrun_multichip import FAMILIES, TILE_AXIS

    b = max(n, 2)
    n_tile = 4 if n % 4 == 0 else 2
    return add_launches(
        *(family_launches(name, b) for name in FAMILIES),
        splat_launches(n_tile * TILE_AXIS["B"], TILE_AXIS["B"]))


def dryrun_path(gc, torch, card_line):
    """(d) goliath_torch.scripts.dryrun_multichip.main at DRYRUN_SHARDS
    shards on the card: one sharded step of each family at the JAX dry
    run's tiny shapes, the tile axis on its 2-D mesh against the unsharded
    render; counts reset just before and read just after (dryrun_expected,
    exactly)."""
    from goliath_torch.scripts import dryrun_multichip

    torch.cuda.synchronize()
    gc.reset_launch_counts()
    t0 = time.perf_counter()
    losses = dryrun_multichip.main(DRYRUN_SHARDS, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(gc.LAUNCHES)
    log(f"dryrun launches: {launches}; losses {json.dumps(losses)}; "
        f"{seconds:.1f} s on {card_line}")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(dryrun_expected(DRYRUN_SHARDS))
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches


# ---------------------------------------------------------------------------
# parallel/ across distinct devices: the card and the host on every
# machine, every visible card where there are two or more
# ---------------------------------------------------------------------------

CROSS_BATCH = 2          # the dry run's batch at 2 shards: a sample a device
MULTI_CARD_STEPS = 3


def card_counts(by_card):
    """{card: {kernel: launches}} (gsplat_cuda.CARD_LAUNCHES, or a step's
    ``card_launches``) with the kernels and cards that launched nothing
    left out."""
    return {c: {k: v for k, v in n.items() if v}
            for c, n in by_card.items() if any(n.values())}


def expect_on_cards(devices, per_shard):
    """{card: launches} when each shard on a card launches
    ``per_shard``'s counts (the host's shards launch nothing)."""
    out = {}
    for d in devices:
        if d.type == "cuda":
            out[d.index] = add_launches(out.get(d.index, {}), {
                k: v for k, v in per_shard.items() if v})
    return out


def unbanded(render_cfg, bands, step):
    """``step`` run with ``bands``' keys taken out of ``render_cfg`` (the
    model's render unbanded), then put back."""
    def run(batch, i):
        for k in bands:
            render_cfg.pop(k)
        try:
            return step(batch, i)
        finally:
            render_cfg.update(bands)
    return run


def cross_device_family(gc, torch, name, devices, card_line="", rows=None):
    """One step of the dry run's family ``name`` at its shapes, held
    (held_sharded_steps, the replicas checked bit for bit after it)
    against train.make_train_step on the model's device from the same
    state and batch. The mesh is "data" over ``devices`` at batch
    CROSS_BATCH; or, with ``rows`` (RGCA), ("data", "tile") over those
    rows at a batch of one sample a mesh position (the batch must divide
    by the mesh's size to be split), with the model's render banded over
    the mesh: each data shard (the rows' first column) renders its bands
    on its own row, and the reference renders unbanded. The model lies on
    the first data shard's device, a replica on each other. Besides
    hold_sharded_step's one-ulp moves and reruns of the reference, where
    the mesh holds the host a gradient's spread takes the reference's
    distance from the same step on the host (the family built there with
    the model's state: its plain versions against the kernels). Each card
    launches family_launches for each sample of a data shard whose band or
    shard it holds, exactly. Returns (each card's launches, the step's
    report)."""
    from goliath_torch import train as train_lib
    from goliath_torch.parallel import make_sharded_train_step
    from goliath_torch.parallel.sharding import Mesh
    from goliath_torch.scripts import dryrun_multichip as dr

    if rows is None:
        mesh = Mesh([torch.device(d) for d in devices], ("data",))
        n_batch = CROSS_BATCH
    else:
        mesh = Mesh([[torch.device(d) for d in r] for r in rows],
                    ("data", "tile"))
        n_batch = mesh.size
    data = mesh.axis_devices("data")
    everywhere = list(mesh.devices.flat)
    home, host = data[0], torch.device("cpu")
    cards = sorted({d.index for d in everywhere if d.type == "cuda"})
    ds, model, batch = dr.build_family(name, n_batch, home)
    loss_fn, optimizer = dr.family_loss_and_optimizer(name, ds, model)
    batch = {k: torch.as_tensor(v).to(home) for k, v in batch.items()}
    module = model.module
    unsharded = train_lib.make_train_step(model, loss_fn, optimizer)
    if rows is not None:
        bands = dict(tile_shard_mesh=mesh, tile_shard_axis="tile")
        # set before the step is made: its replicas copy the render's
        # settings
        module.render_cfg.update(bands)
        unsharded = unbanded(module.render_cfg, bands, unsharded)
    sharded = make_sharded_train_step(model, loss_fn, optimizer, mesh)

    def on_host(i):
        """The reference's gradients on the host: the family built there
        with the model's state and generator, a fresh optimizer (the
        family's first step)."""
        _, host_model, _ = dr.build_family(name, n_batch, host)
        host_model.module.load_state_dict(
            {k: v.to(host) for k, v in module.state_dict().items()})
        if getattr(module, "generator", None) is not None:
            host_model.module.generator.set_state(module.generator.get_state())
        h_loss, h_opt = dr.family_loss_and_optimizer(name, ds, host_model)
        train_lib.make_train_step(host_model, h_loss, h_opt)(
            {k: v.to(host) for k, v in batch.items()}, i)
        return {n: p.grad for n, p in host_model.module.named_parameters()}

    lr = max(g["lr"] for g in optimizer.inner.param_groups)
    where = ([str(d) for d in everywhere] if rows is None
             else [[str(d) for d in r] for r in mesh.devices])
    label = f"cross_device {name} over {where}"
    got, ref, _, needs, loose = held_sharded_steps(
        gc, torch, card_line, model, optimizer, sharded, unsharded, [batch],
        label, lr, cards, [on_host] if host in everywhere else [])
    rel = abs(got[0]["total"] - ref[0]["total"]) / abs(ref[0]["total"])
    if not (math.isfinite(got[0]["total"]) and rel <= SMALL_RTOL):
        raise AssertionError(f"{label}: loss {got[0]['total']} against the "
                             f"unsharded {ref[0]['total']}")
    have = card_counts(got[0]["card_launches"])
    want = expect_on_cards(everywhere, family_launches(
        name, n_batch // len(data)))
    if have != want:
        raise AssertionError(f"{label}: launches by card {have} != {want}")
    return have, dict(seconds=got[0]["seconds"],
                      unsharded_seconds=ref[0]["seconds"], loss_rel=rel,
                      need_spread=needs[0], loose_entries=loose[0])


def cross_device_renders(gc, torch, devices):
    """The dry run's tile axis in len(devices) bands over ``devices`` (the
    scene on the first) against the unsharded render there: the loss
    within the dry run's 1e-4 of max(1, |loss|), finite gradients; then
    the same scene in len(devices) depth slabs (render_prim_sharded) over
    ``devices`` against the single render with its gradients on the first,
    as tests/test_torch_parallel_prim.py holds the slab render: outputs
    atol 5e-5, the loss rtol 2e-4, the gradients (pos, op, col) within
    2e-4 of their largest entry. Each card's bands and slabs launch K1, K2,
    K3 once and K4 twice a sample (the XLA window) exactly. Returns each
    part's launches on each card (the sharded renders', then the
    references')."""
    from goliath_torch.ops import gsplat
    from goliath_torch.parallel.sharding import Mesh
    from goliath_torch.parallel.tile_shard import render_prim_sharded
    from goliath_torch.scripts import dryrun_multichip as dr

    devices = [torch.device(d) for d in devices]
    H, W, kw = dr.TILE_AXIS["H"], dr.TILE_AXIS["W"], dr.TILE_AXIS["render"]
    B = dr.TILE_AXIS["B"]
    scene = dr.tile_axis_scene(devices[0])
    K, Rt, pos, quat, scale, op, col = scene
    counts = {}
    gc.reset_launch_counts()
    v, grads = dr.tile_axis_loss(Mesh([devices], ("data", "tile")), scene)
    counts["bands"] = card_counts(gc.CARD_LAUNCHES)
    gc.reset_launch_counts()
    with torch.no_grad():
        ref = gsplat.render(W, H, K, Rt, pos, quat, scale, op, col, **kw)
        v_ref = float((ref["render"] ** 2).mean() + ref["alpha"].mean())
    counts["unsharded"] = card_counts(gc.CARD_LAUNCHES)
    log(f"cross_device tile axis in {len(devices)} bands over "
        f"{[str(d) for d in devices]}: loss {v} (unsharded {v_ref})")
    if abs(v - v_ref) >= 1e-4 * max(1.0, abs(v_ref)):
        raise AssertionError(f"band loss {v} != unsharded {v_ref}")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("the bands' gradients are not finite")

    def slab_loss(render, *mesh):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (pos, op, col)]
        r = render(*mesh, W, H, K, Rt, leaves[0], quat, scale, leaves[1],
                   leaves[2], **kw)
        loss = (r["render"] ** 2).mean() + r["alpha"].mean()
        return (float(loss.detach()),
                {k: x.detach() for k, x in r.items()},
                torch.autograd.grad(loss, leaves))

    gc.reset_launch_counts()
    s_v, s_out, s_g = slab_loss(render_prim_sharded,
                                Mesh(devices, ("slab",)), "slab")
    counts["slabs"] = card_counts(gc.CARD_LAUNCHES)
    gc.reset_launch_counts()
    r_v, r_out, r_g = slab_loss(gsplat.render)
    counts["single"] = card_counts(gc.CARD_LAUNCHES)
    errs = {k: float((s_out[k] - r_out[k]).abs().max())
            for k in sorted(set(s_out) & set(r_out))}
    g_errs = {n: float((g - r).abs().max()) / float(r.abs().max())
              for n, g, r in zip(("pos", "op", "col"), s_g, r_g)}
    log(f"cross_device slabs: loss {s_v} (single {r_v}); outputs max abs "
        f"error {errs}; gradients' error over their largest entry {g_errs}")
    if not (errs and max(errs.values()) <= 5e-5
            and abs(s_v - r_v) <= 2e-4 * abs(r_v)
            and max(g_errs.values()) <= 2e-4):
        raise AssertionError("the slab render differs from the single one")
    trained = expect_on_cards(devices, splat_launches(B))
    want = {"bands": trained, "unsharded": expect_on_cards(
        devices[:1], splat_launches(0, B)), "slabs": trained,
        "single": expect_on_cards(devices[:1], splat_launches(B))}
    if counts != want:
        raise AssertionError(f"launches by card {counts} != {want}")
    return counts


# the 2-D meshes of cross_device's band step: each data shard (the first
# column) renders its bands on its own row; on the second the host's shard
# leaves the card out, which the card's launch counts show
CROSS_ROWS = ((("cuda:0", "cpu"), ("cpu", "cuda:0")),
              (("cuda:0", "cpu"), ("cpu", "cpu")))


def cross_device(gc, torch, card_line):
    """(e) parallel/ over the card and the host, which every machine with
    a card has: one step of each family of the dry run at its shapes and
    batch CROSS_BATCH on a "data" mesh of (cuda:0, cpu), the model on the
    card and its replica on the host (cross_device_family); one RGCA step
    on each 2-D ("data", "tile") mesh of CROSS_ROWS with the render banded
    over it; then the tile axis in 2 bands and a frame in 2 slabs over
    (cuda:0, cpu) (cross_device_renders). Returns the sharded runs'
    launches on the card (the references' left out)."""
    from goliath_torch.scripts.dryrun_multichip import FAMILIES

    devices = (torch.device("cuda", 0), torch.device("cpu"))
    launches = {name: 0 for name in gc.LAUNCHES}
    runs = [(name, devices, None) for name in FAMILIES]
    runs += [("rgca", None, rows) for rows in CROSS_ROWS]
    for name, devs, rows in runs:
        t0 = time.perf_counter()
        have, rep = cross_device_family(gc, torch, name, devs, card_line,
                                        rows)
        launches = add_launches(launches, have.get(0, {}))
        log(f"cross_device {name} over "
            f"{'(cuda:0, cpu)' if rows is None else f'the rows {rows}'}: "
            f"step {rep['seconds']:.4f} s (unsharded on the card "
            f"{rep['unsharded_seconds']:.4f} s), loss rel diff "
            f"{rep['loss_rel']:.3e}, gradients held by their spread "
            f"{rep['need_spread']}, launches on the card {have}, the "
            f"replica on the host holding the step's parameters and the "
            f"model's buffers after it; {time.perf_counter() - t0:.1f} s "
            f"with its references, on {card_line}")
    counts = cross_device_renders(gc, torch, devices)
    for part in ("bands", "slabs"):
        launches = add_launches(launches, counts[part].get(0, {}))
    log(f"cross_device launches on the card: {launches}")
    return launches


def union_ms(spans):
    """The length in ms of the union of (start, end) spans in us."""
    total, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def card_busy(prof):
    """({card: ms during which it ran device work}, ms during which any
    card did) from a torch.profiler run's device events ({} and 0 where
    the profiler saw none)."""
    from torch.autograd import DeviceType

    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    return ({c: union_ms(s) for c, s in sorted(spans.items())},
            union_ms([x for s in spans.values() for x in s]))


def multi_card_band_frame(gc, torch, cards, card_line):
    """One run_test frame of configs/rgca.yml at full width in one band a
    card (model.render's tile_shard_mesh a "tile" mesh of ``cards``), each
    card launching K1 once and K4 twice; then, on that frame's render
    arguments, the same bands on cuda:0 alone, bit for bit (the band
    render is deterministic; the decoder's forward is not, so two frames
    are compared on the same inputs), and the unsharded render beside it
    (frame_difference)."""
    from goliath_torch.config import load_config
    from goliath_torch.ops import gsplat
    from goliath_torch.parallel.sharding import Mesh
    from goliath_torch.scripts import run_test

    mesh = Mesh([torch.device("cuda", c) for c in cards], ("tile",))
    cfg = load_config(str(ROOT / "configs" / "rgca.yml"), overrides=[
        f"test.data={yaml_flow(FULL_DATA)}", "test.ckpt=null",
        "test.n_test_frames=1", "test.vis_path=null"])
    cfg.model.render.update(tile_shard_mesh=mesh, tile_shard_axis="tile")
    seconds = []
    with RenderTap() as tap:
        gc.reset_launch_counts()
        run_test.main(cfg, device=DEVICE, frame_seconds=seconds)
        sync_cards(torch, cards)
        counts = card_counts(gc.CARD_LAUNCHES)
    args, kw = tap.first_call
    spread = tap.outputs[0]
    renders = {}
    for label, m in (("alone", Mesh([torch.device("cuda", 0)] * len(cards),
                                    ("tile",))), ("unsharded", None)):
        kw_m = {k: v for k, v in kw.items()
                if k not in ("tile_shard_mesh", "tile_shard_axis")}
        if m is not None:
            kw_m.update(tile_shard_mesh=m, tile_shard_axis="tile")
        with torch.no_grad():
            sync_cards(torch, cards)
            t0 = time.perf_counter()
            out = gsplat.render(*args, **kw_m)
            sync_cards(torch, cards)
            renders[label] = ((out["render"], out["final_T"]),
                              time.perf_counter() - t0)
    diff = frame_difference(spread, renders["unsharded"][0])
    log(f"multi_card_train band frame: {len(cards)} bands on cards {cards}, "
        f"the frame {seconds[0]:.4f} s; on its render arguments the same "
        f"bands on cuda:0 {renders['alone'][1]:.4f} s, unsharded "
        f"{renders['unsharded'][1]:.4f} s; against the unsharded render "
        f"max |rgb| {diff[0]:.3e}, max |T| {diff[1]:.3e}, share of pixels "
        f"beyond {SHARD_DIFF} {diff[2]:.6f}; pairs wanted by band "
        f"{tap.wanted}; launches by card {counts} on {card_line}")
    if not all(torch.equal(a, b) for a, b in zip(spread,
                                                 renders["alone"][0])):
        raise AssertionError("the bands on distinct cards differ from the "
                             "same bands on one card")
    if not all(bool(torch.isfinite(x).all()) for x in spread):
        raise AssertionError("the band frame is not finite")
    want = {c: dict(compositor_fwd=1, cumsum1d=2) for c in cards}
    if counts != want:
        raise AssertionError(f"band frame launches {counts} != {want}")
    return dict(seconds=seconds[0], max_abs_rgb=diff[0], max_abs_T=diff[1],
                share_beyond=diff[2], launches=counts)


def multi_card_train(gc, torch, card_line):
    """(f) make_sharded_train_step on make_mesh(4) where four cards are
    visible, else make_mesh(2), at full width (configs/rgca.yml on
    FULL_DATA, batch 4): MULTI_CARD_STEPS steps, each held
    (held_sharded_steps) against the same shards on cuda:0 alone (the
    same-device path, which sharded_train holds against the unsharded
    step) from the same state, its loss against train.make_train_step's
    from the same state. The one-card step's batch-1 shards round as these
    do, so its one-ulp moves and reruns make the spread. Each card launches
    K1, K2, K3 once and K4 twice a sample of its shard; one more step under
    torch.profiler for each card's busy time against the wall; then the
    band frame (multi_card_band_frame). With one card it logs so and runs
    nothing. Returns (the launches in all, the report)."""
    from goliath_torch import train as train_lib
    from goliath_torch.parallel import make_mesh, make_sharded_train_step
    from goliath_torch.parallel.sharding import Mesh

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"multi_card_train: one card is visible "
            f"(torch.cuda.device_count() = {n_cards}); the phase did not "
            f"run")
        return {}, {"cards": n_cards}
    k = 4 if n_cards >= 4 else 2
    mesh = make_mesh(k)
    cards = list(range(k))
    lines = card_lines()[:k]
    log(f"multi_card_train: make_mesh({k}) over "
        f"{[str(d) for d in mesh.devices.flat]}: {lines}")
    model, loss_fn, optimizer, batches, lr = full_width_training(
        torch, MULTI_CARD_STEPS)
    module = model.module
    sharded = make_sharded_train_step(model, loss_fn, optimizer, mesh)
    unsharded = train_lib.make_train_step(model, loss_fn, optimizer)
    one_card = make_sharded_train_step(model, loss_fn, optimizer, Mesh(
        [torch.device("cuda", 0)] * k, ("data",)))

    n_entries = sum(p.numel() for p in module.parameters())
    got, ref, plain, needs, loose = held_sharded_steps(
        gc, torch, card_line, model, optimizer, sharded, one_card, batches,
        f"multi_card_train data x{k} cards", lr, cards,
        ref_name=f"{k} shards on cuda:0", unsharded=unsharded)
    per_card = {c: {name: sum(r["card_launches"].get(c, {}).get(name, 0)
                              for r in got) for name in gc.LAUNCHES}
                for c in cards}
    n = MULTI_CARD_STEPS * TRAIN_BATCH // k
    for c in cards:
        want = {name: 0 for name in gc.LAUNCHES}
        want.update(compositor_fwd=n, pair_grads=n, cumsum_cols=n,
                    cumsum1d=2 * n)
        if per_card[c] != want:
            raise AssertionError(f"card {c}: launches {per_card[c]} != "
                                 f"{want}")
    peaks = {c: max(r["peaks"][c] for r in got) / 2**30 for c in cards}
    rel = [abs(g["total"] - r["total"]) / abs(r["total"])
           for g, r in zip(got, plain)]
    if not all(math.isfinite(r["total"]) for r in got) or max(rel) > \
            SMALL_RTOL:
        raise AssertionError(f"multi_card_train: losses rel diff {rel}")
    log(f"multi_card_train data x{k} cards: step walls "
        f"{[round(r['seconds'], 4) for r in got]} s, {k} shards on cuda:0 "
        f"{[round(r['seconds'], 4) for r in ref]} s, unsharded on cuda:0 "
        f"{[round(r['seconds'], 4) for r in plain]} s; loss rel diff "
        f"against the unsharded step "
        f"{[f'{r:.3e}' for r in rel]}; peak memory of a step above what "
        f"each card held before it (GiB): "
        f"{ {c: round(p, 3) for c, p in peaks.items()} } "
        f"({n_entries * 4 / 2**30:.3f} GiB of parameters); launches by card "
        f"{card_counts(per_card)} on {lines}")

    from torch.profiler import ProfilerActivity, profile

    sync_cards(torch, cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharded(dict(batches[0]), MULTI_CARD_STEPS)
        sync_cards(torch, cards)
        wall = (time.perf_counter() - t0) * 1e3
    busy, union = card_busy(prof)
    overlap = sum(busy.values()) - union
    log(f"multi_card_train overlap (one more step under torch.profiler, "
        f"wall {wall:.3f} ms): device busy by card "
        f"{ {c: round(b, 3) for c, b in busy.items()} } ms, some card busy "
        f"{union:.3f} ms, two or more at once {overlap:.3f} ms "
        f"({overlap / union if union else 0.0:.3f} of it); idle share of "
        f"the wall with no card busy {max(0.0, 1 - union / wall):.3f}"
        if busy else "multi_card_train overlap: the profiler saw no device "
        "work (not measured)")
    del model, module, optimizer, sharded, unsharded, one_card, batches
    torch.cuda.empty_cache()
    band = multi_card_band_frame(gc, torch, cards, lines)
    launches = {name: sum(per_card[c][name] for c in cards)
                for name in gc.LAUNCHES}
    launches = add_launches(launches, *band["launches"].values())
    return launches, dict(
        cards=k, card_lines=lines, seconds=[r["seconds"] for r in got],
        one_card_seconds=[r["seconds"] for r in ref],
        unsharded_seconds=[r["seconds"] for r in plain], loss_rel=rel,
        peak_gib=peaks, launches_by_card=per_card,
        need_spread=[len(x) for x in needs], loose_entries=loose,
        profiled_wall_ms=wall, busy_ms=busy, any_busy_ms=union,
        overlap_ms=overlap, band_frame=band)


# The checkpoint-render example (goliath_torch/examples/render_example.py):
# its render() on configs/rgca.yml at FULL_DATA from the per-sample training
# path's checkpoint (K1 once and K4 twice a sample), then on
# configs/mesh_vae.yml at the mesh eval path's width from fresh weights (K5
# once and K4 twice a sample); EXAMPLE_SAMPLES samples each, as the example
# takes. Its grid against chip_smoke's own grid of a model it builds from
# the same checkpoint: within 1 LSB of uint8.
EXAMPLE_SAMPLES = 4
EXAMPLE_LSB = 1


def example_grid(rgb):
    """[B, 3, H, W] float (B <= 4) -> the example's [H, B W, 3] uint8 grid,
    the body models' 0..255 divided by 255."""
    import numpy as np

    scale = 255.0 if rgb.max() > 2.0 else 1.0
    grid = np.concatenate(list(rgb), axis=2).transpose(1, 2, 0)
    return (np.clip(grid / scale, 0, 1) * 255).astype(np.uint8)


def example_run(gc, torch, card_line, label, cfg, ckpt, expected, out_dir,
                captured):
    """One render() of the example, counts reset just before and read just
    after (exactly ``expected``, every other kernel 0): its wall time and
    peak memory; the PNG read back at the grid's size; the grid against a
    model built here from ``ckpt`` (or fresh) on the run's batch. Keeps the
    run's first K1 arguments (``captured["k1"]``), its first K5 arguments
    (``"k5"``) and every K4 input (``"k4"``), copied to the host without a
    synchronise."""
    from goliath_torch.config import Config, load_from_config
    from goliath_torch.convert import load_params
    from goliath_torch.examples import render_example as rex
    from goliath_torch.ops import binning, rasterizer

    seen, k4 = {}, []
    orig_rt, orig_zb, orig_cs = (gc.rasterize_tiled, rasterizer.zbuffer,
                                 binning.cumsum1d)
    orig_data = rex.build_dataset

    def to_host(x):   # pinned memory, no synchronise
        return x.to("cpu", non_blocking=True) \
            if isinstance(x, torch.Tensor) else x

    def rt(*args, **kw):
        seen.setdefault("k1", args)
        return orig_rt(*args, **kw)

    def zb(*args):
        seen.setdefault("k5", tuple(to_host(a) for a in args))
        return orig_zb(*args)

    def cs(x):
        k4.append(to_host(x))
        return orig_cs(x)

    def data(*a, **kw):
        seen["dataset"] = orig_data(*a, **kw)
        return seen["dataset"]

    out_path = str(Path(out_dir) / f"{label}.png")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gc.rasterize_tiled, rasterizer.zbuffer, binning.cumsum1d = rt, zb, cs
    rex.build_dataset = data
    gc.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        res = rex.render(cfg, ckpt, out_path, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(gc.LAUNCHES)
    finally:
        gc.rasterize_tiled, rasterizer.zbuffer, binning.cumsum1d = (
            orig_rt, orig_zb, orig_cs)
        rex.build_dataset = orig_data
    peak = torch.cuda.max_memory_allocated()
    log(f"render example ({label}): launches {launches}; wall {wall:.3f} s "
        f"(data, model build, checkpoint, forward, PNG), peak device memory "
        f"{peak / 2**30:.3f} GiB on {card_line}")
    want = {name: 0 for name in gc.LAUNCHES}
    want.update(expected)
    if launches != want:
        raise AssertionError(f"render example ({label}): launch counts "
                             f"{launches} != {want}")
    grid, batch = res["grid"], res["batch"]
    n = batch["image"].shape[0]
    size = cfg.model.get("renderer", cfg.model)   # mesh_vae's, RGCA's
    h, w = size["image_height"], size["image_width"]
    png = read_png(out_path)
    log(f"render example ({label}): {n} samples, grid {grid.shape}, PNG "
        f"{png.shape}, pixels above 0: {float((grid > 0).mean()):.4f}")
    if n != EXAMPLE_SAMPLES or grid.shape != (h, n * w, 3) or not (
            png == grid).all():
        raise AssertionError(f"render example ({label}): the PNG is not the "
                             f"grid of {EXAMPLE_SAMPLES} {h}x{w} renders")

    # the same forward from a model built here from the same weights
    del res
    mc = Config.wrap(dict(cfg.model))
    for key in ("cal", "pixel_cal"):
        mc.pop(key, None)
    mc["learn_blur"] = False
    model = load_from_config(mc, assets=seen.pop("dataset").static_assets,
                             device=DEVICE)
    if ckpt:
        load_params(model.module, ckpt)
    with torch.no_grad():
        rgb = model.apply(batch, train=False)["rgb"]
    direct = example_grid(rgb.float().cpu().numpy())
    diff = int(abs(direct.astype("int16") - grid.astype("int16")).max())
    log(f"render example ({label}): grid against a direct model(batch, "
        f"train=False) from the same weights: max difference {diff} of "
        f"uint8 (tolerance {EXAMPLE_LSB})")
    if diff > EXAMPLE_LSB:
        raise AssertionError(f"render example ({label}): its grid differs "
                             f"from the direct forward's by {diff}")
    captured.update({k: v for k, v in seen.items() if k in ("k1", "k5")})
    captured["k4"] = k4
    return launches


def render_example_path(gc, torch, card_line, ckpt, captured):
    """The example on configs/rgca.yml at FULL_DATA from the training
    path's checkpoint ``ckpt`` (K1 4, K4 8), then on configs/mesh_vae.yml
    at MESH_DATA from fresh weights (K5 4, K4 8); each run's kernel
    arguments in ``captured["rgca"]`` / ``captured["mesh"]``."""
    if not ckpt:
        raise AssertionError("the training path wrote no checkpoint")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as out:
        captured["rgca"], captured["mesh"] = {}, {}
        rgca = example_run(gc, torch, card_line, "rgca", rgca_config(), ckpt,
                           dict(compositor_fwd=EXAMPLE_SAMPLES,
                                cumsum1d=2 * EXAMPLE_SAMPLES), out,
                           captured["rgca"])
        torch.cuda.empty_cache()
        mesh = example_run(gc, torch, card_line, "mesh_vae", mesh_config(),
                           None, dict(zbuffer=EXAMPLE_SAMPLES,
                                      cumsum1d=2 * EXAMPLE_SAMPLES), out,
                           captured["mesh"])
    return rgca, mesh


# The rest of the layer library (nn/layers.py, blocks.py, unet.py,
# shadow.py, color_cal.py: plain PyTorch, no hand kernel) at full width on
# the card against the same modules with the same state_dict on the CPU.
# Widths: the shadow variants at configs/mesh_vae.yml's shadow_net (uv 2048,
# shadow 256, n_dims 4) from a 1024^2 AO map (mesh_vae's uv), batch 4; the
# floor decoder at its fixed 512 from a 1024^2 AO map; the UNets at
# decoder_view (4 -> 3 channels, 1024, n_init_ftrs 8); the blocks'
# UpscaleNet at upscale_net (n_ftrs 4, 1024 -> 2048); the colour-cal
# variants on 4 images of 2048x1334 (identity camera 400870); the layers at
# 64 channels, 512^2 (the upsampling layers' output), batch 4.
LIB_BATCH = 4
LIB_DIST_JOINTS = 16   # DistMapShadowUNet's input maps: no config names one
LIB_CAMERAS = ["400870", "400883", "401031", "401168"]
LIB_GRAY_CAMERA = "410001"   # CalV5's grayscale branch (v6 refuses it)
# card against CPU on the first sample of each batch, in float32 (TF32
# off): outputs held at rtol and atol of the largest entry LIB_TOL, and
# gradients at LIB_GRAD_TOL (float32 sums in other orders: 2.1e-06-8.2e-05
# of the largest entry measured on the modules without leaky ReLUs). Where
# a module has leaky ReLUs, its float32 gradients are not held card against
# CPU: a leaky ReLU whose input lies within rounding of 0 takes slope 1 on
# one device and 0.2 on the other, which moves every gradient behind it
# over its receptive field (at full width the UNets' and the floor
# decoder's differ so in 2,480-12,697 entries, up to 0.11 of the largest
# entry, while their float64 gradients agree to 5e-14). There the same
# module in float64 holds outputs and every gradient at LIB_F64_TOL:
# float64 sums in other orders, the weight norm's projection cancelling
# (6e-3 of the largest in float32 on the floor decoder's first layer,
# tests/test_torch_library_floor.py).
LIB_TOL, LIB_GRAD_TOL, LIB_F64_TOL = 1e-4, 1e-3, 1e-8


def library_cases():
    """(name, width, make(generator) -> module, float input shapes, integer
    inputs as numpy arrays, whether the module has leaky ReLUs)."""
    import numpy as np

    from goliath_torch.nn import blocks, color_cal, layers, shadow, unet

    B = LIB_BATCH
    ao_mean = np.random.RandomState(9).rand(1, 1024, 1024).astype(np.float32)
    # sample 0 (the one held against the CPU) on a camera with an affine;
    # the identity camera in the batch too
    idx = np.asarray([3, 1, 2, 0], np.int32)
    cases = [
        ("ShadowUNet_PoseCond", "uv 2048, shadow 256, n_dims 4, pose 6 -> 32",
         lambda g: shadow.ShadowUNet_PoseCond(
             2048, ao_mean, 256, n_dims=4, n_pose_dims=6,
             n_pose_enc_dims=32, generator=g),
         [(B, 1, 1024, 1024), (B, 6)], [], True),
        ("DistMapShadowUNet", f"uv 2048, shadow 256, n_dims 4, "
         f"{LIB_DIST_JOINTS} joints",
         lambda g: shadow.DistMapShadowUNet(2048, 256, LIB_DIST_JOINTS,
                                            n_dims=4, generator=g),
         [(B, LIB_DIST_JOINTS, 1024, 1024)], [], True),
        ("FloorShadowDecoder", "512 from 1024^2",
         lambda g: shadow.FloorShadowDecoder(512, generator=g),
         [(B, 1, 1024, 1024)], [], True),
        ("UNetW", "4 -> 3, 1024, n_init_ftrs 8",
         lambda g: unet.UNetW(4, 3, 8, generator=g), [(B, 4, 1024, 1024)],
         [], True),
        ("UNetWBConcat", "4 -> 3, 1024, n_init_ftrs 8",
         lambda g: unet.UNetWBConcat(4, 3, 1024, 8, generator=g),
         [(B, 4, 1024, 1024)], [], True),
        ("blocks.UpscaleNet", "3 -> 3, n_ftrs 4, 1024 -> 2048",
         lambda g: blocks.UpscaleNet(3, 3, 4, 1024, generator=g),
         [(B, 3, 1024, 1024)], [], True),
    ]
    for ver in ("identity", "v3", "v5", "v6"):
        cams = LIB_CAMERAS if ver == "v6" else LIB_CAMERAS[:3] + [
            LIB_GRAY_CAMERA]
        cases.append((f"make_cal({ver})", "4 images of 2048x1334",
                      lambda g, v=ver, c=cams: color_cal.make_cal(
                          v, cameras=c, identity_camera="400870"),
                      [(B, 3, 2048, 1334)], [idx], False))
    C = 64
    cases += [
        ("ConvTranspose2dWN", "64 -> 64, 256^2 -> 512^2",
         lambda g: layers.ConvTranspose2dWN(C, C, 4, 2, 1, generator=g),
         [(B, C, 256, 256)], [], False),
        ("UpConv2dWN", "64 -> 64, 256^2 -> 512^2",
         lambda g: layers.UpConv2dWN(C, C, 3, 1, 1, generator=g),
         [(B, C, 256, 256)], [], False),
        ("Sequential(make_conv)", "64 -> 64 -> 64, 512^2, a tied 3x3 conv "
         "and an untied 1x1",
         lambda g: layers.Sequential([
             *layers.make_conv(C, C, 3, 1, 1, act=layers.LeakyReLU(),
                               generator=g),
             *layers.make_conv(C, C, 1, 1, 0, ub=(512, 512), generator=g)]),
         [(B, C, 512, 512)], [], True),
        ("Conv2dELR", "64 -> 64, 512^2",
         lambda g: layers.Conv2dELR(C, C, 3, 1, 1, lr_mul=0.5, generator=g),
         [(B, C, 512, 512)], [], False),
        ("LinearELR", "64 -> 64 at each of 512^2 pixels",
         lambda g: layers.LinearELR(C, C, lr_mul=0.5, generator=g),
         [(B, 512 * 512, C)], [], False),
        ("Downsample", "64 channels, 512^2 -> 256^2",
         lambda g: layers.Downsample(), [(B, C, 512, 512)], [], False),
        ("ConcatPyramid", "64 (+3) channels, 128^2 -> 512^2, y at 512^2, "
         "transposed",
         lambda g: layers.ConcatPyramid([
             layers.ConvTranspose2dWN(C + 3, C, 4, 2, 1, generator=g),
             layers.LeakyReLU(),
             layers.ConvTranspose2dWN(C + 3, C, 4, 2, 1, generator=g)],
             n_concat_in=3, transposed=True),
         [(B, C, 128, 128), (B, 3, 512, 512)], [], True),
    ]
    return cases


def lib_card_vs_cpu(torch, make, shapes, ints, kinks):
    """Build ``make``'s module on the CPU (generator seed 0; biases and
    cal_params moved off their initial values so that they show) and copy
    it to the card; draw float inputs of ``shapes`` on the card (seeded;
    they take gradients) beside the integer inputs ``ints``; the loss is a
    seeded projection of the outputs. The card's float32 forward and
    backward run at the whole batch; its first sample is held against the
    CPU's: in float32, outputs at LIB_TOL and, for a module without leaky
    ReLUs (``kinks`` false), every gradient (parameters and inputs) at
    LIB_GRAD_TOL; with ``kinks``, outputs and every gradient in float64 at
    LIB_F64_TOL instead. Returns a dict: the largest errors as fractions
    of the largest entry (``out32``, ``grad32``: the card's float32
    gradients against the CPU's, or with ``kinks`` against the card's
    float64 ones, reported; with ``kinks`` also ``out64``, ``grad64``),
    whether all holds (``holds``), the float32 run's peak device memory
    (``peak``) and ``step``, which runs the card's float32 forward and
    backward again."""
    import copy

    cpu = make(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for pname, p in cpu.named_parameters():
            if pname.endswith("bias") or "cal_params" in pname:
                p.add_(0.1 * torch.randn(p.shape, generator=torch
                                         .Generator().manual_seed(1)))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    xs = [torch.rand(s, generator=gen, device=DEVICE) for s in shapes]
    ints = [torch.from_numpy(i).to(DEVICE) for i in ints]

    def leaves(tensors, dtype, device):
        return [t.to(device=device, dtype=dtype).detach().requires_grad_(True)
                for t in tensors]

    def outputs(out):
        return [out[k] for k in sorted(out)] if isinstance(out, dict) \
            else [out]

    def run(mod, tx, ti, cots):
        outs = outputs(mod(*tx, *ti))
        sum((o * c[:o.shape[0]].to(o.dtype)).sum()
            for o, c in zip(outs, cots)).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for _, p in mod.named_parameters()]
        return [o.detach() for o in outs], grads + [t.grad for t in tx]

    def errors(got, ref, tol):
        worst, beyond = 0.0, 0
        for g, r in zip(got, ref):
            g, r = g.cpu().to(r.dtype), r.cpu()
            scale = float(r.abs().max()) if r.numel() else 0.0
            d = (g - r).abs()
            worst = max(worst, float(d.max()) / scale if scale
                        else float(d.max()))
            beyond += int((d > tol * scale + tol * r.abs()).sum())
        return worst, beyond

    first = [x[:1] for x in xs], [i[:1] for i in ints]
    card = copy.deepcopy(cpu).to(DEVICE)
    tx = leaves(xs, torch.float32, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        shapes_out = [o.shape for o in outputs(card(*tx, *ints))]
    cots = [torch.randn(s, generator=gen, device=DEVICE) for s in shapes_out]
    got32 = run(card, tx, ints, cots)[0]
    torch.cuda.synchronize()
    res = dict(peak=torch.cuda.max_memory_allocated())
    one32 = run(copy.deepcopy(cpu).to(DEVICE),
                leaves(first[0], torch.float32, DEVICE), first[1], cots)[1]
    ref32 = run(cpu, leaves(first[0], torch.float32, "cpu"),
                [i.cpu() for i in first[1]], [c[:1].cpu() for c in cots])
    res["out32"], beyond = errors([o[:1] for o in got32], ref32[0], LIB_TOL)
    del got32
    if kinks:
        ref64 = run(copy.deepcopy(cpu).double(),
                    leaves(first[0], torch.float64, "cpu"),
                    [i.cpu() for i in first[1]], [c[:1].cpu() for c in cots])
        got64 = run(copy.deepcopy(cpu).double().to(DEVICE),
                    leaves(first[0], torch.float64, DEVICE), first[1], cots)
        res["out64"], b_out = errors(got64[0], ref64[0], LIB_F64_TOL)
        res["grad64"], b_grad = errors(got64[1], ref64[1], LIB_F64_TOL)
        res["grad32"], _ = errors(one32, got64[1], LIB_F64_TOL)
        beyond += b_out + b_grad
        del ref64, got64
    else:
        res["grad32"], b_grad = errors(one32, ref32[1], LIB_GRAD_TOL)
        beyond += b_grad
    res["holds"] = beyond == 0
    del ref32, one32
    torch.cuda.empty_cache()

    def step():
        card.zero_grad(set_to_none=True)
        for t in tx:
            t.grad = None
        run(card, tx, ints, cots)

    res["step"] = step
    return res


def library_path(torch, card_line):
    """Each new module of the layer library forward and backward on the
    card at its full width (library_cases) against the same module, with
    the same state_dict, on the CPU (lib_card_vs_cpu: the first sample's
    outputs, every parameter's gradient and every input's gradient of a
    seeded projection of the outputs); the card's float32 forward and
    backward at the whole batch by CUDA events, and its peak memory."""
    from goliath_torch.utils.timing import cuda_ms

    failed, report = [], {}
    for name, width, make, shapes, ints, kinks in library_cases():
        t0 = time.perf_counter()
        res = lib_card_vs_cpu(torch, make, shapes, ints, kinks)
        ms = cuda_ms(res.pop("step"), reps=3, warmup=1)
        peak = res["peak"] / 2**30
        report[name] = dict(ms=ms, peak_gib=peak,
                            seconds=time.perf_counter() - t0)
        log(f"library {name} ({width}, batch {LIB_BATCH}): forward and "
            f"backward {ms:.3f} ms (float32), peak device memory {peak:.3f} "
            f"GiB on {card_line}; card vs CPU on sample 0 as fractions of the "
            f"largest entry: float32 outputs {res['out32']:.3e} (tolerance "
            f"{LIB_TOL}), " + (
                f"float64 outputs {res['out64']:.3e}, gradients "
                f"{res['grad64']:.3e} (tolerance {LIB_F64_TOL}; leaky ReLUs), "
                f"the card's float32 gradients {res['grad32']:.3e} from its "
                f"float64 ones (reported)" if kinks else
                f"float32 gradients {res['grad32']:.3e} (tolerance "
                f"{LIB_GRAD_TOL})") + ": "
            f"{'ok' if res['holds'] else 'FAILED'} "
            f"({report[name]['seconds']:.1f} s with the CPU's runs)")
        if not res["holds"]:
            failed.append(name)
        del res
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"library modules off their CPU result: "
                             f"{failed}")
    return report

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
    log(f"tensorstore (the orbax checkpoint reader's): {tensorstore_line()}")
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
            phase("k7_frame", check_k7_frame, gc, torch, frame)
        if "k1_check" in phases:
            phase("p1_probe", p1_probe, gc, torch, seen["k1"], frame,
                  card_line)
        del seen, frame
        torch.cuda.empty_cache()
    phase("main_path", main_path, gc, torch, card_line)
    totals, fold_inputs = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as run_dir:
        phase("train_path", train_path, gc, torch, card_line, totals,
              run_dir)
        torch.cuda.empty_cache()
        example = {}
        phase("render_example_path", render_example_path, gc, torch,
              card_line, latest_checkpoint(run_dir), example)
    if "k1" in example.get("rgca", {}):
        log("K1 on the render example (configs/rgca.yml, sample 0):")
        phase("k1_example", check_k1, gc, torch, example["rgca"]["k1"], {},
              False)
    if "k4" in example.get("rgca", {}):
        phase("k4_example_rgca", k4_mesh_check, gc, torch,
              example["rgca"]["k4"], 2 * EXAMPLE_SAMPLES,
              "render example (rgca)")
    if "k5" in example.get("mesh", {}):
        phase("k5_example", check_k5, gc, torch, example["mesh"]["k5"],
              "K5 (render example, mesh_vae sample 0)")
    if "k4" in example.get("mesh", {}):
        phase("k4_example_mesh", k4_mesh_check, gc, torch,
              example["mesh"]["k4"], 2 * EXAMPLE_SAMPLES,
              "render example (mesh_vae)")
    del example
    torch.cuda.empty_cache()
    phase("fold_train_path", fold_train_path, gc, torch, card_line, totals,
          fold_inputs)
    torch.cuda.empty_cache()
    if "k6" in fold_inputs:
        phase("k6_check", check_k6, gc, torch, fold_inputs.pop("k6"))
    torch.cuda.empty_cache()
    phase("xla_window_check", xla_window_check, gc, torch, card_line)
    phase("k7_check", check_k7, gc, torch, card_line)
    torch.cuda.empty_cache()
    mesh_inputs = {}
    phase("mesh_eval_path", mesh_eval_path, gc, torch, card_line,
          mesh_inputs)
    if "k5" in mesh_inputs:
        phase("k5_check", check_k5, gc, torch, mesh_inputs["k5"])
    if "k4" in mesh_inputs:
        phase("k4_mesh", k4_mesh_check, gc, torch, mesh_inputs["k4"])
    del mesh_inputs
    torch.cuda.empty_cache()
    mesh_train_inputs = {}
    phase("mesh_train_path", mesh_train_path, gc, torch, card_line, totals,
          mesh_train_inputs)
    if "k5" in mesh_train_inputs:
        phase("k5_train_check", check_k5, gc, torch,
              mesh_train_inputs["k5"], "K5 (mesh training, step 0 sample 0)")
    if "edge" in mesh_train_inputs:
        phase("edge_grad_check", check_edge_grads, torch,
              mesh_train_inputs["edge"])
    del mesh_train_inputs
    torch.cuda.empty_cache()
    drivable_inputs = {}
    phase("drivable_eval_path", drivable_eval_path, gc, torch, card_line,
          drivable_inputs)
    if "k5" in drivable_inputs:
        phase("k5_drivable", check_k5, gc, torch, drivable_inputs["k5"],
              "K5 (drivable eval, frame 0)")
    if "k4" in drivable_inputs:
        phase("k4_drivable", k4_mesh_check, gc, torch, drivable_inputs["k4"],
              6, "drivable eval")
    del drivable_inputs
    torch.cuda.empty_cache()
    drivable_train_inputs = {}
    phase("drivable_train_path", drivable_train_path, gc, torch, card_line,
          totals, drivable_train_inputs)
    if "k5" in drivable_train_inputs:
        phase("k5_drivable_train", check_k5, gc, torch,
              drivable_train_inputs["k5"],
              "K5 (drivable training, step 0 sample 0)")
    if len(drivable_train_inputs.get("k4", ())) == 2:
        phase("k4_drivable_train", k4_mesh_check, gc, torch,
              drivable_train_inputs["k4"], 2,
              "drivable training, step 0 sample 0")
    if "edge" in drivable_train_inputs:
        phase("drivable_edge_grad_check", check_edge_grads, torch,
              drivable_train_inputs["edge"],
              "drivable edge-gradient backward")
    del drivable_train_inputs
    torch.cuda.empty_cache()
    urhand_inputs = {}
    phase("urhand_eval_path", urhand_eval_path, gc, torch, card_line,
          urhand_inputs)
    if "k5_shadow" in urhand_inputs:
        phase("k5_urhand_shadow", check_k5, gc, torch,
              urhand_inputs["k5_shadow"],
              "K5 (URHand frame 0, first light view of the first shadow "
              "pass)")
    if "k5_render" in urhand_inputs:
        phase("k5_urhand_render", check_k5, gc, torch,
              urhand_inputs["k5_render"], "K5 (URHand frame 0, rgb render)")
    if "k4" in urhand_inputs:
        phase("k4_urhand", k4_mesh_check, gc, torch, urhand_inputs["k4"],
              2 * URHAND_K5_PER_FRAME, "URHand frame 0")
    del urhand_inputs
    torch.cuda.empty_cache()
    urhand_train_inputs = {}
    phase("urhand_train_path", urhand_train_path, gc, torch, card_line,
          totals, urhand_train_inputs)
    if {"k5_shadow", "k5_render"} <= set(urhand_train_inputs):
        phase("k5_urhand_train", k5_urhand_train, gc, torch,
              urhand_train_inputs)
    if urhand_train_inputs.get("k4"):
        phase("k4_urhand_train", k4_mesh_check, gc, torch,
              urhand_train_inputs["k4"], 2 * URHAND_K5_PER_FRAME,
              "URHand training step 0")
    if urhand_train_inputs.get("edge"):
        phase("urhand_edge_grad_check", urhand_edge_grad_check, torch,
              urhand_train_inputs["edge"])
    del urhand_train_inputs
    torch.cuda.empty_cache()
    hand_mvp_inputs = {}
    phase("hand_mvp_eval_path", hand_mvp_eval_path, gc, torch, card_line,
          hand_mvp_inputs)
    if hand_mvp_inputs.get("k4"):
        phase("k4_mvp", k4_mvp_check, gc, torch, hand_mvp_inputs["k4"])
    if {"march", "model", "geom_lbs"} <= set(hand_mvp_inputs):
        phase("mvp_march_check", mvp_march_check, torch, hand_mvp_inputs,
              card_line)
    if "march" in hand_mvp_inputs:
        phase("k8_check", k8_check, gc, torch, hand_mvp_inputs, card_line,
              "hand_mvp frame 0")
    del hand_mvp_inputs
    torch.cuda.empty_cache()
    teacher_inputs = {}
    phase("hand_teacher_eval_path", hand_teacher_eval_path, gc, torch,
          card_line, teacher_inputs)
    if teacher_inputs.get("k4"):
        phase("k4_teacher", k4_mvp_check, gc, torch, teacher_inputs["k4"],
              "hand_teacher frame 0")
    if {"grid", "shadow", "march"} <= set(teacher_inputs):
        phase("teacher_shadow_check", teacher_shadow_check, torch,
              teacher_inputs, card_line)
    if "march" in teacher_inputs:
        phase("k8_teacher", k8_check, gc, torch, teacher_inputs, card_line,
              "hand_teacher frame 0")
    if {"grid", "shadow"} <= set(teacher_inputs):
        phase("k9_check", k9_check, gc, torch, teacher_inputs, card_line)
    del teacher_inputs
    torch.cuda.empty_cache()
    mvp_train_inputs = {}
    phase("hand_mvp_train_path", hand_mvp_train_path, gc, torch, card_line,
          totals, mvp_train_inputs)
    if mvp_train_inputs.get("k4"):
        phase("k4_mvp_train", k4_mvp_check, gc, torch,
              mvp_train_inputs["k4"], "hand_mvp training step 0")
    if "march" in mvp_train_inputs:
        phase("mvp_train_march_check", mvp_train_march_check, torch,
              mvp_train_inputs, card_line)
    del mvp_train_inputs
    torch.cuda.empty_cache()
    teacher_train_inputs = {}
    phase("teacher_train_path", teacher_train_path, gc, torch, card_line,
          totals, teacher_train_inputs)
    if teacher_train_inputs.get("k4"):
        phase("k4_teacher_train", k4_mvp_check, gc, torch,
              teacher_train_inputs["k4"], "hand_teacher training step 0")
    del teacher_train_inputs
    torch.cuda.empty_cache()
    relight_inputs = {}
    phase("relight_path", relight_path, gc, torch, card_line, relight_inputs)
    if relight_inputs.get("k4"):
        phase("k4_relight", k4_mesh_check, gc, torch, relight_inputs["k4"],
              2 * RELIGHT_RENDERS["spin"], "relight spin frame 0")
    if "k1" in relight_inputs:
        phase("k1_relight", check_k1_relight, gc, torch,
              relight_inputs["k1"])
    del relight_inputs
    torch.cuda.empty_cache()
    quality_inputs = {}
    phase("quality_path", quality_path, gc, torch, card_line, quality_inputs)
    if "k5" in quality_inputs:
        phase("k5_quality", check_k5, gc, torch, quality_inputs["k5"][0],
              "K5 (quality path, the first target render)",
              QUALITY_MIN_COVERED)
    if len(quality_inputs.get("k4", ())) == 2:
        phase("k4_quality", k4_mesh_check, gc, torch, quality_inputs["k4"],
              2, "quality path, the first target render")
    if {"k1", "k2", "k3"} <= set(quality_inputs):
        phase("quality_kernels", quality_kernels, gc, torch, quality_inputs,
              card_line)
    del quality_inputs
    torch.cuda.empty_cache()
    phase("small_reference", small_reference, torch)
    phase("teacher_small_reference", teacher_small_reference, torch)
    phase("hand_mvp_small_train_reference", hand_mvp_small_train_reference,
          torch)
    phase("teacher_small_train_reference", teacher_small_train_reference,
          torch)
    phase("relight_small_reference", relight_small_reference, torch)
    phase("drivable_small_reference", drivable_small_reference, torch)
    capture_inputs = {}
    phase("capture_path", capture_path, gc, torch, card_line, capture_inputs)
    if len(capture_inputs.get("k4", ())) == 2:
        phase("k4_capture", k4_mesh_check, gc, torch, capture_inputs["k4"],
              2, "capture training, the run's first render")
    del capture_inputs
    torch.cuda.empty_cache()
    texmean_inputs = {}
    phase("texmean_path", texmean_path, gc, torch, card_line, texmean_inputs)
    if "k5" in texmean_inputs:
        phase("k5_texmean", check_k5, gc, torch, texmean_inputs["k5"],
              "K5 (texmean, the first view)")
    if len(texmean_inputs.get("k4", ())) == 2:
        phase("k4_texmean", k4_mesh_check, gc, torch, texmean_inputs["k4"],
              2, "texmean, the first view")
    del texmean_inputs
    torch.cuda.empty_cache()
    phase("capture_small_reference", capture_small_reference, torch)
    shard_inputs = {}
    phase("tile_shard_eval", tile_shard_eval, gc, torch, card_line,
          shard_inputs)
    if "k1" in shard_inputs:
        phase("k1_band", check_k1_band, gc, torch, shard_inputs.pop("k1"))
    if len(shard_inputs.get("k4", ())) == 2 * SHARDS:
        phase("k4_band", k4_mesh_check, gc, torch, shard_inputs.pop("k4"),
              2 * SHARDS, "tile_shard_eval frame 0, its bands")
    if "render_args" in shard_inputs:
        phase("prim_shard_eval", prim_shard_eval, gc, torch, card_line,
              shard_inputs)
    del shard_inputs
    torch.cuda.empty_cache()
    band_inputs = {}
    phase("sharded_train", sharded_train, gc, torch, card_line, band_inputs)
    if {"k2", "k3"} <= set(band_inputs):
        phase("band_train_kernels", band_train_kernels, gc, torch,
              band_inputs, card_line)
    del band_inputs
    torch.cuda.empty_cache()
    phase("dryrun", dryrun_path, gc, torch, card_line)
    torch.cuda.empty_cache()
    phase("cross_device", cross_device, gc, torch, card_line)
    torch.cuda.empty_cache()
    phase("multi_card_train", multi_card_train, gc, torch, card_line)
    torch.cuda.empty_cache()
    phase("library_path", library_path, torch, card_line)

    # the phases that return (launches, measurements) of several kernels
    split = {}
    for name in ("xla_window_check", "k7_check", "p1_probe", "capture_path",
                 "sharded_train", "render_example_path", "multi_card_train"):
        if name in phases:
            split[name], phases[name] = phases[name]
    xla_eval, xla_train = split.get("xla_window_check", ({}, {}))
    for name in ("k6_check", "xla_window_check", "p1_probe"):
        for key, res in phases.get(name, {}).items():
            phases[f"{name}:{key}"] = res
    paths = {"eval": phases.get("main_path", {}),
             "train": phases.get("train_path", {}),
             "fold_train": phases.get("fold_train_path", {}),
             "xla_eval": xla_eval,
             "xla_train": xla_train,
             "mesh": phases.get("mesh_eval_path", {}),
             "mesh_train": phases.get("mesh_train_path", {}),
             "drivable_eval": phases.get("drivable_eval_path", {}),
             "drivable_train": phases.get("drivable_train_path", {}),
             "urhand": phases.get("urhand_eval_path", {}),
             "urhand_train": phases.get("urhand_train_path", {}),
             "hand_mvp_eval": phases.get("hand_mvp_eval_path", {}),
             "hand_teacher_eval": phases.get("hand_teacher_eval_path", {}),
             "hand_mvp_train": phases.get("hand_mvp_train_path", {}),
             "hand_teacher_train": phases.get("teacher_train_path", {}),
             "relight": phases.get("relight_path", {}),
             "quality": phases.get("quality_path", {}),
             "capture_train": phases.get("capture_path", {}),
             "capture_eval": split.get("capture_path", {}),
             "texmean": phases.get("texmean_path", {}),
             "tile_shard_eval": phases.get("tile_shard_eval", {}),
             "prim_shard_eval": phases.get("prim_shard_eval", {}),
             "sharded_train": split.get("sharded_train", {}),
             "dryrun": phases.get("dryrun", {}),
             "cross_device": phases.get("cross_device", {}),
             "multi_card": split.get("multi_card_train", {}),
             "render_example_rgca": split.get("render_example_path", {}),
             "render_example_mesh": phases.get("render_example_path", {}),
             "profile_reduce": split.get("k7_check", {}),
             "probe_kernel": split.get("p1_probe", {})}
    checks = {"compositor_fwd": ("K1", ["k1_check", "k1_relight",
                                        "k1_band", "k1_example"]),
              "compositor_fwd_xla": ("K1 xla", [
                  "xla_window_check:compositor_fwd_xla", "quality_kernels"]),
              "pair_grads": ("K2", ["k2_check", "backward_check",
                                    "band_train_kernels"]),
              "pair_grads_xla": ("K2 xla", [
                  "xla_window_check:pair_grads_xla", "quality_kernels"]),
              "cumsum_cols": ("K3", ["k3_check", "backward_check",
                                     "quality_kernels",
                                     "band_train_kernels"]),
              "cumsum1d": ("K4", ["k4_timing", "k4_exact", "k4_mesh",
                                  "k4_drivable", "k4_drivable_train",
                                  "k4_urhand", "k4_urhand_train", "k4_mvp",
                                  "k4_teacher", "k4_mvp_train",
                                  "k4_teacher_train", "k4_relight",
                                  "k4_quality", "k4_capture", "k4_texmean",
                                  "k4_band", "k4_example_rgca",
                                  "k4_example_mesh"]),
              "zbuffer": ("K5", ["k5_check", "k5_train_check",
                                 "k5_drivable", "k5_drivable_train",
                                 "k5_urhand_shadow", "k5_urhand_render",
                                 "k5_urhand_train", "k5_quality",
                                 "k5_texmean", "k5_example"]),
              "compositor_fwd_fold": ("K6 fwd", [
                  "k6_check:compositor_fwd_fold", "fold_train_path"]),
              "pair_grads_fold": ("K6 bwd", [
                  "k6_check:pair_grads_fold", "fold_train_path"]),
              "cumsum_rows": ("K7", ["k7_check", "k7_frame"]),
              "mvp_march": ("K8", ["k8_check", "k8_teacher"]),
              "shadow_integral": ("K9", ["k9_check"]),
              **{f"probe_{v}": (f"P1 {v}", [f"p1_probe:probe_{v}"])
                 for v in gc.PROBE_VARIANTS}}
    verdicts = []
    for name, (kid, keys) in checks.items():
        entries[name] = dict(
            name=name, route="cuda",
            source=f"goliath_torch/ops/csrc/{gc.SOURCES[name]}",
            replaces=replaces(gc, name),
            launches=sum(p.get(name, 0) for p in paths.values()),
            **{f"launches_{k}_path": p.get(name, 0)
               for k, p in paths.items()},
            **phases.get(keys[0], {}))
        ok = all(k in phases for k in keys) and entries[name]["launches"] > 0
        verdicts.append(f"{kid} {name}: {'ok' if ok else 'FAILED'}")
        if entries[name]["launches"] == 0 and "launches" not in failed:
            failed.append("launches")   # a kernel no path launched
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
