#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flypylib_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # build, check, drive the main path
    python3 chip_smoke.py --profile    # also trace detects and train steps
                                       # with torch.profiler

Phase 4 alone (after ``_build.build()``): ``chip_smoke.check_tail_kernels(
chip_smoke.card())``; phase 9's f32 tails alone: ``chip_smoke.
unet_f32_paths(port, card, chip_smoke.make_volume_u8(256, 16, seed=0))``.
Phase 13 alone: ``chip_smoke.bn_roi_phase(
chip_smoke.import_port(), chip_smoke.card())``; phase 14 alone:
``chip_smoke.multi_device_phase(port, card, vol, refs)`` with 10(a)'s
volume and ``staged_phase(...)["refs"]``.

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. Device: a CUDA card is required; its name and power limit are printed.
2. Build: every ``flypylib_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` into
   ``build/kernels/``; the compiler's register/spill report is printed.
3. K1 (``conv3d_bias_relu``) against its plain PyTorch version on the card,
   at the main path's shapes (the baseline's four body layers and the plain
   U-Net's ten convs at ``default_tiling``'s tile and batch for a 256^3
   volume) and two ``vgg_like`` layers (its first, Ci = 1 into 32, and 64
   -> 96 channels at dilation 4), in f32 and bf16, with the median times of
   both and of one cuDNN call.  Each case prints the kernel's route
   (``k1_route``); every bf16 case with Ci > 1 and Ci, Co multiples of 8
   must take the wgmma/TMA kernel, every f32 case with Ci > 1, Ci a
   multiple of 4 and a dilation of at most 7 the f32 kernel ("simt"),
   whose sums over baseline layers 1-3 and U-Net convs 1-9 are printed.
   Small cases at a dilation of 3, at Co > 128 (192, 136) and at Ci = 6
   run on every route.  Three broken outputs (baseline layer 3 on the
   wgmma and the f32 kernel and layer 0 on the Ci = 1 kernel, the centre
   tap's weights zeroed) must fail the same check.  The f32 kernel's
   output at baseline layer 2 must be the same bits in a second launch
   and, on a sub-window of the input, the overlap of the full output.
4. K2 (``packed_tail``) and K3 (``packed_tail2``) against their plain
   versions.  Small cases first, in bf16 (ragged box edges, odd extents,
   one and two operands, a 16-channel rest, batch > 1, logits in and out of
   the epilogue, one case on the WMMA route) and in f32 (K2's and K3's
   widths, ragged boxes, batch > 1, one to six channel blocks, Co off the
   multiples of 4, one case on the FMA route).  Then at the packed U-Net's 256^3
   covering tile: on the operands its forward hands them, launch by launch
   (each stage and the logits on the kernel's own input, and the last
   stage with the logits in its epilogue against the logits of the
   kernel's own stage output); and, timed, in the four forms ``tail_impl``
   selects ("pallas", "pallas_fold", "pallas2", "pallas_fold2") on those
   shapes with unit-scale activations, in f32 and bf16.  Every bf16 stage
   there must take the wgmma/TMA kernel and every f32 stage the f32 kernel
   of ``conv3d_f32.cu`` ("simt"; ``tail_route``).  Three broken outputs
   (a tap of stage 0 dropped, xb zeroed, a tap of the last stage dropped)
   must fail the same checks, in both dtypes; the f32 kernel's stage 0
   must give the same bits in a second launch and, on a sub-window of its
   operands, the overlap of the full output.  The tails are timed per
   stage, beside the first version of ``packed_tail.cu`` (bf16: the WMMA
   kernel, f32: the FMA kernel) on the same operands and beside the
   unfused tail as the default engine runs it (cuDNN convs, adds, ReLUs,
   the plain logits; f32 with TF32 off).
4b. K2's stage kernel as the packed engines' conv + bias + ReLU
   (``packed_conv_relu`` without grad, ``stage_bias_relu``, Co past 192 in
   output-channel slices) at the volume cells' shapes (the baseline's
   stage-A layers at batch 16, the U-Net's eight such convs on a 388^3
   tile): each call on the route, within ``tail_check``'s one-stage limit
   of the library path it replaces (cuDNN's conv rounded to bf16, then the
   bias add and the ReLU), timed beside it, the plain version and the
   bound; a zeroed tap must fail the check.
5. K5 (``parity_split_kernel``) against its plain version, bit for bit, at
   the packed baseline's and ``vgg_like``'s stage-A -> stage-B boundary
   (one tile batch), in f32 and bf16, timed beside the plain version and
   one PyTorch ``permute(...).contiguous()``.
6. K4 (``wino_conv3d_bias_relu``) against its plain version: small bf16
   cases first (ragged tiles, odd block counts, one small tile, Ci = 24, a
   16-channel rest, Ci = Co = 136, one case on the WMMA route), then on
   the packed baseline's stage-B operands (one tile batch of the 256^3
   volume, seed-0 weights), in f32 and bf16, timed beside the plain
   version, K1 (in bf16 its wgmma route at d = 1), one cuDNN call and, in
   bf16, the WMMA kernel of ``wino_conv.cu``.  Every bf16 stage-B call must
   take the wgmma/TMA kernel (``wino_route``).  Two broken outputs (a tap
   dropped, a channel zeroed) must fail the same check.
7. The plain baseline path (``packed=False``, K1): on a 48^3 volume in
   24-wide tiles, the logits behind the card's probability map must match
   the CPU's (the plain versions, same weights) in f32 and bf16.  Then
   ``FplNetwork("baseline", device="cuda", seed=0, packed=False)`` at bf16
   on a 256^3 uint8 blob volume runs ``infer``, ``detect(method="nms")``
   and ``detect(method="components")``.  K1's launch count must rise by
   exactly four per tile batch and forward (three on the wgmma route, one
   on the Ci = 1 kernel), and both detection lists must
   equal the host (numpy/scipy) reference on the same probability map.
   Times follow, and where one infer's time goes (host pad, upload,
   forwards, the rest).  The same again for the f32 model
   (``dtype=torch.float32``): K1 four launches per tile batch and forward,
   three on the f32 kernel and one on the Ci = 1 kernel, lists equal to the
   host reference, times and the infer's split.  A baseline with dilations
   (1, 1, 3, 3) (no packed
   engine takes it, so the plain stack runs) must return the CPU's map too.
8. The packed ConvStack paths, the default engine: the 48^3 map check for
   ``FplNetwork("baseline")``, then ``baseline`` and ``vgg_like`` at bf16 on
   the 256^3 volume as in 7, K5 launched once per tile batch and forward,
   K2's stage kernel (``stage_bias_relu``) once per dilation-1 lead conv
   (baseline 2, ``vgg_like`` 3) per tile batch and forward, and no other
   kernel.
9. The U-Net paths: the logits behind the card's map match the CPU's on a
   64^3 volume in 24-wide tiles, for the plain U-Net (K1) and the packed
   engine with the K2 and the K3 tail, in f32 and bf16.  Then, at bf16 on
   the 256^3 volume, each engine (the K3 tail, the K2 tail, the unfused
   default, the plain U-Net) runs infer and both detects, with the counts
   reset before and read after: K3 or K2 once per tile batch and forward,
   both of its stages on the wgmma route and none on another,
   K1 once per conv, tile batch and forward on the plain U-Net (conv 0 on
   the Ci = 1 kernel, convs 1-9 on the wgmma route), K2's stage kernel
   once per conv outside the folds, tile batch and forward on the packed
   engines (8; 7 beside a kernel tail, which runs level 0's itself), no
   other kernel.  The lists must equal the host reference; times, peak
   memory and the infer's phases follow.  The same for the f32 K3 and K2
   engines (the port's exactness mode): both stages on the f32 kernel
   ("simt") and none on another route.
10. The staged whole-volume engine, ``FplNetwork.detect_large``.  (a) On
   the 256^3 volume, the packed and plain baseline and packed ``vgg_like``
   run ``forward="roi"`` and ``"shared"`` for ``method`` "nms",
   "components" and "both" at ``default_tiling``'s tile and batch; every
   list must equal ``detect``'s on the scaled f32 volume ``vol * f32(1/255)``
   (the values the staged engine feeds the model), and each call must launch
   K5 once per tile batch and K2's stage kernel once per lead conv and tile
   batch (packed) or K1 four times (plain) and nothing else.  (b) The
   U-Net's default engine in shared mode: its lists must equal the host
   reference's on the volume's part of the shell ``shared_prob`` wrote, and
   it must launch K2's stage kernel 8 times per tile batch and nothing
   else.  Then the high-water of one tile batch's forward per input voxel
   (the figures behind ``_StreamPlan.act_bytes_per_voxel``).  (c) The north
   star: a 1024^3 uint8 volume (``make_volume_u8(1024, 128)``), the packed
   baseline at core 512, ``method="both"``, ``forward="auto"``, the
   threshold the 0.9999 quantile of a 128^3 cutout's map; staged once with
   ``stage_volume_chunked`` and reused by three timed calls (Mvox/s, the
   upload and the upload plus pad on the card, peak memory, the shared grid,
   the launches, one call split into forward and postprocess); both lists
   must equal ``detect``'s on the scaled volume at the shared grid's tile and
   batch.
11. Out-of-core streaming, ``detect_large`` on a ``(shape, read_fn)`` pair
   or with ``staged=False`` (``detect_streaming``: windows read and padded
   by a prefetch thread).  (a) On 10(a)'s volume, with its thresholds and
   plans, the same three engines run ``method="both"`` in roi and shared
   (z-band) mode; the packed baseline also with ``cc_impl="device"`` (both
   modes) and ``fused_impl="nbr"`` (roi), and through bands of one and of
   two ROI rows (core 64).  Every list must equal 10(a)'s ``detect`` lists
   and each call must launch K5 once per tile batch and K2's stage kernel
   once per lead conv and tile batch (packed) or K1 four times (plain), per
   ROI or per band, and nothing else.  (b) 10(c)'s
   volume, written once to a ``.npy`` file and read back through
   ``np.load(mmap_mode="r")`` one window at a time: ``forward="auto"`` and
   ``"shared"`` at the streaming default tiling, three calls each, and one
   ``auto`` call at 10(c)'s tile and batch.  The shared lists and those at
   10(c)'s tiling must equal 10(c)'s; ``auto`` at the default tiling takes
   the roi mode, whose ROI tile (66) is not 10(c)'s (64), and cuDNN sums
   in another order at another tile shape, so its lists must equal
   ``detect``'s at the ROI tile and batch.  Printed: Mvox/s, the mode
   ``auto`` chose and why (the band that fits, the cost gate), the bands,
   the prefetch thread's read seconds beside each call's, the peak device
   memory and the launches.

12. Training and evaluation (``Trainer``, ``forward_train``,
   ``ops/matching.py``).  (a) One step's loss and every parameter's
   gradient on the card against the CPU's plain path, same weights, a
   fixed numpy batch for each of three seeds: the full-width baseline
   (patch 34, batch 8) and the U-Net (base 24, levels 2, its smallest
   patch >= 2 context + 16, batch 2), plain and packed, f32 and bf16,
   within ``GRAD_TOL`` (a plain engine's CPU step on the card's ReLU masks
   and pool choices, of which at most ``DECISION_FLIP_FRAC`` may differ
   from the CPU's own); every parameter must have a finite gradient; one
   step launches K5 once (packed baseline), K1 four times (plain baseline)
   or ten (plain U-Net) and nothing else.  Three broken gradients must
   fail the same check: K5's output detached, K1's backward with one
   layer's dw zeroed, and TF32 allowed in the plain U-Net's step.  (b) The
   main path: ``FplNetwork("baseline", train_config=TrainConfig())`` (patch
   33, batch 32, "auto" -> packed, 100 steps an epoch) trains 3 epochs on a
   128^3 uint8 blob volume with T-bars at the blob centres, validating on a
   second volume; the loss must fall, every validation metric be finite,
   K5 launch once a step and once a validation tile batch, and K2's stage
   kernel twice a validation tile batch and never in a step.  Then
   ``detect`` -> ``evaluate``, and at one tiling ``voxel_pr_device`` and
   ``evaluate_voxels`` on both routes (device, streaming) must equal the
   host ``voxel_pr`` of the same map exactly, at the default thresholds and
   at 19 values of the map; a ``save`` / ``restore`` round trip must give
   the map bit for bit.  (c) The reference bench's ``bench_train``
   (``train_*`` plain b32, ``train_packed_*`` packed b32, ``train_b128_*``
   plain b128, and packed b128 for the crossover) on a 128^3 random uint8
   volume: steps/s and patch Mvox/s, min / median / max of 3 epochs after
   a warm-up; one step of the trainer's own split at synchronising hooks
   into sampling + augment, forward, loss + backward and Adam; whether the
   card agrees with the crossover at 96; the same-seed difference of two
   fits (reported, not required).
13. BatchNorm models, resumable ROI streaming, host-streamed tiling.
   (a) K1 with ``relu=False`` (a BatchNorm layer's conv) against its plain
   version at the baseline's four layer shapes under phase 3's limits, on
   all five routes (bf16 "wgmma" and "ci1", f32 "simt" and "ci1", the input
   off a 16-byte boundary on "wmma" (bf16) and "fma" (f32)); on each route
   the clamped output must fail the same check.  (b) The full-width BatchNorm baseline
   (``ConvStack(use_batchnorm=True)``, seed-0 conv weights, running
   statistics and affine from a seeded calibration, ``bn_state``): the
   48^3 maps, plain and packed, card against CPU under phase 7's and 8's
   limits; the 256^3 ``infer`` and both ``detect`` methods on the packed
   engine (BatchNorm folded into the epilogue, K5 once per tile batch) and
   the plain one (K1 relu=False, per-route counts exact), lists equal to the
   host reference.  (c) One f32 and one bf16 train step of it ("auto" ->
   plain) on the card and on the CPU, the CPU on the card's branch points
   (the ReLUs after BatchNorm and the head's), both held to an f64 truth on
   those branch
   points: each of the card's gradients within BN_TRUTH_RATIO times the
   CPU's own distance or GRAD_TOL, whichever is larger (BatchNorm's
   backward shrinks the gradient 30-45x below the last layer, so two f32
   steps lie further apart than 12(a)'s 1e-4; TF32 in the card's step must
   fail); the running statistics after the step (f32 within
   BN_STATS_RTOL); then three timed epochs of b32 at patch 33 beside
   12(c)'s plain b32.  (d) ``stream_rois`` over the 8 ROIs of a
   512^3 volume served by a mock DVID node on 127.0.0.1, through the
   packed baseline's ``DetectPipeline`` with ``dvid_source``,
   ``dvid_sink`` and a state file: each ROI equal to ``detect`` at the same
   tiling, the POSTs those lists in global coordinates, a second call
   doing nothing, a run stopped after 3 ROIs then resumed POSTing the same
   union; Mvox/s per ROI and in total.  (e) ``infer(host_stream=True)``
   bit for bit the whole-volume upload's map at 256^3, packed baseline and
   plain U-Net, both times printed.

14. The multi-device layer (``flypylib_tpu_torch/parallel/``,
   ``detect_large(devices=)``) on the one card, at the packed baseline's
   full width (bf16, seed-0 weights) on 10(a)'s 256^3 volume.  (a) The
   fan-out: staged ``devices=[cuda:0]`` (run as one device), ``* 2`` and
   ``* 3`` and streamed ``* 2``, roi and shared, ``method="both"`` at core
   128 and 10(a)'s tiling and threshold, and the plain baseline staged roi
   on two slots: every list bit for bit the single-device call's, K5 (K1)
   launched once (four times) per tile batch of the mode (the ROI sweep's,
   or one band grid per band of ``_band_partition``); one and two slots of
   each staged mode timed.  (b) ``sharded_infer`` over 1-D (4), 2-D
   (2, 2) and 3-D (2, 2, 2) meshes of cuda:0 slots at tile 64, batch 8:
   the map bit for bit ``TiledInference``'s at that tile and batch, K5
   once per tile batch of every shard, and ``sharded_nms`` /
   ``sharded_components`` on it equal to ``nms_host`` / ``components_host``;
   whole blocks (no ``tile_out``: cuDNN at other shapes) held to the packed
   map limit on the logits and their lists to the host reference on their
   own map; Mvox/s beside ``TiledInference``.  (c) A world of one on NCCL
   (a subprocess): the 1-D map and lists (b)'s bit for bit, and the f32 DP
   step of the full-width baseline (packed, b32, patch 34) bit for bit the
   single step, both timed.  (d) Two gloo ranks sharing the card
   (subprocesses; NCCL refuses two ranks on one GPU): the 1-D and 2-D
   meshes spanning both ranks give (b)'s map and lists bit for bit, and the
   f32 DP steps of the baseline and of the BatchNorm baseline equal the
   single step on the same global batch (loss rtol 1e-5, parameters atol
   1e-5 where the gradient is not 0 up to its limit, gradients 1e-4 of the
   largest; the BatchNorm baseline's gradients, each step's against an f64
   truth on the global batch, the DP step's within max(1e-4, 2 x the single
   step's distance), as 13(c): the DP step and the truth on the single
   step's branch points), the loss the same on both ranks; two
   broken controls (local mask counts, per-rank BatchNorm moments) must
   fail that check.  Times are one card's: the cost of the fan-out, not a
   scaling.

Every count of launches is set to 0 just before a path runs and read just
after it.  The line before the last but one is one JSON object with each
kernel's launches, error, times and bound (the least time the card could
take: bytes over 3.35 TB/s or operations over the dtype's dense peak, 989
TFLOP/s bf16 or 67 f32, the H100 SXM's figures) and, for K1 and K5, their
launches per train step; then the card; the last line is ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
VOLUME = 256     # the 256^3 end-to-end volume of the reference's bench
N_BLOBS = 16     # size // 16 blobs, as the reference's bench
N_CAND = 2000    # the operating threshold leaves about this many voxels
F32_RTOL = 1e-4  # f32: max |kernel - plain| <= F32_RTOL * max |plain|
# bf16: every element within one bf16 ulp of the plain value, where
# magnitudes below BF16_FLOOR * max|plain| count as that floor (both sides
# accumulate in f32 in different orders, so a value near 0 may round to
# either side of it)
BF16_FLOOR = 2.0**-8
TAIL_CHAIN_TOL = 2e-2  # K2/K3 chains with logits, bf16 (see tail_check)
SMALL = 48       # volume of the card-vs-CPU map check
SMALL_TILING = (24, 3)  # tile_out, batch: 8 tiles in 3 batches, the last
                        # padded, so stitching is inside the check
# card vs CPU: max |logit difference|, the logits being log p - log1p(-p)
# of the two maps (an untrained map's probabilities sit near 1e-6, so a
# limit on them would pass an all-zero map).  On an H100 the sound path
# read 4.2e-05-5.7e-05 (f32) and 0.093-0.189 (bf16) over three volumes;
# one body layer broken in memory (a tap dropped, a channel or an x column
# zeroed) read 0.72 or more in either dtype, every bf16 output of one
# layer one ulp high 0.43-0.53, and f32 convs on TF32 0.023 (PERF.md).
LOGIT_TOL_F32 = 1e-3
LOGIT_TOL_BF16 = 0.3
UNET_SMALL = 64  # volume of the U-Net card-vs-CPU map check
UNET_TILING = (24, 3)  # 27 tiles in 9 batches: stitching is inside the check
# card vs CPU, U-Net logits: max |logit difference|.  On an H100 the sound
# path read 5.4e-05-1.09e-04 (f32) and 0.102-0.144 (bf16) over three
# volumes and the three engines; one kernel output broken in memory (a tap
# dropped, a channel or an x column zeroed) read 5.5 or more in either
# dtype, and every stage-0 (or conv 8) output one bf16 ulp high 0.336
# (PERF.md).
UNET_LOGIT_TOL_F32 = 1e-3
UNET_LOGIT_TOL_BF16 = 0.25
# the plain three-level U-Net (context 44): a map of 8 tiles of 20^3 (tile in
# 108, stride 16) in 4 batches, and one tile batch's logits against the
# CPU's, relative to max |logit|.  scripts/probe_deep_unet_limit.py on an
# H100, volume seeds 1-3: sound 1.6e-06-2.1e-06 (f32) and 0.0043-0.0088
# (bf16); the second 96-channel launch of the Co = 192 bottleneck convs
# zeroed or written one channel off reads 8.9e-04-1.9e-03 in f32 and
# 0.0049-0.0091 in bf16.  So the f32 limit catches such a fault, and the
# bf16 limit only bounds the rounding: an untrained bottleneck moves the
# logits less than bf16 rounds them (PERF.md).
DEEP_UNET_SMALL = 36
DEEP_UNET_TILING = (20, 2)
DEEP_UNET_RTOL_F32 = 1e-4
DEEP_UNET_RTOL_BF16 = 1e-2
# the 256^3 U-Net engines: tail_impl, or "plain" for packed=False
UNET_ENGINES = ("pallas2", "pallas", "xla", "plain")
# the packed baseline's map check, card vs CPU, max |logit difference|.
# scripts/probe_packed_limits.py on an H100, volume seeds 1-3: sound
# 4.8e-05-5.7e-05 (f32) and 0.103-0.160 (bf16); K5's output broken in
# memory (a channel or an x column zeroed) 1.72 or more in either dtype;
# every output of stage B's first conv one bf16 ulp high 0.378-0.407
# (PERF.md).
PACKED_LOGIT_TOL_F32 = 1e-3
PACKED_LOGIT_TOL_BF16 = 0.25
# K4 in bf16 against its plain version (same rounding points, f32 sums in
# other orders): at most WINO_BF16_ULPS bf16 ulps of max(|ref|, BF16_FLOOR
# max|ref|) per element.  On an H100 at the stage-B operands the sound
# reading was 1 ulp, a dropped tap 3.3e4 ulps or more and a zeroed channel
# 212 or more; check_wino_kernel asserts both broken outputs fail it.
WINO_BF16_ULPS = 2.0
WINO_F32_TOL = 1e-4  # f32: |err| <= tol + tol |ref|, the JAX test's
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, H100 SXM
NMS_WINDOW = 5   # FplNetwork.detect's default window
CONF_TOL = 1e-6
CENTROID_TOL = 1e-5


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    require(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


def import_port():
    """Import the port from this checkout, and only from it."""
    require((ROOT / "flypylib_tpu_torch" / "__init__.py").is_file(),
            f"no flypylib_tpu_torch package beside chip_smoke.py in {ROOT}: "
            "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import flypylib_tpu_torch

    where = Path(flypylib_tpu_torch.__file__).resolve().parent.parent
    require(where == ROOT, f"flypylib_tpu_torch imported from {where}, "
                           f"not from this checkout {ROOT}")
    return flypylib_tpu_torch


def make_volume_u8(size: int, n_blobs: int, seed: int = 0,
                   with_centers: bool = False):
    """uint8 ``(size,)*3`` volume: noise around 25 plus Gaussian blobs that
    peak at 255 (the reference bench's synthetic volume, in numpy); with
    ``with_centers`` also the blobs' (n_blobs, 3) centres."""
    rng = np.random.default_rng(seed)
    vol = np.empty((size,) * 3, np.uint8)
    step = max(1, (1 << 27) // (size * size))  # ~128 MB f32 slabs
    for z0 in range(0, size, step):
        z1 = min(size, z0 + step)
        sl = rng.normal(0.1, 0.05, (z1 - z0, size, size)).astype(np.float32)
        vol[z0:z1] = (np.clip(sl, 0, 1) * 255).astype(np.uint8)
    centers = rng.integers(5, size - 5, (n_blobs, 3))
    g = np.arange(-4, 5)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    blob = (np.exp(-(zz**2 + yy**2 + xx**2) / (2 * 2.0**2)) * 255).astype(
        np.uint8)
    for c in centers:
        sl = tuple(slice(c[i] - 4, c[i] + 5) for i in range(3))
        vol[sl] = np.maximum(vol[sl], blob)
    return (vol, centers) if with_centers else vol


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at ``v`` (f32, > 0): 2^(floor(log2 v) - 7)."""
    _, e = torch.frexp(v)  # v = m * 2^e with m in [0.5, 1)
    return torch.ldexp(torch.ones_like(v), e - 8)


def conv_check(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max |got - ref|, whether it is within the tolerance for the dtype)."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    scale = float(r.abs().max())
    if got.dtype == torch.float32:
        ok = float(err.max()) <= F32_RTOL * scale
    else:
        mag = torch.clamp(r.abs(), min=BF16_FLOOR * scale)
        ok = bool((err <= bf16_ulp(mag)).all())
    return float(err.max()), ok


def bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| in bf16 ulps of max(|ref|, BF16_FLOOR max|ref|)."""
    g, r = got.float(), ref.float()
    mag = torch.clamp(r.abs(), min=BF16_FLOOR * float(r.abs().max()))
    return float(((g - r).abs() / bf16_ulp(mag)).max())


def wino_check(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max |got - ref|, whether it is within K4's tolerance): f32 |err| <=
    WINO_F32_TOL (1 + |ref|) elementwise; bf16 at most WINO_BF16_ULPS ulps."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if got.dtype == torch.float32:
        ok = bool((err <= WINO_F32_TOL * (1 + r.abs())).all())
    else:
        ok = bf16_ulps(got, ref) <= WINO_BF16_ULPS
    return float(err.max()), ok


def bound(flops: float, nbytes: float,
          dtype: torch.dtype = torch.bfloat16) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations over the dtype's peak."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cudnn_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               dilation: int = 1) -> torch.Tensor:
    """One cuDNN call computing K1's conv and bias in ``x.dtype`` on the
    NDHWC (channels-last) operand: the library yardstick, not the port."""
    dt = x.dtype
    return torch.nn.functional.conv3d(
        x.permute(0, 4, 1, 2, 3), w.to(dt).permute(4, 3, 0, 1, 2), b.to(dt),
        dilation=dilation)


def tail_check(got: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype,
               pre: torch.Tensor | None = None) -> tuple[float, bool]:
    """(max |got - ref|, whether it is within the tolerance) for K2 / K3
    against the plain version, the model being in ``dtype``.

    - f32: max |err| <= F32_RTOL * max |ref|, as :func:`conv_check`.
    - bf16, one stage (``pre``: the plain version's conv sum rounded to
      bf16, before the bias): within one ulp at each of the stage's two
      rounding points, ulp(|pre|) + ulp(|out|), each magnitude floored at
      BF16_FLOOR times its maximum as in :func:`conv_check`.  One ulp of
      the output alone, K1's limit, is too tight here: where the bias
      cancels the conv sum, a one-ulp flip of the sum is many ulps of the
      output.
    - bf16 chains with logits (f32 out): rtol = atol = TAIL_CHAIN_TOL, the
      JAX package's own test's for this kernel."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    scale = float(r.abs().max())
    if dtype == torch.float32:
        return float(err.max()), float(err.max()) <= F32_RTOL * scale
    if pre is None:
        ok = bool((err <= TAIL_CHAIN_TOL * (1 + r.abs())).all())
        return float(err.max()), ok
    p = pre.float().abs()
    bound = bf16_ulp(torch.clamp(p, min=BF16_FLOOR * float(p.max())))
    mag = torch.maximum(r.abs(), g.abs())
    bound += bf16_ulp(torch.clamp(mag, min=BF16_FLOOR * scale))
    return float(err.max()), bool((err <= bound).all())


def median_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    """Median CUDA-event time of ``fn()`` over ``iters`` runs, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def median_s(fn, iters: int = 3) -> float:
    """Median host-clock seconds of ``fn()``, each run ending in a sync."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# K1 past the widths and dilations of the zoo's defaults, small, one per
# route and dtype: a dilation of 3 (a baseline with dilations (1, 1, 3, 3)),
# Co = 192 (the three-level U-Net's bottleneck, two 96-wide N blocks on the
# wgmma route), Co = 192 at d = 3 and Co = 136 at d = 2 on the Ci = 1 kernel
# (two launches of at most 128 channels) and widths off the multiples of 8 (bf16: the WMMA
# kernel's N blocks; f32: the f32 kernel's channel blocks of 48, and at Ci = 6,
# off the multiples of 4, the first-version FMA kernel's).
# (label, B, size, Ci, Co, d)
WIDE_CONV_CASES = (
    ("wide d=3", 2, 21, 32, 48, 3),
    ("wide Co=192", 2, 15, 96, 192, 1),
    ("wide Ci=1 Co=192 d=3", 2, 21, 1, 192, 3),
    ("wide Ci=1 Co=136 d=2", 2, 17, 1, 136, 2),
    ("wide Ci=12 Co=136 d=3", 2, 19, 12, 136, 3),
    ("wide Ci=6 Co=20 d=2", 2, 15, 6, 20, 2),
)


def conv_cases():
    """(label, B, input size, Ci, Co, dilation) of K1 on the main path:
    the baseline's four body layers, vgg_like's first layer (Ci = 1 into
    32) and its 64 -> 96, d=4 layer, and the plain U-Net's ten convs, at ``default_tiling``'s tile and batch for a
    VOLUME^3 volume, then WIDE_CONV_CASES.  The U-Net's extents (pooled,
    cropped) are recorded by a hook on each conv in one forward of a zero
    tile on the card."""
    from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
    from flypylib_tpu_torch.models.zoo import baseline_model, unet, vgg_like

    cases = []
    for spec, layers in ((baseline_model(), (0, 1, 2, 3)), (vgg_like(), (0, 6))):
        tile_out, batch = default_tiling(spec, (VOLUME,) * 3)
        s = TiledInference(spec, tile_out, batch).tile_in
        for i, conv in enumerate(spec.module.convs):
            _, _, _, ci, co = conv.weight.shape
            if i in layers:
                cases.append((f"{spec.name} layer {i}", batch, s, ci, co,
                              conv.dilation))
            s -= 2 * conv.dilation
    spec = unet(seed=0)
    module = spec.module.to("cuda").eval()
    tile_out, batch = default_tiling(spec, (VOLUME,) * 3)
    tin = TiledInference(spec, tile_out, batch).tile_in
    seen = []
    hooks = [conv.register_forward_pre_hook(
        lambda m, inp: seen.append((m, tuple(inp[0].shape))))
        for conv in module.convs]
    try:
        with torch.no_grad():
            module(torch.zeros((batch, tin, tin, tin, 1), dtype=torch.uint8,
                               device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    require(len(seen) == len(module.convs), f"unet: {len(seen)} convs ran")
    for i, (conv, (b, s, sy, sx, ci)) in enumerate(seen):
        require(s == sy == sx and conv is module.convs[i], "unet conv walk")
        cases.append((f"unet conv {i}", b, s, ci, conv.weight.shape[4],
                      conv.dilation))
    del module
    torch.cuda.empty_cache()
    return cases + list(WIDE_CONV_CASES)


def simt_bitwise(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int,
                 got: torch.Tensor, label: str, card_str: str) -> None:
    """The f32 kernel is blind to placement and to the run: a second launch
    gives ``got``'s bits, and the output of a sub-window of ``x`` (offset
    5, 3, 11: another box grid, every voxel at another place in its box)
    is bit for bit the overlap of ``got``."""
    from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, simt_plan

    again = conv3d_bias_relu(x, w, b, d)
    sub = x[:, 5:, 3:, 11:].contiguous()
    part = conv3d_bias_relu(sub, w, b, d)
    torch.cuda.synchronize()
    want = got[:, 5:, 3:, 11:]
    same, window = torch.equal(again, got), torch.equal(part, want)
    print(f"K1 {label} float32 [simt]: a second launch bit for bit "
          f"{same}; sub-window {tuple(sub.shape)} (box "
          f"{simt_plan(tuple(part.shape[1:4]), d, w.shape[-1])[:3]} against "
          f"{simt_plan(tuple(got.shape[1:4]), d, w.shape[-1])[:3]}) bit for "
          f"bit the full output's overlap {window} [{card_str}]", flush=True)
    require(same and window, f"K1 {label} f32: the simt kernel's bits follow "
                             "the run or the box")


def check_kernels(card_str: str) -> dict:
    """K1 against its plain version at every case, in f32 and bf16."""
    from flypylib_tpu_torch.ops.conv import (SIMT_MAX_DILATION,
                                             conv3d_bias_relu, conv3d_reference,
                                             k1_route)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("plain version: cudnn.allow_tf32=False, "
          "float32_matmul_precision='highest'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_main = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
                 "library_ms": 0.0, "bound_ms": 0.0, "op_ms": 0.0,
                 "routes": {}}
    broken_done = set()  # the routes whose zeroed-tap control ran
    wide_routes = set()  # the routes WIDE_CONV_CASES ran on
    unet_sum = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    # the f32 kernel ("simt"): baseline layers 1-3 and U-Net convs 1-9
    simt = {group: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                                  "max_abs_err"), 0.0)
            for group in ("baseline", "unet")}
    for label, B, S, Ci, Co, d in conv_cases():
        for dtype in (torch.float32, torch.bfloat16):
            shape = (B, S, S, S, Ci)
            if Ci == 1:  # raw uint8 voxel values, as layer 0 sees them
                x = torch.randint(0, 256, shape, generator=gen, device="cuda")
            else:        # post-ReLU activations
                x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
            x = x.to(dtype)
            w = torch.randn((3, 3, 3, Ci, Co), generator=gen, device="cuda")
            w = w / math.sqrt(27 * Ci)
            b = 0.1 * torch.randn((Co,), generator=gen, device="cuda")
            route = k1_route(x, w, d)
            dt = str(dtype).replace("torch.", "")
            if dtype == torch.bfloat16 and Ci > 1 and Ci % 8 == Co % 8 == 0:
                require(route == "wgmma", f"K1 {label} {dt}: route {route}, "
                                          "not the wgmma kernel")
            if (dtype == torch.float32 and Ci > 1 and Ci % 4 == 0
                    and d <= SIMT_MAX_DILATION):
                require(route == "simt", f"K1 {label} {dt}: route {route}, "
                                         "not the f32 kernel")
            got = conv3d_bias_relu(x, w, b, d)
            ref = conv3d_reference(x, w, b, d)
            torch.cuda.synchronize()
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"K1 {label}: {tuple(got.shape)} {got.dtype} vs "
                    f"{tuple(ref.shape)} {ref.dtype}")
            err, ok = conv_check(got, ref)
            ms = median_ms(lambda: conv3d_bias_relu(x, w, b, d))
            plain = median_ms(lambda: conv3d_reference(x, w, b, d))
            lib = median_ms(lambda: cudnn_conv(x, w, b, d))
            flops = 2 * 27 * Ci * got.numel()
            bnd, by = bound(flops, nbytes(x, w, b, got), dtype)
            print(f"K1 {label} x{tuple(x.shape)} -> {tuple(got.shape)} d={d} "
                  f"{dt} [{route}]: max|err| {err:.6g} (max|ref| "
                  f"{float(ref.float().abs().max()):.6g}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, cuDNN {lib:.4f} ms, bound {bnd:.4f} ms "
                  f"({by}) [{card_str}]", flush=True)
            require(ok, f"K1 {label} {dt}: outside tolerance (max|err| {err})")
            if (route, label) in (("wgmma", "baseline layer 3"),
                                  ("ci1", "baseline layer 0"),
                                  ("simt", "baseline layer 3")):
                # the centre tap's weights zeroed: the check must see it
                w_broken = w.clone()
                w_broken[1, 1, 1] = 0
                bad = conv3d_bias_relu(x, w_broken, b, d)
                berr, bok = conv_check(bad, ref)
                print(f"K1 {label} {dt} [{route}], centre tap zeroed: max|err| "
                      f"{berr:.6g} {'ok' if bok else 'FAIL'} (must fail)",
                      flush=True)
                require(not bok, "K1: the check passes a zeroed tap")
                broken_done.add(route)
                del bad, w_broken
            if dtype == torch.bfloat16 and label.startswith("baseline"):
                per = bf16_main["routes"].setdefault(route, dict.fromkeys(
                    ("ms", "plain_ms", "library_ms", "bound_ms"), 0.0))
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bnd)):
                    per[key] += v
                bf16_main["ms"] += ms
                bf16_main["plain_ms"] += plain
                bf16_main["max_abs_err"] = max(bf16_main["max_abs_err"], err)
                bf16_main["library_ms"] += lib
                bf16_main["bound_ms"] += bnd
                if by == "operations":
                    bf16_main["op_ms"] += bnd
            if route == "simt" and label == "baseline layer 2":
                simt_bitwise(x, w, b, d, got, label, card_str)
            group = label.split(" ")[0]
            if route == "simt" and group in simt:
                tot = simt[group]
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bnd)):
                    tot[key] += v
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if label.startswith("wide"):
                wide_routes.add(route)
            if label.startswith("unet"):
                unet_sum[dtype][0] += ms
                unet_sum[dtype][1] += plain
            del x, w, b, got, ref
    for dtype, (ms, plain) in unet_sum.items():
        print(f"K1 unet convs 0-9 summed, {str(dtype).replace('torch.', '')}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms [{card_str}]")
    for group, convs in (("baseline", "layers 1-3"), ("unet", "convs 1-9")):
        t = simt[group]
        print(f"K1 {group} {convs} summed, float32 [simt]: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, cuDNN "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"(operations; {t['bound_ms'] / t['ms']:.1%} of the f32 FMA "
              f"rate) [{card_str}]", flush=True)
    require(broken_done == {"wgmma", "ci1", "simt"},
            f"K1: the zeroed-tap controls ran on {sorted(broken_done)} only")
    require(wide_routes == {"wgmma", "wmma", "ci1", "simt", "fma"},
            f"K1: the wide cases ran on {sorted(wide_routes)} only")
    torch.cuda.empty_cache()
    # the summed bound is bounded by what bounds the larger share of it
    op_ms = bf16_main.pop("op_ms")
    bf16_main["bound_by"] = ("operations" if 2 * op_ms >= bf16_main["bound_ms"]
                             else "bytes")
    bf16_main["simt"] = {**simt["baseline"], "bound_by": "operations",
                         "unet_convs_1_9": simt["unet"]}
    return bf16_main


def tail_inputs(dtype: torch.dtype) -> tuple[dict, dict, int]:
    """What reaches K2 and K3 on the main path: the packed U-Net (seed 0
    weights) runs one 256^3 covering tile of a blob volume once per kernel,
    and the arguments its tail hands ``packed_tail`` ("pallas") and
    ``packed_tail2`` ("pallas2") are kept.  Returns them as captured, the
    same with the activations replaced by post-ReLU unit normals of the
    same shapes (K1's inputs, the scale the chain tolerance is set for: the
    forward's own stage outputs reach ~140, where one bf16 ulp is 1), and
    the tile's input extent."""
    from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
    from flypylib_tpu_torch.models.zoo import unet
    from flypylib_tpu_torch.ops import packed_unet

    seen = {}
    spec = unet(seed=0, dtype=dtype)
    for impl, name in (("pallas", "packed_tail"), ("pallas2", "packed_tail2")):
        pspec = packed_unet.packed_unet_spec(spec, tail_impl=impl)
        module = pspec.module.to("cuda").eval()
        tin = TiledInference(pspec, *default_tiling(pspec, (VOLUME,) * 3)).tile_in
        x = torch.from_numpy(make_volume_u8(tin, N_BLOBS, seed=2)).cuda()
        wrapper = getattr(packed_unet, name)

        def keep(*args, _name=name, _wrapper=wrapper):
            seen[_name] = args
            return _wrapper(*args)

        setattr(packed_unet, name, keep)
        try:
            with torch.no_grad():
                module(x[None, ..., None])
        finally:
            setattr(packed_unet, name, wrapper)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def unit(t):
        return torch.relu(torch.randn(t.shape, generator=gen, device="cuda")
                          ).to(t.dtype)

    xin, stages, lg = seen["packed_tail"]
    sc, xu, stage0, stages2, lg2 = seen["packed_tail2"]
    unit_seen = {"packed_tail": (unit(xin), stages, lg),
                 "packed_tail2": (unit(sc), unit(xu), stage0, stages2, lg2)}
    torch.cuda.synchronize()
    return seen, unit_seen, tin


def check_tail_stagewise(seen: dict, dtype: torch.dtype, tin: int,
                         card_str: str) -> None:
    """K2 and K3 on the operands the forward really hands them, launch by
    launch: every stage and the logits get the kernel's own output of the
    step before as input on both sides, so each is held to a single step's
    bound (:func:`tail_check` with the plain conv sum for a stage; for the
    logits, an f32 sum of exact products in another order, F32_RTOL times
    the largest sum of |products|).  The whole chain's gap on these
    operands is printed too: in bf16 it carries every stage's one-ulp
    flips forward, so it has no bound of its own."""
    from flypylib_tpu_torch.ops.conv import conv3d_f32, matmul_f32
    from flypylib_tpu_torch.ops.tail import (logits_reference, packed_tail,
                                             packed_tail2, tail2_reference,
                                             tail_reference)

    xin, stages, lg = seen["packed_tail"]
    sc, xu, stage0, stages2, lg2 = seen["packed_tail2"]
    wa, wb, _ = stage0
    chains = {
        # kernel: (stage 0 on the card, its plain version, its rounded conv
        #          sum, the stages after it, logits, whole chain on both)
        "K2": (lambda: packed_tail(xin, stages[:1]),
               lambda: tail_reference(xin, stages[:1]),
               lambda: conv3d_f32(xin, stages[0][0].to(dtype)).to(dtype),
               stages[1:], lg, lambda: packed_tail(xin, stages, lg),
               lambda: tail_reference(xin, stages, lg)),
        "K3": (lambda: packed_tail2(sc, xu, stage0),
               lambda: tail2_reference(sc, xu, stage0),
               lambda: (conv3d_f32(sc, wa.to(dtype))
                        + conv3d_f32(xu, wb.to(dtype))).to(dtype),
               stages2, lg2, lambda: packed_tail2(sc, xu, stage0, stages2, lg2),
               lambda: tail2_reference(sc, xu, stage0, stages2, lg2)),
    }
    dt = str(dtype).replace("torch.", "")
    for kname, (k0, p0, pre0, rest, logit_ops, whole_k, whole_p) in chains.items():
        steps = [("stage 0", k0, p0, pre0)]
        for i, (w, b) in enumerate(rest, 1):
            steps.append((f"stage {i}",
                          lambda w=w, b=b: packed_tail(cur, [(w, b)]),
                          lambda w=w, b=b: tail_reference(cur, [(w, b)]),
                          lambda w=w: conv3d_f32(cur, w.to(dtype)).to(dtype)))
        cur = prev = None
        for step, kern, plain, pre in steps:
            prev = cur
            got, ref = kern(), plain()
            err, ok = tail_check(got, ref, dtype, pre())
            print(f"{kname} real operands {step} -> {tuple(got.shape)} {dt} "
                  f"(tile in {tin}): max|err| {err:.6g} (max|ref| "
                  f"{float(ref.float().abs().max()):.6g}) "
                  f"{'ok' if ok else 'FAIL'} [{card_str}]", flush=True)
            require(ok, f"{kname} {step} {dt} on real operands: outside "
                        f"tolerance (max|err| {err})")
            cur = got
            del ref
        wl, bl = logit_ops
        got = packed_tail(cur, [], logit_ops)
        ref = logits_reference(cur, wl, bl)
        mags = matmul_f32(cur.abs(), wl.to(dtype).abs())
        err = float((got - ref).abs().max())
        ok = err <= F32_RTOL * float(mags.max())
        print(f"{kname} real operands logits -> {tuple(got.shape)} {dt}: "
              f"max|err| {err:.6g} (limit {F32_RTOL:g} x max sum|products| "
              f"{float(mags.max()):.6g}) {'ok' if ok else 'FAIL'} "
              f"[{card_str}]", flush=True)
        require(ok, f"{kname} logits {dt} on real operands: outside tolerance "
                    f"(max|err| {err})")
        # the last stage with the logits in its launch (bf16: in the wgmma
        # kernel's epilogue, the stage output never stored) against the
        # logits of the kernel's own stage output, to the same bound
        got = packed_tail(prev, rest[-1:], logit_ops)
        err = float((got - ref).abs().max())
        ok = err <= F32_RTOL * float(mags.max())
        print(f"{kname} real operands last stage + logits in one call -> "
              f"{tuple(got.shape)} {dt}: max|err| {err:.6g} against the "
              f"logits of the stage's own output {'ok' if ok else 'FAIL'} "
              f"[{card_str}]", flush=True)
        require(ok, f"{kname} last stage + logits {dt} on real operands: "
                    f"outside tolerance (max|err| {err})")
        del got, ref, mags, cur, prev
        got, ref = whole_k(), whole_p()
        print(f"{kname} real operands whole chain {dt}: max|err| "
              f"{float((got - ref).abs().max()):.6g} (max|ref| "
              f"{float(ref.abs().max()):.6g}; reading, no limit) "
              f"[{card_str}]", flush=True)
        del got, ref
    torch.cuda.empty_cache()


def tail_bound(operands, out: torch.Tensor, stage_weights,
               wl: torch.Tensor) -> tuple[float, str]:
    """:func:`bound` of a K2 / K3 chain: each 2^3 stage's products (stage i
    of ``stage_weights`` lists its weights, K3's stage 0 two of them) and
    the logits', with the operands, weights and output moved once."""
    x = operands[0]
    bsz, d, h, w, _ = x.shape
    flops, moved = 0, nbytes(*operands, out)
    for i, ws in enumerate(stage_weights, 1):
        n = bsz * (d - i) * (h - i) * (w - i)  # the stage's output voxels
        for wt in ws:
            flops += 2 * n * wt.numel()
            moved += wt.numel() * x.element_size()
    flops += 2 * (out.numel() // out.shape[-1]) * wl.numel()
    return bound(flops, moved, x.dtype)


# K2 / K3 at small shapes, bf16: ((B, D, H, W), Ca, Cb, Co, stages after the
# first, logits, the route of stage 0)
TAIL_SMALL_CASES = (
    ((2, 9, 10, 11), 240, 0, 192, 1, 8, "wgmma"),   # K2's widths: a 16-channel
                                                    # rest, batch 2, ragged boxes
    ((1, 7, 12, 19), 192, 48, 192, 1, 8, "wgmma"),  # K3's widths, odd extents
    ((2, 5, 6, 37), 192, 48, 192, 0, 0, "wgmma"),   # one stage, stored
    ((1, 9, 9, 9), 8, 0, 8, 0, 0, "wgmma"),         # one 16-channel slice alone
    ((1, 6, 7, 8), 16, 8, 24, 1, 3, "wgmma"),       # three logits
    ((3, 4, 5, 6), 40, 24, 56, 2, 8, "wgmma"),      # three stages, batch 3, Co
                                                    # between the N tiles
    ((1, 3, 3, 70), 48, 16, 40, 0, 5, "wgmma"),     # one stage with logits
    ((1, 12, 11, 10), 64, 0, 128, 1, 8, "wgmma"),   # Cb = 0, two full slices
    ((1, 5, 6, 7), 16, 0, 16, 0, 10, "wgmma"),      # more logits than the
                                                    # epilogue takes
    ((2, 6, 7, 8), 20, 12, 44, 1, 3, "wmma"),       # off the multiples of 8
)


# the same in f32: every on-rule stage on the f32 kernel ("simt", channel
# blocks of at most 32)
TAIL_SMALL_F32_CASES = (
    ((2, 9, 10, 11), 240, 0, 192, 1, 8, "simt"),  # K2's widths, batch 2,
                                                  # ragged boxes
    ((1, 7, 12, 19), 192, 48, 192, 1, 8, "simt"),  # K3's widths, odd extents
    ((2, 5, 6, 37), 192, 48, 192, 0, 0, "simt"),   # one stage, stored
    ((1, 9, 9, 9), 4, 0, 8, 0, 0, "simt"),         # one slice alone
    ((3, 4, 5, 6), 40, 24, 56, 2, 8, "simt"),      # three stages, batch 3
    ((1, 3, 3, 70), 48, 16, 136, 0, 5, "simt"),    # five channel blocks
                                                   # (4 x 32 + 8), logits apart
    ((1, 12, 11, 10), 64, 0, 128, 1, 8, "simt"),   # Cb = 0, four blocks of 32
    ((2, 6, 7, 8), 20, 12, 44, 1, 3, "simt"),      # off the multiples of 8
    ((1, 6, 7, 9), 8, 4, 10, 0, 0, "simt"),        # Co off the multiples of
                                                   # 4: scalar stores
    ((2, 6, 7, 8), 18, 10, 42, 1, 3, "fma"),       # off the multiples of 4
)


def tail_operands(shape, ca, cb, co, n_after, n_logits, seed=0,
                  dtype=torch.bfloat16):
    """Seeded operands of a K2 (``cb`` = 0) or K3 chain on the card, the
    activations in ``dtype``: ``(xa, xb or None, (wa, wb or None, b0),
    stages, logits or None)``."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")

    xa = torch.relu(rnd(*shape, ca)).to(dtype)
    xb = torch.relu(rnd(*shape, cb)).to(dtype) if cb else None
    k = 8 * (ca + cb)
    stage0 = (rnd(2, 2, 2, ca, co, scale=k ** -0.5),
              rnd(2, 2, 2, cb, co, scale=k ** -0.5) if cb else None,
              rnd(co, scale=0.1))
    stages = [(rnd(2, 2, 2, co, co, scale=(8 * co) ** -0.5), rnd(co, scale=0.1))
              for _ in range(n_after)]
    lg = ((rnd(co, 2 * n_logits, scale=co ** -0.5), rnd(n_logits))
          if n_logits else None)
    return xa, xb, stage0, stages, lg


def run_tail(xa, xb, stage0, stages, lg, plain=False):
    """The chain of :func:`tail_operands` through K2 or K3, or with
    ``plain`` through its plain version."""
    from flypylib_tpu_torch.ops import tail

    wa, wb, b0 = stage0
    if xb is None:
        fn = tail.tail_reference if plain else tail.packed_tail
        return fn(xa, [(wa, b0)] + stages, lg)
    fn = tail.tail2_reference if plain else tail.packed_tail2
    return fn(xa, xb, stage0, stages, lg)


def check_tail_small(card_str: str) -> None:
    """K2 and K3 against their plain versions at TAIL_SMALL_CASES (bf16)
    and TAIL_SMALL_F32_CASES, each on the route the case names, by
    :func:`tail_check`."""
    from flypylib_tpu_torch.ops import tail
    from flypylib_tpu_torch.ops.conv import conv3d_f32

    cases = ([(c, torch.bfloat16) for c in TAIL_SMALL_CASES]
             + [(c, torch.float32) for c in TAIL_SMALL_F32_CASES])
    for (shape, ca, cb, co, n_after, n_logits, route), dtype in cases:
        ops = tail_operands(shape, ca, cb, co, n_after, n_logits, dtype=dtype)
        xa, xb, (wa, wb, _), _, _ = ops
        wrapper = tail.packed_tail if xb is None else tail.packed_tail2
        require(tail.tail_route(xa, xb, wa) == route,
                f"tail {shape} {ca}+{cb}->{co}: route "
                f"{tail.tail_route(xa, xb, wa)}, not {route}")
        before = dict(wrapper.routes)
        got, ref = run_tail(*ops), run_tail(*ops, plain=True)
        torch.cuda.synchronize()
        ran = {r: n - before[r] for r, n in wrapper.routes.items() if n != before[r]}
        pre = None
        if (dtype == torch.bfloat16 and n_after == 0
                and not n_logits):  # one bf16 stage: the two-rounding bound
            pre = conv3d_f32(xa, wa.bfloat16())
            if xb is not None:
                pre = pre + conv3d_f32(xb, wb.bfloat16())
            pre = pre.bfloat16()
        err, ok = tail_check(got, ref, dtype, pre)
        dt = str(dtype).replace("torch.", "")
        print(f"{'K2' if xb is None else 'K3'} small x{shape} {ca}+{cb}->{co} "
              f"x{1 + n_after} logits {n_logits} {dt} {ran}: max|err| "
              f"{err:.6g} {'ok' if ok else 'FAIL'} [{card_str}]", flush=True)
        require(got.shape == ref.shape and got.dtype == ref.dtype and ok,
                f"tail {shape} {ca}+{cb}->{co}: outside tolerance ({err})")
        require(ran == {route: 1 + n_after},
                f"tail {shape} {ca}+{cb}->{co}: stages ran on {ran}")


def unfused_tail(xa, xb, stage0, stages, lg) -> torch.Tensor:
    """The tail as the packed U-Net's default engine runs it (its
    ``tail_impl="xla"``): every stage a cuDNN conv rounded to bf16 (K3's
    first stage two of them, added), a bias add and a ReLU pass, then the
    plain logits.  The yardstick beside K2 and K3, not the port's path."""
    from flypylib_tpu_torch.ops.packed_conv import _conv
    from flypylib_tpu_torch.ops.tail import logits_reference

    wa, wb, b0 = stage0
    dt = xa.dtype
    y = _conv(xa, wa) if xb is None else _conv(xa, wa) + _conv(xb, wb)
    x = torch.relu(y + b0.to(dt))
    for w, b in stages:
        x = torch.relu(_conv(x, w) + b.to(dt))
    return logits_reference(x, *lg)


def check_tail_controls(kname, ops, card_str: str) -> None:
    """Broken outputs of the chain ``ops`` (:func:`tail_operands`' layout)
    must fail :func:`tail_check`: one tap of stage 0's weights dropped and,
    for K3, xb zeroed, on stage 0 alone (bf16: the two-rounding bound); one
    tap of the last stage dropped, on the whole chain with the logits
    (bf16: in the epilogue, the chain tolerance).  In f32 every check is
    F32_RTOL of max |plain|."""
    from flypylib_tpu_torch.ops.conv import conv3d_f32

    xa, xb, (wa, wb, b0), stages, lg = ops
    dt = xa.dtype
    ref0 = run_tail(xa, xb, (wa, wb, b0), [], None, plain=True)
    pre = conv3d_f32(xa, wa.to(dt))
    if xb is not None:
        pre = pre + conv3d_f32(xb, wb.to(dt))
    pre = pre.to(dt)
    wa_drop = wa.clone()
    wa_drop[1, 1, 1] = 0
    broken = {"stage 0, a tap dropped":
              (run_tail(xa, xb, (wa_drop, wb, b0), [], None), ref0, pre)}
    if xb is not None:
        broken["stage 0, xb zeroed"] = (
            run_tail(xa, torch.zeros_like(xb), (wa, wb, b0), [], None), ref0, pre)
    del wa_drop
    w_last, b_last = stages[-1]
    w_drop = w_last.clone()
    w_drop[0, 1, 0] = 0
    broken["whole chain, a tap of the last stage dropped"] = (
        run_tail(xa, xb, (wa, wb, b0), stages[:-1] + [(w_drop, b_last)], lg),
        run_tail(*ops, plain=True), None)
    name = str(dt).replace("torch.", "")
    for what, (got, ref, p) in broken.items():
        err, ok = tail_check(got, ref, dt, p)
        print(f"{kname} {name} {what}: max|err| {err:.6g} "
              f"{'ok' if ok else 'FAIL'} (must fail) [{card_str}]", flush=True)
        require(not ok, f"{kname} {name}: the check passes a broken output "
                        f"({what})")


def tail_simt_bitwise(kname, xa, xb, stage0, got, card_str: str) -> None:
    """The f32 stage kernel is blind to placement and to the run, as
    :func:`simt_bitwise` holds K1: stage 0 of ``xa`` (and ``xb``) gives
    ``got``'s bits in a second launch, and on a sub-window of the operands
    (offset 5, 3, 11: another box grid, every voxel at another place in its
    box) the overlap of ``got`` bit for bit."""
    from flypylib_tpu_torch.ops.tail import tail_simt_plan

    def sub(t):
        return None if t is None else t[:, 5:, 3:, 11:].contiguous()

    again = run_tail(xa, xb, stage0, [], None)
    part = run_tail(sub(xa), sub(xb), stage0, [], None)
    torch.cuda.synchronize()
    same = torch.equal(again, got)
    window = torch.equal(part, got[:, 5:, 3:, 11:])
    co = stage0[0].shape[-1]
    boxes = [tail_simt_plan(tuple(t.shape[1:4]), co)[:3] for t in (xa, sub(xa))]
    print(f"{kname} stage 0 float32 [simt]: a second launch bit for bit "
          f"{same}; sub-window {tuple(part.shape)} (box {boxes[1]} against "
          f"{boxes[0]}) bit for bit the full output's overlap {window} "
          f"[{card_str}]", flush=True)
    require(same and window, f"{kname} f32: the simt kernel's bits follow the "
                             "run or the box")


def check_tail_kernels(card_str: str) -> dict:
    """K2 and K3 against their plain versions: at small shapes
    (:func:`check_tail_small`); launch by launch on the real operands
    (:func:`tail_inputs`, :func:`check_tail_stagewise`); then in the four
    forms, both dtypes and timed, on the main path's shapes with unit-scale
    activations, every stage on the route its dtype implies ("wgmma",
    "simt"), with the broken-output controls, the f32 kernel's bitwise
    checks (:func:`tail_simt_bitwise`) and the times per stage, of the
    first version of ``packed_tail.cu`` ("wmma", "fma") and of the unfused
    tail on the same operands.  Returns the readings of the full tails
    ("pallas" for K2, "pallas2" for K3) under "K2" / "K3" (bf16) and
    "K2 f32" / "K3 f32"."""
    from flypylib_tpu_torch.ops import tail
    from flypylib_tpu_torch.ops.conv import conv3d_f32
    from flypylib_tpu_torch.ops.tail import (packed_tail, packed_tail2,
                                             tail2_reference, tail_reference)

    check_tail_small(card_str)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        real, seen, tin = tail_inputs(dtype)
        check_tail_stagewise(real, dtype, tin, card_str)
        del real
        xin, stages, lg = seen["packed_tail"]
        sc, xu, stage0, stages2, lg2 = seen["packed_tail2"]
        wa, wb = stage0[0], stage0[1]
        route, old_route = (("wgmma", "wmma") if dtype == torch.bfloat16
                            else ("simt", "fma"))
        forms = {
            # form: (kernel, wrapper, stages, wrapper call, plain call, the
            #        stage's rounded conv sum before the bias, for a single
            #        stage); each single stage before the chain it starts
            "pallas_fold": ("K2", packed_tail, 1,
                            lambda: packed_tail(xin, stages[:1]),
                            lambda: tail_reference(xin, stages[:1]),
                            lambda: conv3d_f32(xin, stages[0][0]).to(dtype)),
            "pallas": ("K2", packed_tail, len(stages),
                       lambda: packed_tail(xin, stages, lg),
                       lambda: tail_reference(xin, stages, lg), None),
            "pallas_fold2": ("K3", packed_tail2, 1,
                             lambda: packed_tail2(sc, xu, stage0),
                             lambda: tail2_reference(sc, xu, stage0),
                             lambda: (conv3d_f32(sc, wa) + conv3d_f32(xu, wb))
                             .to(dtype)),
            "pallas2": ("K3", packed_tail2, 1 + len(stages2),
                        lambda: packed_tail2(sc, xu, stage0, stages2, lg2),
                        lambda: tail2_reference(sc, xu, stage0, stages2, lg2),
                        None),
        }
        dt = str(dtype).replace("torch.", "")
        times = {}
        for form, (kname, wrapper, n_stages, kern, plain, pre) in forms.items():
            before = dict(wrapper.routes)
            got = kern()
            ran = {r: n - before[r] for r, n in wrapper.routes.items()
                   if n != before[r]}
            require(ran == {route: n_stages},
                    f"{kname} {form} {dt}: stages ran on {ran}, not on {route}")
            ref = plain()
            torch.cuda.synchronize()
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"{kname} {form} {dt}: {tuple(got.shape)} {got.dtype} vs "
                    f"{tuple(ref.shape)} {ref.dtype}")
            err, ok = tail_check(got, ref, dtype, pre() if pre else None)
            ms = median_ms(kern, warmup=1, iters=5)
            plain_ms = median_ms(plain, warmup=1, iters=3)
            times[form] = ms
            ins = (f"x{tuple(xin.shape)}" if kname == "K2" else
                   f"xa{tuple(sc.shape)} xb{tuple(xu.shape)}")
            print(f"{kname} tail_impl={form!r} {ins} -> {tuple(got.shape)} "
                  f"{dt} [{route}] (tile in {tin}): max|err| {err:.6g} "
                  f"(max|ref| {float(ref.float().abs().max()):.6g}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms [{card_str}]", flush=True)
            require(ok, f"{kname} {form} {dt}: outside tolerance (max|err| {err})")
            if dtype == torch.float32 and form in ("pallas_fold",
                                                   "pallas_fold2"):
                if kname == "K2":
                    tail_simt_bitwise(kname, xin, None, (stages[0][0], None,
                                                         stages[0][1]),
                                      got, card_str)
                else:
                    tail_simt_bitwise(kname, sc, xu, stage0, got, card_str)
            if form in ("pallas", "pallas2"):
                if kname == "K2":
                    ops = (xin, None, (stages[0][0], None, stages[0][1]),
                           list(stages[1:]), lg)
                    bnd, by = tail_bound((xin,), got, [[w] for w, _ in stages],
                                         lg[0])
                else:
                    ops = (sc, xu, stage0, list(stages2), lg2)
                    bnd, by = tail_bound((sc, xu), got, [[wa, wb]] + [
                        [w] for w, _ in stages2], lg2[0])
                # the stages after the first, with the logits, on the
                # kernel's own stage-0 output
                mid = run_tail(*ops[:3], [], None)
                rest_ms = median_ms(lambda: packed_tail(mid, ops[3], ops[4]),
                                    warmup=1, iters=5)
                del mid
                # the first version of packed_tail.cu (the route of other
                # widths: "wmma" in bf16, "fma" in f32) on the same
                # operands, held to the same check
                rule = tail.tail_route
                tail.tail_route = lambda *a: old_route
                try:
                    old = kern()
                    old_err, old_ok = tail_check(old, ref, dtype)
                    old_ms = median_ms(kern, warmup=0, iters=3)
                finally:
                    tail.tail_route = rule
                del old
                require(old_ok, f"{kname} {form} {dt} on the {old_route} "
                                f"kernel: outside tolerance (max|err| {old_err})")
                loose = unfused_tail(*ops)
                loose_err = float((loose - ref).abs().max())
                del loose
                loose_ms = median_ms(lambda: unfused_tail(*ops), warmup=1,
                                     iters=5)
                print(f"{kname} tail_impl={form!r} {dt}: whole tail {ms:.4f} "
                      f"ms = stage 0 alone {times[form.replace('pallas', 'pallas_fold')]:.4f}"
                      f" + the rest with the logits {rest_ms:.4f}; the "
                      f"{old_route} kernel {old_ms:.4f} ms (max|err| "
                      f"{old_err:.6g}); the unfused tail (cuDNN convs"
                      f"{', TF32 off' if dtype == torch.float32 else ''}, "
                      f"adds, ReLUs, plain logits) {loose_ms:.4f} ms (max|its "
                      f"logits - plain| {loose_err:.6g}); bound {bnd:.4f} ms "
                      f"({by}); no single PyTorch call computes it "
                      f"[{card_str}]", flush=True)
                check_tail_controls(kname, ops, card_str)
                key = kname if dtype == torch.bfloat16 else f"{kname} f32"
                main[key] = {"ms": ms, "plain_ms": plain_ms,
                             "max_abs_err": err, "bound_ms": bnd,
                             "bound_by": by, "library_ms": None,
                             "tail_route": route,
                             "stage0_ms": times[form.replace("pallas",
                                                             "pallas_fold")],
                             "rest_with_logits_ms": rest_ms,
                             f"{old_route}_kernel_ms": old_ms,
                             "unfused_tail_ms": loose_ms}
                del ops
            del got, ref
        del seen, xin, stages, lg, sc, xu, stage0, stages2, lg2
        torch.cuda.empty_cache()
    return main


# the packed engines' conv + bias + ReLU at the volume cells' shapes, on the
# packed lattice: (label, batch, input extent, Ci, Co).  The baseline's stage
# A at tile in 76, batch 16; the U-Net's eight such convs on one 388^3 tile
FUSED_SHAPES = (
    ("baseline L0", 16, 38, 8, 192), ("baseline L1", 16, 37, 192, 256),
    ("unet enc 0", 1, 194, 8, 192), ("unet enc 1", 1, 193, 192, 192),
    ("unet enc 2", 1, 96, 192, 384), ("unet enc 3", 1, 95, 384, 384),
    ("unet bottleneck 0", 1, 47, 384, 768),
    ("unet bottleneck 1", 1, 46, 768, 768),
    ("unet dec 1", 1, 89, 384, 384), ("unet dec 0", 1, 175, 192, 192),
)


def fused_operands(batch: int, s: int, ci: int, co: int, seed: int = 0):
    """A packed-lattice bf16 input (B, s, s, s, Ci) of ReLU'd unit normals
    and a ``Conv3BiasReLU`` of Ci / 8 into Co / 8 channels (He-scaled
    weights, biases N(0, 0.1^2)), on the card."""
    from flypylib_tpu_torch.models.zoo import Conv3BiasReLU

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.relu(torch.randn((batch, s, s, s, ci), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    conv = Conv3BiasReLU(ci // 8, co // 8, 1).to("cuda")
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device="cuda") * (16 / (27 * ci)) ** 0.5)
        conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=gen,
                                          device="cuda"))
    return x, conv


def check_fused_conv(card_str: str) -> dict:
    """The packed engines' conv + bias + ReLU on K2's wgmma stage kernel
    (``packed_conv_relu`` without grad, :data:`FUSED_SHAPES`): each call
    must take the route (one launch of ``stage_bias_relu``) and lie within
    :func:`tail_check`'s one-stage limit of the library path it replaces
    (cuDNN's conv rounded to bf16, then ``_epilogue``), which a zeroed tap
    must fail.  Timed beside that path (``library_ms``: the conv and the
    two elementwise passes), the plain version (f32 conv, TF32 off) and the
    bound (the 3^3 conv's own operations, 27 of the packed lattice's 64
    Ci x Co products a voxel, as ``gpubench``'s ``layer_macs`` counts them;
    bytes of the input, the weight image and the output).  Returns the
    readings per shape and the sums per model."""
    from flypylib_tpu_torch.ops import tail
    from flypylib_tpu_torch.ops.packed_conv import (_epilogue, _fprop,
                                                    _stage_operands,
                                                    pack_weight_d1,
                                                    packed_conv_relu)

    rows, sums = {}, {}
    for label, batch, s, ci, co in FUSED_SHAPES:
        x, conv = fused_operands(batch, s, ci, co)
        wp = pack_weight_d1(conv.weight.to(torch.bfloat16))

        def library():
            return _epilogue(_fprop(x, wp), conv, tile=8)

        with torch.no_grad():
            before = tail.stage_bias_relu.launches
            got = packed_conv_relu(x, conv)
            torch.cuda.synchronize()
            require(tail.stage_bias_relu.launches == before + 1,
                    f"fused conv {label}: the route was not taken")
            pre = _fprop(x, wp)
            ref = _epilogue(pre, conv, tile=8)
            err, ok = tail_check(got, ref, torch.bfloat16, pre)
            require(ok, f"fused conv {label}: max |err| {err} against the "
                        "library path")
            del got, ref
            ms = median_ms(lambda: packed_conv_relu(x, conv))
            lib = median_ms(library)
            plain = median_ms(lambda: tail.tail_reference(
                x, [(wp, conv.bias.to(torch.bfloat16).repeat(8))]),
                warmup=1, iters=3)
            sw = _stage_operands(conv, x.device)
            out = (batch, *(s - 1,) * 3, co)
            # a packed voxel holds 8 outputs of 27 taps x (Ci/8) x (Co/8)
            flops = 2.0 * 27 * (ci // 8) * (co // 8) * 8 * math.prod(out[:4])
            flops_packed = 2.0 * 8 * ci * co * math.prod(out[:4])
            moved = (nbytes(x, sw.b) + 2 * math.prod(out)
                     + sum(nbytes(t) for t in (sw.w32, sw.w16)
                           if t is not None))
            bnd, by = bound(flops, moved)
            if label == "unet enc 3":  # the control: a tap dropped
                held = sw.w32[:, 5].clone()
                sw.w32[:, 5] = 0
                bad = packed_conv_relu(x, conv)
                sw.w32[:, 5] = held
                require(not tail_check(bad, library(), torch.bfloat16,
                                       pre)[1],
                        f"fused conv {label}: a zeroed tap passed the check")
                del bad
        n, width, n_tile = tail.stage_slices(co)
        print(f"fused conv {label}: ({batch}, {s}^3, {ci}) -> {out}, {n} x "
              f"{width} channels on N tile {n_tile}: {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s of the conv's own, "
              f"{flops_packed / ms / 1e9:.1f} on the packed lattice), "
              f"max|err| {err:.6g}; "
              f"library (cuDNN + bias + ReLU) {lib:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}) [{card_str}]",
              flush=True)
        rows[label] = {"ms": ms, "library_ms": lib, "plain_ms": plain,
                       "bound_ms": bnd, "bound_by": by, "max_abs_err": err,
                       "tflop": flops / 1e12,
                       "tflop_packed": flops_packed / 1e12, "slices": n,
                       "n_tile": n_tile}
        model = label.split()[0]
        acc = sums.setdefault(model, dict.fromkeys(
            ("ms", "library_ms", "plain_ms", "bound_ms"), 0.0))
        for k in acc:
            acc[k] += rows[label][k]
        del x, conv, wp, pre, sw
        torch.cuda.empty_cache()
    for model, acc in sums.items():
        print(f"fused conv, {model}'s convs summed: {acc['ms']:.4f} ms, "
              f"library {acc['library_ms']:.4f} ms, plain "
              f"{acc['plain_ms']:.4f} ms, bound {acc['bound_ms']:.4f} ms "
              f"[{card_str}]", flush=True)
    return {"shapes": rows, "sums": sums}


SPLIT_CASES = (  # K5's input at the stage-A -> stage-B boundary, one batch
    ("baseline", (8, 36, 36, 36, 256)),  # tile in 76: 37^3 cells -> 36^3
    ("vgg_like", (8, 44, 44, 44, 384)),  # tile in 94: 47^3 cells -> 44^3
)


def check_split_kernel(card_str: str) -> dict:
    """K5 against its plain version, bit for bit, at SPLIT_CASES in f32 and
    bf16, timed beside the plain version and one ``permute().contiguous()``.
    Returns the bf16 baseline reading."""
    from flypylib_tpu_torch.ops.split import (parity_split_kernel,
                                              parity_split_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    main = {}
    for label, shape in SPLIT_CASES:
        b, d, h, w, c8 = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = parity_split_kernel(x)
            ref = parity_split_reference(x)
            torch.cuda.synchronize()
            same = got.shape == ref.shape and bool(torch.equal(got, ref))
            ms = median_ms(lambda: parity_split_kernel(x))
            plain = median_ms(lambda: parity_split_reference(x))
            lib = median_ms(lambda: x.view(b, d, h, w, 8, c8 // 8)
                            .permute(0, 4, 1, 2, 3, 5).contiguous())
            bnd, by = bound(0, nbytes(x, got))
            dt = str(dtype).replace("torch.", "")
            print(f"K5 {label} x{shape} -> {tuple(got.shape)} {dt}: "
                  f"{'bit-exact' if same else 'DIFFERS'}; kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, permute().contiguous() {lib:.4f} ms, "
                  f"bound {bnd:.4f} ms ({by}) [{card_str}]", flush=True)
            require(same, f"K5 {label} {dt}: differs from its plain version")
            if label == "baseline" and dtype == torch.bfloat16:
                main = {"ms": ms, "plain_ms": plain, "max_abs_err": 0.0,
                        "library_ms": lib, "bound_ms": bnd, "bound_by": by}
            del x, got, ref
    torch.cuda.empty_cache()
    return main


def first_tile_batch(spec, vol: np.ndarray, device="cuda") -> torch.Tensor:
    """The first tile batch ``TiledInference`` hands the module for ``vol``
    at ``default_tiling``: (B, tile_in, tile_in, tile_in, 1) uint8."""
    from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling

    ti = TiledInference(spec, *default_tiling(spec, vol.shape))
    corners, out_shape = ti.plan(vol.shape)
    c, t = ti.ctx, ti.tile_in
    padded = np.pad(vol, c, mode="reflect")
    padded = np.pad(padded, [(0, o - s) for s, o in zip(vol.shape, out_shape)])
    src = torch.from_numpy(padded).to(device)
    return torch.stack([src[z:z + t, y:y + t, x:x + t]
                        for z, y, x in corners[:ti.tile_batch]])[..., None]


def wino_operands(vol: np.ndarray, dtype: torch.dtype, device="cuda"):
    """K4's operands on the packed baseline's path: the stage-B convs'
    inputs in one tile batch of ``vol`` (the seed-0 model in ``dtype``),
    ``[(label, x, conv), ...]`` for layers 2 (x: (8 B, 36^3, 32) at tile in
    76) and 3."""
    from flypylib_tpu_torch.models.zoo import baseline_model
    from flypylib_tpu_torch.ops.packed_conv import _conv, packed_spec

    pspec = packed_spec(baseline_model(seed=0, dtype=dtype))
    module = pspec.module.to(device).eval()
    c2, c3 = module.inner.convs[2], module.inner.convs[3]
    with torch.no_grad():
        xa = module.apply_stage_a(first_tile_batch(pspec, vol, device))
        xb = torch.relu(_conv(xa, c2.weight.to(dtype)) + c2.bias.to(dtype))
    return [("layer 2", xa, c2), ("layer 3", xb, c3)]


# K4 at small shapes, bf16: (label, N, D, H, W, Ci, Co, route).  The wgmma
# kernel's tiles hold up to 64 2^3 output blocks: ragged tile edges on every
# axis, odd block counts, one tile smaller than the GEMM's 64 rows, a
# zero-filled 32-channel slice (Ci = 24), a 16-channel rest (Ci = 48, and
# Ci = 40 where it overlaps the slice before it), Ci and Co past 128 (five
# K slices, three blocks of output channels), and one case off the rule on
# the WMMA kernel.
WINO_SMALL_CASES = (
    ("ragged tiles", 2, 12, 14, 40, 32, 48, "wgmma"),
    ("odd block counts", 1, 8, 12, 16, 32, 64, "wgmma"),
    ("one small tile, B = 1", 1, 6, 6, 6, 16, 8, "wgmma"),
    ("Ci = 24", 2, 10, 10, 12, 24, 32, "wgmma"),
    ("Ci = 48, 16-channel rest", 1, 10, 12, 22, 48, 64, "wgmma"),
    ("Ci = 40, overlapping rest", 1, 8, 8, 14, 40, 24, "wgmma"),
    ("Ci = 136, Co = 136", 1, 8, 8, 12, 136, 136, "wgmma"),
    ("off the rule", 1, 8, 10, 12, 20, 28, "wmma"),
)


def check_wino_small(card_str: str) -> None:
    """K4 at WINO_SMALL_CASES against its plain version on the card, each
    case on the route it names."""
    from flypylib_tpu_torch.ops import wino_conv as wino

    rng = np.random.default_rng(0)
    for label, n, d, h, w, ci, co, route in WINO_SMALL_CASES:
        x = torch.from_numpy(np.maximum(rng.normal(0, 1, (n, d, h, w, ci)), 0)
                             .astype(np.float32)).cuda().bfloat16()
        wgt = torch.from_numpy(rng.normal(0, (27 * ci) ** -0.5,
                                          (3, 3, 3, ci, co))
                               .astype(np.float32)).cuda()
        b = torch.from_numpy(rng.normal(0, 0.1, co).astype(np.float32)).cuda()
        u = wino.wino_transform_weights(wgt)
        require(wino.wino_route(x, u) == route,
                f"K4 {label}: route {wino.wino_route(x, u)}, not {route}")
        before = dict(wino.wino_conv3d_bias_relu.routes)
        got = wino.wino_conv3d_bias_relu(x, u, b)
        torch.cuda.synchronize()
        before[route] += 1
        require(wino.wino_conv3d_bias_relu.routes == before,
                f"K4 {label}: counts {wino.wino_conv3d_bias_relu.routes}")
        ref = wino.wino_reference(x, u, b)
        err, ok = wino_check(got, ref)
        print(f"K4 small, {label}: x{tuple(x.shape)} -> Co {co} bf16 [{route}]"
              f": max|err| {err:.6g} = {bf16_ulps(got, ref):.3g} ulps "
              f"{'ok' if ok else 'FAIL'} [{card_str}]", flush=True)
        require(ok, f"K4 {label}: outside tolerance (max|err| {err})")


def wino_readings(x: torch.Tensor, u: torch.Tensor, b: torch.Tensor) -> dict:
    """K4 on ``x`` with transform-domain weights ``u`` and bias ``b``
    against its plain version: the sound reading and two broken outputs
    (tap 21 dropped from U; channel 0 zeroed), each as (max |err|, bf16
    ulps or None, within tolerance)."""
    from flypylib_tpu_torch.ops.wino_conv import (wino_conv3d_bias_relu,
                                                  wino_reference)

    got = wino_conv3d_bias_relu(x, u, b)
    ref = wino_reference(x, u, b)
    u_drop = u.clone()
    u_drop[21] = 0  # the tap (A, B, C) = (1, 1, 1)
    zeroed = got.clone()
    zeroed[..., 0] = 0
    out = {}
    for name, g in (("sound", got), ("tap dropped",
                                     wino_conv3d_bias_relu(x, u_drop, b)),
                    ("channel zeroed", zeroed)):
        require(g.shape == ref.shape and g.dtype == ref.dtype,
                f"K4: {tuple(g.shape)} {g.dtype} vs {tuple(ref.shape)} {ref.dtype}")
        err, ok = wino_check(g, ref)
        ulps = bf16_ulps(g, ref) if x.dtype == torch.bfloat16 else None
        out[name] = (err, ulps, ok)
    out["max_ref"] = float(ref.float().abs().max())
    return out


def check_wino_kernel(card_str: str, vol: np.ndarray) -> dict:
    """K4 against its plain version at the small cases, then on the packed
    baseline's stage-B operands (:func:`wino_operands`), f32 and bf16: sound
    within the tolerance, both broken outputs outside it; timed beside the
    plain version, K1 (its wgmma route at d = 1 in bf16), one cuDNN call
    and, in bf16, the WMMA kernel of ``wino_conv.cu`` on the same operands.
    Every bf16 stage-B call must take the wgmma kernel.  Returns the bf16
    layer-3 reading."""
    from flypylib_tpu_torch.ops import wino_conv as wino
    from flypylib_tpu_torch.ops.conv import conv3d_bias_relu
    from flypylib_tpu_torch.ops.wino_conv import (wino_conv3d_bias_relu,
                                                  wino_reference,
                                                  wino_transform_weights)

    check_wino_small(card_str)
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).replace("torch.", "")
        for label, x, conv in wino_operands(vol, dtype):
            w, b = conv.weight.detach(), conv.bias.detach()
            u = wino_transform_weights(w)
            route = wino.wino_route(x, u)
            for fn_route in wino_conv3d_bias_relu.routes:
                wino_conv3d_bias_relu.routes[fn_route] = 0
            r = wino_readings(x, u, b)
            ms = median_ms(lambda: wino_conv3d_bias_relu(x, u, b))
            ran = {k for k, v in wino_conv3d_bias_relu.routes.items() if v}
            require(ran == {"wgmma" if dtype == torch.bfloat16 else "fma"}
                    and ran == {route},
                    f"K4 {label} {dt}: ran on {sorted(ran)}")
            wmma = None
            if dtype == torch.bfloat16:  # the WMMA kernel, same operands
                rule, wino.wino_route = wino.wino_route, lambda *a: "wmma"
                try:
                    _, wok = wino_check(wino_conv3d_bias_relu(x, u, b),
                                        wino_reference(x, u, b))
                    wmma = median_ms(lambda: wino_conv3d_bias_relu(x, u, b),
                                     warmup=1, iters=5)
                finally:
                    wino.wino_route = rule
                require(wok, f"K4 {label}: the WMMA kernel is outside "
                             "tolerance")
            plain = median_ms(lambda: wino_reference(x, u, b), warmup=1,
                              iters=3)
            k1 = median_ms(lambda: conv3d_bias_relu(x, w, b, 1))
            lib = median_ms(lambda: cudnn_conv(x, w, b))
            n, d, h, wd, ci = x.shape
            co = w.shape[4]
            out_numel = n * (d - 2) * (h - 2) * (wd - 2) * co
            flops = 2 * out_numel * ci * 8  # 64 products per 8 voxels
            bnd, by = bound(flops, nbytes(x, w.to(dtype), b.to(dtype))
                            + out_numel * x.element_size(), dtype)
            readings = "; ".join(
                f"{k} max|err| {e:.6g}"
                + (f" = {ul:.3g} ulps" if ul is not None else "")
                + (" ok" if ok else " FAIL")
                for k, (e, ul, ok) in ((k, r[k]) for k in
                                       ("sound", "tap dropped",
                                        "channel zeroed")))
            print(f"K4 baseline {label} x{tuple(x.shape)} -> Co {co} {dt} "
                  f"[{route}]: {readings} (max|ref| {r['max_ref']:.6g}); "
                  f"kernel {ms:.4f} ms, plain {plain:.4f} ms, K1 {k1:.4f} ms, "
                  f"cuDNN {lib:.4f} ms"
                  + (f", WMMA kernel {wmma:.4f} ms" if wmma is not None else "")
                  + f", bound {bnd:.4f} ms ({by}) [{card_str}]", flush=True)
            require(r["sound"][2], f"K4 {label} {dt}: outside tolerance "
                                   f"({r['sound']})")
            require(not r["tap dropped"][2] and not r["channel zeroed"][2],
                    f"K4 {label} {dt}: the check passes a broken output")
            if dtype == torch.bfloat16 and label == "layer 3":
                main = {"ms": ms, "plain_ms": plain,
                        "max_abs_err": r["sound"][0], "library_ms": lib,
                        "bound_ms": bnd, "bound_by": by, "k1_ms": k1,
                        "wmma_kernel_ms": wmma}
            del x
        torch.cuda.empty_cache()
    return main


def logits(prob: np.ndarray) -> np.ndarray:
    """The logits behind a probability map, in f64 (inf where p is 0 or 1)."""
    p = prob.astype(np.float64)
    with np.errstate(divide="ignore"):
        return np.log(p) - np.log1p(-p)


def check_map(card_str: str, label: str, make_net, vol: np.ndarray, tiling,
              limits) -> None:
    """The logits behind the card's probability map against the CPU's (the
    plain versions) on ``vol`` in ``tiling`` (tile_out, batch), with the
    same weights, for each ``(dtype, limit)``; ``make_net(device, dtype)``
    builds the network."""
    for dtype, tol in limits:
        gpu = make_net("cuda", dtype)
        cpu = make_net("cpu", dtype)
        cpu.module.load_state_dict(gpu.module.state_dict())
        pg = gpu.infer(vol, *tiling)
        pc = cpu.infer(vol, *tiling)
        lg, lc = logits(pg), logits(pc)
        dt = str(dtype).replace("torch.", "")
        size = "x".join(map(str, vol.shape))
        require(pg.shape == vol.shape and bool(np.isfinite(lg).all())
                and bool(np.isfinite(lc).all()),
                f"{label} {size} {dt} map: shape {pg.shape}; every p in "
                f"(0, 1): card {bool(np.isfinite(lg).all())}, "
                f"CPU {bool(np.isfinite(lc).all())}")
        err = float(np.abs(lg - lc).max())
        print(f"{label} {size} map, tiles {tiling[0]} in batches of "
              f"{tiling[1]}, card vs CPU plain versions, {dt}: max|dlogit| "
              f"{err:.6g} (limit {tol:g}; max|logit| "
              f"{float(np.abs(lc).max()):.6g}), max|dprob| "
              f"{float(np.abs(pg - pc).max()):.6g} [{card_str}]", flush=True)
        require(err <= tol, f"{label} {size} {dt} logits differ from the "
                            f"CPU's by {err} (limit {tol})")
        del gpu, cpu
    torch.cuda.empty_cache()


def check_small_map(port, card_str: str, packed: bool = False) -> None:
    """The baseline's map at SMALL^3 against the CPU's, in f32 and bf16: the
    plain stack (K1), or with ``packed`` the packed engine (K5)."""
    limits = (((torch.float32, PACKED_LOGIT_TOL_F32),
               (torch.bfloat16, PACKED_LOGIT_TOL_BF16)) if packed else
              ((torch.float32, LOGIT_TOL_F32), (torch.bfloat16, LOGIT_TOL_BF16)))
    check_map(card_str, "packed baseline" if packed else "baseline",
              lambda dev, dt: port.FplNetwork("baseline", device=dev, seed=0,
                                              dtype=dt, packed=packed),
              make_volume_u8(SMALL, 2, seed=1), SMALL_TILING, limits)


def unet_net(port, engine: str, device, dtype=torch.bfloat16):
    """``FplNetwork`` on the full-width U-Net (weights from seed 0):
    ``engine`` is a ``tail_impl`` of the packed engine, or "plain" for
    ``packed=False``."""
    from flypylib_tpu_torch.models.zoo import unet
    from flypylib_tpu_torch.ops.packed_unet import packed_unet_spec

    if engine == "plain":
        return port.FplNetwork("unet", device=device, seed=0, dtype=dtype,
                               packed=False)
    if engine == "xla":  # the default engine
        return port.FplNetwork("unet", device=device, seed=0, dtype=dtype)
    return port.FplNetwork(
        packed_unet_spec(unet(seed=0, dtype=dtype), tail_impl=engine),
        device=device)


def check_unet_maps(port, card_str: str) -> None:
    """The U-Net's map at UNET_SMALL^3 against the CPU's, for the plain
    U-Net (K1) and the packed engine with the K2 and the K3 tail."""
    limits = ((torch.float32, UNET_LOGIT_TOL_F32),
              (torch.bfloat16, UNET_LOGIT_TOL_BF16))
    vol = make_volume_u8(UNET_SMALL, 2, seed=1)
    for engine in ("plain", "pallas", "pallas2"):
        check_map(card_str, f"unet {engine}",
                  lambda dev, dt, e=engine: unet_net(port, e, dev, dt), vol,
                  UNET_TILING, limits)


def check_deep_unet(port, card_str: str) -> None:
    """The plain three-level U-Net (``levels=3, packed=False``: K1 at
    Co = 192 in its bottleneck) returns a map on the card, and the logits
    of its first tile batch match the CPU's plain versions with the same
    weights.  An untrained net this deep saturates the sigmoid (p is
    exactly 0 or 1 in places), so the logits are compared as the module
    returns them, relative to their largest magnitude: f32
    DEEP_UNET_RTOL_F32, bf16 DEEP_UNET_RTOL_BF16."""
    from flypylib_tpu_torch.ops.conv import K1_ROUTES

    vol = make_volume_u8(DEEP_UNET_SMALL, 2, seed=1)
    for dtype, rtol in ((torch.float32, DEEP_UNET_RTOL_F32),
                        (torch.bfloat16, DEEP_UNET_RTOL_BF16)):
        gpu = port.FplNetwork("unet", device="cuda", seed=0, dtype=dtype,
                              levels=3, packed=False)
        cpu = port.FplNetwork("unet", device="cpu", seed=0, dtype=dtype,
                              levels=3, packed=False)
        cpu.module.load_state_dict(gpu.module.state_dict())
        reset_launch_counts()
        prob = gpu.infer(vol, *DEEP_UNET_TILING)
        counts = launch_counts()
        n = gpu.tiled_inference(vol.shape, *DEEP_UNET_TILING).n_batches(vol.shape)
        routes = {r: counts[f"conv3d_bias_relu:{r}"] for r in K1_ROUTES}
        main = "simt" if dtype == torch.float32 else "wgmma"
        want = dict.fromkeys(routes, 0)
        want.update({"ci1": n, main: (len(gpu.module.convs) - 1) * n})
        require(prob.shape == vol.shape and bool(np.isfinite(prob).all())
                and float(prob.min()) >= 0 and float(prob.max()) <= 1,
                f"unet levels=3 plain: map {prob.shape}, not probabilities")
        require(routes == want, f"unet levels=3 plain: K1 ran on {routes}, "
                                f"expected {want}")
        tiles = first_tile_batch(gpu.infer_spec, vol)[:DEEP_UNET_TILING[1]]
        with torch.no_grad():
            lg = gpu.module(tiles).cpu()
            lc = cpu.module(tiles.cpu())
        scale = float(lc.abs().max())
        err = float((lg - lc).abs().max())
        dt = str(dtype).replace("torch.", "")
        print(f"unet levels=3 plain (Co = 192 bottleneck) {vol.shape} map in "
              f"{n} tile batches, K1 launches by route {routes}; logits of one "
              f"tile batch {tuple(tiles.shape)}, card vs CPU plain versions, "
              f"{dt}: max|dlogit| {err:.6g} (limit {rtol:g} x max|logit| "
              f"{scale:.6g}) [{card_str}]", flush=True)
        require(bool(torch.isfinite(lg).all()) and err <= rtol * scale,
                f"unet levels=3 plain {dt}: logits differ from the CPU's by "
                f"{err} (limit {rtol} x {scale})")
        del gpu, cpu
    torch.cuda.empty_cache()


def unet_f32_paths(port, card_str: str, vol: np.ndarray) -> dict:
    """Phase 9's f32 kernel tails (the port's exactness mode): the K3 and
    K2 engines of the f32 U-Net at 256^3 through infer and both detects,
    both stages of each call on the f32 kernel ("simt"), the logits apart;
    lists equal to the host reference, times and the infer's split.
    Returns each engine's :func:`run_main_path` result."""
    runs = {}
    for engine, name in (("pallas2", "packed_tail2"), ("pallas", "packed_tail")):
        net = unet_net(port, engine, "cuda", torch.float32)
        require(net.module.dtype == torch.float32, "unet is not f32")
        r = run_main_path(net, vol)
        n = r["n_batches"]
        require_launches(r, {name: n, f"{name}:simt": 2 * n},
                         f"unet {engine} f32")
        print(f"unet {engine} f32 ({net.infer_spec.name}, tile in "
              f"{net.tiled_inference(vol.shape).tile_in}): {n} tile batches, "
              f"launches {r['launches']} (both stages on simt); threshold "
              f"{r['threshold']:.9g} ({r['above_threshold']} voxels above); "
              f"nms {r['n_nms']} detections, components {r['n_cc']}; both "
              "equal the host reference", flush=True)
        time_main_path(net, vol, r["threshold"], card_str,
                       f"unet {engine} f32")
        infer_phases(net, vol, card_str, f"unet {engine} f32")
        runs[engine] = r
        del net
        torch.cuda.empty_cache()
    return runs


def same_list(got, ref, loc_tol: float, what: str) -> None:
    """Detection lists equal: same length and order, locations within
    ``loc_tol`` (0: exactly equal), conf within CONF_TOL."""
    require(len(got) == len(ref),
            f"{what}: {len(got)} detections vs {len(ref)} in the reference")
    if len(ref) == 0:
        return
    dloc = float(np.abs(got.locs - ref.locs).max())
    dconf = float(np.abs(got.conf - ref.conf).max())
    require(dloc <= loc_tol, f"{what}: locations differ by {dloc}")
    require(dconf <= CONF_TOL, f"{what}: conf differs by {dconf}")


def kernel_wrappers() -> dict:
    """The port's kernel wrappers, each with its ``launches`` count."""
    from flypylib_tpu_torch.ops.conv import conv3d_bias_relu
    from flypylib_tpu_torch.ops.split import parity_split_kernel
    from flypylib_tpu_torch.ops.tail import (packed_tail, packed_tail2,
                                             stage_bias_relu)
    from flypylib_tpu_torch.ops.wino_conv import wino_conv3d_bias_relu

    return {"conv3d_bias_relu": conv3d_bias_relu, "packed_tail": packed_tail,
            "packed_tail2": packed_tail2,
            "parity_split_kernel": parity_split_kernel,
            "stage_bias_relu": stage_bias_relu,
            "wino_conv3d_bias_relu": wino_conv3d_bias_relu}


def fused_convs(net) -> int:
    """Launches of ``stage_bias_relu`` in one tile-batch forward of ``net``
    at inference: one a conv of ``packed_conv_relu`` on a bf16 packed
    engine without BatchNorm, i.e. a ConvStack's dilation-1 lead convs
    (baseline 2, vgg_like 3) and a U-Net's convs outside its ConvTranspose
    folds (8 at two levels), less the level-0 conv a ``pallas`` or
    ``pallas2`` tail runs itself; 0 on the plain engine and in f32."""
    from flypylib_tpu_torch.ops.packed_conv import PackedConvStack
    from flypylib_tpu_torch.ops.packed_unet import PackedUNet

    m = net.infer_spec.module
    if not isinstance(m, (PackedConvStack, PackedUNet)) \
            or m.dtype != torch.bfloat16:
        return 0
    if isinstance(m, PackedConvStack):
        return 0 if m.inner.use_batchnorm else m.n_lead
    levels, cps = m.inner.levels, m.inner.convs_per_stage
    return (levels * cps + cps + levels * (cps - 1)
            - (m.tail_impl in ("pallas", "pallas2")))


def routed_wrappers() -> dict:
    """The wrappers that count their launches per route as well."""
    from flypylib_tpu_torch.ops.conv import conv3d_bias_relu
    from flypylib_tpu_torch.ops.tail import packed_tail, packed_tail2
    from flypylib_tpu_torch.ops.wino_conv import wino_conv3d_bias_relu

    return {"conv3d_bias_relu": conv3d_bias_relu, "packed_tail": packed_tail,
            "packed_tail2": packed_tail2,
            "wino_conv3d_bias_relu": wino_conv3d_bias_relu}


def launch_counts() -> dict:
    """Each wrapper's launches, and the launches per route of K1, of K4 and
    of the stages of K2 and K3 as ``<wrapper>:<route>``."""
    counts = {name: fn.launches for name, fn in kernel_wrappers().items()}
    for name, fn in routed_wrappers().items():
        counts.update({f"{name}:{r}": n for r, n in fn.routes.items()})
    return counts


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
    for fn in routed_wrappers().values():
        for r in fn.routes:
            fn.routes[r] = 0


def run_main_path(net, vol: np.ndarray, n_cand: int = N_CAND) -> dict:
    """Drive ``infer`` and both ``detect`` methods once, checking the lists
    against the host reference on the same map; returns the launch counts
    (every count set to 0 just before, read just after, and after infer)."""
    from flypylib_tpu_torch.ops.host_reference import components_host, nms_host

    n_batches = net.tiled_inference(vol.shape).n_batches(vol.shape)
    reset_launch_counts()
    prob = net.infer(vol, keep_on_device=True)
    after_infer = launch_counts()
    require(tuple(prob.shape) == vol.shape and prob.dtype == torch.float32,
            f"prob map {tuple(prob.shape)} {prob.dtype}")
    require(bool(torch.isfinite(prob).all()), "prob map is not finite")
    # operating threshold of an untrained net: the n_cand-th largest value
    thr = float(torch.topk(prob.reshape(-1), min(n_cand, prob.numel()))
                .values[-1])
    dets_nms = net.detect(vol, threshold=thr, method="nms")
    dets_cc = net.detect(vol, threshold=thr, method="components")
    launches = launch_counts()

    host = prob.cpu().numpy()
    same_list(dets_nms, nms_host(host, window=NMS_WINDOW, threshold=thr), 0.0,
              "detect(method='nms') vs nms_host")
    same_list(dets_cc, components_host(host, threshold=thr), CENTROID_TOL,
              "detect(method='components') vs components_host")
    return {"n_batches": n_batches, "launches_infer": after_infer,
            "launches": launches, "threshold": thr, "n_nms": len(dets_nms),
            "n_cc": len(dets_cc),
            "above_threshold": int((prob >= thr).sum())}


def require_launches(res: dict, per_forward: dict, what: str) -> None:
    """Each kernel launched ``per_forward[name]`` times per forward (0 when
    absent): once in infer, three times over infer and both detects."""
    want = {name: per_forward.get(name, 0) for name in res["launches"]}
    require(res["launches_infer"] == want,
            f"{what}: infer launched {res['launches_infer']}, expected {want}")
    want3 = {name: 3 * n for name, n in want.items()}
    require(res["launches"] == want3,
            f"{what}: infer + 2 detects launched {res['launches']}, "
            f"expected {want3}")


def time_main_path(net, vol: np.ndarray, thr: float, card_str: str,
                   label: str = "main path") -> dict:
    prob = net.infer(vol, keep_on_device=True)  # warm
    mvox = vol.size / 1e6
    torch.cuda.reset_peak_memory_stats()
    t = {
        "infer": median_s(lambda: net.infer(vol, keep_on_device=True)),
        "nms": median_s(lambda: net.nms(prob, window=NMS_WINDOW,
                                        threshold=thr)),
        "components": median_s(lambda: net.components(prob, threshold=thr)),
        "detect_nms": median_s(lambda: net.detect(vol, threshold=thr)),
        "detect_components": median_s(
            lambda: net.detect(vol, threshold=thr, method="components")),
    }
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = str(net.module.dtype).replace("torch.", "")
    for k, s in t.items():
        print(f"{label} {k}: {s * 1e3:.2f} ms"
              + (f", {mvox / s:.3f} Mvox/s" if k != "nms" and
                 k != "components" else "")
              + f" ({VOLUME}^3, {dt}) [{card_str}]")
    print(f"{label} peak device memory {peak:.3f} GiB [{card_str}]")
    return t


def infer_phases(net, vol: np.ndarray, card_str: str, label: str) -> None:
    """Where one ``infer`` spends its host-clock time, without a profiler:
    the host pad (as ``TiledInference.infer`` pads), the upload, every
    tile batch's forward (CUDA events; one batch timed, times the number of
    batches) and the rest (tile slicing, sigmoid, stitching, host launch
    time not hidden behind the card).  Medians, each phase timed alone."""
    ti = net.tiled_inference(vol.shape)
    _, out_shape = ti.plan(vol.shape)
    c, tin, B = ti.ctx, ti.tile_in, ti.tile_batch

    def pad():
        p = np.pad(vol, c, mode="reflect") if c else vol
        return np.pad(p, [(0, o - s) for s, o in zip(vol.shape, out_shape)])

    padded = pad()
    t_pad = median_s(pad) * 1e3
    t_up = median_s(lambda: torch.from_numpy(padded).to("cuda")) * 1e3
    src = torch.from_numpy(padded).to("cuda")
    tiles = torch.stack([src[:tin, :tin, :tin]] * B)[..., None]
    module = ti.spec.module
    with torch.no_grad():
        t_fwd = median_ms(lambda: module(tiles), warmup=1, iters=5)
    n = ti.n_batches(vol.shape)
    t_inf = median_s(lambda: net.infer(vol, keep_on_device=True), iters=5) * 1e3
    rest = t_inf - t_pad - t_up - n * t_fwd
    print(f"{label} infer phases ({VOLUME}^3, tile in {tin}, {n} x batch "
          f"{B}): infer {t_inf:.2f} ms = host pad {t_pad:.2f} + upload "
          f"{t_up:.2f} + forwards {n} x {t_fwd:.2f} + rest {rest:.2f} "
          f"[{card_str}]", flush=True)
    del src, tiles


def profile_detect(net, vol: np.ndarray, thr: float, card_str: str,
                   methods=("nms", "components"), label: str = "") -> None:
    """Device time by kernel over one detect per method (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for method in methods:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            net.detect(vol, threshold=thr, method=method)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     for e in events)
        print(f"profile {label}detect({method}): device busy {dev_us / 1e3:.2f} ms "
              f"of {wall * 1e3:.2f} ms wall (profiled) [{card_str}]")
        print(events.table(sort_by="self_cuda_time_total", row_limit=25),
              flush=True)


# phase 10, the staged whole-volume engine (FplNetwork.detect_large)
STAGED_MODELS = (  # (label, zoo name, FplNetwork kwargs)
    ("packed baseline", "baseline", {}),
    ("plain baseline", "baseline", {"packed": False}),
    ("packed vgg_like", "vgg_like", {}),
)
STAGED_METHODS = ("nms", "components", "both")
NORTH_STAR = 1024        # the reference bench's staged_1k volume ...
NORTH_STAR_BLOBS = 128   # ... its blob count ...
NORTH_STAR_CORE = 512    # ... its ROI core ...
NORTH_STAR_PROBE = 128   # ... and the cutout its threshold comes from,
NORTH_STAR_QUANTILE = 0.9999  # at this quantile of the cutout's map


def scaled(vol: np.ndarray) -> np.ndarray:
    """The f32 volume a uint8 volume becomes inside ``detect_large``:
    ``x * f32(1/255)`` (``detect`` feeds raw values)."""
    return vol.astype(np.float32) * np.float32(1.0 / 255.0)


def by_method(result, method: str) -> dict:
    """``detect_large``'s result as ``{"nms": ..., "components": ...}``."""
    if method == "both":
        return {"nms": result[0], "components": result[1]}
    return {method: result}


def same_lists(got: dict, want: dict, what: str) -> None:
    for m, dets in got.items():
        same_list(dets, want[m], 0.0 if m == "nms" else CENTROID_TOL,
                  f"{what} {m}")


def staged_batches(plan, forward: str) -> int:
    """Tile batches (module calls) one detect_large runs in ``forward``."""
    if forward == "shared":
        return plan.full_pipe().n_batches
    return len(plan.grid) * plan.pipe.n_batches


def staged_launch_want(net, n: int) -> dict:
    """Launches of a staged detect of ``net`` over ``n`` tile batches: on
    the packed ConvStacks K5 once per batch and K2's stage kernel
    :func:`fused_convs` times, K1 four times (layers 1-3 on the wgmma
    route, layer 0 on the Ci = 1 kernel) on the plain baseline."""
    want = dict.fromkeys(launch_counts(), 0)
    if net.infer_spec.module is not net.module:  # a packed engine
        want["parity_split_kernel"] = n
        want["stage_bias_relu"] = fused_convs(net) * n
    else:
        want.update({"conv3d_bias_relu": 4 * n,
                     "conv3d_bias_relu:wgmma": 3 * n,
                     "conv3d_bias_relu:ci1": n})
    return want


def check_staged_256(port, card_str: str, vol: np.ndarray) -> dict:
    """10(a): ``detect_large`` in roi and shared modes, for every method,
    on the packed and plain baseline and packed ``vgg_like``, at
    ``default_tiling``'s tile and batch for ``detect``; every list must
    equal ``detect``'s on the scaled f32 volume, and each run must launch
    exactly its kernels.  Returns the launch counts per model and mode, and
    per model the threshold and ``detect``'s lists."""
    from flypylib_tpu_torch.infer.large import make_stream_plan
    from flypylib_tpu_torch.infer.tiled import default_tiling

    volf = scaled(vol)
    mvox = vol.size / 1e6
    counts, refs = {}, {}
    for label, name, kw in STAGED_MODELS:
        net = port.FplNetwork(name, device="cuda", seed=0, **kw)
        tiling = default_tiling(net.infer_spec, vol.shape)
        prob = net.infer(volf, *tiling, keep_on_device=True)
        thr = float(torch.topk(prob.reshape(-1), N_CAND).values[-1])
        want = {"nms": net.nms(prob, window=NMS_WINDOW, threshold=thr),
                "components": net.components(prob, threshold=thr)}
        del prob
        refs[label] = (thr, want)
        packed = kw.get("packed", "auto") is not False
        for forward in ("roi", "shared"):
            for method in STAGED_METHODS:
                plan = make_stream_plan(net.infer_spec, None, vol.shape,
                                        core=256, tile_out=tiling[0],
                                        tile_batch=tiling[1],
                                        window=NMS_WINDOW, threshold=thr,
                                        method=method)
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = net.detect_large(vol, threshold=thr, method=method,
                                       forward=forward, plan=plan)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got_counts = launch_counts()
                n = staged_batches(plan, forward)
                what = f"{label} detect_large({forward}, {method})"
                require(got_counts == staged_launch_want(net, n),
                        f"{what}: launches {got_counts}, expected "
                        f"{staged_launch_want(net, n)}")
                same_lists(by_method(got, method), want,
                           f"{what} vs detect on the scaled volume:")
                counts[(label, forward, method)] = got_counts
                print(f"{what}: {VOLUME}^3 uint8, tiles {tiling[0]} in "
                      f"batches of {tiling[1]}, {n} tile batches, launches "
                      f"K1 {got_counts['conv3d_bias_relu']} K5 "
                      f"{got_counts['parity_split_kernel']}; nms "
                      f"{len(want['nms'])}, components "
                      f"{len(want['components'])}: equal to detect's; "
                      f"{dt * 1e3:.2f} ms, {mvox / dt:.3f} Mvox/s (first "
                      f"call of its plan) [{card_str}]", flush=True)
        del net
        torch.cuda.empty_cache()
    return counts, refs


def check_staged_unet(port, card_str: str, vol: np.ndarray) -> None:
    """10(b): the U-Net (default packed engine) in shared mode: the lists
    of ``method="both"`` must equal the host reference's on the volume's
    part of the shell ``shared_prob`` wrote."""
    from flypylib_tpu_torch.infer.large import make_stream_plan, stage_volume
    from flypylib_tpu_torch.ops.host_reference import components_host, nms_host

    net = port.FplNetwork("unet", device="cuda", seed=0)
    plan = make_stream_plan(net.infer_spec, None, vol.shape, window=NMS_WINDOW,
                            method="both")
    staged = stage_volume(vol, plan=plan)
    shell = plan.shared_prob(staged)
    h = plan.h
    prob = shell[h:h + vol.shape[0], h:h + vol.shape[1], h:h + vol.shape[2]]
    require(bool(torch.isfinite(prob).all()), "unet shared shell: the "
                                              "volume's part is not finite")
    thr = float(torch.topk(prob.reshape(-1), N_CAND).values[-1])
    host = prob.cpu().numpy()
    del shell, prob
    reset_launch_counts()
    got = net.detect_large(vol, threshold=thr, method="both",
                           forward="shared", plan=plan, staged=staged)
    counts = launch_counts()
    same_lists(by_method(got, "both"),
               {"nms": nms_host(host, window=NMS_WINDOW, threshold=thr),
                "components": components_host(host, threshold=thr)},
               "unet detect_large(shared, both) vs the host reference on "
               "its shell:")
    want_counts = dict.fromkeys(counts, 0)
    want_counts["stage_bias_relu"] = (fused_convs(net)
                                      * staged_batches(plan, "shared"))
    require(counts == want_counts, f"unet (unfused tail): launches {counts}, "
                                   f"expected {want_counts}")
    fp = plan.full_pipe()
    print(f"unet detect_large(shared, both): {VOLUME}^3, shared grid tile "
          f"{fp._tiled.tile_out} (in {fp._tin}) batch {fp._tiled.tile_batch}, "
          f"shell {plan._shell_shape()}; nms {len(got[0])}, components "
          f"{len(got[1])}: equal to the host reference [{card_str}]",
          flush=True)
    del net, staged
    torch.cuda.empty_cache()


def activation_bytes(port, card_str: str) -> dict:
    """High-water of one bf16 tile-batch forward per tile-input voxel
    (``torch.cuda.max_memory_allocated`` less what was allocated before):
    the packed U-Net at its 1024^3 shared tile and packed ``vgg_like`` at
    its shared tile and batch; the figures behind ``_StreamPlan
    .act_bytes_per_voxel``."""
    from flypylib_tpu_torch.infer.large import make_stream_plan

    out = {}
    for regime, name in (("cover", "unet"), ("grid", "vgg_like")):
        net = port.FplNetwork(name, device="cuda", seed=0)
        plan = make_stream_plan(net.infer_spec, None, (NORTH_STAR,) * 3,
                                core=NORTH_STAR_CORE)
        fp = plan.full_pipe()
        B, tin = fp._tiled.tile_batch, fp._tin
        x = torch.rand((B, tin, tin, tin, 1), device="cuda")
        with torch.no_grad():
            net.infer_spec.module(x)  # warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            net.infer_spec.module(x)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        out[regime] = peak / (B * tin**3)
        print(f"activations: {net.infer_spec.name} batch {B} x {tin}^3: "
              f"{peak / 2**30:.3f} GiB, {out[regime]:.2f} bytes per input "
              f"voxel (plan constant {plan.act_bytes_per_voxel[regime]}) "
              f"[{card_str}]", flush=True)
        del net, x
        torch.cuda.empty_cache()
    return out


def north_star(port, card_str: str, vol: np.ndarray) -> dict:
    """10(c): the 1024^3 uint8 volume ``vol`` through the packed baseline's
    ``detect_large(core=512, method="both")`` with ``forward="auto"``,
    staged once by ``stage_volume_chunked`` and reused by three timed
    calls; the lists must equal ``detect``'s (its infer, then its nms and
    components verbs) on the scaled f32 volume at the shared grid's tile
    and batch."""
    from flypylib_tpu_torch.infer.large import (make_stream_plan,
                                                stage_volume,
                                                stage_volume_chunked)

    net = port.FplNetwork("baseline", device="cuda", seed=0)
    p = NORTH_STAR_PROBE
    cut = net.infer(scaled(vol[:p, :p, :p]))
    thr = float(np.quantile(cut, NORTH_STAR_QUANTILE))
    plan = make_stream_plan(net.infer_spec, None, vol.shape,
                            core=NORTH_STAR_CORE, window=NMS_WINDOW,
                            threshold=thr, method="both")
    fp = plan.full_pipe()
    # upload plus the reflect pad on the card, once, for its time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big, _ = stage_volume(vol, plan=plan)
    torch.cuda.synchronize()
    t_pad = time.perf_counter() - t0
    del big
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = stage_volume_chunked(vol, plan=plan)
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    mode = "shared" if plan.shared_auto() else "roi"
    kw = dict(threshold=thr, core=NORTH_STAR_CORE, method="both",
              staged=staged, plan=plan)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    nms_det, cc_det = net.detect_large(vol, **kw)
    counts = launch_counts()
    n = staged_batches(plan, mode)
    require(counts == staged_launch_want(net, n),
            f"1024^3 detect_large: launches {counts}, expected "
            f"{staged_launch_want(net, n)}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = net.detect_large(vol, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    same_lists(by_method(again, "both"), {"nms": nms_det, "components": cc_det},
               "1024^3 detect_large, a timed call vs the first:")
    # where one call's time goes: the shared forward, then the boxes
    split = {}
    if mode == "shared":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shell = plan.shared_prob(staged)
        torch.cuda.synchronize()
        split["forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan.consume_shared(shell)
        split["postprocess"] = time.perf_counter() - t0
        del shell
    del staged
    torch.cuda.empty_cache()
    # detect's lists at the shared grid's tiling, on the scaled volume
    t0 = time.perf_counter()
    prob = net.infer(scaled(vol), fp._tiled.tile_out, fp._tiled.tile_batch,
                     keep_on_device=True)
    want = {"nms": net.nms(prob, window=NMS_WINDOW, threshold=thr),
            "components": net.components(prob, threshold=thr)}
    t_ref = time.perf_counter() - t0
    del prob
    torch.cuda.empty_cache()
    same_lists({"nms": nms_det, "components": cc_det}, want,
               "1024^3 detect_large(both) vs detect on the scaled volume:")
    mv = [vol.size / 1e6 / t for t in times]
    res = {"mode": mode, "mvox_s": statistics.median(mv), "mvox_s_all": mv,
           "seconds": times, "upload_s": t_up, "upload_pad_s": t_pad,
           "peak_gib": peak, "tile_out": fp._tiled.tile_out,
           "tile_batch": fp._tiled.tile_batch, "launches": counts,
           "tile_batches": n, "threshold": thr, "n_nms": len(nms_det),
           "n_cc": len(cc_det), "split_s": split,
           "lists": {"nms": nms_det, "components": cc_det}}
    print(f"north star: {NORTH_STAR}^3 uint8, packed "
          f"baseline, core {NORTH_STAR_CORE}, method both, forward auto -> "
          f"{mode}; shared grid tile {res['tile_out']} batch "
          f"{res['tile_batch']} ({n} tile batches); threshold {thr:.9g} "
          f"(the {NORTH_STAR_QUANTILE} quantile of a {p}^3 cutout); nms "
          f"{len(nms_det)}, components {len(cc_det)}: equal to detect's "
          f"(reference {t_ref:.1f} s) [{card_str}]", flush=True)
    print(f"north star: detect_large {statistics.median(mv):.3f} Mvox/s "
          f"median of {', '.join(f'{m:.3f}' for m in mv)} "
          f"({', '.join(f'{t:.3f}' for t in times)} s); chunked upload "
          f"{t_up:.3f} s; upload plus reflect pad on the card "
          f"{t_pad:.3f} s; peak device memory {peak:.3f} GiB; launches "
          f"K5 {counts['parity_split_kernel']}; one call split: "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in split.items())} "
          f"[{card_str}]", flush=True)
    del net
    torch.cuda.empty_cache()
    return res


def staged_phase(port, card_str: str) -> dict:
    """Phase 10: 10(a) at 256^3, 10(b) the U-Net's shell, the activation
    high-water behind ``shared_auto``, 10(c) the 1024^3 north star.  The
    256^3 and 1024^3 volumes and 10(a)'s references are returned for
    phase 11 (``vol``, ``vol_1k``, ``refs``)."""
    t0 = time.perf_counter()
    vol = make_volume_u8(VOLUME, N_BLOBS, seed=0)
    res = {"vol": vol}
    res["256"], res["refs"] = check_staged_256(port, card_str, vol)
    check_staged_unet(port, card_str, vol)
    res["act"] = activation_bytes(port, card_str)
    t1 = time.perf_counter()
    res["vol_1k"] = make_volume_u8(NORTH_STAR, NORTH_STAR_BLOBS, seed=0)
    print(f"north star: {NORTH_STAR}^3 uint8 volume made in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    res["1k"] = north_star(port, card_str, res["vol_1k"])
    print(f"phase 10 (staged engine): {time.perf_counter() - t0:.1f} s "
          f"[{card_str}]", flush=True)
    return res


# phase 11, out-of-core streaming (detect_streaming through detect_large)
STREAM_BAND_CORE = 64  # 11(a)'s forced bands: four ROI rows of 256^3


def streaming_batches(plan, forward: str, rpb: int | None = None) -> int:
    """Tile batches (module calls) one streaming call runs: per ROI in roi
    mode, per band of ``rpb`` ROI rows in shared mode."""
    if forward == "roi":
        return len(plan.grid) * plan.pipe.n_batches
    return len(plan._band_starts(rpb)) * plan.band_pipe(rpb).n_batches


def check_streaming_256(port, card_str: str, vol: np.ndarray,
                        refs: dict) -> dict:
    """11(a): ``detect_large(vol, staged=False)`` (roi and shared) with
    10(a)'s plans, thresholds and lists, for every engine; the packed
    baseline also with device CC, ``fused_impl="nbr"`` and forced bands of
    one and two rows.  Returns the launch counts per run."""
    from flypylib_tpu_torch.infer.large import (_detect_streaming_shared,
                                                array_reader,
                                                make_stream_plan)
    from flypylib_tpu_torch.infer.tiled import default_tiling

    mvox = vol.size / 1e6
    shape, read = array_reader(vol)
    counts = {}
    for label, name, kw in STAGED_MODELS:
        net = port.FplNetwork(name, device="cuda", seed=0, **kw)
        tiling = default_tiling(net.infer_spec, vol.shape)
        thr, want = refs[label]
        packed = kw.get("packed", "auto") is not False
        runs = [("roi", {}, None), ("shared", {}, None)]
        if label == "packed baseline":
            runs += [("roi", {"cc_impl": "device"}, None),
                     ("shared", {"cc_impl": "device"}, None),
                     ("roi", {"fused_impl": "nbr"}, None),
                     ("shared", {"core": STREAM_BAND_CORE}, 1),
                     ("shared", {"core": STREAM_BAND_CORE}, 2)]
        for forward, opts, forced in runs:
            plan = make_stream_plan(
                net.infer_spec, None, vol.shape, core=opts.get("core", 256),
                tile_out=tiling[0], tile_batch=tiling[1], window=NMS_WINDOW,
                threshold=thr, method="both",
                cc_impl=opts.get("cc_impl", "sparse"),
                fused_impl=opts.get("fused_impl", "filter"))
            rpb = forced
            if forward == "shared" and rpb is None:
                rpb = plan.band_rpb(itemsize=1, cost_gate=False)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if forced:
                got = _detect_streaming_shared(plan, read, forced)
            else:
                got = net.detect_large(vol, staged=False, threshold=thr,
                                       method="both", forward=forward,
                                       plan=plan, cc_impl=plan.cc_impl)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got_counts = launch_counts()
            n = streaming_batches(plan, forward, rpb)
            tag = ", ".join(f"{k}={v}" for k, v in opts.items())
            what = (f"{label} detect_large(staged=False, {forward}"
                    + (f", {tag}" if tag else "")
                    + (f", bands of {forced} rows" if forced else "") + ")")
            require(got_counts == staged_launch_want(net, n),
                    f"{what}: launches {got_counts}, expected "
                    f"{staged_launch_want(net, n)}")
            same_lists(by_method(got, "both"), want,
                       f"{what} vs detect on the scaled volume:")
            counts[(label, forward, tag, forced)] = got_counts
            bands = (f"{len(plan._band_starts(rpb))} bands of {rpb} rows, "
                     if forward == "shared" else f"{len(plan.grid)} ROIs, ")
            fs = plan.fetch_seconds
            print(f"{what}: {VOLUME}^3 uint8, {bands}{n} tile batches, "
                  f"launches K1 {got_counts['conv3d_bias_relu']} K5 "
                  f"{got_counts['parity_split_kernel']}; nms "
                  f"{len(want['nms'])}, components {len(want['components'])}: "
                  f"equal to detect's; {dt * 1e3:.2f} ms, {mvox / dt:.3f} "
                  f"Mvox/s (first call of its plan; prefetch read "
                  f"{fs['read'] * 1e3:.2f} ms, pad {fs['pad'] * 1e3:.2f} ms) "
                  f"[{card_str}]", flush=True)
        del net
        torch.cuda.empty_cache()
    return counts


def auto_choice(plan) -> tuple[str, str]:
    """The mode ``forward="auto"`` takes for a uint8 volume streamed with
    ``plan``, and why."""
    fit = plan.band_rpb(itemsize=1, cost_gate=False)
    if fit is None:
        return "roi", "no band fits the card"
    nb = len(plan._band_starts(fit))
    gate = plan._shared_cost_ok(plan.band_pipe(fit), nb)
    why = (f"the largest band that fits is {fit} of "
           f"{len({c[0] for _, c in plan.grid})} ROI rows ({nb} band(s), "
           f"tile {plan.band_pipe(fit)._tiled.tile_out}); its grid reads "
           f"{'<=' if gate else '>'} 0.85 x the roi sweep's conv input "
           f"voxels (roi tile {plan.pipe._tiled.tile_out}), so the cost gate "
           f"{'passes' if gate else 'fails'}")
    return ("shared" if gate else "roi"), why


def streaming_north_star(port, card_str: str, vol: np.ndarray,
                         ns: dict) -> dict:
    """11(b): 10(c)'s volume written once to a ``.npy`` file and read back
    through ``np.load(mmap_mode="r")``, each window copied out of the file:
    ``detect_large((shape, read_fn), core=512, method="both")`` with
    ``forward="auto"`` and ``"shared"`` at the streaming default tiling,
    three calls each, then one ``auto`` call at 10(c)'s tile and batch.
    The shared lists and those at 10(c)'s tiling must equal 10(c)'s.  At
    the default tiling ``auto`` runs the roi mode, whose ROI tile differs
    from 10(c)'s, and cuDNN's bf16 sums follow the tile shape: its lists
    must equal ``detect``'s at the ROI tile and batch on the scaled
    volume."""
    import tempfile

    from flypylib_tpu_torch.infer.large import make_stream_plan

    net = port.FplNetwork("baseline", device="cuda", seed=0)
    thr = ns["threshold"]
    mvox = vol.size / 1e6
    out = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = Path(tmp) / "north_star.npy"
        t0 = time.perf_counter()
        np.save(path, vol)
        t_write = time.perf_counter() - t0
        mm = np.load(path, mmap_mode="r")
        shape = tuple(mm.shape)

        def read(lo, hi):
            return np.array(mm[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])

        kw = dict(window=NMS_WINDOW, threshold=thr, method="both")
        plan = make_stream_plan(net.infer_spec, None, shape,
                                core=NORTH_STAR_CORE, **kw)
        plan_10c = make_stream_plan(net.infer_spec, None, shape,
                                    core=NORTH_STAR_CORE,
                                    tile_out=ns["tile_out"],
                                    tile_batch=ns["tile_batch"], **kw)
        auto_mode, why = auto_choice(plan)
        print(f"streaming north star: {NORTH_STAR}^3 uint8 written to .npy in "
              f"{t_write:.2f} s; at the streaming default tiling forward auto "
              f"-> {auto_mode}: {why} [{card_str}]", flush=True)
        want = {"auto": None, "shared": ns["lists"], "auto 10(c) tiling":
                ns["lists"]}
        if auto_mode == "roi":
            pt = plan.pipe._tiled
            t0 = time.perf_counter()
            prob = net.infer(scaled(vol), pt.tile_out, pt.tile_batch,
                             keep_on_device=True)
            want["auto"] = {"nms": net.nms(prob, window=NMS_WINDOW,
                                           threshold=thr),
                            "components": net.components(prob, threshold=thr)}
            del prob
            torch.cuda.empty_cache()
            d = {m: len(want["auto"][m]) - len(ns["lists"][m])
                 for m in ("nms", "components")}
            print(f"streaming north star: detect at the ROI tile "
                  f"{pt.tile_out} batch {pt.tile_batch}: nms "
                  f"{len(want['auto']['nms'])}, components "
                  f"{len(want['auto']['components'])} ({d['nms']:+d}, "
                  f"{d['components']:+d} against 10(c)'s tile "
                  f"{ns['tile_out']}) in {time.perf_counter() - t0:.1f} s "
                  f"[{card_str}]", flush=True)
        else:
            want["auto"] = ns["lists"]
        runs = (("auto", plan, "auto", 3), ("shared", plan, "shared", 3),
                ("auto 10(c) tiling", plan_10c, "auto", 1))
        for label, p, forward, n_calls in runs:
            mode = auto_choice(p)[0] if forward == "auto" else "shared"
            rpb = (p.band_rpb(itemsize=1, cost_gate=forward == "auto")
                   if mode == "shared" else None)
            n = streaming_batches(p, mode, rpb)
            times, fetch, peaks = [], [], []
            for _ in range(n_calls):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = net.detect_large((shape, read), threshold=thr,
                                       core=NORTH_STAR_CORE, method="both",
                                       forward=forward, plan=p)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
                fetch.append(p.fetch_seconds["read"] + p.fetch_seconds["pad"])
                counts = launch_counts()
                require(counts == staged_launch_want(net, n),
                        f"1024^3 streaming {label}: launches {counts}, "
                        f"expected {staged_launch_want(net, n)}")
                same_lists(by_method(got, "both"), want[label],
                           f"1024^3 streaming {label} ({mode}):")
            mv = [mvox / t for t in times]
            out[label] = {"mode": mode, "mvox_s": statistics.median(mv),
                          "mvox_s_all": mv, "seconds": times,
                          "fetch_s": fetch, "peak_gib": max(peaks),
                          "rpb": rpb, "launches": counts, "tile_batches": n}
            where = (f"{len(p._band_starts(rpb))} band(s) of {rpb} rows"
                     if mode == "shared" else f"{len(p.grid)} ROIs")
            tile = (p.band_pipe(rpb) if mode == "shared" else p.pipe)._tiled
            ref = ("10(c)'s" if want[label] is ns["lists"]
                   else "detect's at the ROI tiling")
            print(f"streaming north star {label} -> {mode} ({where}, tile "
                  f"{tile.tile_out} batch {tile.tile_batch}, {n} tile "
                  f"batches, K5 {counts['parity_split_kernel']}): "
                  f"{statistics.median(mv):.3f} Mvox/s median of "
                  f"{', '.join(f'{m:.3f}' for m in mv)} "
                  f"({', '.join(f'{t:.3f}' for t in times)} s); prefetch "
                  f"thread reading {', '.join(f'{f:.3f}' for f in fetch)} s "
                  f"of those; peak device memory {max(peaks):.3f} GiB; nms "
                  f"{len(got[0])}, components {len(got[1])}: equal to {ref} "
                  f"[{card_str}]", flush=True)
        del mm
    del net
    torch.cuda.empty_cache()
    return out


def streaming_phase(port, card_str: str, staged: dict) -> dict:
    """Phase 11: 11(a) at 256^3, 11(b) the 1024^3 north star from a file."""
    t0 = time.perf_counter()
    res = {"256": check_streaming_256(port, card_str, staged["vol"],
                                      staged["refs"]),
           "1k": streaming_north_star(port, card_str, staged["vol_1k"],
                                      staged["1k"])}
    print(f"phase 11 (out-of-core streaming): {time.perf_counter() - t0:.1f} "
          f"s [{card_str}]", flush=True)
    return res


# phase 12, training and evaluation (Trainer, forward_train, ops/matching)
GRAD_PATCH = 34       # 12(a): the baseline's gradient batch, patch 34 ...
GRAD_BATCH = 8        # ... batch 8
UNET_GRAD_BATCH = 2   # the U-Net's, at its smallest patch >= 2 context + 16
# card vs CPU, one step on the same weights and batch: per parameter,
# max |g_card - g_cpu| <= GRAD_TOL[dtype] * max |g_cpu|, and the loss within
# LOSS_RTOL[dtype] relative.  The CPU runs every kernel's plain version; the
# card K1 / K5, cuDNN and its own sums.  A plain engine's CPU step takes the
# card's branch points (grad_decisions): two f32 sums in different orders
# put the odd ReLU input that is within rounding of 0 on opposite sides,
# and one such voxel moves the gradient of every layer below it by far more
# than rounding (on an H100, the plain U-Net at batch seed 1 has 3 such
# voxels; its worst gap is 8.0e-04 against the CPU's own step and 6.2e-06
# with the card's masks, while scripts/probe_unet_grad.py reads every op's
# f32 gradient within 6.1e-06 of f64 on the card's own values).  At most DECISION_FLIP_FRAC[dtype] of the outputs and pool
# windows may differ: bf16 outputs round at 8 bits, so a later layer's
# inputs differ by an ulp here and there and more of its ReLU inputs and
# pool ties land on the other side.  Readings on an H100 (seeds 1-3): see
# PERF.md, phase 12(a).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
DECISION_FLIP_FRAC = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
GRAD_SEEDS = (1, 2, 3)  # 12(a)'s batch seeds
LOSS_RTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
TRAIN_VOLUME = 128    # 12(b) and 12(c): the reference bench's train volume
TRAIN_BLOBS = 8       # size // 16 blobs
TRAIN_EPOCHS = 3
EVAL_TILING = (64, 8)  # tile_out, tile_batch of 12(b)'s voxel PR routes
EVAL_SLAB = 64
BENCH_TRAIN = (  # bench.py's bench_train: (engine, key prefix, batch, steps)
    ("plain", "train", 32, 100),
    ("packed", "train_packed", 32, 100),
    ("plain", "train_b128", 128, 50),
)
# the packed engine at batch 128 too: the card's side of the crossover
BENCH_CROSSOVER = (("packed", "train_packed_b128", 128, 50),)
BENCH_EPOCHS = 3


def grad_batch(seed: int, n: int, patch: int, ctx: int):
    """One fixed host batch (x, y, m, codes) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    out = patch - 2 * ctx
    x = rng.random((n, patch, patch, patch)).astype(np.float32)
    y = (rng.random((n, out, out, out)) > 0.9).astype(np.float32)
    m = (rng.random((n, out, out, out)) > 0.1).astype(np.float32)
    codes = rng.integers(0, 16, n)
    return x, y, m, codes


def train_grads(spec, engine: str, batch, device: str):
    """(loss, {name: grad or None (f32, CPU)}, launches) of one step's loss
    and backward through the engine's forward on ``device``; every launch
    count set to 0 just before and read just after."""
    from flypylib_tpu_torch.ops.conv import no_tf32
    from flypylib_tpu_torch.train.trainer import TrainConfig, make_loss_fn

    cfg = TrainConfig(patch_size=batch[0].shape[1], batch_size=len(batch[0]),
                      engine=engine)
    loss_fn, _, patch = make_loss_fn(spec, cfg)
    require(patch == batch[0].shape[1], f"patch {patch} is not the batch's")
    module = getattr(spec.module, "inner", spec.module)
    module.zero_grad(set_to_none=True)
    dev = torch.device(device)
    tensors = [torch.from_numpy(a).to(dev) for a in batch]
    reset_launch_counts()
    with no_tf32(dev):
        loss, _ = loss_fn(*tensors)
        loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = launch_counts()
    grads = {n: None if p.grad is None else p.grad.detach().float().cpu()
             for n, p in module.named_parameters()}
    return float(loss.detach()), grads, launches


@contextlib.contextmanager
def grad_decisions(module, ref: dict | None = None,
                   zero_dw: int | None = None):
    """Within the block, the steps of a plain model (``ConvStack`` or
    ``UNetValid``) keep its branch points in the dict it yields: every
    ReLU's output ("y", its mask y > 0: K1's own, or for a BatchNorm stack
    the ReLU after each BatchNorm, K1 running without one; then a
    ``ConvStack``'s head ReLU) and every pool's windows ("win", their first
    maxima).  Given ``ref``, another run's dict, each
    backward takes its ReLU mask and first maxima from ``ref``: the same
    piecewise-linear function is differentiated on both sides.  The forward
    is the model's own (K1 on a CUDA tensor, the plain version on a CPU one)
    and so is the backward's arithmetic.  ``zero_dw``, a broken control,
    zeroes the weight gradient of that layer's backward."""
    from flypylib_tpu_torch.models import zoo
    from flypylib_tpu_torch.ops.conv import Conv3dBiasReLU

    kept = {"y": [], "win": []}
    n_conv = [0]

    class Conv(Conv3dBiasReLU):
        @staticmethod
        def forward(ctx, x, w, b, dilation, relu=True):
            y = Conv3dBiasReLU.forward(ctx, x, w, b, dilation, relu)
            ctx.layer = n_conv[0]
            n_conv[0] += 1
            if relu:
                if ref is not None:
                    ctx.save_for_backward(
                        x, w, ref["y"][len(kept["y"])].to(y.device))
                kept["y"].append(y.detach())
            return y

        @staticmethod
        def backward(ctx, dy):
            dx, dw, db, dd, dr = Conv3dBiasReLU.backward(ctx, dy)
            if ctx.layer == zero_dw:
                dw = torch.zeros_like(dw)
            return dx, dw, db, dd, dr

    class Relu(torch.autograd.Function):
        """A ReLU outside K1 (after a BatchNorm, after the head), its mask
        y > 0 (or ``ref``'s)."""

        @staticmethod
        def forward(ctx, z):
            y = torch.relu(z)
            mask = (y if ref is None else ref["y"][len(kept["y"])].to(y.device)) > 0
            ctx.save_for_backward(mask)
            kept["y"].append(y.detach())
            return y

        @staticmethod
        def backward(ctx, g):
            (mask,) = ctx.saved_tensors
            return g * mask

    real = zoo.WindowMax

    class Max(real):
        @staticmethod
        def forward(ctx, x):
            m = real.forward(ctx, x)
            if ref is not None:
                xr = ref["win"][len(kept["win"])].to(x.device)
                ctx.save_for_backward(xr, xr.amax(dim=-2))
            kept["win"].append(x.detach())
            return m

    convs = list(module.convs)
    for c in convs:
        c.forward = lambda x, c=c: Conv.apply(x, c.weight, c.bias, c.dilation,
                                              c.relu)
    stack = isinstance(module, zoo.ConvStack)
    if stack:  # ConvStack.forward, its ReLUs outside K1 through Relu
        def forward(x, m=module):
            x = x.to(m.dtype)
            for i, conv in enumerate(m.convs):
                x = conv(x)
                if m.use_batchnorm:
                    x = Relu.apply(m.norms[i](x))
            x = Relu.apply(m.head(x, m.dtype))
            return m.logits(x, torch.float32)

        module.forward = forward
    zoo.WindowMax = Max
    try:
        yield kept
    finally:
        zoo.WindowMax = real
        for c in convs:
            del c.forward
        if stack:
            del module.forward


def first_max(win: torch.Tensor) -> torch.Tensor:
    """The index of each pool window's first maximum (window axis -2)."""
    hit = win == win.amax(dim=-2, keepdim=True)
    return (hit & (hit.cumsum(dim=-2) == 1)).to(torch.uint8).argmax(dim=-2)


def decision_flips(got: dict, ref: dict) -> tuple[int, int]:
    """(ReLU outputs on the other side of 0 + pool windows with another first
    maximum, outputs + windows) between two runs' branch points."""
    flips = sum(int(((y > 0) != (r.to(y.device) > 0)).sum())
                for y, r in zip(got["y"], ref["y"]))
    flips += sum(int((first_max(w) != first_max(r.to(w.device))).sum())
                 for w, r in zip(got["win"], ref["win"]))
    n = sum(y.numel() for y in got["y"])
    n += sum(w.numel() // w.shape[-2] for w in got["win"])
    return flips, n


def card_vs_cpu(cpu, gpu, engine: str, batch, own: bool = True,
                card_ctx=contextlib.nullcontext,
                zero_dw: int | None = None) -> dict:
    """One step's loss and gradients on the card and on the CPU, same
    weights and batch: ``loss_card``, ``loss_cpu``, ``errs`` (per parameter,
    :func:`grad_errors`), ``launches`` (the card's, counted around its step
    alone), ``grads_card``.  A plain engine's CPU step takes the card's
    branch points (:func:`grad_decisions`) and also gives ``flips`` (of
    ``decisions``) and, with ``own``, ``errs_own``: the gap to the CPU's
    step on its own branch points; ``grads_cpu`` the CPU's gradients and,
    for a plain engine, ``decisions_card`` the card's branch points.
    ``card_ctx`` (entered around the card's step alone) and ``zero_dw``
    break the card's step for a control."""
    res = {}
    plain = engine == "plain"
    with card_ctx(), (grad_decisions(gpu.module, zero_dw=zero_dw) if plain
                      else contextlib.nullcontext()) as card:
        res["loss_card"], g_gpu, res["launches"] = train_grads(
            gpu, engine, batch, "cuda")
    with (grad_decisions(cpu.module, ref=card) if plain
          else contextlib.nullcontext()) as cpu_own:
        res["loss_cpu"], g_cpu, _ = train_grads(cpu, engine, batch, "cpu")
    res["errs"] = grad_errors(g_gpu, g_cpu)
    res["grads_card"], res["grads_cpu"] = g_gpu, g_cpu
    res["decisions_card"] = card
    if plain:
        res["flips"], res["decisions"] = decision_flips(card, cpu_own)
        if own:
            _, g_own, _ = train_grads(cpu, engine, batch, "cpu")
            res["errs_own"] = grad_errors(g_gpu, g_own)
    return res


def case_ok(res: dict, dtype) -> bool:
    """Every gradient present, finite and within GRAD_TOL, the loss within
    LOSS_RTOL and the branch points within DECISION_FLIP_FRAC."""
    dl = abs(res["loss_card"] - res["loss_cpu"]) / abs(res["loss_cpu"])
    flips_ok = res.get("flips", 0) <= DECISION_FLIP_FRAC[dtype] * res.get(
        "decisions", 0)
    return grads_ok(res["errs"], GRAD_TOL[dtype]) and (
        dl <= LOSS_RTOL[dtype]) and flips_ok


def grad_errors(got: dict, want: dict) -> dict:
    """Per parameter max |got - want| / max |want|; inf where ``got`` has no
    gradient or a non-finite one."""
    errs = {}
    for name, w in want.items():
        g = got.get(name)
        if g is None or not bool(torch.isfinite(g).all()):
            errs[name] = math.inf
            continue
        errs[name] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                      1e-30)
    return errs


def grads_ok(errs: dict, tol: float) -> bool:
    return max(errs.values()) <= tol


def grad_launch_want(model: str, engine: str, dtype) -> dict:
    """Launches of one train step (forward; no kernel runs backward) by
    kernel and route: K5 once (packed baseline), K1 on every conv (plain
    baseline 4, plain U-Net 10; conv 0 on the Ci = 1 kernel, the others on
    the wgmma (bf16) or the f32 kernel), else none."""
    want = {}
    if engine == "packed":
        if model == "baseline":
            want["parity_split_kernel"] = 1
        return want
    n = 4 if model == "baseline" else 10
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    want.update({"conv3d_bias_relu": n, f"conv3d_bias_relu:{route}": n - 1,
                 "conv3d_bias_relu:ci1": 1})
    return want


def grad_case_specs(port, model: str, dtype):
    """The (CPU, card) specs of a gradient case, seed-0 weights both."""
    zoo = port.models
    make = {"baseline": zoo.baseline_model, "unet": zoo.unet}[model]
    cpu, gpu = make(seed=0, dtype=dtype), make(seed=0, dtype=dtype)
    gpu.module.to("cuda")
    return cpu, gpu


def grad_patch(model: str, spec) -> tuple[int, int]:
    """(patch, batch) of a gradient case: GRAD_PATCH x GRAD_BATCH for the
    baseline; for the U-Net its smallest patch >= 2 context + 16 that both
    engines take, at UNET_GRAD_BATCH."""
    if model == "baseline":
        return GRAD_PATCH, GRAD_BATCH
    from flypylib_tpu_torch.ops.packed_unet import packed_unet_spec

    p = packed_unet_spec(spec).valid_size(2 * spec.context + 16)
    require(spec.is_valid_size(p), f"U-Net patch {p} not valid plain")
    return p, UNET_GRAD_BATCH


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` is ``value`` within the block."""
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def tf32_on(device):
    """``ops.conv.no_tf32``'s broken twin for the controls: TF32 allowed."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def grad_controls(port, card_str: str) -> None:
    """Three broken gradients must fail 12(a)'s check (:func:`case_ok`):
    K5's output detached (the bare wrapper, whose output autograd cannot
    see) on the packed baseline, K1's backward with dw zeroed for layer 2
    of the plain baseline, and TF32 allowed in every f32 conv and product
    of the card's plain U-Net step (``ops.conv.no_tf32`` made a context
    that allows it), the path that runs K1's backward most."""
    from flypylib_tpu_torch.ops import conv, packed_conv
    from flypylib_tpu_torch.ops.split import parity_split_kernel

    dt = torch.float32
    for what, model, engine, card_ctx, zero_dw in (
            ("K5 output detached", "baseline", "packed",
             lambda: patched(packed_conv, "parity_batch",
                             lambda x: parity_split_kernel(x).detach()),
             None),
            ("K1 backward, layer 2 dw zeroed", "baseline", "plain",
             contextlib.nullcontext, 2),
            ("TF32 on in the card's step", "unet", "plain",
             lambda: patched(conv, "no_tf32", tf32_on), None)):
        cpu, gpu = grad_case_specs(port, model, dt)
        patch, n = grad_patch(model, cpu)
        batch = grad_batch(0, n, patch, cpu.context)
        r = card_vs_cpu(cpu, gpu, engine, batch, own=False,
                        card_ctx=card_ctx, zero_dw=zero_dw)
        errs = r["errs"]
        worst = max(errs, key=errs.get)
        print(f"gradient control ({what}), {engine} {model} f32: worst "
              f"{worst} {errs[worst]:.6g} (limit {GRAD_TOL[dt]:g}); "
              f"{sum(g is None for g in r['grads_card'].values())} "
              f"parameters without a gradient [{card_str}]", flush=True)
        require(not case_ok(r, dt),
                f"gradient control ({what}) passed the gradient check")
        del cpu, gpu
    torch.cuda.empty_cache()


def check_gradients(port, card_str: str, seeds=GRAD_SEEDS,
                    controls: bool = True) -> dict:
    """12(a): one step's loss and every parameter's gradient on the card
    against the CPU's plain path, same weights and batch, for each batch
    seed: the full-width baseline (patch 34, batch 8) and the U-Net, plain
    and packed, f32 and bf16; then the broken controls.  Returns launches
    per step by case."""
    per_step = {}
    for seed in seeds:
        for model in ("baseline", "unet"):
            for engine in ("plain", "packed"):
                for dt in (torch.float32, torch.bfloat16):
                    cpu, gpu = grad_case_specs(port, model, dt)
                    patch, n = grad_patch(model, cpu)
                    batch = grad_batch(seed, n, patch, cpu.context)
                    r = card_vs_cpu(cpu, gpu, engine, batch)
                    errs = r["errs"]
                    worst = max(errs, key=errs.get)
                    dl = abs(r["loss_card"] - r["loss_cpu"]) / abs(
                        r["loss_cpu"])
                    name = str(dt).replace("torch.", "")
                    label = f"{engine} {model} {name}"
                    extra = ""
                    if engine == "plain":
                        own = r["errs_own"]
                        w_own = max(own, key=own.get)
                        extra = (f"; branch points differing {r['flips']} of "
                                 f"{r['decisions']} (limit "
                                 f"{DECISION_FLIP_FRAC[dt]:g}), worst on the "
                                 f"CPU's own {own[w_own]:.6g} ({w_own})")
                    print(f"gradients seed {seed} {label} (patch {patch}, "
                          f"batch {n}, {len(errs)} parameters): loss card "
                          f"{r['loss_card']:.9g} CPU {r['loss_cpu']:.9g} "
                          f"(rel {dl:.3g}, limit {LOSS_RTOL[dt]:g}); worst "
                          f"max|dg|/max|g| {errs[worst]:.6g} ({worst}; limit "
                          f"{GRAD_TOL[dt]:g}), median "
                          f"{statistics.median(errs.values()):.3g}{extra} "
                          f"[{card_str}]", flush=True)
                    require(all(g is not None
                                for g in r["grads_card"].values()),
                            f"{label}: parameters without a gradient")
                    require(case_ok(r, dt), f"{label}, seed {seed}: gradient "
                            f"{worst} off by {errs[worst]}, loss by {dl}, "
                            f"{r.get('flips', 0)} branch points differ")
                    want = grad_launch_want(model, engine, dt)
                    want = {k: want.get(k, 0) for k in r["launches"]}
                    require(r["launches"] == want, f"{label}: one step "
                            f"launched {r['launches']}, expected {want}")
                    per_step[label] = {k: v for k, v in r["launches"].items()
                                       if v}
                    del cpu, gpu
                    torch.cuda.empty_cache()
    if controls:
        grad_controls(port, card_str)
    return per_step


def voxel_pr_equal(got: dict, want: dict) -> bool:
    return all(np.array_equal(got[k], want[k]) for k in want)


def train_main_path(port, card_str: str) -> dict:
    """12(b): the full-width baseline trains on a 128^3 uint8 blob volume
    with T-bars at the blob centres (TrainConfig's defaults: patch 33,
    batch 32, "auto" -> packed, 100 steps an epoch), validating on a second
    volume each epoch; then detect -> evaluate, evaluate_voxels on both
    routes against the host voxel_pr on the same map, and a save / restore
    round trip."""
    from flypylib_tpu_torch.io.synapses import Tbars, make_training_volumes
    from flypylib_tpu_torch.ops.matching import voxel_pr, voxel_pr_device
    from flypylib_tpu_torch.train.trainer import TrainConfig, resolve_engine

    vol, centers = make_volume_u8(TRAIN_VOLUME, TRAIN_BLOBS, seed=2,
                                  with_centers=True)
    vval, vcenters = make_volume_u8(TRAIN_VOLUME, TRAIN_BLOBS, seed=3,
                                    with_centers=True)
    tb, vtb = (Tbars(locs=c.astype(np.float64)) for c in (centers, vcenters))
    cfg = TrainConfig()
    net = port.FplNetwork("baseline", device="cuda", train_config=cfg)
    require(resolve_engine(net.spec, cfg) == "packed",
            "TrainConfig() does not resolve to the packed engine")
    ctx = net.context
    vlab, vmsk = make_training_volumes(vtb, vval.shape, radius=5.0,
                                       border=ctx)
    val_batches = net.tiled_inference(vval.shape).n_batches(vval.shape)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = net.train(vol, tbars=tb, epochs=TRAIN_EPOCHS,
                     val_data=(scaled(vval), vlab, vmsk), val_tbars=vtb)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = launch_counts()
    steps = TRAIN_EPOCHS * cfg.steps_per_epoch
    for ep in hist:
        print(f"train epoch {ep['epoch']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in ep.items() if k != "epoch")
            + f" [{card_str}]", flush=True)
    seen = {k: v for k, v in launches.items() if v}
    print(f"train: {steps} steps + {TRAIN_EPOCHS} validations in "
          f"{t_train:.2f} s ({steps / t_train:.2f} steps/s with validation); "
          f"launches {seen} [{card_str}]", flush=True)
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
    for ep in hist:
        for k in ("val_loss", "val_voxel_precision", "val_voxel_recall",
                  "val_obj_precision", "val_obj_recall"):
            require(k in ep and math.isfinite(ep[k]), f"epoch {ep['epoch']}: "
                    f"{k} missing or not finite")
    want = {k: 0 for k in launches}
    want["parity_split_kernel"] = steps + TRAIN_EPOCHS * val_batches
    # the validations run the inference engine (grad off), the steps not
    want["stage_bias_relu"] = fused_convs(net) * TRAIN_EPOCHS * val_batches
    require(launches == want, f"train launched {launches}, expected {want}")

    vol_f = scaled(vol)  # the values the trainer fed the model
    dets = net.detect(vol_f)
    curve = net.evaluate(dets, tb)
    pr = (curve["precision"][-1], curve["recall"][-1]) if len(dets) else (0, 0)
    print(f"detect -> evaluate: {len(dets)} detections, {len(tb)} T-bars; "
          f"precision {pr[0]:.4f} recall {pr[1]:.4f} at the last detection "
          f"[{card_str}]", flush=True)
    T, B = EVAL_TILING
    lab, msk = make_training_volumes(tb, vol.shape, radius=5.0, border=ctx)
    prob = net.infer(vol_f, tile_out=T, tile_batch=B, keep_on_device=True)
    host = prob.cpu().numpy()
    # besides the default thresholds, 19 values the map holds strictly
    # inside (0.001, 0.999): a trained map sits mostly at 0 and 1, where
    # counts would not see a voxel that moved by an ulp; at a map value
    # each count is exact only if that voxel is
    mid = np.sort(host[(host > 1e-3) & (host < 1 - 1e-3)])
    require(mid.size >= 19, f"only {mid.size} voxels strictly inside "
                            "(0.001, 0.999)")
    at_map = mid[np.linspace(0, mid.size - 1, 19).astype(np.int64)]
    for label, thr in (("default thresholds", None),
                       (f"19 map values in [{at_map[0]:.6g}, "
                        f"{at_map[-1]:.6g}]", at_map)):
        ref = voxel_pr(host, lab, msk, thresholds=thr)
        runs = (("voxel_pr_device", voxel_pr_device(prob, lab, msk,
                                                    thresholds=thr)),
                ("evaluate_voxels (device)", net.evaluate_voxels(
                    vol_f, lab, msk, thresholds=thr, tile_out=T,
                    tile_batch=B)),
                ("evaluate_voxels (streaming)", net.evaluate_voxels(
                    vol_f, lab, msk, thresholds=thr, slab=EVAL_SLAB,
                    tile_out=T, tile_batch=B)))
        for what, got in runs:
            same = voxel_pr_equal(got, ref)
            bad = int(sum((got[k] != ref[k]).sum() for k in ("precision",
                                                               "recall")))
            print(f"{what} vs host voxel_pr on the map at tile {T}, batch "
                  f"{B}, {label}: {'equal' if same else f'{bad} entries differ'}"
                  f" (precision {np.round(ref['precision'][[0, 9, 18]], 4)}, "
                  f"recall {np.round(ref['recall'][[0, 9, 18]], 4)} at the "
                  f"1st, 10th, 19th threshold) [{card_str}]", flush=True)
            require(same, f"{what} differs from voxel_pr in {bad} entries "
                          f"({label})")
    path = ROOT / "build" / "phase12_weights.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    net.save(str(path))
    other = port.FplNetwork("baseline", device="cuda", seed=1)
    other.restore(str(path))
    path.unlink()
    again = other.infer(vol_f, tile_out=T, tile_batch=B, keep_on_device=True)
    require(torch.equal(again, prob), "save / restore changed the map")
    print(f"save / restore: the map equal bit for bit [{card_str}]",
          flush=True)
    res = {"launches": launches, "steps": steps, "seconds": t_train,
           "history": hist}
    del net, other, prob, again
    torch.cuda.empty_cache()
    return res


def step_split(spec, cfg, data, state, gen, iters: int = 10) -> dict:
    """Median ms of the parts of the trainer's own step (``train_step`` of
    ``make_train_step``), each ended by a synchronise at a hook: sampling +
    augment (to the forward's call), forward (to the loss's call), loss +
    backward (to Adam's step) and Adam.  The hooks wrap the trainer
    module's ``_train_forward`` and ``masked_bce_loss`` and sit on the
    optimizer's step; the step itself is the trainer's."""
    from flypylib_tpu_torch.train import trainer

    marks = []

    def mark(*_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    real_forward, real_loss = trainer._train_forward, trainer.masked_bce_loss

    def train_forward(*args):
        forward = real_forward(*args)
        return lambda x: (mark(), forward(x))[1]

    trainer._train_forward = train_forward
    trainer.masked_bce_loss = lambda *a: (mark(), real_loss(*a))[1]
    hooks = (state.optimizer.register_step_pre_hook(mark),
             state.optimizer.register_step_post_hook(mark))
    parts = {"sample+augment": [], "forward": [], "loss+backward": [],
             "adam": []}
    try:
        train_step, _, _ = trainer.make_train_step(spec, cfg)
        for i in range(iters + 2):
            marks.clear()
            mark()
            train_step(state, gen, data)
            if i >= 2:  # warm-up
                for k, a, b in zip(parts, marks, marks[1:]):
                    parts[k].append((b - a) * 1e3)
    finally:
        trainer._train_forward, trainer.masked_bce_loss = (real_forward,
                                                           real_loss)
        for h in hooks:
            h.remove()
    require(all(len(v) == iters for v in parts.values()),
            "step split: a hook of the train step did not fire")
    return {k: statistics.median(v) for k, v in parts.items()}


def bench_train(port, card_str: str) -> dict:
    """12(c): the reference bench's bench_train on the card: steps/s and
    patch Mvox/s of the full-width baseline on a 128^3 random uint8 volume,
    min / median / max of BENCH_EPOCHS epochs after a warm-up epoch, each
    ended by reading the loss; one step split into its parts; the card's
    reading of the packed / plain crossover; the same-seed difference of
    two fits."""
    from flypylib_tpu_torch.models.zoo import baseline_model
    from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,
                                                  Trainer, make_train_step)

    rng = np.random.default_rng(0)
    size = TRAIN_VOLUME
    image = rng.integers(0, 256, (size,) * 3).astype(np.uint8)
    labels = (rng.random((size,) * 3) > 0.999).astype(np.float32)
    mask = np.ones((size,) * 3, np.float32)
    out, per_step, splits = {}, {}, {}
    runs = BENCH_TRAIN + BENCH_CROSSOVER
    for engine, prefix, bsz, n in runs:
        spec = baseline_model(seed=0)
        cfg = TrainConfig(patch_size=33, batch_size=bsz, augment=True,
                          steps_per_epoch=n, engine=engine)
        tr = Trainer(spec, cfg, seed=0, device="cuda")
        _, train_steps, pvox = make_train_step(spec, cfg)
        data = TrainData.build(image, labels, mask, pvox, device="cuda")
        state = tr.init_state()
        reset_launch_counts()
        float(train_steps(state, tr.generator, data, n)["loss"])  # warm-up
        per_step[prefix] = {k: v / n for k, v in launch_counts().items() if v}
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(BENCH_EPOCHS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(train_steps(state, tr.generator, data, n)["loss"])
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = statistics.median(times)
        rates = sorted(n / t for t in times)
        mvox = sorted(n * bsz * pvox**3 / t / 1e6 for t in times)
        out[f"{prefix}_steps_per_s"] = n / med
        out[f"{prefix}_patch_mvox_s"] = n * bsz * pvox**3 / med / 1e6
        out[f"{prefix}_steps_per_s_all"] = rates
        print(f"{prefix} ({engine}, batch {bsz}, patch {pvox}, {n} steps an "
              f"epoch): steps/s min {rates[0]:.3f} median {n / med:.3f} max "
              f"{rates[-1]:.3f}; patch Mvox/s min {mvox[0]:.3f} median "
              f"{n * bsz * pvox**3 / med / 1e6:.3f} max {mvox[-1]:.3f}; peak "
              f"{peak:.3f} GiB; launches per step {per_step[prefix]} "
              f"[{card_str}]", flush=True)
        if prefix in ("train_packed", "train_b128"):
            splits[prefix] = step_split(spec, cfg, data, state, tr.generator)
            sp = splits[prefix]
            print(f"{prefix} one step, synchronised parts (median of 10): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in sp.items())
                  + f", sum {sum(sp.values()):.3f} ms [{card_str}]",
                  flush=True)
        del tr, data, state, spec
        torch.cuda.empty_cache()
    r32 = out["train_packed_patch_mvox_s"] / out["train_patch_mvox_s"]
    r128 = (out["train_packed_b128_patch_mvox_s"]
            / out["train_b128_patch_mvox_s"])
    agrees = r32 > 1 > r128
    print(f"crossover: packed / plain patch Mvox/s {r32:.3f} at batch 32, "
          f"{r128:.3f} at batch 128; the card {'agrees' if agrees else 'does not agree'} "
          f"with the crossover at 96 (packed below, plain at and above) "
          f"[{card_str}]", flush=True)
    # two fits from the same seed: cuDNN's weight gradients are not
    # deterministic by default, so the difference is reported, not required
    fits = []
    for _ in range(2):
        spec = baseline_model(seed=0)
        tr = Trainer(spec, TrainConfig(steps_per_epoch=20), seed=0,
                     device="cuda")
        hist = tr.fit(image, labels, mask)
        fits.append((hist[0]["loss"], {k: v.detach().float().clone() for k, v
                                       in tr.module.state_dict().items()}))
        del tr, spec
    dparam = max(float((fits[0][1][k] - fits[1][1][k]).abs().max())
                 for k in fits[0][1])
    print(f"same seed, two fits of 20 steps on the card: loss "
          f"{fits[0][0]:.9g} / {fits[1][0]:.9g}, max |dparam| {dparam:.3g} "
          f"[{card_str}]", flush=True)
    torch.cuda.empty_cache()
    return {"bench": out, "launches_per_step": per_step, "splits": splits,
            "crossover_agrees": agrees}


def train_kernel_times(port, card_str: str) -> dict:
    """K1's and K5's forward beside their backward at the shapes a bf16
    train step gives them (median CUDA-event ms): K1 at the plain
    baseline's four layers in a batch-128 step (patch 33), its backward the
    Function's (cuDNN's weight and input gradients, no dx for layer 0); K5
    at the packed baseline's boundary in a batch-32 step (patch 34), its
    backward the inverse relayout."""
    from flypylib_tpu_torch.models.zoo import baseline_model
    from flypylib_tpu_torch.ops.conv import Conv3dBiasReLU, no_tf32
    from flypylib_tpu_torch.ops.packed_conv import ParityBatch, parity_unbatch
    from flypylib_tpu_torch.ops.split import parity_split_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    convs = baseline_model(seed=0).module.to("cuda").convs
    s, ci = 33, 1
    k1 = {"forward_ms": 0.0, "backward_ms": 0.0, "layers": []}
    for i, c in enumerate(convs):
        d, co = c.dilation, c.weight.shape[-1]
        x = torch.rand((128, s, s, s, ci), generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_(i > 0)
        with no_tf32(x.device):
            y = Conv3dBiasReLU.apply(x, c.weight, c.bias, d)
            dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
            fwd = median_ms(lambda: Conv3dBiasReLU.apply(
                x.detach(), c.weight, c.bias, d))
            bwd = median_ms(lambda: y.backward(dy, retain_graph=True))
        k1["layers"].append({"shape": [128, s, s, s, ci, co, d],
                             "forward_ms": fwd, "backward_ms": bwd})
        k1["forward_ms"] += fwd
        k1["backward_ms"] += bwd
        s, ci = s - 2 * d, co
        del x, y, dy
    x = torch.rand((32, 15, 15, 15, 256), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    y = ParityBatch.apply(x)
    g = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    k5 = {"shape": list(x.shape),
          "forward_ms": median_ms(lambda: parity_split_kernel(x.detach())),
          "backward_ms": median_ms(lambda: parity_unbatch(g).contiguous())}
    print("train-step kernel times, bf16: K1 (plain baseline, batch 128, "
          "patch 33) forward " + ", ".join(
              f"{v['forward_ms']:.4f}" for v in k1["layers"])
          + f" = {k1['forward_ms']:.4f} ms, backward " + ", ".join(
              f"{v['backward_ms']:.4f}" for v in k1["layers"])
          + f" = {k1['backward_ms']:.4f} ms; K5 (packed baseline boundary "
          f"{tuple(k5['shape'])}) forward {k5['forward_ms']:.4f} ms, "
          f"backward {k5['backward_ms']:.4f} ms [{card_str}]", flush=True)
    del convs, x, y, g
    torch.cuda.empty_cache()
    return {"conv3d_bias_relu": k1, "parity_split_kernel": k5}


def profile_train_steps(card_str: str) -> None:
    """One profiled train step (after two warm ones) of the packed engine
    at batch 32 and the plain stack at batch 128, on 12(c)'s volume:
    device time by op (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from flypylib_tpu_torch.models.zoo import baseline_model
    from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,
                                                  Trainer, make_train_step)

    rng = np.random.default_rng(0)
    size = TRAIN_VOLUME
    image = rng.integers(0, 256, (size,) * 3).astype(np.uint8)
    labels = (rng.random((size,) * 3) > 0.999).astype(np.float32)
    mask = np.ones((size,) * 3, np.float32)
    for engine, bsz in (("packed", 32), ("plain", 128)):
        spec = baseline_model(seed=0)
        cfg = TrainConfig(batch_size=bsz, engine=engine)
        tr = Trainer(spec, cfg, seed=0, device="cuda")
        step, _, pvox = make_train_step(spec, cfg)
        data = TrainData.build(image, labels, mask, pvox, device="cuda")
        state = tr.init_state()
        for _ in range(2):
            step(state, tr.generator, data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, tr.generator, data)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev_us = sum(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
                     for e in events)
        print(f"profile {engine} b{bsz} train step: device busy "
              f"{dev_us / 1e3:.3f} ms of {wall * 1e3:.3f} ms wall (profiled) "
              f"[{card_str}]")
        print(events.table(sort_by="self_cuda_time_total", row_limit=25),
              flush=True)
        del tr, data, state, spec
        torch.cuda.empty_cache()


def train_phase(port, card_str: str, profile: bool = False) -> dict:
    """Phase 12: gradients (a), the main path (b), throughput (c) and the
    kernels' train-step times; with ``profile``, one profiled train step
    per engine."""
    t0 = time.perf_counter()
    res = {"grads": check_gradients(port, card_str)}
    t1 = time.perf_counter()
    res["main"] = train_main_path(port, card_str)
    t2 = time.perf_counter()
    res["bench"] = bench_train(port, card_str)
    res["kernel_times"] = train_kernel_times(port, card_str)
    t3 = time.perf_counter()
    if profile:
        profile_train_steps(card_str)
    print(f"phase 12 (training and evaluation): {t3 - t0:.1f} s = gradients "
          f"{t1 - t0:.1f} + main path {t2 - t1:.1f} + throughput "
          f"{t3 - t2:.1f} [{card_str}]", flush=True)
    print(json.dumps({k: round(v, 3) for k, v in res["bench"]["bench"].items()
                      if not k.endswith("_all")}))
    return res


# ---------------------------------------------------------------------------
# phase 13, BatchNorm models, K1 without ReLU, resumable ROI streaming from
# DVID, host-streamed tiling
BN_SEED = 1          # the BatchNorm statistics' generator and calibration volume
ROI_VOLUME = 512     # 13(d): the volume the mock DVID node serves ...
ROI_SIZE = 256       # ... as grid_rois of this edge (8 ROIs)
ROI_STOP_AFTER = 3   # the interrupted run stops after this many ROIs
BN_STATS_RTOL = 1e-5  # 13(c): f32 running statistics, card vs CPU, per buffer
# 13(c): each gradient of the card's BatchNorm step against an f64 truth (on
# the card's branch points), max |g - g64| / max |g64|, within BN_TRUTH_RATIO
# times the CPU's own f32 (bf16) step's distance to it, or GRAD_TOL[dtype]
# if larger.  On an H100 (scripts/probe_bn_grad.py) every conv's f32 weight
# and input gradient is within 4.7e-06 of f64, yet both f32 steps read
# 1.4e-04-4.0e-04 from the truth below layer 3 (the CPU's own: 1.4e-04-
# 4.0e-04, the card's 1.5e-04-2.6e-04): BatchNorm's backward removes each
# channel's mean and its part along the normalised input, and the gradient
# that is left falls 30-45x in scale there, so the rounding of the layers
# above is that much larger beside it.  Card against CPU, two f32 steps,
# then reads up to 5.1e-04: 12(a)'s 1e-4 holds two sums of one gradient, not
# this loss of scale.  The ratio is the card's worst over the CPU's, 1.67
# on that run, with room; TF32 in the card's step must fail it.  The head's
# ReLU is a branch point too (grad_decisions): at batch seeds 1-9, 1-5 of
# its 8.2 M inputs, each within 2.4e-06 of 0, fall on the other side on the
# card than in f64, and one of them moved a step by up to 1.9e-03 from a
# truth that took its own head ReLU (either kernel of K1's f32 forward,
# whatever the size of its rounding; scripts/probe_k1_f32_accuracy.py).
# With the card's head decisions taken, both f32 routes read 0.17-0.69 of
# the limit at seeds 1-9 and TF32 8.0-9.6.
BN_TRUTH_RATIO = 2.0
BN_TRAIN_STEPS = 100  # 13(c): steps an epoch of the BatchNorm throughput run


def bn_state(port) -> dict:
    """The full-width baseline with BatchNorm (``ConvStack(24/32/48/64,
    dilations 1/1/2/2, head 96, use_batchnorm=True)``, seed-0 conv weights)
    as a state dict: each layer's running mean and variance are that
    layer's statistics over a seeded SMALL^3 calibration volume (raw uint8
    values, as ``detect`` feeds them), the mean moved by 0.1 standard
    deviations and the variance scaled by 0.5-1.5, and ``scale`` in
    0.5-1.5 and ``bias`` ~ 0.2 N(0, 1), all from a generator seeded
    BN_SEED: a BatchNorm that is not the identity, on activations of the
    size the layer sees."""
    zoo = port.models
    m = zoo.ConvStack(dtype=torch.float32, use_batchnorm=True,
                      generator=torch.Generator().manual_seed(0))
    x = make_volume_u8(SMALL, 2, seed=BN_SEED).astype(np.float32)
    h = torch.from_numpy(x)[None, ..., None]
    g = torch.Generator().manual_seed(BN_SEED)
    with torch.no_grad():
        for conv, norm in zip(m.convs, m.norms):
            h = conv(h)
            flat = h.reshape(-1, h.shape[-1])
            n = flat.shape[1]
            mean, std = flat.mean(0), flat.std(0)
            norm.mean.copy_(mean + 0.1 * std * torch.randn(n, generator=g))
            norm.var.copy_(torch.clamp(std * std, min=1e-3)
                           * (0.5 + torch.rand(n, generator=g)))
            norm.scale.copy_(0.5 + torch.rand(n, generator=g))
            norm.bias.copy_(0.2 * torch.randn(n, generator=g))
            h = torch.relu(norm(h))
    return m.state_dict()


def bn_spec(port, state: dict, dtype=torch.bfloat16):
    """A fresh ``ModelSpec`` of the BatchNorm baseline holding ``state``."""
    zoo = port.models
    m = zoo.ConvStack(dtype=dtype, use_batchnorm=True)
    m.load_state_dict(state)
    return zoo.ModelSpec(name="baseline_bn", module=m, context=6,
                         min_size=13, metadata={"batchnorm": True})


def baseline_layer_cases() -> list:
    """(label, B, input size, Ci, Co, d) of the baseline's four body layers
    at ``default_tiling``'s tile and batch for a VOLUME^3 volume."""
    from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
    from flypylib_tpu_torch.models.zoo import baseline_model

    spec = baseline_model()
    tile_out, batch = default_tiling(spec, (VOLUME,) * 3)
    s = TiledInference(spec, tile_out, batch).tile_in
    cases = []
    for i, conv in enumerate(spec.module.convs):
        _, _, _, ci, co = conv.weight.shape
        cases.append((f"baseline layer {i}", batch, s, ci, co, conv.dilation))
        s -= 2 * conv.dilation
    return cases


def check_k1_no_relu(card_str: str) -> dict:
    """13(a): K1 with ``relu=False`` against ``conv3d_reference(relu=False)``
    at the baseline's layer shapes, phase 3's limits: bf16 on "wgmma"
    (layers 1-3) and "ci1" (layer 0), f32 on "simt" (layers 1-3) and "ci1",
    and layer 1 with the input one element off a 16-byte boundary, bf16 on
    "wmma" and f32 on "fma".  On every route the kernel's clamped output
    (``relu=True``) must fail the same check.  The bf16 main-route cases are
    timed beside the plain version: the BatchNorm stack's K1 launches."""
    from flypylib_tpu_torch.ops.conv import (conv3d_bias_relu,
                                             conv3d_reference, k1_route)

    gen = torch.Generator(device="cuda").manual_seed(BN_SEED)
    summed = dict.fromkeys(("ms", "plain_ms", "max_abs_err"), 0.0)
    routes_seen = set()
    cases = [(c, dt, False) for c in baseline_layer_cases()
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(cases[2][0], dt, True)  # layer 1, unaligned
              for dt in (torch.float32, torch.bfloat16)]
    for (label, B, S, Ci, Co, d), dtype, unaligned in cases:
        shape = (B, S, S, S, Ci)
        if Ci == 1:
            x = torch.randint(0, 256, shape, generator=gen, device="cuda")
        else:
            x = torch.relu(torch.randn(shape, generator=gen, device="cuda"))
        x = x.to(dtype)
        if unaligned:  # the same values from one element past 16 bytes
            buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(shape)
        w = torch.randn((3, 3, 3, Ci, Co), generator=gen,
                        device="cuda") / math.sqrt(27 * Ci)
        b = 0.1 * torch.randn((Co,), generator=gen, device="cuda")
        route = k1_route(x, w, d)
        want_route = ("ci1" if Ci == 1
                      else {(torch.float32, False): "simt",
                            (torch.float32, True): "fma",
                            (torch.bfloat16, False): "wgmma",
                            (torch.bfloat16, True): "wmma"}[dtype, unaligned])
        dt = str(dtype).replace("torch.", "")
        require(route == want_route, f"K1 relu=False {label} {dt}: route "
                                     f"{route}, expected {want_route}")
        got = conv3d_bias_relu(x, w, b, d, relu=False)
        ref = conv3d_reference(x, w, b, d, relu=False)
        torch.cuda.synchronize()
        err, ok = conv_check(got, ref)
        neg = float((ref < 0).float().mean())
        clamped = conv3d_bias_relu(x, w, b, d)
        berr, bok = conv_check(clamped, ref)
        timed = dtype == torch.bfloat16 and not unaligned
        if timed:
            ms = median_ms(lambda: conv3d_bias_relu(x, w, b, d, relu=False))
            plain = median_ms(lambda: conv3d_reference(x, w, b, d, relu=False))
            summed["ms"] += ms
            summed["plain_ms"] += plain
            summed["max_abs_err"] = max(summed["max_abs_err"], err)
        print(f"K1 relu=False {label} x{tuple(x.shape)} d={d} {dt} [{route}]: "
              f"max|err| {err:.6g} {'ok' if ok else 'FAIL'} ({neg:.3f} of the "
              f"outputs negative); clamped anyway: max|err| {berr:.6g} "
              f"{'ok' if bok else 'FAIL'} (must fail)"
              + (f"; kernel {ms:.4f} ms, plain {plain:.4f} ms" if timed else "")
              + f" [{card_str}]", flush=True)
        require(ok, f"K1 relu=False {label} {dt} [{route}]: outside "
                    f"tolerance (max|err| {err})")
        require(neg > 0 and not bok, f"K1 relu=False {label} {dt}: the "
                                     "check passes a clamped output")
        routes_seen.add(route)
        del x, w, b, got, ref, clamped
    require(routes_seen == {"wgmma", "wmma", "ci1", "simt", "fma"},
            f"K1 relu=False ran on {sorted(routes_seen)} only")
    torch.cuda.empty_cache()
    return summed


def check_bn_paths(port, card_str: str, state: dict, vol: np.ndarray) -> dict:
    """13(b): the BatchNorm baseline's 48^3 maps, plain (K1 relu=False) and
    packed (folded BatchNorm, K5), card against the CPU under phase 7's
    and 8's limits; then at bf16 on the 256^3 volume ``infer`` and both
    ``detect`` methods on each engine, launches counted and the lists held
    to the host reference (``run_main_path``)."""
    for packed, limits in (
            (False, ((torch.float32, LOGIT_TOL_F32),
                     (torch.bfloat16, LOGIT_TOL_BF16))),
            (True, ((torch.float32, PACKED_LOGIT_TOL_F32),
                    (torch.bfloat16, PACKED_LOGIT_TOL_BF16)))):
        check_map(card_str, "packed baseline_bn" if packed else "baseline_bn",
                  lambda dev, dt, p=packed: port.FplNetwork(
                      bn_spec(port, state, dt), device=dev, packed=p),
                  make_volume_u8(SMALL, 2, seed=1), SMALL_TILING, limits)
    runs = {}
    for packed in (True, False):
        net = port.FplNetwork(bn_spec(port, state), device="cuda",
                              packed=packed)
        name = "packed baseline_bn" if packed else "plain baseline_bn"
        require(net.infer_spec.name == ("baseline_bn+packed" if packed
                                        else "baseline_bn")
                and not net.module.training, f"{name}: {net.infer_spec.name}")
        r = run_main_path(net, vol)
        nb = r["n_batches"]
        require_launches(r, {"parity_split_kernel": nb} if packed else
                         {"conv3d_bias_relu": 4 * nb,
                          "conv3d_bias_relu:wgmma": 3 * nb,
                          "conv3d_bias_relu:ci1": nb}, name)
        print(f"{name}: {nb} tile batches, launches {r['launches']}; "
              f"threshold {r['threshold']:.9g} ({r['above_threshold']} voxels "
              f"above); nms {r['n_nms']} detections, components {r['n_cc']}; "
              "both equal the host reference", flush=True)
        r["times"] = time_main_path(net, vol, r["threshold"], card_str, name)
        runs[name] = r
        del net
        torch.cuda.empty_cache()
    return runs


def bn_f64_grads(state: dict, batch, masks=None, dilations=(1, 1, 2, 2),
                 device: str = "cpu") -> dict:
    """Loss gradients of a BatchNorm stack (``state``; the baseline's
    ``dilations`` by default) in f64 autograd on ``device``, its ReLUs (the
    body's, then the head's) on ``masks`` (a run's ``grad_decisions`` "y";
    None: f64's own): the truth 13(c) and 14(d) hold the f32 steps to."""
    from flypylib_tpu_torch.ops.augment import augment_batch

    F = torch.nn.functional
    P = {k: v.to(device, torch.float64).clone().requires_grad_(
        not k.endswith(("mean", "var"))) for k, v in state.items()}
    x, y, m, codes = (torch.from_numpy(a).to(device) for a in batch)
    x, y, m = (augment_batch(v.double(), codes) for v in (x, y, m))
    h = x[..., None]
    for i, d in enumerate(dilations):
        w = P[f"convs.{i}.weight"]
        h = F.conv3d(h.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                     dilation=d).permute(0, 2, 3, 4, 1) + P[f"convs.{i}.bias"]
        mu = h.mean((0, 1, 2, 3))
        var = torch.clamp((h * h).mean((0, 1, 2, 3)) - mu * mu, min=0.0)
        h = ((h - mu) * (torch.rsqrt(var + 1e-5) * P[f"norms.{i}.scale"])
             + P[f"norms.{i}.bias"])
        h = torch.relu(h) if masks is None else h * (masks[i].to(device) > 0)
    h = h @ P["head.weight"] + P["head.bias"]
    h = (torch.relu(h) if masks is None
         else h * (masks[len(dilations)].to(device) > 0))
    lg = (h @ P["logits.weight"] + P["logits.bias"])[..., 0]
    bce = -y * F.logsigmoid(lg) - (1 - y) * F.logsigmoid(-lg)
    ((bce * m).sum() / m.sum().clamp(min=1)).backward()
    return {k: p.grad.cpu() for k, p in P.items() if p.grad is not None}


def bn_truth_errors(grads: dict, g64: dict) -> dict:
    """Per parameter max |g - g64| / max |g64|; a body conv's bias, whose
    true gradient is 0 (the train-mode BatchNorm after it removes any
    per-channel constant), against its kernel's max |g64| instead; inf
    where a gradient is missing or not finite."""
    errs = {}
    for name, t in g64.items():
        g = grads.get(name)
        if g is None or not bool(torch.isfinite(g).all()):
            errs[name] = math.inf
            continue
        scale = g64[name.replace(".bias", ".weight")] if (
            name.startswith("convs.") and name.endswith(".bias")) else t
        errs[name] = float((g.double() - t).abs().max()
                           / scale.abs().max())
    return errs


def bn_step_ok(res: dict, dtype) -> bool:
    """13(c)'s check: every gradient within max(GRAD_TOL, BN_TRUTH_RATIO x
    the CPU's own distance) of the f64 truth, the loss within LOSS_RTOL of
    the CPU's, the branch points within DECISION_FLIP_FRAC."""
    card, cpu = res["truth_card"], res["truth_cpu"]
    dl = abs(res["loss_card"] - res["loss_cpu"]) / abs(res["loss_cpu"])
    return all(card[n] <= max(GRAD_TOL[dtype], BN_TRUTH_RATIO * cpu[n])
               for n in card) and dl <= LOSS_RTOL[dtype] and (
        res["flips"] <= DECISION_FLIP_FRAC[dtype] * res["decisions"])


def bn_step(port, state: dict, dtype, batch, card_ctx=contextlib.nullcontext):
    """One BatchNorm train step card against CPU (``card_vs_cpu``, the CPU
    on the card's branch points) and both against :func:`bn_f64_grads`:
    ``card_vs_cpu``'s result plus ``truth_card`` / ``truth_cpu``
    (:func:`bn_truth_errors`) and ``stats`` (each running buffer after the
    step, max |card - CPU| / max |CPU|)."""
    cpu, gpu = bn_spec(port, state, dtype), bn_spec(port, state, dtype)
    gpu.module.to("cuda")
    res = card_vs_cpu(cpu, gpu, "plain", batch, own=False, card_ctx=card_ctx)
    g64 = bn_f64_grads(state, batch, res["decisions_card"]["y"])
    res["truth_card"] = bn_truth_errors(res["grads_card"], g64)
    res["truth_cpu"] = bn_truth_errors(res["grads_cpu"], g64)
    res["stats"] = {
        k: float((b_gpu.cpu() - b_cpu).abs().max()) / float(b_cpu.abs().max())
        for (k, b_gpu), (_, b_cpu) in zip(gpu.module.named_buffers(),
                                          cpu.module.named_buffers())}
    del res["decisions_card"]
    return res


def check_bn_training(port, card_str: str, state: dict,
                      plain_b32: dict) -> dict:
    """13(c): one f32 and one bf16 step of the BatchNorm baseline on the
    plain engine ("auto" resolves to it), card against the CPU on the
    card's branch points (12(a)'s ``card_vs_cpu``) and both against an f64
    truth (:func:`bn_step_ok`), TF32 in the card's f32 step a control that
    must fail; the running statistics after the step, card against CPU
    (f32 to BN_STATS_RTOL); then BENCH_EPOCHS timed epochs of b32 at patch
    33 beside 12(c)'s plain b32 (``plain_b32``: its median and per-epoch
    rates)."""
    from flypylib_tpu_torch.ops import conv
    from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,
                                                  Trainer, make_train_step,
                                                  resolve_engine)

    out = {"launches_per_step": {}}
    batch = grad_batch(GRAD_SEEDS[0], GRAD_BATCH, GRAD_PATCH, 6)
    require(resolve_engine(bn_spec(port, state), TrainConfig(
        batch_size=GRAD_BATCH)) == "plain",
        "a BatchNorm stack's auto engine is not plain")
    for dtype in (torch.float32, torch.bfloat16):
        res = bn_step(port, state, dtype, batch)
        dt = str(dtype).replace("torch.", "")
        want = grad_launch_want("baseline", "plain", dtype)
        seen = {k: v for k, v in res["launches"].items() if v}
        card, cpu = res["truth_card"], res["truth_cpu"]
        worst = max(card, key=lambda n: card[n] / max(
            GRAD_TOL[dtype], BN_TRUTH_RATIO * cpu[n]))
        vs_cpu = max(res["errs"], key=res["errs"].get)
        print(f"BN train step {dt}, plain, batch {GRAD_BATCH}, patch "
              f"{GRAD_PATCH}: loss card {res['loss_card']:.9g} CPU "
              f"{res['loss_cpu']:.9g}; against the f64 truth, card worst "
              f"{max(card.values()):.3g}, CPU worst {max(cpu.values()):.3g}; "
              f"closest to its limit {worst} card {card[worst]:.3g} CPU "
              f"{cpu[worst]:.3g} (limit max({GRAD_TOL[dtype]:g}, "
              f"{BN_TRUTH_RATIO:g} x CPU)); card vs CPU worst {vs_cpu} "
              f"{res['errs'][vs_cpu]:.3g}; {res['flips']} of "
              f"{res['decisions']} branch points differ; running stats max "
              f"rel {max(res['stats'].values()):.3g}"
              f"{f' (limit {BN_STATS_RTOL:g})' if dtype == torch.float32 else ''}"
              f"; launches {seen} [{card_str}]", flush=True)
        require(bn_step_ok(res, dtype), f"BN train step {dt}: the card's "
                f"gradients {card} against the CPU's {cpu}")
        require(seen == want, f"BN train step {dt}: launches {seen}, "
                              f"expected {want}")
        if dtype == torch.float32:
            require(max(res["stats"].values()) <= BN_STATS_RTOL,
                    f"BN running statistics, card vs CPU: {res['stats']}")
        out["launches_per_step"][f"bn baseline plain {dt}"] = seen
        out[dt] = {k: res[k] for k in ("truth_card", "truth_cpu", "errs",
                                       "stats")}
    bad = bn_step(port, state, torch.float32, batch,
                  card_ctx=lambda: patched(conv, "no_tf32", tf32_on))
    print(f"BN gradient control (TF32 on in the card's step), f32: card worst "
          f"{max(bad['truth_card'].values()):.3g} against the f64 truth, CPU "
          f"worst {max(bad['truth_cpu'].values()):.3g} "
          f"{'passes' if bn_step_ok(bad, torch.float32) else 'fails'} (must "
          f"fail) [{card_str}]", flush=True)
    require(not bn_step_ok(bad, torch.float32),
            "BN gradient control (TF32 on) passed the gradient check")
    # throughput: BENCH_EPOCHS epochs of b32 at patch 33, bench_train's way
    rng = np.random.default_rng(0)
    size = TRAIN_VOLUME
    image = rng.integers(0, 256, (size,) * 3).astype(np.uint8)
    labels = (rng.random((size,) * 3) > 0.999).astype(np.float32)
    mask = np.ones((size,) * 3, np.float32)
    spec = bn_spec(port, state)
    cfg = TrainConfig(patch_size=33, batch_size=32, augment=True,
                      steps_per_epoch=BN_TRAIN_STEPS)
    tr = Trainer(spec, cfg, seed=0, device="cuda")
    _, train_steps, pvox = make_train_step(spec, cfg)
    data = TrainData.build(image, labels, mask, pvox, device="cuda")
    st = tr.init_state()
    n = BN_TRAIN_STEPS
    reset_launch_counts()
    float(train_steps(st, tr.generator, data, n)["loss"])  # warm-up
    per_step = {k: v / n for k, v in launch_counts().items() if v}
    times = []
    for _ in range(BENCH_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(train_steps(st, tr.generator, data, n)["loss"])
        times.append(time.perf_counter() - t0)
    mvox = sorted(n * 32 * pvox**3 / t / 1e6 for t in times)
    med = statistics.median(mvox)
    out["train_bn_patch_mvox_s"] = med
    out["train_bn_patch_mvox_s_all"] = mvox
    require(not tr.module.training, "the trainer left the module in train mode")
    print(f"train_bn (plain, batch 32, patch {pvox}, {n} steps an epoch): "
          f"train_bn_patch_mvox_s min {mvox[0]:.3f} median {med:.3f} max "
          f"{mvox[-1]:.3f}; beside 12(c)'s plain b32 train_patch_mvox_s "
          f"median {plain_b32['median']:.3f} (epochs "
          f"{', '.join(f'{v:.3f}' for v in plain_b32['all'])}); launches "
          f"per step {per_step} [{card_str}]", flush=True)
    out["launches_per_step"]["bench train_bn"] = per_step
    del tr, data, st, spec
    torch.cuda.empty_cache()
    return out


class DVIDMock(BaseHTTPRequestHandler):
    """A DVID node in this process: ``raw/0_1_2`` GETs cut the class's
    uint8 ``volume``, ``elements`` POSTs are kept in ``posted``."""

    volume: np.ndarray = None
    posted: list = []

    def log_message(self, *a):
        pass

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        if "raw" not in parts:
            self.send_response(404)
            self.end_headers()
            return
        i = parts.index("raw")
        sx, sy, sz = map(int, parts[i + 2].split("_"))
        ox, oy, oz = map(int, parts[i + 3].split("_"))
        data = np.ascontiguousarray(
            self.volume[oz:oz + sz, oy:oy + sy, ox:ox + sx]).tobytes()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        DVIDMock.posted.append(json.loads(self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()


class StopStream(Exception):
    """Raised by 13(d)'s progress callback to stop a run part way."""


def posted_locs() -> set:
    """The (z, y, x) of every element POSTed to the mock so far."""
    return {tuple(el["Pos"][::-1]) for batch in DVIDMock.posted
            for el in batch}


def check_roi_streaming(port, card_str: str) -> dict:
    """13(d): ``stream_rois`` over ``grid_rois((ROI_VOLUME,)*3, ROI_SIZE)``
    through the packed baseline's ``DetectPipeline``, fetching by
    ``dvid_source`` from and posting by ``dvid_sink`` to an in-process mock
    DVID node on 127.0.0.1, with a ``state_path``.  Each ROI's list must
    equal ``detect`` of that ROI's scaled volume at the same tiling (the
    ROIs do not overlap, so each owns its whole box); the POSTs must be
    those lists in global coordinates; a second call must process nothing;
    a run stopped after ROI_STOP_AFTER ROIs by a raising ``progress``
    callback and then resumed must POST the same union."""
    from flypylib_tpu_torch.infer import (DetectPipeline, dvid_sink,
                                          dvid_source, grid_rois, stream_rois)
    from flypylib_tpu_torch.io import DVIDClient
    from flypylib_tpu_torch.infer.tiled import default_tiling

    t0 = time.perf_counter()
    DVIDMock.volume = make_volume_u8(ROI_VOLUME, ROI_VOLUME // 16, seed=4)
    DVIDMock.posted = []
    t_make = time.perf_counter() - t0
    srv = HTTPServer(("127.0.0.1", 0), DVIDMock)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    state_dir = ROOT / "build" / "phase13"
    state_dir.mkdir(parents=True, exist_ok=True)
    try:
        client = DVIDClient(f"127.0.0.1:{srv.server_port}", "phase13",
                            retries=0)
        rois = grid_rois((ROI_VOLUME,) * 3, ROI_SIZE)
        require(len(rois) == 8, f"{len(rois)} ROIs")
        net = port.FplNetwork("baseline", device="cuda", seed=0)
        shape = rois[0].size
        tile_out, tile_batch = default_tiling(net.infer_spec, shape)
        # the operating threshold: the N_CAND-th largest value of ROI 0's map
        probe = DetectPipeline(net.infer_spec, None, shape, tile_out=tile_out,
                               tile_batch=tile_batch)
        first = DVIDMock.volume[:ROI_SIZE, :ROI_SIZE, :ROI_SIZE]
        prob0 = probe.forward(first)[:ROI_SIZE, :ROI_SIZE, :ROI_SIZE]
        thr = float(torch.topk(prob0.reshape(-1), N_CAND).values[-1])
        pipe = DetectPipeline(net.infer_spec, None, shape, tile_out=tile_out,
                              tile_batch=tile_batch, window=NMS_WINDOW,
                              threshold=thr, run_cc=False)
        source, sink = dvid_source(client, "grayscale"), dvid_sink(
            client, "synapses")
        infos = []
        for path in state_dir.glob("*.json"):
            path.unlink()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = stream_rois(pipe, rois, source, sink=sink,
                          state_path=str(state_dir / "full.json"),
                          progress=lambda roi, info: infos.append(info))
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = launch_counts()
        nb = pipe.n_batches
        want_l = {k: 0 for k in launches}
        want_l["parity_split_kernel"] = len(rois) * nb
        want_l["stage_bias_relu"] = fused_convs(net) * len(rois) * nb
        require(launches == want_l, f"stream_rois launched {launches}, "
                                    f"expected {want_l}")
        require(list(got) == [r.key for r in rois], "ROIs missing")
        union = set()
        for roi in rois:
            cut = DVIDMock.volume[tuple(slice(o, o + s) for o, s in
                                        zip(roi.offset, roi.size))]
            ref = net.detect(scaled(cut), threshold=thr, tile_out=tile_out,
                             tile_batch=tile_batch)
            same_list(got[roi.key], ref, 0.0,
                      f"stream_rois ROI {roi.key} vs detect")
            union |= set(map(tuple, (got[roi.key].locs + np.asarray(
                roi.offset)).astype(np.int64).tolist()))
        n_det = sum(len(t) for t in got.values())
        posted = posted_locs()
        require(posted == union and sum(len(b) for b in DVIDMock.posted)
                == n_det, f"the sink POSTed {len(posted)} locations, "
                          f"the ROIs hold {len(union)}")
        again = stream_rois(pipe, rois, source, sink=sink,
                            state_path=str(state_dir / "full.json"))
        require(again == {}, f"a second call processed {len(again)} ROIs")
        # stopped after ROI_STOP_AFTER ROIs, then resumed
        DVIDMock.posted = []
        done = []

        def stop(roi, info):
            done.append(roi.key)
            if len(done) == ROI_STOP_AFTER:
                raise StopStream(roi.key)

        stopped = False
        try:
            stream_rois(pipe, rois, source, sink=sink,
                        state_path=str(state_dir / "resume.json"),
                        progress=stop)
        except StopStream:
            stopped = True
        require(stopped, "the progress callback did not stop the run")
        rest = stream_rois(pipe, rois, source, sink=sink,
                           state_path=str(state_dir / "resume.json"))
        require(list(rest) == [r.key for r in rois[ROI_STOP_AFTER:]],
                f"the resumed run processed {list(rest)}")
        require(posted_locs() == union, "stopped + resumed POSTs differ from "
                                        "the full run's")
        mvox = [int(np.prod(r.size)) / 1e6 / i["seconds"]
                for r, i in zip(rois, infos)]
        print(f"stream_rois {ROI_VOLUME}^3 from mock DVID ({len(rois)} ROIs of "
              f"{ROI_SIZE}^3, packed baseline, tile {tile_out} batch "
              f"{tile_batch}, threshold {thr:.9g}): {n_det} detections, "
              f"equal to detect per ROI and POSTed in global coordinates; "
              f"per ROI Mvox/s " + ", ".join(f"{v:.3f}" for v in mvox)
              + f"; total {ROI_VOLUME**3 / 1e6 / total:.3f} Mvox/s in "
              f"{total:.3f} s (fetch and POST included); second call: "
              f"nothing; stopped after {ROI_STOP_AFTER} and resumed: "
              f"{len(rest)} more ROIs, the same union (volume made in "
              f"{t_make:.1f} s) [{card_str}]", flush=True)
        res = {"launches": launches, "per_roi_mvox_s": mvox,
               "total_mvox_s": ROI_VOLUME**3 / 1e6 / total, "seconds": total}
        del net, probe, pipe
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=10)
        for path in state_dir.glob("*.json"):
            path.unlink()
        DVIDMock.volume = None
    torch.cuda.empty_cache()
    return res


def check_host_stream(port, card_str: str, vol: np.ndarray) -> dict:
    """13(e): ``infer(host_stream=True)`` against the whole-volume upload,
    bitwise, at VOLUME^3 for the packed baseline (tile batches of 8) and
    the plain U-Net (one covering tile), with both infer times."""
    out = {}
    for label, net in (
            ("packed baseline", port.FplNetwork("baseline", device="cuda",
                                                seed=0)),
            ("plain unet", port.FplNetwork("unet", device="cuda", seed=0,
                                           packed=False))):
        eng = net.tiled_inference(vol.shape)
        want = eng.infer(vol, keep_on_device=True)
        got = eng.infer(vol, keep_on_device=True, host_stream=True)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{label}: host_stream changed the map")
        t_dev = median_s(lambda: eng.infer(vol, keep_on_device=True))
        t_host = median_s(lambda: eng.infer(vol, keep_on_device=True,
                                            host_stream=True))
        print(f"host_stream {label} {VOLUME}^3 (tile in {eng.tile_in}, "
              f"{eng.n_batches(vol.shape)} x batch {eng.tile_batch}): the map "
              f"equal bit for bit; infer {t_dev * 1e3:.2f} ms whole upload, "
              f"{t_host * 1e3:.2f} ms host-streamed [{card_str}]", flush=True)
        out[label] = {"infer_ms": t_dev * 1e3, "host_stream_ms": t_host * 1e3}
        del net, eng, want, got
        torch.cuda.empty_cache()
    return out


def bn_roi_phase(port, card_str: str, vol: np.ndarray | None = None,
                 plain_b32: dict | None = None) -> dict:
    """Phase 13: K1 without ReLU (a), the BatchNorm baseline's paths (b) and
    training (c), ``stream_rois`` from a mock DVID node (d) and
    ``host_stream`` (e).  ``vol``: the VOLUME^3 volume (made here when
    None); ``plain_b32``: 12(c)'s plain b32 patch Mvox/s (``median``,
    ``all``), read here when None."""
    t0 = time.perf_counter()
    if vol is None:
        vol = make_volume_u8(VOLUME, N_BLOBS, seed=0)
    if plain_b32 is None:
        plain_b32 = {"median": math.nan, "all": []}
    state = bn_state(port)
    res = {"k1": check_k1_no_relu(card_str)}
    t1 = time.perf_counter()
    res["paths"] = check_bn_paths(port, card_str, state, vol)
    t2 = time.perf_counter()
    res["train"] = check_bn_training(port, card_str, state, plain_b32)
    t3 = time.perf_counter()
    res["rois"] = check_roi_streaming(port, card_str)
    t4 = time.perf_counter()
    res["host_stream"] = check_host_stream(port, card_str, vol)
    t5 = time.perf_counter()
    res["seconds"] = t5 - t0
    print(f"phase 13 (BatchNorm, ROI streaming, host_stream): {t5 - t0:.1f} s "
          f"= K1 relu=False {t1 - t0:.1f} + BN paths {t2 - t1:.1f} + BN "
          f"training {t3 - t2:.1f} + stream_rois {t4 - t3:.1f} + host_stream "
          f"{t5 - t4:.1f} [{card_str}]", flush=True)
    return res


# phase 14, the multi-device layer (parallel/, detect_large(devices=)) on
# the one card: repeated cuda:0 slots, a world of one on NCCL, two gloo ranks
FANOUT_CORE = 128  # 14(a): 8 ROIs of the 256^3 volume in two z-rows
FANOUT_SLOTS = (1, 2, 3)  # the staged fan-out's lists of cuda:0
SHARD_MESHES = (  # 14(b): (label, mesh shape, axis names)
    ("1-D", (4,), ("space",)),
    ("2-D", (2, 2), ("z", "y")),
    ("3-D", (2, 2, 2), ("z", "y", "x")),
)
DIST_MESHES = SHARD_MESHES[:2]  # 14(d): meshes that span both gloo ranks
SHARD_TILING = (64, 8)  # detect's tiling of the 256^3 volume
DP_PATCH, DP_BATCH = 34, 32  # 14(c)/(d): the f32 full-width DP step
DP_VOLUME = 64  # its training volume (random, seeded)
DP_SEED = 3     # the generator both steps draw the global batch from
# the reference's limits for DP == single (tests/test_parallel.py): loss
# rtol, parameters atol after one Adam step (where the gradient is not 0 up
# to the gradients' limit: there Adam's first step moves an element by
# about lr either way); gradients per tensor relative to its max |g|,
# 12(a)'s f32 limit.  A BatchNorm stack's gradients are held to an f64
# truth instead, as 13(c) holds them: BatchNorm's backward leaves the lower
# layers' gradients 30-45x smaller per layer than the rounding from above,
# so two f32 sum orders of the full-width b32 step differ there by far
# more than 1e-4 of a tensor's max |g|.  Each tensor of the DP step must lie
# within max(DP_GRAD_TOL, BN_TRUTH_RATIO x the single step's own distance)
# of the truth.  As 13(c), the DP step runs on the single step's branch
# points and the truth on the same ones: a ReLU input within rounding of 0
# that lands on the other side in one step (the DP step sums BatchNorm's
# moments in another order) moves it by ~1e-3 from the other, and Adam's
# first step moves such an element by lr either way (fault F6).
DP_LOSS_RTOL = 1e-5
DP_PARAM_ATOL = 1e-5
DP_GRAD_TOL = 1e-4
DP_ZERO_GRAD = 1e-6  # a gradient tensor below this fraction of the largest
DP_TIMED_STEPS = 10
WORKER_TIMEOUT = 300  # seconds a phase-14 subprocess may take


def mesh_of(port, dims, axes, devices):
    """A port mesh of ``dims`` over ``devices`` (this rank's slots)."""
    P = port.parallel
    if len(dims) == 1:
        return P.make_mesh(dims[0], axis=axes[0], devices=devices)
    if len(dims) == 2:
        return P.make_mesh_2d(tuple(dims), axes=tuple(axes), devices=devices)
    return P.make_mesh_3d(tuple(dims), axes=tuple(axes), devices=devices)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_models(port, small: bool) -> dict:
    """The DP cases: ``{name: (make_spec, TrainConfig)}``.  Full width: the
    f32 baseline (packed, b32, patch 34) and the f32 BatchNorm baseline
    (plain); ``small``: the test stacks (features 4/6, dilations 1/2, head
    8), batch 8, patch 10."""
    zoo = port.models
    from flypylib_tpu_torch.train import TrainConfig

    kw = (dict(features=(4, 6), dilations=(1, 2), head_features=8) if small
          else {})
    patch, batch = (10, 8) if small else (DP_PATCH, DP_BATCH)

    def bn():
        m = zoo.ConvStack(dtype=torch.float32, use_batchnorm=True,
                          generator=torch.Generator().manual_seed(0), **kw)
        ctx = sum(kw.get("dilations", (1, 1, 2, 2)))
        return zoo.ModelSpec(name="baseline_bn", module=m, context=ctx,
                             min_size=2 * ctx + 1)

    return {
        "baseline": (lambda: zoo.baseline_model(dtype=torch.float32, seed=0,
                                                **kw),
                     TrainConfig(patch_size=patch, batch_size=batch,
                                 engine="packed")),
        "bn": (bn, TrainConfig(patch_size=patch, batch_size=batch,
                               engine="plain")),
    }


@contextlib.contextmanager
def deterministic():
    """cuDNN on deterministic algorithms for the block: its default
    weight-gradient algorithms sum with atomics, so two runs of one step
    differ in the last bits and only a deterministic pair can be compared
    bit for bit."""
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = old


def dp_case(port, device: str, make_spec, cfg, control=None,
            timed: bool = False, dump: str | None = None) -> dict:
    """One DP step over a mesh of one slot a rank against the single-device
    step on the same global batch (the same seed), from the same weights,
    both on deterministic cuDNN algorithms: the loss's relative gap, the
    parameters' max gap (where the gradient is not 0 within the gradients'
    limit; ``params_at_rounding`` counts the others), the gradients' max
    gap relative to each tensor's largest (to the largest of all for a
    tensor of rounding noise) and ``grad_ok``, their check against
    ``grad_limits``: DP_GRAD_TOL, or for a BatchNorm stack the distance to
    an f64 truth (:func:`bn_f64_grads` on the global batch) within
    max(DP_GRAD_TOL, BN_TRUTH_RATIO x the single step's), both distances
    kept in ``truth``; as 13(c), the DP step runs on the single step's
    branch points (each rank on its rows of them, :func:`grad_decisions`)
    and the truth on the same ones.  ``bitwise``: all three bit for bit.  ``control``:
    ``(name, value)`` patched into ``parallel/train.py`` for the DP step
    (a broken control).  ``timed``: then also steps/s of both, on the
    default algorithms.  ``dump``: an ``.npz`` path that gets the weights
    before the step (``w0:``), the augmented global batch (``x``, ``y``,
    ``m``), the DP step's loss, gradients (``grad:``) and state after it
    (``after:``), for a comparison with the reference's DP step."""
    from flypylib_tpu_torch.ops.augment import augment_batch
    from flypylib_tpu_torch.parallel import train as ptrain
    from flypylib_tpu_torch.train import TrainData
    from flypylib_tpu_torch.train.trainer import (TrainState, make_loss_fn,
                                                  make_train_step)

    rng = np.random.default_rng(0)
    size = 24 if cfg.batch_size <= 8 else DP_VOLUME
    image = rng.random((size,) * 3).astype(np.float32)
    labels = (rng.random((size,) * 3) > 0.9).astype(np.float32)
    mask = (rng.random((size,) * 3) > 0.1).astype(np.float32)
    dev = torch.device(device)
    out, steps, branch = {}, {}, None
    for kind in ("single", "dp"):
        spec = make_spec()
        spec.module.to(dev)
        bn = getattr(spec.module, "use_batchnorm", False)
        state0 = {k: v.detach().cpu().clone()
                  for k, v in spec.module.state_dict().items()}
        ctx = (patched(ptrain, *control) if control and kind == "dp"
               else contextlib.nullcontext())
        with ctx, deterministic():
            if kind == "dp":
                mesh = port.parallel.make_mesh(devices=[device])
                step, _, patch = port.parallel.make_dp_train_step(spec, cfg,
                                                                  mesh)
            else:
                step, _, patch = make_train_step(spec, cfg)
            data = TrainData.build(image, labels, mask, patch, device=dev)
            # the global batch both steps draw (the generator's first draw)
            x, y, m, codes = make_loss_fn(spec, cfg)[1](
                torch.Generator(device=dev).manual_seed(DP_SEED), data)
            if codes is None:
                codes = torch.zeros(cfg.batch_size, dtype=torch.int64)
            batch = tuple(a.cpu().numpy() for a in (x, y, m, codes))
            state = TrainState.create(spec.module, cfg.learning_rate)
            gen = torch.Generator(device=dev).manual_seed(DP_SEED)
            ref = None
            if bn and kind == "dp":  # this rank's rows of the single step's
                rows = ptrain.rank_rows(mesh, "data", cfg.batch_size)[0]
                ref = {"y": [t[rows] for t in branch["y"]], "win": []}
            reset_launch_counts()
            with (grad_decisions(spec.module, ref=ref) if bn
                  else contextlib.nullcontext()) as dec:
                metrics = step(state, gen, data)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = launch_counts()
            if bn and kind == "single":
                branch = dec
        out[kind] = (float(metrics["loss"]),
                     {n: p.detach().float().cpu().clone()
                      for n, p in spec.module.named_parameters()},
                     {n: p.grad.detach().float().cpu().clone()
                      for n, p in spec.module.named_parameters()},
                     launches)
        if kind == "dp" and dump:
            np.savez(dump, loss=out[kind][0],
                     **{f"w0:{k}": v.numpy() for k, v in state0.items()},
                     **{k: augment_batch(torch.from_numpy(a), batch[3]).numpy()
                        for k, a in zip("xym", batch)},
                     **{f"grad:{k}": v.numpy()
                        for k, v in out[kind][2].items()},
                     **{f"after:{k}": v.detach().float().cpu().numpy()
                        for k, v in spec.module.state_dict().items()})
        if timed:
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP_TIMED_STEPS):
                step(state, gen, data)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            steps[kind] = DP_TIMED_STEPS / (time.perf_counter() - t0)
    (l1, p1, g1, _), (l2, p2, g2, launches) = out["single"], out["dp"]
    # each gradient against its own tensor's scale; a tensor whose gradient
    # is 0 up to rounding (below DP_ZERO_GRAD of the largest: a conv bias
    # before BatchNorm, whose batch mean cancels it) against the largest
    gmax = max(float(g1[n].abs().max()) for n in g1)
    scale = {n: float(g1[n].abs().max()) for n in g1}
    scale = {n: v if v > DP_ZERO_GRAD * gmax else gmax
             for n, v in scale.items()}
    errs = {n: float((g2[n] - g1[n]).abs().max()) / scale[n] for n in g1}
    limits, truth = {n: DP_GRAD_TOL for n in g1}, None
    if branch is not None:
        g64 = bn_f64_grads(state0, batch, branch["y"],
                           tuple(c.dilation for c in spec.module.convs), dev)
        truth = {"single": bn_truth_errors(g1, g64),
                 "dp": bn_truth_errors(g2, g64)}
        limits = {n: max(DP_GRAD_TOL, BN_TRUTH_RATIO * truth["single"][n])
                  for n in g1}
    held = errs if truth is None else truth["dp"]
    # Adam's first step moves an element by lr * g / (|g| + eps): where the
    # gradient is 0 up to its limit, two sum orders may move it by up to lr
    # either way, so the parameters are compared elsewhere
    live = {n: g1[n].abs() > limits[n] * scale[n] for n in g1}
    res = {
        "loss": l2, "single_loss": l1, "loss_rel": abs(l2 - l1) / abs(l1),
        "param_err": max(float((p2[n] - p1[n])[live[n]].abs().max())
                         if live[n].any() else 0.0 for n in p1),
        "param_err_all": max(float((p2[n] - p1[n]).abs().max()) for n in p1),
        "params_at_rounding": sum(int((~v).sum()) for v in live.values()),
        "grad_errs": errs, "truth": truth, "grad_limits": limits,
        "grad_ok": all(held[n] <= limits[n] for n in held),
        "bitwise": l1 == l2 and all(torch.equal(p1[n], p2[n]) for n in p1)
        and all(torch.equal(g1[n], g2[n]) for n in g1),
        "launches": {k: v for k, v in launches.items()
                     if ":" not in k and v},
    }
    res["grad_err"] = max(errs.values())
    res["grad_worst"] = max(errs, key=errs.get)
    res["grad_scale"] = {n: v / gmax for n, v in scale.items()}
    if timed:
        res["steps_per_s"] = steps
    return res


def dp_ok(res: dict) -> bool:
    """The DP == single check: the loss and the parameters within the
    reference's limits, the gradients within theirs (``grad_ok``)."""
    return (res["loss_rel"] <= DP_LOSS_RTOL
            and res["param_err"] <= DP_PARAM_ATOL and res["grad_ok"])


def dist_worker(cfg: dict) -> int:
    """One rank of a phase-14 world (14(c), 14(d), and the CPU rehearsal in
    ``tests/test_torch_distributed.py``): joins the world, sums a value
    over it, runs ``sharded_infer`` / ``sharded_nms`` /
    ``sharded_components`` over each of ``cfg["meshes"]`` (rank 0 writes
    the gathered map and the lists under ``cfg["out"]``), then the DP cases
    ``cfg["dp"]`` against the single-device step.  Prints one JSON line."""
    port = import_port()
    P = port.parallel
    from flypylib_tpu_torch.parallel import distributed

    device, world, rank = cfg["device"], cfg["world"], cfg["rank"]
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    t0 = time.perf_counter()
    P.ensure_initialized(f"localhost:{cfg['port']}", world, rank,
                         backend=cfg["backend"])
    res = {"rank": rank, "world": torch.distributed.get_world_size(),
           "backend": torch.distributed.get_backend(),
           "psum": float(distributed.all_reduce_sum(
               torch.tensor([rank + 1.0], device=device))[0]),
           "local_batch": P.local_batch_size(8), "sharded": {}, "dp": {}}
    kw = (dict(features=(4, 6), dilations=(1, 2), head_features=8,
               dtype=torch.float32) if cfg["small"] else {})
    spec = port.FplNetwork("baseline", device=device, seed=0, **kw).infer_spec
    vol = make_volume_u8(cfg["volume"], max(1, cfg["volume"] // 16), seed=0)
    out = Path(cfg["out"])
    tile, batch = cfg["tiling"]
    for label, dims, axes in cfg["meshes"]:
        n = int(np.prod(dims))
        mesh = mesh_of(port, dims, axes, [device] * (n // world))
        reset_launch_counts()
        t1 = time.perf_counter()
        prob = P.sharded_infer(spec, None, vol, mesh, axis=tuple(axes),
                               tile_out=tile, tile_batch=batch)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        t_inf = time.perf_counter() - t1
        launches = launch_counts()["parity_split_kernel"]
        full = prob.gather()
        thr = cfg["threshold"]
        nms = P.sharded_nms(prob, mesh, tuple(axes), NMS_WINDOW, thr)
        cc = P.sharded_components(prob, mesh, tuple(axes), thr)
        if rank == 0:
            np.save(out / f"{label}.npy", full)
            np.savez(out / f"{label}_lists.npz", nms_locs=nms.locs,
                     nms_conf=nms.conf, cc_locs=cc.locs, cc_conf=cc.conf)
        res["sharded"][label] = {"k5_launches": launches, "n_nms": len(nms),
                                 "n_cc": len(cc), "infer_s": t_inf}
    models = dp_models(port, cfg["small"])
    from flypylib_tpu_torch.parallel import train as ptrain

    controls = {"local_count": ("baseline", ("_global_count", lambda c: c)),
                "local_moments": ("bn", ("_global_moments", lambda s: s))}
    for case in cfg["dp"]:
        model, control = controls.get(case, (case, None))
        assert control is None or hasattr(ptrain, control[0])
        dump = (str(out / f"dp_{case}.npz")
                if cfg.get("dump") and rank == 0 and control is None else None)
        res["dp"][case] = dp_case(port, device, *models[model],
                                  control=control,
                                  timed=cfg.get("timed", False), dump=dump)
    res["seconds"] = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    print(json.dumps(res), flush=True)
    return 0


def run_dist_workers(cfg: dict, world: int) -> list[dict]:
    """``world`` ranks of :func:`dist_worker` as subprocesses on a free
    localhost port, each within WORKER_TIMEOUT; their JSON lines in rank
    order.  A rank that fails or times out fails the phase, and every
    process is stopped."""
    cfg = {**cfg, "port": free_port(), "world": world}
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; "
            "sys.exit(chip_smoke.dist_worker(json.loads(sys.argv[2])))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), json.dumps({**cfg,
                                                            "rank": r})],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results = []
    try:
        for r, p in enumerate(procs):
            try:
                so, se = p.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                require(False, f"rank {r} of {world} ({cfg['backend']}) did "
                               f"not finish in {WORKER_TIMEOUT} s")
            require(p.returncode == 0, f"rank {r} of {world} "
                                       f"({cfg['backend']}) failed:\n"
                                       f"{se[-3000:]}")
            results.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def same_list_bitwise(got, ref, what: str) -> None:
    """Detection lists bit for bit: same length, order, locations, conf."""
    require(len(got) == len(ref) and np.array_equal(got.locs, ref.locs)
            and np.array_equal(np.asarray(got.conf, np.float64),
                               np.asarray(ref.conf, np.float64)),
            f"{what}: {len(got)} detections differ from the reference's "
            f"{len(ref)}")


def fanout_batches(plan, forward: str, n: int, rpb: int | None = None) -> int:
    """Tile batches a ``devices=`` list of ``n`` slots runs: the ROI sweep's
    (unchanged by the fan-out), the whole-volume grid (one slot), or one
    band grid per band of :meth:`_band_partition` (or of ``rpb`` rows, the
    streaming bands)."""
    if forward == "roi":
        return len(plan.grid) * plan.pipe.n_batches
    if rpb is None:
        if n == 1:
            return plan.full_pipe().n_batches
        rpb, nb, _ = plan._band_partition(n)
        if nb == 1:
            return plan.full_pipe().n_batches
    return len(plan._band_starts(rpb)) * plan.band_pipe(rpb).n_batches


def check_fanout(port, card_str: str, vol: np.ndarray, refs: dict) -> dict:
    """14(a): ``detect_large(devices=)`` on lists of cuda:0 slots.  The
    packed baseline staged (lists of one, two and three slots; one runs
    the single-device path) and
    streamed (two slots), roi and shared, ``method="both"`` at core
    FANOUT_CORE and 10(a)'s tiling and threshold; the plain baseline
    staged roi on two slots.  Every list must equal the single-device
    call's bit for bit, and each call launch K5 (K1) once (four times) per
    tile batch its mode runs.  Times one and two slots of each staged
    mode."""
    from flypylib_tpu_torch.infer.large import make_stream_plan
    from flypylib_tpu_torch.infer.tiled import default_tiling

    cuda0 = torch.device("cuda", 0)
    counts, times = {}, {}
    for label, kw in (("packed baseline", {}),
                      ("plain baseline", {"packed": False})):
        packed = not kw
        net = port.FplNetwork("baseline", device="cuda", seed=0, **kw)
        thr = refs[label][0]
        tiling = default_tiling(net.infer_spec, vol.shape)
        for forward in ("roi", "shared") if packed else ("roi",):
            plan = make_stream_plan(net.infer_spec, None, vol.shape,
                                    core=FANOUT_CORE, tile_out=tiling[0],
                                    tile_batch=tiling[1], window=NMS_WINDOW,
                                    threshold=thr, method="both")
            kw_call = dict(threshold=thr, method="both", forward=forward,
                           plan=plan)
            for staged in (True, False) if packed else (True,):
                want = net.detect_large(vol, staged=staged, **kw_call)
                for n in (FANOUT_SLOTS if staged and packed else (2,)):
                    rpb = None
                    if not staged and forward == "shared":
                        rpb = min(plan.band_rpb(1, cost_gate=False),
                                  plan._band_partition(n)[0])
                    reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = net.detect_large(vol, staged=staged,
                                           devices=[cuda0] * n, **kw_call)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    got_counts = launch_counts()
                    nb = fanout_batches(plan, forward, n, rpb)
                    mode = "staged" if staged else "streamed"
                    what = (f"{label} detect_large({mode}, {forward}, "
                            f"devices=[cuda:0] * {n})")
                    require(got_counts == staged_launch_want(net, nb),
                            f"{what}: launches {got_counts}, expected "
                            f"{staged_launch_want(net, nb)}")
                    for g, w, m in zip(got, want, ("nms", "components")):
                        same_list_bitwise(g, w, f"{what} {m} vs one device")
                    counts[(label, mode, forward, n)] = got_counts
                    print(f"{what}: {nb} tile batches, launches K1 "
                          f"{got_counts['conv3d_bias_relu']} K5 "
                          f"{got_counts['parity_split_kernel']}; nms "
                          f"{len(got[0])}, components {len(got[1])}: bit for "
                          f"bit the single-device call's; {dt * 1e3:.2f} ms "
                          f"(first call of its list) [{card_str}]",
                          flush=True)
            if packed:
                for n in (1, 2):
                    devs = [cuda0] * n
                    times[(forward, n)] = median_s(
                        lambda: net.detect_large(vol, devices=devs,
                                                 **kw_call))
                print(f"{label} detect_large staged {forward} both "
                      f"{VOLUME}^3: one slot {times[(forward, 1)] * 1e3:.2f} "
                      f"ms, devices=[cuda:0] * 2 "
                      f"{times[(forward, 2)] * 1e3:.2f} ms (one card: the "
                      f"cost of the fan-out, not a scaling) [{card_str}]",
                      flush=True)
        del net
        torch.cuda.empty_cache()
    return {"launches": counts, "times": times}


def shard_tile_batches(prob, tile: int, batch: int) -> int:
    """Tile batches of ``sharded_infer``'s sweep: per shard the tiles of its
    block, in batches of ``min(batch, tiles)``."""
    tiles = int(np.prod([-(-e // tile) for e in prob.extent]))
    per = -(-tiles // min(batch, tiles))
    return per * int(np.prod(prob.grid))


def check_sharded(port, card_str: str, vol: np.ndarray) -> dict:
    """14(b): ``sharded_infer`` over meshes of cuda:0 slots at detect's
    tiling (SHARD_TILING) on the packed baseline: the map bit for bit
    ``TiledInference``'s at that tile and batch, K5 once per tile batch of
    every shard, and ``sharded_nms`` / ``sharded_components`` on the
    sharded map equal to ``nms_host`` / ``components_host`` on it.  Then
    the whole-block forward (no ``tile_out``: cuDNN at other shapes) held
    to the packed map limit on the logits, its lists to the host reference
    on its own map.  Times each mesh beside ``TiledInference``."""
    from flypylib_tpu_torch.ops.host_reference import components_host, nms_host

    P = port.parallel
    net = port.FplNetwork("baseline", device="cuda", seed=0)
    spec = net.infer_spec
    tile, batch = SHARD_TILING
    want = net.infer(vol, tile, batch, keep_on_device=True)
    thr = float(torch.topk(want.reshape(-1), N_CAND).values[-1])
    host = want.cpu().numpy()
    ref = {"nms": nms_host(host, window=NMS_WINDOW, threshold=thr),
           "components": components_host(host, threshold=thr)}
    n_tiled = net.tiled_inference(vol.shape, tile, batch).n_batches(vol.shape)
    t_tiled = median_s(lambda: net.infer(vol, tile, batch,
                                         keep_on_device=True))
    mvox = vol.size / 1e6
    res = {"map": host, "thr": thr, "ref": ref, "launches": {},
           "mvox_s": {"TiledInference": mvox / t_tiled}}
    for label, dims, axes in SHARD_MESHES:
        mesh = mesh_of(port, dims, axes, ["cuda:0"] * int(np.prod(dims)))
        reset_launch_counts()
        prob = P.sharded_infer(spec, None, vol, mesh, axis=axes,
                               tile_out=tile, tile_batch=batch)
        torch.cuda.synchronize()
        k5 = launch_counts()
        nb = shard_tile_batches(prob, tile, batch)
        require(k5 == staged_launch_want(net, nb),
                f"sharded_infer {label}: launches {k5}, expected "
                f"{staged_launch_want(net, nb)}")
        require(np.array_equal(prob.gather(), host),
                f"sharded_infer {label} at tile {tile} batch {batch} is not "
                "TiledInference's map bit for bit")
        got = {"nms": P.sharded_nms(prob, mesh, axes, NMS_WINDOW, thr),
               "components": P.sharded_components(prob, mesh, axes, thr)}
        for m in got:
            same_list_bitwise(got[m], ref[m], f"sharded {m} {label}")
        t = median_s(lambda: P.sharded_infer(spec, None, vol, mesh, axis=axes,
                                             tile_out=tile, tile_batch=batch))
        res["launches"][label] = k5["parity_split_kernel"]
        res["mvox_s"][label] = mvox / t
        print(f"sharded_infer {label} mesh {dims} of cuda:0 ({VOLUME}^3 "
              f"uint8, packed baseline bf16, tile {tile} batch {batch}): the "
              f"map bit for bit TiledInference's, K5 {nb} launches; nms "
              f"{len(got['nms'])}, components {len(got['components'])} equal "
              f"the host reference; {mvox / t:.3f} Mvox/s against "
              f"TiledInference's {mvox / t_tiled:.3f} (one card: the cost of "
              f"the exchange and the per-slot sweep) [{card_str}]",
              flush=True)
        del prob
    # the whole-block forward: one shard input of 76 x 268 x 268
    label, dims, axes = SHARD_MESHES[0]
    mesh = mesh_of(port, dims, axes, ["cuda:0"] * dims[0])
    reset_launch_counts()
    prob = P.sharded_infer(spec, None, vol, mesh, axis=axes)
    torch.cuda.synchronize()
    k5 = launch_counts()
    require(k5 == staged_launch_want(net, dims[0]),
            f"whole-block sharded_infer: launches {k5}")
    whole = prob.gather()
    err = float(np.abs(logits(whole) - logits(host)).max())
    require(np.isfinite(err) and err <= PACKED_LOGIT_TOL_BF16,
            f"whole-block sharded_infer logits differ from the tiled map's "
            f"by {err} (limit {PACKED_LOGIT_TOL_BF16})")
    thr_w = float(np.sort(whole.reshape(-1))[-N_CAND])
    got = {"nms": P.sharded_nms(prob, mesh, axes, NMS_WINDOW, thr_w),
           "components": P.sharded_components(prob, mesh, axes, thr_w)}
    same_list_bitwise(got["nms"], nms_host(whole, window=NMS_WINDOW,
                                           threshold=thr_w),
                      "whole-block sharded nms")
    same_list_bitwise(got["components"], components_host(whole,
                                                         threshold=thr_w),
                      "whole-block sharded components")
    t = median_s(lambda: P.sharded_infer(spec, None, vol, mesh, axis=axes))
    res["mvox_s"]["1-D whole block"] = mvox / t
    res["launches"]["1-D whole block"] = k5["parity_split_kernel"]
    print(f"sharded_infer 1-D whole blocks (no tile_out): max|dlogit| {err:.6g} "
          f"against the tiled map (limit {PACKED_LOGIT_TOL_BF16}); nms "
          f"{len(got['nms'])}, components {len(got['components'])} equal the "
          f"host reference on its map; {mvox / t:.3f} Mvox/s [{card_str}]",
          flush=True)
    del net, prob
    torch.cuda.empty_cache()
    return res


def check_worlds(port, card_str: str, sharded: dict) -> dict:
    """14(c) a world of one on NCCL and 14(d) two gloo ranks sharing the
    card (NCCL refuses two ranks on one GPU), each rank a subprocess
    (:func:`run_dist_workers`).  Both: the maps of their meshes bit for bit
    (b)'s and the lists (b)'s; (c) the DP step bit for bit the
    single-process step, with both timed; (d) the f32 DP step of the
    full-width baseline and of the BatchNorm baseline within the
    reference's limits (:func:`dp_ok`), the loss the same on both ranks,
    and the two broken controls (local mask counts, per-rank BatchNorm
    moments) failing the same check."""
    out = ROOT / "build" / "phase14"
    out.mkdir(parents=True, exist_ok=True)
    base = {"device": "cuda:0", "small": False, "volume": VOLUME,
            "threshold": sharded["thr"], "tiling": list(SHARD_TILING),
            "out": str(out)}
    res = {}
    for world, backend, meshes, dp in (
            (1, "nccl", SHARD_MESHES[:1], ["baseline"]),
            (2, "gloo", DIST_MESHES,
             ["baseline", "bn", "local_count", "local_moments"])):
        for f in out.glob("*"):
            f.unlink()
        t0 = time.perf_counter()
        ranks = run_dist_workers({**base, "backend": backend,
                                  "meshes": [list(m) for m in meshes],
                                  "dp": dp, "timed": world == 1}, world)
        dt = time.perf_counter() - t0
        what = f"world of {world} on {backend}"
        for r in ranks:
            require(r["world"] == world and r["backend"] == backend
                    and r["psum"] == world * (world + 1) / 2
                    and r["local_batch"] == 8 // world,
                    f"{what}: rank {r['rank']} read {r}")
        for label, dims, axes in meshes:
            got = np.load(out / f"{label}.npy")
            require(np.array_equal(got, sharded["map"]),
                    f"{what}: {label} map is not 14(b)'s bit for bit")
            lists = np.load(out / f"{label}_lists.npz")
            for m, key in (("nms", "nms"), ("components", "cc")):
                ref = sharded["ref"][m]
                require(np.array_equal(lists[f"{key}_locs"], ref.locs)
                        and np.array_equal(lists[f"{key}_conf"],
                                           np.asarray(ref.conf, np.float64)),
                        f"{what}: {label} {m} list differs from 14(b)'s")
        dps = [r["dp"] for r in ranks]
        if world == 1:
            d = dps[0]["baseline"]
            require(d["bitwise"], f"{what}: the DP step is not the single "
                                  f"step bit for bit: {d}")
            sps = d["steps_per_s"]
            print(f"{what}: sharded_infer 1-D map and lists bit for bit "
                  f"14(b)'s; the f32 DP step (full-width baseline, packed, "
                  f"b{DP_BATCH}, patch {DP_PATCH}) bit for bit the single "
                  f"step, launches {d['launches']}; DP {sps['dp']:.3f} "
                  f"steps/s beside the plain trainer's {sps['single']:.3f} "
                  f"(world of one: the cost of the collectives, not a "
                  f"scaling); {dt:.1f} s with start-up [{card_str}]",
                  flush=True)
        else:
            require(dps[0]["baseline"]["loss"] == dps[1]["baseline"]["loss"],
                    f"{what}: the ranks' DP losses differ")
            sound = ("baseline", "bn")
            for r in range(2):
                for case, d in dps[r].items():
                    require(dp_ok(d) == (case in sound),
                            f"{what} rank {r}: DP case {case} "
                            f"{'fails' if case in sound else 'passes'} the "
                            f"check: {d}")
            for case, d in dps[0].items():
                gl = d["grad_limits"]
                if d["truth"] is None:
                    grads = (f"grads {d['grad_err']:.3g} of a tensor's max "
                             f"|g| from the single step's (worst "
                             f"{d['grad_worst']}, limit {DP_GRAD_TOL:g})")
                else:
                    t1, t2 = d["truth"]["single"], d["truth"]["dp"]
                    worst = max(t2, key=lambda n: t2[n] / gl[n])
                    grads = (f"grads against the f64 truth: DP worst "
                             f"{max(t2.values()):.3g}, single worst "
                             f"{max(t1.values()):.3g}; tightest {worst} DP "
                             f"{t2[worst]:.3g} vs limit {gl[worst]:.3g} "
                             f"(single {t1[worst]:.3g}); DP vs single "
                             f"{d['grad_err']:.3g} (worst {d['grad_worst']})")
                print(f"{what}: DP {case} (f32, b{DP_BATCH}, patch "
                      f"{DP_PATCH}): loss rel {d['loss_rel']:.3g}, params "
                      f"{d['param_err']:.3g} (limits {DP_LOSS_RTOL:g}, "
                      f"{DP_PARAM_ATOL:g}), {grads} -> "
                      f"{'within' if case in sound else 'fails'}; params "
                      f"over all elements {d['param_err_all']:.3g}; "
                      f"launches {d['launches']} [{card_str}]", flush=True)
            print(f"{what}: sharded_infer / nms / components over "
                  f"{', '.join(m[0] for m in meshes)} meshes spanning both "
                  f"ranks bit for bit 14(b)'s; {dt:.1f} s with start-up "
                  f"[{card_str}]", flush=True)
        res[backend] = {"ranks": ranks, "seconds": dt}
    for f in out.glob("*"):
        f.unlink()
    return res


def multi_device_phase(port, card_str: str, vol: np.ndarray,
                       refs: dict) -> dict:
    """Phase 14: the fan-out (a), sharded meshes of cuda:0 slots (b), a
    world of one on NCCL (c) and two gloo ranks (d), with (e)'s one-card
    times printed by each."""
    t0 = time.perf_counter()
    res = {"fanout": check_fanout(port, card_str, vol, refs)}
    t1 = time.perf_counter()
    res["sharded"] = check_sharded(port, card_str, vol)
    t2 = time.perf_counter()
    res["worlds"] = check_worlds(port, card_str, res["sharded"])
    t3 = time.perf_counter()
    res["seconds"] = t3 - t0
    print(f"phase 14 (multi-device on one card): {t3 - t0:.1f} s = fan-out "
          f"{t1 - t0:.1f} + sharded meshes {t2 - t1:.1f} + worlds "
          f"{t3 - t2:.1f} [{card_str}]", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace detects and train steps with torch.profiler")
    args = ap.parse_args(argv)

    # 1. device
    require(torch.cuda.is_available(), "CUDA is not available: chip_smoke.py "
                                       "needs an NVIDIA GPU")
    port = import_port()
    card_str = card()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card_str}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    # 2. build
    from flypylib_tpu_torch.ops import _build

    path, seconds = _build.build()
    _build.load_library()
    report = [ln for ln in path.with_suffix(".log").read_text().splitlines()
              if "registers" in ln or "spill" in ln or "Compiling" in ln
              or "Performance" in ln]
    print("\n".join(report))
    print(f"build: {path.name} in {seconds:.2f} s", flush=True)

    # 3. K1 against its plain version
    k1 = check_kernels(card_str)

    # 4. K2 and K3 against their plain versions
    tails = check_tail_kernels(card_str)

    # 4b. K2's stage kernel as the packed engines' conv + bias + ReLU
    fused = check_fused_conv(card_str)

    # 5. K5 against its plain version
    k5 = check_split_kernel(card_str)

    # 6. K4 against its plain version, K1 and cuDNN at stage-B operands
    vol = make_volume_u8(VOLUME, N_BLOBS, seed=0)
    k4 = check_wino_kernel(card_str, vol)

    # 7. the plain baseline path (K1): the map against the CPU's at a small
    #    size, then 256^3
    check_small_map(port, card_str)
    net = port.FplNetwork("baseline", device="cuda", seed=0, packed=False)
    require(net.infer_spec is net.spec and net.module.dtype == torch.bfloat16,
            "the plain baseline is not a bf16 ConvStack")
    res = run_main_path(net, vol)
    nb = res["n_batches"]
    require_launches(res, {"conv3d_bias_relu": 4 * nb,
                           "conv3d_bias_relu:wgmma": 3 * nb,
                           "conv3d_bias_relu:ci1": nb}, "baseline")
    print(f"main path: {res['n_batches']} tile batches, launches "
          f"{res['launches']} (K1 = 3 forwards x 4 layers x "
          f"{res['n_batches']}: layers 1-3 wgmma, layer 0 ci1); threshold "
          f"{res['threshold']:.9g} "
          f"({res['above_threshold']} voxels above); nms {res['n_nms']} "
          f"detections, components {res['n_cc']}; both equal the host "
          "reference", flush=True)
    time_main_path(net, vol, res["threshold"], card_str)
    infer_phases(net, vol, card_str, "main path")
    if args.profile:
        profile_detect(net, vol, res["threshold"], card_str)
    del net
    torch.cuda.empty_cache()
    # the f32 model (the port's exactness mode): layers 1-3 on the f32 kernel
    net = port.FplNetwork("baseline", device="cuda", seed=0,
                          dtype=torch.float32, packed=False)
    require(net.infer_spec is net.spec and net.module.dtype == torch.float32,
            "the plain f32 baseline is not an f32 ConvStack")
    res32 = run_main_path(net, vol)
    nb32 = res32["n_batches"]
    require_launches(res32, {"conv3d_bias_relu": 4 * nb32,
                             "conv3d_bias_relu:simt": 3 * nb32,
                             "conv3d_bias_relu:ci1": nb32}, "f32 baseline")
    print(f"main path f32: {nb32} tile batches, launches "
          f"{res32['launches']} (K1 = 3 forwards x 4 layers x {nb32}: layers "
          f"1-3 simt, layer 0 ci1); threshold {res32['threshold']:.9g} "
          f"({res32['above_threshold']} voxels above); nms {res32['n_nms']} "
          f"detections, components {res32['n_cc']}; both equal the host "
          "reference", flush=True)
    time_main_path(net, vol, res32["threshold"], card_str, "main path f32")
    infer_phases(net, vol, card_str, "main path f32")
    del net
    torch.cuda.empty_cache()
    # a dilation outside the packed engine's powers of two: the default
    # packed="auto" finds no packed spec, so the plain stack runs, K1 at d = 3
    reset_launch_counts()
    check_map(card_str, "baseline dilations (1, 1, 3, 3)",
              lambda dev, dt: port.FplNetwork(
                  "baseline", device=dev, seed=0, dtype=dt,
                  dilations=(1, 1, 3, 3)),
              make_volume_u8(SMALL, 2, seed=1), SMALL_TILING,
              ((torch.float32, LOGIT_TOL_F32), (torch.bfloat16, LOGIT_TOL_BF16)))
    counts = launch_counts()
    require(counts["conv3d_bias_relu"] > 0
            and counts["parity_split_kernel"] == 0,
            f"baseline dilations (1, 1, 3, 3): launches {counts}")

    # 8. the packed ConvStack paths, the default engine: the map against the
    #    CPU's at a small size, then 256^3 for baseline and vgg_like
    check_small_map(port, card_str, packed=True)
    packed_runs = {}
    for name in ("baseline", "vgg_like"):
        net = port.FplNetwork(name, device="cuda", seed=0)
        require(net.infer_spec.name == f"{name}+packed"
                and net.module.dtype == torch.bfloat16,
                f"{name}: {net.infer_spec.name} is not the bf16 packed engine")
        r = run_main_path(net, vol)
        n_fused = fused_convs(net)
        require(n_fused == {"baseline": 2, "vgg_like": 3}[name],
                f"packed {name}: {n_fused} convs on K2's stage kernel")
        require_launches(r, {"parity_split_kernel": r["n_batches"],
                             "stage_bias_relu": n_fused * r["n_batches"]},
                         f"packed {name}")
        print(f"packed {name} (tile in {net.tiled_inference(vol.shape).tile_in}"
              f"): {r['n_batches']} tile batches, launches {r['launches']} "
              f"(K5 = 3 forwards x {r['n_batches']}, K2's stage kernel "
              f"{n_fused} x that); threshold "
              f"{r['threshold']:.9g} ({r['above_threshold']} voxels above); "
              f"nms {r['n_nms']} detections, components {r['n_cc']}; both "
              "equal the host reference", flush=True)
        time_main_path(net, vol, r["threshold"], card_str, f"packed {name}")
        infer_phases(net, vol, card_str, f"packed {name}")
        if args.profile and name == "baseline":
            profile_detect(net, vol, r["threshold"], card_str, ("nms",),
                           "packed baseline ")
        packed_runs[name] = r
        del net
        torch.cuda.empty_cache()

    # 9. the U-Net paths: maps against the CPU's at a small size, then 256^3
    check_unet_maps(port, card_str)
    check_deep_unet(port, card_str)
    unet_runs = {}
    for engine in UNET_ENGINES:
        net = unet_net(port, engine, "cuda")
        require(net.module.dtype == torch.bfloat16, "unet is not bf16")
        r = run_main_path(net, vol)
        n = r["n_batches"]
        per_forward = {"plain": {"conv3d_bias_relu": len(net.module.convs) * n,
                                 "conv3d_bias_relu:ci1": n,
                                 "conv3d_bias_relu:wgmma":
                                     (len(net.module.convs) - 1) * n},
                       # two stages per call, both on the wgmma route, the
                       # logits in the second one's epilogue
                       "pallas": {"packed_tail": n, "packed_tail:wgmma": 2 * n},
                       "pallas2": {"packed_tail2": n,
                                   "packed_tail2:wgmma": 2 * n}}.get(engine, {})
        # the convs outside the folds on K2's stage kernel: all 8 on the
        # default engine, 7 beside a kernel tail, none on the plain one
        n_fused = fused_convs(net)
        require(n_fused == {"xla": 8, "plain": 0}.get(engine, 7),
                f"unet {engine}: {n_fused} convs on K2's stage kernel")
        if n_fused:
            per_forward["stage_bias_relu"] = n_fused * n
        require_launches(r, per_forward, f"unet {engine}")
        print(f"unet {engine} ({net.infer_spec.name}, tile in "
              f"{net.tiled_inference(vol.shape).tile_in}): {n} tile batches, "
              f"launches {r['launches']}; threshold {r['threshold']:.9g} "
              f"({r['above_threshold']} voxels above); nms {r['n_nms']} "
              f"detections, components {r['n_cc']}; both equal the host "
              "reference", flush=True)
        time_main_path(net, vol, r["threshold"], card_str, f"unet {engine}")
        infer_phases(net, vol, card_str, f"unet {engine}")
        if args.profile and engine == "pallas2":
            profile_detect(net, vol, r["threshold"], card_str, ("nms",),
                           "unet pallas2 ")
        unet_runs[engine] = r
        del net
        torch.cuda.empty_cache()
    unet32_runs = unet_f32_paths(port, card_str, vol)

    # 10. the staged whole-volume engine: detect_large
    staged = staged_phase(port, card_str)

    # 11. out-of-core streaming: detect_large on a reader or staged=False
    stream = streaming_phase(port, card_str, staged)
    del staged["vol"], staged["vol_1k"]

    # 12. training and evaluation: gradients card vs CPU, the trained main
    #     path through detect / evaluate / evaluate_voxels, throughput
    train = train_phase(port, card_str, profile=args.profile)

    # 13. BatchNorm models (K1 without ReLU, maps, detects, training),
    #     stream_rois from a mock DVID node, host_stream
    bench = train["bench"]["bench"]
    bn = bn_roi_phase(port, card_str, vol, plain_b32={
        "median": bench["train_patch_mvox_s"],
        "all": [r * 32 * 33**3 / 1e6 for r in bench["train_steps_per_s_all"]]})
    train_steps = {**train["grads"],
                   **{f"bench {k}": v
                      for k, v in train["bench"]["launches_per_step"].items()},
                   **bn["train"]["launches_per_step"]}
    bn_runs = bn["paths"]

    # 14. the multi-device layer on the one card: detect_large(devices=),
    #     sharded meshes of cuda:0 slots, a world of one on NCCL, two gloo
    #     ranks
    multi = multi_device_phase(port, card_str, vol, staged["refs"])
    fan = multi["fanout"]["launches"]
    worlds = multi["worlds"]

    def world_launches(name: str) -> dict:
        return {f"{backend} rank {r['rank']} {case}": d["launches"].get(name, 0)
                for backend, w in worlds.items() for r in w["ranks"]
                for case, d in r["dp"].items()}

    def per_step(name: str) -> dict:
        return {case: c[name] for case, c in train_steps.items() if name in c}

    from flypylib_tpu_torch.ops.conv import K1_ROUTES
    from flypylib_tpu_torch.ops.tail import TAIL_ROUTES

    k1_sources = {"wgmma": "flypylib_tpu_torch/csrc/conv3d_wgmma.cu",
                  "simt": "flypylib_tpu_torch/csrc/conv3d_f32.cu"}
    k1_routes = k1.pop("routes")
    simt = k1.pop("simt")
    kernels = [{
        "name": "conv3d_bias_relu",
        "route": "cuda",
        "source": k1_sources["wgmma"],
        "replaces": "flypylib_tpu/ops/pallas_conv.py:155",
        "launches": res["launches"]["conv3d_bias_relu"],
        **k1,
        "routes": {r: {"launches": res["launches"][f"conv3d_bias_relu:{r}"],
                       "source": k1_sources.get(
                           r, "flypylib_tpu_torch/csrc/conv3d_bias_relu.cu"),
                       **k1_routes.get(r, {})}
                   for r in K1_ROUTES},
        "staged_launches": {
            f"plain baseline {fwd} {m} 256^3": staged["256"][
                ("plain baseline", fwd, m)]["conv3d_bias_relu"]
            for fwd in ("roi", "shared") for m in STAGED_METHODS},
        "streaming_launches": {
            f"plain baseline streaming {fwd} both 256^3": stream["256"][
                ("plain baseline", fwd, "", None)]["conv3d_bias_relu"]
            for fwd in ("roi", "shared")},
        "train_launches_per_step": per_step("conv3d_bias_relu"),
        "train_step_ms": train["kernel_times"]["conv3d_bias_relu"],
        "multi_device_launches": {
            **{f"{lab} {mode} {fwd} devices=[cuda:0] * {n} both 256^3":
               c["conv3d_bias_relu"] for (lab, mode, fwd, n), c in fan.items()
               if lab == "plain baseline"},
            **{f"DP step {k}": v for k, v in world_launches(
                "conv3d_bias_relu").items() if v}},
        "relu_false": {
            **bn["k1"],
            "launches": {r: bn_runs["plain baseline_bn"]["launches"][
                f"conv3d_bias_relu:{r}"] for r in K1_ROUTES},
            "at": "relu=False (a BatchNorm layer's conv), baseline layers "
                  "0-3 summed, bf16, one tile batch; launches over infer + 2 "
                  "detects of the plain BatchNorm baseline at 256^3"},
        "at": "baseline layers 0-3 summed, bf16, one tile batch (layers 1-3 "
              "on the wgmma route, layer 0 on ci1; routes splits launches "
              "and times by route); launches from the plain baseline path",
    }, {
        "name": "conv3d_bias_relu (f32)",
        "route": "cuda",
        "source": k1_sources["simt"],
        "replaces": "flypylib_tpu/ops/pallas_conv.py:155",
        "launches": res32["launches"]["conv3d_bias_relu:simt"],
        **simt,
        "ci1_launches": res32["launches"]["conv3d_bias_relu:ci1"],
        "train_launches_per_step": {
            case: c["conv3d_bias_relu:simt"]
            for case, c in train_steps.items()
            if c.get("conv3d_bias_relu:simt")},
        "at": "K1's f32 route ('simt'), baseline layers 1-3 summed, f32, one "
              "tile batch; unet_convs_1_9 the plain U-Net's convs 1-9 summed "
              "(one covering tile); launches over infer + 2 detects of the "
              "plain f32 baseline at 256^3 (layer 0 on ci1: ci1_launches)",
    }]
    for kname, name, line, engine in (
            ("K2", "packed_tail", 221, "pallas"),
            ("K3", "packed_tail2", 470, "pallas2")):
        run = unet_runs[engine]["launches"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "flypylib_tpu_torch/csrc/packed_tail_wgmma.cu",
            "replaces": f"flypylib_tpu/ops/pallas_tail.py:{line}",
            "launches": run[name],
            **tails[kname],
            "stage_launches": {r: run[f"{name}:{r}"] for r in TAIL_ROUTES},
            "train_launches_per_step": per_step(name),
            "at": f"tail_impl={engine!r} (2 stages, the logits in the "
                  f"second's epilogue), bf16, one {VOLUME}^3 covering tile; "
                  f"launches from the U-Net {engine} path, stage_launches "
                  "its stage kernels by route; wmma_kernel_ms is "
                  "csrc/packed_tail.cu's kernel and unfused_tail_ms the "
                  "default engine's cuDNN tail, both on the same operands",
        })
    for kname, name, line, engine in (
            ("K2", "packed_tail", 221, "pallas"),
            ("K3", "packed_tail2", 470, "pallas2")):
        run = unet32_runs[engine]["launches"]
        kernels.append({
            "name": f"{name} (f32)",
            "route": "cuda",
            "source": "flypylib_tpu_torch/csrc/conv3d_f32.cu",
            "replaces": f"flypylib_tpu/ops/pallas_tail.py:{line}",
            "launches": run[name],
            **tails[f"{kname} f32"],
            "stage_launches": {r: run[f"{name}:{r}"] for r in TAIL_ROUTES},
            "at": f"tail_impl={engine!r} (2 stages on the f32 kernel, 'simt', "
                  f"then the logits launch), f32, one {VOLUME}^3 covering "
                  f"tile; launches from the f32 U-Net {engine} path, "
                  "stage_launches its stage kernels by route; fma_kernel_ms "
                  "is csrc/packed_tail.cu's first version and "
                  "unfused_tail_ms the default engine's tail (cuDNN f32, "
                  "TF32 off), both on the same operands",
        })
    kernels.append({
        "name": "stage_bias_relu",
        "route": "cuda",
        "source": "flypylib_tpu_torch/csrc/packed_tail_wgmma.cu",
        "replaces": "flypylib_tpu/ops/pallas_tail.py:221 (one stage)",
        "launches": packed_runs["baseline"]["launches"]["stage_bias_relu"],
        **fused["sums"],
        "shapes": fused["shapes"],
        "main_path_launches": {
            **{f"packed {name} 256^3": r["launches"]["stage_bias_relu"]
               for name, r in packed_runs.items()},
            **{f"unet {engine} 256^3": r["launches"]["stage_bias_relu"]
               for engine, r in unet_runs.items()},
            **{f"unet f32 {engine} 256^3": r["launches"]["stage_bias_relu"]
               for engine, r in unet32_runs.items()},
            "packed baseline_bn 256^3": bn_runs["packed baseline_bn"][
                "launches"]["stage_bias_relu"]},
        "staged_launches": {
            **{f"{lab} {fwd} {m} 256^3": staged["256"][(lab, fwd, m)][
                "stage_bias_relu"]
               for lab in ("packed baseline", "packed vgg_like")
               for fwd in ("roi", "shared") for m in STAGED_METHODS},
            f"north star {NORTH_STAR}^3 {staged['1k']['mode']} both":
                staged["1k"]["launches"]["stage_bias_relu"],
            **{f"north star {NORTH_STAR}^3 streaming {lab} ({r['mode']}) "
               "both": r["launches"]["stage_bias_relu"]
               for lab, r in stream["1k"].items()}},
        "train_launches_per_step": per_step("stage_bias_relu"),
        "train_main_path_launches": train["main"]["launches"][
            "stage_bias_relu"],
        "stream_rois_launches": bn["rois"]["launches"]["stage_bias_relu"],
        "at": "K2's wgmma stage kernel as the packed engines' conv + bias + "
              "ReLU at inference (ops/packed_conv.py::packed_conv_relu), "
              "bf16, summed per model over the shapes of FUSED_SHAPES; "
              "library_ms is cuDNN's conv and the two elementwise passes it "
              "replaces; launches over infer + 2 detects of the packed "
              "baseline at 256^3 (2 a tile batch), the other paths' beside "
              "it (the U-Net's default engine 8 a tile batch, a kernel tail "
              "7; none in f32, with BatchNorm or under grad; the training "
              "run's are its validations')",
    })
    kernels.append({
        "name": "wino_conv3d_bias_relu",
        "route": "cuda",
        "source": "flypylib_tpu_torch/csrc/wino_conv_wgmma.cu",
        "replaces": "flypylib_tpu/ops/wino_conv.py:240",
        "launches": packed_runs["baseline"]["launches"]["wino_conv3d_bias_relu"],
        **k4,
        "routes": {r: {"launches": packed_runs["baseline"]["launches"][
                           f"wino_conv3d_bias_relu:{r}"],
                       "source": "flypylib_tpu_torch/csrc/" + (
                           "wino_conv_wgmma.cu" if r == "wgmma"
                           else "wino_conv.cu")}
                   for r in ("wgmma", "wmma", "fma")},
        "train_launches_per_step": per_step("wino_conv3d_bias_relu"),
        "at": "packed baseline layer 3, bf16, one tile batch, on the wgmma "
              "route; k1_ms is K1's wgmma route at d = 1 and wmma_kernel_ms "
              "csrc/wino_conv.cu's kernel, both on the same operands; no "
              "path calls it, as in the reference",
    })
    kernels.append({
        "name": "parity_split_kernel",
        "route": "cuda",
        "source": "flypylib_tpu_torch/csrc/parity_split.cu",
        "replaces": "flypylib_tpu/ops/pallas_split.py:158",
        "launches": packed_runs["baseline"]["launches"]["parity_split_kernel"],
        **k5,
        "staged_launches": {
            **{f"{lab} {fwd} {m} 256^3": staged["256"][(lab, fwd, m)][
                "parity_split_kernel"]
               for lab in ("packed baseline", "packed vgg_like")
               for fwd in ("roi", "shared") for m in STAGED_METHODS},
            f"north star {NORTH_STAR}^3 {staged['1k']['mode']} both":
                staged["1k"]["launches"]["parity_split_kernel"]},
        "streaming_launches": {
            **{f"{lab} streaming {fwd}"
               + (f" {tag}" if tag else "")
               + (f" bands of {rpb}" if rpb else "") + " both 256^3":
               c["parity_split_kernel"]
               for (lab, fwd, tag, rpb), c in stream["256"].items()
               if lab != "plain baseline"},
            **{f"north star {NORTH_STAR}^3 streaming {lab} ({r['mode']}) "
               "both": r["launches"]["parity_split_kernel"]
               for lab, r in stream["1k"].items()}},
        "train_launches_per_step": per_step("parity_split_kernel"),
        "train_step_ms": train["kernel_times"]["parity_split_kernel"],
        "train_main_path_launches": train["main"]["launches"][
            "parity_split_kernel"],
        "bn_launches": bn_runs["packed baseline_bn"]["launches"][
            "parity_split_kernel"],
        "stream_rois_launches": bn["rois"]["launches"]["parity_split_kernel"],
        "multi_device_launches": {
            **{f"{lab} {mode} {fwd} devices=[cuda:0] * {n} both 256^3":
               c["parity_split_kernel"] for (lab, mode, fwd, n), c in
               fan.items() if lab == "packed baseline"},
            **{f"sharded_infer {m} 256^3": n for m, n in
               multi["sharded"]["launches"].items()},
            **{f"{backend} rank {r['rank']} sharded_infer {m} 256^3":
               v["k5_launches"] for backend, w in worlds.items()
               for r in w["ranks"] for m, v in r["sharded"].items()},
            **{f"DP step {k}": v for k, v in world_launches(
                "parity_split_kernel").items() if v}},
        "at": "packed baseline stage-A -> stage-B boundary, bf16, one tile "
              "batch; launches from the packed baseline path",
    })
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
