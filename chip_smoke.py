#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``flypylib_tpu_torch``) on one GPU.

    python3 chip_smoke.py              # build, check, drive the main path
    python3 chip_smoke.py --profile    # also trace detect with torch.profiler

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. Device: a CUDA card is required; its name and power limit are printed.
2. Build: every ``flypylib_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` into
   ``build/kernels/``; the compiler's register/spill report is printed.
3. K1 (``conv3d_bias_relu``) against its plain PyTorch version on the card,
   at the main path's shapes (the baseline's four body layers at
   ``default_tiling``'s tile and batch for a 256^3 volume) and one
   ``vgg_like`` layer (64 -> 96 channels, dilation 4), in f32 and bf16,
   with the median times of both.
4. Main path: first, on a 48^3 volume in 24-wide tiles, the logits behind
   the card's probability map must match the CPU's (the plain versions,
   same weights) in f32 and bf16.
   Then ``FplNetwork("baseline", device="cuda", seed=0)`` at bf16 on a
   256^3 uint8 blob volume runs ``infer``, ``detect(method="nms")`` and
   ``detect(method="components")``.  K1's launch count must rise by exactly
   four per tile batch and forward, and both detection lists must equal the
   host (numpy/scipy) reference on the same probability map.  Times follow.

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
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
    sys.path.insert(0, str(ROOT))
    import flypylib_tpu_torch

    where = Path(flypylib_tpu_torch.__file__).resolve().parent.parent
    require(where == ROOT, f"flypylib_tpu_torch imported from {where}, "
                           f"not from this checkout {ROOT}")
    return flypylib_tpu_torch


def make_volume_u8(size: int, n_blobs: int, seed: int = 0) -> np.ndarray:
    """uint8 ``(size,)*3`` volume: noise around 25 plus Gaussian blobs that
    peak at 255 (the reference bench's synthetic volume, in numpy)."""
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
    return vol


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


def conv_cases():
    """(label, B, input size, Ci, Co, dilation) of K1 on the main path:
    the baseline's four body layers, and vgg_like's 64 -> 96, d=4 layer, at
    ``default_tiling``'s tile and batch for a VOLUME^3 volume."""
    from flypylib_tpu_torch.infer.tiled import TiledInference, default_tiling
    from flypylib_tpu_torch.models.zoo import baseline_model, vgg_like

    cases = []
    for spec, layers in ((baseline_model(), (0, 1, 2, 3)), (vgg_like(), (6,))):
        tile_out, batch = default_tiling(spec, (VOLUME,) * 3)
        s = TiledInference(spec, tile_out, batch).tile_in
        for i, conv in enumerate(spec.module.convs):
            _, _, _, ci, co = conv.weight.shape
            if i in layers:
                cases.append((f"{spec.name} layer {i}", batch, s, ci, co,
                              conv.dilation))
            s -= 2 * conv.dilation
    return cases


def check_kernels(card_str: str) -> dict:
    """K1 against its plain version at every case, in f32 and bf16."""
    from flypylib_tpu_torch.ops.conv import conv3d_bias_relu, conv3d_reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print("plain version: cudnn.allow_tf32=False, "
          "float32_matmul_precision='highest'")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16_main = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
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
            got = conv3d_bias_relu(x, w, b, d)
            ref = conv3d_reference(x, w, b, d)
            torch.cuda.synchronize()
            require(got.shape == ref.shape and got.dtype == ref.dtype,
                    f"K1 {label}: {tuple(got.shape)} {got.dtype} vs "
                    f"{tuple(ref.shape)} {ref.dtype}")
            err, ok = conv_check(got, ref)
            ms = median_ms(lambda: conv3d_bias_relu(x, w, b, d))
            plain = median_ms(lambda: conv3d_reference(x, w, b, d))
            dt = str(dtype).replace("torch.", "")
            print(f"K1 {label} x{tuple(x.shape)} -> {tuple(got.shape)} d={d} "
                  f"{dt}: max|err| {err:.6g} (max|ref| "
                  f"{float(ref.float().abs().max()):.6g}) "
                  f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms [{card_str}]", flush=True)
            require(ok, f"K1 {label} {dt}: outside tolerance (max|err| {err})")
            if dtype == torch.bfloat16 and label.startswith("baseline"):
                bf16_main["ms"] += ms
                bf16_main["plain_ms"] += plain
                bf16_main["max_abs_err"] = max(bf16_main["max_abs_err"], err)
            del x, w, b, got, ref
    torch.cuda.empty_cache()
    return bf16_main


def logits(prob: np.ndarray) -> np.ndarray:
    """The logits behind a probability map, in f64 (inf where p is 0 or 1)."""
    p = prob.astype(np.float64)
    with np.errstate(divide="ignore"):
        return np.log(p) - np.log1p(-p)


def check_small_map(port, card_str: str) -> None:
    """The logits behind the card's probability map against the CPU's (the
    plain versions) on a SMALL^3 volume, with the same weights, at f32 and
    at bf16."""
    vol = make_volume_u8(SMALL, 2, seed=1)
    for dtype, tol in ((torch.float32, LOGIT_TOL_F32),
                       (torch.bfloat16, LOGIT_TOL_BF16)):
        gpu = port.FplNetwork("baseline", device="cuda", seed=0, dtype=dtype)
        cpu = port.FplNetwork("baseline", device="cpu", seed=0, dtype=dtype)
        cpu.spec.module.load_state_dict(gpu.spec.module.state_dict())
        pg = gpu.infer(vol, *SMALL_TILING)
        pc = cpu.infer(vol, *SMALL_TILING)
        lg, lc = logits(pg), logits(pc)
        dt = str(dtype).replace("torch.", "")
        require(pg.shape == vol.shape and bool(np.isfinite(lg).all())
                and bool(np.isfinite(lc).all()),
                f"{SMALL}^3 {dt} map: shape {pg.shape}; every p in (0, 1): "
                f"card {bool(np.isfinite(lg).all())}, "
                f"CPU {bool(np.isfinite(lc).all())}")
        err = float(np.abs(lg - lc).max())
        print(f"{SMALL}^3 map, tiles {SMALL_TILING[0]} in batches of "
              f"{SMALL_TILING[1]}, card vs CPU plain versions, {dt}: "
              f"max|dlogit| {err:.6g} (limit {tol:g}; max|logit| "
              f"{float(np.abs(lc).max()):.6g}), max|dprob| "
              f"{float(np.abs(pg - pc).max()):.6g} [{card_str}]", flush=True)
        require(err <= tol, f"{SMALL}^3 {dt} logits differ from the CPU's by "
                            f"{err} (limit {tol})")


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


def run_main_path(net, vol: np.ndarray, n_cand: int = N_CAND) -> dict:
    """Drive ``infer`` and both ``detect`` methods once, checking the lists
    against the host reference on the same map; returns the counts."""
    from flypylib_tpu_torch.ops.conv import conv3d_bias_relu
    from flypylib_tpu_torch.ops.host_reference import components_host, nms_host

    n_batches = net.tiled_inference(vol.shape).n_batches(vol.shape)
    conv3d_bias_relu.launches = 0
    prob = net.infer(vol, keep_on_device=True)
    after_infer = conv3d_bias_relu.launches
    require(tuple(prob.shape) == vol.shape and prob.dtype == torch.float32,
            f"prob map {tuple(prob.shape)} {prob.dtype}")
    require(bool(torch.isfinite(prob).all()), "prob map is not finite")
    # operating threshold of an untrained net: the n_cand-th largest value
    thr = float(torch.topk(prob.reshape(-1), min(n_cand, prob.numel()))
                .values[-1])
    dets_nms = net.detect(vol, threshold=thr, method="nms")
    dets_cc = net.detect(vol, threshold=thr, method="components")
    launches = conv3d_bias_relu.launches

    host = prob.cpu().numpy()
    same_list(dets_nms, nms_host(host, window=NMS_WINDOW, threshold=thr), 0.0,
              "detect(method='nms') vs nms_host")
    same_list(dets_cc, components_host(host, threshold=thr), CENTROID_TOL,
              "detect(method='components') vs components_host")
    return {"n_batches": n_batches, "launches_infer": after_infer,
            "launches": launches, "threshold": thr, "n_nms": len(dets_nms),
            "n_cc": len(dets_cc),
            "above_threshold": int((prob >= thr).sum())}


def time_main_path(net, vol: np.ndarray, thr: float, card_str: str) -> dict:
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
    for k, s in t.items():
        print(f"main path {k}: {s * 1e3:.2f} ms"
              + (f", {mvox / s:.3f} Mvox/s" if k != "nms" and
                 k != "components" else "")
              + f" ({VOLUME}^3, bf16) [{card_str}]")
    print(f"main path peak device memory {peak:.3f} GiB [{card_str}]")
    return t


def profile_detect(net, vol: np.ndarray, thr: float, card_str: str) -> None:
    """Device time by kernel over one detect per method (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for method in ("nms", "components"):
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
        print(f"profile detect({method}): device busy {dev_us / 1e3:.2f} ms "
              f"of {wall * 1e3:.2f} ms wall (profiled) [{card_str}]")
        print(events.table(sort_by="self_cuda_time_total", row_limit=25),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace one detect per method with torch.profiler")
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
              if "registers" in ln or "spill" in ln or "Compiling" in ln]
    print("\n".join(report))
    print(f"build: {path.name} in {seconds:.2f} s", flush=True)

    # 3. K1 against its plain version
    k1 = check_kernels(card_str)

    # 4. main path: the map against the CPU's at a small size, then 256^3
    check_small_map(port, card_str)
    net = port.FplNetwork("baseline", device="cuda", seed=0)
    require(net.spec.module.dtype == torch.bfloat16, "baseline is not bf16")
    vol = make_volume_u8(VOLUME, N_BLOBS, seed=0)
    res = run_main_path(net, vol)
    per_forward = 4 * res["n_batches"]
    require(res["launches_infer"] == per_forward,
            f"infer launched K1 {res['launches_infer']} times, expected "
            f"{per_forward} (4 layers x {res['n_batches']} tile batches)")
    require(res["launches"] == 3 * per_forward,
            f"infer + 2 detects launched K1 {res['launches']} times, "
            f"expected {3 * per_forward}")
    print(f"main path: {res['n_batches']} tile batches, K1 launches "
          f"{res['launches']} (= 3 forwards x 4 layers x {res['n_batches']}); "
          f"threshold {res['threshold']:.9g} ({res['above_threshold']} voxels "
          f"above); nms {res['n_nms']} detections, components {res['n_cc']}; "
          "both equal the host reference", flush=True)
    time_main_path(net, vol, res["threshold"], card_str)
    if args.profile:
        profile_detect(net, vol, res["threshold"], card_str)

    kernels = [{
        "name": "conv3d_bias_relu",
        "route": "cuda",
        "source": "flypylib_tpu_torch/csrc/conv3d_bias_relu.cu",
        "replaces": "flypylib_tpu/ops/pallas_conv.py:155",
        "launches": res["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "at": "baseline layers 0-3 summed, bf16, one tile batch",
    }]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
