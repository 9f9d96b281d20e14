#!/usr/bin/env python3
"""Accuracy of K1's f32 routes on one GPU, at the BatchNorm baseline's
train step.

    python3 scripts/probe_k1_f32_accuracy.py [--seeds 1 2 3] [--forward-only]

(A) For each batch seed, ``chip_smoke.py`` phase 13(c)'s f32 step of the
full-width BatchNorm baseline (``chip_smoke.bn_state``, batch 8, patch 34)
on the card: K1's layers 1-3 on the f32 kernel ("simt", the route's
default), on the first-version FMA kernel ("fma", forced), and on "simt"
with TF32 allowed in the step (13(c)'s control), each against the f64 truth
(``chip_smoke.bn_f64_grads`` on that step's branch points, its head ReLU's
included) beside the CPU's own step; it prints every parameter's distance
and the ratio 13(c) holds, card / max(GRAD_TOL, CPU) per parameter.

(B) The forward alone: the f64 forward of the same batch on the card gives
each body conv's input; each conv (f32 input and weights, relu off) runs on
"simt", "fma" and cuDNN f32 (TF32 off) and is held against an f64 conv of
the same f32 values: max |err| / max |ref|, the RMS error over the RMS of
the output less its channel mean (what BatchNorm normalises), and what a
sum over voxels sees of the error: its mean per channel over its RMS, its
correlation with the centred output and between x-neighbours.

(C) How many of the head's inputs fall on the other side of 0 in the card's
step than in the f64 forward on the card's masks, on each route.
"""

import argparse
import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def fma_route(real):
    """``k1_route`` with the f32 kernel's calls sent to the first version."""
    def route(x, w, dilation=1):
        r = real(x, w, dilation)
        return "fma" if r == "simt" else r
    return route


def forward_inputs(state: dict, batch, device="cuda") -> list:
    """Each body conv's input in the f64 forward of the BatchNorm stack on
    ``batch`` (train-mode statistics, ReLU), as ``bn_f64_grads`` runs it."""
    from flypylib_tpu_torch.ops.augment import augment_batch

    F = torch.nn.functional
    P = {k: v.to(device, torch.float64) for k, v in state.items()}
    x, _, _, codes = (torch.from_numpy(a).to(device) for a in batch)
    h = augment_batch(x.double(), codes)[..., None]
    seen = []
    for i, d in enumerate((1, 1, 2, 2)):
        seen.append(h)
        w = P[f"convs.{i}.weight"]
        h = F.conv3d(h.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                     dilation=d).permute(0, 2, 3, 4, 1) + P[f"convs.{i}.bias"]
        mu = h.mean((0, 1, 2, 3))
        var = torch.clamp((h * h).mean((0, 1, 2, 3)) - mu * mu, min=0.0)
        h = torch.relu((h - mu) * (torch.rsqrt(var + 1e-5)
                                   * P[f"norms.{i}.scale"])
                       + P[f"norms.{i}.bias"])
    return seen


def forward_errors(state: dict, batch, card: str) -> None:
    from flypylib_tpu_torch.ops import conv

    F = torch.nn.functional
    for i, (h, d) in enumerate(zip(forward_inputs(state, batch), (1, 1, 2, 2))):
        if i == 0:
            continue  # Ci = 1: the ci1 kernel on every f32 route
        x = h.float().contiguous()
        w = state[f"convs.{i}.weight"].to("cuda", torch.float32)
        b = state[f"convs.{i}.bias"].to("cuda", torch.float32)
        ref = F.conv3d(x.double().permute(0, 4, 1, 2, 3),
                       w.double().permute(4, 3, 0, 1, 2), dilation=d)
        ref = ref.permute(0, 2, 3, 4, 1) + b.double()
        spread = (ref - ref.mean((0, 1, 2, 3))).pow(2).mean().sqrt()
        outs = {"simt": conv.conv3d_bias_relu(x, w, b, d, relu=False)}
        real = conv.k1_route
        with cs.patched(conv, "k1_route", fma_route(real)):
            outs["fma"] = conv.conv3d_bias_relu(x, w, b, d, relu=False)
        with conv.no_tf32(x.device):
            outs["cuDNN f32"] = cs.cudnn_conv(x, w, b, d).permute(0, 2, 3, 4, 1)
        line = []
        cen = ref - ref.mean((0, 1, 2, 3))
        for name, y in outs.items():
            err = y.double() - ref
            rms = err.pow(2).mean().sqrt()
            # what a sum over voxels sees: the error's mean, its part along
            # the output, and its correlation between x-neighbours
            bias = float((err.mean((0, 1, 2, 3)).abs() / err.pow(2).mean(
                (0, 1, 2, 3)).sqrt()).mean())
            along = float((err * cen).sum() / (err.norm() * cen.norm()))
            nbr = float((err[:, :, :, 1:] * err[:, :, :, :-1]).mean()
                        / rms ** 2)
            line.append(f"{name} max {float(err.abs().max() / ref.abs().max()):.3g}"
                        f" rms/spread {float(rms / spread):.3g} mean/rms "
                        f"{bias:.3g} corr(err, out) {along:.3g} x-nbr "
                        f"{nbr:.3g}")
        print(f"  layer {i} x{tuple(x.shape)} d={d}: " + "; ".join(line)
              + f" [{card}]", flush=True)


def head_flips(port, state: dict, batch, card: str, routes: dict) -> None:
    """(C) How many of the head's inputs lie on the other side of 0 in the
    card's step than in the f64 forward on the card's body masks, per
    route: the branch points 13(c) takes from the card since its truth
    missed them."""
    from flypylib_tpu_torch.ops.augment import augment_batch

    F = torch.nn.functional
    for name, ctx in routes.items():
        spec = cs.bn_spec(port, state, torch.float32)
        spec.module.to("cuda")
        seen = []
        hook = spec.module.head.register_forward_hook(
            lambda mod, inp, out: seen.append(out.detach().double()))
        with ctx(), cs.grad_decisions(spec.module) as dec:
            cs.train_grads(spec, "plain", batch, "cuda")
        hook.remove()
        P = {k: v.to("cuda", torch.float64) for k, v in state.items()}
        x, _, _, codes = (torch.from_numpy(a).to("cuda") for a in batch)
        h = augment_batch(x.double(), codes)[..., None]
        for i, d in enumerate((1, 1, 2, 2)):
            w = P[f"convs.{i}.weight"]
            h = F.conv3d(h.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                         dilation=d).permute(0, 2, 3, 4, 1) + P[f"convs.{i}.bias"]
            mu = h.mean((0, 1, 2, 3))
            var = torch.clamp((h * h).mean((0, 1, 2, 3)) - mu * mu, min=0.0)
            h = ((h - mu) * (torch.rsqrt(var + 1e-5) * P[f"norms.{i}.scale"])
                 + P[f"norms.{i}.bias"]) * (dec["y"][i] > 0)
        ref = h @ P["head.weight"] + P["head.bias"]
        flips = (seen[0] > 0) != (ref > 0)
        n = int(flips.sum())
        near = float(ref[flips].abs().max()) if n else 0.0
        print(f"  head inputs, {name}: {n} of {ref.numel()} on the other side "
              f"of 0 than f64's (the largest |f64 value| among them {near:.3g}, "
              f"max |f64 value| {float(ref.abs().max()):.3g}) [{card}]",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--forward-only", action="store_true",
                    help="part (B) only")
    args = ap.parse_args()
    cs.require(torch.cuda.is_available(), "needs an NVIDIA GPU")
    port = cs.import_port()
    card = cs.card()
    from flypylib_tpu_torch.ops import _build, conv

    _build.build()
    _build.load_library()
    state = cs.bn_state(port)
    real = conv.k1_route
    for seed in args.seeds:
        batch = cs.grad_batch(seed, cs.GRAD_BATCH, cs.GRAD_PATCH, 6)
        print(f"batch seed {seed}: forward, each conv against f64", flush=True)
        forward_errors(state, batch, card)
        if args.forward_only:
            continue
        head_flips(port, state, batch, card, {
            "simt": contextlib.nullcontext,
            "fma": lambda: cs.patched(conv, "k1_route", fma_route(real))})
        tol = cs.GRAD_TOL[torch.float32]
        for route, ctx in (
                ("simt", None),
                ("fma", lambda: cs.patched(conv, "k1_route", fma_route(real))),
                ("simt, TF32 on in the step (a control that must fail)",
                 lambda: cs.patched(conv, "no_tf32", cs.tf32_on))):
            res = (cs.bn_step(port, state, torch.float32, batch) if ctx is None
                   else cs.bn_step(port, state, torch.float32, batch,
                                   card_ctx=ctx))
            card_e, cpu_e = res["truth_card"], res["truth_cpu"]
            ratio = {n: card_e[n] / max(tol, cpu_e[n]) for n in card_e}
            worst = max(ratio, key=ratio.get)
            print(f"batch seed {seed}, K1 f32 on {route}: launches "
                  f"{ {k: v for k, v in res['launches'].items() if v} }; card "
                  f"worst {max(card_e.values()):.3g}, CPU worst "
                  f"{max(cpu_e.values()):.3g}; worst ratio {worst} "
                  f"{ratio[worst]:.3g} (13(c) allows {cs.BN_TRUTH_RATIO:g}); "
                  f"13(c) {'passes' if cs.bn_step_ok(res, torch.float32) else 'FAILS'}"
                  f" [{card}]", flush=True)
            print("   " + ", ".join(f"{n} {card_e[n]:.3g}/{cpu_e[n]:.3g}"
                                    for n in card_e), flush=True)


if __name__ == "__main__":
    main()
