"""Whole-volume detection: ``FplNetwork.detect_large`` in a closed loop.

One caller hands the program host (pageable) uint8 volumes from a pool made
from the seed, one call after the other: each call uploads, stages,
forwards and postprocesses (NMS and connected components) a volume.  The
workload file gives the volume's edge, its blob count, the pool size, the
ROI core, the NMS window and the threshold's quantile on a cutout.

Traced runs profile the first ``trace_calls`` calls as they are; the rest
of the window stages each volume itself (``stage_volume``, timed with a
synchronise), then calls ``detect_large`` on the upload, so staging and the
postprocess after the last forward get spans of their own.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gpubench import compare, counts, inputs, observe, reference


class Cell:
    def __init__(self, port, cfg, wl, seed, device):
        self.port, self.cfg, self.wl = port, cfg, wl
        self.seed, self.device = int(seed), torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.results = []

    def setup(self, trace: bool) -> None:
        cfg, wl, dev = self.cfg, self.wl, self.device
        self.params = inputs.make_params(cfg, self.seed, dev)
        # the threshold: a quantile of the reference's map of a probe of the
        # volumes' background (noise, no blobs: a blob in the probe would
        # move the quantile, and the detection work with it)
        probe = inputs.blob_volume(wl["probe"], 0, inputs.generator(
            self.seed, "probe", dev), dev)
        z = reference.volume_logits(cfg, self.params, probe, reference.U8_SCALE)
        a, c = inputs.calibrate(cfg, self.params, z)
        self.threshold = float(np.float32(np.quantile(
            torch.sigmoid(z * a + c).cpu().numpy(), wl["quantile"])))
        del probe, z
        net = self.port.FplNetwork(cfg["zoo"], seed=0, device=dev)
        net.load_flax_params(inputs.flax_variables(self.params))
        self.net = net
        self.vols = inputs.host_volumes(wl["size"], wl["blobs"],
                                        wl["pool"], self.seed, dev)
        self.kw = dict(core=wl["core"], method="both", window=wl["window"],
                       threshold=self.threshold)
        if self.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(wl["warmup"]):
            net.detect_large(self.vols[0], **self.kw)
        if trace:
            from flypylib_tpu_torch.infer.large import (make_stream_plan,
                                                        stage_volume)

            self.plan = make_stream_plan(
                net.infer_spec, None, self.vols[0].shape, core=wl["core"],
                window=wl["window"], threshold=self.threshold, method="both")
            self.stage_volume = stage_volume
            up = stage_volume(self.vols[0], plan=self.plan)
            net.detect_large(self.vols[0], staged=up, plan=self.plan, **self.kw)
            del up

    def _call(self, i: int):
        k = i % len(self.vols)
        self.results.append((k, self.net.detect_large(self.vols[k], **self.kw)))

    def window(self, seconds: float, trace: bool) -> dict:
        if trace:
            return self._traced(seconds)
        start = time.perf_counter()
        i = 0
        while True:
            self._call(i)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        mvox = i * self.vols[0].size / 1e6 / elapsed
        return {"metrics": {"volume_mvox_s": mvox}, "attempted": i}

    def _traced(self, seconds: float) -> dict:
        wl, spans = self.wl, observe.Spans()
        hooks = observe.ForwardHooks(self.net.infer_spec.module)
        prof = observe.Profile()
        start = time.perf_counter()
        prof.start()
        per_call = 0
        for i in range(wl["trace_calls"]):
            hooks.reset()
            self._call(i)
            per_call = hooks.count
            spans.add("forward", hooks.device_seconds())
        prof.stop()
        i = wl["trace_calls"]
        mode = ("shared" if per_call == self.plan.full_pipe().n_batches
                else "roi")
        print(f"gpubench: detect_large forward={mode} (auto): {per_call} "
              "module calls a volume", file=sys.stderr, flush=True)
        while time.perf_counter() - start < seconds:
            k = i % len(self.vols)
            vol = self.vols[k]
            hooks.reset()
            hooks.sync_at = per_call
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            up = self.stage_volume(vol, plan=self.plan)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = self.net.detect_large(vol, staged=up, plan=self.plan,
                                        **self.kw)
            t2 = time.perf_counter()
            del up
            self.results.append((k, out))
            spans.add("stage", t1 - t0)
            spans.add("forward", hooks.device_seconds())
            if hooks.last_post is not None:
                spans.add("postprocess", t2 - hooks.last_post)
            i += 1
        hooks.remove()
        profile = prof.summary()  # read once the window has closed
        work = {"calls": wl["trace_calls"],
                "flops": counts.forward_flops(self.cfg, wl["size"]),
                "bound_s": counts.forward_bound_s(self.cfg, wl["size"])[0]}
        return {"obs": observe.Obs(spans, profile, work), "attempted": i}

    def release(self) -> None:
        self.net = self.plan = None
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference_lists(self, k: int, precision: str = "f32"):
        """The reference's NMS and component lists of volume ``k``."""
        vol = torch.from_numpy(self.vols[k]).to(self.device)
        prob = reference.volume_logits(self.cfg, self.params, vol,
                                       reference.U8_SCALE, precision)
        del vol
        prob = torch.sigmoid_(prob)
        nms = reference.nms(prob, self.wl["window"], self.threshold)
        cc = reference.components(prob, self.threshold)
        del prob
        if self.cuda:
            torch.cuda.empty_cache()
        return nms, cc

    def numbers(self, lists, ref) -> dict:
        """The check's numbers for one call's ``(nms, components)`` lists
        against the reference's."""
        (ref_idx, ref_conf), (ref_cent, ref_cc_conf) = ref
        nms_det, cc_det = lists
        out = compare.nms_numbers(nms_det.locs, nms_det.conf, ref_idx,
                                  ref_conf, self.vols[0].shape)
        out.update(compare.cc_numbers(cc_det.locs, cc_det.conf, ref_cent,
                                      ref_cc_conf))
        return out

    def check(self):
        """Every call the window made on one volume of the pool (drawn from
        the seed) against the reference's lists of that volume."""
        k = int(np.random.default_rng(self.seed).integers(len(self.vols)))
        calls = [r for kk, r in self.results if kk == k]
        if not calls:  # a window too short to reach volume k
            k, calls = self.results[0][0], [r for kk, r in self.results
                                            if kk == self.results[0][0]]
        ref = self.reference_lists(k)
        limits = self.wl["limits"]
        worst, failed = {}, 0
        for lists in calls:
            n = self.numbers(lists, ref)
            failed += any(not v <= limits[key] for key, v in n.items()
                          if key in limits)
            for key, v in n.items():
                worst[key] = max(worst.get(key, 0.0), v)
        print(f"gpubench: checked {len(calls)} calls on volume {k}: "
              f"reference {len(ref[0][0])} NMS, {len(ref[1][0])} components; "
              f"threshold {self.threshold!r}", file=sys.stderr, flush=True)
        return worst, failed
