"""Training: the trainer's own step, back to back, on a labelled volume.

The program's ``TrainConfig`` is the workload file's ``train`` dict (the
defaults users get, and the batch size); the labelled volume (its
``regions``) and the weights, with the logits layer's bias at
``logit(prior)``, are made from the seed on the device.  Set-up builds the
step once, runs its first ``check_steps`` steps (what the check compares)
and further warm-up steps, and hands the same state to the window.  The
window's rate, named by the workload's ``rate_metric``, counts the patch
voxels the configuration asks for (``patch_size``), whatever patch the
engine rounds it to.

Traced runs profile the first ``trace_calls`` steps as they are; the rest
of the window marks each step's parts (sampling, forward, loss and
backward, Adam) with a synchronise at each mark: the trainer's forward and
loss functions are wrapped before the step is built, and the optimizer's
step hooks mark Adam.
"""

from __future__ import annotations

import sys
import time

import torch

from gpubench import compare, counts, inputs, observe, reference


def flax_name(name: str, n_convs: int) -> str:
    """The JAX package's name of a conv stack's parameter
    (``convs.i.weight`` -> ``Conv_i/kernel``, the head and the logits after
    the convs)."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    if parts[0] == "convs":
        return f"Conv_{parts[1]}/{leaf}"
    k = {"head": n_convs, "logits": n_convs + 1}[parts[0]]
    return f"Conv_{k}/{leaf}"


class Cell:
    def __init__(self, port, cfg, wl, seed, device):
        self.port, self.cfg, self.wl = port, cfg, wl
        self.seed, self.device = int(seed), torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.marking = False
        self.marks = []

    def _mark(self, *_):
        if self.marking:
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())

    def _wrap_trainer(self, trainer) -> None:
        """Marks at the forward's and the loss's calls (what
        ``make_train_step`` binds when it builds the step)."""
        real_forward, real_loss = trainer._train_forward, trainer.masked_bce_loss
        mark = self._mark

        def train_forward(*args):
            fwd = real_forward(*args)
            return lambda x: (mark(), fwd(x))[1]

        def loss(*args, **kw):
            mark()
            return real_loss(*args, **kw)

        trainer._train_forward, trainer.masked_bce_loss = train_forward, loss
        self._restore = (trainer, real_forward, real_loss)

    def setup(self, trace: bool) -> None:
        from flypylib_tpu_torch.train import trainer
        from flypylib_tpu_torch.train.trainer import (TrainConfig, TrainData,
                                                      make_train_step,
                                                      resolve_engine)

        cfg, wl, dev = self.cfg, self.wl, self.device
        tc = wl["train"]
        self.params = inputs.make_params(cfg, self.seed, dev)
        inputs.prior_bias(self.params, wl["prior"])
        # the trainer's sampling generator: seeded as the reference's
        self.sample_seed = int(inputs.generator(self.seed, "sample", "cpu")
                               .initial_seed())
        net = self.port.FplNetwork(cfg["zoo"], seed=self.sample_seed,
                                   device=dev, train_config=TrainConfig(**tc))
        net.load_flax_params(inputs.flax_variables(self.params))
        image, labels, mask = inputs.train_volume(
            wl["volume"], wl["blobs"], wl["label_radius"], wl["regions"],
            self.seed, dev)
        self.volume = (image, labels, mask)
        self._restore = None
        if trace:  # undone by release(): the step looks the loss up per call
            self._wrap_trainer(trainer)
        step, _, patch = make_train_step(net.spec, net.trainer.cfg)
        # the patch the engine samples, as the program rounded it and as the
        # reference works it out for the engine the program took
        self.patch = patch
        self.engine = resolve_engine(net.spec, net.trainer.cfg)
        self.ref_patch = reference.train_patch(cfg, tc["patch_size"],
                                               self.engine)
        data = TrainData.build(image.cpu().numpy(), labels.cpu().numpy(),
                               mask.cpu().numpy(), patch, device=dev)
        state = net.trainer.init_state()
        gen = net.trainer.generator
        names = [n for n, _ in state.module.named_parameters()]
        n_convs = len(cfg["features"])
        self.names = {n: flax_name(n, n_convs) for n in names}
        params = dict(state.module.named_parameters())
        self.p0 = {n: p.detach().clone() for n, p in params.items()}
        self.losses = []
        beta1 = state.optimizer.param_groups[0]["betas"][0]
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for k in range(wl["warmup"]):
            m = step(state, gen, data)
            if k < wl["check_steps"]:
                self.losses.append(float(m["loss"]))
            if k == 0:
                self.g1 = {n: state.optimizer.state[p]["exp_avg"].detach()
                           .clone() / (1 - beta1) for n, p in params.items()}
            if k + 1 == wl["check_steps"]:
                self.p3 = {n: p.detach().clone() for n, p in params.items()}
        self.step, self.state, self.gen, self.data = step, state, gen, data
        self.net = net
        if trace:
            self.hooks = (state.optimizer.register_step_pre_hook(self._mark),
                          state.optimizer.register_step_post_hook(self._mark))

    def window(self, seconds: float, trace: bool) -> dict:
        if trace:
            return self._traced(seconds)
        step, state, gen, data = self.step, self.state, self.gen, self.data
        n = 0
        start = time.perf_counter()
        while True:
            m = step(state, gen, data)
            n += 1
            if time.perf_counter() - start >= seconds:
                break
        float(m["loss"])  # waits for the last step
        elapsed = time.perf_counter() - start
        tc = self.wl["train"]
        mvox = n * tc["batch_size"] * tc["patch_size"] ** 3 / elapsed / 1e6
        return {"metrics": {self.wl["rate_metric"]: mvox}, "attempted": n}

    def _traced(self, seconds: float) -> dict:
        step, state, gen, data = self.step, self.state, self.gen, self.data
        wl, spans = self.wl, observe.Spans()
        prof = observe.Profile()
        start = time.perf_counter()
        prof.start()
        for _ in range(wl["trace_calls"]):
            step(state, gen, data)
        prof.stop()
        n = wl["trace_calls"]
        self.marking = True
        parts = ("sample", "forward", "backward", "adam")
        while time.perf_counter() - start < seconds:
            self.marks = []
            self._mark()
            step(state, gen, data)
            if len(self.marks) == 5:
                for k, a, b in zip(parts, self.marks, self.marks[1:]):
                    spans.add(k, b - a)
            n += 1
        self.marking = False
        for h in self.hooks:
            h.remove()
        profile = prof.summary()  # read once the window has closed
        tc = self.wl["train"]
        work = {"calls": wl["trace_calls"],
                "flops": tc["batch_size"] * counts.train_flops(
                    self.cfg, tc["patch_size"])}
        return {"obs": observe.Obs(spans, profile, work), "attempted": n}

    def release(self) -> None:
        if self._restore is not None:
            t, f, lo = self._restore
            t._train_forward, t.masked_bce_loss = f, lo
            self._restore = None
        self.step = self.state = self.gen = self.data = self.net = None
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference_run(self, precision: str = "f32", fault: str | None = None):
        """The reference's first ``check_steps`` steps from the same weights,
        volume and generator seed, on the patch it works out itself."""
        data = reference.TrainData(*self.volume, self.ref_patch)
        gen = torch.Generator(device=self.device).manual_seed(self.sample_seed)
        return reference.train(self.cfg, self.params, data, gen,
                               self.wl["train"], self.ref_patch,
                               self.wl["check_steps"], precision, fault)

    def numbers(self, ref) -> dict:
        """The program's readings against a reference run's: each step's
        loss, the first gradient and the change of the leaves."""
        got_g = {self.names[n]: g.cpu().numpy() for n, g in self.g1.items()}
        got_d = {self.names[n]: (self.p3[n] - self.p0[n]).cpu().numpy()
                 for n in self.p0}
        p0 = {self.names[n]: v for n, v in self.p0.items()}
        ref_g = {k: v.cpu().numpy() for k, v in ref["grad"].items()}
        ref_d = {k: (v - p0[k].reshape(v.shape)).cpu().numpy()
                 for k, v in ref["params"].items()}
        counted = compare.moved_leaves(ref_g)
        steps = [abs(a - b) / abs(b) for a, b in zip(self.losses, ref["loss"])]
        print("gpubench: loss gap by step " + ", ".join(f"{g:.3g}" for g in steps)
              + f"; {len(counted)} of {len(ref_g)} leaves counted; {self.engine}"
              f" engine, patch {self.patch} (reference {self.ref_patch})",
              file=sys.stderr, flush=True)
        # the first step's: both sides start from the same weights, so it
        # reads rounding alone; later steps add the drift of two trajectories
        return {"patch_gap": abs(self.patch - self.ref_patch),
                "loss_gap": steps[0],
                "grad_gap": compare.leaf_gap(got_g, ref_g, counted),
                "grad_diff": compare.diff_gap(got_g, ref_g, counted),
                "change_gap": compare.leaf_gap(got_d, ref_d, counted)}

    def check(self):
        n = self.numbers(self.reference_run())
        limits = self.wl["limits"]
        failed = int(any(not v <= limits[k] for k, v in n.items() if k in limits))
        return n, failed
