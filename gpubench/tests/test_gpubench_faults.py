"""Runs of the harness on the CPU at tiny sizes (no look for a chip): a
sound run comes out correct, and a run with the timed path broken
underneath comes out not correct, once for each fault the cell can have.
The control (the reference in fp8 put in the program's place) fails too.
Each tiny cell keeps its real cell's limits."""

import pytest
import torch

from gpubench import compare, harness
from gpubench.tests.tiny import tiny_catalog

SEED = 3000000019  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return tiny_catalog(tmp_path_factory.mktemp("bench"))


def run(catalog, name, cell_cls=None):
    port = harness.import_port()
    line, _ = harness.run_cell(port, harness.manifest(), name, SEED, 0.3,
                               False, device="cpu", catalog=catalog,
                               cell_cls=cell_cls)
    return line


def altered(module, args, out):
    """The forward's answer altered where it is produced."""
    return out + 3.0


def half_left_out(module, args, out):
    """Half of the batch left out: its tiles' logits never written (or,
    for a batch of one tile, half of the tile)."""
    out = out.clone()
    if out.shape[0] > 1:
        out[out.shape[0] // 2:] = -30.0
    else:
        out[:, : out.shape[1] // 2] = -30.0
    return out


def broken(kind: str, hook):
    """The kind's driver with ``hook`` on the module its timed calls run."""
    base = harness.kind_driver(kind)

    class Broken(base):
        def setup(self, trace):
            super().setup(trace)
            self.net.infer_spec.module.register_forward_hook(hook)

    return Broken


CELLS = ["baseline.volume_1k", "baseline.train_b32", "baseline.train_b128"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(catalog, name):
    line = run(catalog, name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] >= 1


@pytest.mark.parametrize("fault", [altered, half_left_out],
                         ids=["altered", "half_left_out"])
@pytest.mark.parametrize("name", CELLS[:1])
def test_inference_faults_are_caught(catalog, name, fault):
    kind = catalog.workload(name)["kind"]
    line = run(catalog, name, broken(kind, fault))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS[1:])
def test_state_left_unchanged_is_caught(catalog, name, monkeypatch):
    real = torch.optim.Adam.step

    def step(self, *a, **k):
        keep = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        out = real(self, *a, **k)
        with torch.no_grad():
            for p, v in zip((p for g in self.param_groups
                             for p in g["params"]), keep):
                p.copy_(v)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", step)
    line = run(catalog, name)
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS[1:])
def test_half_batch_is_caught(catalog, name, monkeypatch):
    from flypylib_tpu_torch.train import trainer

    real = trainer.masked_bce_loss

    def half(logits, labels, mask, count=None):
        h = logits.shape[0] // 2
        return real(logits[:h], labels[:h], mask[:h], count)

    monkeypatch.setattr(trainer, "masked_bce_loss", half)
    line = run(catalog, name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(catalog, name):
    """The reference computed in fp8, put in the program's place."""
    from gpubench import control

    port = harness.import_port()
    wl = catalog.workload(name)
    entry = harness.cell_entry(harness.manifest(), name)
    cell = harness.kind_driver(wl["kind"])(
        port, catalog.config(entry["config"]), wl, SEED, "cpu")
    cell.setup(False)
    cell.window(0.0, False)
    cell.release()
    got = dict(control.controls(cell, wl["kind"]))["fp8"]
    assert not compare.passed(compare.judge(got, wl["limits"])), got
