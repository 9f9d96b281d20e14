"""The readings a cell's limits are set from, on the card at the cell's size.

    python gpubench/control.py --workload <cell> --seeds 1 2 ... --controls 3

For each seed the program's readings: the cell's set-up, a short window at
the cell's own load (``--seconds``), the check's numbers.  For the first
``--controls`` seeds also the control's: the reference computed in fp8
(``reference.py``'s ``precision="fp8"``) put in the program's place, held
against the f32 reference by the same numbers; and, for a training cell,
the faults read on the reference put in the program's place (half of the
batch left out; a state left unchanged reads 1 by construction).  One JSON
line a reading; the benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    port = harness.import_port()
    cat = harness.Catalog()
    man = harness.manifest()
    entry = harness.cell_entry(man, args.workload)
    wl, cfg = cat.workload(args.workload), cat.config(entry["config"])
    Cell = harness.kind_driver(wl["kind"])
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cell = Cell(port, cfg, wl, seed, "cuda")
        cell.setup(False)
        cell.window(args.seconds, False)
        cell.release()
        numbers, failed = cell.check()
        out = {"seed": seed, "side": "program", "numbers": numbers,
               "failed": failed, "s": time.perf_counter() - t0}
        print(json.dumps(out), flush=True)
        if i >= args.controls:
            continue
        for side, got in controls(cell, wl["kind"]):
            print(json.dumps({"seed": seed, "side": side, "numbers": got}),
                  flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


def controls(cell, kind: str):
    """``(side, numbers)`` of the control (and the faults) of one set-up."""
    if kind == "volume":
        ref = cell.reference_lists(0)
        (idx8, conf8), (cent8, cc_conf8) = cell.reference_lists(0, "fp8")
        shape = cell.vols[0].shape
        yx = shape[1] * shape[2]
        locs8 = idx8[:, None] // [yx, shape[2], 1] % [shape[0], shape[1], shape[2]]
        nms8 = SimpleNamespace(locs=locs8.astype(float), conf=conf8)
        cc8 = SimpleNamespace(locs=cent8, conf=cc_conf8)
        yield "fp8", cell.numbers((nms8, cc8), ref)
    elif kind == "train":
        ref = cell.reference_run()
        for side, prec, fault in (("fp8", "fp8", None),
                                  ("half_batch", "f32", "half_batch")):
            other = cell.reference_run(prec, fault)
            cell.losses = other["loss"]
            cell.g1 = {n: other["grad"][cell.names[n]] for n in cell.p0}
            cell.p3 = {n: other["params"][cell.names[n]].reshape(cell.p0[n].shape)
                       for n in cell.p0}
            yield side, cell.numbers(ref)


if __name__ == "__main__":
    sys.exit(main())
