"""Run one cell of the flypylib_tpu_torch benchmark once and print its line.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the port.  It
needs an NVIDIA card (as many as the cell asks for) and prints no result
without one.  With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, the device's busy time and
a breakdown.  Every run checks what the timed calls produced against the
plain reference (``gpubench/reference.py``) and prints each number compared
beside its limit, last on standard error and last in the line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel caches live at fixed paths inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    from gpubench import harness

    man = harness.manifest()
    chips = harness.cell_entry(man, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    port = harness.import_port()
    line, checks = harness.run_cell(port, man, args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    device="cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"gpubench: {args.workload} seed {args.seed} correct "
          f"{line['correct']} on {line['device']['kind']} "
          f"({line['device'].get('power_limit')})", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']:.9g} (limit {c['limit']:.9g})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
