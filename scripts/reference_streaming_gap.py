#!/usr/bin/env python3
"""The JAX package's ``voxel_pr_streaming`` against ``voxel_pr`` of its own
monolithic map, for a two-level U-Net (CPU, about half a minute).

    python3 scripts/reference_streaming_gap.py

Prints the largest gap in precision and recall over nine thresholds taken
from the map.  A slab window of the reference holds ``slab + 2 context``
true rows and the tile grid reads zeros past them, while a two-level U-Net's
output reaches past ``context`` on one side by its pooling phase: the last
rows of a slab then differ from the monolithic map's, and so can the
counts (ROADMAP queue 3, R1).  The port's ``voxel_pr_streaming`` reads the
true rows of the slab's whole grid (tests/test_torch_matching.py).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from flypylib_tpu.infer.tiled import TiledInference  # noqa: E402
from flypylib_tpu.models.zoo import unet  # noqa: E402
from flypylib_tpu.ops.matching import voxel_pr, voxel_pr_streaming  # noqa: E402


def main() -> int:
    spec = unet(base_features=2, levels=2, convs_per_stage=1)
    variables = spec.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(11)
    vol = rng.random((37, 30, 26)).astype(np.float32)
    labels = (rng.random(vol.shape) > 0.9).astype(np.float32)
    prob = TiledInference(spec, variables, tile_out=12,
                          tile_batch=2).infer(vol)
    thr = np.sort(prob.ravel()[rng.integers(0, prob.size, 9)])
    ref = voxel_pr(prob, labels, thresholds=thr)
    got = voxel_pr_streaming(spec, variables, vol, labels, thresholds=thr,
                             slab=16, tile_out=12, tile_batch=2)
    for k in ("precision", "recall"):
        gap = np.abs(ref[k] - got[k])
        print(f"{k}: {int((gap > 0).sum())} of {len(thr)} thresholds "
              f"differ, max gap {gap.max():.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
