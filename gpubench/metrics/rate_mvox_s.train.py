"""The training rate by the host's clock: patch voxels a second over the
first ``rate_seconds`` of the traced window, whose steps run as they are
(no profiler, no marks), in Mvox/s."""


def read(obs):
    return obs.work.get("rate_mvox_s")
