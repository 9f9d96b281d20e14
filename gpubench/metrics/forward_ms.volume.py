"""Model forward (CUDA events around each module call, summed a volume): mean ms a call, from the ``forward`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("forward")
