"""Adam (the optimizer's step pre- and post-hooks, synchronised): mean ms a call, from the ``adam`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("adam")
