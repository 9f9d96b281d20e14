"""Training forward (synchronised marks: the forward's call to the loss's call): mean ms a call, from the ``forward`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("forward")
