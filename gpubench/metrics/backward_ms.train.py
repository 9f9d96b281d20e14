"""Loss and backward (synchronised marks: the loss's call to the optimizer's step): mean ms a call, from the ``backward`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("backward")
