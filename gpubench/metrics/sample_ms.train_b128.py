"""Sampling and augmentation (synchronised marks: step start to the forward's call): mean ms a call, from the ``sample`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("sample")
