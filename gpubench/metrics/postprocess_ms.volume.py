"""Box postprocess and host CC (host clock from the synchronised end of the last forward to the return of detect_large): mean ms a call, from the ``postprocess`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("postprocess")
