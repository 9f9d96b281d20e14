"""Staging (upload and reflect pad on the card, stage_volume): mean ms a call, from the ``stage`` spans of the traced window."""


def read(obs):
    return obs.spans.mean_ms("stage")
