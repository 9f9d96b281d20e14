"""Device idle share: the profiled stretch's time with nothing running on
the card (kernels, copies, sets), in percent of the stretch."""


def read(obs):
    p = obs.profile
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
