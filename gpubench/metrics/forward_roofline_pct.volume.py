"""The forward's share of its roofline: the least time one call's forward
could take (operations at 989 TFLOP/s or bytes at 3.35 TB/s, of one
monolithic valid forward over the volume) over the device time of the
kernels launched inside the module's forward calls, in the profiled
stretch.  Nothing to read when the profile saw no forward."""

from gpubench.observe import FORWARD


def read(obs):
    t = obs.profile["range_device_s"].get(FORWARD, 0.0)
    if t <= 0:
        return None
    return 100.0 * obs.work["calls"] * obs.work["bound_s"] / t
