"""Training forward (augment and the engine's forward): stream time of the port's ``train.forward`` spans (``train/trainer.py::make_loss_fn``), mean ms a step over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "train.step", ("train.forward",))
