"""Sampling (draws, gathers, augmentation codes): stream time of the port's ``train.sample`` spans (``train/trainer.py::make_train_step``), mean ms a step over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "train.step", ("train.sample",))
