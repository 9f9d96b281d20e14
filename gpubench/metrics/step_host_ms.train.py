"""Host issue of a step: host time of the first ``train.step`` root span of the profiled stretch (``train/trainer.py::make_train_step``), in ms.  The stretch opens on an idle card, so no launch-queue back-pressure holds that step: it reads the host's time to issue one step (under the profiler), where a later step's host time reads the card's."""

from gpubench.portspans import first_root_ms


def read(obs):
    return first_root_ms(obs, "train.step")
