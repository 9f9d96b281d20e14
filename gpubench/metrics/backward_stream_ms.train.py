"""Loss and gradients: stream time of the port's ``train.loss`` (``make_loss_fn``) and ``train.backward`` (``make_train_step``) spans, mean ms a step over the profiled stretch."""

from gpubench.portspans import per_root_ms


def read(obs):
    return per_root_ms(obs, "train.step", ("train.loss", "train.backward"))
