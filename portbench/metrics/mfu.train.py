"""mfu.train: the flops the slice's training steps need (``portbench/work``:
the local solves, the MLP forward and backward, the loss's PCG steps with
M in factored form, forward and backward) over the slice's length,
against the card's float32 peak, in %."""

from portbench.harness.readers import mfu


def read(view):
    return mfu(view)
