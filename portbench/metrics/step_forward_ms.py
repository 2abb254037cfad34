"""step_forward_ms: the device time of the train step's forward (the port's
span ``train.forward``: the model and ``pcg_loss``), a step of the traced
slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "train.forward", "device_ms")
