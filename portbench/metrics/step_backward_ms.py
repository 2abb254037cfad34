"""step_backward_ms: the device time of the train step's backward (the
port's span ``train.backward``), a step of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "train.backward", "device_ms")
