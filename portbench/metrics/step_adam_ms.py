"""step_adam_ms: the device time of the train step's optimizer (the port's
span ``train.adam``: ``zero_grad`` and Adam's ``step``), a step of the
traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "train.adam", "device_ms")
