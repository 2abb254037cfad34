"""setup_forward_ms.case: the device time of the per-case setup's model
forward (the port's span ``fsai.forward``: the columns, kernel B1, the
MLP), a request of the traced slice, in ms; it moves case_solves_per_s."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "fsai.forward", "device_ms")
