"""setup_wrap_ms.case: the device time of the per-case setup's wrap (the
port's span ``fsai.wrap``: factor or strips, the Gram form, the
polynomial wrap), a request of the traced slice, in ms; it moves
case_solves_per_s."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "fsai.wrap", "device_ms")
