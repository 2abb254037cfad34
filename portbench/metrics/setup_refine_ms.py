"""setup_refine_ms: the device time of the structured setup's refinement
(the port's span ``structured.refine``: ``structured_a_col`` and the MLP
on every column), a request of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "structured.refine", "device_ms")
