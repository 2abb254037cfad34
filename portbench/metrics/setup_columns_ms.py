"""setup_columns_ms: the device time of the structured setup's columns
(the port's span ``structured.columns``: sort, scale, the gathers and
kernel B1's local solves), a request of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "structured.columns", "device_ms")
