"""setup_root_ms: the device time of the multigrid's root (the port's
span ``gmg.root``: the 8^3 operator's dense assembly, inverse and
symmetrisation), a request of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "gmg.root", "device_ms")
