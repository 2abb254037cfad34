"""setup_galerkin_ms: the device time of the multigrid's Galerkin levels
(the port's span ``gmg.galerkin``: each level's inverse diagonal and
coarse operator P^T A P), a request of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "gmg.galerkin", "device_ms")
