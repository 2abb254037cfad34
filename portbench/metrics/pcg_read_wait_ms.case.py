"""pcg_read_wait_ms.case: as pcg_read_wait_ms, for the per-case cell (it
moves case_solves_per_s): the host's time in the PCG's reads of ``done``
(the port's span ``pcg.read``: how far the host ran ahead of the card),
a request of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "pcg.read", "host_ms")
