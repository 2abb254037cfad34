"""setup_ms.case: as setup_ms, for the per-case cell (it moves
case_solves_per_s): CUDA events around the runner's call of the port's setup
(span ``setup``), mean a request of the traced slice, in ms."""

from portbench.harness.readers import mean_span


def read(view):
    return mean_span(view, "setup")
