"""pcg_iters.case: as pcg_iters, for the per-case cell (it moves
case_solves_per_s): the PCG iterations the port returns, mean a system of the
traced slice."""

from portbench.harness.readers import mean_iterations


def read(view):
    return mean_iterations(view)
