"""pcg_iters: the PCG iterations the port returns, mean a system of the
traced slice."""

from portbench.harness.readers import mean_iterations


def read(view):
    return mean_iterations(view)
