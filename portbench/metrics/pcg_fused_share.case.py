"""pcg_fused_share.case: as pcg_fused_share, for the per-case cell (it
moves case_solves_per_s): the share of the PCG iterations executed in
the traced slice (the port's counter ``pcg.system_iterations``) that ran
through the port's fused iteration kernels (its counter
``pcg.fused_iterations``), in %."""

from portbench.harness.fused import fused_share


def read(view):
    return fused_share(view)
