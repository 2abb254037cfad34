"""pcg_masked_share: the share of the PCG iterations executed in the
traced slice that ran after their system had stopped, in %:
100 (1 - the iterations the port returned / the port's counter
``pcg.system_iterations``, systems x ``check_every`` a chunk).  A masked
iteration runs every product and is frozen by ``torch.where``."""

from portbench.harness.program import masked_share


def read(view):
    return masked_share(view)
