"""kernels_per_cycle: the device kernels launched inside the port's
``pcg.solve`` spans (placed by their launch call's correlation id) over
the V-cycles those solves ran, one an apply: ``pcg.system_iterations``
plus the solves (``harness/cycles.py``); the chain a cycle and its
iteration put on the card.  None without the counter or the span."""

from portbench.harness.cycles import kernels_per_cycle


def read(view):
    return kernels_per_cycle(view)
