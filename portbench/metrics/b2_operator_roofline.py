"""b2_operator_roofline: kernel B2 at the operator's band count
(``dia_spmv_kernel<27, R>`` for HPCG, ``<7, R>`` for the 7-point
operator) inside the PCG solves: ``portbench/work.dia_work`` of the
operator products the port counted (``pcg.operator_products``) over the
device time of those launches, in %; None unless the launches and the
counter agree (``harness/operators.py``)."""

from portbench.harness.operators import operator_roofline


def read(view):
    return operator_roofline(view)
