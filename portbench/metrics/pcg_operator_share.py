"""pcg_operator_share: the device time of the operator products (kernel
B2 at the operator's band count) over the device time of every kernel
that starts inside the port's ``pcg.solve`` spans, in %: whether the
operator or the factor apply and the vector work set the solve's pace;
None unless the launches and ``pcg.operator_products`` agree
(``harness/operators.py``)."""

from portbench.harness.operators import operator_share


def read(view):
    return operator_share(view)
