"""b1_roofline.case: as b1_roofline, for the per-case cell (it moves
case_solves_per_s): kernel B1 (``csrc/gauss_jordan.cu``): the least time of
the local solves the slice's requests need over the device time of its
launches, in % (its launch count checked against the port's)."""

from portbench.harness.readers import roofline


def read(view):
    return roofline(view, "gauss_jordan_kernel", "gauss_jordan", "b1")
