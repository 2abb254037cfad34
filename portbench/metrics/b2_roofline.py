"""b2_roofline: kernel B2 (``csrc/dia_spmv.cu``): the least time of
every DIA product the slice's requests need over the device time of its
launches, in % (its launch count checked against the port's)."""

from portbench.harness.readers import roofline


def read(view):
    return roofline(view, "dia_spmv_kernel", "dia_spmv", "b2")
