"""b1_roofline.train: kernel B1 (``csrc/gauss_jordan.cu``) in the
training steps: the least time of the local solves of every column of
the steps' batches over the device time of its launches, in % (its
launch count checked against the port's)."""

from portbench.harness.readers import roofline


def read(view):
    return roofline(view, "gauss_jordan_kernel", "gauss_jordan", "b1")
