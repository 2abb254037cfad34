"""launches_per_step: CUDA API calls that launch a kernel
or a graph inside the training steps of the traced slice, a step."""

from portbench.harness.readers import launches_per_request


def read(view):
    return launches_per_request(view)
