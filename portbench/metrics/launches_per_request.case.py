"""launches_per_request.case: as launches_per_request, for the per-case cell (it moves
case_solves_per_s): CUDA API calls that launch a
kernel or a graph inside the requests of the traced slice, a request."""

from portbench.harness.readers import launches_per_request


def read(view):
    return launches_per_request(view)
