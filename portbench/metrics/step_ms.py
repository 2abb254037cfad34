"""step_ms: CUDA events around the runner's call of the port's training
step (span ``step``), mean a step of the traced slice, in ms."""

from portbench.harness.readers import mean_span


def read(view):
    return mean_span(view, "step")
