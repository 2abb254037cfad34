"""pcg_chunk_enqueue_us: the host's time to enqueue one PCG chunk (the
cell's ``check_every`` masked iterations; the port's span ``pcg.chunk``,
its host reads excluded), mean a chunk of the traced slice, in us."""

from portbench.harness.program import per_call


def read(view):
    ms = per_call(view, "pcg.chunk", "self_host_ms")
    return None if ms is None else ms * 1e3
