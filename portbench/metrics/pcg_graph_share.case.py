"""pcg_graph_share.case: as pcg_graph_share, for the per-case cell (it
moves case_solves_per_s): the share of the traced slice's PCG chunks
(span ``pcg.chunk``) that the port replayed from a CUDA graph (its
counter ``pcg.graph_chunks``), in %."""

from portbench.harness.graphs import graph_share


def read(view):
    return graph_share(view)
