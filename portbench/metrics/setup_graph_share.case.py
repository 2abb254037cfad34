"""setup_graph_share.case: the share of the traced slice's per-case
learned setups (span ``fsai.setup``) that the port replayed from CUDA
graphs (its counter ``fsai.graph_setups``), in %; it moves
case_solves_per_s.  None on a port without graphed setups
(``SETUP_GRAPHS`` in ``models/neural_fsai.py``), as for a slice that
ran no setup."""

from portbench.harness.program import recorded


def read(view):
    snap = recorded(view)
    if snap is None or not view.records:
        return None
    from deeppreconditioning_tpu_torch.models import neural_fsai

    if not hasattr(neural_fsai, "SETUP_GRAPHS"):
        return None
    setups = snap["spans"].get("fsai.setup", {}).get("calls", 0)
    if setups <= 0:
        return None
    return 100.0 * snap["counters"].get("fsai.graph_setups", 0) / setups
