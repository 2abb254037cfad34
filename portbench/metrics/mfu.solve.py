"""mfu.solve: the flops the slice's requests need (``portbench/work``,
from shapes and iterations) over the slice's length, against the card's
float32 peak, in %."""

from portbench.harness.readers import mfu


def read(view):
    return mfu(view)
