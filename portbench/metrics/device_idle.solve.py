"""device_idle.solve: the share of the traced slice with no kernel, copy
or set on the card, in %."""

from portbench.harness.readers import idle_share


def read(view):
    return idle_share(view)
