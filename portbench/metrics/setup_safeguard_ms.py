"""setup_safeguard_ms: the device time of the structured setup's spectral
safeguard (the port's span ``structured.safeguard``: the power iteration
and the polynomial's check), a request of the traced slice, in ms."""

from portbench.harness.program import per_request


def read(view):
    return per_request(view, "structured.safeguard", "device_ms")
