"""The share of the traced requests' wall time in which no kernel, memcpy
or memset ran on the card (their union, not their sum)."""


def read(ctx):
    if "traced_requests" not in ctx:
        return None
    s = ctx["summary"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)
