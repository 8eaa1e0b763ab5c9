"""The whole prefill's share of the card's dense bf16 peak: model FLOPs of
the window's requests (``gpubench.flops.prefill_flops``: 2 T active block
params, the head on the last position, the causal attention) over the
window's seconds x the peak (``flops.bf16_peak``)."""
from gpubench import flops


def read(ctx):
    if "requests" not in ctx:
        return None
    return 100.0 * ctx["model_flops"] / (
        ctx["window_s"] * flops.bf16_peak(ctx["device_name"]))
