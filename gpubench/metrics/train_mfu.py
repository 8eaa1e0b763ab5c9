"""The whole train step's share of the card's dense bf16 peak: model FLOPs
of the window's steps (``gpubench.flops.train_step_flops``: 6 T (active
block params + head) and the causal attention forward and backward, no
remat) over the window's seconds x the peak (``flops.bf16_peak``)."""
from gpubench import flops


def read(ctx):
    if "steps" not in ctx:
        return None
    return 100.0 * ctx["model_flops"] / (
        ctx["window_s"] * flops.bf16_peak(ctx["device_name"]))
