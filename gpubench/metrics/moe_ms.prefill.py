"""Device ms a request of the work launched inside the MoE layer
(``repro_torch.models.mlp.moe``, wrapped in a ``gpubench::moe`` range in
the traced run)."""


def read(ctx):
    if "traced_requests" not in ctx or "moe" not in ctx["summary"].range_s:
        return None
    return 1e3 * ctx["summary"].range_s["moe"] / ctx["traced_requests"]
