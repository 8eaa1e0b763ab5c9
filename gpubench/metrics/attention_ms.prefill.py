"""Device ms a request of the work launched inside self-attention
(``repro_torch.models.attention.self_attention``, wrapped in a
``gpubench::attention`` range in the traced run)."""


def read(ctx):
    if ("traced_requests" not in ctx
            or "attention" not in ctx["summary"].range_s):
        return None
    return 1e3 * ctx["summary"].range_s["attention"] / ctx["traced_requests"]
