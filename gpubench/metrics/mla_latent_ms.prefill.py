"""Device ms a request of the work launched inside latent attention's
latent half (``repro_torch.models.attention.mla_latent``: W_kva, the
latent's norm, W_kvb, RoPE on k_pe and K's assembly), wrapped in a
``gpubench::mla_latent`` range in the traced run."""


def read(ctx):
    if ("traced_requests" not in ctx
            or "mla_latent" not in ctx["summary"].range_s):
        return None
    return 1e3 * ctx["summary"].range_s["mla_latent"] / ctx["traced_requests"]
