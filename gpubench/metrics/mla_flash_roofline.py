"""Latent attention's flash forward (``flash_fwd_mla_kernel``, q and k at
192, v at 128) against its roofline: for each traced request the least
time the card could take, its causal products
(``reference/mla_moe_lm.attention_flops``: QK^T and PV over the S (S + 1)
/ 2 pairs of every head and layer) at the dense bf16 peak
(``flops.bf16_peak``) or its bytes (``attention_bytes``: q, k, v and the
output once) at HBM bandwidth, whichever is longer (the products, at
these lengths), summed over the kernel's device time in them.

The traced requests are rungs 0 .. n - 1 of the first cycle, one each
(``kinds/prefill.py``); their lengths come from the traffic file of the
benchmark's prefill cell whose configuration's model is ``ctx["model"]``
(``gpubench/spec.py``), since ``ctx`` does not name the cell. None where
the trace holds no such kernel or no cell runs that model; it raises
where two prefill cells run it, as it cannot tell which one is running."""
import re

from gpubench import flops, inputs, spec
from gpubench.reference import mla_moe_lm

KERNEL = re.compile(r"::flash_fwd_mla_kernel\b")


def _traffic(model: dict):
    bench = spec.benchmark()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    found = []
    for w in bench["workloads"]:
        conf = spec.load_json(spec.ROOT / files[w["config"]])
        traffic = spec.load_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
        if conf["model"] == model and traffic["kind"] == "prefill":
            found.append(traffic)
    if len(found) > 1:
        raise LookupError(f"{len(found)} prefill cells run this model: "
                          "the traced lengths are ambiguous")
    return found[0] if found else None


def read(ctx):
    if "traced_requests" not in ctx or "kv_lora_rank" not in ctx["model"]:
        return None
    spent = sum(seconds for name, (seconds, _) in ctx["summary"].by_name.items()
                if KERNEL.search(name))
    traffic = _traffic(ctx["model"])
    if not spent or traffic is None:
        return None
    m, b = ctx["model"], traffic["batch"]
    peak = flops.bf16_peak(ctx["device_name"])
    bound = sum(max(mla_moe_lm.attention_flops(m, b, s) / peak,
                    mla_moe_lm.attention_bytes(m, b, s) / flops.HBM_BYTES_PER_S)
                for s in inputs.ladder(traffic["ladder"])[:ctx["traced_requests"]])
    return 100.0 * bound / spent
