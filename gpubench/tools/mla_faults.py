"""The readings an MLA prefill cell's limits are set from, on the card at the
cell's own size, all from one weight fill and one reference a seed: the
program's checked rows as a run checks them, the control's (the reference
in float8 in the program's place) and the program's with one fault planted
in its latent attention at a time:

- ``rope_off_kpe``: k_pe left unrotated;
- ``norm_skipped``: c_kv not RMS-normed;
- ``no_m2``: the softmax scale without YaRN's mscale^2.

    python3 gpubench/tools/mla_faults.py --workload deepseek-v2-lite-prefill-long \\
        --seeds 2 [--first-seed N]

One JSON line a reading on standard output, as ``calibrate.py`` prints.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from gpubench import inputs, spec  # noqa: E402


def _faults():
    """name -> (attribute of ``repro_torch.models.attention``, its faulty
    stand-in)."""
    from repro_torch.models import attention
    from repro_torch.models.common import dense
    real_rows = attention.latent_rows

    def rope_off_kpe(p, x, positions, cfg):
        ckv, _ = real_rows(p, x, positions, cfg)
        return ckv, dense(x, p.wkva)[..., cfg.kv_lora_rank:]

    def norm_skipped(p, x, positions, cfg):
        _, kpe = real_rows(p, x, positions, cfg)
        return dense(x, p.wkva)[..., :cfg.kv_lora_rank], kpe

    def no_m2(cfg):
        return cfg.qk_head_dim ** -0.5

    return {"rope_off_kpe": ("latent_rows", rope_off_kpe),
            "norm_skipped": ("latent_rows", norm_skipped),
            "no_m2": ("mla_scale", no_m2)}


@contextlib.contextmanager
def planted(attr: str, fn):
    """``repro_torch.models.attention.<attr>`` replaced by ``fn`` inside."""
    from repro_torch.models import attention
    real = getattr(attention, attr)
    setattr(attention, attr, fn)
    try:
        yield
    finally:
        setattr(attention, attr, real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 33333)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    kind = cell.kind
    for n in range(args.seeds):
        seed = inputs.mix64(args.first_seed, n) % (2 ** 33)
        t0 = time.perf_counter()
        client = kind.Client(cell, seed, "cuda")
        checked = kind.checked_requests(seed, cell.traffic, len(client.ladder))
        runs = {"program": contextlib.nullcontext()}
        runs.update((name, planted(attr, fn))
                    for name, (attr, fn) in _faults().items())
        served = {}
        for who, ctx in runs.items():
            rows = []
            with ctx:
                for k in sorted(checked):
                    prompts = client.prompts(k)
                    tokens, logits = client.send(prompts)
                    logits = logits.float().cpu()
                    rows += [(prompts[r], tokens[r], logits[r], checked[k])
                             for r in range(prompts.shape[0])]
            served[who] = rows
        rungs = len(client.ladder)
        del client
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        prompts = [r[0] for r in served["program"]]
        ref = kind.reference_logits(cell, seed, prompts, "cuda")
        ctl = kind.reference_logits(cell, seed, prompts, "cuda",
                                    precision="fp8").cpu()
        served["control"] = [(p, int(lg.argmax()), lg, r[3])
                             for p, lg, r in zip(prompts, ctl,
                                                 served["program"])]
        for who, rows in served.items():
            nums, notes = kind.numbers({"rows": rows, "rungs": rungs}, ref,
                                       cell.check)
            gaps, errs = kind.row_errors(rows, ref)
            notes["per_row"] = [[len(r[0]), round(g, 5), round(e, 5)]
                                for r, g, e in zip(rows, gaps, errs)]
            print(json.dumps({"seed": seed, "who": who, "numbers": nums,
                              "notes": notes,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
