"""The ``prefill`` kind: one client in a closed loop sends requests of
``batch`` prompts of one length back to back through the program's
``serve_step.generate(max_new=1)`` (the prefill, then the first token's
argmax), with ``cache_len`` the prompts' length.

Prompt lengths come from a fixed ladder (quantiles of a log-uniform
distribution, ``inputs.ladder``); each cycle of as many requests sends
every rung once, in an order drawn from the seed, so every seed sees the
same lengths. The tokens are the Markov stream's, a pool of cycles drawn
in set-up. Set-up sends every rung once, which warms every shape the
window uses. A request's time to first token runs from its start to its
tokens on the host.

What decides ``correct`` (``numbers``): for each rung, ``checked_per_rung``
of its requests among the window's first ``checked_cycles`` cycles,
drawn from the seed, every prompt of each compared with the plain
reference's last-position logits. A row's token gap is the gap by which
its served token's reference logit lies below the reference's best; its
logit error the largest difference of a last-position logit, as a share
of the standard deviation of that row's reference logits. The ladder's
rungs fall into three bands of length (``BANDS``), each held on its own:

- ``token_gap.<band>``, ``logit_err.<band>``: the band's median of each;
- ``rows_off``: the rows, of every band, whose token gap or logit error
  exceeds its per-row limit (``per_row`` in the cell's file).

Medians, since bf16 hidden states flip MoE routing at near ties against
f32 and the flips compound over the layers in a few rows a run, so a
run's widest gap swings from seed to seed as far as the control's; the
bands keep a fault confined to some lengths from hiding under the others'
median, and ``rows_off`` a fault confined to a few rows, where it is
large.
"""
from __future__ import annotations

import statistics
import time

import torch

from gpubench import inputs, program, weights
from gpubench.reference import common

#: cycles of prompts drawn in set-up; later cycles send them again
POOL_CYCLES = 16
BANDS = ("short", "middle", "long")


class Client:
    def __init__(self, cell, seed: int, device):
        from repro_torch.serving import serve_step
        self.generate = serve_step.generate
        self.cell, self.traffic, self.seed = cell, cell.traffic, seed
        self.batch = self.traffic["batch"]
        self.device = torch.device(device)
        self.cfg = program.model_config(cell.config)
        model = program.build_model(self.cfg, self.device)
        weights.fill(cell.family, cell.config["model"],
                     dict(model.named_parameters()), seed)
        self.model = model
        self.ladder = inputs.ladder(self.traffic["ladder"])
        stream = inputs.TokenStream(seed, cell.config["model"]["vocab_size"])
        self.pool = []
        for _ in range(POOL_CYCLES):
            rows = stream.rows(len(self.ladder) * self.batch, max(self.ladder))
            if self.device.type == "cuda":
                rows = rows.pin_memory()
            self.pool.append(rows)

    def rung_of(self, i: int) -> int:
        cycle, j = divmod(i, len(self.ladder))
        return inputs.permutation(self.seed, len(self.ladder), cycle)[j]

    def prompts(self, i: int) -> torch.Tensor:
        """Request ``i``'s prompts, (batch, S) int32 on the host."""
        return self.rung_prompts(i // len(self.ladder), self.rung_of(i))

    def rung_prompts(self, cycle: int, rung: int) -> torch.Tensor:
        b = self.batch
        return self.pool[cycle % POOL_CYCLES][rung * b:(rung + 1) * b,
                                              :self.ladder[rung]]

    def send(self, prompts: torch.Tensor):
        """One request: (its tokens on the host, its (batch, V) logits on
        the device)."""
        toks = prompts.to(self.device, non_blocking=True)
        out, logits = self.generate(self.model, self.cfg, toks,
                                    max_new=self.traffic["max_new"],
                                    cache_len=toks.shape[1],
                                    return_logits=True)
        return out[:, 0].tolist(), logits[:, 0]


def checked_requests(seed: int, traffic: dict, rungs: int) -> dict:
    """{request index: rung} of the requests the check compares: for each
    rung, ``checked_per_rung`` distinct cycles among the first
    ``checked_cycles`` (which every window finishes), drawn from the
    seed."""
    g = torch.Generator().manual_seed(inputs.mix64(seed, 0x43484B))
    out = {}
    for rung in range(rungs):
        cycles = torch.randperm(traffic["checked_cycles"], generator=g)
        for c in cycles[:traffic["checked_per_rung"]].tolist():
            j = inputs.permutation(seed, rungs, c).index(rung)
            out[c * rungs + j] = rung
    return out


def band_of(rung: int, rungs: int) -> str:
    return BANDS[rung * len(BANDS) // rungs]


def reference_logits(cell, seed: int, prompts: list, device,
                     precision: str = "f32") -> torch.Tensor:
    """(R, V) last-position logits of ``prompts`` from the plain reference,
    layer by layer on weights made again from the seed."""
    m, family = cell.config["model"], cell.family

    def weights_of(group):
        return {n: t.float() for n, t in
                weights.make_group(family, m, group, seed, device).items()}

    with common.exact_f32():
        return family.last_logits(weights_of, [p.to(device) for p in prompts],
                                  m, common.Precision(precision))


def row_errors(rows: list, ref_logits) -> tuple[list, list]:
    """Each served row's token gap and logit error against the reference's
    (R, V) last-position logits."""
    gaps, errs = [], []
    for (prompt, served, logits, rung), ref in zip(
            rows, ref_logits.cpu() if rows else []):
        gaps.append(float(ref.max() - ref[served]))
        errs.append(float((logits - ref).abs().max() / ref.std()))
    return gaps, errs


def numbers(program_out: dict, ref_logits, check_conf: dict
            ) -> tuple[dict, dict]:
    """(numbers, notes) of the served rows (``program_out["rows"]``:
    (prompt, token, logits, rung)) against the reference's (R, V)
    last-position logits."""
    rows, rungs = program_out["rows"], program_out["rungs"]
    per_row = check_conf["per_row"]
    gaps, errs = row_errors(rows, ref_logits)
    bands = [band_of(r[3], rungs) for r in rows]
    nums = {}
    for band in BANDS:
        mine = [k for k, b in enumerate(bands) if b == band]
        for name, vals in (("token_gap", gaps), ("logit_err", errs)):
            nums[f"{name}.{band}"] = (statistics.median(vals[k] for k in mine)
                                      if mine else float("inf"))
    off = [k for k in range(len(rows)) if gaps[k] > per_row["token_gap"]
           or errs[k] > per_row["logit_err"]]
    nums["rows_off"] = float(len(off)) if rows else float("inf")
    notes = {"rows": len(rows), "widest_gap": max(gaps, default=None),
             "widest_err": max(errs, default=None),
             "longest": max((len(r[0]) for r in rows), default=None),
             "off": [[len(rows[k][0]), round(gaps[k], 4), round(errs[k], 4)]
                     for k in off]}
    return nums, notes


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        serve_fault=None) -> dict:
    """One run of a prefill cell. ``serve_fault``, given by a test, wraps
    the program's ``generate``."""
    traffic, m = cell.traffic, cell.config["model"]
    client = Client(cell, seed, device)
    if serve_fault is not None:
        client.generate = serve_fault(client.generate)
    for rung in range(len(client.ladder)):            # every shape once
        client.send(client.rung_prompts(0, rung))
    checked = checked_requests(seed, traffic, len(client.ladder))
    t_setup_done = time.perf_counter()
    ttft, kept, i = [], {}, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        prompts = client.prompts(i)
        t_req = time.perf_counter()
        served, logits = client.send(prompts)
        ttft.append(time.perf_counter() - t_req)
        if i in checked:
            kept[i] = (prompts, served, logits)
        i += 1
    window = time.perf_counter() - t0
    prefill = sum(client.batch * cell.family.prefill_flops(
        m, client.ladder[client.rung_of(k)]) for k in range(i))
    out = {"setup_done": t_setup_done, "attempted": i, "failed": 0,
           "e2e": {"ttft_ms_p95": 1e3 * statistics.quantiles(
                       ttft, n=100, method="inclusive")[94]},
           "ctx": {"requests": i, "window_s": window, "model_flops": prefill}}
    if trace:
        from gpubench import trace as trace_lib
        n = traffic["trace_requests"]
        with trace_lib.ranges(program.layer_ranges(cell.config)):
            _, summary = trace_lib.profile(
                lambda: [client.send(client.rung_prompts(0, r))
                         for r in range(n)])
        out["ctx"].update(summary=summary, traced_requests=n)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if client.device.type == "cuda" else 0)
    rungs = len(client.ladder)
    del client
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rows = []
    for k in sorted(kept):
        prompts, served, logits = kept[k]
        logits = logits.float().cpu()
        rows += [(prompts[r], served[r], logits[r], checked[k])
                 for r in range(prompts.shape[0])]
    out["program"] = {"rows": rows, "rungs": rungs}
    out["reference"] = lambda: (reference_logits(
        cell, seed, [r[0] for r in rows], device) if rows else None)
    return out


def readings(cell, seed: int, control: bool, fault: bool, device="cuda"):
    """[(who, numbers, notes)] of one seed at the cell's own size: the
    program's rows of the requests a run checks, and with ``control`` the
    reference in float8 put in the program's place on the same prompts."""
    del fault
    client = Client(cell, seed, device)
    checked = checked_requests(seed, cell.traffic, len(client.ladder))
    rows = []
    for k in sorted(checked):
        prompts = client.prompts(k)
        served, logits = client.send(prompts)
        logits = logits.float().cpu()
        rows += [(prompts[r], served[r], logits[r], checked[k])
                 for r in range(prompts.shape[0])]
    rungs = len(client.ladder)
    del client
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    prompts = [r[0] for r in rows]
    ref = reference_logits(cell, seed, prompts, device)

    def reading(who, judged):
        nums, notes = numbers({"rows": judged, "rungs": rungs}, ref,
                              cell.check)
        gaps, errs = row_errors(judged, ref)
        notes["per_row"] = [[len(r[0]), round(g, 5), round(e, 5)]
                            for r, g, e in zip(judged, gaps, errs)]
        return who, nums, notes

    out = [reading("program", rows)]
    if control:
        ctl = reference_logits(cell, seed, prompts, device,
                               precision="fp8").cpu()
        out.append(reading("control", [(p, int(lg.argmax()), lg, r[3])
                                       for p, lg, r in zip(prompts, ctl,
                                                           rows)]))
    return out
