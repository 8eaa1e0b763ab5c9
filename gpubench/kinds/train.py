"""The ``train`` kind: a closed loop of the program's train step with the
AFM probe, back to back, the next batch made while the card runs a step
(as ``repro_torch.launch.train.run`` does).

Set-up builds one training state (the seeded weights written into the
program's parameters by name, zero moments, the probe's seeded map) and
drives it through the first ``checked_steps`` steps by the window's own
call and feed; the reference follows those steps after the window. The
window then runs the same state on, step after step, for ``--seconds``.

What decides ``correct`` (``numbers``), of the checked steps:

- ``grad``: the worst leaf's gap between the norms of the first gradient
  as the optimizer took it, program against reference;
- ``change``: the worst leaf's gap between the norms of its change over
  the checked steps;
- ``pooled``: the largest difference of a step's pooled hidden states
  (the probe's input), as a share of the reference's (Frobenius norms);
- ``probe``: the gap between the norms of the probe map's change, the
  reference's probe fed the vectors the program's probe took.

The largest gap of a step's loss is reported beside them (``loss`` in the
notes) and not compared: no control or fault separates it from sound runs.
A leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger. Leaves whose reference gradient is
under ``ROUND_OFF_SHARE`` of the median leaf's are left out of
``grad`` and ``change``.

The model is the configuration's family (``cell.family``): its weights,
loss and FLOPs come from its reference module.
"""
from __future__ import annotations

import statistics
import time

import torch

from gpubench import inputs, program, weights
from gpubench.reference import afm_probe, common

#: leaves whose reference gradient is under this share of the median
#: leaf's are left out of a training cell's leaf gaps (they move under
#: Adam by round-off alone)
ROUND_OFF_SHARE = 1e-3


def _leaf_gap(p: dict, r: dict, keep: list) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm ``p[n]`` and the
    reference's ``r[n]``, against the reference's norm of that leaf or of
    the median leaf, whichever is larger; and that leaf."""
    med = statistics.median(r[n] for n in keep)
    gaps = {n: abs(p[n] - r[n]) / max(r[n], med) for n in keep}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _gap(a: float, b: float) -> float:
    """|a - b| / b; where b is 0, 0 if a is too, else infinite."""
    return abs(a - b) / b if b else (0.0 if a == b else float("inf"))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def probe_map(seed: int, side: int, dim: int, device) -> torch.Tensor:
    """The probe's first map, (side^2, dim) f32, N(0, 0.1^2)."""
    g = torch.Generator(device=device)
    g.manual_seed(inputs.mix64(seed, 0x4D4150))
    return 0.1 * torch.randn((side * side, dim), generator=g, device=device)


def probe_settings(traffic: dict, dim: int) -> dict:
    return {**traffic["probe"], "dim": dim}


class Loop:
    """The program's state and its step, fed from the run's token stream
    and draw sources."""

    def __init__(self, cell, seed: int, device, traffic: dict | None = None):
        from repro_torch.core import probe as probe_lib
        from repro_torch.training.adamw import AdamWConfig, adamw_init
        from repro_torch.training.train_step import (TrainState,
                                                     make_train_step)
        traffic = cell.traffic if traffic is None else traffic
        self.cell, self.m = cell, cell.config["model"]
        self.traffic, self.seed = traffic, seed
        self.device = torch.device(device)
        cfg = program.model_config(cell.config)
        model = program.build_model(cfg, self.device)
        params = dict(model.named_parameters())
        weights.fill(cell.family, self.m, params, seed)
        model.requires_grad_(True)
        pcfg = probe_lib.ProbeConfig(**probe_settings(traffic, cfg.d_model))
        probe = probe_lib.init(inputs.SeededDraws(inputs.mix64(seed, 0x4C4E4B),
                                                  self.device), pcfg,
                               device=self.device)
        w0 = probe_map(seed, pcfg.side, pcfg.dim, self.device)
        probe = probe_lib.ProbeState(probe.afm._replace(w=w0))
        self.state = TrainState(model, adamw_init(params),
                                torch.zeros((), dtype=torch.int32,
                                            device=self.device), probe)
        self.step_fn = make_train_step(cfg, AdamWConfig(**traffic["optimizer"]),
                                       pcfg)
        self.stream = inputs.TokenStream(seed, self.m["vocab_size"])
        self.steps = 0
        self.rows = []          # the checked steps' tokens, on the host
        self.nxt = self._batch()

    def _batch(self) -> dict:
        toks = self.stream.rows(self.traffic["batch"], self.traffic["seq"])
        if self.steps < self.traffic["checked_steps"]:
            self.rows.append(toks)
        if self.device.type == "cuda":
            toks = toks.pin_memory().to(self.device, non_blocking=True)
        return {"tokens": toks, "labels": toks}

    def step(self) -> dict:
        draws = inputs.step_draws(self.seed, self.steps, self.device)
        self.state, metrics = self.step_fn(self.state, self.nxt, draws)
        self.steps += 1
        self.nxt = self._batch()
        return metrics


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@torch.no_grad()
def _change_norms(family, m: dict, params: dict, seed: int) -> dict:
    """Each leaf's ``|p - p0|``, p0 the seeded first weights made again."""
    device = next(iter(params.values())).device
    out = {}
    for group in weights.all_groups(family, m, seed, device):
        for name, p0 in group.items():
            out[name] = float(torch.linalg.vector_norm(
                params[name].float() - p0.float()))
    return out


def program_record(loop: Loop) -> dict:
    """Drives set-up's checked steps and reads from the program's own
    state what the check compares: each step's loss, each leaf's first
    gradient as the optimizer took it (its first moment after step 1 over
    1 - b1), each leaf's change after the last checked step, the vectors
    the probe was fed each step (the pooled hidden states, caught at
    ``core.probe.update`` for these steps only) and the probe map's
    change."""
    from repro_torch.core import probe as probe_lib
    b1 = loop.traffic["optimizer"]["b1"]
    losses, grad_norms, pooled = [], {}, []
    update = probe_lib.update

    def caught(state, vectors, draws, cfg):
        pooled.append(vectors.detach().float().cpu())
        return update(state, vectors, draws, cfg)

    probe_lib.update = caught
    try:
        for k in range(loop.traffic["checked_steps"]):
            losses.append(loop.step()["loss"])
            if k == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(mu)
                                       / (1 - b1))
                              for n, mu in loop.state.opt.mu.items()}
    finally:
        probe_lib.update = update
    params = dict(loop.state.params.named_parameters())
    pcfg = loop.traffic["probe"]
    w0 = probe_map(loop.seed, pcfg["side"], loop.m["d_model"], loop.device)
    return {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
            "change_norms": _change_norms(loop.cell.family, loop.m, params,
                                          loop.seed),
            "pooled": pooled,
            "probe_change": float(torch.linalg.vector_norm(
                loop.state.probe.afm.w - w0))}


def reference_record(cell, seed: int, rows: list, device,
                     precision: str = "f32") -> dict:
    """What ``program_record`` reads of the model, from the plain reference
    in ``precision``, on the same weights and tokens: the losses, the
    first gradients' and the changes' norms, and each step's pooled
    hidden states (the vectors the probe would be fed)."""
    m, family = cell.config["model"], cell.family
    prec = common.Precision(precision)
    opt = cell.traffic["optimizer"]
    with common.exact_f32():
        params = {}
        for group in weights.all_groups(family, m, seed, device):
            for name, t in group.items():
                params[name] = t.float().requires_grad_(True)
        p0 = {n: p.detach().clone() for n, p in params.items()}
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, grad_norms, pooled = [], {}, []
        for k, toks in enumerate(rows):
            loss, _, _, hid = family.loss(params, toks.to(device), m, prec)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            pooled.append(hid.detach().mean(1).cpu())
            del hid, loss
            common.adamw(params, grads, mu, nu, k + 1, opt)
            del grads
            if k == 0:
                grad_norms = {n: float(torch.linalg.vector_norm(v)
                                       / (1 - opt["b1"]))
                              for n, v in mu.items()}
        change = {n: float(torch.linalg.vector_norm(params[n].detach() - p0[n]))
                  for n in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "pooled": pooled}


def reference_probe(traffic: dict, dim: int, seed: int, pooled: list,
                    device) -> float:
    """The frozen plain probe, from the seeded map and the step draws,
    fed ``pooled`` (each checked step's vectors): the norm of the map's
    change. The check feeds it the vectors the program's probe took, so
    it follows the probe stage from the program's own input."""
    pcfg = probe_settings(traffic, dim)
    with common.exact_f32():
        w = probe_map(seed, pcfg["side"], dim, device)
        w0 = w.clone()
        c = torch.zeros(pcfg["side"] ** 2, dtype=torch.int32, device=device)
        for k, vectors in enumerate(pooled):
            w, c, _ = afm_probe.step(
                w, c, vectors.to(device), inputs.step_draws(seed, k, device),
                pcfg, i=k * traffic["batch"],
                block_draws=torch.device(device).type == "cuda")
        return float(torch.linalg.vector_norm(w - w0))


def reference(cell, seed: int, rows: list, device, pooled: list) -> dict:
    """The f32 reference's record, with the probe stage fed ``pooled``."""
    ref = reference_record(cell, seed, rows, device)
    ref["probe_change"] = reference_probe(
        cell.traffic, cell.config["model"]["d_model"], seed, pooled, device)
    return ref


def numbers(p: dict, r: dict, check_conf: dict) -> tuple[dict, dict]:
    """(numbers, notes): the four numbers; the worst leaves and the
    losses."""
    del check_conf
    med = statistics.median(r["grad_norms"].values())
    keep = [n for n, g in r["grad_norms"].items()
            if g >= ROUND_OFF_SHARE * med]
    grad, grad_leaf = _leaf_gap(p["grad_norms"], r["grad_norms"], keep)
    change, change_leaf = _leaf_gap(p["change_norms"],
                                         r["change_norms"], keep)
    loss = max(abs(a - b) / abs(b) for a, b in zip(p["losses"], r["losses"]))
    pooled = (max(_rel(a, b) for a, b in zip(p["pooled"], r["pooled"]))
              if len(p["pooled"]) == len(r["pooled"])
              and all(a.shape == b.shape for a, b in zip(p["pooled"],
                                                          r["pooled"]))
              else float("inf"))
    probe = _gap(p["probe_change"], r["probe_change"])
    return ({"grad": grad, "change": change, "pooled": pooled,
             "probe": probe},
            {"loss": loss, "grad_leaf": grad_leaf, "change_leaf": change_leaf,
             "leaves_left_out": len(r["grad_norms"]) - len(keep),
             "losses": p["losses"], "ref_losses": r["losses"]})


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        step_fault=None) -> dict:
    """One run of a train cell: set-up with its checked steps, the window,
    and with ``trace`` a profiled stretch of ``trace_steps`` steps after
    it. ``step_fault``, given by a test, wraps the program's step."""
    traffic = cell.traffic
    loop = Loop(cell, seed, device)
    if step_fault is not None:
        loop.step_fn = step_fault(loop.step_fn)
    record = program_record(loop)
    _sync(device)
    t_setup_done = time.perf_counter()
    t0, n0 = time.perf_counter(), loop.steps
    while True:
        loop.step()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window = time.perf_counter() - t0
    steps = loop.steps - n0
    tokens = steps * traffic["batch"] * traffic["seq"]
    out = {"setup_done": t_setup_done, "attempted": steps, "failed": 0,
           "e2e": {"train_tokens_per_s": tokens / window},
           "ctx": {"steps": steps, "window_s": window,
                   "model_flops": steps * cell.family.train_step_flops(
                       cell.config["model"], traffic["batch"],
                       traffic["seq"]),
                   "probe": probe_settings(traffic, cell.config["model"]
                                           ["d_model"]),
                   "batch": traffic["batch"]}}
    if trace:
        from gpubench import trace as trace_lib
        n = traffic["trace_steps"]
        _, summary = trace_lib.profile(lambda: [loop.step() for _ in range(n)])
        out["ctx"].update(summary=summary, traced_steps=n)
    rows = loop.rows
    out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                         if torch.device(device).type == "cuda" else 0)
    del loop
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["program"] = record
    out["reference"] = lambda: reference(cell, seed, rows, device,
                                         record["pooled"])
    return out


def half_batch(step_fn):
    """A fault: the step sees the first half of the batch's rows, the mean
    taken over them."""
    def step(state, batch, draws=None):
        half = batch["tokens"].shape[0] // 2
        return step_fn(state, {k: v[:half] for k, v in batch.items()}, draws)
    return step


def _free(device) -> None:
    _sync(device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def readings(cell, seed: int, control: bool, fault: bool, device="cuda"):
    """[(who, numbers, notes)] of one seed at the cell's own size: the
    program's; with ``control`` the reference in float8 put in its place;
    with ``fault`` the program with half of each batch left out (a state
    left unchanged reads 1 by the measure and needs no run)."""
    d = cell.config["model"]["d_model"]
    loop = Loop(cell, seed, device)
    rec = program_record(loop)
    rows = loop.rows
    del loop
    _free(device)
    ref = reference_record(cell, seed, rows, device)

    def judged(record):
        """The f32 reference, its probe fed ``record``'s vectors."""
        probe = reference_probe(cell.traffic, d, seed, record["pooled"],
                                device)
        return {**ref, "probe_change": probe}

    out = [("program", *numbers(rec, judged(rec), cell.check))]
    if control:
        ctl = reference_record(cell, seed, rows, device, precision="fp8")
        ctl["probe_change"] = reference_probe(cell.traffic, d, seed,
                                              ctl["pooled"], device)
        out.append(("control", *numbers(ctl, judged(ctl), cell.check)))
    if fault:
        loop = Loop(cell, seed, device)
        loop.step_fn = half_batch(loop.step_fn)
        bad = program_record(loop)
        del loop
        _free(device)
        out.append(("half_batch", *numbers(bad, judged(bad), cell.check)))
    return out
