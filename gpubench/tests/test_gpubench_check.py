"""The check of ``correct`` on the CPU at smoke sizes: the two references
agree with each other and with the program; each fault the cells can
have comes out not correct under the cells' own limits; the control (the
reference in float8 put in the program's place) comes out not correct
under the limits of f32 against f32. The control fails the cells' own
limits only at their sizes, where the error compounds over every layer:
``test_gpubench_card.py`` holds it to them on the card."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from gpubench import check, run, spec, weights
from gpubench.kinds import prefill, train
from gpubench.reference import moe_lm
from gpubench.tests import smoke

SEED = 2 ** 33 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Smoke cells held to the real cells' limits."""
    r = smoke.make_root(tmp_path_factory.mktemp("bench"))
    here = r / spec.HERE.name
    for small, real in (("smoke-train", "granite-moe-train-probe"),
                        ("smoke-prefill", "deepseek-moe-prefill-long"),
                        ("smoke-prefill-batch", "deepseek-moe-prefill-long")):
        (here / "cells" / f"{small}.json").write_text(
            (here / "cells" / f"{real}.json").read_text())
    return r


def _run(root, name, **fault):
    return run.run_cell(spec.cell(name, root), seed=SEED, seconds=0.5,
                        trace=False, device="cpu", **fault)


@pytest.mark.parametrize("name", ["smoke-train", "smoke-prefill",
                                  "smoke-prefill-batch"])
def test_sound_runs_are_correct(root, name):
    res = _run(root, name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    json.dumps(res)


def test_the_two_references_agree(root):
    """The layer-by-layer prefill reference's last-position logits equal
    the full forward's of the training reference."""
    cell = spec.cell("smoke-prefill", root)
    m = cell.config["model"]
    params = {}
    for group in weights.all_groups(cell.family, m, SEED, "cpu"):
        params.update({n: t.float() for n, t in group.items()})
    prompts = [torch.randint(0, m["vocab_size"], (s,)) for s in (17, 40)]
    last = prefill.reference_logits(cell, SEED, prompts, "cpu")
    for p, got in zip(prompts, last):
        x, _ = moe_lm.hidden(params, p[None], m)
        h = moe_lm.rms_norm(x[0, -1], params["ln_f"], m["norm_eps"])
        want = h @ moe_lm.head_weight(params, m)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_control_is_not_correct(root):
    cell = spec.cell("smoke-train", root)
    loop = train.Loop(cell, SEED, "cpu")
    train.program_record(loop)
    ctl = train.reference_record(cell, SEED, loop.rows, "cpu",
                                 precision="fp8")
    ctl["probe_change"] = train.reference_probe(cell.traffic, 128, SEED,
                                                ctl["pooled"], "cpu")
    ref = train.reference(cell, SEED, loop.rows, "cpu", ctl["pooled"])
    ok, report = check.judge(train.numbers(ctl, ref, cell.check)[0],
                             smoke.SMOKE_CHECKS["smoke-train"]["limits"])
    assert not ok, report


def test_prefill_control_is_not_correct(root):
    """The kind's own readings, at the smoke cell's checked requests:
    the program is correct under f32-against-f32 limits, the control
    not."""
    cell = spec.cell("smoke-prefill", root)
    smoke_cell = dataclasses.replace(cell, check=smoke.SMOKE_CHECKS[
        "smoke-prefill"])
    got = {who: nums for who, nums, _ in prefill.readings(
        smoke_cell, SEED, control=True, fault=False, device="cpu")}
    assert check.judge(got["program"], smoke_cell.check["limits"])[0]
    ok, report = check.judge(got["control"], smoke_cell.check["limits"])
    assert not ok, report


def _unchanged(step_fn):
    """A step that returns its state unchanged (its loss still reported)."""
    from repro_torch.training import train_step

    def step(state, batch, draws=None):
        with torch.no_grad():
            loss = train_step.lm_loss(state.params, batch,
                                      state.params.cfg)[0]
        return state, {"loss": loss}
    return step


def _half_batch(step_fn):
    """Half of the batch left out: the mean taken over the rest."""
    def step(state, batch, draws=None):
        half = batch["tokens"].shape[0] // 2
        return step_fn(state, {k: v[:half] for k, v in batch.items()}, draws)
    return step


def _altered_token(generate):
    """The served token altered where it is produced."""
    def gen(*args, **kw):
        out, logits = generate(*args, **kw)
        return (out + 1) % logits.shape[-1], logits
    return gen


def _long_prompts_only(fault, longer_than):
    """``fault`` on the requests whose prompts are longer than
    ``longer_than`` tokens; the others served soundly."""
    def wrap(generate):
        broken = fault(generate)

        def gen(model, cfg, toks, *args, **kw):
            fn = broken if toks.shape[1] > longer_than else generate
            return fn(model, cfg, toks, *args, **kw)
        return gen
    return wrap


def _skewed_logits(generate):
    """The logits bent where they are produced: one entry of each row
    raised by 8 standard deviations of the row, the token its argmax."""
    def gen(*args, **kw):
        out, logits = generate(*args, **kw)
        bent = logits.clone()
        bent[..., 7] += 8 * logits.std(-1)
        return bent.argmax(-1), bent
    return gen


@pytest.mark.parametrize("name,fault", [
    ("smoke-train", {"step_fault": _unchanged}),
    ("smoke-train", {"step_fault": _half_batch}),
    ("smoke-prefill", {"serve_fault": _altered_token}),
    ("smoke-prefill-batch", {"serve_fault": _altered_token}),
    ("smoke-prefill", {"serve_fault": _long_prompts_only(_altered_token,
                                                         100)}),
    ("smoke-prefill", {"serve_fault": _long_prompts_only(_skewed_logits,
                                                         100)}),
], ids=["state-unchanged", "half-batch", "token-altered",
        "token-altered-batch", "token-altered-longest-rung-only",
        "logits-skewed-longest-rung-only"])
def test_a_broken_timed_path_is_not_correct(root, name, fault):
    res = _run(root, name, **fault)
    assert not res["correct"], res["check"]


def test_a_fault_in_the_long_prompts_fails_their_band(root):
    """A fault confined to the longest rung fails the long band, and its
    rows, and only they, are counted off, while the short and middle bands
    still pass: a fault of some lengths does not hide under the others'
    medians."""
    res = _run(root, "smoke-prefill",
               serve_fault=_long_prompts_only(_altered_token, 100))
    bad = {k for k, r in res["check"].items() if not r["value"] <= r["limit"]}
    assert "token_gap.long" in bad, res["check"]
    checked = res["notes"]["rows"] // 4      # the longest of 4 rungs' rows
    assert res["check"]["rows_off"]["value"] == checked > 0
    assert not bad & {"token_gap.short", "logit_err.short",
                      "token_gap.middle", "logit_err.middle"}, res["check"]
