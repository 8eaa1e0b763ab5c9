"""Multi-head latent attention with YaRN (DeepSeek-V2-Lite, a port-only
config) on the CPU: its config and registration, YaRN's frequencies and
softmax scale against the published formulas, the plain version of the
192/128 flash forward against plain attention, prefill and decode through
the latent cache against the benchmark's plain reference
(``gpubench/reference/mla_moe_lm.py``) on seeded weights, the route that
keeps training off the forward-only kernel, the ``mla_latent`` span and
the latent-cache counter, and the harness's new cell.

Tolerances: the program and the reference both run in f32 on the smoke
config, with the same products summed in other orders (the program's
blocked flash-style plain forward and its absorbed decode against the
reference's one softmax over each query block), so logits agree to some
f32 ulps of their size: 2e-5 of the largest logit.
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import inputs, program, spec, weights  # noqa: E402
from gpubench.reference import mla_moe_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import spans  # noqa: E402
from repro_torch.kernels.flash import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash import ref as flash_ref  # noqa: E402
from repro_torch.models import attention, rope, transformer  # noqa: E402
from repro_torch.models.common import MLAConfig  # noqa: E402
from repro_torch.serving import serve_step  # noqa: E402

ARCH = "deepseek-v2-lite"
CONFIG_FILE = ROOT / "gpubench" / "configs" / f"{ARCH}.json"
CELL = "deepseek-v2-lite-prefill-long"
LOGIT_TOL = 2e-5
SEED = 2 ** 33 + 7
PROMPT = 256


def _model_block(cfg) -> dict:
    """The configuration file's ``model`` block with the smoke config's
    geometry, in f32."""
    m = dict(spec.load_json(CONFIG_FILE)["model"])
    for key in m:
        if key not in ("dtype", "param_dtype"):
            m[key] = getattr(cfg, key)
    return {**m, "dtype": "float32", "param_dtype": "float32"}


@pytest.fixture(scope="module")
def smoke():
    """(cfg, model block, model on the CPU with the seeded weights)."""
    cfg = dataclasses.replace(configs.get_smoke(ARCH), moe_impl="ragged")
    m = _model_block(cfg)
    model = transformer.Transformer(cfg, "cpu")
    weights.fill(mla_moe_lm, m, dict(model.named_parameters()), SEED)
    return cfg, m, model


def _reference(m, prompts):
    def weights_of(group):
        return {n: t.float() for n, t in
                weights.make_group(mla_moe_lm, m, group, SEED, "cpu").items()}
    return mla_moe_lm.last_logits(weights_of, prompts, m)


def _prompts(cfg, n, s, seed=1):
    return torch.randint(0, cfg.vocab_size, (n, s),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= LOGIT_TOL * float(want.abs().max()), err


# ---------------------------------------------------------------------------
# config


def test_config_is_registered_beside_jax_s_list():
    """Reached by name through ``PORT_ONLY`` and kept out of ``ARCHS``
    and ``ALIASES`` (which hold JAX's lists); an ``MLAConfig`` at the
    published widths, whose smoke config keeps a dense layer, at least
    three layers and YaRN over a 64-token original window."""
    cfg = configs.get(ARCH)
    assert isinstance(cfg, MLAConfig) and cfg.attention_kind == "mla"
    assert configs.PORT_ONLY[ARCH] == "deepseek_v2_lite"
    assert "deepseek_v2_lite" not in configs.ARCHS
    assert ARCH not in configs.ALIASES
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim,
            cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts,
            cfg.moe_d_ff, cfg.first_dense_d_ff, cfg.vocab_size) == (
                27, 2048, 16, 512, 128, 64, 128, 64, 6, 2, 1408, 10944,
                102400)
    smoke = configs.get_smoke(ARCH)
    assert smoke.num_layers >= 3 and smoke.first_dense_layers == 1
    assert smoke.yarn_original_max_positions == 64 < PROMPT
    assert smoke.dtype == torch.float32
    # every other config keeps the plain ModelConfig and its attention
    assert configs.get("deepseek-moe-16b").attention_kind == "gqa"
    assert not hasattr(configs.get("deepseek-moe-16b"), "kv_lora_rank")


def test_yarn_frequencies_and_scale_match_the_formulas():
    """DeepSeek-V2-Lite's 32 rotated pairs: the correction range of beta
    32 and 1 over 4,096 positions is dims 10..23 (floor 10.47, ceil
    22.51); below it theta^(-2i/64), above it that over 40, a linear ramp
    between. cos and sin keep a factor of 1 (mscale = mscale_all_dim), and
    the softmax scale is 192^-1/2 (1 + 0.0707 ln 40)^2 = 0.114721."""
    cfg = configs.get(ARCH)
    freqs, factor = attention._mla_rotation(cfg, torch.device("cpu"))
    plain = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    want = []
    for i in range(32):
        ramp = min(max((i - 10) / (23 - 10), 0.0), 1.0)
        want.append(float(plain[i]) / 40 * ramp + float(plain[i]) * (1 - ramp))
    assert torch.allclose(freqs.double(), torch.tensor(want,
                                                       dtype=torch.float64),
                          rtol=1e-6, atol=0)
    assert 64 * math.log(4096 / (32 * 2 * math.pi)) / (
        2 * math.log(10000)) == pytest.approx(10.47, abs=0.01)
    assert factor == 1.0
    assert attention.mla_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    m2 = (1 + 0.1 * 0.707 * math.log(40)) ** 2
    assert m2 == pytest.approx(1.58963, abs=1e-5)
    assert attention.mla_scale(cfg) == pytest.approx(192 ** -0.5 * m2,
                                                     rel=1e-12)
    # the reference's own formulas give the same numbers
    m = spec.load_json(CONFIG_FILE)["model"]
    assert torch.allclose(mla_moe_lm.yarn_frequencies(m, "cpu"), freqs)
    assert mla_moe_lm.softmax_scale(m) == attention.mla_scale(cfg)


def test_rope_pairs_rotate_each_pair_in_place():
    """``apply_rope_pairs`` returns the halves layout of pairs (2i, 2i + 1)
    rotated by pos x f_i: products of two such vectors equal those of the
    pairs rotated in place, and the dot product of two rotated vectors
    depends on the positions' difference alone."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 5, 2, 8, generator=gen, dtype=torch.float64)
    freqs = torch.tensor([1.0, 0.3, 0.05, 0.002], dtype=torch.float64)
    pos = torch.arange(5)[None] * 7
    got = rope.apply_rope_pairs(x, pos, freqs)
    ang = pos[0, :, None].double() * freqs
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x0, x1 = x[0, ..., 0::2], x[0, ..., 1::2]
    want = torch.cat([x0 * c - x1 * s, x1 * c + x0 * s], -1)
    assert torch.allclose(got[0], want, atol=1e-12)
    y = torch.randn(1, 1, 1, 8, generator=gen, dtype=torch.float64)
    dots = [float((rope.apply_rope_pairs(y, torch.tensor([[p + 3]]), freqs)
                   * rope.apply_rope_pairs(y, torch.tensor([[p]]),
                                           freqs)).sum())
            for p in (0, 11, 400)]
    assert max(dots) - min(dots) < 1e-9


# ---------------------------------------------------------------------------
# the 192/128 forward's plain version


@pytest.mark.parametrize("b,s,h,hkv", [(1, 130, 2, 2), (2, 70, 4, 1)])
def test_plain_mla_forward_matches_plain_attention(b, s, h, hkv):
    """``ref.flash_forward_ref`` with q and k at 192, v at 128 and a given
    scale against one causal softmax in f64: within 2e-6 of the output's
    size in f32 (the online rescale sums in another order); the wrapper
    on the CPU is that plain version; it refuses a call that needs a
    gradient and head dims other than 192/128."""
    gen = torch.Generator().manual_seed(s)
    q = torch.randn(b, s, h, 192, generator=gen)
    k = torch.randn(b, s, hkv, 192, generator=gen)
    v = torch.randn(b, s, hkv, 128, generator=gen)
    scale = 0.114721
    out, lse = flash_ref.flash_forward_ref(q, k, v, scale=scale)
    rep = h // hkv
    kd, vd = (x.double().repeat_interleave(rep, 2) for x in (k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) * scale
    past = torch.ones(s, s, dtype=torch.bool).triu(1)
    logits = logits.masked_fill(past, -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vd)
    assert out.shape == (b, s, h, 128)
    assert float((out.double() - want).abs().max()) <= 2e-6 * float(
        want.abs().max())
    assert torch.allclose(lse.double(), torch.logsumexp(logits, -1),
                          atol=1e-5)
    assert torch.equal(flash_ops.flash_forward_mla(q, k, v, scale), out)
    with pytest.raises(ValueError, match="no backward"):
        flash_ops.flash_forward_mla(q.requires_grad_(), k, v, scale)
    with pytest.raises(ValueError, match="head dims"):
        flash_ops.flash_forward_mla(q[..., :128].detach(), k[..., :128], v,
                                    scale)
    assert flash_ops.mla_flops(b, s, h, 192, 128) == (
        2 * b * h * 320 * s * (s + 1) // 2)


def test_route_keeps_training_off_the_forward_only_kernel():
    """On the card latent attention's bf16 heads take the 192/128 kernel
    only where no gradient is needed; other widths keep their path."""
    base = dict(device_type="cuda", dtype=torch.bfloat16, causal=True,
                window=0, hd=192, impl="naive", dtensor=False, padded=False,
                hd_v=128)
    assert attention.flash_route(**base) is True
    assert attention.flash_route(**base, grad=True) is False
    assert attention.flash_route(**{**base, "hd_v": 64}) is False
    assert attention.flash_route(**{**base, "device_type": "cpu"}) is False
    assert attention.flash_route(**{**base, "window": 16}) is False


def test_self_attention_wires_the_mla_kernel(monkeypatch, smoke):
    """With the route forced open on the CPU, a call that needs no
    gradient hands the forward-only op q and k of nope + rope and v of v
    heads at ``mla_scale``; one that needs a gradient keeps ``_attend``."""
    cfg, _, _ = smoke
    wide = dataclasses.replace(cfg, qk_nope_head_dim=128,
                               qk_rope_head_dim=64, v_head_dim=128,
                               dtype=torch.bfloat16,
                               param_dtype=torch.bfloat16)
    p = attention.LatentAttention(wide)
    p.reset_parameters(torch.Generator().manual_seed(1), wide)
    x = torch.randn(1, 20, wide.d_model).bfloat16()
    pos = torch.arange(20)[None]
    calls = []
    real = flash_ops.flash_forward_mla

    def spy(q, k, v, scale):
        calls.append((q.shape, k.shape, v.shape, scale))
        return real(q, k, v, scale)

    route = attention.flash_route
    monkeypatch.setattr(flash_ops, "flash_forward_mla", spy)
    monkeypatch.setattr(attention, "flash_route",
                        lambda device_type, *a, **kw: route("cuda", *a, **kw))
    with torch.no_grad():
        attention.mla_self_attention(p, x, pos, wide)
    assert calls == [((1, 20, 4, 192), (1, 20, 4, 192), (1, 20, 4, 128),
                      attention.mla_scale(wide))]
    xx = x.clone().requires_grad_()
    got, _ = attention.mla_self_attention(p, xx, pos, wide)
    assert len(calls) == 1
    got.sum().backward()
    assert xx.grad is not None and bool(torch.isfinite(xx.grad).all())


# ---------------------------------------------------------------------------
# prefill and decode against the reference


def test_prefill_matches_the_reference(smoke):
    """``transformer.prefill`` of 256-token prompts (past YaRN's 64-token
    original window) on seeded weights: last logits against the plain
    reference's; its cache holds ``ckv`` and ``kpe`` alone, rank + rope
    values a token a layer."""
    cfg, m, model = smoke
    toks = _prompts(cfg, 2, PROMPT)
    with torch.no_grad():
        last, cache = transformer.prefill(model, {"tokens": toks}, cfg)
    _close(last, _reference(m, list(toks)))
    for entry in cache.values():
        assert set(entry) == {"ckv", "kpe"}
        assert entry["ckv"].shape[-1] + entry["kpe"].shape[-1] == (
            cfg.kv_lora_rank + cfg.qk_rope_head_dim)


def test_decode_through_the_latent_cache_matches_the_reference(smoke):
    """Prefill 248 tokens, then 8 decode steps through the latent cache
    (the absorbed form): each step's logits against the reference's full
    forward of the prompt up to that position; every step writes its row
    in place and counts its bytes."""
    cfg, m, model = smoke
    toks = _prompts(cfg, 1, PROMPT, seed=2)
    n0 = PROMPT - 8
    before = attention.latent_bytes
    with torch.no_grad():
        _, cache = transformer.prefill(model, {"tokens": toks[:, :n0]}, cfg,
                                       cache_len=PROMPT)
        steps = []
        for t in range(n0, PROMPT):
            logits, cache = transformer.decode_step(
                model, toks[:, t:t + 1],
                torch.full((1,), t, dtype=torch.int32), cache, cfg)
            steps.append(logits[0])
    width = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 4     # f32 bytes
    assert attention.latent_bytes - before == cfg.num_layers * width * PROMPT
    _close(torch.stack(steps),
           _reference(m, [toks[0, :t + 1] for t in range(n0, PROMPT)]))


def test_generate_serves_the_latent_model(smoke):
    """``serve_step.generate`` over the latent cache: its first token's
    logits are the prefill's, and greedy decoding continues from them."""
    cfg, _, model = smoke
    toks = _prompts(cfg, 2, 40, seed=3)
    with torch.no_grad():
        out, logits = serve_step.generate(model, cfg, toks, max_new=4,
                                          cache_len=44, return_logits=True)
        last, _ = transformer.prefill(model, {"tokens": toks}, cfg)
    assert out.shape == (2, 4)
    assert torch.equal(logits[:, 0], last)
    assert torch.equal(out[:, 0], last.argmax(-1))


def test_published_cache_is_the_latent_alone():
    """At the published widths an MLA layer caches 576 values a token
    (c_kv 512, k_pe 64), against 16 x 320 for per-head K and V."""
    cfg = configs.get(ARCH)
    cache = transformer.init_cache(cfg, 1, 1024, device="meta")
    for entry in cache.values():
        assert sum(leaf.shape[-1] for leaf in entry.values()) == 576
    assert {k: tuple(v.shape) for k, v in cache["blocks"].items()} == {
        "ckv": (26, 1, 1024, 512), "kpe": (26, 1, 1024, 64)}


def test_training_differentiates_the_plain_path(smoke):
    """A forward of the smoke model with its weights trainable builds a
    graph through the latent attention's plain path: finite gradients in
    every projection."""
    cfg, _, _ = smoke
    model = transformer.init_params(cfg, seed=4, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    logits, aux = transformer.forward_train(
        model, {"tokens": _prompts(cfg, 2, 24)}, cfg)
    (logits.square().mean() + aux).backward()
    attn = model.blocks[0].attn
    for name in ("wq", "wkva", "wkvb", "wo", "kv_norm"):
        g = getattr(attn, name).grad
        assert g is not None and bool(torch.isfinite(g).all()), name


def test_prefill_records_the_latent_span(smoke):
    """Under a profiler each layer's ``mla_latent`` span opens inside its
    ``attention`` span."""
    cfg, _, model = smoke
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        transformer.prefill(model, {"tokens": _prompts(cfg, 1, 32)}, cfg)
    names = [e.name for e in prof.events()]
    assert names.count(spans.PREFIX + "mla_latent") == cfg.num_layers
    assert names.count(spans.PREFIX + "attention") == cfg.num_layers
    inner = [e for e in prof.events() if e.name == spans.PREFIX + "mla_latent"]
    outer = [e for e in prof.events() if e.name == spans.PREFIX + "attention"]
    for e in inner:
        assert any(o.time_range.start <= e.time_range.start
                   and e.time_range.end <= o.time_range.end for o in outer)


# ---------------------------------------------------------------------------
# the harness


def test_harness_finds_the_new_cell():
    """The MLA cell loads by name (``gpubench/spec.py``) with its kind,
    family, limits and metrics, and its ladder runs 17,408 to 60,416
    tokens at B 1."""
    cell = spec.cell(CELL)
    assert cell.traffic["kind"] == "prefill" and cell.chips == 1
    assert cell.traffic["batch"] == 1 and cell.config["reference"] == \
        "mla_moe_lm"
    assert {m["name"] for m in cell.end_to_end} == {"ttft_ms_p95",
                                                   "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "prefill_mfu", "moe_ms.prefill", "device_idle_pct.prefill",
        "mla_latent_ms.prefill", "mla_flash_roofline",
        "attention_ms.prefill", "launches_per_request.prefill"}
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert inputs.ladder(cell.traffic["ladder"]) == [
        17408, 21504, 25600, 29696, 35840, 41984, 50176, 60416]


def test_configuration_file_is_what_the_program_runs():
    """The file's ``model`` block is the program's config key for key, its
    top level is the published config.json, and its leaf specs are
    exactly the program's parameters (``weights.check_matches``)."""
    data = spec.load_json(CONFIG_FILE)
    cfg = program.model_config(data)
    assert data["reduced"] == [] and cfg.attention_kind == "mla"
    assert (data["num_hidden_layers"], data["kv_lora_rank"],
            data["rope_scaling"]["factor"]) == (27, 512, 40)
    model = program.build_model(cfg, "meta")
    weights.check_matches(mla_moe_lm, data["model"],
                          dict(model.named_parameters()))
    params = sum(math.prod(leaf.shape)
                 for leaf in weights.leaf_specs(mla_moe_lm, data["model"]))
    assert abs(params / 1e9 - 15.71) < 0.01
    for module, attr in program.layer_ranges(data).values():
        assert callable(getattr(module, attr))


def test_flops_of_the_mla_family():
    """Active parameters a token and the causal products, by hand: the
    dense first layer (attention + 3 x 2048 x 10944) and 26 MoE layers
    (attention, router 2048 x 64, 8 experts of 3 x 2048 x 1408); an
    attention of 2048 x 3072 + 2048 x 576 + 512 x 4096 + 2048 x 2048."""
    m = spec.load_json(CONFIG_FILE)["model"]
    attn = 6_291_456 + 1_179_648 + 2_097_152 + 4_194_304
    assert mla_moe_lm.active_block_params(m) == (
        attn + 67_239_936 + 26 * (attn + 131_072 + 69_206_016))
    s = 30_000
    assert mla_moe_lm.attention_flops(m, 1, s) == 138_240 * s * (s + 1)
    assert mla_moe_lm.prefill_flops(m, s) == (
        2 * s * mla_moe_lm.active_block_params(m) + 2 * 102_400 * 2048
        + 138_240 * s * (s + 1))


def test_a_smoke_mla_cell_runs_through_the_harness(tmp_path, smoke):
    """The MLA cell's configuration at the smoke geometry, in f32, with a
    short ladder, run once through ``run.run_cell`` on the CPU: the
    program's served rows against the reference read ``correct`` at
    f32-against-f32 limits, and every end-to-end metric is reported."""
    import json

    from gpubench import run
    from gpubench.tests import smoke as smoke_cells
    cfg, m, _ = smoke
    root = smoke_cells.make_root(tmp_path)
    here = root / "gpubench"
    conf = spec.load_json(CONFIG_FILE)
    conf["model"] = m
    conf["overrides"] = {
        **conf["overrides"], "dtype": "float32", "param_dtype": "float32",
        **{k: getattr(cfg, k) for k in ("num_layers", "d_model",
                                        "num_heads", "num_kv_heads", "d_ff",
                                        "vocab_size", "num_experts",
                                        "experts_per_token",
                                        "num_shared_experts", "moe_d_ff",
                                        "first_dense_d_ff", "kv_lora_rank",
                                        "qk_nope_head_dim",
                                        "qk_rope_head_dim", "v_head_dim",
                                        "yarn_original_max_positions")}}
    (here / "configs" / "mla-smoke.json").write_text(json.dumps(conf))
    mix = spec.load_json(here / "traffic" / "mla-long-prefill-ladder.json")
    mix["ladder"] = {"median": 96, "hi": 192, "rungs": 3, "multiple": 16}
    mix["checked_cycles"] = 1               # checked in the first 3 requests
    (here / "traffic" / "mla-smoke.json").write_text(json.dumps(mix))
    (here / "cells" / "mla-smoke-cell.json").write_text(json.dumps(
        smoke_cells.SMOKE_CHECKS["smoke-prefill"]))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mla-smoke", "source": "CPU tests",
                             "file": "gpubench/configs/mla-smoke.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": "mla-smoke-cell",
                               "config": "mla-smoke", "traffic": "mla-smoke",
                               "chips": 1, "why": "CPU"})
    for metric in bench["end_to_end"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("mla-smoke-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run.run_cell(spec.cell("mla-smoke-cell", root), seed=SEED,
                       seconds=3.0, trace=False, device="cpu")
    assert res["correct"], res["check"]
    assert res["notes"]["rows"] == 3
    assert set(res["metrics"]) == {"ttft_ms_p95", "setup_s"}


def test_mla_flash_roofline_reads_its_kernel_over_the_traced_requests():
    """``mla_flash_roofline`` on a hand-made trace: the causal FLOPs of the
    traced rungs (one request each of the first ``traced_requests``) at
    989 TFLOP/s over the 192/128 kernel's device seconds, other kernels
    left out; nothing where the kernel or the latent model is absent."""
    cell = spec.cell(CELL)
    m = cell.config["model"]
    kernel = ("void (anonymous namespace)::flash_fwd_mla_kernel<192, 128>"
              "(__nv_bfloat16 const*, ...)")

    class Summary:
        by_name = {kernel: (6.8, 216), "flash_fwd_kernel<128>": (1.0, 8)}

    ctx = {"traced_requests": 8, "model": m, "summary": Summary(),
           "device_name": "NVIDIA H100 80GB HBM3"}
    read = spec.metric_reader("mla_flash_roofline")
    work = sum(mla_moe_lm.attention_flops(m, 1, s) for s in
               inputs.ladder(cell.traffic["ladder"]))
    assert read(ctx) == pytest.approx(100 * work / (6.8 * 989e12))
    # bound by the products: the bytes take a tenth of their time or less
    assert all(mla_moe_lm.attention_bytes(m, 1, s) / 3.35e12
               < 0.1 * mla_moe_lm.attention_flops(m, 1, s) / 989e12
               for s in inputs.ladder(cell.traffic["ladder"]))
    assert mla_moe_lm.attention_bytes(m, 1, 1000) == (
        1000 * 16 * (2 * (2 * 192 + 2 * 128) + 4) * 27)
    Summary.by_name = {"flash_fwd_kernel<128>": (1.0, 8)}
    assert read(ctx) is None
    gqa = spec.cell("deepseek-moe-prefill-long").config["model"]
    assert read({**ctx, "model": gqa}) is None
    assert read({"requests": 3}) is None


def test_mla_flash_roofline_refuses_two_cells_of_one_model(monkeypatch):
    """The reader finds the traced lengths by the model alone, so a second
    prefill cell of the same configuration makes it raise rather than read
    one cell's lengths in the other."""
    bench = spec.benchmark()
    mine = next(w for w in bench["workloads"] if w["name"] == CELL)
    twice = {**bench, "workloads": bench["workloads"] + [
        {**mine, "name": CELL + "-again"}]}
    model = spec.cell(CELL).config["model"]
    monkeypatch.setattr(spec, "benchmark", lambda root=spec.ROOT: twice)

    class Summary:
        by_name = {"(anonymous namespace)::flash_fwd_mla_kernel<192, 128>":
                   (6.8, 216)}

    ctx = {"traced_requests": 8, "model": model, "summary": Summary(),
           "device_name": "NVIDIA H100 80GB HBM3"}
    with pytest.raises(LookupError):
        spec.metric_reader("mla_flash_roofline")(ctx)
