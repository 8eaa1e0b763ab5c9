"""The port's spans (``repro_torch.analysis.spans``) and their reading
(``gpubench/spans.py``) on the CPU.

A smoke MoE train step with the AFM probe and ``remat`` on, profiled,
records every layer's forward span and each ``<layer>.backward``; the
recompute of a block lies inside its ``moe.backward``. Without a profiler
the helpers add nothing: the same graph, and a step bitwise equal to the
profiled one. ``generate`` records its serving spans. The reading is held
on a hand-made kineto event list, beside ``trace.summarise``'s fields
pinned on the same list.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import spans as span_reading  # noqa: E402
from gpubench import trace  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import spans  # noqa: E402
from repro_torch.core import probe  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.draws import GeneratorDraws  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import serve_step  # noqa: E402
from repro_torch.training import AdamWConfig, train_step  # noqa: E402

ARCH = "granite-moe-1b-a400m"
LAYERS = ("attention", "moe", "lm_head", "cross_entropy")
CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]


def _cfg(moe_impl: str):
    return dataclasses.replace(configs.get_smoke(ARCH), moe_impl=moe_impl,
                               remat=True)


def _setup(moe_impl: str):
    cfg = _cfg(moe_impl)
    pcfg = probe.ProbeConfig(side=4, dim=cfg.d_model, i_max=100)
    step = train_step.make_train_step(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3), pcfg)
    state = train_step.init_train_state(cfg, pcfg, seed=0, device="cpu")
    batch = next(iter(tokens.batches(torch.Generator().manual_seed(1),
                                     cfg.vocab_size, 2, 16, 1,
                                     device="cpu")))
    return cfg, step, state, batch


def _spans(prof) -> list:
    """[(start, end, name)] of the trace's ``repro_torch::`` ranges."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                   e.name().removeprefix(spans.PREFIX))
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(spans.PREFIX))


@pytest.mark.parametrize("moe_impl", ["dense", "ragged"])
def test_profiled_train_step_records_every_span(moe_impl):
    cfg, step, state, batch = _setup(moe_impl)
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        step(state, batch, GeneratorDraws.for_step(0, 0, "cpu"))
    got = _spans(prof)
    names = [n for _, _, n in got]
    layers = cfg.num_layers
    # forward, then the recompute under remat
    assert names.count("attention") == names.count("moe") == 2 * layers
    for name in ("attention.backward", "moe.backward"):
        assert names.count(name) == layers
    for name in ("train_step", "lm_head", "lm_head.backward",
                 "cross_entropy", "cross_entropy.backward", "optimizer",
                 "probe"):
        assert names.count(name) == 1, name
    (a0, b0, _), = [s for s in got if s[2] == "train_step"]
    assert all(a0 <= a and b <= b0 for a, b, _ in got)
    # each block's recompute opens inside its moe.backward
    backward = [(a, b) for a, b, n in got if n == "moe.backward"]
    recompute = [(a, b) for a, b, n in got if n in ("attention", "moe")
                 and a > backward[0][0]]
    assert len(recompute) == 2 * layers
    assert all(any(a0 <= a and b <= b0 for a0, b0 in backward)
               for a, b in recompute)
    # the CPU trace holds no device op: all of it is idle, cut by span
    read = span_reading.read(prof.profiler.kineto_results.events())
    assert read.span_s == read.span_ops == read.span_syncs == {}
    assert set(read.span_idle_s) <= {n for _, _, n in got} | {""}
    assert "optimizer" in read.span_idle_s


def _graph_nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo += [f for f, _ in node.next_functions]
    return len(seen)


def test_spans_change_nothing_without_a_profiler():
    cfg, step, state, batch = _setup("ragged")
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    assert spans.span("attention") is spans.span("moe")
    assert spans.mark_backward("attention", x, y) is y
    assert x._backward_hooks is None and y._backward_hooks is None
    plain = _graph_nodes(train_step.lm_loss(state.params, batch, cfg)[0])
    with torch.profiler.profile(activities=CPU_ONLY):
        traced = _graph_nodes(train_step.lm_loss(state.params, batch,
                                                 cfg)[0])
    assert plain == traced

    out = {}
    for profiled in (False, True):
        _, step, state, batch = _setup("ragged")
        draws = GeneratorDraws.for_step(0, 0, "cpu")
        if profiled:
            with torch.profiler.profile(activities=CPU_ONLY):
                state, m = step(state, batch, draws)
        else:
            state, m = step(state, batch, draws)
        out[profiled] = (m, state)
    (m0, s0), (m1, s1) = out[False], out[True]
    for key in ("loss", "ce", "moe_aux", "grad_norm", "probe_cascade"):
        assert torch.equal(m0[key], m1[key]), key
    p0, p1 = (dict(s.params.named_parameters()) for s in (s0, s1))
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
        # the first step's moments are the gradient's (1 - b) multiples
        assert torch.equal(s0.opt.mu[name], s1.opt.mu[name]), name
        assert torch.equal(s0.opt.nu[name], s1.opt.nu[name]), name
    assert torch.equal(s0.probe.afm.w, s1.probe.afm.w)
    assert torch.equal(s0.probe.afm.c, s1.probe.afm.c)


def test_generate_records_the_serving_spans():
    cfg = _cfg("ragged")
    model = transformer.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 12),
                           generator=torch.Generator().manual_seed(2))
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        serve_step.generate(model, cfg, prompt, max_new=2, cache_len=16)
    names = {n for _, _, n in _spans(prof)}
    assert names == {"generate", "attention", "moe", "lm_head"}


class _Event:
    """The part of a kineto event the readers call."""

    def __init__(self, name, start, duration, *, cuda=False, corr=0,
                 user=False):
        self._name, self._start, self._duration = name, start, duration
        self._cuda, self._corr, self._user = cuda, corr, user

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._duration

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return self._user


def _host(name, start, duration, corr=0):
    return _Event(name, start, duration, corr=corr,
                  user=name.startswith(("repro_torch::", "gpubench::")))


def _device(name, start, duration, corr=0):
    return _Event(name, start, duration, cuda=True, corr=corr)


#: a traced window in ns. The main thread: the step [0, 1000) holds the MoE
#: [100, 300), which holds attention [120, 200); a copy launched at 50, two
#: kernels at 130 and 210, a sync at 450 inside the step and one at 1160
#: outside every span, a kernel launched at 1100 after the step. Autograd's
#: thread: moe.backward [500, 700) launches a kernel at 600. The harness's
#: range gpubench::moe [90, 310) wraps the MoE from outside. The device
#: idles over [400, 600), across the step and moe.backward.
EVENTS = [
    _host("repro_torch::train_step", 0, 1000),
    _host("gpubench::moe", 90, 220),
    _host("repro_torch::moe", 100, 200),
    _host("repro_torch::attention", 120, 80),
    _host("aten::mm", 125, 20),
    _host("cudaLaunchKernel", 130, 5, corr=1),
    _host("cudaLaunchKernel", 210, 5, corr=2),
    _host("cudaMemcpyAsync", 50, 5, corr=6),
    _host("cudaStreamSynchronize", 450, 40, corr=7),
    _host("cudaLaunchKernel", 800, 5, corr=4),
    _host("cudaLaunchKernel", 1100, 5, corr=5),
    _host("cudaDeviceSynchronize", 1160, 40, corr=8),
    _host("repro_torch::moe.backward", 500, 200),
    _host("cudaLaunchKernel", 600, 5, corr=3),
    _Event("repro_torch::attention", 150, 100, cuda=True, user=True),
    _device("Memcpy HtoD", 60, 20, corr=6),
    _device("k_attn", 150, 100, corr=1),
    _device("k_moe", 260, 140, corr=2),
    _device("k_bwd", 600, 50, corr=3),
    _device("k_step", 800, 100, corr=4),
    _device("k_out", 1100, 50, corr=5),
]


def _seconds(ns: dict) -> dict:
    return {k: pytest.approx(v * 1e-9, rel=1e-12) for k, v in ns.items()}


def test_span_reading_on_a_hand_made_trace():
    got = span_reading.read(EVENTS)
    # each op once, in the innermost span at its launch call; the kernel
    # at 1100 outside every span
    assert got.span_s == _seconds({"train_step": 20 + 100, "attention": 100,
                                   "moe": 140, "moe.backward": 50, "": 50})
    assert got.span_ops["train_step"] == _seconds({"Memcpy HtoD": 20,
                                                   "k_step": 100})
    assert got.span_ops["attention"] == _seconds({"k_attn": 100})
    device = sum(e.duration_ns() for e in EVENTS
                 if e._cuda and not e._user)
    assert sum(got.span_s.values()) == pytest.approx(device * 1e-9,
                                                     rel=1e-12)
    assert got.span_syncs == {"train_step": 1}
    # idle [0, 60) [80, 150) [250, 260) [400, 600) [650, 800) [900, 1100)
    # [1150, 1200), cut by the innermost span
    assert got.span_idle_s == _seconds({
        "train_step": 60 + 20 + 100 + 100 + 100, "moe": 20 + 10,
        "attention": 30, "moe.backward": 100 + 50, "": 100 + 50})
    # the trace's length less the device's busy union
    assert sum(got.span_idle_s.values()) == pytest.approx(
        (1200 - 460) * 1e-9, rel=1e-12)

    s = trace.summarise(EVENTS, 1.2e-6)
    assert s.window_s == 1.2e-6
    assert s.busy_s == pytest.approx(460e-9, rel=1e-12)
    assert s.launches == 5
    assert s.range_s == _seconds({"moe": 240})
    assert s.by_name == {k: (pytest.approx(v * 1e-9, rel=1e-12), 1)
                         for k, v in (("Memcpy HtoD", 20), ("k_attn", 100),
                                      ("k_moe", 140), ("k_bwd", 50),
                                      ("k_step", 100), ("k_out", 50))}
    assert s.device_ops == [(k, pytest.approx(v * 1e-9, rel=1e-12))
                            for k, v in (("k_moe", 140), ("k_attn", 100),
                                         ("k_step", 100), ("k_bwd", 50),
                                         ("k_out", 50),
                                         ("Memcpy HtoD", 20))]
    assert s.idle_gaps == [
        (name, pytest.approx(v * 1e-9, rel=1e-12)) for name, v in (
            ("repro_torch::train_step", 200),
            ("repro_torch::moe.backward", 200),
            ("repro_torch::train_step", 150),
            ("gpubench::moe > repro_torch::moe", 70),
            ("gpubench::moe > repro_torch::moe", 10))]
