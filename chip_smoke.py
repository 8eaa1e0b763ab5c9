#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and ``nvcc``:

1. builds the port's CUDA kernels from ``src/repro_torch/kernels``;
2. prints the card's name and power limit (``nvidia-smi``);
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at ragged ones;
4. checks that the adapt and cascade stages of a full-width step on the card
   agree with the same stages on the CPU (same inputs, same draws);
5. trains a 30x30 map on 784-d MNIST-shaped data through
   ``TopoMap(backend="kernel")`` and queries it with the 10,000 test
   samples, counting the kernel launches of that run;
6. times each kernel beside its bound, its plain version and a library call;
7. prints ``{"kernels": [...]}``, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the exit code is non-zero and the last line is
missing. Without a CUDA card it exits with code 1 before doing anything.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

STEPS = 500                 # training steps of the main path (B = 16 each)
SEED = 0

#: published peaks (NVIDIA data sheets, at the full power limit):
#: non-tensor f32 FLOP/s and memory bytes/s; the kernels use no tensor cores
PEAKS = {
    "SXM": (67e12, 3.35e12),
    "PCIe": (51e12, 2.0e12),
}


def peaks_for(name: str):
    return PEAKS["PCIe"] if "PCIe" in name else PEAKS["SXM"]


class HostDraws:
    """Draws made on the CPU by a seeded generator and moved to ``device``,
    so a CPU run and a CUDA run can consume the very same numbers."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator().manual_seed(seed)

    def randint(self, low, high, shape):
        return torch.randint(low, high, tuple(shape), generator=self.gen
                             ).to(self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen).to(self.device)


def time_ms(fn, iters: int) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns: dict, iters: int, rounds: int = 3) -> dict:
    """Median per-call time of each function, measured in alternating turns
    (a, b, ..., then reversed) on one card."""
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(time_ms(fns[k], iters))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def check_bmu(w, s, precision, what):
    """Kernel vs plain version on the same card: q2 within the f32 bound of
    the expanded form, indices equal except within that bound of a tie."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    idx, q2 = bmu_ops.bmu(w, s, precision=precision)
    plain = bmu_ref.bmu_ref if precision == "exact" else bmu_ref.bmu_bf16_ref
    idx_r, q2_r = plain(w, s)
    torch.cuda.synchronize()
    bound = bmu_ref.tie_bound(w, s)
    differ = idx != idx_r
    n_differ = int(differ.sum())
    if n_differ:
        gap = bmu_ref.top2_gap(w, s)
        if not bool((gap[differ] <= bound[differ]).all()):
            raise AssertionError(f"bmu {precision} {what}: {n_differ} indices "
                                 f"differ away from ties")
    err = (q2 - q2_r).abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"bmu {precision} {what}: q2 off by "
                             f"{float(err.max())} > bound")
    print(f"bmu {precision:5s} {what}: max|dq2| {float(err.max()):.3g}, "
          f"{n_differ} near-tie index differences")
    return float(err.max()), idx


def check_kernels(device):
    """Phase 3: each kernel against its plain version, main-path and ragged
    shapes; returns the worst error per kernel."""
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    gen = torch.Generator(device=device).manual_seed(SEED)
    worst = {"bmu": 0.0, "cascade_wave": 0.0}
    for b, n, d in ((16, 900, 784), (10000, 900, 784)):
        w = torch.rand(n, d, generator=gen, device=device)
        s = torch.rand(b, d, generator=gen, device=device)
        for precision in ("exact", "bf16"):
            err, _ = check_bmu(w, s, precision, f"B={b} N={n} D={d}")
            if precision == "exact":
                worst["bmu"] = max(worst["bmu"], err)
    # ragged shape with planted exact ties: the lower index must win
    w = torch.randn(37, 13, generator=gen, device=device)
    pairs = torch.randperm(37, generator=gen, device=device)[:10].view(5, 2)
    lo, hi = pairs.min(1).values, pairs.max(1).values
    w[hi] = w[lo]
    s = w[hi] + 1e-3 * torch.randn(5, 13, generator=gen, device=device)
    for precision in ("exact", "bf16"):
        err, idx = check_bmu(w, s, precision, "B=5 N=37 D=13 ties")
        if not torch.equal(idx.long(), lo):
            raise AssertionError(f"bmu {precision}: a tie went to the higher "
                                 f"index: {idx.tolist()} vs {lo.tolist()}")
        if precision == "exact":
            worst["bmu"] = max(worst["bmu"], err)
    for side in (30, 7):
        c = torch.randint(0, 6, (side, side), generator=gen, device=device,
                          dtype=torch.int32)
        fired = torch.rand(side, side, generator=gen, device=device) < 0.25
        bern = torch.rand(4, side, side, generator=gen, device=device) < 0.8
        out = cas_ops.cascade_wave(c, fired, bern, 4)
        ref = cas_ref.cascade_wave_ref(c, fired, bern, 4)
        for a, r in zip(out, ref):
            if not torch.equal(a, r):
                raise AssertionError(f"cascade_wave side {side}: not bitwise")
        print(f"cascade_wave side {side}: bitwise equal to the plain version")
    torch.cuda.synchronize()
    return worst


def check_step_stages(device, xtr):
    """Phase 4: the adapt and cascade stages of a full-width step on the card
    (cascade kernel) against the same stages on the CPU (plain versions),
    from one state, one set of GMUs and the same draws. The search stage is
    phase 3's. Counters, fired sizes and waves bitwise; weights within 8 f32
    ULP per adaptation."""
    from repro_torch.core import afm, schedules
    from repro_torch.kernels.cascade import ops as cas_ops
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    state = afm.init(HostDraws(SEED, "cpu"), cfg, xtr[:4096].cpu())
    gen = torch.Generator().manual_seed(SEED)
    c = torch.randint(cfg.theta - 2, cfg.theta, (cfg.n_units,), generator=gen,
                      dtype=torch.int32)
    samples = xtr[:cfg.batch].cpu()
    gmu, _ = afm.search_exact(state, samples, None, cfg)[:2]
    l_c = float(schedules.cascade_learning_rate(0, cfg.total_samples, cfg.c_o,
                                                cfg.c_s))
    p = float(schedules.cascade_probability(0, cfg.total_samples, cfg.n_units,
                                            cfg.c_m, cfg.c_d))
    out = {}
    for dev, wave_fn in (("cpu", None), (device, cas_ops.cascade_wave)):
        w, counts = afm.adapt_merge(state.w.to(dev), samples.to(dev),
                                    gmu.to(dev), cfg)
        out[dev] = afm.cascade_default(w, c.to(dev), counts, l_c, p,
                                       HostDraws(SEED + 1, dev), cfg,
                                       wave_fn=wave_fn)
    cpu, gpu = out["cpu"], out[device]
    if (cpu.size, cpu.waves) != (gpu.size, gpu.waves) or cpu.waves == 0:
        raise AssertionError(f"stage parity: size/waves {cpu.size, cpu.waves}"
                             f" on the CPU, {gpu.size, gpu.waves} on the card")
    if not torch.equal(cpu.c, gpu.c.cpu()):
        raise AssertionError("stage parity: counters differ")
    dw = float((cpu.w - gpu.w.cpu()).abs().max())
    bound = (8 * (1 + cpu.waves) * torch.finfo(torch.float32).eps
             * float(cpu.w.abs().max()))
    if dw > bound:
        raise AssertionError(f"stage parity: |dw| {dw} > {bound}")
    print(f"stage parity (adapt + cascade of {cpu.size} firings in "
          f"{cpu.waves} waves): integers bitwise, max|dw| {dw:.3g} <= "
          f"{bound:.3g}")


def main_path(device, xtr, ytr, xte, yte, steps):
    """Phase 5: train and query through the entry points a user calls.
    Returns the quality, the rates and the launch counts of this run."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.draws import GeneratorDraws
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.kernels.cascade import ops as cas_ops
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    init_state = afm.init(GeneratorDraws(SEED, device), cfg, xtr)
    qe0 = TopoMap.from_state(init_state, cfg, backend="kernel",
                             device=device).quantization_error(xte)
    TopoMap(cfg, backend="kernel", device=device).fit(xtr, num_steps=3)

    bmu_ops.launches = cas_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tm = TopoMap(cfg, backend="kernel", device=device, seed=SEED)
    tm.fit(xtr, num_steps=steps)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches = {"bmu": bmu_ops.launches, "cascade_wave": cas_ops.launches}
    tm.label(xtr, ytr)
    t0 = time.perf_counter()
    units = tm.transform(xte)
    torch.cuda.synchronize()
    transform_s = time.perf_counter() - t0
    pred = tm.predict(xte)
    qe = tm.quantization_error(xte)
    torch.cuda.synchronize()
    launches = {"bmu": bmu_ops.launches, "cascade_wave": cas_ops.launches}

    n = cfg.n_units
    if not (units.shape == (len(xte),) and int(units.min()) >= 0
            and int(units.max()) < n):
        raise AssertionError("transform: units out of range")
    if not bool(torch.isfinite(tm.state_.w).all()):
        raise AssertionError("fit: non-finite weights")
    # the transform's units against f64 distances: each chosen unit must be
    # within the f32 bound of the expanded form of the true nearest one
    d = torch.cdist(xte.double(), tm.state_.w.double()) ** 2
    best = d.min(dim=1)
    chosen = d.gather(1, units.long()[:, None])[:, 0]
    slack = chosen - best.values
    within = bool((slack <= bmu_ref.tie_bound(tm.state_.w, xte)).all())
    agree = float((best.indices == units).float().mean())
    acc = float((pred == yte).float().mean())
    aux = tm.fit_aux_
    print(f"main path: {steps} steps x B=16 on {tuple(xtr.shape)} train, "
          f"{tuple(xte.shape)} test; waves/step {float(aux.waves.float().mean()):.2f}, "
          f"cascade size/step {float(aux.cascade_size.float().mean()):.2f}")
    print(f"QE initial {qe0:.4f} -> trained {qe:.4f}; accuracy {acc:.4f}; "
          f"transform: nearest unit for {agree:.5f} of samples, the rest "
          f"within {float(slack.max()):.3g} of it")
    print(f"launches: training {train_launches}, whole run {launches}")
    print(f"fit samples/s {steps * cfg.batch / fit_s:.1f} "
          f"({fit_s:.3f} s for {steps} steps, init included)")
    print(f"transform samples/s {len(xte) / transform_s:.1f} "
          f"({transform_s * 1e3:.3f} ms for {len(xte)} samples)")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"{launches}")
    if not qe < qe0:
        raise AssertionError(f"QE did not fall: {qe0} -> {qe}")
    if acc < ACCURACY_FLOOR:
        raise AssertionError(f"accuracy {acc} below {ACCURACY_FLOOR}")
    if not within:
        raise AssertionError(f"transform: a unit beyond the tie bound, "
                             f"{float(slack.max())} from the nearest")
    return tm, train_launches, launches


#: chance is 0.1 on the ten classes; the first run on an H100 (500 steps,
#: seed 0) classified all 10,000 test samples right, so 0.9 leaves room for
#: other seeds and cards while a map that failed to organise falls below it
ACCURACY_FLOOR = 0.9


def kernel_table(device, tm, xtr, xte, train_launches, launches, worst):
    """Phase 6: time each kernel at the main path's shapes beside its plain
    version, a library call and its bound."""
    from repro_torch.kernels.bmu import ops as bmu_ops
    from repro_torch.kernels.bmu import ref as bmu_ref
    from repro_torch.kernels.cascade import ops as cas_ops
    from repro_torch.kernels.cascade import ref as cas_ref
    name = torch.cuda.get_device_name(0)
    f32_peak, bw = peaks_for(name)
    w = tm.state_.w
    rows = []
    for label, s, iters, n_launch in (
            ("bmu (training search, B=16)", xtr[:16].contiguous(), 200,
             train_launches["bmu"]),
            ("bmu (queries, B=10000)", xte.contiguous(), 20,
             launches["bmu"] - train_launches["bmu"])):
        (n, d), b = w.shape, s.shape[0]
        t = time_in_turns({
            "plain": lambda: bmu_ref.bmu_ref(w, s),
            "kernel": lambda: bmu_ops.bmu(w, s),
            "library": lambda: torch.cdist(s, w).min(dim=1),
        }, iters)
        nbytes = 4 * (n * d + b * d) + 8 * b
        flops = 2 * b * n * d + 2 * (n + b) * d
        bound = max(nbytes / bw, flops / f32_peak) * 1e3
        rows.append({
            "name": label, "route": "cuda",
            "source": "src/repro_torch/kernels/bmu/bmu.cu",
            "replaces": "src/repro/kernels/bmu/bmu.py:26",
            "launches": n_launch, "max_abs_err": worst["bmu"],
            "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
            "bound_by": "bytes" if nbytes / bw > flops / f32_peak
            else "operations",
            "library_ms": t["library"]})
    side = tm.cfg.side
    gen = torch.Generator(device=device).manual_seed(SEED)
    c = torch.randint(0, 6, (side, side), generator=gen, device=device,
                      dtype=torch.int32)
    fired = torch.rand(side, side, generator=gen, device=device) < 0.25
    bern = torch.rand(4, side, side, generator=gen, device=device) < 0.8
    t = time_in_turns({
        "plain": lambda: cas_ref.cascade_wave_ref(c, fired, bern, 4),
        "kernel": lambda: cas_ops.cascade_wave(c, fired, bern, 4),
    }, 500)
    sites = side * side
    nbytes = sites * (4 + 1 + 4) + sites * (4 + 1 + 4)
    # ~16 integer operations a site, counted at half the f32 rate (an SM
    # has half as many int32 lanes as f32 lanes)
    ops = 16 * sites
    bound = max(nbytes / bw, ops / (f32_peak / 2)) * 1e3
    rows.append({
        "name": "cascade_wave (side 30)", "route": "cuda",
        "source": "src/repro_torch/kernels/cascade/cascade.cu",
        "replaces": "src/repro/kernels/cascade/cascade.py:38",
        "launches": launches["cascade_wave"],
        "max_abs_err": worst["cascade_wave"],
        "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound,
        "bound_by": "bytes" if nbytes / bw > ops / (f32_peak / 2)
        else "operations",
        "library_ms": None})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is "
              "false", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    from repro_torch.data import make_dataset
    from repro_torch.kernels import _build
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s) -> {_build.library_path().name}")
    print(_build.build_log.strip())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")

    worst = check_kernels(device)
    t0 = time.perf_counter()
    xtr, ytr, xte, yte = make_dataset("mnist", seed=SEED, device=device)
    print(f"data: mnist stand-in {tuple(xtr.shape)} + {tuple(xte.shape)} in "
          f"{time.perf_counter() - t0:.2f} s")
    check_step_stages(device, xtr)
    tm, train_launches, launches = main_path(device, xtr, ytr, xte, yte, STEPS)
    rows = kernel_table(device, tm, xtr, xte, train_launches, launches, worst)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
