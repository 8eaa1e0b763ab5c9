#!/usr/bin/env python3
"""Where the time of two of the port's kernels goes, on one NVIDIA card.

    PYTHONPATH=src python3 scripts/profile_torch_kernels.py \
        [--kernels swa,fused] [--parent DIR]

Builds stripped copies of a kernel's source beside the real one, each into
its own library under ``build/kernel_variants/`` (the sources are edited as
text; the script fails if an edit no longer applies), and times each copy
queued ahead of the card (CUDA events around 32 calls behind a sleep
kernel, median of 3), beside an empty elementwise op queued the same way
(the floor of any launch), in two rounds.

``swa``: ``kernels/swa/swa.cu`` at llama3.2-1b's long_500k decode shape
(B 1, 32/8 heads, hd 64, W 8192, bf16, 16 caches in turn so K/V come from
device memory) and at its serve shape (B 4, W 192):

- ``as is``: the kernel;
- ``no math``: the bf16 kernel's per-chunk math (QK^T, softmax, PV) skipped
  by a condition the compiler cannot fold, so what is left is the launch,
  the loads, the merge, the ticket and the combine;
- ``no loads``: no K/V copies issued (the math runs on whatever the shared
  memory holds), so what is left is the launch, the math and the tail.

``fused``: ``kernels/fused/fused.cu`` at the main path's step (30x30x784,
B 16, from the state of a 500-step fused fit of the MNIST-shaped stand-in,
draws at that state's p_i, a wave block of 16):

- ``as is``: the kernel, searching on the exact tier;
- ``given GMUs``: the same call with the GMUs passed in (no search, no grid
  barrier);
- ``no waves``: the same call with ``budget = 0``;
- ``search only``: the kernel cut after the grid barrier and the merge of
  the splits (and, in this tree's kernel, the landing of the copied
  inputs);
- ``barrier only``: an empty cooperative launch of the same grid with one
  grid barrier, the floor of the design;
- this tree only: ``waves: counters only`` (the waves skip the weights)
  and ``phase clock``, a copy that stamps the SM clock after each phase
  (thread 0 of each block) and prints, per phase, the median and the
  largest time over the blocks.

With ``--parent DIR`` (a directory holding another revision's
``fused/fused.cu`` and ``runtime/search.cuh``, and ``runtime/waves.cuh``
and ``runtime/wave_loop.cuh`` where its ``fused.cu`` includes them; e.g.
the parent commit's, written there with ``git show``) its copies are built
and timed too, in turns with this tree's, on the same inputs. A
``fused.cu`` that includes those headers is edited and built with their
text in place of the includes.
"""
import argparse
import ctypes
import functools
import itertools
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLEEP_CYCLES = 100_000_000


def queued_us(fn, iters=32, rounds=3):
    """Median device time of one call, queued ahead of the card, in us."""
    out = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters * 1e3)
    return sorted(out)[len(out) // 2]


def replace(text, old, new, what="swa.cu"):
    if old not in text:
        raise RuntimeError(f"{what} no longer holds {old[:60]!r}")
    return text.replace(old, new, 1)


def variants(source: str) -> dict:
    math_start = "    // S for slots 8 nt + 2 gc (+1) of this warp's 16\n"
    math_end = "    __syncthreads();                       // this stage is refilled next\n"
    a, b = source.index(math_start), source.index(math_end)
    no_math = (source[:a] + "    if (slots < 0) {\n" + source[a:b] + "    }\n"
               + source[b:])
    no_loads = replace(replace(source, "    if (c < chunks) issue(c);\n", ""),
                       "    if (c + MMA_STAGES < chunks) issue(c + MMA_STAGES);\n",
                       "")
    return {"as is": source, "no math": no_math, "no loads": no_loads}


def build(name: str, source: str):
    """A library of all the port's kernels with swa.cu replaced."""
    from repro_torch.kernels import _build
    kernels = ROOT / "build" / "kernel_variants" / name.replace(" ", "_")
    shutil.rmtree(kernels, ignore_errors=True)
    shutil.copytree(_build.KERNELS_DIR, kernels / "kernels",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (kernels / "kernels" / "swa" / "swa.cu").write_text(source)
    saved = _build.KERNELS_DIR, _build.BUILD_DIR, _build._library
    try:
        _build.KERNELS_DIR, _build.BUILD_DIR = kernels / "kernels", kernels
        _build._library = None
        return _build.load()
    finally:
        _build.KERNELS_DIR, _build.BUILD_DIR, _build._library = saved


def profile_swa(device):
    from repro_torch.device import sm_count
    from repro_torch.kernels.swa import ops as swa_ops
    source = (ROOT / "src/repro_torch/kernels/swa/swa.cu").read_text()
    libs = {name: build(name, text) for name, text in variants(source).items()}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=device).manual_seed(0)
    tickets = torch.zeros(64, dtype=torch.int32, device=device)

    def shape(b, w, pos, n_caches):
        caches = [tuple(torch.randn(s, generator=gen, device=device).bfloat16()
                        for s in ((b, 32, 64), (b, w, 8, 64), (b, w, 8, 64)))
                  for _ in range(n_caches)]
        posv = (pos + torch.arange(b, dtype=torch.int32)).to(device)
        return caches, posv, swa_ops.plan(b, 8, w, sm_count(device))

    shapes = {"long_500k (B 1, W 8192)": shape(1, 8192, 8703, 16),
              "serve (B 4, W 192)": shape(4, 192, 128, 1)}
    x = torch.zeros(1, device=device)
    for rnd in range(2):
        print(f"round {rnd + 1}: an empty elementwise op, queued: "
              f"{queued_us(lambda: x.add_(1)):.3f} us")
        for label, (caches, posv, plan) in shapes.items():
            b, w = caches[0][1].shape[:2]
            out = torch.empty_like(caches[0][0])
            ml = torch.empty(b, 8, plan.splits, 4, 2, device=device)
            acc = torch.empty(b, 8, plan.splits, 4, 64, device=device)
            for name, lib in libs.items():
                turn = itertools.cycle(caches)

                def call():
                    q, k, v = next(turn)
                    err = lib.repro_swa_decode(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        posv.data_ptr(), b, 8, w, 4, 64, 1, plan.splits,
                        plan.slots, ml.data_ptr(), acc.data_ptr(),
                        tickets.data_ptr(), out.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                print(f"round {rnd + 1}: {label}, {plan.splits} x "
                      f"{plan.slots} slots, {name}: {queued_us(call):.3f} us")


#: the kernel's body as the stripped fused copies cut it: a line to find
#: and what goes after it
BODY_START = "  extern __shared__ __align__(128) unsigned char smem[];\n"
PARENT_BODY_START = "  extern __shared__ __align__(16) unsigned char smem[];\n"
NEW_SEARCH_END = ("  if (p.bulk_in) repro::mbar_wait(inputs_ready, 0);\n"
                  "  __syncthreads();\n")
OLD_SEARCH_END = "    __syncthreads();\n    if (g == 0 && p.bf16) {"
CUT = "  if (p.n > 0) return;\n"
SEARCH_INCLUDE = '#include "../runtime/search.cuh"\n'
#: the shared headers of the wave code, inlined into a copy's text
WAVE_HEADERS = ("waves.cuh", "wave_loop.cuh")


def inline_waves(source: str, runtime: Path) -> str:
    """``fused.cu`` with the text of ``runtime/waves.cuh`` and
    ``runtime/wave_loop.cuh`` in place of their includes (the drive, wave
    loop and outputs the stripped copies edit live in the second)."""
    for name in WAVE_HEADERS:
        include = f'#include "../runtime/{name}"\n'
        if include in source:
            source = source.replace(include, (runtime / name).read_text())
    return source


def fused_variants(source: str, old: bool) -> dict:
    """The stripped copies of a ``fused.cu``; ``old``: an earlier
    revision's, which plans on the card (another C interface)."""
    what = "the earlier fused.cu" if old else "fused.cu"
    start = PARENT_BODY_START if old else BODY_START
    barrier = replace(source, start,
                      start + "  cg::this_grid().sync();\n" + CUT, what)
    if old:
        search = replace(source, OLD_SEARCH_END,
                         "    __syncthreads();\n" + CUT
                         + OLD_SEARCH_END[len("    __syncthreads();\n"):],
                         what)
    else:
        search = replace(source, NEW_SEARCH_END, NEW_SEARCH_END + CUT, what)
    return {"as is": source, "search only": search, "barrier only": barrier}


#: where ``phase clock`` stamps the time (thread 0 of each block: the SM's
#: clock64 and the global nanosecond timer): a name, the line the stamp
#: follows (or, marked "<", precedes), and the condition it is taken under
PHASES = [("entry", BODY_START, ""),
          ("search", "<    cg::this_grid().sync();\n", ""),
          ("grid barrier", "    cg::this_grid().sync();\n", ""),
          ("split merge",
           "<    if (g == last && p.bf16) {   // exact-f32 polish of each winner\n",
           ""),
          ("inputs landed", NEW_SEARCH_END, ""),
          ("Eq. 3 merge, drive",
           "fronts[atomicAdd(&n_front[0], 1)] = u;\n  }\n"
           "  if (!clean) *dirty = 1;\n  __syncthreads();\n", ""),
          ("first wave: push",
           "<    const int nrc = n_recv[k % 3];\n", "waves == 0"),
          ("first wave: update", "    if (!fresh) *dirty = 1;\n", "waves == 0"),
          ("first wave: barrier", "    ++waves;\n    __syncthreads();\n",
           "waves == 1"),
          ("second wave", "    ++waves;\n    __syncthreads();\n", "waves == 2"),
          ("other waves", "    ++waves;\n    __syncthreads();\n  }\n", ""),
          ("outputs", "      p.stats_out[1] = waves;\n    }\n  }\n", "")]
SLOTS = 16
STAMPS = """
__device__ long long g_clock[4096];
__device__ unsigned long long g_timer[4096];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_clock[blockIdx.x * 16 + k] = clock64();
    g_timer[blockIdx.x * 16 + k] = t;
  }
}
"""
#: extra records of ``phase clock``: when the first staging thread has its
#: inputs in place (slot 14), and ``dirty`` on the third wave (slot 15)
EXTRA = [("        clean &= steady(v);\n      });\n    }\n  }\n",
          "    if (threadIdx.x == SEARCH_WARPS * 32) "
          "g_clock[blockIdx.x * 16 + 14] = clock64();\n"),
         ("    const bool full = *dirty != 0;\n",
          "    if (threadIdx.x == 0 && waves == 2) "
          "g_clock[blockIdx.x * 16 + 15] = *dirty;\n")]
STAMPS_OUT = """
extern "C" int repro_fused_stamps(void* clk, void* timer) {
  cudaError_t err = cudaMemcpyFromSymbol(clk, g_clock, sizeof(g_clock));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(timer, g_timer, sizeof(g_timer));
  return static_cast<int>(err);
}
"""


def phase_clock(source: str) -> str:
    """This tree's fused.cu (``runtime/waves.cuh`` inlined) with a time
    stamp after each phase."""
    out = replace(source, SEARCH_INCLUDE, SEARCH_INCLUDE + STAMPS,
                  "fused.cu")
    # the later anchors first: "other waves" contains "first wave"'s line
    for k, (_, line, cond) in reversed(list(enumerate(PHASES))):
        at = f"  if ({cond}) stamp({k});\n" if cond else f"  stamp({k});\n"
        if line.startswith("<"):   # the stamp goes before the line
            out = replace(out, line[1:], at + line[1:], "fused.cu")
        else:
            out = replace(out, line, line + at, "fused.cu")
    for line, record in EXTRA:
        out = replace(out, line, line + record, "fused.cu")
    return out + STAMPS_OUT


WAVE_WEIGHTS = ("    bool fresh = true;\n", "    if (!fresh) *dirty = 1;\n")


def wave_cuts(source: str) -> dict:
    """A copy whose waves skip the weights (for timing only)."""
    a, b = (source.index(x) for x in WAVE_WEIGHTS)
    return {"waves: counters only": source[:a] + WAVE_WEIGHTS[0] + source[b:]}


def report_phases(lib, call, blocks, what):
    """Runs ``call`` twice and prints, per phase, the median and the
    largest time since the stamp before, over the blocks that reached it
    (the SM clock converted at the rate block 0's two clocks give)."""
    import numpy as np
    call()
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * 4096)()
    timer = (ctypes.c_ulonglong * 4096)()
    ctypes.memset(clk, 0, ctypes.sizeof(clk))
    ctypes.memset(timer, 0, ctypes.sizeof(timer))
    if lib.repro_fused_stamps(clk, timer):   # clear the first call's
        raise RuntimeError("phase clock: copy failed")
    call()
    torch.cuda.synchronize()
    if lib.repro_fused_stamps(clk, timer):
        raise RuntimeError("phase clock: copy failed")
    k_all = len(PHASES)
    raw = np.array(clk[:blocks * SLOTS], dtype=np.float64).reshape(
        blocks, SLOTS)
    c = raw[:, :k_all]
    g = np.array(timer[:blocks * SLOTS], dtype=np.float64).reshape(
        blocks, SLOTS)[:, :k_all]
    print(f"phase clock, {what}: blocks whose third wave updates every "
          f"pair: {int((raw[:, 15] != 0).sum())} of {blocks}")
    ghz = (c[0, -1] - c[0, 0]) / (g[0, -1] - g[0, 0])
    start = g[:, 0].min()
    print(f"phase clock, {what}: SM clock {ghz:.3f} GHz; blocks enter over "
          f"{(g[:, 0].max() - start) / 1e3:.3f} us; the last block ends "
          f"{(g[:, -1].max() - start) / 1e3:.3f} us after the first entry")
    staged = raw[:, 14] != 0
    ask = (raw[staged, 14] - raw[staged, 0]) / ghz / 1e3
    if staged.any():
        print(f"phase clock, {what}: {'inputs in place (warps 8-15)':28s} "
              f"median {np.median(ask):7.3f} us, max {ask.max():7.3f} us "
              f"({int(staged.sum())} blocks)")
    for k in range(1, k_all):
        reached = c[:, k] != 0
        if not reached.any():
            continue
        prev = np.array([c[i, :k][c[i, :k] != 0][-1]
                         for i in np.flatnonzero(reached)])
        dt = (c[reached, k] - prev) / ghz / 1e3
        print(f"phase clock, {what}: {PHASES[k][0]:28s} median "
              f"{np.median(dt):7.3f} us, max {dt.max():7.3f} us "
              f"({int(reached.sum())} blocks)")


def build_fused(specs: dict) -> dict:
    """A library of fused.cu and the runtime alone for each ``name ->
    (fused.cu text, search.cuh text)`` (the parent's C interface differs
    from this tree's), one ``nvcc`` each, all started together."""
    from repro_torch.kernels import _build
    nvcc, procs = _build.find_nvcc(), {}
    for name, (fused, search_h) in specs.items():
        root = ROOT / "build" / "kernel_variants" / name.replace(" ", "_")
        shutil.rmtree(root, ignore_errors=True)
        for sub in ("fused", "runtime"):
            (root / sub).mkdir(parents=True)
        (root / "fused" / "fused.cu").write_text(fused)
        (root / "runtime" / "search.cuh").write_text(search_h)
        shutil.copy(_build.KERNELS_DIR / "runtime" / "runtime.cu",
                    root / "runtime" / "runtime.cu")
        lib = root / "libfused.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.ARCH_FLAGS, *_build.COMPILE_FLAGS, "-shared",
             str(root / "fused" / "fused.cu"),
             str(root / "runtime" / "runtime.cu"), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        print(f"built {name}: " + " ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "Used" in line or "spill" in line))
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].repro_fused_step.restype = ctypes.c_int
        libs[name].repro_fused_plan.restype = ctypes.c_int
    return libs


def fused_inputs(device):
    """The main path's fused step after a 500-step fused fit (as
    ``chip_smoke.py`` times it): w, c, s, drive, bern and the config."""
    from repro_torch.api import TopoMap
    from repro_torch.core import afm
    from repro_torch.data import make_dataset
    from repro_torch.kernels.fused import ops as fused_ops
    xtr, _, _, _ = make_dataset("mnist", device=device)
    cfg = afm.AFMConfig(side=30, dim=784, batch=16)
    tm = TopoMap(cfg, backend="kernel", backend_options={"kernel": "fused"},
                 device=device, seed=0).fit(xtr, num_steps=500)
    side, cap = cfg.side, fused_ops.DEFAULT_WAVE_CAP
    l_c, p_i = afm.schedule_values(tm.state_.i, cfg)
    gen = torch.Generator().manual_seed(9)
    drive = (torch.rand(8, side, side, generator=gen) < p_i).to(device)
    bern = (torch.rand(cap, 4, side, side, generator=gen) < p_i).to(device)
    return (tm.state_.w.contiguous(), tm.state_.c.reshape(side, side)
            .contiguous(), xtr[:cfg.batch].contiguous(), drive, bern, cfg,
            l_c)


def profile_fused(device, parent_dir):
    from repro_torch.kernels.fused import ops as fused_ops
    w, c, s, drive, bern, cfg, l_c = fused_inputs(device)
    (n, d), b, side = w.shape, s.shape[0], cfg.side
    here = ROOT / "src/repro_torch/kernels"
    trees = {}
    for tree, root in (("this tree", here), ("parent", parent_dir)):
        if root is None:
            continue
        root = Path(root)
        fused = inline_waves((root / "fused/fused.cu").read_text(),
                             root / "runtime")
        # an earlier kernel that plans on the card has another C interface
        trees[tree] = (fused, (root / "runtime/search.cuh").read_text(),
                       PARENT_BODY_START in fused)
    props = torch.cuda.get_device_properties(device)
    new_plan = fused_ops.plan(n, d, b, props.multi_processor_count,
                              props.shared_memory_per_block_optin)
    stream = torch.cuda.current_stream().cuda_stream
    out = dict(w=torch.empty_like(w), c=torch.empty_like(c),
               fired=torch.empty((side, side), dtype=torch.bool,
                                 device=device),
               stats=torch.empty(2, dtype=torch.int32, device=device),
               recv=torch.empty_like(c),
               gmu=torch.empty(b, dtype=torch.int32, device=device),
               q2=torch.empty(b, dtype=torch.float32, device=device))
    new_cplan = new_plan.c_array()        # kept alive for every call
    specs = {f"fused {tree} {variant}": (text, search_h)
             for tree, (fused, search_h, old) in trees.items()
             for variant, text in fused_variants(fused, old).items()}
    specs["phase clock"] = (phase_clock(trees["this tree"][0]),
                            trees["this tree"][1])
    for name, text in wave_cuts(trees["this tree"][0]).items():
        specs[name] = (text, trees["this tree"][1])
    libs = build_fused(specs)
    calls = {}
    for tree, (fused, search_h, old) in trees.items():
        for variant in fused_variants(fused, old):
            lib = libs[f"fused {tree} {variant}"]
            if old:                        # it plans on the card
                buf = (ctypes.c_int32 * 5)()
                err = lib.repro_fused_plan(n, d, b, ctypes.c_void_p(
                    ctypes.addressof(buf)))
                if err:
                    raise RuntimeError(f"fused {tree}: plan error {err}")
                grid, plan_arg = buf[1], []
            else:
                grid = new_plan.blocks
                plan_arg = [ctypes.c_void_p(ctypes.addressof(new_cplan))]
            scratch = torch.empty(2 * grid * b, dtype=torch.int32,
                                  device=device)

            def call(lib=lib, scratch=scratch, plan_arg=plan_arg, gmu=None,
                     budget=fused_ops.DEFAULT_WAVE_CAP, tree=tree):
                ptr = ctypes.c_void_p
                err = lib.repro_fused_step(
                    ptr(w.data_ptr()), ptr(c.data_ptr()), ptr(s.data_ptr()),
                    ptr(drive.data_ptr()), ptr(bern.data_ptr()),
                    ptr(None if gmu is None else gmu.data_ptr()), side, d, b,
                    cfg.theta, budget, 0, ctypes.c_float(cfg.l_s),
                    ctypes.c_float(l_c), ptr(out["w"].data_ptr()),
                    ptr(out["c"].data_ptr()), ptr(out["fired"].data_ptr()),
                    ptr(out["stats"].data_ptr()), ptr(out["recv"].data_ptr()),
                    ptr(out["gmu"].data_ptr()), ptr(out["q2"].data_ptr()),
                    ptr(scratch.data_ptr()), *plan_arg, ptr(stream))
                if err:
                    raise RuntimeError(f"fused {tree}: CUDA error {err}")

            if variant != "as is":
                calls[(tree, variant)] = call
                continue
            if tree == "this tree":
                clock = functools.partial(call, lib=libs["phase clock"])
                report_phases(libs["phase clock"], clock, new_plan.blocks,
                              "phase clock")
                calls[(tree, "phase clock")] = clock
                for name in wave_cuts(fused):
                    calls[(tree, name)] = functools.partial(call,
                                                            lib=libs[name])
            call()
            torch.cuda.synchronize()
            gmu = out["gmu"].clone()
            size, waves = out["stats"].tolist()
            print(f"fused {tree}: the timed call fires {size} sites in "
                  f"{waves} waves")
            calls[(tree, "as is")] = call
            calls[(tree, "given GMUs")] = lambda call=call, gmu=gmu: call(
                gmu=gmu)
            calls[(tree, "no waves")] = lambda call=call: call(budget=0)
    order = list(calls)
    x = torch.zeros(1, device=device)
    print(f"fused plan of this tree: {new_plan}, {new_plan.smem} shared "
          f"bytes a block")
    for rnd in range(2):
        print(f"round {rnd + 1}: an empty elementwise op, queued: "
              f"{queued_us(lambda: x.add_(1)):.3f} us")
        for key in (order if rnd == 0 else order[::-1]):
            print(f"round {rnd + 1}: fused_step (B {b}, N {n}, D {d}), "
                  f"{key[0]}, {key[1]}: {queued_us(calls[key]):.3f} us")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default="swa,fused")
    parser.add_argument("--parent", default=None,
                        help="a directory with another revision's "
                             "fused/fused.cu and runtime/search.cuh")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    kernels = args.kernels.split(",")
    if "fused" in kernels:
        profile_fused(device, args.parent)
    if "swa" in kernels:
        profile_swa(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
