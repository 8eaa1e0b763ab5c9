"""Builds the port's CUDA kernels into one shared library and loads it.

At first use every ``kernels/*/*.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source, all started together, then linked into ``build/repro_torch/
librepro_torch_<hash>.so``. The hash covers the sources, the headers they
share (``kernels/*/*.cuh``) and the flags, so an edit to any of them
rebuilds. The library has a plain C interface (no PyTorch headers) and
is loaded with ``ctypes``: every pointer and the stream are ``c_void_p``,
every size ``c_int``, and every entry point returns ``cudaGetLastError()``
after its launch, which ``check`` turns into an exception.

Nothing here runs at import time: the CPU never builds or loads the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DEFAULT_CUDA_HOME = Path("/usr/local/cuda")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry points: name -> argument types (all return a cudaError_t as int)
SIGNATURES = {
    # w, s, n, b, d, bf16, sample_tile, splits, part_v, part_i (scratch of
    # (splits, b) f32 / int32), idx_out, q2_out, stream
    "repro_bmu": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # c, fired, bern, side, theta, c_out, fired_out, recv_out, stream
    "repro_cascade_wave": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    # n, d, plan (int32[5] from cascade ops.CascadePlan.c_array), out
    # (int32[2]: SMs, shared bytes a block may opt into)
    "repro_cascade_plan": [_I, _I, _P, _P],
    # w, c, counts, drive, bern, side, d, theta, budget, l_c, w_out, c_out,
    # fired_out, stats_out, recv_out, plan (int32[5]), stream
    "repro_drive_cascade": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P,
                            _P, _P, _P, _P, _P],
    # n, d, b, plan (int32[8] from fused ops.Plan.c_array), out (int32[3]:
    # SMs, shared bytes a block may opt into, blocks that fit at once)
    "repro_fused_plan": [_I, _I, _I, _P, _P],
    # w, c, s, drive, bern, gmu_in (NULL: search in the kernel), side, d, b,
    # theta, budget, bf16, l_s, l_c, w_out, c_out, fired_out, stats_out,
    # recv_out, gmu_out, q2_out, scratch, plan (int32[8]), stream
    "repro_fused_step": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # q, k, v, b, s, h, hkv, hd, rows (query rows a block), out, lse, stream
    "repro_flash_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # q, k, v, out, d_out, lse, b, s, h, hkv, hd, delta, dq_acc (f32
    # scratch), dq, dk, dv, stream
    "repro_flash_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                        _P, _P, _P, _P],
    # q, k, v, pos, b, hkv, w, rep, hd, bf16, splits, slots, part_ml,
    # part_acc (f32 scratch), tickets (int32, zero; all three NULL with one
    # split), out, stream
    "repro_swa_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P, _P, _P, _P],
}

_library: ctypes.CDLL | None = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory,
#: spills per kernel) and how long it took; empty when the library was cached
build_log = ""
build_seconds = 0.0


def sources() -> list[Path]:
    return sorted(KERNELS_DIR.glob("*/*.cu"))


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(DEFAULT_CUDA_HOME / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "repro_torch's CUDA kernels need nvcc to build, and none was found "
        "(looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")


def headers() -> list[Path]:
    """The headers the sources share (``kernels/*/*.cuh``)."""
    return sorted(KERNELS_DIR.glob("*/*.cuh"))


def library_path(srcs: list[Path] | None = None,
                 hdrs: list[Path] | None = None) -> Path:
    srcs = sources() if srcs is None else srcs
    hdrs = headers() if hdrs is None else hdrs
    digest = hashlib.sha256(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for src in srcs + hdrs:
        digest.update(f"{src.parent.name}/{src.name}".encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless a build of these sources exists."""
    global build_log, build_seconds
    srcs = sources()
    target = library_path(srcs)
    if target.exists():
        return target
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.parent.name + ".o") for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        staged = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link:\n{link.stdout}")
        os.replace(staged, target)   # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - start
    build_log = "".join(logs) + link.stdout
    return target


def load() -> ctypes.CDLL:
    """The built library with its signatures declared (built on first use)."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer int."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
