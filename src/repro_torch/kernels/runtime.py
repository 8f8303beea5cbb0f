"""Build, load and dispatch policy for the hand-written kernels.

Counterpart of ``repro/kernels/runtime.py`` (which picks Pallas interpret
mode). Here the policy is fixed by where the tensors lie:

* a CPU tensor goes to the kernel's plain PyTorch version (``ref.py``);
* a CUDA tensor goes to the kernel, or the wrapper raises. There is no
  switch that turns the kernels off on CUDA, and no fallback.

Kernels are CUDA C++ for ``sm_90a`` (``repro_torch/csrc/*.cu``) with a plain C
interface, built with ``nvcc`` at first use into ``repro_torch/build/`` (one
shared library per source, all sources compiled in parallel) and loaded with
``ctypes``. A library's file name carries a hash of its source and the flags,
so an edited source is rebuilt. ``--use_fast_math`` is deliberately absent: it
implies flush-to-zero, and the sign and selection semantics depend on exact
IEEE compares of denormals, -0.0, inf and NaN.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card; :func:`reset_launches` zeroes it. :func:`kernel_cost` charges a
wrapper's analytic bytes and FLOPs to an open op count (the dry-run's),
:func:`collective_cost` a collective's bytes.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills, kept in build/<name>.log
)

# Largest dynamic shared memory one block may opt into on Hopper (227 KB).
MAX_SMEM_BYTES = 232448

LAUNCHES: collections.Counter = collections.Counter()
# the op counts open (launch/op_cost.py), innermost last: kernel_cost charges it
COUNTS: list = []

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


@contextlib.contextmanager
def collective_cost(kind: str, nbytes: float):
    """Charge a collective's result-shape bytes to the innermost open op
    count under ``kind`` (``all-gather``, ``reduce-scatter``, ``all-reduce``)
    as link traffic, and hide the body (the call into the process group)
    from it. No count open: the body runs as it is."""
    if not COUNTS:
        yield
        return
    count = COUNTS[-1]
    count.charge(kind, nbytes, collective=True)
    with count.paused():
        yield


@contextlib.contextmanager
def kernel_cost(name: str, nbytes: float, flops: float = 0.0):
    """Charge a hand kernel's analytic bytes and FLOPs (PERF.md's kernel
    table: each input read once, each output written once) to the innermost
    open op count (:func:`repro_torch.launch.op_cost.counting`), if any, and
    hide the body from it: the launch, or the plain version on the CPU or
    ``meta``, whose own ops are not the kernel's work. No count open: the
    body runs as it is."""
    if not COUNTS:
        yield
        return
    count = COUNTS[-1]
    count.charge(f"kernel:{name}", nbytes, flops)
    with count.paused():
        yield


def resolve_device(device, *, meta_ok: bool = False) -> torch.device:
    """``torch.device(device)``, raising if CUDA is asked for and absent.

    Entry points default to ``"cuda"``; on a machine without a card that
    default raises here instead of quietly running on the CPU. ``meta_ok``:
    the caller also builds shapes without storage (``device="meta"``, the
    dry-run's count, :mod:`repro_torch.launch`); no default ever picks it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu") and not (meta_ok and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the card, False if every one lies on the
    CPU or every one on ``meta`` (shapes only: the plain version runs there
    for the dry-run's count); raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors must all lie on one of cpu/cuda, got {sorted(kinds)}")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): cannot build the kernels")
    return found


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every stale ``csrc/*.cu`` into ``build/`` (one ``nvcc`` per
    source, all started together); return {stem: library path}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    pending = []
    for stem, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((stem, out, tmp, proc))
    failed = []
    for stem, out, tmp, proc in pending:
        log, _ = proc.communicate()
        (BUILD / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def function(lib: str, name: str, argtypes: list):
    """The C entry point ``name`` of ``csrc/<lib>.cu``, built and loaded on
    first use, with its ``argtypes`` declared and ``int`` result."""
    key = (lib, name)
    with _lock:
        if key not in _fns:
            if lib not in _libs:
                _libs[lib] = ctypes.CDLL(str(build_all()[lib]))
            fn = getattr(_libs[lib], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[key] = fn
    return _fns[key]
