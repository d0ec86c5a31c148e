"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Builds happen at first use
(or all at once, in parallel, through :func:`build_all`) into ``build/`` at
the root of the checkout, which ``.gitignore`` lists. ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside each library as
``<library>.log``. The Hopper pieces (TMA, mbarriers, ``wgmma``,
``setmaxnreg``) are inline PTX in ``csrc/sm90.cuh``, so no CUTLASS or CuTe
header and no extra include path is needed; the four libraries build in
about 7 s, in parallel, on the H100 machine (``chip_smoke.py``'s build line).

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not 0, so a refused launch is never
silent. The libraries are loaded as ``ctypes.PyDLL``: an entry point only
enqueues launches, so the call keeps the GIL rather than releasing and
retaking it: host time that counts where a kernel's device time is as short
as the head's at serving batch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("prod_head", "flash_attention", "decode_attention", "ssd_scan")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.PyDLL] = {}
_FUNCS: Dict[str, object] = {}
_WORKSPACE: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and under CUDA_HOME); "
                       "the port's kernels are built from csrc/ with nvcc")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    log = open(f"{out}.log", "w")
    try:
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", f"{out}.tmp", str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> List[Path]:
    """Build every missing library, one ``nvcc`` per source, all at once;
    every ``nvcc`` is waited for before a failure is raised."""
    names = list(names)
    with _LOCK:
        paths = {n: _lib_path(n) for n in names}
        procs = {n: _start(n, p) for n, p in paths.items() if not p.exists()}
        codes = {n: proc.wait() for n, proc in procs.items()}
        for n, code in codes.items():
            if code != 0:
                raise RuntimeError(f"nvcc failed for {n}.cu:\n"
                                   + Path(f"{paths[n]}.log").read_text())
            os.replace(f"{paths[n]}.tmp", paths[n])
    return [paths[n] for n in names]


def load(name: str) -> ctypes.PyDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[0]
        with _LOCK:
            lib = _LIBS.get(name) or ctypes.PyDLL(str(path))
            _LIBS[name] = lib
    return lib


def entry(name: str, n_pointers: int, n_ints: int, n_floats: int = 0):
    """The C entry point ``<name>_launch`` of ``csrc/<name>.cu`` with its
    signature set: pointers (the stream last among them) as ``c_void_p``,
    then ints, then floats; it returns a ``cudaError_t``."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(load(name), f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                       + [ctypes.c_float] * n_floats)
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


DTYPE_CODES = {"float32": 0, "bfloat16": 1}    # as in csrc/common.cuh
_DTYPE_NAMES: Dict[object, str] = {}             # torch dtype -> "float32", ...


def require(t, name: str, dtypes=("float32",), shape=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of an accepted dtype
    (and of ``shape``, a tuple, / on ``device`` when given). Returns its
    dtype code. It runs on every launch, so it keeps to cheap lookups."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dt = _DTYPE_NAMES.get(t.dtype)
    if dt is None:
        dt = _DTYPE_NAMES.setdefault(t.dtype, str(t.dtype).replace("torch.", ""))
    if dt not in dtypes:
        raise TypeError(f"{name}: dtype {dt} not in {dtypes}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return DTYPE_CODES.get(dt, -1)


def workspace(kernel: str, dev: torch.device, stream: int, n_floats: int,
              n_counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fp32 scratch, int32 counters) of ``kernel`` for a call on ``stream``,
    kept per (kernel, device, stream) and grown when a call needs more, as
    cuBLAS keeps its workspace: calls on one stream run in order. The
    counters are zeroed when they are made; the kernels set every counter
    they complete back to 0. A call captured into a CUDA graph gets a
    workspace of its own, which the graph keeps: a graph may be replayed on
    any stream."""
    capturing = torch.cuda.is_current_stream_capturing()
    key = (kernel, dev, stream)
    ws = None if capturing else _WORKSPACE.get(key)
    if ws is None or ws[0].numel() < n_floats or ws[1].numel() < n_counters:
        ws = (torch.empty(max(n_floats, 1), dtype=torch.float32, device=dev),
              torch.zeros(max(n_counters, 1), dtype=torch.int32, device=dev))
        if not capturing:
            _WORKSPACE[key] = ws
    return ws
