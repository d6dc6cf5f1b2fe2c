"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``build/ptnn_torch/<name>-<hash>.so``
at the root of the checkout, keyed by a hash of the source, of the
``csrc/*.cuh`` headers it includes and of the flags, and loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises. Nothing is compiled
at import time; ``build_all`` compiles several sources in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ptnn_torch"
# no --use_fast_math: the kernels keep IEEE expf and division
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    seconds: float  # compile time in this process; 0.0 when it was on disk
    log: str  # nvcc's output (ptxas register and shared-memory report)


_loaded: Dict[str, Built] = {}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install prefix."""
    cands = [
        os.path.join(os.environ[v], "bin", "nvcc")
        for v in ("CUDA_HOME", "CUDA_PATH")
        if os.environ.get(v)
    ]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of ptnn_torch are "
        "compiled from source at first use"
    )


def _compile(name: str):
    """Compile ``csrc/<name>.cu`` unless its ``.so`` is on disk; returns
    ``(path, nvcc seconds, nvcc output)``."""
    src = _CSRC / f"{name}.cu"
    key = hashlib.sha256(
        b"".join(p.read_bytes() for p in _sources(src))
        + " ".join(FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{key}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    return so, seconds, log


def build(name: str, compiled=None) -> Built:
    """Compile (if needed) and load ``csrc/<name>.cu``; cached per process.
    ``compiled`` is ``_compile``'s result when it already ran."""
    if name in _loaded:
        return _loaded[name]
    so, seconds, log = compiled if compiled is not None else _compile(name)
    lib = ctypes.CDLL(str(so))
    _declare(name, lib)
    _loaded[name] = Built(lib, so, seconds, log)
    return _loaded[name]


def _sources(src: Path) -> List[Path]:
    """``src`` and the ``csrc`` headers it includes, transitively, in a
    fixed order: a header edit changes the cache key."""
    out, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (_CSRC / inc).is_file():
                todo.append(_CSRC / inc)
    return out


def build_all(names: List[str]) -> Dict[str, Built]:
    """``build`` every name, the compilations in parallel (one nvcc per
    source)."""
    todo = [n for n in names if n not in _loaded]
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        futures = {n: pool.submit(_compile, n) for n in todo}
        compiled = {n: fut.result() for n, fut in futures.items()}
    return {n: build(n, compiled.get(n)) for n in names}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    lib.ptnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ptnn_cuda_error_string.restype = ctypes.c_char_p
    if name in ("mala_block", "hmc_block"):
        from ptnn_torch.ops.precond_step import PrecondParams, _WARPS

        launch = getattr(lib, f"ptnn_{name}")
        launch.argtypes = [ctypes.POINTER(PrecondParams), ctypes.c_int] + (
            [ctypes.c_int] if name == "hmc_block" else []) + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_precond_params_size",
                     ctypes.sizeof(PrecondParams), "PrecondParams size")
        _check_query(lib, name, "ptnn_precond_warps", _WARPS, "WARPS")
        _check_query(lib, name, "ptnn_precond_w_size", 61,
                     "the (4, 10, 1) w_size")
    if name in ("mala_cls_block", "hmc_cls_block"):
        from ptnn_torch.ops.precond_cls_step import ClsPrecondParams
        from ptnn_torch.ops.precond_step import _WARPS

        launch = getattr(lib, f"ptnn_{name}")
        launch.argtypes = [ctypes.POINTER(ClsPrecondParams), ctypes.c_int] + (
            [ctypes.c_int] if name == "hmc_cls_block" else []) + [
            ctypes.c_void_p]
        launch.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_cls_params_size",
                     ctypes.sizeof(ClsPrecondParams), "ClsPrecondParams size")
        _check_query(lib, name, "ptnn_cls_warps", _WARPS, "CLS_WARPS")
        _check_query(lib, name, "ptnn_cls_w_size", 99, "the (4, 12, 3) w_size")
    if name == "rw_cls_block":
        from ptnn_torch.ops.block_step import _ClsRwParams, _THREADS

        lib.ptnn_rw_cls_block.argtypes = [
            ctypes.POINTER(_ClsRwParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_rw_cls_block.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_rw_cls_params_size",
                     ctypes.sizeof(_ClsRwParams), "ClsRwParams size")
        _check_query(lib, name, "ptnn_rw_cls_block_threads", _THREADS,
                     "RW_THREADS")
    if name == "rw_block":
        from ptnn_torch.ops.block_step import _RwParams, _THREADS

        lib.ptnn_rw_block.argtypes = [
            ctypes.POINTER(_RwParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_rw_block.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_rw_params_size",
                     ctypes.sizeof(_RwParams), "RwParams size")
        _check_query(lib, name, "ptnn_rw_block_threads", _THREADS, "THREADS")


def _check_query(lib: ctypes.CDLL, name: str, fn: str, want: int,
                 what: str) -> None:
    """Call the library's int query ``fn`` and raise unless it is ``want``:
    the .cu and its Python mirror must agree."""
    f = getattr(lib, fn)
    f.argtypes = []
    f.restype = ctypes.c_int
    got = f()
    if got != want:
        raise RuntimeError(f"{what} differs between {name}.cu ({got}) and "
                           f"its Python mirror ({want})")


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{lib.ptnn_cuda_error_string(err).decode()} (cudaError {err})"
