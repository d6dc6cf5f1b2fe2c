"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` (the six ``*_block.cu``, ``drift_epoch.cu``,
``fnn_eval.cu`` and ``conv1_relu_pool.cu``) has a plain C interface. At first use it is compiled
by ``nvcc`` for Hopper (``sm_90a``) into ``build/ptnn_torch/<name>-<hash>.so``
at the root of the checkout, keyed by a hash of the source, of the
``csrc/*.cuh`` headers it includes and of the flags, and loaded with
``ctypes``. A missing ``nvcc`` or a failed build raises. Nothing is compiled
at import time; ``build_all`` compiles several sources in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Tuple

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


@functools.lru_cache(maxsize=None)
def cu_define(source: str, name: str) -> int:
    """The integer of ``#define name <int>`` in ``csrc/<source>``."""
    text = (_CSRC / source).read_text()
    m = re.search(rf"^\s*#\s*define\s+{name}\s+(\d+)\b", text, re.M)
    if m is None:
        raise RuntimeError(f"no '#define {name} <int>' in csrc/{source}")
    return int(m.group(1))


@functools.lru_cache(maxsize=None)
def cu_rows(source: str, macro: str) -> Tuple[Tuple[int, ...], ...]:
    """The ``X(a, b, ...)`` rows of the table macro ``macro`` in
    ``csrc/<source>`` (a ``#define macro(X)`` continued with backslashes),
    as tuples of ints, in order."""
    text = (_CSRC / source).read_text()
    m = re.search(rf"^\s*#\s*define\s+{macro}\(X\)((?:.*\\\n)*.*)$", text,
                  re.M)
    if m is None:
        raise RuntimeError(f"no table macro {macro}(X) in csrc/{source}")
    return tuple(tuple(int(v) for v in row.split(","))
                 for row in re.findall(r"X\(([\d,\s]+)\)", m.group(1)))


class PtxasEntry(NamedTuple):
    kernel: str  # the mangled entry name
    registers: int
    spill_stores: int  # bytes
    spill_loads: int  # bytes
    stack_frame: int = 0  # bytes of local memory a thread, spills or not


def ptxas_report(log: str) -> List[PtxasEntry]:
    """Registers, spill bytes and stack frame of each kernel entry in
    nvcc's ``-Xptxas -v`` output."""
    out, entry, props = [], None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append(PtxasEntry(entry, int(m.group(1)), props[1], props[2],
                                  props[0]))
            entry, props = None, (0, 0, 0)
    return out


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
        from ptnn_torch.ops import precond_step as ps

        hmc = name == "hmc_block"
        launch = getattr(lib, f"ptnn_{name}")
        launch.argtypes = [ctypes.POINTER(ps.PrecondParams), ctypes.c_int] + (
            [ctypes.c_int, ctypes.c_int] if hmc else [ctypes.c_int]) + [
            ctypes.c_void_p]
        launch.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_precond_params_size",
                     ctypes.sizeof(ps.PrecondParams), "PrecondParams size")
        if not hmc:
            _check_query(lib, name, "ptnn_mala_threads",
                         32 * ps._mala_warps(), "MALA_THREADS")
        _check_query(lib, name, "ptnn_precond_w_size", 61,
                     "the (4, 10, 1) w_size")
        if hmc:
            _check_query(lib, name, "ptnn_hmc_warps", ps._hmc("HMC_WARPS"),
                         "HMC_WARPS")
            _check_query(lib, name, "ptnn_hmc_max_cluster",
                         ps._hmc("HMC_MAX_CLUSTER"), "HMC_MAX_CLUSTER")
            lib.ptnn_hmc_max_active_clusters.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.ptnn_hmc_max_active_clusters.restype = ctypes.c_int
            lib.ptnn_hmc_coop_blocks.argtypes = [
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.ptnn_hmc_coop_blocks.restype = ctypes.c_int
        _declare_gen(name, lib, ctypes.POINTER(ps.PrecondParams))
    if name in ("mala_cls_block", "hmc_cls_block"):
        from ptnn_torch.ops import precond_cls_step as pcs

        P = ctypes.POINTER(pcs.ClsPrecondParams)
        if name == "mala_cls_block":
            lib.ptnn_mala_cls_block.argtypes = [P, ctypes.c_int, ctypes.c_int,
                                                ctypes.c_int, ctypes.c_void_p]
            lib.ptnn_mala_cls_block.restype = ctypes.c_int
            _check_query(lib, name, "ptnn_mala_cls_threads",
                         32 * pcs._mala_warps(), "MALA_CLS_THREADS")
        else:
            i = ctypes.c_int
            lib.ptnn_hmc_cls_block.argtypes = [P, ctypes.c_void_p, i, i, i, i,
                                               i, ctypes.c_void_p]
            lib.ptnn_hmc_cls_block.restype = i
            lib.ptnn_hmc_cls_max_active_clusters.argtypes = [
                i, i, i, i, ctypes.POINTER(i)]
            lib.ptnn_hmc_cls_max_active_clusters.restype = i
            lib.ptnn_hmc_cls_coop_blocks.argtypes = [i, i, i,
                                                     ctypes.POINTER(i)]
            lib.ptnn_hmc_cls_coop_blocks.restype = i
            for query, define in (("ptnn_hmc_cls_threads", "HMC_CLS_THREADS"),
                                  ("ptnn_hmc_cls_max_cluster",
                                   "HMC_CLS_MAX_CLUSTER")):
                _check_query(lib, name, query, pcs._hmc(define), define)
        _check_query(lib, name, "ptnn_cls_params_size",
                     ctypes.sizeof(pcs.ClsPrecondParams),
                     "ClsPrecondParams size")
        _check_query(lib, name, "ptnn_cls_part", pcs._part(), "CLS_PART")
        _declare_gen(name, lib, P)
        for topo in pcs.TOPOLOGIES:
            n_in, hid, n_out = topo
            _check_query(lib, name, "ptnn_cls_w_size",
                         n_in * hid + hid + hid * n_out + n_out,
                         f"the {topo} w_size", hid)
    if name == "rw_cls_block":
        from ptnn_torch.ops import block_step as bs

        i = ctypes.c_int
        lib.ptnn_rw_cls_block.argtypes = [ctypes.POINTER(bs._ClsRwParams), i,
                                          i, i, ctypes.c_void_p]
        lib.ptnn_rw_cls_block.restype = i
        _check_query(lib, name, "ptnn_rw_cls_params_size",
                     ctypes.sizeof(bs._ClsRwParams), "ClsRwParams size")
        _check_query(lib, name, "ptnn_rw_cls_block_threads", bs._THREADS,
                     "RW_THREADS")
        for query, want, width in (
                ("ptnn_rw_cls_fixed_layouts", bs.cls_fixed_topologies(), 3),
                ("ptnn_rw_cls_warps", tuple(
                    (w,) for w in sorted(bs.cls_warps(), reverse=True)), 1)):
            buf = (i * (width * len(want)))()
            fn = getattr(lib, query)
            fn.argtypes = [ctypes.c_void_p, i]
            fn.restype = i
            n = fn(buf, len(want))
            got = tuple(tuple(buf[width * k:width * (k + 1)])
                        for k in range(min(n, len(want))))
            if n != len(want) or got != want:
                raise RuntimeError(f"{query} of the built library ({n} rows) "
                                   f"differs from rw_cls_block.cu's table")
        lib.ptnn_rw_cls_smem_floats.argtypes = [i] * 6
        lib.ptnn_rw_cls_smem_floats.restype = i
        for topo in bs.cls_fixed_topologies() + ((11, 50, 10),):
            for kind, warps in [("generic", 0)] + [
                    ("fixed", w) for w in bs.cls_warps()]:
                want = bs.cls_smem_bytes(699, topo, kind, warps)
                got = 4 * lib.ptnn_rw_cls_smem_floats(
                    699, *topo, int(kind == "fixed"), warps)
                if got != want:
                    raise RuntimeError(f"rw_cls_block shared memory of {topo} "
                                       f"({kind}, {warps} warps) differs "
                                       f"between rw_cls_block.cu ({got}) and "
                                       f"its Python mirror ({want})")
    if name == "drift_epoch":
        from ptnn_torch.ops import drift

        lib.ptnn_drift_epoch.argtypes = [
            ctypes.POINTER(drift._DriftParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_drift_epoch.restype = ctypes.c_int
        lib.ptnn_drift_epoch_reg.argtypes = [
            ctypes.POINTER(drift._DriftParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_drift_epoch_reg.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_drift_params_size",
                     ctypes.sizeof(drift._DriftParams), "DriftParams size")
        for query, define in (("ptnn_drift_warps", "WARPS"),
                              ("ptnn_drift_hid_per_lane", "HPL"),
                              ("ptnn_drift_reg_threads", "REG_THREADS")):
            _check_query(lib, name, query, drift._define(define), define)
        rows = tuple(r[:4] for r in cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS"))
        buf = (ctypes.c_int * (4 * len(rows)))()
        lib.ptnn_drift_reg_layouts.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ptnn_drift_reg_layouts.restype = ctypes.c_int
        n = lib.ptnn_drift_reg_layouts(buf, len(rows))
        got = tuple(tuple(buf[4 * k:4 * k + 4])
                    for k in range(min(n, len(rows))))
        if n != len(rows) or got != rows:
            raise RuntimeError(f"FNN_LAYOUTS (I, H, O, G) of the built "
                               f"library ({n} rows) differs from the source's")
    if name == "fnn_eval":
        from ptnn_torch.ops import fnn_eval as ev

        lib.ptnn_fnn_eval.argtypes = [
            ctypes.POINTER(ev._EvalParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_fnn_eval.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_eval_params_size",
                     ctypes.sizeof(ev._EvalParams), "EvalParams size")
        _check_query(lib, name, "ptnn_eval_max_out", ev._MAX_OUT, "MAX_OUT")
        _check_query(lib, name, "ptnn_eval_max_cluster", ev._MAX_CLUSTER,
                     "MAX_CLUSTER")
        rows = tuple(r[:3] + r[4:]
                     for r in cu_rows("fnn_layouts.cuh", "FNN_LAYOUTS"))
        buf = (ctypes.c_int * (4 * len(rows)))()
        lib.ptnn_eval_layouts.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ptnn_eval_layouts.restype = ctypes.c_int
        n = lib.ptnn_eval_layouts(buf, len(rows))
        got = tuple(tuple(buf[4 * k:4 * k + 4])
                    for k in range(min(n, len(rows))))
        if n != len(rows) or got != rows:
            raise RuntimeError(f"FNN_LAYOUTS (I, H, O, HPW) of the built "
                               f"library ({n} rows) differs from the source's")
        _check_query(lib, name, "ptnn_eval_max_warps", ev._MAX_WARPS,
                     "MAX_WARPS")
        _check_query(lib, name, "ptnn_eval_gen_warps",
                     cu_define("fnn_eval.cu", "GEN_WARPS"), "GEN_WARPS")
        lib.ptnn_eval_smem_floats.argtypes = [ctypes.c_int] * 8
        lib.ptnn_eval_smem_floats.restype = ctypes.c_int
        for topo, groups in (((34, 50, 2), (1, 10, 1, 34, 2)),
                             ((5, 40, 32), (3, 5, 1, 5, 32)),
                             ((900, 16, 40), (1, 4, 0, 300, 32))):
            want = ev.smem_floats(topo, *groups)
            got = lib.ptnn_eval_smem_floats(*topo, *groups)
            if got != want:
                raise RuntimeError(f"eval shared memory of {topo} differs "
                                   f"between fnn_eval.cu ({got}) and its "
                                   f"Python mirror ({want})")
    if name == "conv1_relu_pool":
        from ptnn_torch.ops.conv_stage import _ConvParams

        lib.ptnn_conv1_relu_pool.argtypes = [
            ctypes.POINTER(_ConvParams), ctypes.c_int, ctypes.c_void_p
        ]
        lib.ptnn_conv1_relu_pool.restype = ctypes.c_int
        _check_query(lib, name, "ptnn_conv_params_size",
                     ctypes.sizeof(_ConvParams), "ConvParams size")
        want = tuple(cu_define("conv1_relu_pool.cu", d) for d in (
            "FIXED_HW", "FIXED_IN", "FIXED_OUT", "FIXED_EPT", "FIXED_CHAINS"))
        buf = (ctypes.c_int * len(want))()
        lib.ptnn_conv_fixed.argtypes = [ctypes.c_void_p]
        lib.ptnn_conv_fixed.restype = ctypes.c_int
        if lib.ptnn_conv_fixed(buf) != len(want) or tuple(buf) != want:
            raise RuntimeError(f"the fixed conv shape of the built library "
                               f"{tuple(buf)} differs from the source's {want}")
    if name == "rw_block":
        from ptnn_torch.models import fnn
        from ptnn_torch.ops import block_step as bs

        i = ctypes.c_int
        lib.ptnn_rw_block.argtypes = [ctypes.POINTER(bs._RwParams), i, i, i,
                                      ctypes.c_void_p]
        lib.ptnn_rw_block.restype = i
        _check_query(lib, name, "ptnn_rw_params_size",
                     ctypes.sizeof(bs._RwParams), "RwParams size")
        _check_query(lib, name, "ptnn_rw_block_threads", bs._THREADS,
                     "THREADS")
        rows = tuple(t[:2] for t in bs.fixed_topologies())
        buf = (i * (2 * len(rows)))()
        lib.ptnn_rw_fixed_layouts.argtypes = [ctypes.c_void_p, i]
        lib.ptnn_rw_fixed_layouts.restype = i
        n = lib.ptnn_rw_fixed_layouts(buf, len(rows))
        got = tuple(tuple(buf[2 * k:2 * k + 2])
                    for k in range(min(n, len(rows))))
        if n != len(rows) or got != rows:
            raise RuntimeError(f"the fixed-shape (I, H) of the built library "
                               f"({n} rows) differ from FNN_LAYOUTS'")
        lib.ptnn_rw_fixed_smem_floats.argtypes = [i] * 4
        lib.ptnn_rw_fixed_smem_floats.restype = i
        for topo in bs.fixed_topologies():
            for warps in bs.RW_WARPS:
                want = bs.smem_bytes(497, topo, warps)
                got = 4 * lib.ptnn_rw_fixed_smem_floats(
                    497, topo[0], fnn.w_size(topo), warps)
                if got != want:
                    raise RuntimeError(f"rw_block shared memory of {topo} at "
                                       f"{warps} warps differs between "
                                       f"rw_block.cu ({got}) and its Python "
                                       f"mirror ({want})")


def _declare_gen(name: str, lib: ctypes.CDLL, params) -> None:
    """The generic route's entry points of a MALA / HMC library
    (csrc/gen_chain.cuh): ``<prefix>(params, shape, [exch,] vectors, smem,
    [cluster, route,] stream)`` and, for HMC, its occupancy queries
    ``<prefix>_max_active_clusters(threads, smem, cluster, *out)`` and
    ``<prefix>_coop_blocks(threads, smem, *out)``."""
    from ptnn_torch.ops import precond_step as ps

    i, v = ctypes.c_int, ctypes.c_void_p
    prefix = {"mala_block": "ptnn_mala_gen", "hmc_block": "ptnn_hmc_gen",
              "mala_cls_block": "ptnn_mala_cls_gen",
              "hmc_cls_block": "ptnn_hmc_cls_gen"}[name]
    shape = ctypes.POINTER(ps.GenShape)
    launch = getattr(lib, prefix)
    if name == "hmc_block":  # the exchange slots ride in PrecondParams
        launch.argtypes = [params, shape, v, i, i, i, v]
    elif name == "hmc_cls_block":
        launch.argtypes = [params, shape, v, v, i, i, i, v]
    else:
        launch.argtypes = [params, shape, v, i, v]
    launch.restype = i
    if name.startswith("hmc"):
        getattr(lib, f"{prefix}_max_active_clusters").argtypes = [
            i, i, i, ctypes.POINTER(i)]
        getattr(lib, f"{prefix}_max_active_clusters").restype = i
        getattr(lib, f"{prefix}_coop_blocks").argtypes = [
            i, i, ctypes.POINTER(i)]
        getattr(lib, f"{prefix}_coop_blocks").restype = i
    _check_query(lib, name, "ptnn_gen_shape_size",
                 ctypes.sizeof(ps.GenShape), "GenShape size")
    _check_query(lib, name, "ptnn_gen_part", cu_define("gen_chain.cuh",
                                                       "GEN_PART"), "GEN_PART")


def _check_query(lib: ctypes.CDLL, name: str, fn: str, want: int,
                 what: str, *args: int) -> None:
    """Call the library's int query ``fn`` (on int ``args``) and raise
    unless it is ``want``: the .cu and its Python mirror must agree."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_int] * len(args)
    f.restype = ctypes.c_int
    got = f(*args)
    if got != want:
        raise RuntimeError(f"{what} differs between {name}.cu ({got}) and "
                           f"its Python mirror ({want})")


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{lib.ptnn_cuda_error_string(err).decode()} (cudaError {err})"
