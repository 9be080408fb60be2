"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` alone (no PyTorch headers) into ``build/repro_torch/<name>-<hash>.so``
beside the source checkout, at first use.  The file name carries a hash
of the source and the flags, so an edited kernel rebuilds and a stale
library is never loaded.  ``build_all`` starts one ``nvcc`` per source
at once.  What ``nvcc`` printed is kept beside the library
(:func:`build_log`): ``ptxas``'s count of registers, shared memory and
spills of every kernel.

Every wrapper counts its launches in :data:`LAUNCHES` under its kernel's
name through :func:`count` (one per kernel launch, nowhere else;
:data:`KERNELS` lists the names), which is how a run shows that a path
went through the kernels.  A library may hold more than one kernel, so
the counts are per kernel, not per library.  The fleet launches from
several threads at once, and ``Counter`` increments are read-modify-write,
so every count, read and reset of the counts takes one lock.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: <checkout>/build/repro_torch when running from src/ (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: ``-Xptxas -v``: ptxas's resource report of every kernel, kept beside
#: the library (:func:`build_log`)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

C_INT, C_PTR = ctypes.c_int, ctypes.c_void_p
C_I64, C_FLOAT = ctypes.c_longlong, ctypes.c_float

#: C signature of every exported function, per library
SIGNATURES = {
    "sketch_conv": {
        "sketch_conv_launch": [C_PTR, C_PTR, C_PTR, C_INT, C_INT, C_INT,
                               C_INT, C_INT, C_INT, C_PTR],
        "sketch_conv_smem_bytes": [C_INT, C_INT, C_INT],
    },
    "collision_count": {
        "collision_count_batch_launch": [C_PTR, C_PTR, C_PTR, C_INT, C_INT,
                                         C_INT, C_PTR],
        "collision_count_launch": [C_PTR, C_PTR, C_PTR, C_INT, C_INT,
                                   C_PTR],
        "collision_count_max_k": [],
    },
    "dtw_wavefront": {
        "dtw_wavefront_pairs_launch": [C_PTR, C_PTR, C_PTR, C_PTR, C_PTR,
                                       C_INT, C_INT, C_INT, C_INT, C_INT,
                                       C_PTR],
        "dtw_wavefront_launch": [C_PTR, C_PTR, C_PTR, C_INT, C_PTR, C_INT,
                                 C_INT, C_INT, C_INT, C_INT, C_PTR],
        "dtw_rows_max_radius": [],
        "dtw_pairs_max_radius": [],
        "dtw_smem_bytes": [C_INT, C_INT, C_INT, C_INT],
        "dtw_max_length": [],
    },
    "count_sketch": {
        "cs_tables_launch": [C_PTR, C_PTR, C_PTR, C_INT, C_INT, C_INT,
                             C_PTR],
        "cs_tables_max_width": [],
    },
    "flash_attention": {
        "flash_attention_tc_launch": [C_PTR, C_PTR, C_PTR, C_PTR, C_INT,
                                      C_INT, C_INT, C_INT, C_INT, C_INT,
                                      C_INT, *[C_I64] * 12, C_FLOAT, C_INT,
                                      C_INT, C_PTR, C_PTR],
        "flash_attention_simt_launch": [C_PTR, C_PTR, C_PTR, C_PTR, C_INT,
                                        C_INT, C_INT, C_INT, C_INT, C_INT,
                                        C_INT, C_INT, *[C_I64] * 12, C_FLOAT,
                                        C_INT, C_INT, C_PTR, C_PTR],
        "flash_attention_max_head_dim": [],
        "flash_attention_max_v_head_dim": [],
        "flash_attention_tc_smem_bytes": [C_INT, C_INT],
    },
    "topc_select": {
        "topc_select_launch": [*[C_PTR] * 7, C_INT, C_I64, C_I64, C_INT,
                               C_INT, C_INT, C_PTR],
        "topc_select_max_count": [],
    },
}

#: every kernel, by the name its launches are counted under
KERNELS = ("sketch_conv", "collision_count_batch", "collision_count",
           "dtw_wavefront_pairs", "dtw_wavefront", "cs_tables",
           "flash_attention", "flash_attention_simt", "topc_histogram",
           "topc_threshold", "topc_scatter")

#: launches per kernel since the last reset (see ``kernels.ops``);
#: written under :data:`COUNT_LOCK`
LAUNCHES: Dict[str, int] = collections.Counter()
COUNT_LOCK = threading.Lock()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def count(*names: str) -> None:
    """One launch more under each of ``names``."""
    with COUNT_LOCK:
        for name in names:
            LAUNCHES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels of repro_torch need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:12]}.so"


def build_log(name: str) -> str:
    """What nvcc printed when it built ``name``'s current library."""
    return library_path(name).with_suffix(".log").read_text()


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process or None, temp path, final path)."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)       # atomic: a reader never sees half a library


def build_all() -> None:
    """Compile every kernel library, one nvcc each, all at once."""
    started = [(n, *_start(n)) for n in SIGNATURES]
    for n, proc, tmp, out in started:
        _finish(n, proc, tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _LIBS.get(name)        # every launch asks: no lock once loaded
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = C_INT
            err = getattr(lib, f"{name}_error_string")
            err.argtypes, err.restype = [C_INT], ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(name: str, lib: ctypes.CDLL, code: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if code:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
