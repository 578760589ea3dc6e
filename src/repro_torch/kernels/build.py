"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use.
The library's file name carries a hash of its source and of the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. The build directory ``kernels/_build/`` is listed in
``.gitignore``. ``build()`` starts one ``nvcc`` per source, all at once,
and waits for all of them; ``ptxas_report(name)`` returns what
``-Xptxas -v`` said about each kernel's registers and shared memory.

Nothing here runs at import: the CPU tests import every module of the
port, and the machines they run on have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCES = (
    "edge_hook", "pointer_jump", "splitter_aggregate", "flash_attention",
    "segment_sum",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    the ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Raises with the
    compiler's output if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{text}")
            continue
        out.with_suffix(".log").write_text(text)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the build of ``csrc/<name>.cu``."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        build((name,))
    return "\n".join(
        line for line in log.read_text().splitlines() if "ptxas" in line
    )


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _loaded[name] = lib
    return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C function of a kernel library with its ``argtypes`` declared
    (``c_void_p`` for pointers and the stream, ``c_int`` for ints) and
    an ``int`` result (for a launch: the ``cudaGetLastError()`` after
    it)."""
    fn = _functions.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[(lib_name, fn_name)] = fn
    return fn
