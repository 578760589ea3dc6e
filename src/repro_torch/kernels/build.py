"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper) at first use.
The library's file name carries a hash of its source, of the ``csrc``
headers it includes by quoted name (``sources``), and of the compiler
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. The build directory ``kernels/_build/`` is listed in
``.gitignore``. ``build()`` starts one ``nvcc`` per source, all at once,
and waits for all of them; ``ptxas_report(name)`` returns what
``-Xptxas -v`` said about each kernel's registers, shared memory and
spills, and ``ptxas_kernels(name)`` the same per kernel, parsed.

Nothing here runs at import: the CPU tests import every module of the
port, and the machines they run on have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

SOURCES = (
    "edge_hook", "pointer_jump", "splitter_aggregate", "flash_attention",
    "flash_attention_bwd", "segment_sum", "ordered_fold",
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


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file it includes by quoted name,
    directly or through another such file, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources(name)) + " ".join(NVCC_FLAGS).encode()
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
    """The ``-Xptxas -v`` lines of the build of ``csrc/<name>.cu``: each
    kernel's registers, shared memory, stack frame and spills."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        build((name,))
    return "\n".join(
        line for line in log.read_text().splitlines()
        if "ptxas" in line or "spill" in line
    )


def ptxas_kernels(name: str) -> dict[str, dict[str, int]]:
    """Per kernel entry (mangled name) of ``csrc/<name>.cu``: the
    ``registers``, ``spill_stores`` and ``spill_loads`` (bytes) that
    ``ptxas -v`` reported for ``sm_90a``."""
    entries: dict[str, dict[str, int]] = {}
    entry = None
    for line in ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entries[entry] = {}
        elif entry is None:
            continue
        elif "spill stores" in line:
            parts = [p.split() for p in line.split(",")]
            for words in parts:
                if words[-2:] == ["spill", "stores"]:
                    entries[entry]["spill_stores"] = int(words[0])
                elif words[-2:] == ["spill", "loads"]:
                    entries[entry]["spill_loads"] = int(words[0])
        elif "Used" in line and "registers" in line:
            words = line.split("Used", 1)[1].split()
            entries[entry]["registers"] = int(words[0])
    return entries


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
