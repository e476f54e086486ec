"""Build the port's native sources and load them through ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built by nvcc) or ``csrc/<name>.cpp``
(host code, built by g++ with the flags of the JAX package's
``native/Makefile``) has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<digest>.so`` at the repository root, where
``<digest>`` hashes the source and the flags, so an edited source is rebuilt
and a built one is reused. The build runs at first use; ``build`` starts one
compiler per source, all at once. The library is written under a temporary
name and renamed into place, so processes that build at the same time do not
see each other's half-written files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels are built at first use")
    return found


def cxx_path() -> str:
    found = shutil.which(os.environ.get("CXX") or "g++")
    if found is None:
        raise RuntimeError("no C++ compiler found (g++, or set CXX); the port's host libraries are built at first use")
    return found


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    """The source of ``name`` and its compiler's flags."""
    cu = CSRC / f"{name}.cu"
    return (cu, NVCC_FLAGS) if cu.exists() else (CSRC / f"{name}.cpp", CXX_FLAGS)


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every source in ``names`` that is not built yet, one compiler
    each, all started together. Returns {name: seconds} for those built,
    each from the start to that compiler's end;
    the compiler's output (registers, spills) is kept beside each library
    as ``.log``. Raises RuntimeError with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        src, flags = _source(name)
        compiler = nvcc_path() if src.suffix == ".cu" else cxx_path()
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, seconds = {}, {}

    def finish(name: str, proc: subprocess.Popen) -> None:
        logs[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0   # this compiler's own time, not the slowest one's

    waiters = [threading.Thread(target=finish, args=(name, job[0])) for name, job in jobs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        log = logs[name]
        if proc.returncode != 0:
            failures.append(f"building {_source(name)[0].name} failed (rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` or ``.cpp``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
