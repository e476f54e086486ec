"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<digest>.so`` at the repository root, where
``<digest>`` hashes the source and the flags, so an edited source is rebuilt
and a built one is reused. The build runs at first use; ``build`` starts one
nvcc per source, all at once. The library is written under a temporary name
and renamed into place, so processes that build at the same time do not see
each other's half-written files.
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


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every source in ``names`` that is not built yet, one nvcc
    each, all started together. Returns {name: seconds} for those built;
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
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    seconds = {}
    failures = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc {name}.cu failed (rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
