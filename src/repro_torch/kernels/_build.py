"""Build the port's CUDA kernels from the sources in ``csrc/`` on first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, ``build/repro_torch/lib<name>-<hash>.so`` under the
repository root, and loaded with :mod:`ctypes`.  The hash covers the source,
every shared header ``csrc/*.cuh`` and the flags, so an edited source or
header builds anew and an unchanged one is reused.  Every source is compiled by its own ``nvcc`` process, all started
together.  A failed build raises; nothing falls back.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: ``{name: {"seconds": float, "log": str, "path": str}}`` for every source
#: compiled in this process (reused libraries are not listed).
BUILD_LOG: dict[str, dict] = {}


class BuildError(RuntimeError):
    """``nvcc`` was not found or refused a source."""


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every named source that has no current library, one
    ``nvcc`` per source, all in parallel.  Returns ``{name: library}``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = [n for n in names if not targets[n].is_file()]
    if todo:
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            tmp = targets[n].with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": str(targets[n])}
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[n])  # atomic: concurrent builds agree
        if failed:
            raise BuildError("nvcc failed for " + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib


def sources() -> list[str]:
    """Names of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
