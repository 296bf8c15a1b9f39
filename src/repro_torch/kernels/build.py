"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/kernels/`` at the root of
the checkout. A library's file name carries a hash of its source and flags,
so an edited source is rebuilt and an unchanged one is reused. The build
directory is read at each call, so ``set_build_dir`` (the cluster
executor's ``enable_compile_cache``) can point it at a persistent cache
that outlives the checkout's tree. Builds run at
first use, under a lock (the trainer's prep thread and the main thread can
both get there first); ``build_all`` starts one nvcc for each source at once.
A failed build raises: there is no fallback.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"flash_attn": "flash_attn.cu", "wkv6": "wkv6.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc to build with: ``$CUDA_HOME/bin/nvcc``, else the one on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels must be built before a CUDA tensor can use them")


def set_build_dir(path) -> Path:
    """Build and look up the libraries under ``path`` from now on (the
    default is ``build/kernels`` at the root of the checkout)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)
    return BUILD_DIR


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str, nvcc: str) -> tuple[subprocess.Popen, Path, Path]:
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> str:
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(rc {proc.returncode}):\n{log[-4000:]}")
    os.replace(tmp, out)
    return log


def build_all(force: bool = False) -> dict[str, dict]:
    """Build every source not built yet (all of them with ``force``), one
    nvcc each, all started together. Returns ``{name: {"seconds", "log",
    "path"}}`` for the sources built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _LOCK:
        todo = [n for n in SOURCES if force or not library_path(n).exists()]
        if not todo:
            return {}
        nvcc = nvcc_path()
        t0 = time.monotonic()
        started = {n: _start(n, nvcc) for n in todo}
        built = {}
        for n, (proc, tmp, out) in started.items():
            log = _finish(n, proc, tmp, out)
            built[n] = {"seconds": time.monotonic() - t0, "log": log,
                        "path": str(out)}
        return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all()
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]
