"""Build the package's native code at first use and load it with ctypes.

Each ``csrc/*.cu`` source has a plain C interface. At first use it is
compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the repository
root, under a name that carries a hash of the source and the flags, so one
process builds it at most once and a changed source never loads a stale
library. ``csrc/*.c`` and ``csrc/*.cpp`` sources (host code) are built the
same way by the host C or C++ compiler (``build_host``). A missing compiler
or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.fsutil import fsync_dir

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O3", "-shared", "-fPIC")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall")

_lock = threading.Lock()                     # guards the two dicts below
_key_locks: "dict[str, threading.Lock]" = {}  # one build at a time per library
_loaded: "dict[str, Built]" = {}


class Built:
    """A loaded library plus what the compiler said about it."""

    def __init__(self, lib: ctypes.CDLL, path: Path, ptxas_log: str):
        self.lib = lib
        self.path = path
        self.ptxas_log = ptxas_log


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.access(cand, os.X_OK) else None
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA kernels")
    return nvcc


def _find(env: str, names, what: str) -> str:
    for name in (os.environ.get(env), *names):
        path = shutil.which(name) if name else None
        if path:
            return path
    raise RuntimeError(f"no host {what} compiler found (${env}, "
                       f"{', '.join(names)}): cannot build the host libraries")


def find_cc() -> str:
    return _find("CC", ("cc", "gcc", "clang"), "C")


def find_cxx() -> str:
    return _find("CXX", ("c++", "g++", "clang++"), "C++")


def cpu_flags() -> "set[str]":
    """The CPU feature flags /proc/cpuinfo lists (empty where it is absent)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return set(line.split(":", 1)[1].split())
    except OSError:
        pass
    return set()


def _compile(key: str, src: Path, cmd: "list[str]", flags) -> Built:
    """Compile `src` with `cmd + flags -o <so> src` (once per process and
    hash of source and flags) and load it. Different libraries build
    concurrently (see build_all)."""
    with _lock:
        key_lock = _key_locks.setdefault(key, threading.Lock())
    with key_lock:
        if key in _loaded:
            return _loaded[key]
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(flags).encode()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"{src.stem}_{digest}.so"
        log_path = so.with_suffix(".log")
        if not so.exists():
            tmp = so.with_suffix(f".so.tmp{os.getpid()}")
            proc = subprocess.run([*cmd, *flags, "-o", str(tmp), str(src)],  # swtpu-lint: disable=io-under-lock (the per-library build lock: one build of a library at a time)
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{Path(cmd[0]).name} failed to build {src} "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            log_path.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
            fsync_dir(str(so))
        ptxas_log = log_path.read_text() if log_path.exists() else ""
        built = Built(ctypes.CDLL(str(so)), so, ptxas_log)
        with _lock:
            _loaded[key] = built
        return built


def build(name: str) -> Built:
    """Compile csrc/<name>.cu with nvcc for sm_90a and load it."""
    return _compile(name, CSRC / f"{name}.cu", [find_nvcc()], NVCC_FLAGS)


def simd_flags() -> "tuple[str, ...]":
    """The SIMD flags the JAX package's native/Makefile picks from
    /proc/cpuinfo: -mavx2 -mssse3 with avx2, -msse4.2 with sse4_2."""
    have = cpu_flags()
    return ((("-mavx2", "-mssse3") if "avx2" in have else ())
            + (("-msse4.2",) if "sse4_2" in have else ()))


def build_host(name: str) -> Built:
    """Compile csrc/<name>.c with the host C compiler, or csrc/<name>.cpp
    with the host C++ compiler, and load it, with the SIMD flags the CPU
    allows (simd_flags)."""
    src = CSRC / f"{name}.c"
    if src.exists():
        cmd, flags = find_cc(), CC_FLAGS + simd_flags()
    else:
        src = CSRC / f"{name}.cpp"
        cmd, flags = find_cxx(), CXX_FLAGS + simd_flags()
    return _compile(f"host:{name}:{' '.join(flags)}", src, [cmd], flags)


def build_all(names) -> "dict[str, Built]":
    """Build several CUDA sources at once, one nvcc process each, all
    started together; raises the first failure."""
    from concurrent.futures import ThreadPoolExecutor
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
