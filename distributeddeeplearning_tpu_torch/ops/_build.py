"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>-<source hash>.so`` inside the package
(a directory ``.gitignore`` lists), then loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a build takes seconds. The build runs at
first use, never at import: importing this module needs no CUDA
toolkit. The hash covers the source and the shared headers
(``csrc/*.cuh``, ``csrc/*.h``), so a stale library is never loaded. A
``csrc/<name>.cpp`` (host code that a kernel's source shares, such as
``depthwise_plan.cpp``) builds the same way with the host's C++
compiler, which needs no card.

``set_cache_dir`` (``training/warmup.enable_persistent_cache``, from
``COMPILATION_CACHE_DIR``) points builds and loads at another directory:
the port's counterpart of JAX's on-disk executable cache. A library
loaded from disk without running a compiler is a cache hit, a build a
miss; each goes to the listener ``set_listener`` installs (the warm-up's
counters and the bus's ``xla_cache_hit``/``xla_cache_miss``).

A build is silent for seconds to minutes, wherever the first launch
falls (a model built before ``fit``, a wrapper called on its own), so
it runs inside ``utils/heartbeat.during``: under the launcher's hang
watchdog a process building kernels stays alive.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional

from distributeddeeplearning_tpu_torch.utils import heartbeat

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

HOST_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_cache_dir: Optional[Path] = None
_listener: Optional[Callable[[str, str], None]] = None


def set_cache_dir(directory: Optional[str]) -> None:
    """Build to and load from ``directory`` (``None``: the package's
    ``_build/``). Libraries already loaded in this process stay loaded."""
    global _cache_dir
    _cache_dir = Path(directory) if directory else None


def build_dir() -> Path:
    """Where libraries are built and loaded from now."""
    return _cache_dir if _cache_dir is not None else BUILD_DIR


def set_listener(fn: Optional[Callable[[str, str], None]]) -> None:
    """Call ``fn("hit" | "miss", name)`` for each library loaded from
    disk (``hit``) or built (``miss``)."""
    global _listener
    _listener = fn


def _notify(event: str, name: str) -> None:
    if _listener is not None:
        _listener(event, name)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built with nvcc for sm_90a"
    )


def host_cxx() -> str:
    """The host's C++ compiler: ``$CXX``, then ``c++``, then ``g++`` on
    ``PATH``. Raises when there is none."""
    for c in (os.environ.get("CXX"), shutil.which("c++"), shutil.which("g++")):
        if c:
            return c
    raise RuntimeError("no host C++ compiler ($CXX, c++, g++) for the csrc/*.cpp sources")


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` (or ``.cpp``) builds to (keyed by source,
    headers and flags)."""
    source = _source(name)
    h = hashlib.sha256()
    for path in [source, *sorted(CSRC.glob("*.cuh")), *sorted(CSRC.glob("*.h"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS if source.suffix == ".cu" else HOST_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with ``nvcc`` (or ``csrc/<name>.cpp``
    with the host compiler) unless its library exists; returns the
    library path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library as ``.log``."""
    path = library_path(name)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        return path
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    log = path.with_suffix(".log")
    source = _source(name)
    command = ([nvcc(), *NVCC_FLAGS] if source.suffix == ".cu" else [host_cxx(), *HOST_FLAGS])
    with heartbeat.during(f"build:{name}"):
        res = subprocess.run(
            [*command, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    log.write_text(res.stdout)
    if res.returncode != 0:
        tail = "\n".join(res.stdout.splitlines()[-20:])
        raise RuntimeError(
            f"build failed: {name} ({command[0]} rc={res.returncode}, see {log}):\n{tail}"
        )
    os.replace(tmp, path)  # atomic: a reader never sees half a file
    _notify("miss", name)
    return path


def build_log(name: str) -> str:
    """The compiler output of ``name``'s current build ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``), built on
    first use."""
    lib = _loaded.get(name)
    if lib is None:
        cached = library_path(name).exists()
        path = build(name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        if cached:
            _notify("hit", name)
    return lib
