"""Build the CUDA C++ kernels in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled, at
first use, into ``build/ecad_tpu_torch/lib<name>_<hash>.so`` at the root of
the checkout (the hash is of the source and csrc/'s headers, so an edited
kernel or header rebuilds),
then loaded with ``ctypes``. Nothing here includes PyTorch's headers, so a
build takes seconds. ``build_all`` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "ecad_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# every build's code flags; --split-compile=0 runs the optimizer's passes on
# each kernel in parallel, on every core (the attention sources' seventy
# kernels took 92 s in one thread)
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "--split-compile=0")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name → nvcc/ptxas output of this process's build


def nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "ecad_tpu_torch are compiled from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where `name`'s library is built: its hash covers the source and every
    header in csrc/, so an edited header rebuilds the sources that share it."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [
        nvcc(), *COMPILE_FLAGS, "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC_DIR / f"{name}.cu"),
    ]


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every source that is not built yet, one ``nvcc`` per source,
    all started together. Raises with the compiler's output on failure."""
    names = names or sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = {n: library_path(n) for n in names}
    procs = {}
    for n, out in outs.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[n] = (
            subprocess.Popen(
                _command(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {n}.cu failed ({proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, outs[n])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib
