"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` (the
hash is of the source and the shared headers ``csrc/*.cuh``, so an edited
kernel or header is rebuilt) and loaded with
``ctypes``. Nothing here runs at import time, and nothing falls back: a
missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the content of the source
    and of the headers it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its current build exists; return the .so."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed, then load ``lib<name>``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
