"""Build the native slide-TIFF engine (``slidetiff.cpp``) at first use.

``g++ -shared`` against the system's libtiff runtime (the libtiff 4.x C ABI
is declared in ``tiff_api.h``, so no dev headers are needed), into the
package's gitignored ``build/libslidetiff-<source hash>.so``: an edited
source is rebuilt, and nothing is written next to the source.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent
_SRC = _NATIVE_DIR / "slidetiff.cpp"
BUILD = _NATIVE_DIR.parent.parent / "build"


def find_libtiff() -> str:
    for cand in (
        "/lib/x86_64-linux-gnu/libtiff.so.6",
        "/usr/lib/x86_64-linux-gnu/libtiff.so.6",
        "/lib/x86_64-linux-gnu/libtiff.so.5",
    ):
        if Path(cand).exists():
            return cand
    return "-ltiff"  # let the linker find it


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + (_NATIVE_DIR / "tiff_api.h").read_bytes())
    return BUILD / f"libslidetiff-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile unless the current source's library exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp,
           find_libtiff()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for slidetiff.cpp ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out
