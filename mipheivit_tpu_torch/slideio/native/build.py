"""Build the native slide-TIFF engine (``slidetiff.cpp``) at first use.

``g++ -shared`` against a libtiff 4.x runtime (the C ABI is declared in
``tiff_api.h``, so no dev headers are needed), into the package's
gitignored ``build/libslidetiff-<hash>.so``, the hash of the source and of
the runtime's path: an edited source, or another runtime, is rebuilt, and
nothing is written next to the source.

The runtime is the system's ``libtiff.so.6`` (or ``.so.5``) where there is
one, else the copy that Pillow's wheel ships under a hashed soname
(``site-packages/pillow.libs/libtiff-<hash>.so.6.x``), linked by path with
an rpath to its directory. Without either, ``build`` raises.
"""

from __future__ import annotations

import glob
import hashlib
import os
import site
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

_NATIVE_DIR = Path(__file__).resolve().parent
_SRC = _NATIVE_DIR / "slidetiff.cpp"
BUILD = _NATIVE_DIR.parent.parent / "build"


_SYSTEM = ("/lib/x86_64-linux-gnu/libtiff.so.6", "/usr/lib/x86_64-linux-gnu/libtiff.so.6",
           "/lib/x86_64-linux-gnu/libtiff.so.5", "/usr/lib/x86_64-linux-gnu/libtiff.so.5",
           "/usr/lib64/libtiff.so.6", "/usr/lib64/libtiff.so.5")


def _site_dirs():
    dirs = list(site.getsitepackages()) + [site.getusersitepackages()]
    dirs += [p for p in sys.path if p.endswith(("site-packages", "dist-packages"))]
    return list(dict.fromkeys(dirs))


def find_libtiff() -> Optional[str]:
    """The libtiff runtime to link: the system's, else Pillow's bundled copy
    (None: neither is there)."""
    for cand in _SYSTEM:
        if Path(cand).exists():
            return cand
    for d in _site_dirs():
        found = sorted(glob.glob(os.path.join(d, "pillow.libs", "libtiff-*.so*")))
        if found:
            return found[0]
    return None


def library_path() -> Path:
    """The build of the current source against this machine's libtiff: a
    build directory copied from a machine with another libtiff is not
    reused."""
    digest = hashlib.sha256(_SRC.read_bytes() + (_NATIVE_DIR / "tiff_api.h").read_bytes()
                            + str(find_libtiff()).encode())
    return BUILD / f"libslidetiff-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile unless the current source's library exists; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    lib = find_libtiff()
    if lib is None:
        raise RuntimeError("no libtiff runtime (system libtiff.so.6/.so.5 or Pillow's "
                           "pillow.libs/libtiff-*.so*) to build slidetiff.cpp against")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", tmp, lib]
    if lib not in _SYSTEM:
        # DT_RPATH (not RUNPATH): the bundled copy's own dependencies sit
        # beside it under hashed names too
        cmd.append(f"-Wl,--disable-new-dtags,-rpath,{Path(lib).parent}")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for slidetiff.cpp ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out
