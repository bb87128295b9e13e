"""Build the C++ host module `frad_native.cpp` into a shared library.

g++ compiles the source with the JAX package's flags into
`_build/<hash>/libfrad_native.so`, where the hash covers the source, the
flags and the host CPU that `-march=native` compiles for, so an edited
source or a build directory copied to another host rebuilds, and an
unchanged one loads the library already built. Each build writes a
temporary file and renames it into place, so processes that build at
once never load a partial file. The build runs at first use (or from
`python -m frad_python_tpu_torch.native.build`); importing this module
builds nothing. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "frad_native.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
LIB_NAME = "libfrad_native.so"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LINK_FLAGS = ("-lz", "-lpthread")


def _host_cpu() -> bytes:
    """The CPU model and feature flags that `-march=native` resolves."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine().encode()
    model = next((ln for ln in lines if ln.startswith("model name")), "")
    flags = next((ln for ln in lines if ln.startswith("flags")), "")
    return f"{platform.machine()}\n{model}\n{flags}".encode()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(_host_cpu())
    h.update(SRC.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, bool]:
    """Compile the module if this source is not built yet.

    Returns (library path, whether this call compiled it)."""
    out = library_path()
    if out.exists():
        return out, False
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host module needs a C++ compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SRC), *LINK_FLAGS],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, True


if __name__ == "__main__":
    path, built = build()
    print(f"{'built' if built else 'up to date'}: {path}")
