"""Build the CUDA kernels in `csrc/` into one plain-C shared library.

`nvcc` compiles every `csrc/*.cu` for `sm_90a` (Hopper), in parallel, into
`_build/<hash>/libfrad_kernels.so`, where the hash covers the sources and
the flags, so an edited source rebuilds and an unchanged one loads the
library already built. The build runs at the first kernel launch (or
from `python -m frad_python_tpu_torch.kernels.build`); importing this
module builds nothing. The library is loaded with ctypes: every pointer
and the stream are passed as `c_void_p`, and each entry returns
`cudaGetLastError()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libfrad_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
#: C entry points and their argument types
SIGNATURES = {
    "frad_power_quant": (_P, _P, _P, _LL, _D, _I, _P),
    "frad_overlap_add": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "frad_trunc_pack": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "frad_trunc_unpack": (_P, _P, _I, _I, _I, _I, _I, _P),
    "frad_tns_levinson": (_P, _P, _I, _I, _P),
    "frad_tns_iir": (_P, _P, _P, _I, _I, _I, _P),
    "frad_egr_pack": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "frad_dequant": (_P, _P, _P, _I, _I, _I, _D, _D, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def build(verbose: bool = False) -> tuple[Path, bool]:
    """Compile the kernels if this source set is not built yet: one nvcc
    per source, all started together, then one link.

    Returns (library path, whether this call compiled it)."""
    out = library_path()
    if out.exists():
        return out, False
    out.parent.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sources():
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc(), *compile_flags, *(["-Xptxas", "-v"] if verbose else []),
                   "-c", "-o", obj, str(src)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err}")
            elif verbose:
                print(err, end="")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib_tmp = str(Path(tmp) / LIB_NAME)
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", lib_tmp, *(o for _, o, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(lib_tmp, out)
    return out, True


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(name: str, err: int) -> None:
    """Raise when a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


if __name__ == "__main__":
    path, built = build(verbose=True)
    print(f"{'built' if built else 'up to date'}: {path}")
