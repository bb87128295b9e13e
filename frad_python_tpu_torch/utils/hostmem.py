"""Host allocator tuning for demand-paged VMs (copy of
`frad_python_tpu.utils.hostmem`).

On a demand-paged VM the first touch of a page costs a fault, and glibc
returns large buffers to the OS on free (mmap/munmap per allocation), so
a steady-state codec pass that should be bound by memory bandwidth
becomes bound by page faults.

`tune()` flips glibc to a brk-only, never-trimmed heap via mallopt(3):
pages are faulted once on the first pass and stay warm for every pass
after. RSS stays at the high-water mark: the right trade for a
long-running encode or serve process. The CLI applies it when
FRAD_TORCH_WARM_HEAP is set.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys

# mallopt(3) parameter codes (glibc malloc.h)
M_TRIM_THRESHOLD = -1
M_TOP_PAD = -2
M_MMAP_THRESHOLD = -3
M_MMAP_MAX = -4

_done = False


def tune(top_pad: int = 64 * 1024 * 1024) -> bool:
    """Keep freed heap pages warm: no mmap-backed allocations, never trim.

    Idempotent; returns True when mallopt was applied (glibc only — a
    no-op on musl/macOS, where the codec still works, just without the
    warm-heap guarantee).
    """
    global _done
    if _done:
        return True
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    ok = bool(mallopt(M_MMAP_MAX, 0))
    ok &= bool(mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF))
    mallopt(M_TOP_PAD, top_pad)
    _done = ok
    return ok


def prefault(nbytes: int) -> None:
    """Touch `nbytes` of heap once so later passes never fault.

    Call after tune() with the expected peak working set; the buffer is
    freed immediately but (brk heap, no trim) its pages stay resident.
    """
    import numpy as np

    buf = np.empty(nbytes, dtype=np.uint8)
    buf[:: 4096 // buf.itemsize] = 0
    del buf
