"""ECC ratio policy of the repair path (`parallel.pipeline.batch_repair`).

The JAX package's streaming `Repairer` engine is not ported yet; this
module carries its ratio default and clamp.
"""

from __future__ import annotations

DEFAULT_ECC_RATIO = (96, 24)


def sanitize_ecc_ratio(ratio: tuple[int, int]) -> tuple[tuple[int, int], list[str]]:
    """Clamp an RS (data, parity) request to a representable one.

    GF(256) RS codewords cap at 255 bytes and need a non-empty data part;
    invalid requests fall back to the default with a warning.
    """
    dsize, csize = ratio
    if dsize == 0:
        return DEFAULT_ECC_RATIO, [
            "ECC data size must not be zero; falling back to (96, 24)"]
    if dsize + csize > 255:
        return DEFAULT_ECC_RATIO, [
            f"ECC data+check size must not exceed 255, given: {dsize} and "
            f"{csize}; falling back to (96, 24)"]
    return (dsize, csize), []
