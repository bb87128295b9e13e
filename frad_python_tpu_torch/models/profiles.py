"""FrAD profile capability tables (copy of `frad_python_tpu.models.profiles`).

The compact (lossy) profile numbers, the compact-profile sample-rate
table and the 32-entry frame-size table {128,160,192,224}x2^n.
"""

from __future__ import annotations

import numpy as np

COMPACT = (1, 2)
LOSSLESS = (0, 4)


class compact:
    """Compact-profile (lossy DCT) parameter tables."""

    # Descending valid sample rates (spec order; index transmitted in CSS).
    SRATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050, 16000, 12000, 11025, 8000)

    # Valid frame sizes: {128, 160, 192, 224} * 2^n for n in 0..7, ascending.
    SAMPLES = tuple(base << sh for sh in range(8) for base in (128, 160, 192, 224))

    MAX_SMPL = 28672

    _SRATES_ASC = np.array(sorted(SRATES), dtype=np.int64)
    _SAMPLES_ARR = np.array(SAMPLES, dtype=np.int64)

    @staticmethod
    def get_valid_srate(srate: int) -> int:
        """Smallest table sample rate >= srate."""
        idx = int(np.searchsorted(compact._SRATES_ASC, srate, side="left"))
        if idx >= len(compact._SRATES_ASC):
            raise ValueError(f"Sample rate {srate} exceeds compact maximum {compact.SRATES[0]}")
        return int(compact._SRATES_ASC[idx])

    @staticmethod
    def get_srate_index(srate: int) -> int:
        return compact.SRATES.index(compact.get_valid_srate(srate))

    @staticmethod
    def get_samples_min_ge(smpl: int) -> int:
        """Smallest valid frame size >= smpl."""
        idx = int(np.searchsorted(compact._SAMPLES_ARR, smpl, side="left"))
        if idx >= len(compact._SAMPLES_ARR):
            raise ValueError(f"Frame size {smpl} exceeds compact maximum {compact.MAX_SMPL}")
        return int(compact._SAMPLES_ARR[idx])

    @staticmethod
    def get_samples_index(smpl: int) -> int:
        return compact.SAMPLES.index(compact.get_samples_min_ge(smpl))
