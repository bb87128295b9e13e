"""Profile tables, the batch cores and the per-frame codecs.

The profile registry is the JAX package's, so the encoder's validation
gauntlet gives the same answers and messages for every profile number:
AVAILABLE excludes the experimental TNS profile 2; SEGMAX caps samples
per frame; BIT_DEPTHS lists each profile's valid stream depths.
"""

from __future__ import annotations

from . import profile0, profile1, profile2, profile4
from .profiles import COMPACT, compact

AVAILABLE = [0, 1, 4]

SEGMAX = [
    0xFFFFFFFF,        # Profile 0
    compact.MAX_SMPL,  # Profile 1
    compact.MAX_SMPL,  # Profile 2
    0,                 # Profile 3 (reserved)
    0xFFFFFFFF,        # Profile 4
    0, 0, 0,           # Profiles 5-7 (reserved)
]

BIT_DEPTHS = [
    profile0.DEPTHS,
    profile1.DEPTHS,
    profile2.DEPTHS,
    (),
    profile4.DEPTHS,
    (), (), (),
]


__all__ = ["AVAILABLE", "BIT_DEPTHS", "COMPACT", "SEGMAX", "compact", "profile0",
           "profile1", "profile2", "profile4"]
