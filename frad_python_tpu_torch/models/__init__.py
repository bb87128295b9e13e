"""Profile tables, the batch cores and the per-frame codecs.

The profile registry is the JAX package's, so the encoder's validation
gauntlet gives the same answers and messages for every profile number:
AVAILABLE excludes the experimental TNS profile 2; SEGMAX caps samples
per frame; BIT_DEPTHS lists each profile's valid stream depths. Profiles
0, 1 and 4 are ported; the depth table of profile 2 is carried as a
constant for the gauntlet.
"""

from __future__ import annotations

from . import profile0, profile1, profile4
from .profiles import COMPACT, compact

PROFILE2_DEPTHS = (8, 10, 12, 14, 16, 20, 24)

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
    PROFILE2_DEPTHS,
    (),
    profile4.DEPTHS,
    (), (), (),
]


def check_ported(profile: int) -> None:
    """Raise NotImplementedError for profile 2 (TNS), the one profile the
    port lacks. Reserved profile numbers never reach here: the Encoder's
    gauntlet rejects them and the decoders decode them as profile 0."""
    if profile == 2:
        raise NotImplementedError("profile 2 (TNS) is not ported yet")


__all__ = ["AVAILABLE", "BIT_DEPTHS", "COMPACT", "PROFILE2_DEPTHS", "SEGMAX",
           "check_ported", "compact", "profile0", "profile1", "profile4"]
