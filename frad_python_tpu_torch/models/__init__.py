"""Profile tables, the Profile 1 batch cores and host helpers.

The profile registry is the JAX package's, so the encoder's validation
gauntlet gives the same answers and messages for every profile number:
AVAILABLE excludes the experimental TNS profile 2; SEGMAX caps samples
per frame; BIT_DEPTHS lists each profile's valid stream depths. Only
Profile 1 is ported; the depth tables of profiles 0, 2 and 4 are carried
as constants for the gauntlet.
"""

from __future__ import annotations

from . import profile1
from .profiles import COMPACT, compact

#: stream depths of the lossless profiles 0 and 4 and of the TNS profile 2
LOSSLESS_DEPTHS = (12, 16, 24, 32, 48, 64)
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
    LOSSLESS_DEPTHS,
    profile1.DEPTHS,
    PROFILE2_DEPTHS,
    (),
    LOSSLESS_DEPTHS,
    (), (), (),
]


def check_ported(profile: int) -> None:
    """Raise NotImplementedError for every profile but the ported Profile 1."""
    if profile != 1:
        raise NotImplementedError(f"profile {profile}: only Profile 1 is ported")


__all__ = ["AVAILABLE", "BIT_DEPTHS", "COMPACT", "LOSSLESS_DEPTHS", "PROFILE2_DEPTHS",
           "SEGMAX", "check_ported", "compact", "profile1"]
