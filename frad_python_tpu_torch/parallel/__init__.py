"""Whole-file batch pipeline, sharded cores over a device mesh with the
overlap-add's halo exchange, and multi-process orchestration."""

from . import multihost
from .pipeline import batch_decode, batch_encode, batch_repair, plan_frames
from .sharded import (
    make_mesh, make_mesh_2d, overlap_add_sharded, pad_to_multiple, sharded_p0_decode,
    sharded_p0_encode, sharded_p1_decode, sharded_p1_encode, sharded_p2_decode,
    sharded_p2_encode, training_step_equivalent,
)

__all__ = [
    "batch_decode", "batch_encode", "batch_repair", "make_mesh", "make_mesh_2d", "multihost",
    "overlap_add_sharded", "pad_to_multiple", "plan_frames", "sharded_p0_decode",
    "sharded_p0_encode", "sharded_p1_decode", "sharded_p1_encode", "sharded_p2_decode",
    "sharded_p2_encode", "training_step_equivalent",
]
