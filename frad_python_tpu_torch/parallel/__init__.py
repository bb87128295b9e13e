"""Whole-file batch pipeline."""

from .pipeline import batch_decode, batch_encode, batch_repair, plan_frames

__all__ = ["batch_decode", "batch_encode", "batch_repair", "plan_frames"]
