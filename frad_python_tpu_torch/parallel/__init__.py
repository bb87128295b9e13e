"""Whole-file batch pipeline."""

from .pipeline import batch_decode, batch_encode, plan_frames

__all__ = ["batch_decode", "batch_encode", "plan_frames"]
