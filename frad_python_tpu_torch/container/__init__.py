"""Container layer: ASFH frame headers."""
