"""Stream utilities."""
