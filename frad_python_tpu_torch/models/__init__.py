"""Profile tables, the Profile 1 batch cores and host helpers."""
