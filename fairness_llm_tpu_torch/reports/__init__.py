"""The text report of a phase-1 record."""
