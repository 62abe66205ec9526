"""Decode counters."""
