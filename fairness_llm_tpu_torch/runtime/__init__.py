"""Decode engine, sampling and parameters."""
