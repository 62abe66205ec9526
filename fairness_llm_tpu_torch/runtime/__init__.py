"""Decode engine, sampling, speculative drafting and parameters."""
