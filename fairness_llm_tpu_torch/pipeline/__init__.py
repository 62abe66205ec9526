"""Prompts, response parsing and the decode backend."""
