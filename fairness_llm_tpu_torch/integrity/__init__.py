"""Verified artifacts: sha256 manifests (``manifest``)."""
