"""Measurement tools of the port (counterparts of the repository's ``tools/``)."""
