"""Mesh builders of the port (``repro/launch`` holds the reference's)."""
