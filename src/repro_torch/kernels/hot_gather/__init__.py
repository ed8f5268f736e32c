"""Gather-by-id over a hot set: plain version, Hopper kernel and wrapper."""
