"""Serving on the orbit ring: the distributed key-value service."""
