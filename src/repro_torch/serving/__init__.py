"""Serving: the batched decode engine and the OrbitCache-backed
distributed key-value service on the orbit ring."""
from .engine import ServeConfig, ServeEngine  # noqa: F401
