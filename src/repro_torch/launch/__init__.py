"""Launchers: serve, train."""
