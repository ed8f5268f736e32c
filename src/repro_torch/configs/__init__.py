"""Configurations the port supports."""
