"""The servers' reply value bytes: plain version, Hopper kernel and
wrapper."""
