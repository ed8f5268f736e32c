"""The fused subround op: plain version, Hopper kernel and wrapper."""
