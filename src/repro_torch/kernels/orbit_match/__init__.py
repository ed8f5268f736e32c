"""The batched 128-bit match-action lookup: plain version, Hopper kernel
and wrapper."""
