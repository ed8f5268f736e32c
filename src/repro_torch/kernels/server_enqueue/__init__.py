"""The servers' FIFO enqueue of a window's arrivals: plain version, Hopper
kernel and wrapper."""
