"""Seconds the chunk spent warming up and capturing its CUDA graphs
(``CompiledChunk.capture_seconds``), all in set-up."""
UNIT = "s"
LAYER = "chunk"
MOVES = "setup_s"
SOURCE = "program_counter"


def read(run):
    c = run.counters
    if not c.get("captures"):
        return None
    return float(c["capture_s"])
