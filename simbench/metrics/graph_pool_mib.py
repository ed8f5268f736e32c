"""Device memory the chunk's graph captures reserved
(``CompiledChunk.graph_bytes``, summed over its graphs), in MiB."""
UNIT = "MiB"
LAYER = "chunk"
MOVES = "peak_device_mib"
SOURCE = "program_counter"


def read(run):
    c = run.counters
    if not c.get("captures"):
        return None
    return sum(c["graph_bytes"].values()) / 2**20
