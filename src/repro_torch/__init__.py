"""PyTorch port of the OrbitCache rack simulator (``repro``'s twin).

The package mirrors ``src/repro/`` module by module and keeps its names.
It imports ``torch`` and numpy only; the JAX package stays the reference
that the tests hold every ported function to, bit for bit.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""
