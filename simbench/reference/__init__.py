"""The plain reference of the rack simulator: a frozen copy of the
port's window on its ``ref`` backend (plain PyTorch, no hand-written
kernel, no CUDA graph), importing nothing of the port.

It follows the port module by module as it stood when the benchmark was
written, when the port equalled the JAX package on the CPU (the tests of
``tests/test_torch_*.py``).  A change of the program that changes a
simulated answer shows against it.  :mod:`.rack` steps it eagerly.
"""
