"""Hand-written Hopper kernels of the port and their plain torch versions.

Each kernel package keeps the reference's triple: ``ref.py`` (the plain
torch version, used on the CPU and as the oracle on the card), ``kernel.py``
(the ctypes launcher of the CUDA kernel in ``csrc/``) and ``ops.py`` (the
wrapper: kernel for a CUDA tensor, plain version for a CPU tensor).
"""
