"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper launches its kernel for a CUDA tensor (or raises), and runs the
plain version for a tensor on the CPU. There is no fallback from one to the
other. Each wrapper counts its kernel launches in its ``launches`` attribute.
"""

__all__: list = []  # the wrappers are imported from their modules
