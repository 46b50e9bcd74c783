"""CUDA kernels for Hopper, their wrappers, and their plain PyTorch versions
(``refs``).  Import the submodules; ``selective_scan`` keeps its launch
counter on the module."""
