"""vivim_tpu_torch: the PyTorch/CUDA port of the JAX package for Hopper.

A package of its own beside the JAX package, which stays the reference:
it imports torch and nothing of JAX or of the JAX package.  The Pallas TPU
kernels become hand-written CUDA kernels (``kernels/csrc``), each with a
plain PyTorch version beside it that the CPU runs and the kernel is held
against.  Public functions keep the JAX package's layouts: clips
(B, T, H, W, 3), logits (B, T, H, W, C), scan tensors time-major (B, L, D).
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
