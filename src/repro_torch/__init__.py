"""PyTorch/CUDA port of the VoltanaLLM reproduction.

The JAX package ``repro`` is the reference; this package imports
neither it nor JAX.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
