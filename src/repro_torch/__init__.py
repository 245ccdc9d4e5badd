"""PyTorch + CUDA port of the UISA reproduction, for NVIDIA Hopper (sm_90a).

The JAX package ``repro`` is the reference; this package imports nothing
from it.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
