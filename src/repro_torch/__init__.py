"""PyTorch/CUDA port of the packed-arithmetic system (``repro``).

Imports torch only, never jax or the ``repro`` package.
"""
