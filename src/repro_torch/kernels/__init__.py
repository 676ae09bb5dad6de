"""Kernels of the torch port, written in CUDA C++ for Hopper: the SDV
GEMV (B1) and GEMM (B2) in ``csrc/sdv.cu``, the BSEG conv2d (B3) in
``csrc/bseg.cu``; their plain torch versions, and the packed-matmul and
packed-conv2d dispatch (``ops``)."""
