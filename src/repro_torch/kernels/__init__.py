"""Kernels of the torch port: the SDV GEMV (B1) and GEMM (B2) written
in CUDA C++ for Hopper (``csrc/sdv.cu``), their plain torch versions and
the packed-matmul dispatch (``ops``)."""
