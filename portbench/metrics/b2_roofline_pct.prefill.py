"""b2_roofline_pct.prefill: kernel B2 (the packed GEMM) against its
bound at the prefill chunks' rows, %."""
from portbench import readers

read = readers.b2_roofline_pct
