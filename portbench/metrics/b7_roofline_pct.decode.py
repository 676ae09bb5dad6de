"""b7_roofline_pct.decode: kernel B7 (the memory-packed bank unpack)
against its bound, every bank once a step, %."""
from portbench import readers

read = readers.b7_roofline_pct
