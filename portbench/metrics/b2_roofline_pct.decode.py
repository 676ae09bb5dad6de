"""b2_roofline_pct.decode: kernel B2 against its bound at a decode
step's rows (the attention projections), %."""
from portbench import readers

read = readers.b2_roofline_pct
