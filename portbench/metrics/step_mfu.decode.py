"""step_mfu.decode: the model step's share of the bf16 peak over the
untraced stretch of a traced decode run, on the host clock (active
weights: top-k of the experts), %."""
from portbench import readers

read = readers.step_mfu_pct
