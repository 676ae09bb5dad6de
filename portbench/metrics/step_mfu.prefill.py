"""step_mfu.prefill: the model step's share of the bf16 peak over the
untraced stretch of a traced long-prompt run, on the host clock (every
prompt token prefilled, each request's first token), %."""
from portbench import readers

read = readers.step_mfu_pct
