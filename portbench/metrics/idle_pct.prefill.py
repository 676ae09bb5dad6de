"""idle_pct.prefill: share of the traced long-prompt window with the
device idle, %."""
from portbench import readers

read = readers.idle_pct
