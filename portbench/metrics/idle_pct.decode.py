"""idle_pct.decode: share of the traced decode window with the device
idle, %."""
from portbench import readers

read = readers.idle_pct
