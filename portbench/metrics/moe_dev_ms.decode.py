"""moe_dev_ms.decode: device ms a decode step of the MoE FFN's bank
work (B7 and the expert products), from the stretch traced with host
ops and input shapes."""
from portbench import readers

read = readers.moe_dev_ms
