"""lm_head_dev_ms.decode: device ms a decode step under the program's
span ``repro_torch.head``: the SDV LM head decoded (its plain unpack)
and its product, from the stretch traced with host ops."""
from portbench import spans


def read(run):
    return spans.ms_per_call(run, ("head",))
