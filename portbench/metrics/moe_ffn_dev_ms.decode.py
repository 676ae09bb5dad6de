"""moe_ffn_dev_ms.decode: device ms a decode step under the program's
span ``repro_torch.moe``, the whole MoE FFN (routing, dispatch, B7 and
the expert products, combine), from the stretch traced with host ops."""
from portbench import spans


def read(run):
    return spans.ms_per_call(run, ("moe",))
