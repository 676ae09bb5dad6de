"""attn_dev_ms.decode: device ms a decode step under the program's
attention spans ``repro_torch.attn.kv`` (quantize, cache scatter, the
int8 cache widened to float32 and scaled) and ``repro_torch.attn.core``
(scores, mask, softmax, values), from the stretch traced with host
ops."""
from portbench import spans

ATTN = ("attn.kv", "attn.core")


def read(run):
    return spans.ms_per_call(run, ATTN)
