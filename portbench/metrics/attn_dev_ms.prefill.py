"""attn_dev_ms.prefill: device ms a thousand prompt tokens under the
program's attention spans ``repro_torch.attn.kv`` and
``repro_torch.attn.core`` (the chunks' attention over the whole cache,
and each batch's first-token step), from the stretch traced with host
ops."""
from portbench import spans

ATTN = ("attn.kv", "attn.core")


def read(run):
    return spans.ms_per_k_tokens(run, ATTN)
