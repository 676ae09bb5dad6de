"""Training substrate of the torch port: optimizer, loop,
checkpointing, straggler policy, the int8 SDV-packed gradient
all-reduce (``grad_compress``), and packed QAT (``train.qat``)."""
from . import checkpoint, grad_compress, loop, optimizer, straggler

__all__ = ["checkpoint", "grad_compress", "loop", "optimizer", "straggler"]
