"""Training substrate of the torch port: optimizer, loop,
checkpointing, straggler policy, and packed QAT (``train.qat``).  The
gradient compression of the JAX package (``grad_compress``) is
distribution work and is not ported."""
from . import checkpoint, loop, optimizer, straggler

__all__ = ["checkpoint", "loop", "optimizer", "straggler"]
