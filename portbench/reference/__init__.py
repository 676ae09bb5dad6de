"""The plain reference of the benchmark: float32 PyTorch, TF32 off,
with its own copy of the quantization rule.  It imports nothing of the
program."""
