"""The port's benchmark (``run.py``): cells of ``BENCHMARK.json`` run on
one H100 against the plain reference under ``reference/``.  It imports
the port (``repro_torch``) and never JAX or the JAX package."""
