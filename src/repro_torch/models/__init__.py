"""Model library of the torch port: the quantized dense decoder."""
from .convert import params_from_numpy
from .quantized import (SDVLinear, default_sdv_plan, materialize,
                        pack_linear_sdv, sdv_matmul_apply, serve_params)
from .transformer import (decode_step, init_cache, init_params,
                          prefill_step)

__all__ = ["SDVLinear", "decode_step", "default_sdv_plan", "init_cache",
           "init_params", "materialize", "pack_linear_sdv",
           "params_from_numpy", "prefill_step", "sdv_matmul_apply",
           "serve_params"]
