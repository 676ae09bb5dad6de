"""Model library of the torch port: the quantized dense decoder, the
Mamba2 (ssm) and Griffin (hybrid) decoders, and UltraNet-INT4."""
from .convert import (packed_from_numpy, params_from_numpy,
                      ultranet_params_from_numpy)
from .quantized import (BSEGConv, PackedLinear, SDVLinear, bseg_conv_apply,
                        default_bseg_plan, default_sdv_plan, is_packed,
                        materialize, pack_conv_bseg, pack_linear,
                        pack_linear_sdv, sdv_matmul_apply, serve_params)
from .transformer import (decode_step, init_cache, init_params,
                          prefill_slot, prefill_step, reset_slot)
from .ultranet import UltraNetParams, init_ultranet, ultranet_forward

__all__ = ["BSEGConv", "PackedLinear", "SDVLinear", "UltraNetParams",
           "bseg_conv_apply", "decode_step", "default_bseg_plan",
           "default_sdv_plan", "init_cache", "init_params", "init_ultranet",
           "is_packed", "materialize", "pack_conv_bseg", "pack_linear",
           "pack_linear_sdv", "packed_from_numpy", "params_from_numpy",
           "prefill_slot", "prefill_step", "reset_slot",
           "sdv_matmul_apply", "serve_params",
           "ultranet_forward", "ultranet_params_from_numpy"]
