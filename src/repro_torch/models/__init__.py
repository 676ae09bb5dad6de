"""Model library of the torch port: the quantized dense and
mixture-of-experts decoders, the Mamba2 (ssm) and Griffin (hybrid)
decoders, UltraNet-INT4, and the sharding metadata (``param``,
``shard_ctx``)."""
from . import shard_ctx
from .convert import (opt_state_from_numpy, packed_from_numpy,
                      params_from_numpy, ultranet_params_from_numpy)
from .param import P, PartitionSpec, Rules, is_p, specs, values
from .quantized import (BSEGConv, PackedLinear, SDVLinear, bseg_conv_apply,
                        default_bseg_plan, default_sdv_plan, is_packed,
                        materialize, pack_conv_bseg, pack_linear,
                        pack_linear_sdv, sdv_matmul_apply, serve_param_specs,
                        serve_params)
from .transformer import (cache_specs, decode_step, forward, init_cache,
                          init_params, param_specs, prefill_slot,
                          prefill_step, reset_slot, rollback_slot,
                          unembed_hidden, verify_slot, verify_step)
from .ultranet import UltraNetParams, init_ultranet, ultranet_forward

__all__ = ["BSEGConv", "P", "PackedLinear", "PartitionSpec", "Rules",
           "SDVLinear", "UltraNetParams",
           "bseg_conv_apply", "cache_specs", "decode_step",
           "default_bseg_plan", "forward", "is_p", "param_specs",
           "serve_param_specs", "shard_ctx", "specs", "values",
           "default_sdv_plan", "init_cache", "init_params", "init_ultranet",
           "is_packed", "materialize", "opt_state_from_numpy",
           "pack_conv_bseg", "pack_linear",
           "pack_linear_sdv", "packed_from_numpy", "params_from_numpy",
           "prefill_slot", "prefill_step", "reset_slot", "rollback_slot",
           "sdv_matmul_apply", "serve_params", "unembed_hidden",
           "verify_slot", "verify_step",
           "ultranet_forward", "ultranet_params_from_numpy"]
