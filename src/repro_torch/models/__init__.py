from .blocks import BlockSpec, ModelConfig
from .transformer import (decode_step, forward, init_cache, init_params,
                          prefill)

__all__ = ["BlockSpec", "ModelConfig", "decode_step", "forward",
           "init_cache", "init_params", "prefill"]
