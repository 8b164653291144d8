from .convert import load_paddle_tpu_params, params_from_paddle_tpu
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, StaticKVCache,
                  gpt_configs)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "StaticKVCache",
           "gpt_configs", "load_paddle_tpu_params", "params_from_paddle_tpu"]
