"""Models (counterparts of paddle_tpu/models)."""
from .convert import load_jax_state_dict
from .generation import GenerationMixin, init_kv_cache
from .gpt import GPTConfig, GPTForCausalLM
from .llama import LlamaConfig, LlamaForCausalLM
