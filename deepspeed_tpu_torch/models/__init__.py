from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, init_llama,
                    init_llama_for_causal_lm, precompute_rope)  # noqa: F401
