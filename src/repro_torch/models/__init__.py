"""The LM stack (counterpart of ``repro.models``): config, layers, the
attention and SSD mixers, blocks and ``CausalLM``."""
