"""Configs of the port. Importing this package registers the LM
architectures (``repro_torch.config.get_config``); ``gossip_linear`` is
the paper's own model family."""
from repro_torch.configs import (  # noqa: F401
    llama4_scout, llama32_vision_11b, mamba2_780m, mixtral_8x22b, qwen3_1p7b,
    qwen3_4b, qwen3_8b, recurrentgemma_9b, whisper_medium)
