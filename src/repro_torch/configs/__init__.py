"""Configs of the port. Importing this package registers the LM
architectures (``repro_torch.config.get_config``); ``gossip_linear`` is
the paper's own model family.

``ARCH_IDS`` lists the 10 assigned architectures in the reference's
order."""
from repro_torch.configs import (  # noqa: F401
    llama3_405b, llama4_scout, llama32_vision_11b, mamba2_780m,
    mixtral_8x22b, qwen3_1p7b, qwen3_4b, qwen3_8b, recurrentgemma_9b,
    whisper_medium)

ARCH_IDS = [
    "llama-3.2-vision-11b",
    "qwen3-8b",
    "whisper-medium",
    "recurrentgemma-9b",
    "mamba2-780m",
    "qwen3-1.7b",
    "mixtral-8x22b",
    "qwen3-4b",
    "llama3-405b",
    "llama4-scout-17b-a16e",
]
