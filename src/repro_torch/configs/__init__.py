"""Configs of the port. Importing this package registers the LM
architectures (``repro_torch.config.get_config``); ``gossip_linear`` is
the paper's own model family."""
from repro_torch.configs import qwen3_1p7b, qwen3_4b, qwen3_8b  # noqa: F401
