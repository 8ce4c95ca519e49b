from repro_torch.config.base import (
    AttentionConfig,
    CrossAttnConfig,
    EncoderConfig,
    GossipConfig,
    MoEConfig,
    ModelConfig,
    RGLRUConfig,
    SSMConfig,
)
from repro_torch.config.registry import (get_config, list_configs,
                                         reduced_config, register_config)

__all__ = [
    "AttentionConfig", "CrossAttnConfig", "EncoderConfig", "GossipConfig",
    "MoEConfig", "ModelConfig", "RGLRUConfig", "SSMConfig", "get_config", "list_configs",
    "reduced_config", "register_config",
]
