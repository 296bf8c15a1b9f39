from repro_torch.configs.base import (ALIASES, ArchConfig, MLAConfig,
                                      MoEConfig, SSMConfig, get_config)

__all__ = ["ALIASES", "ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "get_config"]
