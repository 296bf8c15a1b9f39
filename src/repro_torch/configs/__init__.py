from repro_torch.configs.base import (ALIASES, ARCH_IDS, INPUT_SHAPES,
                                      ArchConfig, InputShape, MLAConfig,
                                      MoEConfig, SSMConfig, all_configs,
                                      get_config, input_specs)

__all__ = ["ALIASES", "ARCH_IDS", "INPUT_SHAPES", "ArchConfig", "InputShape",
           "MLAConfig", "MoEConfig", "SSMConfig", "all_configs", "get_config",
           "input_specs"]
