from hint_tpu_torch.configs.registry import Config, get_config, list_configs

__all__ = ["Config", "get_config", "list_configs"]
