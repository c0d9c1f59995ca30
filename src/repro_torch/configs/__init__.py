from repro_torch.configs.catalog import ARCHS, get_config

__all__ = ["ARCHS", "get_config"]
