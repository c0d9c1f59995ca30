"""Assigned architecture config (see repro_torch.configs.catalog for the table)."""
from repro_torch.configs.catalog import RWKV6_7B as CONFIG

__all__ = ["CONFIG"]
