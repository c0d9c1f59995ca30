"""Assigned architecture config (see repro_torch.configs.catalog for the table)."""
from repro_torch.configs.catalog import GRANITE_3_2B as CONFIG

__all__ = ["CONFIG"]
