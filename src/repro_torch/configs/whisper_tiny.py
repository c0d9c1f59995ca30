"""Assigned architecture config (see repro_torch.configs.catalog for the table)."""
from repro_torch.configs.catalog import WHISPER_TINY as CONFIG

__all__ = ["CONFIG"]
