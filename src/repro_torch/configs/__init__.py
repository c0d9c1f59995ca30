from repro_torch.configs.catalog import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable

__all__ = ["ARCHS", "get_config", "SHAPES", "ShapeSpec", "applicable"]
