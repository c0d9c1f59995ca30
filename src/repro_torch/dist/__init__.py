from repro_torch.dist import sharding

__all__ = ["sharding"]
