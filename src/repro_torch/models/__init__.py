from repro_torch.models.config import ModelConfig, reduced
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import DecoderLM

__all__ = ["DecoderLM", "EncDecLM", "ModelConfig", "build_model", "reduced"]
