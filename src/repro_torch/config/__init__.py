from repro_torch.config.model import FAMILIES, ModelConfig, validate

__all__ = ["FAMILIES", "ModelConfig", "validate"]
