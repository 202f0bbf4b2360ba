"""Models of the port: the dense decoder family, every dense contraction
routed through ``repro_torch.core``."""
from repro_torch.models.model_registry import Model, build  # noqa: F401
