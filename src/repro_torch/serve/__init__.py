"""Serving of the port: the batched prefill + decode engine."""
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: F401
