"""Serving for the port's LM stack (PyTorch port of ``repro.serve``)."""
from .engine import Request, ServeConfig, ServingEngine

__all__ = ["Request", "ServeConfig", "ServingEngine"]
