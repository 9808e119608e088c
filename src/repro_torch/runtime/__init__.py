"""Serving runtime of the port."""
from .serve_loop import Request, ServeLoop

__all__ = ["Request", "ServeLoop"]
