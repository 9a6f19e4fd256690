from . import llama

__all__ = ["llama"]
