from .registry import ARCHS, get

__all__ = ["ARCHS", "get"]
