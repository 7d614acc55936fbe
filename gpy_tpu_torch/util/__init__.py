from . import choleskies, convert, linalg

__all__ = ["linalg", "convert", "choleskies"]
