from . import choleskies, convert, linalg, multioutput

__all__ = ["linalg", "convert", "choleskies", "multioutput"]
