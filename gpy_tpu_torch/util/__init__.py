from . import choleskies, convert, initialization, linalg, multioutput, pca

__all__ = ["linalg", "convert", "choleskies", "multioutput", "initialization", "pca"]
