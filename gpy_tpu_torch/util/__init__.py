from . import (choleskies, convert, functions, initialization, linalg, ln_diff_erfs, multioutput,
               normalizer, pca, wofz)

__all__ = ["linalg", "convert", "choleskies", "multioutput", "initialization", "normalizer",
           "pca", "functions", "ln_diff_erfs", "wofz"]
