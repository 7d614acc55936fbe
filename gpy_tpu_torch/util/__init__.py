from . import (choleskies, convert, diagnostics, functions, initialization, linalg, ln_diff_erfs,
               misc, mocap, multioutput, netpbmfile, normalizer, pca, wofz)

__all__ = ["linalg", "convert", "choleskies", "multioutput", "initialization", "normalizer",
           "pca", "functions", "ln_diff_erfs", "wofz", "diagnostics", "misc", "mocap",
           "netpbmfile"]
