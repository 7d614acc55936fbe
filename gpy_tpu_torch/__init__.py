"""gpy_tpu_torch: the PyTorch/CUDA port of gpy_tpu for NVIDIA Hopper.

The public surface mirrors gpy_tpu (and GPy): gpy_tpu_torch.models,
gpy_tpu_torch.kern, gpy_tpu_torch.likelihoods, gpy_tpu_torch.inference,
gpy_tpu_torch.mcmc, gpy_tpu_torch.mappings, gpy_tpu_torch.priors, with
gpy_tpu_torch.plotting, gpy_tpu_torch.examples and gpy_tpu_torch.parallel
loaded at first use and
gpy_tpu_torch.load for saved models. Models
and kernels run on "cuda" unless the caller passes device="cpu". Kernels written for the card live
in csrc/ and build with nvcc at first use; importing the package needs no
compiler.
"""
from . import config  # noqa: F401  (matmul precision policy)
from . import inference
from . import kern
from . import likelihoods
from . import mappings
from . import mcmc
from . import models
from . import util
from .core import priors
from .core.gp import GP
from .core.model import Model
from .core.module import Module, Param

__version__ = "0.1.0"

__all__ = ["kern", "likelihoods", "inference", "mappings", "mcmc", "models", "util", "priors",
           "plotting", "examples", "parallel", "Model", "Module", "Param", "GP", "load"]


def __getattr__(name):
    # plotting (a backend registry), examples and parallel (torch.distributed)
    # load at first use, as in the reference (gpy_tpu/__init__.py:28-38)
    if name in ("plotting", "examples", "parallel"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def load(path, device=None):
    """A model saved with m.save_model(path), every tensor on `device`
    ("cuda" unless the caller passes "cpu"). GPy: GPy/__init__.py:41-58."""
    from .util.serialization import load_model

    return load_model(path, device=device)
