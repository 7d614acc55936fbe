"""gpy_tpu_torch: the PyTorch/CUDA port of gpy_tpu for NVIDIA Hopper.

The public surface mirrors gpy_tpu (and GPy): gpy_tpu_torch.models,
gpy_tpu_torch.kern, gpy_tpu_torch.likelihoods, gpy_tpu_torch.inference,
gpy_tpu_torch.mcmc, gpy_tpu_torch.mappings, gpy_tpu_torch.priors. Models
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
           "Model", "Module", "Param", "GP"]
