"""Inventory of the port: the reference's public names (the lists of
tests/test_inventory.py) looked up in gpy_tpu_torch, and the module map:
every module of gpy_tpu/ and its counterpart in gpy_tpu_torch/.

PORTED lists the names the port has. Every other name is an expected
failure (strict): the count of passes is the progress of the port, and a
name ported without being added to PORTED fails here as an unexpected pass.
Every module of the map has its counterpart (parallel/, A16, the last).
"""
import importlib
import importlib.util
import os

import pytest


def _reference_lists():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_inventory.py")
    spec = importlib.util.spec_from_file_location("_reference_inventory", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_REF = _reference_lists()

# reference list -> (module of the port, names ported so far)
SURFACES = {
    "GPY_KERNELS": ("gpy_tpu_torch.kern", {
        "RBF", "ExpQuad", "Exponential", "OU", "Matern32", "Matern52", "Cosine",
        "ExpQuadCosine", "Sinc", "RatQuad", "Linear", "LinearFull", "TruncLinear",
        "TruncLinear_inf", "Bias", "White", "Fixed", "WhiteHeteroscedastic", "Precomputed",
        "Add", "Prod", "Coregionalize", "IndependentOutputs", "Hierarchical", "MultioutputKern",
        "MultioutputDerivativeKern", "DiffKern", "StdPeriodic", "PeriodicExponential",
        "PeriodicMatern32", "PeriodicMatern52", "MLP", "Poly", "Brownian", "Spline",
        "sde_Matern32", "sde_Matern52", "sde_Exponential", "sde_RBF", "sde_RatQuad",
        "sde_StdPeriodic", "sde_Linear", "sde_White", "sde_Bias", "sde_Brownian",
        "BasisFuncKernel", "LogisticBasisFuncKernel", "LinearSlopeBasisFuncKernel",
        "ChangePointBasisFuncKernel", "PolynomialBasisFuncKernel", "DomainKernel", "Symmetric",
        "SplitKern", "DEtime", "DiffGenomeKern", "GridRBF", "Integral", "Integral_Limits",
        "Multidimensional_Integral_Limits", "EQ_ODE1", "EQ_ODE2", "ODE_UY", "ODE_UYC", "ODE_st",
        "ODE_t", "Symbolic"}),
    "GPY_LIKELIHOODS": ("gpy_tpu_torch.likelihoods", {
        "Gaussian", "HeteroscedasticGaussian", "Bernoulli", "Binomial", "Poisson", "Exponential",
        "Gamma", "StudentT", "Weibull", "LogLogistic", "LogGaussian", "MixedNoise",
        "MultioutputLikelihood"}),
    "GPY_LINKS": ("gpy_tpu_torch.likelihoods.link_functions", {
        "Identity", "Probit", "ScaledProbit", "Cloglog", "Log", "Log_ex_1", "Reciprocal",
        "Heaviside"}),
    "GPY_MODELS": ("gpy_tpu_torch.models", {
        "GPRegression", "GPHeteroscedasticRegression", "SparseGPRegression", "SVGP",
        "GPClassification", "SparseGPClassification", "OneVsAllClassification",
        "OneVsAllSparseClassification", "GPCoregionalizedRegression",
        "SparseGPCoregionalizedRegression", "GPOffsetRegression", "MultioutputGP",
        "SparseGPClassificationUncertainInput", "GPLVM", "SparseGPLVM", "BayesianGPLVM",
        "BayesianGPLVMMiniBatch", "SparseGPMiniBatch", "MRD", "SSGPLVM", "SSMRD", "BCGPLVM",
        "DPBayesianGPLVM", "GPMultioutRegression", "GPMultioutRegressionMD", "TPRegression",
        "StateSpace", "WarpedGP", "InputWarpedGP", "GPKroneckerGaussianRegression",
        "GPRegressionGrid", "GPVariationalGaussianApproximation", "GradientChecker",
        "HessianChecker", "SkewChecker", "IBPLFM"}),
    "GPY_INFERENCE": ("gpy_tpu_torch.inference", {
        "ExactGaussianInference", "VarDTC", "VarDTC_minibatch", "VarDTCMissingData", "FITC",
        "DTC", "PEP", "SVGPInference", "Laplace", "LaplaceBlock", "EP", "EPDTC",
        "ExactStudentTInference", "VarDTC_SVI_Multiout", "VarDTC_SVI_Multiout_Miss", "VarGauss",
        "GaussianGridInference"}),
    "GPY_PRIORS": ("gpy_tpu_torch.core.priors", {
        "Gaussian", "Uniform", "LogGaussian", "MultivariateGaussian", "Gamma",
        "InverseGamma", "Exponential", "StudentT", "HalfT", "DGPLVM", "DGPLVM_Lamda",
        "DGPLVM_T", "DGPLVM_KFDA"}),
}


def _cases():
    for surface, (module, ported) in SURFACES.items():
        for name in getattr(_REF, surface):
            marks = () if name in ported else pytest.mark.xfail(
                strict=True, reason="not ported yet (ROADMAP queue A)")
            yield pytest.param(module, name, marks=marks, id=f"{surface}-{name}")


@pytest.mark.parametrize("module,name", list(_cases()))
def test_name_present_in_port(module, name):
    assert hasattr(importlib.import_module(module), name), f"{module}.{name} missing"


@pytest.mark.parametrize("name", ["HMC", "HMC_shortcut", "Metropolis_Hastings"])
def test_mcmc_present(name):
    """tests/test_inventory.py:114-117."""
    assert hasattr(importlib.import_module("gpy_tpu_torch.mcmc"), name)


def test_port_names_beyond_the_reference_lists():
    """The port's own additions stay importable under the reference's names."""
    from gpy_tpu_torch.inference import IterativeGaussianInference, IterativePosterior  # noqa
    from gpy_tpu_torch.ops import gram_matvec, gram_matvec_fused, pivoted_chol  # noqa
    from gpy_tpu_torch.ops.block_chol import (batched_chol_inv, batched_chol_inv_ll,  # noqa
                                              block_chol, block_chol_inv, rec_block_chol_inv)
    from gpy_tpu_torch.ops.blocked_linalg import rec_chol_inv, tri_inv_doubling  # noqa
    from gpy_tpu_torch.ops.psi2 import rbf_psi2_weighted, ss_rbf_psi2_weighted  # noqa


# --- the module map: gpy_tpu/<path> -> gpy_tpu_torch/<path> -----------------
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# reference modules whose counterpart has another name, each with its reason
ELSEWHERE = {
    "ops/pallas_gram.py": ("csrc/rbf_gram.cu", "its Pallas kernel B1 is a CUDA kernel"),
    "ops/pallas_gram_matvec.py": ("csrc/gram_matvec_fused.cu",
                                  "its Pallas kernels B5 and B6 are CUDA kernels"),
    "ops/pallas_chol.py": ("csrc/block_chol.cu", "its Pallas kernels B2-B4 are CUDA kernels"),
    "ops/pallas_psi.py": ("ops/psi2.py", "it holds no Pallas kernel: a blocked psi2 scan"),
    "native/__init__.py": ("ops/kalman_cpp.py", "the C++ Kalman engine's loader "
                                                "(csrc/kalman.cpp)"),
}
# reference modules with no counterpart on purpose
NOT_NEEDED = {"util/cplx.py": "torch has native complex dtypes (ROADMAP A17)"}
STILL_TO_PORT = {}


def _reference_modules():
    ref = os.path.join(_ROOT, "gpy_tpu")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), ref).replace(os.sep, "/")


def _module_cases():
    for rel in sorted(_reference_modules()):
        marks = (pytest.mark.xfail(strict=True, reason=STILL_TO_PORT[rel])
                 if rel in STILL_TO_PORT else ())
        yield pytest.param(rel, marks=marks, id=rel)


@pytest.mark.parametrize("rel", list(_module_cases()))
def test_module_has_a_counterpart(rel):
    if rel in NOT_NEEDED:
        assert hasattr(__import__("torch"), "complex128"), NOT_NEEDED[rel]
        return
    target = ELSEWHERE.get(rel, (rel, None))[0]
    assert os.path.exists(os.path.join(_ROOT, "gpy_tpu_torch", target)), (
        f"gpy_tpu/{rel} has no counterpart gpy_tpu_torch/{target}")
    if target.endswith(".py"):
        name = "gpy_tpu_torch." + target[:-3].replace("/", ".").removesuffix(".__init__")
        importlib.import_module(name)


def test_module_map_exemptions_are_reference_modules():
    refs = set(_reference_modules())
    assert set(ELSEWHERE) | set(NOT_NEEDED) | set(STILL_TO_PORT) <= refs
