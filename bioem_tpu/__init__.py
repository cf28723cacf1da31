"""bioem_tpu — Bayesian inference of cryo-EM particle images in JAX.

A from-scratch JAX/XLA framework, run on NVIDIA GPUs, with the capabilities of
bio-phys/BioEM (reference mounted at /root/reference): posterior probability
of a structural model given particle images, marginalised over orientation,
CTF/PSF and center-displacement nuisance grids with numerically stable
log-sum-exp, plus maximizing-parameter tracking and per-orientation
posteriors. Beyond the reference: continuous gradient-based refinement of
the maximizing parameters (``bioem_tpu.refine``) via autodiff on the
forward model.
"""

__version__ = "0.1.0"

from . import defs
from .config import RunConfig
from .params import BioEMParams, read_parameters
from .refine import RefineResult, refine_results

__all__ = [
    "defs", "RunConfig", "BioEMParams", "read_parameters",
    "RefineResult", "refine_results",
]
