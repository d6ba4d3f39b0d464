"""Sparse Gaussian-process dynamics (counterpart of ``vjf_tpu/gp``): the
covariance functions, the SGP transition module that plugs into the fit
path beside the RBF dynamics, and the standalone ``SGP`` regression class."""
from . import covfun, sgp
from .sgp import SGP

__all__ = ["SGP", "covfun", "sgp"]
