"""Sparse Gaussian-process dynamics (counterpart of ``vjf_tpu/gp``): the
covariance functions and the SGP transition module that plugs into the fit
path beside the RBF dynamics. The standalone ``SGP`` regression class waits
for the precision backend (ROADMAP Queue 1 item 3)."""
from . import covfun, sgp

__all__ = ["covfun", "sgp"]
