"""Model components of the port (counterpart of ``vjf_tpu/models``)."""
from . import evaluate, smoothing
from .rbfn import RBFNParams, apply_rbfn, init_rbfn
from .regression import (
    BLRState,
    CovarianceBLR,
    NonBayesLR,
    NSVBLR,
    PrecisionBLR,
)

__all__ = [
    "evaluate",
    "smoothing",
    "BLRState",
    "CovarianceBLR",
    "NonBayesLR",
    "NSVBLR",
    "PrecisionBLR",
    "RBFNParams",
    "apply_rbfn",
    "init_rbfn",
]
