"""Model components of the port (counterpart of ``vjf_tpu/models``)."""
from .rbfn import RBFNParams, apply_rbfn, init_rbfn
from .regression import (
    BLRState,
    CovarianceBLR,
    NonBayesLR,
    NSVBLR,
    PrecisionBLR,
)

__all__ = [
    "BLRState",
    "CovarianceBLR",
    "NonBayesLR",
    "NSVBLR",
    "PrecisionBLR",
    "RBFNParams",
    "apply_rbfn",
    "init_rbfn",
]
