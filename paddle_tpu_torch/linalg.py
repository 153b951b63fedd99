"""paddle.linalg: the registry's linear-algebra ops under their public
names.

Counterpart of ``paddle_tpu/linalg.py`` (the same names; ``inv`` is the
``inverse`` op). Each function keeps the boundary rule: ``Tensor`` in,
``Tensor`` out; torch in, torch out (``ops.dispatcher.boundary_op``).
"""

from .ops.dispatcher import boundary_op as _op

cholesky = _op("cholesky")
cholesky_solve = _op("cholesky_solve")
cond = _op("cond")
corrcoef = _op("corrcoef")
cov = _op("cov")
det = _op("det")
eig = _op("eig")
eigh = _op("eigh")
eigvals = _op("eigvals")
eigvalsh = _op("eigvalsh")
householder_product = _op("householder_product")
inv = _op("inverse")
lstsq = _op("lstsq")
lu = _op("lu")
matrix_norm = _op("matrix_norm")
matrix_power = _op("matrix_power")
matrix_rank = _op("matrix_rank")
multi_dot = _op("multi_dot")
norm = _op("norm")
pinv = _op("pinv")
qr = _op("qr")
slogdet = _op("slogdet")
solve = _op("solve")
svd = _op("svd")
triangular_solve = _op("triangular_solve")
_pca_lowrank = _op("pca_lowrank")


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized low-rank PCA: ``(U, S, V)`` with ``X ~ U diag(S) V^T``
    (the registry's ``pca_lowrank``; its draws come from the port's
    generator)."""
    return _pca_lowrank(x, q=q, center=center, niter=int(niter))


__all__ = ["cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det",
           "eig", "eigh", "eigvals", "eigvalsh", "householder_product", "inv",
           "lstsq", "lu", "matrix_norm", "matrix_power", "matrix_rank",
           "multi_dot", "norm", "pca_lowrank", "pinv", "qr", "slogdet",
           "solve", "svd", "triangular_solve"]
