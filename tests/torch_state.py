"""Carry a factorization from the JAX package into the PyTorch port:
read plain numpy arrays off a JAX ``SparseLU`` for
``superlu_dist_tpu_torch.SparseLU.from_numpy_state``. Lives with the
tests because only the tests import both packages."""

import dataclasses

import numpy as np
import scipy.sparse as sp


def numpy_state(jlu, options) -> dict:
    """The solve-ready state of JAX-package ``jlu``; ``options`` is the
    port's Options equal to ``jlu.options``."""
    pool, linv, uinv = jlu._export_factors()
    A = sp.coo_matrix(jlu._A_orig)
    exp = getattr(jlu, "_expand", None)
    return dict(
        options=options, n=jlu.n,
        rowperm=np.asarray(jlu.rowperm), colperm=np.asarray(jlu.colperm),
        row_scale=np.asarray(jlu.row_scale),
        col_scale=np.asarray(jlu.col_scale),
        expand=None if exp is None else np.asarray(exp),
        plan={f.name: getattr(jlu.plan, f.name)
              for f in dataclasses.fields(jlu.plan)},
        pool=np.asarray(pool), linv=np.asarray(linv), uinv=np.asarray(uinv),
        anorm=float(jlu._anorm), a_row=A.row, a_col=A.col, a_data=A.data)
