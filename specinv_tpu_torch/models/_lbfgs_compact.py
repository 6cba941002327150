"""Compact-representation L-BFGS direction (Byrd-Nocedal-Schnabel).

Counterpart of ``specinv_tpu/models/_lbfgs_compact.py``.  The two-loop
recursion is ``2m`` sequential (dot, axpy) stages over ``(n,)`` history rows;
it is algebraically equal to two ``m x m`` triangular solves plus four
``(m, n)`` matvecs [Byrd, Nocedal & Schnabel, "Representations of
quasi-Newton matrices", Math. Prog. 63 (1994)].  With ``A = S Y^T``
(``A_ij = s_i . y_j``, i/j oldest to newest), the first loop's coefficients
solve the upper-triangular system

    (strictU(A) + diag(1/rho)) a = S u

the initial vector is ``r0 = gamma (u - a^T Y)``, the second loop's
coefficients solve the lower-triangular system

    (strictL(A^T) + diag(1/rho)) b = Y r0 + strictL(A^T) a

and the direction is ``d = r0 + (a - b)^T S``.  ``A`` is kept incrementally:
inserting a pair ``(s, y)`` refreshes one row (``Y s``) and one column
(``S y``), two matvecs.

The history is one tensor per buffer, ``(m, *x.shape)``; with a history
stored narrower than the vector (``history_dtype='bfloat16'``) every product
accumulates in the vector's type.  The JAX package's optax wrapper
(``scale_by_compact_lbfgs``) has no counterpart: its update rule is the
strong-Wolfe loop of ``models/lbfgs.py``.
"""
from __future__ import annotations

import torch


def tree_matvec(stacked: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """``(m, *shape)`` history times a ``shape`` vector -> ``(m,)`` dots.

    A history stored narrower than the vector is widened to the vector's
    type first, so the products accumulate there (the JAX package's mixed
    einsum promotes the same way)."""
    rows = stacked.reshape(stacked.shape[0], -1)
    if rows.dtype != vec.dtype:
        rows = rows.to(vec.dtype)
    return rows @ vec.reshape(-1)


def tree_weighted_rows(stacked: torch.Tensor, w: torch.Tensor, like=None) -> torch.Tensor:
    """``sum_i w_i * stacked[i]``, shaped like one row.

    ``like`` (a tensor shaped like one row) sets the accumulation type when
    the history is stored narrower; without it the history's type is
    kept."""
    dt = stacked.dtype if like is None else like.dtype
    rows = stacked.reshape(stacked.shape[0], -1)
    if rows.dtype != dt:
        rows = rows.to(dt)
    return (w.to(dt) @ rows).reshape(stacked.shape[1:])


def compact_direction(u, sbuf, ybuf, rho, gram, perm, valid, gamma):
    """The two-loop recursion's result ``H u`` through the compact form.

    Args:
      u: input vector (``-grad`` on the fixed-step path, ``+grad`` on the
        strong-Wolfe path).
      sbuf / ybuf: ``(m, *shape)`` history in physical slot order.
      rho: ``(m,)`` curvature weights ``1/(s.y)`` (0 marks an unusable slot).
      gram: ``(m, m)`` physical-order ``A = S Y^T`` kept by :func:`gram_insert`.
      perm: ``(m,)`` int64, the physical slot of logical position i (0 =
        oldest).
      valid: ``(m,)`` bool in logical order.
      gamma: initial inverse-Hessian scale (0-d tensor).
    """
    m = rho.shape[0]
    dt = rho.dtype
    a_log = gram[perm][:, perm].to(dt)
    rho_log = rho[perm]
    cross = valid[:, None] & valid[None, :]
    iota = torch.arange(m, device=rho.device)
    upper = iota[:, None] < iota[None, :]
    one = torch.ones((), dtype=dt, device=rho.device)
    zero = torch.zeros((), dtype=dt, device=rho.device)
    diag = torch.where(valid, 1.0 / torch.where(valid, rho_log, one), one)
    r_mat = torch.where(upper & cross, a_log, zero) + torch.diag(diag)
    strict_l = torch.where(upper.T & cross, a_log.T, zero)
    l_mat = strict_l + torch.diag(diag)

    su = tree_matvec(sbuf, u).to(dt)
    su_log = torch.where(valid, su[perm], zero)
    alpha = torch.linalg.solve_triangular(r_mat, su_log[:, None], upper=True)[:, 0]

    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = iota
    alpha_phys = alpha[inv_perm]
    q = u - tree_weighted_rows(ybuf, alpha_phys, like=u).to(u.dtype)
    r0 = gamma.to(q.dtype) * q

    yr0 = tree_matvec(ybuf, r0).to(dt)
    rhs = torch.where(valid, yr0[perm], zero) + strict_l @ alpha
    beta = torch.linalg.solve_triangular(l_mat, rhs[:, None], upper=False)[:, 0]

    c_phys = (alpha - beta)[inv_perm]
    return r0 + tree_weighted_rows(sbuf, c_phys, like=r0).to(r0.dtype)


def gram_insert(gram, sbuf, ybuf, slot, s_new, y_new):
    """``A = S Y^T`` after the pair ``(s, y)`` was written at physical
    ``slot``: the slot's row ``s_new . y_j`` and column
    ``s_j . y_new``.  ``sbuf`` / ``ybuf`` must already hold the new pair.
    ``slot`` is an int or a 0-d int64 tensor.  Returns a new matrix."""
    row = tree_matvec(ybuf, s_new).to(gram.dtype)   # s_new . y_j
    col = tree_matvec(sbuf, y_new).to(gram.dtype)   # s_j . y_new
    index = torch.as_tensor(slot, device=gram.device).reshape(1)
    gram = gram.index_copy(0, index, row[None])
    return gram.index_copy(1, index, col[:, None])
