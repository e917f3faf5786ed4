"""Dense ``Ax = b`` solver suite — levmar's interchangeable linear solvers.

Port of ``brdf_tpu/solver/axb.py``. Every solver takes one system ``a (n, n)``,
``b (n,)`` or a batch of them over leading axes (``a (..., n, n)``,
``b (..., n)``), the batch the JAX functions take under ``vmap``, and keeps
the dtype and device of ``a``.

===================  =======================  ==================================
here                 levmar                   method
===================  =======================  ==================================
:func:`ax_eq_b_qr`   ``Axb_core.c:116``       QR (square A)
:func:`ax_eq_b_qrls` ``Axb_core.c:275``       QR least squares (tall A, m ≥ n)
:func:`ax_eq_b_chol` ``Axb_core.c:446``       Cholesky (SPD A)
:func:`ax_eq_b_lu`   ``Axb_core.c:738``       LU with partial pivoting
:func:`ax_eq_b_svd`  ``Axb_core.c:855``       SVD pseudo-inverse (rank-deficient)
:func:`ax_eq_b_ldlt` ``Axb_core.c:1001``      Bunch-Kaufman LDLᵀ (symmetric,
                                              possibly indefinite — the levmar
                                              default)
===================  =======================  ==================================

Singular systems follow the levmar failure convention: a zero pivot gives
non-finite entries in the solution, which the LM acceptance test treats as a
rejected step. :func:`ax_eq_b_svd` gives a minimum-norm solution instead.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "ax_eq_b_qr",
    "ax_eq_b_qrls",
    "ax_eq_b_chol",
    "ax_eq_b_lu",
    "ax_eq_b_svd",
    "ax_eq_b_ldlt",
    "ldlt_bk",
]


def _col(b: torch.Tensor) -> torch.Tensor:
    return b[..., None]


def _upper_solve(r: torch.Tensor, y: torch.Tensor, unit: bool = False) -> torch.Tensor:
    return torch.linalg.solve_triangular(r, _col(y), upper=True, unitriangular=unit)[..., 0]


def _lower_solve(l: torch.Tensor, y: torch.Tensor, unit: bool = False) -> torch.Tensor:
    return torch.linalg.solve_triangular(l, _col(y), upper=False, unitriangular=unit)[..., 0]


def _qt_b(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (q.transpose(-1, -2) @ _col(b))[..., 0]


def ax_eq_b_qr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Square system via QR (``AX_EQ_B_QR``, ``Axb_core.c:116``)."""
    q, r = torch.linalg.qr(a)
    return _upper_solve(r, _qt_b(q, b))


def ax_eq_b_qrls(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tall least-squares system via QR (``AX_EQ_B_QRLS``, ``Axb_core.c:275``):
    minimizes ``‖Ax − b‖₂`` for A of shape (m, n), m ≥ n, full column rank."""
    q, r = torch.linalg.qr(a)  # reduced: q (m, n), r (n, n)
    return _upper_solve(r, _qt_b(q, b))


def ax_eq_b_chol(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD system via Cholesky (``AX_EQ_B_CHOL``, ``Axb_core.c:446``). A
    system that is not positive definite comes back NaN, as the JAX
    package's Cholesky gives it."""
    chol, info = torch.linalg.cholesky_ex(a)
    y = _lower_solve(chol, b)
    x = _upper_solve(chol.transpose(-1, -2), y)
    return torch.where((info != 0)[..., None], torch.full_like(x, float("nan")), x)


def ax_eq_b_lu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """General square system via LU (``AX_EQ_B_LU``, ``Axb_core.c:738``)."""
    lu, piv, _ = torch.linalg.lu_factor_ex(a)
    return torch.linalg.lu_solve(lu, piv, _col(b))[..., 0]


def ax_eq_b_svd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm solution via SVD pseudo-inverse with a relative
    singular-value cutoff (``AX_EQ_B_SVD``, ``Axb_core.c:855``)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    fi = torch.finfo(a.dtype)
    cutoff = fi.eps * a.shape[-1] * torch.amax(s, -1, keepdim=True)
    s_inv = torch.where(s > cutoff, 1.0 / torch.clamp(s, min=fi.tiny), torch.zeros_like(s))
    return (vt.transpose(-1, -2) @ _col(s_inv * _qt_b(u, b)))[..., 0]


# ---------------------------------------------------------------------------
# Bunch-Kaufman LDLᵀ
# ---------------------------------------------------------------------------

# Bunch-Kaufman pivot threshold: minimizes the bound on element growth
# between 1×1 and 2×2 pivots (Bunch & Kaufman 1977; LAPACK ?sytf2).
_ALPHA = (1.0 + math.sqrt(17.0)) / 8.0


def ldlt_bk(a: torch.Tensor):
    """Bunch-Kaufman LDLᵀ factorization of a symmetric matrix (or a batch).

    Computes ``A[perm][:, perm] = L D Lᵀ`` where L is unit lower triangular
    and D is block diagonal with 1×1 and 2×2 blocks, with the partial
    pivoting of LAPACK's ``?sytf2`` (levmar's default solver, ``AX_EQ_B_BK``,
    ``Axb_core.c:1001``).

    As in the JAX package, the factorization is at most n pivot steps of
    full-matrix masked updates (rank-1 or rank-2 trailing updates as outer
    products). Every matrix of the batch takes its own pivot sizes: both
    pivot updates are computed and each matrix selects its own, and a matrix
    that has finished keeps its state.

    Returns ``(lmat, d0, d1, block2, perm)`` with the batch shape in front:

    - ``lmat``  — (n, n) unit lower triangular L
    - ``d0``    — (n,) diagonal of D
    - ``d1``    — (n,) subdiagonal of D (``d1[k] = D[k+1, k]``, nonzero only
      where ``block2[k]``)
    - ``block2``— (n,) bool, True where a 2×2 block *starts*
    - ``perm``  — (n,) int32 row/column permutation
    """
    batch, n = a.shape[:-2], a.shape[-1]
    dtype, dev = a.dtype, a.device
    aw = a.reshape(-1, n, n).clone()
    nb = aw.shape[0]
    bi = torch.arange(nb, device=dev)
    rows = torch.arange(n, device=dev)
    alpha = _ALPHA
    zero = torch.zeros((), dtype=dtype, device=dev)
    neg_inf = torch.full((), -math.inf, dtype=dtype, device=dev)
    lmat = torch.eye(n, dtype=dtype, device=dev).expand(nb, n, n).clone()
    d0 = torch.zeros(nb, n, dtype=dtype, device=dev)
    d1 = torch.zeros(nb, n, dtype=dtype, device=dev)
    b2 = torch.zeros(nb, n, dtype=torch.bool, device=dev)
    perm = torch.arange(n, dtype=torch.int64, device=dev).expand(nb, n).clone()
    k = torch.zeros(nb, dtype=torch.int64, device=dev)

    def set_col(mat, col, values):
        out = mat.clone()
        out[bi, :, col] = values
        return out

    def set_at(vec, idx, values):
        out = vec.clone()
        out[bi, idx] = values
        return out

    for _ in range(n):
        active = k < n
        kk = torch.clamp(k, max=n - 1)     # clamped for safe indexing when done
        below = rows[None, :] > kk[:, None]
        absakk = torch.abs(aw[bi, kk, kk])

        # largest |A[i, k]| below the diagonal
        col = torch.where(below, torch.abs(aw[bi, :, kk]), neg_inf)
        r = torch.argmax(col, -1)
        colmax = torch.where(kk < n - 1, col[bi, r], zero)

        # largest off-diagonal |A[r, j]| in the trailing submatrix row r
        rowv = torch.where((rows[None, :] >= kk[:, None]) & (rows[None, :] != r[:, None]),
                           torch.abs(aw[bi, r, :]), neg_inf)
        rowmax = torch.maximum(torch.amax(rowv, -1), zero)

        take_1x1_noswap = absakk >= alpha * colmax
        take_1x1_row = absakk * rowmax >= alpha * colmax * colmax
        take_1x1_diag = torch.abs(aw[bi, r, r]) >= alpha * rowmax
        # degenerate all-zero column: a 1×1 zero pivot (→ inf/NaN in the
        # solve, the levmar singular-system signal)
        take_1x1_noswap = take_1x1_noswap | (torch.maximum(absakk, colmax) == 0)

        step2 = ~(take_1x1_noswap | take_1x1_row | take_1x1_diag)
        do_swap = ~take_1x1_noswap & ~take_1x1_row
        # 1×1 with swap exchanges k↔r; 2×2 exchanges (k+1)↔r
        k_next = torch.clamp(kk + 1, max=n - 1)
        swap_from = torch.where(step2, k_next, kk)
        kp = torch.where(do_swap, r, swap_from)

        # symmetric row/col swap of the working matrix; rows of L swapped in
        # the columns already computed (< k), LAPACK-style
        i_, j_ = swap_from[:, None], kp[:, None]
        idx = torch.where(rows == i_, j_, torch.where(rows == j_, i_, rows[None, :]))
        aw_s = aw[bi[:, None, None], idx[:, :, None], idx[:, None, :]]
        colmask = rows[None, :] < kk[:, None]
        row_i, row_j = lmat[bi, swap_from], lmat[bi, kp]
        lmat_s = set_at(lmat, swap_from, torch.where(colmask, row_j, row_i))
        lmat_s[bi, kp] = torch.where(colmask, row_i, row_j)
        perm_s = torch.gather(perm, 1, idx)
        sw = active & do_swap
        aw = torch.where(sw[:, None, None], aw_s, aw)
        lmat = torch.where(sw[:, None, None], lmat_s, lmat)
        perm = torch.where(sw[:, None], perm_s, perm)

        # 1×1 pivot
        d = aw[bi, kk, kk]
        colv = torch.where(below, aw[bi, :, kk], zero)
        d_safe = torch.where(d == 0, torch.ones_like(d), d)
        lcol = colv / d_safe[:, None]
        lcol = torch.where((d == 0)[:, None],
                           torch.where(colv != 0, torch.full_like(colv, math.inf), zero), lcol)
        lmat1 = set_col(lmat, kk, torch.where(below, lcol, lmat[bi, :, kk]))
        aw1 = aw - lcol[:, :, None] * colv[:, None, :]
        d0_1 = set_at(d0, kk, d)
        d1_1 = set_at(d1, kk, zero.expand(nb))
        b2_1 = set_at(b2, kk, torch.zeros(nb, dtype=torch.bool, device=dev))

        # 2×2 pivot
        k1 = k_next
        b00, b10, b11 = aw[bi, kk, kk], aw[bi, k1, kk], aw[bi, k1, k1]
        det = b00 * b11 - b10 * b10
        below2 = rows[None, :] > k1[:, None]
        c0 = torch.where(below2, aw[bi, :, kk], zero)
        c1 = torch.where(below2, aw[bi, :, k1], zero)
        # [l0 l1] = [c0 c1] · B⁻¹
        l0 = (c0 * b11[:, None] - c1 * b10[:, None]) / det[:, None]
        l1 = (c1 * b00[:, None] - c0 * b10[:, None]) / det[:, None]
        lmat2 = set_col(lmat, kk, torch.where(below2, l0, lmat[bi, :, kk]))
        lmat2 = set_col(lmat2, k1, torch.where(below2, l1, lmat2[bi, :, k1]))
        aw2 = aw - l0[:, :, None] * c0[:, None, :] - l1[:, :, None] * c1[:, None, :]
        d0_2 = set_at(set_at(d0, kk, b00), k1, b11)
        d1_2 = set_at(d1, kk, b10)
        b2_2 = set_at(b2, kk, torch.ones(nb, dtype=torch.bool, device=dev))

        # each matrix takes its own pivot; matrices past the end keep their state
        s2 = step2[:, None]
        s2m = step2[:, None, None]
        act, actm = active[:, None], active[:, None, None]
        aw = torch.where(actm, torch.where(s2m, aw2, aw1), aw)
        lmat = torch.where(actm, torch.where(s2m, lmat2, lmat1), lmat)
        d0 = torch.where(act, torch.where(s2, d0_2, d0_1), d0)
        d1 = torch.where(act, torch.where(s2, d1_2, d1_1), d1)
        b2 = torch.where(act, torch.where(s2, b2_2, b2_1), b2)
        k = torch.where(active, torch.where(step2, kk + 2, kk + 1), k)

    return (lmat.reshape(*batch, n, n), d0.reshape(*batch, n), d1.reshape(*batch, n),
            b2.reshape(*batch, n), perm.to(torch.int32).reshape(*batch, n))


def _block_diag_solve(d0, d1, b2, w):
    """Solve ``D y = w`` for block-diagonal D given as (diag, subdiag, starts),
    over the last axis: every position is the start of a 2×2 block, the
    second element of one, or a 1×1 block; all three candidates are computed
    and selected by mask (``b2[..., n-1]`` is False, so the roll wrap-arounds
    only feed unselected positions)."""
    def roll(x, s):
        return torch.roll(x, s, dims=-1)

    d0n, wn = roll(d0, -1), roll(w, -1)
    det = d0 * d0n - d1 * d1
    y_first = (d0n * w - d1 * wn) / det            # start of a 2×2 block
    d0p, d1p, wp = roll(d0, 1), roll(d1, 1), roll(w, 1)
    b2p = roll(b2, 1)
    detp = d0p * d0 - d1p * d1p
    y_second = (d0p * w - d1p * wp) / detp         # second elem of a 2×2 block
    return torch.where(b2, y_first, torch.where(b2p, y_second, w / d0))


def ax_eq_b_ldlt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric (possibly indefinite) system via Bunch-Kaufman LDLᵀ — the
    levmar default (``AX_EQ_B_BK``, ``Axb_core.c:1001``). Stable for
    indefinite A and free of square roots."""
    lmat, d0, d1, b2, perm = ldlt_bk(a)
    perm = perm.to(torch.int64)
    z = torch.gather(b, -1, perm)
    w = _lower_solve(lmat, z, unit=True)
    y = _block_diag_solve(d0, d1, b2, w)
    u = _upper_solve(lmat.transpose(-1, -2), y, unit=True)
    return torch.zeros_like(u).scatter(-1, perm, u)
