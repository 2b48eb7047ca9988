"""Assembled sparse EL system + direct solve (host, numpy/scipy, float64).

Counterpart of ``opticalflow_tpu.solve.direct``: an independent vectorised
COO assembly of the full EL system (interior equations plus the reference's
mirror boundary rows) from one pair's coefficient planes, solved with
``scipy.sparse.linalg.spsolve``.  It is the float64 oracle of the tests and
of ``chip_smoke.py``, and the ``use_direct_solver=True`` path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def flat_index(i, j, q, n_j: int):
    """Interleaved 3-field flat index ``3*Nj*i + 3*j + q``."""
    return 3 * n_j * np.asarray(i) + 3 * np.asarray(j) + q


def assemble_el_matrix(coeffs, n_i: int, n_j: int):
    """Full EL system matrix as scipy CSR (float64).  ``coeffs``: one pair's
    ``ELCoefficients`` (planes (Ni-2, Nj-2), scalar alphas) as numpy arrays
    or CPU tensors."""
    import scipy.sparse

    c = {k: np.asarray(v, dtype=np.float64) for k, v in coeffs._asdict().items()}
    a_s = float(c["speed_alpha"])
    a_r = float(c["remodelling_alpha"])

    ii, jj = np.meshgrid(np.arange(1, n_i - 1), np.arange(1, n_j - 1), indexing="ij")
    ones = np.ones_like(ii, dtype=np.float64)
    rows, cols, vals = [], [], []

    def add(q_row, q_col, di, dj, plane):
        rows.append(flat_index(ii, jj, q_row, n_j).ravel())
        cols.append(flat_index(ii + di, jj + dj, q_col, n_j).ravel())
        vals.append(np.broadcast_to(plane, ii.shape).ravel())

    UX, UY, G = 0, 1, 2
    # u_x equation
    add(UX, UX, 0, 0, c["diag_x"])
    add(UX, UY, 0, 0, c["cross"])
    add(UX, UX, -1, 0, c["adv_xm"])
    add(UX, UX, +1, 0, c["adv_xp"])
    add(UX, UX, 0, -1, a_s * ones)
    add(UX, UX, 0, +1, a_s * ones)
    add(UX, UY, 0, -1, -c["gx"])
    add(UX, UY, 0, +1, c["gx"])
    add(UX, UY, -1, 0, -c["gy"])
    add(UX, UY, +1, 0, c["gy"])
    add(UX, UY, -1, -1, c["quart"])
    add(UX, UY, +1, +1, c["quart"])
    add(UX, UY, -1, +1, -c["quart"])
    add(UX, UY, +1, -1, -c["quart"])
    add(UX, G, -1, 0, c["half_I"])
    add(UX, G, +1, 0, -c["half_I"])
    # u_y equation
    add(UY, UY, 0, 0, c["diag_y"])
    add(UY, UX, 0, 0, c["cross"])
    add(UY, UY, 0, -1, c["adv_ym"])
    add(UY, UY, 0, +1, c["adv_yp"])
    add(UY, UY, -1, 0, a_s * ones)
    add(UY, UY, +1, 0, a_s * ones)
    add(UY, UX, -1, 0, -c["gy"])
    add(UY, UX, +1, 0, c["gy"])
    add(UY, UX, 0, -1, -c["gx"])
    add(UY, UX, 0, +1, c["gx"])
    add(UY, UX, -1, -1, c["quart"])
    add(UY, UX, +1, +1, c["quart"])
    add(UY, UX, -1, +1, -c["quart"])
    add(UY, UX, +1, -1, -c["quart"])
    add(UY, G, 0, -1, c["half_I"])
    add(UY, G, 0, +1, -c["half_I"])
    # gamma equation
    add(G, G, 0, 0, (-1.0 - 4.0 * a_r) * ones)
    add(G, UX, 0, 0, c["dIdx"])
    add(G, UY, 0, 0, c["dIdy"])
    add(G, G, -1, 0, a_r * ones)
    add(G, G, +1, 0, a_r * ones)
    add(G, G, 0, -1, a_r * ones)
    add(G, G, 0, +1, a_r * ones)
    add(G, UX, -1, 0, -c["half_I"])
    add(G, UX, +1, 0, c["half_I"])
    add(G, UY, 0, -1, -c["half_I"])
    add(G, UY, 0, +1, c["half_I"])

    # Boundary rows: unit diagonal per field; top/bottom rows mirror across
    # i, left/right across j; corners receive both mirror terms.
    bmask = np.zeros((n_i, n_j), dtype=bool)
    bmask[0, :] = bmask[-1, :] = bmask[:, 0] = bmask[:, -1] = True
    bi, bj = np.nonzero(bmask)
    for q in range(3):
        rows.append(flat_index(bi, bj, q, n_j))
        cols.append(flat_index(bi, bj, q, n_j))
        vals.append(np.ones(bi.shape[0]))
    all_j = np.arange(n_j)
    all_i = np.arange(n_i)
    for q in range(3):
        rows.append(flat_index(np.zeros_like(all_j), all_j, q, n_j))
        cols.append(flat_index(np.full_like(all_j, 2), all_j, q, n_j))
        vals.append(-np.ones(n_j))
        rows.append(flat_index(np.full_like(all_j, n_i - 1), all_j, q, n_j))
        cols.append(flat_index(np.full_like(all_j, n_i - 3), all_j, q, n_j))
        vals.append(-np.ones(n_j))
        rows.append(flat_index(all_i, np.zeros_like(all_i), q, n_j))
        cols.append(flat_index(all_i, np.full_like(all_i, 2), q, n_j))
        vals.append(-np.ones(n_i))
        rows.append(flat_index(all_i, np.full_like(all_i, n_j - 1), q, n_j))
        cols.append(flat_index(all_i, np.full_like(all_i, n_j - 3), q, n_j))
        vals.append(-np.ones(n_i))

    n = 3 * n_i * n_j
    mat = scipy.sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(n, n)
    )
    return mat.tocsr()


def fields_to_flat(u: np.ndarray) -> np.ndarray:
    """(3, Ni, Nj) field stack -> interleaved flat vector."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(u), 0, -1)).ravel()


def flat_to_fields(x: np.ndarray, n_i: int, n_j: int) -> np.ndarray:
    """Interleaved flat vector -> (3, Ni, Nj) field stack."""
    return np.moveaxis(np.asarray(x).reshape(n_i, n_j, 3), -1, 0)


def direct_solve(coeffs, rhs: np.ndarray) -> Tuple[np.ndarray, bool]:
    """spsolve the assembled system of one pair; ``rhs`` is (3, Ni, Nj)."""
    import scipy.sparse.linalg

    rhs = np.asarray(rhs, dtype=np.float64)
    n_i, n_j = rhs.shape[-2:]
    mat = assemble_el_matrix(coeffs, n_i, n_j)
    x = scipy.sparse.linalg.spsolve(mat, fields_to_flat(rhs))
    return flat_to_fields(x, n_i, n_j), True
