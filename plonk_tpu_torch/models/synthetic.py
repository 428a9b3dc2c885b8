"""Synthetic scaled circuits (port of `plonk_tpu/models/synthetic.py`).

square_chain_circuit(n): n multiplication gates computing the chain
x, x^2, x^4, ..., with copy constraints wiring b_i = a_i and
a_{i+1} = c_i.
"""
from __future__ import annotations

import numpy as np

# copy-constraint wire tags (plonk_tpu/models/constraints.py:31)
COPYOF_A, COPYOF_B, COPYOF_C = 0, 1, 2


def square_chain_circuit(p: int, n: int, x0: int = 3):
    """Returns (selectors (5, n), copies (3, n, 2), a, b, c) as numpy arrays
    in standard form for the scalar field p. Gate i: a_i * b_i = c_i with
    b_i = a_i (squaring) and a_{i+1} = c_i (chaining)."""
    selectors = np.zeros((5, n), dtype=np.uint32)
    # rows: q_l, q_r, q_o, q_m, q_c  — mul gates: q_m = 1, q_o = -1
    selectors[2, :] = p - 1
    selectors[3, :] = 1

    # copy permutation cycles per wire variable:
    #   v_i at A_i, B_i and (for i >= 1) C_{i-1}:  A_i -> B_i -> C_{i-1} -> A_i
    #   v_0: A_0 -> B_0 -> A_0;  v_n only at C_{n-1} (fixed point)
    c_a = np.zeros((n, 2), dtype=np.int64)
    c_b = np.zeros((n, 2), dtype=np.int64)
    c_c = np.zeros((n, 2), dtype=np.int64)
    for i in range(n):
        c_a[i] = (COPYOF_B, i + 1)                 # A_i -> B_i
        if i == 0:
            c_b[i] = (COPYOF_A, 1)                 # B_0 -> A_0
        else:
            c_b[i] = (COPYOF_C, i)                 # B_i -> C_{i-1}
        if i < n - 1:
            c_c[i] = (COPYOF_A, i + 2)             # C_i -> A_{i+1}
        else:
            c_c[i] = (COPYOF_C, n)                 # C_{n-1} fixed point
    copies = np.stack([c_a, c_b, c_c])

    a = np.empty(n, dtype=np.uint32)
    cur = x0 % p
    for i in range(n):
        a[i] = cur
        cur = (cur * cur) % p
    b = a.copy()
    c = (a.astype(np.uint64) * a % p).astype(np.uint32)
    return selectors, copies, a, b, c
