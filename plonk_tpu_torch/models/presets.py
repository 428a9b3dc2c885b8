"""Canonical test circuit and scenario: port of
`plonk_tpu/models/presets.py` (mirrors src/plonk-test.c:123-267).

The 4-gate Pythagoras-style circuit: three multiplications a_i * b_i = c_i
and one addition, with the copy constraints wiring a^2 + b^2 = c^2 for
(3, 4, 5), witness values in F17."""
from __future__ import annotations

import numpy as np

from ..utils.params import TOY_PLONK
from .constraints import (Constraints, Assignments, Gate, make_constraints,
                          COPYOF_A, COPYOF_B, COPYOF_C)

# challenges alpha, beta, gamma, z, v (src/plonk-test.c:262-267)
CANONICAL_CHALLENGE = np.array([15, 12, 13, 5, 12], dtype=np.int64)
# blinding b1..b9 (src/plonk-test.c:249-259)
CANONICAL_RAND = np.array([7, 4, 11, 12, 16, 2, 14, 11, 7], dtype=np.int64)
CANONICAL_SECRET = 2
CANONICAL_N_SRS = 6
CANONICAL_H_LEN = 4


def canonical_constraints(p: int = 17) -> Constraints:
    mul = Gate(0, 0, p - 1, 1, 0)   # q_m=1, q_o=-1 (src/plonk-test.c:160-186)
    add = Gate(1, 1, p - 1, 0, 0)
    gates = [mul, mul, mul, add]
    c_a = [(COPYOF_B, 1), (COPYOF_B, 2), (COPYOF_B, 3), (COPYOF_C, 1)]
    c_b = [(COPYOF_A, 1), (COPYOF_A, 2), (COPYOF_A, 3), (COPYOF_C, 2)]
    c_c = [(COPYOF_A, 4), (COPYOF_B, 4), (COPYOF_C, 4), (COPYOF_C, 3)]
    return make_constraints(p, gates, c_a, c_b, c_c)


def canonical_assignments() -> Assignments:
    # (src/plonk-test.c:225-246)
    return Assignments(a=np.array([3, 4, 5, 9], dtype=np.int64),
                       b=np.array([3, 4, 5, 16], dtype=np.int64),
                       c=np.array([9, 16, 25, 25], dtype=np.int64))


def canonical_context(srs_mode: str = "reference", use_pippenger=False,
                      commit_mode: str = "naive", device=None):
    """The canonical context on `device` (default: the CUDA card; pass
    device="cpu" for the CPU)."""
    from .plonk import plonk_new
    return plonk_new(TOY_PLONK, secret=CANONICAL_SECRET,
                     n_srs=CANONICAL_N_SRS, h_len=CANONICAL_H_LEN,
                     srs_mode=srs_mode, use_pippenger=use_pippenger,
                     commit_mode=commit_mode, device=device)
