"""PLONK proof container (port of `plonk_tpu/models/plonk.py::Proof`)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.curve import G1


class Proof(NamedTuple):
    """9 G1 commitments + 7 scalar-field evaluations (standard form)."""
    a_s: G1
    b_s: G1
    c_s: G1
    z_s: G1
    t_lo_s: G1
    t_mid_s: G1
    t_hi_s: G1
    w_z_s: G1
    w_z_omega_s: G1
    a_z: torch.Tensor
    b_z: torch.Tensor
    c_z: torch.Tensor
    s_sigma_1_z: torch.Tensor
    s_sigma_2_z: torch.Tensor
    r_z: torch.Tensor
    z_omega_z: torch.Tensor


POINT_FIELDS = Proof._fields[:9]
SCALAR_FIELDS = Proof._fields[9:]
