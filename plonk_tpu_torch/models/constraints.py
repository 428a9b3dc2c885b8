"""Constraint system + circuit frontend: port of
`plonk_tpu/models/constraints.py` (replaces src/constraints.h).

Host-side Python builds the circuit (it is metadata, not compute) as
numpy int64 arrays; `selectors_device` and `Assignments.device` put the
selector vectors (q_l, q_r, q_o, q_m, q_c) and the witness columns on a
device as int64 tensors. The witness check `satisfies` is one vectorized
gate equation instead of the reference's per-gate loop
(src/constraints.h:145-171).

The expression frontend replicates eval_expr (src/constraints.h:273-309)
exactly: post-order traversal, string-interned variables in first-use order
(src/constraints.h:197-216), constants interned as "const_<v>"
pseudo-variables (NOT bound with q_c — the reference leaves constants
unconstrained, src/constraints.h:279-282), intermediate wires named "v<n>".

Capability extension: `build_copy_permutation` derives the c_a/c_b/c_c
cyclic permutations from a gate list's wire indices — the reference leaves
this conversion manual (tests hand-write the COPY_OF arrays,
src/plonk-test.c:196-213); scaled circuits need it automated.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.kernels import resolve_device

# COPY_OF wire-column tags (src/constraints.h:19-23)
COPYOF_A, COPYOF_B, COPYOF_C = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Gate:
    """Selector row: q_l*a + q_r*b + q_o*c + q_m*a*b + q_c = 0
    (src/constraints.h:9-17). Values are python ints mod r."""
    q_l: int
    q_r: int
    q_o: int
    q_m: int
    q_c: int


def gate_sum_a_b(p: int) -> Gate:
    """a + b - c = 0 (src/constraints.h:90-92)."""
    return Gate(1, 1, p - 1, 0, 0)


def gate_sub_a_b(p: int) -> Gate:
    """a - b - c = 0 (src/constraints.h:95-97)."""
    return Gate(1, p - 1, p - 1, 0, 0)


def gate_mul_a_b(p: int) -> Gate:
    """a * b - c = 0 (src/constraints.h:100-102)."""
    return Gate(0, 0, p - 1, 1, 0)


def gate_bind_a(p: int, value: int) -> Gate:
    """a + q_c = 0 (src/constraints.h:105-107)."""
    return Gate(1, 0, 0, 0, value % p)


def gate_bind_to_zero(p: int) -> Gate:
    """c = 0 (src/constraints.h:110-112)."""
    return Gate(0, 0, 1, 0, 0)


@dataclasses.dataclass
class Constraints:
    """Selector columns + copy constraints as arrays (SoA like the
    reference's CONSTRAINTS, src/constraints.h:35-47). copy_* hold
    (type, index) pairs with 1-based indices."""
    q_l: np.ndarray
    q_r: np.ndarray
    q_o: np.ndarray
    q_m: np.ndarray
    q_c: np.ndarray
    c_a: np.ndarray  # (n, 2) int arrays: [type, 1-based index]
    c_b: np.ndarray
    c_c: np.ndarray

    @property
    def n(self) -> int:
        return len(self.q_l)

    def selectors_device(self, device):
        return {k: torch.as_tensor(getattr(self, k).astype(np.int64),
                                   device=device)
                for k in ("q_l", "q_r", "q_o", "q_m", "q_c")}


@dataclasses.dataclass
class Assignments:
    """Wire value columns (src/constraints.h:57-62)."""
    a: np.ndarray
    b: np.ndarray
    c: np.ndarray

    def device(self, device):
        return tuple(torch.as_tensor(col.astype(np.int64), device=device)
                     for col in (self.a, self.b, self.c))


def make_constraints(p: int, gates: Sequence[Gate],
                     c_a: Sequence[Tuple[int, int]],
                     c_b: Sequence[Tuple[int, int]],
                     c_c: Sequence[Tuple[int, int]]) -> Constraints:
    sel = lambda f: np.array([getattr(g, f) % p for g in gates],
                             dtype=np.int64)
    return Constraints(
        q_l=sel("q_l"), q_r=sel("q_r"), q_o=sel("q_o"), q_m=sel("q_m"),
        q_c=sel("q_c"),
        c_a=np.array(c_a, dtype=np.int64),
        c_b=np.array(c_b, dtype=np.int64),
        c_c=np.array(c_c, dtype=np.int64))


def satisfies(F, cons: Constraints, asg: Assignments,
              device=None) -> torch.Tensor:
    """Vectorized witness check on `device` (default: the CUDA card): all
    gate equations == 0 (src/constraints.h:145-171)."""
    device = resolve_device(device)
    s = cons.selectors_device(device)
    a, b, c = asg.device(device)
    lhs = F.add(
        F.add(F.mul(s["q_l"], a), F.mul(s["q_r"], b)),
        F.add(F.mul(s["q_o"], c),
              F.add(F.mul(s["q_m"], F.mul(a, b)), s["q_c"])))
    return (lhs == 0).all()


# ---------------- expression frontend ----------------

class Expr:
    """Expression AST with operator sugar. Mirrors EXPRESSION
    (src/constraints.h:64-82)."""

    def __add__(self, other):
        return BinOp("sum", self, _wrap(other))

    def __sub__(self, other):
        return BinOp("sub", self, _wrap(other))

    def __mul__(self, other):
        return BinOp("mul", self, _wrap(other))

    __radd__ = __add__
    __rmul__ = __mul__


@dataclasses.dataclass
class Var(Expr):
    name: str


@dataclasses.dataclass
class Const(Expr):
    value: int


@dataclasses.dataclass
class BinOp(Expr):
    op: str  # "sum" | "sub" | "mul"
    left: Expr
    right: Expr


def _wrap(x) -> Expr:
    return Const(x) if isinstance(x, int) else x


class VarMap:
    """First-use-order string interning (src/constraints.h:185-216)."""

    def __init__(self):
        self.names: List[str] = []
        self._idx = {}

    def get_or_add(self, name: str) -> int:
        if name in self._idx:
            return self._idx[name]
        i = len(self.names)
        self.names.append(name)
        self._idx[name] = i
        return i

    @property
    def count(self) -> int:
        return len(self.names)


UNUSED_INDEX = -1  # reference uses (size_t)-1 (src/constraints-test.c:5)


@dataclasses.dataclass
class GateList:
    """Gates + wire indices (src/constraints.h:227-271)."""
    gates: List[Gate] = dataclasses.field(default_factory=list)
    a_indices: List[int] = dataclasses.field(default_factory=list)
    b_indices: List[int] = dataclasses.field(default_factory=list)
    c_indices: List[int] = dataclasses.field(default_factory=list)

    def append(self, g: Gate, a: int, b: int, c: int):
        self.gates.append(g)
        self.a_indices.append(a)
        self.b_indices.append(b)
        self.c_indices.append(c)

    @property
    def num_gates(self) -> int:
        return len(self.gates)


def eval_expr(p: int, expr: Expr, vars: VarMap, gates: GateList) -> int:
    """AST -> gates + wire indices, replicating src/constraints.h:273-309:
    post-order, left before right, fresh wire v<count> per binary node."""
    if isinstance(expr, Var):
        return vars.get_or_add(expr.name)
    if isinstance(expr, Const):
        # constants become unconstrained pseudo-variables (reference quirk,
        # src/constraints.h:277-282)
        return vars.get_or_add(f"const_{expr.value % p}")
    if isinstance(expr, BinOp):
        l = eval_expr(p, expr.left, vars, gates)
        r = eval_expr(p, expr.right, vars, gates)
        n = vars.count
        vars.get_or_add(f"v{n}")
        if expr.op == "sum":
            g = gate_sum_a_b(p)
        elif expr.op == "sub":
            g = gate_sub_a_b(p)
        else:
            g = gate_mul_a_b(p)
        gates.append(g, l, r, n)
        return n
    raise TypeError(f"unknown expression node {expr!r}")


def compile_expression(p: int, expr: Expr, bind_zero: bool = True):
    """Convenience wrapper mirroring the constraints-test flow
    (src/constraints-test.c:55-59): compile, then bind the root to zero."""
    vars, gates = VarMap(), GateList()
    root = eval_expr(p, expr, vars, gates)
    if bind_zero:
        gates.append(gate_bind_to_zero(p), UNUSED_INDEX, UNUSED_INDEX, root)
    return vars, gates, root


# ---------------- copy-permutation construction (extension) ----------------

def build_copy_permutation(gl: GateList) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Derive PLONK copy constraints from a gate list's wire indices.

    Each slot (column, row) holds some variable; all slots holding the same
    variable form one cycle: slot -> next slot with the same variable
    (wrapping). Unused slots (UNUSED_INDEX) map to themselves. Returns
    (c_a, c_b, c_c) as (n, 2) arrays of (COPYOF_* tag, 1-based row)."""
    n = gl.num_gates
    occurrences = {}
    for col, idxs in ((COPYOF_A, gl.a_indices), (COPYOF_B, gl.b_indices),
                      (COPYOF_C, gl.c_indices)):
        for row, v in enumerate(idxs):
            if v != UNUSED_INDEX:
                occurrences.setdefault(v, []).append((col, row))

    out = {COPYOF_A: [(COPYOF_A, r + 1) for r in range(n)],
           COPYOF_B: [(COPYOF_B, r + 1) for r in range(n)],
           COPYOF_C: [(COPYOF_C, r + 1) for r in range(n)]}
    for v, slots in occurrences.items():
        k = len(slots)
        for i, (col, row) in enumerate(slots):
            nxt_col, nxt_row = slots[(i + 1) % k]
            out[col][row] = (nxt_col, nxt_row + 1)
    return (np.array(out[COPYOF_A], dtype=np.int64),
            np.array(out[COPYOF_B], dtype=np.int64),
            np.array(out[COPYOF_C], dtype=np.int64))


def gate_list_to_constraints(p: int, gl: GateList) -> Constraints:
    c_a, c_b, c_c = build_copy_permutation(gl)
    return make_constraints(p, gl.gates, c_a, c_b, c_c)


def compute_witness(p: int, gl: GateList, vars: VarMap,
                    inputs: dict) -> Assignments:
    """Evaluate the circuit forward to fill wire columns. `inputs` maps
    variable names (and const_<v> pseudo-vars implicitly) to values."""
    values = {}
    for i, name in enumerate(vars.names):
        if name.startswith("const_"):
            values[i] = int(name[len("const_"):]) % p
        elif name in inputs:
            values[i] = inputs[name] % p
    a_col, b_col, c_col = [], [], []
    for g, ai, bi, ci in zip(gl.gates, gl.a_indices, gl.b_indices,
                             gl.c_indices):
        av = values.get(ai, 0) if ai != UNUSED_INDEX else 0
        bv = values.get(bi, 0) if bi != UNUSED_INDEX else 0
        if g.q_m % p == 1 and g.q_o % p == p - 1:      # mul gate
            cv = (av * bv) % p
        elif g.q_l % p == 1 and g.q_r % p == 1:        # sum gate
            cv = (av + bv) % p
        elif g.q_l % p == 1 and g.q_r % p == p - 1:    # sub gate
            cv = (av - bv) % p
        else:                                           # bind / no-op gates
            cv = values.get(ci, 0) if ci != UNUSED_INDEX else 0
        if ci != UNUSED_INDEX:
            values[ci] = cv
        a_col.append(av)
        b_col.append(bv)
        c_col.append(cv)
    return Assignments(np.array(a_col, dtype=np.int64),
                       np.array(b_col, dtype=np.int64),
                       np.array(c_col, dtype=np.int64))


def constraints_to_tensors(cons: Constraints):
    """Constraints -> (selectors (5, n), copies (3, n, 2)) int64 arrays,
    the prover-core input format."""
    selectors = np.stack([cons.q_l, cons.q_r, cons.q_o, cons.q_m,
                          cons.q_c]).astype(np.int64)
    copies = np.stack([cons.c_a, cons.c_b, cons.c_c]).astype(np.int64)
    return selectors, copies


def pad_gate_list(p: int, gl: GateList, n: int) -> GateList:
    """Pad a compiled circuit to n gates (the PLONK domain must be a power
    of two; the reference never needs this because its tests hand-build
    exactly |H| gates). Padding gates are all-zero selector rows whose
    wires are fresh unused variables (self-referencing copy cycles)."""
    if gl.num_gates > n:
        raise ValueError(f"circuit has {gl.num_gates} gates > n = {n}")
    out = GateList(list(gl.gates), list(gl.a_indices), list(gl.b_indices),
                   list(gl.c_indices))
    noop = Gate(0, 0, 0, 0, 0)
    while out.num_gates < n:
        out.append(noop, UNUSED_INDEX, UNUSED_INDEX, UNUSED_INDEX)
    return out


def frontend_circuit(p: int, expr: Expr, inputs: dict, n: int):
    """Full frontend pipeline: expression -> gates -> padded constraint
    arrays + witness columns (numpy int64), ready for prove_core /
    prove_scaled. Returns (selectors, copies, a, b, c)."""
    vars, gl, root = compile_expression(p, expr)
    gl = pad_gate_list(p, gl, n)
    cons = gate_list_to_constraints(p, gl)
    witness = compute_witness(p, gl, vars, inputs)
    selectors, copies = constraints_to_tensors(cons)
    return selectors, copies, witness.a, witness.b, witness.c
