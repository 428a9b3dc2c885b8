"""Parity of the port's constraint system and expression frontend
(models/constraints.py) with the JAX package: the interned variable names
and their order (`const_<v>` included), the gate lists, the copy
permutations, the witnesses and the frontend's arrays are equal, and the
witness check accepts and rejects the same assignments."""
import dataclasses

import numpy as np
import pytest
import torch

from plonk_tpu.models import constraints as JCS
from plonk_tpu.ops.field import Field as JField
from plonk_tpu.utils import params as JPR
from plonk_tpu_torch.models import constraints as CS
from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.ops.field import Field
from plonk_tpu_torch.utils.params import HF17, SCALED_FR

P17 = 17


def _exprs(M):
    """The same expressions built from module M's AST classes."""
    a, b, c, x = M.Var("a"), M.Var("b"), M.Var("c"), M.Var("x")
    return {
        "pythagoras": (a * a + b * b) - (c * c),
        "constants": x * M.Const(21) + M.Const(4) * x,
        "const_only": M.Const(4) + M.Const(4),
        "sugar": 3 * a + 2 - b * 5,
        "negative": a * M.Const(-1) - (b - c) * (a + a),
        "deep": ((a + b) * (a - b) + c) * (x * x - M.Const(38)),
    }


def _gates(gl):
    return [dataclasses.astuple(g) for g in gl.gates]


def _same_gate_list(gl, jgl):
    assert _gates(gl) == _gates(jgl)
    assert (gl.a_indices, gl.b_indices, gl.c_indices) == (
        jgl.a_indices, jgl.b_indices, jgl.c_indices)


@pytest.mark.parametrize("name", list(_exprs(CS)))
@pytest.mark.parametrize("p", [P17, SCALED_FR.p])
def test_compile_expression_matches_jax(name, p):
    """Interning order, gates, wire indices and root, with and without the
    root bound to zero; the copy permutation of the gate list."""
    for bind_zero in (True, False):
        vars, gl, root = CS.compile_expression(p, _exprs(CS)[name],
                                               bind_zero=bind_zero)
        jvars, jgl, jroot = JCS.compile_expression(p, _exprs(JCS)[name],
                                                   bind_zero=bind_zero)
        assert vars.names == jvars.names
        assert vars.count == jvars.count and root == jroot
        _same_gate_list(gl, jgl)
        for got, want in zip(CS.build_copy_permutation(gl),
                             JCS.build_copy_permutation(jgl)):
            np.testing.assert_array_equal(got, want)


def test_interning_golden():
    """src/constraints-test.c's printed var map and gates."""
    a, b, c = CS.Var("a"), CS.Var("b"), CS.Var("c")
    vars, gl, root = CS.compile_expression(P17, (a * a + b * b) - (c * c))
    assert vars.names == ["a", "v1", "b", "v3", "v4", "c", "v6", "v7"]
    assert root == 7 and gl.num_gates == 6
    assert gl.a_indices == [0, 2, 1, 5, 4, CS.UNUSED_INDEX]
    assert gl.c_indices == [1, 3, 4, 6, 7, 7]
    vars, _, _ = CS.compile_expression(P17, CS.Var("x") * CS.Const(21),
                                       bind_zero=False)
    assert vars.names == ["x", "const_4", "v2"]


def test_eval_expr_shares_interning_across_calls():
    """One VarMap and GateList through several eval_expr calls: names
    already interned are reused, as src/constraints.h:197-216 does."""
    def run(M):
        vars, gl = M.VarMap(), M.GateList()
        roots = [M.eval_expr(P17, e, vars, gl)
                 for e in (M.Var("a") * M.Var("b"),
                           M.Var("b") + M.Const(3),
                           M.Const(20) * M.Var("a"))]
        return vars.names, roots, gl
    names, roots, gl = run(CS)
    jnames, jroots, jgl = run(JCS)
    assert names == jnames and roots == jroots
    _same_gate_list(gl, jgl)
    assert "const_3" in names
    with pytest.raises(TypeError):
        CS.eval_expr(P17, "not an expression", CS.VarMap(), CS.GateList())


def test_gate_helpers_match_jax():
    for p in (P17, SCALED_FR.p):
        for fn in ("gate_sum_a_b", "gate_sub_a_b", "gate_mul_a_b",
                   "gate_bind_to_zero"):
            assert dataclasses.astuple(getattr(CS, fn)(p)) == \
                dataclasses.astuple(getattr(JCS, fn)(p))
        for v in (5, -3, p + 2):
            assert dataclasses.astuple(CS.gate_bind_a(p, v)) == \
                dataclasses.astuple(JCS.gate_bind_a(p, v))
    assert (CS.COPYOF_A, CS.COPYOF_B, CS.COPYOF_C, CS.UNUSED_INDEX) == (
        JCS.COPYOF_A, JCS.COPYOF_B, JCS.COPYOF_C, JCS.UNUSED_INDEX)


@pytest.mark.parametrize("name", ["pythagoras", "constants", "negative",
                                  "deep"])
def test_witness_and_constraints_match_jax(name):
    inputs = {"a": 3, "b": 4, "c": 5, "x": 7}
    vars, gl, _ = CS.compile_expression(P17, _exprs(CS)[name])
    jvars, jgl, _ = JCS.compile_expression(P17, _exprs(JCS)[name])
    w = CS.compute_witness(P17, gl, vars, inputs)
    jw = JCS.compute_witness(P17, jgl, jvars, inputs)
    for col in "abc":
        np.testing.assert_array_equal(getattr(w, col), getattr(jw, col))
    padded = CS.pad_gate_list(P17, gl, 16)
    jpadded = JCS.pad_gate_list(P17, jgl, 16)
    _same_gate_list(padded, jpadded)
    cons = CS.gate_list_to_constraints(P17, padded)
    jcons = JCS.gate_list_to_constraints(P17, jpadded)
    for f in ("q_l", "q_r", "q_o", "q_m", "q_c", "c_a", "c_b", "c_c"):
        np.testing.assert_array_equal(getattr(cons, f), getattr(jcons, f))
    assert cons.n == jcons.n == 16
    for got, want in zip(CS.constraints_to_tensors(cons),
                         JCS.constraints_to_tensors(jcons)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        CS.pad_gate_list(P17, gl, gl.num_gates - 1)


def test_satisfies_matches_jax():
    """c = a + b accepted and rejected (src/constraints-test.c:108-160),
    and a frontend witness against its own constraints."""
    F, JF = Field(HF17), JField(JPR.HF17)
    for M, Fm, kw in ((CS, F, {"device": "cpu"}), (JCS, JF, {})):
        cons = M.make_constraints(
            P17, [M.gate_sum_a_b(P17)], c_a=[(M.COPYOF_A, 1)],
            c_b=[(M.COPYOF_B, 1)], c_c=[(M.COPYOF_C, 1)])
        good = M.Assignments(np.array([2]), np.array([3]), np.array([5]))
        bad = M.Assignments(np.array([2]), np.array([3]), np.array([6]))
        assert bool(M.satisfies(Fm, cons, good, **kw))
        assert not bool(M.satisfies(Fm, cons, bad, **kw))
    vars, gl, _ = CS.compile_expression(P17, _exprs(CS)["pythagoras"])
    w = CS.compute_witness(P17, gl, vars, {"a": 3, "b": 4, "c": 5})
    cons = CS.gate_list_to_constraints(P17, gl)
    assert bool(CS.satisfies(F, cons, w, device="cpu"))
    sel = cons.selectors_device("cpu")
    assert sel["q_m"].dtype == torch.int64 and sel["q_m"].device.type == "cpu"


@pytest.mark.parametrize("p", [P17, SCALED_FR.p])
def test_frontend_circuit_matches_jax(p):
    expr, jexpr = _exprs(CS)["pythagoras"], _exprs(JCS)["pythagoras"]
    got = CS.frontend_circuit(p, expr, {"a": 3, "b": 4, "c": 5}, 8)
    want = JCS.frontend_circuit(p, jexpr, {"a": 3, "b": 4, "c": 5}, 8)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_frontend_drives_the_scaled_prover():
    """Frontend arrays -> the port's scaled prover (n = 8): a satisfying
    witness proves with every diagnostic ok; a wrong one is unsatisfied."""
    R = SCALED_FR.p
    expr = _exprs(CS)["pythagoras"]
    sel, cp, a, b, c = CS.frontend_circuit(R, expr, {"a": 3, "b": 4, "c": 5},
                                           8)
    ctx = PS.scaled_new(8, secret=111222333, device="cpu")
    prover = PS.make_prover(ctx, sel, cp)
    ch, rnd = [101, 202, 303, 404, 505], list(range(1, 10))
    _, diags = prover(a, b, c, ch, rnd)
    assert bool(diags.all_ok())
    _, _, a2, b2, c2 = CS.frontend_circuit(R, expr, {"a": 3, "b": 4, "c": 6},
                                           8)
    _, diags2 = prover(a2, b2, c2, ch, rnd)
    assert not bool(diags2.satisfied)
