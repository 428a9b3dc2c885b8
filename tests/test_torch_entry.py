"""The port's entry points (plonk_tpu_torch.entry) on the CPU:

- entry(device="cpu") gives the JAX package's `__graft_entry__.entry()`
  under jax.jit, proof and diagnostics field by field through
  utils/convert.py (r_z = 15);
- each of the dry run's five legs passes on an 8-shard CPU mesh, each its
  own case (the BN254 leg on the window table's route, both disk caches
  under a directory of the module's own: tests/torch_bn254_env.py), and
  the single-device result it is held against equals the JAX package's
  on JAX's own inputs: every lane of the dp leg's batch JAX's entry()
  proof, the local intt and the naive MSM computed by JAX, and the
  scaled and BN254 legs' single-device proofs JAX's, recorded once in
  tests/golden/entry_dryrun_jax.json;
- each leg hands its functions the inputs that JAX's dryrun_multichip
  hands its own, word for word: the legs of `__graft_entry__.py` are run
  from their source with the prover, MSM, INTT and setup calls replaced by
  recorders (JAX's /proc write, XLA_FLAGS, compile cache and wall budget
  are not run), and so are the port's;
- `python -m plonk_tpu_torch.entry --device cpu --shards 8` exits 0 and
  prints entry's and each leg's lines;
- without a card, entry() and the dry run refuse the default device.

JAX's own dryrun_multichip is not run: it writes under /proc and compiles
for tens of minutes on XLA:CPU. Its single-device scaled (n = 256) and
BN254 (n = 8) proofs take minutes of XLA:CPU, so they were recorded once;

    PLONK_TPU_HEAVY_TESTS=1 JAX_PLATFORMS=cpu python -m pytest -s \\
        tests/test_torch_entry.py -k recompute

recomputes and compares them.
"""
import ast
import builtins
import contextlib
import importlib
import inspect
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as JE
from plonk_tpu.ops import field as JFM
from plonk_tpu_torch import entry as E
from plonk_tpu_torch.ops import field as FM
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.utils import convert
from torch_bn254_env import bn254_module_env  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PATH = os.path.join(ROOT, "golden", "entry_dryrun_jax.json")
ROOT = os.path.dirname(ROOT)
LEGS = ["dp-batched-prover", "dist-intt", "dist-msm",
        "sharded-scaled-prover", "sharded-bn254-prover"]
N_SHARDS = 8
FIELDS = (JFM.Field, JFM.MontField, FM.Field, FM.MontField)


def test_entry_matches_jax():
    fn, args = E.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    proof, diags = fn(*args)
    jfn, jargs = JE.entry()
    jproof, jdiags = jax.jit(jfn)(*jargs)
    assert int(proof.r_z) == int(jproof.r_z) == 15
    got = convert.proof_to_numpy(proof)
    for name in POINT_FIELDS:
        for u, v in zip(getattr(got, name), getattr(jproof, name)):
            np.testing.assert_array_equal(u, np.asarray(v), err_msg=name)
    for name in SCALAR_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(jproof, name)),
                                      err_msg=name)
    for name, u in convert.diagnostics_to_numpy(diags)._asdict().items():
        np.testing.assert_array_equal(u, np.asarray(getattr(jdiags, name)),
                                      err_msg=name)
    # and back: JAX's proof through the converter is the port's proof
    back = convert.proof_from_numpy(jproof, "cpu")
    E.assert_proofs_equal(back, proof, "entry")


@pytest.mark.parametrize("n,factors", [(8, (4, 2, 8)), (6, (2, 3, 4)),
                                       (1, (1, 1, 1)), (12, (4, 3, 8))])
def test_mesh_factors_match_jax(n, factors):
    """JAX's arithmetic (__graft_entry__.py:163-169)."""
    assert E.mesh_factors(n) == factors


# ---- the legs' inputs, as JAX's dry run and the port's hand them over ----

class _Stop(Exception):
    """Raised by the recorder of a leg's last call of interest."""


def _recorder(calls: dict, name: str, stop: bool = False, result=None):
    def record(*args, **kw):
        calls[name] = (args, kw)
        if stop:
            raise _Stop(name)
        return object() if result is None else result
    return record


def _jax_dryrun_namespace(n: int) -> dict:
    """The names that JAX's dryrun_multichip(n) gives its legs, made by its
    own source: its imports, its devices, mesh factors and meshes, and its
    assert_proofs_equal and leg_* functions. Nothing else of its body runs
    (not its /proc write, XLA_FLAGS, compile cache or wall budget)."""
    fn = ast.parse(textwrap.dedent(inspect.getsource(JE.dryrun_multichip)))
    names = {"devs", "sp", "dp", "mesh", "p2", "flat_mesh"}
    body = [node for node in fn.body[0].body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.While))
            or (isinstance(node, ast.Assign) and all(
                isinstance(t, ast.Name) and t.id in names
                for t in node.targets))
            or (isinstance(node, ast.FunctionDef)
                and (node.name.startswith("leg_")
                     or node.name == "assert_proofs_equal"))]
    ns = {"__builtins__": builtins, "__name__": "jax_dryrun", "np": np,
          "_canonical_setup": JE._canonical_setup, "n_devices": n,
          "bn254_marker": None}
    exec(compile(ast.Module(body=body, type_ignores=[]), JE.__file__,
                 "exec"), ns)
    assert len(ns["devs"]) == n, "conftest must provide 8 cpu devices"
    return ns


# (module, attribute, recorded name, whether the leg stops there) of each
# leg's calls, in the JAX package and in the port
_JAX_CALLS = {
    "dist-intt": [("plonk_tpu.parallel.dist_ntt", "dist_interpolate",
                   "run", True)],
    "dist-msm": [("plonk_tpu.parallel.dist_msm", "dist_msm", "run", True)],
    "sharded-scaled-prover": [
        ("plonk_tpu.models.plonk_scaled", "scaled_new", "setup", False),
        ("plonk_tpu.parallel.dist_prover", "make_dist_prims", "prims",
         False),
        ("plonk_tpu.models.plonk_scaled", "prove_scaled", "run", True)],
    "sharded-bn254-prover": [
        ("plonk_tpu.models.plonk_bn254", "bn254_setup", "setup", False),
        ("plonk_tpu.parallel.dist_bn254", "make_dist_bn254_prims", "prims",
         False),
        ("plonk_tpu.models.plonk_bn254", "prove_bn254", "run", True)],
}
_PORT_CALLS = {
    "dp-batched-prover": [],
    "dist-intt": [("plonk_tpu_torch.entry", "dist_interpolate", "run",
                   True)],
    "dist-msm": [("plonk_tpu_torch.entry", "dist_msm", "run", True)],
    "sharded-scaled-prover": [
        ("plonk_tpu_torch.models.plonk_scaled", "scaled_new", "setup",
         False),
        ("plonk_tpu_torch.entry", "make_dist_prims", "prims", False),
        ("plonk_tpu_torch.models.plonk_scaled", "prove_scaled", "run",
         True)],
    "sharded-bn254-prover": [
        ("plonk_tpu_torch.models.plonk_bn254", "bn254_setup", "setup",
         False),
        ("plonk_tpu_torch.entry", "make_dist_bn254_prims", "prims", False),
        ("plonk_tpu_torch.models.plonk_bn254", "prove_bn254", "run", True)],
}


def _sharded_prover_recorder(calls: dict):
    """make_sharded_prover's stand-in: records its arguments and returns a
    prover that records the batch and stops the leg."""
    def make(*args, **kw):
        calls["prims"] = (args, kw)
        return _recorder(calls, "run", stop=True)
    return make


def _capture(name: str, calls_of: dict, run, extra=None) -> dict:
    """{recorded name: (args, kwargs)} of one run of a leg with its calls
    replaced by recorders."""
    calls = {}
    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        for module, attr, key, stop in calls_of.get(name, []):
            mp.setattr(importlib.import_module(module), attr,
                       _recorder(calls, key, stop))
        if extra is not None:
            extra(mp, calls)
        with pytest.raises(_Stop):
            run()
    return calls


def jax_leg_calls(name: str, ns: dict) -> dict:
    leg = {"dp-batched-prover": "leg_dp_prover", "dist-intt":
           "leg_dist_intt", "dist-msm": "leg_dist_msm",
           "sharded-scaled-prover": "leg_scaled_prover",
           "sharded-bn254-prover": "leg_bn254_prover"}[name]

    def dp(mp, calls):
        mp.setitem(ns, "make_sharded_prover",
                   _sharded_prover_recorder(calls))
    return _capture(name, _JAX_CALLS, ns[leg],
                    dp if name == "dp-batched-prover" else None)


def port_leg_calls(name: str) -> dict:
    def dp(mp, calls):
        mp.setattr(E, "make_sharded_prover", _sharded_prover_recorder(calls))
    return _capture(name, _PORT_CALLS,
                    dict(E.dryrun_legs(N_SHARDS, device="cpu"))[name],
                    dp if name == "dp-batched-prover" else None)


def _plain(x):
    """A recorded argument as numpy arrays and Python values: tensors and
    JAX arrays as arrays, a list of shards joined, named tuples field by
    field, a mesh as (its axis, its shard count), a field as its modulus."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, (jax.Array, np.ndarray)):
        return np.asarray(x)
    if isinstance(x, list) and x and isinstance(x[0], torch.Tensor):
        return torch.cat([s.cpu() for s in x], -1).numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return tuple(_plain(v) for v in x)
    if hasattr(x, "axis_names") and hasattr(x, "devices"):      # JAX Mesh
        return ("mesh", dict(zip(x.axis_names, x.devices.shape)))
    if hasattr(x, "axis") and hasattr(x, "devices"):            # port Mesh
        return ("mesh", {x.axis: len(x.devices)})
    if isinstance(x, FIELDS):
        return ("field", type(x).__name__, int(x.p))
    return x


def _equal(u, v) -> bool:
    u, v = _plain(u), _plain(v)
    if isinstance(u, np.ndarray) or isinstance(v, np.ndarray):
        return np.array_equal(np.asarray(u).astype(np.int64),
                              np.asarray(v).astype(np.int64))
    if isinstance(u, tuple) and isinstance(v, tuple):
        return len(u) == len(v) and all(map(_equal, u, v))
    return u == v


def _dp_inputs(calls):
    (ctx, sel, cps, mesh, axis), _ = calls["prims"]
    # JAX's batch axis runs over the "dp" axis of its 2-D (dp, sp) mesh;
    # the port's over a 1-D "dp" mesh of as many shards
    return dict(selectors=sel, copies=cps, axis=axis,
                dp_shards=_plain(mesh)[1]["dp"], batch=calls["run"][0])


def _intt_inputs(calls):
    (M, mesh, v, w), kw = calls["run"]
    return dict(field=M, mesh=mesh, values=v, root=int(w), kw=kw)


def _msm_inputs(calls):
    (Fq, mesh, pts, sc), kw = calls["run"]
    return dict(field=Fq, mesh=mesh, points=pts, scalars=sc, kw=kw)


def _prover_inputs(calls, jax_only=()):
    (n,), kw = calls["setup"]
    (_, mesh), _ = calls["prims"]
    (_, *args), run_kw = calls["run"]
    return dict(n=n, setup={k: v for k, v in kw.items()
                            if k not in jax_only + ("device",)},
                mesh=mesh, args=tuple(args), prims=sorted(run_kw))


INPUTS = {"dp-batched-prover": _dp_inputs, "dist-intt": _intt_inputs,
          "dist-msm": _msm_inputs,
          "sharded-scaled-prover": _prover_inputs,
          # `rolled` picks the JAX package's table layout, which the port
          # does not have
          "sharded-bn254-prover": lambda c: _prover_inputs(c, ("rolled",))}


@pytest.fixture(scope="module")
def jax_ns():
    return _jax_dryrun_namespace(N_SHARDS)


@pytest.mark.parametrize("name", LEGS)
def test_dryrun_leg_inputs_match_jax(name, jax_ns):
    """Each leg of the port hands its setup, prims and prover (or its
    INTT, MSM) what JAX's dry run hands them at 8 devices, word for word:
    the BN254 leg's hand-built circuit, challenges and blinding, the
    scaled leg's circuit, challenges and blinding, the meshes' shards."""
    want = INPUTS[name](jax_leg_calls(name, jax_ns))
    got = INPUTS[name](port_leg_calls(name))
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "args":
            assert len(got[key]) == len(want[key])
            for i, (u, v) in enumerate(zip(got[key], want[key])):
                assert _equal(u, v), f"{name}: argument {i}"
        else:
            assert _equal(got[key], want[key]), f"{name}: {key}"


# ---- the legs on the CPU, and their single-device results against JAX ----

def _leaves(tree, path=""):
    """{path: value} of every leaf of nested named tuples (tensors or
    arrays), the values as nested lists of Python ints and bools."""
    if hasattr(tree, "_fields"):
        out = {}
        for name, sub in zip(tree._fields, tree):
            out.update(_leaves(sub, f"{path}.{name}"))
        return out
    return {path: _plain(tree).tolist()}


def _jax_entry_proof():
    jfn, jargs = JE.entry()
    return jax.jit(jfn)(*jargs)[0]


def _jax_local_intt(ns):
    from plonk_tpu.ops import ntt as N
    (M, _, v, w), _ = jax_leg_calls("dist-intt", ns)["run"]
    return jax.jit(lambda x: N.intt(M, x, w))(np.asarray(v))


def _jax_naive_msm(ns):
    from plonk_tpu.models.srs import srs_commit_naive
    (Fq, _, pts, sc), _ = jax_leg_calls("dist-msm", ns)["run"]
    return jax.jit(lambda p, s: srs_commit_naive(Fq, p, s))(pts, sc)


def _affine(p) -> tuple:
    p = _plain(p)
    return (bool(p[2]),) if bool(p[2]) else (int(p[0]), int(p[1]), False)


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("name", LEGS)
def test_dryrun_leg(name, jax_ns, golden):
    legs = E.dryrun_legs(N_SHARDS, device="cpu")
    assert [n for n, _ in legs] == LEGS
    got = dict(legs)[name]()
    if name == "dp-batched-prover":
        want = _leaves(_jax_entry_proof())
        lanes = _leaves(got)
        assert sorted(lanes) == sorted(want)
        assert len(got.r_z) == 2 * E.mesh_factors(N_SHARDS)[1]
        for path, v in want.items():
            assert all(lane == v for lane in lanes[path]), path
    elif name == "dist-intt":
        assert _equal(got, _jax_local_intt(jax_ns))
    elif name == "dist-msm":
        assert _affine(got) == _affine(_jax_naive_msm(jax_ns))
    else:
        assert _leaves(got) == golden[name]


def _jax_single_device_proof(name: str, ns: dict):
    """JAX's single-device proof of the leg, as JAX's leg computes it
    (under jax.jit) on the inputs that JAX's leg makes."""
    from plonk_tpu.models import plonk_bn254 as JPB
    from plonk_tpu.models import plonk_scaled as JPS
    calls = jax_leg_calls(name, ns)
    setup, prove = ((JPS.scaled_new, JPS.prove_scaled)
                    if name == "sharded-scaled-prover"
                    else (JPB.bn254_setup, JPB.prove_bn254))
    args, kw = calls["setup"]
    ctx = setup(*args, **kw)
    (_, *circuit, ch, rnd), _ = calls["run"]
    return jax.jit(lambda c, r: prove(ctx, *circuit, c, r))(ch, rnd)[0]


@pytest.mark.skipif(not os.environ.get("PLONK_TPU_HEAVY_TESTS"),
                    reason="JAX's single-device scaled and BN254 provers "
                           "on the dry run's inputs (minutes of XLA:CPU); "
                           "set PLONK_TPU_HEAVY_TESTS=1")
def test_recompute_jax_values(jax_ns):
    got = {name: _leaves(_jax_single_device_proof(name, jax_ns))
           for name in ("sharded-scaled-prover", "sharded-bn254-prover")}
    print(json.dumps(got))
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    for name, leaves in got.items():
        assert leaves == golden[name], name


def test_dryrun_leg_refuses_a_wrong_proof(monkeypatch):
    """A leg raises when its check fails: the dp leg with a wrong r_z."""
    real = E.make_sharded_prover

    def wrong(*a, **kw):
        run = real(*a, **kw)

        def bad(*args):
            proofs, diags = run(*args)
            return proofs._replace(r_z=proofs.r_z + 1), diags
        return bad

    monkeypatch.setattr(E, "make_sharded_prover", wrong)
    with pytest.raises(RuntimeError, match="dryrun: wrong proofs"):
        dict(E.dryrun_legs(N_SHARDS, device="cpu"))["dp-batched-prover"]()


def test_main_runs_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "plonk_tpu_torch.entry", "--device", "cpu",
         "--shards", "8"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "entry ok; r_z = 15"
    assert lines[-1] == "dryrun_multichip(8) ok"
    assert "done: 5 legs ok" in lines[-2]
    for name in LEGS:
        assert any(f"leg ok: {name} (" in line for line in lines), name


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.dryrun_multichip(8)
