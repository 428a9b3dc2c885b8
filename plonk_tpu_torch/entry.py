"""Entry points of the port: the counterpart of the JAX package's
`__graft_entry__.py`.

entry(device):        the full 5-round toy PLONK prover on the canonical
                      circuit, as (fn, example_args);
dryrun_multichip(n):  one run of each sharded path over an n-shard mesh of
                      one device, in five legs, each checked against the
                      single-device result:
                      - the toy batch split over a "dp" mesh;
                      - the distributed four-step INTT (BabyBear);
                      - the sharded MSM (toy curve);
                      - the sharded scaled prover;
                      - the sharded BN254 prover.

The mesh is that of `parallel/mesh.py`: the shards share one device (the
CUDA card unless device="cpu"), so the JAX package's 2-D (dp, sp) mesh
becomes a 1-D "dp" mesh for the first leg and a 1-D "sp" mesh for the
others, with its factors computed as the JAX package does. A leg runs or
raises: the JAX package's wall budget, compile cache and host settings
are XLA workarounds and are not ported.

    python -m plonk_tpu_torch.entry [--device cpu] [--shards N]

runs entry(), prints `entry ok; r_z = 15`, then the dry run over N shards
(default 8).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .models import plonk_bn254 as PB
from .models import plonk_scaled as PS
from .models.plonk import _words, prove_core
from .models.presets import (CANONICAL_CHALLENGE, CANONICAL_RAND,
                             canonical_assignments, canonical_constraints,
                             canonical_context)
from .models.srs import srs_commit_naive
from .models.synthetic import square_chain_circuit, words_vec
from .ops import curve as C
from .ops.field import Field, MontField
from .ops.ntt import intt
from .parallel.batch import make_sharded_prover
from .parallel.dist_bn254 import make_dist_bn254_prims
from .parallel.dist_msm import dist_msm
from .parallel.dist_ntt import dist_interpolate
from .parallel.dist_prover import make_dist_prims
from .parallel.mesh import make_1d_mesh, shard_vector, unshard_vector
from .utils.kernels import resolve_device
from .utils.params import BABYBEAR, BN254_FR, GF101, SCALED_FR, TOY_CURVE


def _canonical_setup(device):
    """(ctx, selectors (5, n), copies (3, n, 2), a, b, c) of the canonical
    circuit on the fixed SRS, on `device`."""
    ctx = canonical_context(srs_mode="fixed", device=device)
    dev = ctx.device
    cons = canonical_constraints()
    sel = cons.selectors_device(dev)
    selectors = torch.stack([sel[k] for k in ("q_l", "q_r", "q_o", "q_m",
                                              "q_c")])
    copies = _words(np.stack([cons.c_a, cons.c_b, cons.c_c]), dev)
    a, b, c = canonical_assignments().device(dev)
    return ctx, selectors, copies, a, b, c


def entry(device=None):
    """Returns (fn, example_args): fn(a, b, c, challenge, rand9) ->
    (Proof, Diagnostics) is the toy prover on the canonical circuit, and
    example_args its canonical inputs (r_z = 15), on `device` (default:
    the CUDA card)."""
    ctx, selectors, copies, a, b, c = _canonical_setup(device)

    def fn(a_w, b_w, c_w, challenge, rand9):
        return prove_core(ctx, selectors, copies, a_w, b_w, c_w, challenge,
                          rand9)

    example_args = (a, b, c, _words(CANONICAL_CHALLENGE, ctx.device),
                    _words(CANONICAL_RAND, ctx.device))
    return fn, example_args


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _leaves(tree, path=""):
    """(path, tensor) of every leaf of nested named tuples."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    names = getattr(tree, "_fields", range(len(tree)))
    return [leaf for name, sub in zip(names, tree)
            for leaf in _leaves(sub, f"{path}.{name}")]


def _mismatch(got, want) -> str | None:
    """None when two proofs of any curve, on any devices, have the same
    structure and every leaf (each commitment's x, y and infinity flag,
    each evaluation) equal, word for word; else what differs first."""
    g, w = _leaves(got), _leaves(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        return "proof tree structure differs"
    for (path, u), (_, v) in zip(g, w):
        if not torch.equal(u.cpu(), v.cpu()):
            return f"proof leaf {path} differs"
    return None


def proofs_equal(got, want) -> bool:
    return _mismatch(got, want) is None


def assert_proofs_equal(got, want, label: str) -> None:
    what = _mismatch(got, want)
    _check(what is None, f"{label} {what}")


def mesh_factors(n_shards: int) -> tuple[int, int, int]:
    """(sp, dp, p2) as the JAX package factors its mesh: sp the largest
    power of two <= 4 dividing n_shards, dp = n_shards // sp, p2 the
    largest power of two <= n_shards."""
    sp = 1
    while sp < 4 and n_shards % (sp * 2) == 0:
        sp *= 2
    return sp, n_shards // sp, 1 << (n_shards.bit_length() - 1)


def leg_dp_prover(dev, dp: int) -> None:
    """The batched toy prover with its B = 2 dp proofs split over a "dp"
    mesh of dp shards: every witness satisfied, every r_z 15."""
    ctx, selectors, copies, a, b, c = _canonical_setup(dev)
    B = 2 * dp
    tile = lambda x: _words(x, dev).repeat(B, 1)
    run = make_sharded_prover(ctx, selectors, copies,
                              make_1d_mesh("dp", dp, device=dev), "dp")
    proofs, diags = run(tile(a), tile(b), tile(c), tile(CANONICAL_CHALLENGE),
                        tile(CANONICAL_RAND))
    _check(bool(diags.satisfied.all()), "witness check failed")
    _check(proofs.r_z.tolist() == [15] * B, "wrong proofs")
    return proofs


def leg_dist_intt(dev, p2: int) -> None:
    """The distributed four-step INTT over BabyBear at n = max(16, 4 p2^2)
    on p2 shards equal to the local intt."""
    M = MontField(BABYBEAR)
    n = max(16, 4 * p2 * p2)
    w = BABYBEAR.root_of_unity(n)
    v = M.array(np.arange(n) % BABYBEAR.p, dev)
    mesh = make_1d_mesh("sp", p2, device=dev)
    coeffs = unshard_vector(dist_interpolate(M, mesh, shard_vector(mesh, v),
                                             w))
    local = intt(M, v, w)
    _check(torch.equal(coeffs, local), "dist INTT")
    return local


def leg_dist_msm(dev, n_shards: int, p2: int) -> None:
    """dist_msm of 8 n_shards toy points (seed 0, 5-bit windows and
    scalars) on p2 shards equal to the naive fold."""
    Fq = Field(GF101)
    g = C.g1_generator(TOY_CURVE, Fq, dev)
    npts = 8 * n_shards
    rng = np.random.default_rng(0)
    pts = C.g1_mul(Fq, g, _words(rng.integers(1, 17, size=npts,
                                              dtype=np.uint32), dev), nbits=5)
    scalars = _words(rng.integers(0, 17, size=npts, dtype=np.uint32), dev)
    total = dist_msm(Fq, make_1d_mesh("sp", p2, device=dev), pts, scalars,
                     window_bits=5, scalar_bits=5)
    ref = srs_commit_naive(Fq, pts, scalars)
    _check(bool(C.g1_equal(total, ref)), "dist MSM mismatch")
    return ref


def leg_scaled_prover(dev, p2: int) -> None:
    """The scaled prover at n = max(64, 4 p2^2) under the sharded prims on
    p2 shards: diagnostics ok, the proof equal to the single-device one."""
    n = max(64, 4 * p2 * p2)
    ctx = PS.scaled_new(n, secret=424242, device=dev)
    args = square_chain_circuit(SCALED_FR.p, n, x0=3)
    ch = np.array([101, 202, 303, 404, 505], np.uint32)
    rnd = np.arange(1, 10, dtype=np.uint32)
    prims = make_dist_prims(ctx, make_1d_mesh("sp", p2, device=dev))
    proof_d, diags_d = PS.prove_scaled(ctx, *args, ch, rnd, prims=prims)
    _check(bool(diags_d.all_ok()), "sharded scaled prover diags")
    proof_l, _ = PS.prove_scaled(ctx, *args, ch, rnd)
    assert_proofs_equal(proof_d, proof_l, "sharded scaled")
    return proof_l


def bn254_dryrun_circuit(n: int = 8):
    """The JAX dry run's hand-built BN254 circuit of n multiplication gates
    a * b = c, witnesses from default_rng(11): (selectors (5, n, 16),
    copies (3, n, 2), a, b, c (n, 16)) in standard-form words."""
    r = BN254_FR.p
    rng = np.random.default_rng(11)
    av = [int.from_bytes(rng.bytes(31), "little") % r for _ in range(n)]
    bv = [int.from_bytes(rng.bytes(31), "little") % r for _ in range(n)]
    cv = [(x * y) % r for x, y in zip(av, bv)]
    sel = np.zeros((5, n, 16), dtype=np.uint32)
    sel[3] = words_vec([1] * n)                   # q_m = 1
    sel[2] = words_vec([r - 1] * n)               # q_o = -1
    cps = np.stack([np.stack([np.full(n, t), np.arange(1, n + 1)], axis=-1)
                    for t in range(3)]).astype(np.int32)
    return sel, cps, words_vec(av), words_vec(bv), words_vec(cv)


def leg_bn254_prover(dev, n_shards: int) -> None:
    """The BN254 prover at n = 8 (secret 987654321) under the sharded BN254
    prims on min(2, n_shards) shards: diagnostics ok, the proof equal to
    the single-device one."""
    ctx = PB.bn254_setup(8, secret=987654321, device=dev)
    args = bn254_dryrun_circuit(8)
    ch = words_vec([111111, 222222, 333333, 444444, 555555])
    rnd = words_vec(range(17, 26))
    prims = make_dist_bn254_prims(
        ctx, make_1d_mesh("sp", min(2, n_shards), device=dev))
    proof_d, diags_d = PB.prove_bn254(ctx, *args, ch, rnd, prims=prims)
    _check(bool(diags_d.all_ok()), "sharded BN254 prover diags")
    proof_l, _ = PB.prove_bn254(ctx, *args, ch, rnd)
    assert_proofs_equal(proof_d, proof_l, "sharded BN254")
    return proof_l


def dryrun_legs(n_shards: int, device=None) -> list:
    """[(name, fn)] of the dry run's five legs over n_shards shards of
    `device` (default: the CUDA card), in the JAX package's order. Each
    fn() raises if its check fails, and returns the single-device result
    it was held against (the dp leg: its batch of proofs)."""
    dev = resolve_device(device)
    _, dp, p2 = mesh_factors(n_shards)
    return [("dp-batched-prover", lambda: leg_dp_prover(dev, dp)),
            ("dist-intt", lambda: leg_dist_intt(dev, p2)),
            ("dist-msm", lambda: leg_dist_msm(dev, n_shards, p2)),
            ("sharded-scaled-prover", lambda: leg_scaled_prover(dev, p2)),
            ("sharded-bn254-prover", lambda: leg_bn254_prover(dev,
                                                              n_shards))]


def dryrun_multichip(n_shards: int, device=None) -> list:
    """Run the five legs in turn, each with a timestamped start and ok
    line; a leg that fails raises. Returns [(name, seconds)]."""
    if n_shards < 1:
        raise ValueError("a mesh needs at least one shard")
    dev = resolve_device(device)
    legs = dryrun_legs(n_shards, dev)
    t0 = time.perf_counter()
    stamp = lambda: f"[dryrun {time.perf_counter() - t0:7.1f}s]"
    print(f"{stamp()} start: n_shards={n_shards} device={dev}", flush=True)
    results = []
    for name, fn in legs:
        print(f"{stamp()} leg start: {name}", flush=True)
        t = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        results.append((name, time.perf_counter() - t))
        print(f"{stamp()} leg ok: {name} ({results[-1][1]:.3f} s)",
              flush=True)
    print(f"{stamp()} done: {len(results)} legs ok", flush=True)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The canonical toy proof, then the sharded dry run.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--shards", type=int, default=8,
                    help="shards of the dry run's mesh (default 8)")
    args = ap.parse_args(argv)
    fn, example_args = entry(args.device)
    proof, _ = fn(*example_args)
    print("entry ok; r_z =", int(proof.r_z), flush=True)
    dryrun_multichip(args.shards, args.device)
    print(f"dryrun_multichip({args.shards}) ok", flush=True)


if __name__ == "__main__":
    main()
