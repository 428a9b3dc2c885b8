"""Drive the PyTorch/CUDA port (plonk_tpu_torch) once on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. the CUDA device, and its name and power limit from nvidia-smi;
  2. build of the CUDA kernels from plonk_tpu_torch/csrc/;
  3. K1 (row-stage NTT) against its plain PyTorch version, bit-equal, at
     the main path's shapes;
  4. the 2^16-gate setup, then K2 (fixed-base commit) against its plain
     version, affine-equal, at the main path's shape and on a batch with
     zero scalars and repeated, opposite and infinity bases;
  5. the n = 16 proof on the GPU against the CPU port and the JAX
     package's recorded values;
  6. the main path at 2^16 gates: make_prover, prove (kernel launches
     counted), diagnostics, verifying key, verify, tamper rejection;
  7. times: setup, table build, proofs/s, verify, each kernel against its
     plain version.

With --profile a phase 8 follows: the time of each prover stage, the
device kernels and device time of a proof under torch.profiler (and so
the device's idle share), and the verifier's split between its G1
algebra and its pairings:

    python3 chip_smoke.py --profile

Any failure raises and exits non-zero before the result line. The last
two lines are a JSON object of the kernels and the result JSON object.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

from plonk_tpu_torch.models import plonk_scaled as PS
from plonk_tpu_torch.models.plonk import POINT_FIELDS, SCALAR_FIELDS
from plonk_tpu_torch.models.synthetic import square_chain_circuit
from plonk_tpu_torch.ops import commit as CM
from plonk_tpu_torch.ops import curve as C
from plonk_tpu_torch.ops import ntt as N
from plonk_tpu_torch.ops import row_stages as RS
from plonk_tpu_torch.ops.field import MontField
from plonk_tpu_torch.utils import kernels

N_MAIN = 1 << 16
N_SMALL = 16
CH = [1111, 2222, 3333, 4444, 5555]
RND = list(range(1, 10))
PROOF_REPS = 5
# the JAX package's n = 16 proof for (CH, RND), decoded (standard form)
ANCHOR_SCALARS = dict(a_z=11535495, b_z=4125738, c_z=8864595,
                      s_sigma_1_z=31108, s_sigma_2_z=85023238,
                      r_z=91913729, z_omega_z=29775783)
ANCHOR_POINTS = dict(a_s=(1379689719, 1885742547),
                     w_z_omega_s=(1642674468, 1818070622))
KERNELS = {
    "row_stages": dict(route="cuda",
                       source="plonk_tpu_torch/csrc/row_stages.cu",
                       replaces="plonk_tpu/ops/pallas_ntt.py:81"),
    "commit_many": dict(route="cuda",
                        source="plonk_tpu_torch/csrc/commit.cu",
                        replaces="plonk_tpu/ops/pallas_msm.py:166"),
}


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches after two warm-ups."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, seconds) of fn() ending in a device synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def affine_err(a: C.G1, b: C.G1) -> int:
    """Largest word difference between two affine point batches
    (x, y and the infinity flag)."""
    return max(int((a.x - b.x).abs().max()), int((a.y - b.y).abs().max()),
               int((a.inf != b.inf).sum()))


def proofs_equal(p, q) -> bool:
    return (all(torch.equal(getattr(p, f)[k].cpu(), getattr(q, f)[k].cpu())
                for f in POINT_FIELDS for k in range(3))
            and all(int(getattr(p, f)) == int(getattr(q, f))
                    for f in SCALAR_FIELDS))


STAGES = ("_stage_prep", "_stage_grand_product", "_stage_quotient",
          "_stage_openings")
PROFILE_REPS = 3


def staged_proofs(ctx, sel, cp, a, b, c, reps: int):
    """`reps` proofs through prove_scaled with each stage and the batched
    commit timed on the host clock, each ending in a device synchronise.
    Returns the mean seconds per proof of each stage, of the rest of
    prove_scaled (challenge encoding, decoding, diagnostics) and of the
    whole proof; the parts add up to the whole."""
    times = collections.Counter()

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            times[name] += time.perf_counter() - t
            return out
        return run

    prims = PS.default_prims()
    pre = PS.precompute_circuit(ctx, sel, cp, prims)
    prims = prims._replace(commit_many=timed(
        "commit", PS.table_commit(ctx, PS.fixed_base_table(ctx))))
    saved = {name: getattr(PS, name) for name in STAGES}
    try:
        for name in STAGES:
            setattr(PS, name, timed(name.removeprefix("_stage_"),
                                    saved[name]))
        prove = timed("proof", PS.prove_scaled)
        for rep in range(reps):
            _, d = prove(ctx, sel, cp, a, b, c, CH,
                         [v + 100 + 9 * rep for v in RND], prims=prims,
                         pre=pre)
            check(bool(d.all_ok()), f"staged proof {rep} diagnostics")
    finally:
        for name, fn in saved.items():
            setattr(PS, name, fn)
    mean = {k: v / reps for k, v in times.items()}
    mean["rest"] = mean["proof"] - sum(v for k, v in mean.items()
                                       if k != "proof")
    return mean


def profiled_proofs(prover, a, b, c, reps: int):
    """`reps` proofs under torch.profiler. Returns (device events per
    proof, device microseconds per proof, host wall seconds per proof
    while profiled, the top device kernels by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for rep in range(reps):
            prover(a, b, c, CH, [v + 200 + 9 * rep for v in RND])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
    return (len(dev) / reps, sum(by_name.values()) / reps, wall_s / reps,
            by_name.most_common(6))


def profile_phase(ctx, prover, sel, cp, a, b, c, vk, proof,
                  proof_s: float) -> None:
    """proof_s: the mean unprofiled warm proof (seconds)."""
    phase("8 profile of the 2^16 proof and of verify")
    st = staged_proofs(ctx, sel, cp, a, b, c, PROFILE_REPS)
    print(f"stages, mean of {PROFILE_REPS} proofs with a synchronise "
          "around each stage (ms): " + ", ".join(
              f"{k} {v * 1e3:.3f}" for k, v in st.items()))
    n_dev, dev_us, prof_s, top = profiled_proofs(prover, a, b, c,
                                                 PROFILE_REPS)
    if n_dev == 0:
        print("torch.profiler recorded no device events: device time and "
              "idle share not measured")
    else:
        print(f"torch.profiler, {PROFILE_REPS} proofs: {n_dev:.1f} device "
              f"events and {dev_us / 1e3:.3f} ms of device time per proof; "
              f"profiled proof {prof_s * 1e3:.3f} ms; unprofiled proof "
              f"{proof_s * 1e3:.3f} ms, so {proof_s * 1e6 / n_dev:.3f} us "
              f"of host time per device event and the device idle "
              f"{100 * (1 - dev_us / 1e6 / proof_s):.1f} % of it")
        for name, us in top:
            print(f"  {us / PROFILE_REPS / 1e3:9.3f} ms/proof  {name[:100]}")
    pts, points_s = wall(lambda: PS._verify_points(ctx, vk, proof, CH))
    w1, r1, w2, r2 = pts
    oks, pair_s = wall(lambda: PS._pairing_ratio_checks(
        ctx, PS._stack_g1([w1, w2]), PS._stack_g1([r1, r2])))
    check(bool(oks.all()), "profiled verify accepts")
    print(f"verify split: G1 algebra {points_s:.3f} s, pairing checks "
          f"{pair_s:.3f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 8: stage times, device time and idle "
                         "share of a proof, verify split")
    args = ap.parse_args()
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    t = time.perf_counter()
    log = kernels.build()
    kernels.library()
    print(f"nvcc build {time.perf_counter() - t:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    timings = {}
    errs = {}

    phase("3 K1 row_stages vs plain at the main path's shapes")
    pp = PS.scaled_plonk_params(N_MAIN)
    Fr = MontField(pp.field)
    gen = torch.Generator(device="cpu").manual_seed(0)
    k1_cases = {
        # the 2^18 coset stack of the proof (5 rows, forward root)
        "coset 5x2^18": (5, 4 * N_MAIN, pp.field.root_of_unity(4 * N_MAIN)),
        # the 2^16 circuit interpolation stack (9 rows, inverse root)
        "interp 9x2^16": (9, N_MAIN, pow(pp.omega, -1, Fr.p)),
    }
    k1_inputs = {}
    for name, (rows, n, w) in k1_cases.items():
        intra, _ = N._device_tables(Fr, w, n, 1024, dev)
        y = torch.randint(0, Fr.p, (rows * n // 1024, 1024),
                          generator=gen).to(dev)
        got = RS.row_stages(Fr.p, Fr.n_prime, y, intra)
        want = RS.row_stages_plain(Fr.p, Fr.n_prime, y, intra)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        print(f"K1 {name} {tuple(y.shape)}: max_abs_err {err}")
        check(err == 0, f"K1 bit-equal at {name}")
        errs.setdefault("row_stages", 0)
        errs["row_stages"] = max(errs["row_stages"], err)
        k1_inputs[name] = (y, intra)

    phase("4 setup at 2^16 and K2 commit_many vs plain")
    ctx, timings["setup_s"] = wall(
        lambda: PS.scaled_new(N_MAIN, device=dev))
    tbl, timings["table_build_s"] = wall(lambda: PS.fixed_base_table(ctx))
    Fq = ctx.Fq
    L = ctx.srs.length
    print(f"scaled_new(2^16) {timings['setup_s']:.3f} s, L = {L}; "
          f"window table {tuple(tbl.x.shape)} "
          f"{timings['table_build_s']:.3f} s")
    check(L == N_MAIN + 6, "SRS length n + 6")
    rng = np.random.default_rng(0)
    scalars = torch.as_tensor(rng.integers(0, pp.field.p, size=(9, L)),
                              device=dev)
    got = CM.msm_fixed_base_many_kernel(Fq, tbl, scalars)
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, scalars))
    err = affine_err(got, want)
    print(f"K2 B=9 L={L}: max_abs_err {err}")
    check(err == 0 and not bool(got.inf.any()), "K2 affine-equal, B=9")
    # zero scalars; repeated, opposite and infinity base points
    r = pp.curve.r
    ks = rng.integers(0, 64, size=4096)
    ks[1::3] = r - ks[1::3]
    pts = C.g1_mul(Fq, C.g1_generator(pp.curve, Fq, dev),
                   torch.as_tensor(ks % r, device=dev), nbits=r.bit_length())
    edge_tbl = CM.build_commit_table(Fq, pts, r.bit_length())
    sc = rng.integers(0, r, size=(3, 4096))
    sc[0, ::4] = 0
    sc[1] = 0
    edge = torch.as_tensor(sc, device=dev)
    got = CM.msm_fixed_base_many_kernel(Fq, edge_tbl, edge)
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, edge_tbl, edge))
    err2 = affine_err(got, want)
    print(f"K2 edge batch (zero rows, infinity/repeated/opposite bases): "
          f"max_abs_err {err2}, infinity rows {got.inf.tolist()}")
    check(err2 == 0 and bool(got.inf[1]), "K2 affine-equal, edge batch")
    errs["commit_many"] = max(err, err2)

    phase("5 n = 16 proof: GPU vs CPU port vs recorded JAX values")
    small = []
    for d in ("cpu", dev):
        c16 = PS.scaled_new(N_SMALL, device=d)
        sel, cp, a, b, c = square_chain_circuit(pp.field.p, N_SMALL)
        proof, diags = PS.make_prover(c16, sel, cp)(a, b, c, CH, RND)
        check(bool(diags.all_ok()), f"n=16 diagnostics on {d}")
        small.append((c16, proof))
    (c16, p_cpu), (_, p_gpu) = small
    check(proofs_equal(p_cpu, p_gpu), "n=16 GPU proof equals CPU proof")
    for name, v in ANCHOR_SCALARS.items():
        check(int(getattr(p_gpu, name)) == v, f"anchor {name}")
    for name, (x, y) in ANCHOR_POINTS.items():
        pt = getattr(p_gpu, name)
        check(not bool(pt.inf) and int(c16.Fq.decode(pt.x)) == x
              and int(c16.Fq.decode(pt.y)) == y, f"anchor {name}")
    print(f"n=16 proof equal on GPU and CPU; r_z = {int(p_gpu.r_z)}; "
          f"{len(ANCHOR_SCALARS)} scalars and {len(ANCHOR_POINTS)} points "
          "match the JAX values")

    phase("6 main path at 2^16 gates")
    sel, cp, a, b, c = square_chain_circuit(pp.field.p, N_MAIN)
    prover, timings["make_prover_s"] = wall(
        lambda: PS.make_prover(ctx, sel, cp))
    kernels.reset_counts()
    (proof, diags), timings["first_proof_s"] = wall(
        lambda: prover(a, b, c, CH, RND))
    launches = dict(kernels.LAUNCHES)
    print(f"make_prover {timings['make_prover_s']:.3f} s; first proof "
          f"{timings['first_proof_s']:.3f} s; launches {launches}")
    check(bool(diags.all_ok()), f"2^16 diagnostics {diags}")
    for name in KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched by the prove")
    vk, timings["vk_s"] = wall(lambda: PS.make_vk_scaled(ctx, sel, cp))
    ok, timings["verify_s"] = wall(
        lambda: PS.verify_scaled(ctx, vk, proof, CH))
    bad = proof._replace(r_z=(proof.r_z + 1) % pp.field.p)
    rejected = not PS.verify_scaled(ctx, vk, bad, CH)
    print(f"diags.all_ok True; verify {ok} ({timings['verify_s']:.3f} s); "
          f"tampered r_z rejected {rejected}")
    check(ok and rejected, "verify accepts and rejects the tampered proof")

    phase("7 timings")
    _, timings["warm_proof_s"] = wall(
        lambda: prover(a, b, c, CH, [v + 9 for v in RND]))
    t = time.perf_counter()
    for rep in range(PROOF_REPS):
        out, d = prover(a, b, c, CH, [v + 18 + 9 * rep for v in RND])
        check(bool(d.all_ok()), f"rep {rep} diagnostics")
    torch.cuda.synchronize()
    timings["proofs_per_s"] = PROOF_REPS / (time.perf_counter() - t)
    kms = {}
    for name, (y, intra) in k1_inputs.items():
        k = cuda_ms(lambda: RS.row_stages(Fr.p, Fr.n_prime, y, intra))
        pl = cuda_ms(lambda: RS.row_stages_plain(Fr.p, Fr.n_prime, y, intra))
        kms[f"row_stages {name}"] = (k, pl)
    k = cuda_ms(lambda: CM.commit_many(Fq, tbl, scalars))
    pl = cuda_ms(lambda: CM.commit_many_plain(Fq, tbl, scalars), reps=3)
    kms[f"commit_many B=9 L={L}"] = (k, pl)
    timings["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"card: {card}")
    for key, v in timings.items():
        print(f"{key} {v:.6f}")
    for key, (k, pl) in kms.items():
        print(f"{key}: kernel {k:.6f} ms, plain {pl:.6f} ms")
    if args.profile:
        profile_phase(ctx, prover, sel, cp, a, b, c, vk, proof,
                      1 / timings["proofs_per_s"])
    check("jax" not in sys.modules, "no JAX imported")

    first = {name: next(v for k_, v in kms.items() if k_.startswith(name))
             for name in KERNELS}
    print(json.dumps({"kernels": [
        dict(name=name, **meta, launches=launches.get(name, 0),
             max_abs_err=errs[name], ms=first[name][0],
             plain_ms=first[name][1])
        for name, meta in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
