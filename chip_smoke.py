"""Drive the PyTorch/CUDA port (plonk_tpu_torch) once on one NVIDIA GPU.

Run from the root of the repository:

    python3 chip_smoke.py

Phases, each announced on its own line:
  1. the CUDA device, and its name and power limit from nvidia-smi;
  2. build of the CUDA kernels from plonk_tpu_torch/csrc/;
  3. K1's ptxas report (no spills); K1 (row-stage NTT) against its plain
     PyTorch version, word-equal, at the main path's shapes, on random
     rows and on edge rows (zeros, r - 1, lo = hi, hi = r - lo), with each
     shape's bound and int64 floor;
  4. the 2^16-gate setup; K2's ptxas report (no spills); K2 (fixed-base
     commit) against its plain version, affine-equal, at the main path's
     shape, at one shard's of the 8-shard mesh (L = 8 193) and on a batch
     with zero scalars and repeated, opposite and infinity bases;
  5. the n = 16 proof on the GPU against the CPU port and the JAX
     package's recorded values;
  6. the main path at 2^16 gates: make_prover, prove (kernel launches
     counted), diagnostics, verifying key, verify, tamper rejection;
  7. times: setup, table build, proofs/s, verify, each kernel against its
     plain version at each shape of phases 3 and 4, with its bound.

With --profile a phase 8 follows: the time of each prover stage, the
device kernels and device time of a proof under torch.profiler (and so
the device's idle share), and the verifier's split between its G1
algebra and its pairings; phase 13 adds the BN254 verifier's split,
phase 32 GLV's warm call under torch.profiler (device events, device
time, idle share) and phase 35 a sharded 2^12 BN254 proof's:

    python3 chip_smoke.py --profile

With --kernels only phases 1 and 2 run, then phases 3 and 4 (K1 and K2
against their plain versions), K1's and K2's times and bounds beside a
copy of K1's words, K2 on its packed table's other entry order and K2's
product and additions timed alone, then phase 9's K3 checks, phase
14's K6 checks, edge inputs and pass split and its K5 checks, and phase
17's K8 and K9 checks, each with its times (K8's prefix scan and K9's
whole all_to_all call with device and host time, K9 alone, the generic
all-gather), in about two minutes, and no result line is printed:

    python3 chip_smoke.py --kernels

Then the BN254 path (models/plonk_bn254.py) at 2^12 gates, the size at
which the JAX package configures its BN254 prover:
  9. K3's ptxas report (no spills); K3 (16-limb row NTT) against its
     plain version, word-equal, at the path's three row shapes, on random
     rows and on edge rows (zeros, p - 1, lo = hi, hi = p - lo), with each
     shape's bound and int64 floor;
 10. bn254_setup(2^12) and the window table with its packed form for K4,
     timed; K4's ptxas report (registers, spills) and SASS counts; K4
     (16-limb fixed-base commit) against its plain version, affine-equal,
     at B = 9, L = 4101 and on an edge batch;
 11. the n = 8 proof on the GPU against the CPU port and the JAX
     package's recorded values, each device computing its own SRS and
     window table under empty caches of its own;
 12. the main path: make_prover_bn254, prove (K3 and K4 launches
     counted), diagnostics, make_vk_bn254 (the proof's verify, and a
     tampered proof's rejection, are phase 31's verify_bn254_many);
 13. times: proofs/s of one proof (phase 35 times two in turns with the
     sharded prover), the stage split
     of a proof, device events and device time of a proof under
     torch.profiler (so the idle share), verify, each kernel against its
     plain version, peak memory.

Then the scaled prover's other prims at 2^16 gates, on the context of
phases 4-7:
 14. K5's and K6's ptxas reports (no spills), K7's and its SASS (it must
     hold int8 tensor-core instructions); K5 (full-row transform, both
     directions, on random and edge rows), K6 (one-pass four-step
     transform) and K7 (modular matmul, also on words p - 1) against their
     plain versions, word-equal, at the shapes of the 2^18 coset
     transforms, each call one launch; K6 also on matrices of zeros
     and of p - 1, and at nb = 1 on small shapes down to n1 = 1; K6's
     passes timed apart (first pass, grid barrier, second pass);
 15. make_prover (precompute_circuit) and a proof under fused_prims,
     onepass_prims and mxu2_prims, then mxu_prims (plain products, no K7,
     peak memory of each): launches counted for each, diagnostics, the
     proof equal to the default prims' proof of phase 6;
 16. proofs/s of the five prims in turns, each kernel against its plain
     version.

Then the mesh-sharded scaled prover at 2^16 gates (parallel/), on the
same context, with its eight shards all on the card:
 17. K8 on the path (the grand product's prefix scan, which gathers the
     shard totals, one launch for all shards) against its plain version
     at 8 shards of 8192 words, on random and edge words, inclusive and
     shifted; K8's generic all-gather and K9 (all-to-all) against their
     plain versions at every shape the sharded proof gives K9, on one
     shard, on odd row counts and at 8 x (64, 512); word-equal, each call
     one launch;
 18. prove_scaled with make_dist_prims on 8 shards, through K8 and K9 and
     through plain copies: launches counted, diagnostics, the proof equal
     to phase 6's, verify, tamper rejection (the device events and device
     time of a sharded proof of each kind under torch.profiler in a fresh
     process: --dist-events, below);
 19. proofs/s of the default prims and of both sharded prims in turns,
     K8 and K9 against their plain versions: the prefix scan's device and
     host time a call and its device events a call (fresh process), K9
     alone and as the whole all_to_all call, the generic all-gather.

Then the toy "PLONK by hand" prover (models/plonk.py, F_17 scalars,
F_101 coordinates, n = 4, the reference's shapes), which launches none of
K1-K9:
 20. the canonical proof on the card under each commit mode (naive,
     "table", Pippenger): the reference SRS and dialect give the golden
     proof (nine commitments at infinity, tail 15/13/5/1/12/15/15); the
     fixed SRS and the standard dialect prove, verify and reject a
     tampered r_z; all diagnostics ok; the card's words equal the CPU
     port's;
 21. the batched prover (parallel/batch.py) at B = 65 536 proofs in the
     configuration of the JAX package's entry() (fixed SRS, reference
     dialect, the canonical witness in every lane, per-lane challenges and
     blinding in F_17 from a seed): no kernel launched, lane 0 golden and
     equal to the single proof, the first 1 024 lanes equal the CPU
     port's, diagnostics included, the sharded prover on 8 shards equal
     to the batch; proofs/s at B = 1, 1 024 and 65 536 (synchronised,
     host clock) and the peak memory of the 65 536 batch.

Then the non-interactive scaled prover and the rest of plonk_scaled at
2^16 gates, on the context of phases 4-7 (its window table cached on
disk under build/plonk_tpu_cache, emptied at the start, so that phase 4
builds it and phase 25 loads it):
 22. the BLAKE2b Fiat-Shamir prover (models/fiat_shamir.py): prove (K1
     and K2 launches counted), diagnostics, challenges equal to the host
     replay, the proof equal to make_prover's for those challenges,
     verify, a tampered commitment and evaluation rejected;
 23. the Poseidon Fiat-Shamir prover (models/fs_poseidon.py): the same
     checks; the card's tree_digest of random public inputs equal to the
     CPU port's (2^16 of them) and to host_tree_digest (2^12);
     torch.profiler's device events of one permutation (prove_many is
     phase 30's);
 24. verify_scaled_many at B = 4 proofs of distinct blinding, one lane
     tampered, each lane equal to verify_scaled of its proof;
 25. proof and SRS bytes (utils/serialization.py) round-trip on the card
     and equal the CPU port's at n = 16; a second context loads the
     cached window table, words equal; prove_scaled_checked gives phase
     6's proof and raises on an out-of-range copy index before any
     launch; then proofs/s of make_prover and both Fiat-Shamir provers
     in turns, verify, batch-verify, cache-load and table-build times.

Then the non-interactive BN254 prover (models/fiat_shamir.py and
models/fs_poseidon.py over plonk_bn254's stages) and verify_bn254_many:
 26. the 16-limb Poseidon (BN254-Fr, t = 3): big_permute on a (64, 3, 16)
     batch on the card equal to the CPU port's and to PoseidonHost;
     big_tree_digest of 2^12 random leaves equal to host_tree_digest; a
     permutation's time, device events (launches) and device time;
 27. on phase 11's n = 8 context, the BLAKE2b FS proof and the Poseidon
     prove_many at B = 2 (one batched pass, lane 0 the single Poseidon
     proof) equal to the JAX package's recorded proofs
     (tests/golden/bn254_fs_jax.json), word for word, nonce and challenge
     included;
 28. at 2^12 gates on the context, circuit, prover and verifying key of
     phases 10-12: the BLAKE2b FS prover (its vk equal to
     make_vk_bn254's; K3 and K4 launches counted exactly: K3 4, K4 4 a
     proof; diagnostics; the challenges equal to the host replay; the
     proof equal to make_prover_bn254's for its challenges;
     verify_bn254_fs accepts it), the BLAKE2b proof's and that
     make_prover_bn254 proof's times as proofs/s, and the build times
     (the Poseidon prover and verify_bn254_many are phase 31's).

Then batched proving, each batch one pass whose kernel launches are one
proof's:
 29. the scaled prover at B = 16 proofs of 2^12 gates on a fresh context
     and window table (bench.py's bench_scaled_batched: witnesses
     x0 = 3 + i, challenges 1111..5555, blinding 1..9 + 100 i):
     make_prover on the batch launches K1 4 and K2 1, as one proof; every
     lane's diagnostics hold and every lane equals its single proof;
     verify_scaled_many on the 16 lanes as they come out, then with lane
     5 tampered, refusing that lane alone; K2 at (144, 4 101) with an
     all-zero lane against its plain version, card ms and bound;
     proofs/s of the batch and of one proof in turns; the batch's peak
     memory;
 30. PoseidonFsProver.prove_many at B = 8 (bench_fs_poseidon's lanes) on
     the 2^16 context of phases 4-7: one batched pass with K1 4 and K2 4,
     every lane equal to prove() of its inputs (nonce, challenge), lane 0
     verifies; batch and single proofs/s in turns;
 31. on phases 10-12's 2^12 BN254 context, lanes bn254_mul_circuit seeds
     11 + i with bench.py's blinding variants: BN254PoseidonFsProver.
     prove_many at B = 4 (K3 4, K4 4; in place of a single Poseidon
     proof), every lane's challenges equal to the host replay's, lane 0
     equal to make_prover_bn254's single proof for its challenges and
     accepted by verify_bn254_fs_poseidon; make_prover_bn254 on the
     batch (K3 4, K4 1) equal to the FS lanes; K3 and K4 at the batch's
     shapes; then verify_bn254_many on
     [phase 12's proof, the BLAKE2b proof, the 4 lanes, the BLAKE2b
     proof with [a] replaced] giving [T, T, T, T, T, T, F] (the Poseidon
     verify of each lane, batched); batch and single times.

Then the BN254 commitments without a window table (ops/bigcurve.py's
Pippenger, ops/glv.py) and the BN254 disk caches (HOME and
PLONK_TPU_CACHE both point into build/ and are emptied at the start, so
that phase 10 writes the SRS and table files and phase 34 loads them):
 32. the JAX package's bench_bn254_msm configuration: 2^14 copies of the
     generator, random scalars below r from default_rng(0), 8-bit
     windows; plain Pippenger and GLV each equal to (sum s_i) G from a
     python-int ladder on every roll; points/s over one more roll of
     the scalars after a warm call (with --profile GLV's read by
     torch.profiler: device events, device time, so the idle share),
     peak memory, no kernel launched; the window combination (Horner's
     rule) timed alone with its operator calls;
 33. on phases 10-12's context, table and circuit: K4 at B = 9 equal to
     _commit_many by GLV and by plain Pippenger on the same scalars (the
     JAX package's check_bn254_pallas_commit_parity), each commit call
     timed, each _commit_many call's peak memory; make_vk_bn254 and a make_prover_bn254 proof under
     PLONK_TPU_BN254_FB=0 equal word for word to phase 12's, the proof
     launching K3 4 and K4 0 times;
 34. a fresh bn254_setup and a fresh context's window table load phase
     10's files (build_big_table and big_fixed_base_mul_many refused
     meanwhile), words equal, the packed table K4 reads too; load time
     against build time.

Then the mesh-sharded BN254 prover (parallel/dist_bigntt.py and
parallel/dist_bn254.py), its shards all on the card:
 35. the n = 8 proof on a 2-shard mesh (the JAX package's TestDistProver
     mesh) on phase 11's context (the card's own SRS and table, built
     under an empty cache), on the table route and under
     PLONK_TPU_BN254_FB=0, each equal to phase 11's single-device card
     proof and to JAX's recorded sharded proof
     (tests/golden/dist_bn254_jax.json); K3's local transform (the row
     pass, then the bit-reversal gather) against big_ntt at the 2^12
     path's rows of 64 and 128, on random and edge rows; K9 against
     all_to_all_plain at every 16-limb shape of the 2^12 proof on 8
     shards and its precompute; K8's generic all-gather at 8 x (1, 16)
     against the plain exchange, timed beside its library call
     (torch.cat of 8 copies of the shards); K4 on the first and last shard's table
     slice against its plain version; then on phases 10-12's context:
     make_prover_bn254 under make_dist_bn254_prims on 8 shards, launches
     counted exactly (K3 8, K9 10, K8 1, K4 8 a proof), diagnostics, the
     proof equal to phase 12's, and again under plain exchanges (no K8 or
     K9) and under PLONK_TPU_BN254_FB=0 (no K4); proofs/s of the
     single-device and the sharded prover in turns (one proof each), a
     sharded proof's peak memory, and with --profile its device events,
     device time and idle share under torch.profiler.

Then the sharded MSM (parallel/dist_msm.py) and the port's entry points
(plonk_tpu_torch/entry.py, utils/profiling.py):
 36. dist_msm in the JAX package's bench_msm configuration (2^16
     multiples of the toy generator and 5-bit scalars from
     default_rng(1), 5-bit windows) on 8 shards of the card, through K8
     (one launch, nothing else) and through plain copies (no launch),
     equal to the card's single-device msm_pippenger and to the CPU
     port's dist_msm; K8's generic all-gather at the partials' shape,
     8 x (1, 3) int64 rows, against the plain exchange on random words
     and on the call's partials, timed, with its bound and its library
     call (torch.cat of 8 copies of the rows); points/s of the
     sharded and the single-device MSM in turns; entry() on the card
     (r_z = 15, every word equal to the CPU port's, no kernel);
     dryrun_multichip(8) on the card under empty caches of its own (all
     five legs ok, each timed; K2, K3, K4, K8 and K9 launched, K1 not);
     profiling.trace_to around one sharded dist_msm call, after the
     script's earlier torch.profiler sessions: the trace's device events
     and device time (so the idle share) and whether K8's launch is
     among them.

With --dist-events MODE only that reading runs, in a process of its own,
and prints one JSON line: MODE scan-cuda or scan-plain (the sharded grand
product on 8 x 8192 words) or proof-cuda or proof-plain (a sharded 2^16
proof, with proofs/s).

Any failure raises and exits non-zero before the result line; so does a
machine without CUDA, and a directory that holds the script without the
rest of the repository. The last
two lines are a JSON object of the kernels (with each one's bound: the
larger of its bytes over 3.35 TB/s and its operations over the card's
rate for them, 32-bit multiply-adds at 16.75 T/s, the H100's IMAD rate of
64 per SM per clock at 1.98 GHz, and K7's 8-bit limb products at the
1979 T/s of the int8 tensor cores; a 32x32->64-bit product counts as two
multiply-adds, so a 31-bit Montgomery product is 4 (of m * p only the
high half), a 256-bit CIOS product 264 and a 256-bit square 208; the bytes
are those of the values, 4 per 31-bit word, 1 per 7-bit limb and 32 per
BN254 element, whatever the port stores them in) and the result JSON
object.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from plonk_tpu_torch import entry as EN
    from plonk_tpu_torch.models import fiat_shamir as FS
    from plonk_tpu_torch.models import fs_poseidon as FSP
    from plonk_tpu_torch.models import plonk as PL
    from plonk_tpu_torch.models import plonk_bn254 as PB
    from plonk_tpu_torch.models import plonk_scaled as PS
    from plonk_tpu_torch.models import presets as TP
    from plonk_tpu_torch.models import verifier as TV
    from plonk_tpu_torch.models.constraints import constraints_to_tensors
    from plonk_tpu_torch.models import synthetic as SY
    from plonk_tpu_torch.models.synthetic import (
        big_edge_rows, bn254_mul_circuit, edge_rows, from_words,
        square_chain_circuit, words_vec)
    from plonk_tpu_torch.ops import bigcommit as BK
    from plonk_tpu_torch.ops import bigcurve as BC
    from plonk_tpu_torch.ops import bigntt as BN
    from plonk_tpu_torch.ops import commit as CM
    from plonk_tpu_torch.ops import curve as C
    from plonk_tpu_torch.ops import fused_ntt as FN
    from plonk_tpu_torch.ops import glv as GLV
    from plonk_tpu_torch.ops import mxu_ntt as MX
    from plonk_tpu_torch.ops import ntt as N
    from plonk_tpu_torch.ops import poseidon as PO
    from plonk_tpu_torch.ops import row_stages as RS
    from plonk_tpu_torch.ops import bigfield as BF
    from plonk_tpu_torch.ops.bigfield import BigMontField
    from plonk_tpu_torch.ops.field import Field, MontField
    from plonk_tpu_torch.ops.msm import msm_pippenger
    from plonk_tpu_torch.parallel import batch as TB
    from plonk_tpu_torch.parallel import collectives as CL
    from plonk_tpu_torch.parallel import dist_bigntt as DBN
    from plonk_tpu_torch.parallel import dist_bn254 as DB254
    from plonk_tpu_torch.parallel import dist_msm as DM
    from plonk_tpu_torch.parallel import dist_ntt as DN
    from plonk_tpu_torch.parallel import dist_prover as DP
    from plonk_tpu_torch.parallel import dist_scan as DS
    from plonk_tpu_torch.parallel import mesh as MS
    from plonk_tpu_torch.utils import kernels
    from plonk_tpu_torch.utils import profiling as PF
    from plonk_tpu_torch.utils import serialization as SZ
    from plonk_tpu_torch.utils.params import (BN254_FR, GF101, SCALED_FQ,
                                              SCALED_FR, TOY_CURVE)
except ModuleNotFoundError as exc:   # the script without the repository
    raise SystemExit(f"chip_smoke: {exc}; run it from the root of the "
                     "repository") from exc

N_MAIN = 1 << 16
N_SMALL = 16
CH = [1111, 2222, 3333, 4444, 5555]
RND = list(range(1, 10))
PROOF_REPS = 5
TURN_REPS = 1       # proofs of each prims in phases 16 and 19's turns
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
BN254_KERNELS = {
    "big_row": dict(route="cuda", source="plonk_tpu_torch/csrc/big_row.cu",
                    replaces="plonk_tpu/ops/pallas_bigntt.py:73"),
    "big_commit": dict(route="cuda",
                       source="plonk_tpu_torch/csrc/big_commit.cu",
                       replaces="plonk_tpu/ops/pallas_bigmsm.py:423"),
}
PRIMS_KERNELS = {
    "row_transform": dict(route="cuda",
                          source="plonk_tpu_torch/csrc/row_stages.cu",
                          replaces="plonk_tpu/ops/pallas_ntt.py:144"),
    "onepass_ntt": dict(route="cuda",
                        source="plonk_tpu_torch/csrc/onepass_ntt.cu",
                        replaces="plonk_tpu/ops/fused_ntt.py:171"),
    "mont_matmul": dict(route="cuda",
                        source="plonk_tpu_torch/csrc/mont_matmul.cu",
                        replaces="plonk_tpu/ops/pallas_mxu_ntt.py:63"),
}
# prims -> (its kernel, launches per proof, launches in precompute_circuit)
PRIMS = {"fused": ("row_transform", 4, 2), "onepass": ("onepass_ntt", 2, 1),
         "mxu2": ("mont_matmul", 4, 2)}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
IMAD_PER_S = 132 * 64 * 1.98e9  # 32-bit multiply-adds: 64/SM/clock
INT8_OPS_PER_S = 1979e12        # int8 tensor cores, dense (2 per MAC)
QUEUE_AHEAD_CYCLES = 100_000_000  # ~50 ms of device delay before timing
QUEUE_AHEAD_MS = QUEUE_AHEAD_CYCLES / 1.98e6    # at the 1.98 GHz clock
N_BN = 1 << 12
N_BN_SMALL = 8
BN_SECRET = 987654321
BN_CH = [111111, 222222, 333333, 444444, 555555]
BN_RND = list(range(17, 26))
# the JAX package's n = 8 BN254 proof for (BN_CH, BN_RND), the circuit of
# bn254_mul_circuit(8) and secret 987654321, standard form (recorded with
# tests/test_torch_bn254.py::test_recompute_jax_values)
BN_ANCHOR_SCALARS = dict(
    a_z=0x136003277444e0948f970a92a66812d0a653c316b2b8b5fc05f8fa4328ba0289,
    b_z=0x1b90e96c0d1aed1ebb9401e9d0d91fc43416b4e40cba3012ccc3cfbc617851d4,
    c_z=0x13a8a59e751171a331cf4a3bd126bf06449b65855fbb59dc964221a38516604e,
    s_sigma_1_z=0x6c81c,
    s_sigma_2_z=0x21e88c,
    r_z=0x15eb105fb82cb8907f56cfccde29852d8d5e8d90c24295af5ecf17bd02a8caef,
    z_omega_z=0x1bbbb4a369d870ef5ae850ccac4d4e7b7ca474bb06bf5ba87d9b3b7e0250010a)
BN_ANCHOR_POINTS = dict(
    a_s=(0x226a857a70c5237092efbb553637324b4d00ad4d86167f5d0d163b630fcda920,
         0x1f648a2d972f4f588724ed3d009338aab0abdabb0d895e58871c240e03c5a653),
    w_z_omega_s=(
        0xc012db6d0618ba653b09afef7e01817b629df224ef38c12a8762e4bbaa85a4,
        0x211e9e5294d3b07a31257f566ddafbe05d9bdca44afd66be3d3a7910eceb924e))
# the toy "PLONK by hand" proof of the reference run
# (tests/golden/plonk_golden.json): nine commitments at infinity on the
# reference SRS, and this tail for the canonical challenge and blinding
TOY_TAIL = dict(a_z=15, b_z=13, c_z=5, s_sigma_1_z=1, s_sigma_2_z=12,
                r_z=15, z_omega_z=15)
TOY_MODES = {"naive": dict(), "table": dict(commit_mode="table"),
             "pippenger": dict(use_pippenger=True)}
TOY_BATCH = 1 << 16          # proofs in phase 21's batch
TOY_CPU_LANES = 1024         # lanes held against the CPU port
TOY_SEED = 20260101
TOY_TIMED = {1: 3, 1024: 2, TOY_BATCH: 2}     # batch -> timed reps


def bound_ms(n_bytes: float, n_imad: float):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_imad / IMAD_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


T0 = time.perf_counter()
BUILD_LOG = []      # the nvcc build's output (ptxas -v), set in phase 2


def ptxas_lines(entry: str) -> list:
    """The ptxas -v report (registers, spills, shared memory) of each
    compiled kernel whose mangled name contains `entry`."""
    out, keep = [], False
    for line in BUILD_LOG[0].splitlines():
        if "Compiling entry function" in line:
            keep = entry in line
        if keep:
            out.append(line.strip())
    return out


def ptxas_report(entry: str) -> None:
    """Print the ptxas -v report of the kernels named `entry` and check
    that none spills."""
    report = ptxas_lines(entry)
    for line in report:
        print("  " + line)
    spills = [ln for ln in report if "spill stores" in ln]
    check(spills and all("0 bytes spill stores" in ln for ln in spills),
          f"{entry} does not spill")


def sass_opcodes(entry: str, opcodes) -> dict:
    """How many SASS instructions of each opcode prefix the built library
    holds in the kernels whose name contains `entry` (cuobjdump -sass)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([cuobjdump, "-sass", kernels.LIB_PATH],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    counts, keep = {op: 0 for op in opcodes}, False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            keep = entry in line
        elif keep:
            code = line.split("*/", 1)[-1].strip()
            if code.startswith("@"):             # a predicate guard
                code = code.split(None, 1)[-1]
            for op in opcodes:
                if code.startswith(op):
                    counts[op] += 1
    return counts


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def timed_calls(fn, reps: int = 10, queue_ahead: bool = False):
    """(mean device ms of fn() over reps back-to-back calls by CUDA events,
    mean host µs per call to enqueue them), after two warm-ups. With
    queue_ahead a device-side delay is queued first, so that the host has
    enqueued every call before the device reaches them and the events time
    the device work alone; without it a call shorter than its own enqueue
    on the host is timed at the host's rate."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    if queue_ahead and host_ms > QUEUE_AHEAD_MS:
        print(f"  (the host took {host_ms:.3f} ms to enqueue {reps} calls, "
              f"longer than the ~{QUEUE_AHEAD_MS:.0f} ms device delay: "
              "this reading includes host time)")
    return start.elapsed_time(end) / reps, host_ms * 1e3 / reps


def cuda_ms(fn, reps: int = 10, queue_ahead: bool = False) -> float:
    """The device ms per call of timed_calls."""
    return timed_calls(fn, reps, queue_ahead)[0]


def device_ms(fn, reps: int = 20):
    """(device events per call, their mean duration per call in ms or
    None if there were none) of fn() under torch.profiler, after one
    warm-up: a second reading of a kernel's device time, which counts only
    the launches the profiler recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = trace_device_events(prof)
    return (len(events) / reps,
            sum(us for _, us in events) / reps / 1e3 if events else None)


def kernel_times(kern, plain, reps: int = 100, plain_reps: int = 3):
    """(kernel ms by CUDA events over `reps` calls queued behind a device
    delay, plain ms by CUDA events over `plain_reps` back-to-back calls,
    the kernel's torch.profiler reading (events per call, ms))."""
    return (cuda_ms(kern, reps=reps, queue_ahead=True),
            cuda_ms(plain, reps=plain_reps), device_ms(kern))


def print_kernel_times(kms: dict) -> None:
    for key, (k, pl, (n_ev, kd)) in kms.items():
        prof = "none" if kd is None else f"{kd:.6f} ms"
        print(f"{key}: kernel {k:.6f} ms (CUDA events, queued ahead); "
              f"torch.profiler {n_ev:.2f} device events and {prof} per "
              f"call; plain {pl:.6f} ms")


def wall(fn):
    """(result, seconds) of fn() ending in a device synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def affine_err(a, b) -> int:
    """Largest word difference between two affine point batches
    (x, y, infinity flag) of either curve."""
    return max(int((a[0] - b[0]).abs().max()), int((a[1] - b[1]).abs().max()),
               int((a[2] != b[2]).sum()))


STAGES = ("_stage_prep", "_stage_grand_product", "_stage_quotient",
          "_stage_openings")
PROFILE_REPS = 3
BN_PROFILE_REPS = 1     # phase 13's staged and profiled 2^12 BN254 proofs
BN_PROOF_REPS = 1       # phase 13's timed 2^12 BN254 proofs (phase 35
                        # times 2 in turns with the sharded prover)


def staged_proofs(mod, prove, prims, call, reps: int):
    """`reps` proofs through `prove` of module `mod` (prove_scaled or
    prove_bn254) with each of its four stages and the batched commit of
    `prims` timed on the host clock, each ending in a device synchronise;
    call(prove, prims, rep) makes one proof and returns its diagnostics.
    Returns the mean seconds per proof of each stage, of the rest of the
    prover (challenge encoding, decoding, diagnostics) and of the whole
    proof; the parts add up to the whole."""
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

    prims = prims._replace(commit_many=timed("commit", prims.commit_many))
    saved = {name: getattr(mod, name) for name in STAGES}
    try:
        for name in STAGES:
            setattr(mod, name, timed(name.removeprefix("_stage_"),
                                     saved[name]))
        for rep in range(reps):
            d = call(timed("proof", prove), prims, rep)
            check(bool(d.all_ok()), f"staged proof {rep} diagnostics")
    finally:
        for name, fn in saved.items():
            setattr(mod, name, fn)
    mean = {k: v / reps for k, v in times.items()}
    mean["rest"] = mean["proof"] - sum(v for k, v in mean.items()
                                       if k != "proof")
    return mean


def trace_device_events(prof) -> list:
    """(name, microseconds) of each device event of a finished
    torch.profiler run, read from the Chrome trace it exports."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    path = os.path.join(kernels.BUILD_DIR, "profile_trace.json")
    prof.export_chrome_trace(path)
    try:
        return PF.device_events(path)
    finally:
        os.remove(path)


def profiled_proofs(run, reps: int):
    """`reps` calls run(rep) under torch.profiler, recording device
    activity only. Returns (device events per call, device microseconds
    per call, host wall seconds per call while profiled, the top device
    kernels by time). The device events are read from the Chrome trace
    the profiler exports (its `key_averages()` builds a Python object and
    a tree over every event, which takes minutes for the ~10^6 events of
    a few BN254 proofs)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for rep in range(reps):
            run(rep)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    t = time.perf_counter()
    events = trace_device_events(prof)
    print(f"trace export and parse {time.perf_counter() - t:.3f} s")
    by_name = collections.Counter()
    for name, us in events:
        by_name[name] += us
    return (len(events) / reps, sum(by_name.values()) / reps, wall_s / reps,
            by_name.most_common(6))


def print_profile(n_dev, dev_us, prof_s, top, proof_s: float,
                  reps: int = PROFILE_REPS) -> None:
    """Print profiled_proofs' figures (over `reps` proofs) beside the
    unprofiled proof time."""
    if n_dev == 0:
        print("torch.profiler recorded no device events: device time and "
              "idle share not measured")
        return
    print(f"torch.profiler, {reps} proofs: {n_dev:.1f} device "
          f"events and {dev_us / 1e3:.3f} ms of device time per proof; "
          f"profiled proof {prof_s * 1e3:.3f} ms; unprofiled proof "
          f"{proof_s * 1e3:.3f} ms, so {proof_s * 1e6 / n_dev:.3f} us "
          f"of host time per device event and the device idle "
          f"{100 * (1 - dev_us / 1e6 / proof_s):.1f} % of it")
    for name, us in top:
        print(f"  {us / reps / 1e3:9.3f} ms/proof  {name[:100]}")


def profile_phase(ctx, prover, sel, cp, a, b, c, vk, proof,
                  proof_s: float) -> None:
    """proof_s: the mean unprofiled warm proof (seconds)."""
    phase("8 profile of the 2^16 proof and of verify")
    prims = PS.default_prims()
    pre = PS.precompute_circuit(ctx, sel, cp, prims)
    prims = prims._replace(commit_many=PS.table_commit(
        ctx, PS.fixed_base_table(ctx)))
    st = staged_proofs(
        PS, PS.prove_scaled, prims,
        lambda prove, pr, rep: prove(
            ctx, sel, cp, a, b, c, CH, [v + 100 + 9 * rep for v in RND],
            prims=pr, pre=pre)[1], PROFILE_REPS)
    print(f"stages, mean of {PROFILE_REPS} proofs with a synchronise "
          "around each stage (ms): " + ", ".join(
              f"{k} {v * 1e3:.3f}" for k, v in st.items()))
    n_dev, dev_us, prof_s, top = profiled_proofs(
        lambda rep: prover(a, b, c, CH, [v + 200 + 9 * rep for v in RND]),
        PROFILE_REPS)
    print_profile(n_dev, dev_us, prof_s, top, proof_s)
    pts, points_s = wall(lambda: PS._verify_points(ctx, vk, proof, CH))
    w1, r1, w2, r2 = pts
    oks, pair_s = wall(lambda: PS._pairing_ratio_checks(
        ctx, PS._stack_g1([w1, w2]), PS._stack_g1([r1, r2])))
    check(bool(oks.all()), "profiled verify accepts")
    print(f"verify split: G1 algebra {points_s:.3f} s, pairing checks "
          f"{pair_s:.3f} s")


# Bytes of the values themselves, whatever the port's storage: a 31-bit
# field word is 4 bytes, a BN254 Fr or Fq element 32, a flag 1.
WORD_BYTES = 4
BIG_BYTES = 32


def selected_entries(digits: torch.Tensor, nb: int) -> int:
    """Distinct (window, digit, point) table entries with a nonzero digit
    that some commitment selects; digits (B, W, L)."""
    B, W, L = digits.shape
    hit = torch.zeros((W, nb, L), dtype=torch.bool, device=digits.device)
    for b in range(B):
        hit.scatter_(1, digits[b][:, None, :], True)
    return int(hit[:, 1:].sum())


# 32-bit multiply-adds per 31-bit Montgomery product: t = a * b is a
# 32x32->64 product, two (low and high half); m = lo(t) * n' one; and of
# m * p only the high half, one (r = hi(t) + hi(m p) + (lo(t) != 0))
MONT31_IMAD = 4
# ... per 256-bit CIOS product: 64 + 64 wide products, two each, and the 8 m_i
MONT256_IMAD = 264
# ... per 256-bit square: 28 off-diagonal and 8 diagonal wide products, then
# the reduction's 64 wide products and 8 m_i (csrc/bigmont.cuh big_sqr_lazy)
MONT256_SQR_IMAD = 208


def row_bound(R: int, C: int):
    """K1's and K5's least time: rows of 31-bit words read and written
    once, the (log2 C, C) stage table read once; MONT31_IMAD 32-bit
    multiply-adds per Montgomery product, C/2 products per stage and
    row."""
    S = C.bit_length() - 1
    return bound_ms((2 * R * C + S * C) * WORD_BYTES,
                    R * C // 2 * S * MONT31_IMAD)


def onepass_bound(nb: int, n1: int, n2: int, scaled: bool):
    """K6's least time: the matrices read and written once, the two stage
    tables and the (n1, n2) twiddle read once; MONT31_IMAD 32-bit
    multiply-adds per Montgomery product: n1*n2/2 per stage, one per word
    for the twiddle and one more for the 1/n scale."""
    S1, S2 = n1.bit_length() - 1, n2.bit_length() - 1
    words = 2 * nb * n1 * n2 + S1 * n1 + n1 * n2 + S2 * n2
    prods = nb * (n1 * n2 // 2 * (S1 + S2) + n1 * n2 * (2 if scaled else 1))
    return bound_ms(words * WORD_BYTES, prods * MONT31_IMAD)


def mont_matmul_bound(R: int, C: int, K: int, L: int, T: int):
    """K7's least time: X (R, C) and the (T, K) twiddle read once as
    31-bit words, the (L, C, K) limb planes once at a byte per limb, the
    (R, K) result written once; the R*K*C*L^2 products of 7-bit limbs on
    the int8 tensor cores, the card's fastest exact route. Returns
    (bound, bytes or operations, the time of the R*K*C 32x32->64-bit
    products as two 32-bit multiply-adds each at the IMAD rate, ms)."""
    n_bytes = (R * C + T * K + R * K) * WORD_BYTES + L * C * K
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 2 * R * K * C * L * L / INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            R * K * C * 2 / IMAD_PER_S * 1e3)


def commit_bound(table, scalars):
    """K2's least time, counted on this run's scalars: the 31-bit scalars
    read once, each table entry that some nonzero digit selects read once
    (x and y, 8 bytes; infinity needs no byte of its own, an x that no
    coordinate takes marks it), the Jacobian output written once; per
    nonzero-digit, non-identity term one mixed addition (the table point
    is affine), 7 products and 4 squares of MONT31_IMAD multiply-adds
    (madd-2007-bl), as K4's bound counts it. Returns (bound, terms,
    distinct entries)."""
    wb = int(table.window_bits)
    W, nb, L = table.x.shape
    digits = torch.stack([(scalars >> (w * wb)) & (nb - 1)
                          for w in range(W)], dim=1)        # (B, W, L)
    hit = table.inf[torch.arange(W, device=digits.device)[None, :, None],
                    digits, torch.arange(L, device=digits.device)]
    terms = int(((digits != 0) & ~hit).sum())
    entries = selected_entries(digits, nb)
    n_bytes = ((scalars.numel() + 3 * scalars.shape[0]) * WORD_BYTES
               + entries * 2 * WORD_BYTES)
    return (bound_ms(n_bytes, terms * (7 + 4) * MONT31_IMAD), terms,
            entries)


def int64_floor_ms(n_words: int) -> float:
    """The least time to move n_words of the port's int64 storage once
    over device memory: the floor that storage puts under a kernel whose
    values' bound is lower."""
    return n_words * 8 / HBM_BYTES_PER_S * 1e3


def big_row_bound(R: int, C: int, scaled: bool):
    """K3's least time: rows of BN254-Fr elements read and written once,
    the C/2 distinct twiddles of each stage read once; MONT256_IMAD 32-bit
    multiply-adds per product."""
    S = C.bit_length() - 1
    n_bytes = (2 * R * C + S * C // 2) * BIG_BYTES
    n_mul = R * (C // 2 * S + (C if scaled else 0))
    return bound_ms(n_bytes, n_mul * MONT256_IMAD)


def big_commit_bound(table, scalars):
    """K4's least time, counted on this run's scalars: the Fr scalars read
    once, the infinity flags of the base points read once, each table
    entry that some nonzero digit selects read once (x and y in Fq), the
    Jacobian output written once; per term with a nonzero digit one mixed
    addition, 7 products of MONT256_IMAD multiply-adds and 4 squares of
    MONT256_SQR_IMAD (madd-2007-bl). Returns (bound, terms, distinct
    entries)."""
    digits = BK.commit_digits(table, scalars).long()          # (B, W, L)
    B, W, L = digits.shape
    terms = int((digits != 0).sum())
    entries = selected_entries(digits, table.x.shape[1])
    n_bytes = ((B * L + entries * 2 + 3 * B) * BIG_BYTES + L)
    return (bound_ms(n_bytes, terms * (7 * MONT256_IMAD
                                       + 4 * MONT256_SQR_IMAD)),
            terms, entries)


def k3_cases(Fr):
    """K3's row shapes on the 2^12 path: name -> (R, C, root, dif, scale)."""
    m = 4 * N_BN
    n1, n2 = BN._split(m)
    w4 = BN254_FR.root_of_unity(m)
    return {
        # precompute forward (10 rows), per-proof forward (6), inverse (1)
        "precompute fwd (1280, 128)": (10 * n2, n1, pow(w4, n2, Fr.p), True,
                                       None),
        "proof fwd (768, 128)": (6 * n2, n1, pow(w4, n2, Fr.p), True, None),
        "inverse (128, 128) scaled": (n1, n2, pow(pow(w4, -1, Fr.p), n2,
                                                  Fr.p), False,
                                      pow(m, -1, Fr.p)),
    }


def k3_checks(dev, Fr, errs: dict, bounds: dict) -> dict:
    """K3 against its plain version, word-equal, at each path shape on
    random rows and on edge rows; returns each shape's random inputs for
    timing."""
    ptxas_report("big_row_kernel")
    rng = np.random.default_rng(1)
    inputs = {}
    for name, (R, C, w, dif, scale) in k3_cases(Fr).items():
        tw = torch.as_tensor(BN._row_tables(Fr, w, C), device=dev)
        sc = None if scale is None else Fr.const(scale)
        for kind in ("random", "edge rows"):
            if kind == "random":
                vals = rng.integers(0, 1 << 16, size=(R, C, 16))
                vals[..., 15] &= 0x0FFF                 # < 2^252 < r
            else:
                vals = big_edge_rows(Fr.p, R, C, dif, rng)
            y = torch.as_tensor(vals, device=dev)
            got = BN.big_row_pass(Fr, y, w, dif, scale)
            want = BN.big_row_pass_plain(Fr, y, tw, dif, sc)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            print(f"K3 {name}, {kind}: max_abs_err {err}")
            check(err == 0, f"K3 word-equal at {name}, {kind}")
            errs["big_row"] = max(errs.get("big_row", 0), err)
            if kind == "random":
                inputs[name] = (y, tw, w, dif, scale, sc)
        bnd = big_row_bound(R, C, scale is not None)
        bounds.setdefault("big_row", bnd)
        print(f"K3 {name}: bound {bnd[0]:.6f} ms ({bnd[1]}); int64 floor "
              f"{int64_floor_ms(2 * R * C * 16):.6f} ms")
    return inputs


def k3_times(Fr, inputs: dict) -> dict:
    """Each K3 shape's kernel_times."""
    return {f"big_row {name}": kernel_times(
        lambda a=(y, w, dif, scale): BN.big_row_pass(Fr, *a),
        lambda a=(y, tw, dif, sc_): BN.big_row_pass_plain(Fr, *a))
        for name, (y, tw, w, dif, scale, sc_) in inputs.items()}


def bn254_phases(dev, card: str, profile: bool):
    """The BN254 phases 9-13; returns (kernel entries for the kernels
    line, timings, what phases 26-35 reuse: the n = 8 context on the card
    and its proof, the 2^12 context, circuit, make_prover_bn254's prover,
    its proof for BN_CH and the verifying key)."""
    timings, errs, kms, bounds = {}, {}, {}, {}
    Fr = BigMontField(BN254_FR)
    Fq = BigMontField(BC.BN254_FQ)

    phase("9 K3 big_row vs plain at the 2^12 path's shapes")
    k3_inputs = k3_checks(dev, Fr, errs, bounds)

    phase("10 bn254_setup(2^12), window table, K4 big_commit vs plain")
    ctx, timings["bn_setup_s"] = wall(
        lambda: PB.bn254_setup(N_BN, secret=BN_SECRET, device=dev))
    tbl, timings["bn_table_build_s"] = wall(
        lambda: PB.bn254_fixed_base_table(ctx))
    packed = PB.bn254_packed_table(ctx)
    L = ctx.srs.length
    print(f"bn254_setup(2^12) {timings['bn_setup_s']:.3f} s, L = {L}; "
          f"window table {tuple(tbl.x.shape)} and its packed form "
          f"({packed.numel() * 4 / 1e6:.1f} MB) "
          f"{timings['bn_table_build_s']:.3f} s")
    ux, uy = BK.unpack_commit_table(packed)
    check(torch.equal(ux, tbl.x) and torch.equal(uy, tbl.y),
          "the packed table holds the table's words")
    del ux, uy
    report = ptxas_lines("big_commit")
    for line in report:
        print("  " + line)
    tiles = report[report.index(next(ln for ln in report
                                     if "big_commit_tiles" in ln)):]
    check(any("0 bytes spill stores" in ln for ln in tiles[:3]),
          "K4's tile kernel does not spill")
    print(f"big_commit_tiles SASS: "
          f"{sass_opcodes('big_commit_tiles', ('IMAD', 'IADD3', 'LDG'))}")
    check(L == N_BN + 5, "SRS length n + 5")
    rng = np.random.default_rng(1)
    sc = rng.integers(0, 1 << 16, size=(9, L, 16))
    sc[..., 15] &= 0x0FFF
    scalars = torch.as_tensor(sc, device=dev)
    got = BC.big_to_affine(Fq, BK.big_commit_many(Fq, tbl, scalars, packed))
    # the plain version is launch-bound (seconds): one synchronised call,
    # timed on the host clock, is both its check and its time
    plain, k4_plain_s = wall(
        lambda: BK.big_commit_many_plain(Fq, tbl, scalars))
    want = BC.big_to_affine(Fq, plain)
    err = affine_err(got, want)
    print(f"K4 B=9 L={L}: max_abs_err {err}")
    check(err == 0 and not bool(got[2].any()), "K4 affine-equal, B=9")
    bounds["big_commit"], terms, entries = big_commit_bound(tbl, scalars)
    # zero scalars; repeated, opposite (negated y) and infinity base points
    ks = rng.integers(1, 64, size=512)
    ks[5::50] = 0
    bits = np.stack([BC.scalar_to_bits(int(k), 6) for k in ks])
    pts = BC.big_jac_mul(Fq, BC.bn254_generator(Fq, (len(ks),), dev), bits,
                         6)
    neg = torch.zeros(len(ks), dtype=torch.bool, device=dev)
    neg[1::3] = True
    pts = pts._replace(Y=torch.where(neg[:, None], Fq.neg(pts.Y), pts.Y))
    edge_tbl = BC.build_big_table(Fq, pts, 4, 254)
    esc = rng.integers(0, 1 << 16, size=(3, len(ks), 16))
    esc[..., 15] &= 0x0FFF
    esc[0, ::4] = 0
    esc[1] = 0
    edge = torch.as_tensor(esc, device=dev)
    got = BC.big_to_affine(Fq, BK.big_commit_many(
        Fq, edge_tbl, edge, BK.pack_commit_table(edge_tbl)))
    want = BC.big_to_affine(Fq, BK.big_commit_many_plain(Fq, edge_tbl, edge))
    err2 = affine_err(got, want)
    print(f"K4 edge batch (zero rows, infinity/repeated/opposite bases): "
          f"max_abs_err {err2}, infinity rows {got[2].tolist()}")
    check(err2 == 0 and bool(got[2][1]), "K4 affine-equal, edge batch")
    errs["big_commit"] = max(err, err2)

    phase("11 n = 8 BN254 proof: GPU vs CPU port vs recorded JAX values")
    small = []
    sel8, cp8, a8, b8, c8 = bn254_mul_circuit(N_BN_SMALL)
    for d in ("cpu", dev):
        # each device computes its own SRS and window table under empty
        # caches of its own, and commits through the table, as the card
        # does by default (the CPU's default is GLV, phase 33's)
        own = os.path.join(CACHE_DIR, f"n8_{torch.device(d).type}")
        shutil.rmtree(own, ignore_errors=True)
        with switches(PLONK_TPU_BN254_FB="1", PLONK_TPU_CACHE=own,
                      HOME=own):
            c_ = PB.bn254_setup(N_BN_SMALL, secret=BN_SECRET, device=d)
            ctx8 = c_
            proof, diags = PB.make_prover_bn254(c_, sel8, cp8)(
                a8, b8, c8, words_vec(BN_CH), words_vec(BN_RND))
        check(bool(diags.all_ok()), f"n=8 diagnostics on {d}")
        small.append(proof)
    p_cpu, p_gpu = small
    check(EN.proofs_equal(p_cpu, p_gpu), "n=8 GPU proof equals CPU proof")
    for name, v in BN_ANCHOR_SCALARS.items():
        check(from_words(getattr(p_gpu, name).cpu()) == v, f"anchor {name}")
    for name, (x, y) in BN_ANCHOR_POINTS.items():
        pt = getattr(p_gpu, name)
        check(not bool(pt.inf) and from_words(pt.x.cpu()) == x
              and from_words(pt.y.cpu()) == y, f"anchor {name}")
    print(f"n=8 proof equal on GPU and CPU; {len(BN_ANCHOR_SCALARS)} scalars "
          f"and {len(BN_ANCHOR_POINTS)} points match the JAX values")

    phase("12 BN254 main path at 2^12 gates")
    sel, cp, a, b, c = bn254_mul_circuit(N_BN, seed=0)
    ch, rnd = words_vec(BN_CH), words_vec(BN_RND)
    prover, timings["bn_make_prover_s"] = wall(
        lambda: PB.make_prover_bn254(ctx, sel, cp))
    kernels.reset_counts()
    (proof, diags), timings["bn_first_proof_s"] = wall(
        lambda: prover(a, b, c, ch, rnd))
    launches = dict(kernels.LAUNCHES)
    print(f"make_prover_bn254 {timings['bn_make_prover_s']:.3f} s; first "
          f"proof {timings['bn_first_proof_s']:.3f} s; launches {launches}")
    check(bool(diags.all_ok()), f"2^12 diagnostics {diags}")
    for name in BN254_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} launched by the prove")
    # the proof's verify, and a tampered proof's rejection, are lanes of
    # phase 31's verify_bn254_many (the same G1 algebra and pairings)
    vk, timings["bn_vk_s"] = wall(lambda: PB.make_vk_bn254(ctx, sel, cp))
    print(f"diags.all_ok True; make_vk_bn254 {timings['bn_vk_s']:.3f} s")

    phase("13 BN254 timings")
    rnd_rep = lambda rep: words_vec([v + 100 + 9 * rep for v in BN_RND])
    t = time.perf_counter()
    for rep in range(BN_PROOF_REPS):
        _, d = prover(a, b, c, ch, rnd_rep(rep))
        check(bool(d.all_ok()), f"BN254 rep {rep} diagnostics")
    torch.cuda.synchronize()
    timings["bn_proofs_per_s"] = BN_PROOF_REPS / (time.perf_counter() - t)
    proof_s = 1 / timings["bn_proofs_per_s"]
    prims = PB._local_prims(ctx)
    pre = PB.precompute_bn254(ctx, sel, cp, prims)
    st = staged_proofs(
        PB, PB.prove_bn254, prims,
        lambda prove, pr, rep: prove(ctx, sel, cp, a, b, c, ch,
                                     rnd_rep(10 + rep), prims=pr,
                                     pre=pre)[1], BN_PROFILE_REPS)
    print(f"stages, mean of {BN_PROFILE_REPS} proofs with a synchronise "
          "around each stage (ms): " + ", ".join(
              f"{k} {v * 1e3:.3f}" for k, v in st.items()))
    n_dev, dev_us, prof_s, top = profiled_proofs(
        lambda rep: prover(a, b, c, ch, rnd_rep(20 + rep)), BN_PROFILE_REPS)
    print_profile(n_dev, dev_us, prof_s, top, proof_s, BN_PROFILE_REPS)
    if profile:
        pts_, pts_s = wall(lambda: PB._verify_points(ctx, vk, proof, ch))
        oks, pair_s = wall(lambda: PB._pairing_ratio_flags(ctx, *pts_))
        check(all(bool(o) for o in oks), "profiled BN254 verify accepts")
        print(f"BN254 verify split: G1 algebra {pts_s:.3f} s, pairing "
              f"checks {pair_s:.3f} s")
    kms.update(k3_times(Fr, k3_inputs))
    kern = lambda: BK.big_commit_many(Fq, tbl, scalars, packed)
    kms[f"big_commit B=9 L={L}"] = (
        cuda_ms(kern, reps=50, queue_ahead=True), k4_plain_s * 1e3,
        device_ms(kern))
    timings["bn_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"card: {card}")
    for key, v in timings.items():
        print(f"{key} {v:.6f}")
    print(f"K4 terms with a nonzero digit: {terms}; distinct table entries "
          f"they select: {entries}")
    print_kernel_times(kms)
    reuse = dict(ctx8=ctx8, proof8=p_gpu, ctx=ctx,
                 circuit=(sel, cp, a, b, c), prover=prover, proof=proof,
                 vk=vk)
    return (kernel_entries(BN254_KERNELS, kms, launches, errs, bounds),
            timings, reuse)


def kernel_entries(kernel_meta: dict, kms: dict, launches: dict,
                   errs: dict, bounds: dict, library: dict | None = None
                   ) -> list:
    """The kernels line's entries: for each kernel, its first timed case
    in `kms` (key "<name> <case>"), `ms` its CUDA-event time; `library`
    gives the library call's time of the kernels that have one."""
    out = []
    for name, meta in kernel_meta.items():
        k, pl, _ = next(v for key, v in kms.items()
                        if key.split(" ", 1)[0] == name)
        out.append(dict(name=name, **meta, launches=launches.get(name, 0),
                        max_abs_err=errs[name], ms=k,
                        plain_ms=pl, bound_ms=bounds[name][0],
                        bound_by=bounds[name][1],
                        library_ms=(library or {}).get(name)))
    return out


def onepass_args(Fr, y: torch.Tensor, w: int, inverse: bool) -> tuple:
    """The arguments of FN.onepass_ntt for the forward (or, with
    inverse, the scaled mirror) transform of y (nb, n1, n2), n = n1 n2 and
    w a root of order n, as fused_ntt_1k / fused_intt_1k pass them."""
    n = y.shape[1] * y.shape[2]
    return (Fr.p, Fr.n_prime, y,
            *FN.onepass_tables(Fr, w, n, inverse, y.device), inverse,
            Fr.const(pow(n, -1, Fr.p)) if inverse else None)


def k6_edge_checks(Fr, dev) -> int:
    """K6 against its plain version, word-equal, forward and scaled
    mirror: at (5, 512, 512) with matrices of zeros and of p - 1 beside
    random ones, and at nb = 1 on small shapes down to n1 = 1, all zeros
    or all p - 1. Returns
    the largest error (0)."""
    p = Fr.p
    gen = torch.Generator(device="cpu").manual_seed(4)
    worst = 0
    for nb, n, fill in ((5, 1 << 18, None), (1, 2, 0), (1, 2, p - 1),
                        (1, 8, 0), (1, 8, p - 1), (1, 64, p - 1),
                        (1, 1 << 11, 0), (1, 1 << 11, p - 1)):
        n1, n2 = FN._split(n)
        y = torch.randint(0, p, (nb, n1, n2), generator=gen)
        if fill is None:
            y[0], y[1] = 0, p - 1
        else:
            y.fill_(fill)
        for inverse in (False, True):
            args = onepass_args(Fr, y.to(dev), Fr.params.root_of_unity(n),
                                inverse)
            got = FN.onepass_ntt(*args)
            want = FN.onepass_plain(*args)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            what = "zeros and p - 1" if fill is None else f"all {fill}"
            print(f"onepass_ntt edge ({nb}, {n1}, {n2}) "
                  f"{'mirror' if inverse else 'forward'}, {what}: "
                  f"max_abs_err {err}")
            check(err == 0, f"K6 word-equal on edge input ({nb}, {n1}, {n2})")
            worst = max(worst, err)
    return worst


def onepass_split(p, n_prime, y, tw1, twm, tw2, mirror, scale) -> dict:
    """K6's passes timed apart: the launch with only its first pass, only
    its grid barrier, only its second pass, and whole, each by CUDA events
    over 100 launches queued behind a device delay. The second pass alone
    transforms whatever the output holds. These probe launches go around
    the wrapper and are not counted."""
    lib = kernels.library()
    nb, n1, n2 = y.shape
    out = torch.empty_like(y)
    stream = torch.cuda.current_stream(y.device).cuda_stream

    def run(passes):
        err = lib.onepass_ntt_launch(
            y.data_ptr(), tw1.data_ptr(), twm.data_ptr(), tw2.data_ptr(),
            out.data_ptr(), nb, n1, n2, int(mirror),
            0 if scale is None else scale, int(scale is not None), p,
            n_prime, passes, stream)
        check(err == 0, f"onepass_ntt probe launch (passes {passes})")

    first, second = (("row", "column") if mirror else ("column", "row"))
    return {name: cuda_ms(lambda m=mask: run(m), reps=100, queue_ahead=True)
            for name, mask in ((f"{first} pass alone", 1),
                               ("grid.sync alone", 2),
                               (f"{second} pass alone", 4), ("whole", 7))}


def print_split(name: str, split: dict) -> None:
    print(f"onepass_ntt {name} split (ms): " + ", ".join(
        f"{k} {v:.6f}" for k, v in split.items()))


# K5's kernels in the ptxas report (a substring of the mangled name): K1's
# kernel at C = 512 (S = 9), DIF and DIT
K5_ENTRY = "row_stages_kernelILi9E"


def k5_checks(Fr, dev, w: int, m: int, errs: dict) -> dict:
    """K5 against its plain version, word-equal, in both directions at the
    two row shapes of the m-point coset transforms under the fused prims
    (w a root of order m = n1 n2): (5 n2, n1), the passes over the 5-row
    proof stack, and (n1, n2), those over the quotient; on random rows and
    on edge rows (zeros, p - 1, first-stage partners lo = hi and
    hi = p - lo), each call one launch. Returns the four cases, name ->
    (arguments on random rows, bound), the proof's first: the forward's
    (5 n2, n1) DIF and the inverse's (n1, n2) DIT."""
    p = Fr.p
    n1, n2 = FN._split(m)
    rng = np.random.default_rng(5)
    timed = {}
    for what, R, C, w_row, proof_dif in (
            ("proof fwd", 5 * n2, n1, pow(w, n2, p), True),
            ("inverse", n1, n2, pow(pow(w, -1, p), n1, p), False)):
        tw = FN._row_tables(Fr, w_row, C, dev)
        for dif in (proof_dif, not proof_dif):
            name = (f"{what if dif == proof_dif else 'other direction'} "
                    f"({R}, {C}) {'DIF' if dif else 'DIT'}")
            for kind in ("random", "edge rows"):
                vals = (rng.integers(0, p, size=(R, C)) if kind == "random"
                        else edge_rows(p, R, C, rng, C // 2 if dif else 1))
                args = (p, Fr.n_prime, torch.as_tensor(vals, device=dev), tw,
                        dif)
                before = kernels.LAUNCHES["row_transform"]
                got = RS.row_transform(*args)
                want = RS.row_transform_plain(*args)
                torch.cuda.synchronize()
                check(kernels.LAUNCHES["row_transform"] == before + 1,
                      f"row_transform {name}: one launch per call")
                err = int((got - want).abs().max())
                print(f"row_transform {name}, {kind}: max_abs_err {err}")
                check(err == 0, f"K5 word-equal at {name}, {kind}")
                errs["row_transform"] = max(errs.get("row_transform", 0),
                                            err)
                if kind == "random":
                    timed[name] = (args, row_bound(R, C))
    return dict(sorted(timed.items(), key=lambda kv: "other" in kv[0]))


def mxu_prims_check(ctx, circuit, ref_proof):
    """Phase 15's mxu_prims: make_prover and a proof with the coset
    transforms' products in plain PyTorch; launches counted (no K7), peak
    memory of each, the proof equal to `ref_proof`. Returns the prover."""
    sel, cp, a, b, c = circuit
    mems = []
    counts = []
    for step in ("make_prover", "proof"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        kernels.reset_counts()
        if step == "make_prover":
            prover, make_s = wall(lambda: PS.make_prover(
                ctx, sel, cp, prims=PS.mxu_prims()))
        else:
            (proof, diags), first_s = wall(lambda: prover(a, b, c, CH, RND))
        counts.append(dict(kernels.LAUNCHES))
        mems.append((torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30)
    print(f"mxu_prims: make_prover {make_s:.3f} s, launches {counts[0]}, "
          f"peak {mems[0]:.6f} GiB above what was allocated before; first "
          f"proof {first_s:.3f} s, launches {counts[1]}, peak "
          f"{mems[1]:.6f} GiB above")
    check(counts == [{"row_stages": 1},
                     {"row_stages": 2, "commit_many": 1}],
          "mxu precompute and proof launches (no K7)")
    check(bool(diags.all_ok()), f"mxu 2^16 diagnostics {diags}")
    check(EN.proofs_equal(proof, ref_proof),
          "mxu proof equals the default prims' proof")
    return prover


def prims_phases(dev, card: str, ctx, circuit, ref_proof, ref_prover):
    """Phases 14-16: the fused, onepass and mxu2 prims at 2^16 gates on the
    scaled context `ctx`, against the default prims' `ref_proof` of the
    same inputs (made by `ref_prover`); returns the kernel entries."""
    Fr = ctx.Fr
    p = Fr.p
    m = ctx.domain8
    n1, n2 = FN._split(m)
    w8 = ctx.omega8()
    w8i = pow(w8, -1, p)
    gen = torch.Generator(device="cpu").manual_seed(3)

    def rand(*shape):
        return torch.randint(0, p, shape, generator=gen).to(dev)

    phase("14 K5 row_transform, K6 onepass_ntt, K7 mont_matmul vs plain at "
          "the 2^18 coset transforms' shapes")
    errs, bounds, cases = {}, {}, {}
    ptxas_report(K5_ENTRY)
    k5_args = {}
    for name, (args, bnd) in k5_checks(Fr, dev, w8, m, errs).items():
        if name.startswith("other"):
            continue                    # timed by --kernels
        k5_args[name] = args
        cases["row_transform", name] = (
            lambda a=args: RS.row_transform(*a),
            lambda a=args: RS.row_transform_plain(*a), bnd)
    # K6: the per-proof forward stack and the inverse of the quotient
    k6_args = {}
    for name, nb, inverse in (("proof fwd (5, 512, 512)", 5, False),
                              ("inverse (1, 512, 512) scaled", 1, True)):
        args = onepass_args(Fr, rand(nb, n1, n2), w8, inverse)
        k6_args[name] = args
        cases["onepass_ntt", name] = (
            lambda a=args: FN.onepass_ntt(*a),
            lambda a=args: FN.onepass_plain(*a),
            onepass_bound(nb, n1, n2, inverse))
    # K7: the forward's first product (twiddle fused) over the proof stack,
    # and the inverse's first product; L = 4 limb planes for the 27-bit r;
    # then the forward's product with every word p - 1 (its s32 buckets
    # near their largest)
    L = MX._n_limbs(p)
    for name, R, C, w_mat, tw, x in (
            (f"proof fwd (2560, 512) x ({L}, 512, 512) with twiddle",
             5 * n2, n1, pow(w8, n2, p),
             MX._tw_on(Fr, w8, n1, n2, False, dev), None),
            (f"inverse (512, 512) x ({L}, 512, 512)", n1, n2,
             pow(w8i, n1, p), None, None),
            (f"worst case (2560, 512) x ({L}, 512, 512), words p - 1",
             5 * n2, n1, pow(w8, n2, p),
             MX._tw_on(Fr, w8, n1, n2, False, dev),
             torch.full((5 * n2, n1), p - 1, device=dev))):
        limbs = MX._limbs_on(p, w_mat, C, dev)
        wk = MX._kmajor_on(p, w_mat, C, dev)
        x = rand(R, C) if x is None else x
        K = limbs.shape[2]
        cases["mont_matmul", name] = (
            lambda a=(Fr, x, wk, tw): MX.mont_matmul(*a),
            lambda a=(Fr, x, limbs, tw): MX._mont_mat_transform(*a),
            mont_matmul_bound(R, C, K, L, 0 if tw is None else tw.shape[0]))
    ptxas_report("onepass_kernel")
    for line in ptxas_lines("mont_matmul"):
        print("  " + line)
    sass = sass_opcodes("mont_matmul", ("IGMMA", "IMAD"))
    print(f"mont_matmul SASS: {sass}")
    check(sass["IGMMA"] > 0, "mont_matmul issues int8 warpgroup "
          "tensor-core instructions (IGMMA)")
    for (kname, name), (kern, plain, bnd) in cases.items():
        before = kernels.LAUNCHES[kname]
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[kname] == before + 1,
              f"{kname} {name}: one launch per call")
        err = int((got - want).abs().max())
        print(f"{kname} {name}: max_abs_err {err}")
        check(err == 0, f"{kname} word-equal at {name}")
        errs[kname] = max(errs.get(kname, 0), err)
        bounds.setdefault(kname, bnd)
    errs["onepass_ntt"] = max(errs["onepass_ntt"], k6_edge_checks(Fr, dev))
    for name, args in k6_args.items():
        print_split(name, onepass_split(*args))

    phase("15 precompute_circuit and a 2^16 proof under the fused, onepass, "
          "mxu2 and mxu prims")
    sel, cp, a, b, c = circuit
    provers = {"default": ref_prover}
    launches = {}
    for name, (kname, per_proof, per_pre) in PRIMS.items():
        kernels.reset_counts()
        prover, make_s = wall(lambda: PS.make_prover(
            ctx, sel, cp, prims=getattr(PS, f"{name}_prims")()))
        pre = dict(kernels.LAUNCHES)
        kernels.reset_counts()
        (proof, diags), first_s = wall(lambda: prover(a, b, c, CH, RND))
        counts = dict(kernels.LAUNCHES)
        print(f"{name}_prims: make_prover {make_s:.3f} s, launches {pre}; "
              f"first proof {first_s:.3f} s, launches {counts}")
        check(pre == {"row_stages": 1, kname: per_pre},
              f"{name} precompute launches")
        check(counts == {"row_stages": 2, kname: per_proof, "commit_many": 1},
              f"{name} proof launches")
        check(bool(diags.all_ok()), f"{name} 2^16 diagnostics {diags}")
        check(EN.proofs_equal(proof, ref_proof),
              f"{name} proof equals the default prims' proof")
        launches[kname] = counts[kname]
        provers[name] = prover
    provers["mxu"] = mxu_prims_check(ctx, circuit, ref_proof)
    print("each prims' 2^16 proof passes diags.all_ok() and equals the "
          "default prims' proof")

    phase("16 proofs/s of the five prims in turns, kernel times")
    total = collections.Counter()
    for rep in range(TURN_REPS):
        rnd = [v + 50 + 9 * rep for v in RND]
        for name, prover in provers.items():
            (_, d), sec = wall(lambda: prover(a, b, c, CH, rnd))
            check(bool(d.all_ok()), f"{name} rep {rep} diagnostics")
            total[name] += sec
    kms = {f"{kname} {name}": kernel_times(kern, plain)
           for (kname, name), (kern, plain, _) in cases.items()}
    print(f"card: {card}")
    for name in provers:
        print(f"proofs_per_s {name} {TURN_REPS / total[name]:.6f} "
              f"({TURN_REPS} synchronised proofs, in turns)")
    print_kernel_times(kms)
    for (kname, name), (_, _, bnd) in cases.items():
        floor = ""
        if kname in ("onepass_ntt", "row_transform"):
            y = (k6_args[name] if kname == "onepass_ntt"
                 else k5_args[name])[2]
            floor = f"; int64 floor {int64_floor_ms(2 * y.numel()):.6f} ms"
        print(f"{kname} {name}: bound {bnd[0]:.6f} ms ({bnd[1]}){floor}")
    print(f"mont_matmul at the IMAD rate (32x32->64 products): "
          f"{bounds['mont_matmul'][2]:.6f} ms")
    return kernel_entries(PRIMS_KERNELS, kms, launches, errs, bounds)


D_MESH = 8
DIST_KERNELS = {
    "all_gather": dict(route="cuda",
                       source="plonk_tpu_torch/csrc/collectives.cu",
                       replaces="plonk_tpu/parallel/pallas_collectives.py:41"),
    "all_to_all": dict(route="cuda",
                       source="plonk_tpu_torch/csrc/collectives.cu",
                       replaces="plonk_tpu/parallel/pallas_collectives.py:"
                                "143"),
}
# launches of one prove_scaled with the sharded prims on D_MESH shards,
# precompute inside: 3 all-to-alls per interpolation (3 of them) and 2 per
# coset transform (3), one K8 (the grand product's prefix scan, which
# gathers the shard totals), one commit per shard
DIST_LAUNCHES = {"cuda": {"all_to_all": 15, "all_gather": 1,
                          "commit_many": D_MESH},
                 "plain": {"commit_many": D_MESH}}


def dist_cases(n: int, m: int):
    """(kernel, case name, shard shape, split axis, concat axis) of every
    all-to-all the sharded 2^16 proof makes on D_MESH shards: the
    transposes of the m-point coset transforms (batches 5, 10 and none;
    the first is the per-proof forward stack) and of the n-point
    interpolations (batches 9, 3 and none), both ways. Its one other
    exchange, the grand product's totals, runs inside K8's prefix scan
    (scan_checks)."""
    cases = []
    for size, batches in ((m, (5, 10, None)), (n, (9, 3, None))):
        r1, r2 = DN._split(size, D_MESH)
        for b in batches:
            lead = () if b is None else (b,)
            k = len(lead)
            for shape, split, concat in (
                    (lead + (r1 // D_MESH, r2), k + 1, k),
                    (lead + (r1, r2 // D_MESH), k, k + 1)):
                cases.append(("all_to_all", f"{shape} split {split} concat "
                              f"{concat}", shape, split, concat))
    return cases


EDGE_CASES = [  # (kernel, name, shards, shard shape, split, concat)
    ("all_to_all", "one shard (3, 7)", 1, (3, 7), 1, 0),
    ("all_to_all", "odd rows (3, 8, 5)", D_MESH, (3, 8, 5), 1, 2),
    ("all_gather", "one word (1,)", D_MESH, (1,), None, None),
    ("all_gather", "one shard (7,)", 1, (7,), None, None),
    ("all_gather", "odd rows (3, 5)", D_MESH, (3, 5), None, None),
    ("all_gather", "(64, 512)", D_MESH, (64, 512), None, None),
]
SCAN_M = N_MAIN // D_MESH   # words a shard of the sharded grand product


def exchange_bound(name: str, D: int, shard_numel: int):
    """K8's and K9's least time: the values (4 bytes per 31-bit word, the
    prover's data) read once and written once; no arithmetic. K9 reads and
    writes D shards; K8 reads D shards and writes D*D."""
    out = D * shard_numel * (D if name == "all_gather" else 1)
    return bound_ms((D * shard_numel + out) * WORD_BYTES, 0)


def scan_bound(D: int, m: int):
    """K8's prefix scan on D shards of m words: the words read once and
    written once and the D*D gathered totals written (4 bytes a 31-bit
    word); two Montgomery products a word (the serial scan and the
    prefix)."""
    return bound_ms((2 * D * m + D * D) * WORD_BYTES,
                    2 * D * m * MONT31_IMAD)


def scan_checks(dev, F, errs: dict, tested: set):
    """Phase 17's check of K8 on the path: dist_scan through the kernel
    against its plain version, word-equal, on D_MESH shards of SCAN_M
    words, random and edge words (SY.edge_scan_words), inclusive and
    shifted (dist_grand_product's form), the scan and the gathered totals,
    every word in [0, p), one launch a call. Returns (the mesh, the random
    shards)."""
    p = F.p
    mesh = MS.make_1d_mesh("sp", D_MESH, device=dev)
    rng = np.random.default_rng(19)
    shards = {}
    for name, words in (
            ("random", rng.integers(0, p, size=D_MESH * SCAN_M)),
            ("edge", SY.edge_scan_words(p, D_MESH, SCAN_M, rng))):
        xs = [torch.as_tensor(c, device=dev)
              for c in np.split(words, D_MESH)]
        shards[name] = xs
        for shifted in (False, True):
            before = kernels.LAUNCHES["all_gather"]
            got, tot = DS.dist_scan(F, mesh, xs, exchange="cuda",
                                    shifted=shifted)
            want, want_tot = DS.dist_scan(F, mesh, xs, exchange="plain",
                                          shifted=shifted)
            torch.cuda.synchronize()
            form = "shifted" if shifted else "inclusive"
            check(kernels.LAUNCHES["all_gather"] == before + 1,
                  f"prefix scan {name} {form}: one launch a call")
            err = max(int((g - w).abs().max()) for g, w in
                      zip(got + tot, want + want_tot, strict=True))
            canonical = all(bool(((g >= 0) & (g < p)).all())
                            for g in got + tot)
            print(f"prefix scan {name} {form} on {D_MESH} x {SCAN_M}: "
                  f"max_abs_err {err}, words in [0, p) {canonical}")
            check(err == 0 and canonical,
                  f"prefix scan word-equal, {name} {form}")
            errs["all_gather"] = max(errs.get("all_gather", 0), err)
    tested.add(("prefix_scan", D_MESH, SCAN_M))
    return mesh, shards["random"]


def fresh_events(mode: str) -> dict:
    """The --dist-events reading of `mode` from a fresh process (whose
    first torch.profiler run records the library's launches)."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--dist-events", mode],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, f"--dist-events {mode}: "
          f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def scan_times(F, mesh, xs):
    """K8 on the path at D_MESH x SCAN_M, as dist_grand_product: the
    kernel's device ms by CUDA events over 100 calls queued behind a device
    delay and its host µs a call; the plain version's device ms over 3
    calls back to back and its host µs a call; the device events and
    device ms a call of each under torch.profiler in a fresh process.
    Returns the kernel_times entry."""
    kern = lambda: DS.dist_grand_product(F, mesh, xs, exchange="cuda")
    plain = lambda: DS.dist_grand_product(F, mesh, xs, exchange="plain")
    k_ms, k_us = timed_calls(kern, reps=100, queue_ahead=True)
    p_ms, p_us = timed_calls(plain, reps=3)
    ev = {mode: fresh_events(f"scan-{mode}") for mode in ("cuda", "plain")}
    bnd = scan_bound(D_MESH, SCAN_M)
    print(f"all_gather prefix scan {D_MESH} x {SCAN_M} (dist_grand_product):"
          f" kernel {k_ms:.6f} ms device, {k_us:.1f} us host per call (CUDA"
          f" events, queued ahead); plain {p_ms:.6f} ms, {p_us:.1f} us host"
          " per call (back to back); torch.profiler in a fresh process: "
          + "; ".join(f"{mode} {e['events']:.2f} device events and "
                      f"{e['device_ms']:.6f} ms per call"
                      for mode, e in ev.items())
          + f"; bound {bnd[0]:.6f} ms ({bnd[1]})")
    return k_ms, p_ms, (ev["cuda"]["events"], ev["cuda"]["device_ms"])


def scan_shapes(F, dev) -> None:
    """K8's prefix scan (CL.prefix_scan, shifted) alone at a few shard
    counts and lengths, device ms by CUDA events over 100 calls queued
    behind a device delay: what the launch, the look-back and the scan
    each add."""
    gen = torch.Generator(device="cpu").manual_seed(23)
    for D, m in ((1, 1), (8, 1), (16, 1), (1, SCAN_M), (8, SCAN_M),
                 (16, SCAN_M), (8, 8 * SCAN_M)):
        xs = [torch.randint(0, F.p, (m,), generator=gen).to(dev)
              for _ in range(D)]
        ms = cuda_ms(lambda: CL.prefix_scan(xs, F.p, F.n_prime, F.r_mod_p,
                                            True), reps=100, queue_ahead=True)
        print(f"prefix scan kernel at {D} x {m}: {ms:.6f} ms (CUDA events, "
              f"queued ahead); bound {scan_bound(D, m)[0]:.6f} ms")


def dist_events(dev, mode: str) -> None:
    """--dist-events MODE: in this fresh process, the device events and
    device ms a call under torch.profiler of scan-cuda / scan-plain
    (dist_grand_product on D_MESH shards of SCAN_M random words, 20 calls)
    or proof-cuda / proof-plain (a 2^16 proof under the sharded prims,
    precompute done before, PROFILE_REPS proofs, then proofs/s over
    PROOF_REPS synchronised proofs); prints one JSON line."""
    kind, exchange = mode.split("-")
    F = MontField(SCALED_FR)
    mesh = MS.make_1d_mesh("sp", D_MESH, device=dev)
    out = {"mode": mode}
    if kind == "scan":
        gen = torch.Generator(device="cpu").manual_seed(19)
        xs = [torch.randint(0, F.p, (SCAN_M,), generator=gen).to(dev)
              for _ in range(D_MESH)]
        run = lambda rep: DS.dist_grand_product(F, mesh, xs,
                                                exchange=exchange)
        reps = 20
    else:
        ctx = PS.scaled_new(N_MAIN, device=dev)
        sel, cp, a, b, c = square_chain_circuit(ctx.params.field.p, N_MAIN)
        prims = DP.make_dist_prims(ctx, mesh, exchange=exchange)
        pre = PS.precompute_circuit(ctx, sel, cp, prims)

        def run(rep):
            _, d = PS.prove_scaled(ctx, sel, cp, a, b, c, CH,
                                   [v + 9 * rep for v in RND], prims=prims,
                                   pre=pre)
            check(bool(d.all_ok()), f"{mode} rep {rep} diagnostics")
        reps = PROFILE_REPS
    run(0)
    torch.cuda.synchronize()
    n_ev, dev_us, wall_s, _ = profiled_proofs(run, reps)
    out.update(events=n_ev, device_ms=dev_us / 1e3,
               profiled_ms=wall_s * 1e3)
    if kind == "proof":
        _, sec = wall(lambda: [run(1 + rep) for rep in range(PROOF_REPS)])
        out["proofs_per_s"] = PROOF_REPS / sec
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps(out))


def exchange_call(name: str, xs, split, concat, exchange):
    """The whole collective on shards xs: CL.all_gather or CL.all_to_all."""
    if name == "all_gather":
        return lambda: CL.all_gather(xs, exchange)
    return lambda: CL.all_to_all(xs, split, concat, exchange)


def exchange_only(name: str, xs, split, exchange):
    """The exchange alone, into destinations made once; for K9 from
    sources relaid out once to D contiguous chunks each (the split axis
    leading), as all_to_all_into takes them."""
    D = len(xs)
    if name == "all_gather":
        dsts = [torch.empty(D * x.numel(), dtype=x.dtype, device=x.device)
                for x in xs]
        return lambda: CL.all_gather_into(xs, dsts, exchange)
    srcs = [torch.movedim(x, split, 0).reshape(D, -1).contiguous()
            for x in xs]
    dsts = [torch.empty_like(x) for x in srcs]
    return lambda: CL.all_to_all_into(srcs, dsts, exchange)


def exchange_checks(dev, p: int, n: int, m: int, errs: dict):
    """Phase 17's checks: K8 and K9 against their plain versions,
    word-equal, at every exchange shape of the sharded proof of n gates
    (m-point coset) on D_MESH shards and at EDGE_CASES, each call one
    launch. Returns (the D_MESH cases to time, (kernel, name) -> (shards,
    split, concat); the bound of each kernel's first case; the (kernel,
    shards, shard words) checked)."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    bounds, timed, tested = {}, {}, set()
    cases = [(k, nm, D_MESH, sh, sp, ct) for k, nm, sh, sp, ct in
             dist_cases(n, m)]
    for kname, name, D, shape, split, concat in cases + EDGE_CASES:
        xs = [torch.randint(0, p, shape, generator=gen).to(dev)
              for _ in range(D)]
        before = kernels.LAUNCHES[kname]
        got = exchange_call(kname, xs, split, concat, "cuda")()
        want = exchange_call(kname, xs, split, concat, "plain")()
        torch.cuda.synchronize()
        check(kernels.LAUNCHES[kname] == before + 1,
              f"{kname} {name}: one launch per call")
        err = max(int((g - w).abs().max()) for g, w in zip(got, want,
                                                           strict=True))
        print(f"{kname} {name} on {D} shards: max_abs_err {err}")
        check(err == 0, f"{kname} word-equal at {name}")
        errs[kname] = max(errs.get(kname, 0), err)
        numel = int(np.prod(shape))
        tested.add((kname, D, numel))
        if D == D_MESH:
            bounds.setdefault(kname, exchange_bound(kname, D, numel))
            timed.setdefault((kname, name), (xs, split, concat))
    return timed, bounds, tested


def a2a_times(timed: dict):
    """K9 at each D_MESH shape of `timed`: the kernel alone
    (exchange_only, 100 calls) and the whole CL.all_to_all call through
    K9 (40 calls) and through plain copies (20 calls), device ms by CUDA
    events over calls queued behind a device delay, host µs per call
    enqueued; the plain whole call back to back; each shape's bound and
    int64 floor. Returns (kernel_times entries of the whole call, keyed
    "all_to_all <case>"; the plain whole call's queued ms of the first
    case)."""
    kms, library = {}, None
    for (kname, name), (xs, split, concat) in timed.items():
        if kname != "all_to_all":
            continue
        alone = cuda_ms(exchange_only(kname, xs, split, "cuda"), reps=100,
                        queue_ahead=True)
        whole = exchange_call(kname, xs, split, concat, "cuda")
        plain = exchange_call(kname, xs, split, concat, "plain")
        w_ms, w_us = timed_calls(whole, reps=40, queue_ahead=True)
        p_ms, p_us = timed_calls(plain, reps=20, queue_ahead=True)
        kms[f"{kname} {name}"] = (w_ms, cuda_ms(plain, reps=3),
                                  device_ms(whole))
        library = p_ms if library is None else library
        numel = xs[0].numel()
        print(f"{kname} {name}: kernel alone {alone:.6f} ms; whole call "
              f"{w_ms:.6f} ms device, {w_us:.1f} us host per call; plain "
              f"whole call {p_ms:.6f} ms device, {p_us:.1f} us host per "
              f"call (CUDA events, queued ahead); bound "
              f"{exchange_bound(kname, D_MESH, numel)[0]:.6f} ms (bytes); "
              f"int64 floor {int64_floor_ms(2 * D_MESH * numel):.6f} ms")
    return kms, library


def gather_times(timed: dict) -> dict:
    """K8's generic all-gather (CL.all_gather_into) at each D_MESH shape
    of `timed`: kernel_times against the plain exchange, and the plain
    exchange's device ms over 20 calls queued behind a device delay (its
    8 PyTorch launches a destination take the host ~0.5-1.5 ms a call);
    with each shape's bound. Returns the kernel_times entries, keyed
    "all_gather <case>"."""
    kms = {}
    for (kname, name), (xs, split, _) in timed.items():
        if kname != "all_gather":
            continue
        plain = exchange_only(kname, xs, split, "plain")
        kms[f"{kname} {name}"] = kernel_times(
            exchange_only(kname, xs, split, "cuda"), plain)
        lib = cuda_ms(plain, reps=20, queue_ahead=True)
        print(f"{kname} {name}: plain exchange {lib:.6f} ms (CUDA events, "
              f"queued ahead); bound "
              f"{exchange_bound(kname, D_MESH, xs[0].numel())[0]:.9f} ms "
              "(bytes)")
    return kms


def dist_phases(dev, card: str, ctx, circuit, ref_proof, ref_prover, vk):
    """Phases 17-19: K8 and K9 against their plain versions, then the 2^16
    proof under the sharded prims on D_MESH shards of the card, against
    the default prims' `ref_proof` of phase 6 (made by `ref_prover`, with
    verifying key `vk`); returns the kernel entries."""
    Fr = ctx.Fr
    sel, cp, a, b, c = circuit

    phase("17 K8 (the grand product's prefix scan and all_gather) and K9 "
          "all_to_all vs plain at the 2^16 sharded path's shapes")
    errs = {}
    timed, bounds, tested = exchange_checks(dev, Fr.p, ctx.n, ctx.domain8,
                                            errs)
    scan_mesh, scan_xs = scan_checks(dev, Fr, errs, tested)
    bounds["all_gather"] = scan_bound(D_MESH, SCAN_M)

    phase("18 a 2^16 proof under the sharded prims on 8 shards of the card")
    mesh = MS.make_1d_mesh("sp", D_MESH, device=dev)
    seen = set()
    launch, scan = CL._launch, DS.prefix_scan

    def recorded(name, srcs, *rest):
        seen.add((name, len(srcs), srcs[0].numel()))
        return launch(name, srcs, *rest)

    def recorded_scan(shards, *rest):
        seen.add(("prefix_scan", len(shards), shards[0].numel()))
        return scan(shards, *rest)

    provers = {"default": lambda ch, rnd: ref_prover(a, b, c, ch, rnd)}
    launches = {}
    for exchange in ("cuda", "plain"):
        prims = DP.make_dist_prims(ctx, mesh, exchange=exchange)
        CL._launch, DS.prefix_scan = recorded, recorded_scan
        kernels.reset_counts()
        try:
            (proof, diags), first_s = wall(lambda: PS.prove_scaled(
                ctx, sel, cp, a, b, c, CH, RND, prims=prims))
        finally:
            CL._launch, DS.prefix_scan = launch, scan
        counts = dict(kernels.LAUNCHES)
        print(f"sharded {exchange}: prove_scaled with precompute "
              f"{first_s:.3f} s, launches {counts}")
        check(counts == DIST_LAUNCHES[exchange],
              f"sharded {exchange} launches {counts}")
        check(bool(diags.all_ok()), f"sharded {exchange} diagnostics {diags}")
        check(EN.proofs_equal(proof, ref_proof),
              f"sharded {exchange} proof equals phase 6's proof")
        if exchange == "cuda":
            launches = counts
            ok, verify_s = wall(lambda: PS.verify_scaled(ctx, vk, proof, CH))
            bad = proof._replace(r_z=(proof.r_z + 1) % Fr.p)
            rejected = not PS.verify_scaled(ctx, vk, bad, CH)
            print(f"verify {ok} ({verify_s:.3f} s); tampered r_z rejected "
                  f"{rejected}")
            check(ok and rejected, "sharded proof verifies, tampered "
                  "rejected")
        pre = PS.precompute_circuit(ctx, sel, cp, prims)
        provers[f"sharded-{exchange}"] = (
            lambda ch, rnd, pr=prims, pre=pre: PS.prove_scaled(
                ctx, sel, cp, a, b, c, ch, rnd, prims=pr, pre=pre))
    check(seen <= tested, f"every exchange of the proof checked in phase "
          f"17: {sorted(seen - tested)}")
    print(f"both sharded proofs equal phase 6's proof; {len(seen)} "
          "exchange shapes, each checked in phase 17 (device events of a "
          "sharded proof: --dist-events proof-cuda|proof-plain)")

    phase("19 proofs/s of the default and sharded prims in turns, kernel "
          "times")
    total = collections.Counter()
    for rep in range(TURN_REPS):
        rnd = [v + 70 + 9 * rep for v in RND]
        for name, prover in provers.items():
            (_, d), sec = wall(lambda: prover(CH, rnd))
            check(bool(d.all_ok()), f"{name} rep {rep} diagnostics")
            total[name] += sec
    kms = {"all_gather prefix scan": scan_times(Fr, scan_mesh, scan_xs)}
    a2a_kms, a2a_library = a2a_times(timed)
    kms.update(a2a_kms)
    kms.update(gather_times(timed))
    print(f"card: {card}")
    for name in provers:
        print(f"proofs_per_s {name} {TURN_REPS / total[name]:.6f} "
              f"({TURN_REPS} synchronised proofs, in turns)")
    print_kernel_times(kms)
    return kernel_entries(DIST_KERNELS, kms, launches, errs, bounds,
                          {"all_to_all": a2a_library})


def lanes(x, sl):
    """The lanes `sl` of a batched proof or diagnostics (tuples of tensors
    or of points)."""
    if isinstance(x, torch.Tensor):
        return x[sl]
    return type(x)(*(lanes(v, sl) for v in x))


def diags_equal(d, e) -> bool:
    return all(torch.equal(u.cpu(), v.cpu()) for u, v in zip(d, e))


def toy_tail_ok(proof, lane=None) -> bool:
    pick = (lambda t: t) if lane is None else (lambda t: t[lane])
    return all(int(pick(getattr(proof, f))) == v for f, v in TOY_TAIL.items())


def toy_lanes(B: int):
    """Phase 21's inputs: the canonical witness in every lane, per-lane
    challenges and blinding in F_17 from TOY_SEED, lane 0 canonical."""
    rng = np.random.default_rng(TOY_SEED)
    chs = rng.integers(0, 17, size=(B, 5))
    rnds = rng.integers(0, 17, size=(B, 9))
    chs[0], rnds[0] = TP.CANONICAL_CHALLENGE, TP.CANONICAL_RAND
    asg = TP.canonical_assignments()
    wires = [np.tile(w, (B, 1)) for w in (asg.a, asg.b, asg.c)]
    return wires + [chs, rnds]


def toy_phases(dev, card: str) -> None:
    """Phases 20-21: the toy "PLONK by hand" prover on the card (F_17
    scalars, F_101 coordinates, n = 4), then its batched prover at
    TOY_BATCH proofs. The toy path launches none of K1-K9: its NTT is the
    n = 4 reshape butterfly and its commitments are ladders, table
    gathers or Pippenger buckets in PyTorch."""
    phase("20 the toy canonical proof on the card: golden, both dialects, "
          "three commit modes, verify, CPU equality")
    cons, asg = TP.canonical_constraints(), TP.canonical_assignments()
    ch, rnd = TP.CANONICAL_CHALLENGE, TP.CANONICAL_RAND
    for mode, kw in TOY_MODES.items():
        out = {}
        for d in ("cpu", dev):
            ref_ctx = TP.canonical_context(device=d, **kw)
            fix_ctx = TP.canonical_context(srs_mode="fixed", device=d, **kw)
            ref = PL.prove(ref_ctx, cons, asg, ch, rnd)
            std = PL.prove(fix_ctx, cons, asg, ch, rnd, dialect="standard")
            out[d] = (ref, std, fix_ctx)
        (ref, std, _), (gref, gstd, gctx) = out["cpu"], out[dev]
        check(EN.proofs_equal(ref[0], gref[0]) and diags_equal(ref[1], gref[1])
              and EN.proofs_equal(std[0], gstd[0])
              and diags_equal(std[1], gstd[1]),
              f"toy {mode}: the card's proofs equal the CPU port's")
        check(bool(gref[1].all_ok()) and bool(gstd[1].all_ok()),
              f"toy {mode} diagnostics")
        check(all(bool(getattr(gref[0], f).inf) for f in PL.POINT_FIELDS)
              and toy_tail_ok(gref[0]),
              f"toy {mode}: nine commitments at infinity and the golden "
              "tail")
        vk, vk_s = wall(lambda: TV.make_verification_key(gctx, cons))
        ok, verify_s = wall(lambda: TV.verify(gctx, vk, gstd[0], ch))
        bad = gstd[0]._replace(r_z=(gstd[0].r_z + 1) % 17)
        rejected = not TV.verify(gctx, vk, bad, ch)
        check(ok and rejected, f"toy {mode}: verify accepts, tampered r_z "
              "rejected")
        print(f"{mode}: reference proof golden (r_z "
              f"{int(gref[0].r_z)}), standard proof on the fixed SRS "
              f"verifies ({verify_s:.3f} s, key {vk_s:.3f} s), tampered "
              f"r_z rejected, card == CPU")

    phase(f"21 the batched toy prover at B = {TOY_BATCH}: golden lane 0, "
          f"the first {TOY_CPU_LANES} lanes vs the CPU port, 8 shards")
    sel, cp = constraints_to_tensors(cons)
    ctx = TP.canonical_context(srs_mode="fixed", device=dev)
    prover = TB.make_batched_prover(ctx, sel, cp)
    args = toy_lanes(TOY_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    kernels.reset_counts()
    (proofs, diags), first_s = wall(lambda: prover(*args))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"first batch {first_s:.6f} s; launches of K1-K9 {launches}; "
          f"peak memory {peak / 2 ** 30:.6f} GiB, "
          f"{(peak - base_mem) / 2 ** 30:.6f} GiB above what was allocated "
          "before the batch")
    check(not launches, f"the toy path launches no kernel: {launches}")
    single, single_d = PL.prove(ctx, cons, asg, ch, rnd)
    check(toy_tail_ok(proofs, 0) and bool(single_d.all_ok())
          and EN.proofs_equal(lanes(proofs, 0), single)
          and diags_equal(lanes(diags, 0), single_d),
          "lane 0 has the golden tail and equals the single proof")
    cpu_ctx = TP.canonical_context(srs_mode="fixed", device="cpu")
    head = [a[:TOY_CPU_LANES] for a in args]
    cpu = TB.make_batched_prover(cpu_ctx, sel, cp)(*head)
    sl = slice(0, TOY_CPU_LANES)
    check(EN.proofs_equal(lanes(proofs, sl), cpu[0])
          and diags_equal(lanes(diags, sl), cpu[1]),
          f"the first {TOY_CPU_LANES} lanes equal the CPU port's")
    mesh = MS.make_1d_mesh("dp", D_MESH, device=dev)
    sharded, sharded_s = wall(lambda: TB.make_sharded_prover(
        ctx, sel, cp, mesh)(*args))
    check(EN.proofs_equal(sharded[0], proofs)
          and diags_equal(sharded[1], diags),
          "the sharded prover equals the batched prover")
    ok = torch.stack(list(diags)).all(0)
    failed = {f: int((~getattr(diags, f)).sum()) for f in diags._fields}
    print(f"lane 0 golden; {TOY_CPU_LANES} lanes equal the CPU port's; "
          f"{D_MESH} shards equal the batch ({sharded_s:.6f} s); "
          f"{int(ok.sum())} of {TOY_BATCH} lanes have every diagnostic ok; "
          f"lanes failing each (kept, as the reference prover's asserts "
          f"would stop there): {failed}")
    print(f"card: {card}")
    for B, reps in TOY_TIMED.items():
        sub = [a[:B] for a in args]
        wall(lambda: prover(*sub))                     # warm-up
        secs = [wall(lambda: prover(*sub))[1] for _ in range(reps)]
        print(f"toy proofs_per_s B={B} {B * reps / sum(secs):.6f} "
              f"({reps} synchronised batches, host clock; seconds a batch "
              f"{' '.join(f'{x:.6f}' for x in secs)})")
        if B in (1, TOY_BATCH):
            n_ev, dev = device_ms(lambda: prover(*sub), reps=1)
            batch_ms = sum(secs) / reps * 1e3
            idle = "not measured" if dev is None else \
                f"{1 - dev / batch_ms:.4f}"
            dev_s = "no" if dev is None else f"{dev:.6f}"
            print(f"toy B={B} under torch.profiler: {n_ev:.0f} device "
                  f"events and {dev_s} ms of device time a batch; device "
                  f"idle share against the mean batch above {idle}")


FS_REPS = 1              # synchronised proofs of each prover, in turns
MANY_B = 4               # lanes of phase 24's verify_scaled_many
DIGEST_HOST_M = 1 << 12  # public inputs digested by the host oracle
CACHE_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "plonk_tpu_cache")
HOME_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "plonk_tpu_home")


def fs_launches(launches: dict, nonce: int) -> bool:
    """A Fiat–Shamir proof's kernel launches: K1 once in the prep stage,
    once a grand-product attempt (nonce + 1 of them) and twice in the
    quotient; K2 once a round (B = 3, 1, 3, 2)."""
    return launches == {"row_stages": 4 + nonce, "commit_many": 4}


def tampered(proof, Fr):
    """The proof with a commitment and with an evaluation changed."""
    return {"commitment": proof._replace(z_s=proof.z_s._replace(
                x=proof.z_s.x + 1)),
            "evaluation": proof._replace(a_z=(proof.a_z + 1) % Fr.p)}


def fs_prover_checks(kind, prover, prove, verify, replay, ctx, circuit,
                     ref_prover):
    """Phases 22 and 23's common checks: prove (launches counted),
    diagnostics, challenges equal to the host replay, the proof equal to
    make_prover's for those challenges, verify accepts, a tampered
    commitment and evaluation are rejected. Returns (FS proof, timings)."""
    sel, cp, a, b, c = circuit
    kernels.reset_counts()
    (out, diags), first_s = wall(lambda: prove(a, b, c, RND))
    launches = dict(kernels.LAUNCHES)
    print(f"{kind}: first proof {first_s:.3f} s, nonce {out.nonce}, "
          f"challenge {out.challenge.tolist()}, launches {launches}")
    check(bool(diags.all_ok()), f"{kind} diagnostics {diags}")
    check(fs_launches(launches, out.nonce), f"{kind} K1/K2 launches")
    ch, replay_s = wall(lambda: replay(out))
    check(np.array_equal(ch, out.challenge),
          f"{kind} challenges equal the host replay's")
    interactive, d = ref_prover(a, b, c, out.challenge, RND)
    check(bool(d.all_ok()) and EN.proofs_equal(interactive, out.proof),
          f"{kind} proof equals make_prover's for its challenges")
    ok, verify_s = wall(lambda: verify(ctx, prover.vk, out))
    rejected = {name: not verify(ctx, prover.vk, out._replace(proof=bad))
                for name, bad in tampered(out.proof, ctx.Fr).items()}
    print(f"{kind}: host replay {replay_s:.3f} s equal; the proof equals "
          f"make_prover's for those challenges; verify {ok} "
          f"({verify_s:.3f} s); tampered rejected {rejected}")
    check(ok and all(rejected.values()),
          f"{kind} verify accepts and rejects tampering")
    return out, dict(first_s=first_s, verify_s=verify_s, replay_s=replay_s)


def fs_phases(dev, card: str, ctx, circuit, ref_proof, ref_prover,
              vk) -> None:
    """Phases 22-25 on the 2^16 context of phases 4-7: both Fiat–Shamir
    provers, verify_scaled_many, proof and SRS bytes, the window table's
    disk cache, the checked prover; then proofs/s in turns with
    make_prover and the verify and cache times."""
    sel, cp, a, b, c = circuit
    Fr, Fq = ctx.Fr, ctx.Fq
    n = ctx.n
    times = {}

    phase("22 the BLAKE2b Fiat–Shamir prover at 2^16 gates")
    fs, times["blake2b_build_s"] = wall(
        lambda: FS.ScaledFsProver(ctx, sel, cp))
    replay = lambda out: FS._derive_from_proof(
        b"tpu-plonk-fs-v2", ctx.params, n, list(fs.vk), out.proof,
        out.nonce)
    _, t = fs_prover_checks("blake2b", fs, fs.prove, FS.verify_scaled_fs,
                            replay, ctx, circuit, ref_prover)
    times.update({f"blake2b_{k}": v for k, v in t.items()})

    phase("23 the Poseidon Fiat–Shamir prover at 2^16 gates")
    pos = PO.make_params(Fr.p)
    fsp, times["poseidon_build_s"] = wall(
        lambda: FSP.PoseidonFsProver(ctx, sel, cp))
    zero_digest = int(Fr.decode(PO.tree_digest(
        Fr, pos, torch.zeros(n, dtype=torch.int64))))
    replay = lambda out: FSP.derive_challenges_host(
        ctx, list(fsp.vk), out.proof, out.nonce, pi_digest=zero_digest)
    out, t = fs_prover_checks("poseidon", fsp, fsp.prove,
                              FSP.verify_scaled_fs_poseidon, replay, ctx,
                              circuit, ref_prover)
    times.update({f"poseidon_{k}": v for k, v in t.items()})
    # the card's digest of random public inputs: at 2^16 against the CPU
    # port's, at DIGEST_HOST_M against the Python-int oracle (~0.5 ms a
    # permutation on the host: 2^16 inputs would take ~35 s)
    rng = np.random.default_rng(23)
    for m in (n, DIGEST_HOST_M):
        pi = torch.as_tensor(rng.integers(0, Fr.p, m))
        got, dev_s = wall(lambda: int(Fr.decode(PO.tree_digest(
            Fr, pos, pi.to(dev)))))
        t = time.perf_counter()
        want = (int(Fr.decode(PO.tree_digest(Fr, pos, pi))) if m == n
                else PO.host_tree_digest(pos, pi.tolist()))
        ref_s = time.perf_counter() - t
        ref = "the CPU port's" if m == n else "host_tree_digest"
        print(f"tree_digest of {m} random public inputs: card {dev_s:.3f} "
              f"s, {ref} {ref_s:.3f} s, equal {got == want}")
        check(got == want, f"the card's tree_digest equals {ref}")
    rnds = np.stack([np.array(RND) + 9 * (i + 1) for i in range(MANY_B)])
    n_dev, dev_us, _, top = profiled_proofs(
        lambda rep: PO.permute(Fr, pos, Fr.ones((8,), dev)), 1)
    print(f"torch.profiler, permute of one (8,) state: {n_dev:.0f} device "
          f"events, {dev_us / 1e3:.3f} ms of device time; top "
          f"{[(k[:40], round(us / 1e3, 3)) for k, us in top[:3]]}")

    phase(f"24 verify_scaled_many at B = {MANY_B}")
    proofs = [ref_prover(a, b, c, CH, r)[0] for r in rnds]
    chs = np.array([CH] * MANY_B)
    proofs[2] = proofs[2]._replace(r_z=(proofs[2].r_z + 1) % Fr.p)
    flags_bad, times["verify_many_tampered_s"] = wall(
        lambda: PS.verify_scaled_many(ctx, vk, PS.stack_proofs(proofs), chs))
    t = time.perf_counter()
    single = [PS.verify_scaled(ctx, vk, p, CH) for p in proofs]
    torch.cuda.synchronize()
    times["verify_4_singles_s"] = time.perf_counter() - t
    print(f"distinct blinding, lane 2 tampered: {flags_bad.tolist()} "
          f"({times['verify_many_tampered_s']:.3f} s); verify_scaled of "
          f"each lane {single} ({times['verify_4_singles_s']:.3f} s for "
          f"{MANY_B})")
    check(flags_bad.tolist() == single == [True, True, False, True],
          "the honest lanes accepted, only the tampered one rejected, as "
          "verify_scaled says")

    phase("25 proof and SRS bytes, the window table's disk cache, the "
          "checked prover")
    small = []
    for d in ("cpu", dev):
        c16 = PS.scaled_new(N_SMALL, device=d)
        circ16 = square_chain_circuit(Fr.p, N_SMALL)
        p16, _ = PS.make_prover(c16, *circ16[:2])(*circ16[2:], CH, RND)
        small.append((SZ.proof_to_bytes(p16, Fq.p, Fr.p),
                      SZ.srs_to_bytes(c16.srs, Fq.p)))
    check(small[0] == small[1], "n = 16 proof and SRS bytes: card == CPU")
    data, ser_s = wall(lambda: SZ.proof_to_bytes(ref_proof, Fq.p, Fr.p))
    back = SZ.proof_from_bytes(data, dev)
    check(EN.proofs_equal(back, ref_proof) and back.r_z.device == dev,
          "the 2^16 proof round-trips on the card")
    srs_data, srs_s = wall(lambda: SZ.srs_to_bytes(ctx.srs, Fq.p))
    srs2, srs_load_s = wall(lambda: SZ.srs_from_bytes(srs_data, "fixed",
                                                      dev))
    check(all(torch.equal(x, y) for x, y in zip(
        tuple(srs2.g1s) + tuple(srs2.g2_1) + tuple(srs2.g2_s),
        tuple(ctx.srs.g1s) + tuple(ctx.srs.g2_1) + tuple(ctx.srs.g2_s))),
        "the 2^16 SRS round-trips on the card")
    print(f"proof {len(data)} bytes ({ser_s:.3f} s), SRS {len(srs_data)} "
          f"bytes ({srs_s:.3f} s, load {srs_load_s:.3f} s): round trips "
          f"equal; n = 16 bytes equal on card and CPU")
    tbl = PS.fixed_base_table(ctx)
    path = PS._fb_cache_path(ctx, PS.COMMIT_WINDOW_BITS)
    check(os.path.exists(path), f"phase 4 wrote the cache file {path}")
    ctx2 = PS.ScaledContext(params=ctx.params, srs=ctx.srs, n=n)
    tbl2, times["table_cache_load_s"] = wall(
        lambda: PS.fixed_base_table(ctx2))
    _, times["table_build_s"] = wall(lambda: CM.build_commit_table(
        Fq, ctx.srs.g1s, Fr.p.bit_length(), PS.COMMIT_WINDOW_BITS))
    check(all(torch.equal(x, y) for x, y in zip(tbl2[:3], tbl[:3]))
          and (tbl.packed is None if tbl2.packed is None
               else torch.equal(tbl2.packed, tbl.packed)),
          "a second context loads the cached table, words equal")
    print(f"cache file {os.path.getsize(path)} bytes; a second context "
          f"loads it in {times['table_cache_load_s']:.3f} s (build "
          f"{times['table_build_s']:.3f} s)")
    kernels.reset_counts()
    (proof, diags), checked_s = wall(lambda: PS.prove_scaled_checked(
        ctx, sel, cp, a, b, c, CH, RND))
    check(bool(diags.all_ok()) and EN.proofs_equal(proof, ref_proof),
          "prove_scaled_checked gives phase 6's proof")
    bad_cp = np.array(cp)
    bad_cp[1, 7, 1] = n + 1
    kernels.reset_counts()
    try:
        PS.prove_scaled_checked(ctx, sel, bad_cp, a, b, c, CH, RND)
        raised = None
    except ValueError as err:
        raised = str(err)
    torch.cuda.synchronize()
    check(raised == "copy index out of range (1-based, <= n)"
          and not kernels.LAUNCHES,
          f"an out-of-range copy index raises before any launch: {raised}")
    print(f"prove_scaled_checked {checked_s:.3f} s, phase 6's proof; an "
          f"out-of-range index raised {raised!r} with no launch")

    print(f"card: {card}")
    total = collections.Counter()
    provers = {"make_prover": lambda r: ref_prover(a, b, c, CH, r),
               "blake2b": lambda r: fs.prove(a, b, c, r),
               "poseidon": lambda r: fsp.prove(a, b, c, r)}
    for rep in range(FS_REPS):
        rnd = [v + 70 + 9 * rep for v in RND]
        for name, prove in provers.items():
            (_, d), sec = wall(lambda: prove(rnd))
            check(bool(d.all_ok()), f"{name} rep {rep} diagnostics")
            total[name] += sec
    for name in provers:
        print(f"proofs_per_s {name} {FS_REPS / total[name]:.6f} "
              f"({FS_REPS} synchronised proofs, in turns)")
    for key, v in times.items():
        print(f"{key} {v:.6f}")
    return fsp


BN_RND2 = list(range(31, 40))   # prove_many's second lane
BN_FS_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "golden", "bn254_fs_jax.json")
PERM_BATCH = 64          # states of phase 26's batched permutation
DIGEST_LEAVES = 1 << 12  # leaves of phase 26's tree digest


def bn_fs_fields(out) -> dict:
    """A BN254 FS proof as tests/golden/bn254_fs_jax.json holds it:
    points (x, y, inf), evaluations, nonce, challenge as ints."""
    proof = out.proof
    d = {k: (from_words(getattr(proof, k).x.cpu()),
             from_words(getattr(proof, k).y.cpu()),
             bool(getattr(proof, k).inf)) for k in PB.POINT_FIELDS}
    d.update({k: from_words(getattr(proof, k).cpu())
              for k in PB.SCALAR_FIELDS})
    d["nonce"] = int(out.nonce)
    d["challenge"] = [from_words(w) for w in np.asarray(out.challenge)]
    return d


def golden_fields(d: dict) -> dict:
    """A proof of the golden file (hex strings) as bn_fs_fields gives it."""
    out = {k: (int(d[k][0], 16), int(d[k][1], 16), bool(d[k][2]))
           for k in PB.POINT_FIELDS}
    out.update({k: int(d[k], 16) for k in PB.SCALAR_FIELDS})
    out["nonce"] = int(d["nonce"])
    out["challenge"] = [int(c, 16) for c in d["challenge"]]
    return out


def bn254_fs_launches(launches: dict) -> bool:
    """A BN254 FS proof's kernel launches at any nonce: K3 twice in each
    of the quotient's two 4n-coset transforms (a retry reruns the grand
    product, whose transform is big_intt, not K3); K4 once a round
    (B = 3, 1, 3, 2)."""
    return launches == {"big_row": 4, "big_commit": 4}


def bn254_fs_phases(dev, card: str, bn: dict) -> None:
    """Phases 26-28: the 16-limb Poseidon sponge, the BN254 Fiat–Shamir
    provers at n = 8 against the JAX package's recorded proofs, then at
    2^12 gates on the context, circuit, prover and verifying key of
    phases 10-12 (the BLAKE2b prover; the Poseidon prover and
    verify_bn254_many run in phase 31). Returns the BLAKE2b proof of
    phase 28 for phase 31's verify_bn254_many."""
    Fr = BigMontField(BN254_FR)
    pos = PO.make_params(Fr.p, t=3)
    times = {}

    phase("26 the 16-limb Poseidon permutation and tree digest on the card")
    rng = np.random.default_rng(26)
    rand = lambda m: np.array([int.from_bytes(rng.bytes(32), "little")
                               % Fr.p for _ in range(m)], dtype=object)
    std = rand(PERM_BATCH * 3).reshape(PERM_BATCH, 3)
    state = Fr.array(std, "cpu")
    got, times["permute_batch_card_s"] = wall(
        lambda: PO.big_permute(Fr, pos, state.to(dev)))
    t = time.perf_counter()
    want = PO.big_permute(Fr, pos, state)
    times["permute_batch_cpu_s"] = time.perf_counter() - t
    host = PO.PoseidonHost(pos)
    t = time.perf_counter()
    oracle = [host.permute(list(row)) for row in std]
    times["permute_batch_host_s"] = time.perf_counter() - t
    check(torch.equal(got.cpu(), want), "big_permute: card == CPU port")
    check(Fr.decode_host(got).tolist() == oracle,
          "big_permute: card == PoseidonHost")
    leaves = rand(DIGEST_LEAVES)
    words = torch.as_tensor(words_vec(leaves.tolist()).astype(np.int64))
    digest, times["tree_digest_card_s"] = wall(lambda: from_words(Fr.decode(
        PO.big_tree_digest(Fr, pos, words.to(dev))).cpu()))
    t = time.perf_counter()
    want_digest = PO.host_tree_digest(pos, leaves.tolist())
    times["tree_digest_host_s"] = time.perf_counter() - t
    check(digest == want_digest, "big_tree_digest: card == host_tree_digest")
    one = Fr.array(np.array([1, 2, 3], dtype=object), dev)
    _, times["permute_one_card_s"] = wall(lambda: PO.big_permute(Fr, pos,
                                                                 one))
    n_dev, dev_us, _, top = profiled_proofs(
        lambda rep: PO.big_permute(Fr, pos, one), 1)
    print(f"big_permute ({PERM_BATCH}, 3, 16): card == CPU port == "
          f"PoseidonHost; big_tree_digest of {DIGEST_LEAVES} leaves == "
          f"host_tree_digest; one (3, 16) permutation: "
          f"{times['permute_one_card_s'] * 1e3:.3f} ms, {n_dev:.0f} device "
          f"events (launches), {dev_us / 1e3:.3f} ms of device time ({card}); "
          f"top {[(k[:40], round(us / 1e3, 3)) for k, us in top[:3]]}")

    phase("27 n = 8 BN254 Fiat–Shamir proofs on the card vs recorded JAX "
          "values")
    with open(BN_FS_GOLDEN) as f:
        golden = json.load(f)
    ctx8 = bn["ctx8"]
    sel8, cp8, a8, b8, c8 = bn254_mul_circuit(N_BN_SMALL)
    rnd = words_vec(BN_RND)
    fs8 = FS.BN254FsProver(ctx8, sel8, cp8)
    (out, d), sec = wall(lambda: fs8.prove(a8, b8, c8, rnd))
    check(bool(d.all_ok()) and bn_fs_fields(out)
          == golden_fields(golden["blake2b"]),
          "n=8 BLAKE2b FS proof equals JAX's")
    fsp8 = FSP.BN254PoseidonFsProver(ctx8, sel8, cp8)
    # one batched pass; lane 0 is the single Poseidon proof of BN_RND
    many, many_s = wall(lambda: fsp8.prove_many(
        *(np.stack([w, w]) for w in (a8, b8, c8)),
        np.stack([rnd, words_vec(BN_RND2)])))
    check(all(bool(dd.all_ok()) for _, dd in many), "n=8 prove_many diags")
    check(bn_fs_fields(many[0][0]) == golden_fields(golden["poseidon"]),
          "n=8 Poseidon FS proof equals JAX's")
    check([bn_fs_fields(o) for o, _ in many]
          == [golden_fields(g) for g in golden["prove_many"]],
          "n=8 prove_many lanes equal JAX's")
    print(f"n=8 BLAKE2b FS proof ({sec:.3f} s), Poseidon prove_many at B = 2 "
          f"({many_s:.3f} s, lane 0 the single Poseidon proof) equal JAX's "
          f"recorded proofs word for word, nonces and challenges included")

    phase("28 the BLAKE2b BN254 Fiat–Shamir prover at 2^12 gates")
    a, b, c = bn["circuit"][2:]
    fs, ((out, _),), _, single_s = bn254_fs_checks(
        "blake2b", FS.BN254FsProver,
        lambda *args: FS._bn254_derive_from_proof(FS.BN254_LABEL, *args),
        bn, times, [(a, b, c, rnd)])
    ok, times["blake2b_verify_s"] = wall(
        lambda: FS.verify_bn254_fs(bn["ctx"], fs.vk, out))
    print(f"verify_bn254_fs {ok} ({times['blake2b_verify_s']:.3f} s)")
    check(ok, "verify_bn254_fs accepts the BLAKE2b proof")
    print(f"card: {card}")
    # the first BLAKE2b proof and make_prover_bn254's proof for its
    # challenges, one after the other
    for name, sec in (("blake2b", times["blake2b_first_proof_s"]),
                      ("make_prover_bn254", single_s)):
        print(f"proofs_per_s {name} {1 / sec:.6f} (one synchronised 2^12 "
              "proof, back to back)")
    for key, v in times.items():
        print(f"{key} {v:.6f}")
    return out


def bn254_fs_checks(kind, make, replay, bn, times: dict, lanes):
    """Phases 28 and 31's checks of a BN254 FS prover on the 2^12 context
    of phases 10-12: its vk equal to make_vk_bn254's; one proof (lanes: a
    list of one (a, b, c, rand9)) or one prove_many over the lanes, K3 and
    K4 launches counted exactly; diagnostics; every lane's challenges
    equal to the host replay of its transcript (replay(ctx, vk points,
    proof, nonce)); lane 0's proof equal to make_prover_bn254's single
    proof for its challenges. The pairing checks of the lanes are phase
    31's verify_bn254_many. Returns (prover, [(FS proof, diags)], lane
    0's make_prover_bn254 proof, its seconds)."""
    ctx, vk, prover = bn["ctx"], bn["vk"], bn["prover"]
    fs, times[f"{kind}_build_s"] = wall(lambda: make(ctx, *bn["circuit"][:2]))
    check(all(torch.equal(x, y) for p, q in zip(fs.vk, vk)
              for x, y in zip(p, q)), f"{kind} vk equals make_vk_bn254's")
    kernels.reset_counts()
    if len(lanes) == 1:
        one, times[f"{kind}_first_proof_s"] = wall(
            lambda: fs.prove(*lanes[0]))
        outs = [one]
    else:
        outs, times[f"{kind}_first_proof_s"] = wall(
            lambda: fs.prove_many(*(np.stack(x) for x in zip(*lanes))))
    launches = dict(kernels.LAUNCHES)
    what = "proof" if len(outs) == 1 else f"prove_many of {len(outs)}"
    print(f"{kind}: build {times[f'{kind}_build_s']:.3f} s, first {what} "
          f"{times[f'{kind}_first_proof_s']:.3f} s, nonces "
          f"{[o.nonce for o, _ in outs]}, launches {launches}")
    check(bn254_fs_launches(launches), f"{kind} K3/K4 launches")
    t = time.perf_counter()
    for out, diags in outs:
        check(bool(diags.all_ok()), f"{kind} 2^12 diagnostics {diags}")
        check(np.array_equal(replay(ctx, list(fs.vk), out.proof, out.nonce),
                             out.challenge),
              f"{kind}: the challenges equal the host replay's")
    times[f"{kind}_replays_s"] = time.perf_counter() - t
    (out, _), (a, b, c, rnd) = outs[0], lanes[0]
    (single, d), single_s = wall(lambda: prover(a, b, c, out.challenge, rnd))
    check(bool(d.all_ok()) and EN.proofs_equal(single, out.proof),
          f"{kind} proof equals make_prover_bn254's for its challenges")
    return fs, outs, single, single_s


N_BATCH = 1 << 12        # phase 29's gates (bench.py's bench_scaled_batched)
BATCH = 16               # phase 29's lanes
BATCH_BAD = 5            # the lane tampered in phase 29's verify
BATCH_REPS = 3           # phase 29's batches and single proofs in turns
FS_BATCH = 8             # phase 30's lanes (bench.py's bench_fs_poseidon)
FS_BATCH_REPS = 1        # phase 30's batches and single proofs in turns
BN_BATCH = 4             # phase 31's lanes


def print_idle(what: str, run, call_s: float) -> None:
    """torch.profiler's device events and device time of one call of
    run(rep), and the device's idle share of an unprofiled call of
    call_s seconds."""
    n_dev, dev_us, prof_s, top = profiled_proofs(run, 1)
    if n_dev == 0:
        print(f"{what}: torch.profiler recorded no device events, idle "
              "share not measured")
        return
    print(f"{what}: {n_dev:.0f} device events and {dev_us / 1e3:.3f} ms of "
          f"device time a call (profiled call {prof_s:.3f} s); unprofiled "
          f"{call_s:.3f} s, the device idle "
          f"{100 * (1 - dev_us / 1e6 / call_s):.1f} % of it; top "
          f"{[(k[:40], round(us / 1e3, 3)) for k, us in top[:3]]}")


def scaled_batch_phase(dev, card: str) -> None:
    """Phase 29: B = BATCH proofs at 2^12 gates on a fresh context and
    window table, in bench_scaled_batched's configuration (witnesses
    x0 = 3 + i, challenges CH, blinding 1..9 + 100 i): make_prover on the
    batch launches K1 and K2 as often as one proof (K2 once, over the
    B * 9 rows); every lane's diagnostics hold and every lane equals the
    single proof of its inputs; verify_scaled_many accepts the batch as it
    comes out and, with one lane tampered, refuses that lane alone; K2 at
    (B * 9, L) with one all-zero lane against its plain version, with its
    card ms and bound; proofs/s of the batch and of one proof in turns,
    the device's idle share of each, and the batch's peak memory."""
    phase(f"29 batched scaled proofs: B = {BATCH} at 2^12 gates")
    ctx, setup_s = wall(lambda: PS.scaled_new(N_BATCH, device=dev))
    Fr, Fq = ctx.Fr, ctx.Fq
    p = Fr.p
    sel, cp = square_chain_circuit(p, N_BATCH)[:2]
    wits = [square_chain_circuit(p, N_BATCH, x0=3 + i)[2:]
            for i in range(BATCH)]
    a, b, c = (np.stack([w[k] for w in wits]) for k in range(3))
    chs = np.tile(np.array(CH), (BATCH, 1))
    rnds = lambda rep: (np.arange(1, 10) + 100 * np.arange(BATCH)[:, None]
                        + 9 * rep) % p
    prover, build_s = wall(lambda: PS.make_prover(ctx, sel, cp))
    kernels.reset_counts()
    (_, d), one_s = wall(lambda: prover(a[0], b[0], c[0], chs[0],
                                        rnds(0)[0]))
    one_launches = dict(kernels.LAUNCHES)
    kernels.reset_counts()
    (proof, diags), batch_s = wall(lambda: prover(a, b, c, chs, rnds(0)))
    launches = dict(kernels.LAUNCHES)
    print(f"scaled_new(2^12) and window table {setup_s:.3f} s, make_prover "
          f"{build_s:.3f} s; one proof {one_s:.3f} s, launches "
          f"{one_launches}; the batch of {BATCH} {batch_s:.3f} s, launches "
          f"{launches}")
    check(launches == one_launches == {"row_stages": 4, "commit_many": 1},
          "a batch launches K1 and K2 as often as one proof (4, 1)")
    check(tuple(diags.satisfied.shape) == (BATCH,) and bool(diags.all_ok())
          and bool(d.all_ok()), f"every lane's diagnostics hold: {diags}")
    t = time.perf_counter()
    for i in range(BATCH):
        single, sd = prover(a[i], b[i], c[i], chs[i], rnds(0)[i])
        check(bool(sd.all_ok()) and EN.proofs_equal(FSP._lane(proof, i),
                                                 single),
              f"lane {i} equals the single proof of its inputs")
    singles_s = time.perf_counter() - t
    vk = PS.make_vk_scaled(ctx, sel, cp)
    flags, verify_s = wall(lambda: PS.verify_scaled_many(ctx, vk, proof,
                                                         chs))
    r_z = proof.r_z.clone()
    r_z[BATCH_BAD] = (r_z[BATCH_BAD] + 1) % p
    flags_bad, _ = wall(lambda: PS.verify_scaled_many(
        ctx, vk, proof._replace(r_z=r_z), chs))
    print(f"{BATCH} lanes equal their single proofs ({singles_s:.3f} s for "
          f"the {BATCH}); verify_scaled_many {flags.tolist()} "
          f"({verify_s:.3f} s); lane {BATCH_BAD} tampered: "
          f"{flags_bad.tolist()}")
    check(flags.tolist() == [True] * BATCH, "every lane verifies")
    check(flags_bad.tolist() == [i != BATCH_BAD for i in range(BATCH)],
          "only the tampered lane is refused")

    tbl = PS.fixed_base_table(ctx)
    L = ctx.srs.length
    sc = np.random.default_rng(29).integers(0, p, size=(9 * BATCH, L))
    sc[27:36] = 0                                  # lane 3: all zero
    scalars = torch.as_tensor(sc, device=dev)
    got = CM.msm_fixed_base_many_kernel(Fq, tbl, scalars)
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, tbl, scalars))
    err = affine_err(got, want)
    check(err == 0 and bool(got.inf[27:36].all())
          and not bool(got.inf[:27].any()),
          f"K2 affine-equal at ({9 * BATCH}, {L}) with a zero lane")
    k_ms, plain_ms, (n_ev, prof_ms) = kernel_times(
        lambda: CM.commit_many(Fq, tbl, scalars),
        lambda: CM.commit_many_plain(Fq, tbl, scalars))
    bnd, terms, entries = commit_bound(tbl, scalars)
    print(f"K2 at ({9 * BATCH}, {L}), lane 3 all zero: max_abs_err {err}; "
          f"kernel {k_ms:.6f} ms (CUDA events, queued ahead), "
          f"torch.profiler {n_ev:.2f} device events and "
          f"{prof_ms if prof_ms is None else round(prof_ms, 6)} ms a call; "
          f"plain {plain_ms:.6f} ms; bound {bnd[0]:.6f} ms ({bnd[1]}), "
          f"{terms} terms, {entries} distinct entries")

    total = collections.Counter()
    for rep in range(1, BATCH_REPS + 1):
        (_, db), sec = wall(lambda: prover(a, b, c, chs, rnds(rep)))
        total["batch"] += sec
        (_, d1), sec = wall(lambda: prover(a[0], b[0], c[0], chs[0],
                                           rnds(rep)[0]))
        total["single"] += sec
        check(bool(db.all_ok()) and bool(d1.all_ok()),
              f"rep {rep} diagnostics")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prover(a, b, c, chs, rnds(BATCH_REPS + 1))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print_idle(f"batch of {BATCH}", lambda rep: prover(
        a, b, c, chs, rnds(BATCH_REPS + 2 + rep)), total["batch"] / BATCH_REPS)
    print_idle("one proof", lambda rep: prover(
        a[0], b[0], c[0], chs[0], rnds(BATCH_REPS + 2 + rep)[0]),
        total["single"] / BATCH_REPS)
    print(f"card: {card}")
    print(f"proofs_per_s batch of {BATCH} "
          f"{BATCH * BATCH_REPS / total['batch']:.6f}, one proof "
          f"{BATCH_REPS / total['single']:.6f} ({BATCH_REPS} synchronised "
          f"calls each, in turns); the batch's peak memory above what was "
          f"allocated before it {peak:.3f} GiB")


def fs_batch_phase(dev, card: str, ctx, fsp) -> None:
    """Phase 30: PoseidonFsProver.prove_many at B = FS_BATCH on the 2^16
    context of phases 4-7 (bench_fs_poseidon's witnesses x0 = 3 + i and
    blinding 1 + i .. 9 + i): one batched pass launching K1 and K2 as one
    FS proof does (K1 4 and one more a retry round, K2 4); every lane's
    diagnostics; every lane equal to a single prove() of its inputs,
    nonce and challenge included; lane 0 verifies; batch and single
    times in turns."""
    phase(f"30 Poseidon Fiat–Shamir prove_many at B = {FS_BATCH}, 2^16 "
          "gates")
    p = ctx.Fr.p
    wits = [square_chain_circuit(p, ctx.n, x0=3 + i)[2:]
            for i in range(FS_BATCH)]
    a, b, c = (np.stack([w[k] for w in wits]) for k in range(3))
    rnds = lambda rep: (np.stack([np.arange(1 + i, 10 + i)
                                  for i in range(FS_BATCH)]) + 50 * rep) % p
    kernels.reset_counts()
    many, many_s = wall(lambda: fsp.prove_many(a, b, c, rnds(0)))
    launches = dict(kernels.LAUNCHES)
    nonces = [o.nonce for o, _ in many]
    print(f"prove_many B={FS_BATCH}: {many_s:.3f} s, nonces {nonces}, "
          f"launches {launches}")
    check(fs_launches(launches, max(nonces)),
          "a batch launches K1 and K2 as one FS proof does")
    t = time.perf_counter()
    for i, (m, d) in enumerate(many):
        s1, sd = fsp.prove(a[i], b[i], c[i], rnds(0)[i])
        check(bool(d.all_ok()) and bool(sd.all_ok()) and m.nonce == s1.nonce
              and np.array_equal(m.challenge, s1.challenge)
              and EN.proofs_equal(m.proof, s1.proof),
              f"lane {i} equals prove() of its inputs")
    singles_s = time.perf_counter() - t
    ok, verify_s = wall(lambda: FSP.verify_scaled_fs_poseidon(
        ctx, fsp.vk, many[0][0]))
    check(ok, "lane 0 verifies")
    total = collections.Counter()
    for rep in range(1, FS_BATCH_REPS + 1):
        outs, sec = wall(lambda: fsp.prove_many(a, b, c, rnds(rep)))
        total["batch"] += sec
        (_, d), sec = wall(lambda: fsp.prove(a[0], b[0], c[0],
                                             rnds(rep)[0]))
        total["single"] += sec
        check(bool(d.all_ok()) and all(bool(dd.all_ok()) for _, dd in outs),
              f"rep {rep} diagnostics")
    print(f"{FS_BATCH} lanes equal their single proofs ({singles_s:.3f} s "
          f"for the {FS_BATCH}); lane 0 verifies ({verify_s:.3f} s)")
    # K1 at the batch's coset stack: B * 5 rows of the 2^18 transform
    Fr, m = ctx.Fr, ctx.domain8
    intra, _ = N._device_tables(Fr, ctx.omega8(), m, 1024, dev)
    R = FS_BATCH * 5 * m // 1024
    y = torch.as_tensor(np.random.default_rng(30).integers(
        0, p, size=(R, 1024)), device=dev)
    k1 = lambda: RS.row_stages(Fr.p, Fr.n_prime, y, intra)
    k1_plain = lambda: RS.row_stages_plain(Fr.p, Fr.n_prime, y, intra)
    err = int((k1() - k1_plain()).abs().max())
    check(err == 0, f"K1 word-equal at ({R}, 1024)")
    k_ms, plain_ms, (n_ev, prof_ms) = kernel_times(k1, k1_plain)
    bnd = row_bound(R, 1024)
    print(f"K1 at the batch's coset stack ({R}, 1024): max_abs_err {err}; "
          f"kernel {k_ms:.6f} ms (CUDA events, queued ahead), "
          f"torch.profiler {n_ev:.2f} device events a call; plain "
          f"{plain_ms:.6f} ms; bound {bnd[0]:.6f} ms ({bnd[1]}), int64 "
          f"floor {int64_floor_ms(2 * R * 1024):.6f} ms")
    print_idle(f"prove_many of {FS_BATCH}", lambda rep: fsp.prove_many(
        a, b, c, rnds(FS_BATCH_REPS + 1 + rep)),
        total["batch"] / FS_BATCH_REPS)
    print(f"card: {card}")
    print(f"proofs_per_s Poseidon prove_many of {FS_BATCH} "
          f"{FS_BATCH * FS_BATCH_REPS / total['batch']:.6f}, prove() "
          f"{FS_BATCH_REPS / total['single']:.6f} ({FS_BATCH_REPS} "
          f"synchronised calls each, in turns)")


def bn_batch_kernels(dev, ctx) -> None:
    """K3 at the B = BN_BATCH forward coset stack (B * 6 * n2 rows of n1)
    and K4 at the batch's B * 9 commitments of the context's table (one
    lane all zero, where K4's tiling gives each commitment one tile)
    against their plain versions, word for word, each with its card ms,
    plain ms and bound."""
    Fr = BigMontField(BN254_FR)
    m = 4 * N_BN
    n1, n2 = BN._split(m)
    w = pow(BN254_FR.root_of_unity(m), n2, Fr.p)
    R = BN_BATCH * 6 * n2
    vals = np.random.default_rng(31).integers(0, 1 << 16, size=(R, n1, 16))
    vals[..., 15] &= 0x0FFF
    y = torch.as_tensor(vals, device=dev)
    tw = torch.as_tensor(BN._row_tables(Fr, w, n1), device=dev)
    k3 = lambda: BN.big_row_pass(Fr, y, w, True)
    k3_plain = lambda: BN.big_row_pass_plain(Fr, y, tw, True)
    err = int((k3() - k3_plain()).abs().max())
    check(err == 0, f"K3 word-equal at ({R}, {n1})")
    k_ms, plain_ms, (n_ev, _) = kernel_times(k3, k3_plain)
    bnd = big_row_bound(R, n1, False)
    print(f"K3 at the batch's forward coset stack ({R}, {n1}): max_abs_err "
          f"{err}; kernel {k_ms:.6f} ms (CUDA events, queued ahead), "
          f"torch.profiler {n_ev:.2f} device events a call; plain "
          f"{plain_ms:.6f} ms; bound {bnd[0]:.6f} ms ({bnd[1]})")
    Fq = ctx.Fq
    tbl, packed = PB.bn254_fixed_base_table(ctx), PB.bn254_packed_table(ctx)
    L = ctx.srs.length
    sc = np.random.default_rng(31).integers(0, 1 << 16,
                                            size=(9 * BN_BATCH, L, 16))
    sc[..., 15] &= 0x0FFF
    sc[9:18] = 0                                   # lane 1: all zero
    scalars = torch.as_tensor(sc, device=dev)
    k4 = lambda: BK.big_commit_many(Fq, tbl, scalars, packed)
    got = BC.big_to_affine(Fq, k4())
    # the plain version is launch-bound (seconds): one synchronised call,
    # timed on the host clock, is both its check and its time
    plain, plain_s = wall(lambda: BK.big_commit_many_plain(Fq, tbl,
                                                           scalars))
    err = affine_err(got, BC.big_to_affine(Fq, plain))
    inf = got[2]
    check(err == 0 and bool(inf[9:18].all()) and not bool(inf[:9].any())
          and not bool(inf[18:].any()),
          f"K4 affine-equal at ({9 * BN_BATCH}, {L}), the zero lane's "
          "commitments alone at infinity")
    k_ms = cuda_ms(k4, reps=50, queue_ahead=True)
    n_ev, _ = device_ms(k4)
    bnd, terms, entries = big_commit_bound(tbl, scalars)
    print(f"K4 at the batch's ({9 * BN_BATCH}, {L}), lane 1 all zero: "
          f"max_abs_err {err}; kernel {k_ms:.6f} ms (CUDA events, queued "
          f"ahead), torch.profiler {n_ev:.2f} device events a call; plain "
          f"{plain_s * 1e3:.6f} ms (one synchronised call); bound "
          f"{bnd[0]:.6f} ms ({bnd[1]}), {terms} terms, {entries} distinct "
          "entries")


def bn254_batch_phase(dev, card: str, bn: dict, blake) -> None:
    """Phase 31 on the 2^12 context, circuit, prover and vk of phases
    10-12, lanes the witnesses of bn254_mul_circuit seeds 11 + i with
    bench.py's blinding variants 17 + 31 i + j: BN254PoseidonFsProver.
    prove_many at B = BN_BATCH (K3 4, K4 4 a batch; prove() is
    prove_many of one lane), each lane's challenges replayed on the host,
    lane 0 equal to make_prover_bn254's single proof for its challenges
    and verified by verify_bn254_fs_poseidon; make_prover_bn254 on the
    batch with those challenges (K3 4, K4 1) equal to the FS lanes; K3
    and K4 at the batch's shapes against their plain versions
    (bn_batch_kernels); verify_bn254_many on [phase 12's proof, phase
    28's BLAKE2b proof, the B lanes, the BLAKE2b proof with [a] replaced]
    -> [T, ..., T, F]; batch and single times."""
    phase(f"31 BN254 batches at 2^12 gates: Poseidon prove_many and "
          f"make_prover_bn254 at B = {BN_BATCH}, verify_bn254_many")
    ctx, vk, prover = bn["ctx"], bn["vk"], bn["prover"]
    wits = [bn254_mul_circuit(N_BN, seed=11 + i)[2:]
            for i in range(BN_BATCH)]
    rnds = [words_vec([17 + 31 * i + j for j in range(9)])
            for i in range(BN_BATCH)]
    lanes = [(*w, r) for w, r in zip(wits, rnds)]
    times = {}
    fsp, many, single, single_s = bn254_fs_checks(
        "poseidon", FSP.BN254PoseidonFsProver,
        FSP.derive_bn254_challenges_host, bn, times, lanes)
    ok, times["poseidon_verify_s"] = wall(
        lambda: FSP.verify_bn254_fs_poseidon(ctx, fsp.vk, many[0][0]))
    check(ok, "verify_bn254_fs_poseidon accepts lane 0")
    a, b, c, rnd = (np.stack(x) for x in zip(*lanes))
    chs = np.stack([o.challenge for o, _ in many])
    kernels.reset_counts()
    (proof, diags), batch_s = wall(lambda: prover(a, b, c, chs, rnd))
    launches = dict(kernels.LAUNCHES)
    print(f"make_prover_bn254 on the batch: {batch_s:.3f} s, launches "
          f"{launches}; lane 0's single proof {single_s:.3f} s")
    check(launches == {"big_row": 4, "big_commit": 1},
          "a batch launches K3 and K4 as one proof does (4, 1)")
    check(bool(diags.all_ok()) and all(
        EN.proofs_equal(FSP._lane(proof, i), out.proof)
        for i, (out, _) in enumerate(many))
        and EN.proofs_equal(FSP._lane(proof, 0), single),
        "every lane of the batch equals its FS lane, lane 0 its single "
        "proof")
    bn_batch_kernels(dev, ctx)
    proofs = ([bn["proof"], blake.proof] + [o.proof for o, _ in many]
              + [blake.proof._replace(a_s=blake.proof.b_s)])
    v_chs = np.stack([words_vec(BN_CH), blake.challenge, *chs,
                      blake.challenge])
    flags, times["verify_many_s"] = wall(lambda: PB.verify_bn254_many(
        ctx, vk, PB.stack_proofs(proofs), v_chs))
    want = [True] * (2 + BN_BATCH) + [False]
    print(f"verify_bn254_many on [interactive, BLAKE2b, {BN_BATCH} Poseidon "
          f"lanes with their replayed challenges, tampered]: "
          f"{flags.tolist()} in {times['verify_many_s']:.3f} s")
    check(flags.tolist() == want, f"verify_bn254_many flags {want}")
    print(f"card: {card}")
    print(f"proofs_per_s BN254 Poseidon prove_many of {BN_BATCH} "
          f"{BN_BATCH / times['poseidon_first_proof_s']:.6f}; "
          f"make_prover_bn254 batch of {BN_BATCH} {BN_BATCH / batch_s:.6f}, "
          f"single {1 / single_s:.6f} (synchronised, in this order)")
    for key, v in times.items():
        print(f"{key} {v:.6f}")


MSM_N = 1 << 14          # phase 32's points (bench.py's bench_bn254_msm)
MSM_TIMED = 1            # phase 32's timed calls a kind, after a warm one
MSM_PROFILED = ("glv",)  # kinds whose warm call torch.profiler reads under
                         # --profile (its trace takes ~60 us an event to
                         # parse)
MSM_KINDS = {"pippenger": lambda F, pts, w: BC.big_msm_pippenger(F, pts, w),
             "glv": lambda F, pts, w: GLV.big_msm_glv(F, pts, w)}


@contextlib.contextmanager
def switches(**env):
    """The environment variables `env` (the PLONK_TPU_* switches, the
    cache roots) set for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def refusing(module, *names):
    """module.<name> raises for the block: shows that a cached value was
    loaded and not computed."""
    saved = {n: getattr(module, n) for n in names}

    def refuse(*args, **kw):
        raise RuntimeError("computed where the cache should have served")
    try:
        for n in names:
            setattr(module, n, refuse)
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def dispatches(fn) -> int:
    """The PyTorch operator calls of fn() (each launches at most one device
    kernel), counted by a dispatch mode around it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count():
        fn()
    return Count.n


def affine_ints(F, out) -> list:
    """(x, y) python ints of each point of a Jacobian batch, None at
    infinity (one batched inversion)."""
    x, y, inf = BC.big_to_affine(F, BC.BigG1J(*(c.reshape(-1, F.limbs)
                                                 for c in out)))
    xs, ys = F.decode_host(x), F.decode_host(y)
    return [None if bool(i) else (int(a), int(b))
            for a, b, i in zip(xs, ys, inf.tolist())]


def msm_phase(dev, card: str, profile: bool) -> None:
    """Phase 32: plain Pippenger and GLV at MSM_N points in the JAX
    package's bench_bn254_msm configuration (every base the generator,
    scalars from default_rng(0), below r, 8-bit windows), each equal to
    (sum s_i mod r) G from a host ladder; points/s over MSM_TIMED distinct
    rolls of the scalars after a warm call, whose peak memory is taken
    and which, with `profile`, torch.profiler reads for the kinds of
    MSM_PROFILED (device events and device time); no kernel launched; the
    window combination (Horner's rule) timed alone, with its operator
    calls."""
    phase(f"32 BN254 MSM at {MSM_N} points (bench_bn254_msm): plain "
          "Pippenger and GLV")
    Fq = BigMontField(BC.BN254_FQ)
    words = np.random.default_rng(0).integers(0, 1 << 16, size=(MSM_N, 16))
    words[:, 15] &= 0x0FFF
    pts = BC.bn254_generator(Fq, (MSM_N,), dev)
    total = sum(from_words(w) for w in words) % BN254_FR.p
    want = GLV._HostG1(Fq.p).mul(BC.BN254_G1_GEN, total)
    rolls = [torch.as_tensor(np.roll(words, i, axis=0), device=dev)
             for i in range(1 + MSM_TIMED)]
    g1 = BC.bn254_generator(Fq, (1,), dev)
    BC.big_jac_add(Fq, g1, g1)          # constants made before counting
    dbl_n = dispatches(lambda: BC.big_jac_double(Fq, g1))
    add_n = dispatches(lambda: BC.big_jac_add(Fq, g1, g1))
    wb = 8
    rates = {}
    for name, msm in MSM_KINDS.items():
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        first = []
        warm = lambda rep: first.append(msm(Fq, pts, rolls[0]))
        profiled = profile and name in MSM_PROFILED
        if profiled:
            n_dev, dev_us, warm_s, _ = profiled_proofs(warm, 1)
        else:
            _, warm_s = wall(lambda: warm(0))
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outs = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for w in rolls[1:]:
            outs.append(msm(Fq, pts, w))
        torch.cuda.synchronize()
        call_s = (time.perf_counter() - t) / MSM_TIMED
        got = affine_ints(Fq, BC.BigG1J(*(torch.stack(c) for c in zip(
            *first, *outs))))
        check(got == [want] * (1 + MSM_TIMED),
              f"{name} MSM at {MSM_N} points == (sum s_i) G, every roll")
        check(launches == {}, f"{name} launches none of K1-K9")
        rates[name] = MSM_N / call_s
        W = -(-(254 if name == "pippenger" else 131) // wb)
        wtot = BC.BigG1J(*(c.expand(1, W, Fq.limbs)
                           for c in BC.bn254_generator(Fq, (1, 1), dev)))
        _, horner_s = wall(lambda: BC.combine_windows(Fq, wtot, wb))
        print(f"{name}: {call_s:.3f} s a call ({MSM_TIMED} timed, on other "
              f"rolls than the warm call's), {rates[name]:.1f} points/s; "
              f"warm call {warm_s:.3f} s"
              f"; peak memory {peak:.3f} GiB; K1-K9 launches {launches}; "
              f"the window combination ({W - 1} x ({wb} doublings + 1 "
              f"addition): {(W - 1) * (wb * dbl_n + add_n)} operator calls "
              f"at {dbl_n} a doubling and {add_n} an addition) "
              f"{horner_s:.3f} s alone")
        if profiled:
            print(f"{name}'s warm call under torch.profiler: {n_dev:.0f} "
                  f"device events and {dev_us / 1e3:.3f} ms of device time,"
                  f" against the timed call (unprofiled, the same "
                  f"shapes, another roll of the scalars: two runs), the "
                  f"device idle {100 * (1 - dev_us / 1e6 / call_s):.1f} % "
                  f"and {call_s * 1e6 / max(n_dev, 1):.3f} us of host a "
                  "device event")
    print(f"card: {card}")
    print(f"bn254_msm_2e14_points_per_s {rates['pippenger']:.3f}; "
          f"bn254_msm_glv_2e14_points_per_s {rates['glv']:.3f} (GLV "
          f"{rates['glv'] / rates['pippenger']:.3f}x)")


def commit_routes_phase(dev, card: str, bn: dict) -> None:
    """Phase 33 on the 2^12 context, table, circuit, proof and vk of
    phases 10-12: the JAX package's check_bn254_pallas_commit_parity (K4
    at B = 9 against _commit_many by GLV and by plain Pippenger on the
    same scalars, affine-equal) with each route's call timed and the
    peak memory of each _commit_many call; then
    make_vk_bn254 and a make_prover_bn254 proof under
    PLONK_TPU_BN254_FB=0 (no table), equal word for word to phase 12's,
    the proof launching K3 4 and K4 0 times and the vk no K4."""
    phase("33 the BN254 commit routes at 2^12 gates: K4 vs GLV vs "
          "Pippenger at B = 9, vk and proof under PLONK_TPU_BN254_FB=0")
    ctx = bn["ctx"]
    Fr = ctx.Fr
    L = ctx.srs.length
    sc = np.random.default_rng(0).integers(0, 1 << 16, size=(9, L, 16))
    sc[..., 15] &= 0x0FFF                     # < r
    polys = list(Fr.encode(torch.as_tensor(sc, device=dev)).unbind(0))
    kernels.reset_counts()
    k4, k4_s = wall(lambda: PB.bn254_table_commit(ctx)(polys))
    check(kernels.LAUNCHES == {"big_commit": 1}, "the table route: one K4")
    routes, peaks = {}, {}
    for glv in ("1", "0"):
        with switches(PLONK_TPU_BN254_GLV=glv):
            kernels.reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            routes[glv] = wall(lambda: PB._commit_many(ctx, polys))
            peaks[glv] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            check(kernels.LAUNCHES == {}, "_commit_many launches no kernel")
    for glv, (out, _) in routes.items():
        check(all(torch.equal(a, b) for a, b in zip(out, k4)),
              f"K4 == _commit_many (PLONK_TPU_BN254_GLV={glv}) at B = 9, "
              "affine words")
    print(f"B = 9, L = {L}: K4 == GLV == Pippenger (affine words); commit "
          f"calls: the table route (K4 and the affine conversion) "
          f"{k4_s:.3f} s, GLV {routes['1'][1]:.3f} s, plain Pippenger "
          f"{routes['0'][1]:.3f} s; peak memory above what was allocated "
          f"before the call: GLV {peaks['1']:.3f} GiB, plain Pippenger "
          f"{peaks['0']:.3f} GiB")
    sel, cp, a, b, c = bn["circuit"]
    with switches(PLONK_TPU_BN254_FB="0"):
        kernels.reset_counts()
        vk, vk_s = wall(lambda: PB.make_vk_bn254(ctx, sel, cp))
        vk_launches = dict(kernels.LAUNCHES)
        prover, make_s = wall(lambda: PB.make_prover_bn254(ctx, sel, cp))
        kernels.reset_counts()
        (proof, diags), proof_s = wall(lambda: prover(
            a, b, c, words_vec(BN_CH), words_vec(BN_RND)))
        launches = dict(kernels.LAUNCHES)
    check("big_commit" not in vk_launches, "the vk without K4")
    check(launches == {"big_row": 4},
          f"the GLV-committed proof launches K3 4, K4 0: {launches}")
    check(bool(diags.all_ok()) and EN.proofs_equal(proof, bn["proof"]),
          "the PLONK_TPU_BN254_FB=0 proof == phase 12's, word for word")
    check(all(torch.equal(x, y) for p, q in zip(vk, bn["vk"])
              for x, y in zip(p, q)),
          "the PLONK_TPU_BN254_FB=0 vk == phase 12's, word for word")
    print(f"PLONK_TPU_BN254_FB=0: make_vk_bn254 {vk_s:.3f} s (launches "
          f"{vk_launches}), make_prover_bn254 {make_s:.3f} s, the proof "
          f"{proof_s:.3f} s with launches {launches}; proof and vk equal "
          "phase 12's (the table route's)")
    print(f"card: {card}")


def cache_phase(dev, card: str, bn: dict, timings: dict) -> None:
    """Phase 34: phase 10 wrote the 2^12 SRS (under HOME) and its window
    table (under PLONK_TPU_CACHE), both emptied at the start; a fresh
    bn254_setup and a fresh context's table load them, computing nothing,
    and their words equal phase 10's, the packed table K4 reads too."""
    phase("34 the BN254 SRS and window-table disk caches: a fresh context "
          "loads phase 10's files")
    ctx = bn["ctx"]
    srs_path = os.path.join(HOME_DIR, ".cache", "plonk_tpu",
                            f"bn254_srs_n{N_BN}_s{BN_SECRET}.npz")
    tbl_path = PB._fb_cache_path(ctx, PB.bn254_fb_window_bits())
    check(os.path.exists(srs_path) and os.path.exists(tbl_path),
          "phase 10 wrote both cache files")
    with refusing(PB, "big_fixed_base_mul_many", "build_big_table"):
        ctx2, srs_s = wall(lambda: PB.bn254_setup(N_BN, secret=BN_SECRET,
                                                  device=dev))
        tbl2, tbl_s = wall(lambda: PB.bn254_fixed_base_table(ctx2))
    check(all(torch.equal(x, y) for x, y in zip(
        tuple(ctx2.srs.g1s) + tuple(ctx2.srs[1:5]),
        tuple(ctx.srs.g1s) + tuple(ctx.srs[1:5])))
        and ctx2.srs.length == ctx.srs.length,
        "the loaded SRS == phase 10's, words equal")
    tbl = PB.bn254_fixed_base_table(ctx)
    check(all(torch.equal(x, y) for x, y in zip(tbl2[:3], tbl[:3]))
          and torch.equal(PB.bn254_packed_table(ctx2),
                          PB.bn254_packed_table(ctx)),
          "the loaded table == phase 10's, and its packed form")
    print(f"SRS file {os.path.getsize(srs_path)} bytes, loaded in "
          f"{srs_s:.3f} s (built in {timings['bn_setup_s']:.3f} s); table "
          f"file {os.path.getsize(tbl_path)} bytes, loaded and packed in "
          f"{tbl_s:.3f} s (built, packed and written in "
          f"{timings['bn_table_build_s']:.3f} s); words equal")
    print(f"card: {card}")


BN_DIST_D = 8            # phase 35's shards at 2^12 (JAX's 8-device mesh)
BN_DIST_SMALL_D = 2      # phase 35's shards at n = 8 (JAX's TestDistProver)
BN_DIST_REPS = 1         # phase 35's single and sharded proofs, in turns
BN_DIST_PATH = f"sharded BN254 at 2^12 on {BN_DIST_D} shards"
BN_DIST_KERNELS = {**BN254_KERNELS, **DIST_KERNELS}
DIST_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "dist_bn254_jax.json")
# launches of one 2^12 proof under make_dist_bn254_prims on BN_DIST_D
# shards (precompute done in make_prover_bn254): two sharded
# interpolations (the witness stack, the accumulator), one forward and one
# inverse coset transform, each K3 twice (its column and its row
# transforms, all shards in one launch) and K9 three, three, two and two
# times; K8 once (the grand product's shard totals); K4 once a shard
BN_DIST_LAUNCHES = {
    "kernels": {"big_row": 8, "all_to_all": 10, "all_gather": 1,
                "big_commit": BN_DIST_D},
    "plain exchanges": {"big_row": 8, "big_commit": BN_DIST_D},
    "no table": {"big_row": 8, "all_to_all": 10, "all_gather": 1}}
# mode -> (exchange, PLONK_TPU_BN254_FB)
BN_DIST_MODES = {"kernels": (None, "1"), "plain exchanges": ("plain", "1"),
                 "no table": (None, "0")}


def bn_dist_cases(n: int, D: int) -> list:
    """(case name, shard shape, split axis, concat axis, whether a proof
    makes it) of every 16-limb all-to-all of a sharded BN254 proof of n
    gates on D shards and of its precompute: the transposes of the n-point
    interpolations (batches 9 in precompute, 4 and none; an
    interpolation's third all-to-all has its first's shape) and of the
    4n-point coset transforms (batches 10 in precompute, 6 and none), both
    ways."""
    cases = []
    for size, batches in ((n, (9, 4, None)), (4 * n, (10, 6, None))):
        n1, n2 = DN._split(size, D)
        for b in batches:
            lead = () if b is None else (b,)
            k = len(lead)
            for shape, split, concat in (
                    (lead + (n1 // D, n2, 16), k + 1, k),
                    (lead + (n1, n2 // D, 16), k, k + 1)):
                cases.append((f"{shape} split {split} concat {concat}",
                              shape, split, concat, b not in (9, 10)))
    return cases


def big_exchange_bound(name: str, D: int, shard_elems: int):
    """K8's and K9's least time on BN254 values: 32 bytes an element read
    once and written once (K9: D shards each way; K8 reads D shards and
    writes D*D); no arithmetic."""
    out = D * shard_elems * (D if name == "all_gather" else 1)
    return bound_ms((D * shard_elems + out) * BIG_BYTES, 0)


def recorded_proof_equal(proof, rec: dict) -> bool:
    """A proof equal to a recorded one (standard-form hex a field, a point
    [x, y] or None at infinity)."""
    point = lambda p: (None if bool(p.inf) else
                       [from_words(p.x.cpu()), from_words(p.y.cpu())])
    return (all(from_words(getattr(proof, f).cpu()) == int(rec[f], 16)
                for f in PB.SCALAR_FIELDS)
            and all(point(getattr(proof, f)) == (
                None if rec[f] is None else [int(v, 16) for v in rec[f]])
                for f in PB.POINT_FIELDS))


def bn_dist_small(dev, bn: dict) -> None:
    """Phase 35's n = 8 proof on a BN_DIST_SMALL_D-shard card mesh, on
    phase 11's n = 8 context (its SRS and window table built by the card
    under an empty cache of its own) and against phase 11's single-device
    card proof: on the table route and under PLONK_TPU_BN254_FB=0, each
    equal to that proof and to JAX's recorded sharded proof."""
    with open(DIST_GOLDEN) as f:
        rec = json.load(f)["proof_n8_d2"]
    ctx = bn["ctx8"]
    sel, cp, a, b, c = bn254_mul_circuit(N_BN_SMALL)
    ch, rnd = words_vec(BN_CH), words_vec(BN_RND)
    mesh = MS.make_1d_mesh("sp", BN_DIST_SMALL_D, device=dev)
    for fb in ("1", "0"):
        with switches(PLONK_TPU_BN254_FB=fb):
            kernels.reset_counts()
            (proof, diags), sec = wall(lambda: PB.prove_bn254(
                ctx, sel, cp, a, b, c, ch, rnd,
                prims=DB254.make_dist_bn254_prims(ctx, mesh)))
        launches = dict(kernels.LAUNCHES)
        check(bool(diags.all_ok()), f"n=8 sharded FB={fb} diagnostics")
        check(EN.proofs_equal(proof, bn["proof8"]),
              f"n=8 sharded FB={fb} proof == the single-device proof")
        check(recorded_proof_equal(proof, rec),
              f"n=8 sharded FB={fb} proof == JAX's sharded proof")
        check(launches.get("big_commit", 0) == (
            BN_DIST_SMALL_D if fb == "1" else 0),
            f"n=8 sharded FB={fb}: K4 once a shard, or not at all")
        print(f"n=8 on {BN_DIST_SMALL_D} shards, PLONK_TPU_BN254_FB={fb}: "
              f"proof with precompute {sec:.3f} s, launches {launches}; "
              "equal to the card's single-device proof and to JAX's "
              "recorded sharded proof")


def bn_dist_k3(dev, ctx, errs: dict, bounds: dict) -> dict:
    """K3's local transform in the sharded 2^12 proof (dist_bigntt._row_ntt:
    one row pass over every shard's rows, then the bit-reversal gather)
    against big_ntt, word-equal, one launch a call, at the proof's rows of
    64 and 128 with their roots, on random and edge rows. Returns the
    kernel_times entries."""
    Fr = ctx.Fr
    n1, _ = DN._split(N_BN, BN_DIST_D)
    m1, _ = DN._split(4 * N_BN, BN_DIST_D)
    inv = lambda w: pow(w, -1, Fr.p)
    cases = {   # name -> (rows of the launch, row length, root)
        f"witness interpolation ({4 * N_BN // n1}, {n1})":
            (4 * N_BN // n1, n1, pow(inv(ctx.omega), N_BN // n1, Fr.p)),
        f"coset fwd ({6 * 4 * N_BN // m1}, {m1})":
            (6 * 4 * N_BN // m1, m1, pow(ctx.omega4, 4 * N_BN // m1, Fr.p)),
        f"coset inv ({4 * N_BN // m1}, {m1})":
            (4 * N_BN // m1, m1, pow(inv(ctx.omega4), 4 * N_BN // m1,
                                     Fr.p))}
    rng = np.random.default_rng(35)
    kms = {}
    for name, (R, C, root) in cases.items():
        for kind in ("random", "edge rows"):
            if kind == "random":
                vals = rng.integers(0, 1 << 16, size=(R, C, 16))
                vals[..., 15] &= 0x0FFF                  # < 2^252 < r
            else:
                vals = big_edge_rows(Fr.p, R, C, True, rng)
            y = torch.as_tensor(vals, device=dev)
            if kind == "random":
                timed = y
            before = kernels.LAUNCHES["big_row"]
            got = DBN._row_ntt(Fr, y, root)
            want = BF.big_ntt(Fr, y, root)
            torch.cuda.synchronize()
            check(kernels.LAUNCHES["big_row"] == before + 1,
                  f"K3 local transform {name}: one launch a call")
            err = int((got - want).abs().max())
            print(f"K3 local transform {name}, {kind}: max_abs_err {err}")
            check(err == 0, f"K3 local transform == big_ntt, {name} {kind}")
            errs["big_row"] = max(errs.get("big_row", 0), err)
        bnd = big_row_bound(R, C, False)
        bounds.setdefault("big_row", bnd)
        kms[f"big_row {name}"] = kernel_times(
            lambda a=(timed, root): BN.big_row_pass(Fr, *a, True),
            lambda a=(timed, root): BF.big_ntt(Fr, *a))
        whole = cuda_ms(lambda a=(timed, root): DBN._row_ntt(Fr, *a),
                        reps=40, queue_ahead=True)
        print(f"K3 {name}: bound {bnd[0]:.6f} ms ({bnd[1]}); the local "
              f"transform with its gather {whole:.6f} ms (CUDA events, "
              "queued ahead)")
    return kms


def gather_check(label: str, cases: dict, bound, errs: dict, bounds: dict,
                 kms: dict) -> float:
    """K8's generic all-gather against the plain exchange on each of
    `cases` ({kind: D shards of one shape}), word-equal, one launch a call;
    the last case timed (kernel_times, under kms["all_gather <label>"]),
    and so is the one PyTorch call that computes the same words,
    torch.cat of D copies of the shards (every destination's rows in one
    tensor), by CUDA events queued ahead. `bound` is K8's on these shards.
    Returns the library call's ms."""
    for kind, xs in cases.items():
        before = kernels.LAUNCHES["all_gather"]
        got = CL.all_gather(xs, "cuda")
        want = CL.all_gather(xs, "plain")
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["all_gather"] == before + 1,
              f"all_gather {label}: one launch a call")
        err = max(int((a - b).abs().max()) for a, b in zip(got, want,
                                                           strict=True))
        print(f"all_gather of {label}, {kind}: max_abs_err {err}")
        check(err == 0, f"K8's generic all-gather word-equal at {label}, "
              f"{kind}")
        errs["all_gather"] = max(errs.get("all_gather", 0), err)
    D = len(xs)
    library = lambda: torch.cat(xs * D)
    check(torch.equal(library(), torch.cat(want)),
          f"torch.cat of {D} copies == the plain exchange at {label}")
    bounds["all_gather"] = bound
    kms[f"all_gather {label}"] = kernel_times(
        lambda: CL.all_gather(xs, "cuda"), lambda: CL.all_gather(xs, "plain"))
    lib = cuda_ms(library, reps=100, queue_ahead=True)
    print(f"all_gather {label}: bound {bound[0]:.9f} ms ({bound[1]}); "
          f"library (torch.cat of {D} copies) {lib:.6f} ms (CUDA events, "
          "queued ahead)")
    return lib


def bn_dist_exchanges(dev, errs: dict, bounds: dict):
    """K9 against all_to_all_plain at every bn_dist_cases shape of the 2^12
    proof on BN_DIST_D shards, and K8's generic all-gather against the
    plain exchange at BN_DIST_D x (1, 16) (gather_check); K9 timed at the
    proof's forward transposes (split after concat). Returns
    (kernel_times entries, the library ms of K9 (the plain all-to-all's
    queued ms of the first timed case) and of K8, the shapes checked)."""
    g = torch.Generator(device="cpu").manual_seed(35)
    kms, library, tested = {}, None, set()
    for name, shape, split, concat, per_proof in bn_dist_cases(N_BN,
                                                               BN_DIST_D):
        xs = [torch.randint(0, 1 << 16, shape, generator=g).to(dev)
              for _ in range(BN_DIST_D)]
        before = kernels.LAUNCHES["all_to_all"]
        got = CL.all_to_all(xs, split, concat, "cuda")
        want = CL.all_to_all_plain(xs, split, concat)
        torch.cuda.synchronize()
        check(kernels.LAUNCHES["all_to_all"] == before + 1,
              f"all_to_all {name}: one launch a call")
        err = max(int((a - b).abs().max()) for a, b in zip(got, want,
                                                           strict=True))
        print(f"all_to_all {name} on {BN_DIST_D} shards: max_abs_err {err}")
        check(err == 0, f"K9 word-equal at {name}")
        errs["all_to_all"] = max(errs.get("all_to_all", 0), err)
        tested.add(("all_to_all", shape))
        if not per_proof or split < concat:     # checked, not timed
            continue
        whole = lambda: CL.all_to_all(xs, split, concat, "cuda")
        plain = lambda: CL.all_to_all(xs, split, concat, "plain")
        kms[f"all_to_all {name}"] = kernel_times(whole, plain)
        lib = cuda_ms(plain, reps=20, queue_ahead=True)
        library = lib if library is None else library
        elems = int(np.prod(shape[:-1]))
        bnd = big_exchange_bound("all_to_all", BN_DIST_D, elems)
        bounds.setdefault("all_to_all", bnd)
        print(f"all_to_all {name}: plain whole call {lib:.6f} ms (CUDA "
              f"events, queued ahead); bound {bnd[0]:.6f} ms (bytes); int64 "
              f"floor {int64_floor_ms(2 * BN_DIST_D * elems * 16):.6f} ms")
    xs = [torch.randint(0, 1 << 16, (1, 16), generator=g).to(dev)
          for _ in range(BN_DIST_D)]
    gather_lib = gather_check(
        f"{BN_DIST_D} x (1, 16) shard totals", {"random": xs},
        big_exchange_bound("all_gather", BN_DIST_D, 1), errs, bounds, kms)
    tested.add(("all_gather", (1, 16)))
    return kms, {"all_to_all": library, "all_gather": gather_lib}, tested


def bn_dist_k4(dev, ctx, mesh, errs: dict, bounds: dict) -> dict:
    """K4 on the first and the last shard's slice of the window table (the
    last one's padding entries at infinity) against its plain version,
    affine-equal, at B = 9 random scalars below r, padded lanes included.
    Returns the kernel_times entry of the first slice (the plain version
    timed once on the host clock: it takes seconds)."""
    Fq = ctx.Fq
    shards = DB254._table_shards(ctx, mesh)
    rng = np.random.default_rng(36)
    kms = {}
    for d in (0, len(shards) - 1):
        tbl, pk = shards[d]
        Ls = tbl.x.shape[2]
        sc = rng.integers(0, 1 << 16, size=(9, Ls, 16))
        sc[..., 15] &= 0x0FFF
        scalars = torch.as_tensor(sc, device=dev)
        kernels.reset_counts()
        got = BC.big_to_affine(Fq, BK.big_commit_many(Fq, tbl, scalars, pk))
        check(kernels.LAUNCHES == {"big_commit": 1}, "K4: one launch")
        plain, plain_s = wall(lambda: BK.big_commit_many_plain(Fq, tbl,
                                                               scalars))
        err = affine_err(got, BC.big_to_affine(Fq, plain))
        pad = int(tbl.inf[0, 1].sum())
        print(f"K4 on shard {d}'s table slice (B = 9, {Ls} points, {pad} "
              f"of them padding at infinity): max_abs_err {err}")
        check(err == 0, f"K4 affine-equal on shard {d}'s slice")
        errs["big_commit"] = max(errs.get("big_commit", 0), err)
        if d == 0:
            bounds["big_commit"], terms, _ = big_commit_bound(tbl, scalars)
            kms[f"big_commit shard slice B=9 L={Ls}"] = (
                cuda_ms(lambda: BK.big_commit_many(Fq, tbl, scalars, pk),
                        reps=50, queue_ahead=True), plain_s * 1e3,
                device_ms(lambda: BK.big_commit_many(Fq, tbl, scalars, pk)))
            print(f"K4 shard slice: bound {bounds['big_commit'][0]:.6f} ms "
                  f"({bounds['big_commit'][1]}), {terms} terms with a "
                  "nonzero digit")
    return kms


def dist_bn254_phase(dev, card: str, bn: dict, profile: bool) -> list:
    """Phase 35: the mesh-sharded BN254 prover (parallel/dist_bn254.py) on
    the card, with `profile` a sharded proof's device events, device time
    and idle share; returns the kernel entries of its 2^12 path."""
    phase("35 the sharded BN254 prover: n = 8 on 2 shards, K3, K4, K8 and "
          f"K9 at its shapes, 2^12 on {BN_DIST_D} shards")
    bn_dist_small(dev, bn)
    ctx = bn["ctx"]
    mesh = MS.make_1d_mesh("sp", BN_DIST_D, device=dev)
    errs, bounds = {}, {}
    kms = bn_dist_k3(dev, ctx, errs, bounds)
    ex_kms, library, tested = bn_dist_exchanges(dev, errs, bounds)
    kms.update(bn_dist_k4(dev, ctx, mesh, errs, bounds))
    kms.update(ex_kms)

    sel, cp, a, b, c = bn["circuit"]
    ch, rnd = words_vec(BN_CH), words_vec(BN_RND)
    seen = set()
    launch = CL._launch

    def recorded(name, srcs, *rest):
        seen.add((name, tuple(srcs[0].shape)))
        return launch(name, srcs, *rest)

    provers, launches = {}, {}
    for mode, (exchange, fb) in BN_DIST_MODES.items():
        with switches(PLONK_TPU_BN254_FB=fb):
            prims = DB254.make_dist_bn254_prims(ctx, mesh, exchange=exchange)
            CL._launch = recorded
            try:
                prover, make_s = wall(lambda: PB.make_prover_bn254(
                    ctx, sel, cp, prims=prims))
                kernels.reset_counts()
                (proof, diags), proof_s = wall(lambda: prover(a, b, c, ch,
                                                              rnd))
            finally:
                CL._launch = launch
        counts = dict(kernels.LAUNCHES)
        print(f"2^12 on {BN_DIST_D} shards, {mode}: make_prover_bn254 "
              f"{make_s:.3f} s, first proof {proof_s:.3f} s, launches "
              f"{counts}; diagnostics {diags}")
        check(counts == BN_DIST_LAUNCHES[mode],
              f"sharded 2^12 proof, {mode}: launches {counts}")
        check(bool(diags.all_ok()), f"sharded 2^12 diagnostics, {mode}")
        check(EN.proofs_equal(proof, bn["proof"]),
              f"sharded 2^12 proof ({mode}) == phase 12's, word for word")
        provers[mode] = prover
        if mode == "kernels":
            launches = counts
    check(seen <= tested, f"every exchange of the sharded proof checked: "
          f"{sorted(seen - tested)}")
    print(f"the three sharded proofs equal phase 12's; {len(seen)} exchange "
          "shapes, each checked above")

    rnd_rep = lambda rep: words_vec([v + 300 + 9 * rep for v in BN_RND])
    turns = {"single-device": bn["prover"], "sharded": provers["kernels"]}
    total = collections.Counter()
    for rep in range(BN_DIST_REPS):
        for name, prover in turns.items():
            if name == "sharded":       # its peak: the last one's
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            (_, d), sec = wall(lambda: prover(a, b, c, ch, rnd_rep(rep)))
            if name == "sharded":
                peak = torch.cuda.max_memory_allocated()
            check(bool(d.all_ok()), f"{name} rep {rep} diagnostics")
            total[name] += sec
    print(f"card: {card}")
    for name in turns:
        print(f"bn_dist proofs_per_s {name} "
              f"{BN_DIST_REPS / total[name]:.6f} ({BN_DIST_REPS} "
              "synchronised proofs, in turns)")
    print(f"sharded proof peak memory {peak / 2 ** 30:.3f} GiB "
          f"({(peak - base) / 2 ** 30:.3f} GiB above the {base / 2 ** 30:.3f}"
          " GiB allocated before it)")
    if profile:
        print_profile(*profiled_proofs(
            lambda rep: provers["kernels"](a, b, c, ch, rnd_rep(20 + rep)),
            1), total["sharded"] / BN_DIST_REPS, 1)
    print_kernel_times(kms)
    entries = kernel_entries(BN_DIST_KERNELS, kms, launches, errs, bounds,
                             library)
    for e in entries:
        e["path"] = BN_DIST_PATH
    return entries


MSM_DIST_N = 1 << 16     # phase 36's points (bench.py's bench_msm)
MSM_DIST_D = 8           # phase 36's shards (the dry run's mesh)
MSM_DIST_REPS = 2        # phase 36's sharded and single-device calls, in turns
MSM_DIST_PATH = f"dist_msm at 2^16 toy points on {MSM_DIST_D} shards"
TRACE_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "plonk_tpu_trace")
DRYRUN_DIR = os.path.join(os.path.dirname(kernels.BUILD_DIR), "dryrun_caches")
# the dry run's kernels on the card: K9 (dist-intt, the sharded provers'
# transposes), K8 (dist-msm's gather, the scaled prefix scan, the BN254
# totals), K2 (the scaled commits), K3 and K4 (the BN254 leg); no K1 (its
# transforms are below ntt's 4096-point blocked layout)
DRYRUN_KERNELS = ("all_to_all", "all_gather", "commit_many", "big_row",
                  "big_commit")


def toy_msm_inputs(dev, n: int):
    """bench_msm's draw: n multiples k_i G of the toy generator, k_i in
    [1, 17) and scalars in [0, 17) from default_rng(1) (5-bit ladders)."""
    F = Field(GF101)
    rng = np.random.default_rng(1)
    ks = torch.as_tensor(rng.integers(1, 17, size=n), device=dev)
    sc = torch.as_tensor(rng.integers(0, 17, size=n), device=dev)
    return C.g1_mul(F, C.g1_generator(TOY_CURVE, F, dev), ks, nbits=5), sc


def toy_point(p) -> tuple:
    return int(p.x), int(p.y), bool(p.inf)


def partials_bound(D: int):
    """K8's least time on dist_msm's partials: D partials read once and
    D * D written, a partial's values 3 bytes (x and y below 101, the
    infinity flag); no arithmetic."""
    return bound_ms((D + D * D) * 3, 0)


def msm_trace(dev) -> dict:
    """One sharded dist_msm call (bench_msm's inputs on MSM_DIST_D shards)
    under profiling.trace_to, after a warm one: the written trace's device
    events, their summed device ms, and how many of them are K8's
    all_gather_kernel."""
    F = Field(GF101)
    pts, sc = toy_msm_inputs(dev, MSM_DIST_N)
    mesh = MS.make_1d_mesh("sp", MSM_DIST_D, device=dev)
    call = lambda: DM.dist_msm(F, mesh, pts, sc, window_bits=5,
                               scalar_bits=5)
    call()
    torch.cuda.synchronize()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with PF.trace_to(TRACE_DIR):
        call()
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(TRACE_DIR, "*.pt.trace.json"))
    check(len(files) == 1, f"trace_to wrote one trace: {files}")
    events = PF.device_events(files[0])
    return dict(events=len(events),
                device_ms=sum(us for _, us in events) / 1e3,
                k8_events=sum("all_gather_kernel" in name
                              for name, _ in events))


def dist_msm_phase(dev, card: str) -> list:
    """Phase 36: the sharded MSM in bench_msm's configuration on
    MSM_DIST_D shards of the card (through K8 and through plain copies,
    equal to the single-device msm_pippenger and to the CPU port's),
    K8's generic all-gather at the partials' shape against the plain
    exchange, points/s in turns; the port's entry() against the CPU port;
    dryrun_multichip(8); trace_to around a sharded call. Returns the
    kernel entry of K8 on this path."""
    phase(f"36 dist_msm at {MSM_DIST_N} toy points on {MSM_DIST_D} shards "
          "(bench_msm), K8 at the partials' shape, entry(), "
          "dryrun_multichip(8), trace_to")
    t36 = time.perf_counter()
    F = Field(GF101)
    mesh = MS.make_1d_mesh("sp", MSM_DIST_D, device=dev)
    pts, sc = toy_msm_inputs(dev, MSM_DIST_N)
    msm = lambda s, exchange=None: DM.dist_msm(
        F, mesh, pts, s, window_bits=5, scalar_bits=5, exchange=exchange)
    single = lambda s: msm_pippenger(F, pts, s, window_bits=5, scalar_bits=5)
    cpu_pts, cpu_sc = toy_msm_inputs("cpu", MSM_DIST_N)
    cpu_pt, cpu_s = wall(lambda: toy_point(DM.dist_msm(
        F, MS.make_1d_mesh("sp", MSM_DIST_D, device="cpu"), cpu_pts, cpu_sc,
        window_bits=5, scalar_bits=5)))
    want, single_s = wall(lambda: toy_point(single(sc)))
    points = {}
    for mode, exchange, launches in (("kernels", None, {"all_gather": 1}),
                                     ("plain exchange", "plain", {})):
        kernels.reset_counts()
        got, sec = wall(lambda: msm(sc, exchange))
        counts = dict(kernels.LAUNCHES)
        print(f"dist_msm, {mode}: first call {sec:.3f} s, launches {counts}, "
              f"point {toy_point(got)}")
        check(counts == launches, f"dist_msm ({mode}) launches {counts}")
        check(got.x.device == mesh.device, "dist_msm's point on the card")
        points[mode] = toy_point(got)
        if mode == "kernels":
            path_launches = counts
    check(points["kernels"] == points["plain exchange"] == want == cpu_pt,
          "dist_msm == single-device msm_pippenger == the CPU port's")
    print(f"dist_msm == the card's single-device msm_pippenger (first call "
          f"{single_s:.3f} s) == the CPU port's dist_msm ({cpu_s:.3f} s): "
          f"{want}")

    # K8 alone at the partials' shape: D (1, 3) int64 rows, random 62-bit
    # words and the rows of this call (timed)
    errs, bounds, kms = {}, {}, {}
    part = msm_pippenger(F, C.G1(*(torch.stack(MS.shard_vector(mesh, t))
                                   for t in pts)),
                         torch.stack(MS.shard_vector(mesh, sc)), 5, 5)
    rows = torch.stack([part.x, part.y, part.inf.long()], -1)
    g = torch.Generator(device="cpu").manual_seed(36)
    library = gather_check(
        f"{MSM_DIST_D} x (1, 3) dist_msm partials",
        {"random": [torch.randint(0, 1 << 62, (1, 3), generator=g).to(dev)
                    for _ in range(MSM_DIST_D)],
         "partials": list(rows[:, None].unbind(0))},
        partials_bound(MSM_DIST_D), errs, bounds, kms)

    total = collections.Counter()
    turns = {"sharded": msm, "single-device": single}
    for rep in range(MSM_DIST_REPS):
        s = torch.roll(sc, rep + 1)          # bench_msm's rolled scalars
        for name, fn in turns.items():
            _, sec = wall(lambda: fn(s))
            total[name] += sec
    msm_s = total["sharded"] / MSM_DIST_REPS
    print(f"card: {card}")
    for name in turns:
        print(f"dist_msm points_per_s {name} "
              f"{MSM_DIST_REPS * MSM_DIST_N / total[name]:.1f} "
              f"({MSM_DIST_REPS} synchronised calls, in turns, "
              f"{total[name] / MSM_DIST_REPS:.6f} s a call)")

    outs = []
    for d in ("cpu", dev):
        fn, args = EN.entry(device=d)
        kernels.reset_counts()
        out, sec = wall(lambda: fn(*args))
        check(not dict(kernels.LAUNCHES), f"entry() on {d}: no kernel")
        outs.append(out)
        print(f"entry() on {d}: r_z = {int(out[0].r_z)}, {sec:.3f} s")
    check(int(outs[1][0].r_z) == 15, "entry() on the card: r_z == 15")
    check(EN.proofs_equal(outs[0][0], outs[1][0]) and all(
        torch.equal(u.cpu(), v.cpu()) for u, v in zip(*(o[1] for o in outs))),
        "entry() on the card == the CPU port's, every word")

    # the dry run's BN254 SRS and both window tables built under empty
    # caches of its own
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    with switches(HOME=DRYRUN_DIR, PLONK_TPU_CACHE=DRYRUN_DIR):
        kernels.reset_counts()
        legs, sec = wall(lambda: EN.dryrun_multichip(MSM_DIST_D, dev))
    counts = dict(kernels.LAUNCHES)
    print(f"dryrun_multichip({MSM_DIST_D}): {len(legs)} legs ok in "
          f"{sec:.3f} s, launches {counts}")
    check([n for n, _ in legs] == [n for n, _ in EN.dryrun_legs(
        MSM_DIST_D, dev)], "the dry run's five legs")
    check(all(counts.get(k, 0) > 0 for k in DRYRUN_KERNELS)
          and "row_stages" not in counts,
          f"the dry run launches {DRYRUN_KERNELS} and no K1: {counts}")

    ev = msm_trace(dev)
    print(f"trace_to around one sharded dist_msm call, after this "
          f"process's earlier torch.profiler sessions: {ev['events']} "
          f"device events, {ev['device_ms']:.3f} ms of device time (the "
          f"device idle {100 * (1 - ev['device_ms'] / 1e3 / msm_s):.1f} % "
          f"of an unprofiled call), K8's all_gather_kernel "
          f"{'recorded' if ev['k8_events'] else 'not recorded'} "
          f"({ev['k8_events']} events)")
    print_kernel_times(kms)
    print(f"phase 36 took {time.perf_counter() - t36:.1f} s")
    entries = kernel_entries({"all_gather": DIST_KERNELS["all_gather"]}, kms,
                             path_launches, errs, bounds,
                             {"all_gather": library})
    for e in entries:
        e["path"] = MSM_DIST_PATH
    return entries


# K1's and K2's kernels in the ptxas report (a substring of the mangled
# name)
K1_ENTRY = "row_stages_kernel"
K2_ENTRY = "commit_many_kernel"


def k1_phase(dev, errs: dict):
    """Phase 3: K1's ptxas report (no spills), then K1 against its plain
    version, word-equal, at the main path's shapes on random rows and on
    edge rows, with each shape's bound and int64 floor. Returns the field
    and each shape's random inputs for timing."""
    phase("3 K1 row_stages vs plain at the main path's shapes")
    ptxas_report(K1_ENTRY)
    pp = PS.scaled_plonk_params(N_MAIN)
    Fr = MontField(pp.field)
    rng = np.random.default_rng(0)
    k1_cases = {
        # the 2^18 coset stack of the proof (5 rows, forward root)
        "coset 5x2^18": (5, 4 * N_MAIN, pp.field.root_of_unity(4 * N_MAIN)),
        # the 2^16 circuit interpolation stack (9 rows, inverse root)
        "interp 9x2^16": (9, N_MAIN, pow(pp.omega, -1, Fr.p)),
    }
    inputs = {}
    for name, (rows, n, w) in k1_cases.items():
        intra, _ = N._device_tables(Fr, w, n, 1024, dev)
        R = rows * n // 1024
        for kind in ("random", "edge rows"):
            vals = (rng.integers(0, Fr.p, size=(R, 1024)) if kind == "random"
                    else edge_rows(Fr.p, R, 1024, rng))
            y = torch.as_tensor(vals, device=dev)
            got = RS.row_stages(Fr.p, Fr.n_prime, y, intra)
            want = RS.row_stages_plain(Fr.p, Fr.n_prime, y, intra)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            print(f"K1 {name} {tuple(y.shape)}, {kind}: max_abs_err {err}")
            check(err == 0, f"K1 word-equal at {name}, {kind}")
            errs["row_stages"] = max(errs.get("row_stages", 0), err)
            if kind == "random":
                inputs[name] = (y, intra)
        bnd = row_bound(R, 1024)
        print(f"K1 {name} {(R, 1024)}: bound {bnd[0]:.6f} ms ({bnd[1]}); "
              f"int64 floor {int64_floor_ms(2 * R * 1024):.6f} ms")
    return Fr, inputs


def k2_phase(dev, timings: dict, errs: dict):
    """Phase 4: the 2^16 setup and window table, timed; K2's ptxas report
    (no spills); K2 against its plain version, affine-equal, at the main
    path's shape (B = 9, L = n + 6), at one shard's of the 8-shard mesh
    (B = 9, L = 8 193) and on a batch with zero scalars and repeated,
    opposite and infinity bases. Returns the context and each shape's
    (table, scalars) for timing."""
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
    ptxas_report(K2_ENTRY)
    shard = DP._pad_table(ctx, MS.make_1d_mesh("sp", D_MESH, device=dev))[0]
    r = ctx.params.curve.r
    rng = np.random.default_rng(0)
    inputs = {}
    for t in (tbl, shard):
        B, Lt = 9, t.x.shape[2]
        scalars = torch.as_tensor(rng.integers(0, ctx.params.field.p,
                                               size=(B, Lt)), device=dev)
        got = CM.msm_fixed_base_many_kernel(Fq, t, scalars)
        want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, t, scalars))
        err = affine_err(got, want)
        print(f"K2 B={B} L={Lt}: max_abs_err {err}")
        check(err == 0 and not bool(got.inf.any()),
              f"K2 affine-equal, B={B} L={Lt}")
        errs["commit_many"] = max(errs.get("commit_many", 0), err)
        inputs[f"B={B} L={Lt}"] = (t, scalars)
    # zero scalars; repeated, opposite and infinity base points; a row of
    # scalars r, whose terms of one point sum to infinity in one thread
    # (H = 0 at its top window), and of 7 * 2^24 + 2^22 - 1, whose top term
    # equals the sum of the others (a doubling)
    ks = rng.integers(0, 64, size=4096)
    ks[1::3] = r - ks[1::3]
    pts = C.g1_mul(Fq, C.g1_generator(ctx.params.curve, Fq, dev),
                   torch.as_tensor(ks % r, device=dev), nbits=r.bit_length())
    edge_tbl = CM.build_commit_table(Fq, pts, r.bit_length())
    sc = rng.integers(0, r, size=(5, 4096))
    sc[0, ::4] = 0
    sc[1] = 0
    sc[3] = r
    sc[4] = 7 * 2 ** 24 + 2 ** 22 - 1
    edge = torch.as_tensor(sc, device=dev)
    got = CM.msm_fixed_base_many_kernel(Fq, edge_tbl, edge)
    want = C.jac_to_affine(Fq, CM.commit_many_plain(Fq, edge_tbl, edge))
    err = affine_err(got, want)
    print(f"K2 edge batch (zero rows, infinity/repeated/opposite bases): "
          f"max_abs_err {err}, infinity rows {got.inf.tolist()}")
    check(err == 0 and bool(got.inf[1]), "K2 affine-equal, edge batch")
    errs["commit_many"] = max(errs["commit_many"], err)
    return ctx, inputs


def k12_times(Fr, Fq, k1_inputs: dict, k2_inputs: dict) -> dict:
    """kernel_times of K1 and K2 at each of their phase 3 and 4 shapes."""
    kms = {}
    for name, (y, intra) in k1_inputs.items():
        kms[f"row_stages {name}"] = kernel_times(
            lambda a=(y, intra): RS.row_stages(Fr.p, Fr.n_prime, *a),
            lambda a=(y, intra): RS.row_stages_plain(Fr.p, Fr.n_prime, *a),
            plain_reps=10)
    for name, (tbl, scalars) in k2_inputs.items():
        kms[f"commit_many {name}"] = kernel_times(
            lambda a=(tbl, scalars): CM.commit_many(Fq, *a),
            lambda a=(tbl, scalars): CM.commit_many_plain(Fq, *a))
    return kms


def k12_bounds(k1_inputs: dict, k2_inputs: dict) -> dict:
    """Print K1's and K2's bound at each of their shapes; returns the
    bound of each one's first shape (the shape of the kernels line)."""
    bounds = {}
    for name, (y, _) in k1_inputs.items():
        bnd = row_bound(*y.shape)
        bounds.setdefault("row_stages", bnd)
        print(f"row_stages {name}: bound {bnd[0]:.6f} ms ({bnd[1]}); int64 "
              f"floor {int64_floor_ms(2 * y.numel()):.6f} ms")
    for name, (tbl, scalars) in k2_inputs.items():
        bnd, terms, entries = commit_bound(tbl, scalars)
        bounds.setdefault("commit_many", bnd)
        print(f"commit_many {name}: bound {bnd[0]:.6f} ms ({bnd[1]}); "
              f"{terms} terms with a nonzero digit, {entries} distinct "
              "table entries they select")
    return bounds


# The arithmetic under K2, timed alone: chains of dependent Montgomery
# products, mixed additions and complete additions, built from
# csrc/commit.cu's own device functions.
ARITH_PROBE_CU = r"""
#include "commit.cu"
template <int OP>
__global__ void arith_probe(CurveConsts k, int n, uint32_t* out) {
  uint32_t a = threadIdx.x + 5u;
  Jac acc{threadIdx.x + 5u, 7u, 1u}, q{11u, 13u + threadIdx.x, 3u};
  for (int i = 0; i < n; ++i) {
    if (OP == 0) a = fmul(a, 77u + i, k.f);
    if (OP == 1)
      acc = jac_madd(k, acc, (unsigned long long)(i + 3) << 32 | (i * 7u + 1));
    if (OP == 2) {
      acc = jac_add(k, acc, q);
      q.X += 1;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a ^ acc.X ^ acc.Y ^ acc.Z;
}
extern "C" int arith_probe_launch(int op, int blocks, int threads, int n,
                                  unsigned p, unsigned n_prime, unsigned one,
                                  void* out) {
  CurveConsts k{MontParams{p, n_prime}, one, one, one, one};
  uint32_t* o = (uint32_t*)out;
  if (op == 0) arith_probe<0><<<blocks, threads>>>(k, n, o);
  if (op == 1) arith_probe<1><<<blocks, threads>>>(k, n, o);
  if (op == 2) arith_probe<2><<<blocks, threads>>>(k, n, o);
  return (int)cudaGetLastError();
}
"""


def arith_probe(dev) -> None:
    """The dependent latency (one warp alone) and the throughput (8 blocks
    of 256 threads an SM) of K2's Montgomery product, mixed addition and
    complete addition, each as a chain of 2000 in every thread."""
    import ctypes
    src = os.path.join(kernels.BUILD_DIR, "arith_probe.cu")
    lib_path = os.path.join(kernels.BUILD_DIR, "libarith_probe.so")
    with open(src, "w") as f:
        f.write(ARITH_PROBE_CU)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", kernels.ARCH, "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", kernels.CSRC,
                    "-o", lib_path, src], check=True, capture_output=True,
                   timeout=600)
    lib = ctypes.CDLL(lib_path)
    lib.arith_probe_launch.argtypes = ([ctypes.c_int] * 4
                                       + [ctypes.c_uint] * 3
                                       + [ctypes.c_void_p])
    Fq = MontField(SCALED_FQ)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(8 * sms * 256, dtype=torch.int32, device=dev)
    n = 2000
    for op, name in enumerate(("Montgomery product", "mixed addition",
                               "complete addition")):
        def run(blocks, threads, op=op):
            check(lib.arith_probe_launch(op, blocks, threads, n, Fq.p,
                                         Fq.n_prime, Fq.const(1),
                                         out.data_ptr()) == 0,
                  "arith_probe launches")
        one = cuda_ms(lambda: run(1, 32), reps=5, queue_ahead=True)
        full = cuda_ms(lambda: run(8 * sms, 256), reps=5, queue_ahead=True)
        print(f"K2 arithmetic, {name}: {one * 1e6 / n:.3f} ns dependent "
              f"latency; {8 * sms * 256 * n / full / 1e6:.3f} per ns over "
              f"the card (chains of {n}, CUDA events)")


def kernels_only(dev, card: str) -> None:
    """--kernels: K1 and K2 (phases 3 and 4's checks, phase 7's times), K3
    (phase 9's checks, phase 13's times) and K6 (phase 14's checks, edge
    inputs and pass split, phase 16's times) at their path shapes, without
    the provers."""
    errs = {}
    Fr, k1_inputs = k1_phase(dev, errs)
    ctx, k2_inputs = k2_phase(dev, {}, errs)
    kms = k12_times(Fr, ctx.Fq, k1_inputs, k2_inputs)
    # the packed table's other entry order, (W, L, nb) in memory, timed
    # beside the wrapper's (W, nb, L)
    for name, (tbl, scalars) in k2_inputs.items():
        other = tbl._replace(packed=tbl.packed.transpose(1, 2).contiguous()
                             .transpose(1, 2))
        got = C.jac_to_affine(ctx.Fq, CM.commit_many(ctx.Fq, other, scalars))
        want = CM.msm_fixed_base_many_kernel(ctx.Fq, tbl, scalars)
        check(affine_err(got, want) == 0, f"K2 (W, L, nb) order at {name}")
        ms = {order: cuda_ms(lambda t=t: CM.commit_many(ctx.Fq, t, scalars),
                             reps=100, queue_ahead=True)
              for order, t in (("(W, nb, L)", tbl), ("(W, L, nb)", other),
                               ("(W, nb, L) again", tbl))}
        print(f"commit_many {name} by entry order in memory (CUDA events, "
              "queued ahead): " + ", ".join(f"{k} {v:.6f} ms"
                                            for k, v in ms.items()))
    k12_bounds(k1_inputs, k2_inputs)
    for name, (y, _) in k1_inputs.items():
        copy_ms = cuda_ms(y.clone, reps=100, queue_ahead=True)
        print(f"row_stages {name}: a copy of the same int64 words "
              f"(y.clone()) {copy_ms:.6f} ms (CUDA events, queued ahead)")
    arith_probe(dev)
    sass = sass_opcodes(K2_ENTRY, ("IMAD.WIDE", "IMAD.HI", "IMAD",
                                   "VIADDMNMX", "IADD3", "LDG"))
    print(f"{K2_ENTRY} SASS (static, IMAD counts every IMAD form): {sass}")
    phase("9 K3 big_row vs plain at the 2^12 path's shapes")
    Fb = BigMontField(BN254_FR)
    kms.update(k3_times(Fb, k3_checks(dev, Fb, errs, {})))
    phase("14 K6 onepass_ntt vs plain at the 2^18 coset transforms' shapes")
    F = MontField(SCALED_FR)
    m = 4 * N_MAIN
    n1, n2 = FN._split(m)
    gen = torch.Generator(device="cpu").manual_seed(3)
    ptxas_report("onepass_kernel")
    for name, nb, inverse in (("proof fwd (5, 512, 512)", 5, False),
                              ("inverse (1, 512, 512) scaled", 1, True)):
        args = onepass_args(F, torch.randint(0, F.p, (nb, n1, n2),
                                             generator=gen).to(dev),
                            SCALED_FR.root_of_unity(m), inverse)
        err = int((FN.onepass_ntt(*args) - FN.onepass_plain(*args)).abs()
                  .max())
        print(f"onepass_ntt {name}: max_abs_err {err}")
        check(err == 0, f"K6 word-equal at {name}")
        print_split(name, onepass_split(*args))
        kms[f"onepass_ntt {name}"] = kernel_times(
            lambda a=args: FN.onepass_ntt(*a),
            lambda a=args: FN.onepass_plain(*a))
        bnd = onepass_bound(nb, n1, n2, inverse)
        print(f"onepass_ntt {name}: bound {bnd[0]:.6f} ms ({bnd[1]}); "
              f"int64 floor {int64_floor_ms(2 * nb * n1 * n2):.6f} ms")
    k6_edge_checks(F, dev)
    phase("14 K5 row_transform vs plain at the 2^18 coset transforms' "
          "shapes")
    ptxas_report(K5_ENTRY)
    for name, (args, bnd) in k5_checks(F, dev, SCALED_FR.root_of_unity(m),
                                       m, errs).items():
        kms[f"row_transform {name}"] = kernel_times(
            lambda a=args: RS.row_transform(*a),
            lambda a=args: RS.row_transform_plain(*a))
        print(f"row_transform {name}: bound {bnd[0]:.6f} ms ({bnd[1]}); "
              f"int64 floor {int64_floor_ms(2 * args[2].numel()):.6f} ms")
    phase("17 K8 (the grand product's prefix scan and all_gather) and K9 "
          "all_to_all vs plain at the 2^16 sharded path's shapes")
    timed, _, tested = exchange_checks(dev, F.p, N_MAIN, m, errs)
    scan_mesh, scan_xs = scan_checks(dev, F, errs, tested)
    kms["all_gather prefix scan"] = scan_times(F, scan_mesh, scan_xs)
    scan_shapes(F, dev)
    kms.update(a2a_times(timed)[0])
    kms.update(gather_times(timed))
    print(f"card: {card}")
    print_kernel_times(kms)
    print(f"kernels checked and timed in {time.perf_counter() - T0:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="add phase 8: stage times, device time and idle "
                         "share of a proof, verify split")
    ap.add_argument("--kernels", action="store_true",
                    help="only phases 1 and 2, then K1, K2, K3, K5, K6, "
                         "K8 and K9 against their plain versions with "
                         "their times, ptxas reports and K6's pass split; "
                         "no result line")
    ap.add_argument("--dist-events", metavar="MODE",
                    choices=[f"{k}-{x}" for k in ("scan", "proof")
                             for x in ("cuda", "plain")],
                    help="only print the device events and device time a "
                         "call of the sharded grand product (scan-*) or a "
                         "sharded proof (proof-*) under torch.profiler, "
                         "as a JSON line (the kernels already built)")
    args = ap.parse_args()
    if args.dist_events:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device visible to torch")
        dist_events(torch.device("cuda:0"), args.dist_events)
        return
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible to torch")
    # the window tables' disk cache, in the checkout and empty, so that
    # phase 4 builds its table and phase 25 loads it
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    os.environ["PLONK_TPU_CACHE"] = CACHE_DIR
    # the BN254 SRS cache (~/.cache/plonk_tpu, as in the JAX package) under
    # an empty HOME in the checkout, so that phase 10 writes and phase 34
    # loads it
    shutil.rmtree(HOME_DIR, ignore_errors=True)
    os.environ["HOME"] = HOME_DIR
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
    BUILD_LOG.append(log)
    kernels.library()
    print(f"nvcc build {time.perf_counter() - t:.3f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    if args.kernels:
        kernels_only(dev, card)
        return

    timings = {}
    errs = {}
    Fr, k1_inputs = k1_phase(dev, errs)
    ctx, k2_inputs = k2_phase(dev, timings, errs)
    pp = ctx.params
    Fq = ctx.Fq

    phase("5 n = 16 proof: GPU vs CPU port vs recorded JAX values")
    small = []
    for d in ("cpu", dev):
        c16 = PS.scaled_new(N_SMALL, device=d)
        sel, cp, a, b, c = square_chain_circuit(pp.field.p, N_SMALL)
        proof, diags = PS.make_prover(c16, sel, cp)(a, b, c, CH, RND)
        check(bool(diags.all_ok()), f"n=16 diagnostics on {d}")
        small.append((c16, proof))
    (c16, p_cpu), (_, p_gpu) = small
    check(EN.proofs_equal(p_cpu, p_gpu), "n=16 GPU proof equals CPU proof")
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
    kms = k12_times(Fr, Fq, k1_inputs, k2_inputs)
    timings["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"card: {card}")
    for key, v in timings.items():
        print(f"{key} {v:.6f}")
    print_kernel_times(kms)
    if args.profile:
        profile_phase(ctx, prover, sel, cp, a, b, c, vk, proof,
                      1 / timings["proofs_per_s"])
    bounds = k12_bounds(k1_inputs, k2_inputs)
    entries = kernel_entries(KERNELS, kms, launches, errs, bounds)
    bn_entries, bn_timings, bn = bn254_phases(dev, card, args.profile)
    pr_entries = prims_phases(dev, card, ctx, (sel, cp, a, b, c), proof,
                              prover)
    dist_entries = dist_phases(dev, card, ctx, (sel, cp, a, b, c), proof,
                               prover, vk)
    toy_phases(dev, card)
    fsp = fs_phases(dev, card, ctx, (sel, cp, a, b, c), proof, prover, vk)
    blake = bn254_fs_phases(dev, card, bn)
    scaled_batch_phase(dev, card)
    fs_batch_phase(dev, card, ctx, fsp)
    bn254_batch_phase(dev, card, bn, blake)
    msm_phase(dev, card, args.profile)
    commit_routes_phase(dev, card, bn)
    cache_phase(dev, card, bn, bn_timings)
    bn_dist_entries = dist_bn254_phase(dev, card, bn, args.profile)
    msm_dist_entries = dist_msm_phase(dev, card)
    check("jax" not in sys.modules, "no JAX imported")
    print(f"all phases passed in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": entries + bn_entries + pr_entries
                      + dist_entries + bn_dist_entries
                      + msm_dist_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
