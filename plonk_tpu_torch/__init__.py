"""PyTorch + CUDA port of the PLONK provers and verifiers: the toy
"PLONK by hand" protocol (with its batched prover), the scaled pairing
curve and BN254.

The JAX package `plonk_tpu` is the reference; every module here keeps the
name and the function names of its counterpart there, and the tests in
`tests/test_torch_*.py` hold the two against each other.

Representation, held in **int64** tensors on every device (torch's CPU
backend has no `uint32` add, shift or compare):
- toy fields (F_17 scalars, F_101 coordinates): a field element is one
  standard-form word, equal to the `uint32` word of
  `plonk_tpu.ops.field.Field` (direct reduction);
- scaled curve: a field element is one word in [0, p) with p < 2^31; its
  Montgomery word (R = 2^32) equals the `uint32` word of
  `plonk_tpu.ops.field.MontField`;
- BN254: a field element is 16 little-endian 16-bit words (R = 2^256),
  equal to the words of `plonk_tpu.ops.bigfield.BigMontField`.
numpy `uint32` arrays from the JAX side are converted at the boundary
(`utils/convert.py`).

Point-at-infinity flags are `bool` tensors. The device of the tensors
decides where work runs: on a CUDA tensor the hand-written kernels in
`csrc/` launch (the row-stage NTT and the full-row transform
`ops/row_stages.py`, the one-pass four-step transform `ops/fused_ntt.py`,
the modular matmul `ops/mxu_ntt.py`, the fixed-base commit
`ops/commit.py`, and the 16-limb BN254 counterparts `ops/bigntt.py` and
`ops/bigcommit.py`, and the all-gather and all-to-all of the sharded
prover `parallel/collectives.py`); on a CPU tensor their plain
PyTorch versions run. The toy path (`models/plonk.py`,
`models/verifier.py`, `parallel/batch.py`) launches none of them. The
entry points (`canonical_context`, `plonk_new`, `scaled_new`,
`srs_create`, `bn254_setup`, `parallel.mesh.make_1d_mesh`) put their
context on the CUDA card unless given `device="cpu"`.

The mesh-sharded scaled prover lives in `parallel/`: `mesh.py` (a
single-controller mesh of D shards on one device), `collectives.py`,
`dist_ntt.py` (the sharded four-step NTT), `dist_scan.py` (the sharded
grand product) and `dist_prover.py` (`make_dist_prims`).

This package imports neither `jax` nor any module of `plonk_tpu`; it
keeps its own copy of the parameters it needs (`utils/params.py`).
"""
