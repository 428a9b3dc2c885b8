"""PyTorch + CUDA port of the scaled-curve PLONK prover and verifier.

The JAX package `plonk_tpu` is the reference; every module here keeps the
name and the function names of its counterpart there, and the tests in
`tests/test_torch_*.py` hold the two against each other.

Representation: every field element is a word in [0, p) with p < 2^31,
stored in an **int64** tensor. Montgomery words (R = 2^32) equal the
`uint32` words of `plonk_tpu.ops.field.MontField`; numpy `uint32` arrays
from the JAX side are converted at the boundary (`utils/convert.py`).
int64 is used on every device: a product of two words fits it exactly,
and torch's CPU backend has no `uint32` add, shift or compare.

Point-at-infinity flags are `bool` tensors. The device of the tensors
decides where work runs: on a CUDA tensor the two hand-written kernels in
`csrc/` (the row-stage NTT `ops/row_stages.py` and the fixed-base commit
`ops/commit.py`) launch; on a CPU tensor their plain PyTorch versions run.

This package never imports `jax`. The only module of `plonk_tpu` it
imports is `plonk_tpu.utils.params`, which holds plain dataclasses.
"""
