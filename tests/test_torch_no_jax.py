"""The port never imports JAX: a fresh interpreter imports every module of
plonk_tpu_torch, and neither `jax` nor any module of the JAX package
`plonk_tpu` is loaded (the port keeps its own copy of what it needs)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import plonk_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plonk_tpu_torch.__path__,
                                               "plonk_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "plonk_tpu" or m.startswith("plonk_tpu."))
print(len(names), bad)
print(" ".join(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, names = out.stdout.splitlines()
    count, bad = first.split(" ", 1)
    assert int(count) >= 40
    assert bad.strip() == "[]"
    # the modules of every kernel, of every prims, of the sharded prover,
    # of the toy prover, its verifier and its batch, of the transcripts
    # and bytes, of the GLV MSM, of the sharded MSM, the profiling helpers
    # and the entry points are among those imported
    for mod in ("ops.row_stages", "ops.fused_ntt", "ops.mxu_ntt",
                "ops.commit", "ops.bigntt", "ops.bigcommit",
                "models.plonk_scaled", "models.plonk_bn254",
                "parallel.mesh", "parallel.collectives", "parallel.dist_ntt",
                "parallel.dist_scan", "parallel.dist_prover",
                "ops.msm", "ops.matrix", "models.constraints",
                "models.presets", "models.verifier", "parallel.batch",
                "ops.poseidon", "models.fiat_shamir", "models.fs_poseidon",
                "utils.serialization", "utils.convert", "ops.glv",
                "parallel.dist_msm", "utils.profiling", "entry"):
        assert f"plonk_tpu_torch.{mod}" in names.split(), mod
