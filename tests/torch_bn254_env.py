"""The environment of the port's BN254 tests: both disk caches under a
directory of the test's own, so that every SRS and window table a test
uses is computed by the code under test in that test's run and never
loaded from a file that another run, another device or the JAX package
left; and, unless the test is about the route, the commit route pinned.
"""
import pytest


def bn254_env(mp, root, table_route: bool = True) -> None:
    """Through the pytest MonkeyPatch `mp`: HOME (the root of the SRS
    cache, ~/.cache/plonk_tpu) at root/home and PLONK_TPU_CACHE (the
    window table's) at root/tables; with `table_route`,
    PLONK_TPU_BN254_FB=1, the window table (K4 on the card, its plain
    version on the CPU), the route the card takes by default. On the CPU
    the default is GLV Pippenger, some ten times slower at n = 8; both
    routes are held against the JAX package in
    tests/test_torch_bn254_routes.py."""
    mp.setenv("HOME", str(root / "home"))
    mp.setenv("PLONK_TPU_CACHE", str(root / "tables"))
    mp.delenv("PLONK_TPU_BN254_FB_WB", raising=False)
    if table_route:
        mp.setenv("PLONK_TPU_BN254_FB", "1")


@pytest.fixture(scope="module", autouse=True)
def bn254_module_env(tmp_path_factory):
    """bn254_env with the table route for a whole test module, under a
    directory of the module's own; a module takes it by importing it."""
    with pytest.MonkeyPatch.context() as mp:
        bn254_env(mp, tmp_path_factory.mktemp("bn254"))
        yield
