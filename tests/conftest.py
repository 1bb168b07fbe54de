"""Test harness configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic is
exercised without a GPU (chip_smoke.py and the `gpu`-marked tests run on the
card). Must be set before jax initializes.
"""

import os

# CPU unless the caller names another platform (the `gpu`-marked tests on
# the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py)
ON_CPU = os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu"

import cholesky_tpu  # noqa: E402

cholesky_tpu.enable_x64()

if ON_CPU:
    cholesky_tpu.force_cpu(8)
cholesky_tpu.setup_compilation_cache()

import pathlib  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_TESTS = pathlib.Path("/root/reference/tests")
HAS_REFERENCE = (REFERENCE_TESTS / "lapl_9x9").exists()

FIXTURES = {
    "lapl_9x9": ("lapl_3_2.mtx", "lapl_3_2_ord_2.txt", "lapl_3_2_clust_2.txt", "B_9x1.mtx"),
    "lapl_25x25": ("lapl_5_2.mtx", "lapl_5_2_ord_3.txt", "lapl_5_2_clust_3.txt", "B_25x1.mtx"),
    "lapl_400x400": ("lapl_20_2.mtx", "lapl_20_2_ord_5.txt", "lapl_20_2_clust_5.txt", "B_400x1.mtx"),
    "lapl_3375x3375": ("lapl_15_3.mtx", "lapl_15_3_ord_5.txt", "lapl_15_3_clust_5.txt", "B_3375x1.mtx"),
}

# generated equivalents (same sizes/depths) when the reference checkout is
# not mounted — keeps the suite standalone
_GENERATED_SPECS = {
    "lapl_9x9": ((3, 3), 2),
    "lapl_25x25": ((5, 5), 3),
    "lapl_400x400": ((20, 20), 5),
    "lapl_3375x3375": ((15, 15, 15), 5),
}
_GENERATED_DIR = pathlib.Path(tempfile.gettempdir()) / "cholesky_tpu_fixtures"


def _generate_fixture(name):
    from cholesky_tpu.io import mmio, ordering as ordio
    from cholesky_tpu.utils.laplacian import generate_problem

    d = _GENERATED_DIR / name
    mtx, ordf, clustf, bf = FIXTURES[name]
    if (d / bf).exists():
        return d
    d.mkdir(parents=True, exist_ok=True)
    shape, levels = _GENERATED_SPECS[name]
    n, r, c, v, o, cl, b = generate_problem(shape, levels)
    mmio.write_coo(str(d / mtx), r, c, v, (n, n), symmetry="hermitian")
    ordio.write_ordering(str(d / ordf), o)
    ordio.write_clusters(str(d / clustf), cl)
    with open(d / bf, "w") as f:
        f.write("%%MatrixMarket matrix array integer general\n%\n")
        f.write(f"{n} 1\n")
        for x in b.astype(int):
            f.write(f"{x}\n")
    return d


def fixture_paths(name):
    mtx, ordf, clustf, bf = FIXTURES[name]
    d = REFERENCE_TESTS / name
    if not (d / mtx).exists():
        d = _generate_fixture(name)
    return {
        "mat": str(d / mtx),
        "separators": str(d / ordf),
        "clusters": str(d / clustf),
        "b": str(d / bf),
    }


@pytest.fixture
def rng():
    return np.random.default_rng(0)
