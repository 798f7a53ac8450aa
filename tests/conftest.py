"""Test harness config: run everything on a virtual 8-device CPU mesh, with
mesh fixtures generated from a seed.

Multi-device hardware is not available in CI; sharding tests use
``xla_force_host_platform_device_count`` (SURVEY.md §4). Must run before
jax initializes, hence the env mutation at import time. Pallas kernels run
in interpret mode on the CPU backend.

The mesh fixtures ``tester_path``, ``rabbit_path`` and ``walls_path`` are
seeded procedural meshes written once per session as PLY files in each
format ``io/ply.py`` reads (tests/meshes.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the caller picked a platform (the card-only tests, marked
# `gpu`, run with JAX_PLATFORMS=cuda)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import meshes  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled Pallas/Triton "
        "kernels); skipped elsewhere")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (compiled kernels have no CPU "
                    "lowering)")


@pytest.fixture(scope="session")
def fixture_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("meshes")


@pytest.fixture(scope="session")
def tester_path(fixture_dir):
    path = str(fixture_dir / "tester.ply")
    meshes.write_tester(path)
    return path


@pytest.fixture(scope="session")
def rabbit_path(fixture_dir):
    path = str(fixture_dir / "rabbit.ply")
    meshes.write_rabbit(path)
    return path


@pytest.fixture(scope="session")
def walls_path(fixture_dir):
    path = str(fixture_dir / "walls.ply")
    meshes.write_walls(path)
    return path


@pytest.fixture(scope="session")
def simple_tris():
    """Two axis-aligned triangles forming a unit square at z=2 plus one
    behind it at z=5 — analytic fixture for intersection tests."""
    tris = np.array([
        # front square (two triangles), z = 2
        [[-1, -1, 2], [1, -1, 2], [-1, 1, 2]],
        [[1, 1, 2], [-1, 1, 2], [1, -1, 2]],
        # large far triangle, z = 5 (occluded in the middle, visible
        # around the square's edges)
        [[-6, -6, 5], [6, -6, 5], [0, 6, 5]],
    ], np.float32)
    return tris
