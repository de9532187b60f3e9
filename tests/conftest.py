"""Test configuration: CPU with an 8-device virtual mesh, x64 on.

XLA flags must be set before jax initializes — keep this at import time.
Tests marked ``gpu`` (``pytest -m gpu``) are the exception: that marker
expression leaves the platform alone so JAX finds the card, and the
``gpu_device`` fixture skips them where there is none.
"""

import os
import sys


def _gpu_run() -> bool:
    """True when the marker expression on the command line selects gpu
    tests (``-m gpu``); the default and driver runs deselect or ignore it."""
    args = sys.argv
    for i, a in enumerate(args):
        expr = None
        if a == "-m" and i + 1 < len(args):
            expr = args[i + 1]
        elif a.startswith("-m") and len(a) > 2:
            expr = a[2:]
        if expr is not None and "gpu" in expr and "not gpu" not in expr:
            return True
    return False


if not _gpu_run():
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not _gpu_run():
    jax.config.update("jax_platforms", "cpu")
# x64 on for all tests: calibration math wants f64; device-path modules pin
# their own f32 dtypes explicitly, which this also verifies.
jax.config.update("jax_enable_x64", True)

import pathlib

import numpy as np
import pytest

REFERENCE_DATA = pathlib.Path("/root/reference/test/data")


@pytest.fixture(scope="session")
def ref_data():
    if not REFERENCE_DATA.exists():
        pytest.skip("reference test data not available")
    return REFERENCE_DATA


@pytest.fixture(scope="session")
def fml_grid(ref_data):
    from upsp_tpu.io.plot3d import read_p3d_grid

    return read_p3d_grid(str(ref_data / "fml_tc3_volume.grid"))


@pytest.fixture(scope="session")
def fml_model(fml_grid):
    from upsp_tpu.geometry.grids import from_struct_grid

    # GRID_TOLERANCE from fml_tc3_volume.tgts header
    return from_struct_grid(fml_grid, tolerance=0.388202)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none (decided here,
    at test time, never at import)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run with: pytest -m gpu)")
    return gpus[0]
