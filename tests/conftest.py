"""Test configuration: JAX on a virtual 8-device CPU mesh.

The CPU suite is the reference: it needs no accelerator, and the sharding
tests use the 8 virtual CPU devices. Tests that need an NVIDIA GPU carry
the registered ``gpu`` marker; the ``_gpu_only`` fixture skips them when
the first device is not a GPU. On a GPU host run them with

    JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0 tests/

(an explicit JAX_PLATFORMS other than cpu is honoured; otherwise the
suite runs on the CPU).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from shape_based_matching_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless the first device is a GPU (decided
    when the test runs, never at import: every xdist worker must collect
    the same tests)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (Triton kernel compiled for the "
                    "card; the CPU suite runs it in interpret mode)")


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(42)


@pytest.fixture(scope="session")
def case1_images():
    """The case1 demo's real images from the committed goldens: the
    training ROI and the decoded test frame."""
    from tests.golden_utils import load_mat

    return {"train": load_mat("case1_train_img.bin"),
            "test": load_mat("case1_img.bin")}


def has_cv2():
    try:
        import cv2  # noqa: F401

        return True
    except ImportError:
        return False
