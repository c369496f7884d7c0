"""Orientation quantization parity: JAX ops vs NumPy oracle (and cv2.phase)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shape_based_matching_tpu.ops import gradients
from shape_based_matching_tpu.ops.fastmath import phase_deg
from shape_based_matching_tpu.oracle import reference as oracle


def test_phase_deg_vs_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    dx = (rng.randn(5000) * 300).astype(np.float32)
    dy = (rng.randn(5000) * 300).astype(np.float32)
    want = cv2.phase(dx.reshape(-1, 1), dy.reshape(-1, 1),
                     angleInDegrees=True).ravel().astype(np.float32)
    got = np.asarray(phase_deg(jnp.asarray(dx), jnp.asarray(dy)))
    # fastAtan2 replica: tiny FMA/ordering differences only
    assert np.abs(got - want).max() < 1e-3
    orac = oracle.fast_atan2_deg(dy, dx)
    assert np.abs(orac - want).max() < 1e-3


@pytest.mark.parametrize("n_ori", [8, 16])
def test_orientation_bins_every_sobel_pair(n_ori):
    """The orientation bucket of every (dx, dy) a 3x3 Sobel of 8-bit
    pixels can produce (both in [-1020, 1020]) equals the oracle's:
    the frontend's bins depend on nothing else. chip_smoke.py runs the
    same check compiled for the GPU."""
    v = np.arange(-1020, 1021, dtype=np.float32)
    dx, dy = np.meshgrid(v, v)
    got = np.asarray(gradients.orientation_bins(
        phase_deg(jnp.asarray(dx), jnp.asarray(dy)), n_ori))
    want = oracle.orientation_bins(oracle.fast_atan2_deg(dy, dx), n_ori)
    np.testing.assert_array_equal(got, want)


def test_hysteresis_quantize_matches_oracle(rng):
    mag = (rng.rand(40, 52).astype(np.float32) * 5000.0)
    ang = (rng.rand(40, 52).astype(np.float32) * 360.0)
    want = oracle.hysteresis_quantize(mag, ang, 900.0)
    got = np.asarray(
        gradients.hysteresis_quantize(jnp.asarray(mag), jnp.asarray(ang),
                                      jnp.float32(900.0)))
    np.testing.assert_array_equal(got, want)


def test_hysteresis_quantize_structured(rng):
    # Structured angles (constant patches) to exercise the >=5 majority vote.
    ang = np.zeros((32, 32), np.float32)
    ang[:, 16:] = 91.0
    mag = np.full((32, 32), 1e6, np.float32)
    want = oracle.hysteresis_quantize(mag, ang, 900.0)
    got = np.asarray(
        gradients.hysteresis_quantize(jnp.asarray(ang * 0 + mag * 0 + mag),
                                      jnp.asarray(ang), jnp.float32(900.0)))
    np.testing.assert_array_equal(got, want)
    # interior of left half -> bin 0 (1<<0); right half 91deg -> bucket
    # round(91*16/360)=4 -> bin 4
    assert want[10, 5] == 1
    assert want[10, 25] == 16


@pytest.mark.parametrize("color", [False, True])
def test_quantized_orientations_matches_oracle(rng, color):
    shape = (48, 64, 3) if color else (48, 64)
    img = rng.randint(0, 256, shape, dtype=np.uint8)
    want_mag, want_q, want_ang = oracle.quantized_orientations(img, 30.0)
    got = gradients.quantized_orientations(img, 30.0)
    np.testing.assert_array_equal(np.asarray(got.magnitude), want_mag)
    np.testing.assert_array_equal(np.asarray(got.angle), want_q)
    np.testing.assert_allclose(np.asarray(got.angle_ori), want_ang, atol=1e-3)


def test_quantized_orientations_real_image(case1_images):
    img = case1_images["train"]
    want_mag, want_q, want_ang = oracle.quantized_orientations(img, 30.0)
    got = gradients.quantized_orientations(img, 30.0)
    np.testing.assert_array_equal(np.asarray(got.angle), want_q)
    np.testing.assert_array_equal(np.asarray(got.magnitude), want_mag)
