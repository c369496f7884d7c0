"""The XLA frontend chain vs the NumPy oracle — bit-equality.

quantize (blur -> sobel -> fastAtan2 -> hysteresis vote) -> spread ->
response -> linearize, gray and color, 8 and 16 orientations, masked and
frame-batched, against oracle/reference.py (itself pinned to the compiled
C++ by the golden suites). This is the only frontend: the device runs the
same XLA programs these tests run on the CPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from shape_based_matching_tpu.models.detector import (_batch_pyramid,
                                                      _lm_pyramid)
from shape_based_matching_tpu.ops.gradients import (
    quantized_orientations_color, quantized_orientations_gray)
from shape_based_matching_tpu.ops.response import (build_linear_memories,
                                                   spread)
from shape_based_matching_tpu.oracle import reference as oracle
from shape_based_matching_tpu.utils.synthetic import (synthetic_scene,
                                                      synthetic_shape_image)


def _images():
    rng = np.random.RandomState(7)
    noise = (rng.rand(128, 256) * 255).astype(np.uint8)
    templ = synthetic_shape_image(96, seed=1)
    scene = synthetic_scene(256, 256, templ, n_instances=3, seed=2)
    flat = np.full((64, 128), 127, np.uint8)  # no gradients anywhere
    return {"noise": noise, "scene": scene, "flat": flat}


def _quant(img, thr=30.0, n_ori=8):
    fn = (quantized_orientations_gray if img.ndim == 2
          else quantized_orientations_color)
    return np.asarray(fn(jnp.asarray(img), jnp.float32(thr), n_ori).angle)


def _assert_quant_and_spread(img, T, thr=30.0, n_ori=8, mask=None):
    got_q = _quant(img, thr, n_ori)
    _, want_q, _ = oracle.quantized_orientations(img, thr, n_ori)
    if mask is not None:
        got_q = np.where(mask > 0, got_q, 0).astype(got_q.dtype)
        want_q = np.where(mask > 0, want_q, 0).astype(want_q.dtype)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(np.asarray(spread(jnp.asarray(got_q), T)),
                                  oracle.spread(want_q, T))


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("name", ["noise", "scene", "flat"])
def test_quant_and_spread_parity(T, name):
    _assert_quant_and_spread(_images()[name], T)


@pytest.mark.parametrize("name,hw", [("odd-w", (128, 244)),
                                     ("odd-h", (124, 256)),
                                     ("small", (48, 72))])
def test_quant_and_spread_parity_padded_sizes(name, hw):
    """Sizes off any power-of-two grid, including border votes at the
    true image edges."""
    rng = np.random.RandomState(sum(map(ord, name)))
    _assert_quant_and_spread((rng.rand(*hw) * 255).astype(np.uint8), 4)


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("hw", [(128, 256), (120, 244)])
def test_quant_and_spread_parity_color(T, hw):
    """Color path: per-channel blur/sobel + max-|grad|^2 channel select
    with the reference tie rules."""
    rng = np.random.RandomState(11)
    _assert_quant_and_spread((rng.rand(*hw, 3) * 255).astype(np.uint8), T)


def test_batched_color_and_padded():
    """The frame-batched pyramid (one program for B frames) == the
    oracle per frame."""
    rng = np.random.RandomState(13)
    imgs = (rng.rand(3, 128, 240, 3) * 255).astype(np.uint8)
    got = _batch_pyramid(jnp.asarray(imgs), jnp.zeros((1, 1), jnp.uint8),
                         False, False, (4, 8), 2, jnp.float32(30.0))
    for b in range(3):
        want, _ = oracle.build_lm_pyramid(imgs[b], 30.0, (4, 8))
        for lvl in range(2):
            np.testing.assert_array_equal(np.asarray(got[lvl][0][b]),
                                          want[lvl])


@pytest.mark.parametrize("T", [4, 8])
def test_linear_memories_parity(T):
    img = _images()["scene"]
    got = np.asarray(build_linear_memories(jnp.asarray(_quant(img)), T))
    _, q, _ = oracle.quantized_orientations(img, 30.0)
    want = oracle.linearize(oracle.response_maps(oracle.spread(q, T)), T)
    np.testing.assert_array_equal(got, want)


def test_weak_threshold_respected():
    img = _images()["scene"]
    for thr in (10.0, 60.0):
        _assert_quant_and_spread(img, 4, thr=thr)


def test_level_pyramid_parity():
    """The detector's two-level pyramid (pyrDown + per-level chain) ==
    oracle.build_lm_pyramid, and lmflat is lm plus M zero bytes."""
    img = _images()["scene"]
    got = _lm_pyramid(jnp.asarray(img), jnp.zeros((1, 1), jnp.uint8), True,
                      False, (4, 8), 2, jnp.float32(30.0))
    want, _ = oracle.build_lm_pyramid(img, 30.0, (4, 8))
    for lvl in range(2):
        lm, flat = (np.asarray(a) for a in got[lvl])
        np.testing.assert_array_equal(lm, want[lvl])
        M = lm.shape[-1]
        np.testing.assert_array_equal(flat[:-M], lm.reshape(-1))
        assert not flat[-M:].any()


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("n_ori", [8, 16])
def test_masked_quant_and_spread_parity(T, n_ori):
    """Masked configs (line2Dup.cpp:446-450): where(mask > 0, quantized,
    0) before the spread."""
    img = _images()["scene"]
    rng = np.random.RandomState(3)
    mask = (rng.rand(*img.shape) > 0.4).astype(np.uint8) * 255
    mask[40:80, :] = 0
    _assert_quant_and_spread(img, T, n_ori=n_ori, mask=mask)


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("name,color", [("scene", False), ("noise", False),
                                        ("color", True)])
def test_16ori_quant_and_spread_parity(T, name, color):
    """16-orientation configs emit u16 single-bit orientations
    (line2Dup_16bit_ori.cpp:216-297)."""
    if color:
        rng = np.random.RandomState(11)
        img = (rng.rand(120, 250, 3) * 255).astype(np.uint8)
    else:
        img = _images()[name]
    assert _quant(img, n_ori=16).dtype == np.uint16
    _assert_quant_and_spread(img, T, n_ori=16)


def test_16ori_linear_memories_parity():
    """16-orientation linear memories: the u16 spread plane is permuted
    whole, then the 16-bin response is applied."""
    img = _images()["scene"]
    _, q, _ = oracle.quantized_orientations(img, 30.0, 16)
    for T in (4, 8):
        got = np.asarray(build_linear_memories(
            jnp.asarray(_quant(img, n_ori=16)), T, 16))
        want = oracle.linearize(
            oracle.response_maps(oracle.spread(q, T), 16), T)
        np.testing.assert_array_equal(got, want)


def test_batched_masked_parity():
    """Frame-batched masked pyramid == the oracle per frame."""
    rng = np.random.RandomState(5)
    imgs = (rng.rand(3, 64, 128) * 255).astype(np.uint8)
    masks = (rng.rand(3, 64, 128) > 0.3).astype(np.uint8) * 255
    got = _batch_pyramid(jnp.asarray(imgs), jnp.asarray(masks), True, True,
                         (4, 8), 2, jnp.float32(30.0))
    for b in range(3):
        want, _ = oracle.build_lm_pyramid(imgs[b], 30.0, (4, 8),
                                          mask=masks[b])
        for lvl in range(2):
            np.testing.assert_array_equal(np.asarray(got[lvl][0][b]),
                                          want[lvl])
