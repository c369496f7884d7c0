"""Pin the device-dispatch count of the hot match paths.

A host-facing match path pays per-dispatch latency once per program;
these tests make a dispatch regression a test failure instead of a
benchmark mystery.

Counted via utils/dispatch.py: executions of the detector's jitted
entry programs (always-on wrappers) plus H2D/D2H transfers (opt-in
patches). The pinned numbers are the CONTRACT for the warm B=1 match:

  1 batch_pyramid + 1 match_batch_class + 1 pack_match_results
  executions, 1 H2D (the frame), 1 D2H pull (the packed result tensor;
  counted at the pull SITE — on the CPU backend numpy reads device
  buffers zero-copy, so the generic d2h_total patch only fires on real
  accelerators).
"""

import numpy as np
import pytest

from shape_based_matching_tpu.utils import dispatch
from shape_based_matching_tpu.utils.synthetic import (build_rotated_detector,
                                                      synthetic_scene)


@pytest.fixture(scope="module")
def warm_detector():
    det, templ_img = build_rotated_detector(num_templates=6,
                                            num_features=32, size=56)
    scene = synthetic_scene(256, 256, templ_img, n_instances=2, seed=5)
    matches = det.match(scene, 80.0)  # compile + fill const caches
    assert matches, "warm match found nothing; fixture scene is broken"
    return det, scene


def test_warm_b1_match_dispatch_count(warm_detector):
    det, scene = warm_detector
    with dispatch.measure(transfers=True) as delta:
        det.match(scene, 80.0)
    # warm up the TRANSFER patches too (first post-install call may pay
    # one-time device_put of internals), then pin on a second pass
    with dispatch.measure(transfers=True) as delta:
        matches = det.match(scene, 80.0)
    assert matches
    assert delta.get("exec:batch_pyramid", 0) == 1, delta
    assert delta.get("exec:match_batch_class", 0) == 1, delta
    assert delta.get("exec:pack_match_results", 0) == 1, delta
    assert delta.get("exec_total", 0) == 3, delta
    # ONE frame push, ONE packed-result pull — the whole transfer story
    assert delta.get("h2d_total", 0) == 1, delta
    assert delta.get("d2h_pulls", 0) == 1, delta


def test_warm_match_batch_b4_dispatch_count(warm_detector):
    det, scene = warm_detector
    frames = np.stack([np.asarray(scene)] * 4)
    det.match_batch(frames, 80.0)  # compile B=4 shapes
    with dispatch.measure(transfers=True) as delta:
        out = det.match_batch(frames, 80.0)
    assert any(out)
    # batching must NOT scale the dispatch count with B
    assert delta.get("exec_total", 0) == 3, delta
    assert delta.get("h2d_total", 0) == 1, delta
    assert delta.get("d2h_pulls", 0) == 1, delta


def test_device_resident_frames_skip_h2d(warm_detector):
    """A jax-array frame already on device must not be re-pushed
    (round 3 fixed a D2H+H2D round trip in match(); keep it fixed)."""
    import jax
    import jax.numpy as jnp

    det, scene = warm_detector
    dev = jnp.asarray(np.asarray(scene))
    jax.block_until_ready(dev)
    det.match(dev, 80.0)  # warm this input-type path
    with dispatch.measure(transfers=True) as delta:
        det.match(dev, 80.0)
    assert delta.get("h2d_total", 0) == 0, delta
    assert delta.get("d2h_pulls", 0) == 1, delta
