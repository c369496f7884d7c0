"""The Detector's kernel route, run in the Pallas interpreter on the CPU.

On a GPU the Detector scores with the Triton kernel; on the CPU it runs
the XLA scan. `Detector(pallas_interpret=True, use_pallas=True)` drives the
exact GPU dispatch graph (kernel at the coarse level and for the
fine-level maps, inside match_batch's vmapped program and the escalating
host path) through the interpreter; the match lists must equal the XLA
route's bit for bit.
"""

import numpy as np

from shape_based_matching_tpu.models.detector import Detector
from shape_based_matching_tpu.ops.similarity import (coarse_route,
                                                     use_pallas_default)
from shape_based_matching_tpu.utils.synthetic import (build_rotated_detector,
                                                      synthetic_scene,
                                                      synthetic_shape_image)


def _keys(matches):
    return [(m.template_id, m.x, m.y, m.similarity) for m in matches]


def _both(det, fn):
    det.use_pallas, det.pallas_interpret = False, False
    want = fn()
    det.use_pallas, det.pallas_interpret = True, True
    got = fn()
    return got, want


def test_detector_kernel_dispatch_interpreted():
    det, templ_img = build_rotated_detector(num_templates=6,
                                            num_features=32, size=56)
    scene = synthetic_scene(256, 256, templ_img, n_instances=2, seed=5)
    got, want = _both(det, lambda: (det._match_escalating(scene, 80.0),
                                    det.match_batch(scene[None], 80.0)[0]))
    assert len(want[0]) > 0
    assert _keys(got[0]) == _keys(want[0])
    assert _keys(got[1]) == _keys(want[1]) == _keys(want[0])


def test_match_batch_multiframe_interpreted():
    """B>1 vmaps the per-frame program, so the kernel runs under
    jax.vmap (a batched grid) — results equal the XLA route frame for
    frame."""
    det, templ_img = build_rotated_detector(num_templates=6,
                                            num_features=32, size=56)
    frames = np.stack([np.asarray(synthetic_scene(
        256, 256, templ_img, n_instances=2, seed=s)) for s in (5, 9, 13)])
    got, want = _both(det, lambda: det.match_batch(frames, 80.0))
    assert any(len(w) for w in want)
    for g, w in zip(got, want):
        assert _keys(g) == _keys(w)


def test_match_batch_large_caps_interpreted():
    """Large static caps (deep escalation buckets) through the kernel."""
    det, templ_img = build_rotated_detector(num_templates=6,
                                            num_features=32, size=56)
    scene = synthetic_scene(256, 256, templ_img, n_instances=2, seed=5)
    got, want = _both(det, lambda: det.match_batch(
        scene[None], 80.0, cand_cap=1024, distinct_cap=8)[0])
    assert len(want) > 0
    assert _keys(got) == _keys(want)


def test_masked_match_dispatch_interpreted():
    det, templ_img = build_rotated_detector(num_templates=4,
                                            num_features=32, size=56)
    scene = synthetic_scene(256, 256, templ_img, n_instances=2, seed=6)
    rng = np.random.RandomState(8)
    mask = (rng.rand(*scene.shape) > 0.2).astype(np.uint8) * 255
    mask[:, 200:] = 0
    got, want = _both(det, lambda: det.match(scene, 70.0, mask=mask))
    assert len(want) > 0
    assert _keys(got) == _keys(want)


def test_16ori_match_dispatch_interpreted():
    det = Detector(num_features=48, num_orientations=16)
    templ_img = synthetic_shape_image(96, seed=3)
    det.add_template(templ_img, "s", np.full_like(templ_img, 255))
    det.add_template_rotate("s", 0, 90.0, (48.0, 48.0))
    scene = synthetic_scene(256, 256, templ_img, n_instances=1, seed=7)
    got, want = _both(det, lambda: det.match(scene, 60.0))
    assert len(want) > 0
    assert _keys(got) == _keys(want)


def test_scorer_choice_follows_the_platform():
    """The kernel is the default only on a GPU; the CPU test backend runs
    the XLA scan, and the route tag says which ran."""
    assert use_pallas_default() is False
    assert coarse_route() == "xla"
    assert coarse_route(True) == "kernel"
    det = Detector()
    assert det.coarse_route() == "xla"
    det.use_pallas = True
    assert det.coarse_route() == "kernel"
