"""Card-only checks: the Triton kernel compiled for the GPU, exact score
division and a Detector match against the NumPy oracle. Marked `gpu`; they
skip where the first device is not a GPU (see tests/conftest.py for the
command that runs them on a GPU host)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from shape_based_matching_tpu.ops.fastmath import exact_ratio_f32
from shape_based_matching_tpu.ops.similarity import (
    coarse_similarity, coarse_similarity_kernel, pack_level_bank)
from shape_based_matching_tpu.oracle import reference as oracle
from shape_based_matching_tpu.utils.synthetic import (build_rotated_detector,
                                                      synthetic_scene)

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("T,size,N", [(8, (512, 512), 32),
                                      (4, (1024, 1024), 63),
                                      (8, (512, 384), 700)])
def test_compiled_kernel_equals_xla(rng, T, size, N):
    W, H = size[0] // T, size[1] // T
    M = W * H
    lm = rng.randint(0, 5, (8, T * T, M)).astype(np.uint8)
    lmflat = jnp.concatenate([jnp.asarray(lm.reshape(-1)),
                              jnp.zeros((M,), jnp.uint8)])
    templates = [{"features": [(int(rng.randint(0, 64)),
                                int(rng.randint(0, 64)),
                                int(rng.randint(0, 8))) for _ in range(N)],
                  "width": 64, "height": 64} for _ in range(40)]
    bank = pack_level_bank(templates)
    for mask in (True, False):
        a, _ = coarse_similarity_kernel(lmflat, bank, T, size,
                                        mask_positions=mask)
        b, _ = coarse_similarity(lmflat, bank, T, size,
                                 mask_positions=mask)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_exact_ratio_on_gpu():
    raw = np.arange(0, 1600, dtype=np.int32)
    n = np.arange(1, 400, dtype=np.int32)
    R, N = np.meshgrid(raw, n, indexing="ij")
    got = np.asarray(jax.jit(exact_ratio_f32)(jnp.asarray(R * 100),
                                              jnp.asarray(4 * N)))
    np.testing.assert_array_equal(
        got, (R * 100).astype(np.float32) / (4 * N).astype(np.float32))


def test_detector_match_equals_oracle_on_gpu():
    det, templ = build_rotated_detector(num_templates=90, num_features=63)
    scene = synthetic_scene(512, 512, templ, n_instances=2, seed=4)
    got = det.match(scene, 80.0)
    lms, sizes = oracle.build_lm_pyramid(scene, det.weak_threshold,
                                         det.T_at_level)
    tps = [[{"features": [(f.x, f.y, f.label) for f in t.features],
             "width": t.width, "height": t.height} for t in tp]
           for tp in det.class_templates["bench"]]
    want = oracle.match_class(lms, sizes, det.T_at_level, tps, 80.0, "bench")
    assert len(got) > 0
    assert sorted({(m.template_id, m.x, m.y, float(m.similarity))
                   for m in got}) == sorted(
        {(m["template_id"], m["x"], m["y"], float(m["similarity"]))
         for m in want})
