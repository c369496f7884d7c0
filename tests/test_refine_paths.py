"""Pyramid refinement vs the NumPy oracle.

Two device paths remain: refine_from_maps (windowed argmax over full
fine-level maps of the distinct candidate templates — exact under the
border clamp) and refine_candidates (per-candidate gather, the path for
pathological banks whose templates are wider than image - 16T). Both must
reproduce the reference's candidate loop (line2Dup.cpp:1221-1293) as
replayed by the oracle: border clamps, 16x16 local similarity
(oracle.similarity_local), first-max argmax, re-thresholding.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from shape_based_matching_tpu.ops.similarity import (
    coarse_similarity_dispatch, distinct_templates, gather_bank,
    pack_level_bank, refine_candidates, refine_from_maps)
from shape_based_matching_tpu.oracle import reference as oracle


def _templates(rng, K, n_lo, n_hi, wh, n_ori=8):
    out = []
    for _ in range(K):
        n = int(rng.randint(n_lo, n_hi))
        feats = [(int(rng.randint(0, wh + 1)), int(rng.randint(0, wh + 1)),
                  int(rng.randint(0, n_ori))) for _ in range(n)]
        out.append({"features": feats, "width": wh, "height": wh})
    return out


def _case(rng, n_ori, w_img, h_img, T, templates, n_cand=64):
    M = (w_img // T) * (h_img // T)
    lm = rng.randint(0, 5, (n_ori, T * T, M)).astype(np.uint8)
    lmflat = jnp.concatenate([jnp.asarray(lm.reshape(-1)),
                              jnp.zeros((M,), jnp.uint8)])
    bank = pack_level_bank(templates)
    K = len(templates)
    k = jnp.asarray(rng.randint(0, K, n_cand), jnp.int32)
    x = jnp.asarray(rng.randint(0, w_img // 2, n_cand), jnp.int32)
    y = jnp.asarray(rng.randint(0, h_img // 2, n_cand), jnp.int32)
    valid = jnp.asarray(rng.rand(n_cand) > 0.2)
    return lm, lmflat, bank, k, x, y, valid


def _oracle_refine(lm, templates, T, size, k, x, y, valid, thr):
    """The oracle's per-candidate refinement step (match_class's inner
    loop) -> (x, y, sim, valid) arrays."""
    w_img, h_img = size
    border = 8 * T
    offset = T // 2 + (T % 2 - 1)
    f32 = np.float32
    out = []
    for kk, xx, yy, vv in zip(*(np.asarray(a) for a in (k, x, y, valid))):
        t = templates[int(kk)]
        cx = min(max(int(xx) * 2 + 1, border), w_img - t["width"] - border)
        cy = min(max(int(yy) * 2 + 1, border), h_img - t["height"] - border)
        S2 = oracle.similarity_local(lm, t["features"], size, T, (cx, cy))
        best, br, bc = f32(0.0), -1, -1
        for r in range(16):
            for c in range(16):
                sc = f32(f32(int(S2[r, c]) * f32(100.0))
                         / f32(4 * len(t["features"])))
                if sc > best:
                    best, br, bc = sc, r, c
        out.append(((cx // T - 8 + bc) * T + offset,
                    (cy // T - 8 + br) * T + offset, best,
                    bool(vv) and best >= thr))
    return out


def _assert_matches_oracle(res, want):
    _, nx, ny, sim, nv = (np.asarray(a) for a in res)
    for i, (wx, wy, ws, wv) in enumerate(want):
        assert bool(nv[i]) == wv, i
        if wv:
            assert (int(nx[i]), int(ny[i]), float(sim[i])) == (
                wx, wy, float(ws)), i


def _maps(lm, lmflat, bank, T, size, k, valid, use_pallas=False):
    K = int(bank.fx.shape[0])
    slots, slot_of_k, _ = distinct_templates(k, valid, K, K)
    Sfull, _ = coarse_similarity_dispatch(
        jnp.asarray(lm), lmflat, gather_bank(bank, slots), T, size,
        use_pallas=use_pallas, mask_positions=False, interpret=True)
    return Sfull, slot_of_k


@pytest.mark.parametrize("T,hw", [(4, 256), (8, 256), (4, 128)])
def test_refine_from_maps_equals_oracle(rng, T, hw):
    templates = _templates(rng, 9, 5, 48, 32)
    size = (hw, hw)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 8, hw, hw, T, templates)
    Sfull, slot_of_k = _maps(lm, lmflat, bank, T, size, k, valid)
    res = refine_from_maps(Sfull, slot_of_k, bank, T, size, k, x, y, valid,
                           jnp.float32(20.0))
    _assert_matches_oracle(res, _oracle_refine(
        lm, templates, T, size, k, x, y, valid, 20.0))


def test_refine_candidates_pathological_bank(rng):
    """Templates wider than image - 16T: the clamp drops features and
    reads outside the window; only the per-candidate gather is exact."""
    templates = _templates(rng, 5, 5, 40, 100)
    size = (128, 128)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 8, 128, 128, 4,
                                             templates)
    res = refine_candidates(lmflat, bank, 4, size, k, x, y, valid,
                            jnp.float32(10.0))
    _assert_matches_oracle(res, _oracle_refine(
        lm, templates, 4, size, k, x, y, valid, 10.0))


def test_refine_edge_features(rng):
    """Features at fx == template width (the reference's cropped-bbox
    edge) read the next plane row like the C++ pointer arithmetic."""
    templates = _templates(rng, 6, 10, 30, 32)
    for t in templates:
        t["features"][0] = (32, 5, 1)
        t["features"][1] = (31, 32, 2)
    size = (256, 256)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 8, 256, 256, 4,
                                             templates)
    for res in (refine_candidates(lmflat, bank, 4, size, k, x, y, valid,
                                  jnp.float32(15.0)),
                refine_from_maps(*_maps(lm, lmflat, bank, 4, size, k,
                                        valid), bank, 4, size, k, x, y,
                                 valid, jnp.float32(15.0))):
        _assert_matches_oracle(res, _oracle_refine(
            lm, templates, 4, size, k, x, y, valid, 15.0))


def test_refine_16ori_and_wide(rng):
    templates = _templates(rng, 4, 200, 400, 48, n_ori=16)
    size = (256, 256)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 16, 256, 256, 4,
                                             templates)
    Sfull, slot_of_k = _maps(lm, lmflat, bank, 4, size, k, valid)
    res = refine_from_maps(Sfull, slot_of_k, bank, 4, size, k, x, y, valid,
                           jnp.float32(30.0))
    _assert_matches_oracle(res, _oracle_refine(
        lm, templates, 4, size, k, x, y, valid, 30.0))


def test_refine_from_kernel_maps(rng):
    """Fine maps scored by the Triton kernel (interpreted) refine exactly
    like maps from the XLA scan."""
    templates = _templates(rng, 7, 5, 40, 32)
    size = (128, 128)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 8, 128, 128, 4,
                                             templates)
    res = refine_from_maps(*_maps(lm, lmflat, bank, 4, size, k, valid,
                                  use_pallas=True), bank, 4, size, k, x, y,
                           valid, jnp.float32(20.0))
    _assert_matches_oracle(res, _oracle_refine(
        lm, templates, 4, size, k, x, y, valid, 20.0))


def test_refine_invalid_rows_stay_invalid(rng):
    templates = _templates(rng, 4, 5, 30, 32)
    size = (128, 128)
    lm, lmflat, bank, k, x, y, _ = _case(rng, 8, 128, 128, 4, templates)
    valid = jnp.zeros(k.shape, bool)
    for res in (refine_candidates(lmflat, bank, 4, size, k, x, y, valid,
                                  jnp.float32(-1.0)),
                refine_from_maps(*_maps(lm, lmflat, bank, 4, size, k,
                                        valid), bank, 4, size, k, x, y,
                                 valid, jnp.float32(-1.0))):
        assert not np.asarray(res[4]).any()


def test_refine_threshold_filter(rng):
    """Candidates whose refined score falls below the threshold are
    dropped (line2Dup.cpp:1290); the two paths agree on which."""
    templates = _templates(rng, 6, 5, 40, 32)
    size = (128, 128)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 8, 128, 128, 4,
                                             templates)
    sims = np.asarray(refine_candidates(lmflat, bank, 4, size, k, x, y,
                                        valid, jnp.float32(0.0))[3])
    thr = float(np.median(sims[np.asarray(valid)]))
    a = refine_candidates(lmflat, bank, 4, size, k, x, y, valid,
                          jnp.float32(thr))
    b = refine_from_maps(*_maps(lm, lmflat, bank, 4, size, k, valid), bank,
                         4, size, k, x, y, valid, jnp.float32(thr))
    va, vb = np.asarray(a[4]), np.asarray(b[4])
    np.testing.assert_array_equal(va, vb)
    assert 0 < va.sum() < np.asarray(valid).sum()
    for i in range(1, 4):
        np.testing.assert_array_equal(np.asarray(a[i])[va],
                                      np.asarray(b[i])[va])


def test_refine_candidates_chunked_equals_oracle(rng):
    """C*N above the one-shot gather limit takes the candidate-chunked
    lax.map path; results stay exact."""
    templates = _templates(rng, 3, 2000, 2100, 40)
    size = (128, 128)
    lm, lmflat, bank, k, x, y, valid = _case(rng, 8, 128, 128, 4,
                                             templates, n_cand=160)
    assert k.shape[0] * bank.fx.shape[1] > 1 << 18
    res = refine_candidates(lmflat, bank, 4, size, k, x, y, valid,
                            jnp.float32(20.0))
    _assert_matches_oracle(res, _oracle_refine(
        lm, templates, 4, size, k, x, y, valid, 20.0))
