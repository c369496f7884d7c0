"""extract_candidates_cells (unmasked i32 score cells, one fused compare +
count pass) vs the reference extract_candidates on the masked i32 map —
exact equality of (k, x, y, score, valid, n_above), for scores from the
XLA scan and from the Triton kernel (interpreted), including position
masking and the negative/zero threshold quirk (cells past `positions`
count as score 0)."""

import numpy as np
import pytest

import jax.numpy as jnp

from shape_based_matching_tpu.ops.similarity import (
    coarse_similarity, coarse_similarity_dispatch, extract_candidates,
    extract_candidates_cells, pack_level_bank)


CASES = [
    # (T, w_img, h_img, K, N, thr) — N<=63 -> u8 packed4; N>63 -> u16
    (8, 128, 128, 8, 63, 85.0),
    (8, 120, 128, 6, 30, 40.0),
    (4, 64, 64, 5, 100, 30.0),     # packed2 u16 route
    (8, 128, 128, 6, 20, -5.0),    # negative threshold quirk
    (8, 128, 128, 6, 20, 0.0),     # rmin boundary
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_cells_extraction_equals_map_extraction(rng, case, use_pallas):
    T, w_img, h_img, K, N, thr = case
    M = (w_img // T) * (h_img // T)
    lm = jnp.asarray(rng.randint(0, 5, (8, T * T, M)).astype(np.uint8))
    lmflat = jnp.concatenate([lm.reshape(-1), jnp.zeros((M,), jnp.uint8)])
    templates = []
    for _ in range(K):
        feats = [(int(rng.randint(0, 48)), int(rng.randint(0, 48)),
                  int(rng.randint(0, 8))) for _ in range(N)]
        templates.append({"features": feats, "width": 48, "height": 48})
    bank = pack_level_bank(templates)
    W = w_img // T
    C = 64

    S, _ = coarse_similarity(lmflat, bank, T, (w_img, h_img))
    want = extract_candidates(S, bank.nfeat, jnp.float32(thr), T, W, C)
    cells, positions = coarse_similarity_dispatch(
        lm, lmflat, bank, T, (w_img, h_img), use_pallas=use_pallas,
        mask_positions=False, interpret=True)
    got = extract_candidates_cells(cells, positions, bank.nfeat,
                                   jnp.float32(thr), T, W, C, M)
    va, vb = np.asarray(want[4]), np.asarray(got[4])
    np.testing.assert_array_equal(va, vb)
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(want[i])[va],
                                      np.asarray(got[i])[va])
    assert int(want[5]) == int(got[5])
