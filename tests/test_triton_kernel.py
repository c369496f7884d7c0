"""The Triton coarse-scoring kernel (ops/pallas/similarity_triton.py) in the
Pallas interpreter vs the NumPy oracle and the XLA scan — exact int32
equality — plus its lowering to Triton IR for CUDA, which runs on a host
without a GPU. The compiled kernel is checked on the card by chip_smoke.py
and tests/test_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from shape_based_matching_tpu.ops.fastmath import exact_ratio_f32
from shape_based_matching_tpu.ops.pallas.similarity_triton import (
    block_m_for, coarse_scores_triton)
from shape_based_matching_tpu.ops.similarity import (
    _flat_offsets, _positions, coarse_similarity,
    coarse_similarity_dispatch, pack_level_bank)
from shape_based_matching_tpu.oracle import reference as oracle


def _random_case(rng, T, w, h, K, N, n_ori=8, tw=24, th=20, fx_hi=None,
                 p_valid=0.85):
    W, H = w // T, h // T
    M = W * H
    lm = rng.randint(0, 5, (n_ori, T * T, M)).astype(np.uint8)
    templates = []
    for _ in range(K):
        n = int(rng.randint(1, N + 1))
        feats = [(int(rng.randint(0, fx_hi or tw)), int(rng.randint(0, th)),
                  int(rng.randint(0, n_ori))) for _ in range(n)]
        templates.append({"features": feats, "width": tw, "height": th})
    bank = pack_level_bank(templates, n_pad=N)
    if p_valid < 1.0:
        drop = rng.rand(K, bank.fx.shape[1]) > p_valid
        bank = bank._replace(valid=bank.valid & jnp.asarray(~drop))
    return lm, templates, bank


def _kernel(lm, bank, T, size, n_ori, mask=True, **kw):
    w, h = size
    W, H = w // T, h // T
    M = W * H
    lmflat = jnp.concatenate([jnp.asarray(lm).reshape(-1),
                              jnp.zeros((M,), jnp.uint8)])
    off = _flat_offsets(bank, T, W, M, size, n_ori)
    return np.asarray(coarse_scores_triton(
        off, _positions(bank, T, W, H), lmflat, M, mask_positions=mask,
        interpret=True, **kw)), lmflat


def _oracle(lm, bank, T, size):
    """oracle.similarity per template over the bank's VALID slots."""
    fx, fy, lb, va = (np.asarray(a) for a in (bank.fx, bank.fy,
                                               bank.label, bank.valid))
    out = []
    for k in range(fx.shape[0]):
        feats = [(int(fx[k, n]), int(fy[k, n]), int(lb[k, n]))
                 for n in range(fx.shape[1]) if va[k, n]]
        out.append(oracle.similarity(
            lm, feats, (int(bank.width[k]), int(bank.height[k])), size,
            T).reshape(-1).astype(np.int64))
    return np.stack(out)


@pytest.mark.parametrize("T", [4, 8])
@pytest.mark.parametrize("n_ori", [8, 16])
@pytest.mark.parametrize("mask", [True, False])
def test_kernel_equals_oracle(rng, T, n_ori, mask):
    size = (128, 96)
    lm, _, bank = _random_case(rng, T, *size, K=6, N=21, n_ori=n_ori)
    got, lmflat = _kernel(lm, bank, T, size, n_ori, mask=mask)
    if mask:
        np.testing.assert_array_equal(got, _oracle(lm, bank, T, size))
    ref, _ = coarse_similarity(lmflat, bank, T, size, mask_positions=mask,
                               n_ori=n_ori)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("T,hw", [(8, (128, 128)), (4, (64, 96)),
                                  (8, (256, 64))])
def test_kernel_edge_features_at_width(rng, T, hw):
    """Features at fx == image width are out of the image (zero row);
    features near the right edge read across plane rows like the C++
    pointer arithmetic (line2Dup.cpp:843-856)."""
    w, h = hw
    lm, _, bank = _random_case(rng, T, w, h, K=4, N=16, tw=w, th=h // 2,
                               fx_hi=w + 1)
    fx = np.asarray(bank.fx).copy()
    fx[:, 0] = w           # out of the image
    fx[:, 1] = w - 1       # last column
    bank = bank._replace(fx=jnp.asarray(fx))
    got, _ = _kernel(lm, bank, T, (w, h), 8)
    np.testing.assert_array_equal(got, _oracle(lm, bank, T, (w, h)))


@pytest.mark.parametrize("N", [1, 7, 9, 17])
def test_kernel_padded_slots(rng, N):
    """Slot counts off the feature-step grid and dead (invalid) slots:
    both read the zero row and add nothing."""
    size = (64, 64)
    lm, _, bank = _random_case(rng, 4, *size, K=5, N=N, p_valid=0.6)
    got, _ = _kernel(lm, bank, 4, size, 8)
    np.testing.assert_array_equal(got, _oracle(lm, bank, 4, size))


def test_kernel_wide_bank(rng):
    """A wide bank (hundreds of slots, the 8191-feature mode's shape)."""
    size = (64, 64)
    lm, _, bank = _random_case(rng, 4, *size, K=3, N=600, tw=40, th=40)
    got, _ = _kernel(lm, bank, 4, size, 8)
    np.testing.assert_array_equal(got, _oracle(lm, bank, 4, size))


@pytest.mark.parametrize("size", [(72, 48), (120, 88), (40, 200)])
def test_kernel_non_power_of_two_positions(rng, size):
    """M = (w/T)*(h/T) not a power of two: the last position block is
    masked at j < M."""
    lm, _, bank = _random_case(rng, 4, *size, K=4, N=12, tw=16, th=16)
    got, _ = _kernel(lm, bank, 4, size, 8, block_m=128)
    assert got.shape[1] % 128 != 0
    np.testing.assert_array_equal(got, _oracle(lm, bank, 4, size))


@pytest.mark.parametrize("block_m,N", [(128, 4), (128, 16), (256, 8),
                                       (512, 19), (512, 33), (1024, 7)])
def test_kernel_block_configs(rng, block_m, N):
    """Every position-block width, with slot counts on and off the
    F_STEP grid."""
    size = (128, 128)
    lm, _, bank = _random_case(rng, 4, *size, K=3, N=N)
    got, lmflat = _kernel(lm, bank, 4, size, 8, block_m=block_m)
    ref, _ = coarse_similarity(lmflat, bank, 4, size)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_block_m_for_fills_the_card():
    assert block_m_for(1000, 4096) == 512       # many templates: wide
    assert block_m_for(8, 4096) == 128          # 8 x 8191 bank: narrow
    assert block_m_for(64, 65536) == 512        # fine-level maps
    for K, M in ((1, 64), (3, 100000), (10000, 4096)):
        bm = block_m_for(K, M)
        assert bm & (bm - 1) == 0 and 128 <= bm <= 512


def test_kernel_oversize_template_masks_everything(rng):
    """positions <= 0 (template larger than the level): masked scores
    are all zero, as the reference's loop never runs."""
    size = (64, 64)
    lm, _, bank = _random_case(rng, 4, *size, K=2, N=8, tw=80, th=80)
    got, _ = _kernel(lm, bank, 4, size, 8)
    assert int(np.asarray(_positions(bank, 4, 16, 16)).max()) <= 0
    assert not got.any()
    np.testing.assert_array_equal(got, _oracle(lm, bank, 4, size))


@pytest.mark.parametrize("K,N,M", [(1000, 32, 4096), (8, 9126, 65536)])
def test_kernel_lowers_to_triton_for_cuda(K, N, M):
    """The kernel lowers to a Triton custom call for CUDA at real widths
    (the GPU compiler itself runs only on the card)."""
    L = 8 * 64 * M
    f = jax.jit(lambda o, p, lm: coarse_scores_triton(o, p, lm, M))
    text = f.trace(jax.ShapeDtypeStruct((K, N), jnp.int32),
                   jax.ShapeDtypeStruct((K,), jnp.int32),
                   jax.ShapeDtypeStruct((L + M,), jnp.uint8)).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in text and 'name = "coarse_scores"' in text


def test_dispatch_routes_kernel_and_xla(rng):
    size = (64, 64)
    lm, _, bank = _random_case(rng, 4, *size, K=3, N=10)
    lmflat = jnp.concatenate([jnp.asarray(lm).reshape(-1),
                              jnp.zeros((256,), jnp.uint8)])
    a, pa = coarse_similarity_dispatch(jnp.asarray(lm), lmflat, bank, 4,
                                       size, use_pallas=True,
                                       interpret=True)
    b, pb = coarse_similarity_dispatch(jnp.asarray(lm), lmflat, bank, 4,
                                       size, use_pallas=False)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


def test_exact_ratio_grid():
    """Every score quotient raw*100 / (4*nfeat) on a dense grid equals
    NumPy's IEEE float32 division."""
    raw = np.arange(0, 1600, dtype=np.int32)
    n = np.arange(1, 400, dtype=np.int32)
    R, N = np.meshgrid(raw, n, indexing="ij")
    got = np.asarray(jax.jit(exact_ratio_f32)(jnp.asarray(R * 100),
                                              jnp.asarray(4 * N)))
    np.testing.assert_array_equal(
        got, (R * 100).astype(np.float32) / (4 * N).astype(np.float32))


def test_exact_ratio_random_full_range():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2 ** 24, 50000).astype(np.int32)
    b = rng.randint(1, 2 ** 16, 50000).astype(np.int32)
    got = np.asarray(jax.jit(exact_ratio_f32)(jnp.asarray(a),
                                              jnp.asarray(b)))
    np.testing.assert_array_equal(got, a.astype(np.float32)
                                  / b.astype(np.float32))


def test_exact_ratio_extremes():
    a = np.array([0, 1, 3, 2 ** 24 - 1, 2 ** 24 - 1, 5, 36504 * 100],
                 np.int32)
    b = np.array([7, 65535, 1, 2, 65535, 65534, 36504], np.int32)
    got = np.asarray(exact_ratio_f32(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, a.astype(np.float32)
                                  / b.astype(np.float32))
    assert got[-1] == np.float32(100.0)
