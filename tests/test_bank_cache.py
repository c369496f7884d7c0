"""Bank-cache (bench_banks/) parity: cached banks must be bit-identical
to live training — the cache exists purely to shorten the bench's
set-up, never to change what is measured."""

import os

import numpy as np
import pytest

from shape_based_matching_tpu.utils.synthetic import (
    _bank_cache_dir, _bank_cache_key, build_rotated_detector,
    load_bank_cache, save_bank_cache)


def _flat(pyramids):
    """Fully comparable structure: every serialized Template field."""
    out = []
    for tp in pyramids:
        for t in tp:
            out.append((t.width, t.height, t.tl_x, t.tl_y,
                        t.pyramid_level, t.sscale, t.orientation,
                        t.tag_field_id, t.fiducial_src,
                        [(f.x, f.y, f.label) for f in t.features]))
    return out


def test_roundtrip_exact(tmp_path):
    det, _ = build_rotated_detector(num_templates=24, num_features=63,
                                    cache=False)
    pyramids = det.class_templates["bench"]
    path = str(tmp_path / "bank.npz")
    save_bank_cache(path, pyramids)
    loaded = load_bank_cache(path)
    assert _flat(loaded) == _flat(pyramids)


def test_cache_hit_equals_live_training(tmp_path, monkeypatch):
    monkeypatch.setenv("SBM_BANK_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("SBM_BANK_CACHE_WRITE", "1")
    monkeypatch.delenv("SBM_NO_BANK_CACHE", raising=False)
    det_live, img_live = build_rotated_detector(num_templates=24,
                                                num_features=63)
    # second call loads the snapshot the first one just wrote
    det_cached, img_cached = build_rotated_detector(num_templates=24,
                                                    num_features=63)
    assert (_bank_cache_key(24, 63, (4, 8), 256, 0, False, 8) + ".npz"
            ) in os.listdir(tmp_path)
    assert np.array_equal(img_live, img_cached)
    assert _flat(det_cached.class_templates["bench"]) == _flat(
        det_live.class_templates["bench"])


@pytest.mark.parametrize("cfg", [
    dict(num_templates=360, num_features=63),
    dict(num_templates=360, num_features=63, n_ori=16),
])
def test_committed_snapshot_matches_live_training(cfg):
    """The committed bench_banks/ snapshots == live training, re-derived
    here for the cheapest configs (the rest are the same producer at
    other sizes; tools/gen_bank_caches.py regenerates all of them)."""
    key = _bank_cache_key(cfg["num_templates"], cfg["num_features"],
                          (4, 8), 256, 0, False, cfg.get("n_ori", 8))
    path = os.path.join(_bank_cache_dir(), key + ".npz")
    if not os.path.isfile(path):
        pytest.skip(f"snapshot {key} not committed")
    det, _ = build_rotated_detector(cache=False, **cfg)
    assert _flat(load_bank_cache(path)) == _flat(
        det.class_templates["bench"])
