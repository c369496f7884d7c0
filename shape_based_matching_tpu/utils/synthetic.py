"""Synthetic scenes + template banks for benchmarks and entry points.

Self-contained (no reference fixtures needed): draws an anchor-like polygon
shape, trains one template from it, and derives K rotated variants via the
direct feature-rotation path (line2Dup.cpp:1409-1451 equivalent) — the same
construction the reference's angle_test demo uses.
"""

from __future__ import annotations

import os

import numpy as np

# Bank-cache schema version: bump on any change to the training math or
# the serialization below (stale caches would silently change bench
# configs otherwise).
_BANK_CACHE_V = 1


def synthetic_shape_image(size: int = 256, seed: int = 0) -> np.ndarray:
    """A textured polygon on dark background; strong, well-spread edges."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(size, size) * 20).astype(np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    c = size / 2.0
    # spiky star polygon: radius modulated by angle
    ang = np.arctan2(yy - c, xx - c)
    rad = np.hypot(yy - c, xx - c)
    rmax = size * (0.28 + 0.10 * np.cos(3 * ang) + 0.06 * np.sin(7 * ang))
    inside = rad < rmax
    img[inside] = 200
    hole = rad < size * (0.08 + 0.03 * np.sin(5 * ang))
    img[hole] = 40
    return img


def synthetic_scene(h: int, w: int, templ: np.ndarray, n_instances: int = 3,
                    seed: int = 1) -> np.ndarray:
    """Paste template instances into a noisy scene."""
    rng = np.random.RandomState(seed)
    scene = (rng.rand(h, w) * 25).astype(np.uint8)
    th, tw = templ.shape
    for i in range(n_instances):
        y = rng.randint(0, h - th)
        x = rng.randint(0, w - tw)
        region = scene[y : y + th, x : x + tw]
        scene[y : y + th, x : x + tw] = np.maximum(region, templ)
    return scene


def scene_caps(num_templates: int) -> tuple[int, int]:
    """(cand_cap, distinct_cap) for Detector.match_batch that hold every
    coarse candidate and every distinct refine template of a 1024x1024
    synthetic_scene (4 instances) matched at threshold 85 against a
    build_rotated_detector bank of `num_templates` x 63 features.

    Measured on such scenes (seeds 0-7, 20-33): at most 0.42 K coarse
    candidates and 0.065 K distinct templates for K = 360, 1000 and 10000
    (e.g. 413 and 64 at K = 1000; 3639 and 605 at K = 10000). The caps
    are the powers of two at or above K and K / 10, never below
    match_batch's defaults. Callers that time the batched program check
    its overflow flags: a frame over either cap would be truncated."""
    pow2 = lambda n: 1 << max(0, int(n) - 1).bit_length()
    return max(256, pow2(num_templates)), max(64, pow2(num_templates // 10))


def synthetic_block_noise_image(size: int = 512, block: int = 4,
                                seed: int = 0) -> np.ndarray:
    """Binary block noise: strong edges EVERYWHERE — the only synthetic
    texture dense enough to saturate the fork's 8191-feature mode
    (README.md:45; a polygon outline tops out near ~2k candidates)."""
    rng = np.random.RandomState(seed)
    blocks = (rng.rand(size // block, size // block) > 0.5)
    img = np.kron(blocks, np.ones((block, block), bool))
    return np.where(img, 220, 30).astype(np.uint8)


def _bank_cache_dir() -> str:
    """Committed bank snapshots (repo `bench_banks/`) unless overridden.

    A committed snapshot makes a bench or smoke run's setup a file read
    instead of a training run (tests/test_bank_cache.py pins it
    bit-identical to live training)."""
    d = os.environ.get("SBM_BANK_CACHE_DIR")
    if d:
        return d
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(here, "bench_banks")


def _bank_cache_key(num_templates, num_features, T, size, seed, dense,
                    n_ori) -> str:
    t_tag = "-".join(str(t) for t in T)
    return (f"rot{num_templates}x{num_features}_T{t_tag}_s{size}"
            f"_seed{seed}{'_dense' if dense else ''}"
            f"{'_ori16' if n_ori == 16 else ''}_v{_BANK_CACHE_V}")


def save_bank_cache(path: str, pyramids) -> None:
    """Serialize a class's template pyramids to one compressed npz.

    Flat ragged layout: `feat` [N, 3] i16 (x, y, label) with `offsets`
    [n_templates*levels + 1] i32, plus per-(template, level) int metadata
    and float metadata. Feature.theta is NOT stored (matching never reads
    it; only further add_template_rotate calls would — same contract as
    the YAML format, models/template.py:18)."""
    K = len(pyramids)
    levels = len(pyramids[0]) if K else 0
    feats, offsets = [], [0]
    meta_i, meta_f, fid = [], [], []
    for tp in pyramids:
        assert len(tp) == levels, "ragged pyramid levels not cacheable"
        for t in tp:
            feats.extend((f.x, f.y, f.label) for f in t.features)
            offsets.append(len(feats))
            meta_i.append((t.width, t.height, t.tl_x, t.tl_y,
                           t.pyramid_level, t.tag_field_id))
            meta_f.append((t.sscale, t.orientation))
            fid.append(t.fiducial_src)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, v=np.int32(_BANK_CACHE_V), k=np.int32(K),
            levels=np.int32(levels),
            feat=np.asarray(feats, np.int16).reshape(-1, 3),
            offsets=np.asarray(offsets, np.int64),
            meta_i=np.asarray(meta_i, np.int32).reshape(-1, 6),
            meta_f=np.asarray(meta_f, np.float64).reshape(-1, 2),
            fid=np.asarray(fid, dtype=np.str_))
    os.replace(tmp, path)


def load_bank_cache(path: str):
    """Inverse of save_bank_cache; returns the pyramids list or None."""
    from ..models.template import Feature, Template

    if not os.path.isfile(path):
        return None
    with np.load(path) as z:
        if int(z["v"]) != _BANK_CACHE_V:
            return None
        K, levels = int(z["k"]), int(z["levels"])
        feat, offsets = z["feat"], z["offsets"]
        meta_i, meta_f, fid = z["meta_i"], z["meta_f"], z["fid"]
    pyramids, row = [], 0
    for _ in range(K):
        tp = []
        for _ in range(levels):
            fs = feat[offsets[row]:offsets[row + 1]]
            w, h, tlx, tly, lvl, tagf = (int(v) for v in meta_i[row])
            tp.append(Template(
                width=w, height=h, tl_x=tlx, tl_y=tly, pyramid_level=lvl,
                features=[Feature(int(x), int(y), int(lb)) for x, y, lb
                          in fs],
                sscale=float(meta_f[row][0]),
                orientation=float(meta_f[row][1]),
                tag_field_id=tagf, fiducial_src=str(fid[row])))
            row += 1
        pyramids.append(tp)
    return pyramids


def build_rotated_detector(num_templates: int = 360, num_features: int = 63,
                           T=(4, 8), size: int = 256, seed: int = 0,
                           dense: bool = False, n_ori: int = 8,
                           cache: bool = True):
    """Detector with one trained template + (num_templates-1) rotations.

    `dense=True` trains on block noise instead of the star polygon —
    feature-saturated templates for wide-feature (up to 8191) configs.

    `cache=True` loads the finished bank from `bench_banks/` when a
    snapshot exists (bit-identical to training: tests/test_bank_cache.py)
    so bench subprocesses skip device training; set env
    SBM_NO_BANK_CACHE=1 to force live training, SBM_BANK_CACHE_WRITE=1
    to (re)generate snapshots after a live build."""
    from ..models.detector import Detector

    templ_img = (synthetic_block_noise_image(size, seed=seed) if dense
                 else synthetic_shape_image(size, seed))
    use_cache = cache and os.environ.get("SBM_NO_BANK_CACHE", "") != "1"
    cache_path = os.path.join(
        _bank_cache_dir(),
        _bank_cache_key(num_templates, num_features, T, size, seed,
                        dense, n_ori) + ".npz")
    if use_cache:
        pyramids = load_bank_cache(cache_path)
        if pyramids is not None and len(pyramids) == num_templates:
            det = Detector(num_features=num_features, T=T,
                           num_orientations=n_ori)
            det.class_templates["bench"] = pyramids
            return det, templ_img

    det = Detector(num_features=num_features, T=T, num_orientations=n_ori)
    mask = np.full_like(templ_img, 255)
    tid = det.add_template(templ_img, "bench", mask)
    assert tid == 0, "synthetic template training failed"
    step = 360.0 / num_templates
    c = size / 2.0
    det.add_templates_rotate("bench", 0,
                             [i * step for i in range(1, num_templates)],
                             (c, c))
    if use_cache and os.environ.get("SBM_BANK_CACHE_WRITE", "") == "1":
        save_bank_cache(cache_path, det.class_templates["bench"])
    return det, templ_img
