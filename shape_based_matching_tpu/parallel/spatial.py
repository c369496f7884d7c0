"""Spatial scale-out: one huge frame sharded by rows across chips.

SURVEY.md §5 maps the reference's "long-context" analog (image area x
template count) to spatial sharding: for frames too large for one chip's
HBM/latency budget, shard the IMAGE across the mesh and all-gather only
the candidate matches (the reference — a single-threaded C++ library with
an OpenMP template loop, line2Dup.cpp:1166-1169 — has no equivalent).

Design (exactness-first):

* Each of the n shards owns a disjoint band of Hs = H/n rows; its device
  receives an OVERLAPPING tile of Hs + 2*halo rows (clipped to the image:
  the first/last tiles start/end exactly at the image border, so OpenCV
  border semantics — BORDER_REPLICATE blur/sobel, the 1-px zeroed
  quantization border (line2Dup.cpp:229-236) — land on the true image
  edges with no kernel changes). The tile scatter is the data-loader's
  overlapping DMA; no inter-chip traffic is needed for pixels.
* Every shard runs the COMPLETE match pipeline on its tile (pyramid,
  coarse bank scoring, candidate extraction, pyramid refinement) with
  the very same kernels as the single-chip path, then keeps only the
  candidates whose coarse origin falls in its own band (halo candidates
  are duplicates of a neighbor's) and translates y to frame coordinates.
* Candidate lists are exchanged with `all_gather`; scores/positions are
  bit-identical to the single-device full-frame match for every match
  whose geometry stays `halo` away from the band edges — the halo
  default covers the frontend support (blur/sobel/vote/spread/pyrDown,
  ~48 rows), the refinement reach (16x16 window around the doubled
  origin plus the border clamp, 8*T_0 rows) and the template height, so
  in practice the equality is exact (asserted by
  tests/test_spatial.py against Detector.match).

The halo must satisfy H >= Hs + 2*halo (tiles are in-image crops); both
Hs and halo must be multiples of the pyramid stride so every tile keeps
the kernels' tiling contract.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.similarity import (LevelBank, coarse_extract_dispatch,
                              coarse_similarity_dispatch,
                              distinct_templates, gather_bank,
                              refine_from_maps)


def make_spatial_mesh(n_shards: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_shards or len(devs)
    return Mesh(np.array(devs[:n]), ("spatial",))


def required_halo(banks, T_levels: tuple) -> int:
    """Minimum halo (frame rows) for exact band-edge semantics.

    Covers, for EVERY pyramid level l (a level-l template row spans 2^l
    frame rows): the template height, the 16x16 refinement window reach
    (8 * T_0 frame rows around the doubled origin), and the frontend
    support (7-tap blur + sobel + vote + T-row spread + pyrDown chain,
    bounded by 128 frame rows). `banks` is a single finest-level
    LevelBank or the per-level bank list."""
    if isinstance(banks, LevelBank):
        banks = [banks]
    th_max = max(int(np.asarray(b.height).max()) * (2 ** l)
                 for l, b in enumerate(banks))
    return th_max + 8 * T_levels[0] + 128


def default_halo(banks, T_levels: tuple) -> int:
    """required_halo rounded up to the pyramid stride (tiles must keep
    every level's tiling contract)."""
    stride = T_levels[-1] * (2 ** (len(T_levels) - 1))
    return -(-required_halo(banks, T_levels) // stride) * stride


def spatial_match_step(mesh: Mesh, T_levels: tuple, size_hw: tuple,
                       n_shards: int, halo: int, cand_cap: int = 256,
                       distinct_cap: int = 64, gray: bool = True,
                       n_ori: int = 8, use_pallas: bool | None = None):
    """Jitted row-sharded match for ONE huge frame.

    step(tiles [n_shards, Hs + 2*halo, W] u8, weak_threshold, threshold,
         *bank_fields) -> (k, x, y, score, valid) each
    [n_shards * cand_cap] in FRAME coordinates, plus n_above [n_shards].

    `tiles` come from :func:`slice_tiles` (overlapping in-image crops);
    the per-shard band ownership and y translation are derived from the
    same clipped-start arithmetic on the device side.
    """
    h, w = size_hw
    hs = h // n_shards
    tile_h = hs + 2 * halo
    if h < tile_h:
        raise ValueError(f"frame height {h} < tile {tile_h}; "
                         f"lower halo or shard count")
    levels = len(T_levels)
    stride = T_levels[-1] * (2 ** (levels - 1))
    if hs % stride or halo % stride:
        raise ValueError(f"band {hs} and halo {halo} must be multiples "
                         f"of the pyramid stride {stride}")
    sizes = [(w >> l, tile_h >> l) for l in range(levels)]
    t_last = T_levels[-1]

    def per_shard(tile, weak_threshold, threshold, *fields):
        from ..models.detector import _lm_pyramid

        banks = []
        for l in range(levels):
            banks.append(LevelBank(*fields[7 * l:7 * (l + 1)]))
        K = banks[-1].fx.shape[0]

        i = jax.lax.axis_index("spatial").astype(jnp.int32)
        start = jnp.clip(i * hs - halo, 0, h - tile_h)  # tile's frame row

        tile2d = tile[0]
        lms = _lm_pyramid(tile2d, jnp.zeros((1, 1), jnp.uint8), gray,
                          False, T_levels, levels, weak_threshold, n_ori)

        k, x, y, sc, valid, n_above = coarse_extract_dispatch(
            lms[-1][0], lms[-1][1], banks[-1], t_last, sizes[-1],
            threshold, cand_cap, use_pallas)
        # band ownership at the coarse level: the candidate's frame row
        # (coarse pixel coords are level-(levels-1) pixels)
        scale = 2 ** (levels - 1)
        y_frame = y * scale + start
        band_lo = i * hs
        valid = valid & (y_frame >= band_lo) & (y_frame < band_lo + hs)

        for l in range(levels - 2, -1, -1):
            slots, slot_of_k, _nd = distinct_templates(k, valid, K,
                                                       distinct_cap)
            sub = gather_bank(banks[l], slots)
            Sfull, _ = coarse_similarity_dispatch(
                lms[l][0], lms[l][1], sub, T_levels[l], sizes[l],
                use_pallas, mask_positions=False)
            k, x, y, sc, valid = refine_from_maps(
                Sfull, slot_of_k, banks[l], T_levels[l], sizes[l],
                k, x, y, valid, threshold)

        y = jnp.where(valid, y + start, 0)
        k = jnp.where(valid, k, 0)
        x = jnp.where(valid, x, 0)
        sc = jnp.where(valid, sc, 0.0)
        # every shard ends with the full frame's candidate set
        k, x, y, sc, valid = (
            jax.lax.all_gather(a, "spatial", axis=0, tiled=True)
            for a in (k, x, y, sc, valid))
        return k, x, y, sc, valid, n_above[None]

    bank_specs = tuple(P() for _ in range(7 * levels))
    shard = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P("spatial"), P(), P()) + bank_specs,
        out_specs=(P(), P(), P(), P(), P(), P("spatial")),
        check_vma=False,
    )
    return jax.jit(shard)


def slice_tiles(image: np.ndarray, n_shards: int, halo: int) -> np.ndarray:
    """Overlapping in-image row tiles [n, Hs + 2*halo, W] for
    spatial_match_step (the loader-side scatter)."""
    h = image.shape[0]
    hs = h // n_shards
    tile_h = hs + 2 * halo
    tiles = []
    for i in range(n_shards):
        s = min(max(i * hs - halo, 0), h - tile_h)
        tiles.append(image[s:s + tile_h])
    return np.stack(tiles)


def match_huge_frame(detector, image, threshold: float,
                     mesh: Mesh | None = None, class_id=None,
                     halo: int | None = None, cand_cap: int = 256,
                     use_pallas: bool | None = None):
    """Host convenience: spatially-sharded match of one frame, returning
    the same sorted/deduped Match list as Detector.match.

    `class_id`: a class name, a list of names, or None for EVERY trained
    class (the reference loops matchClass over all classes,
    line2Dup.cpp:1129-1141) — multi-class registries run as ONE merged
    bank per shard, exactly like Detector.match_batch's merged path.

    An explicit `halo` is validated against :func:`required_halo` for the
    selected banks — a too-small halo would silently produce inexact
    near-band-edge scores, so it raises instead."""
    from ..models.detector import Match, _sort_dedup

    if mesh is None:
        mesh = make_spatial_mesh()
    n = mesh.devices.shape[0]
    image = np.asarray(image)
    h, w = image.shape[:2]
    detector._validate_size((h, w))
    if h % n:
        raise ValueError(f"frame height {h} not divisible by {n} shards")
    if class_id is None:
        class_ids = detector.class_ids()
    elif isinstance(class_id, str):
        class_ids = [class_id]
    else:
        class_ids = list(class_id)
    if len(class_ids) == 1:
        banks = detector._get_banks(class_ids[0])
        cid0 = class_ids[0]
        mapper = (lambda kk: (cid0, kk))
    else:
        banks, class_of_k, tid_of_k = detector._get_merged_banks(
            tuple(class_ids))
        mapper = (lambda kk: (class_ids[int(class_of_k[kk])],
                              int(tid_of_k[kk])))
    need = required_halo(banks, detector.T_at_level)
    if halo is None:
        stride = (detector.T_at_level[-1]
                  * (2 ** (detector.pyramid_levels - 1)))
        halo = -(-need // stride) * stride
    elif halo < need:
        raise ValueError(
            f"halo {halo} < required {need} (template height + 16x16 "
            f"refinement reach + frontend support); near-band-edge "
            f"matches would be inexact — pass halo >= {need} or omit it")

    step = spatial_match_step(mesh, detector.T_at_level, (h, w), n, halo,
                              cand_cap=cand_cap,
                              gray=image.ndim == 2,
                              n_ori=detector.num_orientations,
                              use_pallas=use_pallas)
    fields = [f for b in banks for f in b]
    tiles = slice_tiles(image, n, halo)
    k, x, y, sc, valid, n_above = step(
        jnp.asarray(tiles), jnp.float32(detector.weak_threshold),
        jnp.float32(threshold), *fields)
    k, x, y, sc, valid = (np.asarray(a) for a in (k, x, y, sc, valid))
    if (np.asarray(n_above) > cand_cap).any():
        import warnings

        warnings.warn(f"candidate overflow: max "
                      f"{int(np.asarray(n_above).max())} above threshold, "
                      f"cap {cand_cap}; raise cand_cap for full parity")
    out = []
    for i in np.nonzero(valid)[0]:
        cid, tid = mapper(int(k[i]))
        out.append(Match(int(x[i]), int(y[i]), float(sc[i]), cid, tid))
    return _sort_dedup(out)
