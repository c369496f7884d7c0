"""Multi-chip scale-out: data-parallel frames × template-parallel bank.

The reference's only parallelism is an OpenMP loop over templates on one CPU
(line2Dup.cpp:1166-1169). The device scale-out shards two axes over a
`jax.sharding.Mesh`:

* ``data``  — a batch of frames (each chip builds the response pyramid for
  its own frames; zero communication),
* ``templ`` — the packed template bank. Each chip scores its slice of the
  bank against every local frame, refines its own candidates through the
  full pyramid (its bank slice + the locally-built fine-level memories are
  all it needs — refinement is communication-free), and the refined
  candidate lists are exchanged with ``all_gather`` so every data shard
  ends with the complete match set.

This is the COMPLETE ``Detector::match`` pipeline (line2Dup.cpp:1078-1297)
under one ``jit`` over the mesh via ``shard_map`` — gradients, quantization,
spread/response/linearize per level, batched coarse scoring, candidate
extraction, pyramid refinement, and candidate assembly. XLA inserts the
collectives (NCCL on GPUs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.gradients import (quantized_orientations_color,
                             quantized_orientations_gray)
from ..ops.response import build_linear_memories
from ..ops.similarity import (LevelBank, coarse_extract_dispatch,
                              coarse_similarity_dispatch,
                              distinct_templates, gather_bank,
                              refine_from_maps)
from ..ops.filters import pyr_down_u8


def make_mesh(n_devices: int | None = None, data: int | None = None):
    """Build a (data, templ) mesh over the available devices.

    Template parallelism is favored (the bank is usually the big axis):
    ``data=2`` only when there are >= 4 devices; with 2 devices the mesh is
    (1, 2) so the bank actually shards.
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if data is None:
        data = 2 if n % 2 == 0 and n >= 4 else 1
    assert n % data == 0
    arr = np.array(devs[:n]).reshape(data, n // data)
    return Mesh(arr, ("data", "templ"))


def shard_pad_bank(bank: LevelBank, n_shards: int) -> LevelBank:
    """Pad the template axis to a multiple of n_shards with dead rows
    (valid=False, nfeat=0 -> never above threshold, 1x1 bbox)."""
    K = int(bank.fx.shape[0])
    Kp = -(-K // n_shards) * n_shards
    if Kp == K:
        return bank
    pad = Kp - K

    def pad_kn(a, fill=0):
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])

    return LevelBank(
        fx=pad_kn(bank.fx), fy=pad_kn(bank.fy), label=pad_kn(bank.label),
        valid=pad_kn(bank.valid), nfeat=pad_kn(bank.nfeat),
        width=pad_kn(bank.width, 1), height=pad_kn(bank.height, 1))


def _local_match(images, banks, T_levels, sizes, weak_threshold, threshold,
                 cand_cap, distinct_cap, gray, n_ori, use_pallas=None):
    """Full single-shard match on a batch of local frames with a local bank
    slice: pyramid -> coarse scores -> candidates -> per-level refinement.
    Returns packed candidate arrays [B_loc, cand_cap] with LOCAL template
    ids, plus overflow counters (n_above, n_distinct per image).

    Same scorer choice as the single-device Detector: the Triton kernel on
    GPU shards, XLA elsewhere (the virtual-CPU test mesh); results are
    bit-identical either way."""
    from ..models.detector import _lm_pyramid

    levels = len(T_levels)
    K_loc = banks[-1].fx.shape[0]
    t_last = T_levels[-1]

    def one_image(img):
        lms = _lm_pyramid(img, jnp.zeros((1, 1), jnp.uint8), gray, False,
                          T_levels, levels, weak_threshold, n_ori)
        k, x, y, sc, valid, n_above = coarse_extract_dispatch(
            lms[-1][0], lms[-1][1], banks[-1], t_last, sizes[-1],
            threshold, cand_cap, use_pallas)
        n_distinct_max = jnp.int32(0)
        for l in range(levels - 2, -1, -1):
            slots, slot_of_k, nd = distinct_templates(k, valid, K_loc,
                                                      distinct_cap)
            n_distinct_max = jnp.maximum(n_distinct_max, nd)
            sub = gather_bank(banks[l], slots)
            Sfull, _ = coarse_similarity_dispatch(
                lms[l][0], lms[l][1], sub, T_levels[l], sizes[l],
                use_pallas=use_pallas, mask_positions=False)
            k, x, y, sc, valid = refine_from_maps(
                Sfull, slot_of_k, banks[l], T_levels[l], sizes[l],
                k, x, y, valid, threshold)
        return k, x, y, sc, valid, n_above, n_distinct_max

    return jax.vmap(one_image)(images)


def multichip_match_step(mesh: Mesh, T_levels: tuple, size_hw: tuple,
                         cand_cap: int = 256, distinct_cap: int = 64,
                         gray: bool = True, n_ori: int = 8,
                         return_scores: bool = False,
                         use_pallas: bool | None = None):
    """Jitted FULL match pipeline over the mesh.

    step(images [B, H, W{,3}] u8, weak_threshold f32, threshold f32,
         *bank_fields) ->
        (k, x, y, score, valid) each [B, levels? no — cand_cap * n_templ],
        n_above [B], n_distinct [B]
    with the batch sharded over 'data', the bank over 'templ', and the
    refined candidates all-gathered over 'templ' (GLOBAL template ids).
    Bank fields are the per-level LevelBank tuples flattened in order
    (level 0 first); template axes must be divisible by the templ size
    (use shard_pad_bank).

    With return_scores=True also returns the coarse score map S
    [B, K_total, M_last] all-gathered over 'templ' — used by the
    sharding-equivalence tests to check element-wise score parity.
    """
    h, w = size_hw
    levels = len(T_levels)
    sizes = []
    for l in range(levels):
        sizes.append((w >> l, h >> l))
    t_last = T_levels[-1]

    def per_shard(images, weak_threshold, threshold, *fields):
        banks = []
        for l in range(levels):
            banks.append(LevelBank(*fields[7 * l:7 * (l + 1)]))
        K_loc = banks[-1].fx.shape[0]
        k, x, y, sc, valid, n_above, nd = _local_match(
            images, banks, T_levels, sizes, weak_threshold, threshold,
            cand_cap, distinct_cap, gray, n_ori, use_pallas=use_pallas)
        # local -> global template ids
        shard = jax.lax.axis_index("templ").astype(jnp.int32)
        k = jnp.where(valid, k + shard * K_loc, 0)
        # every data shard sees all template shards
        k, x, y, sc, valid = (
            jax.lax.all_gather(a, "templ", axis=1, tiled=True)
            for a in (k, x, y, sc, valid))
        n_above = jax.lax.psum(n_above, "templ")
        nd = jax.lax.pmax(nd, "templ")
        if not return_scores:
            return k, x, y, sc, valid, n_above, nd

        def coarse_only(img):
            src = img
            for _ in range(levels - 1):
                src = pyr_down_u8(src)
            if gray:
                g = quantized_orientations_gray(src, weak_threshold, n_ori)
            else:
                g = quantized_orientations_color(src, weak_threshold, n_ori)
            lm = build_linear_memories(g.angle, t_last, n_ori)
            m = lm.shape[-1]
            lmflat = jnp.concatenate([lm.reshape(-1),
                                      jnp.zeros((m,), jnp.uint8)])
            S, _ = coarse_similarity_dispatch(lm, lmflat, banks[-1], t_last,
                                              sizes[-1], use_pallas)
            return S

        S = jax.vmap(coarse_only)(images)
        S = jax.lax.all_gather(S, "templ", axis=1, tiled=True)
        return k, x, y, sc, valid, n_above, nd, S

    img_spec = P("data")
    bank_specs = tuple(P("templ") for _ in range(7 * levels))
    out_core = (P("data", None), P("data", None), P("data", None),
                P("data", None), P("data", None), P("data"), P("data"))
    out_specs = out_core + ((P("data", None, None),) if return_scores
                            else ())
    shard = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(img_spec, P(), P()) + bank_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(shard)


def match_images_sharded(detector, images, threshold: float,
                         mesh: Mesh | None = None,
                         class_id=None,
                         cand_cap: int = 256, distinct_cap: int = 64,
                         use_pallas: bool | None = None):
    """Host convenience: run the full sharded match for a batch of frames
    and assemble Match lists exactly like Detector.match (sort + dedup).

    `class_id`: a class name, a list of class names, or None for every
    trained class (Detector.match semantics; matchClass is per-class
    independent, line2Dup.cpp:1129-1141 — each class runs its own
    sharded step, so multi-class calls rebuild the frame pyramid per
    class).

    The reference has no multi-frame or multi-device path at all; this is
    the device scale-out of line2Dup.cpp:1078-1150 over frames x bank.
    """
    from ..models.detector import _sort_dedup

    if mesh is None:
        mesh = make_mesh()
    if class_id is None:
        class_ids = detector.class_ids()
    elif isinstance(class_id, str):
        class_ids = [class_id]
    else:
        class_ids = list(class_id)

    images = np.asarray(images)
    if len(class_ids) == 1:
        banks = detector._get_banks(class_ids[0])
        cid0 = class_ids[0]
        mapper = (lambda kk: (cid0, kk))
        eff_cand, eff_dist = int(cand_cap), int(distinct_cap)
    else:
        # merged registry: one sharded program scores every class (the
        # same exact-merge as Detector.match_batch; the pyramid is built
        # once instead of once per class)
        banks, class_of_k, tid_of_k = detector._get_merged_banks(
            tuple(class_ids))
        mapper = (lambda kk: (class_ids[int(class_of_k[kk])],
                              int(tid_of_k[kk])))
        eff_cand = min(int(cand_cap) * len(class_ids), 4096)
        if eff_cand < int(cand_cap) * len(class_ids):
            import warnings

            warnings.warn(
                f"merged multi-class cap clamped to {eff_cand} "
                f"(< cand_cap*{len(class_ids)} classes = "
                f"{int(cand_cap) * len(class_ids)}); busy frames may "
                "overflow — the n_above warning below reports it")
        eff_dist = int(distinct_cap) * len(class_ids)
    per = _match_images_sharded_banks(detector, images, threshold, mesh,
                                      banks, mapper, eff_cand, eff_dist,
                                      use_pallas=use_pallas)
    return [_sort_dedup(ms) for ms in per]


def _match_images_sharded_banks(detector, images, threshold: float,
                                mesh: Mesh, banks, mapper,
                                cand_cap: int, distinct_cap: int,
                                use_pallas: bool | None = None):
    from ..models.detector import Match

    assert images.ndim in (3, 4)
    gray = images.ndim == 3
    h, w = images.shape[1:3]
    detector._validate_size((h, w))
    n_data = mesh.devices.shape[0]
    if images.shape[0] % n_data:
        raise ValueError(f"batch {images.shape[0]} not divisible by the "
                         f"mesh data axis ({n_data}); pad the batch")
    n_templ = mesh.devices.shape[1]
    K = int(banks[-1].fx.shape[0])
    banks = [shard_pad_bank(b, n_templ) for b in banks]

    step = multichip_match_step(
        mesh, detector.T_at_level, (h, w), cand_cap=cand_cap,
        distinct_cap=distinct_cap, gray=gray,
        n_ori=detector.num_orientations, use_pallas=use_pallas)
    fields = [f for b in banks for f in b]
    k, x, y, sc, valid, n_above, nd = step(
        jnp.asarray(images), jnp.float32(detector.weak_threshold),
        jnp.float32(threshold), *fields)
    k, x, y, sc, valid = (np.asarray(a) for a in (k, x, y, sc, valid))
    n_above = np.asarray(n_above)
    nd = np.asarray(nd)
    if (n_above > cand_cap).any():
        import warnings

        warnings.warn(f"candidate overflow: max {int(n_above.max())} above "
                      f"threshold, cap {cand_cap}; raise cand_cap for "
                      "full parity")
    if (nd > distinct_cap).any():
        import warnings

        warnings.warn(f"distinct-template overflow: {int(nd.max())} > "
                      f"{distinct_cap}; raise distinct_cap for full parity")

    out = []
    for b in range(images.shape[0]):
        ms = []
        for i in np.nonzero(valid[b] & (k[b] < K))[0]:
            cid, tid = mapper(int(k[b, i]))
            ms.append(Match(int(x[b, i]), int(y[b, i]), float(sc[b, i]),
                            cid, tid))
        out.append(ms)
    return out


def multichip_train_step(mesh: Mesh, size_hw: tuple,
                         pyramid_levels: int = 2,
                         weak_threshold: float = 30.0,
                         strong_lo: float | None = None,
                         gray: bool = True, has_mask: bool = False,
                         n_ori: int = 8, patch_2843: bool = False,
                         cand_cap: int = 4096):
    """The REAL device half of the training sweep over the full mesh:
    the image batch shards across ALL devices (data x templ axes
    flattened — training has no template axis yet), and every shard runs
    the SAME per-frame programs add_templates dispatches locally
    (models/detector.py:_batch_train_level, the device half of
    addTemplate, line2Dup.cpp:452-539): gradient pyramid, quantization,
    ties-allowed 5x5 local max, bit-packed eligible bitmaps, and
    compacted strong-candidate values. Outputs all-gather into
    full-batch arrays bit-identical to the local dispatch, so the host
    greedy selection (Detector._train_consume_chunk) consumes them
    unchanged — that is what makes add_templates_sharded's banks
    bit-exact vs single-device training (asserted by
    tests/test_sharding.py and the driver dryrun).

    Returns a jitted fn(images[, masks]) -> (per-level output tuples...,
    psum'd eligible-count statistic). Frame count must divide by the
    device count (callers pad)."""
    from ..models.detector import _batch_train_level

    if strong_lo is None:
        thr2 = np.float32(60.0 ** 2)
        strong_lo = float(np.nextafter(np.nextafter(
            thr2, np.float32(0)), np.float32(0)))

    def per_shard(images, masks):
        src, msk = images, masks
        zmask = jnp.zeros((1, 1, 1), jnp.uint8)
        outs = []
        n_elig = jnp.int32(0)
        for l in range(pyramid_levels):
            if l > 0:
                src = jax.vmap(pyr_down_u8)(src)
                if has_mask:
                    from ..ops.filters import resize_nearest

                    msk = jax.vmap(partial(
                        resize_nearest,
                        out_hw=(src.shape[1], src.shape[2])))(msk)
            lvl = _batch_train_level(
                src, msk if has_mask else zmask,
                jnp.float32(weak_threshold), jnp.float32(strong_lo),
                gray, has_mask, n_ori, patch_2843, cand_cap)
            n_elig += jnp.sum(lvl[3])
            outs.append(lvl)
        total = jax.lax.psum(n_elig, ("data", "templ"))
        return tuple(outs), total

    batch = P(("data", "templ"))
    n_lvl_outs = 7  # _batch_train_level's per-level tuple arity
    shard = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(batch, batch if has_mask else P()),
        out_specs=(tuple((batch,) * n_lvl_outs
                         for _ in range(pyramid_levels)), P()),
        check_vma=False,
    )
    fn = jax.jit(shard)
    if not has_mask:
        zero = jnp.zeros((), jnp.uint8)
        return lambda images: fn(images, zero)
    return fn


def add_templates_sharded(detector, sources, class_id: str,
                          object_masks=None, mesh: Mesh | None = None,
                          num_features: int = 0, cand_cap: int = 4096,
                          chunk_per_dev: int = 16, sscales=None,
                          orientations=None, tag_field_ids=None,
                          fiducial_src: str = "none") -> list[int]:
    """Mesh-sharded training sweep: add_templates with the device half
    distributed over ALL mesh devices (multichip_train_step) and the
    host-side greedy selection overlapped with in-flight device chunks.

    Bit-exact vs Detector.add_templates / sequential add_template calls:
    the per-frame device programs are identical, each frame is computed
    by exactly one device, and the host consumes the gathered compacted
    outputs through the SAME Detector._train_consume_chunk. Chunks of
    chunk_per_dev * n_devices frames dispatch asynchronously ahead of
    the host loop (dispatch is async; the host only blocks on a chunk's
    np.asarray pull), so device batches for chunk i+1 overlap the
    order-dependent host greedy passes for chunk i — the
    distributed-training analog of SURVEY.md §5.

    Returns one template id per frame (-1 where extraction failed)."""
    sources = np.asarray(sources)
    assert sources.ndim in (3, 4), "expected [B, H, W] or [B, H, W, 3]"
    B = sources.shape[0]
    gray = sources.ndim == 3
    has_mask = object_masks is not None
    masks = np.asarray(object_masks) if has_mask else None
    nfeat = (int(num_features) if num_features > 0
             else detector.num_features)
    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    hw = (sources.shape[1], sources.shape[2])

    thr2 = np.float32(float(detector.strong_threshold) ** 2)
    strong_lo = float(np.nextafter(np.nextafter(
        thr2, np.float32(0)), np.float32(0)))
    step = multichip_train_step(
        mesh, hw, pyramid_levels=detector.pyramid_levels,
        weak_threshold=detector.weak_threshold, strong_lo=strong_lo,
        gray=gray, has_mask=has_mask, n_ori=detector.num_orientations,
        patch_2843=detector.patch_2843, cand_cap=cand_cap)

    def pad_to(arr, n):
        if arr.shape[0] == n:
            return arr
        reps = np.repeat(arr[:1], n - arr.shape[0], axis=0)
        return np.concatenate([arr, reps], axis=0)

    chunk = max(n_dev, chunk_per_dev * n_dev)
    pending = []  # (b0, b1, device outputs) — dispatched ahead, unsynced
    for b0 in range(0, B, chunk):
        b1 = min(b0 + chunk, B)
        bp = -(-(b1 - b0) // n_dev) * n_dev
        src = jnp.asarray(pad_to(sources[b0:b1], bp))
        if has_mask:
            outs, _total = step(src, jnp.asarray(pad_to(masks[b0:b1], bp)))
        else:
            outs, _total = step(src)
        pending.append((b0, b1, outs))

    ids = [-1] * B
    pyramids = detector.class_templates.setdefault(class_id, [])
    meta = (sscales, orientations, tag_field_ids, fiducial_src)
    for b0, b1, outs in pending:
        host_levels = []
        for l, lvl in enumerate(outs):
            h, w = hw[0] >> l, hw[1] >> l
            host_levels.append(
                (tuple(np.asarray(a)[:b1 - b0] for a in lvl), (h, w)))
        detector._train_consume_chunk(
            b0, b1, host_levels, sources, masks, has_mask, gray, nfeat,
            cand_cap, ids, pyramids, meta)
    detector._invalidate_banks(class_id)
    return ids


def _local_refine(images, banks, T_levels, sizes, weak_threshold,
                  threshold, cand_cap, distinct_cap, gray, n_ori,
                  top_c, iters, radius, use_pallas=None):
    """Full detect + ICP-refine flow for a batch of local frames (the
    match_refine_batch production tier as ONE pure function): LINE-2D
    match (_local_match), per-frame fused edge field, device top-k
    candidate selection + batched sim2 point-to-plane refine
    (models/icp.py). Returns per-frame packed refined arrays
    (dtheta, dscale, tx, ty, rmse, inliers, valid, kk, ox, oy, top_sc),
    each [B_loc, top_c]."""
    from ..models.icp import _edge_field_fused_impl, _refine_packed_impl

    k, x, y, sc, valid, n_above, nd = _local_match(
        images, banks, T_levels, sizes, weak_threshold, threshold,
        cand_cap, distinct_cap, gray, n_ori, use_pallas=use_pallas)
    bank0 = banks[0]

    def one(img, kb, xb, yb, scb, vb):
        off, normal, _edge, has, subpix = _edge_field_fused_impl(
            img, weak_threshold, radius)
        res, kk, ox, oy, top_sc = _refine_packed_impl(
            off, normal, has, subpix, bank0.fx, bank0.fy, bank0.valid,
            kb, xb, yb, scb, vb, top_c=top_c, iters=iters, radius=radius)
        return res + (kk, ox, oy, top_sc)

    return jax.vmap(one)(images, k, x, y, sc, valid)


def multichip_refine_step(mesh: Mesh, T_levels: tuple, size_hw: tuple,
                          cand_cap: int = 256, distinct_cap: int = 64,
                          top_c: int = 8, iters: int = 10,
                          radius: int = 8, gray: bool = True,
                          n_ori: int = 8, use_pallas: bool | None = None):
    """The PRODUCTION deployment tier under the mesh: detect + device
    top-k + batched sim2 ICP refine (the match_refine_batch flow,
    reference deployment loop test_jabil.cpp:121-312 / icp2D branches)
    data-parallel over frames across ALL mesh devices. Each frame is
    computed end-to-end by exactly one device with the full bank
    replicated (refinement needs only the frame's own edge field — zero
    cross-frame communication), and the refined pose arrays all-gather. step(images, weak_threshold, threshold, *bank_fields) ->
    11 arrays [B, top_c] (see _local_refine)."""
    levels = len(T_levels)
    h, w = size_hw
    sizes = [(w >> l, h >> l) for l in range(levels)]
    batch = P(("data", "templ"))
    n_fields = 7  # LevelBank arity

    def per_shard(images, weak_threshold, threshold, *fields):
        banks = [LevelBank(*fields[i * n_fields:(i + 1) * n_fields])
                 for i in range(levels)]
        return _local_refine(images, banks, T_levels, sizes,
                             weak_threshold, threshold, cand_cap,
                             distinct_cap, gray, n_ori, top_c, iters,
                             radius, use_pallas)

    shard = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(batch, P(), P()) + (P(),) * (levels * n_fields),
        out_specs=(batch,) * 11,
        check_vma=False,
    )
    return jax.jit(shard)
