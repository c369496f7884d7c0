"""Detector — the public LINE-2D API (mirror of line2Dup.h:257-333).

Device-first design: the template store is packed into padded `LevelBank`
arrays; `match()` builds the response/linear-memory pyramid on device and
scores *all* templates of a class in one batched launch (the reference's
OpenMP-over-templates loop, line2Dup.cpp:1169, becomes a batch dimension).
Candidate refinement batches all surviving candidates across templates.

Score parity: identical integer response accumulation and the identical
float `raw*100/(4*nfeat)` mapping (line2Dup.cpp:1206), verified against
golden outputs generated from the compiled C++ reference (tests/goldens).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gradients import (quantized_orientations_color,
                             quantized_orientations_gray)
from ..ops.filters import pyr_down_u8, resize_nearest
from ..ops.response import build_linear_memories
from ..ops.similarity import (LevelBank, coarse_extract_dispatch,
                              coarse_similarity_dispatch,
                              distinct_templates, extract_candidates_cells,
                              gather_bank, pack_level_bank,
                              refine_candidates, refine_from_maps,
                              use_pallas_default)
from ..utils.dispatch import count as dispatch_count
from ..utils.dispatch import counted_jit
from ..utils.yaml_io import (class_file_path, dump_opencv_yaml,
                             load_opencv_yaml)
from . import training
from .template import Feature, Template, TemplatePyramid, crop_templates


@dataclass
class Match:
    """A detection (line2Dup.h:222-250). (x, y) is the match origin at full
    resolution; similarity in [0, 100]."""

    x: int
    y: int
    similarity: float
    class_id: str
    template_id: int

    def sort_key(self):
        return (-self.similarity, self.template_id)

    def __eq__(self, rhs) -> bool:  # operator== (line2Dup.h:240-243)
        return (self.x == rhs.x and self.y == rhs.y
                and self.similarity == rhs.similarity
                and self.class_id == rhs.class_id)


# Candidate-capacity buckets: smallest one >= the true above-threshold count
# is used, so the common case stays cheap and parity is never lost.
_CAND_BUCKETS = (256, 1024, 4096, 16384, 65536)

# Merged multi-class programs clamp their shared candidate cap to 4096; a
# frame that overflows retries ONE merged program at this cap before the
# per-class escalating fallback (which pays len(class_ids) launches).
_MERGED_ESCALATED_CAP = 16384


@partial(counted_jit, name="pack_match_results")
@jax.jit
def _pack_match_results(groups):
    """Pack per-group match tuples into ONE [n_groups, B, 6, C] i32
    tensor for a single device->host transfer (float scores bitcast,
    overflow broadcast along C). Jitted: one dispatch instead of ~6
    eager ops per group."""
    return jnp.stack([
        jnp.stack([
            k, x, y,
            jax.lax.bitcast_convert_type(sc, jnp.int32),
            valid.astype(jnp.int32),
            jnp.broadcast_to(overflow.astype(jnp.int32)[:, None], k.shape),
        ], axis=1)
        for (k, x, y, sc, valid, overflow) in groups
    ])


def _sort_dedup(matches: list) -> list:
    """sort + dedup (line2Dup.cpp:1143-1145). Deliberate divergence from
    the reference: its operator== ignores template_id, so std::unique
    after an UNSTABLE sort removes a nondeterministic subset of
    same-position detections from *different* templates (verified on
    case2: the reference drops tid 89 but keeps 90/94 at one position,
    purely by libstdc++ partition order). Different templates are
    different angle/scale hypotheses — we keep them all and collapse
    only true duplicates (same template converging from several coarse
    candidates). Result: a deterministic superset of the reference's
    match list; downstream NMS resolves same-position hypotheses."""
    matches.sort(key=lambda m: (-m.similarity, m.template_id, m.x, m.y,
                                m.class_id))
    out = []
    seen = set()
    for m in matches:
        key = (m.x, m.y, m.similarity, m.class_id, m.template_id)
        if key in seen:
            continue
        seen.add(key)
        out.append(m)
    return out


def _lm_pyramid(source, mask, gray: bool, has_mask: bool, T: tuple,
                levels: int, weak_threshold, n_ori: int = 8,
                patch_2843: bool = False):
    """Device pyramid: per level quantize -> spread -> responses -> linear
    memories (match() preamble, line2Dup.cpp:1084-1120). Plain traceable
    function. Returns per level (lm [n_ori, T*T, M], lmflat [L + M]):
    lmflat is lm flattened plus M zero bytes, the row that invalid and
    out-of-image features read."""
    lmflats = []
    src = source
    msk = mask
    for l in range(levels):
        if l > 0:
            src = pyr_down_u8(src)
            if has_mask:
                msk = resize_nearest(msk, (src.shape[0], src.shape[1]))
        if gray:
            grads = quantized_orientations_gray(src, weak_threshold,
                                                n_ori, patch_2843)
        else:
            grads = quantized_orientations_color(src, weak_threshold,
                                                 n_ori, patch_2843)
        quantized = grads.angle
        if has_mask:
            quantized = jnp.where(msk > 0, quantized, 0)
        lm = build_linear_memories(quantized, T[l], n_ori)
        m = lm.shape[-1]
        flat = jnp.concatenate([lm.reshape(-1),
                                jnp.zeros((m,), jnp.uint8)])
        lmflats.append((lm, flat))
    return tuple(lmflats)


_build_lm_pyramid = counted_jit(
    partial(jax.jit,
            static_argnames=("gray", "has_mask", "T", "levels", "n_ori",
                             "patch_2843"))(_lm_pyramid),
    name="lm_pyramid")


@partial(counted_jit, name="batch_pyramid")
@partial(jax.jit, static_argnames=("gray", "has_mask", "T", "levels",
                                   "n_ori", "patch_2843"))
def _batch_pyramid(sources, masks, gray: bool, has_mask: bool, T: tuple,
                   levels: int, weak_threshold, n_ori: int = 8,
                   patch_2843: bool = False):
    """Frame-batched lm pyramid: one program for B frames."""
    fn = lambda s, m: _lm_pyramid(s, m, gray, has_mask, T, levels,
                                  weak_threshold, n_ori, patch_2843)
    return jax.vmap(fn, in_axes=(0, 0 if has_mask else None))(
        sources, masks)


@partial(counted_jit, name="match_batch_class")
@partial(jax.jit, static_argnames=("T", "levels", "use_pallas", "sizes",
                                   "cand_cap", "d_cap", "pathological",
                                   "interpret"))
def _match_batch_class(lms, banks, threshold, T: tuple, levels: int,
                       use_pallas: bool, sizes: tuple, cand_cap: int,
                       d_cap: int, pathological: tuple,
                       interpret: bool = False):
    """Device-complete batched matchClass: coarse scoring -> candidate
    compaction -> pyramid refinement for B frames in ONE program — the
    streaming/batch replacement for the per-frame host-sync escalation
    loops of Detector._match_class (the reference processes frames one at
    a time, test_jabil.cpp:341-360).

    Static caps replace the escalation: `cand_cap` coarse candidates and
    `d_cap` distinct refine templates per frame. Per-frame overflow flags
    are returned; the caller re-runs flagged frames through the exact
    escalating path so parity is never lost.
    """
    K = int(banks[-1].fx.shape[0])
    t_last = T[-1]
    size_last = sizes[-1]

    def per_frame(lm_tuple):
        lm_last, lmflat_last = lm_tuple[-1]
        k, x, y, sc, valid, n_above = coarse_extract_dispatch(
            lm_last, lmflat_last, banks[-1], t_last, size_last,
            threshold, cand_cap, use_pallas, interpret=interpret)
        overflow = n_above > cand_cap
        for l in range(levels - 2, -1, -1):
            lm_l, lmflat_l = lm_tuple[l]
            if pathological[l]:
                k, x, y, sc, valid = refine_candidates(
                    lmflat_l, banks[l], T[l], sizes[l], k, x, y, valid,
                    threshold)
            else:
                slots, slot_of_k, n_distinct = distinct_templates(
                    k, valid, K, d_cap)
                overflow |= n_distinct > d_cap
                sub = gather_bank(banks[l], slots)
                Sfull, _ = coarse_similarity_dispatch(
                    lm_l, lmflat_l, sub, T[l], sizes[l], use_pallas,
                    mask_positions=False, interpret=interpret)
                k, x, y, sc, valid = refine_from_maps(
                    Sfull, slot_of_k, banks[l], T[l], sizes[l],
                    k, x, y, valid, threshold)
        return k, x, y, sc, valid, overflow

    return jax.vmap(per_frame)(lms)


@partial(counted_jit, name="batch_train_level")
@partial(jax.jit, static_argnames=("gray", "has_mask", "n_ori",
                                   "patch_2843", "cap"))
def _batch_train_level(srcs, masks, weak_threshold, strong_sq_lo,
                       gray: bool, has_mask: bool, n_ori: int,
                       patch_2843: bool, cap: int):
    """Device half of a training sweep for ONE pyramid level of a frame
    chunk: gradients -> quantize -> ties-allowed 5x5 local max ->
    mask-eligibility, then TWO compact host-bound products per frame:

    * the full eligible bitmap, bit-packed 8 pixels/byte (np.unpackbits
      'big' order) — the greedy acceptance scan needs every eligible
      pixel's GEOMETRY (any accepted max suppresses later neighbors,
      including zero-magnitude flat-region ties), but only geometry;
    * row-major-compacted indices + magnitude/quantized/theta values at
      STRONG candidate pixels only (eligible & mag above the strong
      threshold & nonzero orientation — the only pixels whose VALUES the
      candidate list can ever need, line2Dup.cpp:518-521). strong_sq_lo
      is an f32 LOWER bound of strong_threshold^2 (the host re-applies
      the exact float comparison), so borderline pixels are kept.

    Returns (packed_elig [h, wpad/8] u8, idx [cap], got [cap], n_strong,
    mag_v, quant_v, theta_v) per frame — tens of KB, never the planes."""
    from ..ops.filters import erode3_u8
    from ..ops.similarity import compact_indices
    from ..models.training import local_max_map

    def one(src, msk):
        if gray:
            grads = quantized_orientations_gray(
                src, weak_threshold, n_ori, patch_2843)
        else:
            grads = quantized_orientations_color(
                src, weak_threshold, n_ori, patch_2843)
        lmax = local_max_map(grads.magnitude)
        if has_mask:
            lmax &= erode3_u8(msk) > 0
        h, w = lmax.shape
        hw = h * w
        wp = -(-w // 8) * 8
        bits = jnp.pad(lmax, ((0, 0), (0, wp - w))).reshape(h, wp // 8, 8)
        weights = (1 << (7 - jnp.arange(8, dtype=jnp.int32)))
        packed = jnp.sum(bits.astype(jnp.int32) * weights,
                         axis=-1).astype(jnp.uint8)
        strong = (lmax & (grads.magnitude > strong_sq_lo)
                  & (grads.angle > 0))
        idx, n = compact_indices(strong.reshape(-1), cap)
        idx_safe = jnp.minimum(idx, hw - 1)
        got = idx < hw
        mag_v = grads.magnitude.reshape(-1)[idx_safe]
        quant_v = grads.angle.reshape(-1)[idx_safe].astype(jnp.int32)
        theta_v = grads.angle_ori.reshape(-1)[idx_safe]
        return packed, idx_safe, got, n, mag_v, quant_v, theta_v

    return jax.vmap(one, in_axes=(0, 0 if has_mask else None))(srcs, masks)


@partial(counted_jit, name="batch_train_counts")
@partial(jax.jit, static_argnames=("gray", "has_mask", "n_ori",
                                   "patch_2843"))
def _batch_train_counts(srcs, masks, weak_threshold, gray: bool,
                        has_mask: bool, n_ori: int, patch_2843: bool):
    """Eligible-pixel count per frame ([B] i32) — the cheap routing
    probe for add_templates: decides compacted-vs-planes per chunk
    before any heavy training program is dispatched."""
    from ..ops.filters import erode3_u8
    from ..models.training import local_max_map

    def one(src, msk):
        if gray:
            grads = quantized_orientations_gray(
                src, weak_threshold, n_ori, patch_2843)
        else:
            grads = quantized_orientations_color(
                src, weak_threshold, n_ori, patch_2843)
        lmax = local_max_map(grads.magnitude)
        if has_mask:
            lmax &= erode3_u8(msk) > 0
        return jnp.sum(lmax, dtype=jnp.int32)

    return jax.vmap(one, in_axes=(0, 0 if has_mask else None))(srcs, masks)


@partial(counted_jit, name="batch_train_planes")
@partial(jax.jit, static_argnames=("gray", "has_mask", "n_ori",
                                   "patch_2843"))
def _batch_train_planes(srcs, masks, weak_threshold, gray: bool,
                        has_mask: bool, n_ori: int, patch_2843: bool):
    """Uncompacted twin of _batch_train_level: full (eligible, magnitude,
    quantized, theta) planes for a frame chunk. The overflow path of
    add_templates — mask-less frames routinely have tens of thousands of
    eligible pixels (flat regions tie in the 5x5 local max), so the
    O(cap) compaction overflows; pulling the planes for the WHOLE chunk
    in one program is exact and costs one transfer, not per-frame
    sequential device round trips."""
    from ..ops.filters import erode3_u8
    from ..models.training import local_max_map

    def one(src, msk):
        if gray:
            grads = quantized_orientations_gray(
                src, weak_threshold, n_ori, patch_2843)
        else:
            grads = quantized_orientations_color(
                src, weak_threshold, n_ori, patch_2843)
        lmax = local_max_map(grads.magnitude)
        if has_mask:
            lmax &= erode3_u8(msk) > 0
        return lmax, grads.magnitude, grads.angle, grads.angle_ori

    return jax.vmap(one, in_axes=(0, 0 if has_mask else None))(srcs, masks)


_instance: "Detector | None" = None


def get_instance(path: str | None = None) -> "Detector":
    """Singleton bootstrap from a settings YAML (line2Dup.cpp:1355-1393).

    Loads `detector_linemod.yaml` (default: ./model_images/) plus every
    class listed under its `classes` key from `templates_dir`.
    """
    global _instance
    if _instance is None:
        if path is None:
            path = os.path.join(os.getcwd(), "model_images",
                                "detector_linemod.yaml")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"LINEMOD configuration file ({path}) not found!")
        det = Detector.load_settings(path)
        doc = load_opencv_yaml(path)
        class_ids = doc.get("classes") or []
        templates_dir = doc.get("templates_dir", "")
        if class_ids:
            det.read_classes(class_ids,
                             os.path.join(templates_dir, "%s.yaml.gz"))
        _instance = det
    return _instance


def reset_instance() -> None:
    global _instance
    _instance = None


class Detector:
    """LINE-2D detector with batched device matching.

    Args mirror Detector(num_features, T, weak_thresh, strong_thresh)
    (line2Dup.h:266). ``T`` is the per-pyramid-level spread/decimation
    factor, finest level first (default (4, 8), line2Dup.cpp:1056-1062).
    """

    def __init__(self, num_features: int = 63, T=(4, 8),
                 weak_threshold: float = 30.0,
                 strong_threshold: float = 60.0,
                 use_pallas: bool | None = None,
                 num_orientations: int = 8,
                 patch_2843: bool = False,
                 pallas_interpret: bool = False):
        self.num_features = int(num_features)
        # None = auto (the Triton scoring kernel on a GPU, XLA elsewhere);
        # results are bit-identical either way. `pallas_interpret` runs
        # the kernel in the Pallas interpreter (CPU tests only).
        self.use_pallas = use_pallas
        self.pallas_interpret = bool(pallas_interpret)
        # 8 = LINE-2D standard; 16 = the 16-orientation experiment
        # (test/ori_16bit_experiment): 32->16 angle buckets, vendored-LUT
        # responses {0, 1, 4} (line2Dup_16bit_ori.cpp:575).
        assert num_orientations in (8, 16)
        self.num_orientations = int(num_orientations)
        # opencv_contrib issue #2843 variant (compile-time-disabled in the
        # reference, line2Dup.cpp:9): weak pixels cast no orientation votes.
        self.patch_2843 = bool(patch_2843)
        self.T_at_level = tuple(int(t) for t in T)
        self.pyramid_levels = len(self.T_at_level)
        self.weak_threshold = float(weak_threshold)
        self.strong_threshold = float(strong_threshold)
        self.class_templates: dict[str, list[TemplatePyramid]] = {}
        self._banks: dict[str, list[LevelBank]] = {}
        self._merged_banks: dict[tuple, tuple] = {}
        # id(bank) -> (max width, max height) on the host (see
        # _is_pathological)
        self._bank_maxdims: dict[int, tuple[int, int]] = {}
        # value -> resident device scalar/array: an eager jnp.float32(...)
        # or jnp.zeros((1, 1)) per match call is one host->device
        # transfer and one dispatch each
        self._dev_consts: dict = {}

    def _f32(self, v):
        """Cached device f32 scalar (one device_put per distinct value).

        Bounded: a caller sweeping thresholds would otherwise grow
        device allocations without limit. Eviction is insertion-order
        (dicts preserve it); 64 distinct values is far beyond any real
        threshold schedule. Cached constants pin to the backend active
        at first use — a Detector must not outlive a mid-process
        jax_platforms switch."""
        key = float(v)
        c = self._dev_consts.get(key)
        if c is None:
            while len(self._dev_consts) >= 64:
                self._dev_consts.pop(next(iter(self._dev_consts)))
            c = self._dev_consts[key] = jnp.float32(key)
        return c

    def _zmask(self):
        """Cached (1, 1) zeros placeholder for mask-less calls."""
        c = self._dev_consts.get("zmask")
        if c is None:
            c = self._dev_consts["zmask"] = jnp.zeros((1, 1), jnp.uint8)
        return c

    # ------------------------------------------------------------------
    # Template management
    # ------------------------------------------------------------------

    def add_template(self, source, class_id: str, object_mask=None,
                     sscale: float = -1.0, orientation: float = -1.0,
                     tag_field_id: int = 0, fiducial_src: str = "none",
                     num_features: int = 0) -> int:
        """Train a template pyramid from an image (line2Dup.cpp:1299-1353).

        Returns the new template_id, or -1 when extraction fails.
        """
        source = np.asarray(source)
        mask = None if object_mask is None else np.asarray(object_mask)
        # One template: the per-level plane path. The batch trainer
        # (add_templates, B=1) is bit-identical but measured slower for a
        # single template on an H100 (38.2 vs 35.6 ms; PERF.md).
        nfeat = int(num_features) if num_features > 0 else self.num_features

        tp: TemplatePyramid = []
        src = source
        msk = mask
        level_nfeat = nfeat
        for l in range(self.pyramid_levels):
            if l > 0:
                src = np.asarray(pyr_down_u8(jnp.asarray(src)))
                if msk is not None:
                    msk = np.asarray(
                        resize_nearest(jnp.asarray(msk),
                                       (src.shape[0], src.shape[1])))
                level_nfeat //= 2  # line2Dup.cpp:427
            grads = self._quantized(src)
            templ = training.extract_template(
                grads, msk, level_nfeat, self.strong_threshold, l)
            if templ is None:
                return -1
            templ.sscale = sscale
            templ.orientation = orientation
            templ.tag_field_id = tag_field_id
            templ.fiducial_src = fiducial_src
            tp.append(templ)

        crop_templates(tp)
        pyramids = self.class_templates.setdefault(class_id, [])
        pyramids.append(tp)
        self._invalidate_banks(class_id)
        return len(pyramids) - 1

    def add_templates(self, sources, class_id: str, object_masks=None,
                      num_features: int = 0, cand_cap: int = 4096,
                      chunk: int = 64, sscales=None, orientations=None,
                      tag_field_ids=None, fiducial_src: str = "none"
                      ) -> list[int]:
        """Pipelined training sweep: train B templates from same-shaped
        frames with the dense device work batched ahead of the host-side
        greedy passes (the distributed-training pattern of SURVEY.md §5).

        Per pyramid level, gradients + quantization + 5x5 local-max +
        eligible-pixel compaction for a CHUNK of frames run as one device
        program; chunks dispatch asynchronously ahead of the host loop,
        so the device computes chunk i+1 while the host replays chunk i's
        order-dependent greedy acceptance/selection (bit-identical to
        sequential add_template calls — same ops per template, and only
        the [B, cand_cap] compacted candidate arrays cross to the host
        instead of B full gradient planes).

        Returns one template id per frame (-1 where extraction failed,
        matching add_template). Frames whose eligible-pixel count
        overflows `cand_cap` (mask-less frames routinely do) re-run
        through a batched full-planes program — still one transfer per
        chunk, never per-frame sequential round trips.
        `sscales`/`orientations`/`tag_field_ids` (optional per-frame
        sequences) and `fiducial_src` carry the fork metadata exactly as
        per-call add_template args would."""
        sources = np.asarray(sources)
        assert sources.ndim in (3, 4), "expected [B, H, W] or [B, H, W, 3]"
        B = sources.shape[0]
        gray = sources.ndim == 3
        has_mask = object_masks is not None
        masks = np.asarray(object_masks) if has_mask else None
        nfeat = int(num_features) if num_features > 0 else self.num_features

        # dispatch every chunk x level ASYNCHRONOUSLY (no host sync):
        # each program hands the host a bit-packed ELIGIBLE bitmap (the
        # acceptance scan needs every eligible pixel's geometry — any
        # accepted max suppresses later neighbors, including the
        # zero-magnitude flat-region ties mask-less frames are full of)
        # plus values compacted at STRONG candidate pixels only — tens
        # of KB per frame, never the gradient planes.
        zmask = jnp.zeros((1, 1, 1), jnp.uint8)
        thr2 = float(self.strong_threshold) ** 2
        # f32 lower bound (2 ulps) of the f64 threshold: the device
        # pre-filter keeps borderline pixels; the host re-applies the
        # exact float comparison (line2Dup.cpp:518 `score > threshold`)
        strong_lo = np.nextafter(
            np.nextafter(np.float32(thr2), np.float32(0)), np.float32(0))
        pending = []  # [(b0, b1, [per-level device outputs])]
        for b0 in range(0, B, chunk):
            b1 = min(b0 + chunk, B)
            src = jnp.asarray(sources[b0:b1])
            msk = jnp.asarray(masks[b0:b1]) if has_mask else None
            levels_out = []
            for l in range(self.pyramid_levels):
                if l > 0:
                    src = jax.vmap(pyr_down_u8)(src)
                    if has_mask:
                        msk = jax.vmap(partial(
                            resize_nearest,
                            out_hw=(src.shape[1], src.shape[2])))(msk)
                levels_out.append(
                    (_batch_train_level(
                        src, msk if has_mask else zmask,
                        jnp.float32(self.weak_threshold),
                        jnp.float32(strong_lo), gray, has_mask,
                        self.num_orientations, self.patch_2843, cand_cap),
                     (src.shape[1], src.shape[2])))
            pending.append((b0, b1, levels_out))

        ids = [-1] * B
        pyramids = self.class_templates.setdefault(class_id, [])
        meta = (sscales, orientations, tag_field_ids, fiducial_src)
        for b0, b1, levels_out in pending:
            # one D2H per chunk x level (device already raced ahead)
            host_levels = [(tuple(np.asarray(a) for a in outs), hw)
                           for outs, hw in levels_out]
            self._train_consume_chunk(
                b0, b1, host_levels, sources, masks, has_mask, gray,
                nfeat, cand_cap, ids, pyramids, meta)
        self._invalidate_banks(class_id)
        return ids

    def _train_consume_chunk(self, b0, b1, host_levels, sources, masks,
                             has_mask, gray, nfeat, cand_cap, ids,
                             pyramids, meta):
        """Host half of a training-sweep chunk: greedy acceptance +
        scattered selection per frame from the device programs'
        compacted products (bit-identical to sequential add_template).
        Shared by add_templates and the mesh-sharded
        parallel.mesh.add_templates_sharded — the device half differs
        (local chunks vs shard_map over a mesh), the consumption must
        not."""
        sscales, orientations, tag_field_ids, fiducial_src = meta

        def meta_of(seq, b, default):
            return float(seq[b]) if seq is not None else default

        # strong-candidate overflow (needs > cand_cap strong pixels
        # per frame — pathological): full-planes program + transfer
        # for ONLY the overflowing frames — the rest of the chunk
        # keeps its already-pulled compacted outputs instead of
        # re-paying the multi-MB plane pulls this path exists to
        # avoid
        ovf = np.zeros(b1 - b0, bool)
        for outs, _ in host_levels:
            ovf |= np.asarray(outs[3]) > cand_cap  # n_strong/frame
        planes_levels = None
        plane_row: dict[int, int] = {}
        if ovf.any():
            zmask = jnp.zeros((1, 1, 1), jnp.uint8)
            idx = np.nonzero(ovf)[0]
            plane_row = {int(b): i for i, b in enumerate(idx)}
            src = jnp.asarray(sources[b0:b1][idx])
            msk = (jnp.asarray(masks[b0:b1][idx]) if has_mask
                   else None)
            planes_levels = []
            for l in range(self.pyramid_levels):
                if l > 0:
                    src = jax.vmap(pyr_down_u8)(src)
                    if has_mask:
                        msk = jax.vmap(partial(
                            resize_nearest,
                            out_hw=(src.shape[1], src.shape[2])))(msk)
                outs = _batch_train_planes(
                    src, msk if has_mask else zmask,
                    jnp.float32(self.weak_threshold), gray, has_mask,
                    self.num_orientations, self.patch_2843)
                planes_levels.append(
                    (tuple(np.asarray(a) for a in outs),
                     (src.shape[1], src.shape[2])))
        for bi in range(b1 - b0):
            b = b0 + bi
            tp: TemplatePyramid = []
            level_nfeat = nfeat
            if ovf[bi]:
                pi = plane_row[bi]
                for l, ((elig, mag, quant, theta),
                        (h, w)) in enumerate(planes_levels):
                    if l > 0:
                        level_nfeat //= 2  # line2Dup.cpp:427
                    ys, xs = np.nonzero(elig[pi])
                    templ = training.extract_template_host(
                        h, w, ys, xs, mag[pi][ys, xs],
                        quant[pi][ys, xs], theta[pi][ys, xs],
                        level_nfeat, self.strong_threshold, l)
                    if templ is None:
                        tp = []
                        break
                    tp.append(templ)
            else:
                for l, ((packed, idx, got, n_str, mag_v, quant_v,
                         theta_v), (h, w)) in enumerate(host_levels):
                    if l > 0:
                        level_nfeat //= 2  # line2Dup.cpp:427
                    elig = np.unpackbits(
                        packed[bi], axis=-1)[:, :w].astype(bool)
                    ys, xs = np.nonzero(elig)
                    flags = training.greedy_accept(h, w, ys, xs)
                    acc = np.zeros((h, w), bool)
                    acc[ys[flags], xs[flags]] = True
                    m = got[bi]
                    si = idx[bi][m]
                    sy = si // w
                    sx = si % w
                    keep = acc[sy, sx]
                    templ = training.template_from_strong(
                        sx[keep], sy[keep], mag_v[bi][m][keep],
                        quant_v[bi][m][keep], theta_v[bi][m][keep],
                        level_nfeat, self.strong_threshold, l)
                    if templ is None:
                        tp = []
                        break
                    tp.append(templ)
            if not tp:
                continue
            for templ in tp:
                templ.sscale = meta_of(sscales, b, -1.0)
                templ.orientation = meta_of(orientations, b, -1.0)
                templ.tag_field_id = (int(tag_field_ids[b])
                                      if tag_field_ids is not None
                                      else 0)
                templ.fiducial_src = fiducial_src
            crop_templates(tp)
            pyramids.append(tp)
            ids[b] = len(pyramids) - 1

    def add_template_rotate(self, class_id: str, zero_id: int, theta: float,
                            center) -> int:
        """Derive a rotated template from template `zero_id` without
        re-extracting features (line2Dup.cpp:1409-1451)."""
        pyramids = self.class_templates[class_id]
        src_tp = pyramids[zero_id]
        tp = training.rotate_template_features(src_tp, float(theta), center,
                                               self.pyramid_levels,
                                               self.num_orientations)
        crop_templates(tp)
        pyramids.append(tp)
        self._invalidate_banks(class_id)
        return len(pyramids) - 1

    def add_templates_rotate(self, class_id: str, zero_id: int, thetas,
                             center) -> list[int]:
        """Batched add_template_rotate: every angle of a dense sweep in
        one vectorized pass — bit-identical templates, ~10x faster bank
        builds at 10k angles (the scalar path pays ~1.3 ms of python
        overhead per rotation). Returns the new template ids in order."""
        pyramids = self.class_templates[class_id]
        src_tp = pyramids[zero_id]
        tps = training.rotate_templates_batch(
            src_tp, [float(t) for t in thetas], center,
            self.pyramid_levels, self.num_orientations)
        ids = []
        for tp in tps:
            pyramids.append(tp)
            ids.append(len(pyramids) - 1)
        self._invalidate_banks(class_id)
        return ids

    def get_templates(self, class_id: str, template_id: int) -> TemplatePyramid:
        return self.class_templates[class_id][template_id]

    def num_templates(self, class_id: str | None = None) -> int:
        if class_id is None:
            return sum(len(v) for v in self.class_templates.values())
        return len(self.class_templates.get(class_id, []))

    def num_classes(self) -> int:
        return len(self.class_templates)

    def class_ids(self) -> list[str]:
        return list(self.class_templates.keys())

    def get_t(self, pyramid_level: int) -> int:
        return self.T_at_level[pyramid_level]

    # ------------------------------------------------------------------
    # Matching
    # ------------------------------------------------------------------

    def match(self, source, threshold: float, class_ids=None, mask=None,
              max_candidates: int | None = None) -> list[Match]:
        """Detect all trained templates in `source` (line2Dup.cpp:1078-1150).

        `source` is a uint8 [H, W] gray or [H, W, 3] color array whose
        dimensions must be divisible by T * 2^(levels-1) (the reference
        asserts the same via computeResponseMaps/linearize).

        Fast path: the whole per-class match is ONE device program (the
        batched path at B=1) — a handful of dispatches instead of the
        per-level host-sync escalation loop, which matters when dispatch
        latency is non-trivial. Frames that overflow the static candidate
        caps re-run through the exact escalating path below, so results
        are identical.
        """
        # keep device-resident frames on device: np.asarray on a jax
        # array is a D2H pull and match_batch would push it right back
        if not isinstance(source, jax.Array):
            source = np.asarray(source)
        if max_candidates is None:
            if mask is not None and not isinstance(mask, jax.Array):
                mask = np.asarray(mask)
            return self.match_batch(source[None], threshold, class_ids,
                                    None if mask is None
                                    else mask[None])[0]
        return self._match_escalating(np.asarray(source), threshold,
                                      class_ids, mask, max_candidates)

    def _match_escalating(self, source, threshold: float, class_ids=None,
                          mask=None,
                          max_candidates: int | None = None) -> list[Match]:
        """Exact escalating match: host loops grow the candidate /
        distinct-template caps until nothing overflows (also the fallback
        for match_batch overflow frames, and the path honoring an explicit
        `max_candidates`)."""
        source = np.asarray(source)
        self._validate_size(source.shape[:2])
        gray = source.ndim == 2
        has_mask = mask is not None
        mask_arr = (jnp.asarray(np.asarray(mask)) if has_mask
                    else self._zmask())

        lmflats = _build_lm_pyramid(
            jnp.asarray(source), mask_arr, gray, has_mask,
            self.T_at_level, self.pyramid_levels,
            self._f32(self.weak_threshold), self.num_orientations,
            self.patch_2843)

        sizes = self._level_sizes(source.shape[:2])

        if class_ids is None or not class_ids:
            class_ids = list(self.class_templates.keys())

        matches: list[Match] = []
        for class_id in class_ids:
            if class_id not in self.class_templates:
                continue
            matches.extend(
                self._match_class(lmflats, sizes, float(threshold), class_id,
                                  max_candidates))

        return _sort_dedup(matches)

    def match_batch(self, sources, threshold: float, class_ids=None,
                    masks=None, cand_cap: int = 256,
                    distinct_cap: int = 64, as_matches: bool = True):
        """Batched streaming match: B same-shaped frames in one device
        program per class, with NO per-frame host syncs (the escalation
        loops of match() are replaced by static caps + per-frame overflow
        flags; overflowing frames — rare — are re-run through the exact
        match() path, so results are identical to [match(f) for f in
        sources]).

        `sources`: uint8 [B, H, W] or [B, H, W, 3] (numpy or a jax array
        already on device — no host round-trip either way); `masks`:
        optional [B, H, W]. Returns a list of B match lists
        (`as_matches=True`; all per-class results come back in ONE packed
        device->host transfer) or a dict of packed per-class DEVICE arrays
        {class_id: (k, x, y, score, valid, overflow)} each [B, cand_cap]
        / [B] (`as_matches=False` — nothing is pulled to the host; for
        throughput pipelines the caller decides when to sync).
        """
        if sources.ndim not in (3, 4):
            raise ValueError("match_batch expects [B, H, W] or [B, H, W, 3]")
        self._validate_size(sources.shape[1:3])
        gray = sources.ndim == 3
        has_mask = masks is not None
        mask_arr = (jnp.asarray(masks) if has_mask
                    else self._zmask())
        sizes = tuple(self._level_sizes(sources.shape[1:3]))

        lms = _batch_pyramid(jnp.asarray(sources), mask_arr, gray, has_mask,
                             self.T_at_level, self.pyramid_levels,
                             self._f32(self.weak_threshold),
                             self.num_orientations, self.patch_2843)

        if class_ids is None or not class_ids:
            class_ids = list(self.class_templates.keys())
        class_ids = [c for c in class_ids if c in self.class_templates]

        B = sources.shape[0]

        # Merged multi-class fast path: matchClass is per-class
        # independent, so the concatenated bank scores in ONE device
        # program per batch — many-class registries (the jabil per-tag
        # case) pay one launch instead of len(class_ids). Results map
        # back through (class_of_k, tid_of_k); packed-dict callers
        # (as_matches=False) keep the per-class layout.
        merged_map = None
        merged_banks = None
        if as_matches and len(class_ids) > 1:
            banks_m, class_of_k, tid_of_k = self._get_merged_banks(
                tuple(class_ids))
            merged_map = (class_of_k, tid_of_k)
            merged_banks = banks_m
            groups = [("\x00merged", banks_m)]
            # caps are shared by every class in the one program; the 4096
            # clamp bounds compile time and memory — an overflowing frame first
            # retries the merged program at _MERGED_ESCALATED_CAP before
            # bouncing to the per-class escalating path.
            eff_cand_cap = min(int(cand_cap) * len(class_ids), 4096)
            eff_distinct_cap = int(distinct_cap) * len(class_ids)
        else:
            groups = [(c, self._get_banks(c)) for c in class_ids]
            eff_cand_cap = int(cand_cap)
            eff_distinct_cap = int(distinct_cap)

        packed = {}
        for group_id, banks in groups:
            packed[group_id] = self._run_batch_group(
                lms, banks, threshold, sizes, eff_cand_cap,
                eff_distinct_cap)

        if not as_matches:
            return packed
        if not packed:  # no trained classes (or class_ids filtered empty)
            return [[] for _ in range(B)]

        # ONE device->host transfer for everything: [n_cls, B, 6, C] i32
        # (float scores bitcast). Per-array pulls would pay the transfer
        # latency 6x per class; the stacking itself is jitted so it is
        # one dispatch, not ~6 eager ops.
        dispatch_count("d2h_pulls")
        host = np.asarray(_pack_match_results(tuple(packed.values())))

        out: list[list[Match]] = []
        group_ids = list(packed.keys())
        for b in range(B):
            frame_matches: list[Match] = []
            for ci, group_id in enumerate(group_ids):
                k, x, y, sc_bits, valid, overflow = host[ci, b]
                sc = sc_bits.view(np.float32)
                if (overflow[0] and merged_map is not None
                        and eff_cand_cap < _MERGED_ESCALATED_CAP):
                    # busy frame under the merged clamp: retry the ONE
                    # merged program at the escalated cap before
                    # forfeiting it for len(class_ids) per-class loops
                    lms_b = jax.tree_util.tree_map(
                        lambda a: a[b:b + 1], lms)
                    rk, rx, ry, rsc, rvalid, rovf = self._run_batch_group(
                        lms_b, merged_banks, threshold, sizes,
                        _MERGED_ESCALATED_CAP, _MERGED_ESCALATED_CAP)
                    if not bool(np.asarray(rovf)[0]):
                        k = np.asarray(rk)[0]
                        x = np.asarray(rx)[0]
                        y = np.asarray(ry)[0]
                        sc = np.asarray(rsc)[0]
                        valid = np.asarray(rvalid)[0]
                        overflow = np.zeros_like(overflow)
                if overflow[0]:
                    # rare: exceed static caps -> exact escalating path
                    # (counted: its cost is a host loop, not the program)
                    dispatch_count("overflow_reruns")
                    ids = class_ids if merged_map else [group_id]
                    frame_matches.extend(
                        self._match_escalating(
                            np.asarray(sources[b]), threshold, ids,
                            np.asarray(masks[b]) if has_mask else None))
                    continue
                for i in np.nonzero(valid)[0]:
                    kk = int(k[i])
                    if merged_map is not None:
                        cid = class_ids[int(merged_map[0][kk])]
                        tid = int(merged_map[1][kk])
                    else:
                        cid, tid = group_id, kk
                    frame_matches.append(
                        Match(int(x[i]), int(y[i]), float(sc[i]),
                              cid, tid))
            out.append(_sort_dedup(frame_matches))
        return out

    def match_icp(self, source, threshold: float, class_ids=None,
                  top_c: int = 32, iters: int = 12, radius: int = 8,
                  cand_cap: int = 256):
        """Detect + subpixel/ICP-refine in ONE device->host sync — the
        deployment-loop API. Returns refine_matches_icp-schema dicts
        sorted by similarity. See models/icp.py:match_icp: one host sync
        per frame instead of the two of match() followed by
        refine_matches_icp()."""
        from .icp import match_icp as _match_icp

        return _match_icp(self, source, threshold, class_ids,
                          top_c=top_c, iters=iters, radius=radius,
                          cand_cap=cand_cap)

    def match_icp_async(self, source, threshold: float, class_ids=None,
                        top_c: int = 32, iters: int = 12, radius: int = 8,
                        cand_cap: int = 256):
        """Non-blocking match_icp: returns a MatchIcpHandle whose
        .result() does the one sync — lets a streaming loop overlap
        frame N's device compute with frame N-1's pull. See
        models/icp.py:match_icp_async for the pipelined-loop shape."""
        from .icp import match_icp_async as _match_icp_async

        return _match_icp_async(self, source, threshold, class_ids,
                                top_c=top_c, iters=iters, radius=radius,
                                cand_cap=cand_cap)

    def _kernel_args(self):
        """(use_pallas, interpret) resolved for this detector."""
        use_pallas = (self.use_pallas if self.use_pallas is not None
                      else use_pallas_default())
        return use_pallas, getattr(self, "pallas_interpret", False)

    def _run_batch_group(self, lms, banks, threshold, sizes,
                         cand_cap: int, distinct_cap: int):
        """One _match_batch_class launch for a bank group: derives the
        per-level pathological flags from the banks."""
        K = int(banks[-1].fx.shape[0])
        pathological = tuple(
            self._is_pathological(banks[l], sizes[l], self.T_at_level[l])
            for l in range(self.pyramid_levels - 1)
        )
        use_pallas, interpret = self._kernel_args()
        return _match_batch_class(
            lms, tuple(banks), self._f32(threshold),
            self.T_at_level, self.pyramid_levels, use_pallas, sizes,
            cand_cap, min(distinct_cap, K), pathological, interpret)

    def coarse_route(self) -> str:
        """Which coarse scorer a match engages — 'kernel' (Triton) or
        'xla' (ops/similarity.py:coarse_route). Host-only probe; bench.py
        tags recorded numbers with it."""
        from ..ops.similarity import coarse_route as _route

        return _route(self._kernel_args()[0])

    def _is_pathological(self, bank, size_wh, T) -> bool:
        """Whether any template is wider than image - 16T. Uses the
        host-side max dims cached at bank build — a per-call
        np.asarray(bank.width) would be a blocking D2H sync in the
        match_batch preamble (serializes the dispatch pipeline)."""
        w_img, h_img = size_wh
        border = 16 * T
        dims = self._bank_maxdims.get(id(bank))
        if dims is None:
            # bank from outside _get_banks/_get_merged_banks (deep copy,
            # unpickle, caller-built sub-bank): compute once and cache —
            # a one-time D2H sync beats a KeyError mid-match.
            dims = (int(np.asarray(bank.width).max()),
                    int(np.asarray(bank.height).max()))
            self._bank_maxdims[id(bank)] = dims
        wmax, hmax = dims
        return (w_img - wmax) < border or (h_img - hmax) < border

    def _match_class(self, lmflats, sizes, threshold, class_id,
                     max_candidates) -> list[Match]:
        banks = self._get_banks(class_id)
        t_last = self.T_at_level[-1]
        size_last = sizes[-1]
        w_last = size_last[0] // t_last

        lm_last, lmflat_last = lmflats[-1]
        bank_last = banks[-1]
        K = int(bank_last.fx.shape[0])

        # Coarse scoring ONCE; extraction re-runs over escalating caps on
        # the resident scores.
        use_pallas, interpret = self._kernel_args()
        S, positions = coarse_similarity_dispatch(
            lm_last, lmflat_last, bank_last, t_last, size_last, use_pallas,
            mask_positions=False, interpret=interpret)
        M = int(S.shape[1])
        thr = self._f32(threshold)
        extract = lambda cap: extract_candidates_cells(
            S, positions, bank_last.nfeat, thr, t_last, w_last, cap, M)
        total = K * M

        buckets = [c for c in _CAND_BUCKETS if c <= total] or [total]
        if max_candidates is not None:
            buckets = [min(c, int(max_candidates)) for c in buckets]
        k = x = y = sc = valid = None
        for cap in buckets:
            k, x, y, sc, valid, n_above = extract(cap)
            n_above = int(n_above)
            if n_above <= cap or cap == buckets[-1]:
                if n_above > cap:
                    import warnings
                    warnings.warn(
                        f"candidate overflow: {n_above} above threshold, "
                        f"cap {cap}; raise max_candidates for full parity")
                break
        for l in range(self.pyramid_levels - 2, -1, -1):
            k, x, y, sc, valid = self._refine_level(
                lmflats[l], banks[l], self.T_at_level[l], sizes[l],
                k, x, y, valid, threshold)

        k = np.asarray(k)
        x = np.asarray(x)
        y = np.asarray(y)
        sc = np.asarray(sc)
        valid = np.asarray(valid)
        return [
            Match(int(x[i]), int(y[i]), float(sc[i]), class_id, int(k[i]))
            for i in np.nonzero(valid)[0]
        ]

    def _refine_level(self, lmflat_pair, bank, T, size_wh, k, x, y, valid,
                      threshold):
        """One refinement level: full fine maps for the distinct candidate
        templates + windowed argmax — exact under the border-clamp
        invariant. Pathological banks (templates wider than image - 16T,
        where the C++ starts dropping features) take the per-candidate
        gather, refine_candidates."""
        lm, lmflat = lmflat_pair
        if self._is_pathological(bank, size_wh, T):
            return refine_candidates(lmflat, bank, T, size_wh, k, x, y,
                                     valid, jnp.float32(threshold))

        K = int(bank.fx.shape[0])
        d_buckets = [d for d in (16, 64, 256, 1024) if d < K] + [K]
        for D in d_buckets:
            slots, slot_of_k, n_distinct = distinct_templates(k, valid, K, D)
            if int(n_distinct) <= D or D == d_buckets[-1]:
                break
        sub = gather_bank(bank, slots)
        use_pallas, interpret = self._kernel_args()
        Sfull, _ = coarse_similarity_dispatch(
            lm, lmflat, sub, T, size_wh, use_pallas, mask_positions=False,
            interpret=interpret)
        return refine_from_maps(Sfull, slot_of_k, bank, T, size_wh,
                                k, x, y, valid, jnp.float32(threshold))

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    def _quantized(self, src: np.ndarray):
        if src.ndim == 2:
            return quantized_orientations_gray(
                jnp.asarray(src), jnp.float32(self.weak_threshold),
                self.num_orientations, self.patch_2843)
        return quantized_orientations_color(
            jnp.asarray(src), jnp.float32(self.weak_threshold),
            self.num_orientations, self.patch_2843)

    def _level_sizes(self, hw) -> list[tuple]:
        h, w = int(hw[0]), int(hw[1])
        sizes = []
        for l in range(self.pyramid_levels):
            sizes.append((w, h))  # (width, height) like cv::Size
            h //= 2
            w //= 2
        return sizes

    def _validate_size(self, hw) -> None:
        h, w = int(hw[0]), int(hw[1])
        for l, t in enumerate(self.T_at_level):
            if h % t or w % t or (h * w) % 16:
                stride = self.T_at_level[-1] * (2 ** (self.pyramid_levels - 1))
                raise ValueError(
                    f"image {w}x{h} not tileable at level {l} (T={t}); "
                    f"crop/pad dims to multiples of {stride} "
                    f"(reference asserts the same: line2Dup.cpp:639,751)")
            h //= 2
            w //= 2

    def _drop_bank_caches(self, bank) -> None:
        self._bank_maxdims.pop(id(bank), None)

    def _invalidate_banks(self, class_id: str) -> None:
        for b in self._banks.pop(class_id, None) or []:
            self._drop_bank_caches(b)
        for key in [k for k in self._merged_banks if class_id in k]:
            for b in self._merged_banks.pop(key)[0]:
                self._drop_bank_caches(b)
        # per-template ICP point arrays (models/icp.py) follow the banks
        icp_pts = getattr(self, "_icp_pts", None)
        if icp_pts:
            for key in [k for k in icp_pts if k[0] == class_id]:
                del icp_pts[key]

    def _get_merged_banks(self, class_ids: tuple):
        """One LevelBank spanning several classes. matchClass is
        per-class independent (line2Dup.cpp:1129-1141), so scoring the
        concatenated bank in ONE device launch is exact; the global
        template index k maps back through (class_of_k, tid_of_k).
        Feature slots pad to the widest class's N (exactness is per
        template; padding slots are dead).

        The cache key is the SORTED id tuple (callers alternating subset
        orderings would otherwise accumulate duplicate device-resident
        merged banks); class_of_k is remapped to the caller's order."""
        order = tuple(sorted(class_ids))
        cached = self._merged_banks.get(order)
        if cached is not None:
            return self._remap_merged(cached, order, class_ids)
        per_class = [self._get_banks(c) for c in order]
        banks = []
        for l in range(self.pyramid_levels):
            parts = [pc[l] for pc in per_class]
            N = max(int(p.fx.shape[1]) for p in parts)

            def pad_n(a):
                return jnp.pad(a, ((0, 0), (0, N - a.shape[1])))

            bank = LevelBank(
                fx=jnp.concatenate([pad_n(p.fx) for p in parts]),
                fy=jnp.concatenate([pad_n(p.fy) for p in parts]),
                label=jnp.concatenate([pad_n(p.label) for p in parts]),
                valid=jnp.concatenate([pad_n(p.valid) for p in parts]),
                nfeat=jnp.concatenate([p.nfeat for p in parts]),
                width=jnp.concatenate([p.width for p in parts]),
                height=jnp.concatenate([p.height for p in parts]),
            )
            self._bank_maxdims[id(bank)] = (
                max(self._bank_maxdims[id(p)][0] for p in parts),
                max(self._bank_maxdims[id(p)][1] for p in parts))
            banks.append(bank)
        ks = [int(pc[0].fx.shape[0]) for pc in per_class]
        class_of_k = np.repeat(np.arange(len(order)), ks)
        tid_of_k = np.concatenate(
            [np.arange(kk, dtype=np.int64) for kk in ks])
        cached = (banks, class_of_k, tid_of_k)
        # bound the cache (device memory): callers alternating many class
        # SUBSETS would otherwise accumulate merged banks indefinitely
        while len(self._merged_banks) >= 8:
            old = next(iter(self._merged_banks))
            for b in self._merged_banks.pop(old)[0]:
                self._drop_bank_caches(b)
        self._merged_banks[order] = cached
        return self._remap_merged(cached, order, class_ids)

    @staticmethod
    def _remap_merged(cached, order: tuple, class_ids: tuple):
        """class_of_k indices from cache (sorted) order -> caller order."""
        banks, class_of_k, tid_of_k = cached
        if order == class_ids:
            return banks, class_of_k, tid_of_k
        remap = np.array([class_ids.index(c) for c in order])
        return banks, remap[class_of_k], tid_of_k

    def _get_banks(self, class_id: str) -> list[LevelBank]:
        banks = self._banks.get(class_id)
        if banks is None:
            pyramids = self.class_templates[class_id]
            banks = []
            for l in range(self.pyramid_levels):
                level_templates = [
                    {
                        "features": [(f.x, f.y, f.label) for f in tp[l].features],
                        "width": tp[l].width,
                        "height": tp[l].height,
                    }
                    for tp in pyramids
                ]
                bank = pack_level_bank(level_templates)
                self._bank_maxdims[id(bank)] = (
                    max((t["width"] for t in level_templates), default=1),
                    max((t["height"] for t in level_templates), default=1))
                banks.append(bank)
            self._banks[class_id] = banks
        return banks

    # ------------------------------------------------------------------
    # Persistence (line2Dup.cpp:1489-1599)
    # ------------------------------------------------------------------

    def write_settings(self) -> dict:
        doc = {
            "pyramid_levels": self.pyramid_levels,
            "T": list(self.T_at_level),
            "type": "ColorGradient",
            "weak_threshold": float(self.weak_threshold),
            "num_features": int(self.num_features),
            "strong_threshold": float(self.strong_threshold),
        }
        if self.num_orientations != 8:
            doc["num_orientations"] = self.num_orientations
        return doc

    def read_settings(self, doc: dict) -> None:
        self.pyramid_levels = int(doc["pyramid_levels"])
        self.T_at_level = tuple(int(t) for t in doc["T"])
        self.weak_threshold = float(doc.get("weak_threshold", 30.0))
        self.num_features = int(doc.get("num_features", 63))
        self.strong_threshold = float(doc.get("strong_threshold", 60.0))
        self.num_orientations = int(doc.get("num_orientations", 8))
        self.class_templates.clear()
        self._banks.clear()
        self._merged_banks.clear()
        self._bank_maxdims.clear()

    def save_settings(self, path: str, templates_dir: str | None = None,
                      classes=None) -> None:
        """Write detector settings; with `templates_dir`/`classes` the file
        matches the jabil driver's full schema (test_jabil.cpp:113-117) and
        bootstraps get_instance()."""
        doc = self.write_settings()
        if templates_dir is not None:
            doc["templates_dir"] = templates_dir
        if classes is not None:
            doc["classes"] = list(classes)
        elif templates_dir is not None:
            doc["classes"] = self.class_ids()
        dump_opencv_yaml(doc, path)

    @classmethod
    def load_settings(cls, path: str) -> "Detector":
        doc = load_opencv_yaml(path)
        det = cls()
        det.read_settings(doc)
        return det

    def write_class(self, class_id: str) -> dict:
        pyramids = self.class_templates[class_id]
        return {
            "class_id": class_id,
            "pyramid_levels": self.pyramid_levels,
            "template_pyramids": [
                {
                    "template_id": i,
                    "templates": [t.to_yaml() for t in tp],
                }
                for i, tp in enumerate(pyramids)
            ],
        }

    def read_class(self, doc: dict, class_id_override: str = "") -> str:
        class_id = class_id_override or doc["class_id"]
        pyramids = []
        for tp_node in doc.get("template_pyramids", []):
            tp = [Template.from_yaml(t) for t in tp_node.get("templates", [])]
            pyramids.append(tp)
        self.class_templates[class_id] = pyramids
        self._invalidate_banks(class_id)
        return class_id

    def write_classes(self, fmt: str = "templates_%s.yml.gz") -> None:
        for class_id in self.class_templates:
            path = class_file_path(fmt, class_id)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            dump_opencv_yaml(self.write_class(class_id), path)

    def read_classes(self, class_ids, fmt: str = "templates_%s.yml.gz") -> None:
        for class_id in class_ids:
            doc = load_opencv_yaml(class_file_path(fmt, class_id))
            self.read_class(doc)
