"""Batched template similarity — the device replacement for the OpenMP loop.

The reference scores templates one at a time with SIMD adds inside an OpenMP
``parallel for`` (line2Dup.cpp:1160-1297). Here the whole template bank is a
padded array pytree and every template scores in one device launch:

* coarse level: ``S[k, j] = sum_n LMflat[off[k, n] + j]`` for all K templates
  and all M decimated positions at once — a scan over the (padded) feature
  axis of batched contiguous-slice gathers. ``off`` encodes the reference's
  linear-memory addressing ((label, y%T, x%T) plane + (y//T)*W + x//T), and
  the *flat* offset semantics — including the wrap across image rows that the
  reference deliberately allows (line2Dup.cpp:946-949) — are preserved.
* refinement: all surviving candidates of all templates refine as one batched
  16×16-patch gather (line2Dup.cpp:860-922 semantics, incl. the multiple-of-T
  snapping and the clamp order of line2Dup.cpp:1236-1245).

Scores stay integer until the final ``raw * 100 / (4 * nfeat)`` float
(line2Dup.cpp:1206), so results match the C++ u8/u16 accumulators exactly
(responses are in {0,3,4}; no overflow differences in i32).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .fastmath import exact_ratio_f32


class LevelBank(NamedTuple):
    """Padded per-pyramid-level template bank (device pytree).

    Replaces the reference's ``map<class_id, vector<TemplatePyramid>>``
    (line2Dup.h:320) with fixed-shape arrays: K templates × N feature slots.
    """

    fx: jnp.ndarray      # [K, N] int32 feature x (template frame)
    fy: jnp.ndarray      # [K, N] int32 feature y
    label: jnp.ndarray   # [K, N] int32 orientation bin 0..7
    valid: jnp.ndarray   # [K, N] bool
    nfeat: jnp.ndarray   # [K] int32 true feature count
    width: jnp.ndarray   # [K] int32 cropped template width at this level
    height: jnp.ndarray  # [K] int32


def pack_level_bank(templates, n_pad: int | None = None) -> LevelBank:
    """Pack a list of per-template dicts (one pyramid level) into arrays.

    Each dict: {'features': [(x, y, label), ...], 'width': int, 'height': int}.
    """
    K = len(templates)
    N = max((len(t["features"]) for t in templates), default=1)
    N = max(N, 1)
    if n_pad is not None:
        N = max(N, n_pad)
    fx = np.zeros((K, N), np.int32)
    fy = np.zeros((K, N), np.int32)
    lb = np.zeros((K, N), np.int32)
    va = np.zeros((K, N), bool)
    nf = np.zeros((K,), np.int32)
    w = np.zeros((K,), np.int32)
    h = np.zeros((K,), np.int32)
    for k, t in enumerate(templates):
        feats = t["features"]
        nf[k] = len(feats)
        w[k] = t["width"]
        h[k] = t["height"]
        for n, f in enumerate(feats):
            fx[k, n], fy[k, n], lb[k, n] = f[0], f[1], f[2]
            va[k, n] = True
    return LevelBank(*(jnp.asarray(a) for a in (fx, fy, lb, va, nf, w, h)))


def _flat_offsets(bank: LevelBank, T: int, W: int, M: int,
                  size_wh, n_ori: int = 8) -> jnp.ndarray:
    """Flat linear-memory offset per feature; invalid/OOB -> zero region (=L).

    off = (label*T*T + (y%T)*T + x%T) * M + (y//T)*W + x//T
    (accessLinearMemory, line2Dup.cpp:782-805).
    """
    w_img, h_img = size_wh
    L = n_ori * T * T * M
    inb = (
        bank.valid
        & (bank.fx >= 0) & (bank.fx < w_img)
        & (bank.fy >= 0) & (bank.fy < h_img)
    )
    plane = bank.label * (T * T) + (bank.fy % T) * T + (bank.fx % T)
    off = plane * M + (bank.fy // T) * W + (bank.fx // T)
    return jnp.where(inb, off, L).astype(jnp.int32)



def use_pallas_default() -> bool:
    """The Triton-route scoring kernel runs when the first device is a
    GPU; on any other backend (the CPU of the tests) the XLA scan runs."""
    return jax.devices()[0].platform == "gpu"


def _positions(bank: LevelBank, T: int, W: int, H: int) -> jnp.ndarray:
    """Valid start positions per template, span_y * W + span_x + 1
    (line2Dup.cpp:816-825); <= 0 for templates larger than the level."""
    wf = (bank.width - 1) // T + 1
    hf = (bank.height - 1) // T + 1
    return (H - hf) * W + (W - wf) + 1


def coarse_similarity_dispatch(lm: jnp.ndarray, lmflat: jnp.ndarray,
                               bank: LevelBank, T: int, size_wh,
                               use_pallas: bool | None = None,
                               mask_positions: bool = True,
                               interpret: bool = False):
    """[K, M] int32 scores from the Triton kernel or the XLA scan
    (identical results).

    `lm` is the [n_ori, T*T, M] stack, `lmflat` its flat+zero-padded form.
    `mask_positions=False` returns raw (unmasked) maps for refinement use.
    `interpret` runs the kernel in the Pallas interpreter (tests only).
    """
    if use_pallas is None:
        use_pallas = use_pallas_default()
    n_ori = int(lm.shape[0])
    if use_pallas:
        return coarse_similarity_kernel(lmflat, bank, T, size_wh,
                                        mask_positions=mask_positions,
                                        n_ori=n_ori, interpret=interpret)
    return coarse_similarity(lmflat, bank, T, size_wh,
                             mask_positions=mask_positions, n_ori=n_ori)


@partial(jax.jit, static_argnames=("T", "size_wh", "mask_positions",
                                   "n_ori", "interpret"))
def coarse_similarity_kernel(lmflat: jnp.ndarray, bank: LevelBank, T: int,
                             size_wh, mask_positions: bool = True,
                             n_ori: int = 8, interpret: bool = False):
    """coarse_similarity through the Triton kernel
    (ops/pallas/similarity_triton.py): same arguments, same results."""
    from .pallas.similarity_triton import coarse_scores_triton

    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    off = _flat_offsets(bank, T, W, M, size_wh, n_ori)
    positions = _positions(bank, T, W, H)
    S = coarse_scores_triton(off, positions, lmflat, M,
                             mask_positions=mask_positions,
                             interpret=interpret)
    return S, positions


@partial(jax.jit,
         static_argnames=("T", "size_wh", "mask_positions", "n_ori"))
def coarse_similarity(lmflat: jnp.ndarray, bank: LevelBank, T: int,
                      size_wh,
                      mask_positions: bool = True,
                      n_ori: int = 8) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Score all K templates over all M positions of the coarsest level.

    lmflat: [8*T*T*M + M] uint8 (linear memories + M-byte zero pad).
    Returns (S [K, M] int32 raw scores masked to valid positions,
             positions [K] int32).
    """
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    off = _flat_offsets(bank, T, W, M, size_wh, n_ori)  # [K, N]

    def body(acc, off_n):  # off_n: [K]
        seg = jax.vmap(
            lambda o: jax.lax.dynamic_slice(lmflat, (o,), (M,))
        )(off_n)
        return acc + seg.astype(jnp.int32), None

    K = off.shape[0]
    acc0 = jnp.zeros((K, M), jnp.int32)
    S, _ = jax.lax.scan(body, acc0, off.T)

    positions = _positions(bank, T, W, H)
    if mask_positions:
        j = jnp.arange(M, dtype=jnp.int32)[None, :]
        S = jnp.where(j < positions[:, None], S, 0)
    return S, positions


def compact_indices(flags: jnp.ndarray, C: int):
    """Order-preserving compaction: indices of the first C set flags.

    Scatter-free form of ``jnp.nonzero(size=C)``: block counts + cumsum,
    then each output slot finds its block by *searchsorted* over the block
    prefix sums (a [C, NB] masked reduction), then its lane within the
    block the same way. Exact same result/order as nonzero.

    Returns (idx [C] int32 with fill=len(flags), n_total int32).
    """
    flat = flags.reshape(-1)
    total = flat.shape[0]
    nb = -(-total // 128)
    pad = nb * 128 - total
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
    blocks = flat.reshape(nb, 128).astype(jnp.int32)
    cnt = jnp.sum(blocks, axis=1, dtype=jnp.int32)           # [NB]
    incl = jnp.cumsum(cnt)                                    # inclusive
    n_total = incl[-1]
    slots = jnp.arange(C, dtype=jnp.int32)
    # block b serves slot i iff excl[b] <= i < incl[b]; searchsorted form:
    blk_of = jnp.sum(incl[None, :] <= slots[:, None], axis=1,
                     dtype=jnp.int32)                         # [C]
    got = blk_of < nb
    blk_safe = jnp.minimum(blk_of, nb - 1)
    excl = incl - cnt
    j = slots - excl[blk_safe]                                # rank in block
    rows = blocks[blk_safe]                                   # [C, 128]
    lane_incl = jnp.cumsum(rows, axis=1)                      # [C, 128]
    lane = jnp.sum(lane_incl <= j[:, None], axis=1, dtype=jnp.int32)
    idx = jnp.where(got, blk_safe * 128 + lane, total)
    return idx, n_total


def _rmin_for_threshold(nfeat: jnp.ndarray, threshold):
    """Smallest integer raw score clearing `f32(S*100)/f32(4*nfeat) >
    threshold` per template [K].

    Exact integer reformulation of the reference's float threshold test:
    the f32 score is monotone in the integer raw S, so per template there
    is a smallest raw rmin that clears the threshold; find it by probing
    the f32 formula around the real-arithmetic boundary (+-2 is far beyond
    the f32 rounding error of quantities < 2^25). Score maps then need
    only an integer compare — no f32 conversion/division per cell."""
    t4n = (4 * nfeat).astype(jnp.float32)
    approx = threshold * t4n / jnp.float32(100.0)
    base = jnp.floor(approx).astype(jnp.int32) - 1
    probes = jnp.maximum(base[:, None]
                         + jnp.arange(4, dtype=jnp.int32)[None, :], 0)
    ok = exact_ratio_f32(probes * 100, 4 * nfeat[:, None]) > threshold
    big = jnp.int32(1 << 30)
    return jnp.min(jnp.where(ok, probes, big), axis=1)


@partial(jax.jit, static_argnames=("T", "W", "C", "M"))
def extract_candidates_cells(cells: jnp.ndarray, positions: jnp.ndarray,
                             nfeat: jnp.ndarray, threshold,
                             T: int, W: int, C: int, M: int):
    """extract_candidates on UNMASKED [K, Mp >= M] score cells.

    Exactly the semantics of masking + extract_candidates on the i32
    map — (template, row-major position) candidate order, the integer
    rmin compare, and the negative-threshold quirk (cells past
    `positions` count as score 0, so they pass iff rmin <= 0, matching
    the reference's zero-initialized similarity Mat scan,
    line2Dup.cpp:1190-1204) — but in ONE fused pass over the cells plus
    O(C) gathers:

    * block counts: the >=rmin compare fuses into a 128-cell block sum
      (never materializing the bool map),
    * candidate slots find their block by TWO-level searchsorted over
      block-count prefix sums (a [C, NB] masked reduction is O(C*K*M/128)
      — 670M ops at K=10k — so blocks group into 128-block superblocks
      first: O(C*NB/128 + C*256)),
    * each slot re-derives its lane from a [C, 128]-cell block gather.
    """
    rmin = _rmin_for_threshold(nfeat, threshold)
    cell_max = jnp.int32(jnp.iinfo(cells.dtype).max)
    passable = rmin <= cell_max                      # [K]
    quirk = rmin <= 0                                # [K]
    K, Mp = cells.shape
    rmin_c = jnp.minimum(rmin, cell_max).astype(cells.dtype)

    j = jnp.arange(Mp, dtype=jnp.int32)[None, :]
    live = j < positions[:, None]
    above = (live & passable[:, None] & (cells >= rmin_c[:, None])) | (
        quirk[:, None] & ~live & (j < M))

    flat = above.reshape(-1)                         # [K * Mp] bool
    total = K * Mp
    nb = -(-total // 128)
    pad = nb * 128 - total
    if pad:  # Mp is 128-aligned in practice; keep the general case exact
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
    cnt = jnp.sum(flat.reshape(nb, 128), axis=1, dtype=jnp.int32)  # [NB]
    incl = jnp.cumsum(cnt)
    n_above = incl[-1]

    # two-level searchsorted: superblocks of 128 blocks
    ns = -(-nb // 128)
    cnt_p = jnp.concatenate(
        [cnt, jnp.zeros((ns * 128 - nb,), jnp.int32)]) if ns * 128 != nb \
        else cnt
    sup = jnp.sum(cnt_p.reshape(ns, 128), axis=1, dtype=jnp.int32)
    sup_incl = jnp.cumsum(sup)
    slots = jnp.arange(C, dtype=jnp.int32)
    sb = jnp.sum(sup_incl[None, :] <= slots[:, None], axis=1,
                 dtype=jnp.int32)                    # [C]
    got = sb < ns
    sb_safe = jnp.minimum(sb, ns - 1)
    sup_excl = sup_incl - sup
    r1 = slots - sup_excl[sb_safe]                   # rank inside superblock
    blk_rows = cnt_p.reshape(ns, 128)[sb_safe]       # [C, 128]
    blk_incl = jnp.cumsum(blk_rows, axis=1)
    bi = jnp.sum(blk_incl <= r1[:, None], axis=1, dtype=jnp.int32)
    blk = sb_safe * 128 + jnp.minimum(bi, 127)       # global block id
    got &= blk < nb
    blk_safe = jnp.minimum(blk, nb - 1)
    blk_excl = blk_incl - blk_rows
    r2 = r1 - blk_excl[jnp.arange(C), jnp.minimum(bi, 127)]  # rank in block

    # re-derive each candidate block's 128 flags from the cells
    # (O(C*128) gathers)
    lane128 = jnp.arange(128, dtype=jnp.int32)[None, :]
    gidx = blk_safe[:, None] * 128 + lane128         # [C, 128] flat index
    gidx_c = jnp.minimum(gidx, total - 1)
    gk = gidx_c // Mp
    gj = gidx_c % Mp
    gcell = cells[gk, gj].astype(jnp.int32)
    glive = gj < positions[gk]
    gabove = ((glive & passable[gk]
               & (gcell >= rmin[gk]))
              | (quirk[gk] & ~glive & (gj < M))) & (gidx < total)
    lane_incl = jnp.cumsum(gabove.astype(jnp.int32), axis=1)
    lane = jnp.sum(lane_incl <= r2[:, None], axis=1, dtype=jnp.int32)
    idx = jnp.where(got, blk_safe * 128 + jnp.minimum(lane, 127), total)

    got &= idx < total
    idx_safe = jnp.minimum(idx, total - 1)
    k = (idx_safe // Mp).astype(jnp.int32)
    jj = (idx_safe % Mp).astype(jnp.int32)
    raw = jnp.where(jj < positions[k], cells[k, jj].astype(jnp.int32), 0)
    sc = exact_ratio_f32(raw * 100, 4 * nfeat[k])
    offset = T // 2 + (T % 2 - 1)
    x = (jj % W) * T + offset
    y = (jj // W) * T + offset
    return k, x, y, sc, got, n_above


def coarse_route(use_pallas: bool | None = None) -> str:
    """Which coarse scorer a match runs: 'kernel' (Triton) or 'xla'."""
    if use_pallas is None:
        use_pallas = use_pallas_default()
    return "kernel" if use_pallas else "xla"


def coarse_extract_dispatch(lm, lmflat, bank: LevelBank, T: int, size_wh,
                            threshold, cand_cap: int, use_pallas=None,
                            interpret: bool = False):
    """Coarse scoring (unmasked) + candidate extraction in one call.
    Returns (k, x, y, sc, valid, n_above)."""
    S, positions = coarse_similarity_dispatch(
        lm, lmflat, bank, T, size_wh, use_pallas, mask_positions=False,
        interpret=interpret)
    return extract_candidates_cells(S, positions, bank.nfeat, threshold,
                                    T, size_wh[0] // T, cand_cap,
                                    int(S.shape[1]))

@partial(jax.jit, static_argnames=("T", "W", "C"))
def extract_candidates(S: jnp.ndarray, nfeat: jnp.ndarray, threshold,
                       T: int, W: int, C: int):
    """Threshold + candidate compaction (line2Dup.cpp:1200-1216).

    Candidates keep the reference's (template, row-major position) order via
    scatter-free nonzero compaction (compact_indices).
    Returns (k, x, y, score, valid, n_above) arrays of length C; n_above is
    the true count of positions above threshold (host checks overflow and
    escalates C on overflow so no candidate is ever silently dropped).
    """
    K, M = S.shape
    rmin = _rmin_for_threshold(nfeat, threshold)
    above = S >= rmin[:, None]
    idx, n_above = compact_indices(above, C)
    got = idx < K * M
    idx_safe = jnp.minimum(idx, K * M - 1)
    k = (idx_safe // M).astype(jnp.int32)
    sc = exact_ratio_f32(S.reshape(-1)[idx_safe] * 100, 4 * nfeat[k])
    j = idx_safe % M
    offset = T // 2 + (T % 2 - 1)
    x = (j % W) * T + offset
    y = (j // W) * T + offset
    return k, x, y, sc, got, n_above


@partial(jax.jit, static_argnames=("K", "D"))
def distinct_templates(k: jnp.ndarray, valid: jnp.ndarray, K: int, D: int):
    """Compact the distinct template ids among valid candidates.

    Returns (slots [D] template ids with K as fill, slot_of_k [K] slot index,
    n_distinct).
    """
    present = jnp.zeros((K,), bool).at[jnp.where(valid, k, 0)].max(valid)
    slots_raw, n_distinct = compact_indices(present, D)
    slots = jnp.minimum(slots_raw, K).astype(jnp.int32)
    # slot_of_k = -1 for templates without a slot: overflow (n_distinct > D)
    # then safely INVALIDATES those candidates instead of mis-mapping them;
    # callers escalate D on overflow for full parity. rank = the template's
    # position among present ids (== its compacted slot when rank < D).
    rank = jnp.cumsum(present.astype(jnp.int32)) - 1
    slot_of_k = jnp.where(present & (rank < D), rank, -1).astype(jnp.int32)
    return slots, slot_of_k, n_distinct


def gather_bank(bank: LevelBank, slots: jnp.ndarray) -> LevelBank:
    """Sub-bank for the given template slots (id K -> all-invalid row)."""
    K = bank.fx.shape[0]
    safe = jnp.minimum(slots, K - 1)
    live = slots < K
    return LevelBank(
        fx=bank.fx[safe],
        fy=bank.fy[safe],
        label=bank.label[safe],
        valid=bank.valid[safe] & live[:, None],
        nfeat=bank.nfeat[safe],
        width=jnp.where(live, bank.width[safe], 1),
        height=jnp.where(live, bank.height[safe], 1),
    )


@partial(jax.jit, static_argnames=("T", "size_wh"))
def refine_from_maps(Sfull: jnp.ndarray, slot_of_k: jnp.ndarray,
                     bank: LevelBank, T: int, size_wh,
                     k: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                     valid: jnp.ndarray, threshold):
    """Pyramid refinement using full fine-level score maps.

    `Sfull` [D, M] holds UNMASKED fine score maps for the distinct candidate
    templates. Under the border clamp (line2Dup.cpp:1239-1245) no feature is
    ever dropped and all linear-memory reads stay in-plane, so the 16×16
    local similarity (line2Dup.cpp:860-922) is exactly a window of the full
    map: patch[rr, cc] = Sfull[slot, (cy//T-8+rr)*W + (cx//T-8+cc)].
    """
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    border = 8 * T
    offset = T // 2 + (T % 2 - 1)

    width_k = bank.width[k]
    height_k = bank.height[k]
    max_x = w_img - width_k - border
    max_y = h_img - height_k - border
    cx = jnp.minimum(jnp.maximum(x * 2 + 1, border), max_x)
    cy = jnp.minimum(jnp.maximum(y * 2 + 1, border), max_y)

    wx = cx // T - 8  # window origin in decimated grid
    wy = cy // T - 8
    rr = jnp.arange(16, dtype=jnp.int32)
    slot = slot_of_k[k]
    valid = valid & (slot >= 0)
    base = jnp.maximum(slot, 0) * M + wy * W + wx  # [C]
    idx = (base[:, None, None] + rr[None, :, None] * W
           + rr[None, None, :])  # [C, 16, 16]
    flat = Sfull.reshape(-1)
    patch = flat[jnp.clip(idx, 0, flat.shape[0] - 1)]  # [C, 16, 16]

    pf = patch.reshape(patch.shape[0], 256)
    best = jnp.argmax(pf, axis=1).astype(jnp.int32)
    raw = jnp.take_along_axis(pf, best[:, None], axis=1)[:, 0]
    sim = exact_ratio_f32(raw * 100, 4 * bank.nfeat[k])
    nx = (wx + best % 16) * T + offset
    ny = (wy + best // 16) * T + offset
    nvalid = valid & (sim >= threshold)
    return k, nx, ny, sim, nvalid


@partial(jax.jit, static_argnames=("T", "size_wh"))
def refine_candidates(lmflat: jnp.ndarray, bank: LevelBank, T: int, size_wh,
                      k: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray,
                      valid: jnp.ndarray, threshold):
    """One pyramid refinement step for all candidates at once.

    Implements the candidate loop of matchClass (line2Dup.cpp:1221-1293):
    doubling, border clamping, 16×16 local similarity, argmax update,
    threshold filter. All candidates (across all templates) batch together.
    """
    w_img, h_img = size_wh
    W, H = w_img // T, h_img // T
    M = W * H
    # invalid features route to the M-byte zero pad at the buffer's end;
    # derived from the buffer so 16-orientation stacks work too
    L = lmflat.shape[0] - M
    border = 8 * T
    offset = T // 2 + (T % 2 - 1)

    width_k = bank.width[k]
    height_k = bank.height[k]
    max_x = w_img - width_k - border
    max_y = h_img - height_k - border

    cx = jnp.minimum(jnp.maximum(x * 2 + 1, border), max_x)
    cy = jnp.minimum(jnp.maximum(y * 2 + 1, border), max_y)

    off_x = (cx // T - 8) * T  # [C]
    off_y = (cy // T - 8) * T

    fx = bank.fx[k] + off_x[:, None]  # [C, N]
    fy = bank.fy[k] + off_y[:, None]
    inb = (
        bank.valid[k]
        & (fx >= 0) & (fx < w_img) & (fy >= 0) & (fy < h_img)
    )
    plane = bank.label[k] * (T * T) + (fy % T) * T + (fx % T)
    base = plane * M + (fy // T) * W + (fx // T)
    base = jnp.where(inb, base, L).astype(jnp.int32)  # [C, N]

    rr = jnp.arange(16, dtype=jnp.int32)
    # window positions kept FLAT [256] so the [.., N, 256] gather tiles
    # cleanly (a trailing [16, 16] pads 16 -> 128 lanes: 8x the memory)
    patch_off = (rr[:, None] * W + rr[None, :]).reshape(-1)  # [256]
    clip_hi = lmflat.shape[0] - 1

    def _patch_sum(base_c):
        idx = base_c[:, :, None] + patch_off[None, None, :]  # [c, N, 256]
        g = lmflat[jnp.clip(idx, 0, clip_hi)].astype(jnp.int32)
        return jnp.sum(g, axis=1)  # [c, 256]

    C_, N_ = base.shape
    if C_ * N_ <= 1 << 18:
        flat = _patch_sum(base)  # one shot: [C, N, 256] stays < ~256 MB
    else:
        # wide banks (8191-feature mode, line2Dup.cpp:811) x many
        # candidates: the one-shot gather materializes C*N*256 i32
        # (19 GB at 256 cand x 9126 slots) — chunk the CANDIDATE axis;
        # per-candidate feature sums are untouched, so results stay
        # bit-identical to the one-shot form.
        chunk = max(1, (1 << 18) // N_)
        Cp = -(-C_ // chunk) * chunk
        base_p = jnp.pad(base, ((0, Cp - C_), (0, 0)))
        flat = jax.lax.map(
            _patch_sum, base_p.reshape(Cp // chunk, chunk, N_)
        ).reshape(Cp, 256)[:C_]
    best = jnp.argmax(flat, axis=1).astype(jnp.int32)  # first max (C++ strict >)
    raw = jnp.take_along_axis(flat, best[:, None], axis=1)[:, 0]
    sim = exact_ratio_f32(raw * 100, 4 * bank.nfeat[k])
    best_r = best // 16
    best_c = best % 16
    nx = (cx // T - 8 + best_c) * T + offset
    ny = (cy // T - 8 + best_r) * T + offset
    nvalid = valid & (sim >= threshold)
    return k, nx, ny, sim, nvalid
