"""Smoke test of the main match path on one NVIDIA GPU.

    python chip_smoke.py              # one GPU: phases 1-7 below
    python chip_smoke.py --multichip  # four GPUs: the sharded paths only
    python chip_smoke.py --rehearse [--multichip]
        # tiny shapes on the CPU (4 virtual devices for --multichip) to
        # rehearse the script; always exits non-zero without a result

Phases (one GPU):
 1. device report: platform, device kind, count, JAX version, native lib;
 2. the Triton scoring kernel, compiled for the card, against the NumPy
    oracle (oracle/reference.py:similarity), exact int32 equality: the
    coarse level at K=1000 for 8 and 16 orientations, the fine-level maps
    at D=64, and the 8-template x 8191-feature bank;
 3. the frontend: the orientation bin of every (dx, dy) pair a Sobel of
    8-bit pixels yields, 8 and 16 orientations, and both levels'
    linear-memory bytes at 1024x1024 against the oracle's
    build_lm_pyramid;
 4. the main path through Detector, each match set (template, x, y,
    similarity) against the oracle's match_class or, where the oracle is
    too slow, the same program run on the CPU backend in this process
    (each line says which): match with its default candidate caps
    (1000 x 63 bank, 1024x1024; frames over the caps re-run through the
    exact escalating path, and the line counts them); the batched program
    itself at caps that hold every candidate (utils/synthetic.py:
    scene_caps), B=1 and B=8, with its overflow flags checked on the
    timed output; the masked 360-template flow; the 16-orientation
    360-template flow; the 8 x 8191 flow; and the upstream case1 demo
    (361 x 128 bank rebuilt from committed goldens) against the compiled
    C++ reference's match list;
 5. the deployment call Detector.match_icp on the 1000 x 128 bank with
    top_c=32, against the CPU backend: identical matches, and poses within
    ICP_TOL (float32 sums run in another order on the GPU);
 6. steady-state ms per frame of phases 4-5 (each ending in a host result
    or block_until_ready) and peak device memory;
 7. the last line: {"ok": true, "device": {...}}.

Every line before the last names the card (nvidia-smi name, power limit).
The script exits non-zero, without the last line, when the first device is
not a GPU or when any phase fails. It runs in one process, so one process
holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# ICP pose tolerance GPU vs CPU backend (phase 5): the float32 normal
# equations run at HIGHEST precision but are summed in another order, and
# 12 Gauss-Newton iterations carry the difference. The bound is 20x below
# the ICP accuracy contract (0.1 degree / 0.5% scale, tests/test_icp.py).
ICP_TOL = {"dtheta_deg": 5e-3, "dscale": 5e-5, "tx": 5e-3, "ty": 5e-3,
           "rmse": 5e-3}


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no GPU (nvidia-smi unavailable)"


class Smoke:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.card = _card()
        self.failed: list[str] = []
        self.timings: dict[str, float] = {}

    def log(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        self.log(f"{'PASS' if ok else 'FAIL'} {name}"
                 + (f" ({detail})" if detail else ""))
        if not ok:
            self.failed.append(name)

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — a phase failure fails the run
            self.failed.append(name)
            for line in traceback.format_exc().rstrip().splitlines():
                self.log(f"  {line}")
            self.log(f"FAIL phase {name}")
        self.log(f"phase {name} took {time.perf_counter() - t0:.1f} s")


def _ms_per_call(fn, reps: int):
    """(ms per call, the last call's output): `reps` calls back to back,
    ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1e3 / reps, out


def _oracle_tps(det, class_id):
    return [[{"features": [(f.x, f.y, f.label) for f in t.features],
              "width": t.width, "height": t.height} for t in tp]
            for tp in det.class_templates[class_id]]


def _set_of(matches):
    return sorted({(m.template_id, m.x, m.y, float(m.similarity))
                   for m in matches})


def _oracle_set(matches):
    return sorted({(m["template_id"], m["x"], m["y"],
                    float(m["similarity"])) for m in matches})


def _diff(got, want) -> str:
    """A few elements of each side of a set difference, for FAIL lines."""
    g, w = set(got), set(want)
    if g == w:
        return ""
    return (f"; only on the GPU: {sorted(g - w)[:3]}, only in the "
            f"reference: {sorted(w - g)[:3]}")


def _cpu_twin(det):
    """A Detector with det's templates whose arrays live on the CPU
    backend and which runs the XLA scorer (call it under
    jax.default_device(cpu))."""
    from shape_based_matching_tpu import Detector

    twin = Detector(num_features=det.num_features, T=det.T_at_level,
                    num_orientations=det.num_orientations,
                    use_pallas=False)
    twin.class_templates = {c: list(v)
                            for c, v in det.class_templates.items()}
    return twin


def single_chip(s: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    from shape_based_matching_tpu import native
    from shape_based_matching_tpu.models.detector import _build_lm_pyramid
    from shape_based_matching_tpu.ops.fastmath import phase_deg
    from shape_based_matching_tpu.ops.gradients import orientation_bins
    from shape_based_matching_tpu.oracle import reference as oracle
    from shape_based_matching_tpu.ops.pallas.similarity_triton import (
        coarse_scores_triton)
    from shape_based_matching_tpu.ops.similarity import (
        _flat_offsets, _positions, gather_bank)
    from shape_based_matching_tpu.utils import dispatch
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, scene_caps, synthetic_scene)

    small = s.rehearse
    side = 256 if small else 1024
    cpu = jax.devices("cpu")[0]
    interp = small
    dev = jax.devices()[0]

    # -- 1. device report ------------------------------------------------
    def p1():
        s.log(f"platform={dev.platform} kind={dev.device_kind} "
              f"count={len(jax.devices())} jax={jax.__version__} "
              f"native_host_lib="
              f"{'loaded' if native.load() is not None else 'absent'}")

    s.phase("1 device report", p1)

    def bank(n, nf, **kw):
        if small:
            kw = {k: v for k, v in kw.items() if k not in ("size", "cache")}
            return build_rotated_detector(max(4, n // 40), nf, size=96,
                                          cache=False, **kw)
        return build_rotated_detector(n, nf, **kw)

    det1000, templ = bank(1000, 63)
    scene = synthetic_scene(side, side, templ, n_instances=4)

    # -- 2. kernel vs NumPy oracle at real widths ------------------------
    def kernel_vs_oracle(name, det, scene_, level, D=None):
        banks = det._get_banks("bench")
        T = det.T_at_level
        lms = _build_lm_pyramid(jnp.asarray(scene_),
                                jnp.zeros((1, 1), jnp.uint8), True, False,
                                T, 2, jnp.float32(det.weak_threshold),
                                det.num_orientations)
        lm, lmflat = lms[level]
        h, w = scene_.shape[0] >> level, scene_.shape[1] >> level
        t = T[level]
        W, H = w // t, h // t
        M = W * H
        tps = det.class_templates["bench"]
        ids = list(range(len(tps))) if D is None else list(range(D))
        b = banks[level] if D is None else gather_bank(
            banks[level], jnp.arange(D))
        off = _flat_offsets(b, t, W, M, (w, h), det.num_orientations)
        got = np.asarray(coarse_scores_triton(
            off, _positions(b, t, W, H), lmflat, M, mask_positions=True,
            interpret=interp))
        lm_np = np.asarray(lm)
        bad = 0
        for r, k in enumerate(ids):
            tl = tps[k][level]
            want = oracle.similarity(
                lm_np, [(f.x, f.y, f.label) for f in tl.features],
                (tl.width, tl.height), (w, h), t).reshape(-1)
            bad += int(np.sum(got[r] != want.astype(np.int64)))
        s.check(f"kernel == oracle: {name}", bad == 0,
                f"K={len(ids)} N={int(b.fx.shape[1])} M={M}, "
                f"{bad} differing cells")

    det16, templ16 = bank(1000, 63, n_ori=16, cache=False)
    det8191, templ8191 = bank(8, 8191, size=768, dense=True)
    scene16 = synthetic_scene(side, side, templ16, n_instances=4, seed=3)
    scene8191 = synthetic_scene(side, side, templ8191, n_instances=2,
                                seed=11)

    def p2():
        kernel_vs_oracle("coarse 8-ori", det1000, scene, 1)
        kernel_vs_oracle("coarse 16-ori", det16, scene16, 1)
        kernel_vs_oracle("fine maps D=64", det1000, scene, 0,
                         D=min(64, det1000.num_templates("bench")))
        kernel_vs_oracle("8191 bank coarse", det8191, scene8191, 1)
        kernel_vs_oracle("8191 bank fine", det8191, scene8191, 0)

    s.phase("2 kernel", p2)

    # -- 3. frontend bytes vs oracle --------------------------------------
    def p3():
        # every (dx, dy) a 3x3 Sobel of 8-bit pixels can produce: the
        # orientation buckets depend on nothing else, and XLA on the GPU
        # divides float32 approximately and may contract into FMAs
        v = np.arange(-1020, 1021, dtype=np.float32)
        dx, dy = np.meshgrid(v, v)
        ang = jax.jit(phase_deg)(jnp.asarray(dx), jnp.asarray(dy))
        want_ang = oracle.fast_atan2_deg(dy, dx)
        n_ang = int(np.sum(np.asarray(ang) != want_ang))
        for n_ori in (8, 16):
            got = np.asarray(jax.jit(orientation_bins, static_argnums=1)(
                ang, n_ori))
            n_bad = int(np.sum(got != oracle.orientation_bins(want_ang,
                                                              n_ori)))
            s.check(f"orientation bins, every Sobel pair, {n_ori}-ori "
                    f"== oracle", n_bad == 0,
                    f"{dx.size} pairs, {n_bad} differing bins, {n_ang} "
                    f"angles not bit-equal")
        lms = _build_lm_pyramid(jnp.asarray(scene),
                                jnp.zeros((1, 1), jnp.uint8), True, False,
                                (4, 8), 2, jnp.float32(30.0))
        want, _ = oracle.build_lm_pyramid(scene, 30.0, (4, 8))
        for lvl in range(2):
            got = np.asarray(lms[lvl][0])
            n_bad = int(np.sum(got != want[lvl]))
            s.check(f"frontend level {lvl} linear memories == oracle",
                    n_bad == 0, f"shape {got.shape}, {n_bad} differing "
                    f"bytes")

    s.phase("3 frontend", p3)

    # -- 4. main path ------------------------------------------------------
    # Every check says whether the batched program's own output was
    # compared: a frame over match_batch's candidate caps (default 256
    # coarse candidates, 64 distinct refine templates) re-runs through the
    # exact escalating path, counted as `overflow_reruns`.
    def oracle_set(det, frame, thr, mask=None, cid="bench"):
        lms_o, sizes = oracle.build_lm_pyramid(
            frame, det.weak_threshold, det.T_at_level,
            n_ori=det.num_orientations, mask=mask)
        return _oracle_set(oracle.match_class(
            lms_o, sizes, det.T_at_level, _oracle_tps(det, cid), thr, cid))

    def vs_oracle(name, det, scene_, thr, mask=None, reruns_ok=False):
        """Detector.match (default caps) against the oracle."""
        with dispatch.measure() as d:
            got = _set_of(det.match(scene_, thr, mask=mask))
        want = oracle_set(det, scene_, thr, mask)
        reruns = d.get("overflow_reruns", 0)
        s.check(f"{name} == oracle match_class", got == want
                and (reruns_ok or reruns == 0),
                f"{len(got)} matches, {reruns} frame(s) over the default "
                f"caps re-ran exactly, reference: NumPy oracle"
                f"{_diff(got, want)}")

    def batch_vs(name, det, frames, thr, caps, ref="oracle", masks=None):
        """The batched program's own output at caps that hold every
        candidate (no overflow, no re-run) against the oracle or the same
        program on the CPU backend; returns ms per frame of the packed
        device result (as_matches=False), checked for overflow too."""
        cand, dist = caps
        kw = dict(masks=masks, cand_cap=cand, distinct_cap=dist)
        with dispatch.measure() as d:
            got = [_set_of(g) for g in det.match_batch(frames, thr, **kw)]
        if ref == "oracle":
            want = [oracle_set(det, f, thr) for f in frames]
        else:
            with jax.default_device(cpu):
                want = [_set_of(w) for w in
                        _cpu_twin(det).match_batch(frames, thr, **kw)]
        reruns = d.get("overflow_reruns", 0)
        dframes = jax.device_put(frames)
        call = lambda: list(det.match_batch(dframes, thr, as_matches=False,
                                            **kw).values())
        ms, out = _ms_per_call(call, 3 if small else 20)
        n_ovf = sum(int(np.asarray(v[5]).sum()) for v in out)
        first = next((_diff(g, w) for g, w in zip(got, want) if g != w), "")
        ref_name = ("NumPy oracle" if ref == "oracle"
                    else "same program on the CPU backend")
        s.check(f"{name}: batched program at caps {caps} == {ref}",
                got == want and reruns == 0 and n_ovf == 0,
                f"{sum(map(len, got))} matches over {len(frames)} frame(s), "
                f"{reruns} re-runs, {n_ovf} timed frames over the caps, "
                f"reference: {ref_name}{first}")
        return ms / len(frames)

    def p4():
        caps1000 = scene_caps(1000)
        vs_oracle("match 1000x63 (default caps)", det1000, scene, 85.0,
                  reruns_ok=True)
        s.timings["match_1000x63_default_caps_ms"], _ = _ms_per_call(
            lambda: det1000.match(scene, 85.0), 3 if small else 20)
        batch_vs("match_batch 1000x63 B=1", det1000, scene[None], 85.0,
                 caps1000)
        s.timings["match_batch_b1_1000x63_host_matches_ms"], _ = \
            _ms_per_call(lambda: det1000.match_batch(
                scene[None], 85.0, cand_cap=caps1000[0],
                distinct_cap=caps1000[1]), 3 if small else 20)
        frames = np.stack([synthetic_scene(side, side, templ,
                                           n_instances=4, seed=20 + i)
                           for i in range(8)])
        s.timings["match_batch_b8_1000x63_ms_per_frame"] = batch_vs(
            "match_batch 1000x63 B=8", det1000, frames, 85.0, caps1000)

        det360, t360 = bank(360, 63)
        sc360 = synthetic_scene(side, side, t360, n_instances=4, seed=3)
        rng = np.random.RandomState(4)
        mask = (rng.rand(side, side) > 0.25).astype(np.uint8) * 255
        vs_oracle("masked match 360x63", det360, sc360, 85.0, mask=mask)
        s.timings["match_masked_360_ms"], _ = _ms_per_call(
            lambda: det360.match(sc360, 85.0, mask=mask),
            3 if small else 20)

        det16_360, t16 = bank(360, 63, n_ori=16)
        sc16 = synthetic_scene(side, side, t16, n_instances=4, seed=3)
        # 16-orientation responses are {0, 1, 4}: scores run lower
        vs_oracle("16-ori match 360x63", det16_360, sc16, 60.0)
        s.timings["match_16ori_360_ms"], _ = _ms_per_call(
            lambda: det16_360.match(sc16, 60.0), 3 if small else 20)

        # the dense 8191-feature bank: 1310 coarse candidates and 4
        # distinct templates at threshold 60 (counted on the CPU backend)
        s.timings["match_batch_b1_8x8191_ms"] = batch_vs(
            "match_batch 8x8191 B=1", det8191, scene8191[None], 60.0,
            (2048, 8), ref="cpu")

    s.phase("4 main path", p4)

    # -- 4b. case1 vs the compiled C++ reference's own match list ---------
    def p4b():
        from tests.golden_utils import case1_detector, load_json, load_mat

        det = case1_detector()
        img = load_mat("case1_img.bin")
        with dispatch.measure() as d:
            got = {(m.template_id, m.x, m.y, round(float(m.similarity), 3))
                   for m in det.match(img, 90.0, ["test"])}
        want = {(m["template_id"], m["x"], m["y"],
                 round(float(m["similarity"]), 3))
                for m in load_json("case1_matches.json")["matches"]}
        reruns = d.get("overflow_reruns", 0)
        s.check("case1 361x128 == compiled C++ reference matches",
                got == want and reruns == 0,
                f"{len(got)} matches, {reruns} re-runs, reference: "
                f"tests/goldens/case1_matches.json{_diff(got, want)}")
        s.timings["match_case1_361x128_ms"], _ = _ms_per_call(
            lambda: det.match(img, 90.0, ["test"]), 3 if small else 20)

    s.phase("4b case1 golden", p4b)

    # -- 5. deployment call -------------------------------------------------
    def p5():
        det128, t128 = bank(1000, 128)
        sc = synthetic_scene(side, side, t128, n_instances=4, seed=7)
        dsc = jax.device_put(sc)
        with dispatch.measure() as d:
            got = det128.match_icp(dsc, 85.0, top_c=32)
        reruns = d.get("overflow_reruns", 0)
        with jax.default_device(cpu):
            want = _cpu_twin(det128).match_icp(sc, 85.0, top_c=32)
        key = lambda r: (r["match"].template_id, r["match"].x,
                         r["match"].y, float(r["match"].similarity))
        same_m = [key(r) for r in got] == [key(r) for r in want]
        worst = {k: 0.0 for k in ICP_TOL}
        ok = same_m and len(got) > 0
        for g, w in zip(got, want):
            ok &= g["valid"] == w["valid"] and g["inliers"] == w["inliers"]
            for k in ICP_TOL:
                worst[k] = max(worst[k], abs(g[k] - w[k]))
        ok &= all(worst[k] <= ICP_TOL[k] for k in ICP_TOL) and reruns == 0
        s.check("match_icp 1000x128 top_c=32 == CPU backend within ICP_TOL",
                ok, f"{len(got)} refined, {reruns} re-runs, same matches "
                f"{same_m}, worst "
                f"abs diff {json.dumps(worst)}"
                f"{_diff(map(key, got), map(key, want))}")
        s.timings["match_icp_1000x128_ms"], _ = _ms_per_call(
            lambda: det128.match_icp(dsc, 85.0, top_c=32),
            3 if small else 20)

    s.phase("5 deployment call", p5)

    # -- 6. timings --------------------------------------------------------
    def p6():
        for k, v in s.timings.items():
            s.log(f"timing {k} = {v:.4f}")
        stats = dev.memory_stats() or {}
        s.log(f"peak_bytes_in_use = {stats.get('peak_bytes_in_use')}")

    s.phase("6 timings", p6)


def multichip(s: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _match_sets
    from shape_based_matching_tpu import Detector
    from shape_based_matching_tpu.parallel.mesh import (
        _local_match, add_templates_sharded, make_mesh,
        multichip_match_step, shard_pad_bank)
    from shape_based_matching_tpu.parallel.spatial import (
        default_halo, make_spatial_mesh, slice_tiles, spatial_match_step)
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene, synthetic_shape_image)

    small = s.rehearse
    side = 256 if small else 1024
    n = 4
    if small:
        det, templ = build_rotated_detector(12, 63, size=96, cache=False)
    else:
        det, templ = build_rotated_detector(1000, 63)
    s.log(f"devices: {[d.device_kind for d in jax.devices()[:n]]}")
    T = det.T_at_level
    banks = det._get_banks("bench")
    K = int(banks[-1].fx.shape[0])
    thr, weak = jnp.float32(85.0), jnp.float32(30.0)

    def p_mesh():
        mesh = make_mesh(n)
        s.log(f"mesh (data, templ) = {mesh.devices.shape}")
        n_templ = mesh.devices.shape[1]
        frames = np.stack([synthetic_scene(side, side, templ,
                                           n_instances=4, seed=30 + i)
                           for i in range(4)])
        pb = [shard_pad_bank(b, n_templ) for b in banks]
        cap, dcap = 4096, 256
        step = multichip_match_step(mesh, T, (side, side), cand_cap=cap,
                                    distinct_cap=dcap)
        fields = [f for b in pb for f in b]
        k, x, y, sc, valid, n_above, nd = step(jnp.asarray(frames), weak,
                                                thr, *fields)
        sizes = [(side >> l, side >> l) for l in range(len(T))]
        rk, rx, ry, rsc, rv, rn, rnd = _local_match(
            jnp.asarray(frames), pb, T, sizes, weak, thr, cap * n_templ,
            dcap * n_templ, True, 8)
        got, want = _match_sets(k, x, y, sc, valid), _match_sets(
            rk, rx, ry, rsc, rv)
        no_ovf = (int(np.max(np.asarray(n_above))) <= cap
                  and int(np.max(np.asarray(nd))) <= dcap)
        s.check("multichip_match_step (2x2 mesh) == _local_match",
                got == want and no_ovf,
                f"{sum(len(g) for g in got)} matches over 4 frames, "
                f"max n_above {int(np.max(np.asarray(n_above)))}, "
                f"caps not exceeded {no_ovf}")
        s.timings["mesh_match_4frames_ms"], _ = _ms_per_call(
            lambda: step(jnp.asarray(frames), weak, thr, *fields),
            2 if small else 10)

    def p_spatial():
        h_big = 4 * side
        big = np.concatenate([synthetic_scene(side, side, templ,
                                              n_instances=2, seed=40 + i)
                              for i in range(4)])
        halo = default_halo(banks, T)
        cap = 4096
        step = spatial_match_step(make_spatial_mesh(n), T, (h_big, side),
                                  n, halo, cand_cap=cap, distinct_cap=256)
        fields = [f for b in banks for f in b]
        ks, xs, ys, scs, vs, na = step(
            jnp.asarray(slice_tiles(big, n, halo)), weak, thr, *fields)
        sizes = [(side >> l, h_big >> l) for l in range(len(T))]
        fk, fx, fy, fsc, fv, fn, _ = _local_match(
            jnp.asarray(big)[None], banks, T, sizes, weak, thr, 4 * cap,
            256, True, 8)
        (got,) = _match_sets(ks[None], xs[None], ys[None], scs[None],
                             vs[None])
        (want,) = _match_sets(fk, fx, fy, fsc, fv)
        s.check(f"spatial_match_step ({h_big}x{side}, 4 bands, halo "
                f"{halo}) == single-device full frame", got == want,
                f"{len(got)} matches, max n_above per band "
                f"{int(np.max(np.asarray(na)))}")

    def p_train():
        frames = np.stack([synthetic_shape_image(96 if small else 256,
                                                 seed=900 + i)
                           for i in range(9 if small else 33)])
        d_local = Detector(num_features=63)
        ids_l = d_local.add_templates(frames, "c")
        d_mesh = Detector(num_features=63)
        ids_m = add_templates_sharded(d_mesh, frames, "c",
                                      mesh=make_mesh(n), chunk_per_dev=2)

        def flat(d):
            return [[(t.width, t.height, t.tl_x, t.tl_y,
                      [(f.x, f.y, f.label) for f in t.features])
                     for t in tp] for tp in d.class_templates["c"]]

        s.check("add_templates_sharded == add_templates",
                ids_m == ids_l and flat(d_mesh) == flat(d_local),
                f"{sum(i >= 0 for i in ids_m)} templates over "
                f"{len(frames)} frames")

    s.phase("mesh match", p_mesh)
    s.phase("spatial match", p_spatial)
    s.phase("sharded training", p_train)
    for k, v in s.timings.items():
        s.log(f"timing {k} = {v:.4f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-GPU sharded paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny shapes on the CPU; never prints a result")
    args = ap.parse_args()

    if args.rehearse:
        if args.multichip:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import jax

        from shape_based_matching_tpu.utils.compile_cache import (
            enable_compile_cache)
    except ImportError as e:
        print(f"chip_smoke: cannot import the program: {e}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    s = Smoke(args.rehearse)
    devs = jax.devices()
    if devs[0].platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (first device: {devs[0].platform}); "
              "nothing measured", file=sys.stderr)
        return 1
    need = 4 if args.multichip else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} devices, found {len(devs)}",
              file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    (multichip if args.multichip else single_chip)(s)
    s.log(f"total {time.perf_counter() - t0:.1f} s; "
          f"failed: {s.failed or 'none'}")
    if s.failed:
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal finished; no result without a GPU",
              file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
