"""Benchmark: full LINE-2D match step at 1024x1024 on one NVIDIA GPU.

Primary metric (the BASELINE.md north star): end-to-end match of a
1000-template bank — gradient extraction, quantization, spread, response
LUT, linearization, batched coarse scoring, candidate extraction, and
pyramid refinement — against the reference's ~20 ms "1000 templates"
CPU number (README.md:35). Also measures the 360-template config
(reference: 60 ms response maps + 7 ms match = 67 ms) and writes all
metrics to BENCH_DETAIL.json in the working directory.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card"} — FIRST, as soon as the primary metric finishes, so a timeout
during the detail metrics cannot lose it. Detail metrics then run
cheapest-first under a wall-clock budget (env SBM_BENCH_BUDGET_S,
default 480 s, measured from the moment the primary line prints);
whatever doesn't fit is recorded in BENCH_DETAIL's "skipped" list.
BENCH_DETAIL.json is rewritten after every metric.

One process per card: this parent never imports JAX. Each metric runs in
its own subprocess, one at a time, so exactly one JAX process holds the
card. A metric subprocess refuses to measure anywhere but on a GPU, and
every record names the platform, device kind and count, and the card's
name and power limit (nvidia-smi). Synthetic template banks load from the
committed `bench_banks/` snapshots (utils/synthetic.py).
"""

import json
import time

# Budget epoch: reset when the primary metric line prints (see main) so
# the detail metrics always get the full budget; initialized here for
# importers (tests) that drive pieces directly.
_T0 = time.monotonic()

BASELINE_1000_MS = 20.0   # reference CPU, ~1000 templates e2e
BASELINE_360_MS = 67.0    # 60 ms response maps + 7 ms / 360-template match


def _min_of(run, iters: int, repeats: int = 3) -> float:
    """Best-of-repeats ms/iter: the min over a few loops of `iters`
    calls, each loop ending in block_until_ready."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(iters)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def _measure(num_templates: int, iters: int = 30) -> float:
    import jax
    import numpy as np

    from __graft_entry__ import entry

    fn, args = entry(num_templates=num_templates)
    jitted = jax.jit(fn)
    out = jitted(*args)
    jax.block_until_ready(out)

    def run(n):
        out = None
        for _ in range(n):
            out = jitted(*args)
        jax.block_until_ready(out)
        return out

    ms = _min_of(run, iters)
    _, _, _, _, _, overflow, n_above, n_distinct = run(1)
    if bool(np.asarray(overflow)):
        raise RuntimeError(
            f"e2e{num_templates}: the timed step overflowed its caps "
            f"({int(n_above)} candidates, {int(n_distinct)} distinct "
            f"templates): its result is truncated")
    return ms


def _timed_batch(det, frames, threshold: float, iters: int, masks=None,
                 caps=None) -> float:
    """Best-of-repeats ms per Detector.match_batch call on device-resident
    frames (packed output, as_matches=False, nothing pulled to the host).
    `caps` = (cand_cap, distinct_cap), by default sized for the bank
    (utils/synthetic.py:scene_caps). Raises when a timed frame overflowed
    them: the batched program's result for it would be truncated (the
    exact re-run happens only when matches are pulled)."""
    import jax
    import numpy as np

    from shape_based_matching_tpu.utils.synthetic import scene_caps

    cand, dist = caps or scene_caps(det.num_templates())

    def call():
        return det.match_batch(frames, threshold, masks=masks,
                               cand_cap=cand, distinct_cap=dist,
                               as_matches=False)

    jax.block_until_ready(call())  # compile

    def run(n):
        out = None
        for _ in range(n):
            out = call()
        jax.block_until_ready(out)
        return out

    ms = _min_of(run, iters)
    n_ovf = sum(int(np.asarray(v[5]).sum()) for v in run(1).values())
    if n_ovf:
        raise RuntimeError(f"{n_ovf} timed frame(s) overflowed the caps "
                           f"({cand}, {dist}): the result is truncated")
    return ms


def _measure_throughput(num_templates: int = 360, batch: int = 8,
                        iters: int = 10) -> float:
    """Streaming throughput (frames/s): Detector.match_batch on B frames
    per launch, packed output (no per-frame host syncs or Match objects).

    Frames are device-resident: a streaming runtime double-buffers the
    H2D copy behind compute, so device throughput is the steady-state
    number."""
    import numpy as np

    import jax

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=63)
    frames = jax.device_put(np.stack([
        synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=s)
        for s in range(batch)
    ]))
    return batch / (_timed_batch(det, frames, 85.0, iters) / 1e3)


def _measure_masked(num_templates: int = 360, iters: int = 40):
    """Masked match e2e (ms/frame): the jabil-style workload. Returns
    (masked, unmasked) through the same match_batch B=1 program."""
    import numpy as np

    import jax

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=63)
    frame = synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=3)
    rng = np.random.RandomState(4)
    mask = (rng.rand(1024, 1024) > 0.25).astype(np.uint8) * 255
    frames = jax.device_put(frame[None])
    masks = jax.device_put(mask[None])
    # unmasked through the SAME match_batch B=1 program for a fair ratio
    return (_timed_batch(det, frames, 85.0, iters, masks=masks),
            _timed_batch(det, frames, 85.0, iters))


def _measure_wide(num_templates: int = 1000, num_features: int = 128,
                  iters: int = 40, dense: bool = False, size: int = 256):
    """Match-only e2e (ms/frame) for WIDE-feature banks — the fork's
    marquee 8191-features-per-template mode (README.md:45, u16
    accumulators line2Dup.cpp:811,931). `dense=True` trains on block
    noise so a wide-cap template actually saturates its feature budget.
    Returns (ms, true coarse-level feature count, coarse scorer tag)."""
    import jax

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=num_features,
                                            dense=dense, size=size)
    nfeat_coarse = len(det.get_templates("bench", 0)[-1].features)
    frame = synthetic_scene(1024, 1024, templ_img, n_instances=2, seed=11)
    frames = jax.device_put(frame[None])
    ms = _timed_batch(det, frames, 88.0, iters)
    return ms, nfeat_coarse, det.coarse_route()


def _measure_e2e_16ori(num_templates: int = 360, iters: int = 40):
    """Match e2e (ms/frame) in the 16-orientation mode — capability is
    golden-exact vs the compiled experiment (tests/test_golden_16ori.py);
    the experiment's point was the speed/precision tradeoff of the wider LUT
    (line2Dup_16bit_ori.cpp:610-700). Same config as e2e360 otherwise,
    so the e2e360 / this ratio is the 16-ori cost."""
    import jax

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=63, n_ori=16)
    frame = synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=3)
    return _timed_batch(det, jax.device_put(frame[None]), 85.0, iters)


def _measure_train_sweep(n_frames: int = 128, size: int = 256):
    """Training-sweep throughput (templates/s): Detector.add_templates on
    n_frames distinct frames — device gradient batches dispatched ahead
    of the host-side greedy selection (SURVEY.md §5 distributed-training
    analog). Returns (templates_per_s, total_s)."""
    import numpy as np

    from shape_based_matching_tpu import Detector
    from shape_based_matching_tpu.utils.synthetic import (
        synthetic_shape_image)

    frames = np.stack([synthetic_shape_image(size, seed=1000 + i)
                       for i in range(n_frames)])
    det = Detector(num_features=63)
    # warm the REAL chunk shape (add_templates chunks at 64): a smaller
    # warm leaves the [64,...] programs compiling inside the timed sweep
    det.add_templates(frames[:min(64, n_frames)], "warm")
    t0 = time.perf_counter()
    ids = det.add_templates(frames, "bench")
    dt = time.perf_counter() - t0
    assert all(i >= 0 for i in ids)
    return n_frames / dt, dt


def _measure_bank_build(num_templates: int = 10000, attempts: int = 2):
    """10k-template bank build (s): one trained template + 9999 derived
    rotations (the realistic huge-bank path, line2Dup.cpp:1409-1451) +
    device bank packing. Min over `attempts` builds."""
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector)

    best = float("inf")
    for _ in range(attempts):
        t0 = time.perf_counter()
        # cache=False: this metric MEASURES the build — the committed
        # bench_banks snapshot would reduce it to a file read.
        det, _ = build_rotated_detector(num_templates=num_templates,
                                        num_features=63, cache=False)
        det._get_banks("bench")  # pack + device put
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_icp(num_matches: int = 64, iters: int = 20):
    """Subpixel/ICP refinement (ms/frame): edge field + batched sim2
    point-to-plane refine of `num_matches` candidates on a 1024x1024
    frame (models/icp.py — the reference's icp2D/subpixel branches
    tier). Measures the three edge-field programs + the vmapped solve
    as one device round trip."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from shape_based_matching_tpu.models.icp import (edge_nearest_field,
                                                     icp_refine_points)
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=8,
                                            num_features=63)
    frame = jnp.asarray(
        synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=5))
    rng = np.random.RandomState(6)
    pts = jnp.asarray(rng.rand(num_matches, 63, 2).astype(np.float32) * 48)
    origins = jnp.asarray(
        rng.randint(64, 900, (num_matches, 2)).astype(np.float32))
    pv = jnp.ones((num_matches, 63), bool)

    def once():
        off, normal, edge, has, subpix = edge_nearest_field(
            frame, jnp.float32(30.0), 8)
        return icp_refine_points(off, normal, has, subpix, pts, origins,
                                 pv, iters=10, radius=8)

    jax.block_until_ready(once())  # compile

    def run(n):
        out = None
        for _ in range(n):
            out = once()
        jax.block_until_ready(out)

    return _min_of(run, iters)


def _measure_production_batch(num_templates: int = 1000,
                              num_features: int = 128,
                              iters: int = 10):
    """BASELINE.json "production batch" config as ONE flow: match a
    1000+-template bank (wide-feature u16 path) on a 1024x1024 frame,
    then subpixel/ICP-refine the surviving detections. Returns ms/frame
    for the full match -> Match objects -> sim2 refine pipeline
    (host-side NMS + Match construction included — this is the
    deployment loop, not a kernel time)."""
    import jax

    from shape_based_matching_tpu.models.icp import refine_matches_icp
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=num_features)
    frame = synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=7)
    dev_frame = jax.device_put(frame)
    jax.block_until_ready(dev_frame)

    def once():
        matches = det.match(dev_frame, 85.0)
        return refine_matches_icp(det, dev_frame, matches[:32])

    res = once()  # compile
    assert res, "production batch found no matches"

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            once()
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def _measure_production_onecall(num_templates: int = 1000,
                                num_features: int = 128,
                                iters: int = 10):
    """The one-sync deployment API (Detector.match_icp): same flow and
    host-dict output as _measure_production_batch but with ONE blocking
    device->host sync per frame instead of two — candidate selection
    and template-point gathering stay on device
    (models/icp.py:match_icp). The production_batch - production_onecall
    gap is one host sync per frame."""
    import jax

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=num_features)
    frame = synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=7)
    dev_frame = jax.device_put(frame)
    jax.block_until_ready(dev_frame)

    res = det.match_icp(dev_frame, 85.0, top_c=32)  # compile
    assert res, "one-sync production flow found no matches"

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            det.match_icp(dev_frame, 85.0, top_c=32)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def _measure_production_stream(num_templates: int = 1000,
                               num_features: int = 128,
                               iters: int = 10):
    """Pipelined per-frame deployment loop (ms/frame): the same
    host-dict-per-frame flow as production_onecall but via
    Detector.match_icp_async — frame N+1's device programs dispatch
    before frame N's one-sync result pull, so device compute hides
    under the previous frame's blocking sync
    (models/icp.py:match_icp_async). The production_onecall -
    production_stream gap is the overlapped compute; this is the
    fastest shape that still hands the host per-frame results."""
    import jax

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=num_features)
    frames = [jax.device_put(synthetic_scene(1024, 1024, templ_img,
                                             n_instances=4, seed=s))
              for s in (7, 11, 13)]
    jax.block_until_ready(frames)

    def run(n):
        out = []
        prev = None
        for i in range(n):
            h = det.match_icp_async(frames[i % 3], 85.0, top_c=32)
            if prev is not None:
                out.append(prev.result())
            prev = h
        out.append(prev.result())
        return out

    res = run(3)  # compile all three frames' programs
    assert res and res[0], "pipelined production flow found no matches"

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run(iters)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def _measure_production_device(num_templates: int = 1000,
                               num_features: int = 128,
                               iters: int = 20):
    """Device-complete detect+refine pipeline (ms/frame): the same
    production flow as _measure_production_batch but via
    match_refine_batch — packed match output feeds device-side top-k
    selection and batched sim2 ICP with NO host sync between stages
    (one block at the end). The gap between this and production_batch
    is pure host orchestration (Match objects, NMS, transfers)."""
    import jax

    from shape_based_matching_tpu.models.icp import match_refine_batch
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=num_features)
    frame = synthetic_scene(1024, 1024, templ_img, n_instances=4, seed=7)
    frames = jax.device_put(frame[None])
    jax.block_until_ready(frames)

    def once():
        return match_refine_batch(det, frames, 85.0, top_c=32)

    out = once()  # compile
    jax.block_until_ready(jax.tree_util.tree_leaves(out))
    n_valid = int(jax.device_get(out["bench"][0]["icp"].valid).sum())
    assert n_valid > 0, "device pipeline refined no matches"
    # the default caps hold this frame's 206 candidates and 52 distinct
    # templates; an overflowing frame's candidates would be truncated
    assert not bool(out["bench"][0]["overflow"]), "candidate caps overflowed"

    def run(n):
        out = None
        for _ in range(n):
            out = once()
        jax.block_until_ready(jax.tree_util.tree_leaves(out))

    return _min_of(run, iters)


def _measure_case1(iters: int = 40):
    """Real-data cell (SURVEY.md §6): the upstream case1 angle demo —
    361 rotation templates x 128 features on its committed test frame,
    the bank rebuilt by the bit-exact trainer from the committed training
    image and mask (tests/golden_utils.py:case1_detector). Returns
    (ms/frame, dispatch counts, coarse scorer tag)."""
    import os
    import sys

    tests_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests")
    sys.path.insert(0, tests_dir)
    try:
        from golden_utils import case1_detector, load_mat
    finally:
        sys.path.remove(tests_dir)
    import jax

    from shape_based_matching_tpu.utils import dispatch

    det = case1_detector()
    img = jax.device_put(load_mat("case1_img.bin"))
    # the default caps hold this frame's 123 candidates and 46 distinct
    # templates (counted on the CPU backend)
    ms = _timed_batch(det, img[None], 90.0, iters, caps=(256, 64))
    # dispatch audit alongside the wall number: a swing in ms/frame is
    # then attributable to the device or to a grown dispatch count
    with dispatch.measure(transfers=True) as counts:
        out = det.match_batch(img[None], 90.0, as_matches=False)
        jax.block_until_ready(out)
    return ms, counts, det.coarse_route()


_METRICS = {
    "case1": lambda: _measure_case1(),
    "masked360": lambda: _measure_masked(360),
    "e2e360": lambda: _measure(360),
    "e2e1000": lambda: _measure(1000),
    "e2e10000": lambda: _measure(10000, iters=30),
    "e2e360_16ori": lambda: _measure_e2e_16ori(360),
    "fps_b8": lambda: _measure_throughput(360, 8),
    "match1000x128": lambda: _measure_wide(1000, 128),
    "wide8191": lambda: _measure_wide(8, 8191, dense=True, size=768),
    "wide1000x256": lambda: _measure_wide(1000, 256, dense=True,
                                          size=256),
    "train_sweep": lambda: _measure_train_sweep(128, 256),
    "bank_build_10k": lambda: _measure_bank_build(10000),
    "icp_refine": lambda: _measure_icp(64),
    "production_batch": lambda: _measure_production_batch(1000, 128),
    "production_onecall": lambda: _measure_production_onecall(1000, 128),
    "production_stream": lambda: _measure_production_stream(1000, 128),
    "production_device": lambda: _measure_production_device(1000, 128),
}

# Detail metrics in cheapest-first order, with a rough warm-cache cost
# estimate (s) used to decide whether a metric still fits the budget.
# Estimates are deliberately generous (subprocess import + compile-cache
# hits + measurement loops); a metric is skipped when the remaining
# budget is below its estimate, and hard-killed at the remaining budget
# if it overruns anyway.
_DETAIL_ORDER = [
    ("e2e360", 35),
    ("case1", 35),
    ("masked360", 45),
    ("match1000x128", 45),
    ("wide1000x256", 45),
    ("fps_b8", 45),
    ("icp_refine", 40),
    ("e2e360_16ori", 45),
    ("wide8191", 60),
    ("e2e10000", 60),
    ("production_device", 60),
    ("production_onecall", 60),
    ("production_stream", 60),
    ("production_batch", 60),
    ("train_sweep", 60),
    ("bank_build_10k", 90),
]


def _budget_s() -> float:
    import os

    return float(os.environ.get("SBM_BENCH_BUDGET_S", "480"))


def _remaining_s() -> float:
    return _budget_s() - (time.monotonic() - _T0)


def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown (nvidia-smi unavailable)"


def _device_record() -> dict:
    """Platform, device kind and count of this (metric) process; raises
    when the first device is not a GPU — a CPU run is never recorded."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench measures on a GPU only; found "
                           f"{dev.platform} ({dev.device_kind})")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _run_metric_subprocess(name: str, timeout_s: float | None = None):
    """Run one metric in a fresh python process; returns (value, device
    record)."""
    import os
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--metric", name],
        capture_output=True, text=True, timeout=timeout_s,
        cwd=os.path.dirname(os.path.abspath(__file__)) or ".")
    if out.returncode != 0:
        raise RuntimeError(f"metric {name} failed:\n{out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    return rec["value"], rec["device"]


def _detail_from_vals(vals: dict, skipped: list) -> dict:
    """Assemble BENCH_DETAIL from whichever metrics have finished."""
    detail = {}
    ms_1000 = vals.get("e2e1000")
    if ms_1000 is not None:
        detail["match_1024x1024_1000templates_e2e_ms"] = round(ms_1000, 3)
        detail["vs_baseline_1000"] = round(BASELINE_1000_MS / ms_1000, 2)
        detail["north_star_under_5ms"] = ms_1000 < 5.0

    def put(key, value, digits):
        if value is not None:
            detail[key] = round(value, digits)

    ms_masked, ms_unmasked_b1 = vals.get("masked360") or (None, None)
    put("match_1024x1024_360templates_e2e_ms", vals.get("e2e360"), 3)
    put("match_1024x1024_360templates_masked_e2e_ms", ms_masked, 3)
    put("match_1024x1024_360templates_b1_e2e_ms", ms_unmasked_b1, 3)
    put("match_1024x1024_10000templates_e2e_ms", vals.get("e2e10000"), 3)
    put("throughput_1024x1024_360templates_b8_fps", vals.get("fps_b8"), 1)
    def put_wide(name, key_ms, key_nf, key_route):
        if vals.get(name) is not None:
            ms, nf, route = vals[name]
            detail[key_ms] = round(ms, 3)
            detail[key_nf] = int(nf)
            detail[key_route] = route

    put_wide("match1000x128", "match_1024x1024_1000t_128f_e2e_ms",
             "match_1000t_128f_coarse_nfeat",
             "match_1000t_128f_coarse_route")
    put_wide("wide8191", "match_1024x1024_8t_8191f_e2e_ms",
             "match_8t_8191f_coarse_nfeat",
             "match_8t_8191f_coarse_route")
    put_wide("wide1000x256", "match_1024x1024_1000t_256f_dense_e2e_ms",
             "match_1000t_256f_coarse_nfeat",
             "match_1000t_256f_coarse_route")
    put("match_1024x1024_360templates_16ori_e2e_ms",
        vals.get("e2e360_16ori"), 3)
    if (vals.get("e2e360_16ori") is not None
            and vals.get("e2e360") is not None):
        detail["ratio_16ori_vs_8ori_360t"] = round(
            vals["e2e360_16ori"] / vals["e2e360"], 3)
    put("train_sweep_128x256px_templates_per_s",
        vals["train_sweep"][0] if vals.get("train_sweep") else None, 1)
    put("bank_build_10000templates_s", vals.get("bank_build_10k"), 2)
    put("icp_refine_64matches_1024x1024_e2e_ms", vals.get("icp_refine"), 3)
    put("production_batch_1000t_128f_match_icp_ms",
        vals.get("production_batch"), 3)
    put("production_onecall_1000t_128f_match_icp_ms",
        vals.get("production_onecall"), 3)
    put("production_stream_1000t_128f_match_icp_ms",
        vals.get("production_stream"), 3)
    put("production_device_1000t_128f_match_icp_ms",
        vals.get("production_device"), 3)
    if vals.get("e2e360") is not None:
        detail["vs_baseline_360"] = round(
            BASELINE_360_MS / vals["e2e360"], 2)
    case1 = vals.get("case1")
    if case1 is not None:
        ms, counts, route = case1
        detail["case1_361templates_golden_e2e_ms"] = round(ms, 3)
        detail["case1_dispatch_counts"] = counts
        detail["case1_coarse_route"] = route
    if skipped:
        detail["skipped"] = sorted(skipped)
    return detail


def main():
    import sys

    global _T0
    _T0 = time.monotonic()

    if len(sys.argv) >= 3 and sys.argv[1] == "--metric":
        from shape_based_matching_tpu.utils.compile_cache import (
            enable_compile_cache)

        enable_compile_cache()
        device = _device_record()
        val = _METRICS[sys.argv[2]]()
        print(json.dumps({"value": val, "device": device}))
        return
    in_process = "--in-process" in sys.argv  # debugging escape hatch

    def run(name, timeout_s=None):
        if in_process:
            return _METRICS[name](), _device_record()
        return _run_metric_subprocess(name, timeout_s)

    # 1. Primary metric, then IMMEDIATELY the required single JSON line:
    #    stdout carries exactly this one line, flushed, so a timeout
    #    anywhere later still leaves a complete record. A failure here
    #    (no GPU, or the metric itself) ends the run with an error.
    import os

    primary_timeout = float(os.environ.get(
        "SBM_BENCH_PRIMARY_TIMEOUT_S", "420"))
    ms_1000, device = run("e2e1000", timeout_s=(primary_timeout if not
                                                in_process else None))
    card = _card()
    print(json.dumps({
        "metric": "match_1024x1024_1000templates_e2e_ms",
        "value": round(ms_1000, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_1000_MS / ms_1000, 2),
        "device": device,
        "card": card,
    }), flush=True)
    # Detail budget epoch: starts HERE (not at process start) so a slow
    # primary cannot starve the detail metrics.
    _T0 = time.monotonic()

    # 2. Detail metrics, cheapest-first, inside the wall-clock budget.
    vals = {"e2e1000": ms_1000}
    skipped = []
    detail_path = "BENCH_DETAIL.json"

    def write_detail():
        detail = _detail_from_vals(vals, skipped)
        detail["device"] = device
        detail["card"] = card
        with open(detail_path, "w") as f:
            json.dump(detail, f, indent=2)

    write_detail()
    for name, est_s in _DETAIL_ORDER:
        remaining = _remaining_s()
        if remaining < est_s:
            skipped.append(name)
            print(f"bench: skipping {name} (est {est_s}s, "
                  f"{remaining:.0f}s of budget left)", file=sys.stderr)
        else:
            try:
                t0 = time.monotonic()
                vals[name], _ = run(name, timeout_s=remaining)
                print(f"bench: {name} took "
                      f"{time.monotonic() - t0:.1f}s (est {est_s}s)",
                      file=sys.stderr)
            except Exception as e:  # noqa: BLE001 — detail is optional
                skipped.append(name)
                print(f"bench: metric {name} failed, skipping: "
                      f"{str(e)[-1500:]}", file=sys.stderr)
        write_detail()


if __name__ == "__main__":
    main()
