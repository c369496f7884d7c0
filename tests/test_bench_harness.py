"""Structure tests for bench.py's harness.

The north-star line is stdout's first (and only JSON) line, it names the
device and the card, detail metrics run under SBM_BENCH_BUDGET_S,
BENCH_DETAIL.json is valid after every step with a `skipped` list, and a
metric process refuses to measure on a host without a GPU.

No GPU: metrics and the device record are stubbed in-process.
"""

import io
import json
import sys

import pytest

import bench


_FAKE_DEVICE = {"platform": "gpu", "kind": "NVIDIA H100", "count": 1}


@pytest.fixture
def stub_bench(monkeypatch, tmp_path):
    """Replace the real metrics with instant stubs and cd to tmp."""
    def _boom():
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "_METRICS", {
        "e2e1000": lambda: 2.5,
        "e2e360": lambda: 2.0,
        "failing": _boom,
    })
    monkeypatch.setattr(bench, "_DETAIL_ORDER",
                        [("e2e360", 1), ("failing", 1)])
    monkeypatch.setattr(bench, "_device_record", lambda: _FAKE_DEVICE)
    monkeypatch.setattr(bench, "_card", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(sys, "argv", ["bench.py", "--in-process"])
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _run_main(monkeypatch):
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    bench.main()
    return out.getvalue()


def test_primary_line_is_first_and_only_stdout(stub_bench, monkeypatch):
    stdout = _run_main(monkeypatch)
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, f"stdout must be exactly one line: {lines}"
    rec = json.loads(lines[0])
    assert rec["metric"] == "match_1024x1024_1000templates_e2e_ms"
    assert rec["value"] == 2.5
    assert rec["unit"] == "ms"
    assert rec["vs_baseline"] == round(bench.BASELINE_1000_MS / 2.5, 2)
    assert rec["device"] == _FAKE_DEVICE
    assert rec["card"] == "NVIDIA H100, 700.00 W"


def test_detail_written_with_skipped_failures(stub_bench, monkeypatch):
    _run_main(monkeypatch)
    detail = json.loads((stub_bench / "BENCH_DETAIL.json").read_text())
    assert detail["match_1024x1024_1000templates_e2e_ms"] == 2.5
    assert detail["match_1024x1024_360templates_e2e_ms"] == 2.0
    assert detail["skipped"] == ["failing"]


def test_budget_zero_skips_all_detail_metrics(stub_bench, monkeypatch):
    monkeypatch.setenv("SBM_BENCH_BUDGET_S", "0")
    stdout = _run_main(monkeypatch)
    rec = json.loads(stdout.strip().splitlines()[0])
    assert rec["value"] == 2.5  # primary still runs and prints
    detail = json.loads((stub_bench / "BENCH_DETAIL.json").read_text())
    assert sorted(detail["skipped"]) == ["e2e360", "failing"]
    assert "match_1024x1024_360templates_e2e_ms" not in detail


def test_detail_order_covers_all_optional_metrics():
    names = {n for n, _ in bench._DETAIL_ORDER}
    assert names == set(bench._METRICS) - {"e2e1000"}


def test_metric_process_refuses_cpu_host():
    """The real device record on the CPU test backend must refuse."""
    with pytest.raises(RuntimeError, match="GPU only"):
        bench._device_record()


def test_parent_never_imports_jax():
    """The bench parent stays off JAX so only its metric subprocess
    holds the card."""
    import subprocess

    code = ("import sys, bench; "
            "assert 'jax' not in sys.modules, 'bench imported jax'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=bench.__file__.rsplit("/", 1)[0] or ".")


def test_scene_caps_cover_the_measured_counts():
    from shape_based_matching_tpu.utils.synthetic import scene_caps

    assert scene_caps(8) == (256, 64)          # never below the defaults
    assert scene_caps(360) == (512, 64)
    assert scene_caps(1000) == (1024, 128)     # 413 / 64 measured
    assert scene_caps(10000) == (16384, 1024)  # 3639 / 605 measured


@pytest.mark.parametrize("num_templates", [360, 1000])
def test_entry_caps_hold_the_flagship_scene(num_templates):
    """The timed flagship step returns the exact match set: its scene
    stays within the step's candidate and distinct-template caps."""
    import jax
    import numpy as np

    from __graft_entry__ import entry

    fn, args = entry(num_templates=num_templates)
    k, x, y, sc, valid, overflow, n_above, n_distinct = jax.jit(fn)(*args)
    assert not bool(overflow), (int(n_above), int(n_distinct))
    assert int(np.asarray(valid).sum()) > 0


def _tiny_detector():
    import numpy as np

    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ = build_rotated_detector(8, 63, size=96, cache=False)
    frames = np.stack([synthetic_scene(128, 128, templ, n_instances=2,
                                       seed=s) for s in (1, 2)])
    return det, frames


def test_timed_batch_refuses_an_overflowing_frame():
    det, frames = _tiny_detector()
    with pytest.raises(RuntimeError, match="overflowed the caps"):
        bench._timed_batch(det, frames, 50.0, iters=1, caps=(1, 1))


def test_timed_batch_times_frames_within_the_caps():
    det, frames = _tiny_detector()
    ms = bench._timed_batch(det, frames, 50.0, iters=1)
    assert ms > 0
