"""App-layer utilities: timer, SSIM/CCORR verification, viz, YAML roundtrip."""

import numpy as np
import pytest

from shape_based_matching_tpu.utils.timer import CSVStat, Timer
from shape_based_matching_tpu.utils import verify, viz
from shape_based_matching_tpu.models.shape_info import (ShapeInfo,
                                                        ShapeInfoProducer)


def test_timer_accumulation():
    t = Timer()
    t.record("A")
    t.record("A")
    t.record("B")
    rec = t.records
    assert set(rec) == {"A", "B"}
    csv = t.display_csv(["A", "B"], first_column="frame0")
    assert csv.startswith("frame0,")


def test_csv_stat():
    s = CSVStat(["m", "n"])
    s.append([1.0, 10.0])
    s.append([3.0, 20.0])
    assert s.get_mins() == [1.0, 10.0]
    assert s.get_maxes() == [3.0, 20.0]
    assert s.get_mean() == [2.0, 15.0]
    assert "mean,2,15" in s.summary_csv()


def test_ssim_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    a = rng.randint(0, 256, (64, 64), np.uint8)
    noise = rng.randint(-20, 20, (64, 64))
    b = np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)

    mean_ours, _ = verify.ssim(a, b)
    # cv2-based replica of evalSSIM (utils.cpp:455-523)
    C1, C2 = 6.5025, 58.5225
    x = a.astype(np.float32)
    y = b.astype(np.float32)
    blur = lambda im: cv2.GaussianBlur(im, (11, 11), 1.5)
    mu1, mu2 = blur(x), blur(y)
    s1 = blur(x * x) - mu1 * mu1
    s2 = blur(y * y) - mu2 * mu2
    s12 = blur(x * y) - mu1 * mu2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))
    want = m[5:, 5:].mean()
    assert abs(float(mean_ours) - float(want)) < 1e-4


def test_ccorr_normed_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    img = rng.randint(0, 256, (48, 64), np.uint8)
    templ = img[10:30, 20:44]
    want = cv2.matchTemplate(img, templ, cv2.TM_CCORR_NORMED)
    got = np.asarray(verify.match_template_ccorr_normed(img, templ))
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert got[10, 20] > 0.999


def test_verify_match_gate(rng):
    scene = rng.randint(0, 40, (64, 64), np.uint8)
    templ = rng.randint(0, 256, (16, 16), np.uint8)
    scene[8:24, 8:24] = templ
    ok, score = verify.verify_match_ccorr(scene, (8, 8), templ, 0.8)
    assert ok and score > 0.99
    ok2, score2 = verify.verify_match_ccorr(scene, (40, 40), templ, 0.8)
    assert not ok2


def test_histograms(rng):
    img = rng.randint(0, 256, (32, 32), np.uint8)
    h = verify.calc_histogram(img)
    assert abs(h.sum() - 1.0) < 1e-9
    assert verify.comp_histogram(h, h) == pytest.approx(1.0)


def test_rotate_scale_image_90():
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    r90 = verify.rotate_scale_image(img, 1.0, 90)
    cv2 = pytest.importorskip("cv2")
    np.testing.assert_array_equal(r90, cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE))
    r270 = verify.rotate_scale_image(img, 1.0, 270)
    np.testing.assert_array_equal(
        r270, cv2.rotate(img, cv2.ROTATE_90_COUNTERCLOCKWISE))


def test_rotate_scale_rect_matches_reference_geometry():
    # 90-degree rotation of a rect inside a 100x60 image
    rect = (10, 20, 30, 15)
    out = verify.rotate_scale_rect(rect, 1.0, 90.0, (100, 60))
    # rotating CW by 90: new image is 60x100; verify by rotating corners
    x, y, w, h = out
    assert w in (30, 15) or h in (30, 15)


def test_display_quantized_colors():
    q = np.array([[0, 1], [128, 7]], np.uint8)
    c = viz.display_quantized(q)
    assert tuple(c[0, 0]) == (0, 0, 0)
    assert tuple(c[0, 1]) == (55, 55, 55)
    assert tuple(c[1, 0]) == (230, 230, 230)
    assert tuple(c[1, 1]) == (0, 255, 0)  # non-single-bit -> green


def test_shape_info_save_load(tmp_path):
    p = str(tmp_path / "info.yaml")
    ShapeInfoProducer.save_infos(
        [ShapeInfo(0.0, 1.0), ShapeInfo(45.0, 0.5)], p)
    infos = ShapeInfoProducer.load_infos(p)
    assert [(i.angle, i.scale) for i in infos] == [(0.0, 1.0), (45.0, 0.5)]


def test_load_reference_infos(tmp_path):
    """The case1 angle demo's info list (angle_range [0, 360], 1° steps,
    as the reference writes to test_info.yaml) survives save/load."""
    producer = ShapeInfoProducer(np.zeros((16, 16), np.uint8))
    producer.angle_range = [0.0, 360.0]
    producer.angle_step = 1.0
    made = producer.produce_infos()
    p = str(tmp_path / "test_info.yaml")
    ShapeInfoProducer.save_infos(made, p)
    infos = ShapeInfoProducer.load_infos(p)
    assert len(infos) == 361
    assert infos[5].angle == 5.0
    assert [(i.angle, i.scale) for i in infos] == [
        (i.angle, i.scale) for i in made]
