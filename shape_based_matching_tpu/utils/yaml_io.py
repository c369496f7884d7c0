"""OpenCV-FileStorage-compatible YAML I/O for templates and detector settings.

The reference persists templates as OpenCV YAML (optionally gzipped):
schema per class (line2Dup.cpp:1507-1575, Template::write :86-113):

    %YAML:1.0
    ---
    class_id: <str>
    pyramid_levels: <int>
    template_pyramids:
       - template_id: <int>
         templates:
            - width/height/tl_x/tl_y: int
              scale: float           (fork additions; absent in upstream files)
              orientation: float
              tagFieldID: int
              fiducial_src: str
              pyramid_level: int
              features: [[x, y, label], ...]

and detector settings (line2Dup.cpp:1489-1505, test_jabil.cpp:113-117):
pyramid_levels, T (list), type/weak_threshold/num_features/strong_threshold,
optionally templates_dir + classes. We parse with PyYAML after stripping the
"%YAML:1.0" directive, and emit OpenCV-style YAML so files round-trip into
the C++ reference. Missing keys default like cv::FileNode (0 / 0.0 / "").
"""

from __future__ import annotations

import gzip
import os
import re
from typing import Any


def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path, "r") as f:
        return f.read()


def _write_text(path: str, text: str) -> None:
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


def load_opencv_yaml(path: str) -> dict:
    """Load an OpenCV YAML file into plain Python structures."""
    text = _read_text(path)
    # Drop the OpenCV YAML directive; PyYAML rejects "%YAML:1.0".
    text = re.sub(r"^%YAML:[\d.]+\s*\n", "", text)
    # OpenCV writes "!!opencv-matrix" tags in some files; none appear in the
    # template schema, but neutralize them defensively.
    text = text.replace("!!opencv-matrix", "")
    # libyaml parses the 2.4 MB case1 registry in 2.4 s vs pure-python
    # safe_load's 12 s (1-CPU host) with identical output; registry load
    # is on the CLI's critical path, so prefer it when available.
    import yaml  # PyYAML is needed only for persistence, not to match

    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    return yaml.load(text, Loader=loader)


def _fmt_float(v: float) -> str:
    """OpenCV FileStorage float formatting ('1.', '-1.', '9.9600000381469727e-01')."""
    if v == int(v) and abs(v) < 1e15:
        s = f"{int(v)}."
        return s
    return repr(float(v))


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        return _fmt_float(v)
    if isinstance(v, int):
        return str(v)
    s = str(v)
    if s == "" or re.search(r"[:#\[\]{},&*!|>'\"%@`]", s) or s != s.strip():
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


def dump_opencv_yaml(doc: dict, path: str) -> None:
    """Emit OpenCV-FileStorage-style YAML (3-space indent, '-' sequences)."""
    lines = ["%YAML:1.0", "---"]

    def emit(value: Any, indent: int, into: list, inline_key: str | None):
        pad = "   " * indent
        if isinstance(value, dict):
            first = True
            for k, v in value.items():
                if isinstance(v, (dict, list)) and not _is_flat_list(v):
                    into.append(f"{pad}{k}:")
                    emit(v, indent + 1, into, None)
                elif _is_flat_list(v):
                    into.append(f"{pad}{k}: {_flat(v)}")
                else:
                    into.append(f"{pad}{k}: {_fmt_scalar(v)}")
                first = False
        elif isinstance(value, list):
            for item in value:
                if isinstance(item, dict):
                    into.append(f"{pad}-")
                    emit(item, indent + 1, into, None)
                elif _is_flat_list(item):
                    into.append(f"{pad}- {_flat(item)}")
                else:
                    into.append(f"{pad}- {_fmt_scalar(item)}")

    def _is_flat_list(v: Any) -> bool:
        return isinstance(v, list) and all(
            not isinstance(i, (dict, list)) for i in v
        )

    def _flat(v: list) -> str:
        return "[ " + ", ".join(_fmt_scalar(i) for i in v) + " ]"

    emit(doc, 0, lines, None)
    _write_text(path, "\n".join(lines) + "\n")


def class_file_path(fmt: str, class_id: str) -> str:
    """cv::format("%s", class_id) application (line2Dup.cpp:1583)."""
    return fmt % (class_id,) if "%s" in fmt else os.path.join(fmt, class_id)
