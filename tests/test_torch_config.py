"""The port's settings (`core/config.py` on its own `core/yaml_subset.py`),
display probes, `ProgramConfig.from_settings` and `effective_compute_dtype`,
against the JAX package and PyYAML on the CPU.

A CUDA host need not have PyYAML, so the port reads and writes YAML itself.
Its reader is held to `yaml.safe_load` on the repository's settings.yaml, on
hand-written files (comments, flow sequences, quoted scalars, YAML 1.1
typing, a nested `Model List` as the reference GUI writes it) and on
mappings that hypothesis draws and `yaml.safe_dump` writes (text keys that
fit on one line: an empty or multi-line key is written as a complex `?` key,
which the port refuses); its writer is read back by `yaml.safe_load`.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import pytest
import torch
import yaml
from hypothesis import HealthCheck, example, given, settings as hsettings, strategies as st

import desktop2stereo_tpu.core.config as J_config
import desktop2stereo_tpu.core.display as J_display
import desktop2stereo_tpu.core.registry as J_registry
import desktop2stereo_tpu.pipeline.programs as J_programs
import desktop2stereo_tpu_torch.core.config as T_config
import desktop2stereo_tpu_torch.core.display as T_display
import desktop2stereo_tpu_torch.core.registry as T_registry
import desktop2stereo_tpu_torch.pipeline.programs as T_programs
from desktop2stereo_tpu_torch.core import yaml_subset
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_SETTINGS = os.path.join(ROOT, "settings.yaml")

# A reference-GUI style file: the GUI's keys, foreign keys, and the nested
# `Model List` mapping of per-model menus (reference settings.yaml:5-314)
REFERENCE_STYLE = {
    "Depth Model": "Depth-Anything-V2-Large",
    "Model List": {
        "Depth-Anything-V2-Small": {"resolutions": [196, 238, 294, 336, 392, 448, 518],
                                    "repo": "depth-anything/Depth-Anything-V2-Small-hf"},
        "DA3-LARGE": {"resolutions": [182, 224, 280], "metric": True},
        "InfiniDepth-Base": {"resolutions": [192, 240], "note": "patch 16: 'p16'"},
    },
    "Depth Strength": 3.5,
    "Depth Resolution": 518,
    "Anti-aliasing": 2,
    "Foreground Scale": 5,
    "IPD": 0.064,
    "Convergence": -0.25,
    "Display Mode": "Full-SBS",
    "FP16": True,
    "Run Mode": "OpenXR Link",
    "Processing Resolution": 2160,
    "Set FPS": 72.0,
    "Show FPS": False,
    "Fill 16:9": True,
    "Streamer Port": 1122,
    "Stream Quality": 85,
    "Temporal Smooth": False,
    "Language": "中文",
    "Capture Mode": "Window",
    "Window Title": "VLC media player",
    "Monitor Index": "none",
    "Crop Mode": "Auto",
    "Stream Key": "live/d2s",
    "Recent Windows": ["a: b", "#hash", "", "yes", "0x10", "1e3"],
    "Empty": {},
    "Nothing": None,
}

HAND_WRITTEN = """\
# desktop2stereo settings, edited by hand
Depth Model: Depth-Anything-V2-Base   # a trailing comment
Depth Strength: 2.5
Depth Resolution: 0x1F8
IPD: .064
Convergence: -1_0.0
Display Mode: 'Half-TAB'
Run Mode: "MJPEG Streamer"
FP16: yes
Show FPS: Off
Temporal Smooth: TRUE
Set FPS: 1.0e+2
Streamer Port: 1_122
Hex: 0x1F
Octal: 017
Binary: 0b101
Sexagesimal: 1:30
SexFloat: 1:30.5
Not A Float: 1e3
Not Either: 1.0e3
Also Text: -.5
Tilde: ~
Empty Value:
Null Text: NULL
Infinity: -.inf
Flow: [196, 238, 'x, y', "z", [1, 2], {a: 1, b: [true]}]
Flow Map: {k: v, n: 1}
Multi Flow: [1,
  2, 3]
Block List:
- one
- two: 2
  three: 3
- - nested
  - list
Indented List:
  - a
  - b
Quoted: 'it''s a "test"'
Escapes: "tab\\there \\u00e9 \\x41 \\\\ \\" end"
Folded plain: first line
  second line

  after a blank
Folded quoted: 'first
  second'
Colon in text: a:b http://x
Hash in text: a#b
Nested:
  Inner:
    deeper: [1]
    other: text
  Back: 2
"""


def _same(a, b):
    """Equal with types: True is not 1, 1.0 is not 1; key order kept."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and a != a:
        return b != b
    return a == b


def _fields(settings):
    return {f.name: getattr(settings, f.name) for f in dataclasses.fields(settings)}


def _assert_settings_equal(t, j):
    assert _same(_fields(t), _fields(j))
    assert _same(t.extra, j.extra)
    assert (t.foreground_scale, t.aa_strength) == (j.foreground_scale, j.aa_strength)


# ---- the YAML reader ---------------------------------------------------------

@pytest.mark.parametrize("text", [
    open(REPO_SETTINGS, encoding="utf-8").read(),
    HAND_WRITTEN,
    yaml.safe_dump(REFERENCE_STYLE, allow_unicode=True, sort_keys=False),
    yaml.safe_dump(REFERENCE_STYLE, allow_unicode=False, sort_keys=False),
    "---\na: 1\n...\n",
    "",
    "# only a comment\n",
    "a: 1\r\nb: [x]\r\n",
    "- 1\n- 2\n",
    "plain document\n",
], ids=["repo_settings", "hand_written", "reference_style_unicode",
        "reference_style_ascii", "markers", "empty", "comment", "crlf", "sequence",
        "scalar"])
def test_reader_matches_safe_load(text):
    assert _same(yaml_subset.load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: !!str 1\n",
    "a: |\n  block\n",
    "a: >\n  folded\n",
    "a: 1\n---\nb: 2\n",
    "? complex\n: key\n",
    "%YAML 1.1\n---\na: 1\n",
    "a: 2001-12-14\n",
    "<<: {a: 1}\n",
    "a:\n\tb: 1\n",
    "a: b: c\n",
    "a: 'unterminated\n",
    "a:\n  - 1\n - 2\n",
    "a: [1, 2\n",
    "a: \u2028\n",
], ids=["anchor_alias", "tag", "literal", "folded", "two_documents", "complex_key",
        "directive", "timestamp", "merge_key", "tab_indent", "nested_inline_mapping",
        "unterminated", "bad_indentation", "unclosed_flow", "line_separator"])
def test_reader_refuses_what_it_does_not_cover(text):
    with pytest.raises(ValueError):
        yaml_subset.load(text)


_TEXT = st.text(st.characters(blacklist_categories=("Cs",),
                              blacklist_characters="\u2028\u2029"), max_size=120)
_KEY = st.text(st.characters(blacklist_categories=("Cs",),
                             blacklist_characters="\n\r\x85\u2028\u2029"),
               min_size=1, max_size=30)
_SCALARS = st.none() | st.booleans() | st.integers() | st.floats(allow_nan=False) | _TEXT
_VALUES = st.recursive(_SCALARS, lambda inner: st.lists(inner, max_size=4)
                       | st.dictionaries(_KEY, inner, max_size=4), max_leaves=12)
_MAPPINGS = st.dictionaries(_KEY, _VALUES, max_size=6)


@hsettings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_MAPPINGS, st.booleans())
def test_reader_matches_safe_load_on_safe_dump_output(mapping, allow_unicode):
    text = yaml.safe_dump(mapping, allow_unicode=allow_unicode, sort_keys=False)
    assert _same(yaml_subset.load(text), yaml.safe_load(text))


@hsettings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(_MAPPINGS)
@example({"0": "A\n"})
def test_writer_reads_back_under_safe_load(mapping):
    text = yaml_subset.dump(mapping)
    assert _same(yaml.safe_load(text), mapping)
    assert _same(yaml_subset.load(text), mapping)


def test_writer_block_style_keeps_order():
    text = yaml_subset.dump(REFERENCE_STYLE)
    assert "{" not in text.replace("Empty: {}", "")  # block style, bar the empty mapping
    assert _same(yaml.safe_load(text), REFERENCE_STYLE)
    assert list(yaml.safe_load(text)) == list(REFERENCE_STYLE)


# ---- settings files against the JAX package -------------------------------------

@pytest.fixture
def settings_files(tmp_path):
    """name → path: the repository's settings.yaml, a GBK file, a
    reference-GUI style file with a nested Model List, and the hand-written
    one."""
    files = {"repo": tmp_path / "repo.yaml", "gbk": tmp_path / "gbk.yaml",
             "reference_style": tmp_path / "ref.yaml", "hand_written": tmp_path / "hand.yaml"}
    shutil.copy(REPO_SETTINGS, files["repo"])
    files["gbk"].write_bytes(
        "Depth Model: Depth-Anything-V2-Small\nLanguage: 中文界面\nIPD: 0.07\n"
        "Window Title: 视频播放器\n".encode("gbk"))
    files["reference_style"].write_text(
        yaml.safe_dump(REFERENCE_STYLE, allow_unicode=True, sort_keys=False), encoding="utf-8")
    files["hand_written"].write_text(HAND_WRITTEN, encoding="utf-8")
    return files


@pytest.mark.parametrize("name", ["repo", "gbk", "reference_style", "hand_written"])
def test_load_settings_matches_jax(settings_files, name):
    path = settings_files[name]
    _assert_settings_equal(T_config.load_settings(path), J_config.load_settings(path))


def test_gbk_file_decodes_as_gbk(settings_files):
    s = T_config.load_settings(settings_files["gbk"])
    assert s.extra["Language"] == "中文界面" and s.ipd == 0.07


@pytest.mark.parametrize("name", ["repo", "gbk", "reference_style"])
def test_save_settings_merge_matches_jax(settings_files, tmp_path, name):
    """Foreign keys of the existing file (the nested Model List too) survive
    the merge; the file the port writes reads, under yaml.safe_load, as the
    one the JAX package writes."""
    src = settings_files[name]
    t_path, j_path = tmp_path / "t.yaml", tmp_path / "j.yaml"
    shutil.copy(src, t_path)
    shutil.copy(src, j_path)
    base = J_config.load_settings(src)
    T_config.save_settings(T_config.load_settings(src).replace(depth_strength=2.5,
                                                               display_mode="Anaglyph"), t_path)
    J_config.save_settings(base.replace(depth_strength=2.5, display_mode="Anaglyph"), j_path)
    t_data = yaml.safe_load(t_path.read_text(encoding="utf-8"))
    j_data = yaml.safe_load(j_path.read_text(encoding="utf-8"))
    assert _same(t_data, j_data)
    assert t_data["Depth Strength"] == 2.5
    for key in base.extra:
        assert key in t_data, key
    _assert_settings_equal(T_config.load_settings(t_path), J_config.load_settings(j_path))


@pytest.mark.parametrize("fields,extra", [
    ({"model": "A\n"}, {}),
    ({"run_mode": "a b\n"}, {}),
    ({}, {"Model Names": ["A\n"]}),
    ({}, {"Window Title": "title\r\n"}),
], ids=["value", "value-with-space", "list-item", "foreign-crlf"])
def test_save_settings_keeps_a_trailing_newline_as_jax(tmp_path, fields, extra):
    """A string that ends in a line break is written quoted, so it reads
    back whole, as the JAX package's `yaml.safe_dump` writes it."""
    t_path, j_path = tmp_path / "t.yaml", tmp_path / "j.yaml"
    T_config.save_settings(dataclasses.replace(T_config.Settings(**fields), extra=extra), t_path)
    J_config.save_settings(dataclasses.replace(J_config.Settings(**fields), extra=extra), j_path)
    t_data = yaml.safe_load(t_path.read_text(encoding="utf-8"))
    assert _same(t_data, yaml.safe_load(j_path.read_text(encoding="utf-8")))
    for key, value in extra.items():
        assert _same(t_data[key], value)
    t_back, j_back = T_config.load_settings(t_path), J_config.load_settings(j_path)
    _assert_settings_equal(t_back, j_back)
    assert all(getattr(t_back, k) == v for k, v in fields.items())
    assert _same(t_back.extra, extra)


def test_save_settings_to_a_new_file(tmp_path):
    s = T_config.Settings(model="Depth-Anything-V2-Large", fps=144.0, fill_16_9=True)
    T_config.save_settings(s, tmp_path / "new.yaml")
    _assert_settings_equal(T_config.load_settings(tmp_path / "new.yaml"),
                           J_config.load_settings(tmp_path / "new.yaml"))


@pytest.mark.parametrize("name", ["repo", "gbk", "reference_style"])
def test_update_yaml_matches_jax(settings_files, tmp_path, name):
    updates = {"Depth Strength": 4.0, "Environment Model": "Theater", "New List": [1, "two"]}
    t_path, j_path = tmp_path / "t.yaml", tmp_path / "j.yaml"
    shutil.copy(settings_files[name], t_path)
    shutil.copy(settings_files[name], j_path)
    T_config.update_yaml(t_path, updates)
    J_config.update_yaml(j_path, updates)
    assert _same(yaml.safe_load(t_path.read_text(encoding="utf-8")),
                 yaml.safe_load(j_path.read_text(encoding="utf-8")))


def test_update_yaml_on_a_missing_file(tmp_path):
    T_config.update_yaml(tmp_path / "none.yaml", {"a": 1})
    assert yaml.safe_load((tmp_path / "none.yaml").read_text()) == {"a": 1}


@pytest.fixture
def fake_monitor(monkeypatch):
    """A 2560x1440 monitor at 144 Hz for both packages' display probes."""
    for mod in (J_display, T_display):
        monkeypatch.setattr(mod, "get_monitor_size", lambda monitor_index=None: (2560, 1440))
        monkeypatch.setattr(mod, "get_refresh_rate", lambda monitor_index=None: 144.0)


@pytest.mark.parametrize("run_mode", ["Local Viewer", "3D Monitor", "RTMP Streamer",
                                      "MJPEG Streamer", "OpenXR Link"])
@pytest.mark.parametrize("display_mode", ["Half-SBS", "Full-TAB"])
def test_auto_resolution_and_fps_match_jax(fake_monitor, run_mode, display_mode):
    data = {"Processing Resolution": "Auto", "Set FPS": "auto", "Run Mode": run_mode,
            "Display Mode": display_mode}
    t, j = T_config.Settings.from_yaml_dict(data), J_config.Settings.from_yaml_dict(data)
    _assert_settings_equal(t, j)
    assert t.fps == 144.0 and t.extra["Processing Resolution"] == "Auto"


@pytest.mark.parametrize("value", [1080, "720", " 1440 ", "Auto", "", None, 0, "bogus"])
def test_compute_output_resolution_matches_jax(fake_monitor, value):
    for run_mode in ("Local Viewer", "Streamer"):
        for mode in ("Half-SBS", "Full-TAB"):
            assert (T_display.compute_output_resolution(value, mode, run_mode)
                    == J_display.compute_output_resolution(value, mode, run_mode))


def test_list_monitors_parses_xrandr_as_jax(monkeypatch):
    sample = ("Monitors: 2\n 0: +*eDP-1 1920/309x1080/173+0+0  eDP-1\n"
              " 1: +HDMI-1 2560/597x1440/336+1920+0  HDMI-1\n")

    class Result:
        stdout = sample

    for mod in (J_display, T_display):
        monkeypatch.setattr(mod.subprocess, "run", lambda *a, **k: Result())
    assert T_display.list_monitors() == J_display.list_monitors()
    assert T_display.monitor_rect(1) == (1920, 0, 2560, 1440)
    assert T_display.monitor_rect(5) is None


# ---- ProgramConfig.from_settings and the compute dtype ------------------------------

@pytest.mark.parametrize("quality", ["high", "fast"])
@pytest.mark.parametrize("name", ["repo", "reference_style", "hand_written"])
def test_program_config_from_settings_matches_jax(settings_files, name, quality):
    t = T_programs.ProgramConfig.from_settings(T_config.load_settings(settings_files[name]),
                                               quality=quality)
    j = J_programs.ProgramConfig.from_settings(J_config.load_settings(settings_files[name]),
                                               quality=quality)
    assert _same(dataclasses.asdict(t), dataclasses.asdict(j))


@pytest.mark.parametrize("force_fp32", [False, True])
@pytest.mark.parametrize("policy", ["bf16", "f32"])
def test_effective_compute_dtype_matches_jax(force_fp32, policy):
    spec = dict(name="m", family="depth_anything", variant="vits", hf_repo="none",
                force_fp32=force_fp32)
    t = T_registry.effective_compute_dtype(
        T_registry.ModelSpec(**spec), torch.bfloat16 if policy == "bf16" else torch.float32,
        quiet=True)
    j = J_registry.effective_compute_dtype(
        J_registry.ModelSpec(**spec), jnp.bfloat16 if policy == "bf16" else jnp.float32,
        quiet=True)
    assert str(t).split(".")[-1] == jnp.dtype(j).name
    assert t == (torch.float32 if force_fp32 or policy == "f32" else torch.bfloat16)
