"""Typed configuration with settings.yaml round-trip compatibility.

Port of `desktop2stereo_tpu/core/config.py`.  The reference app drives
everything from one ``settings.yaml`` and its GUI writes it back with a
merge-don't-clobber policy that keeps keys it does not understand
(reference utils.py:574-614, 819-907).  Here the same surface is a frozen
dataclass whose loader keeps unknown keys in ``extra``, so a settings file
written by the reference GUI (with its nested ``Model List``) survives a
round trip unchanged.

A CUDA host need not have PyYAML, so the files are read and written by the
port's own `core/yaml_subset.py`.  `DISPLAY_MODES` is in the viewer's
hot-key cycle order, which `ProgramCache.cycle_display_mode` steps through.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from desktop2stereo_tpu_torch.core import yaml_subset

# Map between our field names and the reference's settings.yaml keys
# (reference utils.py:819-907).  Only compute-relevant keys are typed; the
# remainder (GUI language, stream keys, ...) ride along in `extra`.
_YAML_KEYS = {
    "model": "Depth Model",
    "depth_strength": "Depth Strength",
    "depth_resolution": "Depth Resolution",
    "anti_aliasing": "Anti-aliasing",
    "foreground_scale_10": "Foreground Scale",
    "ipd": "IPD",
    "convergence": "Convergence",
    "display_mode": "Display Mode",
    "fp16": "FP16",
    "device_index": "Computing Device",
    "run_mode": "Run Mode",
    "output_resolution": "Processing Resolution",
    "fps": "Set FPS",
    "show_fps": "Show FPS",
    "fill_16_9": "Fill 16:9",
    "streamer_port": "Streamer Port",
    "stream_quality": "Stream Quality",
    "temporal_smooth": "Temporal Smooth",
}

DISPLAY_MODES = (
    "Half-SBS",
    "Full-SBS",
    "Half-TAB",
    "Full-TAB",
    "Anaglyph",
    "Row-Interleaved",
    "Column-Interleaved",
    "Mono",
    "Depth",
)


@dataclass(frozen=True)
class Settings:
    """Full runtime configuration.

    Derived quantities mirror the reference's transforms: the GUI-facing
    ``Foreground Scale`` 0-10 becomes ``foreground_scale = x/10`` (reference
    utils.py:858) and ``Anti-aliasing`` 0-5 becomes ``aa_strength = x*2``
    (reference utils.py:859).
    """

    model: str = "Depth-Anything-V2-Small"
    depth_resolution: int = 384
    depth_strength: float = 2.0
    anti_aliasing: float = 1.0
    foreground_scale_10: float = 0.0
    ipd: float = 0.064
    convergence: float = 0.0
    display_mode: str = "Half-SBS"
    fp16: bool = True  # the reference's half-precision switch; the port computes in bf16
    device_index: int = 0
    run_mode: str = "Viewer"
    output_resolution: int = 1080
    fps: float = 60.0
    show_fps: bool = False
    fill_16_9: bool = False
    streamer_port: int = 1122
    stream_quality: int = 90
    temporal_smooth: bool = True
    ema_alpha: float = 0.9  # reference depth.py:1891 DepthStabilizer(alpha=0.9)
    # Unknown keys from a foreign settings.yaml, preserved on save.
    extra: Dict[str, Any] = field(default_factory=dict, compare=False)

    @property
    def foreground_scale(self) -> float:
        return self.foreground_scale_10 / 10.0

    @property
    def aa_strength(self) -> float:
        return self.anti_aliasing * 2.0

    def replace(self, **kw: Any) -> "Settings":
        return dataclasses.replace(self, **kw)

    # ---- YAML round trip -------------------------------------------------

    @classmethod
    def from_yaml_dict(cls, data: Dict[str, Any]) -> "Settings":
        kwargs: Dict[str, Any] = {}
        extra: Dict[str, Any] = {}
        inverse = {v: k for k, v in _YAML_KEYS.items()}
        # The reference's canonical key is "Processing Resolution"
        # (reference utils.py:844); earlier versions here wrote "Output
        # Resolution" — accepted as an alias, canonical name wins a tie.
        inverse.setdefault("Output Resolution", "output_resolution")
        for key, value in data.items():
            fname = inverse.get(key)
            if fname is None or value is None:
                extra[key] = value
            elif fname in kwargs and key not in _YAML_KEYS.values():
                extra[key] = value  # alias loses to the canonical key
            else:
                kwargs[fname] = value
        # Normalise types the YAML may carry loosely.  "Auto" resolves via
        # the monitor policy (reference utils.py:316-343).
        if "output_resolution" in kwargs and isinstance(kwargs["output_resolution"], str):
            if kwargs["output_resolution"].lower() == "auto":
                from desktop2stereo_tpu_torch.core.display import compute_output_resolution

                extra["Processing Resolution"] = kwargs.pop("output_resolution")
                kwargs["output_resolution"] = compute_output_resolution(
                    "auto",
                    kwargs.get("display_mode", "Half-SBS"),
                    kwargs.get("run_mode"),
                )
            else:
                kwargs["output_resolution"] = int(kwargs["output_resolution"])
        if "fps" in kwargs and isinstance(kwargs["fps"], str):
            if kwargs["fps"].lower() == "auto":
                from desktop2stereo_tpu_torch.core.display import get_refresh_rate

                extra["Set FPS"] = kwargs.pop("fps")
                kwargs["fps"] = get_refresh_rate()
            else:
                kwargs["fps"] = float(kwargs["fps"])
        return cls(extra=extra, **kwargs)

    def to_yaml_dict(self) -> Dict[str, Any]:
        out = dict(self.extra)
        for fname, key in _YAML_KEYS.items():
            if key in out:
                continue  # key was unparsable (e.g. "Auto"); keep original
            out[key] = getattr(self, fname)
        return out


def load_settings(path: str | os.PathLike) -> Settings:
    """Read a settings.yaml (reference-compatible).  Tolerates GBK-encoded
    files the way the reference does (reference utils.py:574-586)."""
    raw: Optional[bytes] = None
    with open(path, "rb") as f:
        raw = f.read()
    for enc in ("utf-8", "gbk", "latin-1"):
        try:
            text = raw.decode(enc)
            break
        except UnicodeDecodeError:
            continue
    data = yaml_subset.load(text) or {}
    if not isinstance(data, dict):
        raise ValueError(f"settings file {path} did not parse to a mapping")
    return Settings.from_yaml_dict(data)


def save_settings(settings: Settings, path: str | os.PathLike) -> None:
    """Write settings, merging over an existing file so foreign keys are
    preserved (reference utils.py:588-614 merge-don't-clobber)."""
    existing: Dict[str, Any] = {}
    if os.path.exists(path):
        try:
            existing = load_settings(path).to_yaml_dict()
        except Exception:
            existing = {}
    existing.update(settings.to_yaml_dict())
    with open(path, "w", encoding="utf-8") as f:
        f.write(yaml_subset.dump(existing))


def update_yaml(path: str | os.PathLike, updates: Dict[str, Any]) -> None:
    """Merge a few keys into a settings.yaml without touching anything else
    — the reference's `write_yaml(path, {key: value})` live-update channel
    from the XR side (reference utils.py:588-614, environment.py:1093-1099)."""
    data: Dict[str, Any] = {}
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                raw = f.read()
            for enc in ("utf-8", "gbk", "latin-1"):
                try:
                    data = yaml_subset.load(raw.decode(enc)) or {}
                    break
                except UnicodeDecodeError:
                    continue
            if not isinstance(data, dict):
                data = {}
        except Exception:
            data = {}
    data.update(updates)
    with open(path, "w", encoding="utf-8") as f:
        f.write(yaml_subset.dump(data))


def stereo_geometry(settings: Settings) -> Tuple[float, float, float]:
    """(ipd, depth_ratio, convergence) triple for the stereo compositor."""
    return settings.ipd, settings.depth_strength, settings.convergence
