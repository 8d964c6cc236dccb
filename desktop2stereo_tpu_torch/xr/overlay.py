"""XR overlays / OSD: PIL-rendered panels the renderer shows as quads.

Host-side analog of the reference's overlay mixin (reference
xr_viewer/overlay.py:30-1511, bilingual help tables utils.py:909-1044):
FPS/status panel, depth-strength OSD, screen-preset OSD, crop OSD, seat
OSD, the controller help panel (EN/CN), and the virtual-keyboard texture
rendered from xr.keyboard's layout.  Every renderer returns an RGBA uint8
numpy array; a throttle helper matches the reference's 0.5 s OSD cadence.
PIL is imported by the functions that draw, not when the module is.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from desktop2stereo_tpu_torch.xr.keyboard import Key, KeyboardState, build_layout

PANEL_BG = (16, 18, 24, 216)
PANEL_FG = (235, 238, 245, 255)
HEADER_FG = (140, 200, 255, 255)
ACCENT = (90, 200, 120, 255)
KEY_BG = (40, 44, 56, 255)
KEY_BG_HOVER = (90, 120, 200, 255)
KEY_BG_ACTIVE = (70, 160, 90, 255)
KEY_FG = (230, 233, 240, 255)


def _font(size: int):
    from PIL import ImageFont

    for name in ("DejaVuSans.ttf", "NotoSansCJK-Regular.ttc",
                 "Arial Unicode.ttf"):
        try:
            return ImageFont.truetype(name, size)
        except OSError:
            continue
    return ImageFont.load_default()


def _panel(width: int, height: int):
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (width, height), PANEL_BG)
    d = ImageDraw.Draw(img)
    d.rectangle([0, 0, width - 1, height - 1], outline=(90, 96, 110, 255))
    return img


def render_text_panel(lines: Sequence[str], width: int = 420,
                      font_size: int = 18, pad: int = 12,
                      highlight: Optional[int] = None) -> np.ndarray:
    """Simple multi-line OSD panel → RGBA uint8 [H, W, 4]."""
    from PIL import ImageDraw

    font = _font(font_size)
    lh = font_size + 6
    height = pad * 2 + lh * max(len(lines), 1)
    img = _panel(width, height)
    d = ImageDraw.Draw(img)
    for i, line in enumerate(lines):
        fg = ACCENT if i == highlight else PANEL_FG
        d.text((pad, pad + i * lh), line, fill=fg, font=font)
    return np.asarray(img, np.uint8)


# ------------------------------------------------------------- OSDs -------

def fps_panel(fps: float, low1: float, latency_ms: float,
              model: str = "", depth_strength: float = 1.0) -> np.ndarray:
    """Status panel (reference overlay.py FPS panel + title-bar stats
    main.py:1233-1251)."""
    lines = [
        f"FPS {fps:5.1f}   1% low {low1:5.1f}",
        f"latency {latency_ms:6.1f} ms",
    ]
    if model:
        lines.append(f"model  {model}")
    lines.append(f"depth  {depth_strength:.2f}")
    return render_text_panel(lines, width=300)


def depth_osd(depth_strength: float, lang: str = "EN") -> np.ndarray:
    label = "深度强度" if lang == "CN" else "Depth strength"
    return render_text_panel([f"{label}: {depth_strength:.2f}"], width=280,
                             font_size=22)


def preset_osd(name: str, index: int, total: int,
               lang: str = "EN") -> np.ndarray:
    label = "屏幕预设" if lang == "CN" else "Screen preset"
    return render_text_panel([f"{label} {index + 1}/{total}", name],
                             width=300, font_size=22, highlight=1)


def seat_osd(name: str, index: int, total: int, lang: str = "EN") -> np.ndarray:
    label = "座位" if lang == "CN" else "Seat"
    return render_text_panel([f"{label} {index + 1}/{total}", name],
                             width=300, font_size=22, highlight=1)


def crop_osd(mode: str, rect: Optional[Tuple[float, float, float, float]] = None,
             paused: bool = False, lang: str = "EN") -> np.ndarray:
    """Letterbox-crop OSD (reference crop.py OSD)."""
    title = "裁剪" if lang == "CN" else "Crop"
    lines = [f"{title}: {mode}" + ("  [paused]" if paused else "")]
    if rect is not None:
        u0, v0, u1, v1 = rect
        lines.append(f"u [{u0:.3f}, {u1:.3f}]  v [{v0:.3f}, {v1:.3f}]")
    return render_text_panel(lines, width=340, font_size=20)


# ------------------------------------------------------- help panel -------

HelpRow = Tuple[str, str, str, bool]  # (input, gesture, effect, is_header)


def help_rows(lang: str = "EN") -> List[HelpRow]:
    """Controller operation guide for this framework's binding set
    (structure after reference utils.py:909-1044, bilingual)."""
    if lang == "CN":
        return [
            ("# 手柄操作指南", "", "", True),
            ("[屏幕]", "", "", True),
            ("握持 + 激光指屏幕", "按住移动", "移动/旋转屏幕", False),
            ("握持 + 摇杆", "推动", "屏幕尺寸/距离/偏摆/俯仰", False),
            ("[预设与环境]", "", "", True),
            ("Y 键", "短按 / 长按", "重置屏幕 / 循环预设与灯光", False),
            ("X 键", "短按 / 按住", "虚拟键盘 / 透视绿幕", False),
            ("摇杆按下", "短按", "切换环境 / 曲面屏", False),
            ("[鼠标(激光指屏幕)]", "", "", True),
            ("扳机", "单击 / 按住", "鼠标单击 / 拖动", False),
            ("双扳机", "同时按住", "双指缩放手势", False),
            ("右摇杆", "前后 / 左右", "滚轮 / 水平滚动", False),
            ("左摇杆", "前后 / 左右", "上下 / 左右方向键", False),
            ("[深度]", "", "", True),
            ("握持 + 左摇杆 前后", "推动", "调整深度强度", False),
            ("右摇杆按下", "短按", "重置深度强度", False),
        ]
    return [
        ("# Controller guide", "", "", True),
        ("[Screen]", "", "", True),
        ("Grip + laser at screen", "hold & move", "move / rotate screen", False),
        ("Grip + stick", "push", "size / distance / yaw / pitch", False),
        ("[Presets & environment]", "", "", True),
        ("Y", "tap / hold", "reset screen / cycle presets & lighting", False),
        ("X", "tap / hold", "virtual keyboard / passthrough", False),
        ("Stick click", "tap", "cycle environment / curved screen", False),
        ("[Mouse (laser at screen)]", "", "", True),
        ("Trigger", "click / hold", "mouse click / drag", False),
        ("Both triggers", "hold", "two-finger pinch gesture", False),
        ("Right stick", "fwd-back / left-right", "wheel / horizontal scroll", False),
        ("Left stick", "fwd-back / left-right", "arrow keys", False),
        ("[Depth]", "", "", True),
        ("Grip + left stick fwd-back", "push", "adjust depth strength", False),
        ("Right stick click", "tap", "reset depth strength", False),
    ]


def render_help_panel(lang: str = "EN", width: int = 760,
                      font_size: int = 17) -> np.ndarray:
    """Three-column help table → RGBA uint8 (reference overlay.py help
    panel)."""
    from PIL import ImageDraw

    rows = help_rows(lang)
    font = _font(font_size)
    lh = font_size + 8
    pad = 16
    height = pad * 2 + lh * len(rows)
    img = _panel(width, height)
    d = ImageDraw.Draw(img)
    col_x = (pad, int(width * 0.42), int(width * 0.62))
    y = pad
    for inp, gesture, effect, is_header in rows:
        if is_header:
            d.text((pad, y), inp, fill=HEADER_FG, font=font)
        else:
            for x, text in zip(col_x, (inp, gesture, effect)):
                d.text((x, y), text, fill=PANEL_FG, font=font)
        y += lh
    return np.asarray(img, np.uint8)


# --------------------------------------------------- keyboard texture -----

KB_TEX_W, KB_TEX_H = 1280, 384  # 18-unit × 6-row grid (reference constants)


def render_keyboard_texture(keys: Optional[Sequence[Key]] = None,
                            state: Optional[KeyboardState] = None,
                            hover: Optional[int] = None,
                            pressed: Optional[int] = None,
                            width: int = KB_TEX_W,
                            height: int = KB_TEX_H) -> np.ndarray:
    """Virtual-keyboard quad texture: key caps with the state-aware labels
    (shift/caps), hover and pressed tints (reference overlay.py:1252-1456)."""
    from PIL import Image, ImageDraw

    keys = list(keys) if keys is not None else build_layout()
    state = state or KeyboardState()
    img = Image.new("RGBA", (width, height), (10, 11, 14, 235))
    d = ImageDraw.Draw(img)
    font = _font(18)
    gap = 2
    for i, k in enumerate(keys):
        u0, v0, u1, v1 = k.rect_uv
        x0, y0 = int(u0 * width) + gap, int(v0 * height) + gap
        x1, y1 = int(u1 * width) - gap, int(v1 * height) - gap
        latched = (k.label in ("Shift", "Ctrl", "Alt", "Win")
                   and getattr(state, k.label.lower())) or (
            k.label == "Caps" and state.caps)
        bg = (KEY_BG_ACTIVE if (i == pressed or latched)
              else KEY_BG_HOVER if i == hover else KEY_BG)
        d.rounded_rectangle([x0, y0, x1, y1], radius=5, fill=bg,
                            outline=(70, 75, 90, 255))
        label = state.label_for(k)
        tb = d.textbbox((0, 0), label, font=font)
        tw, thh = tb[2] - tb[0], tb[3] - tb[1]
        d.text(((x0 + x1 - tw) / 2, (y0 + y1 - thh) / 2 - tb[1]),
               label, fill=KEY_FG, font=font)
    return np.asarray(img, np.uint8)


# ----------------------------------------------------------- throttle -----

@dataclass
class OverlayThrottle:
    """Re-render OSD textures at most every `interval` seconds (reference
    viewer.py:1896-2166 throttles PIL renders to 0.5 s)."""

    interval: float = 0.5
    _last: float = -1e9
    _cache: Optional[np.ndarray] = None

    def maybe(self, render_fn, *args, now: Optional[float] = None, **kw):
        now = time.monotonic() if now is None else now
        if self._cache is None or now - self._last >= self.interval:
            self._cache = render_fn(*args, **kw)
            self._last = now
        return self._cache
