"""Virtual keyboard: layout, hit testing and key-state machine.

Port of `desktop2stereo_tpu/xr/keyboard.py`, copied: plain Python.

Host-side analog of the reference's laser-typed virtual keyboard (layout
table reference xr_viewer/constants.py:68-119, hit test laser.py:797-833,
press/modifier handling input_handler.py).  The layout is a standard
full-size ANSI board on an 18-unit grid (6 rows: F-row, number row, three
letter rows, bottom row) with a navigation/arrow column on the right —
regenerated here from row specs rather than a literal table.

Key output events are abstract (virtual-key codes + modifier state); the
host input injector (OS-specific) consumes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# Windows virtual-key codes (the reference's native event vocabulary; any
# host injector can map them).
VK = {
    "Esc": 0x1B, "Tab": 0x09, "Caps": 0x14, "Shift": 0x10, "Ctrl": 0x11,
    "Win": 0x5B, "Alt": 0x12, "Apps": 0x5D, "Space": 0x20, "Enter": 0x0D,
    "Bksp": 0x08, "Ins": 0x2D, "Del": 0x2E, "Home": 0x24, "End": 0x23,
    "PgUp": 0x21, "PgDn": 0x22, "PrtSc": 0x2C, "ScrLk": 0x91, "Pause": 0x13,
    "Up": 0x26, "Down": 0x28, "Left": 0x25, "Right": 0x27,
    "`": 0xC0, "-": 0xBD, "=": 0xBB, "[": 0xDB, "]": 0xDD, "\\": 0xDC,
    ";": 0xBA, "'": 0xDE, ",": 0xBC, ".": 0xBE, "/": 0xBF,
}
for _i in range(10):
    VK[str(_i)] = 0x30 + _i
for _c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ":
    VK[_c] = ord(_c)
for _i in range(1, 13):
    VK[f"F{_i}"] = 0x6F + _i

SHIFTED = {
    "`": "~", "1": "!", "2": "@", "3": "#", "4": "$", "5": "%", "6": "^",
    "7": "&", "8": "*", "9": "(", "0": ")", "-": "_", "=": "+", "[": "{",
    "]": "}", "\\": "|", ";": ":", "'": '"', ",": "<", ".": ">", "/": "?",
}

UNITS_WIDE = 18.0
NUM_ROWS = 6

# (label, width) per row; None = dead gap.  Each row sums to 18 units.
_ROW_SPECS: Tuple[Tuple[Tuple[Optional[str], float], ...], ...] = (
    (("Esc", 1.5),) + tuple((f"F{i}", 1.0) for i in range(1, 13))
    + (("PrtSc", 1.5), ("ScrLk", 1.5), ("Pause", 1.5)),
    (("`", 1.0), ("1", 1.0), ("2", 1.0), ("3", 1.0), ("4", 1.0), ("5", 1.0),
     ("6", 1.0), ("7", 1.0), ("8", 1.0), ("9", 1.0), ("0", 1.0), ("-", 1.0),
     ("=", 1.0), ("Bksp", 2.0), ("Ins", 1.0), ("Home", 1.0), ("PgUp", 1.0)),
    (("Tab", 1.5), ("Q", 1.0), ("W", 1.0), ("E", 1.0), ("R", 1.0), ("T", 1.0),
     ("Y", 1.0), ("U", 1.0), ("I", 1.0), ("O", 1.0), ("P", 1.0), ("[", 1.0),
     ("]", 1.0), ("\\", 1.5), ("Del", 1.0), ("End", 1.0), ("PgDn", 1.0)),
    (("Caps", 1.75), ("A", 1.0), ("S", 1.0), ("D", 1.0), ("F", 1.0),
     ("G", 1.0), ("H", 1.0), ("J", 1.0), ("K", 1.0), ("L", 1.0), (";", 1.0),
     ("'", 1.0), ("Enter", 2.25), (None, 3.0)),
    (("Shift", 2.25), ("Z", 1.0), ("X", 1.0), ("C", 1.0), ("V", 1.0),
     ("B", 1.0), ("N", 1.0), ("M", 1.0), (",", 1.0), (".", 1.0), ("/", 1.0),
     ("Shift", 2.75), (None, 1.0), ("Up", 1.0), (None, 1.0)),
    (("Ctrl", 1.5), ("Win", 1.0), ("Alt", 1.25), ("Space", 7.5),
     ("Alt", 1.25), ("Apps", 1.0), ("Ctrl", 1.5),
     ("Left", 1.0), ("Down", 1.0), ("Right", 1.0)),
)

MODIFIER_KEYS = frozenset({"Shift", "Ctrl", "Alt", "Win"})
TOGGLE_KEYS = frozenset({"Caps"})


@dataclass(frozen=True)
class Key:
    label: str
    shifted_label: Optional[str]
    vk: int
    rect_uv: Tuple[float, float, float, float]      # (u0, v0, u1, v1), v0 top
    rect_local: Tuple[float, float, float, float]   # metres, board-local


def build_layout(board_half_w: float = 0.30,
                 board_half_h: float = 0.10) -> List[Key]:
    """Key list with UV rects (texture space, v down) and board-local metre
    rects (origin at board center, +y up) for ray hit testing."""
    keys: List[Key] = []
    row_h = 1.0 / NUM_ROWS
    for ri, row in enumerate(_ROW_SPECS):
        x = 0.0
        for label, width in row:
            u0, u1 = x / UNITS_WIDE, (x + width) / UNITS_WIDE
            x += width
            if label is None:
                continue
            v0, v1 = ri * row_h, (ri + 1) * row_h
            lx0 = (u0 - 0.5) * 2.0 * board_half_w
            lx1 = (u1 - 0.5) * 2.0 * board_half_w
            # texture v runs top-down; board-local y runs bottom-up
            ly1 = (0.5 - v0) * 2.0 * board_half_h
            ly0 = (0.5 - v1) * 2.0 * board_half_h
            keys.append(Key(
                label=label, shifted_label=SHIFTED.get(label),
                vk=VK[label], rect_uv=(u0, v0, u1, v1),
                rect_local=(lx0, ly0, lx1, ly1),
            ))
    return keys


def hit_key(keys: List[Key], lx: float, ly: float) -> Optional[int]:
    """Index of the key containing the board-local point, else None."""
    for i, k in enumerate(keys):
        x0, y0, x1, y1 = k.rect_local
        if x0 <= lx <= x1 and y0 <= ly <= y1:
            return i
    return None


@dataclass
class KeyboardState:
    """Modifier/latch tracking for laser typing (reference
    input_handler.py): modifiers latch for one following normal key press;
    Caps toggles.  `press` returns the (vk, down-modifier-vks) to inject."""

    shift: bool = False
    ctrl: bool = False
    alt: bool = False
    win: bool = False
    caps: bool = False
    _latched: List[str] = field(default_factory=list)

    def press(self, key: Key) -> Optional[Tuple[int, Tuple[int, ...]]]:
        if key.label in MODIFIER_KEYS:
            attr = key.label.lower()
            setattr(self, attr, not getattr(self, attr))
            self._latched = [m for m in ("shift", "ctrl", "alt", "win")
                             if getattr(self, m)]
            return None
        if key.label in TOGGLE_KEYS:
            self.caps = not self.caps
            return None
        mods = tuple(VK[m.capitalize() if m != "win" else "Win"]
                     for m in self._latched)
        for m in self._latched:
            setattr(self, m, False)
        self._latched = []
        return key.vk, mods

    def label_for(self, key: Key) -> str:
        upper = self.shift != (self.caps and key.label.isalpha()
                               and len(key.label) == 1)
        if self.shift and key.shifted_label:
            return key.shifted_label
        if len(key.label) == 1 and key.label.isalpha():
            return key.label.upper() if upper else key.label.lower()
        return key.label
