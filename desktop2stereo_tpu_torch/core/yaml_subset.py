"""The YAML that settings files hold, read and written without PyYAML.

A CUDA host need not have PyYAML, so the port reads and writes its settings
files itself.  `load(text)` reads what `yaml.safe_load` reads for the files
the reference GUI and `yaml.safe_dump` write, to the same Python values:

- block mappings and block sequences, nested, including the compact forms
  `- key: value` and `- - item` and a sequence at its key's indentation;
- flow sequences `[a, b]` and flow mappings `{a: b}`, nested, over lines;
- plain, single-quoted and double-quoted scalars (escapes, line folding);
- comments, a leading `---` and a trailing `...`;
- YAML 1.1 typing of plain scalars, as PyYAML's resolver does it:
  `true/false/yes/no/on/off` in three casings, `null`/`Null`/`NULL`/`~` and
  the empty value, ints (decimal, `0x`, `0b`, a leading-0 octal, `_`
  separators, base 60 `1:30`) and floats exactly where PyYAML makes them
  floats (`1.0e+3` and `.5` are floats; `1e3` and `1.0e3` stay strings).

Anything else raises ValueError: anchors, aliases, tags, block scalars
(`|`, `>`), complex keys, directives, several documents, timestamps, merge
keys, tabs used as indentation, non-printable characters and the line
breaks U+2028 and U+2029.

`dump(mapping)` writes block style that `yaml.safe_load` and `load` read
back to the same mapping, keys in order.
"""

from __future__ import annotations

import math
import re
from typing import Any, List

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# characters a YAML stream may hold (PyYAML's reader refuses the others);
# the line breaks \u2028 and \u2029, which PyYAML keeps inside a folded
# scalar, are refused too
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\xA0-\u2027\u202A-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010FFFF]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
            "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_FLOW_END = ",[]{}"
_NOT_PLAIN_START = "-?:,[]{}#&*!|>'\"%@`"
_REFUSED_START = "&*!|>%@`"


def _sexagesimal(text: str, cast) -> Any:
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _construct_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _construct_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def resolve(text: str) -> Any:
    """A plain scalar's value under YAML 1.1 typing (PyYAML's resolver)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _construct_int(text)
    if _FLOAT.match(text):
        return _construct_float(text)
    if text in ("<<", "=") or _TIMESTAMP.match(text):
        raise ValueError(f"unsupported YAML scalar {text!r} (merge key, value key or "
                         f"timestamp)")
    return text


class _Reader:
    def __init__(self, text: str) -> None:
        if text.startswith("\ufeff"):
            text = text[1:]
        # YAML 1.1 line breaks, as PyYAML's scanner reads them
        text = text.replace("\r\n", "\n").replace("\r", "\n").replace("\x85", "\n")
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise ValueError(f"non-printable character {bad.group()!r} at offset {bad.start()}")
        self.s = text
        self.n = len(text)
        self.i = 0

    # ---- positions -------------------------------------------------------

    def peek(self, k: int = 0) -> str:
        j = self.i + k
        return self.s[j] if j < self.n else ""

    def col(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def where(self) -> str:
        line = self.s.count("\n", 0, self.i) + 1
        return f"line {line}, column {self.col() + 1}"

    def fail(self, what: str):
        raise ValueError(f"{what} at {self.where()}")

    def at_marker(self, marker: str) -> bool:
        return (self.col() == 0 and self.s.startswith(marker, self.i)
                and self.peek(3) in ("", " ", "\n"))

    def at_blank(self, k: int = 0) -> bool:
        return self.peek(k) in ("", " ", "\n")

    def skip_blank(self) -> None:
        """Spaces, line breaks and comments up to the next content."""
        while self.i < self.n:
            ch = self.s[self.i]
            if ch in " \n":
                self.i += 1
            elif ch == "#":
                end = self.s.find("\n", self.i)
                self.i = self.n if end < 0 else end
            elif ch == "\t":
                self.fail("tab character used as indentation or separation")
            else:
                return

    def end_of_line(self) -> None:
        """Only spaces and a comment may follow a node on its line."""
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "#":
            end = self.s.find("\n", self.i)
            self.i = self.n if end < 0 else end
        if self.peek() not in ("", "\n"):
            self.fail(f"unexpected {self.peek()!r}")

    # ---- documents and block nodes -----------------------------------------

    def document(self) -> Any:
        self.skip_blank()
        if self.peek() == "%":
            self.fail("YAML directives are not supported")
        if self.at_marker("---"):
            self.i += 3
        node = self.block_node(-1)
        self.skip_blank()
        if self.at_marker("..."):
            self.i += 3
            self.skip_blank()
        if self.i < self.n:
            if self.at_marker("---"):
                self.fail("several documents in one settings file")
            self.fail(f"unexpected {self.peek()!r}")
        return node

    def is_seq_entry(self) -> bool:
        return self.peek() == "-" and self.at_blank(1)

    def block_node(self, parent: int, indentless: bool = False) -> Any:
        """The node after a key or a `- ` indicator, or the document's root:
        None when nothing is indented deeper than `parent` (a sequence at
        `parent` itself where `indentless`)."""
        self.skip_blank()
        if self.i >= self.n or self.at_marker("---") or self.at_marker("..."):
            return None
        col = self.col()
        if col <= parent and not (indentless and col == parent and self.is_seq_entry()):
            return None
        if self.is_seq_entry():
            return self.block_sequence(col)
        ch = self.peek()
        if ch in _REFUSED_START or (ch == "?" and self.at_blank(1)):
            self.fail(f"unsupported YAML construct {ch!r} (anchor, alias, tag, block "
                      f"scalar or complex key)")
        line_start = self.s.rfind("\n", 0, self.i)
        if ch in "[{":
            node = self.flow_collection()
        elif ch in "'\"":
            node = self.quoted()
        else:
            node = self.plain(parent, single_line=True)
        while self.peek() == " ":
            self.i += 1
        if self.peek() == ":" and self.at_blank(1):
            if ch in "[{" or self.s.rfind("\n", 0, self.i) != line_start:
                self.fail("complex or multi-line mapping keys are not supported")
            if ch not in "'\"":
                node = resolve(node)
            return self.block_mapping(col, node)
        if ch not in "[{'\"":
            node = resolve(node + self.plain_continuation(parent))
        self.end_of_line()
        return node

    def block_mapping(self, col: int, key: Any) -> dict:
        out: dict = {}
        while True:
            self.i += 1  # the ':'
            try:
                out[key] = self.mapping_value(col)
            except TypeError:
                self.fail(f"unhashable mapping key {key!r}")
            self.skip_blank()
            if self.i >= self.n or self.at_marker("---") or self.at_marker("..."):
                return out
            c = self.col()
            if c < col:
                return out
            if c > col or self.is_seq_entry():
                self.fail("bad indentation of a mapping entry")
            key = self.mapping_key()

    def mapping_key(self) -> Any:
        ch = self.peek()
        if ch in "[{" or ch in _REFUSED_START or (ch == "?" and self.at_blank(1)):
            self.fail(f"unsupported mapping key starting with {ch!r}")
        line_start = self.s.rfind("\n", 0, self.i)
        if ch in "'\"":
            key = self.quoted()
        else:
            key = resolve(self.plain(-1, single_line=True))
        while self.peek() == " ":
            self.i += 1
        if not (self.peek() == ":" and self.at_blank(1)):
            self.fail("expected ':' after a mapping key")
        if self.s.rfind("\n", 0, self.i) != line_start:
            self.fail("multi-line mapping keys are not supported")
        return key

    def mapping_value(self, col: int) -> Any:
        while self.peek() == " ":
            self.i += 1
        if self.peek() in ("", "\n", "#"):
            self.end_of_line()
            return self.block_node(col, indentless=True)
        ch = self.peek()
        if ch in _REFUSED_START or (ch in "?-" and self.at_blank(1)):
            self.fail(f"unsupported or misplaced {ch!r} in a mapping value")
        if ch in "[{":
            node = self.flow_collection()
        elif ch in "'\"":
            node = self.quoted()
        else:
            node = resolve(self.plain(col, single_line=False))
        while self.peek() == " ":
            self.i += 1
        if self.peek() == ":" and self.at_blank(1):
            self.fail("mapping values are not allowed here")
        self.end_of_line()
        return node

    def block_sequence(self, col: int) -> list:
        out: list = []
        while True:
            self.i += 1  # the '-'
            out.append(self.block_node(col))
            self.skip_blank()
            if self.i >= self.n or self.at_marker("---") or self.at_marker("..."):
                return out
            c = self.col()
            if c < col or (c == col and not self.is_seq_entry()):
                return out
            if c > col:
                self.fail("bad indentation of a sequence entry")

    # ---- scalars -----------------------------------------------------------

    def plain(self, parent: int, single_line: bool, flow: bool = False) -> str:
        """A plain scalar's text; in block context it may continue on lines
        indented deeper than `parent` unless `single_line`."""
        ch = self.peek()
        if ch in _NOT_PLAIN_START and not (
                (ch == "-" or (not flow and ch in "?:")) and not self.at_blank(1)):
            self.fail(f"a plain scalar cannot start with {ch!r}")
        text = self.plain_run(flow)
        if not single_line:
            text += self.plain_continuation(parent, flow)
        return text

    def plain_run(self, flow: bool) -> str:
        """Non-space text of a plain scalar up to its end on this line, with
        the single spaces inside it."""
        start = j = self.i
        end = start
        while j < self.n:
            ch = self.s[j]
            if ch == "\n":
                break
            if ch == "\t":
                self.i = j
                self.fail("tab character in a plain scalar")
            if ch == " ":
                k = j
                while k < self.n and self.s[k] == " ":
                    k += 1
                if k >= self.n or self.s[k] in "\n#":
                    break
                j = k
                continue
            if ch == ":" and (j + 1 >= self.n or self.s[j + 1] in " \n"
                              or (flow and self.s[j + 1] in _FLOW_END)):
                break
            if flow and ch in ",?[]{}":
                break
            j += 1
            end = j
        self.i = end
        return self.s[start:end]

    def plain_continuation(self, parent: int, flow: bool = False) -> str:
        """Folded continuation lines of a plain scalar ('' if none): a line
        break between two lines of text folds to a space, each empty line to
        a newline."""
        out: List[str] = []
        while True:
            mark = self.i
            while self.peek() == " ":
                self.i += 1
            if self.peek() != "\n":
                self.i = mark
                return "".join(out)
            breaks = 0
            while self.peek() == "\n":
                self.i += 1
                breaks += 1
                while self.peek() == " ":
                    self.i += 1
            ch = self.peek()
            if (ch in ("", "#") or (not flow and self.col() <= parent)
                    or self.at_marker_line()
                    or (flow and ch in _FLOW_END)
                    or (ch == ":" and self.at_blank(1))):
                self.i = mark
                return "".join(out)
            run = self.plain_run(flow)
            if not run:
                self.i = mark
                return "".join(out)
            out.append(" " if breaks == 1 else "\n" * (breaks - 1))
            out.append(run)
            if not flow and self.peek() == ":" and self.at_blank(1):
                self.fail("mapping values are not allowed here")

    def at_marker_line(self) -> bool:
        line_start = self.s.rfind("\n", 0, self.i) + 1
        return any(self.s.startswith(m, line_start)
                   and (line_start + 3 >= self.n or self.s[line_start + 3] in " \n")
                   for m in ("---", "..."))

    def quoted(self) -> str:
        q = self.peek()
        self.i += 1
        out: List[str] = []
        while True:
            ch = self.peek()
            if ch == "":
                self.fail("unterminated quoted scalar")
            if ch == q:
                if q == "'" and self.peek(1) == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                self.escape(out)
            elif ch in " \t\n":
                j = self.i
                while j < self.n and self.s[j] in " \t":
                    j += 1
                if j < self.n and self.s[j] == "\n":
                    self.i = j
                    out.append(self.fold_breaks(escaped=False))
                else:
                    out.append(self.s[self.i:j])
                    self.i = j
            else:
                out.append(ch)
                self.i += 1

    def fold_breaks(self, escaped: bool) -> str:
        """At a line break inside a quoted scalar: consume it, the empty
        lines after it and the next line's indentation; one break folds to a
        space (nothing after an escaped break), each empty line to a newline."""
        self.i += 1
        empties = 0
        while True:
            if self.at_marker("---") or self.at_marker("..."):
                self.fail("document marker inside a quoted scalar")
            while self.peek() in (" ", "\t"):
                self.i += 1
            if self.peek() != "\n":
                break
            self.i += 1
            empties += 1
        if empties:
            return "\n" * empties
        return "" if escaped else " "

    def escape(self, out: List[str]) -> None:
        code = self.peek(1)
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            self.i += 2
        elif code in _ESCAPE_CODES:
            width = _ESCAPE_CODES[code]
            digits = self.s[self.i + 2:self.i + 2 + width]
            if len(digits) != width or not all(c in "0123456789abcdefABCDEF" for c in digits):
                self.fail(f"bad escape \\{code}{digits}")
            out.append(chr(int(digits, 16)))
            self.i += 2 + width
        elif code == "\n":
            self.i += 1
            out.append(self.fold_breaks(escaped=True))
        else:
            self.fail(f"unknown escape \\{code}")

    # ---- flow collections ------------------------------------------------------

    def flow_collection(self) -> Any:
        opening = self.peek()
        self.i += 1
        closing = "]" if opening == "[" else "}"
        out: Any = [] if opening == "[" else {}
        while True:
            self.skip_blank()
            if self.peek() == closing:
                self.i += 1
                return out
            if opening == "[":
                out.append(self.flow_node())
                self.skip_blank()
                if self.peek() == ":":
                    self.fail("single-pair mappings in a flow sequence are not supported")
            else:
                key = self.flow_node()
                self.skip_blank()
                value = None
                if self.peek() == ":":
                    self.i += 1
                    self.skip_blank()
                    if self.peek() not in (",", "}"):
                        value = self.flow_node()
                        self.skip_blank()
                try:
                    out[key] = value
                except TypeError:
                    self.fail(f"unhashable mapping key {key!r}")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != closing:
                self.fail(f"expected ',' or {closing!r} in a flow collection")

    def flow_node(self) -> Any:
        self.skip_blank()
        ch = self.peek()
        if ch in "[{":
            return self.flow_collection()
        if ch in "'\"":
            return self.quoted()
        if ch == "" or ch in _REFUSED_START or ch in ",]}" or (ch == "?" and self.at_blank(1)):
            self.fail(f"unsupported or missing flow node at {ch!r}")
        return resolve(self.plain(-1, single_line=False, flow=True))


def load(text: str) -> Any:
    """Parse one YAML document of the supported subset (see the module's
    docstring); an empty document is None."""
    return _Reader(text).document()


# ---- writing ---------------------------------------------------------------

# matched against the whole string (fullmatch): `$` would also match before a
# final newline and write "A\n" plain, which reads back as "A"
_PLAIN_SAFE = re.compile(r"[A-Za-z_][A-Za-z0-9_ .,/()+\-]*(?::[A-Za-z0-9_.,/()+\-]+)*")


def _printable(o: int) -> bool:
    return (0x20 <= o <= 0x7E or (0xA0 <= o <= 0xD7FF and o not in (0x2028, 0x2029))
            or (0xE000 <= o <= 0xFFFD and o != 0xFEFF) or 0x10000 <= o <= 0x10FFFF)


def _double_quoted(text: str) -> str:
    out = ['"']
    for ch in text:
        o = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif _printable(o):
            out.append(ch)
        elif o <= 0xFF:
            out.append(f"\\x{o:02X}")
        elif o <= 0xFFFF:
            out.append(f"\\u{o:04X}")
        else:
            out.append(f"\\U{o:08X}")
    out.append('"')
    return "".join(out)


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # PyYAML's float needs the dot
        return text
    if isinstance(value, str):
        if (_PLAIN_SAFE.fullmatch(value) and not value.endswith(" ") and "  " not in value
                and resolve(value) == value):
            return value
        return _double_quoted(value)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as a YAML scalar")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def _is_block(value: Any) -> bool:
    return isinstance(value, (dict, list, tuple)) and len(value) > 0


def _mapping_lines(mapping: dict, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    for key, value in mapping.items():
        if isinstance(key, (dict, list, tuple)):
            raise TypeError(f"cannot write a {type(key).__name__} mapping key")
        head = f"{pad}{_scalar(key)}:"
        if isinstance(value, dict) and value:
            lines.append(head)
            lines += _mapping_lines(value, indent + 2)
        elif _is_block(value):
            lines.append(head)
            lines += _sequence_lines(value, indent)
        else:
            lines.append(f"{head} {_inline(value)}")
    return lines


def _sequence_lines(seq, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    for item in seq:
        if _is_block(item):
            sub = (_mapping_lines(item, indent + 2) if isinstance(item, dict)
                   else _sequence_lines(item, indent + 2))
            lines.append(f"{pad}- {sub[0][indent + 2:]}")
            lines += sub[1:]
        else:
            lines.append(f"{pad}- {_inline(item)}")
    return lines


def dump(mapping: dict) -> str:
    """Block-style YAML of a mapping (keys in order) whose leaves are None,
    bools, ints, floats and strings, inside mappings and lists."""
    if not isinstance(mapping, dict):
        raise TypeError(f"dump writes a mapping, got {type(mapping).__name__}")
    if not mapping:
        return "{}\n"
    return "\n".join(_mapping_lines(mapping, 0)) + "\n"
