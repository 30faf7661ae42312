"""YAML configuration system.

Keeps the exact YAML schema of the reference configs
(reference config/*.yaml; loader at reference include/Settings.h:19-28,
src/Settings.cpp:6-21): ``rectified``, ``slamMode``, ``dataset``,
``imagesPath``, ``fileExtension``, ``Camera_l``/``Camera_r`` intrinsics (+
optional D/K/R/P blocks for unrectified rigs), ``Camera`` (width/height/
fps/bl), ``FE`` feature-extractor block, ``IMU`` block, and ``T_bc1``
body-to-camera extrinsics.

Differences from the reference loader (deliberate fixes, documented per
SURVEY.md "quirks"): missing files raise immediately instead of setting an
unchecked ``badFile`` flag, and paths are resolved against the caller's cwd
or an explicit search dir instead of the *source tree's* config dir.

The files are read by :func:`load_yaml`, a small loader for the subset of
YAML the configs use (block and flow mappings, flow sequences that may span
lines, ints, floats, bools, null, quoted strings, ``#`` comments), so the
package needs no YAML library.
"""

from __future__ import annotations

import enum
import os
import re
from typing import Any, Sequence

import numpy as np


class SlamMode(enum.IntEnum):
    """reference include/System.h:21-26."""

    STEREO_IMU = 0
    STEREO = 1
    MONOCULAR = 2  # mono + IMU
    MONO_IMU = 2  # alias (same mode; the reference's monocular requires IMU)


class ConfigFile:
    """Typed YAML accessor mirroring ConfigFile::getValue<T>(a, b, c)
    (reference include/Settings.h:19-28) with up-to-N-level nesting."""

    _MISSING = object()

    def __init__(self, path: str, search_dirs: Sequence[str] = ()):  # noqa: D401
        resolved = self._resolve(path, search_dirs)
        if resolved is None:
            raise FileNotFoundError(
                f"Config file not found: {path!r} (searched cwd and {list(search_dirs)})"
            )
        self.path = resolved
        with open(resolved, "r") as f:
            self.data: dict[str, Any] = load_yaml(f.read())
        self.bad_file = self.data is None
        if self.bad_file:
            raise ValueError(f"Config file is empty: {resolved}")

    @staticmethod
    def _resolve(path: str, search_dirs: Sequence[str]) -> str | None:
        if os.path.isfile(path):
            return path
        for d in search_dirs:
            cand = os.path.join(d, path)
            if os.path.isfile(cand):
                return cand
        here = os.path.join(os.path.dirname(__file__), "..", "..", "configs", path)
        if os.path.isfile(here):
            return os.path.normpath(here)
        return None

    def get(self, *keys: str, default: Any = _MISSING) -> Any:
        node: Any = self.data
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                if default is not ConfigFile._MISSING:
                    return default
                raise KeyError(f"Missing config key: {'.'.join(keys)} in {self.path}")
            node = node[k]
        return node

    # C++-style alias used in docs/tests for parity with the reference API.
    getValue = get

    def get_matrix(self, *keys: str, default: Any = _MISSING) -> np.ndarray | Any:
        """Read a {rows, cols, data} block (e.g. T_bc1, Camera_l.K) as an
        ndarray, matching the cv::FileStorage-style blocks in the configs."""
        node = self.get(*keys, default=ConfigFile._MISSING if default is ConfigFile._MISSING else None)
        if node is None:
            return default
        rows, cols = int(node["rows"]), int(node["cols"])
        return np.asarray(node["data"], dtype=np.float64).reshape(rows, cols)

    @property
    def slam_mode(self) -> SlamMode:
        return SlamMode(int(self.get("slamMode")))

    @property
    def rectified(self) -> bool:
        return bool(self.get("rectified", default=True))

    @property
    def dataset(self) -> str:
        return str(self.get("dataset", default="KITTI"))


_INT = re.compile(r"[-+]?[0-9]+$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", '"': '"', "\\": "\\", "/": "/"}


def load_yaml(text: str) -> Any:
    """Parse the YAML subset the configs use; None for an empty document.

    Supported: block mappings (nesting by indentation), flow mappings and
    flow sequences (``{a: 1}``, ``[1, 2]``, spanning lines while a bracket
    is open), int / float / bool / null scalars, single- and double-quoted
    strings, plain strings and ``#`` comments. Anything else (block
    sequences, anchors, multi-line strings) raises ValueError."""
    lines = _logical_lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None:
        return _parse_flow(lines[0][1])
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"YAML: unexpected dedent at {lines[i][1]!r}")
    return value


def _unquoted(s: str):
    """(index, char) of every character of `s` outside quoted strings."""
    quote, i = None, 0
    while i < len(s):
        c = s[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        else:
            yield i, c
        i += 1


def _strip_comment(line: str) -> str:
    for i, c in _unquoted(line):
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _bracket_depth(s: str) -> int:
    return sum((c in "[{") - (c in "]}") for _, c in _unquoted(s))


def _logical_lines(text: str) -> list[tuple[int, str]]:
    """(indent, content) per logical line: comments and blank lines
    dropped, a line with an open flow bracket joined with its successors."""
    out: list[tuple[int, str]] = []
    pending: list[str] = []
    indent = 0
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or (not pending and line.strip() == "---"):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"YAML: tab in indentation: {raw!r}")
        if not pending:
            indent = len(line) - len(line.lstrip(" "))
        pending.append(line.strip())
        joined = " ".join(pending)
        if _bracket_depth(joined) <= 0:
            out.append((indent, joined))
            pending = []
    if pending:
        raise ValueError(f"YAML: unclosed bracket in {' '.join(pending)!r}")
    return out


def _split_key(s: str) -> tuple[str, str] | None:
    """Split ``key: rest`` at the first ': ' (or trailing ':') outside
    quotes and brackets; None if the line is not a mapping entry."""
    depth = 0
    for i, c in _unquoted(s):
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(s) or s[i + 1] == " "):
            return s[:i].strip(), s[i + 1 :].strip()
    return None


def _parse_block(lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict[str, Any] = {}
    while i < len(lines):
        ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"YAML: unexpected indent at {text!r}")
        if text.startswith("- "):
            raise ValueError(f"YAML: block sequences are not supported: {text!r}")
        kv = _split_key(text)
        if kv is None:
            raise ValueError(f"YAML: expected 'key: value', got {text!r}")
        key, rest = kv
        key = _parse_flow(key)
        i += 1
        if rest:
            out[key] = _parse_flow(rest)
        elif i < len(lines) and lines[i][0] > ind:
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _parse_flow(s: str) -> Any:
    value, pos = _flow_value(s, 0, top=True)
    if s[pos:].strip():
        raise ValueError(f"YAML: trailing text {s[pos:]!r} in {s!r}")
    return value


def _skip_ws(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] in " \t":
        pos += 1
    return pos


def _flow_value(s: str, pos: int, top: bool = False, key: bool = False):
    pos = _skip_ws(s, pos)
    if pos >= len(s):
        return None, pos
    c = s[pos]
    if c in "[{":
        close = "]" if c == "[" else "}"
        items: list = []
        mapping: dict = {}
        pos = _skip_ws(s, pos + 1)
        while pos < len(s) and s[pos] != close:
            if c == "[":
                v, pos = _flow_value(s, pos)
                items.append(v)
            else:
                k, pos = _flow_value(s, pos, key=True)
                pos = _skip_ws(s, pos)
                if pos >= len(s) or s[pos] != ":":
                    raise ValueError(f"YAML: expected ':' in flow mapping {s!r}")
                v, pos = _flow_value(s, pos + 1)
                mapping[k] = v
            pos = _skip_ws(s, pos)
            if pos < len(s) and s[pos] == ",":
                pos = _skip_ws(s, pos + 1)
            elif pos >= len(s) or s[pos] != close:
                raise ValueError(f"YAML: expected ',' or {close!r} in {s!r}")
        if pos >= len(s):
            raise ValueError(f"YAML: unclosed {c!r} in {s!r}")
        return (items if c == "[" else mapping), pos + 1
    if c in "\"'":
        return _quoted(s, pos)
    stops = "" if top else (",[]{}:" if key else ",[]{}")
    end = pos
    while end < len(s) and s[end] not in stops:
        if not top and s[end] == ":" and (end + 1 == len(s) or s[end + 1] == " "):
            break
        end += 1
    return _scalar(s[pos:end].strip()), end


def _quoted(s: str, pos: int) -> tuple[str, int]:
    q = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1 : i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            esc = s[i + 1 : i + 2]
            if esc not in _ESCAPES:
                raise ValueError(f"YAML: unsupported escape \\{esc} in {s!r}")
            out.append(_ESCAPES[esc])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise ValueError(f"YAML: unterminated string in {s!r}")


def _scalar(tok: str) -> Any:
    if tok in ("", "~", "null", "Null", "NULL"):
        return None
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    return tok
