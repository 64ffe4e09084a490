"""A reader and writer of the subset of YAML that the config tree and the
command line use, without PyYAML (the machine with the card has none).

``load(text)`` gives what ``yaml.safe_load(text)`` gives on that subset,
resolved as PyYAML's YAML 1.1 resolver resolves plain scalars (``1.e-6``,
``5.e-4`` and ``1.`` are floats while ``1e-5`` stays a string; ``yes``,
``on``, ``~``, ``0x10``, ``010`` and ``1:30`` are True, True, None, 16, 8 and
90). The subset:

- block mappings and block sequences, nested by indentation, a sequence entry
  holding a mapping (``- override /data: ucfcrime``) or another sequence;
- plain, single-quoted and double-quoted scalars on one line, plain ones with
  ``:`` and ``/`` inside (``ViT-B/16``, ``${oc.env:ROOT,/data}/Features/``);
- flow sequences on one line (``["dev"]``, ``[2, 3, 5]``, nested ones) and the
  empty flow mapping ``{}``;
- comments, whole-line and trailing.

Anything else (anchors, aliases, tags, block scalars, other flow mappings,
complex keys, plain scalars continued over lines, multi-line flow
collections, documents, directives, tabs, timestamps) raises ``YAMLSubsetError``
with the line it is on: the reader never guesses.

``dump(tree)`` writes a tree of dicts, lists and scalars in block form that
``load`` and ``yaml.safe_load`` read back to the same tree.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

__all__ = ["YAMLSubsetError", "dump", "load"]


class YAMLSubsetError(ValueError):
    """Text outside the subset, or not YAML at all."""


# PyYAML's implicit resolvers (yaml/resolver.py), keyed by a scalar's first
# character, in the order PyYAML tries them
_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
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
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_VALUE = re.compile(r"^(?:=)$")

_RESOLVERS = (
    ("bool", _BOOL, "yYnNtTfFoO"),
    ("float", _FLOAT, "-+0123456789."),
    ("int", _INT, "-+0123456789"),
    ("merge", _MERGE, "<"),
    ("null", _NULL, "~nN"),
    ("timestamp", _TIMESTAMP, "0123456789"),
    ("value", _VALUE, "="),
)

_INF = float("inf")
_BREAKS = "\r\n\x85\u2028\u2029"
_FLOW_INDICATORS = ",[]{}"
_ESCAPES = {
    "0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
    "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "\\": "\\", "/": "/",
    "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029",
}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
# what PyYAML's reader refuses (yaml/reader.py NON_PRINTABLE)
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010ffff]")
_NAMED = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
          ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
          "`": "a reserved indicator", "?": "a complex key"}


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = +1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        digits = [int(part) for part in value.split(":")]
        digits.reverse()
        base, total = 1, 0
        for digit in digits:
            total += digit * base
            base *= 60
        return sign * total
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = +1
    if value[0] == "-":
        sign = -1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * _INF
    if value == ".nan":
        return -_INF / _INF  # the quiet NaN PyYAML makes
    if ":" in value:
        digits = [float(part) for part in value.split(":")]
        digits.reverse()
        base, total = 1, 0.0
        for digit in digits:
            total += digit * base
            base *= 60
        return sign * total
    return sign * float(value)


def _resolve_plain(text: str, where: str = "<string>") -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 resolver."""
    first = text[:1]
    for kind, pattern, firsts in _RESOLVERS:
        if not text:
            if kind == "null":
                return None
            continue
        if first not in firsts or not pattern.match(text):
            continue
        if kind == "bool":
            return text.lower() in ("yes", "true", "on")
        try:
            if kind == "float":
                return _construct_float(text)
            if kind == "int":
                return _construct_int(text)
        except ValueError as exc:  # "0x_": PyYAML's constructor fails the same way
            raise YAMLSubsetError(f"{where}: {text!r} is no {kind}: {exc}") from None
        if kind == "null":
            return None
        raise YAMLSubsetError(f"{where}: {text!r} resolves to a {kind}, outside the subset")
    return text


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        match = _NON_PRINTABLE.search(text)
        if match:
            line = text.count("\n", 0, match.start()) + 1
            raise YAMLSubsetError(f"{source}:{line}: non-printable character {match.group()!r}")
        self.lines: List[_Line] = []
        for no, raw in enumerate(re.split("\r\n|[\r\n\x85\u2028\u2029]", text), start=1):
            if no == 1 and raw.startswith("\ufeff"):
                raw = raw[1:]
            body = raw.lstrip(" ")
            if not body or body.startswith("#"):
                continue
            if body[0] == "\t" or "\t" in body:
                raise YAMLSubsetError(f"{source}:{no}: a tab, outside the subset")
            indent = len(raw) - len(body)
            if indent == 0 and (body[:3] in ("---", "...") and body[3:4] in ("", " ")):
                raise YAMLSubsetError(f"{source}:{no}: a document marker, outside the subset")
            if body.startswith("%"):
                raise YAMLSubsetError(f"{source}:{no}: a directive, outside the subset")
            self.lines.append(_Line(no, indent, body.rstrip(" ")))
        self.pos = 0

    def fail(self, line: _Line, what: str):
        raise YAMLSubsetError(f"{self.source}:{line.no}: {what}")

    def peek(self) -> Optional[_Line]:
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    # ------------------------------------------------------------ blocks

    def document(self) -> Any:
        first = self.peek()
        if first is None:
            return None
        node = self.block(first.indent, top=True)
        rest = self.peek()
        if rest is not None:
            self.fail(rest, "text after the end of the document, or a wrong indentation")
        return node

    def block(self, indent: int, top: bool = False) -> Any:
        line = self.peek()
        if _is_entry(line.text):
            return self.sequence(indent)
        key_end = self.key_end(line)
        if key_end is not None:
            return self.mapping(indent)
        # a lone scalar or flow collection: the whole document, or a
        # mapping value on the line after its key
        self.pos += 1
        value = self.inline(line, line.text)
        after = self.peek()
        if after is not None and (after.indent > indent or top):
            self.fail(after, "a scalar continued over lines, outside the subset")
        return value

    def sequence(self, indent: int) -> list:
        items = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return items
            if line.indent > indent:
                self.fail(line, "a wrong indentation")
            if not _is_entry(line.text):
                # the end of a sequence that is a mapping value at its key's
                # column; anywhere else the caller refuses the line
                return items
            rest = line.text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                self.pos += 1
                nxt = self.peek()
                items.append(self.block(nxt.indent) if nxt is not None and nxt.indent > indent else None)
                continue
            # "- rest": rest is a block node of its own at its column
            column = indent + len(line.text) - len(rest)
            self.lines[self.pos] = _Line(line.no, column, rest)
            items.append(self.block(column))

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                self.fail(line, "a wrong indentation")
            if _is_entry(line.text):
                self.fail(line, "a sequence entry inside a mapping")
            key_end = self.key_end(line)
            if key_end is None:
                self.fail(line, "a line that is no mapping entry inside a mapping")
            key = self.key(line, line.text[:key_end])
            rest = line.text[key_end + 1:].lstrip(" ")
            self.pos += 1
            if not rest or rest.startswith("#"):
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    value = self.block(nxt.indent)
                elif nxt is not None and nxt.indent == indent and _is_entry(nxt.text):
                    value = self.sequence(indent)
                else:
                    value = None
            else:
                if _is_entry(rest):
                    self.fail(line, "a sequence entry on a mapping key's line")
                value = self.inline(line, rest)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    self.fail(nxt, "a scalar continued over lines, or a wrong indentation")
            out[key] = value

    def key_end(self, line: _Line) -> Optional[int]:
        """The index of the ':' that ends a simple key on ``line``, or None."""
        text = line.text
        if text[0] in "\"'":
            end = _quoted_end(text, 0)
            if end is None:
                self.fail(line, "an unclosed quoted scalar")
            i = end
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ":" and text[i + 1:i + 2] in ("", " "):
                return i
            return None
        if text[0] == "?" and text[1:2] in ("", " "):
            self.fail(line, "a complex key, outside the subset")
        if text[0] in "[{":
            return None
        i = 0
        while i < len(text):
            ch = text[i]
            if ch == ":" and text[i + 1:i + 2] in ("", " "):
                return i
            if ch == "#" and i > 0 and text[i - 1] == " ":
                return None
            i += 1
        return None

    def key(self, line: _Line, text: str) -> Any:
        text = text.rstrip(" ")
        if not text:
            self.fail(line, "an empty key, outside the subset")
        if text[0] in "\"'":
            value, end = self.quoted(line, text, 0)
            if text[end:].strip(" "):
                self.fail(line, "text after a quoted key")
            return value
        value = self.plain(line, text, 0, flow=False)
        if value[1] != len(text):
            self.fail(line, "a key that is no plain scalar")
        if value[0] == "<<":
            self.fail(line, "a merge key, outside the subset")
        return _resolve_plain(value[0], f"{self.source}:{line.no}")

    # ---------------------------------------------------------- one line

    def inline(self, line: _Line, text: str) -> Any:
        """A value that sits on one line: a scalar or a flow collection,
        followed by nothing but a comment."""
        ch = text[0]
        if ch in "\"'":
            value, end = self.quoted(line, text, 0)
        elif ch == "[":
            value, end = self.flow_sequence(line, text, 0)
        elif ch == "{":
            value, end = self.flow_mapping(line, text, 0)
        else:
            plain, end = self.plain(line, text, 0, flow=False)
            if end < len(text) and text[end] == ":":
                self.fail(line, "a mapping value where none is allowed")
            value = _resolve_plain(plain, f"{self.source}:{line.no}")
        self.trailing(line, text, end)
        return value

    def trailing(self, line: _Line, text: str, end: int) -> None:
        rest = text[end:].lstrip(" ")
        if rest and not rest.startswith("#"):
            self.fail(line, f"unexpected text {rest!r}")

    def plain(self, line: _Line, text: str, start: int, flow: bool) -> Tuple[str, int]:
        """A plain scalar from ``start`` -> (its text, the index after it)."""
        ch = text[start]
        nxt = text[start + 1:start + 2]
        if ch in _NAMED and not (ch == "?" and nxt not in ("", " ") and not flow):
            self.fail(line, f"{_NAMED[ch]} ({ch!r}), outside the subset")
        allowed_lead = "-" if flow else "-?:"
        if ch in "-?:,[]{}#'\"" and not (ch in allowed_lead and nxt not in ("", " ")):
            self.fail(line, f"a plain scalar cannot start with {ch!r}")
        i = start
        end = start
        while i < len(text):
            ch = text[i]
            if ch == " ":
                i += 1
                continue
            if ch == "#" and text[i - 1] == " ":
                break
            if ch == ":" and (text[i + 1:i + 2] in ("", " ")
                              or (flow and text[i + 1:i + 2] in tuple(_FLOW_INDICATORS))):
                break
            if flow and ch in ",?[]{}":
                break
            i += 1
            end = i
        return text[start:end], end

    def quoted(self, line: _Line, text: str, start: int) -> Tuple[str, int]:
        quote = text[start]
        end = _quoted_end(text, start)
        if end is None:
            self.fail(line, "a quoted scalar that does not close on its line, outside the subset")
        body = text[start + 1:end - 1]
        if quote == "'":
            return body.replace("''", "'"), end
        out, i = [], 0
        while i < len(body):
            ch = body[i]
            if ch != "\\":
                out.append(ch)
                i += 1
                continue
            esc = body[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _ESCAPE_CODES:
                n = _ESCAPE_CODES[esc]
                digits = body[i + 2:i + 2 + n]
                if len(digits) != n or any(c not in "0123456789ABCDEFabcdef" for c in digits):
                    self.fail(line, f"a bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                self.fail(line, f"an unknown escape \\{esc}")
        return "".join(out), end

    def flow_sequence(self, line: _Line, text: str, start: int) -> Tuple[list, int]:
        items: list = []
        i = _skip(text, start + 1)
        while True:
            if i >= len(text) or text[i] == "#" and text[i - 1] == " ":
                self.fail(line, "a flow sequence that does not close on its line, outside the subset")
            ch = text[i]
            if ch == "]":
                return items, i + 1
            if ch in "\"'":
                value, i = self.quoted(line, text, i)
            elif ch == "[":
                value, i = self.flow_sequence(line, text, i)
            elif ch == "{":
                value, i = self.flow_mapping(line, text, i)
            else:
                plain, i = self.plain(line, text, i, flow=True)
                value = _resolve_plain(plain, f"{self.source}:{line.no}")
            items.append(value)
            i = _skip(text, i)
            if i < len(text) and text[i] == ",":
                i = _skip(text, i + 1)
                if i < len(text) and text[i] == ",":
                    self.fail(line, "an empty flow sequence entry")
                continue
            if i < len(text) and text[i] == "]":
                return items, i + 1
            if i < len(text) and text[i] == ":":
                self.fail(line, "a mapping inside a flow sequence, outside the subset")
            if i >= len(text) or text[i] == "#":
                self.fail(line, "a flow sequence that does not close on its line, outside the subset")
            self.fail(line, f"unexpected {text[i]!r} in a flow sequence")

    def flow_mapping(self, line: _Line, text: str, start: int) -> Tuple[dict, int]:
        i = _skip(text, start + 1)
        if i < len(text) and text[i] == "}":
            return {}, i + 1
        self.fail(line, "a flow mapping other than {}, outside the subset")


def _skip(text: str, i: int) -> int:
    while i < len(text) and text[i] == " ":
        i += 1
    return i


def _quoted_end(text: str, start: int) -> Optional[int]:
    """The index after the quote that closes the scalar opened at ``start``."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        if quote == '"':
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                return i + 1
        i += 1
    return None


def _is_entry(text: str) -> bool:
    return text[:1] == "-" and text[1:2] in ("", " ")


def load(text: str, source: str = "<string>") -> Any:
    """``yaml.safe_load(text)`` on the subset; ``source`` names the text in
    errors (a file path, say)."""
    return _Reader(text, source).document()


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


def _float_text(value: float) -> str:
    """PyYAML's representation of a float (yaml/representer.py)."""
    if value != value:
        return ".nan"
    if value == _INF:
        return ".inf"
    if value == -_INF:
        return "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _plain_ok(text: str) -> bool:
    if not text or text != text.strip(" ") or _NON_PRINTABLE.search(text) or any(c in text for c in "\t" + _BREAKS):
        return False
    if text[:3] in ("---", "...") or text.startswith("- "):
        return False
    try:
        reader = _Reader("", "<dump>")
        line = _Line(0, 0, text)
        plain, end = reader.plain(line, text, 0, flow=False)
        return end == len(text) and plain == text and _resolve_plain(text) == text
    except YAMLSubsetError:
        return False


def _quote(text: str) -> str:
    out = ['"']
    for ch in text:
        if ch in '"\\':
            out.append("\\" + ch)
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif _NON_PRINTABLE.match(ch) or ch in _BREAKS or ch == "\ufeff":
            code = ord(ch)
            out.append(f"\\x{code:02X}" if code < 0x100 else f"\\u{code:04X}" if code < 0x10000 else f"\\U{code:08X}")
        else:
            out.append(ch)
    out.append('"')
    return "".join(out)


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float_text(value)
    if isinstance(value, str):
        return value if _plain_ok(value) else _quote(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML")


def _emit(node: Any, indent: int, out: List[str], lead: str) -> None:
    """Write ``node`` whose first line starts with ``lead`` (a key with its
    colon, a sequence dash, or nothing) at column ``indent``."""
    pad = " " * indent
    if isinstance(node, dict) and node:
        first = True
        for key, value in node.items():
            prefix = lead if first else pad
            first = False
            head = f"{prefix}{_scalar(key)}:"
            if isinstance(value, dict) and value:
                out.append(head)
                _emit(value, indent + 2, out, " " * (indent + 2))
            elif isinstance(value, list) and value:
                out.append(head)
                _emit(value, indent, out, pad)
            else:
                out.append(f"{head} {_inline(value)}")
        return
    if isinstance(node, list) and node:
        first = True
        for item in node:
            prefix = lead if first else pad
            first = False
            if isinstance(item, (dict, list)) and item:
                _emit(item, indent + 2, out, f"{prefix}- ")
            else:
                out.append(f"{prefix}- {_inline(item)}")
        return
    out.append(f"{lead}{_inline(node)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _scalar(value)


def dump(tree: Any) -> str:
    """``tree`` in block form, ending in a newline."""
    out: List[str] = []
    _emit(tree, 0, out, "")
    return "\n".join(out) + "\n"
