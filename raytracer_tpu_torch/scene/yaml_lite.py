"""A reader for the subset of YAML that scene files use, with no PyYAML.

Supported: block sequences and block mappings by indentation (a sequence
may sit at its key's indentation), single-line flow sequences ``[...]``
(nested too, with ``[a: 1]`` single-pair mappings) and flow mappings
``{...}``, plain and quoted scalars, ``#`` comments and blank lines.

Plain scalars resolve as PyYAML's SafeLoader resolves them (YAML 1.1):
``true/false/yes/no/on/off`` (three spellings each) are booleans, ``~``,
``null`` and an empty value are None, decimal integers are ints, floats
need a ``.`` (``1e3`` stays a string, the exponent needs a sign), and
``.inf``/``.nan`` are floats. Double-quoted scalars take the escapes
``\\\\``, ``\\"``, ``\\/``, ``\\n``, ``\\t`` and ``\\r``.

Everything else raises ValueError naming the line: anchors, aliases, tags,
block scalars, multi-line flow collections, quoted or plain scalars that
run onto the next line, documents (``---``), directives, complex keys,
merge keys, any other escape, and every plain scalar that PyYAML would
read as a number or timestamp in another form (``0x1F``, ``012``,
``1_000``, ``1:20``, ``2001-12-14``). No construct is read differently
from PyYAML without an error.
"""

from __future__ import annotations

import re

__all__ = ["load"]

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?")
_SPECIAL = re.compile(r"([-+]?)\.(?:inf|Inf|INF)|\.(nan|NaN|NAN)")
# everything PyYAML's int, float and timestamp resolvers (resolver.py) take
_PYYAML_OTHER = re.compile(r"""(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?(?:(?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?
    |<<|=)""", re.X)
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r"}
_SPACE = " \t"


def _resolve(s, err):
    """A plain scalar's value, as PyYAML's SafeLoader gives it."""
    if s in _BOOL:
        return _BOOL[s]
    if s in _NULL:
        return None
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    m = _SPECIAL.fullmatch(s)
    if m:
        return float("nan") if m[2] else float(m[1] + "inf")
    if _PYYAML_OTHER.fullmatch(s):
        err(f"unsupported scalar {s!r} (a number form other than decimal, "
            f"a timestamp or a merge key)")
    return s


class _Reader:
    def __init__(self, text):
        self.lines = []                       # [lineno, indent, content]
        for no, raw in enumerate(
                re.split("\r\n|[\r\n\x85\u2028\u2029]", text), 1):
            body = raw.lstrip(" ")
            if not body.strip(_SPACE) or body.lstrip(_SPACE)[0] == "#":
                continue
            if body[0] == "\t":
                self._fail(no, "tab in indentation")
            if raw[0] == "%" or re.match(r"(---|\.\.\.)(\s|$)", raw):
                self._fail(no, "directives and document markers are not "
                               "supported")
            self.lines.append([no, len(raw) - len(body), body.rstrip(_SPACE)])
        self.i = 0

    @staticmethod
    def _fail(no, msg):
        raise ValueError(f"yaml_lite: line {no}: {msg}")

    # -- block structure --------------------------------------------------

    def document(self):
        if not self.lines:
            return None
        value = self.node(-1)
        if self.i < len(self.lines):
            self._fail(self.lines[self.i][0], "unexpected content")
        return value

    def node(self, parent):
        """The block node that starts on line i (indent > parent)."""
        no, ind, text = self.lines[self.i]
        if _is_seq_entry(text):
            return self.sequence(ind)
        key = self._key(no, text)
        if key is not None:
            return self.mapping(ind)
        value = self.inline(no, text, 0)
        self.i += 1
        self._no_continuation(parent)
        return value

    def _no_continuation(self, indent):
        if self.i < len(self.lines) and self.lines[self.i][1] > indent:
            self._fail(self.lines[self.i][0], "unexpected indentation (a "
                       "multi-line scalar is not supported)")

    def _child(self, indent, same_indent_seq):
        """The nested value of an empty ``key:`` or ``-`` at ``indent``."""
        if self.i >= len(self.lines):
            return None
        _, ind, text = self.lines[self.i]
        if ind > indent or (same_indent_seq and ind == indent
                            and _is_seq_entry(text)):
            return self.node(indent)
        return None

    def sequence(self, indent):
        out = []
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind != indent or not _is_seq_entry(text):
                break
            rest = text[1:].lstrip(_SPACE)
            if not rest or rest[0] == "#":
                self.i += 1
                out.append(self._child(indent, False))
                continue
            # the entry's content becomes a line of its own at its column
            self.lines[self.i] = [no, indent + len(text) - len(rest), rest]
            out.append(self.node(indent))
        return out

    def mapping(self, indent):
        out = {}
        while self.i < len(self.lines):
            no, ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                self._fail(no, "unexpected indentation")
            got = self._key(no, text)
            if got is None:
                if _is_seq_entry(text):
                    break                 # a same-indent sequence ends here
                self._fail(no, "expected 'key: value'")
            key, pos = got
            rest = text[pos:].lstrip(_SPACE)
            self.i += 1
            if not rest or rest[0] == "#":
                out[key] = self._child(indent, True)
                continue
            if _is_seq_entry(rest):
                self._fail(no, "a block sequence cannot start after 'key:'")
            out[key] = self.inline(no, text, len(text) - len(rest))
            self._no_continuation(indent)
        return out

    def _key(self, no, text):
        """(key, position after its ':') when the line is 'key: ...'."""
        if text[0] in "[{":
            _, pos = self.flow(no, text, 0)
            if _is_sep(text, _skip(text, pos)):
                self._fail(no, "flow collections as keys are not supported")
            return None
        if text[0] in "'\"":
            key, pos = self.quoted(no, text, 0)
            pos = _skip(text, pos)
            return (key, pos + 1) if _is_sep(text, pos) else None
        if text[0] == "?" and (len(text) == 1 or text[1] in _SPACE):
            self._fail(no, "complex keys are not supported")
        pos = 0
        while pos < len(text):
            if _is_sep(text, pos):
                key = text[:pos].rstrip(_SPACE)
                self._check_plain(no, key)
                return _resolve(key, lambda m: self._fail(no, m)), pos + 1
            if text[pos] == "#" and pos and text[pos - 1] in _SPACE:
                break
            pos += 1
        return None

    # -- inline values ----------------------------------------------------

    def inline(self, no, text, pos):
        """The value starting at ``pos``, which runs to the line's end (a
        comment may follow)."""
        c = text[pos]
        if c in "[{":
            value, end = self.flow(no, text, pos)
        elif c in "'\"":
            value, end = self.quoted(no, text, pos)
        else:
            end = len(text)
            m = re.search(r"[ \t]#", text[pos:])
            plain = text[pos: pos + m.start() if m else end].rstrip(_SPACE)
            if re.search(r":([ \t]|$)", plain):
                self._fail(no, "mapping values are not allowed here")
            self._check_plain(no, plain)
            return _resolve(plain, lambda m: self._fail(no, m))
        end = _skip(text, end)
        if end < len(text) and text[end] != "#":
            self._fail(no, f"unexpected {text[end:]!r} after a value")
        return value

    def _check_plain(self, no, s):
        if not s:
            return
        c = s[0]
        if c in "&*!":
            self._fail(no, "anchors, aliases and tags are not supported")
        if c in "|>":
            self._fail(no, "block scalars are not supported")
        if c in ",[]{}#%@`'\"" or (c in "-?:" and (len(s) == 1
                                                    or s[1] in _SPACE)):
            self._fail(no, f"a plain scalar cannot start with {c!r}")

    def quoted(self, no, text, pos):
        q = text[pos]
        out, i = [], pos + 1
        while i < len(text):
            c = text[i]
            if c == q:
                if q == "'" and text[i + 1: i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if c == "\\" and q == '"':
                e = text[i + 1: i + 2]
                if e not in _ESCAPES:
                    self._fail(no, f"unsupported escape in {text[pos:]!r}")
                out.append(_ESCAPES[e])
                i += 2
                continue
            out.append(c)
            i += 1
        self._fail(no, "a quoted scalar must end on its line")

    def flow(self, no, text, pos):
        """A flow collection that closes on this line -> (value, end)."""
        close = "]" if text[pos] == "[" else "}"
        out = [] if close == "]" else {}
        pos = _skip(text, pos + 1)
        while True:
            if pos >= len(text) or text[pos] == "#":
                self._fail(no, "flow collections must close on their line")
            if text[pos] == close:
                return out, pos + 1
            key, pos = self._flow_node(no, text, pos)
            pos = _skip(text, pos)
            value = None
            pair = text[pos: pos + 1] == ":"
            if pair:
                pos = _skip(text, pos + 1)
                if pos < len(text) and text[pos] not in ",]}#":
                    value, pos = self._flow_node(no, text, pos)
                    pos = _skip(text, pos)
            if close == "}":
                out[key] = value
            else:
                out.append({key: value} if pair else key)
            if text[pos: pos + 1] == ",":
                pos = _skip(text, pos + 1)
            elif text[pos: pos + 1] != close:
                self._fail(no, f"expected ',' or {close!r} in {text!r}")

    def _flow_node(self, no, text, pos):
        c = text[pos]
        if c in "[{":
            return self.flow(no, text, pos)
        if c in "'\"":
            return self.quoted(no, text, pos)
        end = pos
        while end < len(text):
            ch = text[end]
            if ch in ",[]{}" or (ch == "#" and text[end - 1] in _SPACE):
                break
            if ch == ":" and text[end + 1: end + 2] in ("", " ", "\t", ",",
                                                        "[", "]", "{", "}"):
                break
            end += 1
        plain = text[pos:end].rstrip(_SPACE)
        if not plain:
            self._fail(no, f"empty entry in {text!r}")
        self._check_plain(no, plain)
        return _resolve(plain, lambda m: self._fail(no, m)), end


def _skip(text, pos):
    while pos < len(text) and text[pos] in _SPACE:
        pos += 1
    return pos


def _is_sep(text, pos):
    """A mapping's ':' at ``pos`` (followed by a space or the line's end)."""
    return text[pos: pos + 1] == ":" and text[pos + 1: pos + 2] in ("", " ",
                                                                    "\t")


def _is_seq_entry(text):
    return text[0] == "-" and (len(text) == 1 or text[1] in _SPACE)


def load(text: str):
    """YAML text -> Python values (lists, dicts, str, int, float, bool,
    None), as ``yaml.safe_load`` reads the supported subset. Raises
    ValueError, naming the line, on anything outside it."""
    return _Reader(text).document()
