"""A reader for the YAML subset that scenario files use.

Scenario files (``data/*/sim_params.yaml``, and files written by the MCP
config tools) need only: block mappings and block sequences (including a
sequence at its key's indentation and nested ``- - x`` items), flow
sequences and mappings (``[0, 1]``, ``{a: 1}``), plain, single-quoted and
double-quoted scalars, and ``#`` comments.  Plain scalars resolve as
PyYAML's ``safe_load`` resolves them (YAML 1.1): null, booleans, ints
(decimal, ``0x``, ``0o``/leading-zero octal, ``0b``), and floats, which
need a ``.`` (``1e-5`` stays a string, ``1.0e-05`` is a float).

Anything outside the subset (block scalars ``|``/``>``, anchors, aliases,
tags, multi-line plain scalars) raises ``ValueError`` rather than being
read differently from a full YAML parser.
"""

import re

_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                     "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                     "off", "Off", "OFF"), False),
}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[01_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+|0o[0-7_]+)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0"}


def _resolve(s: str):
    """Plain scalar -> Python value (YAML 1.1 implicit types)."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v.startswith("0o"):
            return sign * int(v[2:], 8)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s[0] == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if s[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML syntax: {s!r}")
    return s


def _quoted(s: str, p: int):
    """Quoted scalar starting at s[p]; returns (value, end position)."""
    q = s[p]
    out = []
    p += 1
    while p < len(s):
        c = s[p]
        if q == "'" and c == "'":
            if s[p + 1:p + 2] == "'":
                out.append("'")
                p += 2
                continue
            return "".join(out), p + 1
        if q == '"' and c == '"':
            return "".join(out), p + 1
        if q == '"' and c == "\\":
            e = s[p + 1:p + 2]
            if e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(s[p + 2:p + 2 + n], 16)))
                p += 2 + n
                continue
            if e not in _ESCAPES:
                raise ValueError(f"bad escape in {s!r}")
            out.append(_ESCAPES[e])
            p += 2
            continue
        out.append(c)
        p += 1
    raise ValueError(f"unterminated quoted scalar: {s!r}")


def _strip_comment(line: str) -> str:
    q = None
    skip = False
    for i, c in enumerate(line):
        if skip:
            skip = False
        elif q:
            if (q == '"' and c == "\\") or (q == c == "'" and line[i + 1:i + 2] == "'"):
                skip = True
            elif c == q:
                q = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            q = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _skip_ws(s, p):
    while p < len(s) and s[p] in " \t":
        p += 1
    return p


def _flow(s: str, p: int, stops: str):
    """Flow node at s[p]; plain scalars end at any char in ``stops``."""
    p = _skip_ws(s, p)
    if p >= len(s):
        raise ValueError(f"unexpected end of flow collection: {s!r}")
    c = s[p]
    if c == "[":
        items = []
        p = _skip_ws(s, p + 1)
        while s[p:p + 1] != "]":
            v, p = _flow(s, p, ",]")
            items.append(v)
            p = _skip_ws(s, p)
            if s[p:p + 1] == ",":
                p = _skip_ws(s, p + 1)
            elif s[p:p + 1] != "]":
                raise ValueError(f"expected ',' or ']' in {s!r}")
        return items, p + 1
    if c == "{":
        out = {}
        p = _skip_ws(s, p + 1)
        while s[p:p + 1] != "}":
            k, p = _flow(s, p, ":,}")
            p = _skip_ws(s, p)
            if s[p:p + 1] != ":":
                raise ValueError(f"expected ':' in {s!r}")
            v, p = _flow(s, p + 1, ",}")
            out[k] = v
            p = _skip_ws(s, p)
            if s[p:p + 1] == ",":
                p = _skip_ws(s, p + 1)
            elif s[p:p + 1] != "}":
                raise ValueError(f"expected ',' or '}}' in {s!r}")
        return out, p + 1
    if c in "'\"":
        return _quoted(s, p)
    end = p
    while end < len(s) and s[end] not in stops:
        end += 1
    return _resolve(s[p:end].strip()), end


def _inline(s: str):
    """A whole value written on one line (scalar or flow collection)."""
    if s[0] in "[{'\"":
        v, end = _flow(s, 0, "")
        if s[end:].strip():
            raise ValueError(f"trailing characters after {s!r}")
        return v
    return _resolve(s)


def _split_key(s: str):
    """``key: rest`` -> (key, rest); None when ``s`` is not a map entry."""
    if s[0] in "'\"":
        key, p = _quoted(s, 0)
    else:
        if s[0] in "[{":
            return None
        m = re.match(r"(.*?):(?:\s|$)", s)
        if m is None or m.group(1).startswith("- "):
            return None
        key, p = _resolve(m.group(1).strip()), m.end(1)
    if s[p:p + 1] != ":" or (len(s) > p + 1 and s[p + 1] not in " \t"):
        return None
    return key, s[p + 1:].strip()


def _is_item(s: str) -> bool:
    return s == "-" or s.startswith("- ")


def _node(lines, i, indent):
    s = lines[i][1]
    if _is_item(s):
        return _seq(lines, i, indent)
    if _split_key(s) is not None:
        return _map(lines, i, indent)
    return _inline(s), i + 1


def _child(lines, i, indent, allow_same_indent_seq):
    """Value of an entry whose inline part was empty: the block below."""
    if i < len(lines):
        ind, s = lines[i]
        if ind > indent or (allow_same_indent_seq and ind == indent and _is_item(s)):
            return _node(lines, i, ind)
    return None, i


def _seq(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        s = lines[i][1]
        rest = s[1:].lstrip()
        if rest:
            # the item's content starts a node at its own column
            lines[i] = (indent + len(s) - len(rest), rest)
            val, i = _node(lines, i, lines[i][0])
        else:
            val, i = _child(lines, i + 1, indent, False)
        out.append(val)
    _check_dedent(lines, i, indent)
    return out, i


def _map(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        if rest:
            val, i = _inline(rest), i + 1
        else:
            val, i = _child(lines, i + 1, indent, True)
        out[key] = val
    _check_dedent(lines, i, indent)
    return out, i


def _check_dedent(lines, i, indent):
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")


def safe_load(stream):
    """Parse YAML text (or a readable file) in the subset above."""
    text = stream.read() if hasattr(stream, "read") else stream
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs are not allowed in YAML indentation")
        s = _strip_comment(raw).rstrip()
        if not s.strip() or s in ("---", "..."):
            continue
        lines.append((len(s) - len(s.lstrip(" ")), s.strip()))
    if not lines:
        return None
    value, i = _node(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected content at {lines[i][1]!r}")
    return value
