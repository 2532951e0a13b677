# Copyright (c) ava256_tpu contributors.
# All rights reserved.
#
# This source code is licensed under the license found in the
# LICENSE file in the root directory of this source tree.
"""Config system, as ``ava256_tpu.config``: YAML files + dot-path CLI
overrides, in a nested attribute dict.

The port reads YAML without PyYAML, with a small parser for the subset the
files under ``configs/`` use: block mappings nested by indentation, ``#``
comments (also after a value), quoted and bare strings, flow lists
(``["irgbrec", "primscale"]``) and YAML 1.1's plain scalars as PyYAML's
``safe_load`` resolves them (``true``/``yes``/``on``, ``null``/``~``, ints,
floats such as ``2.0e-4``; note that ``1e-3``, without a dot, stays a string
there). Anything else (block sequences, flow mappings, anchors, tags, block
scalars, multi-line values, timestamps) raises ``YamlSubsetError``: the
parser does not guess.
"""

from __future__ import annotations

import ast
import logging
import re
from typing import Any, Dict, List, Optional, Tuple


class YamlSubsetError(ValueError):
    """YAML outside the subset this parser reads."""


_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_NULL = ("", "~", "null", "Null", "NULL")
# PyYAML's implicit resolvers for YAML 1.1 (yaml/resolver.py)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_INDICATORS = "[]{}&*!|>%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _sexagesimal(value: str, number) -> Any:
    sign = -1 if value.startswith("-") else 1
    total = 0
    for part in value.lstrip("+-").split(":"):
        total = total * 60 + number(part)
    return sign * total


def resolve_scalar(text: str) -> Any:
    """A plain (unquoted) scalar as PyYAML's safe_load resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        if ":" in v:
            return _sexagesimal(v, int)
        sign, digits = (-1, v[1:]) if v[0] == "-" else (1, v.lstrip("+"))
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.lstrip("+-") == ".inf":
            return float("-inf") if v[0] == "-" else float("inf")
        if v == ".nan":
            return float("nan")
        return _sexagesimal(v, float) if ":" in v else float(v)
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise YamlSubsetError(f"scalar {text!r}: timestamps, merge and value keys are not read")
    if text[0] in _INDICATORS or text.startswith(("- ", "? ", "--- ", "...")) or text == "-":
        raise YamlSubsetError(f"scalar {text!r} starts with an indicator this parser does not read")
    return text


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i]; returns (value, index after it)."""
    q = s[i]
    out: List[str] = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1:j + 2]
            if e not in _ESCAPES:
                raise YamlSubsetError(f"escape \\{e} is not read: {s!r}")
            out.append(_ESCAPES[e])
            j += 2
            continue
        out.append(c)
        j += 1
    raise YamlSubsetError(f"unterminated quoted scalar (multi-line values are not read): {s!r}")


def _strip_comment(s: str) -> str:
    """s without a trailing ``# comment`` (a '#' at the start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or s[i - 1] in " \t[,:"):
            i = _quoted(s, i)[1]
            continue
        if c == "#" and (i == 0 or s[i - 1] in " \t"):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _flow_list(s: str, i: int) -> Tuple[list, int]:
    """The flow sequence starting at s[i] == '['."""
    out: list = []
    j = i + 1
    while True:
        while j < len(s) and s[j] in " \t":
            j += 1
        if j >= len(s):
            raise YamlSubsetError(f"unterminated flow list (multi-line values are not read): {s!r}")
        if s[j] == "]" and not out:
            return out, j + 1
        if s[j] == "[":
            item, j = _flow_list(s, j)
        elif s[j] in "'\"":
            item, j = _quoted(s, j)
        elif s[j] == "{":
            raise YamlSubsetError(f"flow mappings are not read: {s!r}")
        else:
            k = j
            while k < len(s) and s[k] not in ",]":
                k += 1
            text = s[j:k].strip()
            if not text or ": " in text or text.endswith(":"):
                raise YamlSubsetError(f"flow list item {text!r} is not read: {s!r}")
            item, j = resolve_scalar(text), k
        out.append(item)
        while j < len(s) and s[j] in " \t":
            j += 1
        if j < len(s) and s[j] == ",":
            j += 1
        elif j < len(s) and s[j] == "]":
            return out, j + 1
        else:
            raise YamlSubsetError(f"malformed flow list: {s!r}")


def parse_value(text: str) -> Any:
    """One value (the text after ``key:`` or a whole one-line document),
    comment already stripped."""
    text = text.strip()
    if not text:
        return None
    if text[0] in "'\"":
        value, end = _quoted(text, 0)
    elif text[0] == "[":
        value, end = _flow_list(text, 0)
    else:
        if ": " in text or text.endswith(":"):
            raise YamlSubsetError(f"a mapping on one line is not read: {text!r}")
        return resolve_scalar(text)
    if text[end:].strip():
        raise YamlSubsetError(f"text after a closed value: {text!r}")
    return value


def _split_key(body: str, lineno: int) -> Tuple[str, str]:
    if body[0] in "'\"":
        key, end = _quoted(body, 0)
        rest = body[end:]
        if not rest.startswith(":"):
            raise YamlSubsetError(f"line {lineno}: expected ':' after the key: {body!r}")
        return key, rest[1:]
    m = re.match(r"^([^:#]+?):(?:\s|$)", body)
    if m is None or body[0] in _INDICATORS or body.startswith(("? ", "-")):
        raise YamlSubsetError(f"line {lineno}: not a 'key: value' line: {body!r}")
    return m.group(1), body[m.end(1) + 1:]


def parse_yaml(text: str) -> Optional[Dict[str, Any]]:
    """A YAML document of nested block mappings (see the module docstring)
    -> nested dicts. An empty document gives None, as safe_load does."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {n}: tab in the indentation")
        body = _strip_comment(raw.strip())
        if not body:
            continue
        if body.startswith(("---", "...", "%")):
            raise YamlSubsetError(f"line {n}: document markers and directives are not read")
        lines.append((n, len(raw) - len(raw.lstrip(" ")), body))
    if not lines:
        return None

    def block(start: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        i = start
        while i < len(lines):
            n, ind, body = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"line {n}: unexpected indentation")
            key, rest = _split_key(body, n)
            if key in out:
                raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
            rest = rest.strip()
            if rest and (rest[0] in "&*!|>"):
                raise YamlSubsetError(f"line {n}: anchors, tags and block scalars are not read")
            i += 1
            if rest:
                out[key] = parse_value(rest)
            elif i < len(lines) and lines[i][1] > indent:
                out[key], i = block(i, lines[i][1])
            else:
                out[key] = None
        return out, i

    doc, end = block(0, lines[0][1])
    if end != len(lines):
        raise YamlSubsetError(f"line {lines[end][0]}: indentation does not match a parent key")
    return doc


class Config(dict):
    """Nested dict with attribute access and dot-path merging."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def from_nested(cls, d: Dict[str, Any]) -> "Config":
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_nested(v) if isinstance(v, dict) else v
        return out

    def merge_dotted(self, overrides: List[str]) -> "Config":
        """Apply ["a.b.c=value", ...] or ["a.b.c", "value", ...] overrides.
        A value is read as a Python literal first, then by the YAML scalar
        rules (``false``, ``null``, ``yes``), else kept as the raw string."""
        pairs: List[tuple] = []
        i = 0
        while i < len(overrides):
            if "=" in overrides[i]:
                k, v = overrides[i].split("=", 1)
                pairs.append((k, v))
                i += 1
            else:
                pairs.append((overrides[i], overrides[i + 1]))
                i += 2
        for key, raw in pairs:
            node = self
            parts = key.split(".")
            known = True
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = Config()
                    known = False
                node = node[p]
            if known and parts[-1] not in node:
                known = False
            if not known:
                # a typo'd override (train.outdir=...) would otherwise be a
                # silent no-op: the key is created but nothing reads it
                logging.warning(
                    "config override %r creates a new key not present in the "
                    "YAML — check for a typo (e.g. progress.output_path, not "
                    "outdir)",
                    key,
                )
            try:
                val = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                try:
                    val = parse_value(_strip_comment(raw.strip()))
                except YamlSubsetError:
                    val = raw
            node[parts[-1]] = val
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v for k, v in self.items()}


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    with open(path, "r") as f:
        cfg = Config.from_nested(parse_yaml(f.read()) or {})
    if overrides:
        cfg.merge_dotted(overrides)
    return cfg
