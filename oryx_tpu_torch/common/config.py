"""Configuration system: a HOCON-subset tree with overlay, defaults, serialization.

A copy of the JAX package's
``oryx_tpu/common/config.py``
(host code, no JAX), held equal to it by ``tests/test_torch_kmeans.py``.
Below, "the reference" is the original Oryx that module was modelled on.

The original is a TPU-native re-design of the reference's Typesafe-Config-based settings layer
(reference: framework/oryx-common/src/main/java/com/cloudera/oryx/common/settings/
ConfigUtils.java:59-154 and framework/oryx-common/src/main/resources/reference.conf).

The whole framework is configured from a single ``oryx.*`` tree. Supports:
  * parsing a practical HOCON subset (comments, nested objects, dotted keys,
    ``=``/``:`` separators, lists, quoted/unquoted scalars, ``${path}``
    substitutions against the merged tree),
  * overlaying one config on another (``ConfigUtils.overlayOn``),
  * JSON string (de)serialization so config can cross process/task boundaries
    (``ConfigUtils.serialize/deserialize`` — the serving layer passes config to
    the HTTP app this way),
  * redacting pretty-print for startup logging (``ConfigUtils.prettyPrint``),
  * key-value → flat properties (``ConfigToProperties``) for CLI use.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterator


class ConfigError(Exception):
    """Raised for missing keys, type errors, or parse errors."""


# ---------------------------------------------------------------------------
# HOCON-subset parser
# ---------------------------------------------------------------------------

_SUBST_RE = re.compile(r"\$\{(\??)([^}]+)\}")


class _Parser:
    """Recursive-descent parser for the HOCON subset used by oryx configs."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    # -- low-level helpers --------------------------------------------------
    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < self.n else ""

    def _skip_ws_and_comments(self, stop_at_newline: bool = False) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c == "\n":
                if stop_at_newline:
                    return
                self.pos += 1
            elif c.isspace():
                self.pos += 1
            else:
                return

    def parse_root(self) -> dict:
        self._skip_ws_and_comments()
        if self._peek() == "{":
            return self.parse_object()
        # root-level braceless object (standard HOCON)
        return self.parse_object(braceless=True)

    def parse_object(self, braceless: bool = False) -> dict:
        obj: dict = {}
        if not braceless:
            assert self._peek() == "{"
            self.pos += 1
        while True:
            self._skip_ws_and_comments()
            if self.pos >= self.n:
                if braceless:
                    return obj
                raise ConfigError("unexpected end of input in object")
            c = self._peek()
            if c == "}":
                self.pos += 1
                return obj
            if c == ",":
                self.pos += 1
                continue
            key = self._parse_key()
            self._skip_ws_and_comments()
            c = self._peek()
            if c == "{":
                value = self.parse_object()
            else:
                if c in "=:":
                    self.pos += 1
                    self._skip_ws_and_comments()
                value = self._parse_value()
            _set_path(obj, key.split("."), value, merge=True)

    def _parse_key(self) -> str:
        self._skip_ws_and_comments()
        c = self._peek()
        if c in "\"'":
            return self._parse_quoted()
        start = self.pos
        while self.pos < self.n and self.text[self.pos] not in "=:{}\n," and not self.text[self.pos].isspace():
            self.pos += 1
        key = self.text[start:self.pos]
        if not key:
            raise ConfigError(f"empty key at position {start}")
        return key

    def _parse_quoted(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c == "\\" and self.pos + 1 < self.n:
                nxt = self.text[self.pos + 1]
                out.append({"n": "\n", "t": "\t", '"': '"', "'": "'", "\\": "\\"}.get(nxt, nxt))
                self.pos += 2
            elif c == quote:
                self.pos += 1
                return "".join(out)
            else:
                out.append(c)
                self.pos += 1
        raise ConfigError("unterminated string")

    def _parse_value(self) -> Any:
        self._skip_ws_and_comments()
        c = self._peek()
        if c == "{":
            return self.parse_object()
        if c == "[":
            return self._parse_list()
        if c in "\"'":
            s = self._parse_quoted()
            # adjacent-string concatenation is not needed for oryx configs
            return s
        # unquoted scalar: read until newline/comma/brace/comment;
        # ${...} substitution tokens consume through their closing brace
        start = self.pos
        while self.pos < self.n:
            if self.text.startswith("${", self.pos):
                end = self.text.find("}", self.pos)
                if end == -1:
                    raise ConfigError("unterminated substitution")
                self.pos = end + 1
                continue
            ch = self.text[self.pos]
            if ch in "\n,]}" or ch == "#" or self.text.startswith("//", self.pos):
                break
            self.pos += 1
        raw = self.text[start:self.pos].strip()
        return _coerce_scalar(raw)

    def _parse_list(self) -> list:
        assert self._peek() == "["
        self.pos += 1
        items: list = []
        while True:
            self._skip_ws_and_comments()
            if self.pos >= self.n:
                raise ConfigError("unterminated list")
            c = self._peek()
            if c == "]":
                self.pos += 1
                return items
            if c == ",":
                self.pos += 1
                continue
            items.append(self._parse_value())


def _coerce_scalar(raw: str) -> Any:
    if raw == "" or raw.lower() == "null":
        return None
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _set_path(obj: dict, path: list[str], value: Any, merge: bool = False) -> None:
    cur = obj
    for part in path[:-1]:
        nxt = cur.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[part] = nxt
        cur = nxt
    last = path[-1]
    if merge and isinstance(value, dict) and isinstance(cur.get(last), dict):
        _deep_merge(cur[last], value)
    else:
        cur[last] = value


def _deep_merge(base: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _resolve_substitutions(tree: dict) -> None:
    """Resolve ${a.b.c} substitutions against the merged tree (one pass + fixpoint)."""

    def lookup(path: str) -> Any:
        cur: Any = tree
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                raise KeyError(path)
            cur = cur[part]
        return cur

    def resolve(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _SUBST_RE.fullmatch(node.strip())
            if m:
                try:
                    return lookup(m.group(2).strip())
                except KeyError:
                    if m.group(1):  # ${?optional}
                        return None
                    raise ConfigError(f"unresolved substitution: {node}") from None

            def repl(mm: re.Match) -> str:
                try:
                    return str(lookup(mm.group(2).strip()))
                except KeyError:
                    if mm.group(1):
                        return ""
                    raise ConfigError(f"unresolved substitution: {mm.group(0)}") from None

            return _SUBST_RE.sub(repl, node)
        return node

    for _ in range(4):  # nested substitution fixpoint; oryx configs need depth ≤ 2
        new = resolve(tree)
        if new == tree:
            break
        tree.clear()
        tree.update(new)


# ---------------------------------------------------------------------------
# Config object
# ---------------------------------------------------------------------------

_REDACT_RE = re.compile(r"password|secret|keystore", re.IGNORECASE)


class Config:
    """Immutable-ish view over a nested dict with dotted-path access."""

    def __init__(self, tree: dict | None = None):
        self._tree = tree or {}

    # -- construction -------------------------------------------------------
    @staticmethod
    def parse_string(text: str) -> "Config":
        tree = _Parser(text).parse_root()
        _resolve_substitutions(tree)
        return Config(tree)

    @staticmethod
    def parse_file(path: str) -> "Config":
        with open(path, "r", encoding="utf-8") as f:
            return Config.parse_string(f.read())

    @staticmethod
    def from_dict(d: dict) -> "Config":
        tree: dict = {}
        for k, v in d.items():
            _set_path(tree, str(k).split("."), v, merge=True)
        _resolve_substitutions(tree)
        return Config(tree)

    # -- access -------------------------------------------------------------
    def _lookup(self, path: str) -> Any:
        cur: Any = self._tree
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                raise ConfigError(f"missing config key: {path}")
            cur = cur[part]
        return cur

    def has(self, path: str) -> bool:
        try:
            return self._lookup(path) is not None
        except ConfigError:
            return False

    def get(self, path: str, default: Any = ...) -> Any:
        try:
            return self._lookup(path)
        except ConfigError:
            if default is ...:
                raise
            return default

    def get_string(self, path: str, default: Any = ...) -> str:
        v = self.get(path, default)
        return v if v is None else str(v)

    def get_int(self, path: str, default: Any = ...) -> int:
        v = self.get(path, default)
        return v if v is None else int(v)

    def get_float(self, path: str, default: Any = ...) -> float:
        v = self.get(path, default)
        return v if v is None else float(v)

    def get_bool(self, path: str, default: Any = ...) -> bool:
        v = self.get(path, default)
        if isinstance(v, str):
            return v.lower() == "true"
        return bool(v)

    def get_list(self, path: str, default: Any = ...) -> list:
        v = self.get(path, default)
        if v is None:
            return v
        if not isinstance(v, list):
            return [v]
        return v

    def get_config(self, path: str) -> "Config":
        v = self._lookup(path)
        if not isinstance(v, dict):
            raise ConfigError(f"not a config object: {path}")
        return Config(v)

    def as_dict(self) -> dict:
        return json.loads(json.dumps(self._tree))  # deep copy

    def flatten(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        def walk(node: dict, pre: str) -> Iterator[tuple[str, Any]]:
            for k in sorted(node):
                v = node[k]
                kk = f"{pre}{k}"
                if isinstance(v, dict):
                    yield from walk(v, kk + ".")
                else:
                    yield kk, v

        yield from walk(self._tree, prefix)

    # -- overlay / serialize ------------------------------------------------
    def overlay_on(self, base: "Config") -> "Config":
        """Return base ⊕ self (self wins), like ConfigUtils.overlayOn."""
        merged = base.as_dict()
        _deep_merge(merged, self.as_dict())
        return Config(merged)

    def with_values(self, kv: dict) -> "Config":
        return Config.from_dict(kv).overlay_on(self)

    def serialize(self) -> str:
        return json.dumps(self._tree)

    @staticmethod
    def deserialize(s: str) -> "Config":
        return Config(json.loads(s))

    def pretty_print(self, root: str = "oryx") -> str:
        """Config dump with secret redaction, for startup logging."""
        lines = []
        sub = self.get_config(root) if self.has(root) else self
        for k, v in sub.flatten(prefix=f"{root}." if self.has(root) else ""):
            shown = "*****" if _REDACT_RE.search(k) else json.dumps(v)
            lines.append(f"{k} = {shown}")
        return "\n".join(lines)

    def to_properties(self, prefix: str = "oryx") -> dict[str, str]:
        """Flat key→string map of one subtree (ConfigToProperties equivalent)."""
        out = {}
        for k, v in self.flatten():
            if k.startswith(prefix):
                out[k] = json.dumps(v) if isinstance(v, list) else ("" if v is None else str(v))
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self._tree!r})"


# ---------------------------------------------------------------------------
# Defaults + module-level helpers (ConfigUtils equivalents)
# ---------------------------------------------------------------------------

_default_config: Config | None = None


def get_default() -> Config:
    """The reference config tree overlaid with any user overrides already applied
    by the CLI; equivalent of ConfigUtils.getDefault (reference ConfigUtils.java:59)."""
    global _default_config
    if _default_config is None:
        from oryx_tpu_torch.common import reference_conf

        _default_config = Config.parse_string(reference_conf.REFERENCE_CONF)
    return _default_config


def overlay_on(overlay: dict | Config, underlying: Config) -> Config:
    if isinstance(overlay, dict):
        overlay = Config.from_dict(overlay)
    return overlay.overlay_on(underlying)


def key_value_to_properties(*kv: Any) -> dict[str, str]:
    if len(kv) % 2:
        raise ValueError("odd number of key-value elements")
    return {str(kv[i]): str(kv[i + 1]) for i in range(0, len(kv), 2)}
