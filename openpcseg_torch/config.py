"""Config system: YAML file -> attribute dict, with base-file inheritance.

Counterpart of ``openpcseg_tpu/config.py``: ``CfgDict``,
``merge_new_config`` (``_BASE_CONFIG_``), ``cfg_from_yaml_file`` (``TAG``,
``EXP_GROUP_PATH``), ``cfg_from_list`` and ``log_config_to_file``.

The port does not use a yaml package. ``load_yaml`` reads the subset of
YAML that ``tools/cfgs/**/*.yaml`` is written in, and gives the same dicts
as ``yaml.safe_load`` there:

- block mappings nested by indentation (spaces), ``key: value`` and
  ``key:`` followed by a deeper block (or nothing: None);
- flow lists ``[a, b]`` and flow mappings ``{'k': v}``, nested, on one line;
- single- and double-quoted strings and bare strings;
- ints, and floats with a dot or an exponent (``0.0001``, ``1.``,
  ``1e-4``; yaml 1.1 reads ``1e-4`` as a string, this reader as a float);
- ``True``/``False`` (any case), ``None``/``null``/``~``, ``#`` comments.

Anything else (block lists ``- x``, anchors, tags, multi-line scalars,
tabs, ``yes``/``no``/``on``/``off``, octal-looking ints, several
documents) raises ``ConfigError`` naming the file and line.
"""
from __future__ import annotations

import ast
import copy
import re
from pathlib import Path
from typing import Any, List, Tuple


class ConfigError(ValueError):
    """A config file outside the YAML subset this reader takes."""


class CfgDict(dict):
    """dict with attribute access, recursively converting nested mappings."""

    def __init__(self, d: dict | None = None):
        super().__init__()
        if d:
            for k, v in d.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, dict) and not isinstance(value, CfgDict):
            value = CfgDict(value)
        elif isinstance(value, (list, tuple)):
            value = type(value)(
                CfgDict(v) if isinstance(v, dict) and not isinstance(v, CfgDict)
                else v for v in value)
        super().__setitem__(key, value)

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:  # attribute protocol expects AttributeError
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        out = CfgDict()
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


# ------------------------------------------------------------ the reader --

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+|[0-9]+)([eE][-+]?[0-9]+)?$")
_BOOL = {"true": True, "false": False}
_NULL = ("~", "null", "Null", "NULL", "None")
# plain scalars yaml 1.1 reads as something other than a string
_AMBIGUOUS = {"yes", "no", "on", "off", ".inf", "-.inf", "+.inf", ".nan"}
_INDICATORS = tuple("&*!|>%@`-?")


def _scalar(text: str, where: str) -> Any:
    """A plain (unquoted) scalar: bool, None, int, float or string."""
    if text.lower() in _BOOL:
        return _BOOL[text.lower()]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text)
    if re.match(r"[-+]?0[0-9]", text) and re.match(r"[-+0-9._]+$", text):
        raise ConfigError(f"{where}: {text!r} (a number with a leading 0) "
                          "is outside the config subset")
    if _FLOAT.match(text) and ("." in text or "e" in text.lower()):
        return float(text)
    if text.lower() in _AMBIGUOUS or text.startswith(_INDICATORS) or any(
            s in text for s in (": ", " #", "\t")) or text.endswith(":"):
        raise ConfigError(f"{where}: plain scalar {text!r} is outside the "
                          "config subset (quote it)")
    return text


class _Flow:
    """Recursive-descent reader of one line's value: a quoted string, a
    flow list or mapping, or a plain scalar."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def fail(self, what: str):
        raise ConfigError(f"{self.where}: {what} at column {self.i + 1} of "
                          f"{self.s!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def value(self, in_flow: bool) -> Any:
        self.ws()
        c = self.peek()
        if c == "[":
            return self.seq()
        if c == "{":
            return self.mapping()
        if c in ("'", '"'):
            return self.quoted()
        stop = ",]}" if in_flow else ""
        j = self.i
        while j < len(self.s) and self.s[j] not in stop and not (
                in_flow and self.s[j] == ":" and self.s[j + 1:j + 2] in
                (" ", "")):
            j += 1
        text = self.s[self.i:j].strip()
        if not text:
            self.fail("empty value")
        self.i = j
        return _scalar(text, self.where)

    def quoted(self) -> str:
        q = self.s[self.i]
        out, j = [], self.i + 1
        while j < len(self.s):
            c = self.s[j]
            if q == "'" and c == "'":
                if self.s[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                self.i = j + 1
                return "".join(out)
            if q == '"' and c == "\\":
                esc = {"\\": "\\", '"': '"', "n": "\n", "t": "\t", "/": "/"}
                nxt = self.s[j + 1:j + 2]
                if nxt not in esc:
                    self.i = j
                    self.fail(f"escape \\{nxt} outside the config subset")
                out.append(esc[nxt])
                j += 2
                continue
            if q == '"' and c == '"':
                self.i = j + 1
                return "".join(out)
            out.append(c)
            j += 1
        self.fail("unterminated quoted string")

    def seq(self) -> list:
        self.i += 1
        out = []
        self.ws()
        if self.peek() == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(in_flow=True))
            self.ws()
            c = self.peek()
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                self.i -= 1
                self.fail("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        self.ws()
        if self.peek() == "}":
            self.i += 1
            return out
        while True:
            key = self.value(in_flow=True)
            self.ws()
            if self.peek() != ":":
                self.fail("expected ':'")
            self.i += 1
            if key in out:
                self.fail(f"duplicate key {key!r}")
            out[key] = self.value(in_flow=True)
            self.ws()
            c = self.peek()
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                self.i -= 1
                self.fail("expected ',' or '}'")

    def whole(self) -> Any:
        v = self.value(in_flow=False)
        self.ws()
        if self.i != len(self.s):
            self.fail("trailing text")
        return v


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (a ``#`` at the start or after a
    space, outside quotes) and without trailing spaces."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(body: str, where: str) -> Tuple[Any, str]:
    """'key: rest' -> (key, rest); the key may be quoted."""
    p = _Flow(body, where)
    if body[:1] in ("'", '"'):
        key = p.quoted()
        if body[p.i:p.i + 1] != ":":
            p.fail("expected ':' after the key")
        colon = p.i
    else:
        m = re.search(r":( |$)", body)
        if m is None:
            raise ConfigError(f"{where}: expected 'key: value', got {body!r}")
        colon = m.start()
        key = _scalar(body[:colon].strip(), where)
    return key, body[colon + 1:].strip()


def load_yaml(text: str, source: str = "<string>") -> dict:
    """Parse the config subset of YAML (module docstring): a block mapping
    of dicts, lists and scalars; an empty document gives {}."""
    lines: List[Tuple[int, int, str]] = []  # (line number, indent, body)
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigError(f"{where}: tab in the indentation")
        body = _strip_comment(raw)
        if not body.strip():
            continue
        if body.strip() in ("---", "...") or body.startswith("%"):
            raise ConfigError(f"{where}: document markers and directives "
                              "are outside the config subset")
        indent = len(body) - len(body.lstrip(" "))
        lines.append((n, indent, body.strip()))
    if not lines:
        return {}
    value, pos = _block(lines, 0, lines[0][1], source)
    if pos != len(lines):
        n = lines[pos][0]
        raise ConfigError(f"{source}:{n}: indentation does not match any "
                          "enclosing block")
    return value


def _block(lines, pos: int, indent: int, source: str):
    """The block mapping whose keys sit at column `indent`, from lines[pos];
    returns (dict, index of the first line after it)."""
    out: dict = {}
    while pos < len(lines):
        n, ind, body = lines[pos]
        where = f"{source}:{n}"
        if ind < indent:
            break
        if ind > indent:
            raise ConfigError(f"{where}: unexpected indentation")
        if body.startswith("- ") or body == "-":
            raise ConfigError(f"{where}: block lists are outside the config "
                              "subset (write [a, b])")
        key, rest = _split_key(body, where)
        if key in out:
            raise ConfigError(f"{where}: duplicate key {key!r}")
        pos += 1
        if rest:
            out[key] = _Flow(rest, where).whole()
        elif pos < len(lines) and lines[pos][1] > indent:
            out[key], pos = _block(lines, pos, lines[pos][1], source)
        else:
            out[key] = None
    return out, pos


def load_yaml_file(path: str | Path) -> dict:
    path = Path(path)
    return load_yaml(path.read_text(), str(path))


# ------------------------------------------------------------ the config --

def merge_new_config(config: CfgDict, new_config: dict) -> CfgDict:
    """Recursive merge with ``_BASE_CONFIG_`` inheritance: a
    ``_BASE_CONFIG_`` key loads the base file first, then the rest
    overlays it."""
    if "_BASE_CONFIG_" in new_config:
        config.update(CfgDict(load_yaml_file(new_config["_BASE_CONFIG_"])))

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict) and isinstance(config.get(key), dict):
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file: str | Path,
                       config: CfgDict | None = None) -> CfgDict:
    """Load an experiment config; TAG is the file's stem, EXP_GROUP_PATH
    its directory below the last ``cfgs`` (else the directory's name)."""
    config = config if config is not None else CfgDict()
    merge_new_config(config, load_yaml_file(cfg_file))
    cfg_file = Path(cfg_file)
    config["TAG"] = cfg_file.stem
    parts = cfg_file.parent.parts
    if "cfgs" in parts:
        idx = len(parts) - 1 - parts[::-1].index("cfgs")
        config["EXP_GROUP_PATH"] = "/".join(parts[idx + 1:])
    else:
        config["EXP_GROUP_PATH"] = cfg_file.parent.name
    return config


def _parse_value(v: str) -> Any:
    """A command-line value: a Python literal (lists, numbers incl. 1e-3,
    True/False/None), else a YAML scalar or flow value, else the string."""
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        pass
    try:
        return _Flow(v, "<override>").whole()
    except ConfigError:
        return v


def cfg_from_list(cfg_list: List[str], config: CfgDict) -> None:
    """Apply dotted-key overrides, e.g. ``OPTIM.BATCH_SIZE_PER_GPU 4``."""
    if len(cfg_list) % 2:
        raise ValueError(f"override list must be KEY VALUE pairs: {cfg_list}")
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        keys = full_key.split(".")
        d = config
        for sub in keys[:-1]:
            if sub not in d:
                d[sub] = CfgDict()
            d = d[sub]
        value = _parse_value(v)
        key = keys[-1]
        if (key in d and isinstance(d[key], (list, tuple))
                and not isinstance(value, (list, tuple))):
            raise ValueError(f"type mismatch for override {full_key}")
        d[key] = value


def log_config_to_file(cfg: CfgDict, pre: str = "cfg", logger=None) -> None:
    """Pretty-print the config tree."""
    emit = logger.info if logger is not None else print
    for key, val in cfg.items():
        if isinstance(val, dict):
            emit(f"\n{pre}.{key} = edict()")
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
        else:
            emit(f"{pre}.{key}: {val}")
