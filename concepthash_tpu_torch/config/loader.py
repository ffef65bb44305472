"""Hydra-style YAML config composition, self-contained (no hydra/omegaconf):
the port's own copy of concepthash_tpu/config/loader.py, reading the same
configs/ directory.

Re-implements the subset of hydra 1.x semantics the reference actually uses
(SURVEY.md §2.7, §5.6):

  - a root config (configs/train.yaml) with a ``defaults`` list mixing
    ``_self_`` and group entries (``/dataset: cub200``)
  - CLI overrides: ``group=choice`` picks a group file, ``a.b.c=value`` sets a
    leaf (values parsed as YAML), ``+a.b=v`` adds a new key
  - group files placed under their group key, unless headed by
    ``# @package _global_`` (model/transform configs), which merge at root
  - group configs may carry their own ``defaults: - override /backbone: x``
  - ``${a.b}`` interpolation, ``${eval:'expr'}`` resolver, ``${now:%fmt}``
    timestamps, ``${choices.group}`` (accepting the reference spelling
    ``${hydra:runtime.choices.group}`` too), ``${uuid4:}``
  - the run-dir template ``logs/<ds>/<model><nbit>_<ep>/<tag><seed>_<ts>``

The composed result is a plain nested dict.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
import uuid
from typing import Any

import yaml

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")
_GLOBAL_PACKAGE_RE = re.compile(r"^#\s*@package\s+_global_\s*$", re.MULTILINE)


def _read_yaml(path: str):
    with open(path) as f:
        text = f.read()
    data = yaml.safe_load(text) or {}
    is_global = bool(_GLOBAL_PACKAGE_RE.search(text))
    return data, is_global


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: dict, dotted: str, value, allow_new: bool = True):
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not allow_new:
                raise KeyError(f"override path {dotted!r}: missing {k!r}")
            node[k] = {}
        node = node[k]
    node[keys[-1]] = value


def _get_dotted(cfg: dict, dotted: str):
    node = cfg
    for k in dotted.split("."):
        if isinstance(node, dict) and k in node:
            node = node[k]
        elif isinstance(node, list):
            node = node[int(k)]
        else:
            raise KeyError(dotted)
    return node


def _parse_defaults(defaults) -> list:
    """Normalize a defaults list into [('_self_',None)| (group, choice) |
    ('override', group, choice)] triples, preserving order."""
    out = []
    for item in defaults or []:
        if item == "_self_":
            out.append(("_self_", None))
        elif isinstance(item, dict):
            (key, choice), = item.items()
            if key.startswith("override "):
                group = key[len("override "):].lstrip("/")
                out.append(("override", group, choice))
            else:
                out.append((key.lstrip("/"), choice))
        else:
            raise ValueError(f"unsupported defaults entry: {item!r}")
    return out


class _Resolver:
    def __init__(self, cfg: dict, choices: dict):
        self.cfg = cfg
        self.choices = choices
        self._stack: list[str] = []

    def resolve_all(self):
        self.cfg = self._resolve_node(self.cfg)
        return self.cfg

    def _resolve_node(self, node):
        if isinstance(node, dict):
            return {k: self._resolve_node(v) for k, v in node.items()}
        if isinstance(node, list):
            return [self._resolve_node(v) for v in node]
        if isinstance(node, str):
            return self._resolve_str(node)
        return node

    def _resolve_str(self, s: str):
        def sub(match):
            v = self._resolve_expr(match.group(1))
            return "" if v is None else str(v)

        # innermost-first expansion; loop handles nested ${eval:"... ${x} ..."}
        cur = s
        prev = None
        while isinstance(cur, str) and "${" in cur and cur != prev:
            prev = cur
            m = _INTERP_RE.fullmatch(cur.strip())
            if m:
                cur = self._resolve_expr(m.group(1))  # preserves value type
            else:
                cur = _INTERP_RE.sub(sub, cur)
        return cur

    def _resolve_expr(self, expr: str):
        expr = expr.strip()
        if expr in self._stack:
            raise ValueError(f"interpolation cycle at ${{{expr}}}")
        self._stack.append(expr)
        try:
            if expr.startswith("eval:"):
                inner = self._resolve_str_body(expr[len("eval:"):].strip())
                inner = _strip_quotes(inner)
                return eval(inner, {"__builtins__": {}}, {"int": int, "float": float,
                                                          "min": min, "max": max, "len": len,
                                                          "round": round, "abs": abs})
            if expr.startswith("now:"):
                return datetime.datetime.now().strftime(expr[len("now:"):])
            if expr.startswith("uuid4:"):
                return str(uuid.uuid4())[-4:]
            if expr.startswith("env:"):
                return os.environ.get(expr[len("env:"):], "")
            if expr.startswith("hydra:runtime.choices."):
                return self.choices.get(expr.rsplit(".", 1)[1])
            if expr.startswith("hydra:run.dir"):
                return self.cfg.get("logdir", "")
            if expr.startswith("hydra:runtime.cwd"):
                return os.getcwd()
            if expr.startswith("choices."):
                return self.choices.get(expr.split(".", 1)[1])
            # plain config path
            val = _get_dotted(self.cfg, expr)
            if isinstance(val, str):
                return self._resolve_str(val)
            if isinstance(val, (dict, list)):
                return self._resolve_node(val)
            return val
        finally:
            self._stack.pop()

    def _resolve_str_body(self, s: str) -> str:
        def sub(match):
            v = self._resolve_expr(match.group(1))
            return "" if v is None else str(v)

        return _INTERP_RE.sub(sub, s)


def _strip_quotes(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    return s


def load_config(
    config_dir: str,
    config_name: str = "train",
    overrides: list[str] | None = None,
    resolve: bool = True,
) -> dict:
    """Compose a config from groups + CLI overrides. Returns a plain dict.

    ``overrides`` entries: ``group=choice`` (group dir exists), ``a.b=v``
    (value override, YAML-parsed), ``+a.b=v`` (add)."""
    overrides = list(overrides or [])
    if not config_name.endswith(".yaml"):
        config_name += ".yaml"
    root_path = os.path.join(config_dir, config_name)
    root, _ = _read_yaml(root_path)
    defaults = _parse_defaults(root.pop("defaults", ["_self_"]))

    # split CLI overrides into group choices vs value overrides
    cli_groups: dict[str, str | None] = {}
    value_overrides: list[tuple[str, Any, bool]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"bad override {ov!r} (expected key=value)")
        key, _, raw = ov.partition("=")
        additive = key.startswith("+")
        key = key.lstrip("+")
        val = yaml.safe_load(raw) if raw != "" else None
        top = key.split(".")[0]
        is_group = (
            "." not in key
            and os.path.isdir(os.path.join(config_dir, top))
            and (val is None or isinstance(val, str))
        )
        if is_group:
            cli_groups[key] = val
        else:
            value_overrides.append((key, val, additive))

    # choices: defaults order, then CLI
    choices: dict[str, str | None] = {}
    order: list[str] = []  # composition order of entries
    for entry in defaults:
        if entry[0] == "_self_":
            order.append("_self_")
        elif entry[0] == "override":
            choices[entry[1]] = entry[2]
        else:
            group, choice = entry
            choices[group] = choice
            order.append(group)
    for g, c in cli_groups.items():
        choices[g] = c
        if g not in order:
            order.append(g)

    # pre-scan chosen group files for their own `override /x: y` defaults
    # (hydra lets e.g. a model config force backbone=clip_vision) — CLI wins.
    pending = [(g, choices[g]) for g in order if g != "_self_" and choices.get(g)]
    for group, choice in pending:
        path = os.path.join(config_dir, group, f"{choice}.yaml")
        if not os.path.exists(path):
            continue
        data, _ = _read_yaml(path)
        for entry in _parse_defaults(data.get("defaults", [])):
            if entry[0] == "override" and entry[1] not in cli_groups:
                choices[entry[1]] = entry[2]
                if entry[1] not in order:
                    # insert before the group that requested it
                    order.insert(order.index(group), entry[1])

    # compose
    cfg: dict = {}
    for slot in order:
        if slot == "_self_":
            cfg = _deep_merge(cfg, root)
            continue
        choice = choices.get(slot)
        if choice is None:
            continue
        path = os.path.join(config_dir, slot, f"{choice}.yaml")
        if not os.path.exists(path):
            raise FileNotFoundError(f"config group file not found: {path}")
        data, is_global = _read_yaml(path)
        data.pop("defaults", None)
        if is_global:
            cfg = _deep_merge(cfg, data)
        else:
            cfg = _deep_merge(cfg, {slot: data})

    # value overrides last
    for key, val, additive in value_overrides:
        _set_dotted(cfg, key, val, allow_new=True)

    cfg["_choices_"] = {k: v for k, v in choices.items()}

    if resolve:
        cfg = _Resolver(cfg, cfg["_choices_"]).resolve_all()
    return cfg


def save_config(cfg: dict, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    clean = {k: v for k, v in cfg.items() if not k.startswith("_")}
    with open(path, "w") as f:
        yaml.safe_dump(clean, f, default_flow_style=False, sort_keys=False)


def load_saved_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)
