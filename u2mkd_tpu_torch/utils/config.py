"""Recursive YAML config with dotted-key CLI overrides (port of
``u2mkd_tpu/utils/config.py``, a copy: the port imports nothing of the JAX
package).

``load(path)`` walks every ``default.yaml`` from the filesystem root down to
the config's directory and deep-merges them under the target file (torchpack
``configs.load(recursive=True)``); ``update_dotted`` applies ``a.b.c=value``
CLI overrides. The result is an explicit object passed down, not a global.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import yaml


class Config(dict):
    """dict with attribute access and deep merge."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config({k: Config._wrap(x) for k, x in v.items()})
        if isinstance(v, list):
            return [Config._wrap(x) for x in v]
        return v

    def merge_from(self, other: Dict):
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, dict):
                self[k].merge_from(v)
            else:
                self[k] = Config._wrap(v)

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur


def _parse_value(s: str):
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def load(path: str, recursive: bool = True) -> Config:
    """Load a YAML config, deep-merging every ``default.yaml`` found in the
    directory chain above it (torchpack ``configs.load(recursive=True)``
    semantics, reference ``train_spformer.py:33``)."""
    path = os.path.abspath(path)
    cfg = Config()
    if recursive:
        parts = os.path.dirname(path).split(os.sep)
        chain: List[str] = []
        for i in range(len(parts) + 1):
            d = os.sep.join(parts[:i]) or os.sep
            cand = os.path.join(d, "default.yaml")
            if os.path.exists(cand):
                chain.append(cand)
        for cand in chain:
            with open(cand) as f:
                cfg.merge_from(yaml.safe_load(f) or {})
    with open(path) as f:
        cfg.merge_from(yaml.safe_load(f) or {})
    return cfg


def update_dotted(cfg: Config, opts: List[str]) -> Config:
    """Apply ['a.b=1', 'c=x'] style overrides (torchpack ``configs.update``)."""
    for opt in opts:
        if "=" not in opt:
            raise ValueError(f"override must be key=value, got {opt!r}")
        key, val = opt.split("=", 1)
        parts = key.strip().split(".")
        cur = cfg
        for p in parts[:-1]:
            if p not in cur or not isinstance(cur[p], Config):
                cur[p] = Config()
            cur = cur[p]
        cur[parts[-1]] = Config._wrap(_parse_value(val))
    return cfg
