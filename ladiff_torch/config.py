"""Layered YAML configuration (the port's copy of ``ladiff_tpu/config.py``,
which the port does not import).

Four YAML sources are merged (base.yaml <- experiment yaml <- every yaml
under configs/<model.target>/ <- assets.yaml), ``${a.b.c}`` interpolations
are resolved against the root, and ``target:`` nodes can be instantiated: the
OmegaConf contract of the reference LADiff configuration stack, in a small
dependency-free implementation.  ``assemble_config`` gives the same tree as
the JAX package's for every published ``configs/config_*.yaml``.
"""
from __future__ import annotations

import importlib
import os
import re
from typing import Any, Mapping

import yaml

__all__ = [
    "ConfigNode",
    "assemble_config",
    "load_yaml",
    "merge",
    "resolve",
    "parse_args",
    "instantiate_from_config",
    "get_obj_from_str",
]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class ConfigNode(dict):
    """A dict with attribute access, recursive over nested mappings.

    Mirrors the parts of ``omegaconf.DictConfig`` the reference relies on:
    attribute get/set, ``in`` checks, ``.get``, iteration, and YAML round-trip.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, Mapping):
            return ConfigNode(value)
        if isinstance(value, list):
            return [ConfigNode._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, ConfigNode._wrap(value))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:  # pragma: no cover - mirrors attribute protocol
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(key) from e

    # -- helpers ---------------------------------------------------------
    def select(self, dotted: str, default: Any = None) -> Any:
        """Lookup ``a.b.c`` style paths."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def to_dict(self) -> dict:
        def conv(v: Any) -> Any:
            if isinstance(v, ConfigNode):
                return {k: conv(u) for k, u in v.items()}
            if isinstance(v, list):
                return [conv(u) for u in v]
            return v

        return conv(self)

    def copy(self) -> "ConfigNode":  # deep copy
        return ConfigNode(self.to_dict())


def load_yaml(path: str | os.PathLike) -> ConfigNode:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return ConfigNode(data)


def merge(base: ConfigNode, *overrides: Mapping[str, Any]) -> ConfigNode:
    """Recursively merge ``overrides`` into ``base`` (later wins)."""
    out = base.copy() if isinstance(base, ConfigNode) else ConfigNode(base)

    def _merge(dst: ConfigNode, src: Mapping[str, Any]) -> None:
        for k, v in src.items():
            if k in dst and isinstance(dst[k], ConfigNode) and isinstance(v, Mapping):
                _merge(dst[k], v)
            else:
                dst[k] = v

    for o in overrides:
        if o:
            _merge(out, o)
    return out


def resolve(cfg: ConfigNode, _root: ConfigNode | None = None) -> ConfigNode:
    """Resolve ``${a.b.c}`` interpolations against the config root.

    A value that is exactly one interpolation keeps the referenced value's
    type (like OmegaConf); embedded interpolations are string-substituted.
    An interpolation whose target does not exist is left as its literal
    ``${...}`` string: OmegaConf only errors on *access*, and reference
    config trees ship dangling interpolations on never-accessed keys
    (e.g. modules/evaluators.yaml's ${model.t2m_moveencoder.output_size}),
    so eager raising would reject configs the reference accepts.
    """
    root = _root if _root is not None else cfg

    def _resolve_value(v: Any, seen: tuple = ()) -> Any:
        if isinstance(v, str):
            m = _INTERP_RE.fullmatch(v.strip())
            if m:
                path = m.group(1)
                if path in seen:
                    raise ValueError(f"circular interpolation: {path}")
                target = root.select(path, default=_MISSING)
                if target is _MISSING:
                    return v  # dangling: keep literal (OmegaConf-lazy parity)
                return _resolve_value(target, seen + (path,))
            if "${" in v:
                def sub(mm: re.Match) -> str:
                    t = root.select(mm.group(1), default=_MISSING)
                    if t is _MISSING:
                        return mm.group(0)  # keep literal
                    return str(_resolve_value(t, seen + (mm.group(1),)))

                return _INTERP_RE.sub(sub, v)
            return v
        if isinstance(v, ConfigNode):
            out = ConfigNode()
            for k, u in v.items():
                out[k] = _resolve_value(u, seen)
            return out
        if isinstance(v, list):
            return [_resolve_value(u, seen) for u in v]
        return v

    return _resolve_value(cfg)


class _Missing:
    pass


_MISSING = _Missing()


def get_obj_from_str(string: str, reload: bool = False) -> Any:
    """Import ``pkg.mod.Class`` (reference: src/ladiff/config.py:16-23)."""
    module, cls = string.rsplit(".", 1)
    mod = importlib.import_module(module)
    if reload:
        importlib.reload(mod)
    return getattr(mod, cls)


def instantiate_from_config(node: Mapping[str, Any], **extra: Any) -> Any:
    """Build an object from ``{target: ..., params: {...}}`` nodes.

    Reference: src/ladiff/config.py:26-33.
    """
    if "target" not in node:
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(node.get("params") or {})
    params.update(extra)
    return get_obj_from_str(node["target"])(**params)


# ---------------------------------------------------------------------------
# CLI / experiment config assembly
# ---------------------------------------------------------------------------

def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assemble_config(
    cfg_path: str,
    cfg_assets_path: str | None = None,
    overrides: Mapping[str, Any] | None = None,
) -> ConfigNode:
    """4-way merge mirroring the reference semantics.

    base.yaml <- experiment yaml <- module yamls (configs/<model.target>/)
    <- assets.yaml <- programmatic overrides, then interpolation resolution.
    Reference: src/ladiff/config.py:180-193.
    """
    cfg_dir = os.path.dirname(os.path.abspath(cfg_path))
    base_path = os.path.join(cfg_dir, "base.yaml")
    cfg = load_yaml(base_path) if os.path.exists(base_path) else ConfigNode()
    cfg_exp = load_yaml(cfg_path)
    cfg = merge(cfg, cfg_exp)

    # module yaml folder named by model.target (default "modules")
    model_target = ConfigNode(cfg).select("model.target", "modules")
    module_dir = os.path.join(cfg_dir, str(model_target))
    if os.path.isdir(module_dir):
        files = sorted(os.listdir(module_dir))
        for fname in files:
            if fname.endswith((".yaml", ".yml")):
                cfg_model = load_yaml(os.path.join(module_dir, fname))
                cfg["model"] = merge(cfg.get("model", ConfigNode()), cfg_model)

    if cfg_assets_path and os.path.exists(cfg_assets_path):
        cfg = merge(cfg, load_yaml(cfg_assets_path))

    if overrides:
        cfg = merge(cfg, overrides)

    return resolve(cfg)


def parse_args(phase: str = "train", argv: list[str] | None = None,
               overrides: Mapping[str, Any] | None = None) -> ConfigNode:
    """CLI mirroring the reference entry points.

    Reference flags: --cfg, --cfg_assets, --batch_size, --device, --nodebug,
    plus demo/render extras (src/ladiff/config.py:36-175).  ``overrides``
    are merged over the assembled files before the flags (a program that
    drives an entry point sets its own paths and sizes so).
    """
    import argparse

    parser = argparse.ArgumentParser()
    root = _repo_root()
    parser.add_argument("--cfg", type=str, default=os.path.join(root, "configs", "config_ladiff_humanml3d.yaml"))
    parser.add_argument("--cfg_assets", type=str, default=os.path.join(root, "configs", "assets.yaml"))
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--device", type=int, nargs="*", default=None)
    parser.add_argument("--nodebug", action="store_true")
    if phase == "demo":
        parser.add_argument("--example", type=str, default=None)
        parser.add_argument("--task", type=str, default="text_motion")
        parser.add_argument("--out_dir", type=str, default=None)
        parser.add_argument("--latentwise_gen", type=str, default=None)
        parser.add_argument("--plot_att_map", action="store_true")
        # reference demo flags (config.py:85-115): N generation passes per
        # prompt; --allinone additionally groups them into one npy
        parser.add_argument("--replication", type=int, default=1)
        parser.add_argument("--allinone", action="store_true")
        parser.add_argument("--frame_rate", type=float, default=None)
    if phase == "test":
        parser.add_argument("--replication", type=int, default=None)
    args = parser.parse_args(argv)

    cfg = assemble_config(args.cfg, args.cfg_assets, overrides)
    if args.batch_size is not None:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
        if "TEST" in cfg:
            cfg.TEST.BATCH_SIZE = args.batch_size
    if args.device is not None:
        cfg.DEVICE = list(args.device)
    if args.nodebug:
        cfg.DEBUG = False
    if phase == "test":
        cfg.DEBUG = False
        if getattr(args, "replication", None):
            cfg.TEST.REPLICATION_TIMES = args.replication
    if phase == "demo":
        demo_over = {
            "EXAMPLE": args.example,
            "TASK": args.task,
            "OUT_DIR": args.out_dir,
            "LATENTWISE_GEN": args.latentwise_gen,
            "PLOT_ATT_MAP": bool(getattr(args, "plot_att_map", False)),
            "REPLICATION": int(getattr(args, "replication", 1) or 1),
            "OUTALL": bool(getattr(args, "allinone", False)),
        }
        # only override the yaml FRAME_RATE when the flag is given
        if getattr(args, "frame_rate", None) is not None:
            demo_over["FRAME_RATE"] = float(args.frame_rate)
        cfg.DEMO = merge(cfg.get("DEMO", ConfigNode()), demo_over)
    # DEBUG mode semantics (reference: config.py:224-227)
    if cfg.get("DEBUG", False):
        cfg.NAME = "debug--" + str(cfg.get("NAME", "exp"))
        if "LOGGER" in cfg and "VAL_EVERY_STEPS" in cfg.LOGGER:
            cfg.LOGGER.VAL_EVERY_STEPS = 1
    return cfg
