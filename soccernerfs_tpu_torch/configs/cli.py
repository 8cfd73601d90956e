"""Command-line parsing for ``snt-train`` (counterpart of
soccernerfs_tpu/configs/cli.py, the same grammar).

``<method> [--nested.flag value ...] <dataparser-subcommand>
[--dataparser-flag value ...]``: flags bind to the preceding subcommand,
defaults come from the method's ``trainer_configs`` entry, dotted
kebab-case paths address nested dataclass fields, and a dict-style field
stored as (key, value) pairs takes its key as the last part
(``--pipeline.model.loss-coefficients.space-tv-loss 0.2``).  ``--data``
before the subcommand sets the dataparser's data; ``--load-config``
replaces the whole config with a saved ``config.yml``.
"""
from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path
from typing import Any, List, Optional, Sequence

from soccernerfs_tpu_torch.configs.base import TrainerConfig, load_config


def _coerce(value_tokens: List[str], current: Any):
    """CLI tokens as the type of the field's current value."""
    if isinstance(current, bool):
        return value_tokens[0].lower() in ("true", "1", "yes")
    if isinstance(current, int):
        return int(value_tokens[0])
    if isinstance(current, float):
        return float(value_tokens[0])
    if isinstance(current, Path) or (current is None and len(value_tokens) == 1):
        tok = value_tokens[0]
        if current is None:
            # the literal's own type for a field without a default
            for cast in (int, float):
                try:
                    return cast(tok)
                except ValueError:
                    pass
            if tok.lower() in ("true", "false"):
                return tok.lower() == "true"
            return tok
        return Path(tok)
    if isinstance(current, (tuple, list)):
        elem_proto = current[0] if len(current) else 0
        return tuple(_coerce([t], elem_proto) for t in value_tokens)
    return value_tokens[0]


def _resolve(obj: Any, parts: List[str]):
    """(parent, attribute name) of a dotted path."""
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


def _is_pair_tuple(v) -> bool:
    return (
        isinstance(v, tuple)
        and len(v) > 0
        and all(isinstance(e, tuple) and len(e) == 2 and isinstance(e[0], str) for e in v)
    )


def _is_frozen(obj) -> bool:
    return dataclasses.is_dataclass(obj) and type(obj).__dataclass_params__.frozen


def set_nested(config: Any, dotted: str, value_tokens: List[str]) -> None:
    """Set the field at the dotted kebab-case path ``dotted`` of ``config``
    from CLI tokens; exits on an unknown path or key."""
    parts = [p.replace("-", "_") for p in dotted.split(".")]
    if len(parts) >= 2:
        try:
            parent, attr = _resolve(config, parts[:-1])
        except AttributeError:
            raise SystemExit(f"unknown option --{dotted}")
        if hasattr(parent, attr) and _is_pair_tuple(getattr(parent, attr)):
            table = dict(getattr(parent, attr))
            key = parts[-1]
            if key not in table:
                raise SystemExit(f"unknown key {key!r} in --{dotted}")
            table[key] = _coerce(value_tokens, table[key])
            _frozen_replace(config, parts[:-1], tuple(table.items()))
            return
    parent, attr = _resolve(config, parts)
    if not hasattr(parent, attr):
        raise SystemExit(f"unknown option --{dotted}")
    new_value = _coerce(value_tokens, getattr(parent, attr))
    if _is_frozen(parent):
        _frozen_replace(config, parts, new_value)
    else:
        setattr(parent, attr, new_value)


def _frozen_replace(config: Any, parts: List[str], new_value: Any) -> None:
    """Replace a field inside (possibly nested) frozen dataclasses, rebuilt
    with ``dataclasses.replace`` up to the first mutable parent."""
    chain = [config]
    for p in parts[:-1]:
        chain.append(getattr(chain[-1], p))
    obj = dataclasses.replace(chain[-1], **{parts[-1]: new_value})
    for i in range(len(chain) - 2, -1, -1):
        parent, name = chain[i], parts[i]
        if _is_frozen(parent):
            obj = dataclasses.replace(parent, **{name: obj})
        else:
            setattr(parent, name, obj)
            return


def _collect_values(argv: Sequence[str], i: int, subcommands) -> tuple:
    """The value tokens of a flag, from argv[i]."""
    values = []
    while i < len(argv) and not argv[i].startswith("--") and argv[i] not in subcommands:
        values.append(argv[i])
        i += 1
    return values, i


def parse_train_cli(argv: Optional[Sequence[str]] = None) -> TrainerConfig:
    """A TrainerConfig from the command line (``sys.argv[1:]`` by default).

    Exits with a message on an unknown method, an unknown flag or a flag
    without a value; ``--help`` prints the methods and dataparsers."""
    from soccernerfs_tpu_torch.configs import method_configs as mc
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: snt-train <method> [--flags ...] [<dataparser-data> [--flags ...]]")
        print("methods:")
        for name in sorted(mc.trainer_configs):
            print(f"  {name:<26s}{mc.descriptions.get(name, '')}")
        print("dataparsers:", ", ".join(sorted(DATAPARSERS)))
        raise SystemExit(0)

    method = argv[0]
    if method not in mc.trainer_configs:
        raise SystemExit(f"unknown method {method!r}; known: "
                         f"{sorted(mc.trainer_configs)}")
    config: TrainerConfig = copy.deepcopy(mc.trainer_configs[method])

    # flags bind to the trainer config until a dataparser subcommand
    target = config
    i = 1
    subcommands = set(DATAPARSERS)
    while i < len(argv):
        tok = argv[i]
        if tok in ("-h", "--help"):
            print(f"usage: snt-train {method} [--flags ...] "
                  "[<dataparser-data> [--flags ...]]")
            print("flags use dotted config paths, e.g. "
                  "--pipeline.model.multiscale-res 1 2 4 8 16, "
                  "--max-num-iterations 30000")
            print("dataparsers:", ", ".join(sorted(DATAPARSERS)))
            raise SystemExit(0)
        if tok in subcommands:
            dp_config = DATAPARSERS[tok]()
            config.pipeline.datamanager.dataparser = dp_config
            target = dp_config
            i += 1
        elif tok.startswith("--"):
            name = tok[2:]
            values, j = _collect_values(argv, i + 1, subcommands)
            if not values:
                raise SystemExit(f"flag --{name} needs a value")
            if target is config and name == "data":
                config.data = Path(values[0])
            else:
                set_nested(target, name, values)
            i = j
        else:
            raise SystemExit(f"unexpected token {tok!r}")

    if config.data is not None and config.pipeline.datamanager.dataparser is not None:
        config.pipeline.datamanager.dataparser.data = Path(config.data)

    if config.load_config is not None:
        config = load_config(config.load_config)
    return config
