"""Frozen-dataclass configuration framework.

The port's own copy of ``mile_tpu/config/base.py`` (the port imports
nothing of ``mile_tpu``); it has no framework dependency, so the copy is
verbatim apart from this docstring:

- YAML/JSON (de)serialization of nested frozen dataclasses.
- Recursive construction from plain dicts with located error messages,
  enum coercion and union/optional handling.
- Rejection of unknown keys (typo safety).
- Search trees: nested dicts whose leaves are lists of candidate values;
  grid (cartesian product) and random expansion into config variants.
- Schema/template generation for any config class.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import json
import typing
from pathlib import Path
from typing import Any, Iterator, Mapping, Sequence, Type, TypeVar

import yaml

T = TypeVar('T', bound='BaseConfig')

SearchTree = dict  # nested dict; list leaves = candidate values


class ConfigError(ValueError):
    """Raised on malformed configuration input, carrying the field path."""


class CfgEnum(str, enum.Enum):
    """String enum with lenient, case-insensitive construction."""

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value

    @classmethod
    def coerce(cls, value: Any) -> 'CfgEnum':
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            for member in cls:
                if member.value.lower() == value.lower() or member.name.lower() == value.lower():
                    return member
        raise ConfigError(
            f'{value!r} is not a valid {cls.__name__}; '
            f'options: {[m.value for m in cls]}'
        )


def _is_config_cls(tp: Any) -> bool:
    return isinstance(tp, type) and issubclass(tp, BaseConfig)


def _is_enum_cls(tp: Any) -> bool:
    return isinstance(tp, type) and issubclass(tp, enum.Enum)


def _convert(value: Any, tp: Any, path: str) -> Any:
    """Convert ``value`` to annotated type ``tp``, raising located errors."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)

    if tp is Any or tp is None or tp is type(None):
        if tp is type(None) and value is not None:
            raise ConfigError(f'{path}: expected null, got {value!r}')
        return value

    if origin is typing.Union:
        if value is None and type(None) in args:
            return None
        errors = []
        for arg in args:
            if arg is type(None):
                continue
            try:
                return _convert(value, arg, path)
            except (ConfigError, TypeError, ValueError) as e:  # try next member
                errors.append(str(e))
        raise ConfigError(
            f'{path}: {value!r} matches no member of {tp} ({"; ".join(errors[:2])})'
        )

    if origin in (list, Sequence):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f'{path}: expected list, got {type(value).__name__}')
        inner = args[0] if args else Any
        return [_convert(v, inner, f'{path}[{i}]') for i, v in enumerate(value)]

    if origin is tuple:
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f'{path}: expected tuple, got {type(value).__name__}')
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_convert(v, args[0], f'{path}[{i}]') for i, v in enumerate(value))
        if args and len(args) != len(value):
            raise ConfigError(f'{path}: expected {len(args)} items, got {len(value)}')
        return tuple(
            _convert(v, a, f'{path}[{i}]') for i, (v, a) in enumerate(zip(value, args))
        ) if args else tuple(value)

    if origin in (dict, Mapping):
        if not isinstance(value, dict):
            raise ConfigError(f'{path}: expected mapping, got {type(value).__name__}')
        kt = args[0] if args else Any
        vt = args[1] if len(args) > 1 else Any
        return {
            _convert(k, kt, f'{path}.<key>'): _convert(v, vt, f'{path}.{k}')
            for k, v in value.items()
        }

    if _is_config_cls(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f'{path}: expected mapping for {tp.__name__}')
        return tp.from_dict(value, _path=path)

    if _is_enum_cls(tp):
        try:
            if issubclass(tp, CfgEnum):
                return tp.coerce(value)
            return tp(value)
        except (ValueError, ConfigError) as e:
            raise ConfigError(f'{path}: {e}') from None

    if tp is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f'{path}: expected bool, got {value!r}')
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f'{path}: expected int, got {value!r}')
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f'{path}: expected float, got {value!r}')
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise ConfigError(f'{path}: expected str, got {value!r}')
        return value
    if tp is Path:
        return Path(value)

    if isinstance(tp, type) and isinstance(value, tp):
        return value
    raise ConfigError(f'{path}: cannot convert {value!r} to {tp}')


def _to_plain(value: Any) -> Any:
    """Recursively convert config values to YAML-friendly plain types."""
    if isinstance(value, BaseConfig):
        return value.to_dict()
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, Path):
        return value.as_posix()
    if isinstance(value, (list, tuple)):
        return [_to_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_plain(v) for k, v in value.items()}
    return value


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    """Base class for all configuration dataclasses."""

    # ---------------------------------------------------------------- dicts
    @classmethod
    def from_dict(cls: Type[T], data: Mapping[str, Any], _path: str = '') -> T:
        if not isinstance(data, Mapping):
            raise ConfigError(f'{_path or cls.__name__}: expected mapping')
        hints = typing.get_type_hints(cls)
        fields = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(data) - set(fields)
        if unknown:
            raise ConfigError(
                f'{_path or cls.__name__}: unknown field(s) {sorted(unknown)}; '
                f'valid fields: {sorted(fields)}'
            )
        kwargs = {}
        for name, f in fields.items():
            loc = f'{_path}.{name}' if _path else name
            if name in data:
                kwargs[name] = _convert(data[name], hints[name], loc)
            elif (f.default is dataclasses.MISSING
                  and f.default_factory is dataclasses.MISSING):
                raise ConfigError(f'{loc}: required field missing')
        return cls(**kwargs)

    def to_dict(self) -> dict:
        return {
            f.name: _to_plain(getattr(self, f.name))
            for f in dataclasses.fields(self)
        }

    # ---------------------------------------------------------------- files
    @classmethod
    def from_yaml(cls: Type[T], path: str | Path) -> T:
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    @classmethod
    def from_json(cls: Type[T], path: str | Path) -> T:
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_file(cls: Type[T], path: str | Path) -> list[T]:
        """Load one config (file) or many (directory of yaml/json files)."""
        path = Path(path)
        if path.is_dir():
            out = []
            for p in sorted(path.iterdir()):
                if p.suffix in ('.yaml', '.yml', '.json'):
                    out.extend(cls.from_file(p))
            return out
        if path.suffix == '.json':
            return [cls.from_json(path)]
        return [cls.from_yaml(path)]

    def to_yaml(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, 'w') as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def to_json(self, path: str | Path) -> None:
        with open(path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)

    # ------------------------------------------------------------- updates
    def replace(self: T, **updates: Any) -> T:
        """Functional field update with type conversion, supporting dotted paths."""
        data = self.to_dict()
        for key, value in updates.items():
            node = data
            *parents, leaf = key.split('.')
            for p in parents:
                node = node[p]
            node[leaf] = _to_plain(value)
        return type(self).from_dict(data)

    # -------------------------------------------------------- search trees
    @classmethod
    def _iter_grid(cls, base: dict, tree: SearchTree) -> Iterator[dict]:
        paths, choices = [], []

        def walk(node: Any, prefix: tuple[str, ...]) -> None:
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, prefix + (k,))
            elif isinstance(node, list):
                paths.append(prefix)
                choices.append(node)
            elif node is not None:
                raise ConfigError(
                    f'search tree leaf at {".".join(prefix)} must be a list'
                )

        walk(tree, ())
        for combo in itertools.product(*choices):
            out = json.loads(json.dumps(base))  # deep copy
            for path, value in zip(paths, combo):
                node = out
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = value
            yield out

    def expand_grid(self: T, tree: SearchTree) -> list[T]:
        """Cartesian-product expansion of a search tree into config variants.

        Variants get ``experiment_name`` suffixed with their index when the
        class has that field, so experiment dirs never collide.
        """
        cls = type(self)
        seen, out = set(), []
        for i, d in enumerate(self._iter_grid(self.to_dict(), tree)):
            cfg = cls.from_dict(self._suffix_name(d, i))
            key = json.dumps(cfg.to_dict(), sort_keys=True)
            if key not in seen:
                seen.add(key)
                out.append(cfg)
        return out

    def expand_grid_from_path(self: T, path: str | Path) -> list[T]:
        with open(path) as f:
            return self.expand_grid(yaml.safe_load(f))

    @staticmethod
    def _suffix_name(d: dict, i: int) -> dict:
        if 'experiment_name' in d:
            d = dict(d)
            d['experiment_name'] = f'{d["experiment_name"]}_{i}'
        return d
