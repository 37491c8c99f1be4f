"""Gin-compatible configuration system (the port's own copy).

The same ``configs/*.gin`` files and ``-g``/``-p`` flags drive both the JAX
package and this port; configurables register under the same names
(``RAFT``, ``inference``, ``fusion``, ...). A dependency-free subset of gin:

* ``@configurable`` / ``@configurable("name")`` decorators that register a
  function or class and make its keyword defaults overridable.
* ``parse_config_files_and_bindings(files, bindings, skip_unknown=True)`` that
  parses ``name.param = value`` lines (Python literals) and stores them as
  bindings.
* Bindings are applied at call time for any parameter the caller did not
  explicitly pass; a binding the callable does not accept raises
  :class:`ConfigError`.

Syntax supported:

    # comment
    train.batch_size = 2
    random_scale_and_crop.crop_size = [1056, 1440]
    get_test_data_loader.datasetname = "DTUTest"
    include 'other.gin'
"""

from __future__ import annotations

import ast
import functools
import inspect
import os
import threading
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}
_BINDINGS: Dict[str, Dict[str, Any]] = {}
_LOCK = threading.Lock()


class ConfigError(Exception):
    pass


def clear_config() -> None:
    """Drop all bindings (used by tests)."""
    with _LOCK:
        _BINDINGS.clear()


def _register(name: str, fn: Callable) -> None:
    with _LOCK:
        _REGISTRY[name] = fn


def query_parameter(spec: str) -> Any:
    """Look up a bound parameter value, e.g. ``query_parameter('train.lr')``."""
    name, _, param = spec.rpartition(".")
    try:
        return _BINDINGS[name][param]
    except KeyError as e:
        raise ConfigError(f"no binding for {spec!r}") from e


def bind_parameter(spec: str, value: Any) -> None:
    name, _, param = spec.rpartition(".")
    if not name:
        raise ConfigError(f"malformed binding target {spec!r}")
    with _LOCK:
        _BINDINGS.setdefault(name, {})[param] = value


def operative_config() -> Dict[str, Dict[str, Any]]:
    return {k: dict(v) for k, v in _BINDINGS.items()}


def configurable(name_or_fn=None, name: Optional[str] = None):
    """Decorator registering a callable under its name (or an explicit one)."""

    def wrap(fn: Callable, reg_name: Optional[str]) -> Callable:
        reg = reg_name or fn.__name__
        if inspect.isclass(fn):
            orig_init = fn.__init__

            @functools.wraps(orig_init)
            def init(self, *args, **kwargs):
                merged = _merged_kwargs(reg, orig_init, args, kwargs, skip_self=True)
                orig_init(self, *args, **merged)

            fn.__init__ = init
            _register(reg, fn)
            return fn

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            merged = _merged_kwargs(reg, fn, args, kwargs)
            return fn(*args, **merged)

        wrapper.__config_name__ = reg
        _register(reg, wrapper)
        return wrapper

    if callable(name_or_fn) and name is None:
        return wrap(name_or_fn, None)
    # used as @configurable() or @configurable("name")
    explicit = name_or_fn if isinstance(name_or_fn, str) else name
    return lambda fn: wrap(fn, explicit)


def _merged_kwargs(reg, fn, args, kwargs, skip_self=False):
    bound = _BINDINGS.get(reg, {})
    if not bound:
        return kwargs
    sig = inspect.signature(fn)
    params = list(sig.parameters.values())
    if skip_self:
        params = params[1:]
    # positions already filled by positional args
    filled = {p.name for p in params[: len(args)]}
    merged = dict(kwargs)
    for pname, value in bound.items():
        if pname in filled or pname in merged:
            continue  # explicit call-site values win
        if pname not in sig.parameters and not any(
            p.kind == inspect.Parameter.VAR_KEYWORD for p in params
        ):
            raise ConfigError(f"{reg} has no parameter {pname!r}")
        merged[pname] = value
    return merged


def _parse_value(text: str) -> Any:
    text = text.strip()
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        # tuple without parens:  a, b, c
        if "," in text:
            try:
                return ast.literal_eval(f"({text})")
            except (ValueError, SyntaxError):
                pass
        raise ConfigError(f"cannot parse value {text!r}")


def parse_config(lines, skip_unknown: bool = True) -> None:
    buf = ""
    for raw in lines:
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        buf += line
        # allow multi-line values (e.g. lists spanning lines)
        if buf.count("[") > buf.count("]") or buf.count("(") > buf.count(")"):
            continue
        stmt, buf = buf.strip(), ""
        if stmt.startswith("include"):
            path = ast.literal_eval(stmt[len("include"):].strip())
            parse_config_file(path, skip_unknown=skip_unknown)
            continue
        if "=" not in stmt:
            raise ConfigError(f"malformed config line {stmt!r}")
        target, value = stmt.split("=", 1)
        target = target.strip()
        name, _, param = target.rpartition(".")
        if not name:
            raise ConfigError(f"malformed binding target {target!r}")
        if name not in _REGISTRY and not skip_unknown:
            raise ConfigError(f"unknown configurable {name!r}")
        bind_parameter(target, _parse_value(value))
    if buf:
        raise ConfigError(f"unterminated config statement {buf!r}")


def parse_config_file(path: str, skip_unknown: bool = True) -> None:
    with open(path) as f:
        parse_config(f.readlines(), skip_unknown=skip_unknown)


def parse_config_files_and_bindings(config_files, bindings, skip_unknown=True):
    """Entry-point helper matching gin's API."""
    for path in config_files or []:
        if not os.path.exists(path) and not skip_unknown:
            raise ConfigError(f"config file not found: {path}")
        if os.path.exists(path):
            parse_config_file(path, skip_unknown=skip_unknown)
    parse_config(bindings or [], skip_unknown=skip_unknown)


def add_cli_flags(parser):
    """Attach the ``-g`` / ``-p`` flags to an argparse parser."""
    parser.add_argument(
        "-g", "--gin_config", nargs="+", default=[], action="extend",
        help="Set of config files (separated by spaces), exclude .gin from path",
    )
    parser.add_argument(
        "-p", "--gin_param", nargs="+", default=[], action="extend",
        help="Parameter settings that override config defaults, "
        "e.g. -p module_1.a=2 module_2.b=3 (repeatable)",
    )
    return parser


def parse_cli(args, config_dir="configs"):
    files = [os.path.join(config_dir, f"{g}.gin") for g in args.gin_config]
    parse_config_files_and_bindings(files, args.gin_param, skip_unknown=True)
