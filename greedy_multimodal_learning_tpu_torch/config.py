"""Minimal gin-compatible configuration engine.

The reference drives every tunable through gin-config: ``@gin.configurable``
functions/classes whose keyword defaults are overridden by ``Name.param =
value`` bindings parsed from ``.gin`` files and CLI binding strings
(reference: src/utils.py:58-68, configs/*.gin).  gin-config is not available
in this environment, so the framework ships its own engine with the same
observable surface:

* :func:`configurable` — decorator registering a function or class; at call
  time any parameter not supplied by the caller is filled from the active
  bindings.
* :func:`parse_config_files_and_bindings` — parse ``#``-separable config
  files plus a ``#``-separated CLI binding string (the reference CLI treats
  ``#`` in the config argument as a mixin separator and in the bindings
  argument as a newline; reference: src/utils.py:61).
* :data:`CONFIG` — the raw binding dict handed to callbacks, mirroring the
  reference's use of ``gin.config._CONFIG`` (reference: train.py:68).

Values are Python literals (``ast.literal_eval``).  ``@Name`` configurable
references and ``%MACRO`` substitution are supported for completeness.
"""

from __future__ import annotations

import ast
import functools
import inspect
import logging
import threading

logger = logging.getLogger(__name__)

# name -> {param: value}; mirrors gin.config._CONFIG's role as the raw
# binding store handed to callbacks (reference: train.py:68).
CONFIG: dict = {}
# macro name -> value (``NAME = value`` lines).
MACROS: dict = {}
# registry of configurables: name -> callable
_REGISTRY: dict = {}
_LOCK = threading.RLock()


class ConfigError(ValueError):
    pass


class _Required:
    def __repr__(self):
        return "REQUIRED"


REQUIRED = _Required()


def clear_config():
    """Reset all bindings (not the registry). Used by tests and CLI reruns."""
    with _LOCK:
        CONFIG.clear()
        MACROS.clear()


class _ConfigurableReference:
    """A ``@Name`` value: resolves to the registered configurable (or, with
    ``@Name()``, to a zero-arg invocation at query time)."""

    def __init__(self, name: str, evaluate: bool):
        self.name = name
        self.evaluate = evaluate

    def resolve(self):
        if self.name not in _REGISTRY:
            raise ConfigError(f"Unknown configurable reference @{self.name}")
        target = _REGISTRY[self.name]
        return target() if self.evaluate else target

    def __repr__(self):
        return f"@{self.name}" + ("()" if self.evaluate else "")


def _scan_line(line: str):
    """Single pass over a line: drop a ``#`` comment (respecting string
    literals) and record which kept characters sit inside a string.

    A quote closes its literal only when preceded by an even number of
    backslashes (so ``"C:\\\\"`` closes, ``"a\\""`` does not)."""
    out = []
    in_string = []
    quote = None
    backslashes = 0
    for ch in line:
        if quote:
            out.append(ch)
            in_string.append(True)
            if ch == "\\":
                backslashes += 1
            else:
                if ch == quote and backslashes % 2 == 0:
                    quote = None
                backslashes = 0
        elif ch in ("'", '"'):
            quote = ch
            backslashes = 0
            out.append(ch)
            in_string.append(True)
        elif ch == "#":
            break
        else:
            out.append(ch)
            in_string.append(False)
    return "".join(out), in_string


def _strip_comment(line: str) -> str:
    """Remove a ``#`` comment, respecting string literals."""
    return _scan_line(line)[0]


def _code_chars(line: str) -> str:
    """The line with comment removed AND string-literal contents blanked —
    the text bracket-balance heuristics may safely count over."""
    code, in_string = _scan_line(line)
    return "".join(c for c, s in zip(code, in_string) if not s)


def _parse_value(text: str):
    text = text.strip()
    if text.startswith("@"):
        name = text[1:].strip()
        evaluate = name.endswith("()")
        if evaluate:
            name = name[:-2].strip()
        return _ConfigurableReference(name, evaluate)
    if text.startswith("%"):
        macro = text[1:].strip()
        if macro not in MACROS:
            raise ConfigError(f"Unknown macro %{macro}")
        return MACROS[macro]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError) as e:
        raise ConfigError(f"Cannot parse config value: {text!r}") from e


def parse_config(text: str):
    """Parse gin-style binding lines from a string."""
    # Join simple multi-line list/tuple/dict values.
    pending = ""
    pending_code = ""  # string-literal contents blanked: brackets inside
    for raw in text.splitlines():  # values like 'split [train' don't count
        line = _strip_comment(raw).strip()
        if not line:
            continue
        pending = pending + " " + line if pending else line
        code = _code_chars(raw).strip()
        pending_code = pending_code + " " + code if pending_code else code
        # Heuristic: balanced brackets means the statement is complete.
        if (
            pending_code.count("[") > pending_code.count("]")
            or pending_code.count("(") > pending_code.count(")")
            or pending_code.count("{") > pending_code.count("}")
        ):
            continue
        _parse_statement(pending)
        pending = ""
        pending_code = ""
    if pending:
        _parse_statement(pending)


def _parse_statement(line: str):
    if line.startswith("import ") or line.startswith("from "):
        return  # gin files may import modules to register configurables; ours are pre-registered.
    if "=" not in line:
        raise ConfigError(f"Malformed config line: {line!r}")
    key, value = line.split("=", 1)
    key = key.strip()
    with _LOCK:
        if "." not in key:
            MACROS[key] = _parse_value(value)
            return
        # Strip gin scopes ("scope/Name.param") — scopes are unused by the
        # reference configs.
        name, param = key.rsplit(".", 1)
        name = name.split("/")[-1]
        CONFIG.setdefault(name, {})[param] = _parse_value(value)


def parse_config_file(path: str):
    with open(path) as f:
        parse_config(f.read())


def parse_config_files_and_bindings(config_files, bindings):
    """Mirror of gin.parse_config_files_and_bindings for our CLI surface
    (reference: src/utils.py:61)."""
    for path in config_files or []:
        path = path.strip()
        if path:
            parse_config_file(path)
    if bindings:
        if isinstance(bindings, (list, tuple)):
            bindings = "\n".join(bindings)
        parse_config(bindings)


def query(name: str, param: str, default=None):
    return CONFIG.get(name, {}).get(param, default)


def bind(name: str, param: str, value):
    """Programmatic binding (equivalent to a config line)."""
    with _LOCK:
        CONFIG.setdefault(name, {})[param] = value


def _resolve(value):
    if isinstance(value, _ConfigurableReference):
        return value.resolve()
    if isinstance(value, list):
        return [_resolve(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_resolve(v) for v in value)
    return value


def configurable(name_or_fn=None, *, name: str = None):
    """Register a function or class; fill unbound kwargs from CONFIG at call
    time, like ``@gin.configurable`` (reference usage: train.py:43,
    src/dataset.py:15, src/model.py:15, src/callbacks.py:173...)."""

    def decorate(fn, reg_name=None):
        reg_name = reg_name or fn.__name__
        if inspect.isclass(fn):
            sig = inspect.signature(fn.__init__)
            param_names = [p for p in sig.parameters if p != "self"]
            original_init = fn.__init__

            @functools.wraps(original_init)
            def init_wrapper(self, *args, **kwargs):
                merged = _merge_kwargs(reg_name, sig, args, kwargs, skip_self=True)
                original_init(self, *args, **merged)

            fn.__init__ = init_wrapper
            with _LOCK:
                _REGISTRY[reg_name] = fn
            return fn

        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            merged = _merge_kwargs(reg_name, sig, args, kwargs, skip_self=False)
            return fn(*args, **merged)

        with _LOCK:
            _REGISTRY[reg_name] = wrapper
        return wrapper

    if callable(name_or_fn):
        return decorate(name_or_fn)
    return lambda fn: decorate(fn, reg_name=(name or name_or_fn))


def _merge_kwargs(reg_name, sig, args, kwargs, *, skip_self):
    bindings = CONFIG.get(reg_name, {})
    params = list(sig.parameters.values())
    if skip_self:
        params = [p for p in params if p.name != "self"]
    # positions already filled by positional args
    positional_filled = {p.name for p in params[: len(args)] if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)}
    merged = dict(kwargs)
    for p in params:
        if p.name in merged or p.name in positional_filled:
            continue
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.name in bindings:
            merged[p.name] = _resolve(bindings[p.name])
    for p in params:
        value = merged.get(p.name, p.default if p.name not in positional_filled else None)
        if isinstance(value, _Required):
            raise ConfigError(f"Required binding {reg_name}.{p.name} not supplied")
    return merged


def register(name: str, obj):
    """Register an externally-defined configurable by name."""
    with _LOCK:
        _REGISTRY[name] = obj


def get_configurable(name: str):
    return _REGISTRY.get(name)


def operative_config_str() -> str:
    """Human-readable dump of active bindings (gin.operative_config_str
    analogue), written to the save dir for reproducibility."""
    lines = []
    for macro, value in sorted(MACROS.items()):
        lines.append(f"{macro} = {value!r}")
    for name in sorted(CONFIG):
        for param, value in sorted(CONFIG[name].items()):
            lines.append(f"{name}.{param} = {value!r}")
    return "\n".join(lines) + "\n"
