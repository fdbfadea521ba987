"""Request-model validation with the standard library only.

The subset of the pydantic API that `api/schemas.py` uses, so the served
path needs no third-party package:

- `BaseModel` subclasses declare fields as annotated class attributes
  (inheritance included); a field without a default is required.
- `Field(default, *, default_factory, gt, ge, lt, le, min_length,
  max_length, pattern, description)`.
- Coercion of JSON values to `float`, `int`, `bool`, `str`, `list[X]`,
  `dict`, `Optional[X]`, `Union[...]` / `X | Y` and nested models, in pydantic's lax
  mode: an int is a valid float, an integral float a valid int, and keys
  the model does not declare are ignored.
- `@model_validator(mode="after")` methods run once the fields are set.
- `model_dump()`; `ValidationError`, whose `str()` lists every failing
  field and is the body of the server's 422 responses.
"""

from __future__ import annotations

import copy
import re
import sys
import types
import typing
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["BaseModel", "Field", "ValidationError", "model_validator"]

_MISSING = object()


class ValidationError(ValueError):
    """Raised with every field error of one model, as (location, message)."""

    def __init__(self, model: str, errors: List[Tuple[str, str]]):
        self.model = model
        self.errors = errors
        lines = [f"{len(errors)} validation error(s) for {model}"]
        lines += [f"{loc}\n  {msg}" for loc, msg in errors]
        super().__init__("\n".join(lines))


class _FieldInfo:
    __slots__ = ("default", "default_factory", "gt", "ge", "lt", "le",
                 "min_length", "max_length", "pattern")

    def __init__(self, default=_MISSING, *, default_factory=None, gt=None,
                 ge=None, lt=None, le=None, min_length=None, max_length=None,
                 pattern=None, description=None):
        del description  # documentation only
        self.default = default
        self.default_factory = default_factory
        self.gt, self.ge, self.lt, self.le = gt, ge, lt, le
        self.min_length, self.max_length = min_length, max_length
        self.pattern = re.compile(pattern) if pattern else None

    def make_default(self):
        if self.default_factory is not None:
            return self.default_factory()
        return copy.deepcopy(self.default)

    def check(self, value) -> Optional[str]:
        """The first constraint `value` breaks, or None."""
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            for bound, ok, word in (
                    (self.gt, lambda b: value > b, "greater than"),
                    (self.ge, lambda b: value >= b,
                     "greater than or equal to"),
                    (self.lt, lambda b: value < b, "less than"),
                    (self.le, lambda b: value <= b, "less than or equal to")):
                if bound is not None and not ok(bound):
                    return f"Input should be {word} {bound}"
        if isinstance(value, (list, str)):
            if self.min_length is not None and len(value) < self.min_length:
                return f"Input should have at least {self.min_length} items"
            if self.max_length is not None and len(value) > self.max_length:
                return f"Input should have at most {self.max_length} items"
        if self.pattern is not None and isinstance(value, str) \
                and not self.pattern.search(value):
            return f"String should match pattern '{self.pattern.pattern}'"
        return None


def Field(default=_MISSING, **kwargs) -> Any:  # noqa: N802 — pydantic name
    """Field default and constraints (see module docstring)."""
    return _FieldInfo(default, **kwargs)


def model_validator(*, mode: str) -> Callable:
    """Mark a method to run on the built model (only mode="after")."""
    if mode != "after":
        raise ValueError("only model_validator(mode='after') is supported")

    def mark(fn):
        fn.__model_validator__ = True
        return fn
    return mark


class _Invalid(Exception):
    """A coercion failure at one (possibly nested) location."""

    def __init__(self, errors: List[Tuple[str, str]]):
        self.errors = errors


def _coerce(tp, value, loc: str):
    """`value` converted to the annotation `tp`, or _Invalid."""
    origin = typing.get_origin(tp)
    if tp is Any:
        return value
    if origin in (typing.Union, types.UnionType):
        args = typing.get_args(tp)
        if value is None and type(None) in args:
            return None
        errors = []
        for arg in args:
            if arg is type(None):
                continue
            try:
                return _coerce(arg, value, loc)
            except _Invalid as e:
                errors.extend(e.errors)
        raise _Invalid(errors)
    if value is None:
        raise _Invalid([(loc, "Input should not be None")])
    if origin is list or tp is list:
        if not isinstance(value, (list, tuple)):
            raise _Invalid([(loc, "Input should be a valid list")])
        (item_tp,) = typing.get_args(tp) or (Any,)
        out, errors = [], []
        for i, item in enumerate(value):
            try:
                out.append(_coerce(item_tp, item, f"{loc}.{i}"))
            except _Invalid as e:
                errors.extend(e.errors)
        if errors:
            raise _Invalid(errors)
        return out
    if origin is dict or tp is dict:
        if not isinstance(value, dict):
            raise _Invalid([(loc, "Input should be a valid dictionary")])
        return dict(value)
    if isinstance(tp, type) and issubclass(tp, BaseModel):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise _Invalid([(loc, f"Input should be a valid dictionary or "
                                  f"instance of {tp.__name__}")])
        try:
            return tp(**value)
        except ValidationError as e:
            raise _Invalid([(f"{loc}.{sub}", msg) for sub, msg in e.errors])
    if tp is bool:
        if isinstance(value, bool):
            return value
        if value in (0, 1) and not isinstance(value, float):
            return bool(value)
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise _Invalid([(loc, "Input should be a valid boolean")])
    if tp is int:
        if isinstance(value, bool):
            return int(value)
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            try:
                return int(value.strip())
            except ValueError:
                pass
        raise _Invalid([(loc, "Input should be a valid integer")])
    if tp is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if isinstance(value, str):
            try:
                return float(value.strip())
            except ValueError:
                pass
        raise _Invalid([(loc, "Input should be a valid number")])
    if tp is str:
        if isinstance(value, str):
            return value
        raise _Invalid([(loc, "Input should be a valid string")])
    raise TypeError(f"unsupported field annotation {tp!r} at {loc}")


class BaseModel:
    """Declarative request model (see module docstring)."""

    __fields__: Dict[str, Tuple[Any, _FieldInfo]] = {}
    __validators__: Tuple[str, ...] = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls.__fields__ = {}
        cls.__validators__ = ()
        cls._resolved = False

    @classmethod
    def _resolve(cls):
        """Field table from the annotations, resolved on first use (the
        schemas module defines its models with postponed annotations)."""
        if cls._resolved:
            return
        fields: Dict[str, Tuple[Any, _FieldInfo]] = {}
        validators: List[str] = []
        for klass in reversed(cls.__mro__):
            if not (isinstance(klass, type) and issubclass(klass, BaseModel)) \
                    or klass is BaseModel:
                continue
            scope = vars(sys.modules[klass.__module__])
            for name, ann in klass.__dict__.get("__annotations__",
                                                {}).items():
                default = klass.__dict__.get(name, _MISSING)
                info = (default if isinstance(default, _FieldInfo)
                        else _FieldInfo(default))
                fields[name] = (eval(ann, scope) if isinstance(ann, str)
                                else ann, info)
            validators += [name for name, fn in vars(klass).items()
                           if getattr(fn, "__model_validator__", False)]
        cls.__fields__ = fields
        cls.__validators__ = tuple(validators)
        cls._resolved = True

    def __init__(self, **data):
        cls = type(self)
        cls._resolve()
        errors: List[Tuple[str, str]] = []
        for name, (tp, info) in cls.__fields__.items():
            if name in data:
                try:
                    value = _coerce(tp, data[name], name)
                except _Invalid as e:
                    errors.extend(e.errors)
                    continue
                problem = info.check(value)
                if problem:
                    errors.append((name, problem))
                    continue
            elif info.default is _MISSING and info.default_factory is None:
                errors.append((name, "Field required"))
                continue
            else:
                value = info.make_default()
            setattr(self, name, value)
        if errors:
            raise ValidationError(cls.__name__, errors)
        for name in cls.__validators__:
            try:
                getattr(self, name)()
            except ValueError as e:
                raise ValidationError(cls.__name__,
                                      [("__root__", f"Value error, {e}")])

    def model_dump(self) -> Dict[str, Any]:
        def dump(v):
            if isinstance(v, BaseModel):
                return v.model_dump()
            if isinstance(v, list):
                return [dump(x) for x in v]
            return v
        return {name: dump(getattr(self, name))
                for name in type(self).__fields__}

    def __repr__(self):
        body = ", ".join(f"{k}={getattr(self, k)!r}"
                         for k in type(self).__fields__)
        return f"{type(self).__name__}({body})"
