"""CEL-subset evaluator for DeviceClass / request selectors.

The real scheduler evaluates CEL expressions like

    device.driver == 'tpu.google.com' &&
    device.attributes['tpu.google.com'].iciX < 2

against each published device (reference behavior:
demo/specs/quickstart/gpu-test6.yaml:22-31 is evaluated by the k8s
structured-parameters allocator). This module implements the subset those
expressions use, so the hermetic scheduler-sim can execute the demo specs
rather than merely parse them:

- member access / indexing: ``device.attributes['domain'].name``,
  ``device.capacity['domain'].name``
- literals: strings, ints, floats, booleans, lists
- comparisons: ``==  !=  <  <=  >  >=  in``
- boolean logic: ``&&  ||  !``, parentheses

Semantics of missing attributes follow CEL's commutative logical operators:
a reference to an absent attribute is an error that ``||`` absorbs when the
other operand is true and ``&&`` absorbs when the other operand is false;
an error surviving to the top makes the device not match (the scheduler
likewise skips devices a selector cannot evaluate against).
"""

from __future__ import annotations

import re
from typing import Any, Callable

from ..api.v1alpha1.quantity import InvalidQuantityError, parse_quantity


class CelError(ValueError):
    """A malformed expression (tokenizer/parser/structural error).

    ``expression`` carries the offending source once known — a claim can
    hold several selectors, and "invalid CEL selector" without a pointer
    to WHICH one sent operators grepping every DeviceClass in the
    cluster. ``evaluate``/``evaluate_detailed`` attach it on the way out;
    internal raise sites may leave it empty."""

    def __init__(self, message: str, expression: str = ""):
        super().__init__(message)
        self.expression = expression


class _EvalError(Exception):
    """A runtime evaluation error (absent attribute, type mismatch).

    CEL's commutative ``&&``/``||`` absorb these when the other operand
    decides the result; one surviving to the top makes the device not
    match. Python exceptions (e.g. TypeError from ``'str' >= int``) must
    never escape ``evaluate``: one would kill the allocator loop."""


class _Missing(_EvalError):
    """An attribute referenced by the expression is absent on the device.
    Carries the attribute name so mismatch diagnostics can say WHICH
    reference failed, not just that one did."""

    def __init__(self, attribute: str = ""):
        super().__init__(attribute)
        self.attribute = attribute


class _TypeMismatch(_EvalError):
    """Operands of incompatible types reached a comparison operator."""


_TOKEN_RE = re.compile(
    r"""
    \s*(
        (?P<float>\d+\.\d+)
      | (?P<int>\d+)
      | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
      | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op>&&|\|\||==|!=|<=|>=|[<>!\[\].(),])
    )
    """,
    re.VERBOSE,
)


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            if src[pos:].strip() == "":
                break
            raise CelError(f"cannot tokenize at {src[pos:pos + 20]!r}")
        pos = m.end()
        for kind in ("float", "int", "string", "ident", "op"):
            tok = m.group(kind)
            if tok is not None:
                out.append((kind, tok))
                break
    out.append(("end", ""))
    return out


class _AttrMap:
    """``device.attributes['domain']`` — resolves unqualified attribute
    names published by this driver, unwrapping the DRA value union.

    Capacity maps additionally parse their quantity-string values to
    integer bytes/counts, so ``device.capacity['d'].hbm >= 17179869184``
    compares numerically the way real CEL compares Quantity values."""

    def __init__(self, attrs: dict, domain: str, want_domain: str,
                 is_capacity: bool = False):
        self._attrs = attrs
        self._match = domain == want_domain
        self._is_capacity = is_capacity

    def get(self, name: str):
        if not self._match:
            raise _Missing(name)
        raw = self._attrs.get(name)
        if raw is None:
            raise _Missing(name)
        if isinstance(raw, dict):
            if not raw:
                raise _Missing(name)  # empty value union carries no value
            raw = next(iter(raw.values()))
        if self._is_capacity:
            try:
                return parse_quantity(raw)
            except InvalidQuantityError:
                return raw
        return raw


class _Device:
    """The ``device`` root variable."""

    def __init__(self, driver: str, attributes: dict, capacity: dict):
        self.driver = driver
        self.attributes = attributes
        self.capacity = capacity


# A compiled node: nullary thunk, evaluated after parsing completes.
Thunk = Callable[[], Any]


class _Parser:
    """Recursive descent over the token list, producing thunks so logical
    operators can implement CEL's error-absorbing semantics."""

    def __init__(self, tokens: list[tuple[str, str]], driver: str,
                 device: _Device):
        self.toks = tokens
        self.i = 0
        self.driver = driver
        self.device = device

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val: str):
        _, tok = self.next()
        if tok != val:
            raise CelError(f"expected {val!r}, got {tok!r}")

    def parse(self) -> Thunk:
        v = self.or_()
        if self.peek()[0] != "end":
            raise CelError(f"trailing tokens at {self.peek()[1]!r}")
        return v

    def or_(self) -> Thunk:
        operands = [self.and_()]
        while self.peek()[1] == "||":
            self.next()
            operands.append(self.and_())
        if len(operands) == 1:
            return operands[0]

        def run():
            err = None
            for op in operands:
                try:
                    if bool(op()):
                        return True  # true absorbs errors (CEL or)
                except _EvalError as e:
                    err = e
            if err is not None:
                raise err
            return False

        return run

    def and_(self) -> Thunk:
        operands = [self.not_()]
        while self.peek()[1] == "&&":
            self.next()
            operands.append(self.not_())
        if len(operands) == 1:
            return operands[0]

        def run():
            err = None
            for op in operands:
                try:
                    if not bool(op()):
                        return False  # false absorbs errors (CEL and)
                except _EvalError as e:
                    err = e
            if err is not None:
                raise err
            return True

        return run

    def not_(self) -> Thunk:
        if self.peek()[1] == "!":
            self.next()
            inner = self.not_()
            return lambda: not bool(inner())
        return self.cmp()

    _OPS = {
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b,
        "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b,
        ">=": lambda a, b: a >= b,
        "in": lambda a, b: a in b,
    }

    @staticmethod
    def _check_overload(op: str, a: Any, b: Any) -> None:
        """Modern CEL (the cel-go runtime Kubernetes uses) defines
        heterogeneous equality — ``1 == '1'`` is simply false, ``!=`` true
        — so ==/!= fall through to Python semantics. Only the ORDERING
        operators and ``in`` have no cross-type overloads: those raise an
        evaluation error the logical operators may absorb."""
        if op in ("==", "!="):
            return

        def cat(v: Any) -> str:
            if isinstance(v, bool):  # before int: bool is an int subclass
                return "bool"
            if isinstance(v, (int, float)):
                return "number"
            if isinstance(v, str):
                return "string"
            if isinstance(v, list):
                return "list"
            return type(v).__name__

        if op == "in":
            if cat(b) != "list":
                raise _TypeMismatch(
                    f"'in' requires a list, got {cat(b)}"
                )
            return
        if cat(a) != cat(b):
            raise _TypeMismatch(
                f"no matching overload for {op!r} applied to "
                f"({cat(a)}, {cat(b)})"
            )

    def cmp(self) -> Thunk:
        left = self.primary()
        _, tok = self.peek()
        if tok in self._OPS:
            self.next()
            right = self.primary()
            fn = self._OPS[tok]

            def run():
                a, b = left(), right()
                self._check_overload(tok, a, b)
                try:
                    return fn(a, b)
                except TypeError:
                    # Belt and braces: anything _check_overload missed is
                    # still an evaluation error the logical operators may
                    # absorb, never a Python crash.
                    raise _TypeMismatch(
                        f"no matching overload for {tok!r} applied to "
                        f"({type(a).__name__}, {type(b).__name__})"
                    ) from None

            return run
        return left

    def primary(self) -> Thunk:
        kind, tok = self.next()
        if kind == "int":
            return self.postfix(lambda v=int(tok): v)
        if kind == "float":
            return self.postfix(lambda v=float(tok): v)
        if kind == "string":
            body = (
                tok[1:-1]
                .replace("\\'", "'")
                .replace('\\"', '"')
                .replace("\\\\", "\\")
            )
            return self.postfix(lambda v=body: v)
        if tok == "(":
            v = self.or_()
            self.expect(")")
            return self.postfix(v)
        if tok == "[":
            items = []
            if self.peek()[1] != "]":
                items.append(self.or_())
                while self.peek()[1] == ",":
                    self.next()
                    items.append(self.or_())
            self.expect("]")
            return lambda: [it() for it in items]
        if kind == "ident":
            if tok == "true":
                return lambda: True
            if tok == "false":
                return lambda: False
            if tok == "device":
                return self.postfix(lambda: self.device)
            raise CelError(f"unknown identifier {tok!r}")
        raise CelError(f"unexpected token {tok!r}")

    def postfix(self, v: Thunk) -> Thunk:
        """Member access and indexing chains."""
        while True:
            _, tok = self.peek()
            if tok == ".":
                self.next()
                k2, name = self.next()
                if k2 != "ident":
                    raise CelError(f"expected member name, got {name!r}")
                v = self._member(v, name)
            elif tok == "[":
                self.next()
                idx = self.or_()
                self.expect("]")
                v = self._index(v, idx)
            else:
                return v

    def _member(self, v: Thunk, name: str) -> Thunk:
        def run():
            obj = v()
            if isinstance(obj, _Device):
                if name == "driver":
                    return obj.driver
                if name in ("attributes", "capacity"):
                    return ("attrmap", getattr(obj, name), name)
                raise CelError(f"unknown device member {name!r}")
            if isinstance(obj, _AttrMap):
                return obj.get(name)
            raise CelError(
                f"cannot access member {name!r} on {type(obj).__name__}"
            )

        return run

    def _index(self, v: Thunk, idx: Thunk) -> Thunk:
        def run():
            obj = v()
            if isinstance(obj, tuple) and obj and obj[0] == "attrmap":
                return _AttrMap(obj[1], str(idx()), self.driver,
                                is_capacity=obj[2] == "capacity")
            raise CelError(f"cannot index {type(obj).__name__}")

        return run


def evaluate_detailed(
    expression: str,
    driver: str,
    attributes: dict,
    capacity: dict | None = None,
) -> tuple[bool, str]:
    """Evaluate a selector expression against one device.

    Returns ``(matched, why_not)``: ``why_not`` is empty for a match (and
    for a plain boolean non-match), and names the absorbed evaluation
    error — the absent attribute, the type mismatch — when that is what
    made the device not match. The allocation explainer threads this into
    per-device rejection reasons, so a typo'd attribute name reads as
    ``attribute 'iciY' absent``, not as a silent non-match.

    A malformed expression raises :class:`CelError` with ``expression``
    attached (every raise path here is wrapped, including structural
    errors that only surface at evaluation time, e.g. an unknown
    ``device`` member)."""
    device = _Device(driver, attributes, capacity or {})
    try:
        thunk = _Parser(_tokenize(expression), driver, device).parse()
        result = bool(thunk())
    except _Missing as e:
        return False, (
            f"attribute {e.attribute!r} absent on device"
            if e.attribute else "referenced attribute absent on device"
        )
    except _TypeMismatch as e:
        return False, str(e)
    except _EvalError as e:
        return False, str(e) or "evaluation error"
    except CelError as e:
        if not e.expression:
            raise CelError(
                f"{e} in expression {expression!r}", expression=expression
            ) from e
        raise
    return result, ""


def evaluate(
    expression: str,
    driver: str,
    attributes: dict,
    capacity: dict | None = None,
) -> bool:
    """Evaluate a selector expression against one device. Returns False when
    the expression (irrecoverably) references attributes the device doesn't
    carry."""
    return evaluate_detailed(expression, driver, attributes, capacity)[0]
