"""A template engine for the prompts: the subset of Jinja2 that
``Environment(undefined=ChainableUndefined)`` renders, written for the port
(gorse's chat ranker and chat item-to-item render their prompts with Go
templates; the reference package renders them with jinja2).

Syntax: ``{{ expr }}``; ``{% for a in x %}`` and ``{% for a, b in x %}``
with ``{% else %}``; ``{% if %}``, ``{% elif %}``, ``{% else %}``; ``{# #}``
comments; ``-`` whitespace control at either end of a tag; inside a loop
``loop.index``, ``loop.index0``, ``loop.first``, ``loop.last`` and
``loop.length``. Expressions: string, number, list, tuple and dict
literals, ``true``/``false``/``none``; ``.attr`` (an attribute, then an
item) and ``[key]`` (an item, then an attribute); ``==``, ``!=``, ``<``,
``<=``, ``>``, ``>=`` (chained), ``in``, ``not in``, ``and``, ``or``,
``not``, ``~`` and ``+ - * / // % **`` with Jinja's precedence; the
filters ``default`` (``d``), ``join``, ``length`` (``count``), ``lower``,
``upper``, ``trim``, ``truncate``, ``replace``, ``reverse``, ``first``,
``last``, ``tojson``, ``string``, ``int`` and ``round``, each Jinja's
function.

Rendering follows Jinja's defaults: a value renders as ``str(value)`` (so
``None`` renders ``None``) without escaping; an undefined name, and any
chain of attributes or items on one, renders ``""``; arithmetic or ordering
on an undefined value raises; the source's line ends become ``\\n`` and one
trailing newline is dropped. Anything outside the subset (tests with
``is``, calls, slices, conditional expressions, ``set``, macros, other
filters and loop attributes, ...) raises :class:`TemplateSyntaxError` with
its line and column when the template is parsed, never at render time.
"""

from __future__ import annotations

import json
import math
import re

__all__ = ["Markup", "Template", "TemplateError", "TemplateSyntaxError", "Undefined",
           "UndefinedError", "from_string"]


class TemplateError(Exception):
    """A template failed while it rendered."""


class UndefinedError(TemplateError):
    """An undefined value was used where a value is needed."""


class TemplateSyntaxError(ValueError):
    """The source is not in the engine's subset of Jinja2."""

    def __init__(self, message: str, line: int, column: int) -> None:
        super().__init__(f"{message} (line {line}, column {column})")
        self.message, self.line, self.column = message, line, column


# ------------------------------------------------------------ values


def _fail(self, *args, **kwargs):
    raise UndefinedError("an undefined value was used")


class Undefined:
    """Jinja's ``ChainableUndefined``: renders as ``""``, is false, empty
    and iterable; an attribute or item of it is itself; arithmetic,
    ordering and conversion to a number raise :class:`UndefinedError`."""

    __slots__ = ()

    def __getattr__(self, name: str):
        if name[:2] == "__":
            raise AttributeError(name)
        return self

    def __getitem__(self, key):
        return self

    def __html__(self) -> str:
        return ""

    def __str__(self) -> str:
        return ""

    def __repr__(self) -> str:
        return "Undefined"

    def __bool__(self) -> bool:
        return False

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _fail
    __mod__ = __rmod__ = __pos__ = __neg__ = __call__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __int__ = __float__ = __complex__ = _fail
    __pow__ = __rpow__ = _fail


_ESCAPES = str.maketrans({"&": "&amp;", ">": "&gt;", "<": "&lt;", "'": "&#39;", '"': "&#34;"})


def _escape(value) -> "Markup":
    """markupsafe's ``escape``: a value with ``__html__`` as it says, any
    other one as its ``str`` with ``& < > ' "`` escaped."""
    if hasattr(value, "__html__"):
        return Markup(value.__html__())
    return Markup(str(value).translate(_ESCAPES))


class Markup(str):
    """What ``tojson`` returns, as markupsafe's ``Markup``: adding a plain
    string escapes it, and the string methods a filter reaches (``lower``,
    ``upper``, ``trim``, ``truncate``, ``reverse``) keep the type. ``%`` on
    it raises rather than format differently."""

    __slots__ = ()

    def __html__(self) -> "Markup":
        return self

    def __add__(self, other):
        if isinstance(other, str) or hasattr(other, "__html__"):
            return Markup(str.__add__(self, _escape(other)))
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, str) or hasattr(other, "__html__"):
            return _escape(other).__add__(self)
        return NotImplemented

    def __mul__(self, n):
        return Markup(str.__mul__(self, n))

    __rmul__ = __mul__

    def __mod__(self, arg):
        raise TemplateError("'%' on a tojson value is outside the template subset")

    def __getitem__(self, key):
        return Markup(str.__getitem__(self, key))

    def lower(self):
        return Markup(str.lower(self))

    def upper(self):
        return Markup(str.upper(self))

    def strip(self, chars=None):
        return Markup(str.strip(self, None if chars is None else _escape(chars)))

    def rsplit(self, sep=None, maxsplit=-1):
        return [Markup(v) for v in str.rsplit(self, sep, maxsplit)]


def _soft_str(value):
    return value if isinstance(value, str) else str(value)


def getattr_(obj, name):
    """``obj.name``: the attribute, else the item, else undefined."""
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined()


def getitem_(obj, key):
    """``obj[key]``: the item, else (for a string key) the attribute, else
    undefined."""
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return Undefined()


# ------------------------------------------------------------ filters
# Each one is Jinja 3.1's function (jinja2/filters.py) for an environment
# without autoescape.


def do_default(value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def do_join(value, d="", attribute=None):
    if attribute is not None:
        parts = [int(p) if p.isdigit() else p for p in attribute.split(".")] \
            if isinstance(attribute, str) else [attribute]

        def get(item):
            for part in parts:
                item = getitem_(item, part)
            return item

        value = map(get, value)
    return str(d).join(map(str, value))


def do_lower(s):
    return _soft_str(s).lower()


def do_upper(s):
    return _soft_str(s).upper()


def do_trim(value, chars=None):
    return _soft_str(value).strip(chars)


def do_truncate(s, length=255, killwords=False, end="...", leeway=None):
    if leeway is None:
        leeway = 5
    if not length >= len(end):
        raise TemplateError(f"expected length >= {len(end)}, got {length}")
    if not leeway >= 0:
        raise TemplateError(f"expected leeway >= 0, got {leeway}")
    if len(s) <= length + leeway:
        return s
    if killwords:
        return s[: length - len(end)] + end
    result = s[: length - len(end)].rsplit(" ", 1)[0]
    return result + end


def do_replace(s, old, new, count=None):
    if count is None:
        count = -1
    return str(s).replace(str(old), str(new), count)


def do_reverse(value):
    if isinstance(value, str):
        return value[::-1]
    try:
        return reversed(value)
    except TypeError:
        try:
            rv = list(value)
            rv.reverse()
            return rv
        except TypeError as e:
            raise TemplateError("argument must be iterable") from e


def do_first(seq):
    try:
        return next(iter(seq))
    except StopIteration:
        return Undefined()


def do_last(seq):
    try:
        return next(iter(reversed(seq)))
    except StopIteration:
        return Undefined()


def do_tojson(value, indent=None):
    kwargs = {"sort_keys": True}
    if indent is not None:
        kwargs["indent"] = indent
    return Markup(json.dumps(value, **kwargs).replace("<", "\\u003c").replace(">", "\\u003e")
                  .replace("&", "\\u0026").replace("'", "\\u0027"))


def do_int(value, default=0, base=10):
    try:
        if isinstance(value, str):
            return int(value, base)
        return int(value)
    except (TypeError, ValueError):
        try:
            return int(float(value))
        except (TypeError, ValueError, OverflowError):
            return default


def do_round(value, precision=0, method="common"):
    if method not in {"common", "ceil", "floor"}:
        raise TemplateError("method must be common, ceil or floor")
    if method == "common":
        return round(value, precision)
    func = getattr(math, method)
    return func(value * (10**precision)) / (10**precision)


FILTERS = {
    "default": do_default, "d": do_default, "join": do_join, "length": len, "count": len,
    "lower": do_lower, "upper": do_upper, "trim": do_trim, "truncate": do_truncate,
    "replace": do_replace, "reverse": do_reverse, "first": do_first, "last": do_last,
    "tojson": do_tojson, "string": _soft_str, "int": do_int, "round": do_round,
}

LOOP_ATTRS = ("index", "index0", "first", "last", "length")


# ------------------------------------------------------------ lexer

_NEWLINE = re.compile(r"\r\n|\r|\n")
_WS = re.compile(r"\s+")
_NAME = re.compile(r"[^\W\d]\w*")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'" r'|"([^"\\]*(?:\\.[^"\\]*)*)")', re.S)
_INTEGER = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*|0(_?0)*)",
                      re.IGNORECASE)
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|\.(\d+_)*\d+)",
                    re.IGNORECASE)
_OPERATORS = sorted(["+", "-", "/", "//", "*", "%", "**", "~", "[", "]", "(", ")", "{", "}",
                     "==", "!=", ">", ">=", "<", "<=", "=", ".", ":", "|", ",", ";"],
                    key=len, reverse=True)
_TAG = re.compile(r"\{\{|\{%|\{#")
_END_WS = re.compile(r"\s*")
_CLOSE = {"{{": "}}", "{%": "%}"}


class _Token:
    __slots__ = ("kind", "value", "line", "col")

    def __init__(self, kind, value, line, col):
        self.kind, self.value, self.line, self.col = kind, value, line, col

    def test(self, kind, value=None) -> bool:
        return self.kind == kind and (value is None or self.value == value)

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def _tokenize(source: str) -> list:
    """The source as ``data``, ``var_begin``, ``block_begin`` and ``end``
    tokens with the expression tokens between them; comments and the
    whitespace that ``-`` takes away are gone."""
    starts = [0] + [m.end() for m in re.finditer("\n", source)]

    def where(pos: int) -> tuple[int, int]:
        lo, hi = 0, len(starts) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if starts[mid] <= pos:
                lo = mid
            else:
                hi = mid - 1
        return lo + 1, pos - starts[lo] + 1

    def fail(message: str, pos: int):
        raise TemplateSyntaxError(message, *where(pos))

    tokens: list = []
    pos, n = 0, len(source)
    lstrip_next = False
    while pos < n:
        m = _TAG.search(source, pos)
        text = source[pos: m.start() if m else n]
        if lstrip_next:
            text = text.lstrip()  # the `-` of the tag before took it
            lstrip_next = False
        if not m:
            if text:
                tokens.append(_Token("data", text, *where(pos)))
            break
        tag, tag_pos = m.group(), m.start()
        pos = m.end()
        sign = source[pos: pos + 1]
        if sign == "-":
            text = text.rstrip()
            pos += 1
        elif sign == "+":
            fail("'+' whitespace control is outside the template subset", pos)
        if text:
            tokens.append(_Token("data", text, *where(m.start() - len(text))))
        if tag == "{#":
            end = source.find("#}", pos)
            if end < 0:
                fail("missing end of comment tag", tag_pos)
            if source[end - 1: end] == "-" and end - 1 >= pos:
                lstrip_next = True
            elif source[end - 1: end] == "+" and end - 1 >= pos:
                fail("'+' whitespace control is outside the template subset", end - 1)
            pos = end + 2
            continue
        close = _CLOSE[tag]
        tokens.append(_Token("var_begin" if tag == "{{" else "block_begin", tag, *where(tag_pos)))
        balance: list = []
        while True:
            if pos >= n:
                fail(f"unexpected end of template, expected '{close}'", tag_pos)
            if not balance:
                if source.startswith("-" + close, pos):
                    tokens.append(_Token("end", close, *where(pos)))
                    pos += 1 + len(close)
                    lstrip_next = True
                    break
                if source.startswith(close, pos):
                    tokens.append(_Token("end", close, *where(pos)))
                    pos += len(close)
                    break
            ws = _WS.match(source, pos)
            if ws:
                pos = ws.end()
                continue
            line, col = where(pos)
            if m2 := _FLOAT.match(source, pos):
                tokens.append(_Token("float", float(m2.group().replace("_", "")), line, col))
                pos = m2.end()
            elif m2 := _INTEGER.match(source, pos):
                tokens.append(_Token("integer", int(m2.group().replace("_", ""), 0), line, col))
                pos = m2.end()
            elif m2 := _NAME.match(source, pos):
                tokens.append(_Token("name", m2.group(), line, col))
                pos = m2.end()
            elif m2 := _STRING.match(source, pos):
                raw = m2.group()[1:-1]
                try:
                    value = raw.encode("ascii", "backslashreplace").decode("unicode-escape")
                except UnicodeDecodeError as e:
                    fail(f"bad string escape: {e}", pos)
                tokens.append(_Token("string", value, line, col))
                pos = m2.end()
            else:
                for op in _OPERATORS:
                    if source.startswith(op, pos):
                        break
                else:
                    fail(f"unexpected character {source[pos]!r}", pos)
                if op in "([{":
                    balance.append({"(": ")", "[": "]", "{": "}"}[op])
                elif op in ")]}":
                    if not balance or balance.pop() != op:
                        fail(f"unexpected '{op}'", pos)
                tokens.append(_Token("op", op, line, col))
                pos += len(op)
    tokens.append(_Token("eof", None, *where(n)))
    return tokens


# ------------------------------------------------------------ parser
# Nodes are tuples ("kind", ...); expressions are compiled to closures over
# the scope dict as they are parsed.

_COMPARE = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
            "<=": lambda a, b: a <= b, ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
            "in": lambda a, b: a in b, "notin": lambda a, b: a not in b}
_MATH = {"+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
         "/": lambda a, b: a / b, "//": lambda a, b: a // b, "%": lambda a, b: a % b,
         "**": lambda a, b: a ** b}
_CONSTANTS = {"true": True, "false": False, "none": None, "True": True, "False": False,
              "None": None}
_RESERVED = {"and", "or", "not", "in", "is", "if", "else"}
# names that Jinja's default environment defines
_JINJA_GLOBALS = {"range", "dict", "lipsum", "cycler", "joiner", "namespace"}


class _Loop:
    __slots__ = LOOP_ATTRS

    def __init__(self, i: int, n: int) -> None:
        self.index, self.index0, self.length = i + 1, i, n
        self.first, self.last = i == 0, i == n - 1


class _Parser:
    def __init__(self, source: str) -> None:
        self.tokens = _tokenize(source)
        self.pos = 0
        self.loop_depth = 0

    # -- token stream

    @property
    def cur(self) -> _Token:
        return self.tokens[self.pos]

    def next(self) -> _Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def fail(self, message: str, tok: _Token | None = None):
        tok = tok or self.cur
        raise TemplateSyntaxError(message, tok.line, tok.col)

    def expect(self, kind: str, value=None) -> _Token:
        if not self.cur.test(kind, value):
            want = value if value is not None else kind
            got = self.cur.value if self.cur.value is not None else self.cur.kind
            self.fail(f"expected {want!r}, got {got!r}")
        return self.next()

    def at_op(self, *ops) -> bool:
        return self.cur.kind == "op" and self.cur.value in ops

    def at_name(self, *names) -> bool:
        return self.cur.kind == "name" and self.cur.value in names

    # -- template

    def parse(self):
        body = self.subparse(())
        self.expect("eof")
        return body

    def subparse(self, end_names: tuple):
        """Nodes up to (not past) a ``{% name %}`` in ``end_names``."""
        body: list = []
        while True:
            tok = self.cur
            if tok.kind == "data":
                self.next()
                body.append(("data", tok.value))
            elif tok.kind == "var_begin":
                self.next()
                body.append(("out", self.parse_tuple()))
                self.expect("end", "}}")
            elif tok.kind == "block_begin":
                name = self.tokens[self.pos + 1]
                if name.kind == "name" and name.value in end_names:
                    return body
                self.next()
                if not name.kind == "name":
                    self.fail("expected a statement name", name)
                if name.value == "for":
                    body.append(self.parse_for())
                elif name.value == "if":
                    body.append(self.parse_if())
                elif name.value in ("endfor", "endif", "elif", "else"):
                    self.fail(f"unexpected '{name.value}'", name)
                else:
                    self.fail(f"statement '{name.value}' is outside the template subset", name)
            elif tok.kind == "eof":
                if end_names:
                    self.fail(f"unexpected end of template, expected {' or '.join(end_names)}")
                return body
            else:
                self.fail(f"unexpected {tok.value!r}")

    def block_name(self, *names) -> str:
        self.expect("block_begin")
        tok = self.expect("name")
        if tok.value not in names:
            self.fail(f"expected {' or '.join(names)}", tok)
        return tok.value

    def parse_for(self):
        self.next()  # for
        targets, comma = [], False
        paren = self.at_op("(")
        if paren:
            self.next()
        while True:
            tok = self.expect("name")
            if tok.value in _RESERVED or tok.value in _CONSTANTS:
                self.fail(f"cannot assign to {tok.value!r}", tok)
            if tok.value == "loop":
                self.fail("cannot assign to the special loop variable", tok)
            targets.append(tok.value)
            if not self.at_op(","):
                break
            self.next()
            comma = True
        if paren:
            self.expect("op", ")")
        unpack = comma
        self.expect("name", "in")
        iterable = self.parse_tuple()
        if self.at_name("if", "recursive"):
            self.fail(f"'{self.cur.value}' in a for loop is outside the template subset")
        self.expect("end", "%}")
        self.loop_depth += 1
        body = self.subparse(("endfor", "else"))
        self.loop_depth -= 1
        orelse: list = []
        if self.block_name("endfor", "else") == "else":
            self.expect("end", "%}")
            orelse = self.subparse(("endfor",))
            self.block_name("endfor")
        self.expect("end", "%}")
        return ("for", targets, unpack, iterable, body, orelse)

    def parse_if(self):
        self.next()  # if
        branches = []
        test = self.parse_tuple()
        self.expect("end", "%}")
        while True:
            body = self.subparse(("elif", "else", "endif"))
            branches.append((test, body))
            name = self.block_name("elif", "else", "endif")
            if name == "elif":
                test = self.parse_tuple()
                self.expect("end", "%}")
                continue
            orelse: list = []
            if name == "else":
                self.expect("end", "%}")
                orelse = self.subparse(("endif",))
                self.block_name("endif")
            self.expect("end", "%}")
            return ("if", branches, orelse)

    # -- expressions: each parse_* returns a closure of the scope

    def parse_tuple(self, explicit: bool = False):
        items, comma = [], False
        while True:
            if items:
                self.expect("op", ",")
                comma = True
            if self.cur.kind in ("end", "eof") or self.at_op(")"):
                break
            items.append(self.parse_expression())
            if not self.at_op(","):
                break
        if not items:
            if explicit:
                return lambda s: ()
            self.fail("expected an expression")
        if len(items) == 1 and not comma:
            return items[0]
        fns = tuple(items)
        return lambda s: tuple(f(s) for f in fns)

    def parse_expression(self):
        expr = self.parse_or()
        if self.at_name("if"):
            self.fail("conditional expressions are outside the template subset")
        return expr

    def parse_or(self):
        left = self.parse_and()
        while self.at_name("or"):
            self.next()
            right = self.parse_and()
            left = (lambda a, b: lambda s: a(s) or b(s))(left, right)
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.at_name("and"):
            self.next()
            right = self.parse_not()
            left = (lambda a, b: lambda s: a(s) and b(s))(left, right)
        return left

    def parse_not(self):
        if self.at_name("not"):
            self.next()
            inner = self.parse_not()
            return lambda s: not inner(s)
        return self.parse_compare()

    def parse_compare(self):
        first = self.parse_math1()
        ops = []
        while True:
            if self.at_op("==", "!=", "<", "<=", ">", ">="):
                op = self.next().value
            elif self.at_name("in"):
                self.next()
                op = "in"
            elif self.at_name("not") and self.tokens[self.pos + 1].test("name", "in"):
                self.pos += 2
                op = "notin"
            else:
                break
            ops.append((_COMPARE[op], self.parse_math1()))
        if not ops:
            return first
        ops = tuple(ops)

        def compare(s):
            left = first(s)
            for fn, operand in ops:
                right = operand(s)
                if not fn(left, right):
                    return False
                left = right
            return True

        return compare

    def _binary(self, ops, sub):
        left = sub()
        while self.at_op(*ops):
            fn = _MATH[self.next().value]
            right = sub()
            left = (lambda f, a, b: lambda s: f(a(s), b(s)))(fn, left, right)
        return left

    def parse_math1(self):
        return self._binary(("+", "-"), self.parse_concat)

    def parse_concat(self):
        parts = [self.parse_math2()]
        while self.at_op("~"):
            self.next()
            parts.append(self.parse_math2())
        if len(parts) == 1:
            return parts[0]
        parts = tuple(parts)
        return lambda s: "".join([str(p(s)) for p in parts])

    def parse_math2(self):
        return self._binary(("*", "/", "//", "%"), self.parse_pow)

    def parse_pow(self):
        return self._binary(("**",), self.parse_unary)

    def parse_unary(self, with_filter: bool = True):
        if self.at_op("-"):
            self.next()
            inner = self.parse_unary(False)
            node = lambda s: -inner(s)  # noqa: E731
        elif self.at_op("+"):
            self.next()
            inner = self.parse_unary(False)
            node = lambda s: +inner(s)  # noqa: E731
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        if with_filter:
            node = self.parse_filters(node)
        return node

    def parse_primary(self):
        tok = self.cur
        if tok.kind == "name":
            self.next()
            if tok.value in _CONSTANTS:
                value = _CONSTANTS[tok.value]
                return lambda s: value
            if tok.value in _RESERVED:
                self.fail(f"unexpected {tok.value!r}", tok)
            if tok.value in _JINJA_GLOBALS:
                self.fail(f"Jinja's global {tok.value!r} is outside the template subset", tok)
            if tok.value == "loop" and self.loop_depth:
                if not self.at_op(".") or not self.tokens[self.pos + 1].test("name") \
                        or self.tokens[self.pos + 1].value not in LOOP_ATTRS:
                    self.fail(f"the loop variable is used only as loop.{{{','.join(LOOP_ATTRS)}}}"
                              " in the template subset", tok)
            name = tok.value
            return lambda s: s[name] if name in s else Undefined()
        if tok.kind == "string":
            buf = []
            while self.cur.kind == "string":
                buf.append(self.next().value)
            value = "".join(buf)
            return lambda s: value
        if tok.kind in ("integer", "float"):
            self.next()
            value = tok.value
            return lambda s: value
        if self.at_op("("):
            self.next()
            node = self.parse_tuple(explicit=True)
            self.expect("op", ")")
            return node
        if self.at_op("["):
            self.next()
            items = []
            while not self.at_op("]"):
                if items:
                    self.expect("op", ",")
                    if self.at_op("]"):
                        break
                items.append(self.parse_expression())
            self.expect("op", "]")
            items = tuple(items)
            return lambda s: [f(s) for f in items]
        if self.at_op("{"):
            self.next()
            pairs = []
            while not self.at_op("}"):
                if pairs:
                    self.expect("op", ",")
                    if self.at_op("}"):
                        break
                k = self.parse_expression()
                self.expect("op", ":")
                pairs.append((k, self.parse_expression()))
            self.expect("op", "}")
            pairs = tuple(pairs)
            return lambda s: {k(s): v(s) for k, v in pairs}
        self.fail(f"unexpected {tok.value if tok.value is not None else tok.kind!r}")

    def parse_postfix(self, node):
        while True:
            if self.at_op("."):
                self.next()
                tok = self.next()
                if tok.kind == "name":
                    node = (lambda n, name: lambda s: getattr_(n(s), name))(node, tok.value)
                elif tok.kind == "integer":
                    node = (lambda n, key: lambda s: getitem_(n(s), key))(node, tok.value)
                else:
                    self.fail("expected a name or a number", tok)
            elif self.at_op("["):
                self.next()
                if self.at_op(":"):
                    self.fail("slices are outside the template subset")
                key = self.parse_expression()
                if self.at_op(":", ","):
                    self.fail("slices and tuple keys are outside the template subset")
                self.expect("op", "]")
                node = (lambda n, k: lambda s: getitem_(n(s), k(s)))(node, key)
            elif self.at_op("("):
                self.fail("calls are outside the template subset")
            else:
                return node

    def parse_filters(self, node):
        while True:
            if self.at_op("|"):
                self.next()
                tok = self.expect("name")
                if self.at_op("."):
                    self.fail("dotted filter names are outside the template subset")
                fn = FILTERS.get(tok.value)
                if fn is None:
                    self.fail(f"filter '{tok.value}' is outside the template subset", tok)
                args, kwargs = [], []
                if self.at_op("("):
                    self.next()
                    while not self.at_op(")"):
                        if args or kwargs:
                            self.expect("op", ",")
                            if self.at_op(")"):
                                break
                        if self.at_op("*", "**"):
                            self.fail("*args and **kwargs are outside the template subset")
                        if self.cur.kind == "name" and self.tokens[self.pos + 1].test("op", "="):
                            key = self.next().value
                            self.next()
                            kwargs.append((key, self.parse_expression()))
                        else:
                            if kwargs:
                                self.fail("a positional argument after a keyword argument")
                            args.append(self.parse_expression())
                    self.expect("op", ")")
                node = (lambda f, n, a, kw: lambda s: f(
                    n(s), *[x(s) for x in a], **{k: v(s) for k, v in kw}))(
                    fn, node, tuple(args), tuple(kwargs))
            elif self.at_name("is"):
                self.fail("tests ('is') are outside the template subset")
            elif self.at_op("("):
                self.fail("calls are outside the template subset")
            else:
                return node


# ------------------------------------------------------------ rendering


def _render(nodes, scope: dict, out: list) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "data":
            out.append(node[1])
        elif kind == "out":
            out.append(str(node[1](scope)))
        elif kind == "if":
            for test, body in node[1]:
                if test(scope):
                    _render(body, scope, out)
                    break
            else:
                _render(node[2], scope, out)
        else:  # for
            _, targets, unpack, iterable, body, orelse = node
            values = list(iterable(scope))
            n = len(values)
            for i, value in enumerate(values):
                inner = dict(scope)
                if unpack:
                    parts = tuple(value)
                    if len(parts) != len(targets):
                        raise TemplateError(f"cannot unpack {len(parts)} values into "
                                            f"{len(targets)} names")
                    inner.update(zip(targets, parts))
                else:
                    inner[targets[0]] = value
                inner["loop"] = _Loop(i, n)
                _render(body, inner, out)
            if not n:
                _render(orelse, scope, out)


class Template:
    """A parsed template; :meth:`render` fills it from a context."""

    def __init__(self, source: str) -> None:
        # Jinja's lexer: each \r\n, \r and \n becomes "\n", and one
        # trailing newline is dropped
        lines = _NEWLINE.split(source)
        if lines[-1] == "":
            del lines[-1]
        self.source = "\n".join(lines)
        self._nodes = _Parser(self.source).parse()

    def render(self, *args, **kwargs) -> str:
        scope = dict(*args, **kwargs)
        out: list = []
        _render(self._nodes, scope, out)
        return "".join(out)


def from_string(source: str) -> Template:
    """Parse ``source``; raises :class:`TemplateSyntaxError` (with the line
    and column) for anything outside the subset."""
    return Template(source)
