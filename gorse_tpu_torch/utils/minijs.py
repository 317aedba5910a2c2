"""A small self-contained JavaScript interpreter (ES5 subset + arrow
functions, template literals, for-of, spread/rest, default parameters):
the port's own copy of gorse_tpu/utils/minijs.py (standard library only).

The reference runs user-supplied external-recommender scripts inside a
QuickJS VM with an injected ``fetch`` (reference: logics/external.go:29-101,
config.ExternalConfig{Name, Script} config/config.go:367-370). QuickJS is a C
engine that is not in this image; this module provides the same capability
natively: enough JavaScript to express recommendation glue code — objects,
arrays, closures, control flow, JSON, string/array/Math builtins — with
host-function injection (``Interpreter.register``), per-eval operation
budgets, and recursion caps so an untrusted script cannot hang or exhaust
the node.

Value mapping (JS <-> Python):
  undefined <-> ``UNDEFINED`` sentinel · null <-> ``None`` · number <->
  ``float`` · string <-> ``str`` · boolean <-> ``bool`` · Array <-> ``list``
  · Object <-> ``dict`` · Function <-> ``JSFunction`` / native callable.

Not supported (documented non-goals for recommender glue): prototypes/
classes, generators, async/await (``fetch`` is synchronous, as in the
reference's RegisterFunc(..., false)), regular expressions, labels, getters/
setters, ``with``.
"""

from __future__ import annotations

import json as _json
import math
import time
import urllib.parse
from typing import Any, Callable

__all__ = [
    "Interpreter",
    "JSError",
    "JSSyntaxError",
    "JSThrow",
    "UNDEFINED",
    "JSFunction",
    "NativeFunction",
    "js_str",
    "to_python",
]


class JSUndefined:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "undefined"

    def __bool__(self) -> bool:
        return False


UNDEFINED = JSUndefined()


class JSError(Exception):
    """Host-level interpreter error (budget exceeded, depth exceeded...)."""


class JSSyntaxError(JSError):
    """Script failed to parse."""


class JSThrow(Exception):
    """A JS ``throw`` propagating through host code."""

    def __init__(self, value: Any) -> None:
        self.value = value
        super().__init__(js_err_message(value))


def js_err_message(value: Any) -> str:
    if isinstance(value, dict) and "message" in value:
        name = value.get("name", "Error")
        return f"{js_str(name)}: {js_str(value['message'])}"
    return js_str(value)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

KEYWORDS = {
    "var", "let", "const", "if", "else", "while", "do", "for", "function",
    "return", "break", "continue", "throw", "try", "catch", "finally",
    "switch", "case", "default", "new", "typeof", "instanceof", "in", "of",
    "delete", "void", "this", "true", "false", "null",
}

PUNCTUATORS = [
    ">>>=", "===", "!==", "**=", ">>>", "...", "=>", "==", "!=", "<=", ">=",
    "&&=", "||=", "??=", "&&", "||", "??", "++", "--", "+=", "-=", "*=",
    "/=", "%=", "&=", "|=", "^=", "<<=", ">>=", "**", "<<", ">>", "{", "}",
    "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/", "%", "&",
    "|", "^", "~", "!", "?", ":", "=", ".",
]


class Token:
    __slots__ = ("kind", "value", "pos", "line", "nl_before")

    def __init__(self, kind: str, value: Any, pos: int, line: int, nl_before: bool):
        self.kind = kind          # num | str | template | name | keyword | punct | eof
        self.value = value
        self.pos = pos
        self.line = line
        self.nl_before = nl_before

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Token({self.kind},{self.value!r},l{self.line})"


_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
            "v": "\v", "0": "\0", "'": "'", '"': '"', "`": "`", "\\": "\\"}


def _is_id_start(c: str) -> bool:
    return c.isalpha() or c in "_$"


def _is_id_char(c: str) -> bool:
    return c.isalnum() or c in "_$"


class Lexer:
    def __init__(self, src: str) -> None:
        self.src = src
        self.i = 0
        self.line = 1
        self.nl = False

    def error(self, msg: str) -> JSSyntaxError:
        return JSSyntaxError(f"SyntaxError: {msg} (line {self.line})")

    def tokens(self) -> list[Token]:
        out: list[Token] = []
        while True:
            tok = self.next_token()
            out.append(tok)
            if tok.kind == "eof":
                return out

    def _skip_ws(self) -> None:
        src, n = self.src, len(self.src)
        while self.i < n:
            c = src[self.i]
            if c == "\n":
                self.line += 1
                self.nl = True
                self.i += 1
            elif c in " \t\r\f\v ":
                self.i += 1
            elif c == "/" and self.i + 1 < n and src[self.i + 1] == "/":
                while self.i < n and src[self.i] != "\n":
                    self.i += 1
            elif c == "/" and self.i + 1 < n and src[self.i + 1] == "*":
                end = src.find("*/", self.i + 2)
                if end < 0:
                    raise self.error("unterminated comment")
                self.line += src.count("\n", self.i, end)
                if src.count("\n", self.i, end):
                    self.nl = True
                self.i = end + 2
            else:
                return

    def next_token(self) -> Token:
        self._skip_ws()
        nl, self.nl = self.nl, False
        src, n = self.src, len(self.src)
        pos, line = self.i, self.line
        if self.i >= n:
            return Token("eof", None, pos, line, nl)
        c = src[self.i]
        if _is_id_start(c):
            j = self.i + 1
            while j < n and _is_id_char(src[j]):
                j += 1
            word = src[self.i:j]
            self.i = j
            kind = "keyword" if word in KEYWORDS else "name"
            return Token(kind, word, pos, line, nl)
        if c.isdigit() or (c == "." and self.i + 1 < n and src[self.i + 1].isdigit()):
            return Token("num", self._read_number(), pos, line, nl)
        if c in "'\"":
            return Token("str", self._read_string(c), pos, line, nl)
        if c == "`":
            return Token("template", self._read_template(), pos, line, nl)
        for p in PUNCTUATORS:
            if src.startswith(p, self.i):
                self.i += len(p)
                return Token("punct", p, pos, line, nl)
        raise self.error(f"unexpected character {c!r}")

    def _read_number(self) -> float:
        src, n = self.src, len(self.src)
        start = self.i
        if src[self.i] == "0" and self.i + 1 < n and src[self.i + 1] in "xXoObB":
            base = {"x": 16, "o": 8, "b": 2}[src[self.i + 1].lower()]
            j = self.i + 2
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            text = src[self.i + 2:j].replace("_", "")
            self.i = j
            try:
                return float(int(text, base))
            except ValueError:
                raise self.error(f"invalid number {src[start:j]!r}") from None
        j = self.i
        while j < n and (src[j].isdigit() or src[j] == "_"):
            j += 1
        if j < n and src[j] == ".":
            j += 1
            while j < n and (src[j].isdigit() or src[j] == "_"):
                j += 1
        if j < n and src[j] in "eE":
            k = j + 1
            if k < n and src[k] in "+-":
                k += 1
            if k < n and src[k].isdigit():
                j = k
                while j < n and src[j].isdigit():
                    j += 1
        text = src[self.i:j].replace("_", "")
        self.i = j
        try:
            return float(text)
        except ValueError:
            raise self.error(f"invalid number {text!r}") from None

    def _read_escape(self) -> str:
        src, n = self.src, len(self.src)
        self.i += 1  # past backslash
        if self.i >= n:
            raise self.error("unterminated escape")
        e = src[self.i]
        if e == "x":
            h = src[self.i + 1:self.i + 3]
            self.i += 3
            return chr(int(h, 16))
        if e == "u":
            if src[self.i + 1:self.i + 2] == "{":
                end = src.find("}", self.i + 2)
                if end < 0:
                    raise self.error("unterminated unicode escape")
                cp = int(src[self.i + 2:end], 16)
                self.i = end + 1
                return chr(cp)
            h = src[self.i + 1:self.i + 5]
            self.i += 5
            return chr(int(h, 16))
        if e == "\n":  # line continuation
            self.line += 1
            self.i += 1
            return ""
        self.i += 1
        return _ESCAPES.get(e, e)

    def _read_string(self, quote: str) -> str:
        src, n = self.src, len(self.src)
        self.i += 1
        parts: list[str] = []
        while self.i < n:
            c = src[self.i]
            if c == quote:
                self.i += 1
                return "".join(parts)
            if c == "\\":
                parts.append(self._read_escape())
            elif c == "\n":
                raise self.error("unterminated string literal")
            else:
                parts.append(c)
                self.i += 1
        raise self.error("unterminated string literal")

    def _read_template(self) -> list[tuple[str, str]]:
        """Return parts: ("str", cooked) literal chunks and ("expr", src)
        interpolation sources (parsed later by the Parser)."""
        src, n = self.src, len(self.src)
        self.i += 1
        parts: list[tuple[str, str]] = []
        lit: list[str] = []
        while self.i < n:
            c = src[self.i]
            if c == "`":
                self.i += 1
                if lit:
                    parts.append(("str", "".join(lit)))
                return parts
            if c == "\\":
                lit.append(self._read_escape())
                continue
            if c == "$" and src[self.i + 1:self.i + 2] == "{":
                if lit:
                    parts.append(("str", "".join(lit)))
                    lit = []
                # find the matching close brace, respecting nested braces,
                # strings, and templates
                j = self.i + 2
                depth = 1
                while j < n and depth:
                    ch = src[j]
                    if ch == "{":
                        depth += 1
                    elif ch == "}":
                        depth -= 1
                        if not depth:
                            break
                    elif ch in "'\"`":
                        q = ch
                        j += 1
                        while j < n and src[j] != q:
                            if src[j] == "\\":
                                j += 1
                            j += 1
                    elif ch == "\n":
                        self.line += 1
                    j += 1
                if depth:
                    raise self.error("unterminated template expression")
                parts.append(("expr", src[self.i + 2:j]))
                self.i = j + 1
                continue
            if c == "\n":
                self.line += 1
            lit.append(c)
            self.i += 1
        raise self.error("unterminated template literal")


# ---------------------------------------------------------------------------
# Parser — recursive descent producing tuple ASTs
# ---------------------------------------------------------------------------

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "**=", "&=", "|=", "^=",
               "<<=", ">>=", ">>>=", "&&=", "||=", "??="}


class Parser:
    def __init__(self, src: str) -> None:
        self.toks = Lexer(src).tokens()
        self.p = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        j = min(self.p + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.p]
        if t.kind != "eof":
            self.p += 1
        return t

    def at(self, kind: str, value: Any = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value: Any = None) -> Token | None:
        if self.at(kind, value):
            return self.next()
        return None

    def expect(self, kind: str, value: Any = None) -> Token:
        t = self.peek()
        if t.kind != kind or (value is not None and t.value != value):
            want = value if value is not None else kind
            raise JSSyntaxError(
                f"SyntaxError: expected {want!r}, got {t.value!r} (line {t.line})"
            )
        return self.next()

    def eat_semi(self) -> None:
        """Automatic semicolon insertion: accept ';', '}' / EOF, or a newline
        before the next token."""
        if self.eat("punct", ";"):
            return
        t = self.peek()
        if t.kind == "eof" or (t.kind == "punct" and t.value == "}") or t.nl_before:
            return
        raise JSSyntaxError(
            f"SyntaxError: expected ';', got {t.value!r} (line {t.line})"
        )

    # -- program ------------------------------------------------------------
    def parse_program(self) -> list[tuple]:
        stmts: list[tuple] = []
        while not self.at("eof"):
            stmts.append(self.parse_statement())
        return stmts

    # -- statements ---------------------------------------------------------
    def parse_statement(self) -> tuple:
        t = self.peek()
        if t.kind == "punct":
            if t.value == "{":
                return self.parse_block()
            if t.value == ";":
                self.next()
                return ("empty",)
        if t.kind == "keyword":
            v = t.value
            if v in ("var", "let", "const"):
                self.next()
                node = self.parse_var_declarations(v)
                self.eat_semi()
                return node
            if v == "if":
                return self.parse_if()
            if v == "while":
                self.next()
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                return ("while", cond, self.parse_statement())
            if v == "do":
                self.next()
                body = self.parse_statement()
                self.expect("keyword", "while")
                self.expect("punct", "(")
                cond = self.parse_expression()
                self.expect("punct", ")")
                self.eat("punct", ";")
                return ("dowhile", body, cond)
            if v == "for":
                return self.parse_for()
            if v == "function":
                self.next()
                name = self.expect("name").value
                fn = self.parse_function_rest(name)
                return ("fndecl", name, fn)
            if v == "return":
                self.next()
                nxt = self.peek()
                if nxt.nl_before or (nxt.kind == "punct" and nxt.value in (";", "}")) \
                        or nxt.kind == "eof":
                    self.eat_semi()
                    return ("return", None)
                e = self.parse_expression()
                self.eat_semi()
                return ("return", e)
            if v in ("break", "continue"):
                self.next()
                self.eat_semi()
                return (v,)
            if v == "throw":
                self.next()
                if self.peek().nl_before:
                    raise JSSyntaxError("SyntaxError: newline after throw")
                e = self.parse_expression()
                self.eat_semi()
                return ("throw", e)
            if v == "try":
                return self.parse_try()
            if v == "switch":
                return self.parse_switch()
        e = self.parse_expression()
        self.eat_semi()
        return ("expr", e)

    def parse_block(self) -> tuple:
        self.expect("punct", "{")
        stmts: list[tuple] = []
        while not self.eat("punct", "}"):
            if self.at("eof"):
                raise JSSyntaxError("SyntaxError: unterminated block")
            stmts.append(self.parse_statement())
        return ("block", stmts)

    def parse_var_declarations(self, kind: str) -> tuple:
        decls: list[tuple[str, tuple | None]] = []
        while True:
            name = self.expect("name").value
            init = None
            if self.eat("punct", "="):
                init = self.parse_assign()
            decls.append((name, init))
            if not self.eat("punct", ","):
                break
        return ("var", kind, decls)

    def parse_if(self) -> tuple:
        self.expect("keyword", "if")
        self.expect("punct", "(")
        cond = self.parse_expression()
        self.expect("punct", ")")
        then = self.parse_statement()
        other = None
        if self.eat("keyword", "else"):
            other = self.parse_statement()
        return ("if", cond, then, other)

    def parse_for(self) -> tuple:
        self.expect("keyword", "for")
        self.expect("punct", "(")
        # for-in / for-of with declaration
        decl_kind = None
        if self.peek().kind == "keyword" and self.peek().value in ("var", "let", "const"):
            decl_kind = self.peek().value
            if self.peek(1).kind == "name" and self.peek(2).kind == "keyword" \
                    and self.peek(2).value in ("in", "of"):
                self.next()
                name = self.next().value
                loop = self.next().value  # in | of
                obj = self.parse_expression()
                self.expect("punct", ")")
                body = self.parse_statement()
                return ("for" + loop, decl_kind, name, obj, body)
        # bare `for (x of arr)` / `for (x in obj)`
        if self.peek().kind == "name" and self.peek(1).kind == "keyword" \
                and self.peek(1).value in ("in", "of"):
            name = self.next().value
            loop = self.next().value
            obj = self.parse_expression()
            self.expect("punct", ")")
            body = self.parse_statement()
            return ("for" + loop, None, name, obj, body)
        init = None
        if not self.at("punct", ";"):
            if decl_kind is not None:
                self.next()
                init = self.parse_var_declarations(decl_kind)
            else:
                init = ("expr", self.parse_expression())
        self.expect("punct", ";")
        test = None if self.at("punct", ";") else self.parse_expression()
        self.expect("punct", ";")
        update = None if self.at("punct", ")") else self.parse_expression()
        self.expect("punct", ")")
        return ("for", init, test, update, self.parse_statement())

    def parse_try(self) -> tuple:
        self.expect("keyword", "try")
        block = self.parse_block()
        param = None
        handler = None
        finalizer = None
        if self.eat("keyword", "catch"):
            if self.eat("punct", "("):
                param = self.expect("name").value
                self.expect("punct", ")")
            handler = self.parse_block()
        if self.eat("keyword", "finally"):
            finalizer = self.parse_block()
        if handler is None and finalizer is None:
            raise JSSyntaxError("SyntaxError: try without catch or finally")
        return ("try", block, param, handler, finalizer)

    def parse_switch(self) -> tuple:
        self.expect("keyword", "switch")
        self.expect("punct", "(")
        disc = self.parse_expression()
        self.expect("punct", ")")
        self.expect("punct", "{")
        cases: list[tuple[tuple | None, list[tuple]]] = []
        while not self.eat("punct", "}"):
            if self.eat("keyword", "case"):
                test = self.parse_expression()
            elif self.eat("keyword", "default"):
                test = None
            else:
                raise JSSyntaxError("SyntaxError: expected case/default")
            self.expect("punct", ":")
            body: list[tuple] = []
            while not (self.at("keyword", "case") or self.at("keyword", "default")
                       or self.at("punct", "}")):
                body.append(self.parse_statement())
            cases.append((test, body))
        return ("switch", disc, cases)

    # -- functions ----------------------------------------------------------
    def parse_function_rest(self, name: str | None) -> tuple:
        """Parse params + body after the `function [name]` head."""
        self.expect("punct", "(")
        params, rest = self.parse_params()
        body = self.parse_block()
        return ("fn", name, params, rest, body, False, False)

    def parse_params(self) -> tuple[list[tuple[str, tuple | None]], str | None]:
        params: list[tuple[str, tuple | None]] = []
        rest: str | None = None
        while not self.eat("punct", ")"):
            if self.eat("punct", "..."):
                rest = self.expect("name").value
                self.expect("punct", ")")
                break
            pname = self.expect("name").value
            default = None
            if self.eat("punct", "="):
                default = self.parse_assign()
            params.append((pname, default))
            if not self.eat("punct", ","):
                self.expect("punct", ")")
                break
        return params, rest

    # -- expressions --------------------------------------------------------
    def parse_expression(self) -> tuple:
        e = self.parse_assign()
        if self.at("punct", ","):
            exprs = [e]
            while self.eat("punct", ","):
                exprs.append(self.parse_assign())
            return ("comma", exprs)
        return e

    def parse_assign(self) -> tuple:
        arrow = self.try_parse_arrow()
        if arrow is not None:
            return arrow
        left = self.parse_conditional()
        t = self.peek()
        if t.kind == "punct" and t.value in _ASSIGN_OPS:
            if left[0] not in ("name", "member", "index"):
                raise JSSyntaxError("SyntaxError: invalid assignment target")
            self.next()
            right = self.parse_assign()
            return ("assign", t.value, left, right)
        return left

    def try_parse_arrow(self) -> tuple | None:
        """Detect `(params) =>` / `name =>` with bounded lookahead."""
        t = self.peek()
        if t.kind == "name" and self.peek(1).kind == "punct" \
                and self.peek(1).value == "=>" and not self.peek(1).nl_before:
            self.next()
            self.next()
            return self.parse_arrow_body([(t.value, None)], None)
        if t.kind == "punct" and t.value == "(":
            j = self.p + 1
            depth = 1
            while j < len(self.toks) and depth:
                tk = self.toks[j]
                if tk.kind == "punct":
                    if tk.value in ("(", "[", "{"):
                        depth += 1
                    elif tk.value in (")", "]", "}"):
                        depth -= 1
                j += 1
            if j < len(self.toks):
                after = self.toks[j]
                if after.kind == "punct" and after.value == "=>" and not after.nl_before:
                    self.next()  # (
                    params, rest = self.parse_params()
                    self.expect("punct", "=>")
                    return self.parse_arrow_body(params, rest)
        return None

    def parse_arrow_body(self, params, rest) -> tuple:
        if self.at("punct", "{"):
            body = self.parse_block()
            return ("fn", None, params, rest, body, True, False)
        body = self.parse_assign()
        return ("fn", None, params, rest, body, True, True)

    def parse_conditional(self) -> tuple:
        cond = self.parse_nullish()
        if self.eat("punct", "?"):
            a = self.parse_assign()
            self.expect("punct", ":")
            b = self.parse_assign()
            return ("cond", cond, a, b)
        return cond

    def _parse_binary(self, sub: Callable[[], tuple], ops: tuple[str, ...],
                      node: str = "binop") -> tuple:
        left = sub()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ops:
                self.next()
                left = (node, t.value, left, sub())
            elif t.kind == "keyword" and t.value in ops:
                self.next()
                left = (node, t.value, left, sub())
            else:
                return left

    def parse_nullish(self) -> tuple:
        return self._parse_binary(self.parse_or, ("??",), "logic")

    def parse_or(self) -> tuple:
        return self._parse_binary(self.parse_and, ("||",), "logic")

    def parse_and(self) -> tuple:
        return self._parse_binary(self.parse_bitor, ("&&",), "logic")

    def parse_bitor(self) -> tuple:
        return self._parse_binary(self.parse_bitxor, ("|",))

    def parse_bitxor(self) -> tuple:
        return self._parse_binary(self.parse_bitand, ("^",))

    def parse_bitand(self) -> tuple:
        return self._parse_binary(self.parse_equality, ("&",))

    def parse_equality(self) -> tuple:
        return self._parse_binary(self.parse_relational,
                                  ("==", "!=", "===", "!=="))

    def parse_relational(self) -> tuple:
        return self._parse_binary(self.parse_shift,
                                  ("<", ">", "<=", ">=", "instanceof", "in"))

    def parse_shift(self) -> tuple:
        return self._parse_binary(self.parse_additive, ("<<", ">>", ">>>"))

    def parse_additive(self) -> tuple:
        return self._parse_binary(self.parse_multiplicative, ("+", "-"))

    def parse_multiplicative(self) -> tuple:
        return self._parse_binary(self.parse_exponent, ("*", "/", "%"))

    def parse_exponent(self) -> tuple:
        left = self.parse_unary()
        if self.at("punct", "**"):
            self.next()
            return ("binop", "**", left, self.parse_exponent())  # right-assoc
        return left

    def parse_unary(self) -> tuple:
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "~", "+", "-"):
            self.next()
            return ("unary", t.value, self.parse_unary())
        if t.kind == "keyword" and t.value in ("typeof", "void", "delete"):
            self.next()
            return ("unary", t.value, self.parse_unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            target = self.parse_unary()
            if target[0] not in ("name", "member", "index"):
                raise JSSyntaxError("SyntaxError: invalid update target")
            return ("update", t.value, True, target)
        return self.parse_postfix()

    def parse_postfix(self) -> tuple:
        e = self.parse_call_member()
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--") and not t.nl_before:
            if e[0] not in ("name", "member", "index"):
                raise JSSyntaxError("SyntaxError: invalid update target")
            self.next()
            return ("update", t.value, False, e)
        return e

    def parse_call_member(self) -> tuple:
        if self.at("keyword", "new"):
            self.next()
            callee = self.parse_member_only(self.parse_primary())
            args = self.parse_arguments() if self.at("punct", "(") else []
            e: tuple = ("new", callee, args)
        else:
            e = self.parse_primary()
        while True:
            if self.eat("punct", "."):
                name = self.next()
                if name.kind not in ("name", "keyword"):
                    raise JSSyntaxError("SyntaxError: expected property name")
                e = ("member", e, name.value)
            elif self.at("punct", "?") and self.peek(1).kind == "punct" \
                    and self.peek(1).value == ".":
                # optional chaining a?.b  (tokenized as ? .)
                self.next()
                self.next()
                if self.at("punct", "("):
                    e = ("optcall", e, self.parse_arguments())
                else:
                    name = self.next()
                    e = ("optmember", e, name.value)
            elif self.at("punct", "["):
                self.next()
                idx = self.parse_expression()
                self.expect("punct", "]")
                e = ("index", e, idx)
            elif self.at("punct", "("):
                e = ("call", e, self.parse_arguments())
            else:
                return e

    def parse_member_only(self, e: tuple) -> tuple:
        while True:
            if self.eat("punct", "."):
                name = self.next()
                e = ("member", e, name.value)
            elif self.at("punct", "["):
                self.next()
                idx = self.parse_expression()
                self.expect("punct", "]")
                e = ("index", e, idx)
            else:
                return e

    def parse_arguments(self) -> list[tuple]:
        self.expect("punct", "(")
        args: list[tuple] = []
        while not self.eat("punct", ")"):
            if self.eat("punct", "..."):
                args.append(("spread", self.parse_assign()))
            else:
                args.append(self.parse_assign())
            if not self.eat("punct", ","):
                self.expect("punct", ")")
                break
        return args

    def parse_primary(self) -> tuple:
        t = self.peek()
        if t.kind == "num":
            self.next()
            return ("lit", t.value)
        if t.kind == "str":
            self.next()
            return ("lit", t.value)
        if t.kind == "template":
            self.next()
            parts: list[tuple] = []
            for kind, val in t.value:
                if kind == "str":
                    parts.append(("lit", val))
                else:
                    parts.append(Parser(val).parse_expression())
            return ("tmpl", parts)
        if t.kind == "name":
            self.next()
            return ("name", t.value)
        if t.kind == "keyword":
            if t.value == "true":
                self.next()
                return ("lit", True)
            if t.value == "false":
                self.next()
                return ("lit", False)
            if t.value == "null":
                self.next()
                return ("lit", None)
            if t.value == "this":
                self.next()
                return ("this",)
            if t.value == "function":
                self.next()
                name = self.eat("name")
                return self.parse_function_rest(name.value if name else None)
            if t.value == "new":
                return self.parse_call_member()
        if t.kind == "punct":
            if t.value == "(":
                self.next()
                e = self.parse_expression()
                self.expect("punct", ")")
                return e
            if t.value == "[":
                self.next()
                elems: list[tuple] = []
                while not self.eat("punct", "]"):
                    if self.at("punct", ","):
                        self.next()
                        elems.append(("lit", UNDEFINED))  # elision
                        continue
                    if self.eat("punct", "..."):
                        elems.append(("spread", self.parse_assign()))
                    else:
                        elems.append(self.parse_assign())
                    if not self.eat("punct", ","):
                        self.expect("punct", "]")
                        break
                return ("arr", elems)
            if t.value == "{":
                return self.parse_object_literal()
        raise JSSyntaxError(
            f"SyntaxError: unexpected token {t.value!r} (line {t.line})"
        )

    def parse_object_literal(self) -> tuple:
        self.expect("punct", "{")
        props: list[tuple] = []
        while not self.eat("punct", "}"):
            if self.eat("punct", "..."):
                props.append(("spread", None, self.parse_assign()))
            else:
                t = self.peek()
                if t.kind == "punct" and t.value == "[":
                    self.next()
                    key_expr = self.parse_assign()
                    self.expect("punct", "]")
                    self.expect("punct", ":")
                    props.append(("computed", key_expr, self.parse_assign()))
                else:
                    if t.kind in ("name", "keyword"):
                        key = t.value
                    elif t.kind == "str":
                        key = t.value
                    elif t.kind == "num":
                        key = fmt_num(t.value)
                    else:
                        raise JSSyntaxError(
                            f"SyntaxError: bad property key {t.value!r} (line {t.line})"
                        )
                    self.next()
                    if self.at("punct", "("):  # method shorthand
                        fn = self.parse_function_rest(key)
                        props.append(("prop", key, fn))
                    elif self.eat("punct", ":"):
                        props.append(("prop", key, self.parse_assign()))
                    else:  # shorthand {a}
                        if t.kind != "name":
                            raise JSSyntaxError(
                                f"SyntaxError: bad shorthand {key!r} (line {t.line})"
                            )
                        props.append(("prop", key, ("name", key)))
            if not self.eat("punct", ","):
                self.expect("punct", "}")
                break
        return ("obj", props)


# ---------------------------------------------------------------------------
# Values and coercions
# ---------------------------------------------------------------------------

class JSFunction:
    __slots__ = ("name", "params", "rest", "body", "env", "is_arrow",
                 "is_expr_body", "bound_this", "interp")

    def __init__(self, name, params, rest, body, env, is_arrow, is_expr_body,
                 interp) -> None:
        self.name = name or ""
        self.params = params
        self.rest = rest
        self.body = body
        self.env = env
        self.is_arrow = is_arrow
        self.is_expr_body = is_expr_body
        self.bound_this = None
        self.interp = interp

    def __call__(self, *args: Any) -> Any:
        """Host-side convenience: call a JS function from Python."""
        return self.interp.call_function(self, list(args), UNDEFINED)

    def __repr__(self) -> str:
        return f"function {self.name}() {{ ... }}"


class NativeFunction:
    """A Python callable exposed to JS. ``fn(*args)`` receives JS values.
    If ``pass_this`` is set, the call receives ``(this, *args)``."""

    __slots__ = ("name", "fn", "pass_this")

    def __init__(self, name: str, fn: Callable, pass_this: bool = False) -> None:
        self.name = name
        self.fn = fn
        self.pass_this = pass_this

    def __repr__(self) -> str:
        return f"function {self.name}() {{ [native code] }}"


def is_callable(v: Any) -> bool:
    return isinstance(v, (JSFunction, NativeFunction))


def fmt_num(x: float) -> str:
    """JS Number→string."""
    if isinstance(x, bool):
        return "true" if x else "false"
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == int(x) and abs(x) < 1e21:
        return str(int(x))
    r = repr(float(x))
    if "e" in r:
        mant, exp = r.split("e")
        expi = int(exp)
        return f"{mant}e{'+' if expi >= 0 else ''}{expi}"
    return r


def js_str(v: Any) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return fmt_num(float(v))
    if isinstance(v, str):
        return v
    if isinstance(v, list):
        return ",".join("" if e is None or e is UNDEFINED else js_str(e) for e in v)
    if isinstance(v, dict):
        return "[object Object]"
    if is_callable(v):
        return repr(v)
    return str(v)


def js_num(v: Any) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)):
        return float(v)
    if v is None:
        return 0.0
    if v is UNDEFINED:
        return math.nan
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            if s.lower().startswith(("0x", "-0x", "+0x")):
                return float(int(s, 16))
            if s in ("Infinity", "+Infinity"):
                return math.inf
            if s == "-Infinity":
                return -math.inf
            return float(s)
        except ValueError:
            return math.nan
    if isinstance(v, list):
        if not v:
            return 0.0
        if len(v) == 1:
            return js_num(v[0]) if not isinstance(v[0], (list, dict)) else math.nan
        return math.nan
    return math.nan


def js_truthy(v: Any) -> bool:
    if v is UNDEFINED or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return not (v == 0 or math.isnan(v))
    if isinstance(v, str):
        return bool(v)
    return True  # objects, arrays, functions


def to_primitive(v: Any) -> Any:
    if isinstance(v, (list, dict)) or is_callable(v):
        return js_str(v)
    return v


def js_typeof(v: Any) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "object"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if is_callable(v):
        return "function"
    return "object"


def strict_eq(a: Any, b: Any) -> bool:
    if a is UNDEFINED or b is UNDEFINED:
        return a is b
    if a is None or b is None:
        return a is b
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        fa, fb = float(a), float(b)
        if math.isnan(fa) or math.isnan(fb):
            return False
        return fa == fb
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b  # objects/arrays/functions: identity


def loose_eq(a: Any, b: Any) -> bool:
    nullish_a = a is None or a is UNDEFINED
    nullish_b = b is None or b is UNDEFINED
    if nullish_a or nullish_b:
        return nullish_a and nullish_b
    ta, tb = js_typeof(a), js_typeof(b)
    if ta == tb and ta in ("number", "string", "boolean"):
        return strict_eq(a if not isinstance(a, bool) else float(a),
                         b if not isinstance(b, bool) else float(b)) \
            if ta != "string" else a == b
    if ta in ("object", "function") and tb in ("object", "function"):
        return a is b
    # mixed primitives: compare as numbers (with object→primitive first)
    pa, pb = to_primitive(a), to_primitive(b)
    if isinstance(pa, str) and isinstance(pb, str):
        return pa == pb
    na, nb = js_num(pa), js_num(pb)
    if math.isnan(na) or math.isnan(nb):
        return False
    return na == nb


def to_int32(v: Any) -> int:
    f = js_num(v)
    if math.isnan(f) or math.isinf(f):
        return 0
    i = int(f) & 0xFFFFFFFF
    return i - 0x100000000 if i >= 0x80000000 else i


def to_uint32(v: Any) -> int:
    f = js_num(v)
    if math.isnan(f) or math.isinf(f):
        return 0
    return int(f) & 0xFFFFFFFF


def to_python(v: Any) -> Any:
    """Map JS values to plain Python (UNDEFINED→None, recursively)."""
    if v is UNDEFINED:
        return None
    if isinstance(v, list):
        return [to_python(e) for e in v]
    if isinstance(v, dict):
        return {k: to_python(e) for k, e in v.items()}
    return v


def make_error(name: str, message: str) -> dict:
    return {"name": name, "message": message, "stack": f"{name}: {message}"}


def throw_type_error(message: str) -> None:
    raise JSThrow(make_error("TypeError", message))


# ---------------------------------------------------------------------------
# Environments and control flow
# ---------------------------------------------------------------------------

class Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: "Env | None" = None) -> None:
        self.vars: dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name: str) -> "Env | None":
        env: Env | None = self
        while env is not None:
            if name in env.vars:
                return env
            env = env.parent
        return None

    def get(self, name: str) -> Any:
        env = self.lookup(name)
        if env is None:
            raise JSThrow(make_error("ReferenceError", f"{name} is not defined"))
        return env.vars[name]

    def set(self, name: str, value: Any) -> None:
        env = self.lookup(name)
        if env is None:
            # sloppy-mode implicit global, as QuickJS EvalGlobal allows
            root: Env = self
            while root.parent is not None:
                root = root.parent
            root.vars[name] = value
        else:
            env.vars[name] = value

    def declare(self, name: str, value: Any) -> None:
        self.vars[name] = value


class BreakEx(Exception):
    pass


class ContinueEx(Exception):
    pass


class ReturnEx(Exception):
    def __init__(self, value: Any) -> None:
        self.value = value


# completion-value sentinel: statements that produce no value return this so
# blocks/programs keep the previous completion (QuickJS Eval semantics)
_NO_VALUE = object()


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class Interpreter:
    """Evaluate scripts with an operation budget and a recursion cap.

    The public surface mirrors what the reference uses QuickJS for
    (logics/external.go:29-101): ``set_global`` (user_id injection),
    ``register`` (the fetch host function), and ``eval`` returning the
    completion value of the last expression statement.
    """

    def __init__(self, max_ops: int = 5_000_000, max_depth: int = 200) -> None:
        self.max_ops = max_ops
        self.max_depth = max_depth
        self.global_env = Env()
        self._depth = 0
        self._ops = 0
        # each JS frame costs ~15 Python frames; keep Python's limit above
        # max_depth so our RangeError fires before Python's RecursionError
        import sys
        need = max_depth * 20 + 1000
        if sys.getrecursionlimit() < need:
            sys.setrecursionlimit(need)
        _install_builtins(self)

    # -- public API ---------------------------------------------------------
    def set_global(self, name: str, value: Any) -> None:
        self.global_env.declare(name, value)

    def register(self, name: str, fn: Callable, pass_this: bool = False) -> None:
        self.global_env.declare(name, NativeFunction(name, fn, pass_this))

    def eval(self, src: str) -> Any:
        program = Parser(src).parse_program()
        self._ops = 0
        return self.exec_program(program, self.global_env)

    # -- execution ----------------------------------------------------------
    def _tick(self) -> None:
        self._ops += 1
        if self._ops > self.max_ops:
            raise JSError(
                f"script exceeded operation budget ({self.max_ops} ops)"
            )

    def exec_program(self, stmts: list[tuple], env: Env) -> Any:
        self._hoist(stmts, env)
        completion: Any = UNDEFINED
        for s in stmts:
            v = self.exec_stmt(s, env)
            if v is not _NO_VALUE:
                completion = v
        return completion

    def _hoist(self, stmts: list[tuple], env: Env) -> None:
        for s in stmts:
            if s[0] == "fndecl":
                env.declare(s[1], self._make_function(s[2], env))

    def _make_function(self, fn_node: tuple, env: Env) -> JSFunction:
        _, name, params, rest, body, is_arrow, is_expr_body = fn_node
        return JSFunction(name, params, rest, body, env, is_arrow,
                          is_expr_body, self)

    def exec_stmt(self, node: tuple, env: Env) -> Any:
        """Execute a statement; returns its completion value (the QuickJS
        ``Eval`` result semantics) or ``_NO_VALUE`` for statements that
        produce none (declarations, empty)."""
        self._tick()
        op = node[0]
        if op == "expr":
            return self.eval_expr(node[1], env)
        if op == "var":
            for name, init in node[2]:
                val = UNDEFINED if init is None else self.eval_expr(init, env)
                env.declare(name, val)
            return _NO_VALUE
        if op == "block":
            block_env = Env(env)
            self._hoist(node[1], block_env)
            comp: Any = _NO_VALUE
            for s in node[1]:
                v = self.exec_stmt(s, block_env)
                if v is not _NO_VALUE:
                    comp = v
            return comp
        if op == "if":
            if js_truthy(self.eval_expr(node[1], env)):
                return self.exec_stmt(node[2], env)
            if node[3] is not None:
                return self.exec_stmt(node[3], env)
            return UNDEFINED
        if op == "while":
            comp = _NO_VALUE
            while js_truthy(self.eval_expr(node[1], env)):
                self._tick()
                try:
                    v = self.exec_stmt(node[2], env)
                    if v is not _NO_VALUE:
                        comp = v
                except BreakEx:
                    break
                except ContinueEx:
                    continue
            return comp
        if op == "dowhile":
            comp = _NO_VALUE
            while True:
                self._tick()
                try:
                    v = self.exec_stmt(node[1], env)
                    if v is not _NO_VALUE:
                        comp = v
                except BreakEx:
                    break
                except ContinueEx:
                    pass
                if not js_truthy(self.eval_expr(node[2], env)):
                    break
            return comp
        if op == "for":
            init, test, update, body = node[1], node[2], node[3], node[4]
            loop_env = Env(env)
            if init is not None:
                self.exec_stmt(init, loop_env)
            comp = _NO_VALUE
            while test is None or js_truthy(self.eval_expr(test, loop_env)):
                self._tick()
                try:
                    v = self.exec_stmt(body, loop_env)
                    if v is not _NO_VALUE:
                        comp = v
                except BreakEx:
                    break
                except ContinueEx:
                    pass
                if update is not None:
                    self.eval_expr(update, loop_env)
            return comp
        if op in ("forof", "forin"):
            _, kind, name, obj_expr, body = node
            obj = self.eval_expr(obj_expr, env)
            if op == "forof":
                if isinstance(obj, str):
                    seq: Any = list(obj)
                elif isinstance(obj, list):
                    seq = list(obj)
                else:
                    throw_type_error("value is not iterable")
            else:
                if isinstance(obj, dict):
                    seq = list(obj.keys())
                elif isinstance(obj, list):
                    seq = [fmt_num(float(i)) for i in range(len(obj))]
                elif isinstance(obj, str):
                    seq = [fmt_num(float(i)) for i in range(len(obj))]
                elif obj is None or obj is UNDEFINED:
                    seq = []
                else:
                    seq = []
            comp = _NO_VALUE
            for item in seq:
                self._tick()
                it_env = Env(env)
                if kind is None:
                    env.set(name, item)
                    run_env = env
                else:
                    it_env.declare(name, item)
                    run_env = it_env
                try:
                    v = self.exec_stmt(body, run_env)
                    if v is not _NO_VALUE:
                        comp = v
                except BreakEx:
                    break
                except ContinueEx:
                    continue
            return comp
        if op == "fndecl":
            if node[1] not in env.vars:
                env.declare(node[1], self._make_function(node[2], env))
            return _NO_VALUE
        if op == "return":
            value = UNDEFINED if node[1] is None else self.eval_expr(node[1], env)
            raise ReturnEx(value)
        if op == "break":
            raise BreakEx()
        if op == "continue":
            raise ContinueEx()
        if op == "throw":
            raise JSThrow(self.eval_expr(node[1], env))
        if op == "try":
            _, block, param, handler, finalizer = node
            comp = _NO_VALUE
            try:
                comp = self.exec_stmt(block, env)
            except JSThrow as exc:
                if handler is not None:
                    catch_env = Env(env)
                    if param is not None:
                        catch_env.declare(param, exc.value)
                    comp = self.exec_stmt(handler, catch_env)
                else:
                    raise
            finally:
                if finalizer is not None:
                    self.exec_stmt(finalizer, env)
            return comp
        if op == "switch":
            _, disc_expr, cases = node
            disc = self.eval_expr(disc_expr, env)
            sw_env = Env(env)
            matched = False
            comp = _NO_VALUE
            try:
                for test, body in cases:
                    if not matched and test is not None \
                            and strict_eq(disc, self.eval_expr(test, sw_env)):
                        matched = True
                    if matched:
                        for s in body:
                            v = self.exec_stmt(s, sw_env)
                            if v is not _NO_VALUE:
                                comp = v
                if not matched:
                    # default clause (and fallthrough after it)
                    take = False
                    for test, body in cases:
                        if test is None:
                            take = True
                        if take:
                            for s in body:
                                v = self.exec_stmt(s, sw_env)
                                if v is not _NO_VALUE:
                                    comp = v
            except BreakEx:
                pass
            return comp
        if op == "empty":
            return _NO_VALUE
        raise JSError(f"unknown statement {op!r}")

    # -- function calls -----------------------------------------------------
    def call_function(self, fn: Any, args: list[Any], this: Any) -> Any:
        self._tick()
        if isinstance(fn, NativeFunction):
            if fn.pass_this:
                return fn.fn(this, *args)
            return fn.fn(*args)
        if not isinstance(fn, JSFunction):
            throw_type_error(f"{js_str(fn)} is not a function")
        if self._depth >= self.max_depth:
            raise JSThrow(make_error("RangeError",
                                     "Maximum call stack size exceeded"))
        env = Env(fn.env)
        if not fn.is_arrow:
            env.declare("#this", fn.bound_this if fn.bound_this is not None else this)
            env.declare("arguments", list(args))
        for i, (pname, default) in enumerate(fn.params):
            if i < len(args) and args[i] is not UNDEFINED:
                env.declare(pname, args[i])
            elif default is not None:
                env.declare(pname, self.eval_expr(default, env))
            else:
                env.declare(pname, args[i] if i < len(args) else UNDEFINED)
        if fn.rest is not None:
            env.declare(fn.rest, list(args[len(fn.params):]))
        self._depth += 1
        try:
            if fn.is_expr_body:
                return self.eval_expr(fn.body, env)
            try:
                self.exec_stmt(fn.body, env)
            except ReturnEx as r:
                return r.value
            return UNDEFINED
        finally:
            self._depth -= 1

    # -- expressions --------------------------------------------------------
    def eval_expr(self, node: tuple, env: Env) -> Any:
        self._tick()
        op = node[0]
        if op == "lit":
            return node[1]
        if op == "name":
            return env.get(node[1])
        if op == "this":
            e = env.lookup("#this")
            return e.vars["#this"] if e is not None else UNDEFINED
        if op == "tmpl":
            return "".join(js_str(self.eval_expr(p, env)) for p in node[1])
        if op == "arr":
            out: list[Any] = []
            for e in node[1]:
                if e[0] == "spread":
                    v = self.eval_expr(e[1], env)
                    if isinstance(v, list):
                        out.extend(v)
                    elif isinstance(v, str):
                        out.extend(list(v))
                    else:
                        throw_type_error("spread target is not iterable")
                else:
                    out.append(self.eval_expr(e, env))
            return out
        if op == "obj":
            obj: dict[str, Any] = {}
            for kind, key, value in node[1]:
                if kind == "spread":
                    v = self.eval_expr(value, env)
                    if isinstance(v, dict):
                        obj.update(v)
                    elif isinstance(v, list):
                        for i, e in enumerate(v):
                            obj[fmt_num(float(i))] = e
                    continue
                if kind == "computed":
                    k = js_str(self.eval_expr(key, env))
                else:
                    k = key
                val = self.eval_expr(value, env)
                if value[0] == "fn" and isinstance(val, JSFunction) and not val.name:
                    val.name = k
                obj[k] = val
            return obj
        if op == "fn":
            return self._make_function(node, env)
        if op == "cond":
            if js_truthy(self.eval_expr(node[1], env)):
                return self.eval_expr(node[2], env)
            return self.eval_expr(node[3], env)
        if op == "logic":
            left = self.eval_expr(node[2], env)
            kind = node[1]
            if kind == "&&":
                return self.eval_expr(node[3], env) if js_truthy(left) else left
            if kind == "||":
                return left if js_truthy(left) else self.eval_expr(node[3], env)
            # ??
            if left is None or left is UNDEFINED:
                return self.eval_expr(node[3], env)
            return left
        if op == "binop":
            return self._binop(node[1], node[2], node[3], env)
        if op == "unary":
            return self._unary(node[1], node[2], env)
        if op == "update":
            _, kind, prefix, target = node
            ref = self._resolve_target(target, env)
            old = js_num(self._ref_read(ref, env))
            new = old + (1.0 if kind == "++" else -1.0)
            self._ref_write(ref, new, env)
            return new if prefix else old
        if op == "assign":
            _, aop, target, value_expr = node
            if aop == "=":
                value = self.eval_expr(value_expr, env)
                if value_expr[0] == "fn" and isinstance(value, JSFunction) \
                        and not value.name and target[0] == "name":
                    value.name = target[1]
            elif aop in ("&&=", "||=", "??="):
                ref = self._resolve_target(target, env)
                cur = self._ref_read(ref, env)
                if aop == "&&=" and not js_truthy(cur):
                    return cur
                if aop == "||=" and js_truthy(cur):
                    return cur
                if aop == "??=" and not (cur is None or cur is UNDEFINED):
                    return cur
                value = self.eval_expr(value_expr, env)
                self._ref_write(ref, value, env)
                return value
            else:
                ref = self._resolve_target(target, env)
                cur = self._ref_read(ref, env)
                rhs = self.eval_expr(value_expr, env)
                value = self._apply_binary(aop[:-1], cur, rhs)
                self._ref_write(ref, value, env)
                return value
            self._write_target(target, value, env)
            return value
        if op == "comma":
            result: Any = UNDEFINED
            for e in node[1]:
                result = self.eval_expr(e, env)
            return result
        if op in ("member", "optmember"):
            obj = self.eval_expr(node[1], env)
            if op == "optmember" and (obj is None or obj is UNDEFINED):
                return UNDEFINED
            return self.js_get(obj, node[2])
        if op == "index":
            obj = self.eval_expr(node[1], env)
            key = self.eval_expr(node[2], env)
            return self.js_get(obj, key)
        if op in ("call", "optcall"):
            return self._eval_call(node, env)
        if op == "new":
            return self._eval_new(node, env)
        if op == "spread":
            raise JSSyntaxError("SyntaxError: unexpected spread")
        raise JSError(f"unknown expression {op!r}")

    def _eval_args(self, arg_nodes: list[tuple], env: Env) -> list[Any]:
        args: list[Any] = []
        for a in arg_nodes:
            if a[0] == "spread":
                v = self.eval_expr(a[1], env)
                if isinstance(v, list):
                    args.extend(v)
                elif isinstance(v, str):
                    args.extend(list(v))
                else:
                    throw_type_error("spread target is not iterable")
            else:
                args.append(self.eval_expr(a, env))
        return args

    def _eval_call(self, node: tuple, env: Env) -> Any:
        callee = node[1]
        if callee[0] in ("member", "index", "optmember"):
            obj = self.eval_expr(callee[1], env)
            if callee[0] == "optmember" and (obj is None or obj is UNDEFINED):
                return UNDEFINED
            if callee[0] == "index":
                prop = js_str(self.eval_expr(callee[2], env))
            else:
                prop = callee[2]
            fn = self.js_get(obj, prop)
            if node[0] == "optcall" and (fn is None or fn is UNDEFINED):
                return UNDEFINED  # a.b?.() with no such method (ES2020)
            if not is_callable(fn):
                throw_type_error(
                    f"{js_str(obj)[:40]}.{prop} is not a function"
                )
            args = self._eval_args(node[2], env)
            return self.call_function(fn, args, obj)
        fn = self.eval_expr(callee, env)
        if node[0] == "optcall" and (fn is None or fn is UNDEFINED):
            return UNDEFINED
        args = self._eval_args(node[2], env)
        return self.call_function(fn, args, UNDEFINED)

    def _eval_new(self, node: tuple, env: Env) -> Any:
        fn = self.eval_expr(node[1], env)
        args = self._eval_args(node[2], env)
        if isinstance(fn, NativeFunction):
            return self.call_function(fn, args, UNDEFINED)
        if not isinstance(fn, JSFunction):
            throw_type_error("constructor is not a function")
        obj: dict[str, Any] = {}
        result = self.call_function(fn, args, obj)
        return result if isinstance(result, (dict, list)) else obj

    # -- assignment targets -------------------------------------------------
    def _resolve_target(self, target: tuple, env: Env):
        """Evaluate a member/index target's base (and computed key) ONCE,
        returning a reference for read-then-write ops — compound assignment
        and ++/-- must not re-run side effects in the base expression
        (``f().total++`` must call f once)."""
        if target[0] == "name":
            return ("name", target[1])
        obj = self.eval_expr(target[1], env)
        if target[0] == "member":
            return ("prop", obj, target[2])
        return ("prop", obj, self.eval_expr(target[2], env))

    def _ref_read(self, ref, env: Env) -> Any:
        if ref[0] == "name":
            e = env.lookup(ref[1])
            return e.vars[ref[1]] if e is not None else UNDEFINED
        return self.js_get(ref[1], ref[2])

    def _ref_write(self, ref, value: Any, env: Env) -> None:
        if ref[0] == "name":
            env.set(ref[1], value)
        else:
            self.js_set(ref[1], ref[2], value)

    def _read_target(self, target: tuple, env: Env) -> Any:
        if target[0] == "name":
            e = env.lookup(target[1])
            return e.vars[target[1]] if e is not None else UNDEFINED
        if target[0] == "member":
            return self.js_get(self.eval_expr(target[1], env), target[2])
        obj = self.eval_expr(target[1], env)
        key = self.eval_expr(target[2], env)
        return self.js_get(obj, key)

    def _write_target(self, target: tuple, value: Any, env: Env) -> None:
        if target[0] == "name":
            env.set(target[1], value)
            return
        obj = self.eval_expr(target[1], env)
        if target[0] == "member":
            key: Any = target[2]
        else:
            key = self.eval_expr(target[2], env)
        self.js_set(obj, key, value)

    # -- operators ----------------------------------------------------------
    def _unary(self, kind: str, expr: tuple, env: Env) -> Any:
        if kind == "typeof":
            if expr[0] == "name" and env.lookup(expr[1]) is None:
                return "undefined"
            return js_typeof(self.eval_expr(expr, env))
        if kind == "delete":
            if expr[0] in ("member", "index"):
                obj = self.eval_expr(expr[1], env)
                key = expr[2] if expr[0] == "member" \
                    else js_str(self.eval_expr(expr[2], env))
                if isinstance(obj, dict):
                    obj.pop(key, None)
                    return True
                if isinstance(obj, list):
                    try:
                        idx = int(js_num(key))
                        if 0 <= idx < len(obj):
                            obj[idx] = UNDEFINED
                    except (ValueError, OverflowError):
                        pass
                    return True
            return True
        v = self.eval_expr(expr, env)
        if kind == "!":
            return not js_truthy(v)
        if kind == "-":
            return -js_num(v)
        if kind == "+":
            return js_num(v)
        if kind == "~":
            return float(~to_int32(v))
        if kind == "void":
            return UNDEFINED
        raise JSError(f"unknown unary {kind!r}")

    def _binop(self, kind: str, lexpr: tuple, rexpr: tuple, env: Env) -> Any:
        left = self.eval_expr(lexpr, env)
        right = self.eval_expr(rexpr, env)
        return self._apply_binary(kind, left, right)

    def _apply_binary(self, kind: str, left: Any, right: Any) -> Any:
        if kind == "+":
            pl, pr = to_primitive(left), to_primitive(right)
            if isinstance(pl, str) or isinstance(pr, str):
                return js_str(pl) + js_str(pr)
            return js_num(pl) + js_num(pr)
        if kind == "-":
            return js_num(left) - js_num(right)
        if kind == "*":
            return js_num(left) * js_num(right)
        if kind == "/":
            d = js_num(right)
            n = js_num(left)
            if d == 0:
                if n == 0 or math.isnan(n):
                    return math.nan
                return math.inf if (n > 0) == (not _neg_zero(d)) else -math.inf
            return n / d
        if kind == "%":
            n, d = js_num(left), js_num(right)
            if d == 0 or math.isnan(n) or math.isnan(d) or math.isinf(n):
                return math.nan
            if math.isinf(d):
                return n
            return math.fmod(n, d)
        if kind == "**":
            try:
                r = js_num(left) ** js_num(right)
                return float(r.real) if isinstance(r, complex) else float(r)
            except (OverflowError, ZeroDivisionError):
                return math.inf
        if kind in ("==", "!="):
            eq = loose_eq(left, right)
            return eq if kind == "==" else not eq
        if kind in ("===", "!=="):
            eq = strict_eq(left, right)
            return eq if kind == "===" else not eq
        if kind in ("<", ">", "<=", ">="):
            pl, pr = to_primitive(left), to_primitive(right)
            if isinstance(pl, str) and isinstance(pr, str):
                a_cmp: Any
                b_cmp: Any
                a_cmp, b_cmp = pl, pr
            else:
                a_cmp, b_cmp = js_num(pl), js_num(pr)
                if math.isnan(a_cmp) or math.isnan(b_cmp):
                    return False
            if kind == "<":
                return a_cmp < b_cmp
            if kind == ">":
                return a_cmp > b_cmp
            if kind == "<=":
                return a_cmp <= b_cmp
            return a_cmp >= b_cmp
        if kind == "&":
            return float(to_int32(left) & to_int32(right))
        if kind == "|":
            return float(to_int32(left) | to_int32(right))
        if kind == "^":
            return float(to_int32(left) ^ to_int32(right))
        if kind == "<<":
            return float(to_int32(to_int32(left) << (to_uint32(right) & 31)))
        if kind == ">>":
            return float(to_int32(left) >> (to_uint32(right) & 31))
        if kind == ">>>":
            return float(to_uint32(left) >> (to_uint32(right) & 31))
        if kind == "instanceof":
            return self._instanceof(left, right)
        if kind == "in":
            key = js_str(left)
            if isinstance(right, dict):
                return key in right
            if isinstance(right, list):
                try:
                    idx = int(float(key))
                except ValueError:
                    return False
                return 0 <= idx < len(right)
            throw_type_error("'in' on non-object")
        raise JSError(f"unknown operator {kind!r}")

    def _instanceof(self, left: Any, right: Any) -> bool:
        if isinstance(right, dict):
            name = right.get("name")
        else:
            name = getattr(right, "name", None)
        if name == "Array":
            return isinstance(left, list)
        if name == "Object":
            return isinstance(left, (dict, list)) or is_callable(left)
        if name == "Function":
            return is_callable(left)
        if isinstance(name, str) and name.endswith("Error"):
            return isinstance(left, dict) and "message" in left \
                and str(left.get("name", "")).endswith("Error")
        if isinstance(right, JSFunction):
            return isinstance(left, dict) and left.get("#ctor") is right
        throw_type_error("right-hand side of instanceof is not callable")
        return False  # unreachable


def _neg_zero(x: float) -> bool:
    return x == 0 and math.copysign(1.0, x) < 0


# ---------------------------------------------------------------------------
# Property access — defined as free functions and attached to Interpreter
# ---------------------------------------------------------------------------

def _norm_index(obj_len: int, i: float) -> int:
    """JS relative index (negative counts from the end), clamped."""
    idx = int(i) if not math.isnan(i) else 0
    if idx < 0:
        idx += obj_len
    return max(0, min(idx, obj_len))


def _slice(seq, start: Any, end: Any):
    n = len(seq)
    s = _norm_index(n, js_num(start)) if start is not UNDEFINED else 0
    e = _norm_index(n, js_num(end)) if end is not UNDEFINED else n
    return seq[s:e]


def _cmp_default(a: Any, b: Any) -> int:
    if a is UNDEFINED:
        return 0 if b is UNDEFINED else 1
    if b is UNDEFINED:
        return -1
    sa, sb = js_str(a), js_str(b)
    return -1 if sa < sb else (1 if sa > sb else 0)


def _string_method(interp: "Interpreter", s: str, name: str):
    def nf(fn):
        return NativeFunction(name, fn)

    if name == "charAt":
        return nf(lambda i=0.0: s[int(js_num(i))]
                  if 0 <= int(js_num(i)) < len(s) else "")
    if name == "charCodeAt":
        return nf(lambda i=0.0: float(ord(s[int(js_num(i))]))
                  if 0 <= int(js_num(i)) < len(s) else math.nan)
    if name == "codePointAt":
        return nf(lambda i=0.0: float(ord(s[int(js_num(i))]))
                  if 0 <= int(js_num(i)) < len(s) else UNDEFINED)
    if name == "at":
        def _at(i=0.0):
            idx = int(js_num(i))
            if idx < 0:
                idx += len(s)
            return s[idx] if 0 <= idx < len(s) else UNDEFINED
        return nf(_at)
    if name == "concat":
        return nf(lambda *args: s + "".join(js_str(a) for a in args))
    if name == "endsWith":
        return nf(lambda sub="", end=UNDEFINED: s[:len(s) if end is UNDEFINED
                  else int(js_num(end))].endswith(js_str(sub)))
    if name == "startsWith":
        return nf(lambda sub="", start=0.0:
                  s.startswith(js_str(sub), int(js_num(start))))
    if name == "includes":
        return nf(lambda sub="", start=0.0: js_str(sub) in s[int(js_num(start)):])
    if name == "indexOf":
        return nf(lambda sub="", start=0.0:
                  float(s.find(js_str(sub), int(js_num(start)))))
    if name == "lastIndexOf":
        return nf(lambda sub="": float(s.rfind(js_str(sub))))
    if name == "padStart":
        return nf(lambda n=0.0, pad=" ": _pad(s, int(js_num(n)), js_str(pad), True))
    if name == "padEnd":
        return nf(lambda n=0.0, pad=" ": _pad(s, int(js_num(n)), js_str(pad), False))
    if name == "repeat":
        def _repeat(n=0.0):
            cnt = int(js_num(n))
            if cnt < 0:
                raise JSThrow(make_error("RangeError", "Invalid count value"))
            if cnt * len(s) > 1_000_000:
                raise JSError("repeat result too large")
            return s * cnt
        return nf(_repeat)
    if name == "replace":
        def _replace(pat="", rep=""):
            if is_callable(rep):
                idx = s.find(js_str(pat))
                if idx < 0:
                    return s
                rv = interp.call_function(rep, [js_str(pat), float(idx), s], UNDEFINED)
                return s[:idx] + js_str(rv) + s[idx + len(js_str(pat)):]
            return s.replace(js_str(pat), js_str(rep), 1)
        return nf(_replace)
    if name == "replaceAll":
        return nf(lambda pat="", rep="": s.replace(js_str(pat), js_str(rep)))
    if name == "slice":
        return nf(lambda a=UNDEFINED, b=UNDEFINED: _slice(s, a, b))
    if name == "substring":
        def _substring(a=UNDEFINED, b=UNDEFINED):
            n = len(s)
            sa = 0 if a is UNDEFINED else max(0, min(n, int(js_num(a) if not math.isnan(js_num(a)) else 0)))
            sb = n if b is UNDEFINED else max(0, min(n, int(js_num(b) if not math.isnan(js_num(b)) else 0)))
            if sa > sb:
                sa, sb = sb, sa
            return s[sa:sb]
        return nf(_substring)
    if name == "substr":
        def _substr(a=0.0, ln=UNDEFINED):
            start = int(js_num(a))
            if start < 0:
                start = max(0, len(s) + start)
            n = len(s) - start if ln is UNDEFINED else int(js_num(ln))
            return s[start:start + max(0, n)]
        return nf(_substr)
    if name == "split":
        def _split(sep=UNDEFINED, limit=UNDEFINED):
            if sep is UNDEFINED:
                out = [s]
            elif js_str(sep) == "":
                out = list(s)
            else:
                out = s.split(js_str(sep))
            if limit is not UNDEFINED:
                out = out[: int(js_num(limit))]
            return out
        return nf(_split)
    if name == "toLowerCase" or name == "toLocaleLowerCase":
        return nf(lambda: s.lower())
    if name == "toUpperCase" or name == "toLocaleUpperCase":
        return nf(lambda: s.upper())
    if name == "trim":
        return nf(lambda: s.strip())
    if name == "trimStart":
        return nf(lambda: s.lstrip())
    if name == "trimEnd":
        return nf(lambda: s.rstrip())
    if name == "toString" or name == "valueOf":
        return nf(lambda: s)
    if name == "localeCompare":
        return nf(lambda other="": float((s > js_str(other)) - (s < js_str(other))))
    return UNDEFINED


def _pad(s: str, n: int, pad: str, start: bool) -> str:
    if len(s) >= n or not pad:
        return s
    fill = (pad * ((n - len(s)) // len(pad) + 1))[: n - len(s)]
    return fill + s if start else s + fill


def _array_method(interp: "Interpreter", arr: list, name: str):
    def nf(fn):
        return NativeFunction(name, fn)

    def call1(fn, item, i):
        return interp.call_function(fn, [item, float(i), arr], UNDEFINED)

    if name == "push":
        def _push(*args):
            arr.extend(args)
            return float(len(arr))
        return nf(_push)
    if name == "pop":
        return nf(lambda: arr.pop() if arr else UNDEFINED)
    if name == "shift":
        return nf(lambda: arr.pop(0) if arr else UNDEFINED)
    if name == "unshift":
        def _unshift(*args):
            arr[:0] = list(args)
            return float(len(arr))
        return nf(_unshift)
    if name == "slice":
        return nf(lambda a=UNDEFINED, b=UNDEFINED: _slice(arr, a, b))
    if name == "splice":
        def _splice(start=0.0, count=UNDEFINED, *items):
            n = len(arr)
            st = _norm_index(n, js_num(start))
            cnt = n - st if count is UNDEFINED else max(0, int(js_num(count)))
            removed = arr[st:st + cnt]
            arr[st:st + cnt] = list(items)
            return removed
        return nf(_splice)
    if name == "concat":
        def _concat(*args):
            out = list(arr)
            for a in args:
                if isinstance(a, list):
                    out.extend(a)
                else:
                    out.append(a)
            return out
        return nf(_concat)
    if name == "join":
        return nf(lambda sep=",": js_str(sep if sep is not UNDEFINED else ",").join(
            "" if e is None or e is UNDEFINED else js_str(e) for e in arr))
    if name == "reverse":
        def _reverse():
            arr.reverse()
            return arr
        return nf(_reverse)
    if name == "indexOf":
        def _index_of(x=UNDEFINED, start=0.0):
            for i in range(max(0, int(js_num(start))), len(arr)):
                if strict_eq(arr[i], x):
                    return float(i)
            return -1.0
        return nf(_index_of)
    if name == "lastIndexOf":
        def _last_index_of(x=UNDEFINED):
            for i in range(len(arr) - 1, -1, -1):
                if strict_eq(arr[i], x):
                    return float(i)
            return -1.0
        return nf(_last_index_of)
    if name == "includes":
        def _includes(x=UNDEFINED, start=0.0):
            for i in range(max(0, int(js_num(start))), len(arr)):
                e = arr[i]
                if strict_eq(e, x) or (isinstance(e, float) and isinstance(x, float)
                                       and math.isnan(e) and math.isnan(x)):
                    return True
            return False
        return nf(_includes)
    if name == "map":
        return nf(lambda fn: [call1(fn, e, i) for i, e in enumerate(arr)])
    if name == "filter":
        return nf(lambda fn: [e for i, e in enumerate(arr)
                              if js_truthy(call1(fn, e, i))])
    if name == "forEach":
        def _for_each(fn):
            for i, e in enumerate(arr):
                call1(fn, e, i)
            return UNDEFINED
        return nf(_for_each)
    if name == "find":
        def _find(fn):
            for i, e in enumerate(arr):
                if js_truthy(call1(fn, e, i)):
                    return e
            return UNDEFINED
        return nf(_find)
    if name == "findIndex":
        def _find_index(fn):
            for i, e in enumerate(arr):
                if js_truthy(call1(fn, e, i)):
                    return float(i)
            return -1.0
        return nf(_find_index)
    if name == "some":
        return nf(lambda fn: any(js_truthy(call1(fn, e, i))
                                 for i, e in enumerate(arr)))
    if name == "every":
        return nf(lambda fn: all(js_truthy(call1(fn, e, i))
                                 for i, e in enumerate(arr)))
    if name == "reduce":
        def _reduce(fn, init=UNDEFINED):
            it = iter(enumerate(arr))
            if init is UNDEFINED:
                try:
                    _, acc = next(it)
                except StopIteration:
                    throw_type_error("Reduce of empty array with no initial value")
            else:
                acc = init
            for i, e in it:
                acc = interp.call_function(fn, [acc, e, float(i), arr], UNDEFINED)
            return acc
        return nf(_reduce)
    if name == "reduceRight":
        def _reduce_right(fn, init=UNDEFINED):
            items = list(enumerate(arr))[::-1]
            it = iter(items)
            if init is UNDEFINED:
                try:
                    _, acc = next(it)
                except StopIteration:
                    throw_type_error("Reduce of empty array with no initial value")
            else:
                acc = init
            for i, e in it:
                acc = interp.call_function(fn, [acc, e, float(i), arr], UNDEFINED)
            return acc
        return nf(_reduce_right)
    if name == "sort":
        def _sort(cmp=UNDEFINED):
            import functools
            if cmp is UNDEFINED:
                arr.sort(key=functools.cmp_to_key(_cmp_default))
            else:
                def comparator(a, b):
                    r = js_num(interp.call_function(cmp, [a, b], UNDEFINED))
                    return -1 if r < 0 else (1 if r > 0 else 0)
                arr.sort(key=functools.cmp_to_key(comparator))
            return arr
        return nf(_sort)
    if name == "flat":
        def _flat(depth=1.0):
            d = int(js_num(depth))

            def go(a, d):
                out = []
                for e in a:
                    if isinstance(e, list) and d > 0:
                        out.extend(go(e, d - 1))
                    else:
                        out.append(e)
                return out
            return go(arr, d)
        return nf(_flat)
    if name == "flatMap":
        def _flat_map(fn):
            out = []
            for i, e in enumerate(arr):
                r = call1(fn, e, i)
                if isinstance(r, list):
                    out.extend(r)
                else:
                    out.append(r)
            return out
        return nf(_flat_map)
    if name == "fill":
        def _fill(value=UNDEFINED, start=UNDEFINED, end=UNDEFINED):
            n = len(arr)
            st = _norm_index(n, js_num(start)) if start is not UNDEFINED else 0
            en = _norm_index(n, js_num(end)) if end is not UNDEFINED else n
            for i in range(st, en):
                arr[i] = value
            return arr
        return nf(_fill)
    if name == "at":
        def _at(i=0.0):
            idx = int(js_num(i))
            if idx < 0:
                idx += len(arr)
            return arr[idx] if 0 <= idx < len(arr) else UNDEFINED
        return nf(_at)
    if name == "keys":
        return nf(lambda: [float(i) for i in range(len(arr))])
    if name == "entries":
        return nf(lambda: [[float(i), e] for i, e in enumerate(arr)])
    if name == "values":
        return nf(lambda: list(arr))
    if name == "toString":
        return nf(lambda: js_str(arr))
    return UNDEFINED


def _function_method(interp: "Interpreter", fn, name: str):
    if name == "call":
        return NativeFunction("call", lambda this=UNDEFINED, *args:
                              interp.call_function(fn, list(args), this))
    if name == "apply":
        return NativeFunction("apply", lambda this=UNDEFINED, args=UNDEFINED:
                              interp.call_function(
                                  fn, list(args) if isinstance(args, list) else [],
                                  this))
    if name == "bind":
        def _bind(this=UNDEFINED, *pre):
            return NativeFunction(
                getattr(fn, "name", "bound"),
                lambda *args: interp.call_function(fn, list(pre) + list(args), this))
        return NativeFunction("bind", _bind)
    if name == "name":
        return getattr(fn, "name", "")
    if name == "length":
        if isinstance(fn, JSFunction):
            return float(len(fn.params))
        return 0.0
    if name == "toString":
        return NativeFunction("toString", lambda: repr(fn))
    return UNDEFINED


def _interp_js_get(self: "Interpreter", obj: Any, key: Any) -> Any:
    self._tick()
    if obj is None or obj is UNDEFINED:
        throw_type_error(
            f"Cannot read properties of {js_str(obj)} (reading '{js_str(key)}')"
        )
    # numeric indexing for arrays/strings
    if isinstance(key, (int, float)) and not isinstance(key, bool):
        if isinstance(obj, (list, str)):
            idx = int(key)
            if idx == key and 0 <= idx < len(obj):
                return obj[idx]
            return UNDEFINED
        key = fmt_num(float(key))
    name = js_str(key)
    if isinstance(obj, dict):
        if name in obj:
            return obj[name]
        if name == "hasOwnProperty":
            return NativeFunction("hasOwnProperty", lambda k="": js_str(k) in obj)
        if name == "toString":
            return NativeFunction("toString", lambda: js_str(obj))
        return UNDEFINED
    if isinstance(obj, list):
        if name == "length":
            return float(len(obj))
        if name.lstrip("-").isdigit():
            idx = int(name)
            return obj[idx] if 0 <= idx < len(obj) else UNDEFINED
        return _array_method(self, obj, name)
    if isinstance(obj, str):
        if name == "length":
            return float(len(obj))
        if name.lstrip("-").isdigit():
            idx = int(name)
            return obj[idx] if 0 <= idx < len(obj) else UNDEFINED
        return _string_method(self, obj, name)
    if isinstance(obj, bool):
        if name == "toString":
            return NativeFunction("toString", lambda: js_str(obj))
        return UNDEFINED
    if isinstance(obj, (int, float)):
        x = float(obj)
        if name == "toFixed":
            def _to_fixed(digits=0.0):
                d = int(js_num(digits))
                return f"{x:.{d}f}"
            return NativeFunction("toFixed", _to_fixed)
        if name == "toString":
            def _num_to_string(radix=UNDEFINED):
                if radix is UNDEFINED or int(js_num(radix)) == 10:
                    return fmt_num(x)
                base = int(js_num(radix))
                i = int(x)
                if i == 0:
                    return "0"
                digits = "0123456789abcdefghijklmnopqrstuvwxyz"
                neg, i = i < 0, abs(i)
                out = ""
                while i:
                    out = digits[i % base] + out
                    i //= base
                return ("-" if neg else "") + out
            return NativeFunction("toString", _num_to_string)
        if name == "toPrecision":
            return NativeFunction(
                "toPrecision",
                lambda p=UNDEFINED: fmt_num(x) if p is UNDEFINED
                else f"{x:.{int(js_num(p))}g}")
        if name == "valueOf":
            return NativeFunction("valueOf", lambda: x)
        return UNDEFINED
    if is_callable(obj):
        return _function_method(self, obj, name)
    return UNDEFINED


def _interp_js_set(self: "Interpreter", obj: Any, key: Any, value: Any) -> None:
    self._tick()
    if obj is None or obj is UNDEFINED:
        throw_type_error(
            f"Cannot set properties of {js_str(obj)} (setting '{js_str(key)}')"
        )
    if isinstance(obj, dict):
        obj[js_str(key)] = value
        return
    if isinstance(obj, list):
        name = js_str(key)
        if name == "length":
            n = int(js_num(value))
            if n < len(obj):
                del obj[n:]
            else:
                obj.extend([UNDEFINED] * (n - len(obj)))
            return
        try:
            idx = int(float(name))
        except ValueError:
            return  # named props on arrays are dropped
        if idx < 0:
            return
        if idx >= len(obj):
            obj.extend([UNDEFINED] * (idx + 1 - len(obj)))
        obj[idx] = value
        return
    # primitives silently ignore writes (sloppy mode)


Interpreter.js_get = _interp_js_get  # type: ignore[attr-defined]
Interpreter.js_set = _interp_js_set  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Builtin globals
# ---------------------------------------------------------------------------

def _json_stringify(interp: "Interpreter", value: Any, replacer: Any = UNDEFINED,
                    space: Any = UNDEFINED) -> Any:
    if space is UNDEFINED or space is None:
        indent = ""
    elif isinstance(space, str):
        indent = space[:10]
    else:
        indent = " " * min(10, max(0, int(js_num(space))))
    seen: set[int] = set()

    def ser(v: Any, depth: int) -> str | None:
        if is_callable(replacer):
            pass  # replacer functions applied by caller below
        if isinstance(v, dict) and "toJSON" in v and is_callable(v["toJSON"]):
            v = interp.call_function(v["toJSON"], [], v)
        if v is True:
            return "true"
        if v is False:
            return "false"
        if v is None:
            return "null"
        if v is UNDEFINED or is_callable(v):
            return None
        if isinstance(v, (int, float)):
            f = float(v)
            if math.isnan(f) or math.isinf(f):
                return "null"
            return fmt_num(f)
        if isinstance(v, str):
            return _json.dumps(v, ensure_ascii=False)
        if id(v) in seen:
            throw_type_error("Converting circular structure to JSON")
        seen.add(id(v))
        try:
            nl = "\n" + indent * (depth + 1) if indent else ""
            endnl = "\n" + indent * depth if indent else ""
            colon = ": " if indent else ":"
            if isinstance(v, list):
                if not v:
                    return "[]"
                parts = [ser(e, depth + 1) or "null" for e in v]
                return "[" + nl + ("," + nl).join(parts) + endnl + "]"
            if isinstance(v, dict):
                items = []
                for k, e in v.items():
                    se = ser(e, depth + 1)
                    if se is None:
                        continue
                    items.append(_json.dumps(str(k), ensure_ascii=False) + colon + se)
                if not items:
                    return "{}"
                return "{" + nl + ("," + nl).join(items) + endnl + "}"
        finally:
            seen.discard(id(v))
        return None

    out = ser(value, 0)
    return out if out is not None else UNDEFINED


def _json_parse(text: Any) -> Any:
    try:
        return _json.loads(js_str(text), parse_int=float, parse_float=float,
                           parse_constant=float)
    except Exception as exc:  # noqa: BLE001
        raise JSThrow(make_error("SyntaxError", f"JSON.parse: {exc}")) from None


def _parse_int(s: Any = UNDEFINED, radix: Any = UNDEFINED) -> float:
    text = js_str(s).strip()
    base = int(js_num(radix)) if radix is not UNDEFINED and js_num(radix) else 10
    sign = 1
    if text[:1] in "+-":
        if text[0] == "-":
            sign = -1
        text = text[1:]
    if base == 16 and text[:2].lower() == "0x":
        text = text[2:]
    elif base == 10 and text[:2].lower() == "0x":
        base, text = 16, text[2:]
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:base]
    i = 0
    while i < len(text) and text[i].lower() in digits:
        i += 1
    if i == 0:
        return math.nan
    return float(sign * int(text[:i], base))


def _parse_float(s: Any = UNDEFINED) -> float:
    text = js_str(s).strip()
    i, n = 0, len(text)
    if i < n and text[i] in "+-":
        i += 1
    start_digits = i
    while i < n and text[i].isdigit():
        i += 1
    if i < n and text[i] == ".":
        i += 1
        while i < n and text[i].isdigit():
            i += 1
    if i > start_digits and i < n and text[i] in "eE":
        j = i + 1
        if j < n and text[j] in "+-":
            j += 1
        if j < n and text[j].isdigit():
            i = j
            while i < n and text[i].isdigit():
                i += 1
    if text.startswith(("Infinity", "+Infinity")):
        return math.inf
    if text.startswith("-Infinity"):
        return -math.inf
    try:
        return float(text[:i])
    except ValueError:
        return math.nan


def _install_builtins(interp: "Interpreter") -> None:
    g = interp.global_env

    def nf(name, fn, pass_this=False):
        return NativeFunction(name, fn, pass_this)

    g.declare("undefined", UNDEFINED)
    g.declare("NaN", math.nan)
    g.declare("Infinity", math.inf)

    # JSON
    g.declare("JSON", {
        "parse": nf("parse", lambda text=UNDEFINED, reviver=UNDEFINED:
                    _json_parse(text)),
        "stringify": nf("stringify",
                        lambda v=UNDEFINED, replacer=UNDEFINED, space=UNDEFINED:
                        _json_stringify(interp, v, replacer, space)),
    })

    # Math
    import random as _random

    def _js_round(x=UNDEFINED):
        f = js_num(x)
        if math.isnan(f) or math.isinf(f):
            return f
        return float(math.floor(f + 0.5))

    def _minmax(fn, default):
        def go(*args):
            if not args:
                return default
            vals = [js_num(a) for a in args]
            if any(math.isnan(v) for v in vals):
                return math.nan
            return fn(vals)
        return go

    g.declare("Math", {
        "PI": math.pi, "E": math.e, "LN2": math.log(2), "LN10": math.log(10),
        "SQRT2": math.sqrt(2),
        "abs": nf("abs", lambda x=UNDEFINED: abs(js_num(x))),
        "floor": nf("floor", lambda x=UNDEFINED: float(math.floor(js_num(x)))
                    if math.isfinite(js_num(x)) else js_num(x)),
        "ceil": nf("ceil", lambda x=UNDEFINED: float(math.ceil(js_num(x)))
                   if math.isfinite(js_num(x)) else js_num(x)),
        "round": nf("round", _js_round),
        "trunc": nf("trunc", lambda x=UNDEFINED: float(math.trunc(js_num(x)))
                    if math.isfinite(js_num(x)) else js_num(x)),
        "sign": nf("sign", lambda x=UNDEFINED: math.nan if math.isnan(js_num(x))
                   else float((js_num(x) > 0) - (js_num(x) < 0))),
        "min": nf("min", _minmax(min, math.inf)),
        "max": nf("max", _minmax(max, -math.inf)),
        "pow": nf("pow", lambda a=UNDEFINED, b=UNDEFINED:
                  interp._apply_binary("**", a, b)),
        "sqrt": nf("sqrt", lambda x=UNDEFINED: math.sqrt(js_num(x))
                   if js_num(x) >= 0 else math.nan),
        "cbrt": nf("cbrt", lambda x=UNDEFINED: math.copysign(
            abs(js_num(x)) ** (1 / 3), js_num(x))),
        "exp": nf("exp", lambda x=UNDEFINED: math.exp(js_num(x))
                  if js_num(x) < 700 else math.inf),
        "log": nf("log", lambda x=UNDEFINED: math.log(js_num(x))
                  if js_num(x) > 0 else (-math.inf if js_num(x) == 0 else math.nan)),
        "log2": nf("log2", lambda x=UNDEFINED: math.log2(js_num(x))
                   if js_num(x) > 0 else (-math.inf if js_num(x) == 0 else math.nan)),
        "log10": nf("log10", lambda x=UNDEFINED: math.log10(js_num(x))
                    if js_num(x) > 0 else (-math.inf if js_num(x) == 0 else math.nan)),
        "hypot": nf("hypot", lambda *a: math.hypot(*[js_num(x) for x in a])),
        "random": nf("random", lambda: _random.random()),
        "sin": nf("sin", lambda x=UNDEFINED: math.sin(js_num(x))),
        "cos": nf("cos", lambda x=UNDEFINED: math.cos(js_num(x))),
        "tan": nf("tan", lambda x=UNDEFINED: math.tan(js_num(x))),
        "atan2": nf("atan2", lambda y=UNDEFINED, x=UNDEFINED:
                    math.atan2(js_num(y), js_num(x))),
    })

    # Object
    def _assign(target=UNDEFINED, *sources):
        if not isinstance(target, dict):
            throw_type_error("Object.assign target must be an object")
        for s in sources:
            if isinstance(s, dict):
                target.update(s)
        return target

    g.declare("Object", {
        "keys": nf("keys", lambda o=UNDEFINED: list(o.keys())
                   if isinstance(o, dict)
                   else [fmt_num(float(i)) for i in range(len(o))]
                   if isinstance(o, (list, str)) else []),
        "values": nf("values", lambda o=UNDEFINED: list(o.values())
                     if isinstance(o, dict) else list(o)
                     if isinstance(o, list) else []),
        "entries": nf("entries", lambda o=UNDEFINED:
                      [[k, v] for k, v in o.items()] if isinstance(o, dict)
                      else [[fmt_num(float(i)), v] for i, v in enumerate(o)]
                      if isinstance(o, list) else []),
        "assign": nf("assign", _assign),
        "freeze": nf("freeze", lambda o=UNDEFINED: o),
        "fromEntries": nf("fromEntries", lambda pairs=UNDEFINED:
                          {js_str(p[0]): (p[1] if len(p) > 1 else UNDEFINED)
                           for p in pairs} if isinstance(pairs, list) else {}),
        "name": "Object",
    })

    # Array
    def _array_from(src=UNDEFINED, fn=UNDEFINED):
        if isinstance(src, list):
            out = list(src)
        elif isinstance(src, str):
            out = list(src)
        elif isinstance(src, dict) and "length" in src:
            n = int(js_num(src["length"]))
            out = [src.get(fmt_num(float(i)), UNDEFINED) for i in range(n)]
        else:
            out = []
        if is_callable(fn):
            out = [interp.call_function(fn, [e, float(i)], UNDEFINED)
                   for i, e in enumerate(out)]
        return out

    g.declare("Array", {
        "isArray": nf("isArray", lambda v=UNDEFINED: isinstance(v, list)),
        "from": nf("from", _array_from),
        "of": nf("of", lambda *args: list(args)),
        "name": "Array",
    })

    # conversion constructors
    g.declare("String", nf("String", lambda v="": js_str(v)))
    g.declare("Boolean", nf("Boolean", lambda v=UNDEFINED: js_truthy(v)))

    number_ctor = nf("Number", lambda v=UNDEFINED: js_num(v) if v is not UNDEFINED else 0.0)
    g.declare("Number", number_ctor)
    # Number statics live on a dict the member-access layer can't reach via a
    # NativeFunction, so expose them as globals too and as a Number namespace
    g.declare("NumberStatics", UNDEFINED)
    num_ns = {
        "isInteger": nf("isInteger", lambda v=UNDEFINED:
                        isinstance(v, (int, float)) and not isinstance(v, bool)
                        and math.isfinite(float(v)) and float(v) == int(v)),
        "isFinite": nf("isFinite", lambda v=UNDEFINED:
                       isinstance(v, (int, float)) and not isinstance(v, bool)
                       and math.isfinite(float(v))),
        "isNaN": nf("isNaN", lambda v=UNDEFINED:
                    isinstance(v, float) and math.isnan(v)),
        "parseFloat": nf("parseFloat", _parse_float),
        "parseInt": nf("parseInt", _parse_int),
        "MAX_SAFE_INTEGER": float(2**53 - 1),
        "MIN_SAFE_INTEGER": -float(2**53 - 1),
        "EPSILON": 2.0**-52,
        "POSITIVE_INFINITY": math.inf,
        "NEGATIVE_INFINITY": -math.inf,
        "NaN": math.nan,
    }
    # route property access on the Number constructor through the namespace
    interp._number_statics = num_ns  # type: ignore[attr-defined]

    g.declare("parseInt", nf("parseInt", _parse_int))
    g.declare("parseFloat", nf("parseFloat", _parse_float))
    g.declare("isNaN", nf("isNaN", lambda v=UNDEFINED: math.isnan(js_num(v))))
    g.declare("isFinite", nf("isFinite", lambda v=UNDEFINED: math.isfinite(js_num(v))))

    # console → utils.log
    def _console(level):
        def go(*args):
            try:
                from . import log as _log
                getattr(_log.logger(), level)(
                    "minijs console: " + " ".join(
                        _json_stringify(interp, a) if isinstance(a, (dict, list))
                        else js_str(a) for a in args))
            except Exception:  # noqa: BLE001 - logging must never break scripts
                pass
            return UNDEFINED
        return go

    g.declare("console", {
        "log": nf("log", _console("info")),
        "info": nf("info", _console("info")),
        "warn": nf("warn", _console("warning")),
        "error": nf("error", _console("error")),
        "debug": nf("debug", _console("debug")),
    })

    # Error constructors
    def _error_ctor(name):
        def go(message=UNDEFINED, *_):
            return make_error(name, "" if message is UNDEFINED else js_str(message))
        f = nf(name, go)
        return f

    for err_name in ("Error", "TypeError", "RangeError", "SyntaxError",
                     "ReferenceError", "EvalError"):
        g.declare(err_name, _error_ctor(err_name))

    g.declare("encodeURIComponent", nf(
        "encodeURIComponent",
        lambda s="": urllib.parse.quote(js_str(s), safe="-_.!~*'()")))
    g.declare("decodeURIComponent", nf(
        "decodeURIComponent", lambda s="": urllib.parse.unquote(js_str(s))))
    g.declare("encodeURI", nf(
        "encodeURI",
        lambda s="": urllib.parse.quote(js_str(s), safe="-_.!~*'();/?:@&=+$,#")))
    g.declare("decodeURI", nf(
        "decodeURI", lambda s="": urllib.parse.unquote(js_str(s))))

    g.declare("Date", {
        "now": nf("now", lambda: float(int(time.time() * 1000))),
        "name": "Date",
    })
    g.declare("globalThis", {})  # placeholder; scripts use plain globals


# Number statics (Number.isInteger etc.) are reached through function-property
# access; extend the function-method lookup for the Number constructor.
_orig_function_method = _function_method


def _function_method_with_number(interp, fn, name):  # noqa: ANN001
    statics = getattr(interp, "_number_statics", None)
    if statics is not None and isinstance(fn, NativeFunction) \
            and fn.name == "Number" and name in statics:
        return statics[name]
    return _orig_function_method(interp, fn, name)


_function_method = _function_method_with_number
