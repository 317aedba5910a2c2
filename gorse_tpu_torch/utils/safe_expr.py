"""Safe expression evaluator for config-defined score/filter functions (copy
of gorse_tpu/utils/safe_expr.py).

The reference embeds expr-lang (logics/non_personalized.go:45-84) to let
operators define non-personalized scorers in config, e.g.
``len(feedback)`` (most popular) or ``item.timestamp`` (latest). This is the
Python-dialect equivalent: a tiny AST-whitelisted evaluator — no imports, no
attribute access to dunders, only the documented variables and builtins.
"""

from __future__ import annotations

import ast
import math
import time as _time

_ALLOWED_NODES = (
    ast.Expression,
    ast.BoolOp, ast.And, ast.Or,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.UnaryOp, ast.USub, ast.UAdd, ast.Not,
    ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
    ast.Call, ast.Name, ast.Load, ast.Attribute, ast.Constant,
    ast.Subscript, ast.Index, ast.Slice, ast.List, ast.Tuple, ast.IfExp,
    ast.ListComp, ast.comprehension, ast.GeneratorExp,
)

_SAFE_FUNCS = {
    "len": len,
    "count": len,
    "sum": sum,
    "min": min,
    "max": max,
    "abs": abs,
    "round": round,
    "float": float,
    "int": int,
    "sqrt": math.sqrt,
    "log": math.log,
    "log2": math.log2,
    "log1p": math.log1p,
    "exp": math.exp,
    "now": _time.time,
}


class SafeExpression:
    """Compile once, evaluate many times against an env of variables."""

    def __init__(self, source: str) -> None:
        self.source = source
        tree = ast.parse(source, mode="eval")
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ValueError(
                    f"expression {source!r}: disallowed syntax {type(node).__name__}"
                )
            if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
                raise ValueError(f"expression {source!r}: private attribute access")
            if isinstance(node, ast.Name) and node.id.startswith("__"):
                raise ValueError(f"expression {source!r}: dunder name")
        self._code = compile(tree, "<expr>", "eval")

    def __call__(self, **env):
        scope = dict(_SAFE_FUNCS)
        scope.update(env)
        return eval(self._code, {"__builtins__": {}}, scope)
