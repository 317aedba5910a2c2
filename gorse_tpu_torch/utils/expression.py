"""Feedback-type match expressions (copy of gorse_tpu/utils/expression.py).

Selectors of the form ``type``, ``type>3``, ``type>=1.5``, ``type<0``,
``type<=2``, ``type=1`` as used in DataSource.PositiveFeedbackTypes etc. A
bare type matches any value; with a comparator, the feedback value must
satisfy it.
"""

from __future__ import annotations

import dataclasses
import functools
import re

_PATTERN = re.compile(r"^\s*([^<>=\s]+)\s*(<=|>=|<|>|=)?\s*([-+0-9.eE]+)?\s*$")


@dataclasses.dataclass(frozen=True)
class FeedbackTypeExpression:
    feedback_type: str
    op: str | None = None
    threshold: float = 0.0

    @classmethod
    def parse(cls, s: str) -> "FeedbackTypeExpression":
        m = _PATTERN.match(s)
        if not m:
            raise ValueError(f"invalid feedback type expression {s!r}")
        ftype, op, value = m.groups()
        if op is None:
            if value:
                raise ValueError(f"invalid feedback type expression {s!r}")
            return cls(ftype)
        if value is None:
            raise ValueError(f"invalid feedback type expression {s!r}")
        return cls(ftype, op, float(value))

    def match(self, feedback_type: str, value: float) -> bool:
        if feedback_type != self.feedback_type:
            return False
        if self.op is None:
            return True
        return {
            "<": value < self.threshold,
            "<=": value <= self.threshold,
            ">": value > self.threshold,
            ">=": value >= self.threshold,
            "=": value == self.threshold,
        }[self.op]

    def __str__(self) -> str:
        if self.op is None:
            return self.feedback_type
        g = ("%g" % self.threshold)
        return f"{self.feedback_type}{self.op}{g}"


def parse_expressions(specs: list[str]) -> list[FeedbackTypeExpression]:
    return [FeedbackTypeExpression.parse(s) for s in specs]


@functools.lru_cache(maxsize=1024)
def _parse_cached(s: str) -> FeedbackTypeExpression:
    return FeedbackTypeExpression.parse(s)


def match_any(
    exprs: list[FeedbackTypeExpression] | list[str], feedback_type: str, value: float
) -> bool:
    """True if any expression matches. String expressions recur in
    per-feedback hot loops, so parses are memoized (the instances are
    immutable)."""
    for e in exprs:
        if isinstance(e, str):
            e = _parse_cached(e)
        if e.match(feedback_type, value):
            return True
    return False
