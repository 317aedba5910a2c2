"""The port's copy of the mini-JS interpreter (gorse_tpu_torch/utils/minijs.py)
held against gorse_tpu/utils/minijs.py: every test of tests/test_minijs.py
runs with that module's names bound to the port's, and its ``ev`` evaluates
each expression in both interpreters, which must agree exactly (the same
value, type for type, NaN for NaN, or the same exception with the same
message; ``Math.random`` from the same seed, ``Date.now`` from the same
frozen clock) before the test's own assertions check the port's value.
"""

import importlib.util
import inspect
import math
import random
import time
from pathlib import Path

import pytest

from gorse_tpu.utils import minijs as ref_js
from gorse_tpu_torch.utils import minijs as port_js

_SPEC = importlib.util.spec_from_file_location(
    "_reference_test_minijs", Path(__file__).with_name("test_minijs.py")
)
REF_TESTS = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(REF_TESTS)


def _cases() -> list[str]:
    out = []
    for name, obj in vars(REF_TESTS).items():
        if name.startswith("Test") and inspect.isclass(obj):
            out += [f"{name}.{m}" for m in vars(obj) if m.startswith("test")]
        elif name.startswith("test") and inspect.isfunction(obj):
            out.append(name)
    return out


CASES = _cases()


def _norm(v, js):
    """A value of either interpreter in comparable form."""
    if v is js.UNDEFINED:
        return ("undefined",)
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    if isinstance(v, list):
        return [_norm(x, js) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x, js) for k, x in v.items()}
    if callable(v):
        return ("function",)
    return (type(v).__name__, v)


def _run(js, src, globals_):
    random.seed(0)  # Math.random draws from Python's random module
    interp = js.Interpreter()
    for k, v in globals_.items():
        interp.set_global(k, v)
    try:
        return interp.eval(src), None
    except Exception as e:  # compared below, then the port's is raised
        return None, e


def both_ev(src, **globals_):
    want, want_err = _run(ref_js, src, globals_)
    got, got_err = _run(port_js, src, globals_)
    if want_err is not None or got_err is not None:
        assert (type(got_err).__name__, str(got_err)) == \
            (type(want_err).__name__, str(want_err)), src
        raise got_err
    assert _norm(got, port_js) == _norm(want, ref_js), src
    return got


def test_cases_cover_the_reference_file():
    assert len(CASES) >= 60 and "test_optional_call_on_missing_method" in CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_case_through_both_interpreters(case, monkeypatch):
    for name in ("UNDEFINED", "Interpreter", "JSError", "JSSyntaxError", "JSThrow", "js_str",
                 "to_python"):
        monkeypatch.setattr(REF_TESTS, name, getattr(port_js, name))
    monkeypatch.setattr(REF_TESTS, "ev", both_ev)
    # each interpreter reads the clock itself: both must read the same instant
    monkeypatch.setattr(time, "time", lambda: 1.75e9)
    if "." in case:
        cls_name, method = case.split(".")
        getattr(getattr(REF_TESTS, cls_name)(), method)()
    else:
        getattr(REF_TESTS, case)()
