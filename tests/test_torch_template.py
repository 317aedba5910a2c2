"""The port's template engine (gorse_tpu_torch/utils/template.py) against
jinja2 with ``Environment(undefined=ChainableUndefined)``, the reference's
(gorse_tpu/logics/chat.py:26), on the CPU.

- A table of templates covering every construct of the subset, each
  rendered over one fixed context and over contexts drawn by hypothesis
  (dataclass users and items, dicts, lists, ``None``, missing names, made
  from numpy draws of the seed): the two output strings are equal, or both
  engines raise. Exact: no tolerance.
- Every template in the reference's code and tests, rendered alike.
- Syntax outside the subset raises ``TemplateSyntaxError`` when the
  template is parsed, with its line and column.
"""

import jinja2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gorse_tpu.logics.chat import LLMReranker as RefLLMReranker
from gorse_tpu.storage.types import Feedback, Item, User
from gorse_tpu_torch.logics.chat import LLMReranker
from gorse_tpu_torch.utils import template

ENV = jinja2.Environment(undefined=jinja2.ChainableUndefined)

TABLE = [
    # output, names and attribute chains
    "plain text only",
    "{{ user.user_id }}",
    "{{ missing }}|{{ missing.attr.deeper }}|{{ missing['k'][0] }}",
    "{{ none_value }}|{{ none_value.attr }}",
    "{{ item.labels.color }}/{{ item.labels['color'] }}/{{ item['item_id'] }}",
    "{{ mapping.a }} {{ mapping['b'] }} {{ mapping.nested.x }} {{ mapping.missing }}",
    "{{ numbers.0 }}{{ numbers[1] }}{{ numbers[-1] }}{{ numbers[99] }}",
    "{{ items[0].categories[1] }} {{ items[1].item_id.x }}",
    # literals
    "{{ 'single' }}{{ \"double\" }}{{ 'a' 'b' }}{{ 'esc\\t\\u00e9\\n' }}",
    "{{ 42 }} {{ -7 }} {{ 3.25 }} {{ 1e3 }} {{ 1_000 }} {{ 0x1f }} {{ 0b101 }}",
    "{{ true }} {{ false }} {{ none }} {{ True }} {{ None }}",
    "{{ [1, 'two', none] }} {{ (1,) }} {{ () }} {{ {'k': [1, 2]} }} {{ [] }}",
    # operators
    "{{ 1 + 2 * 3 - 4 / 2 }} {{ 7 // 2 }} {{ 7 % 3 }} {{ 2 ** 3 ** 2 }} {{ -2 ** 2 }}",
    "{{ 'a' ~ 1 ~ none ~ missing ~ [1] }}",
    "{{ 'ab' + 'cd' }} {{ numbers + [9] }} {{ 'x' * 3 }}",
    "{{ 1 < 2 }} {{ 2 <= 2 < 3 }} {{ 3 > 4 }} {{ 'a' == 'a' }} {{ 1 != 1.0 }} {{ 1 >= 2 }}",
    "{{ 'b' in 'abc' }} {{ 5 not in numbers }} {{ 'k' in mapping }} {{ 1 in missing }}",
    "{{ user and 1 }} {{ missing or 'fallback' }} {{ not missing }} {{ not not user }}",
    "{{ missing == missing }} {{ missing == none }} {{ missing != 1 }}",
    "{{ missing + 1 }}",
    "{{ missing < 1 }}",
    "{{ numbers > 1 }}",
    "{{ 1 / 0 }}",
    # statements
    "{% if user %}yes{% else %}no{% endif %}",
    "{% if missing %}a{% elif numbers %}b{% else %}c{% endif %}",
    "{% if none_value %}a{% elif missing.x %}b{% endif %}end",
    "{% for n in numbers %}{{ n }}{% if not loop.last %},{% endif %}{% endfor %}",
    "{% for n in numbers %}{{ loop.index }}/{{ loop.index0 }}/{{ loop.length }}"
    "{{ loop.first }}{{ loop.last }} {% endfor %}",
    "{% for t, it in feedback %}{{ t }}:{{ it.item_id }};{% endfor %}",
    "{% for (t, it) in feedback %}{{ loop.index }}{{ t }}{% endfor %}",
    "{% for x in missing %}x{% else %}empty{% endfor %}",
    "{% for x in none_value %}x{% endfor %}",
    "{% for k in mapping %}{{ k }}={{ mapping[k] }} {% endfor %}",
    "{% for c in 'abc' %}{{ c }}{% endfor %}",
    "{% for a in numbers %}{% for b in items %}{{ loop.index }}{% endfor %}|{{ loop.index }}"
    "{% endfor %}",
    "{% for a in numbers %}{% endfor %}{{ a }}",
    "{% for a, b in numbers %}{{ a }}{% endfor %}",
    "{% for x in [] %}a{% else %}{{ loop.index }}b{% endfor %}",
    # comments and whitespace control
    "a {# a comment {{ not rendered }} #} b",
    "a  {#- trimmed -#}  b",
    "line\n  {%- if true %}\n  kept\n  {%- endif -%}\n  tail\n",
    "{{- '  x  ' -}}  \n  y",
    "a\r\nb\rc\nd\n",
    "a\n\n",
    # filters
    "{{ missing|default('dflt') }} {{ ''|default('e', true) }} {{ 0|d('z', boolean=true) }}",
    "{{ numbers|join(', ') }} {{ numbers|join }} {{ items|join('|', attribute='item_id') }}",
    "{{ numbers|length }} {{ missing|length }} {{ mapping|count }} {{ 'abc'|length }}",
    "{{ text|lower }} {{ text|upper }} {{ '  pad  '|trim }}| {{ 'xxaxx'|trim('x') }}",
    "{{ text|truncate(9) }}|{{ text|truncate(9, true) }}|{{ text|truncate(12, false, '..', 0) }}"
    "|{{ text|truncate(255) }}",
    "{{ text|replace('o', '0') }} {{ text|replace('o', '0', 1) }} {{ 123|replace(2, 9) }}",
    "{{ numbers|reverse|join(',') }} {{ 'abc'|reverse }} {{ missing|reverse|join }}",
    "{{ numbers|first }} {{ numbers|last }} {{ missing|first }} {{ []|first }} {{ 'xy'|last }}",
    "{{ mapping|tojson }} {{ numbers|tojson(indent=2) }} {{ \"<a & 'b'>\"|tojson }}",
    "{{ mapping|tojson + '<' }} {{ '<' + numbers|tojson }} {{ numbers|tojson ~ '<' }}",
    "{{ (mapping|tojson|trim|upper) + '<' }} {{ (text|tojson|truncate(7)) + '&' }}"
    " {{ (numbers|tojson|reverse) + '>' }} {{ numbers|tojson * 2 + \"'\" }}",
    "{{ score|string }} {{ none_value|string ~ '!' }} {{ missing|string }}",
    "{{ '42'|int }} {{ '4.7'|int }} {{ 'x'|int(-1) }} {{ '0x1A'|int(0, 16) }} {{ score|int }}",
    "{{ score|round }} {{ score|round(2) }} {{ score|round(1, 'floor') }} {{ score|round(0, 'ceil') }}",
    "{{ -score|round(1) }} {{ user.user_id|upper|replace('U', 'v')|truncate(5, true, '') }}",
    "{{ missing|int }}",
    "{{ missing|tojson }}",
    "{{ user|tojson }}",
    "{{ numbers|round }}",
    "{{ text|truncate(2) }}",
    "{% for item in items|reverse %}\"{{ item.item_id }}\"{% if not loop.last %},"
    "{% endif %}{% endfor %}",
]

REFERENCE_TEMPLATES = [
    RefLLMReranker.DEFAULT_PROMPT,
    "{{ item.item_id }}",  # logics/chat.py:42, serve/worker.py:415
    "{{ user.user_id }}",  # serve/worker.py:414, tests/test_config_reference.py:120
    "find items like {{ item.item_id }}",  # tests/test_config_reference.py:91
    "queries for {{ item.item_id }}",  # tests/test_llm.py:73
    "user={{ user.user_id }}",  # tests/test_llm.py:190
    "doc={{ item.item_id }}",  # tests/test_llm.py:191
    "history: {% for t, item in feedback %}{{ item.item_id }} {% endfor %}",  # test_dashboard
    "doc {{ item.item_id }}",  # tests/test_dashboard.py:278
]

UNSUPPORTED = [
    ("{{ x is defined }}", 1, 6),
    ("{% set x = 1 %}", 1, 4),
    ("{{ x() }}", 1, 5),
    ("{{ x.upper() }}", 1, 11),
    ("{{ x[1:] }}", 1, 7),
    ("{{ a if b else c }}", 1, 6),
    ("{{ x|title }}", 1, 6),
    ("{{ x|join(*y) }}", 1, 11),
    ("line one\n{% for x in y %}{{ loop.revindex }}{% endfor %}", 2, 20),
    ("{% for x in y %}{{ loop }}{% endfor %}", 1, 20),
    ("{% for loop in y %}{% endfor %}", 1, 8),
    ("{% for x in y if x %}{% endfor %}", 1, 15),
    ("{% macro m() %}{% endmacro %}", 1, 4),
    ("{% raw %}{{ x }}{% endraw %}", 1, 4),
    ("{% include 'x' %}", 1, 4),
    ("{{ range }}", 1, 4),
    ("{{+ x }}", 1, 3),
    ("{{ x }", 1, 6),
    ("{% if x %}no end", 1, 17),
    ("{% endif %}", 1, 4),
    ("{# open comment", 1, 1),
    ("{{ }}", 1, 4),
    ("{{ (1 }}", 1, 7),
    ("{{ 1 ] }}", 1, 6),
    ("{% for x, in y %}{% endfor %}", 1, 11),
]


def _context(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "Gamma", "delta epsilon", "zeta <eta> & 'theta'"]
    items = [Item(f"i{k}", categories=[f"c{int(c)}" for c in rng.integers(0, 3, size=2)],
                  labels={"color": words[int(rng.integers(len(words)))],
                          "n": int(rng.integers(100))},
                  comment=words[int(rng.integers(len(words)))])
             for k in range(int(rng.integers(0, 4)))]
    return {
        "user": User(f"u{int(rng.integers(100))}", labels={"age": int(rng.integers(90))}),
        "items": items,
        "item": items[0] if items else None,
        "feedback": [("like", it) for it in items],
        "numbers": [int(x) for x in rng.integers(-5, 50, size=int(rng.integers(0, 5)))],
        "mapping": {"a": 1, "b": [2, 3], "nested": {"x": "y"}},
        "text": " ".join(words[int(i)] for i in rng.integers(len(words), size=4)),
        "score": float(rng.normal() * 10),
        "none_value": None,
    }


def _both(src: str, ctx: dict):
    """(jinja2's outcome, the port's): ("ok", output) or ("raises", None)."""
    out = []
    for render in (lambda: ENV.from_string(src).render(**ctx),
                   lambda: template.from_string(src).render(**ctx)):
        try:
            out.append(("ok", render()))
        except Exception:  # either engine's error; both must raise
            out.append(("raises", None))
    return out


@pytest.mark.parametrize("src", TABLE)
def test_table_renders_as_jinja2(src):
    want, got = _both(src, _context(0))
    assert got == want


def test_table_is_large_and_mostly_renders():
    outcomes = [_both(src, _context(0))[0][0] for src in TABLE]
    assert len(TABLE) >= 40 and outcomes.count("ok") >= 50


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1),
       drop=st.lists(st.sampled_from(["user", "items", "feedback", "numbers", "mapping",
                                      "text", "score"]), max_size=3),
       nones=st.lists(st.sampled_from(["user", "items", "mapping", "text"]), max_size=2))
def test_table_over_drawn_contexts(seed, drop, nones):
    """Every table entry over a drawn context, with some names missing and
    some ``None``."""
    ctx = _context(seed)
    for name in drop:
        ctx.pop(name, None)
    for name in nones:
        ctx[name] = None
    for src in TABLE:
        want, got = _both(src, ctx)
        assert got == want, src


@pytest.mark.parametrize("src", REFERENCE_TEMPLATES)
def test_reference_templates(src):
    for seed in range(5):
        ctx = _context(seed)
        want, got = _both(src, ctx)
        assert got == want and got[0] == "ok"
    assert LLMReranker.DEFAULT_PROMPT == RefLLMReranker.DEFAULT_PROMPT


def test_reference_feedback_shape():
    """The feedback the worker and the dashboard pass: (type, Item) pairs of
    real rows, with a user; the ranker prompt over candidates."""
    items = [Item(f"i{k}", comment=f"item {k}") for k in range(3)]
    ctx = {"user": User("u1"), "feedback": [(f.feedback_type, items[0]) for f in
                                            [Feedback("like", "u1", "i0")]], "items": items}
    for src in REFERENCE_TEMPLATES:
        want, got = _both(src, ctx)
        assert got == want and got[0] == "ok"


@pytest.mark.parametrize("src,line,col", UNSUPPORTED)
def test_unsupported_syntax_raises_at_parse(src, line, col):
    with pytest.raises(template.TemplateSyntaxError) as e:
        template.from_string(src)
    assert (e.value.line, e.value.column) == (line, col), str(e.value)
