"""The port's submodular selection (``repro_torch.core.selection``) held
against the JAX package's (``tests/test_selection.py``).

Each reference test runs on the port, on a problem built from the same
seeded numbers in both packages, and the port's answer must equal the
JAX package's exactly: the same objective values (the same float
operations in the same order), the same clauses selected in the same
order, the same number of marginal evaluations.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro.core import predicates as j_pred  # noqa: E402
from repro.core import selection as j_sel  # noqa: E402
from repro_torch.core import predicates as t_pred  # noqa: E402
from repro_torch.core import selection as t_sel  # noqa: E402


def _make_problem(pred, sel_mod, rng, n_preds=10, n_queries=8, budget=3.0):
    """tests/test_selection.py's ``_make_problem`` in either package."""
    pool = [pred.clause(pred.key_value(f"k{i}", i)) for i in range(n_preds)]
    sel = {c: float(rng.uniform(0.01, 0.95)) for c in pool}
    cost = {c: float(rng.uniform(0.2, 1.5)) for c in pool}
    queries = []
    for _ in range(n_queries):
        k = rng.integers(1, min(4, n_preds) + 1)
        idx = rng.choice(n_preds, size=k, replace=False)
        queries.append(pred.Query(tuple(pool[i] for i in idx), freq=1.0))
    return sel_mod.SelectionProblem(tuple(queries), sel, cost, budget)


def _problems(seed, budget=None, **kw):
    """The port's and the JAX package's problem from one seed, and the rng
    after them (the reference draws its subsets from it next); ``budget``
    a callable of the rng, drawn first, as the reference draws it."""
    out = []
    for pred, mod in ((t_pred, t_sel), (j_pred, j_sel)):
        rng = np.random.default_rng(seed)
        if budget is not None:
            kw["budget"] = budget(rng)
        out.append(_make_problem(pred, mod, rng, **kw))
    return out + [rng]


def _same(a, b) -> None:
    """Two SelectionResults (port, JAX) equal in every field."""
    assert a.objective == b.objective
    assert a.total_cost == b.total_cost
    assert a.evaluations == b.evaluations
    assert [t_pred.clause_to_obj(c) for c in a.selected] == \
        [j_pred.clause_to_obj(c) for c in b.selected]


def _subsets(p, jp, rng, frac):
    """One random subset of the candidates, in both packages."""
    keep = [rng.random() < frac for _ in p.candidates()]
    return ([c for c, k in zip(p.candidates(), keep) if k],
            [c for c, k in zip(jp.candidates(), keep) if k])


@given(st.integers(0, 10_000))
@settings(max_examples=60, deadline=None)
def test_submodularity(seed):
    """f(S)+f(T) >= f(S∪T)+f(S∩T) (paper §V-B), each value the JAX
    package's."""
    p, jp, rng = _problems(seed)
    (S, jS), (T, jT) = _subsets(p, jp, rng, 0.5), _subsets(p, jp, rng, 0.5)
    for a, b in ((S, jS), (T, jT), (set(S) | set(T), set(jS) | set(jT)),
                 (set(S) & set(T), set(jS) & set(jT))):
        assert t_sel.objective(p, a) == j_sel.objective(jp, b)
    lhs = t_sel.objective(p, S) + t_sel.objective(p, T)
    rhs = t_sel.objective(p, set(S) | set(T)) + \
        t_sel.objective(p, set(S) & set(T))
    assert lhs >= rhs - 1e-9


@given(st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_monotone(seed):
    p, jp, rng = _problems(seed)
    S, jS = _subsets(p, jp, rng, 0.4)
    extra = [c for c in p.candidates() if c not in S]
    jextra = [c for c in jp.candidates() if c not in jS]
    if not extra:
        return
    assert t_sel.objective(p, S + [extra[0]]) == \
        j_sel.objective(jp, jS + [jextra[0]])
    assert t_sel.objective(p, S + [extra[0]]) >= \
        t_sel.objective(p, S) - 1e-12


@given(st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_budget_respected(seed):
    p, jp, _ = _problems(seed, budget=lambda rng: float(rng.uniform(0.5, 4.0)))
    for run in (lambda m, q: m.greedy(q, ratio=False),
                lambda m, q: m.greedy(q, ratio=True),
                lambda m, q: m.combined_celf(q)):
        res = run(t_sel, p)
        _same(res, run(j_sel, jp))
        assert res.total_cost <= p.budget + 1e-9


@given(st.integers(0, 10_000))
@settings(max_examples=25, deadline=None)
def test_combined_beats_0316_opt(seed):
    """Paper §V-C: max(Alg1, Alg2) >= (1/2)(1-1/e)·OPT ≈ 0.316·OPT."""
    p, jp, _ = _problems(seed, n_preds=8, n_queries=6)
    opt, res = t_sel.brute_force(p), t_sel.combined_greedy(p)
    _same(opt, j_sel.brute_force(jp))
    _same(res, j_sel.combined_greedy(jp))
    if opt.objective > 0:
        assert res.objective >= 0.316 * opt.objective - 1e-9


@given(st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_celf_matches_eager_greedy(seed):
    """CELF lazy evaluation returns the same objective with fewer evals."""
    p, jp, _ = _problems(seed, n_preds=14, n_queries=10)
    for ratio in (False, True):
        eager = t_sel.greedy(p, ratio=ratio)
        lazy = t_sel.celf_greedy(p, ratio=ratio)
        _same(eager, j_sel.greedy(jp, ratio=ratio))
        _same(lazy, j_sel.celf_greedy(jp, ratio=ratio))
        assert abs(eager.objective - lazy.objective) < 1e-9, (
            eager.describe(), lazy.describe())


def test_celf_fewer_evaluations_large():
    p, jp, _ = _problems(7, n_preds=200, n_queries=100, budget=lambda _: 20.0)
    eager = t_sel.greedy(p, ratio=True)
    lazy = t_sel.celf_greedy(p, ratio=True)
    _same(eager, j_sel.greedy(jp, ratio=True))
    _same(lazy, j_sel.celf_greedy(jp, ratio=True))
    assert abs(eager.objective - lazy.objective) < 1e-9
    assert lazy.evaluations < eager.evaluations / 2, (
        lazy.evaluations, eager.evaluations)


def test_zero_budget_selects_nothing():
    p, jp, _ = _problems(0, budget=lambda _: 0.0)
    assert t_sel.combined_greedy(p).selected == []
    _same(t_sel.combined_greedy(p), j_sel.combined_greedy(jp))
