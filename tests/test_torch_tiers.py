"""The rest of ``tests/test_tiers.py`` on the port, held against the JAX
package: the multi-budget solver, the fleet allocator, plan families,
the coverage-aware store (validation, statistics, the group breakdown,
the mixed-tier mixed-epoch differential sweep, save and load) and the
engines' prefix checks.  ``tests/test_torch_fleet.py`` holds the tests
of this file that reach the pipeline and the replanner.

Each test runs the reference's body on the port and the same steps on
the JAX package from the same seeded inputs (clauses and families cross
between the packages through their JSON forms), and the answers must be
equal: solver orders and objectives, allocations, coverage sets, store
statistics and every ScanResult's accounting.  All values are integers
or the same float operations: the tolerance is 0.

``test_all_tiers_share_one_jit_trace`` counts ``pallas_call`` stagings;
the port stages nothing.  Its counterpart counts what the port caches:
one compiled plan for every tier of a family (the tier views share its
shapes), and one plain kernel-A call per evaluation.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import client as j_client  # noqa: E402
from repro.core import predicates as j_pred  # noqa: E402
from repro.core import selection as j_sel  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro_torch.core import selection as t_sel  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402
from repro_torch.core.client import (  # noqa: E402
    NumpyEngine, PythonEngine, encode_chunk,
)
from repro_torch.core.predicates import (  # noqa: E402
    Query, clause, clause_to_obj, presence,
)
from repro_torch.core.selection import (  # noqa: E402
    ClientProfile, SelectionProblem, allocate_tiers, celf_greedy, objective,
    tiered_celf,
)
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, FullScanBaseline, PlanFamily,
    PushdownPlan, evolve_family, trivial_family,
)
from repro_torch.core.workload import estimate_selectivities  # noqa: E402
from repro_torch.data import datasets as t_datasets  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)


def _jc(c):
    """A port clause as the JAX package's."""
    return j_pred.clause_from_obj(clause_to_obj(c))


def _jq(q):
    return j_pred.Query(tuple(_jc(c) for c in q.clauses), freq=q.freq)


def _jfam(fam):
    """A port PlanFamily as the JAX package's (its plan's global ids and
    retired ids kept)."""
    plan = j_server.PushdownPlan.from_obj(json.loads(json.dumps(
        fam.plan.to_obj())))
    return j_server.PlanFamily.from_obj(plan, json.loads(json.dumps(
        fam.to_obj())))


def _objs(clauses) -> list:
    return [clause_to_obj(c) for c in clauses]


def _jobjs(clauses) -> list:
    return [j_pred.clause_to_obj(c) for c in clauses]


def _acct(r) -> tuple:
    """Every ScanResult field but time, groups in their order."""
    return (r.count, r.rows_scanned, r.rows_skipped, r.raw_parsed,
            r.segments_pruned, r.segments_scanned, r.used_skipping,
            tuple((k, (g.count, g.rows_scanned, g.rows_skipped,
                       g.raw_parsed, g.segments_pruned))
                  for k, g in r.groups.items()))


def _problem(mods, seed: int, n_queries: int = 18):
    """tests/test_tiers.py's ``_problem`` in one package: (datasets,
    workload, selection) modules."""
    datasets, workload, selection = mods
    pool = datasets.predicate_pool("ycsb")
    rng = np.random.default_rng(seed)
    wl = workload.generate_workload(pool, n_queries=n_queries,
                                    distribution="zipf", zipf_a=1.5, rng=rng)
    cands = wl.clause_pool()
    sel = {c: float(rng.uniform(0.01, 0.6)) for c in cands}
    cost = {c: float(rng.uniform(0.2, 2.0)) for c in cands}
    return selection.SelectionProblem(queries=tuple(wl.queries), sel=sel,
                                      cost=cost, budget=0.0)


PORT = (t_datasets, t_workload, t_sel)
JAX = (j_datasets, j_workload, j_sel)


# ---------------------------------------------------------------------------
# the multi-budget solver
# ---------------------------------------------------------------------------

def test_tiered_celf_nested_budgeted_and_top_matches_celf():
    """Property sweep: Ti ⊆ Ti+1, every tier within budget, objectives
    non-decreasing, and the top tier IS the single-budget CELF solution;
    the order, objectives and costs the JAX package's."""
    for seed in range(12):
        prob, jprob = _problem(PORT, seed), _problem(JAX, seed)
        rng = np.random.default_rng(100 + seed)
        budgets = np.sort(rng.uniform(0.3, 8.0, size=rng.integers(2, 5)))
        ts = tiered_celf(prob, budgets.tolist())
        jts = j_sel.tiered_celf(jprob, budgets.tolist())
        assert _objs(ts.order) == _jobjs(jts.order)
        assert list(ts.objectives) == list(jts.objectives)
        assert ts.n_tiers == len(budgets)
        for t in range(ts.n_tiers):
            tier = ts.tier(t)
            assert ts.tier_cost(t) == jts.tier_cost(t)
            assert ts.tier_cost(t) <= ts.budgets[t] + 1e-9
            assert abs(ts.objectives[t] - objective(prob, tier)) < 1e-9
            if t:
                assert set(ts.tier(t - 1)) <= set(tier)          # nesting
                assert ts.objectives[t] >= ts.objectives[t - 1] - 1e-12
        top = celf_greedy(
            SelectionProblem(queries=prob.queries, sel=prob.sel,
                             cost=prob.cost, budget=float(budgets[-1])),
            ratio=True)
        assert list(ts.order) == list(top.selected)


def test_tiered_celf_rejects_bad_budgets():
    prob, jprob = _problem(PORT, 0), _problem(JAX, 0)
    for bad in ([], [2.0, 1.0], [-1.0, 1.0]):
        with pytest.raises(ValueError):
            tiered_celf(prob, bad)
        with pytest.raises(ValueError):
            j_sel.tiered_celf(jprob, bad)


# ---------------------------------------------------------------------------
# the fleet allocator
# ---------------------------------------------------------------------------

def _alloc(costs, values, profiles, budget):
    """The port's allocation, checked equal to the JAX package's."""
    got = allocate_tiers(costs, values, profiles, budget=budget)
    want = j_sel.allocate_tiers(
        costs, values, [j_sel.ClientProfile(cost_scale=p.cost_scale,
                                            weight=p.weight)
                        for p in profiles], budget=budget)
    assert list(got.tiers) == list(want.tiers)
    assert (got.spent, got.expected_savings, got.feasible) == \
        (want.spent, want.expected_savings, want.feasible)
    return got


def test_allocator_prefers_cheap_fast_clients():
    costs = [0.0, 1.0, 3.0]
    values = [0.0, 5.0, 8.0]
    clients = [ClientProfile(cost_scale=0.25, weight=0.5),   # fast
               ClientProfile(cost_scale=4.0, weight=0.5)]    # slow phone
    alloc = _alloc(costs, values, clients, 1.0)
    assert alloc.feasible and alloc.spent <= 1.0 + 1e-9
    assert alloc.tiers[0] > alloc.tiers[1]  # fast client climbs first


def test_allocator_budget_extremes():
    costs = [0.0, 1.0, 3.0]
    values = [0.0, 5.0, 8.0]
    clients = [ClientProfile(cost_scale=1.0, weight=1 / 3)] * 3
    rich = _alloc(costs, values, clients, 1e9)
    assert rich.tiers == [2, 2, 2]
    poor = _alloc(costs, values, clients, 0.0)
    assert poor.tiers == [0, 0, 0] and poor.feasible
    # savings monotone in budget
    mid = _alloc(costs, values, clients, 1.5)
    assert poor.expected_savings <= mid.expected_savings \
        <= rich.expected_savings


def test_allocator_validates_shapes():
    for costs, values in (([0.0, 1.0], [0.0]), ([2.0, 1.0], [0.0, 1.0])):
        with pytest.raises(ValueError):
            allocate_tiers(costs, values, [ClientProfile()], budget=1.0)
        with pytest.raises(ValueError):
            j_sel.allocate_tiers(costs, values, [j_sel.ClientProfile()],
                                 budget=1.0)


# ---------------------------------------------------------------------------
# PlanFamily: nesting across construction and evolution
# ---------------------------------------------------------------------------

def test_family_validates_tier_sizes():
    for srv, pred in ((None, None), (j_server, j_pred)):
        Plan = PushdownPlan if srv is None else srv.PushdownPlan
        Fam = PlanFamily if srv is None else srv.PlanFamily
        cl = clause if pred is None else pred.clause
        pr = presence if pred is None else pred.presence
        plan = Plan(clauses=[cl(pr("a")), cl(pr("b"))])
        with pytest.raises(ValueError):
            Fam(plan=plan, tier_sizes=(2, 1))         # not ascending
        with pytest.raises(ValueError):
            Fam(plan=plan, tier_sizes=(1,))           # top != plan.n
        with pytest.raises(ValueError):
            Fam(plan=plan, tier_sizes=(1, 2), budgets=(1.0,))
        fam = Fam(plan=plan, tier_sizes=(0, 2))
        assert fam.n_tiers == 2 and fam.tier_clauses(0) == []


def test_nesting_preserved_across_evolve_and_remap():
    """Coverage gid sets stay nested per epoch, survivors keep gids, and
    every tier's covered rows remap exactly like the whole plan's; every
    gid, coverage set and remap the JAX package's."""
    a, b, c, d, e = (clause(presence(x)) for x in "abcde")
    fam0 = PlanFamily(plan=PushdownPlan(clauses=[a, b, c, d]),
                      tier_sizes=(1, 2, 4))
    fam1 = evolve_family(fam0, [c, e, a], (1, 2, 3))
    ja, jb, jc_, jd, je = (_jc(x) for x in (a, b, c, d, e))
    jfam0 = j_server.PlanFamily(
        plan=j_server.PushdownPlan(clauses=[ja, jb, jc_, jd]),
        tier_sizes=(1, 2, 4))
    jfam1 = j_server.evolve_family(jfam0, [jc_, je, ja], (1, 2, 3))
    for fam, jfam in ((fam0, jfam0), (fam1, jfam1)):
        covs = [fam.coverage_gids(s) for s in fam.tier_sizes]
        assert covs == [jfam.coverage_gids(s) for s in jfam.tier_sizes]
        for lo, hi in zip(covs, covs[1:]):
            assert lo <= hi                               # nesting invariant
    # survivors keep stable gids; the new clause drew a fresh one
    assert fam1.plan.global_ids[a] == fam0.plan.global_ids[a]
    assert fam1.plan.global_ids[c] == fam0.plan.global_ids[c]
    assert fam1.plan.global_ids[e] == 4 == jfam1.plan.global_ids[je]
    # remap is consistent tier-by-tier: a tier-covered new row either maps
    # to the old local row of the same gid or is -1 (newly pushed)
    remap = fam1.plan.remap_from(fam0.plan)
    assert np.array_equal(remap, jfam1.plan.remap_from(jfam0.plan))
    for s in fam1.tier_sizes:
        for new_local in range(s):
            old_local = remap[new_local]
            if old_local >= 0:
                cl = fam1.plan.clauses[new_local]
                assert fam0.plan.ids[cl] == old_local
                assert fam0.plan.global_ids[cl] == fam1.plan.global_ids[cl]


def test_trivial_family_roundtrip():
    plan = PushdownPlan(clauses=[clause(presence("a"))])
    fam = trivial_family(plan)
    assert fam.tier_sizes == (1,) and fam.top_tier == 0
    assert PlanFamily.from_obj(plan, fam.to_obj()).tier_sizes == (1,)
    jplan = j_server.PushdownPlan(clauses=[_jc(clause(presence("a")))])
    assert fam.to_obj() == j_server.trivial_family(jplan).to_obj()
    assert _jfam(fam).tier_sizes == (1,)


# ---------------------------------------------------------------------------
# coverage-aware store: validation, stats, breakdown
# ---------------------------------------------------------------------------

def _ycsb_family(n_tiers=(1, 2, 4)):
    pool = predicate_pool("ycsb")
    recs = generate_records("ycsb", 600, seed=2)
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.2))
    plan = PushdownPlan(clauses=ranked[: n_tiers[-1]])
    fam = PlanFamily(plan=plan, tier_sizes=tuple(n_tiers))
    return fam, ranked, recs


class _Twin:
    """A port store and a JAX one fed the same chunks, each package's
    NumpyEngine computing its own bitvectors."""

    def __init__(self, fam):
        self.store = CiaoStore(fam)
        self.jstore = j_server.CiaoStore(_jfam(fam))
        self.eng, self.jeng = NumpyEngine(), j_client.NumpyEngine()

    def ingest(self, recs, k, **kw):
        chunk, jchunk = encode_chunk(recs), j_client.encode_chunk(recs)
        self.store.ingest_chunk(chunk, self.eng.eval_fused_prefix(
            chunk, self.store.family.plan.clauses, k), **kw)
        self.jstore.ingest_chunk(jchunk, self.jeng.eval_fused_prefix(
            jchunk, self.jstore.family.plan.clauses, k), **kw)

    def scan(self, q, **kw):
        r = DataSkippingScanner(self.store, **kw).scan(q)
        jr = j_server.DataSkippingScanner(self.jstore, **kw).scan(_jq(q))
        assert _acct(r) == _acct(jr), q.describe()
        return r

    def same_state(self):
        s, j = self.store, self.jstore
        assert (s.stats.n_records, s.stats.n_loaded, len(s.blocks),
                len(s.raw), len(s.jit_blocks)) == \
            (j.stats.n_records, j.stats.n_loaded, len(j.blocks), len(j.raw),
             len(j.jit_blocks))
        assert dict(s.group_records) == dict(j.group_records)
        assert np.array_equal(s.observed_selectivities(),
                              j.observed_selectivities())


def test_ingest_validates_coverage_before_stats():
    fam, ranked, recs = _ycsb_family()
    twin = _Twin(fam)
    store, eng = twin.store, twin.eng
    chunk = encode_chunk(recs[:100])
    # tier 1 covers 2 clauses; shipping 4 rows is a coverage lie
    bv_full = eng.eval_fused(chunk, fam.plan.clauses)
    jchunk = j_client.encode_chunk(recs[:100])
    jbv_full = twin.jeng.eval_fused(jchunk, twin.jstore.family.plan.clauses)
    before = (store.stats.n_records, len(store.blocks), len(store.raw))
    for s, c, bv in ((store, chunk, bv_full), (twin.jstore, jchunk,
                                                jbv_full)):
        with pytest.raises(ValueError):
            s.ingest_chunk(c, bv, tier=1)
        with pytest.raises(ValueError):
            s.ingest_chunk(c, bv, tier=7)   # no such tier
    assert (store.stats.n_records, len(store.blocks), len(store.raw)) == before
    twin.same_state()
    # the honest tier-1 chunk is accepted and tagged
    twin.ingest(recs[:100], 2, tier=1)
    assert store.blocks[-1].n_covered == 2 and store.blocks[-1].tier == 1
    assert store.group_records[(0, 1)] == 100
    twin.same_state()


def test_empty_tier_keeps_everything_raw():
    fam, ranked, recs = _ycsb_family(n_tiers=(0, 4))
    twin = _Twin(fam)
    twin.ingest(recs[:120], 0, tier=0)
    store = twin.store
    assert not store.blocks and len(store.raw) == 1
    assert store.raw[0].n_covered == 0
    twin.same_state()
    # zero coverage is never skippable: the first scan JIT-promotes it
    base = FullScanBaseline()
    base.ingest_chunk(encode_chunk(recs[:120]))
    q = Query((ranked[0],))
    r = twin.scan(q)
    assert r.count == base.scan(q).count
    assert r.raw_parsed == 120
    twin.same_state()


def test_observed_selectivities_use_per_clause_denominators():
    fam, ranked, recs = _ycsb_family(n_tiers=(1, 2))
    twin = _Twin(fam)
    twin.ingest(recs[:200], 1, tier=0)     # tier 0: covers clause 0 only
    twin.ingest(recs[200:300], 2, tier=1)  # tier 1: covers both
    obs = twin.store.observed_selectivities()
    eng = twin.eng
    bits_all = eng.eval(encode_chunk(recs[:300]), fam.plan.clauses)
    bits_hi = eng.eval(encode_chunk(recs[200:300]), fam.plan.clauses)
    # clause 0 was evaluated on all 300 records, clause 1 only on the 100
    assert obs[0] == pytest.approx(bits_all[0].mean())
    assert obs[1] == pytest.approx(bits_hi[1].mean())
    twin.same_state()


def test_scan_result_group_breakdown_sums_to_aggregate():
    fam, ranked, recs = _ycsb_family()
    twin = _Twin(fam)
    for lo, tier in ((0, 0), (100, 1), (200, 2)):
        twin.ingest(recs[lo:lo + 100], fam.tier_sizes[tier], tier=tier)
    r = twin.scan(Query((ranked[1],)))
    assert set(r.groups) <= {(0, 0), (0, 1), (0, 2)}
    assert sum(g.rows_scanned for g in r.groups.values()) == r.rows_scanned
    assert sum(g.rows_skipped for g in r.groups.values()) == r.rows_skipped
    assert sum(g.raw_parsed for g in r.groups.values()) == r.raw_parsed
    assert sum(g.count for g in r.groups.values()) == r.count
    # clause ranked[1] is covered by tiers 1/2 but NOT tier 0: only the
    # tier-0 group can have JIT parses, the covered groups can skip
    assert r.groups[(0, 0)].raw_parsed > 0
    assert r.groups[(0, 1)].rows_skipped + r.groups[(0, 2)].rows_skipped > 0


# ---------------------------------------------------------------------------
# THE soundness gate: differential sweep under mixed tiers, mixed epochs
# ---------------------------------------------------------------------------

def test_differential_mixed_tier_mixed_epoch_scan_counts():
    """Scanner counts equal FullScanBaseline counts for every probe under
    interleaved tiers and a mid-stream epoch bump; every ScanResult the
    JAX package's on its twin store."""
    pool = predicate_pool("ycsb")
    recs = generate_records("ycsb", 1200, seed=5)
    sel = estimate_selectivities(pool, recs[:300])
    ranked = sorted(pool, key=lambda c: abs(sel[c] - 0.25))
    fam0 = PlanFamily(plan=PushdownPlan(clauses=ranked[:4]),
                      tier_sizes=(1, 2, 4))
    twin = _Twin(fam0)
    base = FullScanBaseline()
    rng = np.random.default_rng(11)
    lo = 0
    for _ in range(6):                              # epoch 0, mixed tiers
        tier = int(rng.integers(0, 3))
        twin.ingest(recs[lo:lo + 100], fam0.tier_sizes[tier], epoch=0,
                    tier=tier)
        base.ingest_chunk(encode_chunk(recs[lo:lo + 100]))
        lo += 100
    fam1 = evolve_family(fam0, [ranked[2], ranked[4], ranked[5]], (1, 3))
    twin.store.advance_epoch(fam1)
    twin.jstore.advance_epoch(_jfam(fam1))
    for _ in range(6):                              # epoch 1, mixed tiers
        tier = int(rng.integers(0, 2))
        twin.ingest(recs[lo:lo + 100], fam1.tier_sizes[tier], epoch=1,
                    tier=tier)
        base.ingest_chunk(encode_chunk(recs[lo:lo + 100]))
        lo += 100
    twin.same_state()
    probes = [Query((c,)) for c in ranked[:6]]      # covered + uncovered mix
    probes += [Query((ranked[0], ranked[2])), Query((ranked[2], ranked[4])),
               Query((ranked[1], ranked[5])), Query((ranked[7],))]
    scanner = DataSkippingScanner(twin.store)
    jscanner = j_server.DataSkippingScanner(twin.jstore)
    for _ in range(2):        # then repeat post-JIT (promoted blocks)
        for q in probes:
            got, jgot = scanner.scan(q), jscanner.scan(_jq(q))
            assert _acct(got) == _acct(jgot), q.describe()
            want = base.scan(q).count
            assert got.count == want, (q.describe(), got.count, want)
    twin.same_state()


# ---------------------------------------------------------------------------
# kernel plane: shared plans + the engines' prefix checks
# ---------------------------------------------------------------------------

def test_all_tiers_share_one_compiled_plan(monkeypatch):
    """Counterpart of ``test_all_tiers_share_one_jit_trace``: the port has
    no trace to stage.  Every tier of one family evaluates through ONE
    compiled plan (``compile_plan`` runs once; the tier views keep its
    shapes), re-evaluation compiles nothing, and each evaluation is one
    plain kernel-A call (on the card, one launch: ``chip_smoke.py``);
    every tier's bitvectors the JAX package's ``pallas_interpret``."""
    from repro.kernels.engine import KernelEngine as JKernelEngine
    from repro_torch.kernels import engine as engine_mod
    from repro_torch.kernels import ops as ops_mod
    from repro_torch.kernels.engine import KernelEngine

    compiled, calls = [], []
    real_compile, real_ref = engine_mod.compile_plan, \
        ops_mod.ref.clause_bitvectors_ref

    def counting_compile(*a, **kw):
        compiled.append(1)
        return real_compile(*a, **kw)

    def counting_ref(*a, **kw):
        calls.append(1)
        return real_ref(*a, **kw)

    monkeypatch.setattr(engine_mod, "compile_plan", counting_compile)
    monkeypatch.setattr(ops_mod.ref, "clause_bitvectors_ref", counting_ref)
    recs = generate_records("ycsb", 200, seed=3)
    pool = tuple(predicate_pool("ycsb")[:5])
    chunk = encode_chunk(recs)
    jpool = tuple(_jc(c) for c in pool)
    jchunk = j_client.encode_chunk(recs)
    eng, jeng = KernelEngine("torch"), JKernelEngine("pallas_interpret")
    ks = (5, 3, 1, 4, 2, 5, 3)
    for i, k in enumerate(ks):
        got = eng.eval_fused_prefix(chunk, pool, k)
        assert len(compiled) == 1, "a tier compiled its own plan"
        assert len(calls) == i + 1, "an evaluation was not one call"
        want = jeng.eval_fused_prefix(jchunk, jpool, k)
        assert np.array_equal(got.words, want.words), k
        assert np.array_equal(got.or_words, want.or_words), k
        assert np.array_equal(got.counts, want.counts), k
    assert len(eng._plan_cache) == 1 and len(eng._tier_cache) == 4


def test_eval_fused_prefix_rejects_out_of_range_on_all_engines():
    from repro.kernels.engine import KernelEngine as JKernelEngine
    from repro_torch.kernels.engine import KernelEngine

    recs = generate_records("ycsb", 50, seed=1)
    pool = tuple(predicate_pool("ycsb")[:3])
    chunk = encode_chunk(recs)
    for eng in (NumpyEngine(), PythonEngine(), KernelEngine("torch")):
        for bad in (-1, 4):
            with pytest.raises(ValueError):
                eng.eval_fused_prefix(chunk, pool, bad)
    jchunk = j_client.encode_chunk(recs)
    for bad in (-1, 4):
        with pytest.raises(ValueError):
            JKernelEngine("xla").eval_fused_prefix(
                jchunk, tuple(_jc(c) for c in pool), bad)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def test_save_load_roundtrips_families_and_coverage(tmp_path):
    """The reference's round trip on the port, and across the packages:
    the port's file loads in the JAX package with the same families,
    coverage and scans."""
    fam, ranked, recs = _ycsb_family()
    twin = _Twin(fam)
    for lo, tier in ((0, 0), (150, 2), (300, 1)):
        twin.ingest(recs[lo:lo + 150], fam.tier_sizes[tier], tier=tier)
    twin.scan(Query((ranked[7],)))  # force JIT blocks
    store = twin.store
    path = str(tmp_path / "tiered.npz")
    store.save(path)
    for loaded in (CiaoStore.load(path), j_server.CiaoStore.load(path)):
        assert loaded.family.tier_sizes == fam.tier_sizes
        assert [b.n_covered for b in loaded.blocks] == \
            [b.n_covered for b in store.blocks]
        assert [b.tier for b in loaded.jit_blocks] == \
            [b.tier for b in store.jit_blocks]
        assert loaded.group_records == store.group_records
        assert loaded.group_loaded == store.group_loaded
        assert np.array_equal(loaded.observed_selectivities(),
                              store.observed_selectivities())
    loaded, jloaded = CiaoStore.load(path), j_server.CiaoStore.load(path)
    for q in (Query((ranked[0],)), Query((ranked[1], ranked[2]))):
        a = DataSkippingScanner(store, log_queries=False).scan(q)
        b = DataSkippingScanner(loaded, log_queries=False).scan(q)
        c = j_server.DataSkippingScanner(jloaded, log_queries=False).scan(
            _jq(q))
        assert (a.count, a.rows_scanned, a.rows_skipped) == \
            (b.count, b.rows_scanned, b.rows_skipped)
        assert _acct(b) == _acct(c)
