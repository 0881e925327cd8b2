"""The analysis plane and the dry run against the JAX package
(``tests/test_analysis.py``).

  * ``flops.estimate`` equals the JAX package's, field for field, for every
    arch x shape, and ``scan_estimate`` over a hypothesis sweep;
  * the analytic FLOPs against ``torch.utils.flop_counter.FlopCounterMode``
    over an unrolled f32 train step (loss and gradients) of three reduced
    configs, within the JAX package's 0.5-1.6 (its own test holds them
    against XLA's ``cost_analysis``).  The ratios measured on the CPU
    (torch 2.13): qwen3-8b 0.879, deepseek-v3 0.877, recurrentgemma 0.919
    (the counter prices the masked attention in full, and counts matrix
    products only);
  * the 6·N·D check;
  * ``comms`` on a row-parallel pair of known bytes, and the dry run of
    two reduced cells, in one subprocess over a fake world of 8 (the fake
    group becomes the process's default group), its records' keys equal
    to the JAX package's;
  * the counterpart of ``test_dryrun_artifacts_complete``, which skips
    without the sweep's artifacts (``artifacts/`` is not committed).
"""
import dataclasses
import glob
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis import flops as j_flops  # noqa: E402
from repro.analysis import roofline as j_rl  # noqa: E402
from repro.configs import get_config as j_get, list_archs  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro_torch.analysis import flops as t_flops  # noqa: E402
from repro_torch.analysis import roofline as t_rl  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
#: the JAX package's record keys (repro.launch.dryrun.run_cell)
RECORD_KEYS = {"arch", "shape", "kind", "params", "active_params", "mesh",
               "n_devices", "lower_s", "compile_s", "memory_analysis",
               "cost_analysis", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "generated_code_bytes"}


@pytest.mark.parametrize("arch", list_archs())
def test_estimate_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_get(arch)
    m = build_model(cfg)
    n, n_act = m.param_count(), m.active_param_count()
    for name, shape in SHAPES.items():
        got = t_flops.estimate(cfg, shape, n, n_act)
        want = j_flops.estimate(jcfg, J_SHAPES[name], n, n_act)
        assert got.flops_global == want.flops_global, name
        assert got.hbm_bytes_global == want.hbm_bytes_global, name
        assert got.breakdown == want.breakdown, name
        assert t_rl.model_flops(cfg, shape, n_act) == \
            j_rl.model_flops(jcfg, J_SHAPES[name], n_act)


def test_scan_estimate_equals_reference_sweep():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    dims = st.integers(min_value=0, max_value=1 << 20)

    @settings(max_examples=200, deadline=None)
    @given(dims, st.integers(0, 600), st.integers(0, 600),
           st.integers(0, 300), st.integers(0, 64))
    def check(n_rows, n_terms, n_clauses, n_queries, n_slots):
        kw = dict(n_rows=n_rows, n_terms=n_terms, n_clauses=n_clauses,
                  n_queries=n_queries, n_slots=n_slots)
        got, want = t_flops.scan_estimate(**kw), j_flops.scan_estimate(**kw)
        assert (got.flops_global, got.hbm_bytes_global, got.breakdown) == \
            (want.flops_global, want.hbm_bytes_global, want.breakdown)

    check()


def test_roofline_constants_are_the_h100s():
    assert t_rl.PEAK_FLOPS == 989e12 and t_rl.HBM_BW == 3.35e12
    assert t_rl.LINK_BW == 450e9
    r = t_rl.Roofline("a", "s", "m", device_flops=989e12, device_bytes=0.0,
                      collective_bytes=0.0, model_flops_global=989e12,
                      n_devices=1).finalize()
    assert r.compute_s == 1.0 and r.dominant == "compute"
    assert r.roofline_frac == 1.0
    assert {f.name for f in dataclasses.fields(t_rl.Roofline)} == \
        {f.name for f in dataclasses.fields(j_rl.Roofline)}


def _counted_flops(cfg, shape) -> float:
    """FlopCounterMode's FLOPs of the loss and its gradients (one device,
    the layers unrolled, remat off)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import make_batch
    from repro_torch.train.train_step import value_and_grad

    model = build_model(cfg)
    params = model.init(0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, shape).items()}
    with FlopCounterMode(display=False) as fc:
        value_and_grad(model, params, batch)
    return float(fc.get_total_flops())


@pytest.mark.parametrize("arch,lo,hi", [("qwen3-8b", 0.8, 0.95),
                                        ("deepseek-v3-671b", 0.8, 0.95),
                                        ("recurrentgemma-9b", 0.85, 1.0)])
def test_analytic_flops_matches_counted_unrolled(arch, lo, hi):
    """The JAX package's bounds (0.5-1.6) hold, and each ratio stays near
    the one measured when this test was written (module docstring)."""
    cfg = dataclasses.replace(
        get_config(arch).reduced(), scan_layers=False, remat="none",
        microbatches=1, attn_q_chunk=4096, attn_k_chunk=4096,
        compute_dtype="float32", param_dtype="float32")
    shape = ShapeConfig("t", "train", 128, 2)
    counted = _counted_flops(cfg, shape)
    m = build_model(cfg)
    est = t_flops.estimate(cfg, shape, m.param_count(),
                           m.active_param_count())
    ratio = est.flops_global / counted
    assert 0.5 < ratio < 1.6, (ratio, est.flops_global, counted)
    assert lo < ratio < hi, ratio


def test_estimate_close_to_six_nd_dense():
    cfg = get_config("qwen3-8b")
    m = build_model(cfg)
    shape = ShapeConfig("t", "train", 4096, 256)
    est = t_flops.estimate(cfg, shape, m.param_count(),
                           m.active_param_count())
    six_nd = 6.0 * m.param_count() * shape.global_batch * shape.seq_len
    assert 1.0 < est.flops_global / six_nd < 2.2


_FAKE_WORLD = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.analysis.comms import CommsRecorder
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh

    dryrun.init_fake_world(8)
    mesh = make_test_mesh((8,), ("model",))
    B, d, f = 4, 64, 256
    x = distribute_tensor(torch.empty(B, d, device="meta"), mesh,
                          [Replicate()], src_data_rank=None)
    w1 = distribute_tensor(torch.empty(d, f, device="meta"), mesh,
                           [Shard(1)], src_data_rank=None)
    w2 = distribute_tensor(torch.empty(f, d, device="meta"), mesh,
                           [Shard(0)], src_data_rank=None)
    with CommsRecorder() as rec:
        y = ((x @ w1) @ w2).redistribute(mesh, [Replicate()])
    out = {"comms": rec.result(), "y_shape": list(y.shape)}
    out["cells"] = [dryrun.run_cell(a, s, "4,2", sys.argv[1], reduced=True)
                    for a, s in (("qwen3-1.7b", "train_4k"),
                                 ("deepseek-v3-671b", "prefill_32k"))]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _FAKE_WORLD, str(tmp)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["files"] = sorted(os.listdir(tmp))
    return res


def test_comms_counts_a_row_parallel_pair(fake_world):
    """One all-reduce of the (B, d) f32 result, counted twice."""
    c = fake_world["comms"]
    assert c["counts"] == {"all-reduce": 1}
    assert c["bytes"] == {"all-reduce": 2 * 4 * 64 * 4}
    assert c["total"] == 2 * 4 * 64 * 4
    assert fake_world["y_shape"] == [4, 64]


def test_dryrun_records_have_reference_keys(fake_world):
    for rec in fake_world["cells"]:
        assert set(rec) == RECORD_KEYS
        assert set(rec["memory_analysis"]) == MEMORY_KEYS
        assert set(rec["roofline"]) == {f.name for f in dataclasses.fields(
            j_rl.Roofline)}
        ro = rec["roofline"]
        assert ro["device_flops"] > 0 and ro["n_devices"] == 8
        assert rec["memory_analysis"]["argument_bytes"] > 0
        assert sum(ro["collectives"]["counts"].values()) > 0
        assert ro["dominant"] in ("compute", "memory", "collective")
    train = fake_world["cells"][0]
    assert train["memory_analysis"]["temp_bytes"] > 0    # autograd saved
    assert train["memory_analysis"]["alias_bytes"] > 0   # params, opt state
    assert fake_world["files"] == [
        "deepseek-v3-671b_prefill_32k_4x2.json", "qwen3-1.7b_train_4k_4x2.json"]


def _stub_cells(mesh_model: int = 16) -> int:
    """Cells whose decode reaches the flash-decoding stub in both packages:
    GQA decode (not MLA, RWKV or encdec) with the model axis dividing the
    cache."""
    n = 0
    from repro_torch.configs import cache_alloc_len, shape_applicable

    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.kind != "decode" or not shape_applicable(cfg, shape)[0]:
                continue
            if cfg.family in ("rwkv", "encdec") or cfg.attention == "mla":
                continue
            alloc = cache_alloc_len(shape.seq_len)
            if cfg.window:
                alloc = min(alloc, cfg.window + 128)
            n += alloc % mesh_model == 0
    return n


def test_dryrun_artifacts_complete():
    """All 40 cells x 2 meshes recorded: ok, a documented skip, or (absent)
    a decode cell that reaches the JAX package's flash-decoding stub."""
    files = glob.glob("artifacts/dryrun_torch/*.json")
    n_stub = 2 * _stub_cells()
    if len(files) < 80 - n_stub:
        pytest.skip("dry-run sweep artifacts not present in this checkout")
    n_ok = n_skip = 0
    for f in files:
        rec = json.load(open(f))
        if "skipped" in rec:
            n_skip += 1
        else:
            assert rec["roofline"]["device_flops"] > 0, f
            n_ok += 1
    assert n_skip == 16 and n_ok == 64 - n_stub, (n_ok, n_skip, n_stub)


def test_bench_roofline_renders_dryrun_records(tmp_path, monkeypatch, capsys):
    """The roofline section reads the dry run's records and writes the
    port's table (never the JAX package's file); run.py carries it."""
    from repro_torch.benchmarks import bench_roofline, run

    d = tmp_path / "dryrun_torch"
    d.mkdir()
    ro = t_rl.Roofline("qwen3-8b", "train_4k", "single", device_flops=1e15,
                       device_bytes=1e12, collective_bytes=1e11,
                       model_flops_global=2e17, n_devices=256).finalize()
    (d / "a.json").write_text(json.dumps({
        "arch": "qwen3-8b", "shape": "train_4k", "mesh": "single",
        "roofline": ro.to_json()}))
    (d / "b.json").write_text(json.dumps({
        "arch": "qwen3-8b", "shape": "long_500k", "mesh": "single",
        "skipped": "quadratic"}))
    table = tmp_path / "roofline_table_torch.md"
    monkeypatch.setattr(bench_roofline, "DRYRUN", str(d))
    monkeypatch.setattr(bench_roofline, "TABLE", str(table))
    csv, failed = run.run({"roofline"}, quick=True, device="cpu")
    assert failed == [] and csv == [("roofline_cells", 0.0,
                                     "1_cells_run;1_documented_skips")]
    text = table.read_text()
    assert "| qwen3-8b | train_4k | 1.011e+00 |" in text
    assert "| qwen3-8b | long_500k | — | — | — | skipped |" in text
    assert "roofline_table_torch.md" == table.name
    monkeypatch.setattr(bench_roofline, "DRYRUN", str(tmp_path / "none"))
    assert bench_roofline.main() == {}
    assert "no dry-run records" in capsys.readouterr().out
