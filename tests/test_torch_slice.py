"""The port's whole slice against the JAX package, and the port's rules.

The quickstart loop (``examples/quickstart.py``) runs through both
packages from the same seeds at 2,048 records: plan -> client pushdown ->
partial load -> data-skipping queries.  Plans, per-chunk bitvectors, the
loading ratio and every query result must be identical, and both must
equal the full-scan baseline.  The rules: nothing in ``src/repro_torch``
or ``chip_smoke.py`` imports ``jax`` or the JAX package, and the ``cuda``
backends refuse to run where there is no card.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.core import client as j_client  # noqa: E402
from repro.core import planner as j_planner  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import workload as j_workload  # noqa: E402
from repro.data import datasets as j_datasets  # noqa: E402
from repro.kernels.engine import KernelEngine as JKernelEngine  # noqa: E402
from repro_torch.core.client import encode_chunk, get_engine  # noqa: E402
from repro_torch.core.device_scan import DeviceScanner  # noqa: E402
from repro_torch.core.planner import build_plan  # noqa: E402
from repro_torch.core.predicates import clause_to_obj  # noqa: E402
from repro_torch.core.server import (  # noqa: E402
    CiaoStore, DataSkippingScanner, FullScanBaseline,
)
from repro_torch.core.workload import generate_workload  # noqa: E402
from repro_torch.data.datasets import (  # noqa: E402
    generate_records, predicate_pool,
)
from repro_torch.kernels.engine import KernelEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_RECORDS, CHUNK = 2048, 256


def _quickstart(torch_side: bool, dataset: str):
    """The quickstart loop in one package; returns what it observed."""
    if torch_side:
        gen, pool_of, wl_of, plan_of = (generate_records, predicate_pool,
                                        generate_workload, build_plan)
        enc, engine = encode_chunk, KernelEngine("torch")
        Store, Scanner, Base = CiaoStore, DataSkippingScanner, FullScanBaseline
    else:
        gen, pool_of = j_datasets.generate_records, j_datasets.predicate_pool
        wl_of, plan_of = j_workload.generate_workload, j_planner.build_plan
        enc, engine = j_client.encode_chunk, JKernelEngine("xla")
        Store, Scanner = j_server.CiaoStore, j_server.DataSkippingScanner
        Base = j_server.FullScanBaseline
    records = gen(dataset, N_RECORDS, seed=17)
    workload = wl_of(pool_of(dataset), n_queries=60, distribution="zipf",
                     zipf_a=1.5, rng=np.random.default_rng(0))
    report = plan_of(workload, records[:500], budget_us=1.0)
    store, base = Store(report.plan, segment_capacity=512), Base()
    chunks = [enc(records[i:i + CHUNK]) for i in range(0, N_RECORDS, CHUNK)]
    bitvecs = [engine.eval_fused(c, report.plan.clauses) for c in chunks]
    for c, bv in zip(chunks, bitvecs):
        store.ingest_chunk(c, bv)
        base.ingest_chunk(c)
    scanner = Scanner(store, log_queries=False)
    results = [scanner.scan(q) for q in workload.queries]
    out = {
        "plan": [clause_to_obj(c) if torch_side else
                 j_server.clause_to_obj(c) for c in report.plan.clauses],
        "bitvecs": bitvecs, "loading": store.stats.loading_ratio,
        "loaded": store.stats.n_loaded, "results": results,
        "baseline": [base.scan(q).count for q in workload.queries],
    }
    if torch_side:
        # the device plane on the same store (promotions already applied)
        dev = DeviceScanner(store, backend="torch", device="cpu",
                            log_queries=False)
        qs = list(workload.queries)
        out["device"] = [r for i in range(0, len(qs), 64)
                         for r in dev.scan_batch(qs[i:i + 64])]
    return out


@pytest.mark.parametrize("dataset", ["ycsb", "winlog"])
def test_quickstart_loop_matches_jax(dataset):
    ours, theirs = _quickstart(True, dataset), _quickstart(False, dataset)
    assert ours["plan"] == theirs["plan"] and ours["plan"]
    assert len(ours["bitvecs"]) == len(theirs["bitvecs"])
    for a, b in zip(ours["bitvecs"], theirs["bitvecs"]):
        assert np.array_equal(a.words, b.words)
        assert np.array_equal(a.or_words, b.or_words)
        assert np.array_equal(a.counts, b.counts)
    assert ours["loading"] == theirs["loading"] < 1.0
    assert ours["loaded"] == theirs["loaded"]
    for a, b, d in zip(ours["results"], theirs["results"], ours["device"]):
        assert (a.count, a.rows_scanned, a.rows_skipped, a.raw_parsed) == \
            (b.count, b.rows_scanned, b.rows_skipped, b.raw_parsed)
        assert (d.count, d.rows_scanned, d.rows_skipped) == \
            (a.count, a.rows_scanned, a.rows_skipped)
    assert [r.count for r in ours["results"]] == ours["baseline"] \
        == theirs["baseline"]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 20
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor PyTorch's internal test helpers, but for the fake process group
    of the dry run (``launch/dryrun.py``)."""
    bad, fake_pg = [], []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
                if n.startswith("torch.testing._internal"):
                    where = path.relative_to(ROOT).as_posix()
                    if (n != "torch.testing._internal.distributed.fake_pg"
                            or where != "src/repro_torch/launch/dryrun.py"):
                        bad.append(f"{where}: {n}")
                    fake_pg.append(where)
    assert not bad, bad
    assert fake_pg == ["src/repro_torch/launch/dryrun.py"]


def test_import_walk_covers_every_port_module():
    walked = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for mod in ("kernels/bitvector_ops.py", "kernels/substring_match.py",
                "kernels/residual.py", "benchmarks/__init__.py",
                "benchmarks/bench_kernels.py", "benchmarks/bench_reduce.py",
                "benchmarks/bench_ingest.py", "kernels/flash_attention.py",
                "dist/__init__.py", "dist/collectives.py", "core/shard.py",
                "core/batch_scan.py", "core/replan.py", "data/pipeline.py",
                "configs/__init__.py", "configs/base.py",
                "configs/qwen3_1_7b.py", "configs/deepseek_v3_671b.py",
                "data/tokenizer.py", "models/__init__.py", "models/layers.py",
                "models/attention.py", "models/transformer.py",
                "models/moe.py", "models/rglru.py", "models/rwkv6.py",
                "models/encdec.py", "models/model.py", "models/convert.py", "serve/__init__.py",
                "serve/engine.py", "launch/__init__.py", "launch/serve.py",
                "benchmarks/common.py", "benchmarks/bench_end_to_end.py",
                "benchmarks/bench_micro.py", "benchmarks/bench_cost_model.py",
                "benchmarks/bench_selection.py", "benchmarks/bench_replan.py",
                "benchmarks/bench_tiers.py", "benchmarks/bench_scan.py",
                "benchmarks/bench_device.py", "benchmarks/bench_batch.py",
                "benchmarks/bench_shard.py", "benchmarks/bench_skip.py",
                "benchmarks/bench_schema.py", "benchmarks/run.py",
                "train/__init__.py", "train/optimizer.py",
                "train/train_step.py", "train/checkpoint.py",
                "launch/train.py", "benchmarks/bench_train.py",
                "dist/sharding.py", "launch/mesh.py", "launch/dryrun.py",
                "analysis/__init__.py", "analysis/flops.py",
                "analysis/roofline.py", "analysis/comms.py",
                "benchmarks/bench_roofline.py"):
        assert f"src/repro_torch/{mod}" in walked, mod


def test_kernel_sources_are_cuda_for_hopper():
    from repro_torch.kernels import cuda_build
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    assert len(cuda_build.SOURCES) == 6
    # kernel E has its own source and library, apart from kernel D's
    assert cuda_build.SOURCES["key_value"] == "key_value.cu"
    assert "key_value_kernel" in (cuda_build.CSRC / "key_value.cu").read_text()
    assert "key_value_kernel" not in (
        cuda_build.CSRC / "substring_match.cu").read_text()
    for src in cuda_build.SOURCES.values():
        text = (cuda_build.CSRC / src).read_text()
        assert "__global__" in text and "src/repro/kernels/" in text
    assert cuda_build.BUILD_DIR == ROOT / "build"


def test_cuda_backends_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = CiaoStore(build_plan(
        generate_workload(predicate_pool("ycsb"), n_queries=5),
        [], budget_us=1.0).plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        KernelEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_engine("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceScanner(store)
    with pytest.raises(ValueError):
        KernelEngine("cuda", device="cpu")
    # kernel F: the path a CUDA tensor takes builds the kernel first
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model
    if not cuda_build.lib_path("flash_attention").exists():
        with pytest.raises(RuntimeError, match="CUDA"):
            fa._lib()
    model = build_model(get_config("qwen3-1.7b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced"])
