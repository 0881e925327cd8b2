"""Nothing the benchmark runs loads JAX or the JAX package, nor reads the
JAX package's benchmarks."""
import re
import subprocess
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def test_harness_imports_no_jax_in_a_fresh_process():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import perfbench.run as r, perfbench.calibrate, perfbench.faults\n"
        "from perfbench.harness import bench, flops, port, record, runs, serve, train, traffic, weights\n"
        "from perfbench.harness.ports import decoder as port_decoder\n"
        "from perfbench.reference import arch, data, decoder, precision, train as rt\n"
        "for c in bench.benchmark()['configs']:\n"
        "    bench.architecture(bench.load_json('configs', c['name']))\n"
        "for m in bench.benchmark()['end_to_end'] + bench.benchmark()['per_layer']:\n"
        "    bench.metric_reader(m['name'])\n"
        "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names():
    from perfbench import run
    assert run.forbidden_modules(["repro_torch.models", "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["jaxlib.xla", "repro.core.server", "flax"]) == [
        "flax", "jaxlib", "repro"]


def test_no_source_reads_the_jax_packages_benchmarks():
    pat = re.compile(r"^\s*(from|import)\s+(repro|jax|jaxlib|flax|benchmarks|"
                     r"repro_torch\.benchmarks)\b", re.M)
    for path in PERFBENCH.rglob("*.py"):
        assert not pat.search(path.read_text()), path
