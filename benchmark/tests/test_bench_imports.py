"""Nothing the benchmark loads is JAX, flax or the JAX package (compared by
whole top-level module names: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import subprocess
import sys

from benchmark import run, spec

REFERENCE = spec.CHECKOUT / "benchmark" / "reference"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wiki_grx_gym_tpu_torch_fake", object())
    assert "wiki_grx_gym_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]


def test_the_benchmark_and_the_port_load_no_jax():
    code = ("import sys\n"
            "import benchmark.run, benchmark.session, benchmark.report, benchmark.control, benchmark.program\n"
            "from benchmark import spec\n"
            "for m in spec.load_benchmark()['per_layer']: spec.reader(m['name'])\n"
            "import wiki_grx_gym_tpu_torch.envs, wiki_grx_gym_tpu_torch.learn.runner, "
            "wiki_grx_gym_tpu_torch.learn.graphs, wiki_grx_gym_tpu_torch.parallel.mesh\n"
            "print(benchmark.run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=spec.CHECKOUT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in REFERENCE.glob("*.py"):
        names = _top_level_imports(path)
        assert not names & {"wiki_grx_gym_tpu_torch", "wiki_grx_gym_tpu", "jax", "jaxlib", "flax"}, path
    code = ("import sys\nimport benchmark.reference.ppo, benchmark.reference.gae, benchmark.reference.precision\n"
            "import benchmark.reference.env\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'wiki_grx_gym_tpu_torch', 'wiki_grx_gym_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=spec.CHECKOUT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_only_the_program_adapter_imports_the_port():
    bench_dir = spec.CHECKOUT / "benchmark"
    for path in bench_dir.rglob("*.py"):
        rel = path.relative_to(bench_dir).as_posix()
        if rel in ("program.py",) or rel.startswith("tests/"):
            continue
        assert "wiki_grx_gym_tpu_torch" not in _top_level_imports(path), rel
