"""Nothing in ``ldpc_bench/`` imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level module names are
compared whole: ``ldpc_tpu_torch`` begins with ``ldpc_tpu`` and is allowed
outside ``reference/``."""
import ast
import subprocess
import sys

import pytest

from ldpc_bench import run
from ldpc_bench.cell import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "ldpc_tpu"}
PROGRAM = "ldpc_tpu_torch"


def _imports(path):
    """Top-level names of every absolute import in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _sources(sub=""):
    files = sorted((BENCH / sub).rglob("*.py"))
    assert files
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (JAX | {PROGRAM})


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ldpc_tpu_torch_fake", object())
    assert run.forbidden_modules() == [] or "ldpc_tpu_torch_fake" not in \
        run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ldpc_tpu.fake", object())
    assert "ldpc_tpu" in run.forbidden_modules()


def test_a_run_in_process_loads_no_jax():
    """A run of the harness's modules and the program's modules on the CPU
    leaves no JAX module behind."""
    code = ("import sys; import ldpc_bench.run, ldpc_bench.check, "
            "ldpc_bench.trace, ldpc_bench.calibrate; "
            "import ldpc_tpu_torch.harness.experiment, "
            "ldpc_tpu_torch.decoders.alp, ldpc_tpu_torch.decoders.bp; "
            "from ldpc_bench.run import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits with another code than 0 and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "ldpc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "ldpc_bench.run", "--workload",
         "bp100-optimalH-m3db", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("hook", ["reference", "metric"])
def test_jax_loaded_after_the_window_gives_no_result(hook, capsys,
                                                     monkeypatch):
    """JAX loaded once the window has closed, by the reference or by a
    metric's reader, leaves the run without a result and its exit code
    not 0."""
    import types

    from ldpc_bench.cell import Cell

    def plant():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    real = getattr(Cell, hook)

    def reference(self):
        plant()
        return real(self)

    def metric(self, name):
        mod = real(self, name)

        def read(ctx, summary):
            plant()
            return mod.read(ctx, summary)
        return types.SimpleNamespace(**{**vars(mod), "read": read})
    monkeypatch.setattr(Cell, hook, locals()[hook])
    rc = run.main(["--workload", "bp100-optimalH-m3db", "--seed", "5",
                   "--seconds", "0.01", "--trace", str(int(hook == "metric"))],
                  device="cpu", sizes={"batch": 16, "block_batches": 1,
                                       "check_blocks": 1, "trace_blocks": 1})
    captured = capsys.readouterr()
    assert rc != 0 and captured.out.strip() == ""
    assert "jax" in captured.err
