"""No module of JAX or of the JAX package in the benchmark; the reference
imports nothing of the program."""
import ast
import subprocess
import sys

from perfbench import harness


def test_top_level_names_compared_whole():
    mods = ["bodyct_dram_emph_subtype_tpu_torch", "jaxtyping",
            "bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv", "flaxen"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
           "bodyct_dram_emph_subtype_tpu", "bodyct_dram_emph_subtype_tpu.ops"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        assert harness.forbidden_modules(list(_imports(path))) == [], path


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            assert not name.startswith("bodyct"), (path, name)
    code = ("import sys; sys.path.insert(0, %r);"
            "import perfbench.reference.model, perfbench.reference.processor,"
            " perfbench.reference.train, perfbench.flops, perfbench.synth;"
            "print(sorted(m for m in sys.modules if m.startswith('bodyct')"
            " or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax')))"
            % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_drivers_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "from perfbench import harness;"
            "[harness.load_module(p) for p in sorted("
            "(harness.BENCH / 'drivers').glob('*.py'))];"
            "import bodyct_dram_emph_subtype_tpu_torch.train.loop,"
            " bodyct_dram_emph_subtype_tpu_torch.inference.processor;"
            "print(harness.forbidden_modules())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
