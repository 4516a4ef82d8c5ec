"""Nothing the runner or the reference loads has the top-level name of JAX
or of the JAX package, compared whole (the port's name begins with the JAX
package's); the reference loads nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "hairgs_tpu"}


def loaded_top_level(code: str):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r}); {code}; "
         "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runner_loads_no_jax():
    names = loaded_top_level(
        "import benchmark.run, benchmark.harness, benchmark.calibrate; "
        "from benchmark import harness; import json; "
        "m = json.load(open('BENCHMARK.json')); "
        "[harness.reader(x['name']) for x in m['per_layer']]; "
        "import hairgs_tpu_torch.drivers.train")
    assert "hairgs_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_level("import benchmark.reference.stage1, benchmark.reference.stage3")
    assert not names & (FORBIDDEN | {"hairgs_tpu_torch"})


def test_reference_sources_import_plain_modules_only():
    allowed = {"math", "statistics", "typing", "numpy", "torch", "benchmark.reference"}
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert all(m.split(".")[0] in allowed or m.startswith("benchmark.reference")
                       for m in mods), (path, mods)


def test_forbidden_names_compare_whole():
    sys.path.insert(0, ROOT)
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules["hairgs_tpu_torch_extra"] = sys
        assert "hairgs_tpu" not in run.forbidden_modules()
        sys.modules["hairgs_tpu.core"] = sys
        assert run.forbidden_modules() == ["hairgs_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
