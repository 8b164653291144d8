"""The port stands alone: paddle_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package, and the card path names no library
attention and no torch.compile."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
CHECKED = PORT_FILES + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "paddle_tpu"


def imported_modules(path: Path):
    """Every module an ``import``/``from ... import`` statement or an
    ``importlib.import_module("...")`` call in ``path`` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_has_files_to_check():
    assert len(PORT_FILES) >= 15
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", CHECKED,
                         ids=[str(p.relative_to(ROOT)) for p in CHECKED])
def test_no_jax_or_paddle_tpu_imports(path):
    bad = [m for m in imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; before = set(sys.modules); "
            "import paddle_tpu_torch, paddle_tpu_torch.models.gpt, "
            "paddle_tpu_torch.inference.engine; "
            "new = sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')); "
            "print(new)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_card_path_names_no_library_attention_or_compile():
    for path in PORT_FILES:
        text = path.read_text()
        for word in ("scaled_dot_product_attention", "torch.compile"):
            assert word not in text, f"{path.relative_to(ROOT)} names {word}"


def test_every_kernel_source_is_wrapped():
    from paddle_tpu_torch import ops
    sources = sorted(p.name for p in (ROOT / "paddle_tpu_torch" / "csrc")
                     .glob("*.cu"))
    assert sources == sorted(ops.KERNELS)
    for src in sources:
        text = (ROOT / "paddle_tpu_torch" / "csrc" / src).read_text()
        assert "Replaces: paddle_tpu/ops/" in text
        assert "What bounds it" in text


def _run_smoke(cwd: Path, script: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_without_cuda_fails_with_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_alone_fails_with_no_result(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script must fail without a result (on a GPU host: it cannot import
    the port)."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path, script)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
