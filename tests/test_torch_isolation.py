"""The port stands alone: paddle_tpu_torch and chip_smoke.py import
neither JAX nor the JAX package (its C sources name no module of it
either), and the card path uses no library attention (torch's SDPA,
found by an AST check) and no file of the port names torch.compile."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
CHECKED = PORT_FILES + [ROOT / "chip_smoke.py"]
C_SOURCES = sorted(p for ext in ("*.c", "*.h", "*.cu", "*.cuh")
                   for p in (ROOT / "paddle_tpu_torch").rglob(ext))


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


def jax_package_names(text: str):
    """Every JAX-package module a C source names: ``paddle_tpu.`` not
    followed by ``_torch``, or a ``jax`` module in a string."""
    return re.findall(r"\bpaddle_tpu\.[\w.]*|\"jax(?:lib)?[\".][\w.]*",
                      text)


def test_port_has_c_sources_to_check():
    names = {p.name for p in C_SOURCES}
    assert {"pd_inference.c", "pd_inference.h", "capi_demo.c",
            "capi_train_demo.c", "flash_fwd.cu"} <= names


@pytest.mark.parametrize("path", C_SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in C_SOURCES])
def test_c_sources_name_no_jax_package_module(path):
    bad = jax_package_names(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


@pytest.mark.parametrize("text,bad", [
    ('PyImport_ImportModule("paddle_tpu.inference.capi_bridge");', True),
    ('PyImport_ImportModule("jax.numpy");', True),
    ('PyImport_ImportModule("paddle_tpu_torch.inference.capi_bridge");',
     False),
    ("/* Replaces: paddle_tpu/ops/flash_attention.py:72 */", False),
], ids=["jax-package", "jax", "port", "replaces-comment"])
def test_c_source_check_catches_planted_names(text, bad):
    assert bool(jax_package_names(text)) == bad


def test_no_port_file_names_torch_compile():
    for path in PORT_FILES + C_SOURCES:
        assert "torch.compile" not in path.read_text(), \
            f"{path.relative_to(ROOT)} names torch.compile"


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


# the training-step slice's modules, each loaded alone
NEW_MODULES = ["paddle_tpu_torch.core.flags", "paddle_tpu_torch.testing.faults",
               "paddle_tpu_torch.amp", "paddle_tpu_torch.amp.grad_scaler",
               "paddle_tpu_torch.distributed.checkpoint",
               "paddle_tpu_torch.distributed.resilience",
               # the serving fleet's
               "paddle_tpu_torch.inference.router",
               "paddle_tpu_torch.inference.disagg",
               "paddle_tpu_torch.inference.loadgen",
               # the DataLoader workers' and the detection ops'
               "paddle_tpu_torch.io.shm_ring",
               "paddle_tpu_torch.io.dataloader",
               "paddle_tpu_torch.vision.ops",
               # the program path's
               "paddle_tpu_torch.func", "paddle_tpu_torch.extension",
               "paddle_tpu_torch.jit.api", "paddle_tpu_torch.static.program",
               "paddle_tpu_torch.inference.capi_bridge",
               "paddle_tpu_torch.onnx"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_alone_loads_no_jax(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = ROOT / module.replace(".", "/") / "__init__.py"
    assert not [m for m in imported_modules(path) if _forbidden(m)]
    code = ("import sys, importlib; before = set(sys.modules); "
            f"importlib.import_module({module!r}); "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _bound_modules(tree):
    """``{name: dotted module}`` for every name an absolute import or a
    plain ``name = a.b.c`` assignment binds to a module path."""
    bound = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    bound[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    bound[top] = top
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for alias in node.names:
                bound[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            path = _dotted(node.value, bound)
            if path is not None and path.split(".")[0] == "torch":
                bound[node.targets[0].id] = path
    return bound


def _dotted(node, bound):
    """The dotted path of a ``Name.attr.attr`` chain, its head resolved
    through ``bound``; None for anything else."""
    attrs = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    head = bound.get(node.id, node.id)
    return ".".join([head] + attrs[::-1])


_SDPA = "scaled_dot_product"


def _torch_path(path):
    return path is not None and path.split(".")[0] == "torch"


def library_attention_uses(source: str):
    """Every use of torch's SDPA in ``source``: any attribute chain
    rooted at ``torch`` (under any alias of torch or of one of its
    modules) that names ``scaled_dot_product*``, such as
    ``torch.nn.functional.scaled_dot_product_attention``,
    ``torch.ops.aten.(_)scaled_dot_product*`` or
    ``torch._C._nn.scaled_dot_product_attention``; such an attribute of
    anything that is not a plain name chain (``import_module(...).x``);
    such a name imported from a torch module, or ``*`` imported from
    one; and ``getattr`` with a ``scaled_dot_product*`` string.
    Paddle's own ``nn.functional.scaled_dot_product_attention`` (a
    relative import in the port) is not torch's."""
    tree = ast.parse(source)
    bound = _bound_modules(tree)
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 and \
                _torch_path(node.module) and any(
                    _SDPA in a.name or a.name == "*" for a in node.names):
            hits.append((node.lineno, f"from {node.module} import"))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "getattr" and any(
                    isinstance(a, ast.Constant) and isinstance(a.value, str)
                    and _SDPA in a.value for a in node.args[1:2]):
            hits.append((node.lineno, "getattr"))
        elif isinstance(node, ast.Attribute) and _SDPA in node.attr:
            path = _dotted(node, bound)
            if path is None or _torch_path(path):
                hits.append((node.lineno, path or node.attr))
        elif isinstance(node, ast.Name) and _SDPA in bound.get(node.id, "") \
                and _torch_path(bound[node.id]):
            hits.append((node.lineno, bound[node.id]))
    return hits


def test_card_path_names_no_library_attention_or_compile():
    for path in PORT_FILES:
        text = path.read_text()
        assert "torch.compile" not in text, \
            f"{path.relative_to(ROOT)} names torch.compile"
        hits = library_attention_uses(text)
        assert not hits, f"{path.relative_to(ROOT)} uses torch's SDPA: {hits}"


@pytest.mark.parametrize("source", [
    "import torch\ny = torch.nn.functional.scaled_dot_product_attention(q, k, v)\n",
    "import torch\nimport torch.nn.functional as F\n"
    "y = F.scaled_dot_product_attention(q, k, v)\n",
    "from torch.nn import functional as F\n"
    "y = F.scaled_dot_product_attention(q, k, v)\n",
    "import torch\nF = torch.nn.functional\n"
    "y = F.scaled_dot_product_attention(q, k, v)\n",
    "from torch.nn.functional import scaled_dot_product_attention\n",
    "from torch.nn.functional import scaled_dot_product_attention as a\n",
    "import torch\ny = torch.ops.aten._scaled_dot_product_flash_attention("
    "q, k, v)\n",
    "import torch as th\n"
    "y = th.ops.aten._scaled_dot_product_efficient_attention(q, k, v)\n",
    "import torch\ny = torch.ops.aten.scaled_dot_product_attention(q, k, v)\n",
    "import torch\ny = torch._C._nn.scaled_dot_product_attention(q, k, v)\n",
    "from torch._C import _nn\ny = _nn.scaled_dot_product_attention(q, k, v)\n",
    "from torch._C._nn import scaled_dot_product_attention\n",
    "import torch.nn.functional as F\n"
    "y = getattr(F, \"scaled_dot_product_attention\")(q, k, v)\n",
    "import importlib\ny = importlib.import_module(\"torch.nn.functional\")"
    ".scaled_dot_product_attention(q, k, v)\n",
    "from torch.nn.functional import *\n"
    "y = scaled_dot_product_attention(q, k, v)\n",
], ids=["torch.nn.functional", "import-as-F", "from-torch.nn-import",
        "F-assigned", "from-import", "from-import-as", "aten-flash",
        "aten-efficient-aliased-torch", "aten-public", "torch._C._nn",
        "_nn-imported", "from-torch._C._nn-import", "getattr-string",
        "import_module-attribute", "star-import"])
def test_library_attention_check_catches_planted_uses(source):
    assert library_attention_uses(source)


def test_library_attention_check_passes_paddle_sdpa():
    source = ("from .. import functional as F\n"
              "from .attention import scaled_dot_product_attention\n"
              "y = F.scaled_dot_product_attention(q, k, v)\n"
              "z = scaled_dot_product_attention(q, k, v)\n")
    assert not library_attention_uses(source)


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
