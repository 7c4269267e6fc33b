"""The PyTorch port imports without JAX and keeps the JAX package, YAML and
the native slide IO off its chip path."""

import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "mipheivit_tpu_torch"

CHIP_PATH = [
    "mipheivit_tpu_torch",
    "mipheivit_tpu_torch._build",
    "mipheivit_tpu_torch.ops.attention",
    "mipheivit_tpu_torch.ops.resize",
    "mipheivit_tpu_torch.models",
    "mipheivit_tpu_torch.models.vit",
    "mipheivit_tpu_torch.models.foundation",
    "mipheivit_tpu_torch.models.mipheivit",
    "mipheivit_tpu_torch.models.convert",
    "mipheivit_tpu_torch.io.safetensors",
    "mipheivit_tpu_torch.infer",
    "mipheivit_tpu_torch.infer.loading",
    "mipheivit_tpu_torch.infer.tiles",
]


def test_chip_path_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"       # any import of jax now raises
        f"for name in {CHIP_PATH!r}:\n"
        "    importlib.import_module(name)\n"
        "import mipheivit_tpu_torch.run_inference\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml',\n"
        "                                     'safetensors', 'mipheivit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_package_sources_never_name_jax_or_library_attention():
    files = [p for p in sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
             if "build" not in p.relative_to(PKG).parts]      # build/: generated
    assert files
    for path in files:
        text = path.read_text()
        for banned in ("import jax", "from jax", "scaled_dot_product_attention",
                       "torch.compile(", "cudnn_attention", "flash_attn"):
            assert banned not in text, (path, banned)
