"""The PyTorch port imports without JAX and keeps the JAX package, YAML and
the native slide IO off its chip path."""

import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent / "mipheivit_tpu_torch"

CHIP_PATH = [
    "mipheivit_tpu_torch",
    "mipheivit_tpu_torch._build",
    "mipheivit_tpu_torch.ops",
    "mipheivit_tpu_torch.ops.attention",
    "mipheivit_tpu_torch.ops.attn_block",
    "mipheivit_tpu_torch.ops.mlp",
    "mipheivit_tpu_torch.ops.seg_heads",
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
    "mipheivit_tpu_torch.infer.stitch",
    "mipheivit_tpu_torch.infer.wsi",
    "mipheivit_tpu_torch.infer.serve",
    "mipheivit_tpu_torch.config",
    "mipheivit_tpu_torch.data.stats",
    "mipheivit_tpu_torch.slideio",
]


def test_chip_path_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"       # any import of jax now raises
        f"for name in {CHIP_PATH!r}:\n"
        "    importlib.import_module(name)\n"
        "import mipheivit_tpu_torch.run_inference\n"
        "import mipheivit_tpu_torch.run_serve\n"
        "from mipheivit_tpu_torch.ops.attention import flash_attention, flash_reference\n"
        "from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml', 'cv2',\n"
        "                                     'safetensors', 'mipheivit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_wsi_on_arrays_runs_without_jax_or_slide_io():
    """The chip path of stitched inference (an in-memory slide, an array
    sink) runs end to end with jax unimportable and never loads the JAX
    package's slide IO (native code, cv2)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference\n"
        "from mipheivit_tpu_torch.infer.tiles import HOPTIMUS_HE\n"
        "from mipheivit_tpu_torch.models import MipheiViT, ViTConfig\n"
        "torch.set_num_threads(2)\n"
        "model = MipheiViT(ViTConfig(img_size=(32, 32), patch_size=4, embed_dim=128, depth=1,\n"
        "                            num_heads=2, mlp_hidden_dim=256), 2).eval()\n"
        "image = np.random.default_rng(0).integers(0, 256, (40, 50, 3), dtype=np.uint8)\n"
        "out = np.zeros((2, 40, 50), np.uint8)\n"
        "wsi_inference(model, ArraySlide(image), out, ['a', 'b'], HOPTIMUS_HE,\n"
        "              tile_size=32, overlap=8, batch_size=2, tissue_only=False)\n"
        "assert out.any()\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'cv2', 'yaml', 'mipheivit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_modules(path: Path):
    """Every module an ``import`` or ``from ... import`` statement of the
    file names, at any depth (lazy imports inside functions included)."""
    import ast

    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or any
    ``mipheivit_tpu`` module (the port keeps its own copies of the host
    modules it needs). Relative imports stay inside the port."""
    files = [p for p in sorted(PKG.rglob("*.py"))
             if "build" not in p.relative_to(PKG).parts]
    files.append(PKG.parent / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "mipheivit_tpu"):
                bad.append((str(path.relative_to(PKG.parent)), name))
    assert not bad, bad


def test_package_sources_never_name_jax_or_library_attention():
    files = [p for p in sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
             if "build" not in p.relative_to(PKG).parts]      # build/: generated
    assert files
    for path in files:
        text = path.read_text()
        for banned in ("import jax", "from jax", "scaled_dot_product_attention",
                       "torch.compile(", "cudnn_attention", "flash_attn"):
            assert banned not in text, (path, banned)
