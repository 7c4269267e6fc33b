"""The PyTorch port imports without JAX and keeps the JAX package, YAML and
the native slide IO off its chip path; its training driver runs without
JAX, pandas, cv2, PyYAML and scikit-learn."""

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
    "mipheivit_tpu_torch.ops.segment_pool",
    "mipheivit_tpu_torch.models",
    "mipheivit_tpu_torch.models.vit",
    "mipheivit_tpu_torch.models.foundation",
    "mipheivit_tpu_torch.models.mipheivit",
    "mipheivit_tpu_torch.models.layers",
    "mipheivit_tpu_torch.models.cnn",
    "mipheivit_tpu_torch.models.unetr",
    "mipheivit_tpu_torch.models.smp_unet",
    "mipheivit_tpu_torch.models.convert",
    "mipheivit_tpu_torch.models.swin",
    "mipheivit_tpu_torch.models.hemit",
    "mipheivit_tpu_torch.models.hemit_hybrid",
    "mipheivit_tpu_torch.models.import_hemit",
    "mipheivit_tpu_torch.io.safetensors",
    "mipheivit_tpu_torch.infer",
    "mipheivit_tpu_torch.infer.loading",
    "mipheivit_tpu_torch.infer.tiles",
    "mipheivit_tpu_torch.infer.stitch",
    "mipheivit_tpu_torch.infer.wsi",
    "mipheivit_tpu_torch.infer.serve",
    "mipheivit_tpu_torch.config",
    "mipheivit_tpu_torch.data.stats",
    "mipheivit_tpu_torch.data.table",
    "mipheivit_tpu_torch.data.augment",
    "mipheivit_tpu_torch.data.sampler",
    "mipheivit_tpu_torch.data.dataset",
    "mipheivit_tpu_torch.data.pipeline",
    "mipheivit_tpu_torch.ops.hed",
    "mipheivit_tpu_torch.utils",
    "mipheivit_tpu_torch.metrics",
    "mipheivit_tpu_torch.metrics.cell",
    "mipheivit_tpu_torch.metrics._gating",
    "mipheivit_tpu_torch.train",
    "mipheivit_tpu_torch.train.cell_loss",
    "mipheivit_tpu_torch.train.trainer",
    "mipheivit_tpu_torch.train.test_driver",
    "mipheivit_tpu_torch.evaluation.common",
    "mipheivit_tpu_torch.evaluation.eval_orion",
    "mipheivit_tpu_torch.evaluation.eval_immucan",
    "mipheivit_tpu_torch.evaluation.eval_hemit",
    "mipheivit_tpu_torch.evaluation.eval_orion_hemit_pipeline",
    "mipheivit_tpu_torch.evaluation.eval_immucan_hemit_pipeline",
    "mipheivit_tpu_torch.evaluation.eval_hemit_hemit_pipeline",
    "mipheivit_tpu_torch.hemit.train_hemit",
    "mipheivit_tpu_torch.slideio",
    "mipheivit_tpu_torch.parallel",
    "mipheivit_tpu_torch.parallel.mesh",
    "mipheivit_tpu_torch.parallel.seq",
    "mipheivit_tpu_torch.parallel.spawn",
    "mipheivit_tpu_torch.parallel.workers",
    "mipheivit_tpu_torch.parallel.dryrun",
    "mipheivit_tpu_torch.models.cellpose_net",
]

# the preprocessing scripts: cv2, scipy and pandas only inside their functions
PREPROCESSING = [
    "mipheivit_tpu_torch.preprocessings",
    "mipheivit_tpu_torch.preprocessings.nuclei_segmentation.flow_dynamics",
    "mipheivit_tpu_torch.preprocessings.nuclei_segmentation.backends",
    "mipheivit_tpu_torch.preprocessings.nuclei_segmentation.wsi_nuclei_inference",
    "mipheivit_tpu_torch.preprocessings.nuclei_segmentation.flow_wsi",
    "mipheivit_tpu_torch.preprocessings.nuclei_segmentation.he_nuclei_inference",
    "mipheivit_tpu_torch.preprocessings.cycle_gan.resnet_generator",
    "mipheivit_tpu_torch.preprocessings.cycle_gan.cycle_gan_wsi_inference",
    "mipheivit_tpu_torch.preprocessings.cycle_gan.normalize_tiles",
]

# the copies of the repo's data-preparation scripts that read and write
# slides: the port's slideio, data.table, io.safetensors; cv2 inside functions
PREP_SCRIPTS = [
    "mipheivit_tpu_torch.scripts.scale_slides",
    "mipheivit_tpu_torch.preprocessings.registration.registration",
    "mipheivit_tpu_torch.preprocessings.mif_cleaning.tune_af_settings",
    "mipheivit_tpu_torch.preprocessings.mif_cleaning.mif_cleaning",
    "mipheivit_tpu_torch.preprocessings.tiling",
    "mipheivit_tpu_torch.preprocessings.wsi2tiles",
    "mipheivit_tpu_torch.scripts.create_dataframe",
    "mipheivit_tpu_torch.preprocessings.get_mean_std_channels",
    "mipheivit_tpu_torch.scripts.extract_std",
    "mipheivit_tpu_torch.preprocessings.single_cell_analysis.extract_expression_matrix",
    "mipheivit_tpu_torch.preprocessings.artifacts_detection.extract_if_artifact_props",
    "mipheivit_tpu_torch.preprocessings.convert_to_ometiff",
    "mipheivit_tpu_torch.hemit.orion_to_hemit_layout",
    "mipheivit_tpu_torch.examples.visualize_dataset",
    "mipheivit_tpu_torch.scripts.ckpt_remove_foundation_model",
]
PREPROCESSING += PREP_SCRIPTS


# the copies of the repo's scripts that run a model: their CLIs' host
# libraries (cv2, matplotlib, the 2-D reducers) only inside their functions
CONSUMERS = [
    "mipheivit_tpu_torch.preprocessings.artifacts_detection.extract_embeddings",
    "mipheivit_tpu_torch.figures.datasets_umap",
    "mipheivit_tpu_torch.figures.prediction_panels",
    "mipheivit_tpu_torch.examples.roi_inference",
    "mipheivit_tpu_torch.scripts.inference_hemit",
]


def test_chip_path_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"       # any import of jax now raises
        f"for name in {CHIP_PATH!r}:\n"
        "    importlib.import_module(name)\n"
        "import mipheivit_tpu_torch.run_inference\n"
        "import mipheivit_tpu_torch.run_serve\n"
        "import mipheivit_tpu_torch.run\n"
        "import mipheivit_tpu_torch.run_test\n"
        "from mipheivit_tpu_torch.ops.attention import flash_attention, flash_reference\n"
        "from mipheivit_tpu_torch.infer import ArraySlide, wsi_inference\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'yaml', 'cv2',\n"
        "                                     'safetensors', 'mipheivit_tpu', 'pandas',\n"
        "                                     'sklearn'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_preprocessing_imports_without_jax_cv2_scipy_or_pandas():
    """The preprocessing modules import with jax, cv2, scipy and pandas
    unimportable (each is imported inside the functions that use it), and
    pull in nothing of the JAX package nor of the repo's
    ``preprocessings/`` scripts."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'cv2', 'scipy', 'pandas', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {PREPROCESSING!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'cv2', 'scipy', 'pandas', 'mipheivit_tpu',\n"
        "                                     'backends', 'flow_wsi', 'flow_dynamics',\n"
        "                                     'resnet_generator', 'preprocessings',\n"
        "                                     'registration', 'mif_cleaning', 'tiling',\n"
        "                                     'wsi2tiles', 'extract_expression_matrix'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_consumer_scripts_import_without_jax_cv2_pandas_or_matplotlib():
    """The five consumer scripts import with jax, cv2, pandas, matplotlib,
    scikit-learn and umap unimportable, and pull in nothing of the JAX
    package nor of the repo's scripts they copy."""
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'cv2', 'pandas', 'matplotlib', 'sklearn', 'umap', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {CONSUMERS!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'cv2', 'pandas', 'matplotlib', 'sklearn',\n"
        "                                     'mipheivit_tpu', 'backends', 'roi_inference',\n"
        "                                     'prediction_panels', 'datasets_umap',\n"
        "                                     'extract_embeddings', 'inference_hemit'))\n"
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


def test_trainer_runs_an_epoch_without_jax_pandas_cv2_yaml_or_sklearn():
    """The machine with the card may lack all five: the training driver
    imports, composes nothing from YAML (the flagship preset comes as a
    dict, as chip_smoke.py passes it), reads its CSVs, TIFF tiles, nuclei
    tiles and nuclei CSV, writes config.yaml, its snapshot, the PNG grid and
    model.safetensors, and runs one CPU epoch with the cell loss (MSE and
    clustering) and the val and test epochs with cell metrics, then
    ``test_model`` writes test_dataframe_cell.csv."""
    code = (
        "import sys, tempfile\n"
        "from pathlib import Path\n"
        "for name in ('jax', 'pandas', 'cv2', 'yaml', 'sklearn'):\n"
        "    sys.modules[name] = None\n"       # any import of these now raises
        "sys.path.insert(0, 'tests')\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import chip_smoke\n"
        "import torch_synthetic_run as syn\n"
        "import mipheivit_tpu_torch.infer.loading as loading\n"
        "from mipheivit_tpu_torch.config import Config\n"
        "from mipheivit_tpu_torch.train.trainer import train_patchgan\n"
        "loading.get_generator = syn.tiny_generator\n"
        "root = Path(tempfile.mkdtemp())\n"
        "values = syn.write_run(root, cells=True)\n"
        "values['model.checkpoint_path'] = str(syn.write_checkpoint(root))\n"
        "cfg = syn.configure(Config.create(chip_smoke.FLAGSHIP_PRESET), values, cells=True,\n"
        "                    train__epochs=1)\n"
        "out = train_patchgan(cfg, str(root / 'run'), use_wandb=False, device='cpu')\n"
        "assert (root / 'run' / 'status.txt').read_text() == 'finished'\n"
        "assert out['state'].step == 2 and (root / 'run' / 'model.safetensors').exists()\n"
        "line = out['history'][0]\n"
        "assert line['loss_cell'] > 0 and line['val_cell_auc'] == out['best']\n"
        "from mipheivit_tpu_torch.train.test_driver import test_model\n"
        "res = test_model(cfg, str(root / 'run'), 'run', device='cpu')\n"
        "assert 0 <= res['test_cell_auc'] <= 1\n"
        "assert (root / 'run' / 'test_dataframe_cell.csv').exists()\n"
        "assert (root / 'run' / 'config.yaml').read_text().startswith('data:')\n"
        "assert (root / 'run' / 'logs_img' / 'step1.png').exists()\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pandas', 'cv2',\n"
        "                                     'yaml', 'sklearn', 'mipheivit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


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
    """No module of the port, and not chip_smoke.py, imports jax, any
    ``mipheivit_tpu`` module or the repo's ``preprocessings`` scripts (the
    port keeps its own copies of the host modules it needs). Relative
    imports stay inside the port."""
    files = [p for p in sorted(PKG.rglob("*.py"))
             if "build" not in p.relative_to(PKG).parts]
    files.append(PKG.parent / "chip_smoke.py")
    assert len(files) > 20
    for name in PREP_SCRIPTS:
        assert PKG.parent / (name.replace(".", "/") + ".py") in files, name
    bad = []
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "mipheivit_tpu", "preprocessings"):
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


def test_prep_scripts_run_without_jax_or_pandas(tmp_path):
    """``ckpt_remove_foundation_model`` and ``mif_cleaning --device cpu``
    run end to end with jax, flax, optax and pandas unimportable, and load
    nothing of the JAX package."""
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'pandas'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from mipheivit_tpu_torch.io.safetensors import load_file, save_file\n"
        "from mipheivit_tpu_torch.slideio import TiffSlide, write_pyramid\n"
        "from mipheivit_tpu_torch.scripts import ckpt_remove_foundation_model as strip\n"
        "from mipheivit_tpu_torch.preprocessings.mif_cleaning import mif_cleaning\n"
        "root = Path(sys.argv[1])\n"
        "torch.save({'encoder.vit.blocks.0.mlp.fc1.weight': torch.ones(2, 2),\n"
        "            'encoder.vit.blocks.0.attn.qkv.lora_q.A': torch.ones(2, 1),\n"
        "            'decoder.conv.weight': torch.zeros(3)}, root / 'g.pth')\n"
        "strip.main(['--checkpoint', str(root / 'g.pth'), '--out', str(root / 'g.safetensors')])\n"
        "assert sorted(load_file(root / 'g.safetensors')) == [\n"
        "    'decoder.conv.weight', 'encoder.vit.blocks.0.attn.qkv.lora_q.A']\n"
        "rng = np.random.default_rng(0)\n"
        "mif = rng.integers(0, 5000, (3, 96, 128)).astype(np.uint16)\n"
        "mif[:, 20:70, 30:90] += 3000\n"
        "write_pyramid(str(root / 'mif.tiff'), mif, n_levels=1, tile_size=64, mpp=0.5)\n"
        "(root / 's.json').write_text(json.dumps({'1': {'lambda': 0.2, 'bias': 5.0}}))\n"
        "out = mif_cleaning.main(['--slide_path', str(root / 'mif.tiff'), '--out_path',\n"
        "                         str(root / 'o.tiff'), '--lambda_settings', str(root / 's.json'),\n"
        "                         '--channel_names', 'AF,a,b', '--tile_size', '32',\n"
        "                         '--device', 'cpu'])\n"
        "ts = TiffSlide(str(root / 'o.tiff'))\n"
        "assert ts.dtype == np.uint8 and ts.n_channels == 3 and (out['p99'] > 1).all()\n"
        "ts.close()\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'pandas',\n"
        "                                     'mipheivit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, cwd=PKG.parent, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
