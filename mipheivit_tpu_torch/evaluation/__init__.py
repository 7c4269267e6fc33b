"""The paper's single-cell evaluations on PyTorch: ORION (``eval_orion``),
IMMUCAN (``eval_immucan``) and HEMIT (``eval_hemit``), each run as
``python -m mipheivit_tpu_torch.evaluation.<name> --checkpoint_dir D``."""
