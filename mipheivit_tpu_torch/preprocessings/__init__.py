"""The preprocessing that makes the data the port trains and evaluates on,
on PyTorch: Cellpose nuclei segmentation of DAPI slides and H&E nuclei
segmentation (``nuclei_segmentation``), and the CycleGAN stain normaliser
(``cycle_gan``). The scripts run as ``python -m
mipheivit_tpu_torch.preprocessings.<package>.<script>``."""
