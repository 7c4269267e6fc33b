"""The preprocessing that makes the data the port trains and evaluates on,
on PyTorch: Cellpose nuclei segmentation of DAPI slides and H&E nuclei
segmentation (``nuclei_segmentation``), the CycleGAN stain normaliser
(``cycle_gan``), and the data preparation: registration
(``registration``), AF cleaning (``mif_cleaning``, its two passes on the
card), tiling and tile export (``tiling``, ``wsi2tiles``), channel stats
(``get_mean_std_channels``), the expression matrix
(``single_cell_analysis``, on the card), artifact shares
(``artifacts_detection``) and OME-TIFF conversion (``convert_to_ometiff``).
The scripts run as ``python -m mipheivit_tpu_torch.preprocessings.<path>``."""
