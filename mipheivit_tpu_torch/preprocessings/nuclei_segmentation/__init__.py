"""Whole-slide nucleus segmentation (the port's copies of
``preprocessings/nuclei_segmentation``): ``wsi_nuclei_inference`` on DAPI
(classical watershed, Cellpose flows through ``models.cellpose_net`` on the
card with ``--backend torch``, flow averaging), ``he_nuclei_inference`` on
H&E (the haematoxylin channel on the card, or HoverFast polygons)."""
