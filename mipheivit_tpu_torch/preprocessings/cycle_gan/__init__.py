"""The CycleGAN stain normaliser (the port's copies of
``preprocessings/cycle_gan``): the generator, and its runs over tiles
(``normalize_tiles``) and over a whole slide
(``cycle_gan_wsi_inference``)."""
