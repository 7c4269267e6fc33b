"""H&E <-> mIF slide registration (the port's copy of
``preprocessings/registration``): ``python -m
mipheivit_tpu_torch.preprocessings.registration.registration``."""
