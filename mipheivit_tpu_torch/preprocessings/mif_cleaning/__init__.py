"""mIF cleaning (the port's copy of ``preprocessings/mif_cleaning``):
``tune_af_settings`` sweeps the autofluorescence lambdas on the host,
``mif_cleaning`` subtracts them and quantises the slide to uint8 on the
card."""
