from .loading import cast_params, load_generator, merge_lora, to_fast_heads
from .tiles import inference_model, predict_tiles, predictions_to_uint8

__all__ = ["cast_params", "inference_model", "load_generator", "merge_lora",
           "predict_tiles", "predictions_to_uint8", "to_fast_heads"]
