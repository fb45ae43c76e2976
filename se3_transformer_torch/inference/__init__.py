from .engine import InferenceEngine, pad_to_bucket
