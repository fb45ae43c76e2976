"""Post-training quantization for serving: the port of
se3_transformer_tpu/quant.

int8 (or fp8-e4m3) storage with per-output-channel float32 scales for the
invariant-input matmuls, bf16 at most for the higher-degree channel
mixers, chosen by first-match-wins (parameter-path regex, precision)
rules. The consumers fold the scale in after their contraction (LinearSE3,
the radial trunk's Dense layers, kernel #3's and kernel #7's scale
epilogues), so the float32 weights never reach the device:

    from se3_transformer_torch import quant
    model, report = quant.quantize_params(model, 'int8_mix')   # in place
    # or: the engine quantizes on the host, then places the module
    engine = InferenceEngine(model_on_cpu, precision='int8_mix')
"""
from .qtensor import (
    QuantTensor, concat_weights, dequantize, float_weight, is_quantized,
    quantize, weight_or_none,
)
from .rules import (
    MIXES, PRECISIONS, EquivariantPrecisionError, mix_name,
    quantize_params, quantize_state, resolve_mix, resolve_precision,
)

__all__ = [
    'MIXES', 'PRECISIONS', 'EquivariantPrecisionError', 'QuantTensor',
    'concat_weights', 'dequantize', 'float_weight', 'is_quantized',
    'mix_name', 'quantize', 'quantize_params', 'quantize_state',
    'resolve_mix', 'resolve_precision', 'weight_or_none',
]
