"""Precision-mix rules: ordered regex-on-parameter-path -> storage
precision, the port of se3_transformer_tpu/quant/rules.py.

An ordered list of (regex, precision[, ndim]) rules is matched against a
parameter's '/'-joined flax path (convert.flax_path: `Dense_k.weight`
[out, in] is `Dense_k/kernel` [in, out]), first match wins, and a rule
with a rank guard matches only parameters of that rank. So a rule list
written for the JAX package selects the same weights here. The
precisions:

    'int8'      symmetric per-output-channel int8 (QuantTensor)
    'fp8_e4m3'  fp8 storage (QuantTensor)
    'bf16'      a bfloat16 cast (consumers upcast it exactly)
    'fp32'      passthrough

int8 and fp8 are for the invariant-input matmuls only: the degree-0
LinearSE3 mixers (`w0`), the radial weights (`w3`, grouped
`w3_{d_in}_{d_out}`, v2's `wm{m}_{d_in}_{d_out}`) and the radial trunk's
Dense kernels. Their inputs are rotation-invariant, so weight error moves
accuracy and not equivariance. A higher-degree mixer (`w1`, `w2`, ... and a
2-d `w3`) may go to bf16 at most: an int8 or fp8 rule that matches one
raises EquivariantPrecisionError.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple, Union

import torch
from torch import nn

from ..convert import flax_path
from .qtensor import QuantTensor, quantize

PRECISIONS = ('int8', 'fp8_e4m3', 'bf16', 'fp32')

PrecisionRule = Union[Tuple[str, str], Tuple[str, str, int]]
PrecisionRules = Sequence[PrecisionRule]
MixSpec = Union[str, PrecisionRules]

# the invariant-input weight classes int8/fp8 storage is safe for, each
# with the rank that identifies it (w0 [in, out]; w3 / w3_i_o [mid, IF,
# O]; wm{m}_i_o [mid, K, O]; the trunk's Dense kernels [in, out])
_W0_RE = r'(^|/)w0$'
_W3_RE = r'(^|/)w3(_\d+_\d+)?$'
_WM_RE = r'(^|/)wm\d+_\d+_\d+$'
_RADIAL_DENSE_RE = r'(^|/)Dense_[01]/kernel$'
_INT8_SAFE = ((_W0_RE, 2), (_W3_RE, 3), (_WM_RE, 3),
              (_RADIAL_DENSE_RE, 2))
# higher-degree LinearSE3 mixers: bf16 at most (also a 2-d `w3` mixer,
# once the rank guard has passed it by)
_WL_RE = r'(^|/)w[1-9]\d*$'


class EquivariantPrecisionError(ValueError):
    """An int8/fp8 rule matched a parameter outside the invariant-safe
    classes."""


def _mix_rules(low: str) -> PrecisionRules:
    return (
        (_W0_RE, low, 2),
        (_W3_RE, low, 3),
        (_WM_RE, low, 3),
        (_RADIAL_DENSE_RE, low, 2),
        (_WL_RE, 'bf16'),
        (r'.*', 'fp32'),
    )


# the shipped mixes; norms, biases, embeddings and null slots stay fp32
MIXES: Dict[str, PrecisionRules] = {
    'fp32': ((r'.*', 'fp32'),),
    'bf16': _mix_rules('bf16'),
    'int8_mix': _mix_rules('int8'),
    'fp8_mix': _mix_rules('fp8_e4m3'),
}


def resolve_mix(mix: MixSpec) -> PrecisionRules:
    """A mix by name or an explicit rule list, checked."""
    if isinstance(mix, str):
        if mix not in MIXES:
            raise KeyError(f'unknown precision mix {mix!r} '
                           f'(shipped: {sorted(MIXES)})')
        return MIXES[mix]
    rules = tuple(mix)
    for rule in rules:
        if rule[1] not in PRECISIONS:
            raise ValueError(f'rule ({rule[0]!r}, {rule[1]!r}): precision '
                             f'must be one of {PRECISIONS}')
    return rules


def mix_name(mix: MixSpec) -> str:
    return mix if isinstance(mix, str) else 'custom'


def resolve_precision(rules: PrecisionRules, path: str,
                      ndim: int = None) -> str:
    """First-match-wins precision of one parameter path ('fp32' tail); a
    rule with a rank guard matches only parameters of that rank."""
    for rule in rules:
        guard = rule[2] if len(rule) > 2 else None
        if guard is not None and ndim is not None and ndim != guard:
            continue
        if re.search(rule[0], path):
            return rule[1]
    return 'fp32'


def _replace(owner: nn.Module, name: str, value) -> None:
    """Put `value` (a QuantTensor, or a bf16 Parameter) where `owner`'s
    parameter `name` was."""
    del owner._parameters[name]
    setattr(owner, name, value)


def quantize_params(model: nn.Module, mix: MixSpec = 'int8_mix'):
    """Quantize `model`'s parameters in place by the mix's rules; returns
    (model, report).

    An int8/fp8 parameter becomes a QuantTensor with the JAX package's bits
    (contracted axis: the flax kernel's axis 0, i.e. a Dense weight's
    input axis), a bf16 one a bf16 Parameter; the others stay. The
    quantization reads each parameter on the host, and its results are CPU
    tensors: built on the CPU and then moved (InferenceEngine does this),
    the float32 weights never reach the device. `report` is the JAX
    quantize_params report: per-precision parameter counts, bytes before
    and after, and their ratio. Nothing changes when a rule is refused."""
    rules = resolve_mix(mix)
    counts = {p: 0 for p in PRECISIONS}
    bytes_before = bytes_after = 0
    offenders, plan = [], []
    for owner_name, owner in model.named_modules():
        for name, p in list(owner.named_parameters(recurse=False)):
            path, transposed = flax_path(owner_name, owner, name)
            nbytes = p.numel() * p.element_size()
            bytes_before += nbytes
            prec = resolve_precision(rules, path, ndim=p.ndim)
            counts[prec] += 1
            if prec == 'fp32':
                bytes_after += nbytes
            elif prec == 'bf16':
                bytes_after += p.numel() * 2
                plan.append((owner, name, nn.Parameter(
                    p.detach().to(torch.bfloat16))))
            elif not any(re.search(pat, path) and p.ndim == nd
                         for pat, nd in _INT8_SAFE):
                offenders.append((path, prec))
            else:
                w = p.detach().cpu()
                qt = quantize(w.t() if transposed else w, (0,), prec)
                bytes_after += qt.nbytes
                if transposed:
                    qt = QuantTensor(qt.q.t().contiguous(),
                                     qt.scale.t().contiguous())
                plan.append((owner, name, qt))
    if offenders:
        shown = ', '.join(f'{p} -> {prec}' for p, prec in offenders[:8])
        raise EquivariantPrecisionError(
            f'{len(offenders)} param(s) outside the invariant-safe weight '
            f'classes matched an int8/fp8 rule ({shown}'
            f'{" ..." if len(offenders) > 8 else ""}): higher-degree '
            f'kernels compound rotation error and may go bf16 at most')
    for owner, name, value in plan:
        _replace(owner, name, value)
    report = dict(
        mix=mix_name(mix),
        leaves={p: n for p, n in counts.items() if n},
        params_bytes_fp32=int(bytes_before),
        params_bytes_quantized=int(bytes_after),
        bytes_ratio=round(bytes_after / max(bytes_before, 1), 4),
    )
    return model, report


_STORAGES = {torch.int8: 'int8', torch.float8_e4m3fn: 'fp8_e4m3'}


def quantize_state(model: nn.Module, state) -> dict:
    """`state` (a state dict) in the form `model`, already quantized,
    holds: the float32 value of each of model's QuantTensors (key
    `<owner>.<name>`) quantized on the host at that QuantTensor's storage
    into `<owner>.<name>.q` and `.scale`, bit for bit as quantize_params
    makes them, and a float32 value where model holds bf16 cast to bf16.
    Entries already in model's form pass through. The weight-swap half of
    quantize_params: the engine re-quantizes a float32 state at its own
    mix."""
    state = dict(state)
    for owner_name, owner in model.named_modules():
        for name, qt in owner.named_children():
            key = f'{owner_name}.{name}' if owner_name else name
            if not isinstance(qt, QuantTensor) or key not in state:
                continue
            _, transposed = flax_path(owner_name, owner, name)
            w = state.pop(key).detach().cpu()
            new = quantize(w.t() if transposed else w, (0,),
                           _STORAGES[qt.q.dtype])
            if transposed:
                new = QuantTensor(new.q.t().contiguous(),
                                  new.scale.t().contiguous())
            state[f'{key}.q'], state[f'{key}.scale'] = new.q, new.scale
    for key, value in model.state_dict().items():
        given = state.get(key)
        if value.dtype == torch.bfloat16 and isinstance(given, torch.Tensor) \
                and given.dtype == torch.float32:
            state[key] = given.detach().to(torch.bfloat16)
    return state
