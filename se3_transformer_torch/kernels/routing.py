"""Shape routing: the decision, made before any launch, to send a call whose
widths a kernel is not built for to that kernel's plain version.

Each kernel module exports its fits predicate, a function of widths,
dtypes and configuration alone: `pairwise.pairwise_limit` (#1-#4),
`attention.attention_limit` (#5/#6), `flash.flash_limit` (#7) and
`flash.global_limit` (7g). It returns None when the built kernel takes the
call, else the limit the call exceeds; the wrappers' checks raise that
same limit. A caller given a CUDA tensor past a limit asks `route`, which
counts the call in the wrapper's `.routed` and warns once per (kernel,
shape), as the JAX package warns when it takes XLA past a kernel's
limits; the caller then runs the kernel's plain version under autograd.
Tensors on any other device take the plain versions in the wrappers.
"""
from __future__ import annotations

import warnings
from typing import Optional

_WARNED = set()


def route(wrapper, device_type: str, limit: Optional[str],
          shape: tuple) -> bool:
    """True when a call on a `device_type` tensor goes past `wrapper`'s
    kernel to its plain version: a 'cuda' device and a `limit` (not
    None). Counts each such call in `wrapper.routed` and warns once per
    (kernel, shape)."""
    if device_type != 'cuda' or limit is None:
        return False
    wrapper.routed += 1
    key = (wrapper.__name__, tuple(shape))
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(f'{wrapper.__name__} kernel: {limit} (shape '
                      f'{tuple(shape)}); using the plain path', stacklevel=2)
    return True
