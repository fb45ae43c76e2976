"""Fiber: the type signature of an SE(3)-equivariant feature space.

A fiber is an ordered set of (degree, multiplicity) pairs describing a
feature dict {str(degree): [..., multiplicity, 2*degree+1]}. A frozen,
hashable dataclass; the port's copy of se3_transformer_tpu/ops/fiber.py.
"""
from __future__ import annotations

import dataclasses
from itertools import product
from typing import Mapping, Sequence, Tuple, Union

FiberEl = Tuple[int, int]  # (degree, dim)


@dataclasses.dataclass(frozen=True)
class Fiber:
    structure: Tuple[FiberEl, ...]

    def __init__(self, structure: Union[Mapping[int, int], Sequence]):
        if isinstance(structure, Mapping):
            structure = [(int(d), int(m)) for d, m in structure.items()]
        structure = tuple((int(d), int(m)) for d, m in structure)
        object.__setattr__(self, 'structure', structure)

    @property
    def dims(self):
        return list({m: None for _, m in self.structure}.keys())

    @property
    def degrees(self):
        return [d for d, _ in self.structure]

    @staticmethod
    def create(num_degrees: int, dim: Union[int, Tuple[int, ...]]) -> 'Fiber':
        dims = dim if isinstance(dim, tuple) else (dim,) * num_degrees
        return Fiber(list(zip(range(num_degrees), dims)))

    def __getitem__(self, degree: int) -> int:
        return dict(self.structure)[degree]

    def __contains__(self, degree: int) -> bool:
        return degree in dict(self.structure)

    def __iter__(self):
        return iter(self.structure)

    def __mul__(self, other: 'Fiber'):
        """All (in, out) element pairs."""
        return product(self.structure, other.structure)

    def __and__(self, other: 'Fiber'):
        """Degrees present in both: [(degree, dim_self, dim_other), ...]."""
        out = []
        for degree, dim in self:
            if degree in other:
                out.append((degree, dim, other[degree]))
        return out

    def scale(self, mult: int) -> 'Fiber':
        return Fiber([(d, m * mult) for d, m in self.structure])

    def to(self, dim: int) -> 'Fiber':
        """Same degrees, constant multiplicity `dim`."""
        return Fiber([(d, dim) for d, _ in self.structure])


def fiber_of(features) -> Fiber:
    """The Fiber of a feature dict {str(degree): [..., channels, 2d+1]}."""
    return Fiber({int(k): v.shape[-2] for k, v in features.items()})
