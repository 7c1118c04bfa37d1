"""Declarative public-input layouts (reference: mp2-common/src/
public_inputs.rs:11-43 — each circuit family declares named ranges over its
PI vector and registers with a length check).

A jax-free copy of `mp2_tpu/circuit/public_inputs.py`: only the imports
change."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class PublicInputRange:
    name: str
    start: int
    end: int  # exclusive

    @property
    def length(self):
        return self.end - self.start


class PublicInputLayout:
    """Build named ranges once; slice PI vectors / target lists by name."""

    def __init__(self, fields: Sequence[Tuple[str, int]]):
        self.ranges: Dict[str, PublicInputRange] = {}
        pos = 0
        for name, length in fields:
            self.ranges[name] = PublicInputRange(name, pos, pos + length)
            pos += length
        self.total_len = pos

    def slice(self, pis: Sequence, name: str) -> List:
        r = self.ranges[name]
        assert len(pis) == self.total_len, (
            f"PI length {len(pis)} != layout {self.total_len}"
        )
        return list(pis[r.start : r.end])

    def build(self, **parts) -> List:
        """Assemble a PI vector from named parts (with length checks)."""
        out: List = []
        pos = 0
        for name, r in self.ranges.items():
            part = list(parts[name])
            assert len(part) == r.length, (
                f"{name}: got {len(part)} values, layout wants {r.length}"
            )
            out.extend(part)
        return out


# canonical layouts used by the tree-node circuits (tp2_backend)
CELLS_NODE_LAYOUT = PublicInputLayout(
    [("h", 4), ("id", 1), ("value", 8), ("lh", 4), ("rh", 4)]
)
TREE_NODE_LAYOUT = PublicInputLayout(
    [
        ("h", 4), ("id", 1), ("value", 8), ("min", 8), ("max", 8),
        ("lh", 4), ("rh", 4), ("inner", 4),
    ]
)
