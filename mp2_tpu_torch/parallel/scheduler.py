"""Map-reduce proof scheduler: UpdateTree workplans -> batched device dispatch.

The UpdateTree is the dependency DAG; this scheduler drains it level by
level, groups ready items by circuit name, and hands each group to a batch
prover in ONE call (the map phase batches leaf witnesses; the reduce phase
batches same-arity aggregations).  In the port the batch prover is the
caller's function over `recursion/runtime.RecursionFramework`'s
`prove_leaves_batch` / `prove_aggregations_batch`, so every group is one
`prover/batch.prove_batch` call per stage on the card.

A jax-free copy of `MapReduceScheduler` and `ScheduleStats` from
`mp2_tpu/parallel/scheduler.py`: only the imports change.  The reference's
`BatchedPoseidonProver` (a JAX dispatch demo) is not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, List, Tuple

from mp2_tpu_torch.ryhope.updatetree import UpdatePlan

# items: list of (key, circuit_name, inputs); returns proofs aligned to items
BatchProveFn = Callable[[str, List[Tuple[Hashable, object]]], List[object]]


@dataclass
class ScheduleStats:
    levels: int = 0
    batches: int = 0
    items: int = 0
    max_batch: int = 0
    per_level_sizes: List[int] = field(default_factory=list)


class MapReduceScheduler:
    """Drains a workplan: at each step, all ready items are grouped by
    circuit shape and proved in one batched call per group."""

    def __init__(self, prove_batch: BatchProveFn):
        self.prove_batch = prove_batch

    def run(
        self,
        plan: UpdatePlan,
        classify: Callable[[Hashable], Tuple[str, object]],
    ) -> Tuple[Dict[Hashable, object], ScheduleStats]:
        """classify(key) -> (circuit_name, inputs)."""
        proofs: Dict[Hashable, object] = {}
        stats = ScheduleStats()
        while not plan.completed():
            batch = plan.next_ready()
            assert batch, "workplan deadlock"
            stats.levels += 1
            stats.per_level_sizes.append(len(batch))
            groups: Dict[str, List[Tuple[Hashable, object]]] = {}
            for key in batch:
                name, inputs = classify(key)
                groups.setdefault(name, []).append((key, inputs))
            for name, items in sorted(groups.items()):
                outs = self.prove_batch(name, items)
                assert len(outs) == len(items)
                stats.batches += 1
                stats.items += len(items)
                stats.max_batch = max(stats.max_batch, len(items))
                for (key, _), proof in zip(items, outs):
                    proofs[key] = proof
            for key in batch:
                plan.done(key)
        return proofs, stats
