"""Paged KV block allocator (port of
``deepspeed_tpu/inference/v2/blocked_allocator.py``, same logic).

A free-list over a fixed pool of KV blocks. Host-side only — block ids
flow into device block tables; the cache itself never moves. A double
free is detected exactly (set membership). ``num_homes`` > 1 keeps one
free list per home (block ``b`` lives on home ``b % num_homes``); at the
default of 1 the pop order is 0, 1, 2, ...
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set


class OutOfBlocksError(RuntimeError):
    pass


class BlockedAllocator:
    def __init__(self, num_blocks: int, num_homes: int = 1):
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        if num_homes < 1:
            raise ValueError(f"num_homes must be >= 1, got {num_homes}")
        if num_blocks % num_homes:
            raise ValueError(
                f"num_blocks ({num_blocks}) must divide by num_homes "
                f"({num_homes}) — the pool shards round-robin by block id")
        self._num_blocks = num_blocks
        self._num_homes = num_homes
        # per-home LIFO free lists, each popping in ascending order
        self._free: List[List[int]] = [
            list(range(num_blocks - num_homes + h, -1, -num_homes))
            for h in range(num_homes)]
        self._free_set: Set[int] = set(range(num_blocks))

    @property
    def num_blocks(self) -> int:
        return self._num_blocks

    @property
    def num_homes(self) -> int:
        return self._num_homes

    @property
    def free_blocks(self) -> int:
        return len(self._free_set)

    def free_in_home(self, home: int) -> int:
        return len(self._free[home])

    def free_list(self) -> List[int]:
        """Flat snapshot of every free block id across all homes."""
        return [b for home in self._free for b in home]

    def home_of(self, block: int) -> int:
        return block % self._num_homes

    def is_free(self, block: int) -> bool:
        return block in self._free_set

    def can_allocate(self, homes: Sequence[int]) -> bool:
        """True when one block per requested home is available."""
        return not any(self.shortfall(homes))

    def shortfall(self, homes: Sequence[int]) -> List[int]:
        """Per-home deficit for a prospective ``allocate(homes=...)``."""
        need = [0] * self._num_homes
        for h in homes:
            need[h] += 1
        return [max(0, need[h] - len(self._free[h]))
                for h in range(self._num_homes)]

    def allocate(self, n: int,
                 homes: Optional[Sequence[int]] = None) -> List[int]:
        """Allocate ``n`` blocks. With ``homes`` (one home id per block)
        block ``i`` comes from home ``homes[i]``; without, blocks come
        from the fullest homes first."""
        if homes is not None:
            if len(homes) != n:
                raise ValueError(
                    f"homes has {len(homes)} entries for n={n}")
            deficit = self.shortfall(homes)
            if any(deficit):
                raise OutOfBlocksError(
                    f"requested {n} blocks with per-home deficit "
                    f"{deficit} (free={[len(f) for f in self._free]})")
            out = [self._free[h].pop() for h in homes]
        else:
            if n > len(self._free_set):
                raise OutOfBlocksError(
                    f"requested {n} blocks, only {len(self._free_set)} "
                    f"free")
            if self._num_homes == 1:
                free = self._free[0]
                out = [free.pop() for _ in range(n)]
            else:
                out = []
                for _ in range(n):
                    h = max(range(self._num_homes),
                            key=lambda i: len(self._free[i]))
                    out.append(self._free[h].pop())
        self._free_set.difference_update(out)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        incoming: Set[int] = set()
        for b in blocks:
            if not 0 <= b < self._num_blocks:
                raise ValueError(f"block id {b} out of range")
            if b in self._free_set or b in incoming:
                raise RuntimeError(f"double free of block {b}")
            incoming.add(b)
        for b in blocks:
            self._free[b % self._num_homes].append(b)
        self._free_set.update(incoming)
