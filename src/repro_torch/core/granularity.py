"""Adaptive pipeline-granularity configuration (paper Algorithm 1), a
copy of ``repro.core.granularity``.

The searcher maintains a set S of disjoint batch-size ranges R_n, each
mapped one-to-one to an optimal partition count n (monotonicity
hypothesis: optimal n is non-decreasing in B), plus a hash-table cache in
front. ``find``/``insert`` are O(log |S|) (bisect over sorted ranges — the
paper's binary search tree).

``measure_fn(B, n) -> seconds`` is injected: wall-clock timing of a few
candidate steps on the card, the analytic pipeline simulator
(``core.pipeline_sim``) otherwise.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class GranularitySearcher:
    def __init__(self, measure_fn: Callable[[int, int], float],
                 candidates: Sequence[int] = (1, 2, 4, 8, 16, 32)):
        self.measure_fn = measure_fn
        self.candidates = tuple(sorted(candidates))
        # sorted disjoint ranges: list of [lo, hi, n]
        self._ranges: List[List[int]] = []
        self._keys: List[int] = []       # lo of each range, kept sorted
        self._by_n: Dict[int, List[int]] = {}
        self._cache: Dict[int, int] = {}
        self.search_calls = 0            # instrumentation (tests/benches)

    # -- Algorithm 1, lines 6 / find(S, B) ------------------------------
    def _find(self, b: int) -> Tuple[Optional[List[int]], int]:
        i = bisect.bisect_right(self._keys, b) - 1
        if i >= 0 and self._ranges[i][0] <= b <= self._ranges[i][1]:
            return self._ranges[i], self._ranges[i][2]
        return None, -1

    def _find_by_n(self, n: int) -> Optional[List[int]]:
        return self._by_n.get(n)

    # -- Algorithm 1, line 8 / searchBestGran(B) ------------------------
    def _search_best(self, b: int) -> int:
        self.search_calls += 1
        feas = [n for n in self.candidates if b // n >= 1]
        costs = {n: self.measure_fn(b, n) for n in feas}
        return min(costs, key=costs.get)

    # -- Algorithm 1 main ------------------------------------------------
    def best_n(self, b: int) -> int:
        if b in self._cache:                       # lines 3-5
            return self._cache[b]
        rng, n = self._find(b)                     # line 6
        if n == -1:                                # lines 7-16
            n = self._search_best(b)
            rng = self._find_by_n(n)
            if rng is None:                        # lines 10-12
                self._insert([b, b, n])
            else:                                  # lines 13-14: merge
                rng[0] = min(rng[0], b)
                rng[1] = max(rng[1], b)
                self._repair(rng)
        self._cache[b] = n                         # line 17
        return n

    # -- internals -------------------------------------------------------
    def _insert(self, rng: List[int]) -> None:
        i = bisect.bisect_left(self._keys, rng[0])
        self._ranges.insert(i, rng)
        self._repair(rng)

    def _repair(self, rng: List[int]) -> None:
        """Keep ranges disjoint under the monotonicity hypothesis: a
        merged range may swallow neighbours measured with other n; shrink
        neighbours (their n stays valid at their remaining extremes)."""
        self._ranges.sort(key=lambda r: r[0])
        out: List[List[int]] = []
        for r in self._ranges:
            if out and r[0] <= out[-1][1]:
                if r[2] == out[-1][2]:
                    out[-1][1] = max(out[-1][1], r[1])
                elif r is rng:                     # new data wins overlap
                    out[-1][1] = r[0] - 1
                    if out[-1][0] > out[-1][1]:
                        out.pop()
                    out.append(r)
                else:
                    r[0] = out[-1][1] + 1
                    if r[0] <= r[1]:
                        out.append(r)
            else:
                out.append(r)
        self._ranges = out
        # reindex: _find bisects _keys; _find_by_n is a dict hit. Both
        # rebuilt only here (insert/merge path — tied to a real search),
        # never on the hot lookup path.
        self._keys = [r[0] for r in out]
        self._by_n = {r[2]: r for r in out}

    def reset(self) -> None:
        """Drop learned ranges + cache: measurements are presumed stale
        (periodic retune under workload drift, §III-C online setting)."""
        self._ranges = []
        self._keys = []
        self._by_n = {}
        self._cache = {}

    @property
    def ranges(self) -> Tuple[Tuple[int, int, int], ...]:
        return tuple((r[0], r[1], r[2]) for r in self._ranges)
