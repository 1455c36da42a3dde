"""Host spans around calls into the program's layers, from the outside.

:class:`Spans` wraps methods on an instance (the program's own code is
untouched): while ``on``, each call is timed on ``time.monotonic()`` and
kept as ``(start, end)`` by name. ``close`` puts the methods back.
"""

import collections
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class Spans:
    def __init__(self):
        self.on = False
        self.calls: Dict[str, List[Tuple[float, float]]] = (
            collections.defaultdict(list))
        self._lock = threading.Lock()
        self._wrapped: List[Tuple[object, str]] = []

    def wrap(self, obj, method: str, name: Optional[str] = None,
             before: Optional[Callable] = None) -> None:
        """Time ``obj.method``; ``before(*args)`` runs first while on."""
        fn = getattr(obj, method)
        name = name or method

        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            if before is not None:
                before(*args, **kwargs)
            t0 = time.monotonic()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.monotonic()
                with self._lock:
                    self.calls[name].append((t0, t1))

        setattr(obj, method, timed)
        self._wrapped.append((obj, method))

    def within(self, name: str, lo: float, hi: float
               ) -> List[Tuple[float, float]]:
        """The calls of ``name`` that started in [lo, hi)."""
        with self._lock:
            return [c for c in self.calls[name] if lo <= c[0] < hi]

    def all(self) -> List[Tuple[float, float, str]]:
        """Every call kept, as ``(start, end, name)``."""
        with self._lock:
            return [(a, b, name) for name, calls in self.calls.items()
                    for a, b in calls]

    def close(self) -> None:
        self.on = False
        for obj, method in self._wrapped:
            delattr(obj, method)
        self._wrapped = []
