"""Immutable generator contexts (the port's copy of
jepsen_tpu/generator/context.py).

A context tells generators what time it is, which threads exist, which are
free, and which process each thread is currently executing. Contexts are
persistent values: every mutation returns a new context.

Capability reference: jepsen/src/jepsen/generator/context.clj (IContext ops
context.clj:49-93, Context record 95-114, thread filters 300-360) and
generator/translation_table.clj. The reference uses Java BitSets and
Bifurcan maps; here thread sets are arbitrary-precision Python ints used
as bitsets (bit i set = thread index i present), which makes
intersection/filtering single `&` ops.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Iterable

NEMESIS = "nemesis"


class TranslationTable:
    """Interns thread names (ints 0..n-1 plus named threads like 'nemesis')
    to dense indices. Mirrors generator/translation_table.clj."""

    __slots__ = ("int_thread_count", "named_threads", "named_to_index")

    def __init__(self, int_thread_count: int, named_threads: Iterable[Any]):
        self.int_thread_count = int_thread_count
        self.named_threads = tuple(named_threads)
        self.named_to_index = {
            name: int_thread_count + i
            for i, name in enumerate(self.named_threads)
        }

    def thread_count(self) -> int:
        return self.int_thread_count + len(self.named_threads)

    def name_to_index(self, thread) -> int:
        if isinstance(thread, int):
            return thread
        return self.named_to_index[thread]

    def index_to_name(self, i: int):
        if i < self.int_thread_count:
            return i
        return self.named_threads[i - self.int_thread_count]

    def all_names(self):
        return list(range(self.int_thread_count)) + list(self.named_threads)


def _bits(indices: Iterable[int]) -> int:
    b = 0
    for i in indices:
        b |= 1 << i
    return b


def _iter_bits(bitset: int):
    i = 0
    while bitset:
        tz = (bitset & -bitset).bit_length() - 1
        yield tz
        bitset &= bitset - 1
        i += 1


def _popcount(bitset: int) -> int:
    return bitset.bit_count()


class Context:
    """Immutable context. See module docstring.

    Thread *names* are ints 0..concurrency-1 plus 'nemesis'; thread
    *indices* are dense ints from the translation table. Processes start
    equal to their thread names; crashed client threads move to process
    (process + int_thread_count) — mirrors with-next-process
    (context.clj:240-258).
    """

    __slots__ = ("time", "next_thread_index", "tt", "all_threads",
                 "free_threads", "thread_index_to_process",
                 "process_to_thread", "ext")

    def __init__(self, time, next_thread_index, tt, all_threads, free_threads,
                 thread_index_to_process, process_to_thread, ext=None):
        self.time = time
        self.next_thread_index = next_thread_index
        self.tt = tt
        self.all_threads = all_threads          # bitset of thread indices
        self.free_threads = free_threads        # bitset of thread indices
        self.thread_index_to_process = thread_index_to_process  # tuple
        self.process_to_thread = process_to_thread              # dict proc→thread name
        self.ext = ext or {}

    # -- construction -------------------------------------------------------

    @classmethod
    def for_test(cls, test: dict) -> "Context":
        """Fresh context: threads 0..concurrency-1 plus nemesis, all free,
        each executing itself (context.clj `context`, 262-296)."""
        concurrency = int(test.get("concurrency", 1))
        named = [NEMESIS]
        tt = TranslationTable(concurrency, named)
        n = tt.thread_count()
        all_bits = (1 << n) - 1
        names = tt.all_names()
        return cls(
            time=0,
            next_thread_index=0,
            tt=tt,
            all_threads=all_bits,
            free_threads=all_bits,
            thread_index_to_process=tuple(names),
            process_to_thread={name: name for name in names},
            # per-test scheduling RNG, only when the test asks for one:
            # two seeded tests in one process keep independent
            # deterministic schedules, while seedless tests keep using
            # the module fallback (which set_seed controls)
            ext=({"rng": random.Random(test["seed"])}
                 if test.get("seed") is not None else {}),
        )

    def _clone(self, **kw) -> "Context":
        return Context(
            kw.get("time", self.time),
            kw.get("next_thread_index", self.next_thread_index),
            self.tt,
            kw.get("all_threads", self.all_threads),
            kw.get("free_threads", self.free_threads),
            kw.get("thread_index_to_process", self.thread_index_to_process),
            kw.get("process_to_thread", self.process_to_thread),
            kw.get("ext", self.ext),
        )

    # -- map-ish ------------------------------------------------------------

    def with_time(self, time: int) -> "Context":
        return self._clone(time=time)

    def get(self, k, default=None):
        if k == "time":
            return self.time
        return self.ext.get(k, default)

    def assoc(self, k, v) -> "Context":
        if k == "time":
            return self.with_time(v)
        ext = dict(self.ext)
        ext[k] = v
        return self._clone(ext=ext)

    # -- IContext -----------------------------------------------------------

    def all_thread_names(self) -> list:
        return [self.tt.index_to_name(i) for i in _iter_bits(self.all_threads)]

    def all_thread_count(self) -> int:
        return _popcount(self.all_threads)

    def free_thread_count(self) -> int:
        return _popcount(self.free_threads)

    def free_thread_names(self) -> list:
        return [self.tt.index_to_name(i) for i in _iter_bits(self.free_threads)]

    def all_processes(self) -> list:
        return [self.thread_index_to_process[i]
                for i in _iter_bits(self.all_threads)]

    def free_processes(self) -> list:
        return [self.thread_index_to_process[i]
                for i in _iter_bits(self.free_threads)]

    def process_to_thread_name(self, process):
        return self.process_to_thread.get(process)

    def thread_to_process(self, thread):
        return self.thread_index_to_process[self.tt.name_to_index(thread)]

    def thread_free(self, thread) -> bool:
        return bool(self.free_threads >> self.tt.name_to_index(thread) & 1)

    def some_free_process(self):
        """A free process, rotating fairly from next_thread_index
        (context.clj:203-220)."""
        free = self.free_threads
        if free == 0:
            return None
        # Bits at or above next_thread_index:
        hi = free >> self.next_thread_index
        if hi:
            i = self.next_thread_index + ((hi & -hi).bit_length() - 1)
        else:
            i = (free & -free).bit_length() - 1
        return self.thread_index_to_process[i]

    def busy_thread(self, time, thread) -> "Context":
        """Marks thread busy at the given time, bumping the fairness
        rotation (context.clj:229-238)."""
        i = self.tt.name_to_index(thread)
        return self._clone(
            time=time,
            next_thread_index=(self.next_thread_index + 1)
            % self.tt.thread_count(),
            free_threads=self.free_threads & ~(1 << i),
        )

    def free_thread(self, time, thread) -> "Context":
        i = self.tt.name_to_index(thread)
        return self._clone(time=time, free_threads=self.free_threads | (1 << i))

    def with_next_process(self, thread) -> "Context":
        """Replaces the thread's process with a fresh one: integer process p
        becomes p + int_thread_count (context.clj:240-258)."""
        process = self.thread_to_process(thread)
        if isinstance(process, int):
            process2 = process + self.tt.int_thread_count
        else:
            process2 = process
        i = self.tt.name_to_index(thread)
        tip = list(self.thread_index_to_process)
        tip[i] = process2
        p2t = dict(self.process_to_thread)
        p2t.pop(process, None)
        p2t[process2] = thread
        return self._clone(thread_index_to_process=tuple(tip),
                           process_to_thread=p2t)


class AllBut:
    """Predicate matching every thread except one (context.clj:300-312)."""

    __slots__ = ("element",)

    def __init__(self, element):
        self.element = element

    def __call__(self, x):
        return None if x == self.element else x


def all_but(x) -> AllBut:
    return AllBut(x)


def truthy(x) -> bool:
    """Clojure truthiness: everything except None/False is truthy. Needed
    because thread name 0 must count as a match from predicates like
    AllBut that return the name itself."""
    return x is not None and x is not False


def make_thread_filter(pred: Callable, ctx: Context | None = None):
    """Precomputes a context-restriction function keeping only threads whose
    *name* satisfies pred (context.clj:322-360). Returns a fn ctx→ctx'."""
    if ctx is None:
        cache: dict = {}

        def lazy_filter(c: Context) -> Context:
            f = cache.get("f")
            if f is None:
                f = make_thread_filter(pred, c)
                cache["f"] = f
            return f(c)

        return lazy_filter

    mask = 0
    for i in _iter_bits(ctx.all_threads):
        if truthy(pred(ctx.tt.index_to_name(i))):
            mask |= 1 << i

    def by_bitset(c: Context) -> Context:
        return c._clone(all_threads=c.all_threads & mask,
                        free_threads=c.free_threads & mask)

    return by_bitset
