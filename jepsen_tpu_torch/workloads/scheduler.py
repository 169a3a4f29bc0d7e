"""Job-scheduler run-coverage workload: submit periodic jobs, read back
the record of actual runs, and verify every *required* target
invocation was satisfied by a distinct run within its epsilon window.

Capability reference: chronos/src/jepsen/chronos/checker.clj —
job->targets (30-47: targets due strictly before
read_time - epsilon - duration, each forgiving epsilon +
epsilon-forgiveness seconds of lateness), job-solution (117-189: a
constraint solution assigning each target a distinct run; the
reference solves it with the loco CP solver), solution (191-213:
group jobs/runs by name, every job must be satisfied) and
chronos.clj's add-job generator (194-215: intervals sized so targets
never overlap). The CP solver is replaced by greedy interval matching
(targets sorted by deadline take the earliest usable run), which is an
exact maximum matching for points-in-intervals — no solver dependency.

Shapes (times are unix-epoch seconds, floats):
  job: {"name": int, "start": t, "interval": s, "count": n,
        "epsilon": s, "duration": s}
  run: {"name": int, "start": t, "end": t|None}  (end None = began
        but never completed; incomplete runs satisfy nothing)
  {"f": "add-job", "value": job} -> ok when the scheduler accepted it
  {"f": "read", "value": None} -> ok with value
        {"time": t, "runs": [run...]}

The port's copy of jepsen_tpu/workloads/scheduler.py; a host checker. No
kernel runs.
"""

from __future__ import annotations

from .. import util

from .. import checker as chk
from .. import generator as gen

EPSILON_FORGIVENESS = 5.0  # chronos misses deadlines by a few seconds


def job_targets(read_time: float, job: dict) -> list:
    """[(start, deadline)] for every invocation that MUST have begun by
    the read (checker.clj job->targets): targets stop epsilon+duration
    before the read (later ones may legally still be pending), and each
    forgives epsilon + EPSILON_FORGIVENESS of start lateness."""
    finish = read_time - job["epsilon"] - job["duration"]
    out = []
    t = job["start"]
    for _ in range(int(job["count"])):
        if t >= finish:
            break
        out.append((t, t + job["epsilon"] + EPSILON_FORGIVENESS))
        t += job["interval"]
    return out


def match_targets(targets: list, run_starts: list) -> tuple:
    """Greedy maximum matching of run start-times to target intervals:
    targets in deadline order take the earliest unused run inside
    their window. Returns (assignment, unsatisfied) where assignment
    maps target index -> run index."""
    order = sorted(range(len(targets)), key=lambda i: targets[i][1])
    runs = sorted(range(len(run_starts)), key=lambda j: run_starts[j])
    used = [False] * len(run_starts)
    assignment: dict = {}
    unsatisfied = []
    for i in order:
        lo, hi = targets[i]
        hit = None
        for j in runs:
            if used[j]:
                continue
            s = run_starts[j]
            if s < lo:
                continue
            if s > hi:
                break
            hit = j
            break
        if hit is None:
            unsatisfied.append(i)
        else:
            used[hit] = True
            assignment[i] = hit
    return assignment, unsatisfied


def job_solution(read_time: float, job: dict, runs: list) -> dict:
    """checker.clj job-solution: split complete/incomplete runs, match
    complete runs to targets, report extras and misses."""
    complete = sorted((r for r in runs if r.get("end") is not None),
                      key=lambda r: r["start"])
    incomplete = sorted((r for r in runs if r.get("end") is None),
                        key=lambda r: r["start"])
    targets = job_targets(read_time, job)
    assignment, unsatisfied = match_targets(
        targets, [r["start"] for r in complete])
    solution = [{"target": targets[i], "run": complete[j]}
                for i, j in sorted(assignment.items())]
    extra = [r for j, r in enumerate(complete)
             if j not in set(assignment.values())]
    return {
        "valid?": not unsatisfied,
        "job": job,
        "solution": solution,
        "unsatisfied-targets": [targets[i] for i in unsatisfied],
        "extra": extra,
        "complete": complete,
        "incomplete": incomplete,
    }


def check_schedule(read_time: float, jobs: list, runs: list) -> dict:
    """checker.clj solution: group by job name; valid iff every job's
    targets are all satisfied by distinct runs."""
    runs_by = {}
    for r in runs:
        runs_by.setdefault(r["name"], []).append(r)
    solns = {}
    for job in jobs:
        solns[job["name"]] = job_solution(
            read_time, job, runs_by.get(job["name"], []))
    unknown_runs = [r for r in runs
                    if r["name"] not in {j["name"] for j in jobs}]
    return {
        "valid?": all(s["valid?"] for s in solns.values()),
        "jobs": solns,
        "extra": [r for s in solns.values() for r in s["extra"]],
        "incomplete": [r for s in solns.values()
                       for r in s["incomplete"]],
        "unknown-job-runs": unknown_runs,
        "read-time": read_time,
    }


def run_coverage_checker() -> chk.Checker:
    """History-level checker: jobs are ok :add-job values; runs and the
    read time come from the last ok :read."""

    def run(test, hist, opts):
        jobs, final = [], None
        for op in hist:
            if op.type != "ok":
                continue
            if op.f == "add-job":
                jobs.append(op.value)
            elif op.f == "read":
                final = op.value
        if final is None:
            return {"valid?": "unknown",
                    "error": "runs were never read"}
        return check_schedule(final["time"], jobs,
                              list(final["runs"]))

    return chk.checker(run)


class _AddJobGen(gen.Generator):
    """Seeded job-spec generator (chronos.clj add-job, 194-215):
    intervals sized > duration + 2*epsilon + forgiveness so one
    scheduler never has to run two invocations of a job at once.
    Emission is FUNCTIONAL — op() returns a successor carrying n+1,
    and the spec is derived from (seed, n) — so probe-and-discard
    wrappers (reserve/any) can't leak job names."""

    def __init__(self, head_start: float = 10.0, seed=None, n: int = 0):
        self.head_start = head_start
        # (seed, n) -> spec must be stable across probe-and-discard
        # re-derivations, so an unseeded run draws ONE random seed here
        # and threads it through every successor.
        self.seed = (util.seeded_rng(None).randrange(2 ** 63)
                     if seed is None else seed)
        self.n = n

    def op(self, test, ctx):
        rng = util.seeded_rng(self.seed, self.n)
        duration = rng.randrange(10)
        epsilon = 10 + rng.randrange(20)
        interval = (1 + duration + epsilon + EPSILON_FORGIVENESS
                    + rng.randrange(30))
        job = {"name": self.n,
               "start": ctx.time / 1e9 + self.head_start,
               "interval": float(interval),
               "count": 10 + rng.randrange(20),
               "epsilon": float(epsilon),
               "duration": float(duration)}
        m = gen.fill_in_op({"f": "add-job", "value": job}, ctx)
        if m is gen.PENDING:
            # don't advance n on a probe: spec n must not be consumed
            # until the op is actually emitted
            return gen.PENDING, self
        return m, _AddJobGen(self.head_start, self.seed, self.n + 1)

    def update(self, test, ctx, event):
        return self


def workload(opts: dict | None = None) -> dict:
    """Add jobs under faults; after recovery, one final read of the
    run log (chronos.clj test, 240-266)."""
    o = dict(opts or {})
    return {
        "generator": gen.limit(
            o.get("jobs", 20),
            gen.stagger(o.get("stagger", 0.05),
                        _AddJobGen(seed=o.get("seed")))),
        "final_generator": gen.once(
            lambda: {"f": "read", "value": None}),
        "checker": run_coverage_checker(),
    }
