#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc under
/usr/local/cuda (or on PATH) and PyTorch built for CUDA. It

  1. prints the card (nvidia-smi name and power limit), the toolchain and
     the compute capability, which must be 9.0;
  2. builds every kernel from jepsen_tpu_torch/gpu/kernels/csrc;
  3. holds the wgl_search kernel against its plain PyTorch version on the
     card, on seeded histories (verdict and reach mode, with and without
     crashes, a window/frontier overflow case, segment rows with an empty
     segment, one long segment of ~2.4k entries at M = 4096 crash-free
     at W=32 and crashed, so the kernel's shared-memory ring wraps ~19
     times, a register over 600 values, so S = 512 states), prints the
     levels each case finished on the kernel's warp path and on its
     block path and the warp-path levels that sorted, and fails unless
     all three ran; on 128 crashed 400-op ensemble rows at W=32, F=64 (over 48 KB of shared memory a block),
     and on one launch over a one-device ensemble layout with
     unreferenced and repeated segments (against the plain version and a
     numpy gather): zero mismatches allowed, every output is an integer;
  4. drives the main path: a 1M-event CAS-register history
     (register_history(500_000, n_procs=5, seed=42)) through encode and
     check_segmented(target_len=8192) on the card, with the kernel launch
     count set to 0 just before and read just after; it must come back
     valid with >= 40 segments, and the same history corrupted at 85%
     must come back invalid, with the failed segment unreachable from its
     composed start state under the host search; the device profiler's
     records of each headline check must number the launches, each
     with a compute_ns equal to a launch's CUDA-event time (phase 23's
     check (a));
  5. cross-checks the slice on a ~20k-event history: check_segmented on
     the card equals check_segmented on the CPU (the plain kernel), and
     analysis(certify=True) / the linearizable checker on the card give
     certificates the port's validator accepts;
  6. replays the main path's kernel launches to time the kernel on each
     of them, and holds every one against its plain version, run once
     over all the rows of the launches of one search shape (M, S, W, F,
     reach, crash-free; `plain_against`): each launch's per-row outputs
     must equal its rows of that call, the call's level count the
     launches' largest and its level series the sum of theirs;
  7. holds the scc and bank_reduce kernels against their plain PyTorch
     versions on the card: seeded graphs (many large components, edge-mask
     subsets, a 3,000-node decreasing chain that hits SWEEP_CAP, one above
     DEVICE_MIN_EDGES, chains of 100 and 800 ten-node cycles; every graph that
     hits a cap also through the convergence launch, the launch scc()
     makes after a cap hit, against its plain version on the CPU and
     scipy's labels, with its rounds, sweeps, trim passes and grid syncs)
     and seeded balance matrices (one row past 2^31; 1, 2, 3, 32 and 100
     columns, also starting 8 bytes off the 16-byte grid); zero
     mismatches allowed in labels, ok, rounds, sweeps, trim passes, sums,
     flags; then times the convergence launch alone on a 100,000-node
     decreasing chain, a 100,000-node cycle, chains of 100, 800 and 2,000
     ten-node cycles and a
     100,000-node graph of large components joined to a decreasing chain
     and, through Edges.scc, a 20,001-node decreasing chain joined to a
     forward chain of 20,001 edges (one capped launch, one convergence
     launch), each held against scipy's labels;
  8. drives the Elle path through the checkers at ELLE_TXNS (bench.py
     config 3's 100,000 txns cut to 50,000 for the time limit), with the
     scc launch count set to 0 just before each check and read just
     after: list_append_history(50_000, seed=11) through append_checker
     must be valid with >= 1 launch, its twin with one read damaged at
     85% must be invalid with G0 and 5 launches,
     rw_register_history(50_000, seed=17) through wr_checker must be
     valid; every certificate must validate,
     and every SCC of these checks must be solved by one launch of the
     kernel (no host path, no cap hit, no degradation);
  9. cross-checks the Elle path on 20,000 txns, both families, valid and
     corrupted: the device engine on the card equals the device engine on
     the CPU (the plain kernel) and the host engine;
 10. drives the bank path: bank_history(500_000, n_accounts=32, seed=11)
     through check_fast on the card must be valid with the bank_reduce
     kernel launched, and a twin with one balance raised by 1 at 85% must
     give the numpy fold's first error;
 11. replays the Elle and bank main paths' launches to time both kernels,
     their plain versions and (bank) the PyTorch reduction, prints the scc
     rounds, sweeps, grid syncs and live edges per round of each launch
     (the bytes of its bound are counted from them), bank_reduce's time
     back to back and with L2 flushed before each launch, and both
     kernels' ptxas registers and spills;
 12. drives the ensemble, BASELINE config 5 cut from 1,024 to 768
     histories of register_history(400, n_procs=4, seed=1000+i,
     crash_p=0.15) through analysis_batch_streamed(chunk=128) three times
     (all valid, 6 launches a run), analysis_batch (one launch) and analysis_batch_sharded (one
     launch of the one-device ensemble form), with the launch counts set
     to 0 just before each and read just after; a twin with member 700
     corrupted at 30% must be invalid at member 700 only, with a witness,
     and member 700 corrupted at 85% must not come back VALID from the
     card (TWIN_AT_FRAC says why it is not searched on the host); prints
     wall time, events/s, host-resolved rows, kernel ms per launch (CUDA
     events) and each drain's wait on its launch's event;
 13. drives the independent-key checker over the same histories folded
     into one multi-key history (~614k events): valid over 768 keys in
     one launch with a certificate or a counted absence for each key, the
     folded twin invalid with failures [700]; 15 seeded certificates (and
     key 700's of the twin) validated against the whole history;
 14. drives check_slices in the fleet's shape: every start state of 64
     crashed ensemble histories and of their crash-free twins in one
     launch at W=24, F=48; every known row must equal the host reach
     search, and 8 rows must equal check_slices on the CPU;
 15. replays the ensemble's launches (one streamed run's chunks and the
     sharded launch) on the kernel and its plain version;
 16. checkpoint-and-extend on a history of the headline's shape cut to
     EXTEND_OPS ops (register_history(100_000, n_procs=5, seed=42), ~200k
     events, or the headline's own ops where fewer; the headline's 1M
     events took ~150 s in phases 16-18):
     analysis_extend of its first 90% writes a wgl-extend record to a temporary store, and
     analysis_extend of the whole history resumes from it; the result
     and certificate must equal, byte for byte, a fresh analysis_extend
     without a store, the certificate must validate, and the resumed run
     may compute at most (K - matched segments + 1) * S masks; the
     85%-corrupted twin resumed from its clean 80% prefix must equal its
     fresh check (invalid, same failed segment and certificate); a torn
     record must count ckpt.torn and give the fresh result; prints the
     reused and computed masks, launches, rows, wall seconds and kernel
     ms of each run; the whole history's rows go through check_slices
     on the card once more, and every known row, and every mask of the
     resumed record, must equal the host reach search, and 8 rows
     check_slices on the CPU;
 17. check_segmented(enc, checkpoint_dir=...) on the headline history
     twice: the second run must load every mask the first saved and
     launch no kernel, with the same result;
 18. the linearizable checker with a store directory and extend? on the
     card, on phase 16's history: valid through analysis_extend, its certificate validated;
 19. the checker stacks a Jepsen test composes (checker.compose), each
     into a fresh store directory, with every launch count set to 0 just
     before each composed check: the register stack
     (independent.checker(linearizable) + stats + unhandled_exceptions)
     over phase 13's folded history must be valid with wgl_search
     launched and write no file, and over its twin invalid with failures
     [700] and a counterexample SVG equal, byte for byte, to the one key
     700's subhistory leaves when checked alone on the CPU; the
     list-append stack (append_checker + stats) over phase 8's history
     valid with scc launched, over its twin invalid with G0 and its
     elle/G0-<fp>.txt on disk, and phase 9's corrupted history through
     the checker on the card and on the CPU with the same files and
     bytes; the bank stack (bank.checker + stats) over phase 10's history
     valid with bank_reduce launched, over its twin with phase 10's first
     error; no sub-result may be "unknown" or carry an error; prints each
     composed check's wall seconds beside the direct check's and the
     rendering calls' seconds;
 20. a generated test, the loop a Jepsen test runs: for the register
     (50 keys, 5 threads a key, 100 ops a key, 50 threads: 5,000 ops),
     bank (32 accounts, 24,000 ops), list-append and rw-register (5,000
     txns each) and fenced-lock (1,000 ops) workloads, each with the
     workload's generator on the port's interpreter (worker threads, the
     in-memory clients of jepsen_tpu_torch/testing.py, under
     util.with_relative_time), and each history the interpreter recorded
     checked with the workload's checker twice, on the card and with
     "device": "cpu"; each but the lock has a twin whose client is at
     fault (stale reads of one key, a bank whose balances start at 11,
     transactions that read from a snapshot refreshed every 16 txns).
     Every valid run must be valid and every twin invalid (the register
     twin's stale key in failures, with at least one stale read the
     recorded history rules out, the bank twin's first error a wrong
     total, the Elle twins with anomaly types), no result "unknown"; the
     card's verdicts, failures, anomaly types, first errors and
     certificates must equal the CPU's byte for byte, the calls through
     each kernel wrapper must be the same on both, and on the card equal
     each wrapper's launch counter: wgl_search 1 for the register run,
     bank_reduce 1 for the bank run, scc at least 1 for each Elle run,
     no kernel for the lock run; certificates are validated. Prints each
     run's interpreter ops/s and counters, check_s split by spans, the
     launches, the kernels' replayed ms and the card's idle share. One
     register twin of 2,000 ops runs traced into a temporary store: its
     optrace.jsonl must pass tracing.validate_records, its check must
     launch wgl_search once, and the stale key's counterexample trace
     excerpt must be the trace of its ops;
 21. the test lifecycle: four full Jepsen runs through core.run, each a
     named test in a temporary store over the dummy remote (the five
     nodes of the noop test, a responder chain answering node addresses,
     the network device, the fixture DB's pid file, node clocks and the
     node probe's seeded synthetic state), with FixtureDB's daemon
     started, killed, paused and resumed through control.exec_, the
     combined nemesis package's partition, kill, pause and clock faults
     at a 1 s interval and its final generator, the monitor at 1 s and
     the node probe on: the register (50 threads, the register
     watchdog adapter; 100 keys, 10,000 ops, the cut that keeps the
     script inside its time limit) must be valid with 1 wgl_search launch; its twin
     (StaleReadKVClient, trace? on) invalid with the stale key in
     failures, at least one stale read the history rules out and an
     optrace.jsonl that passes tracing.validate_records; list-append
     (10,000 txns) valid with scc launched; bank (32 accounts, 24,000
     ops; conservation and stats) valid with 1 bank_reduce launch. Each
     run directory must hold the run: history.jlog read back by
     store.load equal to the history op for op, results.json equal to
     the results, a `certified` stamp on every certificate, the
     clock-skew bound of the stored nodes.jsonl (whose records pass
     validate_records), a metrics.json that passes validate_metrics, a
     monitor point a second of the case span (one fewer allowed: the
     sampler's period is 1 s plus its own time) and every kernel
     gauge of the analysis in the time series, a coverage.json that
     passes validate_record with the fault activations of the history,
     one more atlas line, a -j DROP and the final iptables -F -w in every
     node's session log, a non-empty jepsen.log; the run directory is
     analysed again with core.analyze and the checker built with
     "device": "cpu", whose verdicts, failures, anomaly types, first
     errors and certificates must equal the card's byte for byte, with
     the same calls through each kernel wrapper; no result may be
     "unknown" or carry an error, and no thread or log handler may
     outlive the phase. Prints each run's lifecycle spans, ops/s, fault
     activations, check seconds on the card and the CPU, launches,
     kernel ms and the card's idle share over the whole core.run;
 22. checking-as-a-service: one port FleetServer on 127.0.0.1 with the
     card as its device, 36 tenants streaming at once in chunks of 512
     ops over the wire (each chunk journaled to the WAL before its ack,
     stream checks on): 32 cas-register tenants at bench.py's fleet
     shape cut to half its ops (register_history(1_500, seed=3000 + i),
     ~3,000 events, six chunks a tenant; tenants 7 and 23
     corrupted at 30%; tenant 0 of weight 2), two list-append and two
     rw-register tenants of 10,000 txns (past Elle's device dispatch,
     so scc runs on the card), all finishing together. Every verdict
     must equal the same history's solo check on the card
     (wgl.analysis(certify=True), or the Elle check) and the check on
     the CPU (the register histories in one analysis_batch, the plain
     kernel paying per level), every certificate must validate, a
     valid run's certificate must equal the solo one byte for byte; at
     least one check_slices launch and one final launch must hold two
     or more tenants (the flight recorder's launch records); every
     fleet slice launch is replayed against the plain version (0
     mismatches); the launch counters must equal the wrapper calls; no
     launch may fail and no item may be kept from a shared launch
     (bisect_launches, fleet.quarantine.attributions, host_floor,
     quarantine_items, the breaker, client fallback), and no verdict
     may carry an error. One tenant's server is then kill()ed
     mid-stream and restarted on the same WAL directory and port: its
     verdict file must equal the clean run's byte for byte, and
     neither server may show a failed launch.
     Last, phase 21's lifecycle with a single-register workload (the
     shape the fleet's cas-register model checks) streams to the same
     server through test["fleet"]: results["fleet"] must carry the local
     verdict, with a certificate equal to the local one. Prints the
     fleet's and the solo checks' ops/s, slice launches and rows per
     launch, histories per final launch, the flight recorder's verdict
     latency quantiles and mean slices, the replayed kernel ms and the
     card's idle share of the fleet's wall time;
23. the device profiler on the card: phase 21's register lifecycle at
     20 keys x 100 ops, one list-append run of 10,000 txns and one bank
     run of 24,000 ops (past the bank's device dispatch), each through
     core.run with profile? on in a fresh process of its own, the three
     at once (a process that has already run a Jepsen test loses device
     records from its torch.profiler traces on the card). The run
     directory's xprof directory must hold a torch.profiler trace whose
     kernel events for wgl_search, scc and bank_reduce equal the launch
     counters; prints the card's busy and idle share of each analysis.
     Each run's trace.json (reports/trace.write_trace) must pass
     validate_chrome_trace with a
     device-track slice for each `kernel:` span, its metrics.json
     validate_metrics with the profiler's wgl and scc launches equal to
     the wrapper calls, profile_text must render and prometheus_text
     pass validate_prometheus_text; phase 22's flight-recorder records
     as a Chrome trace (fleet_chrome_trace) must validate. Then the
     dispatch thresholds kept from the TPU, measured only: scc on the
     host against the card at 2,500-80,000 live edges, the bank fold
     against bank_reduce at 1,250-40,000 reads, the one-row search
     against check_segmented at 1,024-16,384 entries, the median of 5
     each, with each crossover printed. Last, one bench-ledger entry
     per kernel of the kernels line appended to a temporary ledger
     must pass ledger.validate_entries;
24. every workload of the registry (workloads.REGISTRY, 28 entries, in
     its order) as a generated test on the port's interpreter, each with
     the entry's in-memory fixture client of jepsen_tpu_torch/testing.py
     at the workload's default opts (500 ops where a generator has no
     bound of its own); a twin for each fixture with a fault knob, the
     knob set, at the sizes of the JAX package's test of it (25 twins);
     and a kafka run and its lose_offset twin at 10,000 ops. Each
     history is checked on the card (device left at its default) and
     with "device": "cpu": verdicts, anomaly and error types and every
     count must be equal (the whole result tree where no kernel wrapper
     was called), the calls through each kernel wrapper the same and on
     the card equal to the launch counters; every valid run must be
     valid but the causal one, whose verdict the threads' interleaving
     decides (ROADMAP C9), every twin invalid with the facts its JAX
     test asserts, no result "unknown". Prints each run's interpreter
     ops/s, check seconds on the card and the CPU and launches;
25. the transports and the filesystem-fault layer: three whole tests
     through core.run, each with the fixture DB of phase 21 under
     LazyFSDB (lazyfs mounted over its data directory; its binary
     deployed from an fs_cache pointed at a fresh directory, its clock
     under faketime, a tcpdump capture on every node), with
     file-corruption (lazyfs's lose-unfsynced-writes), kill (through
     LazyFSDB.kill, which drops the page cache), clock and membership
     faults (FixtureMembership: an in-memory member list of the five
     nodes, never below quorum, polled by one view thread a node), about
     24 nemesis ops at a 1 s interval. The register run (20 keys x 100
     ops) goes over the default stack's layers,
     RetryingRemote(ScpRemote(...)) with the dummy transport in place of
     SshRemote, a non-root login and the run under su; its transport
     raises TransportError once on three seeded commands, so the retry
     layer reconnects inside the run. Its stale-read twin goes over
     DockerRemote (a scripted docker CLI: `docker ps` resolves each
     node's published port), list-append (10,000 txns) over K8sRemote
     (a scripted kubectl). Each run's verdict must equal the stored
     history analysed again on the CPU (the twin invalid on its bad
     key), with wgl_search launched once for each register run and scc
     at least once for list-append; coverage must show
     lose-unfsynced-writes, membership and kill activations; every
     node's tcpdump.pcap, tcpdump.log and lazyfs.log must be fetched by
     snarf_logs (and on the default stack once more as root, through
     the scp layer's sudo download); no membership view thread may
     outlive the run, and the fs_cache directory must hold the
     artifact alone. Prints each run's spans, ops/s, fault
     activations, check seconds on the card and the CPU, launches and
     the card's idle share;
26. the command line, `python -m jepsen_tpu_torch`, in a temporary
     working directory (the store is ./store): three `test --no-ssh`
     runs at once, each in a process of its own (register and bank at
     the CLI's defaults, 500 ops at 100 ops/s, the bank's 8 accounts
     folded on the host; list-append 10,000 txns), and `fleet serve`
     on 127.0.0.1 in another. Each run must exit 2 with its `perf`
     sub-result "unknown" from an ImportError where matplotlib does not
     import (0 with the PNGs where it does), its workload verdict true,
     and the launches its stored metrics.json and telemetry.jsonl
     record: wgl_search 1 for register, scc 1 for list-append (its
     `kernel:scc` spans), none for the bank. As each run ends,
     `analyze` checks it again in this process on the card and with
     `--device cpu`: results.json equal, untimed, to what `test` wrote;
     on the card the launches as in the stored run, equal to the
     wrapper calls and to the counters in results.json; on the CPU no
     kernel launch, and the path counters (`wgl.kernel.launches`,
     `scc.path.device`, which count the plain versions there too) as on
     the card; so is a stored 32-account bank run of
     24,000 ops (synth.bank_history), whose ~12,000 reads launch
     bank_reduce once. Then `analyze --resume` of the list-append run
     with results.json removed and the partial log cut to the workload
     checker (the workload reused, checker.resumed 1, results equal);
     a twin of the register run with one read corrupted through the
     port's store/format writer (exit 1, the same failing key on the
     card and the CPU); `telemetry`, `profile`, `nodes`, `trace`,
     `certify` (on the register and list-append runs: the bank's
     results carry no certificate) and `coverage`, each exiting 0 with
     the text of its library call; `fleet submit` of each register key's subhistory
     (cas-register) and of the list-append run, each verdict the
     stored run's, then `status`, `top`, `explain`; web.serve's routes
     (200 each, /lint the graftlint report, /fleet with the tenant);
     `fleet trace`, and the server stopped by SIGINT with exit 0.
     Prints each step's seconds against the phase's 45 s budget;
27. the database suites (jepsen_tpu_torch/suites/, ROADMAP A10a): each
     of the 13 ported suites built by its own `<name>_test(opts)` (its
     DB, client, nemesis and checker stack) at its default workload
     (etcd's register and append), key count and ops, in this process,
     through core.run over the dummy remote with its client's transport
     on an in-memory database defined here (SUITE_SIZES: 3 nodes, 6
     threads, 5,000 ops/s within 1 s, the append runs 20,000 txns/s
     within 3 s); etcd's runs on the suite's own generator, the others
     on their workload's client ops (client_generator); postgres'
     append at 10,000 txns, past scc's dispatch; the twin of consul's
     run (key 1 answers a value nobody wrote from its 12th read on) and
     of the postgres append (every second read of a list reversed).
     Every run is stored; the wrapper calls must equal the launch
     counters and the stored metrics.json and telemetry.jsonl launches;
     every linearizable run launches wgl_search, each SCC solve of at
     least DEVICE_MIN_EDGES live edges launches scc once and no other
     does, and some run launches it; each append run invokes all its
     txns; the results equal, untimed, resume.analyze_run of the stored
     run on the CPU with the suite's builder; every certificate
     validates; healthy runs are valid by their workload checker, twins
     invalid with the same failing keys or anomalies on the card and
     the CPU (consul's [1]). Prints each run's seconds against the
     phase's 60 s budget;
 28. the other eight database suites (ROADMAP A10b: hazelcast,
     cockroach, tidb, yugabyte, dgraph, disque, elasticsearch, rabbitmq)
     as phase 27 runs its suites, through suites_path(phase=28): each at
     its default workload (hazelcast's lock, cockroach's register,
     tidb's 2,000-txn append, yugabyte's ysql/append, dgraph's upsert,
     the queues and dirty reads), key count and ops, plus dgraph's
     linearizable-register and yugabyte's ysql/multi-key-acid (the two
     linearizable workloads no default reaches), on in-memory databases
     defined here (the hazelcast console, cockroach sql tsv, the mysql
     CLI, ysqlsh, dgraph's HTTP calls, disque-cli, EsHttp.request,
     rabbitmqadmin raw_json); dgraph's runs at 8 threads (its key groups
     of 4, ROADMAP C13); yugabyte's append at 10,000 txns within 8 s,
     past scc's dispatch; the workload's final generator (elasticsearch's
     refresh and strong reads, rabbitmq's drain) after the time limit;
     the twins of cockroach's register (key 1 answers a value nobody
     wrote from its 12th read on) and of yugabyte's append (every second
     read of a list reversed). The same checks as phase 27: wgl_search
     launched by every linearizable run, scc once per solve of at least
     DEVICE_MIN_EDGES live edges, results equal to the CPU's
     re-analysis, twins invalid with equal keys (cockroach's [1]) or
     anomalies; certificates a model outside the validator's replay
     registry cannot have (yugabyte's MultiRegister) are counted as
     honest absences. Prints each run's seconds against the phase's
     60 s budget;
 29. the static analysis (jepsen_tpu_torch.analysis, gpu/lint.py):
     `python -m jepsen_tpu_torch lint --baseline lint-baseline-torch.json
     --json` in a process of its own must exit 0 with no NEW and no
     stale finding; in this process, after every launch above,
     run_lint(runtime_buckets=True, full=True) builds the libraries and
     must find each launch's Python scratch and shared-memory sizes
     equal to the library's at every registry bucket and every runtime
     bucket (wgl and scc ones among them), with no trace error, and the
     default mode's finding keys must be the committed baseline's;
     /lint and /lint?json=1 from a web.serve must answer 200 with the
     gated report. Launches no kernel. Prints the traces by kernel, the
     findings by rule and each part's seconds against a 20 s budget;
 30. the multi-device form (ROADMAP A6), on meshes of MESH_SHARDS (4)
     shards sharing the card (the machine has one: spmd.spmd_devices()
     must be 1, so no earlier phase sharded): (a) phase 12's 768
     histories through check_batch_sharded over the mesh and over the
     card alone, and every start state of 64 of them in reach mode, 0
     mismatches, one wgl_search launch a shard, each shard's launch
     replayed on the kernel and its plain version; a launch routed over
     the shards returns while a 0.5 s sleep queued on the card just
     before its dispatch still holds it; check_segmented of
     phase 16's history and its 85%-corrupted twin with spmd.cards()
     read as 4 entries of the card (the automatic route), results and
     certificates byte for byte the one-device check's, certificates
     validated; (b) phase 8's corrupted list-append through the Elle
     check over the shards (key-block layout, sharded solves), its
     anomalies those of the one-device search over the edges in the
     same key-block order, with the scc_shard launch counts set to 0
     just before and read just after; every sharded solve of phase 8's
     two graphs, the twin's graded subsets and a tests/test_spmd.py-
     shaped graph (2,500 nodes, 30,040 edges) at 2, 4 and 8 shards with
     labels, ok, rounds and sweeps equal to scc_kernel's, and each
     solve's launches, read-backs and seconds; the twin's graph at 4
     shards under three chunk schedules in turns (the solve's own, one
     read-back a sweep, chunks of 2, 4, 8, ...); each solve's launches
     and its waits for the card, counted by kind where the host makes
     them, which must be the state's read once a chunk and the labels'
     download, no read of its own a round (a round's first colours,
     roots and retire run inside the fixpoints' launches); every recorded chunk of sweeps replayed
     launch by launch (the compacting first sweeps, which derive the
     values they send, the later sweeps over the compacted edges, the
     first applies of both passes, the later applies, the launches past
     a fixpoint's end, and a backward chunk's retire as a launch of its
     own) and whole (the retire at its end), each against its plain
     version, timed between its launcher's events (a launch also behind
     a sleep queued on the card, which leaves the host's launch call
     out), beside the PyTorch call that computes the same values where
     there is one;
     (c) a 2-rank gloo group, each rank a process of its own sharing
     the card, equal to the in-process 2-shard mesh, each rank counting
     the shared card once (spmd.spmd_devices() 1); prints that NCCL
     across cards was not run, and why;
 31. the run-time switches, its seconds printed against
     SWITCHES_BUDGET_S (60 s): (a) a
     process of its own with JEPSEN_TPU_COMPILE_CACHE set to a fresh
     temporary directory runs build.build_all(), and every library must
     land there; (b) another, with that cache and no nvcc on PATH, must
     find every library in the cache before it loads, load each from
     there, leave the cache's files untouched and launch wgl_search,
     scc_kernel, bank_reduce and a compacting and a later scc_shard
     sweep on small seeded inputs, each against its plain version on
     the card with 0 mismatches; (c) phase 4's headline check with its
     certificate attached (certify.attach_wgl, as analysis(certify=True)
     attaches it), certificates on and with JEPSEN_TPU_CERTIFY=0: the
     same verdict and result, the same wgl_search launches, the
     certificate extracted and then the absent marker; prints both
     checks' wall seconds, the certificate's cost; (d) phase 4's
     85%-corrupted twin through check_segmented with early exit on and
     with JEPSEN_TPU_EARLY_EXIT=0: the same result (verdict, failed
     segment, witness), no early exit when off; prints both launch
     counts. Then the script prints one `{"kernels": [...]}` line,
     whose wgl_search launches include those of phases 16-28, whose scc
     and bank_reduce launches include those of phases 19-28, and which
     lists the mesh form's wgl_search and the three scc_shard kernels
     (sweep, apply, retire) with phase 30's launches; phase 31's
     launches are printed in its own lines.

The last line is {"ok": true, "device": {...}}. Any failure raises, and
the script exits non-zero without that line; it also exits non-zero
when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import math
import os
import random
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

import numpy as np

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import control, core, coverage
from jepsen_tpu_torch import db as jdb
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent, interpreter, nodeprobe, store
from jepsen_tpu_torch import ledger, telemetry, testing, tracing, util
from jepsen_tpu_torch import faketime, fs_cache, lazyfs, workloads
from jepsen_tpu_torch import resume, suites
from jepsen_tpu_torch.control import core as ccore
from jepsen_tpu_torch.control import scp
from jepsen_tpu_torch.control import util as cu
from jepsen_tpu_torch.control.docker import DockerRemote
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.control.k8s import K8sRemote
from jepsen_tpu_torch.control.retry import RetryingRemote
from jepsen_tpu_torch.control.scp import ScpRemote
from jepsen_tpu_torch.dbs import tcpdump
from jepsen_tpu_torch import fleet
from jepsen_tpu_torch.fleet import client as fclient
from jepsen_tpu_torch.fleet import flightrec as fflightrec
from jepsen_tpu_torch.fleet import scheduler as fsched
from jepsen_tpu_torch.fleet import server as fserver
from jepsen_tpu_torch.fleet import wal as fwal
from jepsen_tpu_torch.nemesis import combined, membership
from jepsen_tpu_torch.checker import cycle, linearizable, models
from jepsen_tpu_torch.gpu import certify, ckpt, elle, ensemble, synth, wgl
from jepsen_tpu_torch.gpu import dist as gdist
from jepsen_tpu_torch.gpu import elle_device, profiler, spmd
from jepsen_tpu_torch.gpu import scc as scc_mod
from jepsen_tpu_torch.history import History, op
from jepsen_tpu_torch.gpu.encode import encode
from jepsen_tpu_torch.gpu.kernels import bank_reduce as kbank
from jepsen_tpu_torch.gpu.kernels import build
from jepsen_tpu_torch.gpu.kernels import scc as kscc
from jepsen_tpu_torch.gpu.kernels import scc_shard as kshard
from jepsen_tpu_torch.gpu.kernels import wgl_search as ws
from jepsen_tpu_torch.reports import explain
from jepsen_tpu_torch.reports import profile as rprofile
from jepsen_tpu_torch.reports import trace as rtrace
from jepsen_tpu_torch.store.format import jsonable
from jepsen_tpu_torch.workloads import bank
from jepsen_tpu_torch.workloads import lock as wl_lock
from jepsen_tpu_torch.workloads import register as wl_register
from jepsen_tpu_torch.workloads import txn_append as wl_append
from jepsen_tpu_torch.workloads import txn_wr as wl_wr

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth,
# and the float32 CUDA-core rate, used as the rate of the kernel's 32-bit
# integer compare/select work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# BASELINE config 5 (bench.py:145-187): 1,024 register histories of 400
# ops, 4 processes, 15% of ops crashed, streamed in chunks of 128; cut to
# 768 histories (six chunks) to keep the script inside its time limit
ENSEMBLE_N = 768
ENSEMBLE_CHUNK = 128
ENSEMBLE_BAD = 700
# The twin corrupts member 700 at 30% of its history. At 85% neither
# package decides that member in bounded time: the kernel answers
# UNKNOWN (frontier overflow) and the exact host search behind it is
# exponential in the crashed writes before the bad read (30 there; the
# search takes 0.2 s at 30%, 2 s at 40%, 52 s at 50% on a CPU). The 85%
# twin runs through the card only (phase 12), which must not say VALID.
TWIN_AT_FRAC = 0.3
UNDECIDED_AT_FRAC = 0.85
# ops of phase 16-18's history (the headline's 500,000 cut to keep the
# script inside its time limit)
EXTEND_OPS = 100_000
# txns of phase 8's Elle histories (bench.py config 3's 100,000 cut to
# keep the script inside its time limit; ~300k edges, one SCC launch a
# valid check, the twin's graded subsets 5, all past DEVICE_MIN_EDGES)
ELLE_TXNS = 50_000


def ensemble_hist(i: int, crash_p: float = 0.15) -> History:
    return synth.register_history(400, n_procs=4, seed=1000 + i,
                                  crash_p=crash_p)


def fold_keys(hists) -> History:
    """One multi-key history out of single-key ones (key k = hists[k]):
    values become (k, v), process ids k * 1000 + p, and ops merge by
    (per-key time, key) with index and time renumbered."""
    events = sorted(((o.time, k, o) for k, h in enumerate(hists)
                     for o in h), key=lambda e: (e[0], e[1]))
    return History([op(index=i, time=i, type=o.type,
                       process=k * 1000 + o.process, f=o.f,
                       value=(k, o.value))
                    for i, (_t, k, o) in enumerate(events)],
                   assign_indices=False)


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _seeded_cases():
    """(name, encodes, rows, W, F, reach) launches of 2-10k entries."""
    m = models.cas_register()
    out = []
    for crash_p in (0.0, 0.15):
        hs = [synth.register_history(1500, n_procs=5, seed=s,
                                     crash_p=crash_p) for s in range(3)]
        hs.append(synth.corrupt_register_history(hs[0], at_frac=0.5)[0])
        encs = [encode(m, h) for h in hs]
        rows = [(i, e.init_state) for i, e in enumerate(encs)]
        tag = f"whole-crash{crash_p}"
        out.append((f"{tag}-verdict", encs, rows, 32, 64, False))
        out.append((f"{tag}-reach", encs, rows, 32, 32, True))
        out.append((f"{tag}-overflow-verdict", encs, rows, 4, 4, False))
        out.append((f"{tag}-overflow-reach", encs, rows, 4, 4, True))
        # check_segmented's shape: segments x every start state
        enc = encode(m, synth.corrupt_register_history(
            synth.register_history(10_000, n_procs=5, seed=7,
                                   crash_p=crash_p / 10), at_frac=0.6)[0])
        q = enc.m // 8
        cuts = [k * q for k in range(8)] + [enc.m]
        segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(8)]
        # and an empty segment (m == 0): its rows start VALID, mask
        # 1 << st0, and never run a level
        segs.append(enc.segment(q, q))
        rows = [(k, s) for k in range(9) for s in range(enc.n_states)]
        out.append((f"segments-crash{crash_p / 10}-reach", segs, rows, 24,
                    48, True))
    # one long segment (~2.4k entries, M = 4096; cut from 15,000 ops,
    # M = 16384, then 7,500 ops, M = 8192, to keep the script inside its
    # time limit), one row: the kernel's ring of R = 128 entries wraps
    # ~19 times; W=32 crash-free
    # fills the window (no hole left in the mask), and the crashed
    # segment's levels give up to 168 successors (the block path)
    for crash_p, W, F, reach in ((0.0, 32, 64, False), (0.02, 32, 64, False),
                                 (0.02, 24, 48, True)):
        enc = encode(m, synth.register_history(3_000, n_procs=5, seed=21,
                                               crash_p=crash_p))
        out.append((f"long-crash{crash_p}-W{W}-"
                    f"{'reach' if reach else 'verdict'}", [enc],
                    [(0, enc.init_state)], W, F, reach))
    # a register over 600 values (S = 512 states): the kernel reads trans
    # from global memory, so its shared memory does not grow with S
    for crash_p in (0.0, 0.15):
        hs = [synth.register_history(1500, n_procs=5, seed=30 + s,
                                     crash_p=crash_p, n_values=600)
              for s in range(3)]
        hs.append(synth.corrupt_register_history(hs[0], at_frac=0.5)[0])
        encs = [encode(m, h) for h in hs]
        rows = [(i, e.init_state) for i, e in enumerate(encs)]
        out.append((f"values600-crash{crash_p}-verdict", encs, rows, 24, 48,
                    False))
    return out


def _mismatches(got, want) -> list[int]:
    return [int((a.to(torch.int64) != b.to(torch.int64)).sum())
            for a, b in zip(got, want)]


def _max_abs_err(got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def _path_levels(packed, rs, s0, kw, on_card: bool):
    """{"warp": n, "block": n, "warp_sorted": n}: the levels one launch
    of the kernel finished on its warp path and on its block path, and
    the warp-path levels that sorted (more than F unique successors),
    summed over its rows, from a launch of its own; None off the card."""
    if not on_card:
        return None
    buf = torch.zeros(3, dtype=torch.int32, device=rs.device)
    ws.wgl_search(packed, rs, s0, path_levels=buf, **kw)
    warp, block, warp_sorted = buf.tolist()
    return {"warp": warp, "block": block, "warp_sorted": warp_sorted}


def _us_per_level(kernel_ms, levels: int):
    return (1e3 * kernel_ms / levels) if kernel_ms is not None and levels \
        else None


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_group_key(packed, kw) -> tuple:
    """(M, S, W, F, max_iters, reach, crash-free): launches that agree on
    these can share one call of the plain version (plain_against)."""
    return (int(packed[0].shape[1]), int(packed[2].shape[2]), kw["W"],
            kw["F"], kw["max_iters"], bool(kw["reach"]),
            bool(kw["crash_free"]))


def plain_against(launches, sync=lambda: None) -> tuple[int, float]:
    """(max abs error, plain ms) of the kernel's outputs of `launches`
    ((packed, row_seg, st0, kw, out) of one plain_group_key) against ONE
    call of the plain version over all their rows: the launches' tables
    stacked along K, each launch's row segments offset past the tables
    before it. The plain version searches each row on its own (a row's
    state, verdict and mask never read another row's), so each launch's
    per-row outputs must equal its rows of the call; the call runs until
    its last row stops, so its level count must be the launches' largest
    and each level series the sum of theirs (a launch's series is 0 past
    its own levels). A launch's own level count is held to its live
    series: a running row keeps a live configuration, so the series is
    positive at each of the launch's levels and 0 after them."""
    kw = launches[0][3]
    packed = tuple(torch.cat([x[0][i] for x in launches])
                   for i in range(5))
    offsets = np.cumsum([0] + [x[0][0].shape[0] for x in launches])
    rs = torch.cat([x[1] + int(off) for x, off in zip(launches, offsets)])
    s0 = torch.cat([x[2] for x in launches])
    sync()
    t0 = time.perf_counter()
    want = ws.wgl_search_reference(packed, rs, s0, **kw)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err, row = 0, 0
    for _, rs_i, _, _, out in launches:
        b = rs_i.numel()
        err = max(err, _max_abs_err(out[:-4], [w[row:row + b]
                                               for w in want[:-4]]))
        row += b
        n, live = int(out[-4]), out[-3]
        err = max(err, int((live[:n] <= 0).sum()),
                  int((live[n:] != 0).sum()))
    n_it = max(int(x[4][-4]) for x in launches)
    err = max(err, abs(int(want[-4]) - n_it))
    series = [sum(x[4][k].to(torch.int64) for x in launches)
              for k in (-3, -2, -1)]
    return max(err, _max_abs_err(series, want[-3:])), plain_ms


def _launch_bound(packed, rs, kw, out) -> tuple[float, float, float]:
    """(bytes, operations, bound ms) of one launch on this run's data:
    each packed entry the rows' segments hold is read once (inv, ret,
    sufmin and a trans row of S states), each output written once; one
    operation per (configuration, window slot) evaluated and per
    successor key sorted, from the launch's own level series."""
    inv_t, ret_t, trans, mseg, sufmin = packed
    S = trans.shape[2]
    segs = torch.unique(rs)
    entries = int(mseg[segs].to(torch.int64).sum())
    B = rs.numel()
    n_it = int(out[-4])
    live = int(out[-3][:n_it].to(torch.int64).sum())
    gen = int(out[-2][:n_it].to(torch.int64).sum()
              + out[-1][:n_it].to(torch.int64).sum())
    nbytes = entries * 4 * (3 + S) + B * 4 * 2 + B * 6 + 3 * 4 * kw[
        "max_iters"]
    ops = live * kw["W"] + gen * max(1, math.ceil(math.log2(max(gen, 2))))
    bound_ms = 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)
    return nbytes, ops, bound_ms


def _norm(x):
    """A result tree in plain data: every op replaced by its to_dict(),
    sets sorted, a model (an object with a step) as its class name and
    fields, so the two packages' trees compare."""
    if hasattr(x, "to_dict") and not isinstance(x, dict):
        return {"op": _norm(x.to_dict())}
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted((_norm(v) for v in x), key=repr)
    if hasattr(x, "step") and not isinstance(x, type):
        fields = (x.__slots__ if hasattr(x, "__slots__") else vars(x))
        return {"class": type(x).__name__,
                **{f: _norm(getattr(x, f)) for f in fields}}
    return x


def _clustered_graph(seed, n, cluster, inner, cross):
    """Many large SCCs: random edges inside clusters of `cluster` nodes
    plus forward edges between clusters."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, n // cluster, inner)
    src = blk * cluster + rng.integers(0, cluster, inner)
    dst = blk * cluster + rng.integers(0, cluster, inner)
    cs = rng.integers(0, n - 2 * cluster, cross)
    cd = cs + rng.integers(1, 2 * cluster, cross)
    return np.concatenate([src, cs]), np.concatenate([dst, cd])


def _cycle_chain(k, size):
    """k cycles of `size` nodes in decreasing order, each joined to the
    one below by an edge from its first node to the lower cycle's last:
    a chain of non-trivial components, which trim cannot touch."""
    base = np.repeat(np.arange(k) * size, size)
    pos = np.tile(np.arange(size), k)
    links = np.arange(1, k) * size
    return (k * size, np.concatenate([base + pos, links]),
            np.concatenate([base + (pos + 1) % size, links - 1]))


def _scc_cases():
    """(name, n, src, dst, edge_on) seeded graphs for kernel vs plain."""
    rng = np.random.default_rng(5)
    out = []
    for seed, (n, cluster, inner, cross) in enumerate(
            [(3000, 60, 6000, 1500), (100_000, 300, 500_000, 100_000)]):
        src, dst = _clustered_graph(seed, n, cluster, inner, cross)
        ty = rng.integers(0, 5, len(src))
        for k in (1, 2, 3, 4, 5):
            out.append((f"clustered-n{n}-classes{k}", n, src, dst, ty < k))
    chain = 3000
    out.append(("decreasing-chain-3000", chain,
                np.arange(chain - 1, 0, -1), np.arange(chain - 2, -1, -1),
                np.ones(chain - 1, dtype=bool)))
    out.append(("decreasing-chain-100", 100, np.arange(99, 0, -1),
                np.arange(98, -1, -1), np.ones(99, dtype=bool)))
    out.append(("cycle-600", 600, np.arange(600), (np.arange(600) + 1) % 600,
                np.ones(600, dtype=bool)))
    for k in (100, 800):
        n, src, dst = _cycle_chain(k, 10)
        out.append((f"cycle-chain-{k}x10", n, src, dst,
                    np.ones(len(src), dtype=bool)))
    n = 2000
    src, dst = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    out.append(("random-n2000", n, src, dst, rng.random(4000) < 0.8))
    return out


def _scc_tensors(src, dst, on, dev):
    return (torch.from_numpy(np.asarray(src, np.int32)).to(dev),
            torch.from_numpy(np.asarray(dst, np.int32)).to(dev),
            torch.from_numpy(np.asarray(on, bool)).to(dev))


def _bank_cases():
    """(name, matrix, offset): an offset case lies one element past a
    16-byte boundary, so its rows start off the 16-byte grid (all of
    them for an even width, every other one for an odd width)."""
    rng = np.random.default_rng(9)
    mats = {"random-1000x32": rng.integers(-100, 100, (1000, 32)),
            "random-250000x32": rng.integers(0, 50, (250_000, 32)),
            "random-77x100": rng.integers(-2 ** 40, 2 ** 40, (77, 100)),
            "random-1000x1": rng.integers(-2 ** 40, 2 ** 40, (1000, 1)),
            "random-1000x2": rng.integers(-2 ** 40, 2 ** 40, (1000, 2)),
            "random-1000x3": rng.integers(-2 ** 40, 2 ** 40, (1000, 3))}
    past = rng.integers(0, 10, (5000, 16))
    past[17, :2] = [2 ** 31 - 1, 5]
    past[18, :3] = [2 ** 31 - 1, 2 ** 31 - 1, 2 ** 31 - 1]
    mats["past-int32-5000x16"] = past
    out = [(k, np.ascontiguousarray(v, dtype=np.int64), False)
           for k, v in mats.items()]
    for rows, cols in ((1000, 1), (1000, 2), (1000, 3), (77, 100),
                       (250_414, 32)):
        out.append((f"offset-{rows}x{cols}", np.ascontiguousarray(
            rng.integers(-2 ** 40, 2 ** 40, (rows, cols)), dtype=np.int64),
            True))
    return out


def _bank_tensor(mat, offset: bool, dev):
    if not offset:
        return torch.from_numpy(mat).to(dev)
    rows, cols = mat.shape
    flat = torch.empty(rows * cols + 1, dtype=torch.int64, device=dev)
    view = flat[1:].view(rows, cols)
    view.copy_(torch.from_numpy(mat))
    return view


def _syncs(dev, on_card: bool):
    return torch.zeros(2, dtype=torch.int32, device=dev) if on_card else None


def kernels_against_plain(dev, on_card: bool) -> int:
    """Phase 7: scc and bank_reduce against their plain versions; every
    capped case that hits a cap also through the convergence launch,
    against its plain version on the CPU and scipy's labels."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    total = 0
    for name, n, src, dst, on in _scc_cases():
        args = _scc_tensors(src, dst, on, dev)
        sync()
        t0 = time.perf_counter()
        got = kscc.scc_labels(*args, n)
        sync()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = kscc.scc_labels_reference(*args, n)
        sync()
        t_plain = time.perf_counter() - t0
        mism = int((got != want).sum())
        total += mism
        tail = want[n:].tolist()
        emit({"phase": "kernel-vs-plain", "kernel": "scc", "case": name,
              "nodes": n, "edges": len(src), "live_edges": int(on.sum()),
              "ok": tail[0], "rounds": tail[1], "sweeps": tail[2],
              "components": int(np.unique(want[:n].cpu().numpy()).size),
              "mismatches": mism, "kernel_s": t_kernel, "plain_s": t_plain})
        if (name.startswith(("decreasing-chain", "cycle"))
                and tail[0] != 0):
            raise AssertionError(f"{name} did not hit a cap: {tail}")
        if tail[0] == 0:
            # the launch scc() makes after a cap hit, against its plain
            # version on the CPU and scipy's labels; on the card also with
            # block 0 never going on alone, so the grid schedule meets
            # the plain version too
            cpu = [a.cpu() for a in args]
            want = kscc.scc_labels_to_convergence(*cpu, n)
            host = scc_mod._scc_host(n, src[on], dst[on])
            tail = want[n:].tolist()
            if tail[0] != 1:
                raise AssertionError(f"{name} to convergence: {tail}")
            total += int((want[:n].numpy() != host).sum())
            schedules = {"default": kscc.TAIL_WORK, "grid": -1}
            for schedule, tail_work in schedules.items():
                if not on_card and schedule != "default":
                    continue
                syncs = _syncs(dev, on_card)
                kscc.TAIL_WORK = tail_work
                try:
                    sync()
                    t0 = time.perf_counter()
                    got = kscc.scc_labels_to_convergence(*args, n,
                                                         syncs=syncs)
                    sync()
                    t_kernel = time.perf_counter() - t0
                finally:
                    kscc.TAIL_WORK = schedules["default"]
                mism = int((got.cpu() != want).sum())
                total += mism
                emit({"phase": "kernel-vs-plain", "kernel": "scc",
                      "case": f"{name}-to-convergence",
                      "schedule": schedule, "ok": tail[0],
                      "rounds": tail[1], "sweeps": tail[2],
                      "trim_passes": tail[3],
                      "grid_syncs": syncs.tolist() if on_card else None,
                      "mismatches": mism,
                      "equals_scipy": bool((want[:n].numpy() == host)
                                           .all()),
                      "kernel_s": t_kernel})
    for name, mat, offset in _bank_cases():
        m = _bank_tensor(mat, offset, dev)
        got = kbank.bank_reduce(m)
        want = kbank.bank_reduce_reference(m)
        sync()
        mism = [int((a != b).sum()) for a, b in zip(got, want)]
        exact = bool((got[0].cpu().numpy() == mat.sum(axis=1)).all()
                     and (got[1].cpu().numpy() == (mat < 0).any(axis=1))
                     .all())
        total += sum(mism) + (not exact)
        emit({"phase": "kernel-vs-plain", "kernel": "bank_reduce",
              "case": name, "shape": list(mat.shape),
              "data_ptr_mod_16": m.data_ptr() % 16, "mismatches": mism,
              "equals_numpy_int64": exact})
    return total


def _wide_capped(n: int):
    """A wide graph that hits SWEEP_CAP: n nodes in clusters of 300 with
    5n random edges inside them and n forward edges between them (many
    large components, 6n edges), plus a 3,000-node decreasing chain."""
    src, dst = _clustered_graph(7, n, 300, 5 * n, n)
    chain = n + np.arange(2999, 0, -1)
    return (n + 3000, np.concatenate([src, chain]),
            np.concatenate([dst, chain - 1]))


def scc_adversarial(dev, on_card: bool, n_big: int = 100_000,
                    n_chain: int = 20_001) -> dict:
    """Phase 7b: the convergence launch alone on a decreasing chain and a
    single cycle of n_big nodes, the chains of 100, 800 and 2,000
    ten-node cycles and a wide graph of n_big nodes joined to a
    decreasing chain, and a
    decreasing chain of n_chain nodes joined to a forward chain of
    n_chain edges through Edges.scc (a cap hit, then the convergence
    launch). Each is held against scipy's labels; the plain versions are
    too slow at this size on the card."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    graphs = {
        f"decreasing-chain-{n_big}": (n_big, np.arange(n_big - 1, 0, -1),
                                      np.arange(n_big - 2, -1, -1)),
        f"cycle-{n_big}": (n_big, np.arange(n_big),
                           (np.arange(n_big) + 1) % n_big),
        "cycle-chain-100x10": _cycle_chain(100, 10),
        f"clustered-{n_big}+decreasing-chain-3000": _wide_capped(n_big),
        "cycle-chain-800x10": _cycle_chain(800, 10),
        "cycle-chain-2000x10": _cycle_chain(2000, 10)}
    result = {}
    for name, (n, src, dst) in graphs.items():
        on = np.ones(len(src), dtype=bool)
        args = _scc_tensors(src, dst, on, dev)
        host = scc_mod._scc_host(n, src, dst)
        syncs = _syncs(dev, on_card)
        if on_card:  # a warm-up launch
            kscc.scc_labels_to_convergence(*args, n)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        sync()
        t0 = time.perf_counter()
        if on_card:
            start.record()
        out = kscc.scc_labels_to_convergence(*args, n, syncs=syncs)
        if on_card:
            end.record()
        sync()
        seconds = time.perf_counter() - t0
        ms = start.elapsed_time(end) if on_card else None
        o = out.cpu().numpy()
        if o[n] != 1 or (o[:n] != host).any():
            raise AssertionError(f"{name}: labels differ from scipy's: "
                                 f"{o[n:]}")
        x = {"case": name, "tail_work": kscc.TAIL_WORK, "nodes": n,
             "edges": len(src), "seconds": seconds, "kernel_ms": ms,
             "rounds": int(o[n + 1]), "sweeps": int(o[n + 2]),
             "trim_passes": int(o[n + 3]),
             "grid_syncs": syncs.tolist() if on_card else None,
             "equals_scipy": True}
        result[name] = x
        emit({"phase": "scc-adversarial", **x})
    # through the entry point: the capped launch hits SWEEP_CAP, the
    # convergence launch answers
    n = n_chain
    m = n_chain
    src = np.concatenate([np.arange(n - 1, 0, -1), np.arange(n, n + m)])
    dst = np.concatenate([np.arange(n - 2, -1, -1), np.arange(n + 1,
                                                              n + m + 1)])
    total_n = n + m + 1
    host = scc_mod._scc_host(total_n, src, dst)
    kscc.launches = kscc.converge_launches = 0
    telemetry.reset()
    sync()
    t0 = time.perf_counter()
    labels = scc_mod.scc(total_n, src, dst, device=dev)
    sync()
    seconds = time.perf_counter() - t0
    counters = telemetry.get().counters()
    counts = {"capped_launches": kscc.launches,
              "converge_launches": kscc.converge_launches,
              "nonconverged": counters.get("scc.device-nonconverged", 0),
              "device_path": counters.get("scc.path.device", 0),
              "host_path": counters.get("scc.path.host", 0)}
    if (labels != host).any():
        raise AssertionError("Edges.scc on the joined chains differs from "
                             "scipy")
    if counts["nonconverged"] != 1 or counts["device_path"] != 1 or \
            counts["host_path"] or (on_card and (
                counts["capped_launches"], counts["converge_launches"])
                != (1, 1)):
        raise AssertionError(f"Edges.scc on the joined chains: {counts}")
    x = {"case": f"decreasing-chain-{n}+forward-chain-{m} via Edges.scc",
         "nodes": total_n, "edges": len(src), "seconds": seconds,
         **counts, "equals_scipy": True}
    result["entry"] = x
    emit({"phase": "scc-adversarial", **x})
    return result


def _device_kernels(fn) -> list | str:
    """[(kernel name, device us)] of every kernel that one call of fn
    ran, in launch order, from torch.profiler's CUDA trace; the error's
    text when the profiler fails or records no kernel on this machine."""
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
        return out or "the profiler recorded no device kernels"
    except Exception as e:  # noqa: BLE001 — a measurement, not the check
        return f"profiler failed: {e!r}"[:300]


def _span_s(name: str) -> float:
    return sum(sp["t1"] - sp["t0"] for sp in telemetry.get().spans()
               if sp["name"] == name) / 1e9


def _recording(module, name, store):
    """Replaces module.name with a wrapper that keeps each call's
    arguments and result; returns the original."""
    original = getattr(module, name)

    def wrapper(*args, **kw):
        out = original(*args, **kw)
        store.append((args, kw, out))
        return out

    setattr(module, name, wrapper)
    return original


def elle_main_path(dev, on_card: bool, n_txns: int
                   ) -> tuple[list, dict, dict]:
    """Phase 8: the Elle checkers at full size. Returns the recorded scc
    launches (check name, args, out), the launches per check, and the
    histories and wall seconds of each check (phase 19 checks them
    again through compose)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    la = synth.list_append_history(n_txns, seed=11)
    twin, bad_idx = synth.corrupt_list_append_history(la, at_frac=0.85)
    rw = synth.rw_register_history(n_txns, seed=17)
    opts = {"device": dev}
    checks = [("list-append", la, cycle.append_checker(opts), True),
              ("list-append-corrupted", twin, cycle.append_checker(opts),
               False),
              ("rw-register", rw, cycle.wr_checker(opts), True)]
    recorded, per_check = [], {}
    direct = {"histories": {name: h for name, h, _c, _v in checks},
              "check_s": {}}
    calls: list = []
    original = _recording(kscc, "scc_labels", calls)
    try:
        for name, h, chk, valid in checks:
            calls.clear()
            kscc.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            res = chk.check({}, h)
            sync()
            t1 = time.perf_counter()
            launches = kscc.launches
            counters = telemetry.get().counters()
            family = name.removesuffix("-corrupted")
            spans = {"host_encode_s": _span_s(f"elle:{family}"),
                     "cycle_search_s": _span_s("elle:cycles"),
                     "scc_device_s": _span_s("scc:device"),
                     "certify_s": _span_s("certify.attach")}
            certify.validate(h, res["certificate"])
            t2 = time.perf_counter()
            if res["valid?"] is not valid:
                raise AssertionError(f"{name}: valid? {res['valid?']} "
                                     f"{res['anomaly-types']}")
            if on_card and launches < 1:
                raise AssertionError(f"{name}: no scc kernel launch")
            if "degradation" in res:
                raise AssertionError(f"{name}: {res['degradation']}")
            if n_txns == ELLE_TXNS:
                # every graph of the full-size checks is past
                # DEVICE_MIN_EDGES: each one must be solved by one launch
                # of the kernel, none by the host or a second launch
                off = {k: counters.get(k, 0) for k in
                       ("scc.path.host", "scc.device-nonconverged")}
                if any(off.values()):
                    raise AssertionError(f"{name}: off the card {off}")
                if on_card and counters.get("scc.path.device") != launches:
                    raise AssertionError(
                        f"{name}: {launches} launches for "
                        f"{counters.get('scc.path.device')} device solves")
            if name == "list-append-corrupted" and n_txns == ELLE_TXNS:
                # the full-size twin's known shape (smaller rehearsal
                # sizes damage another read)
                if "G0" not in res["anomaly-types"]:
                    raise AssertionError(f"twin: {res['anomaly-types']}")
                if on_card and launches != 5:
                    raise AssertionError(f"twin: {launches} launches")
            per_check[name] = launches
            direct["check_s"][name] = t1 - t0
            recorded += [(name, a, o) for a, _kw, o in calls]
            emit({"phase": "elle", "check": name, "txns": res["txn-count"],
                  "edges": res["edge-count"], "valid": res["valid?"],
                  "anomaly_types": res["anomaly-types"],
                  "damaged_op": bad_idx if name.endswith("corrupted")
                  else None,
                  "scc_launches": launches,
                  "scc_device_path": counters.get("scc.path.device", 0),
                  "scc_host_path": counters.get("scc.path.host", 0),
                  "scc_nonconverged": counters.get(
                      "scc.device-nonconverged", 0),
                  "certificate": ("cycle" if "cycle" in res["certificate"]
                                  else "topo-order"),
                  "check_s": t1 - t0, **spans, "validate_s": t2 - t1,
                  "txns_per_s": res["txn-count"] / (t1 - t0)})
    finally:
        kscc.scc_labels = original
    return recorded, per_check, direct


def elle_cross_check(dev, n_txns: int) -> History:
    """Phase 9: card against CPU against the host engine. Returns the
    corrupted list-append history."""
    la = synth.list_append_history(n_txns, seed=11)
    la_bad = synth.corrupt_list_append_history(la, 0.85)[0]
    rw = synth.rw_register_history(n_txns, seed=17)
    cases = [("list-append", la, elle.check_list_append),
             ("list-append-corrupted", la_bad, elle.check_list_append),
             ("rw-register", rw, elle.check_rw_register),
             ("rw-register-corrupted",
              synth.corrupt_rw_register_history(rw, 0.85)[0],
              elle.check_rw_register)]
    for name, h, check in cases:
        t0 = time.perf_counter()
        card = _norm(check(h, {"engine": "device", "device": dev}))
        t1 = time.perf_counter()
        cpu = _norm(check(h, {"engine": "device", "device": "cpu"}))
        t2 = time.perf_counter()
        host = _norm(check(h, {"engine": "host"}))
        t3 = time.perf_counter()
        if card != cpu:
            raise AssertionError(f"{name}: card {card} != cpu {cpu}")
        # the host engine alone attributes edges per key (search keys and
        # per-key-edges), as in the reference; everything else is equal
        for k in ("keys", "per-key-edges"):
            host["search"].pop(k, None)
        if card != host:
            raise AssertionError(f"{name}: card {card} != host {host}")
        if card["valid?"] is name.endswith("corrupted"):
            raise AssertionError(f"{name} judged {card['valid?']}")
        emit({"phase": "elle-cross-check", "check": name,
              "txns": card["txn-count"], "edges": card["edge-count"],
              "anomaly_types": card["anomaly-types"], "identical": True,
              "card_s": t1 - t0, "cpu_plain_s": t2 - t1,
              "host_engine_s": t3 - t2})
    return la_bad


def _raise_balance(hist, at_frac: float):
    ops = list(hist)
    for i in range(int(len(ops) * at_frac), len(ops)):
        o = ops[i]
        if o.type == "ok" and o.f == "read":
            ops[i] = o.copy(value={**o.value, 0: o.value[0] + 1})
            return type(hist)(ops, assign_indices=False), i
    raise ValueError("no ok read to corrupt")


def _numpy_fold_first_error(hist, total: int):
    """The first error of the plain numpy fold over the balance matrix."""
    reads = [o for o in hist
             if o.type == "ok" and o.f == "read" and o.value is not None]
    mat = np.array([list(o.value.values()) for o in reads], dtype=np.int64)
    sums = mat.sum(axis=1)
    bad = np.flatnonzero((sums != total) | (mat < 0).any(axis=1))
    if not bad.size:
        return None
    i = int(bad[0])
    if sums[i] != total:
        return {"type": "wrong-total", "expected": total,
                "found": int(sums[i]), "op": reads[i]}
    return {"type": "negative-value",
            "found": [int(b) for b in mat[i] if b < 0], "op": reads[i]}


def bank_path(dev, on_card: bool, n_txns: int
              ) -> tuple[list, int, dict]:
    """Phase 10: the bank checker on the card. Returns the recorded
    bank_reduce launches, the launch count of the valid check, and the
    histories, total, wall seconds and the twin's first error (phase 19
    checks them again through compose)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    accounts = 32
    total = accounts * 10
    h = synth.bank_history(n_txns, n_accounts=accounts, seed=11)
    twin, bad_idx = _raise_balance(h, 0.85)
    calls: list = []
    original = _recording(kbank, "bank_reduce", calls)
    try:
        kbank.launches = 0
        t0 = time.perf_counter()
        res = bank.check_fast(h, total, device=dev)
        sync()
        t1 = time.perf_counter()
        launches = kbank.launches
        main = list(calls)
        bres = bank.check_fast(twin, total, device=dev)
        sync()
    finally:
        kbank.bank_reduce = original
    if res["valid?"] is not True:
        raise AssertionError(f"bank history not valid: {res}")
    if on_card and launches < 1:
        raise AssertionError("the bank path launched no kernel")
    want = _numpy_fold_first_error(twin, total)
    if bres["valid?"] is not False or _norm(bres["first-error"]) != \
            _norm(want):
        raise AssertionError(f"bank twin: {bres} != numpy fold {want}")
    emit({"phase": "bank", "txns": n_txns, "accounts": accounts,
          "reads": res["read-count"], "valid": res["valid?"],
          "bank_reduce_launches": launches, "check_s": t1 - t0,
          "corrupted_op": bad_idx, "corrupted_first_error": {
              k: v for k, v in bres["first-error"].items() if k != "op"},
          "corrupted_error_count": bres["error-count"],
          "equals_numpy_fold": True})
    return main, launches, {"history": h, "twin": twin, "total": total,
                            "check_s": t1 - t0, "first_error": want}


def _scc_jacobi_bytes(src, dst, on, n: int, out) -> tuple[int, float, list]:
    """(bytes, ms at the memory rate, per-round work) of one scc launch
    as the kernel ran it before its redesign, from the live edges of each
    of its rounds (the plain version's count, which must agree with the
    kernel's rounds and sweeps). Kept so that the times before and after
    the redesign compare against one count; it is not a bound, since the
    redesigned kernel moves fewer bytes. Per round: the live mask is
    rebuilt (edge_on and the new mask over every edge, src, dst and two
    active flags for each edge of the subset) and the colours set (active
    read, c written); each forward sweep reads the mask over every edge,
    src, dst, the source's colour and the target's prop for each live
    edge, and reads and writes each node's value; the same-colour mask is
    cut (the mask, and src, dst and both colours of each live edge) and
    the membership set; each backward sweep is a forward sweep over the
    same-colour edges; the retire pass reads active and m and writes the
    labels and active."""
    E, E_on = src.numel(), int(on.sum())
    work = kscc.scc_rounds(src, dst, on, n)
    tail = out[n:].tolist()
    if len(work) != tail[1] or sum(f + b for *_x, f, b in work) != tail[2]:
        raise AssertionError(f"scc work {work} disagrees with the "
                             f"kernel's rounds and sweeps {tail}")
    nbytes = 0
    for live, same, fwd, bwd in work:
        nbytes += 2 * E + 10 * E_on + 5 * n
        nbytes += fwd * (E + 16 * live + 8 * n)
        nbytes += E + 16 * live + 9 * n
        nbytes += bwd * (E + 16 * same + 8 * n)
        nbytes += 10 * n
    return nbytes, 1e3 * nbytes / PEAK_BYTES_PER_S, work


def _scc_bound(E: int, n: int) -> tuple[int, float]:
    """(bytes, bound ms) of one scc launch: the inputs read once and the
    outputs written once, src and dst (4 bytes) and edge_on (1) for each
    edge, a 4-byte label for each node and the three counts, over the
    memory rate. The operations, a compare per edge, are far below the
    32-bit rate."""
    nbytes = 9 * E + 4 * (n + 3)
    return nbytes, 1e3 * nbytes / PEAK_BYTES_PER_S


def _ptxas(info, name: str) -> list:
    """The ptxas lines (-Xptxas -v) of one kernel source: each entry
    function, its registers, its stack and spills."""
    if not info:
        return []
    return [ln.strip() for ln in info["ptxas"].get(name, "").splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def scc_timing(recorded, per_check, on_card: bool, info=None) -> dict:
    """Phase 11, scc: each main-path launch replayed on the kernel (CUDA
    events, and its grid syncs) and the plain version, against the plain
    outputs."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    per_launch, max_err = [], 0
    for check, (src, dst, on, n), out in recorded:
        tail = out[n:].tolist()
        nbytes, bound_ms = _scc_bound(src.numel(), n)
        jacobi_bytes, jacobi_ms, work = _scc_jacobi_bytes(src, dst, on, n,
                                                          out)
        kernel_ms = (_event_ms(lambda: kscc.scc_labels(src, dst, on, n),
                               reps=20) if on_card else None)
        syncs = _syncs(src.device, on_card)
        if on_card:
            kscc.scc_labels(src, dst, on, n, syncs=syncs)
        sync()
        t0 = time.perf_counter()
        want = kscc.scc_labels_reference(src, dst, on, n)
        sync()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        max_err = max(max_err, int((out.long() - want.long()).abs().max()))
        per_launch.append({"check": check, "nodes": n,
                           "edges": src.numel(),
                           "live_edges": int(on.sum()), "ok": tail[0],
                           "rounds": tail[1], "sweeps": tail[2],
                           "grid_syncs": (syncs.tolist()[0] if on_card
                                          else None),
                           "live_edges_per_round": [w[0] for w in work],
                           "same_colour_edges_per_round": [w[1]
                                                           for w in work],
                           "sweeps_per_round": [[w[2], w[3]]
                                                for w in work],
                           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                           "bound_ms": bound_ms, "bytes": nbytes,
                           "jacobi_bytes": jacobi_bytes,
                           "jacobi_bytes_ms": jacobi_ms})
    if on_card:
        prof = _device_kernels(lambda: [kscc.scc_labels(*a)
                                        for _c, a, _o in recorded])
        dev_us = ([us for name, us in prof if "scc_kernel" in name]
                  if isinstance(prof, list) else [])
        for x, us in zip(per_launch, dev_us):
            x["device_ms"] = us / 1e3
        if len(dev_us) != len(per_launch):
            emit({"phase": "scc-profile", "note": prof if isinstance(
                prof, str) else f"{len(dev_us)} scc kernels traced"})
    emit({"phase": "scc-launches", "launches": per_launch})
    if max_err:
        raise AssertionError(f"scc main-path launches differ from the "
                             f"plain version by up to {max_err}")
    ms = sum(x["kernel_ms"] for x in per_launch) if on_card else None
    return {
        "name": "scc",
        "route": "cuda",
        "source": "jepsen_tpu_torch/gpu/kernels/csrc/scc.cu",
        "replaces": "jepsen_tpu/tpu/scc.py:64",
        "launches": sum(per_check.values()),
        "launches_per_check": per_check,
        "max_abs_err": max_err,
        "ms": ms,
        "ms_per_launch": ms / len(per_launch) if on_card else None,
        "device_ms": (sum(x["device_ms"] for x in per_launch)
                      if per_launch and "device_ms" in per_launch[-1]
                      else None),
        "grid_syncs": (sum(x["grid_syncs"] for x in per_launch)
                       if on_card else None),
        "plain_ms": sum(x["plain_ms"] for x in per_launch),
        "bound_ms": sum(x["bound_ms"] for x in per_launch),
        "bound_by": "bytes",
        "jacobi_bytes_ms": sum(x["jacobi_bytes_ms"] for x in per_launch),
        "library_ms": None,
        "ptxas": _ptxas(info, "scc"),
    }


def _flushed_ms(fn, flush, reps: int) -> list:
    """CUDA-event ms of `reps` launches of fn, each after a write of the
    whole `flush` buffer (outside the events), so fn finds L2 cold. The
    write keeps the card busy while the host enqueues fn, so the events
    time the kernel, not the host's launch."""
    times = []
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)


def _device_ms_by_mode(fn, flush, clean, name: str, reps: int = 9):
    """Median device ms (torch.profiler) of fn's kernel `name`: launched
    back to back (L2 as the last launch left it), after a write of
    `flush` (L2 full of dirty lines that the launch must write back), and
    after that write and a read of `clean` (L2 cold and clean)."""
    def run():
        for _ in range(reps + 1):  # the profiler may miss the first
            fn()
        for i in range(reps):
            flush.fill_(i)
            fn()
        for i in range(reps):
            flush.fill_(i)
            clean.sum()
            fn()
    prof = _device_kernels(run)
    if isinstance(prof, str):
        return {"warm": prof, "write_flushed": prof, "clean_flushed": prof}
    us = [u for n, u in prof if name in n][-3 * reps:]
    if len(us) != 3 * reps:
        note = f"{len(us)} {name} kernels traced, {3 * reps + 1} launched"
        return {"warm": note, "write_flushed": note, "clean_flushed": note}
    med = [sorted(us[k * reps:(k + 1) * reps])[reps // 2] / 1e3
           for k in range(3)]
    return {"warm": med[0], "write_flushed": med[1], "clean_flushed": med[2]}


def bank_timing(recorded, launches: int, on_card: bool, info=None) -> dict:
    """Phase 11, bank_reduce: the main path's launch replayed on the
    kernel, the plain version and the PyTorch reduction (the same two
    calls, timed as the library yardstick). Kernel and library by CUDA
    events with L2 flushed before each launch (a 256 MB write); the
    kernel also by the profiler's device time back to back, after that
    write, and after the write and a 256 MB read (clean L2), and the
    library's kernels back to back."""
    (mat,), _kw, out = recorded[0]
    want = kbank.bank_reduce_reference(mat)
    max_err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(out, want))
    rows, cols = mat.shape
    nbytes = rows * cols * 8 + rows * 9
    kernel_ms = library_ms = None
    device = library_device = {}
    if on_card:
        flush = torch.empty(64 << 20, dtype=torch.int32, device=mat.device)
        clean = torch.ones(64 << 20, dtype=torch.int32, device=mat.device)
        k = _flushed_ms(lambda: kbank.bank_reduce(mat), flush, 21)
        lib = _flushed_ms(lambda: (mat.sum(1), (mat < 0).any(1)), flush, 21)
        kernel_ms, library_ms = k[len(k) // 2], lib[len(lib) // 2]
        plain_ms = _event_ms(lambda: kbank.bank_reduce_reference(mat),
                             reps=20)
        device = _device_ms_by_mode(lambda: kbank.bank_reduce(mat), flush,
                                    clean, "bank_reduce")
        prof = _device_kernels(lambda: [(mat.sum(1), (mat < 0).any(1))
                                        for _ in range(5)])
        library_device = {"warm": (sum(u for _n, u in prof) / 5e3
                                   if isinstance(prof, list) else prof)}
        del flush, clean
    else:
        t0 = time.perf_counter()
        kbank.bank_reduce_reference(mat)
        plain_ms = 1e3 * (time.perf_counter() - t0)
    if max_err:
        raise AssertionError(f"bank_reduce differs from the plain version "
                             f"by {max_err}")
    bound_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    shares = {mode: (bound_ms / ms if isinstance(ms, float) else None)
              for mode, ms in device.items()}
    emit({"phase": "bank-timing", "shape": [rows, cols],
          "flushed_event_ms": kernel_ms, "device_ms": device,
          "bound_ms": bound_ms, "share_of_bound_by_device_ms": shares,
          "library_flushed_event_ms": library_ms,
          "library_device_ms": library_device})
    return {
        "name": "bank_reduce",
        "route": "cuda",
        "source": "jepsen_tpu_torch/gpu/kernels/csrc/bank_reduce.cu",
        "replaces": "jepsen_tpu/workloads/bank.py:98",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "device_ms": device,
        "library_device_ms": library_device,
        "shape": [rows, cols],
        "ptxas": _ptxas(info, "bank_reduce"),
    }


def ensemble_against_plain(dev, on_card: bool, n_rows: int) -> int:
    """Phase 3, the ensemble's shapes: n_rows crashed 400-op rows at
    W=32, F=64 (the successor buffer of 4,096 keys puts a block past the
    48 KB shared-memory default), and one launch over a one-device
    ensemble layout with unreferenced and repeated segments, against the
    plain version followed by a numpy gather."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    m = models.cas_register()
    encs = [encode(m, ensemble_hist(i)) for i in range(max(n_rows, 12))]
    total = 0
    pb = wgl.PackedBatch(encs[:n_rows])
    rows = [(i, e.init_state) for i, e in enumerate(encs[:n_rows])]
    smem = ws.library_smem_bytes(32, 64, False) if on_card else None
    for reach in (False, True):
        packed, rs, s0 = pb.tensors(*pb.rows(rows), dev)
        kw = dict(W=32, F=64, max_iters=pb.M + 4, reach=reach,
                  crash_free=False)
        sync()
        t0 = time.perf_counter()
        got = ws.wgl_search(packed, rs, s0, **kw)
        sync()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        sync()
        t_plain = time.perf_counter() - t0
        mism = _mismatches(got, want)
        total += sum(mism)
        emit({"phase": "kernel-vs-plain",
              "case": f"ensemble-{n_rows}x400-crash0.15-"
                      f"{'reach' if reach else 'verdict'}",
              "M": pb.M, "rows": len(rows), "entries": int(pb.m.sum()),
              "W": 32, "F": 64, "reach": reach, "crash_free": False,
              "smem_bytes": smem, "levels": int(want[-4]),
              "path_levels": _path_levels(packed, rs, s0, kw, on_card),
              "unknown_rows": int((want[1] if reach else want[0] == -1)
                                  .sum()),
              "mismatches": mism, "kernel_s": t_kernel,
              "plain_s": t_plain})
    sub = wgl.PackedBatch(encs[:12])
    # segments 1, 2, 4, 6, 7, 8 and 10 unreferenced; 0, 3 and 9 repeated
    lrows = [(0, 0), (3, 1), (3, 0), (5, 2), (3, 1), (9, 4), (11, 0),
             (0, 3), (9, 4)]
    lay = ensemble.shard_layout(sub, lrows, 1)
    for reach in (False, True):
        calls: list = []
        original = _recording(wgl, "_run", calls)
        try:
            got = wgl._drain(ensemble.sharded_launch(sub, lrows, 32, 64,
                                                     reach=reach, mesh=dev),
                             reach=reach)
        finally:
            wgl._run = original
        r = _replay(calls[0], on_card)
        # the launch's rows in caller order: the plain version's outputs
        # gathered through inv_perm on the host
        (packed, rs, s0, W, F, max_iters, _r), kw, _out = calls[0]
        want = ws.wgl_search_reference(packed, rs, s0, W=W, F=F,
                                       max_iters=max_iters, reach=reach,
                                       crash_free=kw["crash_free"])
        idx = lay.inv_perm[:len(lrows)]
        gathered = sum(int(np.sum(np.asarray(g) != w.cpu().numpy()[idx]))
                       for g, w in zip(got if reach else (got,), want))
        total += r["mismatches"] + gathered
        emit({"phase": "kernel-vs-plain",
              "case": f"ensemble-layout-{'reach' if reach else 'verdict'}",
              "segments": sub.B, "layout_segments": int(lay.mseg.size),
              "rows": len(lrows), "layout_rows": int(lay.row_seg.size),
              "levels": r["levels"], "mismatches": r["mismatches"],
              "gathered_mismatches": gathered})
    return total


def _drains() -> list[dict]:
    return [sp.get("attrs", {}) for sp in telemetry.get().spans()
            if sp["name"] == "wgl:drain"]


def _ensemble_counters(c: dict) -> dict:
    return {"host_resolved_rows": c.get("wgl.host-resolved-rows", 0),
            "host_resolved_s": c.get("wgl.host-resolved-ns", 0) / 1e9,
            "encode_s": c.get("profiler.encode.encode_ns", 0) / 1e9,
            "pack_s": c.get("profiler.pack.encode_ns", 0) / 1e9,
            "h2d_enqueue_s": c.get("wgl.kernel.h2d_ns", 0) / 1e9,
            "drain_wait_s": c.get("wgl.kernel.execute_ns", 0) / 1e9}


def ensemble_path(dev, on_card: bool, hists, chunk: int, bad: int) -> dict:
    """Phase 12: BASELINE config 5 through analysis_batch_streamed (three
    runs), analysis_batch and analysis_batch_sharded, with the kernel
    launch count set to 0 just before each and read just after; then the
    twin with member `bad` corrupted. Returns the recorded launches of
    each path and the launch counts."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    model = models.cas_register()
    n = len(hists)
    events = sum(len(h) for h in hists)
    per_path: dict = {"ensemble-streamed": []}
    recorded: dict = {}
    calls: list = []
    original = _recording(wgl, "_run", calls)
    try:
        for rep in range(3):
            calls.clear()
            ws.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            res = wgl.analysis_batch_streamed(model, hists, chunk=chunk,
                                              device=dev)
            sync()
            t1 = time.perf_counter()
            launches = ws.launches
            not_valid = [i for i, r in enumerate(res)
                         if r["valid?"] is not True]
            if not_valid:
                raise AssertionError(f"ensemble members not valid: "
                                     f"{not_valid[:20]}")
            if on_card and launches != -(-n // chunk):
                raise AssertionError(f"{launches} launches for {n} "
                                     f"histories in chunks of {chunk}")
            drains = _drains()
            emit({"phase": "ensemble", "entry": "analysis_batch_streamed",
                  "rep": rep, "histories": n, "events": events,
                  "chunk": chunk, "wall_s": t1 - t0,
                  "events_per_s": events / (t1 - t0),
                  "wgl_search_launches": launches,
                  **_ensemble_counters(telemetry.get().counters()),
                  "kernel_ms": [d["device_ms"] for d in drains],
                  "drain_wait_ms": [d["wait_ns"] / 1e6 for d in drains],
                  "levels": [d["levels"] for d in drains],
                  "analyzers": sorted({r["analyzer"] for r in res})})
            per_path["ensemble-streamed"].append(launches)
        recorded["streamed"] = (list(calls), _drains())
        verdicts = [r["valid?"] for r in res]
        for entry in ("analysis_batch", "analysis_batch_sharded"):
            calls.clear()
            ws.launches = ensemble.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            if entry == "analysis_batch":
                res = wgl.analysis_batch(model, hists, device=dev)
            else:
                res = ensemble.analysis_batch_sharded(model, hists,
                                                      mesh=dev)
            sync()
            t1 = time.perf_counter()
            launches = ws.launches
            if [r["valid?"] for r in res] != verdicts:
                raise AssertionError(f"{entry} disagrees with the "
                                     "streamed verdicts")
            if on_card and launches != 1:
                raise AssertionError(f"{entry}: {launches} launches")
            if entry.endswith("sharded"):
                per_path["ensemble-sharded (B2)"] = ensemble.launches
                if on_card and ensemble.launches != 1:
                    raise AssertionError(f"{ensemble.launches} sharded "
                                         "launches")
            per_path[entry] = launches
            recorded[entry] = (list(calls), _drains())
            emit({"phase": "ensemble", "entry": entry, "histories": n,
                  "wall_s": t1 - t0, "events_per_s": events / (t1 - t0),
                  "wgl_search_launches": launches,
                  "sharded_launches": ensemble.launches,
                  **_ensemble_counters(telemetry.get().counters()),
                  "kernel_ms": [d["device_ms"] for d in _drains()],
                  "analyzers": sorted({r["analyzer"] for r in res})})
    finally:
        wgl._run = original
    twin = list(hists)
    twin[bad] = synth.corrupt_register_history(hists[bad],
                                               at_frac=TWIN_AT_FRAC)[0]
    telemetry.reset()
    t0 = time.perf_counter()
    tres = wgl.analysis_batch_streamed(model, twin, chunk=chunk,
                                       device=dev)
    sync()
    t1 = time.perf_counter()
    not_valid = [i for i, r in enumerate(tres) if r["valid?"] is not True]
    w = tres[bad]
    if not_valid != [bad] or w["valid?"] is not False:
        raise AssertionError(f"twin: members {not_valid[:20]} not valid")
    if w.get("op") is None and not w.get("configs"):
        raise AssertionError(f"twin member {bad} carries no witness: {w}")
    emit({"phase": "ensemble-twin", "member": bad,
          "at_frac": TWIN_AT_FRAC, "invalid_members": not_valid,
          "analyzer": w["analyzer"],
          "witness_extraction": w["witness-extraction"],
          "witness_entry": w.get("witness-entry"),
          "op_indices": w.get("op-indices"), "wall_s": t1 - t0,
          **_ensemble_counters(telemetry.get().counters())})
    und = encode(model, synth.corrupt_register_history(
        hists[bad], at_frac=UNDECIDED_AT_FRAC)[0])
    code = int(wgl.check_batch([und], device=dev)[0])
    if code == wgl.VALID:
        raise AssertionError(f"member {bad} corrupted at "
                             f"{UNDECIDED_AT_FRAC} judged VALID")
    emit({"phase": "ensemble-twin-undecided", "member": bad,
          "at_frac": UNDECIDED_AT_FRAC, "entries": und.m,
          "crashed_entries": int(und.crashed.sum()), "kernel_code": code,
          "host_search": "not run (exponential in the crashed writes "
                         "before the bad read)"})
    return {"recorded": recorded, "per_path": per_path}


def independent_path(dev, on_card: bool, hists, bad: int,
                     n_validate: int = 15) -> tuple[dict, dict]:
    """Phase 13: the independent-key checker over the ensemble folded
    into one multi-key history, and its twin. Returns the launches per
    check, and the two histories and each check's wall seconds (phase 19
    checks them again through compose)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n = len(hists)
    t0 = time.perf_counter()
    multi = fold_keys(hists)
    twin_hists = list(hists)
    twin_hists[bad] = synth.corrupt_register_history(
        hists[bad], at_frac=TWIN_AT_FRAC)[0]
    twin = fold_keys(twin_hists)
    fold_s = time.perf_counter() - t0
    chk = independent.checker(linearizable({"model": models.cas_register(),
                                            "device": dev}))
    per_path = {}
    direct = {"histories": {"independent": multi,
                            "independent-twin": twin}, "check_s": {}}
    for name, h in (("independent", multi), ("independent-twin", twin)):
        ws.launches = 0
        telemetry.reset()
        t0 = time.perf_counter()
        res = chk.check({}, h)
        sync()
        t1 = time.perf_counter()
        launches = ws.launches
        c = telemetry.get().counters()
        results = res["results"]
        if len(results) != n:
            raise AssertionError(f"{name}: {len(results)} keys, want {n}")
        odd = [k for k, r in results.items()
               if "error" in r or not isinstance(r["valid?"], bool)]
        if odd:
            raise AssertionError(f"{name}: keys {odd[:10]} errored")
        if on_card and launches != 1:
            raise AssertionError(f"{name}: {launches} wgl launches")
        n_cert = c.get("certify.extracted", 0) + c.get("certify.absent", 0)
        if n_cert != n:
            raise AssertionError(f"{name}: {n_cert} certificates for {n}")
        want_failures = [] if name == "independent" else [bad]
        if res["valid?"] is not (not want_failures) \
                or res["failures"] != want_failures:
            raise AssertionError(f"{name}: valid? {res['valid?']} "
                                 f"failures {res['failures'][:10]}")
        absent = {k: r["certificate"]["absent"] for k, r in results.items()
                  if "absent" in r["certificate"]}
        present = sorted(k for k in results if k not in absent)
        if name == "independent":
            rng = np.random.default_rng(13)
            sample = sorted(int(k) for k in rng.choice(
                present, size=min(n_validate, len(present)),
                replace=False))
        else:
            sample = [bad] if bad in present else []
        t2 = time.perf_counter()
        digest = certify.history_digest(h)
        for k in sample:
            certify.validate(h, results[k]["certificate"], digest=digest)
        t3 = time.perf_counter()
        per_path[name] = launches
        direct["check_s"][name] = t1 - t0
        emit({"phase": "independent", "check": name, "keys": n,
              "events": len(h), "valid": res["valid?"],
              "failures": res["failures"], "wgl_search_launches": launches,
              "certify_extracted": c.get("certify.extracted", 0),
              "certify_absent": c.get("certify.absent", 0),
              "absent": {str(k): v for k, v in absent.items()},
              "validated_keys": sample, "validate_s": t3 - t2,
              "fold_s": fold_s, "check_s": t1 - t0,
              "events_per_s": len(h) / (t1 - t0),
              "subhistories_s": _span_s("independent:subhistories"),
              "kernel_ms": [d["device_ms"] for d in _drains()],
              "certify_attach_s": _span_s("certify.attach"),
              **_ensemble_counters(c)})
    return per_path, direct


def _slices_against_host(dev, on_card: bool, slices, seed: int):
    """check_slices over `slices` in one launch at W=24, F=48 on `dev`;
    every row the card answers as known searched on the host
    (search_host_reach), and 8 rows picked by `seed` run again through
    check_slices on the CPU. Unknown rows are not searched (ROADMAP C3).
    Returns (out, unk, {row: host mask}, launch s, host s, CPU rows,
    whether the CPU rows equal the card's)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out, unk = wgl.check_slices(slices, W=24, F=48, device=dev)
    sync()
    t1 = time.perf_counter()
    host = {i: wgl.search_host_reach(e.with_init(s))
            for i, (e, s) in enumerate(slices) if not unk[i]}
    t2 = time.perf_counter()
    pick = sorted(int(i) for i in np.random.default_rng(seed).choice(
        len(slices), size=8, replace=False))
    cpu_out, cpu_unk = wgl.check_slices([slices[i] for i in pick], W=24,
                                        F=48, device="cpu")
    cpu_equal = (cpu_out.tolist() == out[pick].tolist()
                 and cpu_unk.tolist() == unk[pick].tolist())
    return out, unk, host, t1 - t0, t2 - t1, pick, cpu_equal


def slices_path(dev, on_card: bool, hists, n: int) -> int:
    """Phase 14: check_slices in the fleet's shape. Rows are every start
    state of the first n ensemble histories (each one Encoded object,
    shared by its rows) and of their crash-free twins (same seeds,
    crash_p 0), in one launch at W=24, F=48. Every row the card answers
    as known must equal the host reach search; unknown rows are counted
    and listed. Returns the launch count."""
    model = models.cas_register()
    groups = {"crashed": [encode(model, h) for h in hists[:n]],
              "crash-free": [encode(model, ensemble_hist(i, crash_p=0.0))
                             for i in range(n)]}
    slices, where = [], []
    for g, encs in groups.items():
        for i, e in enumerate(encs):
            for s in range(e.n_states):
                slices.append((e, s))
                where.append((g, i, s))
    ws.launches = 0
    telemetry.reset()
    out, unk, host, card_s, host_s, pick, cpu_equal = \
        _slices_against_host(dev, on_card, slices, 14)
    launches = ws.launches
    if on_card and launches != 1:
        raise AssertionError(f"check_slices: {launches} launches")
    bad = [where[i] for i, h in host.items() if h != int(out[i])]
    if bad:
        raise AssertionError(f"check_slices rows differ from the host "
                             f"reach search: {bad[:10]}")
    if not cpu_equal:
        raise AssertionError(f"check_slices card {out[pick]} {unk[pick]} "
                             f"!= cpu on rows {pick}")
    unknown = {g: sorted({i for (gg, i, _s), u in zip(where, unk)
                          if u and gg == g}) for g in groups}
    emit({"phase": "check_slices", "rows": len(slices),
          "segments": sum(len(v) for v in groups.values()),
          "wgl_search_launches": launches, "card_s": card_s,
          "known_rows": len(host), "unknown_rows": int(unk.sum()),
          "unknown_rows_by_group": {
              g: sum(1 for (gg, _i, _s), u in zip(where, unk)
                     if u and gg == g) for g in groups},
          "histories_with_unknown_rows": unknown,
          "host_reach_of_known_rows_s": host_s,
          "cpu_rows": [where[i] for i in pick], "cpu_equal": True})
    return launches


def _replay(rec, on_card: bool) -> dict:
    """One recorded `wgl._run` call replayed: the kernel by CUDA events,
    the plain version, its bound, and the largest difference between the
    recorded outputs and the plain version's."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    args, kw, launch = rec
    packed, rs, s0, W, F, max_iters, reach = args
    kkw = dict(W=W, F=F, max_iters=max_iters, reach=reach,
               crash_free=kw["crash_free"])

    def card():
        return ws.wgl_search(packed, rs, s0, **kkw)

    kernel_ms = _event_ms(card, reps=3) if on_card else None
    paths = _path_levels(packed, rs, s0, kkw, on_card)
    sync()
    t0 = time.perf_counter()
    want = list(ws.wgl_search_reference(packed, rs, s0, **kkw))
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    got = [o.to(rs.device) for o in launch.outs]
    nbytes, ops, bound_ms = _launch_bound(packed, rs, kkw, got)
    return {"rows": int(rs.numel()), "M": int(packed[0].shape[1]),
            "reach": reach, "levels": int(want[-4]),
            "kernel_ms": kernel_ms,
            "us_per_level": _us_per_level(kernel_ms, int(want[-4])),
            "path_levels": paths, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bytes": nbytes, "operations": ops,
            "max_abs_err": _max_abs_err(got, want),
            "mismatches": sum(_mismatches(got, want))}


def _cert_bytes(res: dict) -> bytes:
    return json.dumps(jsonable(res["certificate"]),
                      sort_keys=True).encode()


def _prefix(ops: list, frac: float) -> list:
    return ops[:int(len(ops) * frac)]


def _extend_run(dev, model, ops, store, certify_on: bool) -> dict:
    """One analysis_extend on the card, with the wgl_search count set to
    0 just before and read just after: its result, counters, launches,
    wall seconds and the device ms of its launches (wgl:drain spans)."""
    telemetry.reset()
    ws.launches = 0
    t0 = time.perf_counter()
    res = wgl.analysis_extend(model, History(ops), store_path=store,
                              certify=certify_on, device=dev)
    seconds = time.perf_counter() - t0
    c = telemetry.get().counters()
    return {"result": res, "counters": c, "launches": ws.launches,
            "seconds": seconds,
            "kernel_ms": sum(d.get("device_ms") or 0 for d in _drains()),
            "rows": c.get("wgl.kernel.rows", 0),
            "certify_s": _span_s("certify.attach")}


def _matched_segments(old: dict, new: dict) -> int:
    """Segments of `new` whose two cuts and digests equal `old`'s: what
    check_extend may reuse."""
    matched = 0
    for a, b, x, y in zip(old["cuts"], new["cuts"], old["digests"],
                          new["digests"]):
        if a != b or x != y:
            break
        matched += 1
    return max(0, matched - 1)


def _extend_line(name: str, r: dict, on_card: bool, **extra) -> dict:
    c = r["counters"]
    return {"phase": "extend", "run": name,
            "valid": r["result"]["valid?"],
            "failed_segment": r["result"].get("failed-segment"),
            "seconds": r["seconds"], "wgl_search_launches": r["launches"],
            "rows": r["rows"], "kernel_ms": r["kernel_ms"],
            "reused_masks": c.get("ckpt.extend.reused-masks", 0),
            "computed_masks": c.get("ckpt.extend.computed-masks", 0),
            "torn": c.get("ckpt.torn", 0), "stale": c.get("ckpt.stale", 0),
            "host_resolved_rows": c.get("wgl.host-resolved-rows", 0),
            "host_resolved_s": c.get("wgl.host-resolved-ns", 0) / 1e9,
            "encode_s": c.get("profiler.encode.encode_ns", 0) / 1e9,
            "pack_s": c.get("profiler.pack.encode_ns", 0) / 1e9,
            "certify_s": r["certify_s"],
            **extra, "card": nvidia_smi_line() if on_card else "cpu"}


def _extend_masks(dev, on_card: bool, enc, cuts, rec) -> dict:
    """The extend path's launch held against the host: every (segment,
    state) row of the whole history through _slices_against_host, in one
    launch at check_extend's shape, as a fresh run makes it; every mask
    of the resumed run's record (reused or computed) is held against the
    same host search where the row is known."""
    K, S = len(cuts) - 1, enc.n_states
    if rec["cuts"] != [int(c) for c in cuts] or \
            rec["states"] != [repr(x) for x in enc.states]:
        raise AssertionError("the resumed record's cuts or states differ "
                             "from the history's encoding")
    segs = [enc.segment(cuts[k], cuts[k + 1]) for k in range(K)]
    keys = [(k, s) for k in range(K) for s in range(S)]
    out, unk, host, card_s, host_s, pick, cpu_equal = _slices_against_host(
        dev, on_card, [(segs[k], s) for k, s in keys], 16)
    bad = [keys[i] for i, h in host.items() if h != int(out[i])]
    masks = rec["masks"]
    on_rec = [i for i in host if f"{keys[i][0]}:{keys[i][1]}" in masks]
    bad_rec = [keys[i] for i in on_rec
               if masks[f"{keys[i][0]}:{keys[i][1]}"] != host[i]]
    line = {"phase": "extend-masks", "rows": len(keys),
            "known_rows": len(host), "unknown_rows": int(unk.sum()),
            "card_s": card_s, "mismatches": len(bad),
            "record_masks_checked": len(on_rec),
            "record_mismatches": len(bad_rec),
            "host_reach_of_known_rows_s": host_s,
            "cpu_rows": [keys[i] for i in pick], "cpu_equal": cpu_equal}
    emit(line)
    if bad or bad_rec or not cpu_equal:
        raise AssertionError(f"extend masks differ from the host reach "
                             f"search: launch {bad[:10]}, record "
                             f"{bad_rec[:10]}, cpu rows equal {cpu_equal}")
    return line


def extend_path(dev, on_card: bool, hist, bad) -> dict:
    """Phase 16: checkpoint-and-extend on the headline history. The
    first 90% of its ops writes a wgl-extend record; the whole history
    resumes from it and must equal, certificate byte for byte, a fresh
    analysis_extend without a store, computing at most (K - matched
    segments + 1) * S masks; the 85%-corrupted twin resumed from its
    clean 80% prefix must equal its fresh check (invalid, same failed
    segment, same certificate); a torn record counts ckpt.torn and
    gives the fresh verdict and certificate. The masks of the whole
    history's launch and record are held against the host
    (_extend_masks). Returns the launches of each run."""
    model = models.cas_register()
    ops, bad_ops = list(hist), list(bad)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = Path(tmp) / "extend.ckpt"
        r = _extend_run(dev, model, _prefix(ops, 0.9), store, False)
        prefix_rec = ckpt.read(store)
        if prefix_rec is None or r["counters"].get("ckpt.saved") != 1:
            raise AssertionError("the 90% prefix wrote no wgl-extend "
                                 "record")
        launches["extend-prefix"] = r["launches"]
        emit(_extend_line("prefix-90%", r, on_card,
                          ops=len(ops) * 9 // 10,
                          segments=len(prefix_rec["cuts"]) - 1))
        fresh = _extend_run(dev, model, ops, None, True)
        launches["extend-fresh"] = fresh["launches"]
        torn_store = Path(tmp) / "torn.ckpt"
        torn_store.write_bytes(store.read_bytes())
        resumed = _extend_run(dev, model, ops, store, True)
        launches["extend-resumed"] = resumed["launches"]
        # the entry digest chain, which every run computes on the host
        enc = encode(model, History(ops))
        cuts = wgl.segment_cuts(enc, wgl.EXTEND_STRIDE)
        t0 = time.perf_counter()
        ckpt.entry_digest_chain(enc, cuts)
        digest_s = time.perf_counter() - t0
        new_rec = ckpt.read(store)
        checked = _extend_masks(dev, on_card, enc, cuts, new_rec)
        del enc
        K = len(new_rec["cuts"]) - 1
        S = len(new_rec["states"])
        matched = _matched_segments(prefix_rec, new_rec)
        computed = resumed["counters"].get("ckpt.extend.computed-masks")
        fr, rr = fresh["result"], resumed["result"]
        same = _norm(rr) == _norm(fr) and \
            _cert_bytes(rr) == _cert_bytes(fr)
        emit(_extend_line("fresh", fresh, on_card, segments=K, states=S,
                          digest_chain_s=digest_s,
                          mask_mismatches=checked["mismatches"]))
        emit(_extend_line("resumed-from-90%", resumed, on_card,
                          segments=K, states=S, matched_segments=matched,
                          computed_bound=(K - matched + 1) * S,
                          certificate_equal=same,
                          mask_mismatches=checked["record_mismatches"]))
        if fr["valid?"] is not True or not same:
            raise AssertionError(f"resumed extend differs from fresh: "
                                 f"valid {fr['valid?']} / {rr['valid?']}")
        if matched < 1 or computed is None or \
                computed > (K - matched + 1) * S:
            raise AssertionError(f"resumed extend computed {computed} "
                                 f"masks, K={K} matched={matched} S={S}")
        if on_card and not (fresh["launches"] and resumed["launches"]):
            raise AssertionError("an extend run launched no kernel")
        certify.validate(hist, rr["certificate"])

        # the torn record: counted, the fresh verdict and certificate
        data = torn_store.read_bytes()
        torn_store.write_bytes(data[:len(data) // 2])
        torn = _extend_run(dev, model, ops, torn_store, True)
        launches["extend-torn"] = torn["launches"]
        emit(_extend_line("torn-record", torn, on_card))
        if torn["counters"].get("ckpt.torn") != 1 or \
                _norm(torn["result"]) != _norm(fr) or \
                _cert_bytes(torn["result"]) != _cert_bytes(fr):
            raise AssertionError("a torn record changed the result")

        # the 85%-corrupted twin, resumed from its clean 80% prefix
        twin_store = Path(tmp) / "twin.ckpt"
        r = _extend_run(dev, model, _prefix(bad_ops, 0.8), twin_store,
                        False)
        launches["extend-twin-prefix"] = r["launches"]
        twin_fresh = _extend_run(dev, model, bad_ops, None, True)
        twin = _extend_run(dev, model, bad_ops, twin_store, True)
        launches["extend-twin-fresh"] = twin_fresh["launches"]
        launches["extend-twin-resumed"] = twin["launches"]
        tf, tr = twin_fresh["result"], twin["result"]
        same = _norm(tr) == _norm(tf) and \
            _cert_bytes(tr) == _cert_bytes(tf)
        emit(_extend_line("twin-fresh", twin_fresh, on_card))
        emit(_extend_line("twin-resumed-from-80%", twin, on_card,
                          certificate_equal=same))
        if tf["valid?"] is not False or not same or \
                twin["counters"].get("ckpt.extend.resumed") != 1:
            raise AssertionError(f"the twin resumed {tr['valid?']} at "
                                 f"{tr.get('failed-segment')}, fresh "
                                 f"{tf['valid?']} at "
                                 f"{tf.get('failed-segment')}")
        certify.validate(bad, tr["certificate"])
    return {"launches": launches,
            "fresh": {k: fresh[k] for k in ("seconds", "launches",
                                             "kernel_ms", "rows")},
            "resumed": {k: resumed[k] for k in ("seconds", "launches",
                                                "kernel_ms", "rows")}}


def resumable_segmented(dev, on_card: bool, enc, target_len: int) -> dict:
    """Phase 17: check_segmented(enc, checkpoint_dir=...) on the headline
    history twice. The second run loads every mask the first saved and
    launches no kernel, with the same result."""
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(2):
            telemetry.reset()
            ws.launches = 0
            t0 = time.perf_counter()
            res = wgl.check_segmented(enc, target_len=target_len,
                                      device=dev, checkpoint_dir=tmp)
            seconds = time.perf_counter() - t0
            c = telemetry.get().counters()
            runs.append((res, c, ws.launches))
            emit({"phase": "segmented-checkpoint", "rep": rep,
                  "valid": res["valid?"], "segments": res["segments"],
                  "seconds": seconds, "wgl_search_launches": ws.launches,
                  "saved": c.get("wgl.checkpoint.saved", 0),
                  "loaded": c.get("wgl.checkpoint.loaded", 0),
                  "files": sorted(p.name for p in Path(tmp).iterdir()),
                  "card": nvidia_smi_line() if on_card else "cpu"})
    (first, c1, n1), (second, c2, n2) = runs
    if first["valid?"] is not True or second != first or n2 != 0 or \
            c2.get("wgl.checkpoint.loaded") != c1.get(
                "wgl.checkpoint.saved") or (on_card and n1 == 0):
        raise AssertionError(f"resumed segmented check: {n1} then {n2} "
                             f"launches, saved "
                             f"{c1.get('wgl.checkpoint.saved')}, loaded "
                             f"{c2.get('wgl.checkpoint.loaded')}")
    return {"segmented-checkpoint-first": n1,
            "segmented-checkpoint-resumed": n2}


def checker_extend(dev, on_card: bool, hist) -> dict:
    """Phase 18: the linearizable checker with a store directory and
    extend? on the card: valid, through analysis_extend, with a
    certificate that validates."""
    with tempfile.TemporaryDirectory() as tmp:
        telemetry.reset()
        ws.launches = 0
        t0 = time.perf_counter()
        res = linearizable({"model": models.cas_register(),
                            "device": dev}).check(
            {"store_dir": tmp, "extend?": True}, hist)
        seconds = time.perf_counter() - t0
        stored = sorted(p.name for p in (Path(tmp) / "ckpt").iterdir())
    certify.validate(hist, res["certificate"])
    emit({"phase": "checker-extend", "valid": res["valid?"],
          "analyzer": res["analyzer"], "seconds": seconds,
          "wgl_search_launches": ws.launches, "stored": stored,
          "card": nvidia_smi_line() if on_card else "cpu"})
    if res["valid?"] is not True or res["analyzer"] != "gpu-extend" or \
            len(stored) != 1 or (on_card and ws.launches == 0):
        raise AssertionError(f"checker extend?: {res['valid?']} "
                             f"{res['analyzer']} {stored}")
    return {"checker-extend": ws.launches}


RENDERERS = ("render_linear_svg", "write_linear_trace_excerpt",
             "write_elle_artifacts", "write_trace_excerpts")


def _files(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def _unsound(res, where: str = "") -> list[str]:
    """Where a composed result holds valid? "unknown" or an error."""
    out = []
    if isinstance(res, dict):
        if res.get("valid?") == "unknown" or "error" in res:
            out.append(where or "/")
        for k, v in res.items():
            out += _unsound(v, f"{where}/{k}")
    elif isinstance(res, (list, tuple)):
        for i, v in enumerate(res):
            out += _unsound(v, f"{where}/{i}")
    return out


def _rendering_timed(seconds: dict):
    """Replaces explain's renderers with wrappers that add each call's
    wall seconds to seconds[name] (the checkers call them from Compose's
    worker threads); returns the originals."""
    lock = threading.Lock()
    originals = {name: getattr(explain, name) for name in RENDERERS}

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                with lock:
                    seconds[name] = seconds.get(name, 0.0) + (
                        time.perf_counter() - t0)
        return wrapper

    for name, fn in originals.items():
        setattr(explain, name, timed(name, fn))
    return originals


def _composed(name: str, checker, history, store: Path, on_card: bool,
              direct_s, kernel: str) -> tuple[dict, dict]:
    """One composed check into `store`, every launch count set to 0 just
    before and read just after. Returns (result, line)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    render_s: dict = {}
    originals = _rendering_timed(render_s)
    ws.launches = kscc.launches = kscc.converge_launches = 0
    kbank.launches = 0
    telemetry.reset()
    try:
        t0 = time.perf_counter()
        res = checker.check({"store_dir": str(store)}, history)
        sync()
        wall = time.perf_counter() - t0
    finally:
        for fn_name, fn in originals.items():
            setattr(explain, fn_name, fn)
    launches = {"wgl_search": ws.launches, "scc": kscc.launches,
                "scc_converge": kscc.converge_launches,
                "bank_reduce": kbank.launches}
    bad = _unsound(res)
    if bad:
        raise AssertionError(f"{name}: unknown or error at {bad[:10]}")
    if on_card and launches[kernel] < 1:
        raise AssertionError(f"{name}: no {kernel} launch from compose")
    spans = {sp["name"]: (sp["t1"] - sp["t0"]) / 1e9
             for sp in telemetry.get().spans()
             if sp["name"].startswith("checker:")}
    line = {"phase": "composed", "check": name, "valid": res["valid?"],
            "wall_s": wall, "direct_s": direct_s,
            "checker_spans_s": spans, "render_s": render_s,
            "launches": launches, "files": len(_files(store)),
            "card": nvidia_smi_line() if on_card else "cpu"}
    return res, line


def composed_path(dev, on_card: bool, elle_direct: dict, la_bad_cross,
                  bank_direct: dict, ind_direct: dict, bad: int) -> dict:
    """Phase 19: the checker stacks a Jepsen test composes, on the card,
    over the histories of phases 8-10 and 13, each into a fresh store
    directory: (a) the register stack over the folded ensemble and its
    twin, whose key `bad` must leave a counterexample SVG equal to the
    one key `bad` checked alone on the CPU leaves; (b) the list-append
    stack over phase 8's history and its twin (G0 artifacts), and phase
    9's corrupted history through the card and the CPU, with the same
    files; (c) the bank stack. No sub-result may be "unknown" or carry
    an error. Returns the launches per check."""
    launches = {}
    register = chk.compose({
        "linear": independent.checker(linearizable(
            {"model": models.cas_register(), "device": dev})),
        "stats": chk.stats(), "exceptions": chk.unhandled_exceptions()})
    append = chk.compose({"elle": cycle.append_checker({"device": dev}),
                          "stats": chk.stats()})
    bank_stack = chk.compose({
        "bank": bank.checker({"total-amount": bank_direct["total"],
                              "device": dev}),
        "stats": chk.stats()})
    checks = [
        ("register", register, ind_direct["histories"]["independent"],
         ind_direct["check_s"]["independent"], "wgl_search"),
        ("register-twin", register,
         ind_direct["histories"]["independent-twin"],
         ind_direct["check_s"]["independent-twin"], "wgl_search"),
        ("list-append", append, elle_direct["histories"]["list-append"],
         elle_direct["check_s"]["list-append"], "scc"),
        ("list-append-twin", append,
         elle_direct["histories"]["list-append-corrupted"],
         elle_direct["check_s"]["list-append-corrupted"], "scc"),
        ("bank", bank_stack, bank_direct["history"],
         bank_direct["check_s"], "bank_reduce"),
        ("bank-twin", bank_stack, bank_direct["twin"], None,
         "bank_reduce")]
    with tempfile.TemporaryDirectory() as tmp:
        for name, checker, h, direct_s, kernel in checks:
            store = Path(tmp) / name
            store.mkdir()
            res, line = _composed(name, checker, h, store, on_card,
                                  direct_s, kernel)
            launches[f"composed-{name}"] = line["launches"][kernel]
            twin = name.endswith("-twin")
            if res["valid?"] is twin:
                raise AssertionError(f"{name}: valid? {res['valid?']}")
            if not twin and _files(store):
                raise AssertionError(f"{name}: valid, but wrote "
                                     f"{sorted(_files(store))[:5]}")
            if name == "register-twin":
                line.update(_register_twin(res, h, bad, store, Path(tmp)))
            elif name == "list-append-twin":
                line.update(_append_twin(res, store))
            elif name == "bank-twin":
                want = _norm(bank_direct["first_error"])
                if _norm(res["bank"]["first-error"]) != want:
                    raise AssertionError(f"bank twin: "
                                         f"{res['bank']['first-error']} "
                                         f"!= phase 10's {want}")
                line["first_error_equals_phase_10"] = True
            emit(line)
        line = _append_card_against_cpu(dev, on_card, la_bad_cross,
                                        Path(tmp))
        emit(line)
    return launches


def _register_twin(res, h, bad: int, store: Path, tmp: Path) -> dict:
    """(a): key `bad` invalid alone, its SVG on disk and byte-equal to
    the one its subhistory leaves when checked alone on the CPU."""
    linear = res["linear"]
    if linear["failures"] != [bad]:
        raise AssertionError(f"register twin: failures "
                             f"{linear['failures'][:10]}")
    svg = Path(linear["results"][bad]["counterexample-svg"])
    body = svg.read_bytes()
    if not body.startswith(b"<svg"):
        raise AssertionError(f"{svg} is not an SVG")
    alone = tmp / "register-key-alone"
    alone.mkdir()
    sub = independent.subhistories(h)[bad]
    t0 = time.perf_counter()
    cpu = linearizable({"model": models.cas_register(),
                        "device": "cpu"}).check({"store_dir": str(alone)},
                                                sub)
    cpu_s = time.perf_counter() - t0
    cpu_svg = Path(cpu["counterexample-svg"])
    if cpu_svg.name != svg.name or cpu_svg.read_bytes() != body:
        raise AssertionError(f"key {bad}: card {svg.name} != CPU alone "
                             f"{cpu_svg.name}")
    return {"failures": linear["failures"], "svg": svg.name,
            "svg_bytes": len(body), "svg_equals_cpu_alone": True,
            "cpu_alone_s": cpu_s}


def _append_twin(res, store: Path) -> dict:
    """(b): the twin's G0 and its artifacts on disk."""
    elle_res = res["elle"]
    # the full-size twin's known shape (smaller rehearsal sizes damage
    # another read, as in phase 8)
    want = ("G0" if elle_res["txn-count"] == ELLE_TXNS
            else elle_res["anomaly-types"][0])
    if want not in elle_res["anomaly-types"]:
        raise AssertionError(f"list-append twin: "
                             f"{elle_res['anomaly-types']}")
    paths = [Path(p) for p in elle_res.get("artifacts", [])]
    rel = [str(p.relative_to(store)) for p in paths]
    named = [r for r in rel
             if r.startswith(f"elle/{want}-") and r.endswith(".txt")]
    if not all(p.exists() for p in paths) or not named:
        raise AssertionError(f"list-append twin artifacts: {rel[:10]}")
    return {"anomaly_types": elle_res["anomaly-types"],
            "artifacts": len(rel), "anomaly_file": named[0]}


def _append_card_against_cpu(dev, on_card: bool, hist, tmp: Path) -> dict:
    """(b): phase 9's corrupted history through the list-append checker on
    the card and on the CPU: the same files, byte for byte, and the same
    result."""
    out = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        store = tmp / f"append-20k-{side}"
        store.mkdir()
        t0 = time.perf_counter()
        res = cycle.append_checker({"device": d}).check(
            {"store_dir": str(store)}, hist)
        out[side] = (store, res, time.perf_counter() - t0)
    (cs, cres, c_s), (ps, pres, p_s) = out["card"], out["cpu"]
    cf, pf = _files(cs), _files(ps)
    if cf != pf or not cf:
        raise AssertionError(f"append 20k: card files {sorted(cf)[:5]} != "
                             f"CPU files {sorted(pf)[:5]}")
    strip = json.dumps(_norm(cres), default=repr).replace(str(cs), "")
    if strip != json.dumps(_norm(pres), default=repr).replace(str(ps), ""):
        raise AssertionError("append 20k: card and CPU results differ")
    return {"phase": "composed", "check": "list-append-20k card vs cpu",
            "anomaly_types": cres["anomaly-types"], "files": len(cf),
            "bytes": sum(len(b) for b in cf.values()),
            "identical_files": True, "identical_results": True,
            "card_s": c_s, "cpu_s": p_s,
            "card": nvidia_smi_line() if on_card else "cpu"}


# ---------------------------------------------------------------------------
# Phase 20: a generated test
# ---------------------------------------------------------------------------

class StaleReadKVClient(testing.KVClient):
    """A KVClient at fault (a fixture of this script, not of the package):
    after every `every`-th read of the run, the next read of `key` that
    can be answered with a value the history has ruled out is answered
    with it.

    A read R answered v is ruled out when some write X of another value
    completed before R was invoked and every write of v completed before
    X was invoked. The client learns these orders from the processes, not
    the clock: the interpreter journals an op's completion before it
    hands that process its next op, so once the process of a write
    invokes again, at time t, the write completed before t. Such a write
    is settled. The client answers from settled writes only, with a
    value that no unsettled write may restore. A write of v invoked but
    not yet in the client when R is answered could still linearize R;
    `forced_stale_reads` counts from the recorded history the stale
    reads that no write saves, and phase 20 asks for at least one."""

    def __init__(self, state, key, every: int = 50,
                 latency_s: float = 0.0005):
        super().__init__(state, latency_s)
        self.key = key
        self.every = every
        self.reads = 0
        self.due = False
        self.meta = threading.Lock()
        self.applied: dict = {}  # process -> (value, invoked at) it wrote
        self.unsettled: dict = {}  # value -> writes of it not settled
        self.settled: list = []  # (value, invoked at, completed before)
        self.done_by: dict = {}  # value -> its settled writes completed
        self.stale = 0

    def _settle(self, op) -> None:
        """op's process invoked again: its last write completed before
        op.time."""
        x = self.applied.pop(op.process, None)
        if x is None:
            return
        value, invoked = x
        self.unsettled[value] -= 1
        self.settled = self.settled[-63:] + [(value, invoked, op.time)]
        self.done_by[value] = max(self.done_by.get(value, -1), op.time)

    def _stale_value(self, op, cur):
        """A value the history rules out for read op, or cur."""
        for x, invoked, completed in reversed(self.settled):
            if completed > op.time:  # op's own invoke may settle X
                continue
            vs = [v for v, done in self.done_by.items()
                  if v not in (cur, x) and done <= invoked
                  and not self.unsettled.get(v)]
            if vs:
                return max(vs, key=lambda v: (self.done_by[v], repr(v)))
        return cur

    def invoke(self, test, op):
        k, v = op.value
        new = v if op.f == "write" else v[1] if op.f == "cas" else None
        mine = k == self.key and op.f != "read"
        with self.meta:
            self._settle(op)
            if mine:
                self.unsettled[new] = self.unsettled.get(new, 0) + 1
        wrote = False
        try:
            if self.latency_s:
                time.sleep(self.latency_s)
            with self.state.lock:
                cur = self.state.data.get(k)
                if op.f == "read":
                    self.reads += 1
                    if self.reads % self.every == 0:
                        self.due = True
                    if k == self.key and self.due:
                        with self.meta:
                            old = self._stale_value(op, cur)
                        if old != cur:
                            self.due = False
                            self.stale += 1
                            return op.copy(type="ok", value=(k, old))
                    return op.copy(type="ok", value=(k, cur))
                if op.f == "write" or (op.f == "cas" and cur == v[0]):
                    wrote = mine
                    self.state.data[k] = new
                    return op.copy(type="ok")
                if op.f == "cas":
                    return op.copy(type="fail")
        finally:
            if mine:
                with self.meta:
                    if wrote:
                        self.applied[op.process] = (new, op.time)
                    else:
                        self.unsettled[new] -= 1
        raise ValueError(f"unknown f {op.f!r}")


def forced_stale_reads(hist, key) -> int:
    """The reads of `key` in a recorded history that no linearization
    answers: a read of v, not nil, such that some write X of another
    value completed before the read was invoked, and every write of v
    completed before X was invoked or was invoked after the read
    completed. Positions in the history give the order; a successful
    cas writes its new value."""
    invoked: dict = {}
    writes, reads = [], []  # (value, invoke position, completion position)
    for pos, o in enumerate(hist):
        kv = o.value
        if not (isinstance(kv, (tuple, list)) and len(kv) == 2
                and kv[0] == key):
            continue
        if o.type == "invoke":
            invoked[o.process] = (pos, kv[1])
            continue
        inv, arg = invoked.pop(o.process)
        if o.type != "ok":
            continue
        if o.f == "read" and kv[1] is not None:
            reads.append((kv[1], inv, pos))
        elif o.f in ("write", "cas"):
            writes.append((arg if o.f == "write" else arg[1], inv, pos))
    forced = 0
    for v, r_inv, r_ok in reads:
        of_v = [(w_inv, w_ok) for w, w_inv, w_ok in writes if w == v]
        if any(x != v and x_ok < r_inv and all(
                w_ok < x_inv or w_inv > r_ok for w_inv, w_ok in of_v)
               for x, x_inv, x_ok in writes):
            forced += 1
    return forced


class SnapshotTxnClient(testing.TxnClient):
    """A TxnClient at fault (a fixture of this script): writes apply to
    the store, but reads come from a snapshot of it that is refreshed
    every `every` txns."""

    def __init__(self, every: int = 16, latency_s: float = 0.0003):
        super().__init__(latency_s=latency_s)
        self.every = every
        self.txns = 0
        self.snapshot: dict = {}

    def invoke(self, test, op):
        if self.latency_s:
            time.sleep(self.latency_s)
        out = []
        with self.state.lock:
            if self.txns % self.every == 0:
                self.snapshot = {k: (list(v) if isinstance(v, list) else v)
                                 for k, v in self.state.data.items()}
            self.txns += 1
            for f, k, v in op.value:
                if f == "r":
                    cur = self.snapshot.get(k)
                    out.append([f, k, list(cur) if isinstance(cur, list)
                                else cur])
                elif f == "append":
                    self.state.data.setdefault(k, []).append(v)
                    out.append([f, k, v])
                elif f == "w":
                    self.state.data[k] = v
                    out.append([f, k, v])
                else:
                    raise ValueError(f"unknown mop {f!r}")
        return op.copy(type="ok", value=out)


def generated_runs(sizes: dict) -> list[dict]:
    """The runs of phase 20, each a workload, a client factory, the
    concurrency, the kernel it must launch and whether it is a twin.
    `sizes` scales them: the full sizes are GENERATED_SIZES."""
    reg = {"keys": range(sizes["register_keys"]), "group-size": 5,
           "ops_per_key": 100, "seed": 8}
    bad_key = sizes["register_keys"] // 2
    accounts = list(range(32))
    bank_o = {"accounts": accounts, "ops": sizes["bank_ops"], "seed": 11}
    txn_o = {"ops": sizes["txn_ops"], "seed": 9}
    return [
        {"name": "register", "workload": wl_register.workload, "opts": reg,
         "client": lambda: testing.KVClient(testing.KVState()),
         "concurrency": sizes["register_concurrency"],
         "kernel": "wgl_search", "twin": False},
        {"name": "register-twin", "workload": wl_register.workload,
         "opts": reg, "bad_key": bad_key,
         "client": lambda: StaleReadKVClient(testing.KVState(), bad_key),
         "concurrency": sizes["register_concurrency"],
         "kernel": "wgl_search", "twin": True},
        {"name": "bank", "workload": bank.workload, "opts": bank_o,
         "client": lambda: testing.BankClient(testing.BankState(accounts)),
         "concurrency": 10, "kernel": "bank_reduce", "twin": False},
        {"name": "bank-twin", "workload": bank.workload, "opts": bank_o,
         "client": lambda: testing.BankClient(
             testing.BankState(accounts, initial=11)),
         "concurrency": 10, "kernel": "bank_reduce", "twin": True},
        {"name": "list-append", "workload": wl_append.workload,
         "opts": txn_o, "client": testing.TxnClient, "concurrency": 10,
         "kernel": "scc", "twin": False},
        {"name": "list-append-twin", "workload": wl_append.workload,
         "opts": txn_o, "client": SnapshotTxnClient, "concurrency": 10,
         "kernel": "scc", "twin": True},
        {"name": "rw-register", "workload": wl_wr.workload, "opts": txn_o,
         "client": testing.TxnClient, "concurrency": 10, "kernel": "scc",
         "twin": False},
        {"name": "rw-register-twin", "workload": wl_wr.workload,
         "opts": txn_o, "client": SnapshotTxnClient, "concurrency": 10,
         "kernel": "scc", "twin": True},
        {"name": "lock", "workload": wl_lock.fenced_lock_workload,
         "opts": {"ops": sizes["lock_ops"]},
         "client": testing.LockClient, "concurrency": 5, "kernel": None,
         "twin": False},
    ]


# cut from 200 register keys, 40,000 bank ops, 20,000 txns and 2,000
# lock ops to keep the script inside its time limit; the bank's ~12,000
# reads and the Elle runs' graphs (~50,000 live edges) stay past their
# device dispatch
GENERATED_SIZES = {"register_keys": 50, "register_concurrency": 50,
                   "bank_ops": 24_000, "txn_ops": 5_000, "lock_ops": 1_000,
                   "traced_keys": 20}

# the wrappers phase 20 counts calls through, and the kernel each counts
WRAPPERS = ((ws, "wgl_search", "wgl_search"),
            (kscc, "scc_labels", "scc"),
            (kscc, "scc_labels_to_convergence", "scc_converge"),
            (kbank, "bank_reduce", "bank_reduce"))


def generated_test(workload: dict, client, concurrency: int) -> dict:
    """A clusterless test map: the noop test with the workload's
    generator on the client threads, its checker and its other keys."""
    test = testing.noop_test()
    test.update(concurrency=concurrency, client=client,
                checker=workload["checker"],
                generator=gen.clients(workload["generator"]))
    for k, v in workload.items():
        if k not in ("generator", "checker"):
            test[k] = v
    return test


def interpret(test: dict) -> tuple[dict, float, dict]:
    """interpreter.run on the test under a fresh relative-time origin;
    returns the test with its history, the wall seconds and the
    interpreter's counters."""
    telemetry.reset()
    with util.with_relative_time():
        t0 = time.perf_counter()
        out = interpreter.run(test)
        seconds = time.perf_counter() - t0
    c = telemetry.get().counters()
    return out, seconds, {k: v for k, v in c.items()
                          if k.startswith("interpreter.")}


def _counted_check(checker, test, hist, on_card: bool):
    """checker.check with a call counter around every kernel wrapper (the
    same count on the card and on the CPU, where the plain versions run)
    and each wrapper's own launch counter set to 0 just before and read
    just after. Returns (result, seconds, calls, launches, recorded,
    spans, counters)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # each side checks its own copy, from a collected heap, so neither
    # reuses what the other built or pays for the other's garbage
    hist = History(list(hist), assign_indices=False)
    gc.collect()
    recorded = {label: [] for _m, _n, label in WRAPPERS}
    originals = [(m, n, _recording(m, n, recorded[label]))
                 for m, n, label in WRAPPERS]
    ws.launches = kscc.launches = kscc.converge_launches = 0
    kbank.launches = 0
    telemetry.reset()
    try:
        t0 = time.perf_counter()
        res = chk.check(checker, test, hist)
        sync()
        seconds = time.perf_counter() - t0
    finally:
        for m, n, fn in originals:
            setattr(m, n, fn)
    launches = {"wgl_search": ws.launches, "scc": kscc.launches,
                "scc_converge": kscc.converge_launches,
                "bank_reduce": kbank.launches}
    calls = {label: len(v) for label, v in recorded.items()}
    spans: dict = {}
    for sp in telemetry.get().spans():
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + (
            sp["t1"] - sp["t0"]) / 1e9
    return (res, seconds, calls, launches, recorded, spans,
            telemetry.get().counters())


def _certificates(res) -> dict:
    """Every certificate in a result tree, by where it sits, as bytes."""
    out = {}

    def walk(x, where):
        if isinstance(x, dict):
            for k, v in x.items():
                if k == "certificate":
                    out[where or "/"] = json.dumps(jsonable(v),
                                                   sort_keys=True).encode()
                else:
                    walk(v, f"{where}/{k}")

    walk(res, "")
    return out


def _compared(res) -> dict:
    """The parts of a result the card and the CPU must agree on: the
    verdict, failures, anomaly types and first error, wherever they sit
    in the tree."""
    out = {}

    def walk(x, where):
        if isinstance(x, dict):
            for k, v in x.items():
                if k in ("valid?", "failures", "anomaly-types",
                         "first-error"):
                    out[f"{where}/{k}"] = _norm(v)
                elif k != "certificate":
                    walk(v, f"{where}/{k}")

    walk(res, "")
    return out


def _untimed(kw: dict) -> dict:
    """A kernel wrapper's keyword arguments without the timing events
    the main path passes (a replay times itself)."""
    return {k: v for k, v in kw.items() if k != "events"}


def _replayed_kernel_ms(recorded: dict, on_card: bool) -> float | None:
    """CUDA-event ms of every recorded kernel launch, replayed."""
    if not on_card:
        return None
    ms = 0.0
    fns = {"wgl_search": ws.wgl_search, "scc": kscc.scc_labels,
           "scc_converge": kscc.scc_labels_to_convergence,
           "bank_reduce": kbank.bank_reduce}
    for label, calls in recorded.items():
        for args, kw, _out in calls:
            ms += _event_ms(lambda: fns[label](*args, **_untimed(kw)),
                            reps=3)
    return ms


def _check_spans(run: str, spans: dict, counters: dict) -> dict:
    """check_s split into host encode, kernel path and certificate."""
    if run.startswith(("list-append", "rw-register")):
        fam = "list-append" if run.startswith("list") else "rw-register"
        return {"host_encode_s": spans.get(f"elle:{fam}", 0.0),
                "cycle_search_s": spans.get("elle:cycles", 0.0),
                "scc_device_s": spans.get("scc:device", 0.0),
                "certify_s": spans.get("certify.attach", 0.0)}
    if run.startswith("register"):
        return {"host_encode_s":
                counters.get("profiler.encode.encode_ns", 0) / 1e9,
                "pack_s": counters.get("profiler.pack.encode_ns", 0) / 1e9,
                "drain_s": spans.get("wgl:drain", 0.0),
                "host_resolved_rows": counters.get(
                    "wgl.host-resolved-rows", 0),
                "certify_s": spans.get("certify.attach", 0.0)}
    return {}


def _validate_certs(run: str, hist, res, bad_key) -> int:
    """certify.validate over the card's certificates: elle's one, the
    register's first 16 keys and the twin's bad key (each against the
    whole history)."""
    if run.startswith(("list-append", "rw-register")):
        certify.validate(hist, res["certificate"])
        return 1
    if run.startswith("register"):
        keys = sorted(res["results"], key=str)[:16]
        if bad_key is not None and bad_key not in keys:
            keys.append(bad_key)
        for k in keys:
            certify.validate(hist, res["results"][k]["certificate"])
        return len(keys)
    return 0


def generated_path(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 20: a generated test. Each run builds its workload with
    device=None (the card) or "cpu", drives the port's interpreter with
    worker threads over the in-memory client, and checks the history it
    recorded twice: on the card and with "device": "cpu" (the kernels'
    plain versions). Returns the launches per run, by kernel.

    The heap of the earlier phases is frozen out of the collector for
    the phase, so the collection before each check scans this phase's
    objects only."""
    gc.collect()
    gc.freeze()
    try:
        return _generated_path(dev, on_card, sizes)
    finally:
        gc.unfreeze()


def _generated_path(dev, on_card: bool, sizes: dict | None) -> dict:
    sizes = dict(GENERATED_SIZES, **(sizes or {}))
    card_dev = None if on_card else dev
    t_phase = time.perf_counter()
    per_kernel: dict = {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
    for spec in generated_runs(sizes):
        name = spec["name"]
        w = spec["workload"](dict(spec["opts"], device=card_dev))
        test, interp_s, icount = interpret(generated_test(
            w, spec["client"](), spec["concurrency"]))
        hist = test["history"]
        invokes = sum(1 for o in hist if o.type == "invoke")
        card = _counted_check(w["checker"], test, hist, on_card)
        wcpu = spec["workload"](dict(spec["opts"], device="cpu"))
        cpu = _counted_check(wcpu["checker"], test, hist, False)
        res, check_s, calls, launches, recorded, spans, counters = card
        cres, cpu_s, ccalls = cpu[0], cpu[1], cpu[2]
        bad = _unsound(res) + _unsound(cres)
        if bad:
            raise AssertionError(f"{name}: unknown or error at {bad[:10]}")
        if res["valid?"] is spec["twin"]:
            raise AssertionError(f"{name}: valid? {res['valid?']}")
        if _compared(res) != _compared(cres):
            raise AssertionError(f"{name}: card {_compared(res)} != "
                                 f"cpu {_compared(cres)}")
        certs, ccerts = _certificates(res), _certificates(cres)
        if certs != ccerts:
            diff = [k for k in set(certs) | set(ccerts)
                    if certs.get(k) != ccerts.get(k)]
            raise AssertionError(f"{name}: certificates differ at "
                                 f"{diff[:10]}")
        if calls != ccalls:
            raise AssertionError(f"{name}: wrapper calls card {calls} != "
                                 f"cpu {ccalls}")
        kernel = spec["kernel"]
        if on_card:
            if {k: launches[k] for k in calls} != calls:
                raise AssertionError(f"{name}: launch counters {launches} "
                                     f"!= wrapper calls {calls}")
            if kernel is None and any(launches.values()):
                raise AssertionError(f"{name}: launched {launches}")
            if kernel is not None and launches[kernel] < 1:
                raise AssertionError(f"{name}: no {kernel} launch")
            if name in ("register", "bank") and launches[kernel] != 1:
                raise AssertionError(f"{name}: {launches[kernel]} "
                                     f"{kernel} launches, want 1")
        scc_paths = {k: counters.get(k, 0) for k in (
            "scc.path.device", "scc.path.host", "scc.device-nonconverged")}
        # a valid run's one graph is past DEVICE_MIN_EDGES; a twin's
        # smaller graded edge subsets may fall under it and go to scipy
        # by size, the reference's rule
        if kernel == "scc" and not spec["twin"] and \
                scc_paths["scc.path.host"]:
            raise AssertionError(f"{name}: an SCC off the card {scc_paths}")
        line = {"phase": "generated", "run": name,
                "invokes": invokes, "events": len(hist),
                "concurrency": spec["concurrency"],
                "interpreter_s": interp_s,
                "interpreter_ops_per_s": invokes / interp_s,
                **{k.removeprefix("interpreter."): v
                   for k, v in icount.items()},
                "valid": res["valid?"], "check_s": check_s,
                **_check_spans(name, spans, counters),
                "cpu_check_s": cpu_s, "launches": launches,
                "wrapper_calls": calls}
        if kernel == "scc":
            line["scc_paths"] = scc_paths
        if spec["twin"]:
            line.update(_twin_facts(spec, test, res))
        t0 = time.perf_counter()
        line["certificates_validated"] = _validate_certs(
            name, hist, res, spec.get("bad_key"))
        line["validate_s"] = time.perf_counter() - t0
        kernel_ms = _replayed_kernel_ms(recorded, on_card)
        wall_ms = 1e3 * (interp_s + check_s)
        line.update({"kernel_ms": kernel_ms,
                     "card_busy_share": (kernel_ms / wall_ms
                                         if kernel_ms is not None
                                         else None),
                     "card_idle_share": (1 - kernel_ms / wall_ms
                                         if kernel_ms is not None
                                         else None),
                     "card": nvidia_smi_line() if on_card else "cpu"})
        emit(line)
        if kernel is not None:
            per_kernel[kernel][f"generated-{name}"] = calls[kernel]
    per_kernel["wgl_search"]["generated-register-traced"] = \
        traced_register_run(dev, on_card, sizes)
    emit({"phase": "generated-total",
          "seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return per_kernel


def _twin_facts(spec: dict, test: dict, res: dict) -> dict:
    """What each twin must show besides valid? False."""
    name = spec["name"]
    if name == "register-twin":
        if spec["bad_key"] not in res["failures"]:
            raise AssertionError(f"{name}: failures {res['failures'][:10]}"
                                 f" lack key {spec['bad_key']}")
        forced = forced_stale_reads(test["history"], spec["bad_key"])
        if forced < 1:
            raise AssertionError(f"{name}: {test['client'].stale} stale "
                                 f"reads, none ruled out by the history")
        return {"failures": res["failures"],
                "stale_reads": test["client"].stale,
                "forced_stale_reads": forced}
    if name == "bank-twin":
        fe = res["bank"]["first-error"]
        if fe["type"] != "wrong-total":
            raise AssertionError(f"{name}: first error {fe}")
        return {"first_error": {k: v for k, v in fe.items() if k != "op"},
                "error_count": res["bank"]["error-count"]}
    if not res.get("anomaly-types"):
        raise AssertionError(f"{name}: no anomaly types")
    return {"anomaly_types": res["anomaly-types"]}


def traced_register_run(dev, on_card: bool, sizes: dict) -> int:
    """The register twin traced (test["trace?"]) into a temporary store
    directory: the tracer writes optrace.jsonl while the interpreter runs,
    the file must pass tracing.validate_records, and the invalid key's
    counterexample trace excerpt must be written from it. Returns the
    wgl_search launches of its check."""
    n_keys = sizes["traced_keys"]
    bad_key = n_keys // 3
    opts = {"keys": range(n_keys), "group-size": 5, "ops_per_key": 100,
            "seed": 8, "device": None if on_card else dev}
    w = wl_register.workload(opts)
    client = StaleReadKVClient(testing.KVState(), bad_key, every=10)
    tracer = tracing.get()
    with tempfile.TemporaryDirectory() as tmp:
        test = generated_test(w, client, 10)
        test.update({"trace?": True, "store_dir": tmp})
        tracer.reset(enabled=True)
        try:
            tracer.open(Path(tmp) / tracing.TRACE_FILE)
            test, interp_s, icount = interpret(test)
            tracer.flush()
        finally:
            tracer.reset(enabled=False)
        recs = list(tracing.read_records(Path(tmp) / tracing.TRACE_FILE))
        n_recs = tracing.validate_records(recs)
        hist = test["history"]
        forced = forced_stale_reads(hist, bad_key)
        if forced < 1:
            raise AssertionError(f"traced twin: {client.stale} stale reads,"
                                 f" none ruled out by the history")
        res, check_s, calls, launches, _rec, _sp, _c = _counted_check(
            w["checker"], test, hist, on_card)
        if res["valid?"] is not False or bad_key not in res["failures"]:
            raise AssertionError(f"traced twin: {res['valid?']} "
                                 f"{res['failures']}")
        if on_card and (launches["wgl_search"] != calls["wgl_search"]
                        or launches["wgl_search"] != 1):
            raise AssertionError(f"traced twin: launch counters {launches}"
                                 f", wrapper calls {calls}, want 1 "
                                 f"wgl_search")
        excerpt = res["results"][bad_key].get("trace-excerpt")
        if not excerpt or not Path(excerpt).exists():
            raise AssertionError(f"traced twin: no trace excerpt {excerpt}")
        # the excerpt's lines are the records of optrace.jsonl behind the
        # counterexample's ops
        body = Path(excerpt).read_text().splitlines()
        by_op = tracing.by_op(recs)
        idxs = sorted(res["results"][bad_key]["op-indices"])
        want = explain.trace_excerpt_lines(by_op, idxs)
        if not any(i in by_op for i in idxs) or any(
                line not in body for line in want):
            raise AssertionError(f"traced twin: the excerpt is not the "
                                 f"trace of ops {idxs}")
        invokes = sum(1 for o in hist if o.type == "invoke")
        if len(by_op) != invokes:
            raise AssertionError(f"traced twin: {len(by_op)} traced ops for "
                                 f"{invokes} invocations")
        emit({"phase": "generated-traced", "run": "register-twin",
              "invokes": invokes, "interpreter_s": interp_s,
              "interpreter_ops_per_s": invokes / interp_s,
              **{k.removeprefix("interpreter."): v
                 for k, v in icount.items()},
              "trace_records": n_recs, "traced_ops": len(by_op),
              "failures": res["failures"], "stale_reads": client.stale,
              "forced_stale_reads": forced,
              "excerpt": Path(excerpt).name, "check_s": check_s,
              "launches": launches})
        return calls["wgl_search"]


# ---------------------------------------------------------------------------
# 21. the test lifecycle: core.run over the dummy remote
# ---------------------------------------------------------------------------

# phase 20's run sizes: register 100 keys (10,000 ops; at 300 keys the
# phase took 177 s on the card, each register run ~35 s of core.run and
# ~16 s of re-analysis on the CPU, and ~106 s at 200), list-append 10,000
# txns and bank 24,000 ops (cut from 30,000 txns, then 20,000 txns and
# 40,000 ops with phase 20's, to keep the script inside its time limit;
# at these sizes each case runs about as long as the nemesis schedule,
# so a smaller run saves little). nemesis_ops bounds the fault
# schedule (four packages at a 1 s interval give about four nemesis ops
# a second). stale_every is the twin's StaleReadKVClient's `every`: a
# small run needs a stale read due after every read to be sure of one
# the history rules out.
LIFECYCLE_SIZES = {"register_keys": 100, "register_concurrency": 50,
                   "bank_ops": 24_000, "txn_ops": 10_000,
                   "nemesis_ops": 24, "stale_every": 50}
LIFECYCLE_FAULTS = ["partition", "kill", "pause", "clock"]
FIXTURE_PIDFILE = "/run/fixture-db.pid"
FIXTURE_PID = "4242"
FIXTURE_LOG = "/var/log/fixture-db.log"
FIXTURE_DIR = "/opt/fixture-db"


class FixtureDB(jdb.DB):
    """The database a lifecycle run installs on every node. Its daemon's
    start, kill, pause and resume are commands through control.exec_ on
    the node's dummy session (the in-memory client holds the data), and
    its log is the file the node probe tails and snarf_logs downloads."""

    supports_kill = True
    supports_pause = True

    def setup(self, test, node):
        self.start(test, node)

    def teardown(self, test, node):
        self.kill(test, node)

    def start(self, test, node):
        return cu.start_daemon(
            {"logfile": FIXTURE_LOG, "pidfile": FIXTURE_PIDFILE,
             "chdir": FIXTURE_DIR}, f"{FIXTURE_DIR}/bin/fixture-db")

    def kill(self, test, node):
        cu.stop_daemon(FIXTURE_PIDFILE)
        return "killed"

    def pause(self, test, node):
        with control.su():
            control.exec_("kill", "-STOP",
                          control.exec_("cat", FIXTURE_PIDFILE))
        return "paused"

    def resume(self, test, node):
        with control.su():
            control.exec_("kill", "-CONT",
                          control.exec_("cat", FIXTURE_PIDFILE))
        return "resumed"

    def log_files(self, test, node):
        return [FIXTURE_LOG]


def lifecycle_responder():
    """The dummy remote's answers: node addresses (getent), the network
    device (ip link), the fixture DB's pid file, the node clock (date,
    bump-time), and the node probe's compound command with seeded
    synthetic node state. A fresh chain per run keeps the synthetic
    state run-scoped."""
    probe = nodeprobe.synthetic_responder(seed=7)

    def respond(node, action):
        cmd = action.cmd
        if cmd.startswith("getent ahostsv4"):
            host = cmd.split()[-1]
            digits = "".join(ch for ch in str(host) if ch.isdigit())
            return f"10.0.0.{int(digits or 0) % 250 + 1}   STREAM {host}"
        if cmd == "ip -o link show":
            return ("1: lo: <LOOPBACK,UP> mtu 65536\n"
                    "2: eth0: <BROADCAST,MULTICAST,UP> mtu 1500")
        if cmd == f"cat {FIXTURE_PIDFILE}":
            return FIXTURE_PID
        if cmd.startswith(("date +%s.%N", "/opt/jepsen/bump-time")):
            return f"{time.time():.9f}"
        return probe(node, action)

    return respond


def lifecycle_test(name: str, workload: dict, client, concurrency: int,
                   store_base, nemesis_ops: int) -> dict:
    """A named test over the dummy remote: the fixture DB on the five
    nodes of the noop test, the combined nemesis package's partition,
    kill, pause and clock faults at a 1 s interval (nemesis_ops of them
    beside the workload's client ops, then the package's final
    generator), the monitor at 1 s and the node probe on."""
    db = FixtureDB()
    pkg = combined.nemesis_package({"db": db, "faults": LIFECYCLE_FAULTS,
                                    "interval": 1})
    test = testing.noop_test()
    test.update({
        "name": f"lifecycle-{name}", "store_base": str(store_base),
        "remote": DummyRemote(lifecycle_responder()), "db": db,
        "client": client, "concurrency": concurrency,
        "nemesis": pkg["nemesis"], "checker": workload["checker"],
        "generator": gen.phases(
            gen.clients(workload["generator"],
                        gen.limit(nemesis_ops, pkg["generator"])),
            gen.nemesis(pkg["final_generator"])),
        "plot": {"nemeses": pkg["perf"]},
        "monitor_interval_s": 1, "nodeprobe?": True})
    for k, v in workload.items():
        if k not in ("generator", "checker"):
            test[k] = v
    return test


def lifecycle_runs(sizes: dict) -> list[dict]:
    """The runs of phase 21 on phase 20's workloads. The bank run checks
    the conservation verdict and stats: the bundle's balance plot needs
    matplotlib, which the card machine lacks, and a stored run would
    report it "unknown"."""
    reg = {"keys": range(sizes["register_keys"]), "group-size": 5,
           "ops_per_key": 100, "seed": 8}
    bad_key = sizes["register_keys"] // 2
    accounts = list(range(32))

    def bank_workload(o):
        w = bank.workload(o)
        w["checker"] = chk.compose({"bank": bank.checker(o),
                                    "stats": chk.stats()})
        return w

    return [
        {"name": "register", "workload": wl_register.workload, "opts": reg,
         "client": lambda: testing.KVClient(testing.KVState()),
         "concurrency": sizes["register_concurrency"],
         "kernel": "wgl_search", "twin": False, "watchdog": True},
        {"name": "register-twin", "workload": wl_register.workload,
         "opts": reg, "bad_key": bad_key,
         "client": lambda: StaleReadKVClient(testing.KVState(), bad_key,
                                             every=sizes["stale_every"]),
         "concurrency": sizes["register_concurrency"],
         "kernel": "wgl_search", "twin": True, "watchdog": True,
         "trace": True},
        {"name": "list-append", "workload": wl_append.workload,
         "opts": {"ops": sizes["txn_ops"], "seed": 9},
         "client": testing.TxnClient, "concurrency": 10,
         "kernel": "scc", "twin": False, "watchdog": False},
        {"name": "bank", "workload": bank_workload,
         "opts": {"accounts": accounts, "ops": sizes["bank_ops"],
                  "seed": 11},
         "client": lambda: testing.BankClient(testing.BankState(accounts)),
         "concurrency": 10, "kernel": "bank_reduce", "twin": False,
         "watchdog": False},
    ]


def _wrapped_kernels():
    """Replaces every kernel wrapper with a recording one and sets each
    launch counter to 0; returns (recorded, restore)."""
    recorded = {label: [] for _m, _n, label in WRAPPERS}
    originals = [(m, n, _recording(m, n, recorded[label]))
                 for m, n, label in WRAPPERS]
    ws.launches = kscc.launches = kscc.converge_launches = 0
    kbank.launches = 0

    def restore():
        for m, n, fn in originals:
            setattr(m, n, fn)

    return recorded, restore


def _stamping_timed():
    """Wraps certify.stamp_results, which core.analyze calls after the
    `analyze` span to validate every certificate again; returns (the
    list its calls' seconds go to, restore)."""
    seconds: list = []
    original = certify.stamp_results

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return original(*args, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)

    certify.stamp_results = timed

    def restore():
        certify.stamp_results = original

    return seconds, restore


def _launch_counts() -> dict:
    return {"wgl_search": ws.launches, "scc": kscc.launches,
            "scc_converge": kscc.converge_launches,
            "bank_reduce": kbank.launches}


def _checked(res, drop=("watchdog", "telemetry")) -> dict:
    """A run's results without the entries named in drop: by default
    those core.analyze puts beside the checkers' (the watchdog's and the
    telemetry summary)."""
    return {k: v for k, v in res.items() if k not in drop}


def _results_unsound(res) -> list[str]:
    """Where the checkers' results hold "unknown", an error or a failed
    certificate."""
    out = []

    def walk(x, where):
        if isinstance(x, dict):
            if x.get("valid?") == "unknown" or "error" in x \
                    or "certificate-error" in x:
                out.append(where or "/")
            for k, v in x.items():
                walk(v, f"{where}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{where}/{i}")

    walk(_checked(res), "")
    return out


def _uncertified(res, absent_ok: bool = False) -> list[str]:
    """Where a result carries a certificate without a `certified`
    stamp; absent_ok: but for the honest absences ("absent": why no
    proof, as for a model outside the validator's replay registry),
    which have nothing to validate."""
    out = []

    def walk(x, where):
        if isinstance(x, dict):
            cert = x.get("certificate")
            if "certificate" in x and x.get("certified") is not True \
                    and not (absent_ok and isinstance(cert, dict)
                             and "absent" in cert):
                out.append(where or "/")
            for k, v in x.items():
                walk(v, f"{where}/{k}")

    walk(res, "")
    return out


def _fault_counts(faults, kinds) -> dict:
    """{kind: activations} of the kinds named (an end without its begin
    folds to a count of 0 and is left out)."""
    return {f["kind"]: f["count"] for f in faults
            if f["kind"] in kinds and f["count"]}


def _check_run_dir(spec: dict, out: dict, atlas_before: int) -> dict:
    """The run directory against the run in memory: history, results,
    certificates, the clock-skew bound, metrics, the time series,
    coverage and the atlas, the session logs, jepsen.log."""
    name = spec["name"]
    d = Path(out["store_dir"])
    loaded = store.load(d)
    hist = out["history"]
    if [jsonable(o) for o in loaded["history"]] != \
            [jsonable(o) for o in hist]:
        raise AssertionError(f"{name}: history.jlog differs from the run")
    with open(d / "results.json") as f:
        if json.load(f) != jsonable(out["results"]):
            raise AssertionError(f"{name}: results.json differs")
    res = out["results"]
    missing = _uncertified(res)
    if missing:
        raise AssertionError(f"{name}: certificates without a stamp at "
                             f"{missing[:10]}")
    recs = nodeprobe.load_records(d)
    n_recs = nodeprobe.validate_records(recs)
    bound = nodeprobe.clock_skew_bound(recs, loaded["history"])
    if bound is None or res.get("clock-skew-bound") != bound:
        raise AssertionError(f"{name}: clock-skew-bound "
                             f"{res.get('clock-skew-bound')} != {bound}")
    events, metrics = store.load_telemetry(d)
    telemetry.validate_metrics(metrics)
    case = [e for e in events if e["name"] == "case"]
    if len(case) != 1:
        raise AssertionError(f"{name}: {len(case)} case spans")
    c0, c1 = case[0]["t0"], case[0]["t1"]
    points = store.load_timeseries(d)
    in_case = [p["t"] for p in points if c0 <= p["t"] <= c1]
    case_s = (c1 - c0) / 1e9
    # one point a second of the case: the sampler waits a whole second
    # after each point, so its period is 1 s plus the sample's own time
    # and the wake-up under the GIL, and over a 20 s case that drift can
    # cost one point
    if len(in_case) < int(case_s) - 1:
        raise AssertionError(f"{name}: {len(in_case)} monitor points in "
                             f"a {case_s:.2f} s case")
    period_s = (float(np.median(np.diff(in_case))) / 1e9
                if len(in_case) > 1 else None)
    # every kernel gauge the analysis set streams in the time series
    want_gauges = {k for k in res["telemetry"]["gauges"]
                   if k.startswith(("wgl.", "elle.", "scc."))}
    shown = set()
    for p in points:
        shown |= set(p.get("gauges") or ())
    if not want_gauges <= shown:
        raise AssertionError(f"{name}: gauges {sorted(want_gauges)} not "
                             f"in the time series ({sorted(shown)})")
    rec = coverage.load_record(d)
    coverage.validate_record(rec)
    kinds = ("partition", "db-kill", "db-pause", "clock-bump",
             "clock-strobe", "clock-reset")
    live = _fault_counts(rec["faults"], kinds)
    # a bare start/stop is the history fallback's documented ambiguity
    # (coverage.F_KINDS reads it as a partition): the db package's start
    # ends a kill, so it is left out of the fallback's count
    from_hist = _fault_counts(coverage.faults_from_history(
        [o for o in hist if o.f not in ("start", "stop")]), kinds)
    if live != from_hist:
        raise AssertionError(f"{name}: coverage {live} != history "
                             f"{from_hist}")
    if not live.get("partition"):
        raise AssertionError(f"{name}: no partition: {live}")
    atlas = coverage.read_atlas(Path(out["store_base"])
                                / coverage.ATLAS_FILE)
    coverage.validate_atlas(atlas)
    if len(atlas) != atlas_before + 1 or atlas[-1]["run"] != rec["run"]:
        raise AssertionError(f"{name}: atlas {atlas_before} -> "
                             f"{len(atlas)} lines")
    for node, sess in out["sessions"].items():
        cmds = [a.cmd for a in sess.log if hasattr(a, "cmd")]
        if not any("-j DROP" in c for c in cmds):
            raise AssertionError(f"{name}: no -j DROP on {node}")
        if "iptables -F -w" not in cmds:
            raise AssertionError(f"{name}: no final heal on {node}")
    if not (d / "jepsen.log").stat().st_size:
        raise AssertionError(f"{name}: empty jepsen.log")
    return {"nodes_records": n_recs, "clock_skew_bound": bound,
            "monitor_points": len(points), "monitor_points_in_case":
            len(in_case), "monitor_period_s": period_s, "case_s": case_s,
            "faults": live,
            "atlas_lines": len(atlas), "loaded": loaded}


def lifecycle_path(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 21: full Jepsen runs through core.run, each analysed on the
    card and its run directory analysed again on the CPU. Returns the
    launches per run, by kernel. The earlier phases' heap is frozen out
    of the collector, as in phase 20."""
    gc.collect()
    gc.freeze()
    log = logging.getLogger("jepsen_tpu_torch")
    level = log.level
    log.setLevel(logging.INFO)
    try:
        return _lifecycle_path(dev, on_card, sizes)
    finally:
        log.setLevel(level)
        gc.unfreeze()


def _lifecycle_path(dev, on_card: bool, sizes: dict | None) -> dict:
    sizes = dict(LIFECYCLE_SIZES, **(sizes or {}))
    card_dev = None if on_card else dev
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    threads0 = set(threading.enumerate())
    handlers0 = list(logging.getLogger().handlers)
    per_kernel: dict = {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for spec in lifecycle_runs(sizes):
            name = spec["name"]
            w = spec["workload"](dict(spec["opts"], device=card_dev))
            test = lifecycle_test(name, w, spec["client"](),
                                  spec["concurrency"], tmp,
                                  sizes["nemesis_ops"])
            if spec["watchdog"]:
                test["watchdog"] = ["register"]
            if spec.get("trace"):
                test["trace?"] = True
            atlas_before = len(coverage.read_atlas(
                Path(tmp) / coverage.ATLAS_FILE))
            recorded, restore = _wrapped_kernels()
            stamp_s, unstamp = _stamping_timed()
            try:
                t0 = time.perf_counter()
                out = core.run(test)
                sync()
                run_s = time.perf_counter() - t0
            finally:
                restore()
                unstamp()
            launches = _launch_counts()
            calls = {label: len(v) for label, v in recorded.items()}
            if logging.getLogger().handlers != handlers0:
                raise AssertionError(f"{name}: the run's log handler was "
                                     f"not released")
            res = out["results"]
            bad = _results_unsound(res)
            if bad:
                raise AssertionError(f"{name}: unknown or error at "
                                     f"{bad[:10]}")
            if res["valid?"] is spec["twin"]:
                raise AssertionError(f"{name}: valid? {res['valid?']}")
            kernel = spec["kernel"]
            if on_card:
                if {k: launches[k] for k in calls} != calls:
                    raise AssertionError(f"{name}: launch counters "
                                         f"{launches} != wrapper calls "
                                         f"{calls}")
                if launches[kernel] < 1 or (
                        kernel != "scc" and launches[kernel] != 1):
                    raise AssertionError(f"{name}: {launches[kernel]} "
                                         f"{kernel} launches")
            facts = _check_run_dir(spec, out, atlas_before)
            loaded = facts.pop("loaded")
            line_twin = {}
            if spec["twin"]:
                line_twin = _twin_facts(
                    {"name": "register-twin", "bad_key": spec["bad_key"]},
                    out, res)
                recs = list(tracing.read_records(
                    Path(out["store_dir"]) / tracing.TRACE_FILE))
                line_twin["trace_records"] = tracing.validate_records(recs)
            # the stored run analysed again on the CPU
            wcpu = spec["workload"](dict(spec["opts"], device="cpu"))
            again = dict(loaded, checker=wcpu["checker"])
            crecorded, crestore = _wrapped_kernels()
            cpu_stamp_s, cunstamp = _stamping_timed()
            try:
                t0 = time.perf_counter()
                cres = core.analyze(again)["results"]
                cpu_s = time.perf_counter() - t0
            finally:
                crestore()
                cunstamp()
            ccalls = {label: len(v) for label, v in crecorded.items()}
            bad = _results_unsound(cres)
            if bad:
                raise AssertionError(f"{name} (cpu): unknown or error at "
                                     f"{bad[:10]}")
            if _compared(jsonable(_checked(res))) != \
                    _compared(jsonable(_checked(cres))):
                raise AssertionError(f"{name}: card and cpu verdicts "
                                     f"differ")
            certs, ccerts = _certificates(res), _certificates(cres)
            if certs != ccerts:
                diff = [k for k in set(certs) | set(ccerts)
                        if certs.get(k) != ccerts.get(k)]
                raise AssertionError(f"{name}: certificates differ at "
                                     f"{diff[:10]}")
            if calls != ccalls:
                raise AssertionError(f"{name}: wrapper calls card {calls} "
                                     f"!= cpu {ccalls}")
            tel = res["telemetry"]
            hist = out["history"]
            invokes = sum(1 for o in hist
                          if o.type == "invoke" and isinstance(o.process,
                                                               int))
            kernel_ms = _replayed_kernel_ms(recorded, on_card)
            emit({"phase": "lifecycle", "run": name,
                  "valid": res["valid?"], "invokes": invokes,
                  "events": len(hist), "run_s": run_s,
                  "spans_ms": {k: v for k, v in tel["phases"].items()
                               if k in ("os-setup", "db-cycle", "case",
                                        "snarf-logs", "analyze", "run")
                               or k.startswith("teardown-")},
                  "interpreter_ops_per_s": invokes / facts["case_s"],
                  "check_s": tel["phases"].get("analyze", 0.0) / 1e3,
                  "stamp_s": sum(stamp_s), "cpu_analyze_s": cpu_s,
                  "cpu_stamp_s": sum(cpu_stamp_s), "launches": launches,
                  "wrapper_calls": calls, **facts, **line_twin,
                  "watchdog": {k: v for k, v in (res.get("watchdog")
                                                 or {}).items()
                               if k != "violations"},
                  "kernel_ms": kernel_ms,
                  "card_idle_share": (1 - kernel_ms / (1e3 * run_s)
                                      if kernel_ms is not None else None),
                  "card": nvidia_smi_line() if on_card else "cpu"})
            per_kernel[kernel][f"lifecycle-{name}"] = calls[kernel]
            del out, loaded, again
    # every thread alive now was alive before the phase (one of an
    # earlier caller's may have ended meanwhile: that is not a leak)
    leaked = [t.name for t in threading.enumerate() if t not in threads0]
    if leaked:
        raise AssertionError(f"threads started in the phase outlive it: "
                             f"{leaked}")
    if logging.getLogger().handlers != handlers0:
        raise AssertionError(f"log handlers left behind: "
                             f"{logging.getLogger().handlers}")
    emit({"phase": "lifecycle-total",
          "seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return per_kernel


# bench.py's fleet shape with each register tenant's 3,000 ops and the
# lifecycle run's 2,000 cut by half to keep the script inside its time
# limit
FLEET_SIZES = {"register_tenants": 32, "register_ops": 1_500, "chunk": 512,
               "corrupt": (7, 23), "elle_txns": 10_000,
               "core_run_ops": 1_000, "nemesis_ops": 8}


def fleet_histories(sizes: dict) -> dict:
    """{tenant: (model, history)}: bench.py's fleet shape for the register
    tenants (register_history(n, seed=3000 + i)), the ones listed in
    `corrupt` damaged at TWIN_AT_FRAC (where the witness search stays
    cheap, ROADMAP C3), and two list-append and two rw-register
    tenants past Elle's device dispatch."""
    out = {}
    for i in range(sizes["register_tenants"]):
        h = synth.register_history(sizes["register_ops"], seed=3000 + i)
        if i in sizes["corrupt"]:
            h = synth.corrupt_register_history(h, at_frac=TWIN_AT_FRAC)[0]
        out[f"reg{i:02d}"] = ("cas-register", h)
    for j in range(2):
        out[f"la{j}"] = ("list-append", synth.list_append_history(
            sizes["elle_txns"], seed=2200 + j))
        out[f"rw{j}"] = ("rw-register", synth.rw_register_history(
            sizes["elle_txns"], seed=2300 + j))
    return out


def _stream_tenant(addr, tenant: str, model: str, hist, chunk: int,
                   weight: float = 1.0, barrier=None) -> dict:
    """One tenant's stream: chunks of `chunk` ops, each acked once
    journaled, then (after the barrier, so the finals land together)
    fin and the verdict envelope."""
    c = fclient.FleetClient(addr, tenant, "r", model=model, weight=weight,
                            io_timeout_s=120.0)
    try:
        ops = list(hist)
        for i in range(0, len(ops), chunk):
            c.send_chunk(ops[i:i + chunk])
        if barrier is not None:
            barrier.wait(timeout=600)
        return c.finish(timeout_s=600)
    finally:
        c.close()


def _launch_records(recs: list, cls: str) -> list:
    return [r for r in recs if r["kind"] == "launch" and r["cls"] == cls]


def _fleet_solo(dev, hists: dict, sync) -> tuple[dict, dict]:
    """Each history's solo check on `dev` with its certificate
    (wgl.analysis, or the Elle family's check), one after another as a
    pool without the fleet would run them; returns the results and the
    wall seconds by model."""
    out, seconds = {}, {}
    for t, (model, h) in hists.items():
        t0 = time.perf_counter()
        if model == "cas-register":
            out[t] = wgl.analysis(models.cas_register(), h, certify=True,
                                  device=dev)
        else:
            out[t] = fleet.elle_checks()[model](
                h, {"certify": True, "device": dev})
        sync()
        seconds[model] = seconds.get(model, 0.0) + (time.perf_counter()
                                                    - t0)
    return out, seconds


def _fleet_cpu(hists: dict) -> dict:
    """The same checks with the kernels' plain versions on the CPU: the
    register histories in one analysis_batch (the plain kernel pays per
    level, so one batched launch instead of one per history), the Elle
    histories one by one."""
    regs = [t for t, (m, _h) in hists.items() if m == "cas-register"]
    res = wgl.analysis_batch(models.cas_register(),
                             [hists[t][1] for t in regs], certify=True,
                             device="cpu")
    out = dict(zip(regs, res))
    for t, (model, h) in hists.items():
        if model != "cas-register":
            out[t] = fleet.elle_checks()[model](
                h, {"certify": True, "device": "cpu"})
    return out


def _verdict_against(t: str, model: str, h, got: dict, want: dict,
                     where: str) -> None:
    """A fleet verdict against a check of the same history: the verdict
    (and Elle's anomaly types), and for a valid run the certificate byte
    for byte."""
    if got["valid?"] != want["valid?"]:
        raise AssertionError(f"{t}: fleet valid? {got['valid?']} != "
                             f"{where} {want['valid?']}")
    if model != "cas-register" and sorted(got.get("anomaly-types") or []) \
            != sorted(want.get("anomaly-types") or []):
        raise AssertionError(f"{t}: anomaly types differ from {where}")
    if got["valid?"] is True and json.dumps(got["certificate"],
                                            sort_keys=True).encode() \
            != _cert_bytes(want):
        raise AssertionError(f"{t}: certificate differs from {where}'s")


def fleet_core_run(dev, on_card: bool, addr, tmp, sizes: dict) -> dict:
    """Phase 21's lifecycle (the fixture DB over the dummy remote, the
    combined package's faults, monitor and node probe) with a
    single-register workload, the shape the fleet's cas-register model
    checks, and test["fleet"] pointing at the fleet. Returns the run's
    results."""
    card_dev = None if on_card else dev
    rng = util.seeded_rng(12, "fleet-core-run")
    w = {"generator": gen.limit(sizes["core_run_ops"],
                                lambda: wl_register.cas_op_mix(rng)),
         "checker": linearizable({"model": models.cas_register(0),
                                  "device": card_dev})}
    test = lifecycle_test("fleet-register", w,
                          testing.AtomClient(testing.AtomState(0),
                                             latency_s=0.0005),
                          5, tmp, sizes["nemesis_ops"])
    host, port = addr
    test["fleet"] = {"addr": f"{host}:{port}", "tenant": "core-run",
                     "model": "cas-register", "initial": 0}
    out = core.run(test)
    res = out["results"]
    fl = res.get("fleet") or {}
    if "verdict" not in fl:
        raise AssertionError(f"results['fleet'] without a verdict: {fl}")
    got = fl["verdict"]["result"]
    if got["valid?"] is not res["valid?"] or res["valid?"] is not True:
        raise AssertionError(f"core.run: fleet {got['valid?']} vs local "
                             f"{res['valid?']}")
    certify.validate(out["history"], got["certificate"])
    if json.dumps(got["certificate"], sort_keys=True).encode() \
            != _cert_bytes(res):
        raise AssertionError("core.run: the fleet's certificate differs "
                             "from the local checker's")
    fallback = res["telemetry"]["counters"].get("fleet.client.fallback", 0)
    if fallback:
        raise AssertionError(f"core.run: {fallback} client fallbacks")
    return {"valid": res["valid?"], "events": len(out["history"]),
            "fleet_ack_ms": fl.get("ack_ms"),
            "fleet_latency": fl["verdict"].get("latency"),
            "client_fallback": fallback}


def fleet_crash(dev, tenant: str, model: str, hist, chunk: int, base,
                want: bytes) -> dict:
    """One tenant's server kill()ed mid-stream and restarted on the same
    WAL directory and port; the verdict file must equal the clean run's
    byte for byte."""
    ops = list(hist)
    chunks = [ops[i:i + chunk] for i in range(0, len(ops), chunk)]
    srv = fserver.FleetServer(base, device=dev).start()
    c = fclient.FleetClient(srv.addr, tenant, "r", model=model,
                            io_timeout_s=30.0)
    half = len(chunks) // 2
    for ch in chunks[:half]:
        c.send_chunk(ch)
    port = srv.addr[1]
    srv.kill()
    srv2 = fserver.FleetServer(base, port=port, device=dev).start()
    try:
        for ch in chunks[half:]:
            c.send_chunk(ch)
        c.finish(timeout_s=300)
        c.close()
        got = fwal.verdict_path(base, tenant, "r").read_bytes()
        for s in (srv, srv2):
            _fleet_failures("fleet crash", s.stats()["scheduler"],
                            telemetry.get().counters())
    finally:
        srv2.stop()
    if got != want:
        raise AssertionError(f"{tenant}: the verdict after kill() differs "
                             f"from the clean run's")
    return {"tenant": tenant, "chunks_before_kill": half,
            "chunks": len(chunks), "verdict_bytes": len(got)}


def fleet_path(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 22: checking-as-a-service. Returns the launches per path, by
    kernel. The earlier phases' heap is frozen out of the collector, as
    in phases 20-21."""
    gc.collect()
    gc.freeze()
    try:
        return _fleet_path(dev, on_card, sizes)
    finally:
        gc.unfreeze()


def _check_launches(what: str, calls: dict, on_card: bool) -> None:
    """On the card, each wrapper's launch counter must equal the calls
    through it."""
    launches = _launch_counts()
    if on_card and {k: launches[k] for k in calls} != calls:
        raise AssertionError(f"{what}: launch counters {launches} != "
                             f"wrapper calls {calls}")


def _fleet_failures(what: str, sch: dict, counters: dict) -> dict:
    """A scheduler's stats and the run's telemetry counters must show no
    failed launch and no item kept from a shared device launch: no
    bisection, attribution, quarantine, breaker or host-lane item, and
    no client fallback. Returns what was read."""
    out = {"host_floor": sch["host_floor"],
           "quarantine_items": sch["quarantine_items"],
           "quarantined_runs": len(sch["quarantine"]),
           "bisect_launches": sch["bisect_launches"],
           "breaker_open": sch["breaker_open"]}
    for k in ("fleet.breaker.opened", "fleet.quarantine.added",
              "fleet.quarantine.attributions", "fleet.client.fallback"):
        out[k] = counters.get(k, 0)
    if any(out.values()):
        raise AssertionError(f"{what}: a failed launch or a host lane: "
                             f"{out}")
    return out


def _fleet_path(dev, on_card: bool, sizes: dict | None) -> dict:
    sizes = dict(FLEET_SIZES, **(sizes or {}))
    card_dev = None if on_card else dev
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card = nvidia_smi_line() if on_card else "cpu"
    t_phase = time.perf_counter()
    hists = fleet_histories(sizes)
    generate_s = time.perf_counter() - t_phase
    total_ops = sum(len(h) for _m, h in hists.values())
    per_kernel: dict = {"wgl_search": {}, "scc": {}}
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "fleet"
        sched = fsched.Scheduler(window_s=0.1, device=card_dev)
        srv = fserver.FleetServer(
            base, scheduler=sched,
            quotas=fserver.Quotas(max_tenants=len(hists) + 2,
                                  max_total_streams=2 * len(hists) + 4))
        runs: list = []
        run_orig = _recording(wgl, "_run", runs)
        recorded, restore = _wrapped_kernels()
        telemetry.reset()
        envs, errs = {}, []
        barrier = threading.Barrier(len(hists))

        def tenant(t, model, h):
            try:
                envs[t] = _stream_tenant(
                    srv.addr, t, model, h, sizes["chunk"],
                    weight=2.0 if t == "reg00" else 1.0, barrier=barrier)
            except Exception as e:  # noqa: BLE001 — raised below
                errs.append((t, repr(e)))
                barrier.abort()

        try:  # the server stops however the phase ends
            try:
                srv.start()
                t0 = time.perf_counter()
                workers = [threading.Thread(target=tenant, args=(t, m, h),
                                            name=f"tenant-{t}")
                           for t, (m, h) in hists.items()]
                for w in workers:
                    w.start()
                for w in workers:
                    w.join(timeout=900)
                sync()
                fleet_s = time.perf_counter() - t0
                stats = srv.stats()
                recs = srv.flightrec.records()
                # phase 23 (c) exports them as a Chrome trace
                per_kernel["flightrec_records"] = recs
                counters = telemetry.get().counters()
                # each launch's kernel time between the CUDA events its
                # launcher recorded just around it during the run
                drain_ms = [(sp.get("attrs") or {}).get("device_ms")
                            for sp in telemetry.get().spans()
                            if sp["name"] == "wgl:drain"]
                scc_ms = [(sp.get("attrs") or {}).get("device_ms")
                          for sp in telemetry.get().spans()
                          if sp["name"] == "scc:device"]
            finally:
                restore()
                wgl._run = run_orig
            launches = _launch_counts()
            calls = {label: len(v) for label, v in recorded.items()}
            if errs:
                raise AssertionError(f"fleet tenants failed: {errs[:5]}")
            sch = stats["scheduler"]
            host_lanes = _fleet_failures("fleet", sch, counters)
            _check_launches("fleet", calls, on_card)
            errors = [t for t, e in envs.items() if "error" in e["result"]]
            if errors:
                raise AssertionError(f"fleet verdicts with an error: {errors}")
            slice_recs = _launch_records(recs, "slice")
            final_recs = _launch_records(recs, "final")
            cross_slices = sum(1 for r in slice_recs if len(r["tenants"]) > 1)
            cross_finals = sum(1 for r in final_recs if len(r["tenants"]) > 1)
            if not cross_slices or not cross_finals:
                raise AssertionError(f"no cross-tenant launch: slices "
                                     f"{cross_slices}, finals {cross_finals}")
            frec_snap = stats["flightrec"]
            lat = [e["latency"] for e in envs.values()]
            for b in lat:
                fflightrec.validate_latency(b)
            fflightrec.validate_records(recs)
            # the fleet's slice launches against the plain version
            t0 = time.perf_counter()
            slices = [_replay(r, on_card) for r in runs if r[0][6]]
            mism = sum(x["mismatches"] for x in slices)
            if mism:
                raise AssertionError(f"fleet slice launches differ from the "
                                     f"plain version in {mism} values")
            kernel_ms = _replayed_kernel_ms(recorded, on_card)
            replay_s = time.perf_counter() - t0
            # every verdict against its solo check on the card and the CPU
            results = {t: e["result"] for t, e in envs.items()}
            solo, solo_s = _fleet_solo(dev, hists, sync)
            t0 = time.perf_counter()
            cpu = _fleet_cpu(hists)
            cpu_s = time.perf_counter() - t0
            for t, (model, h) in hists.items():
                got = results[t]
                if got["valid?"] is not (int(t[3:]) not in sizes["corrupt"]
                                         if model == "cas-register" else True):
                    raise AssertionError(f"{t}: fleet valid? {got['valid?']}")
                certify.validate(h, got["certificate"])
                _verdict_against(t, model, h, got, solo[t], "solo card")
                _verdict_against(t, model, h, got, cpu[t], "CPU")
            n_reg = sizes["register_tenants"]
            solo_total = sum(solo_s.values())
            emit({"phase": "fleet", "tenants": len(hists),
                  "register_tenants": n_reg, "events": total_ops,
                  "fleet_s": fleet_s,
                  "fleet_ops_per_s": total_ops / fleet_s,
                  "solo_s": solo_s, "solo_ops_per_s": total_ops / solo_total,
                  "fleet_over_solo": solo_total / fleet_s,
                  "launches": launches, "wrapper_calls": calls,
                  "slice_launches": sch["slice_launches"],
                  "slice_rows": sch["slice_rows"],
                  "rows_per_slice_launch": (sch["slice_rows"]
                                            / max(sch["slice_launches"], 1)),
                  "final_launches": sch["final_launches"],
                  "final_hists": sch["final_hists"],
                  "hists_per_final_launch": (sch["final_hists"]
                                             / max(sch["final_launches"], 1)),
                  "cross_tenant_slice_launches": cross_slices,
                  "cross_tenant_final_launches": cross_finals,
                  "max_tenants_in_launch": sch["max_tenants_in_launch"],
                  "slice_mismatches": mism,
                  "slice_kernel_ms": (sum(x["kernel_ms"] for x in slices)
                                      if on_card else None),
                  "slice_replays": [{k: x[k] for k in (
                      "rows", "M", "levels", "kernel_ms", "us_per_level",
                      "plain_ms", "bound_ms", "mismatches")} for x in slices],
                  "in_run_drain_device_ms": drain_ms,
                  "in_run_scc_device_ms": scc_ms,
                  "in_run_device_ms_total": (
                      sum(drain_ms) + sum(scc_ms) if on_card else None),
                  "verdict_ms": frec_snap["verdict_ms"],
                  "latency_mean_ms": {k: sum(b[k] for b in lat) / len(lat)
                                      for k in fflightrec.LATENCY_KEYS},
                  "decisions": frec_snap["decisions"],
                  "occupancy": {c: v["occupancy"] for c, v
                                in frec_snap["classes"].items()},
                  "host_lanes": host_lanes, "kernel_ms": kernel_ms,
                  "card_idle_share": (1 - kernel_ms / (1e3 * fleet_s)
                                      if kernel_ms is not None else None),
                  "invalid": sorted(t for t, r in results.items()
                                    if r["valid?"] is not True),
                  "generate_s": generate_s, "replay_s": replay_s,
                  "cpu_s": cpu_s, "card": card})
            per_kernel["wgl_search"]["fleet"] = calls["wgl_search"]
            per_kernel["scc"]["fleet"] = calls["scc"]
            # one tenant's server killed mid-stream, restarted, byte-equal
            crash_t = f"reg{min(3, n_reg - 1):02d}"
            want = fwal.verdict_path(base, crash_t, "r").read_bytes()
            recorded, restore = _wrapped_kernels()
            t0 = time.perf_counter()
            try:
                crash = fleet_crash(card_dev, crash_t, "cas-register",
                                    hists[crash_t][1], sizes["chunk"],
                                    Path(tmp) / "fleet-crash", want)
            finally:
                restore()
            crash["seconds"] = time.perf_counter() - t0
            calls = {label: len(v) for label, v in recorded.items()}
            _check_launches("fleet crash", calls, on_card)
            per_kernel["wgl_search"]["fleet-crash"] = calls["wgl_search"]
            emit({"phase": "fleet-crash", **crash, "wrapper_calls": calls,
                  "card": card})
            # core.run streaming to the same server
            recorded, restore = _wrapped_kernels()
            try:
                t0 = time.perf_counter()
                cr = fleet_core_run(dev, on_card, srv.addr, tmp, sizes)
                sync()
                cr_s = time.perf_counter() - t0
                _fleet_failures("fleet core.run", srv.stats()["scheduler"],
                                {})
            finally:
                # stopped before the wrappers go: no launch uncounted
                srv.stop()
                restore()
            calls = {label: len(v) for label, v in recorded.items()}
            _check_launches("fleet core.run", calls, on_card)
            per_kernel["wgl_search"]["fleet-core-run"] = calls["wgl_search"]
            emit({"phase": "fleet-core-run", **cr, "run_s": cr_s,
                  "wrapper_calls": calls, "card": card})
        finally:
            srv.stop()
    # the servers' threads are daemons; a killed server's stream steps
    # wait out their slices' timeout, as a dead process's would never
    # return. No other thread may outlive the phase.
    leaked = [t.name for t in threading.enumerate()
              if not t.daemon and t is not threading.main_thread()]
    if leaked:
        raise AssertionError(f"threads left behind: {leaked}")
    emit({"phase": "fleet-total", "seconds": time.perf_counter() - t_phase,
          "card": card})
    return per_kernel


# Phase 23's profiled whole runs: phase 21's register lifecycle at 20
# keys x 100 ops, then one list-append run past Elle's device dispatch
# and one bank run past the bank's (~12,000 reads: bank_reduce on the
# profiled timeline), each in a process of its own, run at once
# (profiled_runs says why); the dispatch-threshold sweeps (sizes from the thresholds kept from the
# TPU: DEVICE_MIN_EDGES 20,000, DEVICE_MIN_READS 10,000, SEGMENT_MIN_M
# 4,096, an octave or two each side); the median of REPS timings.
PROFILED_SIZES = {"register_keys": 20, "register_concurrency": 10,
                  "bank_ops": 24_000, "txn_ops": 10_000, "nemesis_ops": 2,
                  "stale_every": 50}
SCC_SWEEP_EDGES = (2_500, 5_000, 10_000, 20_000, 40_000, 80_000)
BANK_SWEEP_READS = (1_250, 2_500, 5_000, 10_000, 20_000, 40_000)
WGL_SWEEP_M = (1_024, 2_048, 4_096, 8_192, 16_384)
SWEEP_REPS = 5
PHASE_23_BUDGET_S = 60
# busy intervals of the card in a torch.profiler trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_NAMES = {"wgl_search": ("wgl_search_kernel",),
                "scc": ("scc_kernel", "scc_converge_kernel"),
                "bank_reduce": ("bank_reduce_kernel",)}


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_timeline(trace_path: Path, window_ns: int) -> dict:
    """The card's timeline in a torch.profiler Chrome trace: kernel
    events by kernel (KERNEL_NAMES), the union of the kernels' and of
    all device activity's intervals, and their share of a window (the
    `analyze` span the trace was taken in, which includes the
    profiler's own start and stop). `traced_ms` is the extent of the
    trace's timed events, the checkers' window alone."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    timed = [e for e in events if isinstance(e.get("ts"), (int, float))
             and isinstance(e.get("dur"), (int, float))]
    traced_us = (max(e["ts"] + e["dur"] for e in timed)
                 - min(e["ts"] for e in timed)) if timed else 0.0
    dev = [e for e in timed if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    counts = {k: sum(1 for e in kernels
                     if any(n in str(e.get("name", "")) for n in names))
              for k, names in KERNEL_NAMES.items()}
    busy_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in dev)
    kernel_us = _union_us((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    window_us = window_ns / 1e3
    cats: dict = {}
    for e in events:
        cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
    return {"events": len(events), "categories": cats,
            "device_events": len(dev),
            "kernel_events": counts, "other_kernels": sorted({
                str(e.get("name"))[:60] for e in kernels
                if not any(n in str(e.get("name", ""))
                           for names in KERNEL_NAMES.values()
                           for n in names)})[:10],
            "window_ms": window_us / 1e3, "traced_ms": traced_us / 1e3,
            "busy_ms": busy_us / 1e3,
            "kernel_ms": kernel_us / 1e3,
            "busy_share": busy_us / window_us if window_us else None,
            "kernel_share": kernel_us / window_us if window_us else None,
            "idle_share": 1 - busy_us / window_us if window_us else None,
            "traced_idle_share": (1 - busy_us / traced_us if traced_us
                                  else None)}


def _run_reports(name: str, d: Path, calls: dict) -> dict:
    """Phase 23 (c) over one stored run: its trace.json, metrics.json,
    profile text and Prometheus text."""
    events, metrics = store.load_telemetry(d)
    telemetry.validate_metrics(metrics)
    kernel_spans = [e for e in events if e["name"].startswith("kernel:")]
    doc = json.loads(rtrace.write_trace(d).read_text())
    n_events = rtrace.validate_chrome_trace(doc)
    dev_slices = [e for e in doc["traceEvents"]
                  if e.get("pid") == rtrace._PID_DEVICE and e["ph"] == "X"]
    if sorted((e["name"], e["ts"]) for e in dev_slices) != sorted(
            (s["name"][len("kernel:"):], s["t0"] / 1e3)
            for s in kernel_spans):
        raise AssertionError(f"{name}: {len(dev_slices)} device-track "
                             f"slices for {len(kernel_spans)} kernel spans")
    c = metrics["counters"]
    fam = {k: sum(v for kk, v in c.items()
                  if kk.startswith(f"profiler.{p}") and
                  kk.endswith(".launches"))
           for k, p in (("wgl_search", "wgl"), ("scc", "scc"))}
    want = {"wgl_search": calls["wgl_search"], "scc": calls["scc"]}
    if fam != want:
        raise AssertionError(f"{name}: profiler launches {fam} != wrapper "
                             f"calls {want}")
    rows = rprofile.kernel_rows(metrics)
    text = rprofile.profile_text(events, metrics)
    # bank_reduce makes no record (nor does the JAX package's bank)
    if any(fam.values()) and (not rows or "kernel" not in text):
        raise AssertionError(f"{name}: no profile table: {text[:200]}")
    prom = rprofile.prometheus_text(metrics, run=name)
    n_samples = rprofile.validate_prometheus_text(prom)
    return {"trace_events": n_events, "device_slices": len(dev_slices),
            "profiler_launches": fam, "profile_rows": len(rows),
            "prometheus_samples": n_samples,
            "profile_text": text.splitlines()[:8]}


def profiled_run(name: str, dev, on_card: bool, sizes: dict) -> dict:
    """One of phase 23's profiled runs in this process: phase 21's
    `name` run through core.run with profile? on, its xprof trace's
    device timeline over the `analyze` span, and its reports (which
    raise if they do not validate). Returns the run's line."""
    card_dev = None if on_card else dev
    spec = {s["name"]: s for s in lifecycle_runs(sizes)}[name]
    with tempfile.TemporaryDirectory() as tmp:
        w = spec["workload"](dict(spec["opts"], device=card_dev))
        test = lifecycle_test(f"profiled-{name}", w, spec["client"](),
                              spec["concurrency"], tmp,
                              sizes["nemesis_ops"])
        test["profile?"] = True
        recorded, restore = _wrapped_kernels()
        try:
            t0 = time.perf_counter()
            res = core.run(test)
            run_s = time.perf_counter() - t0
        finally:
            restore()
        launches = _launch_counts()
        calls = {label: len(v) for label, v in recorded.items()}
        if res["results"]["valid?"] is not True:
            raise AssertionError(f"profiled {name}: "
                                 f"{res['results']['valid?']}")
        d = Path(res["store_dir"])
        trace = d / "xprof" / util.PROFILE_TRACE_FILE
        if not trace.exists():
            raise AssertionError(f"profiled {name}: no {trace}")
        events, _m = store.load_telemetry(d)
        (analyze,) = [e for e in events if e["name"] == "analyze"]
        return {"phase": "profiled-run", "run": name, "kernel":
                spec["kernel"], "run_s": run_s,
                "events": len(res["history"]), "launches": launches,
                "wrapper_calls": calls,
                "trace_bytes": trace.stat().st_size,
                "timeline": device_timeline(trace, analyze["t1"]
                                            - analyze["t0"]),
                **_run_reports(f"profiled-{name}", d, calls),
                "card": nvidia_smi_line() if on_card else "cpu"}


def _child(name: str, dev, on_card: bool, sizes: dict):
    """Starts profiled_run in a process of its own, from this file's
    directory; its line comes back on stdout (_child_line)."""
    code = ("import json, torch, chip_smoke as cs; "
            f"line = cs.profiled_run({name!r}, torch.device({str(dev)!r}), "
            f"{on_card!r}, {sizes!r}); "
            "print('PROFILED-RUN ' + json.dumps(line), flush=True)")
    return subprocess.Popen([sys.executable, "-c", code],
                            cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _child_line(name: str, proc) -> dict:
    out, err = proc.communicate(timeout=600)
    lines = [ln for ln in out.splitlines() if ln.startswith("PROFILED-RUN ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"profiled {name}: the run's process exited "
                             f"{proc.returncode}: {err[-3000:]}")
    return json.loads(lines[0][len("PROFILED-RUN "):])


def profiled_runs(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 23 (b) and (c): whole Jepsen runs with profile? on, each in
    a fresh process (on the card machine, torch.profiler's CUPTI
    collection loses device records in a process that has already run
    a Jepsen test: the trace must be the run's first session). The
    three processes run at once: each trace holds its own process's
    device activity, and the card's busy time is the sum over them. The
    run directory's xprof trace must hold a kernel event for each launch
    of wgl_search, scc and bank_reduce (on the card), and the run's
    reports must validate. Prints the card's busy and idle share of each
    analysis."""
    sizes = dict(PROFILED_SIZES, **(sizes or {}))
    out: dict = {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
    names = ("register", "list-append", "bank")
    procs = {name: _child(name, dev, on_card, sizes) for name in names}
    try:
        lines = {name: _child_line(name, procs[name]) for name in names}
    finally:
        for proc in procs.values():  # stop every process this started
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for name in names:
        line = lines[name]
        emit(line)
        launches, kernel = line["launches"], line["kernel"]
        if on_card:
            want = {"wgl_search": launches["wgl_search"],
                    "scc": launches["scc"] + launches["scc_converge"],
                    "bank_reduce": launches["bank_reduce"]}
            got = {k: line["timeline"]["kernel_events"][k] for k in want}
            if got != want or not launches[kernel]:
                raise AssertionError(f"profiled {name}: trace kernel "
                                     f"events {got} != launches {want}")
        out[kernel][f"profiled-{name}"] = line["wrapper_calls"][kernel]
    return out


def _median_s(fn, reps: int, sync) -> float:
    """Median wall seconds of `reps` calls of fn, after one call that
    warms imports, caches and the kernel library."""
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _crossover(rows: list, slow: str, fast: str):
    """The smallest size from which `fast` beats `slow` at every larger
    size of the sweep, or None."""
    for i, r in enumerate(rows):
        if all(x[fast] < x[slow] for x in rows[i:]):
            return r["size"]
    return None


def threshold_sweeps(dev, on_card: bool, reps: int = SWEEP_REPS,
                     scc_edges=SCC_SWEEP_EDGES, bank_reads=BANK_SWEEP_READS,
                     wgl_m=WGL_SWEEP_M) -> dict:
    """Phase 23 (d): the dispatch thresholds kept from the TPU, measured
    only (no threshold changes): host against card for scc and the bank
    fold, one-row search against check_segmented for wgl, each the
    median of `reps` wall times of the entry point's own dispatch
    (module threshold set to send every size one way, then the other,
    and restored)."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    card_dev = None if on_card else dev
    out = {}
    # scc: Edges.scc over a fresh edge array (upload included)
    rows = []
    saved = scc_mod.DEVICE_MIN_EDGES
    try:
        for E in scc_edges:
            n = E // 8
            rng = np.random.default_rng(E)
            src = rng.integers(0, n, E).astype(np.int32)
            dst = rng.integers(0, n, E).astype(np.int32)
            t = {}
            for way, thr in (("host", 1 << 62), ("card", 0)):
                scc_mod.DEVICE_MIN_EDGES = thr
                t[way] = _median_s(lambda: scc_mod.Edges(
                    n, src, dst, device=card_dev).scc(), reps, sync)
            rows.append({"size": E, "nodes": n, "host_s": t["host"],
                         "card_s": t["card"]})
    finally:
        scc_mod.DEVICE_MIN_EDGES = saved
    out["scc"] = {"threshold": saved, "unit": "live edges", "rows": rows,
                  "crossover": _crossover(rows, "host_s", "card_s")}
    # bank: check_fast over the reads of a 32-account history
    hist = synth.bank_history(2 * max(bank_reads) + 10_000, n_accounts=32,
                              seed=23)
    reads = [o for o in hist if o.type == "ok" and o.f == "read"]
    if len(reads) < max(bank_reads):
        raise AssertionError(f"{len(reads)} reads < {max(bank_reads)}")
    total = 32 * 10
    rows = []
    saved = bank.DEVICE_MIN_READS
    try:
        for R in bank_reads:
            t = {}
            for way, thr in (("host", 1 << 62), ("card", 0)):
                bank.DEVICE_MIN_READS = thr
                t[way] = _median_s(lambda: bank.check_fast(
                    reads[:R], total, device=card_dev), reps, sync)
            rows.append({"size": R, "host_s": t["host"],
                         "card_s": t["card"]})
    finally:
        bank.DEVICE_MIN_READS = saved
    out["bank"] = {"threshold": saved, "unit": "reads", "rows": rows,
                   "crossover": _crossover(rows, "host_s", "card_s")}
    # wgl: the one-row search against check_segmented (both on the card)
    rows = []
    for m in wgl_m:
        h = synth.register_history(int(m / 0.8), n_procs=5, seed=m)
        enc = encode(models.cas_register(), h)
        one = _median_s(lambda: wgl.check_batch([enc], W=32, F=64,
                                                device=card_dev), reps, sync)
        seg = _median_s(lambda: wgl.check_segmented(
            enc, witness=True, device=card_dev, W=24, F=48), reps, sync)
        rows.append({"size": enc.m, "target_m": m, "one_row_s": one,
                     "segmented_s": seg})
    out["wgl"] = {"threshold": wgl.SEGMENT_MIN_M, "unit": "entries",
                  "rows": rows,
                  "crossover": _crossover(rows, "one_row_s", "segmented_s")}
    for k, v in out.items():
        emit({"phase": "threshold", "kernel": k, **v,
              "card": nvidia_smi_line() if on_card else "cpu"})
    return out


def ledger_entries(kernels: list, headline_check_s: float,
                   on_card: bool) -> int:
    """Phase 23 (e): one bench-ledger entry per kernel of the kernels
    line, appended to a temporary ledger through ledger.append_entry and
    read back through validate_entries. The value is the kernel's ms on
    the card (its plain version's off the card)."""
    key = "ms" if on_card else "plain_ms"
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / ledger.LEDGER_FILE
        for k in kernels:
            entries = ledger.read_entries(path)
            ledger.append_entry(path, {
                "round": ledger.next_round(entries),
                "headline": {"metric": "headline check_s",
                             "value": headline_check_s, "unit": "s"},
                "kernels": {k["name"]: {"value": k[key], "unit": key,
                                        "higher_is_better": False}}})
        entries = ledger.read_entries(path)
        n = ledger.validate_entries(entries)
    if n != len(kernels):
        raise AssertionError(f"{n} ledger entries for {len(kernels)} "
                             f"kernels")
    emit({"phase": "ledger", "entries": n,
          "kernels": [next(iter(e["kernels"])) for e in entries],
          "rounds": [e["round"] for e in entries]})
    return n


def profiler_path(dev, on_card: bool, fleet_records: list,
                  profiled_sizes: dict | None = None,
                  sweep: dict | None = None) -> dict:
    """Phase 23 (b)-(d): profiled whole runs and their reports, the
    fleet's flight-recorder records as a Chrome trace, the threshold
    sweeps. Returns the launches per path, by kernel."""
    gc.collect()
    gc.freeze()
    log = logging.getLogger("jepsen_tpu_torch")
    level = log.level
    log.setLevel(logging.WARNING)
    try:
        t0 = time.perf_counter()
        launches = profiled_runs(dev, on_card, profiled_sizes)
        runs_s = time.perf_counter() - t0
        doc = rtrace.fleet_chrome_trace(fleet_records)
        n_fleet = rtrace.validate_chrome_trace(doc)
        if not [e for e in doc["traceEvents"]
                if e.get("cat") == "fleet.launch"]:
            raise AssertionError("the fleet trace holds no launch")
        emit({"phase": "fleet-trace", "records": len(fleet_records),
              "events": n_fleet})
        t1 = time.perf_counter()
        thresholds = threshold_sweeps(dev, on_card, **(sweep or {}))
        emit({"phase": "profiler-total",
              "seconds": time.perf_counter() - t0, "runs_s": runs_s,
              "sweep_s": time.perf_counter() - t1,
              "budget_s": PHASE_23_BUDGET_S,
              "crossovers": {k: v["crossover"]
                             for k, v in thresholds.items()},
              "card": nvidia_smi_line() if on_card else "cpu"})
        return launches
    finally:
        log.setLevel(level)
        gc.unfreeze()



def headline_profile(records: list, events: list, launches: int,
                     on_card: bool) -> dict:
    """Phase 23 (a): the profiler's records of one headline check. Their
    count must equal the launch counter and each record's compute_ns the
    CUDA-event time of a launch of the check, read again here from the
    events the launcher recorded. Prints each kernel's launches, compute
    ms and bytes. Returns {kernel: [records]}."""
    by_kernel: dict = {}
    for r in records:
        by_kernel.setdefault(r["kernel"], []).append(r)
    wgl_recs = [r for r in records if r["kernel"].startswith("wgl")]
    if on_card:
        if len(wgl_recs) != launches:
            raise AssertionError(f"{len(wgl_recs)} wgl records for "
                                 f"{launches} launches")
        want = sorted(round(a.elapsed_time(b) * 1e6) for a, b in events)
        got = sorted(r["compute_ns"] for r in wgl_recs)
        if got != want:
            raise AssertionError(f"record compute_ns {got} != the "
                                 f"launches' CUDA-event ns {want}")
    emit({"phase": "profiler-headline", "launch_counter": launches,
          "kernels": {k: {"launches": len(v),
                          "compute_ms": sum(r.get("compute_ns", 0)
                                            for r in v) / 1e6,
                          "bytes_accessed": sum(r.get("bytes_accessed", 0)
                                                for r in v),
                          "flops": sum(r.get("flops") or 0 for r in v),
                          "peak_memory_bytes": max(
                              r.get("peak_memory_bytes") or 0 for r in v),
                          "compile_ns": [r["compile_ns"] for r in v
                                         if r.get("compile_ns")]}
                      for k, v in by_kernel.items()},
          "compute_ns_equal_events": on_card})
    return by_kernel


# ---------------------------------------------------------------------------
# Phase 24: every workload of the registry
# ---------------------------------------------------------------------------

# Phase 24's sizes: "ops" bounds the entries whose generator has no bound
# of its own (bank, dirty-read, kafka, sequential, append, wr); every other
# entry runs at its workload's default opts. kafka_ops sizes the extra
# kafka run and its twin, so cycle_anomalies sees a graph of a user's run.
REGISTRY_SIZES = {"ops": 500, "kafka_ops": 10_000}

_NODES2 = ["n1", "n2"]
_NODES3 = ["n1", "n2", "n3"]


def _run_spec(name, entry, opts, client, concurrency, nodes=None,
              stagger=None, twin=False) -> dict:
    """One run of phase 24: a registry entry, its opts, a client factory
    over a package's testing module, the threads, the nodes, an extra
    stagger of the generator (where the JAX package's test of the fixture
    has one) and whether the client is at fault."""
    return {"name": name, "entry": entry, "opts": opts, "client": client,
            "concurrency": concurrency, "nodes": nodes, "stagger": stagger,
            "twin": twin}


def registry_entries(sizes: dict) -> list[dict]:
    """Every entry of workloads.REGISTRY, in its order, with the fixture
    client the entry runs against, at the workload's default opts."""
    n = sizes["ops"]
    specs = {
        "adya-g2": ({}, lambda t: t.G2Client(), 4),
        "bank": ({"ops": n, "seed": 11},
                 lambda t: t.BankClient(t.BankState(list(range(8)))), 5),
        "causal": ({}, lambda t: t.CausalClient(), 2),
        "causal-reverse": ({}, lambda t: t.PerKeySetClient(), 4),
        "counter": ({"seed": 3}, lambda t: t.CounterClient(), 6),
        "dirty-read": ({"ops": n, "concurrency": 6, "seed": 5},
                       lambda t: t.DirtyReadClient(), 6, _NODES3),
        "fenced-lock": ({}, lambda t: t.LockClient(), 4),
        "kafka": ({"ops": n, "seed": 1}, lambda t: t.KafkaClient(), 4),
        "lock": ({}, lambda t: t.LockClient(fences=False), 4),
        "long-fork": ({}, lambda t: t.TxnClient(), 6),
        "lost-updates": ({}, lambda t: t.VersionedSetClient(), 5),
        "monotonic": ({}, lambda t: t.MonotonicClient(), 4, _NODES2),
        "multimonotonic": ({}, lambda t: t.MultiRegClient(), 4),
        "owner-lock": ({}, lambda t: t.LockClient(fences=False), 4),
        "pages": ({"seed": 1}, lambda t: t.PagesClient(), 4),
        "queue": ({}, lambda t: t.QueueClient(), 6),
        "reentrant-lock": ({}, lambda t: t.LockClient(reentrant_limit=2),
                           4),
        "register": ({"seed": 8}, lambda t: t.KVClient(t.KVState()), 10),
        "run-coverage": ({"seed": 3}, lambda t: t.SchedulerClient(), 4),
        "semaphore": ({}, lambda t: t.LockClient(t.LockState(permits=2),
                                                 semaphore=True), 4),
        "sequential": ({"ops": n, "seed": 11},
                       lambda t: t.SequentialClient(), 10),
        "set": ({}, lambda t: t.SetClient(), 6),
        "set-full": ({}, lambda t: t.SetClient(), 6),
        "append": ({"ops": n, "seed": 9}, lambda t: t.TxnClient(), 6),
        "upsert": ({}, lambda t: t.UpsertClient(), 4),
        "version-divergence": ({}, lambda t: t.VersionRegClient(), 6),
        "wr": ({"ops": n, "seed": 9}, lambda t: t.TxnClient(), 6),
        "unique-ids": ({}, lambda t: t.UniqueIdsClient(), 6),
    }
    if list(specs) != list(workloads.REGISTRY):
        raise AssertionError(f"phase 24's entries {list(specs)} != the "
                             f"registry's {list(workloads.REGISTRY)}")
    return [_run_spec(name, name, *spec) for name, spec in specs.items()]


def registry_twins(sizes: dict) -> list[dict]:
    """A twin for each fixture with a fault knob, the knob set, at the
    sizes and settings of the JAX package's test of it
    (tests/test_workloads.py, test_new_workloads.py, test_causal_adya.py;
    the kafka twins have no JAX test and hide key 0's first offset), and
    the kafka run and its twin at sizes["kafka_ops"]."""
    s = 0.0003
    k = sizes["kafka_ops"]
    return [_run_spec(*spec, twin=twin) for twin, spec in (
        (True, ("set-twin", "set", {"ops": 60},
                lambda t: t.SetClient(drop_every=10), 6)),
        (True, ("set-full-twin", "set-full", {"ops": 80},
                lambda t: t.SetClient(drop_every=10), 6)),
        (True, ("queue-twin", "queue", {"ops": 60},
                lambda t: t.QueueClient(drop_every=7), 6)),
        (True, ("unique-ids-twin", "unique-ids", {"ops": 50},
                lambda t: t.UniqueIdsClient(dup_every=9), 6)),
        (True, ("adya-g2-twin", "adya-g2", {"key-count": 6},
                lambda t: t.G2Client(broken=True), 4, ["n1"])),
        (True, ("causal-twin", "causal", {"keys": [0, 1, 2]},
                lambda t: t.CausalClient(lose_write=True), 2, ["n1"])),
        (True, ("causal-reverse-twin", "causal-reverse",
                {"keys": [0, 1], "per-key-limit": 40},
                lambda t: t.PerKeySetClient(hide_first=True), 4, ["n1"])),
        (True, ("kafka-twin", "kafka", {"ops": sizes["ops"], "seed": 1},
                lambda t: t.KafkaClient(lose_offset=(0, 0)), 4)),
        (False, ("kafka-depth", "kafka", {"ops": k, "seed": 2},
                 lambda t: t.KafkaClient(), 4)),
        (True, ("kafka-depth-twin", "kafka", {"ops": k, "seed": 2},
                lambda t: t.KafkaClient(lose_offset=(0, 0)), 4)),
        (True, ("monotonic-skew-twin", "monotonic", {"ops": 120},
                lambda t: t.MonotonicClient(skew_every=10), 4, _NODES2, s)),
        (True, ("monotonic-dup-twin", "monotonic", {"ops": 120},
                lambda t: t.MonotonicClient(dup_every=15), 4, _NODES2, s)),
        (True, ("sequential-twin", "sequential",
                {"ops": 300, "writers": 3, "seed": 11},
                lambda t: t.SequentialClient(hide_first_every=2), 6, ["n1"],
                s)),
        (True, ("dirty-read-dirty-twin", "dirty-read",
                {"ops": 400, "concurrency": 6, "seed": 5},
                lambda t: t.DirtyReadClient(dirty_every=3), 6, _NODES3, s)),
        (True, ("dirty-read-lose-twin", "dirty-read",
                {"ops": 300, "concurrency": 6, "seed": 5},
                lambda t: t.DirtyReadClient(lose_every=4), 6, _NODES3, s)),
        (True, ("upsert-twin", "upsert", {"key_count": 8},
                lambda t: t.UpsertClient(race_every=3), 4, _NODES2, s)),
        (True, ("run-coverage-miss-twin", "run-coverage",
                {"jobs": 10, "seed": 3, "stagger": 0.0005},
                lambda t: t.SchedulerClient(miss_every=4), 4, _NODES2, s)),
        (True, ("run-coverage-late-twin", "run-coverage",
                {"jobs": 8, "seed": 5, "stagger": 0.0005},
                lambda t: t.SchedulerClient(late_every=3), 4, _NODES2, s)),
        (True, ("pages-twin", "pages",
                {"key_count": 3, "ops_per_key": 60, "elements": 500,
                 "seed": 1},
                lambda t: t.PagesClient(tear_every=2), 4, _NODES2, s)),
        (True, ("multimonotonic-twin", "multimonotonic",
                {"ops": 300, "writers": 2},
                lambda t: t.MultiRegClient(stale_every=3), 4, _NODES2, s)),
        (True, ("lost-updates-twin", "lost-updates",
                {"key_count": 3, "group_size": 4, "ops_per_key": 60},
                lambda t: t.VersionedSetClient(lose_every=5), 4, _NODES2,
                s)),
        (True, ("version-divergence-twin", "version-divergence",
                {"key_count": 2, "ops_per_key": 80},
                lambda t: t.VersionRegClient(diverge_every=4), 6, _NODES2,
                s)),
        (True, ("owner-lock-twin", "owner-lock", {"ops": 120},
                lambda t: t.LockClient(fences=False, steal_every=3), 4,
                _NODES2, s)),
        (True, ("fenced-lock-twin", "fenced-lock", {"ops": 120},
                lambda t: t.LockClient(steal_every=3), 4, _NODES2, s)),
        (True, ("semaphore-twin", "semaphore", {"ops": 140, "permits": 2},
                lambda t: t.LockClient(t.LockState(permits=3),
                                       semaphore=True), 6, _NODES2, s)),
    )]


def registry_runs(sizes: dict) -> list[dict]:
    return registry_entries(sizes) + registry_twins(sizes)


def registry_test(spec: dict, w: dict, client, pkg_testing=None,
                  pkg_gen=None) -> dict:
    """A clusterless test of one phase-24 run: the noop test with the
    workload's generator (and its final phase after it) on the client
    threads, its checker and its other keys. pkg_testing and pkg_gen
    default to the port's (the tests run the JAX package's too)."""
    t_mod = pkg_testing or testing
    g_mod = pkg_gen or gen
    g = w["generator"]
    if spec["stagger"]:
        g = g_mod.stagger(spec["stagger"], g)
    g = g_mod.clients(g)
    if w.get("final_generator") is not None:
        g = g_mod.phases(g, g_mod.clients(w["final_generator"]))
    test = t_mod.noop_test()
    test.update(concurrency=spec["concurrency"], client=client,
                checker=w["checker"], generator=g)
    if spec["nodes"]:
        test["nodes"] = list(spec["nodes"])
    for k, v in w.items():
        if k not in ("generator", "checker", "final_generator"):
            test[k] = v
    return test


def registry_view(res) -> dict:
    """The verdicts, anomaly and error types and every count of a result
    tree, by where each sits."""
    out = {}

    def walk(x, where):
        if isinstance(x, dict):
            for k, v in x.items():
                if k in ("valid?", "failures", "anomaly-types",
                         "error-types", "bad-error-types", "first-error") \
                        or (isinstance(k, str) and k.endswith("-count")):
                    out[f"{where}/{k}"] = _norm(v)
                elif k != "certificate":
                    walk(v, f"{where}/{k}")

    walk(res, "")
    return out


# what each twin must show (the JAX package's test asserts each but the
# set-full twin's, which it does not run; the kafka twins lose key 0's
# first message: a lost write below the highest polled offset)
REGISTRY_FACTS = {
    "adya-g2-twin": lambda r: r["illegal-count"] > 0,
    "kafka-twin": lambda r: "lost-write" in r["kafka"]["bad-error-types"],
    "kafka-depth-twin":
        lambda r: "lost-write" in r["kafka"]["bad-error-types"],
    "monotonic-skew-twin":
        lambda r: bool(r["value-reorders"]) and not r["order-by-errors"],
    "monotonic-dup-twin": lambda r: bool(r["duplicates"]),
    "sequential-twin": lambda r: r["bad-count"] > 0,
    "dirty-read-dirty-twin": lambda r: r["dirty-count"] > 0,
    "dirty-read-lose-twin": lambda r: r["lost-count"] > 0,
    "run-coverage-miss-twin": lambda r: any(
        s["unsatisfied-targets"] for s in r["jobs"].values()
        if not s["valid?"]),
    "multimonotonic-twin": lambda r: r["ts-order"]["valid?"] is False,
    "run-coverage": lambda r: not r["incomplete"],
    "sequential": lambda r: r["all-count"] + r["some-count"]
    + r["none-count"] > 0,
}
# runs whose verdict the threads' interleaving decides: the causal chain
# of a key is carried by two threads at once (ROADMAP C9)
INTERLEAVING_DECIDES = {"causal"}


def registry_verdict(spec: dict, res: dict) -> None:
    """Raises unless res is the verdict the run must give."""
    name = spec["name"]
    if name not in INTERLEAVING_DECIDES:
        if res["valid?"] is spec["twin"]:
            raise AssertionError(f"{name}: valid? {res['valid?']}")
    fact = REGISTRY_FACTS.get(name)
    if fact is not None and not fact(res):
        raise AssertionError(f"{name}: result lacks its fact: "
                             f"{registry_view(res)}")


def registry_path(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 24: every registry entry, its twins and the kafka run at
    depth, each recorded by the port's interpreter and checked twice, on
    the card (device left at its default) and with "device": "cpu". The
    earlier phases' heap is frozen out of the collector, as in phase 20.
    Returns the launches per run, by kernel."""
    gc.collect()
    gc.freeze()
    try:
        return _registry_path(dev, on_card, sizes)
    finally:
        gc.unfreeze()


def _registry_path(dev, on_card: bool, sizes: dict | None) -> dict:
    sizes = dict(REGISTRY_SIZES, **(sizes or {}))
    card_dev = None if on_card else dev
    t_phase = time.perf_counter()
    per_kernel: dict = {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
    for spec in registry_runs(sizes):
        name = spec["name"]
        ctor = workloads.REGISTRY[spec["entry"]]
        w = ctor(dict(spec["opts"], device=card_dev))
        test, interp_s, icount = interpret(registry_test(
            spec, w, spec["client"](testing)))
        hist = test["history"]
        invokes = sum(1 for o in hist if o.type == "invoke")
        res, check_s, calls, launches, _rec, _spans, counters = \
            _counted_check(w["checker"], test, hist, on_card)
        wcpu = ctor(dict(spec["opts"], device="cpu"))
        cres, cpu_s, ccalls = _counted_check(wcpu["checker"], test, hist,
                                             False)[:3]
        unknown = [k for k, v in registry_view(res).items()
                   if k.endswith("valid?") and v == "unknown"]
        if unknown:
            raise AssertionError(f"{name}: unknown at {unknown}")
        if registry_view(res) != registry_view(cres):
            raise AssertionError(f"{name}: card {registry_view(res)} != "
                                 f"cpu {registry_view(cres)}")
        if not any(calls.values()) and _norm(res) != _norm(cres):
            raise AssertionError(f"{name}: card and cpu results differ")
        if calls != ccalls:
            raise AssertionError(f"{name}: wrapper calls card {calls} != "
                                 f"cpu {ccalls}")
        if on_card and {k: launches[k] for k in calls} != calls:
            raise AssertionError(f"{name}: launch counters {launches} != "
                                 f"wrapper calls {calls}")
        registry_verdict(spec, res)
        line = {"phase": "registry", "run": name, "entry": spec["entry"],
                "twin": spec["twin"], "invokes": invokes,
                "events": len(hist), "concurrency": spec["concurrency"],
                "interpreter_s": interp_s,
                "interpreter_ops_per_s": invokes / interp_s,
                "valid": res["valid?"], "check_s": check_s,
                "cpu_check_s": cpu_s,
                "launches": launches if on_card else None,
                "wrapper_calls": calls,
                "scc_paths": {k: counters.get(k, 0) for k in (
                    "scc.path.device", "scc.path.host")},
                "card": nvidia_smi_line() if on_card else "cpu"}
        emit(line)
        for kernel, n in calls.items():
            if n and kernel in per_kernel:
                per_kernel[kernel][f"registry-{name}"] = n
    emit({"phase": "registry-total",
          "runs": len(registry_runs(sizes)),
          "seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return per_kernel


# Phase 25's whole tests under the transports and the filesystem faults:
# phase 21's register at 20 keys x 100 ops (the profiled runs' size) and
# a list-append run of 10,000 txns (past Elle's device dispatch), each
# with about 24 nemesis ops at a 1 s interval. transport_faults is the
# number of commands on which the default-stack run's dummy transport
# raises a TransportError once; view_interval is the membership
# nemesis's poll period.
A3C_SIZES = {"register_keys": 20, "register_concurrency": 10,
             "txn_ops": 10_000, "nemesis_ops": 24, "stale_every": 1,
             "transport_faults": 3, "view_interval": 0.05}
A3C_FAULTS = ["file-corruption", "kill", "clock", "membership"]
LAZYFS_DIR = f"{FIXTURE_DIR}/data"
FIXTURE_BIN = f"{FIXTURE_DIR}/bin/fixture-db"
# the fs_cache path of the fixture DB's binary, which every node deploys
FIXTURE_ARTIFACT = ["fixture-db", "1.0", "bin"]
TCPDUMP_PID = "5151"
# the port the fixture DB listens on and tcpdump captures
FIXTURE_PORT = 7070
SSH_USER = "admin"


class MemberList:
    """An in-memory member API shared by the nodes (the fake member API
    of the JAX package's tests/test_membership.py, without a database):
    names to member ids; a node that is not a member answers nothing."""

    def __init__(self, nodes):
        self.lock = threading.Lock()
        self.members = {str(n): 1000 + i for i, n in enumerate(nodes)}
        self.next_id = 2000

    def view(self, node) -> dict:
        """{name: id} as `node` sees the cluster."""
        with self.lock:
            if str(node) not in self.members:
                raise ConnectionRefusedError(f"{node} is not a member")
            return dict(self.members)

    def add(self, name) -> None:
        with self.lock:
            self.members[str(name)] = self.next_id
            self.next_id += 1

    def remove(self, member_id) -> None:
        with self.lock:
            for name, mid in list(self.members.items()):
                if mid == member_id:
                    del self.members[name]
                    return
        raise KeyError(f"no member {member_id}")


class MemberMachine:
    """The membership state machine over a MemberList, written once and
    subclassed with a package's MembershipState (FixtureMembership below;
    the port's tests subclass the JAX package's as well). Views are
    frozensets of member names and the majority view wins, ties to the
    largest. It removes a random member while the cluster is above its
    majority floor, then adds a removed node back: it never leaves a
    cluster without a quorum. An add with a `db` wipes the node's stale
    data directory and starts the DB there, through `control` (the
    package's control module, a class attribute of the subclass)."""

    control = None

    def __init__(self, members: MemberList, db=None, seed=None):
        super().__init__()
        self.members = members
        self.db = db
        self.member_ids: dict = {}
        self.rng = random.Random(seed)

    def node_view(self, test, node):
        try:
            ids = self.members.view(node)
        except ConnectionRefusedError:  # not a member: view unknown
            return None
        self.member_ids.update(ids)
        return frozenset(ids)

    def merge_views(self, test):
        counts: dict = {}
        for v in self.node_views.values():
            counts[v] = counts.get(v, 0) + 1
        if not counts:
            return None
        return max(counts, key=lambda v: (counts[v], len(v)))

    def fs(self):
        return {"add-member", "remove-member"}

    def op(self, test):
        if self.view is None or self.pending:
            return "pending"
        nodes = set(map(str, test.get("nodes", ())))
        active = set(self.view) & nodes
        removed = nodes - set(self.view)
        if active and len(active) > len(nodes) // 2 + 1:
            return {"type": "info", "f": "remove-member",
                    "value": self.rng.choice(sorted(active))}
        if removed:
            return {"type": "info", "f": "add-member",
                    "value": self.rng.choice(sorted(removed))}
        return "pending"

    def invoke(self, test, op):
        target = op.value
        if op.f == "remove-member":
            mid = self.member_ids.get(target)
            if mid is None:
                return op.copy(value=[target, "unknown-member"])
            self.members.remove(mid)
            return op.copy(value=[target, "removed"])
        if op.f == "add-member":
            self.members.add(target)
            if self.db is not None:
                c = self.control
                with c.with_session(test, target):
                    with c.su():
                        c.exec_("rm", "-rf", f"{LAZYFS_DIR}/{target}")
                    self.db.start(test, target)
            return op.copy(value=[target, "added"])
        raise ValueError(f"unknown membership f {op.f!r}")

    def resolve_op(self, test, pair):
        _inv, done = pair
        d = dict(done)
        f, val = d.get("f"), d.get("value")
        if not isinstance(val, tuple) or len(val) != 2:
            return True
        target = val[0]
        if self.view is None:
            return False
        if f == "remove-member":
            return target not in self.view
        if f == "add-member":
            return target in self.view
        return True


class FixtureMembership(MemberMachine, membership.MembershipState):
    control = control


class TcpdumpFixtureDB(FixtureDB):
    """Phase 21's fixture DB with what a deployment adds around it: its
    binary deployed from the control node's fs_cache (saved once, under
    the cache's lock, by the first node to miss), its clock under
    faketime, and a tcpdump capture on every node from setup to
    teardown, whose files snarf_logs fetches as tcpdump.pcap and
    tcpdump.log."""

    def __init__(self):
        self.tcpdump = tcpdump.tcpdump(ports=[FIXTURE_PORT])

    def setup(self, test, node):
        with fs_cache.locking(FIXTURE_ARTIFACT):
            if not fs_cache.cached_p(FIXTURE_ARTIFACT):
                fs_cache.save_string("#!/bin/sh\nexec fixture-db \"$@\"\n",
                                     FIXTURE_ARTIFACT)
        with control.su():
            fs_cache.deploy_remote(FIXTURE_ARTIFACT, FIXTURE_BIN)
            faketime.wrap(FIXTURE_BIN, 0, faketime.rand_factor(
                2.0, random.Random(str(node))))
        self.tcpdump.setup(test, node)
        super().setup(test, node)

    def teardown(self, test, node):
        super().teardown(test, node)
        self.tcpdump.teardown(test, node)
        with control.su():
            faketime.unwrap(FIXTURE_BIN)

    def log_files(self, test, node):
        return {FIXTURE_LOG: "fixture-db.log",
                **self.tcpdump.log_files(test, node)}


class A3cDB(lazyfs.LazyFSDB):
    """LazyFSDB over the fixture DB, whose data directory lazyfs mounts;
    the inner DB's named log files keep their names (LazyFSDB's own list
    would take their paths' basenames)."""

    def __init__(self):
        super().__init__(LAZYFS_DIR, TcpdumpFixtureDB())

    def log_files(self, test, node):
        return {self.lazyfs["log-file"]: "lazyfs.log",
                **self.inner.log_files(test, node)}


def a3c_responder(faults: int = 0, seed: int = 25):
    """Phase 21's answers plus tcpdump's daemon (its pid file while it
    runs; `ps -p` fails once it was sent SIGINT, which ends its
    teardown's wait) and the capture files, which the connection user
    cannot read (`head -c 1` fails: the scp layer's sudo download copies
    them first). Every command is recorded by node in `respond.log`.
    With faults, the transport raises TransportError once on each of
    `faults` commands drawn from a seeded range of the run's first
    commands, so the retry layer reconnects inside the run."""
    base = lifecycle_responder()
    alive: dict = {}
    log: dict = {}
    lock = threading.Lock()
    rng = random.Random(seed)
    fail_at = set(rng.sample(range(20, 200), faults)) if faults else set()
    count = [0]
    raised: list = []

    def respond(node, action):
        cmd = action.cmd
        with lock:
            log.setdefault(node, []).append(action)
            count[0] += 1
            k = count[0]
        if k in fail_at:
            with lock:
                fail_at.discard(k)
                raised.append((node, cmd))
            raise ccore.TransportError("connection reset by peer",
                                       cmd=cmd, node=node)
        if "start-stop-daemon" in cmd and "/usr/bin/tcpdump" in cmd:
            alive[node] = True
        elif cmd == f"cat {tcpdump.PID_FILE}":
            if not alive.get(node):
                return ccore.Result(exit=1, out="", err="No such file",
                                    cmd=cmd)
            return TCPDUMP_PID
        elif cmd == f"kill -s INT {TCPDUMP_PID}":
            alive[node] = False
        elif cmd == f"ps -p {TCPDUMP_PID}":
            return ccore.Result(exit=0 if alive.get(node) else 1,
                                out="", err="", cmd=cmd)
        elif cmd.startswith(f"head -c 1 {tcpdump.DIR}/"):
            return ccore.Result(exit=1, out="", err="Permission denied",
                                cmd=cmd)
        return base(node, action)

    respond.log = log
    respond.raised = raised
    return respond


def _fetched(path, remote) -> None:
    """What a transfer from a node leaves at `path` on this machine (in
    it, under the source's name, when `path` is a directory)."""
    p = Path(path)
    if p.is_dir():
        p = p / Path(str(remote[0] if isinstance(remote, (list, tuple))
                         else remote)).name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(f"fetched {remote}\n")


def _sudo_fetch(out: dict, base: Path) -> None:
    """Fetches the capture files again from every node as root over the
    run's non-root login, through its transport stack: the scp layer's
    sudo download. snarf_logs fetched them without an ambient su, since
    on_nodes runs each node's body in its worker thread's own context, in
    both packages (ROADMAP C10)."""
    t = {k: out[k] for k in ("nodes", "remote", "ssh")}
    for node in out["nodes"]:
        dest = base / str(node)
        dest.mkdir(parents=True)
        with control.with_session(t, node):
            with control.su():
                control.download([tcpdump.CAP_FILE, tcpdump.LOG_FILE],
                                 str(dest))


class FetchingDummy(DummyRemote):
    """The dummy transport whose downloads leave a file at their
    destination, as scp would; it counts its connects (the retry layer
    reconnects after a transport fault)."""

    def __init__(self, responder):
        super().__init__(responder)
        self.connects = 0

    def connect(self, conn_spec):
        self.connects += 1
        sess = super().connect(conn_spec)

        def download(remote_paths, local_path):
            sess.log.append(("download", remote_paths, local_path))
            _fetched(local_path, remote_paths)

        sess.download = download
        return sess


def _unwrapped(cmd: str) -> ccore.Action:
    """The Action a DockerSession or K8sSession wrapped into `cmd`
    (control/core.py wrap_sudo: `cd DIR && sudo -S -u USER bash -c
    CMD`)."""
    d = sudo = None
    if cmd.startswith("cd "):
        head, cmd = cmd.split(" && ", 1)
        d = shlex.split(head)[1]
    if cmd.startswith("sudo -S -u "):
        parts = shlex.split(cmd)
        sudo, cmd = parts[3], parts[6]
    return ccore.Action(cmd=cmd, sudo=sudo, dir=d)


class NodeCli:
    """A scripted `docker` or `kubectl` CLI, the runner of a DockerRemote
    or K8sRemote: `docker ps` lists one container per node, publishing
    the node name's port; each `exec` goes to the responder as that
    node's Action; each `cp` from a node leaves the file at its
    destination. Every argv is recorded."""

    def __init__(self, tool: str, nodes, respond):
        self.tool = tool
        self.respond = respond
        self.calls: list = []
        if tool == "docker":
            self.node_of = {f"c0ffee{i:06d}": n
                            for i, n in enumerate(nodes, 1)}
        else:
            self.node_of = {str(n): n for n in nodes}

    def _ps(self) -> str:
        rows = ["CONTAINER ID   IMAGE   COMMAND   CREATED   STATUS   "
                "PORTS   NAMES"]
        for cid, node in self.node_of.items():
            port = str(node).rsplit(":", 1)[-1]
            rows.append(f"{cid}   fixture-db   \"/fixture-db\"   1h ago   "
                        f"Up 1h   0.0.0.0:{port}->{FIXTURE_PORT}/tcp   "
                        f"jepsen-{port}")
        return "\n".join(rows) + "\n"

    def __call__(self, argv, stdin=None, timeout=600.0) -> ccore.Result:
        argv = list(argv)
        self.calls.append(argv)
        joined = " ".join(argv)
        if argv[:2] == ["docker", "ps"]:
            return ccore.Result(0, self._ps(), "", joined)
        if argv[1] == "exec":
            target = argv[-4] if self.tool == "docker" else argv[-5]
            action = _unwrapped(argv[-1])
            action.stdin, action.timeout = stdin, timeout
            r = self.respond(self.node_of[target], action)
            if isinstance(r, ccore.Result):
                return r
            return ccore.Result(0, r or "", "", joined)
        if argv[1] == "cp":
            src, dst = argv[-2], argv[-1]
            if src.split(":", 1)[0] in self.node_of:
                _fetched(dst, src)
            return ccore.Result(0, "", "", joined)
        return ccore.Result(127, "", f"unknown {joined}", joined)


def a3c_runs(sizes: dict) -> list[dict]:
    """The three runs of phase 25: the register over the default stack's
    layers (the dummy transport in place of SshRemote, a non-root
    connection user, the whole run under su, transport faults), its
    stale-read twin over DockerRemote, list-append over K8sRemote."""
    reg = {"keys": range(sizes["register_keys"]), "group-size": 5,
           "ops_per_key": 100, "seed": 8}
    bad_key = sizes["register_keys"] // 2
    return [
        {"name": "register-ssh-stack", "workload": wl_register.workload,
         "opts": reg, "transport": "default-stack",
         "client": lambda: testing.KVClient(testing.KVState()),
         "concurrency": sizes["register_concurrency"],
         "kernel": "wgl_search", "twin": False},
        {"name": "register-twin-docker", "workload": wl_register.workload,
         "opts": reg, "bad_key": bad_key, "transport": "docker",
         "client": lambda: StaleReadKVClient(testing.KVState(), bad_key,
                                             every=sizes["stale_every"]),
         "concurrency": sizes["register_concurrency"],
         "kernel": "wgl_search", "twin": True},
        {"name": "list-append-k8s", "workload": wl_append.workload,
         "opts": {"ops": sizes["txn_ops"], "seed": 9}, "transport": "k8s",
         "client": testing.TxnClient, "concurrency": 10,
         "kernel": "scc", "twin": False},
    ]


def a3c_test(spec: dict, workload: dict, store_base, sizes: dict):
    """A named test of phase 25 and its transport's recorder: the
    LazyFSDB over the fixture DB on five nodes, file-corruption (lazyfs's
    lose-unfsynced-writes), kill, clock and membership faults at a 1 s
    interval (nemesis_ops of them beside the client ops, then the
    package's final generator)."""
    kind = spec["transport"]
    nodes = ([f"localhost:{30400 + i}" for i in range(1, 6)]
             if kind == "docker" else ["n1", "n2", "n3", "n4", "n5"])
    respond = a3c_responder(sizes["transport_faults"]
                            if kind == "default-stack" else 0)
    db = A3cDB()
    members = MemberList(nodes)
    pkg = combined.nemesis_package({
        "db": db, "faults": A3C_FAULTS, "interval": 1,
        # every node spec but None: a [None, None] value is read as the
        # key None by the independent checker, whose certificate then
        # fails (ROADMAP C11; tests/test_torch_fs_faults.py pins it)
        "file_corruption": {"lazyfs": db.lazyfs, "targets": [
            "one", "minority-third", "minority", "majority", "all"],
            "corruptions": [{"type": "lose-unfsynced-writes"}]},
        "membership": {"state": FixtureMembership(members, db=db, seed=25),
                       "view-interval": sizes["view_interval"]}})
    if kind == "default-stack":
        transport = FetchingDummy(respond)
        remote = RetryingRemote(ScpRemote(transport))
    elif kind == "docker":
        transport = NodeCli("docker", nodes, respond)
        remote = DockerRemote(transport)
    else:
        transport = NodeCli("kubectl", nodes, respond)
        remote = K8sRemote(namespace="jepsen", runner=transport)
    test = testing.noop_test()
    test.update({
        "name": f"a3c-{spec['name']}", "store_base": str(store_base),
        "nodes": nodes, "remote": remote, "db": db,
        "ssh": {"username": SSH_USER},
        "client": spec["client"](), "concurrency": spec["concurrency"],
        "nemesis": pkg["nemesis"], "checker": workload["checker"],
        "generator": gen.phases(
            gen.clients(workload["generator"],
                        gen.limit(sizes["nemesis_ops"], pkg["generator"])),
            gen.nemesis(pkg["final_generator"])),
        "plot": {"nemeses": pkg["perf"]}})
    for k, v in workload.items():
        if k not in ("generator", "checker"):
            test[k] = v
    return test, {"respond": respond, "transport": transport,
                  "members": members}


A3C_KINDS = ("file-lost-writes", "membership", "db-kill")


def _a3c_facts(spec: dict, out: dict, rig: dict, cache: Path,
               sizes: dict) -> dict:
    """What each run of phase 25 must show besides its verdict: the fault
    kinds in coverage, the tcpdump files fetched from every node, no
    membership view thread alive, nothing in the fs_cache but the
    artifact, and the transport's own evidence."""
    name = spec["name"]
    d = Path(out["store_dir"])
    rec = coverage.load_record(d)
    coverage.validate_record(rec)
    live = _fault_counts(rec["faults"], A3C_KINDS)
    if set(live) != set(A3C_KINDS):
        raise AssertionError(f"{name}: coverage {live} lacks "
                             f"{set(A3C_KINDS) - set(live)}")
    for node in out["nodes"]:
        for f in ("tcpdump.pcap", "tcpdump.log", "lazyfs.log"):
            if not (d / str(node) / f).is_file():
                raise AssertionError(f"{name}: {node}/{f} not fetched")
    views = [t.name for t in threading.enumerate()
             if t.name.startswith("membership-view-")]
    if views:
        raise AssertionError(f"{name}: view threads alive: {views}")
    files = sorted(str(p.relative_to(cache)) for p in cache.rglob("*")
                   if p.is_file())
    want = [str(fs_cache.file(FIXTURE_ARTIFACT).relative_to(cache))]
    if files != want:
        raise AssertionError(f"{name}: fs_cache holds {files}, want {want}")
    respond, transport = rig["respond"], rig["transport"]
    cmds = {n: [a.cmd for a in acts] for n, acts in respond.log.items()}
    # every node's teardown waited for tcpdump and unmounted lazyfs; the
    # faults dropped unfsynced writes on some node
    for node in out["nodes"]:
        c = cmds.get(node, [])
        for want_cmd in (f"ps -p {TCPDUMP_PID}", "fusermount -u"):
            if not any(want_cmd in x for x in c):
                raise AssertionError(f"{name}: no {want_cmd!r} on {node}")
    if not any("lazyfs::clear-cache" in x for c in cmds.values()
               for x in c):
        raise AssertionError(f"{name}: no lazyfs::clear-cache")
    facts = {"faults": live, "membership_ops": sum(
        1 for o in out["history"] if o.process == "nemesis"
        and o.type == "info" and o.f in ("add-member", "remove-member")
        and isinstance(o.value, (list, tuple))),
        "members_after": len(rig["members"].members)}
    if spec["transport"] == "default-stack":
        # the run's sessions, and a fresh one for each transport fault
        connects = transport.connects
        if connects <= len(out["nodes"]):
            raise AssertionError(f"{name}: {connects} connects: no "
                                 f"reconnect after a transport fault")
        # the capture files come through the scp layer's sudo download:
        # copied to its tmp directory, chowned to the connection user
        # and fetched
        _sudo_fetch(out, cache.parent / f"sudo-fetch-{name}")
        # read again: the fetch's commands joined the log
        cmds = {n: [a.cmd for a in acts]
                for n, acts in respond.log.items()}
        for node in out["nodes"]:
            for f in ("tcpdump", "log"):
                if not (cache.parent / f"sudo-fetch-{name}" / str(node)
                        / f).is_file():
                    raise AssertionError(f"{name}: {node}'s {f} not "
                                         f"fetched as root")
            c = cmds.get(node, [])
            for src in (tcpdump.CAP_FILE, tcpdump.LOG_FILE):
                if not any(x.startswith(f"cp {src} {scp.TMP_DIR}/")
                           for x in c):
                    raise AssertionError(f"{name}: {src} not copied for "
                                         f"the sudo download on {node}")
            if not any(x.startswith(f"chown {SSH_USER} {scp.TMP_DIR}/")
                       for x in c):
                raise AssertionError(f"{name}: no chown on {node}")
        if len(respond.raised) != sizes["transport_faults"]:
            raise AssertionError(f"{name}: {len(respond.raised)} transport "
                                 f"faults raised")
        facts.update(transport_faults=len(respond.raised),
                     connects=connects)
    else:
        tool = transport.tool
        execs = sum(1 for a in transport.calls if a[1] == "exec")
        cps = sum(1 for a in transport.calls if a[1] == "cp")
        if spec["transport"] == "docker" and not any(
                a[:2] == ["docker", "ps"] for a in transport.calls):
            raise AssertionError(f"{name}: no docker ps")
        facts.update({f"{tool}_exec": execs, f"{tool}_cp": cps})
    return facts


def transports_path(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 25: whole Jepsen tests through core.run over the default
    stack's layers, DockerRemote and K8sRemote, under lazyfs, kill, clock
    and membership faults; each stored run analysed again on the CPU.
    Returns the launches per run, by kernel. The earlier phases' heap is
    frozen out of the collector, as in phase 20."""
    gc.collect()
    gc.freeze()
    try:
        return _transports_path(dev, on_card, sizes)
    finally:
        gc.unfreeze()


def _transports_path(dev, on_card: bool, sizes: dict | None) -> dict:
    sizes = dict(A3C_SIZES, **(sizes or {}))
    card_dev = None if on_card else dev
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    threads0 = set(threading.enumerate())
    handlers0 = list(logging.getLogger().handlers)
    cache_env = os.environ.get("JEPSEN_TPU_CACHE_DIR")
    per_kernel: dict = {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for spec in a3c_runs(sizes):
                name = spec["name"]
                cache = Path(tmp) / f"cache-{name}"
                os.environ["JEPSEN_TPU_CACHE_DIR"] = str(cache)
                w = spec["workload"](dict(spec["opts"], device=card_dev))
                test, rig = a3c_test(spec, w, Path(tmp) / "store", sizes)
                recorded, restore = _wrapped_kernels()
                try:
                    t0 = time.perf_counter()
                    if spec["transport"] == "default-stack":
                        # a non-root login whose whole run is under sudo
                        with control.su():
                            out = core.run(test)
                    else:
                        out = core.run(test)
                    sync()
                    run_s = time.perf_counter() - t0
                finally:
                    restore()
                launches = _launch_counts()
                calls = {label: len(v) for label, v in recorded.items()}
                res = out["results"]
                bad = _results_unsound(res)
                if bad:
                    raise AssertionError(f"{name}: unknown or error at "
                                         f"{bad[:10]}")
                if res["valid?"] is spec["twin"]:
                    raise AssertionError(f"{name}: valid? {res['valid?']}")
                kernel = spec["kernel"]
                if on_card:
                    if {k: launches[k] for k in calls} != calls:
                        raise AssertionError(f"{name}: launch counters "
                                             f"{launches} != wrapper calls "
                                             f"{calls}")
                    if launches[kernel] < 1 or (
                            kernel != "scc" and launches[kernel] != 1):
                        raise AssertionError(f"{name}: {launches[kernel]} "
                                             f"{kernel} launches")
                facts = _a3c_facts(spec, out, rig, cache, sizes)
                if spec["twin"]:
                    facts.update(_twin_facts(
                        {"name": "register-twin",
                         "bad_key": spec["bad_key"]}, out, res))
                # the stored run analysed again on the CPU
                loaded = store.load(out["store_dir"])
                wcpu = spec["workload"](dict(spec["opts"], device="cpu"))
                crecorded, crestore = _wrapped_kernels()
                try:
                    t0 = time.perf_counter()
                    cres = core.analyze(dict(loaded, checker=wcpu[
                        "checker"]))["results"]
                    cpu_s = time.perf_counter() - t0
                finally:
                    crestore()
                ccalls = {label: len(v) for label, v in crecorded.items()}
                if _results_unsound(cres):
                    raise AssertionError(f"{name} (cpu): unknown or error")
                if _compared(jsonable(_checked(res))) != \
                        _compared(jsonable(_checked(cres))):
                    raise AssertionError(f"{name}: card and cpu verdicts "
                                         f"differ")
                if _certificates(res) != _certificates(cres):
                    raise AssertionError(f"{name}: certificates differ")
                if calls != ccalls:
                    raise AssertionError(f"{name}: wrapper calls card "
                                         f"{calls} != cpu {ccalls}")
                tel = res["telemetry"]
                hist = out["history"]
                invokes = sum(1 for o in hist if o.type == "invoke"
                              and isinstance(o.process, int))
                case_s = tel["phases"].get("case", 0.0) / 1e3
                kernel_ms = _replayed_kernel_ms(recorded, on_card)
                emit({"phase": "transports", "run": name,
                      "transport": spec["transport"],
                      "valid": res["valid?"], "invokes": invokes,
                      "events": len(hist), "run_s": run_s,
                      "spans_ms": {k: v for k, v in tel["phases"].items()
                                   if k in ("os-setup", "db-cycle", "case",
                                            "snarf-logs", "analyze", "run")
                                   or k.startswith("teardown-")},
                      "interpreter_ops_per_s": (invokes / case_s
                                                if case_s else None),
                      "check_s": tel["phases"].get("analyze", 0.0) / 1e3,
                      "cpu_analyze_s": cpu_s, "launches": launches,
                      "wrapper_calls": calls, **facts,
                      "kernel_ms": kernel_ms,
                      "card_idle_share": (1 - kernel_ms / (1e3 * run_s)
                                          if kernel_ms is not None
                                          else None),
                      "card": nvidia_smi_line() if on_card else "cpu"})
                per_kernel[kernel][f"transports-{name}"] = calls[kernel]
                del out, loaded
        finally:
            if cache_env is None:
                os.environ.pop("JEPSEN_TPU_CACHE_DIR", None)
            else:
                os.environ["JEPSEN_TPU_CACHE_DIR"] = cache_env
    leaked = [t.name for t in threading.enumerate() if t not in threads0]
    if leaked:
        raise AssertionError(f"threads started in the phase outlive it: "
                             f"{leaked}")
    if logging.getLogger().handlers != handlers0:
        raise AssertionError(f"log handlers left behind: "
                             f"{logging.getLogger().handlers}")
    emit({"phase": "transports-total",
          "seconds": time.perf_counter() - t_phase,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return per_kernel


# ---------------------------------------------------------------------------
# 26. the command line on the card
# ---------------------------------------------------------------------------

# The runs of phase 26 (a): register and bank at the CLI's defaults (500
# ops at 100 ops/s, what a user's first run is; the bank's 8 accounts
# take the host fold, whatever the count) and list-append past Elle's
# device dispatch; the stored 32-account bank run that `analyze` checks
# in (b) reaches bank_reduce (about 12,000 reads).
CLI_SIZES = {"time_limit": 10, "append_ops": 10_000,
             "stored_bank_ops": 24_000, "stored_bank_accounts": 32}
# ops/s asked of the append run, and its time limit: the op budget ends
# the run, not the clock
CLI_RATE = 100_000
CLI_TIME_LIMIT = 300
CLI_BUDGET_S = 45.0


def _cli_argv(*argv) -> list:
    return [sys.executable, "-m", "jepsen_tpu_torch", *argv]


def _cli_env() -> dict:
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def cli_runs(sizes: dict, on_card: bool) -> list[dict]:
    """The three `test` command lines of phase 26 (a)."""
    dev = [] if on_card else ["--device", "cpu"]
    fast = ["--rate", str(CLI_RATE), "--time-limit", str(CLI_TIME_LIMIT)]
    defaults = ["--time-limit", str(sizes["time_limit"]), *dev]
    return [
        {"name": "register", "kernel": "wgl_search",
         "argv": ["test", "--no-ssh", "--workload", "register",
                  *defaults]},
        {"name": "append", "kernel": "scc",
         "argv": ["test", "--no-ssh", "--workload", "append", "--ops",
                  str(sizes["append_ops"]), *fast, *dev]},
        {"name": "bank", "kernel": None,
         "argv": ["test", "--no-ssh", "--workload", "bank", *defaults]}]


def _cli_call(argv: list) -> tuple[int, str]:
    """(exit code, standard output) of `python -m jepsen_tpu_torch argv`
    run in this process; the root logger is left as it was (run_cli
    sets it up for a process of its own)."""
    import contextlib
    import io

    from jepsen_tpu_torch.__main__ import main as cli_main

    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    out = io.StringIO()
    code = None
    try:
        with contextlib.redirect_stdout(out):
            try:
                cli_main(list(argv))
            except SystemExit as e:
                code = e.code
    finally:
        for h in list(root.handlers):
            if h not in handlers:
                root.removeHandler(h)
        root.setLevel(level)
    return code, out.getvalue()


def _counted_launches(c: dict) -> dict:
    """The launch counters of a run's telemetry, by kernel. Of these only
    `bank.kernel.launches` counts on the card alone; `wgl.kernel.launches`
    (batched searches) and `scc.path.device` (device-path solves; a
    capped solve adds `scc.device-nonconverged` and a convergence
    launch) count the plain versions on the CPU too."""
    return {"wgl_search": c.get("wgl.kernel.launches", 0),
            "scc": c.get("scc.path.device", 0)
            + c.get("scc.device-nonconverged", 0),
            "bank_reduce": c.get("bank.kernel.launches", 0)}


def _stored_launches(d: Path) -> dict:
    """A stored run's kernel launches: wgl_search and bank_reduce from
    its metrics.json counters, scc from its telemetry.jsonl `kernel:scc`
    spans (the profiler's record of each launch, the convergence launch
    included); the counters beside them as a cross-check."""
    events, metrics = store.load_telemetry(d)
    counted = _counted_launches((metrics or {}).get("counters", {}))
    names = [str(e.get("name", "")) for e in events]
    return {"wgl_search": counted["wgl_search"],
            "scc": names.count("kernel:scc"),
            "bank_reduce": counted["bank_reduce"],
            "wgl_spans": sum(n.startswith("kernel:wgl") for n in names),
            "scc_counted": counted["scc"]}


def _results_launches(res: dict) -> dict:
    return _counted_launches(
        (res.get("telemetry") or {}).get("counters", {}))


# what a CLI check measures rather than decides: the telemetry summary
# (durations, counters) and the offline analysis block
CLI_MEASURED = ("telemetry", "analysis")


def _read_results(d: Path) -> dict:
    return json.loads((d / "results.json").read_text())


def _workload_verdict(res: dict):
    """The workload's verdict in a CLI run's results: the bank bundle
    composes its balance plot beside the conservation checker, so its
    verdict is the `bank` sub-result (the plot is "unknown" without
    matplotlib); the other workloads' result is the verdict."""
    wl = res["workload"]
    return wl["bank"]["valid?"] if "bank" in wl else wl["valid?"]


def _want_launches(name: str, plain: bool = False) -> dict:
    """Phase 26 (a)'s launches: wgl_search for the register run (at
    least 1), scc 1 for list-append, none for the CLI's 8-account bank,
    bank_reduce 1 for the stored 32-account one. plain: the counters of
    a check on the CPU, where bank_reduce counts nothing and the path
    counters of wgl_search and scc count the plain versions."""
    want = {"register": {"scc": 0, "bank_reduce": 0},
            "append": {"wgl_search": 0, "scc": 1, "bank_reduce": 0},
            "bank": {"wgl_search": 0, "scc": 0, "bank_reduce": 0},
            "bank32": {"wgl_search": 0, "scc": 0,
                       "bank_reduce": 1}}[name]
    return dict(want, bank_reduce=0) if plain else want


def _check_cli_launches(what: str, got: dict, name: str,
                        plain: bool = False) -> None:
    want = _want_launches(name, plain)
    bad = {k: got[k] for k, v in want.items() if got[k] != v}
    if name == "register" and got["wgl_search"] < 1:
        bad["wgl_search"] = got["wgl_search"]
    if bad:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def stored_bank_run(work: Path, sizes: dict) -> Path:
    """A run directory as a 32-account bank test leaves it (history.jlog,
    test.json, spec.json naming the bank workload), the history from
    synth.bank_history: the run `analyze` checks on bank_reduce (the
    CLI's own bank has 8 accounts, whose narrow reads take the host
    fold)."""
    from jepsen_tpu_torch.store import format as sformat

    n = sizes["stored_bank_accounts"]
    h = synth.bank_history(sizes["stored_bank_ops"], n_accounts=n,
                           seed=26)
    d = work / "store" / "bank32-demo" / "20260101T000000.000"
    d.mkdir(parents=True)
    sformat.write_history(d / "history.jlog", list(h))
    accounts = list(range(n))
    nodes = ["n1", "n2", "n3", "n4", "n5"]
    (d / "test.json").write_text(json.dumps(
        {"name": "bank32-demo", "start_time": "2026-01-01 00:00:00",
         "nodes": nodes, "concurrency": 5, "accounts": accounts,
         "total-amount": 10 * n}, indent=1))
    (d / "spec.json").write_text(json.dumps(
        {"workload": "bank", "opts": {"workload": "bank", "nodes": nodes,
                                      "concurrency": 5,
                                      "ssh": {"dummy": True},
                                      "ops": sizes["stored_bank_ops"]}},
        indent=1))
    return d


def cli_twin(src: Path, dst: Path) -> tuple:
    """A copy of the register run src whose history has one ok read
    changed to a value no write wrote, written with the port's
    store/format writer; returns (the key, the op index)."""
    from jepsen_tpu_torch.store import format as sformat

    dst.mkdir(parents=True)
    for f in ("test.json", "spec.json", "nodes.jsonl"):
        if (src / f).exists():
            shutil.copy2(src / f, dst / f)
    ops = list(sformat.read_history(src / "history.jlog"))
    for i, o in enumerate(ops):
        if (o.type == "ok" and o.f == "read" and isinstance(
                o.value, (list, tuple)) and o.value[1] is not None):
            key = o.value[0]
            ops[i] = o.copy(value=[key, 1_000_003])
            break
    else:
        raise AssertionError(f"{src}: no ok read with a value")
    sformat.write_history(dst / "history.jlog", ops)
    return key, ops[i].index


def _key_histories(d: Path, out: Path) -> dict:
    """Each key's subhistory of the register run d as history.jlog under
    out/k<key>/ (what `fleet submit` streams); {key: directory}."""
    from jepsen_tpu_torch.store import format as sformat

    hist = sformat.read_history(d / "history.jlog")
    subs = independent.subhistories(hist)
    dirs = {}
    for k, sub in sorted(subs.items(), key=lambda kv: str(kv[0])):
        kd = out / f"k{k}"
        sformat.write_history(kd / "history.jlog", list(sub))
        dirs[k] = kd
    return dirs


def _wait_addr(path: Path, proc, timeout_s: float = 180.0) -> str:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if path.exists():
            line = path.read_text().splitlines()
            if line and line[0].strip():
                return line[0].strip()
        if proc.poll() is not None:
            raise AssertionError(f"fleet serve exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-3000:]}")
        time.sleep(0.1)
    raise AssertionError("fleet serve wrote no fleet.addr")


def _http_get(url: str) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def cli_path(dev, on_card: bool, sizes: dict | None = None) -> dict:
    """Phase 26: the command line, through `python -m jepsen_tpu_torch`
    (the module docstring's item 26). Returns the launches per run, by
    kernel. The earlier phases' heap is frozen out of the collector, as
    in phase 20."""
    gc.collect()
    gc.freeze()
    try:
        return _cli_path(dev, on_card, sizes)
    finally:
        gc.unfreeze()


class _CliPhase:
    """Phase 26's state and steps, in a temporary working directory (the
    store is ./store there). Each step method is one of the docstring's
    (a)-(g); `_cli_path` calls them as the test processes end."""

    def __init__(self, work: Path, on_card: bool, sizes: dict,
                 has_mpl: bool):
        self.work = work
        self.on_card = on_card
        self.sizes = sizes
        self.has_mpl = has_mpl
        self.dev_args = [] if on_card else ["--device", "cpu"]
        self.runs: dict = {}
        self.analyzed: dict = {}
        self.verdicts: dict = {}
        self.readers: dict = {}
        self.per_kernel: dict = {"wgl_search": {}, "scc": {},
                                 "bank_reduce": {}}
        self.t0 = time.perf_counter()
        self.steps: dict = {}

    def timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.steps[name] = time.perf_counter() - t0

    def rel(self, name: str) -> str:
        return str(Path("store") / self.runs[name]["rel"])

    def count(self, kernel: str, label: str, n: int) -> None:
        kernel = "scc" if kernel == "scc_converge" else kernel
        if n:
            self.per_kernel[kernel][label] = (
                self.per_kernel[kernel].get(label, 0) + n)

    # (a) ------------------------------------------------------------------
    def test_run(self, spec: dict, proc) -> None:
        """One `test` process's stored run: exit code, verdicts, perf
        sub-result and the launches its metrics.json and telemetry.jsonl
        record."""
        from jepsen_tpu_torch.store import format as sformat

        name = spec["name"]
        _out, err = proc.communicate(timeout=900)
        d = (self.work / "store" / f"{spec['argv'][3]}-demo"
             / "latest").resolve()
        if not (d / "results.json").exists():
            raise AssertionError(f"cli {name}: exit {proc.returncode}, "
                                 f"no results: {err[-3000:]}")
        res = _read_results(d)
        wl = _workload_verdict(res)
        perf = res["perf"]
        pngs = sorted(p.name for p in d.glob("*.png"))
        want_code = 0 if self.has_mpl else 2
        ok = _perf_as_expected(perf, self.has_mpl) and (
            {"latency-raw.png", "latency-quantiles.png", "rate.png",
             "monitor.png"} <= set(pngs) if self.has_mpl else not pngs)
        if proc.returncode != want_code or wl is not True or not ok or \
                res["valid?"] is False:
            raise AssertionError(
                f"cli {name}: exit {proc.returncode} (want {want_code}), "
                f"workload {wl}, perf {perf['valid?']}, pngs {pngs}: "
                f"{err[-2000:]}")
        launches = _stored_launches(d)
        _check_cli_launches(f"cli {name}", launches, name,
                            plain=not self.on_card)
        if launches["wgl_spans"] != launches["wgl_search"] or \
                launches["scc_counted"] != launches["scc"]:
            raise AssertionError(f"cli {name}: kernel spans {launches}")
        self.runs[name] = {"dir": d, "results": res,
                           "rel": str(d.relative_to(self.work / "store"))}
        emit({"phase": "cli-test", "run": name, "argv": spec["argv"],
              "exit": proc.returncode, "valid": res["valid?"],
              "workload": wl, "perf": perf["valid?"], "pngs": pngs,
              "events": len(sformat.read_history(d / "history.jlog")),
              "launches": launches,
              "run_ms": res["telemetry"]["phases"].get("run"),
              "analyze_ms": res["telemetry"]["phases"].get("analyze"),
              "ended_s": time.perf_counter() - self.t0,
              "card": nvidia_smi_line() if self.on_card else "cpu"})
        if spec["kernel"]:
            self.count(spec["kernel"], f"cli-test-{name}",
                       launches[spec["kernel"]])

    # (b) ------------------------------------------------------------------
    def analyze_both(self, name: str) -> None:
        """The stored run checked again by `analyze` in this process, on
        the card and with --device cpu: results.json equal, untimed, to
        what `test` wrote. On the card the kernels' launches are (a)'s,
        equal to the wrapper calls and to the counters in results.json;
        on the CPU no kernel launches, and the path counters that count
        the plain versions too (`wgl.kernel.launches`, `scc.path.device`)
        are the card's."""
        r = self.runs[name]
        paths = {}
        for where, argv in (("card", self.dev_args),
                            ("cpu", ["--device", "cpu"])):
            recorded, restore = _wrapped_kernels()
            try:
                code, _out = _cli_call(["analyze", self.rel(name), *argv])
            finally:
                restore()
            calls = {k: len(v) for k, v in recorded.items()}
            launched = _launch_counts()
            real = dict(launched)
            real["scc"] += real.pop("scc_converge")
            res = _read_results(r["dir"])
            counted = _results_launches(res)
            if code != (0 if self.has_mpl else 2) or \
                    res["analysis"]["offline?"] is not True:
                raise AssertionError(f"cli analyze {name} {where}: exit "
                                     f"{code}")
            what = f"cli analyze {name} {where}"
            if self.on_card and where == "card":
                _check_cli_launches(what, real, name)
                if launched != calls or counted != real:
                    raise AssertionError(
                        f"{what}: launches {launched}, wrapper calls "
                        f"{calls}, counted {counted}")
            else:
                _check_cli_launches(what, counted, name, plain=True)
                if any(real.values()):
                    raise AssertionError(f"{what}: kernel launches {real}")
            paths[where] = {k: counted[k] for k in ("wgl_search", "scc")}
            untimed = _checked(res, CLI_MEASURED)
            if name in self.analyzed:
                if untimed != self.analyzed[name]:
                    raise AssertionError(f"cli analyze {name}: card and "
                                         f"cpu differ")
            elif "results" in r and untimed != _checked(
                    r["results"], CLI_MEASURED):
                raise AssertionError(f"cli analyze {name}: not the "
                                     f"results test wrote")
            self.analyzed.setdefault(name, untimed)
            emit({"phase": "cli-analyze", "run": name, "device": where,
                  "exit": code, "valid": res["valid?"],
                  "launches": real, "counted": counted,
                  "wrapper_calls": calls,
                  "analyze_ms": res["telemetry"]["phases"].get("analyze")})
            if where == "card":
                for k, n in calls.items():
                    self.count(k, f"cli-analyze-{name}", n)
        if paths["card"] != paths["cpu"]:
            raise AssertionError(f"cli analyze {name}: path counters "
                                 f"{paths}")

    def stored_bank(self) -> None:
        d = stored_bank_run(self.work, self.sizes)
        self.runs["bank32"] = {"dir": d,
                               "rel": str(d.relative_to(self.work / "store"))}
        self.analyze_both("bank32")
        if _workload_verdict(self.analyzed["bank32"]) is not True:
            raise AssertionError(f"bank32: {self.analyzed['bank32']}")

    # (c) ------------------------------------------------------------------
    def resume(self) -> None:
        """`analyze --resume` of the list-append run, its analysis cut
        back: results.json gone, the partial log holding the workload
        checker's result alone (the workload reused, checker.resumed 1,
        results equal to (b))."""
        from jepsen_tpu_torch.store import format as sformat

        d = self.runs["append"]["dir"]
        partial = sformat.read_partial_results(d / "results.partial.jlog")
        (d / "results.json").unlink()
        (d / "results.partial.jlog").unlink()
        w = sformat.PartialResultsWriter(d / "results.partial.jlog")
        w.put("workload", partial["workload"])
        w.close()
        recorded, restore = _wrapped_kernels()
        try:
            code, _out = _cli_call(["analyze", self.rel("append"),
                                    "--resume", *self.dev_args])
        finally:
            restore()
        res = _read_results(d)
        counters = res["telemetry"]["counters"]
        if code != (0 if self.has_mpl else 2) or _checked(
                res, CLI_MEASURED) != self.analyzed["append"] or res["analysis"][
                    "resumed-checkers"] != ["workload"] or counters.get(
                        "checker.resumed") != 1:
            raise AssertionError(f"cli resume: exit {code}, "
                                 f"{res['analysis']}, "
                                 f"{counters.get('checker.resumed')}")
        emit({"phase": "cli-resume", "exit": code,
              "analysis": res["analysis"],
              "checker.resumed": counters.get("checker.resumed"),
              "checkpoint_counters": {
                  k: v for k, v in counters.items()
                  if k.startswith(("ckpt.", "wgl.checkpoint."))},
              "wrapper_calls": {k: len(v) for k, v in recorded.items()}})

    # (d) ------------------------------------------------------------------
    def twin(self) -> None:
        """The register run's twin, one read corrupted with the port's
        store/format writer: exit 1 with the same failing key on the
        card and the CPU."""
        src = self.runs["register"]["dir"]
        twin = src.parent / (src.name + "-twin")
        key, idx = cli_twin(src, twin)
        rel = str(Path("store") / twin.relative_to(self.work / "store"))
        got = {}
        for where, argv in (("card", self.dev_args),
                            ("cpu", ["--device", "cpu"])):
            recorded, restore = _wrapped_kernels()
            try:
                code, _out = _cli_call(["analyze", rel, *argv])
            finally:
                restore()
            res = _read_results(twin)
            wres = res["workload"]
            launches = _results_launches(res)
            if code != 1 or wres["valid?"] is not False or wres.get(
                    "failures") != [key] or launches["wgl_search"] != len(
                        recorded["wgl_search"]):
                raise AssertionError(f"cli twin {where}: exit {code}, "
                                     f"failures {wres.get('failures')}, "
                                     f"want [{key}], {launches}")
            got[where] = _checked(res, CLI_MEASURED)
            emit({"phase": "cli-twin", "device": where, "exit": code,
                  "key": key, "op": idx, "failures": wres["failures"],
                  "launches": launches})
            if where == "card":
                self.count("wgl_search", "cli-twin",
                           len(recorded["wgl_search"]))
        if got["card"] != got["cpu"]:
            raise AssertionError("cli twin: card and cpu differ")

    # (e) ------------------------------------------------------------------
    def run_readers(self, name: str) -> None:
        """`telemetry`, `profile`, `nodes`, `certify` and `trace` on the
        stored run: exit 0, the text (trace: the file) of the library
        call."""
        from jepsen_tpu_torch.reports import nodes as rnodes
        from jepsen_tpu_torch.reports import profile as rprofile
        from jepsen_tpu_torch.reports import telemetry as rtel

        d = self.runs[name]["dir"]
        rel = self.rel(name)
        head = f"# {d.resolve()}\n\n"
        secs = self.readers[name] = {}
        t0 = time.perf_counter()
        events, metrics = store.load_telemetry(d)
        want = {}
        if events or metrics is not None:
            want["telemetry"] = head + rtel.telemetry_text(
                events, metrics) + "\n"
            want["profile"] = head + rprofile.profile_text(
                events, metrics) + "\n"
        records = store.load_nodes(d)
        if records:
            want["nodes"] = head + rnodes.nodes_text(
                records, store.load(d).get("history")) + "\n"
        if name in ("register", "append"):
            want["certify"] = None
        secs["library"] = time.perf_counter() - t0
        for cmd, text in want.items():
            t0 = time.perf_counter()
            code, out = _cli_call([cmd, rel])
            secs[cmd] = time.perf_counter() - t0
            if code != 0 or (text is not None and out != text):
                raise AssertionError(f"cli {cmd} {name}: exit {code}")
            if cmd == "certify" and " 0 error(s)" not in out:
                raise AssertionError(f"cli certify {name}: {out}")
        t0 = time.perf_counter()
        code, out = _cli_call(["trace", rel])
        secs["trace"] = time.perf_counter() - t0
        doc = json.loads((d / "trace.json").read_text())
        t0 = time.perf_counter()
        lib = rtrace.write_trace(rel)
        secs["library"] += time.perf_counter() - t0
        if code != 0 or not out.startswith(f"wrote {lib}\n") or \
                json.loads(Path(lib).read_text()) != doc:
            raise AssertionError(f"cli trace {name}: exit {code}")
        rtrace.validate_chrome_trace(doc)

    def coverage(self) -> None:
        """`coverage` over the store: exit 0 with the atlas's text."""
        from jepsen_tpu_torch import coverage as jcoverage

        code, out = _cli_call(["coverage"])
        cells = jcoverage.aggregate(jcoverage.read_atlas(
            Path("store") / jcoverage.ATLAS_FILE))
        if code != 0 or not out.endswith(jcoverage.coverage_text(
                cells, list(workloads.REGISTRY)) + "\n"):
            raise AssertionError(f"cli coverage: exit {code}")
        emit({"phase": "cli-readers", "seconds": self.readers,
              "coverage_cells": len(cells)})

    # (f) ------------------------------------------------------------------
    def fleet(self, server, tmp: Path) -> None:
        """`fleet submit` of each register key's subhistory and of the
        list-append run to the `fleet serve` process, each verdict the
        stored run's; then `status`, `top` and `explain`."""
        self.fleet_addr = _wait_addr(self.work / "store" / "fleet"
                                     / "fleet.addr", server)
        base = ["--base", "store/fleet", "--tenant", "cli"]
        reg = self.runs["register"]["results"]["workload"]["results"]
        for k, kd in _key_histories(self.runs["register"]["dir"],
                                    tmp / "keys").items():
            code, out = _cli_call(["fleet", "submit", str(kd), *base,
                                   "--model", "cas-register",
                                   "--chunk-ops", "2048"])
            got = json.loads(out)["result"]["valid?"]
            want = reg[str(k)]["valid?"]
            if got != want or code != {True: 0, False: 1}.get(got, 2):
                raise AssertionError(f"fleet key {k}: {got} (exit {code}), "
                                     f"stored {want}")
            self.verdicts[f"register/{k}"] = got
        code, out = _cli_call(["fleet", "submit",
                               str(self.runs["append"]["dir"]), *base,
                               "--model", "list-append",
                               "--chunk-ops", "2048"])
        env = json.loads(out)
        stored = self.runs["append"]["results"]["workload"]
        if env["result"]["valid?"] != stored["valid?"] or code != 0 or \
                env["result"].get("anomaly-types") != stored.get(
                    "anomaly-types"):
            raise AssertionError(f"fleet append: {env['result']}")
        self.verdicts["append"] = env["result"]["valid?"]
        code, out = _cli_call(["fleet", "status", *base])
        self.fleet_status = json.loads(out)
        if code != 0 or self.fleet_status["tenants"]["cli"][
                "verdicts"] != len(self.verdicts):
            raise AssertionError(f"fleet status: "
                                 f"{self.fleet_status['tenants']}")
        code, top = _cli_call(["fleet", "top", *base, "--iterations", "1"])
        if code != 0 or "verdict ms" not in top:
            raise AssertionError(f"fleet top: exit {code}")
        run_name = self.runs["append"]["dir"].name.replace(" ", "-")
        code, explain = _cli_call(["fleet", "explain", run_name, *base])
        if code != 0 or "dominant slice:" not in explain:
            raise AssertionError(f"fleet explain: exit {code}")
        self.fleet_explain = explain.splitlines()[-1]

    def fleet_stop(self, server) -> None:
        """`fleet trace`, then the server stopped by SIGINT: exit 0."""
        code, _out = _cli_call(["fleet", "trace", "--base", "store/fleet"])
        doc = json.loads((self.work / "store" / "fleet"
                          / "fleet-trace.json").read_text())
        rtrace.validate_chrome_trace(doc)
        server.send_signal(signal.SIGINT)
        s_out, s_err = server.communicate(timeout=120)
        if server.returncode != 0 or code != 0:
            raise AssertionError(f"fleet serve exited {server.returncode}"
                                 f": {s_err[-2000:]}")
        emit({"phase": "cli-fleet", "verdicts": self.verdicts,
              "launches": self.fleet_status["scheduler"].get("launches"),
              "explain": self.fleet_explain,
              "trace_events": len(doc["traceEvents"]),
              "server": s_out.strip().splitlines()[:1],
              "server_exit": server.returncode})

    # (g) ------------------------------------------------------------------
    def web(self) -> None:
        """web.serve on 127.0.0.1, port 0, over the store, the fleet still
        up: every route 200, /lint the graftlint report, /fleet with the
        tenant."""
        from jepsen_tpu_torch import web

        srv = web.serve("127.0.0.1", 0, base=Path("store"))
        try:
            port = srv.server_address[1]
            rel = self.runs["register"]["rel"]
            pages = {}
            for path in ("/", f"/files/{rel}/", "/coverage/", "/fleet",
                         f"/telemetry/{rel}", f"/live/{rel}", f"/zip/{rel}",
                         f"/files/{rel}/results.json", f"/trace/{rel}",
                         f"/metrics?run={rel}", "/lint"):
                code, body = _http_get(f"http://127.0.0.1:{port}{path}")
                pages[path] = [code, len(body)]
                if path == "/lint" and b"graftlint" not in body:
                    raise AssertionError(f"web /lint: {body[:200]}")
                if code != 200:
                    raise AssertionError(f"web {path}: {code}")
                if path == "/fleet" and b"cli" not in body:
                    raise AssertionError("web /fleet: no tenant cli")
        finally:
            srv.shutdown()
            srv.server_close()
        emit({"phase": "cli-web", "pages": pages})


def _cli_path(dev, on_card: bool, sizes: dict | None) -> dict:
    sizes = dict(CLI_SIZES, **(sizes or {}))
    has_mpl = _has_matplotlib()
    emit({"phase": "cli-matplotlib", "imports": has_mpl})
    threads0 = set(threading.enumerate())
    handlers0 = list(logging.getLogger().handlers)
    cwd0 = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "work"
        work.mkdir()
        ph = _CliPhase(work, on_card, sizes, has_mpl)
        env = _cli_env()
        procs: dict = {}
        server = None
        try:
            # (a) the three test runs at once, and (f)'s fleet server
            for spec in cli_runs(sizes, on_card):
                procs[spec["name"]] = (spec, subprocess.Popen(
                    _cli_argv(*spec["argv"]), cwd=work, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            server = subprocess.Popen(
                _cli_argv("fleet", "serve", "--base", "store/fleet",
                          "-p", "0", "--device",
                          "cuda" if on_card else "cpu"),
                cwd=work, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            os.chdir(work)
            # the stored bank run needs no process: it is checked while
            # they start; each run's steps go as soon as its process ends
            ph.timed("b bank32", ph.stored_bank)
            spec, proc = procs["register"]
            ph.timed("a register", ph.test_run, spec, proc)
            ph.timed("b register", ph.analyze_both, "register")
            ph.timed("d twin", ph.twin)
            ph.timed("e register", ph.run_readers, "register")
            spec, proc = procs["append"]
            ph.timed("a append", ph.test_run, spec, proc)
            ph.timed("b append", ph.analyze_both, "append")
            ph.timed("e append", ph.run_readers, "append")
            ph.timed("c resume", ph.resume)
            ph.timed("f fleet", ph.fleet, server, Path(tmp))
            spec, proc = procs["bank"]
            ph.timed("a bank", ph.test_run, spec, proc)
            ph.timed("b bank", ph.analyze_both, "bank")
            ph.timed("e bank", ph.run_readers, "bank")
            ph.timed("e coverage", ph.coverage)
            ph.timed("g web", ph.web)
            ph.timed("f fleet stop", ph.fleet_stop, server)
        finally:
            os.chdir(cwd0)
            for spec, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            if server is not None and server.poll() is None:
                server.kill()
                server.communicate()
    leaked = [t.name for t in threading.enumerate() if t not in threads0
              and not t.daemon]
    if leaked:
        raise AssertionError(f"threads started in the phase outlive it: "
                             f"{leaked}")
    if logging.getLogger().handlers != handlers0:
        raise AssertionError(f"log handlers left behind: "
                             f"{logging.getLogger().handlers}")
    emit({"phase": "cli-total", "seconds": time.perf_counter() - ph.t0,
          "steps": ph.steps, "budget_s": CLI_BUDGET_S,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return ph.per_kernel


# ---------------------------------------------------------------------------
# 27. the database suites (A10a) against in-memory databases
# ---------------------------------------------------------------------------

# Phase 27 runs each of the 13 ported suites once through its own test
# builder (`<name>_test(opts)`: its DB, client, nemesis and checker
# stack) and the port's core.run over the dummy remote, at the suites'
# default workload, key count and ops; only the rate is raised and the
# time limit cut. Each client's transport (redis-cli, aql, _sql over
# curl, ReQL, psql, mysql, sqlcmd, mongosh, the HTTP APIs; zkCli through
# the dummy remote's responder) is replaced by one of the in-memory
# databases below; the DB's setup and teardown commands go to the dummy
# remote. etcd's runs keep the suite's own generator: its nemesis cycle
# sleeps 5 s before its first fault, so none fires and each run lasts
# 5 s. The other suites' cycles sleep 10 s, which the interpreter waits
# out past any time limit, so their runs take client_generator's
# instead (zookeeper's own staggers its ops 1 s apart, with no rate
# option). The postgres append run is the one Elle run past scc's
# dispatch (big_txns txns).
SUITE_SIZES = {"time_limit": 1, "rate": 5000, "concurrency": 6,
               "append_time_limit": 3, "append_rate": 20_000,
               "big_txns": 10_000, "big_time_limit": 8}
# the run opts the tests cut (phase 27 leaves each to its suite)
SUITE_CUTS = ("ops", "keys", "ops_per_key")
# each suite's append_workload default txns
APPEND_TXNS = {"postgres": 2000, "stolon": 2000, "etcd": 1000,
               "tidb": 2000}
# the runs on their suite's own generator
OWN_GENERATOR = ("etcd",)
ZK_OPS = 500
SUITES_BUDGET_S = 60.0
SUITE_NODES = ["n1", "n2", "n3"]
SUITE_SEED = 27
# the seeded twin of a wgl_search suite: reads of this key answer a value
# nobody wrote from the PHANTOM_FROM-th read of it on
PHANTOM_KEY = 1
PHANTOM_FROM = 12


class _Locked:
    def __init__(self):
        self.lock = threading.Lock()


class ZkFake(_Locked):
    """One znode with a dataVersion, answering zkCli.sh (the 3.4 dialect)
    through the dummy remote's responder."""

    def __init__(self):
        super().__init__()
        self.value = None
        self.version = -1

    def respond(self, node, action):
        cmd = action.cmd
        if "zkCli.sh" not in cmd:
            return None
        args = shlex.split(cmd.split("zkCli.sh", 1)[1])[2:]
        if len(args) == 1:
            args = args[0].split()

        def res(exit_, out="", err=""):
            return ccore.Result(exit=exit_, out=out, err=err, cmd=cmd)

        with self.lock:
            if args[0] == "get":
                if self.value is None:
                    return res(1, err="NoNode for /jepsen")
                return res(0, f"{self.value}\ndataVersion = "
                              f"{self.version}\n")
            if args[0] == "create":
                if self.value is not None:
                    return res(1, err="NodeExists")
                self.value, self.version = int(args[2]), 0
                return res(0, "Created")
            if args[0] == "set":
                if self.value is None:
                    return res(1, err="NoNode")
                if len(args) >= 4 and int(args[3]) != self.version:
                    return res(1, err="KeeperErrorCode = BadVersion")
                self.value = int(args[2])
                self.version += 1
                return res(0)
        return res(1, err=f"unknown zkCli command {args}")


class RedisFake(_Locked):
    """Redis keys behind redis-cli replies (raftis' register and counter,
    the sentinel's master address and its EVAL cas)."""

    def __init__(self):
        super().__init__()
        self.kv: dict = {}

    def cli(self, *args) -> str:
        cmd = args[0].upper()
        with self.lock:
            if cmd == "SENTINEL":
                return "n1\n6379"
            if cmd == "GET":
                v = self.kv.get(args[1])
                return "" if v is None else str(v)
            if cmd == "SET":
                self.kv[args[1]] = int(args[2])
                return "OK"
            if cmd in ("INCRBY", "DECRBY"):
                d = int(args[2]) * (1 if cmd == "INCRBY" else -1)
                self.kv[args[1]] = self.kv.get(args[1], 0) + d
                return str(self.kv[args[1]])
            if cmd == "EVAL":
                frm, to = int(args[-2]), int(args[-1])
                if self.kv.get(args[3]) == frm:
                    self.kv[args[3]] = to
                    return "1"
                return "0"
        raise ValueError(f"unexpected redis command {args}")


class _Cli:
    """A transport object over a fake: run(*args) -> reply text."""

    def __init__(self, fn):
        self.fn = fn
        self.master = None

    def run(self, *args):
        return self.fn(*args)

    def stmt(self, sql, args=None):
        return self.fn(sql, args)

    def run_command(self, command, admin=False):
        return self.fn(command)

    def resolve_master(self):
        self.master = ("n1", 6379)
        return self.master

    def forget_master(self):
        self.master = None

    def close(self):
        pass


def _factory(fn):
    """A client's transport factory: every node's transport is the same
    in-memory database."""
    return lambda *_a, **_kw: _Cli(fn)


class AqlFake(_Locked):
    """One aerospike record, answering aql's table output; the jepsen.lua
    UDF's cas runs under the lock as it runs server-side."""

    def __init__(self):
        super().__init__()
        self.value = None

    @staticmethod
    def _table(v) -> str:
        return f"+---+\n| v |\n+---+\n| {v} |\n+---+\n1 row in set\n"

    def run(self, statement: str) -> str:
        with self.lock:
            if statement.startswith("SELECT"):
                return ("0 rows in set (0.000 secs)\n"
                        if self.value is None else self._table(self.value))
            m = re.match(r"EXECUTE jepsen\.put\((-?\d+)\)", statement)
            if m:
                self.value = int(m.group(1))
                return self._table(1)
            m = re.match(r"EXECUTE jepsen\.cas\((-?\d+), (-?\d+)\)",
                         statement)
            if m:
                if self.value != int(m.group(1)):
                    return self._table(0)
                self.value = int(m.group(2))
                return self._table(1)
        raise ValueError(f"unexpected aql {statement!r}")


class CrateFake(_Locked):
    """One crate row behind _sql's JSON replies (rowcount proves a
    conditional UPDATE)."""

    def __init__(self):
        super().__init__()
        self.value = None

    def stmt(self, sql, args=None):
        s = sql.strip().upper()
        args = args or []
        with self.lock:
            if s.startswith(("REFRESH", "CREATE")):
                return {"rows": [], "rowcount": 0}
            if s.startswith("SELECT"):
                rows = [] if self.value is None else [[self.value]]
                return {"rows": rows, "rowcount": len(rows)}
            if s.startswith("INSERT"):
                self.value = int(args[0])
                return {"rows": [], "rowcount": 1}
            if s.startswith("UPDATE"):
                if self.value is None or self.value != int(args[1]):
                    return {"rows": [], "rowcount": 0}
                self.value = int(args[0])
                return {"rows": [], "rowcount": 1}
        raise ValueError(f"unexpected crate sql {sql!r}")


class RethinkFake(_Locked):
    """The one rethinkdb document, answering the node-side query helper's
    reply lines."""

    def __init__(self):
        super().__init__()
        self.val = None

    def run(self, *args) -> str:
        with self.lock:
            if args[0] == "read":
                return "NONE" if self.val is None else f"VAL {self.val}"
            if args[0] == "write":
                self.val = int(args[3])
                return "OK"
            if args[0] == "cas":
                if self.val != int(args[3]):
                    return "CAS 0"
                self.val = int(args[4])
                return "CAS 1"
            if args[0] == "setup":
                return "OK"
        raise ValueError(f"unexpected helper call {args}")


class ConsulFake(_Locked):
    """consul's KV HTTP API with a ModifyIndex per key and ?cas=
    semantics. phantom_key: from the PHANTOM_FROM-th GET of that key on,
    it answers 99, a value no client writes (the twin)."""

    def __init__(self, nodes=SUITE_NODES, phantom_key=None):
        super().__init__()
        self.kv: dict = {}
        self.index = 0
        self.nodes = list(nodes)
        self.phantom = (None if phantom_key is None
                        else f"/v1/kv/register/{phantom_key}")
        self.phantom_reads = 0

    def request(self, method, path, params=None, body=None):
        import base64

        with self.lock:
            if path == "/v1/catalog/nodes":
                return 200, json.dumps([{"Node": n} for n in self.nodes])
            key = path[len("/v1/kv/"):]
            if method == "GET":
                if path == self.phantom:
                    self.phantom_reads += 1
                    if self.phantom_reads >= PHANTOM_FROM:
                        return 200, json.dumps([{
                            "Key": key, "ModifyIndex": 1,
                            "Value": base64.b64encode(b"99").decode()}])
                if key not in self.kv:
                    return 404, ""
                value, idx = self.kv[key]
                return 200, json.dumps([{
                    "Key": key, "ModifyIndex": idx,
                    "Value": base64.b64encode(value.encode()).decode()}])
            if method == "PUT":
                if "cas" in (params or {}) and int(params["cas"]) != \
                        self.kv.get(key, (None, 0))[1]:
                    return 200, "false"
                self.index += 1
                self.kv[key] = (body, self.index)
                return 200, "true"
        raise ValueError(f"unexpected consul request {method} {path}")

    def factory(self, mod):
        def make(node, consistency=None, timeout=5.0):
            http = mod.ConsulHttp(node, consistency=consistency,
                                  timeout=timeout)
            http.request = self.request
            return http

        return make


class MongoFake(_Locked):
    """A mongo collection of register documents behind runCommand: find,
    upsert and the value-guarded update, plus the replica set's initiate
    and hello on the primary."""

    def __init__(self):
        super().__init__()
        self.docs: dict = {}

    def run_command(self, command):
        with self.lock:
            if "replSetInitiate" in command:
                return {"ok": 1}
            if "hello" in command:
                return {"ok": 1, "isWritablePrimary": True}
            if "find" in command:
                k = command["filter"]["_id"]
                batch = ([{"_id": k, "value": self.docs[k]}]
                         if k in self.docs else [])
                return {"ok": 1, "cursor": {"firstBatch": batch}}
            if "update" in command:
                u = command["updates"][0]
                q, upd = u["q"], u["u"]
                if "value" in q:
                    if self.docs.get(q["_id"], object()) != q["value"]:
                        return {"ok": 1, "n": 0, "nModified": 0}
                    self.docs[q["_id"]] = upd["$set"]["value"]
                    return {"ok": 1, "n": 1, "nModified": 1}
                self.docs[q["_id"]] = upd["value"]
                return {"ok": 1, "n": 1, "nModified": 1}
        raise ValueError(f"unexpected mongo command {command}")


class VoltFake(_Locked):
    """voltdb's registers table behind sqlcmd's output: the guarded
    UPDATE answers its modified-tuple count."""

    def __init__(self):
        super().__init__()
        self.registers: dict = {}

    def run(self, sql: str) -> str:
        out = []
        with self.lock:
            for s in filter(None, (x.strip() for x in sql.split(";"))):
                m = re.match(r"SELECT 'v=' \|\| CAST\(value AS VARCHAR\) "
                             r"FROM registers WHERE id = (\d+)", s)
                if m:
                    v = self.registers.get(int(m.group(1)))
                    if v is not None:
                        out.append(f"v={v}")
                    continue
                m = re.match(r"UPSERT INTO registers \(id, value\) "
                             r"VALUES \((\d+), (-?\d+)\)", s)
                if m:
                    self.registers[int(m.group(1))] = int(m.group(2))
                    out.append("1")
                    continue
                m = re.match(r"UPDATE registers SET value = (-?\d+) "
                             r"WHERE id = (\d+) AND value = (-?\d+)", s)
                if m:
                    new, k, old = map(int, m.groups())
                    ok = self.registers.get(k) == old
                    if ok:
                        self.registers[k] = new
                    out.append("1" if ok else "0")
                    continue
                raise ValueError(f"unexpected voltdb sql {s!r}")
        return "\n".join(out)


class MysqlFake(_Locked):
    """galera's accounts table behind mysql's batch output: a transfer
    applies whole or not at all."""

    def __init__(self, accounts=8, balance=10):
        super().__init__()
        self.accounts = {i: balance for i in range(accounts)}

    def run(self, sql: str) -> str:
        with self.lock:
            if "CONCAT('b='" in sql:
                return "b=" + ",".join(
                    f"{i}:{b}" for i, b in sorted(self.accounts.items()))
            if "START TRANSACTION" in sql:
                a, f = map(int, re.search(
                    r"balance - (\d+) WHERE id = (\d+)", sql).groups())
                t = int(re.search(r"balance \+ \d+ WHERE id = (\d+)",
                                  sql).group(1))
                if self.accounts[f] < a:
                    return "applied=0"
                self.accounts[f] -= a
                self.accounts[t] += a
                return "applied=1"
        raise ValueError(f"unexpected mysql batch {sql!r}")


class AppendFake(_Locked):
    """Elle's list-append rows behind a SQL CLI's tagged output: one
    batch executes whole under the lock (serializable); a read answers
    m<i>=<comma list> or ~, an append adds its element to the key's list.
    A subclass names its CLI's statements: read_re (tag, table, key),
    append_re (table, key, element), and `other` for the rest.
    reverse_every: the twin; every reverse_every-th read of a list of two
    or more elements answers it reversed."""

    read_re = append_re = None

    def __init__(self, reverse_every=0):
        super().__init__()
        self.rows: dict = {}  # (table, key) -> comma list
        self.reverse_every = reverse_every
        self.reads = 0

    def other(self, s: str, out: list) -> bool:
        """Executes a statement that is neither a read nor an append;
        False if it is none the CLI sends."""
        return s.startswith(("BEGIN", "COMMIT"))

    def run(self, sql: str) -> str:
        out = []
        with self.lock:
            for s in filter(None, (x.strip() for x in sql.split(";"))):
                m = self.read_re.search(s)
                if m:
                    val = self.rows.get((m.group(2), int(m.group(3))))
                    if val is not None and "," in val and \
                            self.reverse_every:
                        self.reads += 1
                        if self.reads % self.reverse_every == 0:
                            val = ",".join(reversed(val.split(",")))
                    out.append(f"m{m.group(1)}=" + ("~" if val is None
                                                    else val))
                    continue
                m = self.append_re.search(s)
                if m:
                    key = (m.group(1), int(m.group(2)))
                    cur = self.rows.get(key)
                    self.rows[key] = (m.group(3) if cur is None
                                      else f"{cur},{m.group(3)}")
                    continue
                if not self.other(s, out):
                    raise ValueError(f"unexpected {type(self).__name__} "
                                     f"statement {s!r}")
        return "\n".join(out) + ("\n" if out else "")


class PgFake(AppendFake):
    """postgres' txn tables behind psql's unaligned output."""

    read_re = re.compile(
        r"SELECT 'm(\d+)=' \|\| COALESCE\(\(SELECT val FROM (txn\d+) "
        r"WHERE id = (\d+)\), '~'\)")
    append_re = re.compile(
        r"INSERT INTO (txn\d+) AS t \(id, val\) VALUES \((\d+), "
        r"'(\d+)'\) ON CONFLICT")


class EtcdFake(_Locked):
    """etcd v3's KV through the suite's gateway calls, with a mod
    revision per key so guarded txns behave as etcd's."""

    def __init__(self):
        super().__init__()
        self.kv: dict = {}
        self.rev: dict = {}
        self.next_rev = 0

    def _write(self, key, value):
        self.next_rev += 1
        self.kv[key] = value
        self.rev[key] = self.next_rev

    def factory(self, _node):
        return self

    def get(self, key):
        with self.lock:
            if key not in self.kv:
                return None, None
            return self.kv[key], self.rev[key]

    def put(self, key, value):
        with self.lock:
            self._write(key, value)

    def cas(self, key, old, new):
        with self.lock:
            if self.kv.get(key) != old:
                return False
            self._write(key, new)
            return True

    def cas_create(self, key, new):
        with self.lock:
            if key in self.kv:
                return False
            self._write(key, new)
            return True

    def txn_rw(self, guards, puts):
        with self.lock:
            if any((self.rev.get(k) or 0) != (rev or 0)
                   for k, rev in guards):
                return False
            for k, v in puts:
                self._write(k, v)
            return True


class HzFake(_Locked):
    """The hazelcast client jar's lock lines over in-memory CP locks:
    acquire answers OK and the lock's fence (a new fence for each new
    holder) or BUSY, release OK or ERR; a lock is held by the op's named
    CP session, reentrantly."""

    def __init__(self):
        super().__init__()
        self.locks: dict = {}  # name -> (session, fence, count)
        self.fences: dict = {}

    def cmd(self, session: str, line: str) -> str:
        kind, f, name = line.split()
        if kind != "lock":
            raise ValueError(f"unexpected hazelcast console line {line!r}")
        with self.lock:
            owner, fence, count = self.locks.get(name, (None, 0, 0))
            if f == "acquire":
                if owner not in (None, session):
                    return "BUSY"
                if owner is None:
                    fence = self.fences[name] = self.fences.get(name, 0) + 1
                self.locks[name] = (session, fence, count + 1)
                return f"OK {fence}"
            if owner != session:
                return "ERR not-owner"
            self.locks[name] = ((owner, fence, count - 1) if count > 1
                                else (None, fence, 0))
            return "OK"

    def factory(self, *_a, **_kw):
        fake = self

        class _Console:
            def cmd(self, line, session="jepsen"):
                return fake.cmd(session, line)

        return _Console()


class CrdbFake(_Locked):
    """cockroach's kv table behind `cockroach sql --format tsv` (a header
    row, then one value a row); the guarded UPDATE .. RETURNING answers
    a row only where it applied. phantom_key: from the PHANTOM_FROM-th
    read of that key on, it answers 99, a value no client writes (the
    twin)."""

    def __init__(self, phantom_key=None):
        super().__init__()
        self.kv: dict = {}
        self.phantom = phantom_key
        self.phantom_reads = 0
        self.read_re = re.compile(r"SELECT v FROM kv WHERE k = (-?\d+);$")
        self.write_re = re.compile(r"UPSERT INTO kv VALUES \((-?\d+), "
                                   r"(-?\d+)\);$")
        self.cas_re = re.compile(r"UPDATE kv SET v = (-?\d+) WHERE k = "
                                 r"(-?\d+) AND v = (-?\d+) RETURNING v;$")

    def run(self, sql: str) -> str:
        with self.lock:
            m = self.read_re.match(sql)
            if m:
                k = int(m.group(1))
                v = self.kv.get(k)
                if k == self.phantom:
                    self.phantom_reads += 1
                    if self.phantom_reads >= PHANTOM_FROM:
                        v = 99
                return "v\n" if v is None else f"v\n{v}\n"
            m = self.write_re.match(sql)
            if m:
                self.kv[int(m.group(1))] = int(m.group(2))
                return ""
            m = self.cas_re.match(sql)
            if m:
                new, k, old = map(int, m.groups())
                if self.kv.get(k) != old:
                    return "v\n"
                self.kv[k] = new
                return f"v\n{new}\n"
        raise ValueError(f"unexpected cockroach sql {sql!r}")


class TidbFake(AppendFake):
    """tidb's txn tables behind the mysql CLI's batch output (-N -B)."""

    read_re = re.compile(
        r"SELECT CONCAT\('m(\d+)=', COALESCE\(\(SELECT val FROM "
        r"(txn\d+) WHERE id = (\d+)\), '~'\)\)$")
    append_re = re.compile(
        r"INSERT INTO (txn\d+) \(id, val\) VALUES \((\d+), '(\d+)'\) "
        r"ON DUPLICATE KEY UPDATE")


class YsqlFake(AppendFake):
    """yugabyte's YSQL tables behind ysqlsh's unaligned tuples: the
    list-append rows (append0), the client's setup DDL, and the
    multi-key ACID registers (multireg)."""

    read_re = re.compile(
        r"SELECT 'm(\d+)=' \|\| COALESCE\(\(SELECT v FROM (append\d+) "
        r"WHERE k = (\d+)\), '~'\)$")
    append_re = re.compile(
        r"INSERT INTO (append\d+) \(k, v\) VALUES \((\d+), '(\d+)'\) "
        r"ON CONFLICT \(k\) DO UPDATE")
    mwrite_re = re.compile(
        r"INSERT INTO multireg \(id, val\) VALUES \('(\w+)', (-?\d+)\) "
        r"ON CONFLICT \(id\) DO UPDATE")
    mread_re = re.compile(
        r"SELECT id, val FROM multireg WHERE id IN \(([^)]*)\)$")

    def other(self, s: str, out: list) -> bool:
        m = self.mwrite_re.match(s)
        if m:
            self.rows[("multireg", m.group(1))] = int(m.group(2))
            return True
        m = self.mread_re.match(s)
        if m:
            for i in (x.strip().strip("'") for x in m.group(1).split(",")):
                v = self.rows.get(("multireg", i))
                if v is not None:
                    out.append(f"{i}|{v}")
            return True
        return s.startswith(("BEGIN", "COMMIT", "CREATE"))

    def factory(self, *_a, **_kw):
        fake = self

        class _Runner:
            dialect = "ysql"

            def run(self, stmt):
                return fake.run(stmt)

            def close(self):
                pass

        return _Runner()


class DgraphFake(_Locked):
    """dgraph's records behind the suite's semantic HTTP calls: atomic
    upsert blocks (insert unless a record has pred = key, or set a value
    on it) and equality queries."""

    def __init__(self):
        super().__init__()
        self.recs: dict = {}  # uid -> {pred: value}

    def factory(self, *_a, **_kw):
        return self

    def alter_schema(self, schema):
        pass

    def _find(self, pred, key):
        return [u for u, r in self.recs.items()
                if str(r.get(pred)) == str(key)]

    def upsert_unless_exists(self, pred, key, extra):
        with self.lock:
            if self._find(pred, key):
                return None
            uid = f"0x{len(self.recs) + 1:x}"
            self.recs[uid] = dict(extra, **{pred: key})
            return uid

    def write_value(self, pred, key, vpred, value):
        with self.lock:
            hits = self._find(pred, key)
            uid = hits[0] if hits else f"0x{len(self.recs) + 1:x}"
            self.recs.setdefault(uid, {pred: key})[vpred] = value

    def query_eq(self, pred, key, want=("uid",)):
        with self.lock:
            return [{w: (u if w == "uid" else self.recs[u][w])
                     for w in want if w == "uid" or w in self.recs[u]}
                    for u in self._find(pred, key)]


class DisqueFake(_Locked):
    """disque's one queue behind disque-cli replies: ADDJOB answers a job
    id, GETJOB NOHANG the queue, id and body lines (nothing when empty),
    ACKJOB 1."""

    def __init__(self):
        super().__init__()
        self.jobs: list = []
        self.n = 0

    def run(self, *args) -> str:
        with self.lock:
            if args[0] == "addjob":
                self.n += 1
                self.jobs.append((f"D-{self.n:08x}", args[2]))
                return f"D-{self.n:08x}"
            if args[0] == "getjob":
                if not self.jobs:
                    return ""
                jid, body = self.jobs.pop(0)
                return f"{args[-1]}\n{jid}\n\"{body}\""
            if args[0] == "ackjob":
                return "1"
        raise ValueError(f"unexpected disque command {args}")


class EsFake(_Locked):
    """elasticsearch's indices behind EsHttp.request: create-only
    indexing, get by id, a refresh every shard answers, and a
    match_all search sorted by _id, paged with search_after."""

    def __init__(self):
        super().__init__()
        self.indices: dict = {}

    def request(self, method, path, body=None):
        with self.lock:
            parts = path.split("?")[0].strip("/").split("/")
            docs = self.indices.get(parts[0])
            if method == "PUT" and len(parts) == 1:
                if docs is not None:
                    return 400, {"error": "resource_already_exists"}
                self.indices[parts[0]] = set()
                return 200, {"acknowledged": True}
            if docs is None:
                return 404, {"error": "index_not_found"}
            if parts[1] == "_doc":
                if method == "PUT":
                    if parts[2] in docs:
                        return 409, {"error": "version_conflict"}
                    docs.add(parts[2])
                    return 201, {"result": "created"}
                found = parts[2] in docs
                return (200 if found else 404), {"found": found}
            if parts[1] == "_refresh":
                return 200, {"_shards": {"total": 2, "successful": 2}}
            if parts[1] == "_search":
                after = (body.get("search_after") or [None])[0]
                ids = sorted(i for i in docs if after is None or i > after)
                hits = [{"_id": i, "sort": [i]}
                        for i in ids[:body["size"]]]
                return 200, {"hits": {"hits": hits}}
        raise ValueError(f"unexpected elasticsearch request {method} "
                         f"{path}")

    def factory(self, mod):
        def make(node, timeout=8.0):
            http = mod.EsHttp(node, timeout=timeout)
            http.request = self.request
            return http

        return make


class RabbitFake(_Locked):
    """rabbitmq's durable queue behind rabbitmqadmin -f raw_json: publish
    routes to the declared queue, get with ack_requeue_false removes the
    message it answers."""

    def __init__(self):
        super().__init__()
        self.queues: dict = {}

    def run(self, *args) -> str:
        kw = dict(a.split("=", 1) for a in args[1:] if "=" in a)
        with self.lock:
            if args[0] == "declare":
                self.queues.setdefault(kw["name"], [])
                return ""
            if args[0] == "publish":
                q = self.queues.get(kw["routing_key"])
                if q is None:
                    return "Message published but NOT routed"
                q.append(kw["payload"])
                return "Message published"
            if args[0] == "get":
                q = self.queues.get(kw["queue"], [])
                if not q:
                    return "[]"
                return json.dumps([{"payload": q.pop(0),
                                    "payload_bytes": 1,
                                    "redelivered": False}])
        raise ValueError(f"unexpected rabbitmqadmin call {args}")


def suite_responder(zk: ZkFake | None = None):
    """The dummy remote's answers to the DB commands: node addresses
    (getent), the network device (ip link), install_archive's probes (nothing cached; the archive's
    one top-level directory), postgres' hba_file, crate's schema curl,
    and zkCli through the zookeeper fake."""

    def respond(node, action):
        cmd = action.cmd
        if zk is not None:
            r = zk.respond(node, action)
            if r is not None:
                return r
        if cmd.startswith("getent ahostsv4"):
            host = cmd.split()[-1]
            digits = "".join(ch for ch in str(host) if ch.isdigit())
            return f"10.0.0.{int(digits or 0) % 250 + 1}   STREAM {host}"
        if cmd == "ip -o link show":
            return ("1: lo: <LOOPBACK,UP> mtu 65536\n"
                    "2: eth0: <BROADCAST,MULTICAST,UP> mtu 1500")
        if cmd.startswith("stat "):
            return ccore.Result(exit=1, out="", err="no such file",
                                cmd=cmd)
        if cmd.startswith("dirname "):
            return cmd.split()[-1].rsplit("/", 1)[0]
        if cmd.startswith("ls -A"):
            return "pkg"
        if "SHOW hba_file" in cmd:
            return "/etc/postgresql/15/main/pg_hba.conf"
        if cmd.startswith("curl"):
            return '{"rows": [], "rowcount": 1}'
        return None

    return respond


def rig_suite(test: dict, spec: dict) -> object:
    """Puts a suite's test on the dummy remote and its client (and the
    DB's own client, where setup talks to the database) on a fresh
    in-memory database; returns the database."""
    suite = spec["suite"]
    zk = ZkFake() if suite == "zookeeper" else None
    test["remote"] = DummyRemote(suite_responder(zk))
    client, db = test["client"], test["db"]
    if zk is not None:
        return zk
    if suite in ("raftis", "redis_sentinel"):
        fake = RedisFake()
        client.cli_factory = _factory(fake.cli)
    elif suite == "aerospike":
        fake = AqlFake()
        client.cli_factory = _factory(fake.run)
    elif suite == "crate":
        fake = CrateFake()
        client.sql_factory = _factory(fake.stmt)
    elif suite == "rethinkdb":
        fake = RethinkFake()
        client.cli_factory = _factory(fake.run)
    elif suite == "consul":
        fake = ConsulFake(phantom_key=spec.get("phantom_key"))
        client.http_factory = db.http_factory = fake.factory(
            suites.load("consul"))
    elif suite == "mongodb":
        fake = MongoFake()
        client.shell_factory = db.shell_factory = _factory(
            fake.run_command)
    elif suite == "voltdb":
        fake = VoltFake()
        client.sql_factory = _factory(fake.run)
    elif suite == "galera":
        fake = MysqlFake()
        client.mysql_factory = _factory(fake.run)
    elif suite in ("postgres", "stolon"):
        fake = PgFake(reverse_every=spec.get("reverse_every", 0))
        client.psql_factory = _factory(fake.run)
    elif suite == "etcd":
        fake = EtcdFake()
        client.http_factory = fake.factory
    elif suite == "hazelcast":
        fake = HzFake()
        client.console_factory = fake.factory
    elif suite == "cockroach":
        fake = CrdbFake(phantom_key=spec.get("phantom_key"))
        client.sql_factory = _factory(fake.run)
    elif suite == "tidb":
        fake = TidbFake()
        client.sql_factory = _factory(fake.run)
    elif suite == "yugabyte":
        fake = YsqlFake(reverse_every=spec.get("reverse_every", 0))
        client.runner_factory = fake.factory
    elif suite == "dgraph":
        fake = DgraphFake()
        client.http_factory = fake.factory
    elif suite == "disque":
        fake = DisqueFake()
        client.cli_factory = _factory(fake.run)
    elif suite == "elasticsearch":
        fake = EsFake()
        client.http_factory = fake.factory(suites.load("elasticsearch"))
    elif suite == "rabbitmq":
        fake = RabbitFake()
        client.admin_factory = _factory(fake.run)
    else:
        raise ValueError(f"no in-memory database for {suite}")
    return fake


# suite -> (builder, default workload); the first 13 run in phase 27,
# A10B's eight in phase 28
SUITE_BUILDERS = {
    "zookeeper": ("zk_test", None), "raftis": ("raftis_test", "register"),
    "redis_sentinel": ("redis_sentinel_test", "register"),
    "aerospike": ("aerospike_test", "register"),
    "crate": ("crate_test", "register"),
    "rethinkdb": ("rethinkdb_test", "register"),
    "consul": ("consul_test", "register"),
    "mongodb": ("mongodb_test", "cas"),
    "voltdb": ("voltdb_test", "register"),
    "galera": ("galera_test", "bank"),
    "postgres": ("postgres_test", "append"),
    "stolon": ("stolon_test", "append"),
    "etcd": ("etcd_test", "register"),
    "hazelcast": ("hazelcast_test", "lock"),
    "cockroach": ("cockroach_test", "register"),
    "tidb": ("tidb_test", "append"),
    "yugabyte": ("yugabyte_test", "ysql/append"),
    "dgraph": ("dgraph_test", "upsert"),
    "disque": ("disque_test", "queue"),
    "elasticsearch": ("elasticsearch_test", "dirty-read"),
    "rabbitmq": ("rabbitmq_test", "queue"),
}
A10B = ("hazelcast", "cockroach", "tidb", "yugabyte", "dgraph", "disque",
        "elasticsearch", "rabbitmq")
# suite module -> registry name
SUITE_KEYS = {m: m.replace("_", "-") for m in SUITE_BUILDERS}
# the runs besides a suite's default workload: etcd's append, and the
# linearizable workloads of dgraph and yugabyte, which reach wgl_search
# where their defaults (upsert, Elle's list-append) do not
EXTRA_WORKLOADS = {"etcd": ("append",),
                   "dgraph": ("linearizable-register",),
                   "yugabyte": ("ysql/multi-key-acid",)}
# dgraph's upsert and linearizable-register spread their keys over
# groups of 4 threads and refuse a thread count that 4 does not divide,
# 6 included (ROADMAP C13): its runs take 8 threads
SUITE_CONCURRENCY = {"dgraph": 8}
# the workloads whose generator ends in a drain phase of its own after
# its `ops` (the queue's): a second cut to `ops` would drop the drain
DRAINED_WORKLOADS = {("disque", "queue")}
# Elle's list-append workloads, and the appends at big_txns txns
APPEND_WORKLOADS = ("append", "ysql/append")
BIG_APPENDS = ("postgres", "yugabyte")
# the kernel each run's workload reaches: wgl_search for the
# linearizable registers and locks (zookeeper's checker is "linear",
# the others' "workload"), scc for Elle's list-append past its dispatch
LINEARIZABLE_SUITES = ("zookeeper", "raftis", "redis_sentinel",
                       "aerospike", "crate", "rethinkdb", "consul",
                       "mongodb", "voltdb", "etcd")
LINEARIZABLE_WORKLOADS = {("hazelcast", "lock"), ("cockroach", "register"),
                          ("dgraph", "linearizable-register"),
                          ("yugabyte", "ysql/multi-key-acid")}


def linearizable_run(spec: dict) -> bool:
    """Does the run's workload checker launch wgl_search?"""
    if spec["suite"] in LINEARIZABLE_SUITES:
        return spec["workload"] not in APPEND_WORKLOADS
    return (spec["suite"], spec["workload"]) in LINEARIZABLE_WORKLOADS


def suite_runs(sizes: dict) -> list[dict]:
    """The runs of phases 27 and 28 ("phase" in each spec): each suite at
    its default workload and the EXTRA_WORKLOADS, the twins of consul's
    and cockroach's registers (phantom reads of one key), and the appends
    of postgres and yugabyte at big_txns txns with their twins (reversed
    list reads). Each append spec carries the txns its run must
    invoke."""
    base = {"nodes": SUITE_NODES, "concurrency": sizes["concurrency"],
            "ssh": {"dummy": True}, "time_limit": sizes["time_limit"],
            "rate": sizes["rate"], "seed": SUITE_SEED, "recovery_time": 0,
            **{k: sizes[k] for k in SUITE_CUTS if k in sizes}}
    appends = {"rate": sizes["append_rate"],
               "time_limit": sizes["append_time_limit"]}
    big = {"ops": sizes["big_txns"], "rate": sizes["append_rate"],
           "time_limit": sizes["big_time_limit"]}
    specs = []
    for suite, (builder, wl) in SUITE_BUILDERS.items():
        for w in (wl,) + EXTRA_WORKLOADS.get(suite, ()):
            opts = dict(base, workload=w)
            if suite in SUITE_CONCURRENCY:
                opts["concurrency"] = SUITE_CONCURRENCY[suite]
            if w in APPEND_WORKLOADS:
                opts.update(big if suite in BIG_APPENDS else appends)
            spec = {"name": (f"{suite}-{w.replace('/', '-')}" if w
                             else suite),
                    "suite": suite, "builder": builder, "workload": w,
                    "twin": False, "opts": opts,
                    "phase": 28 if suite in A10B else 27}
            if w in APPEND_WORKLOADS:
                spec["txns"] = (opts["ops"] if "ops" in opts
                                else APPEND_TXNS[suite])
            specs.append(spec)

    def default(suite):
        return next(s for s in specs if s["suite"] == suite)

    for suite in ("consul", "cockroach"):
        specs.append(dict(default(suite),
                          name=default(suite)["name"] + "-twin", twin=True,
                          phantom_key=PHANTOM_KEY))
    for suite in BIG_APPENDS:
        specs.append(dict(default(suite),
                          name=default(suite)["name"] + "-twin", twin=True,
                          reverse_every=2))
    return sorted(specs, key=lambda s: s["phase"])


def suite_test(spec: dict, store_base, device=None) -> tuple[dict, object]:
    """The named, stored test of one phase-27 or phase-28 run, built by
    the port suite's own builder with opts["device"] = device, on its
    in-memory database; returns (test, the database). Its spec.json
    carries the opts, so resume.analyze_run rebuilds its checkers."""
    mod = suites.load(SUITE_KEYS[spec["suite"]])
    opts = dict(spec["opts"], device=device)
    test = getattr(mod, spec["builder"])(dict(opts))
    fake = rig_suite(test, spec)
    if spec["suite"] not in OWN_GENERATOR:
        test["generator"] = client_generator(mod, spec, opts)
    test.update(store_base=str(store_base),
                spec={"workload": spec["workload"], "opts": opts})
    return test, fake


def client_generator(mod, spec: dict, opts: dict):
    """A run's client ops without its suite's nemesis cycle: the
    workload's generator (zookeeper's cas mix, ZK_OPS of it; rabbitmq's
    mix) staggered at the run's rate within its time limit, cut to `ops`
    where opts name them (galera's bank is bounded by time alone) and
    the workload does not end in its own drain, then
    the workload's final generator on every thread where it has one
    (elasticsearch's refresh and strong reads, rabbitmq's drain), as the
    suite's builder runs it after the nemesis stops."""
    final = None
    if spec["suite"] == "zookeeper":
        rng = random.Random(opts["seed"])
        ops = gen.limit(opts.get("ops", ZK_OPS),
                        lambda: wl_register.cas_op_mix(rng))
    else:
        w = mod.WORKLOADS[spec["workload"]](dict(opts))
        ops = w["generator"] if "generator" in w else w["mix"]
        final = w.get("final_generator", w.get("drain"))
        if "ops" in opts and (spec["suite"], spec["workload"]) not in \
                DRAINED_WORKLOADS:
            ops = gen.limit(opts["ops"], ops)
    main = gen.time_limit(opts["time_limit"], gen.clients(
        gen.stagger(1.0 / opts["rate"], ops)))
    return main if final is None else gen.phases(main, gen.clients(final))


def suite_checker_key(spec: dict) -> str:
    return "linear" if spec["suite"] == "zookeeper" else "workload"


def suite_verdict(spec: dict, res: dict):
    """The run's verdict as the suite decides it: its workload checker's
    (the composed result is "unknown" where matplotlib is missing, from
    the perf checker)."""
    return res[suite_checker_key(spec)]["valid?"]


def _failing_keys(res: dict, spec: dict):
    """The keys of an independent checker's failures, or the anomaly
    types of an Elle result."""
    r = res[suite_checker_key(spec)]
    if "failures" in r:
        return sorted(r["failures"], key=str)
    return sorted(r.get("anomaly-types", []))


def _every_certificate(hist, res) -> int:
    """certify.validate over every certificate in a result tree, each
    against the whole history; returns how many."""
    n = 0

    def walk(x):
        nonlocal n
        if isinstance(x, dict):
            if isinstance(x.get("certificate"), dict) and \
                    "absent" not in x["certificate"]:
                certify.validate(hist, x["certificate"])
                n += 1
            for v in x.values():
                walk(v)

    walk(res)
    return n


def _absent_certificates(res) -> dict:
    """The honest absences in a result tree, by reason."""
    out: dict = {}

    def walk(x):
        if isinstance(x, dict):
            cert = x.get("certificate")
            if isinstance(cert, dict) and "absent" in cert:
                out[cert["absent"]] = out.get(cert["absent"], 0) + 1
            for v in x.values():
                walk(v)

    walk(res)
    return out


def _has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _perf_as_expected(perf: dict, has_mpl: bool) -> bool:
    """The perf checker's result: valid with its plots drawn where
    matplotlib imports, else "unknown" with each plot's error naming
    matplotlib's import."""
    if has_mpl:
        return perf["valid?"] is True
    errs = [perf[k].get("error", "").strip().splitlines()[-1:]
            for k in ("latency-graph", "rate-graph")]
    return perf["valid?"] == "unknown" and all(
        e and "matplotlib" in e[0] and ("ImportError" in e[0]
                                        or "ModuleNotFoundError" in e[0])
        for e in errs)


def _edges_recorded():
    """Records the live edges of every SCC solve (Edges.scc), the count
    scc's dispatch holds against DEVICE_MIN_EDGES; returns (the list,
    restore)."""
    live: list = []
    original = scc_mod.Edges.scc

    def recording(self, emask=None):
        live.append(int(self._mask(emask).sum()))
        return original(self, emask)

    scc_mod.Edges.scc = recording

    def restore():
        scc_mod.Edges.scc = original

    return live, restore


def suites_path(dev, on_card: bool, sizes: dict | None = None,
                phase: int = 27) -> dict:
    """Phase 27 (the A10a suites) or 28 (A10b's). Returns the launches
    per run, by kernel."""
    gc.collect()
    gc.freeze()
    try:
        return _suites_path(dev, on_card, sizes, phase)
    finally:
        gc.unfreeze()


def _suites_path(dev, on_card: bool, sizes: dict | None,
                 phase: int) -> dict:
    sizes = dict(SUITE_SIZES, **(sizes or {}))
    label = "suites" if phase == 27 else "suites-a10b"
    card_dev = None if on_card else dev.type
    has_mpl = _has_matplotlib()
    t_phase = time.perf_counter()
    per_kernel: dict = {"wgl_search": {}, "scc": {}, "bank_reduce": {}}
    steps = []
    work = Path(tempfile.mkdtemp(prefix="chip-smoke-suites-"))
    try:
        for i, spec in enumerate(s for s in suite_runs(sizes)
                                 if s["phase"] == phase):
            name = spec["name"]
            t0 = time.perf_counter()
            test, fake = suite_test(spec, work / f"{i:02d}",
                                    device=card_dev)
            mod = suites.load(SUITE_KEYS[spec["suite"]])
            recorded, restore = _wrapped_kernels()
            live_edges, restore_edges = _edges_recorded()
            telemetry.reset()
            try:
                t1 = time.perf_counter()
                out = core.run(test)
            finally:
                restore()
                restore_edges()
            run_s = time.perf_counter() - t1
            calls = {k: len(v) for k, v in recorded.items()}
            launches = _launch_counts()
            res = out["results"]
            d = store.path(out)
            stored = _stored_launches(d)
            hist = out["history"]
            invokes = sum(1 for o in hist if o.type == "invoke"
                          and o.process != "nemesis")
            t2 = time.perf_counter()
            again = resume.analyze_run(d, test_fn=getattr(
                mod, spec["builder"]), device="cpu")["results"]
            cpu_s = time.perf_counter() - t2
            got, want = (_norm(_checked(res, CLI_MEASURED + ("watchdog",))),
                         _norm(_checked(again, CLI_MEASURED
                                        + ("watchdog",))))
            if got != want:
                diff = sorted(k for k in set(got) | set(want)
                              if got.get(k) != want.get(k))
                raise AssertionError(f"{name}: the card's results differ "
                                     f"from the CPU's re-analysis at "
                                     f"{diff}")
            # without matplotlib (the card machine) the perf checker's
            # plots are "unknown" from its import, and so is the
            # composed verdict of a valid run
            unsound = [w for w in _results_unsound(res) if has_mpl or not (
                w == "/" or w.startswith("/perf"))]
            if unsound:
                raise AssertionError(f"{name}: unsound results at {unsound}")
            if not _perf_as_expected(res["perf"], has_mpl) or \
                    res["valid?"] not in (suite_verdict(spec, res),
                                          "unknown"):
                raise AssertionError(f"{name}: perf {res['perf']}, "
                                     f"valid? {res['valid?']}")
            uncertified = _uncertified(res, absent_ok=True)
            if uncertified:
                raise AssertionError(f"{name}: uncertified at {uncertified}")
            certs = _every_certificate(hist, res)
            absent = _absent_certificates(res)
            verdict = suite_verdict(spec, res)
            if verdict is not (not spec["twin"]):
                raise AssertionError(f"{name}: verdict {verdict}")
            if on_card:
                if {k: launches[k] for k in ("wgl_search", "scc",
                                             "bank_reduce")} != \
                        {k: calls[k] for k in ("wgl_search", "scc",
                                               "bank_reduce")}:
                    raise AssertionError(f"{name}: launch counters "
                                         f"{launches} != wrapper calls "
                                         f"{calls}")
                if (stored["wgl_search"], stored["scc"],
                        stored["bank_reduce"]) != (
                        calls["wgl_search"],
                        calls["scc"] + calls["scc_converge"],
                        calls["bank_reduce"]):
                    raise AssertionError(f"{name}: stored launches "
                                         f"{stored} != wrapper calls "
                                         f"{calls}")
            if linearizable_run(spec) and calls["wgl_search"] < 1:
                raise AssertionError(f"{name}: no wgl_search launch")
            if "txns" in spec and invokes != spec["txns"]:
                raise AssertionError(f"{name}: {invokes} txns invoked, "
                                     f"want {spec['txns']}")
            # one launch for each solve at or past scc's dispatch
            past = sum(e >= scc_mod.DEVICE_MIN_EDGES for e in live_edges)
            if calls["scc"] != past:
                raise AssertionError(f"{name}: scc launches {calls['scc']}"
                                     f" for {past} solves past dispatch "
                                     f"(live edges {live_edges})")
            keys = _failing_keys(res, spec)
            if spec["twin"] and keys != _failing_keys(again, spec):
                raise AssertionError(f"{name}: failing keys {keys} on the "
                                     f"card, {_failing_keys(again, spec)} "
                                     f"on the CPU")
            if spec.get("phantom_key") is not None and \
                    keys != [PHANTOM_KEY]:
                raise AssertionError(f"{name}: failing keys {keys}")
            seconds = time.perf_counter() - t0
            steps.append(seconds)
            emit({"phase": label, "run": name, "suite": spec["suite"],
                  "workload": spec["workload"], "twin": spec["twin"],
                  "invokes": invokes, "txns": spec.get("txns"),
                  "events": len(hist),
                  "valid": verdict, "failing": keys,
                  "wrapper_calls": calls,
                  "launches": launches if on_card else None,
                  "stored_launches": stored, "certificates": certs,
                  "absent_certificates": absent,
                  "scc_live_edges": live_edges,
                  "scc_min_edges": scc_mod.DEVICE_MIN_EDGES,
                  "run_s": run_s, "cpu_reanalysis_s": cpu_s,
                  "seconds": seconds,
                  "elapsed_s": time.perf_counter() - t_phase,
                  "card": nvidia_smi_line() if on_card else "cpu"})
            for kernel in ("wgl_search", "bank_reduce"):
                if calls[kernel]:
                    per_kernel[kernel][f"suite-{name}"] = calls[kernel]
            n_scc = calls["scc"] + calls["scc_converge"]
            if n_scc:
                per_kernel["scc"][f"suite-{name}"] = n_scc
            del out, test, fake, hist
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if on_card and not per_kernel["scc"]:
        raise AssertionError("no suite run launched scc")
    total = time.perf_counter() - t_phase
    emit({"phase": f"{label}-total", "runs": len(steps), "seconds": total,
          "budget_s": SUITES_BUDGET_S,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return per_kernel


LINT_BUDGET_S = 20.0
LINT_BASELINE = Path(__file__).resolve().parent / "lint-baseline-torch.json"


def lint_path(dev, on_card: bool) -> dict:
    """Phase 29: the static analysis (jepsen_tpu_torch.analysis) after
    the earlier phases' launches. (a) `python -m jepsen_tpu_torch lint
    --baseline lint-baseline-torch.json --json` in a process of its own
    must exit 0 with 0 NEW and 0 stale findings; (b) run_lint with the
    runtime buckets of this process and, on the card, full mode (the
    libraries built and asked for every launch's scratch and shared
    memory), with no trace error, the library's sizes equal to the
    plan's at every registry and runtime bucket, and the default mode's
    finding keys those of the committed baseline; (c) /lint and /lint?
    json=1 from a web.serve answer 200 with the gated report. Launches
    no kernel. Returns the phase's numbers."""
    from jepsen_tpu_torch import web
    from jepsen_tpu_torch.analysis import driver

    t_phase = time.perf_counter()
    out: dict = {}
    # (a) the command line, in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        _cli_argv("lint", "--baseline", str(LINT_BASELINE), "--json"),
        capture_output=True, text=True, env=_cli_env(), timeout=300,
        cwd=Path(__file__).resolve().parent)
    out["cli_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"lint exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    if doc["ratchet"]["new"] or doc["ratchet"]["stale"]:
        raise AssertionError(f"lint vs its baseline: {doc['ratchet']}")
    out["cli"] = {"findings": doc["aggregates"]["findings"],
                  "traces": len(doc["traces"]),
                  "pinned": doc["ratchet"]["baselined"],
                  "lint_wall_s": doc["wall_s"]}
    # (b) this process: runtime buckets, full mode on the card
    t0 = time.perf_counter()
    rep = driver.run_lint(runtime_buckets=True, full=on_card)
    out["full_s"] = time.perf_counter() - t0
    if rep.errors:
        raise AssertionError(f"lint trace errors: {rep.errors[:5]}")
    sized, by_kernel, runtime = 0, {}, {}
    for t in rep.traces:
        by_kernel[t["kernel"]] = by_kernel.get(t["kernel"], 0) + 1
        if t["bucket"].startswith("rt-"):
            runtime[t["kernel"]] = runtime.get(t["kernel"], 0) + 1
        for k, v in t.get("library", {}).items():
            if t[k] != v:
                raise AssertionError(f"{t['kernel']}/{t['bucket']}: {k} "
                                     f"{t[k]} in Python, {v} in the "
                                     f"library")
            sized += 1
    if on_card and not (runtime.get("wgl") and runtime.get("scc")):
        raise AssertionError(f"no runtime bucket traced: {runtime}")
    want = [e["key"] for e in
            json.loads(LINT_BASELINE.read_text())["findings"]]
    default = driver.run_lint()
    got = sorted(f.key for f in default.findings)
    if got != sorted(want):
        raise AssertionError(f"default-mode keys differ from the "
                             f"baseline: {sorted(set(got) ^ set(want))}")
    out["full"] = {"traces": len(rep.traces), "by_kernel": by_kernel,
                   "runtime_buckets": runtime,
                   "library_sizes_compared": sized,
                   "findings": rep.by_rule(), "lint_wall_s": rep.wall_s,
                   "default_findings": default.by_rule(),
                   "default_lint_wall_s": default.wall_s,
                   "default_traces": [
                       {k: t[k] for k in ("kernel", "bucket", "args_bytes",
                                          "scratch_bytes", "smem_bytes",
                                          "carry_bytes")}
                       for t in default.traces]}
    # (c) the web UI's /lint
    t0 = time.perf_counter()
    srv = web.serve("127.0.0.1", 0, base=Path(tempfile.mkdtemp(
        prefix="chip-smoke-lint-")))
    try:
        port = srv.server_address[1]
        code, body = _http_get(f"http://127.0.0.1:{port}/lint?json=1"
                               "&refresh=1")
        page = json.loads(body) if code == 200 else {}
        if code != 200 or page["ratchet"]["new"] or \
                page["ratchet"]["stale"]:
            raise AssertionError(f"web /lint?json=1: {code} "
                                 f"{body[:300]}")
        code2, body2 = _http_get(f"http://127.0.0.1:{port}/lint")
        if code2 != 200 or b"graftlint" not in body2:
            raise AssertionError(f"web /lint: {code2}")
    finally:
        srv.shutdown()
        srv.server_close()
    out["web_s"] = time.perf_counter() - t0
    out["web"] = {"json": code, "html": code2,
                  "findings": len(page["findings"])}
    out["seconds"] = time.perf_counter() - t_phase
    out["budget_s"] = LINT_BUDGET_S
    emit({"phase": "lint", **out,
          "card": nvidia_smi_line() if on_card else "cpu"})
    return out


# ---------------------------------------------------------------------------
# 30. the multi-device form (A6): meshes of shards sharing the card
# ---------------------------------------------------------------------------

MESH_SHARDS = 4
MESH_BUDGET_S = 45.0
# the 2-rank group's inputs: phase 12's first histories and a graph of
# tests/test_spmd.py's shape
MESH_RANK_HISTORIES = 64


def _shared_card(dev, n: int):
    """spmd.cards() as n entries of `dev` until the returned function is
    called: the automatic route then lays every launch out over n shards
    sharing the one card, as it would over n cards."""
    original = spmd.cards
    spmd.cards = lambda: [(0, dev)] * n

    def restore():
        spmd.cards = original
    return restore


def _spmd_graph(seed: int, n: int = 2500, e: int = 30_000):
    rng = np.random.default_rng(seed)
    ring = np.arange(40)
    return (n, np.concatenate([rng.integers(0, n, e), ring]),
            np.concatenate([rng.integers(0, n, e), np.roll(ring, -1)]))


def _scc_one_device(n, src, dst, mask, dev) -> np.ndarray:
    """scc_kernel's (or off the card its plain version's) [n + 3] on the
    masked edges: the sharded solve's reference."""
    on = np.ones(len(src), bool) if mask is None else mask
    return kscc.scc_labels(*_scc_tensors(np.asarray(src, np.int32),
                                         np.asarray(dst, np.int32), on,
                                         dev), n).cpu().numpy()


def _rank_inputs(n_hists: int):
    m = models.cas_register()
    encs = [encode(m, ensemble_hist(i)) for i in range(n_hists)]
    rows = [(i, s) for i, e in enumerate(encs)
            for s in range(min(e.n_states, 2))]
    return encs, rows, _spmd_graph(5)


def mesh_rank_outputs(mesh, n_hists: int) -> dict:
    """What a 2-rank group and the in-process 2-shard mesh must agree on:
    a reach launch over the first start states of n_hists of phase 12's
    histories, their verdicts, and the sharded SCC of a test_spmd-shaped
    graph."""
    encs, rows, (n, src, dst) = _rank_inputs(n_hists)
    mask, unk = wgl._drain(ensemble.sharded_launch(
        wgl.PackedBatch(encs), rows, 16, 16, reach=True, mesh=mesh),
        reach=True)
    res = ensemble.check_batch_sharded(encs, mesh=mesh, W=32, F=64)
    graph = scc_mod.Edges(n, src, dst, mesh=mesh)
    return {"mask": mask.tolist(), "unknown": unk.tolist(),
            "result": res.tolist(), "scc": graph.solve_sharded().tolist()}


def mesh_rank(rank: int, rdv: str, dev: str, n_hists: int) -> None:
    """One rank of phase 30's 2-rank gloo group (run in a process of its
    own by _mesh_group): joins through a file rendezvous, lays a mesh of
    two shards of `dev` over the two ranks and prints its outputs."""
    import datetime

    import torch.distributed as tdist

    tdist.init_process_group("gloo", init_method=f"file://{rdv}",
                             world_size=2, rank=rank,
                             timeout=datetime.timedelta(seconds=120))
    try:
        if not gdist.ensure_initialized():
            raise AssertionError("the process group was not adopted")
        mesh = spmd.mesh_of([dev, dev])
        out = mesh_rank_outputs(mesh, n_hists)
        out["info"] = gdist.process_info()
        out["info"]["spmd_devices"] = spmd.spmd_devices()
        out["mesh_ranks"] = list(mesh.ranks)
        print("MESH-RANK " + json.dumps(out), flush=True)
    finally:
        tdist.destroy_process_group()


def _mesh_group(dev, tmp: Path, n_hists: int) -> dict:
    """Two ranks of a gloo group, each in a process of its own, sharing
    `dev`: both must answer what the in-process 2-shard mesh answers."""
    t0 = time.perf_counter()
    rdv = tmp / "rdv"
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as cs; cs.mesh_rank({r}, {str(rdv)!r}, "
         f"{str(dev)!r}, {n_hists})"],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    want = mesh_rank_outputs(spmd.mesh_of([dev, dev]), n_hists)
    mism = 0
    infos = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MESH-RANK ")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"mesh rank {r} exited {p.returncode}: "
                                 f"{err[-3000:]}")
        got = json.loads(lines[0][len("MESH-RANK "):])
        infos.append(got.pop("info"))
        if got.pop("mesh_ranks") != [0, 1]:
            raise AssertionError(f"rank {r}: the mesh's ranks")
        mism += sum(int(np.sum(np.asarray(got[k]) != np.asarray(want[k])))
                    for k in want)
    # the two ranks share one card (none off the card): the group lists
    # it once, so its automatic route keeps the one-device launch
    n_cards = int(dev.type == "cuda")
    if [i["backend"] for i in infos] != ["gloo", "gloo"] or \
            [i["process_index"] for i in infos] != [0, 1] or \
            [(i["global_devices"], i["spmd_devices"]) for i in infos] != \
            [(n_cards, n_cards)] * 2:
        raise AssertionError(f"the group's ranks: {infos}")
    return {"ranks": 2, "backend": "gloo", "mismatches": mism,
            "rows": len(want["mask"]), "histories": len(want["result"]),
            "scc_nodes": len(want["scc"]) - 3, "info": infos,
            "wall_s": time.perf_counter() - t0}


def _returns_before_search(encs, dev, shards: int,
                           sleep_s: float = 0.5) -> tuple:
    """(seconds wgl._launch took to return, the seconds of the sleep
    queued on the card just before its dispatch, whether its `done`
    event had fired at the return) for a launch routed over `shards`
    shards of `dev`. Every input is uploaded before the dispatch, so
    the launch returns while the sleep holds the card."""
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    cycles = int(10 ** 8 * sleep_s / (start.elapsed_time(end) / 1e3))
    pb = wgl.PackedBatch(encs)
    rows = [(i, e.init_state) for i, e in enumerate(encs)]
    timed = wgl._timed_launch

    def sleeping(bucket, dispatch, kernel, meta):
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        return timed(bucket, dispatch, kernel=kernel, meta=meta)

    restore = _shared_card(dev, shards)
    wgl._timed_launch = sleeping
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wgl._launch(pb, rows, 32, 64, False, dev)
        ret_s = time.perf_counter() - t0
        fired = out.done.query()
        wgl._drain(out, reach=False)
    finally:
        wgl._timed_launch = timed
        restore()
    return ret_s, start.elapsed_time(end) / 1e3, fired


class _ShardCalls:
    """Records each call of the scc_shard chunk wrapper (the state a call
    starts from, cloned, since the solve updates it in place, and the
    state it leaves), for the replays of phase 30 (b). A round has no
    launch of its own: its steps run inside the chunks."""

    def __init__(self):
        self.calls = {"scc_chunk": []}
        self.originals = {k: getattr(kshard, k) for k in self.calls}

    def __enter__(self):
        orig = self.originals

        def chunk(plan, k, first, **kw):
            before = _chunk_state(plan)
            orig["scc_chunk"](plan, k, first, **kw)
            self.calls["scc_chunk"].append((plan, k, first, before,
                                            _chunk_state(plan)))

        kshard.scc_chunk = chunk
        return self

    def __exit__(self, *exc):
        for k, v in self.originals.items():
            setattr(kshard, k, v)
        return False


def _chunk_state(chunk) -> dict:
    """Clones of what a chunk of sweeps reads and writes: the node
    arrays (the colours one clone with x in the forward pass, whose x
    they are), the accumulator and the state its shards share, the
    labels where the chunk retires, and each shard's edge mask (the
    solver's, which the next solve overwrites), live list and count."""
    sweeps, a = chunk.group.sweeps, chunk.apply.outputs
    out = {"x": a["x"].clone(), "prop": a["prop"].clone(),
           "st": a["st"].clone(), "active": sweeps[0].args["active"].clone()}
    col = sweeps[0].args["col"]
    out["col"] = out["x"] if col is a["x"] else col.clone()
    if chunk.retire is not None:
        out["out"] = chunk.retire.outputs["out"].clone()
    for i, p in enumerate(sweeps):
        out[f"on{i}"] = p.args["edge_on"].clone()
        out[f"live{i}"] = p.outputs["live"].clone()
        out[f"cnt{i}"] = p.outputs["cnt"].clone()
    return out


def _chunk_plans(chunk, state: dict) -> tuple:
    """The chunk's sweep group, apply plan and retire plan (None for a
    forward chunk) over the tensors of `state` (a _chunk_state), its
    edge blocks shared."""
    backward = bool(chunk.apply.params["backward"])
    group = kshard.SweepGroup([kshard.sweep_plan(
        p.args["src"], p.args["dst"], state[f"on{i}"], state["active"],
        state["x"], state["col"], state["prop"], state[f"live{i}"],
        state[f"cnt{i}"], state["st"], backward)
        for i, p in enumerate(chunk.group.sweeps)])
    apply = kshard.apply_plan(state["x"], state["prop"], state["st"],
                              state["active"], state["col"],
                              chunk.apply.params["cap"], backward)
    retire = (kshard.retire_plan(state["active"], state["col"], state["x"],
                                 state["out"], state["st"])
              if chunk.retire is not None else None)
    return group, apply, retire


def _live_keys(plan) -> torch.Tensor:
    """A sweep plan's live list as sorted s * n + d keys (the kernel
    appends in no fixed order)."""
    b, E, n = (plan.params[k] for k in ("backward", "E", "n"))
    k = min(int(plan.outputs["cnt"][b]), E)
    pairs = plan.outputs["live"][:k].to(torch.int64)
    return (pairs[:, 0] * n + pairs[:, 1]).sort().values


def _state_err(a: dict, b: dict, group_a, group_b) -> int:
    """max_abs_err between two chunk states: x, prop, st, the active set
    and the labels, each count, and each live list as a set."""
    names = ["x", "prop", "st", "active"] + [
        f"cnt{i}" for i in range(len(group_a.sweeps))] + (
        ["out"] if "out" in a else [])
    err = _max_abs_err([a[k] for k in names], [b[k] for k in names])
    for pa, pb in zip(group_a.sweeps, group_b.sweeps):
        ka, kb = _live_keys(pa), _live_keys(pb)
        err = max(err, _max_abs_err([ka], [kb]) if ka.shape == kb.shape
                  else 1 << 30)
    return err


def _ms_of(fn, on_card: bool, reps: int = 3) -> float:
    """ms of one call of fn: CUDA events around back-to-back calls on
    the card (at these sizes the host's launch rate may set it), the host
    clock off the card."""
    if on_card:
        return _event_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def _kernel_ms(fn, on_card: bool, reps: int = 3, restore=None,
               queued: bool = False) -> float:
    """ms of the kernels of one launch alone: fn(events) launches with a
    (start, end) pair, which the wrapper's launcher records just around
    its kernels, so the host's time between launches is left out; the
    mean over reps. restore(), where given, runs before every launch,
    outside the events, so each rep starts from the same state (and the
    state after is that of one launch). `queued`: the reps are enqueued
    behind a ~1 ms sleep on the card, so each pair of events meets its
    kernels already in the queue and times the card alone, not the
    host's launch call between them. Off the card, _ms_of's host
    clock."""
    restore = restore or (lambda: None)
    if not on_card:
        def once(_ev):
            restore()
            fn(None)
        return _ms_of(lambda: once(None), on_card, reps)
    restore()
    fn(None)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(2_000_000)
    for ev in pairs:
        restore()
        fn(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _bound_ms(nbytes: int) -> float:
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def _new_kinds(names) -> dict:
    return {k: {"launches": 0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "library_ms": 0.0} for k in names}


def _replay_chunk(entry, on_card: bool, sweeps: dict, applies: dict,
                  retires: dict, chunks: dict) -> int:
    """Phase 30 (b)'s replay of one recorded chunk from the state it
    started from: each of its launches one by one (a backward chunk's
    retire as a launch of its own after its sweeps), the kernel timed
    between its launcher's events (the mean of 3, each from the same
    state) and its plain version by the host's clock, both checked to
    agree after every launch, and where a PyTorch call computes the
    same values its time; the state after the chunk checked against
    what the main path's one call left; then the chunk whole, through
    scc_chunk (the retire at its end), timed between the events its
    launcher records around its kernels (the host's launch calls
    between them included, as on the main path) and checked the same
    way. Adds to the sweep kinds (compacting_forward,
    compacting_backward, live, past_done), the apply kinds
    (forward_first, backward_first, applied, past_done), the retire
    kinds (retired, running) and `chunks`. Returns the max_abs_err."""
    chunk, k, first, before, after = entry
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ks = _clone_state(before)
    ps = _clone_state(before)
    k_sweeps, k_apply, k_retire = _chunk_plans(chunk, ks)
    p_sweeps, p_apply, p_retire = _chunk_plans(chunk, ps)
    backward = k_apply.params["backward"]
    pass_name = "backward" if backward else "forward"
    n = int(ks["x"].numel())
    err = 0

    def one(kind, table, fn_k, fn_p, mutable, lib, nbytes):
        nonlocal err
        snap = {m: ks[m].clone() for m in mutable}

        def restore():
            for m in mutable:
                ks[m].copy_(snap[m])
        device_ms = _kernel_ms(fn_k, on_card, restore=restore, queued=True)
        ms = _kernel_ms(fn_k, on_card, restore=restore)
        sync()
        t0 = time.perf_counter()
        fn_p()
        sync()
        row = table[kind]
        row["launches"] += 1
        row["ms"] += ms
        row["device_ms"] += device_ms
        row["plain_ms"] += 1e3 * (time.perf_counter() - t0)
        row["bound_ms"] += _bound_ms(nbytes)
        if lib is not None:
            row["library_ms"] += _ms_of(lib, on_card)
        err = max(err, _state_err(ks, ps, k_sweeps, p_sweeps))

    for it in range(k):
        fresh = first and it == 0
        done = int(ks["st"][kshard.DONE]) != kshard.RUNNING
        kind = (f"compacting_{pass_name}" if fresh else "past_done" if done
                else "live")
        lib, nbytes = None, 4
        if kind != "past_done":
            to, vals = [], []
            # the accumulator written, the state; a later sweep reads x
            nbytes = 4 * n + 8 + (0 if fresh else 4 * n)
            for pk in k_sweeps.sweeps:
                a, E = pk.args, pk.params["E"]
                s, d = a["src"].long(), a["dst"].long()
                live = a["edge_on"] & a["active"][s] & a["active"][d]
                if backward:
                    live &= a["col"][s] == a["col"][d]
                    s, d = d, s
                to.append(d[live])
                vals.append(kshard.compact_values(pk, s[live]) if fresh
                            else ks["x"][s[live]])
                c = int(live.sum())
                nbytes += 9 * E + 8 * c + 4 if fresh else 8 * c + 4
            if fresh:  # active, and backward the colours, gathered
                nbytes += n * (1 + 4 * backward)
            to, vals = torch.cat(to), torch.cat(vals)
            scratch = torch.empty_like(ks["prop"])
            lib = (lambda: scratch.scatter_reduce_(0, to, vals, "amax"))
        one(kind, sweeps,
            lambda ev: kshard.scc_sweep(k_sweeps, fresh, events=ev),
            lambda: kshard.sweep_reference(p_sweeps, fresh),
            ["prop"] + [f"{t}{i}" for i in range(len(k_sweeps.sweeps))
                        for t in ("live", "cnt")], lib, nbytes)
        done = not fresh and int(ks["st"][kshard.DONE]) != kshard.RUNNING
        xl = ks["x"].clone()
        # x (or active, and backward c) read, x and prop written, prop
        # read, the state
        nbytes = (16 * n + 32 if not fresh else
                  13 * n + 32 if not backward else 17 * n + 32)
        one("past_done" if done else f"{pass_name}_first" if fresh
            else "applied", applies,
            lambda ev: kshard.scc_apply(k_apply, fresh, events=ev),
            lambda: kshard.apply_reference(p_apply, fresh),
            ["x", "prop", "st"],
            None if done or fresh else (
                lambda: torch.maximum(xl, ks["prop"], out=xl)),
            4 if done else nbytes)
    if k_retire is not None:
        # the retire as a launch of its own: active, m and c read, out
        # and active written, the state
        done = int(ks["st"][kshard.DONE]) != kshard.RUNNING
        one("retired" if done else "running", retires,
            lambda ev: kshard.scc_retire(k_retire, events=ev),
            lambda: kshard.retire_reference(p_retire),
            ["active", "out", "st"], None, 14 * n + 24 if done else 4)
    want = _chunk_plans(chunk, after)[0]
    err = max(err, _state_err(ks, after, k_sweeps, want))
    # and the chunk whole, as the main path launched it
    cs = _clone_state(before)
    c_group, c_apply, c_retire = _chunk_plans(chunk, cs)
    whole = kshard.ChunkPlan(c_group, c_apply, chunk.host, c_retire)

    def restore():
        for m, t in before.items():
            cs[m].copy_(t)
    ms = _kernel_ms(lambda ev: kshard.scc_chunk(whole, k, first, events=ev),
                    on_card, restore=restore)
    chunks["calls"] += 1
    chunks["sweeps_launched"] += k
    chunks["ms"] += ms
    return max(err, _state_err(cs, after, c_group, want))


def _clone_state(state: dict) -> dict:
    """A copy of a _chunk_state whose colours stay one tensor with x
    where they were (the forward pass)."""
    out = {n: t.clone() for n, t in state.items() if n != "col"}
    out["col"] = out["x"] if state["col"] is state["x"] \
        else state["col"].clone()
    return out


def shard_kernel_timing(rec: _ShardCalls, launches: dict,
                        on_card: bool) -> list[dict]:
    """Phase 30 (b): every scc_shard launch of the main path replayed on
    its recorded inputs (_replay_chunk), against its plain version (the
    same PyTorch code the CPU runs, here on the card's tensors) and the
    recorded output. Bytes bounds, each input read once and each output
    written once: a compacting sweep (one launch over a device's shards)
    reads each edge's src, dst and edge_on (9 bytes) and each node's
    active (1) and, backward, col (4) (it reads no x: the values it sends
    follow from those), and writes prop (4), 8 bytes a live edge and the
    counts; a later sweep reads 8 bytes a live edge and x, and writes
    prop; an apply reads and writes x and prop (16 a node), a first
    apply reads active (1) and, backward, c (4) in place of x; a retire
    reads active, m and c and writes out and active (14 a node); a launch
    past the fixpoint's end, or a retire while it runs, reads 4 bytes of
    state."""
    sweeps = _new_kinds(("compacting_forward", "compacting_backward",
                         "live", "past_done"))
    applies = _new_kinds(("forward_first", "backward_first", "applied",
                          "past_done"))
    retires = _new_kinds(("retired", "running"))
    chunks = {"calls": 0, "sweeps_launched": 0, "ms": 0.0}
    err = 0
    for entry in rec.calls["scc_chunk"]:
        err = max(err, _replay_chunk(entry, on_card, sweeps, applies,
                                     retires, chunks))
    chunks["us_a_sweep"] = (1e3 * chunks["ms"] / chunks["sweeps_launched"]
                            if chunks["sweeps_launched"] and on_card
                            else None)
    if not on_card:
        chunks["ms"] = None
    rows = []
    for name, kinds, lib_call in (
            ("scc_sweep", sweeps, "Tensor.scatter_reduce_(0, dst, values, "
                                  "'amax') of the live edges"),
            ("scc_apply", applies, "torch.maximum(x, prop, out=x), "
                                   "without the state (later applies)"),
            ("scc_retire", retires, None)):
        for row in kinds.values():
            for key in ("ms", "device_ms"):
                row[key.replace("ms", "us_each")] = (
                    1e3 * row[key] / row["launches"]
                    if row["launches"] and on_card else None)
                if not on_card:  # host times are no kernel times
                    row[key] = None
        rows.append({
            "name": name, "launches": launches[name],
            "replayed": sum(r["launches"] for r in kinds.values()),
            "max_abs_err": err,
            **{key: sum(r[key] or 0.0 for r in kinds.values())
               for key in ("ms", "device_ms", "plain_ms", "bound_ms")},
            "library_ms": (sum(r["library_ms"] or 0.0
                               for r in kinds.values())
                           if lib_call else None),
            "library_call": lib_call, "kinds": kinds})
    rows[0]["compacting_launches"] = launches["scc_sweep_compacting"]
    # the chunks, sweeps, applies and retires together, as the main path
    # runs them
    rows[0]["chunks"] = chunks
    return rows


def _shard_launch_counts() -> dict:
    return {"scc_sweep": kshard.sweep_launches,
            "scc_sweep_compacting": kshard.compact_launches,
            "scc_apply": kshard.apply_launches,
            "scc_retire": kshard.retire_launches,
            "state_reads": kshard.state_reads}


def _zero_counts() -> None:
    ws.launches = ensemble.launches = 0
    kshard.sweep_launches = kshard.compact_launches = 0
    kshard.apply_launches = kshard.retire_launches = kshard.state_reads = 0


class _HostWaits:
    """Counts by kind, while it is entered, the calls by which the host
    waits for the card: a CUDA tensor read back (item, tolist, numpy,
    cpu, int, bool, float, index, a `to` or a blocking `copy_` into host
    memory) and a stream's, an event's or the device's synchronize. A
    sharded solve on the card waits only in kshard.read_state (its
    stream's synchronize, once a chunk) and at the labels' download
    (one Tensor.cpu); on the CPU it waits for nothing."""

    def __enter__(self):
        self.waits: dict = {}
        self._saved = []

        def count(kind):
            self.waits[kind] = self.waits.get(kind, 0) + 1

        def on_cuda(name, f):
            def read(t, *a, **k):
                if t.is_cuda:
                    count(f"Tensor.{name}")
                return f(t, *a, **k)
            return read

        def to(f):
            def read(t, *a, **k):
                out = f(t, *a, **k)
                if t.is_cuda and not out.is_cuda:
                    count("Tensor.to")
                return out
            return read

        def copy_(f):
            def read(t, src, non_blocking=False, **k):
                if src.is_cuda and not t.is_cuda and not non_blocking:
                    count("Tensor.copy_")
                return f(t, src, non_blocking, **k)
            return read

        def sync(name, f):
            def wait(*a, **k):
                count(name)
                return f(*a, **k)
            return wait

        wraps = [(torch.Tensor, name, on_cuda(name, getattr(torch.Tensor,
                                                            name)))
                 for name in ("item", "tolist", "numpy", "cpu", "__int__",
                              "__bool__", "__float__", "__index__")]
        wraps += [(torch.Tensor, "to", to(torch.Tensor.to)),
                  (torch.Tensor, "copy_", copy_(torch.Tensor.copy_)),
                  (torch.cuda, "synchronize",
                   sync("cuda.synchronize", torch.cuda.synchronize))]
        wraps += [(cls, "synchronize", sync(f"{cls.__name__}.synchronize",
                                            cls.synchronize))
                  for cls in (torch.cuda.Stream, torch.cuda.Event)]
        for owner, name, wrap in wraps:
            self._saved.append((owner, name, owner.__dict__.get(name)))
            setattr(owner, name, wrap)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        return False


def _chunk_schedules(graph, key, dev, shards: int, reps: int = 5) -> dict:
    """The sharded solve of one graph under three chunk schedules, in
    turns in one process: the solve's own (gpu/scc.py `_schedule`), one
    read-back a sweep, and chunks of 2, 4, 8, ...; for each the median
    host seconds of `reps` solves, and the state reads and sweep
    launches of one."""
    n, src, dst = graph
    edges = scc_mod.Edges(n, src, dst, ekey=key, mesh=[dev] * shards)
    own = scc_mod._schedule
    schedules = {"own": own,
                 "one-a-sweep": lambda head: iter(lambda: 1, None),
                 "2-4-8": lambda head: own((2,))}
    times: dict = {name: [] for name in schedules}
    counts: dict = {}
    want = None
    try:
        for _ in range(reps):
            for name, sched in schedules.items():
                scc_mod._schedule = sched
                c0 = _shard_launch_counts()
                t0 = time.perf_counter()
                out = edges.solve_sharded()
                times[name].append(time.perf_counter() - t0)
                c1 = _shard_launch_counts()
                counts[name] = {k: c1[k] - c0[k]
                                for k in ("state_reads", "scc_sweep")}
                if want is None:
                    want = out
                elif not np.array_equal(out, want):
                    raise AssertionError(f"chunk schedule {name} changed "
                                         "the solve")
    finally:
        scc_mod._schedule = own
    return {"shards": shards, "nodes": n, "edges": len(src),
            "sweeps": int(want[n + 2]),
            "schedules": {name: {"solve_s": float(np.median(times[name])),
                                 **counts[name]} for name in schedules}}


def mesh_path(dev, on_card: bool, hists, ext_ops: int, elle_hists: dict,
              shards: int = MESH_SHARDS,
              group_histories: int = MESH_RANK_HISTORIES) -> dict:
    """Phase 30: the multi-device form (ROADMAP A6) over `shards` shards
    sharing the card (see the module docstring's item 30). Returns the
    launches of its main paths and the kernels line's entries of the
    sharded SCC's kernels and of the ensemble's mesh form."""
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    seconds = {}
    mark = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - mark[0]
        mark[0] = now

    if spmd.spmd_devices() > 1 and on_card:
        raise AssertionError("the card machine routes launches over "
                             f"{spmd.spmd_devices()} cards: the main path "
                             "would not be the one-device launch")
    m = models.cas_register()
    mesh = [dev] * shards
    per_path = {}
    # (a) the ensemble: phase 12's histories over the mesh and over one
    # device; reach masks over every start state of 64 of them
    encs = [encode(m, h) for h in hists]
    ensemble.check_batch_sharded(encs, mesh=dev)  # warm, as the mesh is
    sync()
    t0 = time.perf_counter()
    one = ensemble.check_batch_sharded(encs, mesh=dev)
    sync()
    one_s = time.perf_counter() - t0
    calls: list = []
    original = _recording(wgl, "_run", calls)
    try:
        _zero_counts()
        profiler.reset()
        sync()
        t0 = time.perf_counter()
        got = ensemble.check_batch_sharded(encs, mesh=mesh)
        sync()
        ens_s = time.perf_counter() - t0
        per_path["mesh-ensemble"] = ws.launches
        shard_launches = ensemble.launches
    finally:
        wgl._run = original
    rec = [r for r in profiler.get().records()
           if r["kernel"] == "wgl-sharded"]
    ens_mism = int(np.sum(np.asarray(got) != np.asarray(one)))
    sub = encs[:64]
    rows = [(i, s) for i, e in enumerate(sub) for s in range(e.n_states)]
    r1 = ensemble.check_batch_sharded(sub, mesh=dev, reach=True, rows=rows)
    r4 = ensemble.check_batch_sharded(sub, mesh=mesh, reach=True, rows=rows)
    reach_mism = sum(int(np.sum(np.asarray(a) != np.asarray(b)))
                     for a, b in zip(r1, r4))
    if ens_mism or reach_mism:
        raise AssertionError(f"mesh ensemble: {ens_mism} verdicts and "
                             f"{reach_mism} reach rows differ")
    if on_card and (shard_launches != shards or
                    per_path["mesh-ensemble"] != shards):
        raise AssertionError(f"mesh ensemble: {shard_launches} shard "
                             f"launches, {per_path['mesh-ensemble']} "
                             f"wgl_search launches for {shards} shards")
    replays = [_replay(c, on_card) for c in calls]
    if any(x["max_abs_err"] for x in replays):
        raise AssertionError("mesh ensemble shards differ from the "
                             "plain version")
    emit({"phase": "mesh-ensemble", "shards": shards,
          "histories": len(encs), "mismatches": ens_mism,
          "reach_rows": len(rows), "reach_mismatches": reach_mism,
          "wall_s": ens_s, "one_device_wall_s": one_s,
          "wgl_search_launches": per_path["mesh-ensemble"],
          "devices": rec[0]["devices"] if rec else None,
          "device_entries": rec[0]["device_entries"] if rec else None,
          "balance": rec[0]["balance"] if rec else None,
          "kernel_ms": [x["kernel_ms"] for x in replays]})
    if on_card:
        ret_s, sleep_s, fired = _returns_before_search(encs[:64], dev,
                                                       shards)
        emit({"phase": "mesh-launch-returns", "return_s": ret_s,
              "queued_sleep_s": sleep_s, "done_at_return": fired})
        if fired or ret_s >= sleep_s / 2:
            raise AssertionError(
                f"a routed launch waited on the card: it returned after "
                f"{ret_s:.3f} s behind a {sleep_s:.3f} s sleep, its search "
                f"{'done' if fired else 'not done'}")
    lap("ensemble")
    # (a) check_segmented of phase 16's history and its twin, automatic
    # route over the shards: results and certificates the one-device's
    ext_hist = synth.register_history(ext_ops, n_procs=5, seed=42)
    ext_bad = synth.corrupt_register_history(ext_hist, at_frac=0.85)[0]
    seg_launches = 0
    for label, h in (("valid", ext_hist), ("invalid", ext_bad)):
        enc = encode(m, h)
        sync()
        t0 = time.perf_counter()
        want = wgl.check_segmented(enc, witness=True, device=dev)
        sync()
        one_s = time.perf_counter() - t0
        certify.attach_wgl(m, h, enc, want)
        restore = _shared_card(dev, shards)
        try:
            _zero_counts()
            telemetry.reset()
            sync()
            t0 = time.perf_counter()
            res = wgl.check_segmented(enc, witness=True, device=dev)
            sync()
            seg_s = time.perf_counter() - t0
            launches = ws.launches
            c = telemetry.get().counters()
        finally:
            restore()
        certify.attach_wgl(m, h, enc, res)
        certify.validate(h, res["certificate"])
        same = (_cert_bytes(res) == _cert_bytes(want)
                and _norm({k: v for k, v in res.items()
                           if k != "certificate"})
                == _norm({k: v for k, v in want.items()
                          if k != "certificate"}))
        if not same or res["valid?"] is not (label == "valid"):
            raise AssertionError(f"mesh check_segmented ({label}) differs "
                                 "from the one-device check")
        if on_card and c.get("wgl.spmd.launches", 0) < 1:
            raise AssertionError("check_segmented did not ride the mesh")
        seg_launches += launches
        emit({"phase": "mesh-segmented", "history": label,
              "events": len(h), "segments": res.get("segments"),
              "shards": shards, "check_s": seg_s, "one_device_check_s": one_s,
              "wgl_search_launches": launches,
              "mesh_launches": c.get("wgl.spmd.launches", 0),
              "mismatches": 0, "certified": True})
    per_path["mesh-segmented"] = seg_launches
    lap("segmented")
    # (b) the sharded SCC: phase 8's twin through the Elle check over the
    # shards (the automatic route), then each graded subset of phase
    # 8's graphs and a test_spmd-shaped graph against scc_kernel
    twin = elle_hists["list-append-corrupted"]
    # the reference: the one-device cycle search over the edges in the
    # key-block order the mesh lays them out in (the witness a search
    # finds in an SCC follows the edge order, as in the JAX package)
    a = elle_device.DeviceAppendAnalysis(twin)
    o = np.argsort(a.edge_key, kind="stable")
    anomalies = dict(a.anomalies)
    anomalies.update(elle_device.cycle_anomalies_arrays(
        a.flat.n, a.edge_src[o], a.edge_dst[o], a.edge_ty[o], a._op,
        device=dev))
    want = {"valid?": not anomalies, "anomaly-types": sorted(anomalies),
            "anomalies": {k: v[:8] for k, v in anomalies.items()}}
    restore = _shared_card(dev, shards)
    try:
        with _ShardCalls() as shard_rec:
            _zero_counts()
            telemetry.reset()
            sync()
            t0 = time.perf_counter()
            res = elle_device.check_list_append_device(twin, device=dev)
            sync()
            elle_s = time.perf_counter() - t0
            shard_launches = _shard_launch_counts()
            c = telemetry.get().counters()
    finally:
        restore()
    if _norm({k: res[k] for k in want}) != _norm(want) \
            or res["valid?"] is not False:
        raise AssertionError("the Elle check over the shards differs "
                             f"from the one-device check: "
                             f"{res['anomaly-types']}")
    if on_card and not all(shard_launches.values()):
        raise AssertionError(f"sharded scc launches {shard_launches}")
    emit({"phase": "mesh-elle", "txns": res["txn-count"],
          "edges": res["edge-count"], "shards": shards,
          "anomaly_types": res["anomaly-types"], "check_s": elle_s,
          "keyblock_layouts": c.get("scc.keyblock-layouts", 0),
          "scc_device_solves": c.get("scc.path.device", 0),
          "launches": shard_launches})
    solves = []
    scc_mism = 0
    graphs = []
    for name in ("list-append", "list-append-corrupted"):
        a = elle_device.DeviceAppendAnalysis(elle_hists[name])
        subsets = [None] + [np.isin(a.edge_ty, sub)
                            for sub in elle_device._SUBSETS[:-1]]
        graphs.append((name, a.flat.n, a.edge_src, a.edge_dst, a.edge_key,
                       subsets if name.endswith("corrupted") else [None]))
    n, src, dst = _spmd_graph(5)
    graphs.append(("spmd-seed5", n, src, dst, None, [None]))
    for name, n, src, dst, key, masks in graphs:
        for k in sorted({2, shards, 8}):
            edges = scc_mod.Edges(n, src, dst, ekey=key, mesh=[dev] * k)
            for i, mask in enumerate(masks if k == shards else [None]):
                want = _scc_one_device(n, src, dst, mask, dev)
                sync()
                c0 = _shard_launch_counts()
                with _HostWaits() as host:
                    t0 = time.perf_counter()
                    out = edges.solve_sharded(mask)
                    solve_s = time.perf_counter() - t0
                used = {key: v - c0[key]
                        for key, v in _shard_launch_counts().items()}
                mism = int(np.sum(out != want))
                scc_mism += mism
                rounds = int(out[n + 1])
                applies = used["scc_apply"]
                solves.append({
                    "graph": name, "shards": k, "subset": i, "nodes": n,
                    "live_edges": int(len(src) if mask is None
                                      else mask.sum()),
                    "ok": int(out[n]), "rounds": rounds,
                    "sweeps": int(out[n + 2]), "mismatches": mism,
                    "solve_s": solve_s,
                    "launches": {key: used[key] for key in (
                        "scc_sweep", "scc_sweep_compacting", "scc_apply",
                        "scc_retire")},
                    "sweeps_launched": applies,
                    "device_ops_per_sweep": (
                        (used["scc_sweep"] + applies) / applies
                        if applies else None),
                    # every wait for the card, by kind; the state reads
                    # are kshard.read_state's calls
                    "waits": host.waits,
                    "read_backs": sum(host.waits.values()),
                    "state_reads": used["state_reads"]})
                # the state once a chunk and the labels once, no other
                # wait (a round's own read of the nodes left, say)
                allowed = ({"Stream.synchronize": used["state_reads"],
                            "Tensor.cpu": 1} if on_card else {})
                if host.waits != allowed:
                    raise AssertionError(
                        f"a sharded solve waited for the card "
                        f"{host.waits}, not only at its {allowed}")
    emit({"phase": "mesh-scc", "solves": solves})
    emit({"phase": "mesh-scc-schedules",
          **_chunk_schedules(graphs[1][1:4], graphs[1][4], dev, shards)})
    if scc_mism:
        raise AssertionError(f"sharded scc differs from scc_kernel in "
                             f"{scc_mism} values")
    lap("scc")
    kernels = shard_kernel_timing(shard_rec, shard_launches, on_card)
    if any(x["max_abs_err"] for x in kernels):
        raise AssertionError("scc_shard kernels differ from their plain "
                             f"versions: {kernels}")
    lap("scc kernels")
    # (c) a 2-rank gloo group sharing the card
    with tempfile.TemporaryDirectory() as tmp:
        grp = _mesh_group(dev, Path(tmp), group_histories)
    emit({"phase": "mesh-group", **grp})
    if grp["mismatches"]:
        raise AssertionError(f"the 2-rank group differs from the "
                             f"in-process mesh: {grp['mismatches']}")
    lap("group")
    n_cards = torch.cuda.device_count() if on_card else 0
    emit({"phase": "mesh-nccl", "run": False, "cards": n_cards,
          "reason": f"NCCL across cards needs two or more cards; this "
                    f"machine has {n_cards}"})
    wall = time.perf_counter() - t_phase
    emit({"phase": "mesh", "seconds": seconds, "wall_s": wall,
          "budget_s": MESH_BUDGET_S})
    ens_bytes = sum(x["bytes"] for x in replays)
    ens_ops = sum(x["operations"] for x in replays)
    src_path = "jepsen_tpu_torch/gpu/kernels/csrc/scc_shard.cu"
    entries = [{
        "name": "wgl_search (ensemble, mesh form)",
        "route": "cuda",
        "source": "jepsen_tpu_torch/gpu/kernels/csrc/wgl_search.cu",
        "replaces": "jepsen_tpu/tpu/ensemble.py:54",
        "launches": per_path["mesh-ensemble"] + per_path["mesh-segmented"],
        "launches_per_path": dict(per_path),
        "shards": shards,
        "max_abs_err": max(x["max_abs_err"] for x in replays),
        "mismatches": ens_mism + reach_mism,
        "ms": (sum(x["kernel_ms"] for x in replays) if on_card else None),
        "plain_ms": sum(x["plain_ms"] for x in replays),
        "bound_ms": sum(x["bound_ms"] for x in replays),
        "bound_by": ("bytes" if ens_bytes / PEAK_BYTES_PER_S
                     >= ens_ops / PEAK_OPS_PER_S else "operations"),
        "library_ms": None,
        "main_path_launches": replays}]
    for x in kernels:
        entries.append({"route": "cuda", "source": src_path,
                        "replaces": "jepsen_tpu/tpu/scc.py:172",
                        "bound_by": "bytes", **x,
                        "ms": x["ms"] if on_card else None,
                        "device_ms": x["device_ms"] if on_card else None})
    return {"kernels": entries, "seconds": wall}


# ---------------------------------------------------------------------------
# 31. the run-time switches: the kernel build cache, certificates off,
# early exit off
# ---------------------------------------------------------------------------

SWITCHES_BUDGET_S = 60.0
CERT_ABSENT = {"v": 1, "absent": "extraction disabled (JEPSEN_TPU_CERTIFY=0)"}


@contextlib.contextmanager
def _env(name: str, value: str | None):
    """`name` set to `value` (None: unset) while the block runs."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def cache_launches(dev) -> dict:
    """Phase 31 (b)'s launches on small seeded inputs: wgl_search,
    scc_kernel, bank_reduce and one compacting and one later scc_shard
    sweep, each against its plain version on the same tensors.
    {kernel: {"mismatches", "launches"}}."""
    rng = np.random.default_rng(31)
    m = models.cas_register()
    encs = [encode(m, synth.register_history(300, n_procs=4, seed=s,
                                             crash_p=0.1))
            for s in range(4)]
    pb = wgl.PackedBatch(encs)
    packed, rs, s0 = pb.tensors(*pb.rows(
        [(i, e.init_state) for i, e in enumerate(encs)]), dev)
    kw = dict(W=32, F=64, max_iters=pb.M + 4, reach=False,
              crash_free=not pb.has_crashed)
    before = {"wgl_search": ws.launches, "scc": kscc.launches,
              "bank_reduce": kbank.launches,
              "scc_shard": kshard.sweep_launches}
    mism = {"wgl_search": sum(_mismatches(
        ws.wgl_search(packed, rs, s0, **kw),
        ws.wgl_search_reference(packed, rs, s0, **kw)))}
    n, E = 2000, 6000
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    args = _scc_tensors(src, dst, rng.random(E) < 0.8, dev)
    mism["scc"] = int((kscc.scc_labels(*args, n)
                       != kscc.scc_labels_reference(*args, n)).sum())
    mat = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40, (1000, 32))).to(
        dev)
    mism["bank_reduce"] = sum(_mismatches(kbank.bank_reduce(mat),
                                          kbank.bank_reduce_reference(mat)))
    i32 = dict(dtype=torch.int32, device=dev)
    edges = [args[0], args[1], args[2],
             torch.ones(n, dtype=torch.bool, device=dev)]
    state = {"x": torch.from_numpy(rng.integers(0, n, n)).to(**i32),
             "col": torch.zeros(n, **i32),
             "prop": torch.full((n,), kshard.NEUTRAL, **i32),
             "live": torch.zeros((E, 2), **i32),
             "cnt": torch.zeros(2, **i32),
             "st": torch.zeros(kshard.STATE, **i32)}
    plain = {k: v.clone() for k, v in state.items()}
    groups = [kshard.SweepGroup([kshard.sweep_plan(
        *edges, t["x"], t["col"], t["prop"], t["live"], t["cnt"], t["st"],
        False)]) for t in (state, plain)]
    mism["scc_shard"] = 0
    for compact in (True, False):
        kshard.scc_sweep(groups[0], compact)
        kshard.sweep_reference(groups[1], compact)
        # the live pairs agree up to their order
        k = int(plain["cnt"][0])
        pairs = [sorted(map(tuple, t["live"][:k].tolist()))
                 for t in (state, plain)]
        mism["scc_shard"] += int((state["prop"] != plain["prop"]).sum()) \
            + int((state["cnt"] != plain["cnt"]).sum()) \
            + int(pairs[0] != pairs[1])
    after = {"wgl_search": ws.launches, "scc": kscc.launches,
             "bank_reduce": kbank.launches,
             "scc_shard": kshard.sweep_launches}
    return {k: {"mismatches": mism[k], "launches": after[k] - before[k]}
            for k in mism}


def _cache_files(d: Path) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in sorted(d.iterdir())}


def cache_build_child() -> None:
    """Phase 31 (a), in a process of its own: build_all() into the cache
    JEPSEN_TPU_COMPILE_CACHE names."""
    info = build.build_all()
    print("CACHE-BUILD " + json.dumps({
        "seconds": info["seconds"], "libraries": info["libraries"],
        "build_dir": str(build.build_dir()),
        "nvcc": build.nvcc_version().strip().splitlines()[-1:]}),
        flush=True)


def cache_load_child() -> None:
    """Phase 31 (b), in a process of its own with no nvcc on PATH: every
    library is in the cache before it loads, each loads from there, the
    cache's files are untouched, and cache_launches() runs on the card."""
    d = build.build_dir()
    before = _cache_files(d)
    missing = [n for n in build.sources()
               if not build.library_path(n).exists()]
    if missing:
        raise AssertionError(f"not in the cache {d}: {missing}")
    loaded = {}
    for n in build.sources():
        build.load(n)
        loaded[n] = str(build.library_path(n))
    out = cache_launches(torch.device("cuda"))
    print("CACHE-LOAD " + json.dumps({
        "nvcc_on_path": shutil.which("nvcc"), "build_dir": str(d),
        "libraries": loaded, "files_unchanged": _cache_files(d) == before,
        "launches": out}), flush=True)


def _cache_child(fn: str, tag: str, cache: Path,
                 path: str) -> tuple[dict, float]:
    """Runs chip_smoke.<fn>() in a process of its own with the kernel
    build cache at `cache` and `path` as PATH; (the line it prints after
    `tag`, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke as cs; cs.{fn}()"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PATH=path,
                              JEPSEN_TPU_COMPILE_CACHE=str(cache)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{fn} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return json.loads(lines[0][len(tag):]), time.perf_counter() - t0


def _build_cache(on_card: bool, card: str) -> None:
    """(a) a cold build into a fresh cache; (b) the libraries loaded from
    it by a process without nvcc on PATH and launched against their plain
    versions. The card's alone: off it, there is no nvcc to build with."""
    if not on_card:
        return
    cache = Path(tempfile.mkdtemp(prefix="chip-smoke-cache-"))
    try:
        cold, cold_s = _cache_child("cache_build_child", "CACHE-BUILD ",
                                    cache, os.environ.get("PATH", ""))
        names = sorted(cold["libraries"])
        if names != build.sources() or any(
                Path(p).parent != cache for p in cold["libraries"].values()):
            raise AssertionError(f"the cold build did not land in {cache}: "
                                 f"{cold['libraries']}")
        emit({"phase": "switches", "part": "cold-build", "wall_s": cold_s,
              "build_s": cold["seconds"], "build_dir": cold["build_dir"],
              "libraries": [Path(p).name
                            for p in cold["libraries"].values()],
              "nvcc": cold["nvcc"], "card": card})
        no_nvcc = os.pathsep.join(
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if d and not (Path(d) / "nvcc").exists())
        warm, warm_s = _cache_child("cache_load_child", "CACHE-LOAD ",
                                    cache, no_nvcc)
        bad = {k: v for k, v in warm["launches"].items()
               if v["mismatches"] or v["launches"] < 1}
        if (warm["nvcc_on_path"] is not None or not warm["files_unchanged"]
                or warm["libraries"] != cold["libraries"] or bad):
            raise AssertionError(f"loading from the cache: {warm}")
        emit({"phase": "switches", "part": "cached-load", "wall_s": warm_s,
              "nvcc_on_path": warm["nvcc_on_path"],
              "files_unchanged": warm["files_unchanged"],
              "launches": warm["launches"], "card": card})
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def _certified_check(dev, model, hist, enc, target_len: int):
    """Phase 4's headline check with its certificate attached, as
    wgl.analysis(certify=True) attaches it: (result, wall s, launches)."""
    ws.launches = 0
    t0 = time.perf_counter()
    res = wgl.check_segmented(enc, target_len=target_len, device=dev)
    certify.attach_wgl(model, hist, enc, res)
    return res, time.perf_counter() - t0, ws.launches


def switches_path(dev, on_card: bool, hist, enc, benc,
                  target_len: int) -> dict:
    """Phase 31: the kernel build cache (the card only), then phase 4's
    headline check with certificates on and JEPSEN_TPU_CERTIFY=0, and its
    85%-corrupted twin through check_segmented with early exit on and
    JEPSEN_TPU_EARLY_EXIT=0."""
    t_phase = time.perf_counter()
    card = nvidia_smi_line() if on_card else "cpu"
    _build_cache(on_card, card)
    model = models.cas_register()
    with _env("JEPSEN_TPU_CERTIFY", None):
        on, on_s, on_n = _certified_check(dev, model, hist, enc, target_len)
    with _env("JEPSEN_TPU_CERTIFY", "0"):
        off, off_s, off_n = _certified_check(dev, model, hist, enc,
                                             target_len)
    cert_on = on.pop("certificate")
    cert_off = off.pop("certificate")
    if (on["valid?"] is not True or _norm(on) != _norm(off)
            or cert_off != CERT_ABSENT or "absent" in cert_on
            or on_n != off_n or (on_card and on_n == 0)):
        raise AssertionError(f"certificates off: {off} {cert_off} "
                             f"({off_n} launches) against {on} "
                             f"({on_n} launches)")
    emit({"phase": "switches", "part": "certify", "events": len(hist),
          "valid": on["valid?"], "certified_s": on_s, "uncertified_s": off_s,
          "certificate_s": on_s - off_s, "wgl_search_launches": [on_n, off_n],
          "certificate_off": cert_off, "card": card})
    twin = {}
    for name, value in (("on", None), ("off", "0")):
        with _env("JEPSEN_TPU_EARLY_EXIT", value):
            ws.launches = 0
            telemetry.reset()
            t0 = time.perf_counter()
            res = wgl.check_segmented(benc, target_len=target_len,
                                      device=dev)
            twin[name] = (res, time.perf_counter() - t0, ws.launches,
                          telemetry.get().counters().get(
                              "wgl.segmented.early-exit", 0))
    (a, a_s, a_n, a_e), (b, b_s, b_n, b_e) = twin["on"], twin["off"]
    if (a["valid?"] is not False or _norm(a) != _norm(b) or b_e
            or (on_card and not (a_n and b_n))):
        raise AssertionError(f"early exit off: {b} ({b_n} launches) "
                             f"against {a} ({a_n} launches)")
    emit({"phase": "switches", "part": "early-exit", "valid": a["valid?"],
          "failed_segment": a["failed-segment"],
          "wgl_search_launches": {"on": a_n, "off": b_n},
          "early_exits": {"on": a_e, "off": b_e},
          "check_s": {"on": a_s, "off": b_s}, "card": card})
    wall = time.perf_counter() - t_phase
    emit({"phase": "switches-total", "seconds": wall,
          "budget_s": SWITCHES_BUDGET_S, "card": card})
    return {"seconds": wall}


def run(dev: torch.device, n_headline: int = 500_000,
        target_len: int = 8192, min_segments: int = 40,
        n_cross: int = 10_000, n_elle: int = ELLE_TXNS,
        n_elle_cross: int = 20_000, n_bank: int = 500_000,
        n_ensemble: int = ENSEMBLE_N, chunk: int = ENSEMBLE_CHUNK,
        bad_member: int = ENSEMBLE_BAD, n_plain_rows: int = 128,
        n_slices: int = 64, n_adversarial: int = 100_000,
        n_adversarial_chain: int = 20_001,
        generated_sizes: dict | None = None,
        lifecycle_sizes: dict | None = None,
        fleet_sizes: dict | None = None,
        profiled_sizes: dict | None = None,
        sweep: dict | None = None,
        registry_sizes: dict | None = None,
        a3c_sizes: dict | None = None,
        cli_sizes: dict | None = None,
        suite_sizes: dict | None = None,
        mesh_sizes: dict | None = None) -> dict:
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # wall seconds of each group of phases, printed before the kernels
    # line: where the script's time limit goes
    seconds: dict = {}
    t_mark = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - t_mark[0]
        t_mark[0] = now

    # 2. build
    info = None
    if on_card:
        info = build.build_all()
        emit({"phase": "build", "seconds": info["seconds"],
              "libraries": info["libraries"],
              "ptxas": {n: _ptxas(info, n) for n in info["ptxas"]}})

    mark("2 build")
    # 3. kernel against its plain version on the same tensors
    total_mism = 0
    path_total = {"warp": 0, "block": 0, "warp_sorted": 0}
    for name, encs, rows, W, F, reach in _seeded_cases():
        pb = wgl.PackedBatch(encs)
        packed, rs, s0 = pb.tensors(*pb.rows(rows), dev)
        kw = dict(W=W, F=F, max_iters=pb.M + 4, reach=reach,
                  crash_free=not pb.has_crashed)
        sync()
        t0 = time.perf_counter()
        got = ws.wgl_search(packed, rs, s0, **kw)
        sync()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ws.wgl_search_reference(packed, rs, s0, **kw)
        sync()
        t_plain = time.perf_counter() - t0
        mism = _mismatches(got, want)
        total_mism += sum(mism)
        paths = _path_levels(packed, rs, s0, kw, on_card)
        for k in path_total:
            path_total[k] += paths[k] if paths else 0
        emit({"phase": "kernel-vs-plain", "case": name, "M": pb.M,
              "S": pb.S, "rows": len(rows), "entries": int(pb.m.sum()), "W": W,
              "F": F, "reach": reach, "crash_free": kw["crash_free"],
              "levels": int(want[-4]), "mismatches": mism,
              "path_levels": paths, "kernel_s": t_kernel,
              "plain_s": t_plain})
    emit({"phase": "kernel-paths", "seeded_cases": path_total})
    if on_card and not all(path_total.values()):
        raise AssertionError(f"the seeded cases did not run every level "
                             f"path of the kernel: {path_total}")
    total_mism += ensemble_against_plain(dev, on_card, n_plain_rows)
    if total_mism:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"in {total_mism} values")

    mark("3 kernel-vs-plain")
    # 4. the main path at full size: the 1M-event headline history
    t0 = time.perf_counter()
    hist = synth.register_history(n_headline, n_procs=5, seed=42)
    gen_s = time.perf_counter() - t0
    recorded = []
    launch_events = []
    original = ws.wgl_search

    def recording(packed, rs, s0, **kw):
        out = original(packed, rs, s0, **kw)
        # replayed below without the launch's own timing events, which
        # phase 23 (a) reads against the profiler's records
        recorded.append((packed, rs, s0, _untimed(kw), out))
        launch_events.append(kw.get("events"))
        return out

    runs = []
    ws.wgl_search = recording
    try:
        for rep in range(3):
            recorded.clear()
            launch_events.clear()
            ws.launches = 0
            telemetry.reset()
            profiler.reset()
            t0 = time.perf_counter()
            enc = encode(models.cas_register(), hist)
            t1 = time.perf_counter()
            res = wgl.check_segmented(enc, target_len=target_len,
                                      device=dev)
            sync()
            t2 = time.perf_counter()
            launches = ws.launches
            counters = telemetry.get().counters()
            if res is None or res["valid?"] is not True:
                raise AssertionError(f"headline history not valid: {res}")
            if res["segments"] < min_segments:
                raise AssertionError(f"only {res['segments']} segments")
            if on_card and launches == 0:
                raise AssertionError("the main path launched no kernel")
            runs.append({"encode_s": t1 - t0, "check_s": t2 - t1,
                         "events_per_s": len(hist) / (t2 - t0)})
            emit({"phase": "headline", "rep": rep, "events": len(hist),
                  "entries": enc.m, "segments": res["segments"],
                  "encode_s": t1 - t0, "check_s": t2 - t1,
                  "events_per_s": len(hist) / (t2 - t0),
                  "generate_s": gen_s,
                  "wgl_search_launches": launches,
                  "rows": counters.get("wgl.kernel.rows", 0),
                  "levels": counters.get("wgl.search.levels", 0),
                  "host_resolved_rows": counters.get(
                      "wgl.host-resolved-rows", 0),
                  "host_resolved_s": counters.get(
                      "wgl.host-resolved-ns", 0) / 1e9,
                  "pack_s": counters.get("profiler.pack.encode_ns", 0) / 1e9,
                  "h2d_s": counters.get("wgl.kernel.h2d_ns", 0) / 1e9,
                  "drain_s": counters.get("wgl.kernel.execute_ns", 0)
                  / 1e9,
                  "card": nvidia_smi_line() if on_card else "cpu"})
            headline_profile(profiler.get().records(), launch_events,
                             launches, on_card)
        main_launches = list(recorded)
        main_count = launches
    finally:
        ws.wgl_search = original

    bad, bad_idx = synth.corrupt_register_history(hist, at_frac=0.85)
    benc = encode(models.cas_register(), bad)
    t0 = time.perf_counter()
    bres = wgl.check_segmented(benc, target_len=target_len, device=dev)
    sync()
    bad_s = time.perf_counter() - t0
    if bres is None or bres["valid?"] is not False:
        raise AssertionError(f"corrupted history not invalid: {bres}")
    k = bres["failed-segment"]
    lo, hi = bres["segment-range"]
    start = bres["search-chain"]["chain"][k]
    reach = wgl.search_host_reach(benc.segment(lo, hi, init_state=start))
    if reach != 0:
        raise AssertionError(f"failed segment {k} reaches {reach:#x} "
                             f"from state {start} on the host")
    emit({"phase": "headline-corrupted", "bad_event": bad_idx,
          "failed_segment": k, "segment_range": [lo, hi],
          "check_s": bad_s, "host_reach_of_failed_segment": reach})

    mark("4 headline")
    # 5. slice cross-check: card against the CPU's plain kernel
    cross = synth.register_history(n_cross, n_procs=5, seed=7)
    cross_bad = synth.corrupt_register_history(cross, at_frac=0.5)[0]
    for label, h in (("valid", cross), ("invalid", cross_bad)):
        e = encode(models.cas_register(), h)
        t0 = time.perf_counter()
        on_dev = wgl.check_segmented(e, witness=True, device=dev)
        t1 = time.perf_counter()
        on_cpu = wgl.check_segmented(e, witness=True, device="cpu")
        t2 = time.perf_counter()
        if on_dev != on_cpu:
            raise AssertionError(f"{label}: card {on_dev} != cpu {on_cpu}")
        if on_dev["valid?"] is not (label == "valid"):
            raise AssertionError(f"{label} history judged {on_dev}")
        res = wgl.analysis(models.cas_register(), h, certify=True,
                           device=dev)
        certify.validate(h, res["certificate"])
        chk = linearizable({"model": models.cas_register(),
                            "device": dev}).check({}, h)
        if chk["valid?"] is not on_dev["valid?"]:
            raise AssertionError(f"checker disagrees: {chk['valid?']}")
        certify.validate(h, chk["certificate"])
        emit({"phase": "cross-check", "history": label, "events": len(h),
              "entries": e.m, "segments": on_dev.get("segments"),
              "card_s": t1 - t0, "cpu_plain_s": t2 - t1,
              "analyzer": res["analyzer"], "certified": True})

    mark("5 cross-check")
    # 6. the kernel on the main path's own launches: every launch timed,
    # and every launch held against the plain version, in one plain call
    # a search shape (plain_against: the waves' screens at M = 128 or
    # 256 and their main launches at M = 16,384), which keeps the script
    # inside its time limit (the plain version's time goes to its
    # per-level loop, not to the rows)
    per_launch = []
    max_err = 0
    groups: dict = {}
    for packed, rs, s0, kw, out in main_launches:
        nbytes, ops, bound_ms = _launch_bound(packed, rs, kw, out)
        kernel_ms = (_event_ms(lambda: original(packed, rs, s0, **kw),
                               reps=3) if on_card else None)
        paths = _path_levels(packed, rs, s0, kw, on_card)
        key = plain_group_key(packed, kw)
        groups.setdefault(key, []).append(len(per_launch))
        per_launch.append({
            "rows": int(rs.numel()), "segments": int(packed[0].shape[0]),
            "M": int(packed[0].shape[1]),
            "reach": kw["reach"], "levels": int(out[-4]),
            "kernel_ms": kernel_ms,
            "us_per_level": _us_per_level(kernel_ms, int(out[-4])),
            "path_levels": paths,
            "plain_call": list(groups).index(key),
            "bound_ms": bound_ms, "bytes": nbytes, "operations": ops})
    plain_calls = []
    for key, idx in groups.items():
        err, plain_ms = plain_against([main_launches[i] for i in idx],
                                      sync)
        max_err = max(max_err, err)
        plain_calls.append({"M": key[0], "launches": idx,
                            "rows": sum(per_launch[i]["rows"]
                                        for i in idx),
                            "levels": max(per_launch[i]["levels"]
                                          for i in idx),
                            "plain_ms": plain_ms, "max_abs_err": err})
    if max_err:
        raise AssertionError(f"main-path launches differ from the plain "
                             f"version by up to {max_err}")
    nbytes = sum(x["bytes"] for x in per_launch)
    ops = sum(x["operations"] for x in per_launch)
    kernel_ms = (sum(x["kernel_ms"] for x in per_launch)
                 if on_card else None)
    emit({"phase": "headline-plain-replays", "launches": len(per_launch),
          "plain_calls": plain_calls})

    mark("6 headline launches")
    # 7. scc and bank_reduce against their plain versions
    mism = kernels_against_plain(dev, on_card)
    if mism:
        raise AssertionError(f"scc/bank_reduce disagree with their plain "
                             f"versions in {mism} values")
    adversarial = scc_adversarial(dev, on_card, n_adversarial,
                                  n_adversarial_chain)
    mark("7 scc/bank vs plain, adversarial")
    # 8-10. the Elle and bank paths; 11. their kernels on their launches
    scc_recorded, scc_per_check, elle_direct = elle_main_path(
        dev, on_card, n_elle)
    la_bad_cross = elle_cross_check(dev, n_elle_cross)
    bank_recorded, bank_launches, bank_direct = bank_path(dev, on_card,
                                                          n_bank)
    scc_entry = scc_timing(scc_recorded, scc_per_check, on_card, info)
    scc_entry["convergence_launch"] = adversarial
    bank_entry = bank_timing(bank_recorded, bank_launches, on_card, info)

    mark("8-11 elle, bank")
    # 12-14. the batch path at BASELINE config 5's size
    t0 = time.perf_counter()
    hists = [ensemble_hist(i) for i in range(n_ensemble)]
    emit({"phase": "ensemble-generate", "histories": n_ensemble,
          "events": sum(len(h) for h in hists),
          "generate_s": time.perf_counter() - t0})
    ens = ensemble_path(dev, on_card, hists, chunk, bad_member)
    per_path = {"headline": main_count, **ens["per_path"]}
    ind_launches, ind_direct = independent_path(dev, on_card, hists,
                                                bad_member)
    per_path.update(ind_launches)
    per_path["check_slices"] = slices_path(dev, on_card, hists, n_slices)

    # the ensemble launches replayed: the streamed run's chunks (B1) and
    # the sharded launch (B2)
    calls, drains = ens["recorded"]["streamed"]
    streamed = [_replay(c, on_card) for c in calls]
    for x, d in zip(streamed, drains):
        x["in_run_device_ms"] = d["device_ms"]
    sharded = [_replay(c, on_card)
               for c in ens["recorded"]["analysis_batch_sharded"][0]]
    emit({"phase": "ensemble-launches", "streamed": streamed,
          "sharded": sharded})
    max_err = max([max_err] + [x["max_abs_err"] for x in streamed])
    sh_err = max(x["max_abs_err"] for x in sharded)
    if max_err or sh_err:
        raise AssertionError(f"ensemble launches differ from the plain "
                             f"version by up to {max(max_err, sh_err)}")
    sh_bytes = sum(x["bytes"] for x in sharded)
    sh_ops = sum(x["operations"] for x in sharded)
    mark("12-15 ensemble, independent, slices")
    # 16-18. checkpoint-and-extend on a cut of the headline's shape
    ext_hist = synth.register_history(min(EXTEND_OPS, n_headline),
                                      n_procs=5, seed=42)
    ext_bad = synth.corrupt_register_history(ext_hist, at_frac=0.85)[0]
    ext = extend_path(dev, on_card, ext_hist, ext_bad)
    per_path.update(ext["launches"])
    per_path.update(resumable_segmented(dev, on_card, enc, target_len))
    per_path.update(checker_extend(dev, on_card, ext_hist))
    del ext_hist, ext_bad
    mark("16-18 extend, checkpoint")
    # 19. the composed checker stacks, with the reports of invalid results
    composed = composed_path(dev, on_card, elle_direct, la_bad_cross,
                             bank_direct, ind_direct, bad_member)
    per_path.update({k: v for k, v in composed.items()
                     if k.startswith("composed-register")})
    scc_composed = {k: v for k, v in composed.items()
                    if k.startswith("composed-list-append")}
    scc_entry["launches"] += sum(scc_composed.values())
    scc_entry["launches_per_check"].update(scc_composed)
    bank_composed = {k: v for k, v in composed.items()
                     if k.startswith("composed-bank")}
    bank_entry["launches_per_check"] = {"bank": bank_entry["launches"],
                                        **bank_composed}
    bank_entry["launches"] += sum(bank_composed.values())
    mark("19 composed")
    # 20. a generated test: the port's interpreter records each history
    generated = generated_path(dev, on_card, generated_sizes)
    per_path.update(generated["wgl_search"])
    scc_entry["launches"] += sum(generated["scc"].values())
    scc_entry["launches_per_check"].update(generated["scc"])
    bank_entry["launches"] += sum(generated["bank_reduce"].values())
    bank_entry["launches_per_check"].update(generated["bank_reduce"])
    mark("20 generated")
    # 21. the test lifecycle: core.run, analysed on the card
    lifecycle = lifecycle_path(dev, on_card, lifecycle_sizes)
    per_path.update(lifecycle["wgl_search"])
    scc_entry["launches"] += sum(lifecycle["scc"].values())
    scc_entry["launches_per_check"].update(lifecycle["scc"])
    bank_entry["launches"] += sum(lifecycle["bank_reduce"].values())
    bank_entry["launches_per_check"].update(lifecycle["bank_reduce"])
    mark("21 lifecycle")
    # 22. checking-as-a-service: many tenants' streams in shared launches
    fleet_launches = fleet_path(dev, on_card, fleet_sizes)
    per_path.update(fleet_launches["wgl_search"])
    scc_entry["launches"] += sum(fleet_launches["scc"].values())
    scc_entry["launches_per_check"].update(fleet_launches["scc"])
    mark("22 fleet")
    # 23. the profiler on the card: profiled whole runs, the reports,
    # the dispatch thresholds; (a) ran with phase 4, (e) and (f) below
    prof_launches = profiler_path(dev, on_card,
                                  fleet_launches["flightrec_records"],
                                  profiled_sizes, sweep)
    per_path.update(prof_launches["wgl_search"])
    scc_entry["launches"] += sum(prof_launches["scc"].values())
    scc_entry["launches_per_check"].update(prof_launches["scc"])
    bank_entry["launches"] += sum(prof_launches["bank_reduce"].values())
    bank_entry["launches_per_check"].update(prof_launches["bank_reduce"])
    mark("23 profiler")
    # 24. every workload of the registry, its twins, kafka at depth
    registry = registry_path(dev, on_card, registry_sizes)
    per_path.update(registry["wgl_search"])
    scc_entry["launches"] += sum(registry["scc"].values())
    scc_entry["launches_per_check"].update(registry["scc"])
    bank_entry["launches"] += sum(registry["bank_reduce"].values())
    bank_entry["launches_per_check"].update(registry["bank_reduce"])
    mark("24 registry")
    # 25. whole tests over the default stack's layers, docker and k8s,
    # under lazyfs, kill, clock and membership faults
    transports = transports_path(dev, on_card, a3c_sizes)
    per_path.update(transports["wgl_search"])
    scc_entry["launches"] += sum(transports["scc"].values())
    scc_entry["launches_per_check"].update(transports["scc"])
    mark("25 transports")
    # 26. the command line: test, analyze (--resume), a twin, the
    # readers, the fleet and the web UI through python -m jepsen_tpu_torch
    cli = cli_path(dev, on_card, cli_sizes)
    per_path.update(cli["wgl_search"])
    scc_entry["launches"] += sum(cli["scc"].values())
    scc_entry["launches_per_check"].update(cli["scc"])
    bank_entry["launches"] += sum(cli["bank_reduce"].values())
    bank_entry["launches_per_check"].update(cli["bank_reduce"])
    mark("26 cli")
    # 27. the database suites (A10a) on in-memory databases
    suite_launches = suites_path(dev, on_card, suite_sizes)
    per_path.update(suite_launches["wgl_search"])
    scc_entry["launches"] += sum(suite_launches["scc"].values())
    scc_entry["launches_per_check"].update(suite_launches["scc"])
    bank_entry["launches"] += sum(suite_launches["bank_reduce"].values())
    bank_entry["launches_per_check"].update(suite_launches["bank_reduce"])
    mark("27 suites")
    # 28. the database suites (A10b) on in-memory databases
    suite_launches = suites_path(dev, on_card, suite_sizes, phase=28)
    per_path.update(suite_launches["wgl_search"])
    scc_entry["launches"] += sum(suite_launches["scc"].values())
    scc_entry["launches_per_check"].update(suite_launches["scc"])
    bank_entry["launches"] += sum(suite_launches["bank_reduce"].values())
    bank_entry["launches_per_check"].update(suite_launches["bank_reduce"])
    mark("28 suites a10b")
    # 29. the static analysis over the kernels' launches
    lint_path(dev, on_card)
    mark("29 lint")
    # 30. the multi-device form: meshes of shards sharing the card, the
    # sharded SCC, a 2-rank gloo group
    mesh = mesh_path(dev, on_card, hists, min(EXTEND_OPS, n_headline),
                     elle_direct["histories"], **(mesh_sizes or {}))
    mark("30 mesh")
    # 31. the kernel build cache, certificates off, early exit off
    switches_path(dev, on_card, hist, enc, benc, target_len)
    mark("31 switches")

    by_path = {k: (sum(v) if isinstance(v, list) else v)
               for k, v in per_path.items() if k != "ensemble-sharded (B2)"}
    kernels = [{
            "name": "wgl_search",
            "route": "cuda",
            "source": "jepsen_tpu_torch/gpu/kernels/csrc/wgl_search.cu",
            "replaces": "jepsen_tpu/tpu/wgl.py:518",
            "launches": sum(by_path.values()),
            "launches_per_path": per_path,
            "max_abs_err": max_err,
            "mismatches": total_mism,
            "ms": kernel_ms,
            "plain_ms": sum(x["plain_ms"] for x in plain_calls),
            "plain_calls": plain_calls,
            "bound_ms": sum(x["bound_ms"] for x in per_launch),
            "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                         >= ops / PEAK_OPS_PER_S else "operations"),
            "library_ms": None,
            "timed_path": "headline",
            "extend": {"fresh": ext["fresh"], "resumed": ext["resumed"]},
            "us_per_level": _us_per_level(
                kernel_ms, sum(x["levels"] for x in per_launch)),
            "main_path_launches": per_launch,
            "ensemble_streamed_launches": streamed,
        }, {
            "name": "wgl_search (ensemble, one-device form)",
            "route": "cuda",
            "source": "jepsen_tpu_torch/gpu/kernels/csrc/wgl_search.cu",
            "replaces": "jepsen_tpu/tpu/ensemble.py:54",
            "launches": per_path["ensemble-sharded (B2)"],
            "max_abs_err": sh_err,
            "mismatches": sum(x["mismatches"] for x in sharded),
            "ms": (sum(x["kernel_ms"] for x in sharded) if on_card
                   else None),
            "plain_ms": sum(x["plain_ms"] for x in sharded),
            "bound_ms": sum(x["bound_ms"] for x in sharded),
            "bound_by": ("bytes" if sh_bytes / PEAK_BYTES_PER_S
                         >= sh_ops / PEAK_OPS_PER_S else "operations"),
            "library_ms": None,
            "main_path_launches": sharded,
        }, scc_entry, bank_entry] + mesh["kernels"]
    # 23 (e) the ledger, (f) the kernels line still lists every kernel
    ledger_entries(kernels, runs[-1]["check_s"], on_card)
    names = {k["name"] for k in kernels}
    if not {"wgl_search", "scc", "bank_reduce", "scc_sweep", "scc_apply",
            "scc_retire"} <= names:
        raise AssertionError(f"the kernels line lists {sorted(names)}")
    return {
        "kernels": kernels,
        "headline_runs": runs,
        "phase_seconds": seconds,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    nvcc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "--version"], capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "capability": list(cap),
          "nvcc": nvcc[-1] if nvcc else None, "python": sys.version})
    if cap != (9, 0):
        raise AssertionError(f"compute capability {cap}, want (9, 0)")
    summary = run(torch.device("cuda"))
    emit({"phase": "seconds", **summary["phase_seconds"],
          "card": card})
    emit({"kernels": summary["kernels"]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
