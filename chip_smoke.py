#!/usr/bin/env python3
"""Drive the PyTorch port's hist-GBDT paths on one CUDA card and check them.

Run from the root of a checkout, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles the native ingest engine
   (``dmlc_core_tpu_torch/csrc/native/*.cc``) with g++ into
   ``build/native/`` before any worker process starts, then
   ``dmlc_core_tpu_torch/csrc/hist.cu`` with nvcc, and prints both builds'
   seconds and the ptxas report; the probe (``kernels_available``) checks
   K1, K2 and K3 on a small case;
3. kernels: at 2,000,000 rows x 28 features x 256 bins and 1, 32 and 256
   nodes, K2 (``grad_hist_cuda``, which launches K3's kernel: one K3
   launch and no K1 launch a call) and K3 (``grad_hist_fused_cuda``)
   against their plain PyTorch version on the card (rtol 1e-4, atol 1e-3:
   f32 sums in another order), bitwise repeatability of two launches (and
   of the plain version, whose segment sums are atomics-free), and
   CUDA-event times beside the bound and one ``index_add_`` over
   precomputed flat ids (the scatter formulation); at 32 nodes also both
   on the column window 14..27 read in place (row stride 28, offset 14)
   against the plain version on a copy, bitwise over two launches; K1
   (``hist_matmul_cuda``) at 1 and 32 nodes on the W the reference's K2
   would build, and alone on ragged shapes
   (1,000,003 rows, 48 weight rows, 255 bins with bins out of range, uint8
   on all columns and int32 on the window 14..27), and K3
   (``grad_hist_fused_cuda``) alone on ragged shapes (1,000,003 rows; 1, 5,
   13, 37 and 256 nodes with node ids in [-2, n + 3); 255 bins with bins
   out of range in int32; windows 14..27 and 2..4; tensors at an offset in
   their allocations), each against its plain version, bitwise over two
   launches and with its launches counted; the K1, K2 and K3 lines also
   give the dense tensor-core time 2*M*B*F*nbins at 989 TFLOP/s beside
   the bound (for K2 and K3, M = 16 A rows per 8-node m-tile computed);
4. GBDT: ``fit_binned`` (10 rounds, depth 6, 256 bins, learning rate 0.3)
   on 2,000,000 HIGGS-shaped rows binned to the uint8 wire, twice through
   ``hist_method="auto"`` (K2) and once through ``"pallas_fused"`` (K3),
   with launch counts read around that run: K3's kernel on every level of
   the three fits, K1 never, and the ``"auto"`` fit's ensemble and margin
   bitwise equal to the ``"pallas_fused"`` fit's; ``predict`` on 200,000
   held-out rows; two ``"scatter"`` fits of the same rows (segment sums,
   no kernel), bitwise equal; then a 200,000-row fit on the card against
   the same fit on the CPU with the plain versions;
5. distributed GBDT: four worker processes of this script share the card
   as a 2 x 2 data x model mesh over gloo (NCCL refuses two ranks on one
   card).  Each takes the 1,000,000 rows of its data coordinate of the
   phase-4 shape, makes the bin edges with the distributed quantile sketch,
   bins them to uint8 and fits ``GBDT(model_axis="model")`` with
   ``"pallas"`` and ``"pallas_fused"``, so every level runs K4 (K3's
   windowed kernel on the rank's 14 columns, the data all-reduce, the model
   all-gather).  All ranks must hold the same edges and ensembles, the two
   methods' ensembles must be bitwise equal on every rank, K4 must
   launch on every level, the global accuracy must reach 0.8, and a
   single-process card fit with the same edges must grow the same first
   tree.  Inside the workers K4 at 32 nodes is held against the plain
   histogram of the whole global array and timed beside its bound and the
   collectives.  Then one worker with world size 1 over NCCL fits 200,000
   rows with ``model_axis`` and must match the plain card fit bitwise;
6. ingest: the first 500,000 of phase 4's training rows are written as
   libsvm text (``%.9g``, so every float32 survives) and the first 200,000
   as CSV with the label column, then parsed with the port's threaded
   ``create_parser`` (default thread count; the native engine) and
   ``dense_batches(8192)``: the parsed features and labels must be bitwise
   the written arrays and the native parse calls (read from
   ``native_bridge.ENGINE_CALLS``) more than 0; both files are parsed again
   with the numpy engine (``DMLC_TPU_DISABLE_NATIVE``), whose merged
   columns must be bitwise the native engine's, and both engines' seconds,
   MB/s and rows/s are printed.  Edges on the first 50,000 parsed rows,
   ``binned_batches`` (the wire must be bitwise phase 4's
   ``binner.transform`` of the same rows), ``DeviceFeedLoader`` through its
   pinned ring into one preallocated tensor on the card (bitwise
   ``torch.from_numpy(wire).to(card)``), timed beside a synchronous
   pageable ``.to(card)``, then ``fit_binned`` with labels only, as phase 4
   fits: its ensemble and margin must be bitwise the phase-4 model's fit of
   the same rows from memory, with K3's kernel on every level and K1 never
   (counts set to 0 before the parse, read after the fit, printed on a line
   of their own).  Last, ``python -m
   dmlc_core_tpu_torch.examples.train_gbdt`` on the libsvm file must exit 0
   with train accuracy >= 0.8.  Writing and parsing all 2,000,000 rows,
   twice with the CLI, would not fit phase 6's ~120 s;
7. serve: phase 4's warm ``"auto"`` model is saved with ``serving_state``
   through ``CheckpointManager.save(1)`` (manifest published) under
   ``build/chip_smoke_serve/``, loaded with ``build_runtime("gbdt", 28,
   checkpoint=...)`` on the card (its ``predict_float`` on 8,192 held-out
   rows within 1e-6 of the CPU plain version from the same blob) and
   served by a ``ScoringServer`` on 127.0.0.1, port 0 (``max_batch`` 64,
   ``max_delay_ms`` 2) with a ``CheckpointWatcher`` on the directory.
   Eight client threads, each on a keep-alive connection, send 1,000
   requests of 1-64 of those rows (latency p50/p95/p99, requests/s and
   rows/s printed); then they keep sending while 2 rounds are appended on
   the card (``append_rounds``, K3's kernel) and published as step 2,
   until 500 answers came from step 2 (about 1,500 requests in all: at
   the ~50 requests/s the card's scoring path serves, 2,000 would not fit
   the phase's ~40 s).  Every answer must be 200 and bitwise the
   ``predict_float`` of the version that answered it, both versions must
   answer, ``/healthz`` must report version 2 (the seconds from publish
   to the first step-2 answer printed), a 27-wide row must get the
   structured 400, and step 2's ``predict_float`` must be within 1e-6 of
   the CPU plain version from its blob.  It prints the warmup seconds and
   the direct ``predict`` time of 64 and 65,536 rows, builds the seeded
   ``build_runtime("gbdt", 28)`` (a 256-row fit on the card), drains the
   server and reads the K3 launches of the phase (>= 12 + 24).  Last,
   ``python -m dmlc_core_tpu_torch.serve --model gbdt --checkpoint
   <step 1> --num-feature 28 --port 0`` as a subprocess: the ``serving
   ... on <url>`` line, one POST bitwise equal to the in-process step-1
   answer, SIGTERM, and ``serve: shut down cleanly`` with exit 0;
8. train: (8a) ``fit_with_eval`` on phase 4's 2,000,000 rows with its
   200,000 held-out rows: 10 rounds bitwise phase 4's ``"auto"`` fit, each
   round's eval loss within 1e-6 of ``staged_losses``; 40 rounds, then
   40 with ``early_stopping_rounds=3`` (on ``loss`` and on ``error`` at
   learning rate 0.3, on ``loss`` at 1.5 and 2, which overshoot, so at
   least one fit must stop early), whose kept trees must be bitwise the
   first ``best_round + 1`` of the 40;
   (8b) ``GBDTClassifier(device="cuda")`` on the 2,000,000 raw rows:
   held-out accuracy >= 0.8, ``feature_importances_`` summing to 1,
   ``save_model`` -> ``load_model`` with bitwise ``predict_proba``; (8c)
   a ``TrainerDaemon`` on the card over a spool of 8 libsvm files of
   31,250 of phase 4's rows (2 rounds a batch, a publish every 4 rounds,
   a ``_DONE`` sentinel; at 62,500 rows a file the phase took 80 s on an
   H100), its steps served live by a ``ScoringServer`` with a
   ``CheckpointWatcher`` while 8 client threads send requests (the spool
   hands out the next batch only after the newest step answered 20 of
   them): every answer 200 and bitwise the ``predict_float`` of its
   version, at least 3 versions, the final step 16 trees at cursor 8; the
   seconds of parsing, binning, rounds, the margin recompute and
   publishing, rounds/s, and publish -> first answer of each step; (8d)
   ``python -m dmlc_core_tpu_torch.train`` over the same spool, killed by
   a ``DMLC_FAULT_PLAN`` exit 43 at ``train.round`` after 9 rounds, then
   rerun as ``--incarnation 1`` with one torn publish: it must resume
   from step 2, count one rejection, finish, and end bitwise equal to
   8c's final step; (8e) a port ``ShardLeaseCoordinator`` over 200,000
   libsvm rows in 8 units feeding one daemon through ``FleetSource``:
   every unit committed once, 200,000 rows trained.  Each part counts
   K3's launches (6 a round) and K1's (none);
9. serving tier: phase 4's model saved as step 1 under
   ``build/chip_smoke_tier/``; five processes start at once, each its own
   CUDA context on the card: ``python -m dmlc_core_tpu_torch.serve
   --transport evloop`` on that step, a ``ReplicaFleet`` of 3 GBDT
   replicas watching its directory (admission bound 256 KiB a replica),
   and one linear and one MLP replica (the JAX defaults,
   ``hidden="32,32"``, ``num_class=2``) on checkpoints of seeded params.
   (9a) ``run_churn``: 1,000 idle keep-alive connections and 32 active
   workers for 5 s with zero refused, reset or dropped; 64 requests of
   1-64 held-out rows, 8 pipelined in one write, answered in order, each
   bitwise ``predict_float`` and byte-identical to an in-process
   threaded server's answer; the CLI's clean exit.  (9c) 64 rows through
   a router to the linear and the MLP replica, twice: bitwise equal, and
   within 1e-6 (linear) and 1e-5 (MLP, bf16) of the CPU plain version of
   the same checkpoint; an f32 forward of the MLP's params must read
   more than 1e-5 from the bf16 CPU version, so the gate tells bf16 from
   f32.  (9b) a ``RouterServer`` over the 3 GBDT replicas in a process
   of its own, as the CLI runs it with ``--replicas``, but over replicas
   with an admission bound of 256 KiB, not the CLI's 64 MiB default
   (with 64 MiB, 3x overload queues past the router's 5 s try deadline
   and times out: ROADMAP.md §1 item 4e); ``run_load`` open-loop
   from this process (1-64 held-out rows a request) at phase 7's
   measured requests/s for 10 s, then at 3 times that for 75 s while
   replica 1 is SIGKILLed at 3 s, relaunched by the fleet's monitor, and
   every replica restarts in turn (``rolling_restart``) inside the load:
   zero crashed, refused, timed out or wrong answers (every 200 bitwise
   ``predict_float`` of the version that answered), every non-200 a
   structured 503, the router seeing replica 1 ejected and healthy
   again, hedges fired; (9d) while the fleet takes load at phase 7's
   rate, 2 rounds are appended on the card and published as step 2:
   every replica swaps, both versions answer, every answer bitwise its
   version's, the seconds from publish to the last replica's first
   step-2 answer printed, >= 12 K3 launches in this process (scoring
   launches none);
10. sampling and the entry points: (10a) phase 4's fit with subsample and
   colsample_bytree/bylevel/bynode at 0.8, twice (bitwise equal, K3 on
   every level, held-out accuracy >= 0.8, seconds and rows/s beside
   phase 4's unsampled fit); the card's row weights and masks bitwise
   the CPU's draws for the same (seed, round, class), kept-row shares
   within 0.8 +- 0.005, one tree's draws timed; ``append_rounds(None,
   ...)`` twice over 5 rounds and ``fit_with_eval`` bitwise the sampled
   ``fit_binned``; the first sampled tree of a 200,000-row fit equal on
   the card and on the CPU; a 3-class relabel of 200,000 rows at
   subsample 0.8, twice bitwise; (10b) 200,000 of phase 4's rows (and
   50,000 held-out rows) as libsvm through the port's ``train_gbdt``
   (``--eval-data --early-stopping-rounds 3``; ``--checkpoint-dir``),
   ``train_logreg`` (sparse, ``--checkpoint``) and ``train_mlp``
   (``--checkpoint-dir``) as subprocesses, each exiting 0, then their
   reruns, which must resume from the latest step; and
   ``graft_entry.entry()`` on the card within 1e-6 of its CPU run;
11. multi-worker training: the first 500,000 of phase 4's training rows as
   libsvm (``%.9g``), then ``python -m dmlc_core_tpu_torch.tracker.submit
   --cluster local --num-workers 2`` over this script as ``--worker cli
   DIR`` (the two ranks share the card over gloo; outputs in
   ``build/chip_smoke_multiworker/``): each rank runs the CLIs'
   ``main(argv)`` in turn, each on a store port of its own, and saves its
   model, launch counts, printed lines and the seconds of every histogram
   all-reduce.  (11a) ``train_gbdt`` at full width (28 features, 256
   bins, depth 6, 10 rounds, ``"auto"``, 250,000 rows a rank): ensembles
   bitwise equal on both ranks, the same ``over 2 workers`` line on both,
   120 K3 launches (warm-up plus fit) and 0 K1 a rank, train accuracy >=
   0.8 and within 0.005 of an in-process world-1 fit of the same rows
   from memory; the warm-up fit's first tree, level by level (1-32
   nodes), its all-reduced (G, H) within rtol 1e-4, atol 1e-3 of
   ``grad_hist_ref`` of both ranks' rows; a world-1 fit of both ranks'
   padded rows and merged bins with every tree's splits equal and leaf
   values within 1e-4; the world-2 fit's seconds and rows/s beside the
   world-1 fit's, and the all-reduce's seconds and share.  (11b)
   ``train_logreg --form sparse`` and ``train_mlp``, 2 epochs: params
   bitwise equal on both ranks, rank 0's loss falling, and rank 0's first
   two steps against world-1 steps over both ranks' batches (logreg: new
   params and loss within 1e-5 relative; MLP: the all-reduced gradients
   within 2e-2 of the largest, the bf16 bound, and the loss within
   1e-5).  Last, ``python -m
   dmlc_core_tpu_torch.examples.train_gbdt`` itself in 2 workers on the
   first 100,000 rows: exit 0 and the same line from both ranks;
12. recordio and the split engines: phase 4's 2,000,000 training rows as
   one record each (28 uint8 bins, then the float32 label) written with
   ``IndexedRecordIOWriter.write_records`` (the batched native framing)
   with its index.  (12a) ``create_input_split(type="recordio")`` in 4
   parts through the native engine and the Python engine: each part's
   records equal between them, and the parts, decoded in order, bitwise
   phase 4's wire and labels (disjoint and exhaustive); the wire fed to the
   card and ``fit_binned``: ensemble and margin bitwise phase 4's
   ``"auto"`` fit, K3's kernel on every level, K1 never.  (12b)
   ``indexed_recordio`` with ``shuffle=True``, ``batch_size=8192`` and a
   fixed seed through the native span reader: the seed's shuffle of every
   record once (the order of ``random.Random(111 + seed)``), then the
   second epoch's first 200,000 records, planned over all 2,000,000, in
   the seed's second shuffle; on a file of the first 200,000 records, two
   epochs through each engine: the same orders from both, each the seed's
   shuffle, the second unlike the first.  (12c) a
   ``#cachefile`` recordio split: epoch 2, the replay, bitwise epoch 1,
   both engines.  (12d) ``InputSplitShuffle`` with 4 shuffle parts: every
   record once, not in file order, both engines in the same order.  (12e)
   200,000 rows as libfm with fields (7 columns a field) through both
   parsers: columns bitwise equal, and to the written rows.  Each read's
   seconds and MB/s are printed;
13. training from object storage: a strict SigV4 mock store
   (``tests/mock_s3.py``) on loopback in this process is the bucket, the
   environment carries the credential contract (``AWS_*``,
   ``S3_ENDPOINT``) and the port's telemetry is on for the phase.  The
   data is phase 6's 500,000-row libsvm file (kept under
   ``build/chip_smoke_ingest/``, or written again the same way; the cut
   from 2,000,000 rows is phase 6's own).  (13a) ``create_stream(s3://...,
   "w")`` uploads it at ``DMLC_S3_WRITE_BUFFER_MB=64``, a multipart upload
   of 4 parts; stat and list agree with its size, and
   ``create_stream_for_read`` reads it back byte-equal.  (13b)
   ``create_parser`` over the object twice: by default (the Python split
   engine, ``native_bridge.ENGINE_CALLS`` split count 0) and with
   ``DMLC_TPU_NATIVE_REMOTE=1`` (the native engine through the read-at
   callback, ring 8, batched pop; count above 0); both merged columns
   bitwise phase 6's local parse, each run's seconds, MB/s, rows/s, GETs
   and read bytes (the ``dmlc_filesystem_*`` series) printed.  (13c) the
   parse binned and fed as in phase 6, then ``fit_binned``: ensemble and
   margin bitwise phase 6's ingest-path fit, K3's kernel on every level,
   K1 never (counts set to 0 before 13b, read after the fit); the port's
   ``train_gbdt`` CLI on a 100,000-row object with ``--checkpoint-dir
   s3://...`` and ``--checkpoint-every 5``, then again: the rerun resumes
   from the bucket's step 5, its final ensemble read back from the bucket
   is bitwise the first run's, and the bucket's step is bitwise its first
   5 trees.  (13d) ``create_row_block_iter("s3://...#s3://.../train.cache")``
   with ``DMLC_CACHE_REMOTE=1`` and a fresh ``DMLC_CACHE_LOCAL_DIR``:
   epoch 1 parses, builds the v2 cache and publishes it (one publish
   counted), epoch 2 replays it from mmap bitwise epoch 1 and 13b's
   columns; an iterator with another fresh directory (another host)
   fetches the published cache with no parse (one remote hit) and its
   blocks are bitwise epoch 1's.  (13e) a second store that cuts every 7th
   GET off mid-body: a 16 MiB object read whole twice comes back
   byte-equal, with at least one retry counted.  No ``hdfs://``: the
   card machine has no ``pyarrow``;
14. tensor and sequence parallelism, ranks sharing the card over gloo
   (correctness and transport cost, no scaling figure).  (14a)
   ``graft_entry.dryrun_multichip(8)``: 8 ranks through the port's
   launcher (data 4 x model 2, the hybrid dcn_data 2 x ici_data 2 x
   model 2 whose margin must equal the flat mesh's within 1e-5), every
   section of the reference's dryrun; on every rank K4 at the dryrun's
   shapes (16 bins, 4 columns a rank) on the flat and the hybrid mesh's
   rows, within rtol 1e-4, atol 1e-3 of its plain version on the same
   rows and of ``grad_hist_ref`` of all rows (launches not counted);
   rank 0's K4 launches must be above 0 (counted from 0 at the rank's
   start).  (14b) 4 ranks of this script
   (``--worker seq DIR``) on an ``sp`` mesh: ring and Ulysses attention
   at B = 1, L = 8,192, H = 8, D = 64, f32, causal and not, against
   ``reference_attention`` of the whole sequence (one rank at a time:
   2.1 GB of scores) at rtol 2e-4, atol 2e-5, and the dq, dk, dv of
   ``sum(out**2)`` within 1e-4 of max|g_ref|; CUDA-event forward and
   forward+backward ms, and the K/V rotations' and all-to-alls' ms alone
   (medians of 5 turns with the forward they belong to).  (14c) ``--worker tp DIR`` in 4 workers of the port's launcher:
   ``ring_allreduce`` against ``psum`` and ``allreduce_bandwidth_gbps``
   (64 MiB; gloo through host memory, no interconnect figure); two f32
   steps of ``MLP(model_axis="model")``; ``train_mlp.main`` with
   ``--model-parallel 2`` on phase 6's 500,000-row libsvm file (kept
   under ``build/chip_smoke_ingest/`` by phases 6 and 13, or written
   again the same way; removed after 14c; the default ``--hidden 128,128``,
   2 epochs, a ``--checkpoint-dir``): the model line's blocks bitwise
   equal across the data line and the checkpoint's gathered params on
   every rank, losses falling, the first two steps' all-reduced
   gradients gathered against world-1 steps over the same global batches
   (bf16 within 2e-2 of the largest, f32 within 1e-5), the checkpoint
   restored into a world-1 ``MLP`` predicting bitwise what the run's
   gathered params predicted; then ``python -m
   dmlc_core_tpu_torch.examples.train_mlp --model-parallel 2 --epochs 3``
   in 4 workers, which must resume from epoch 1;
15. the substrate, the parse process pool and columnar ingest.  (15a)
   phase 6's 500,000-row libsvm file (written again the same way; phase
   14c removed it) parsed with the numpy engine
   (``DMLC_TPU_DISABLE_NATIVE``) through the thread pool
   (``DMLC_PARSE_PROC=0``), then twice through 4 worker processes
   (``DMLC_PARSE_PROC=4``; the first parse starts the spawned workers,
   each of which re-imports this script): the pool engaged, the three
   parses' merged columns bitwise equal and bitwise phase 6's native
   parse, no native engine call, each parse's seconds, MB/s and rows/s on
   the host clock; the pool's rows binned as phase 6 bins them (the wire
   bitwise phase 4's) and fitted on the card at full width: ensemble and
   margin bitwise phase 6's ingest-path fit, K3's kernel on every level,
   K1 never (counts set to 0 before the parse, read after the fit).  (15b)
   phase 4's ensemble saved with the port's serializer as
   ``Pair(Map(Str, Vector(POD(int32))), Map(Str, Vector(POD(float32))))``
   on a local stream, loaded back onto the card: ``predict`` on 200,000
   rows bitwise the original ensemble's; ``interop.to_torch`` of a CUDA
   tensor's dlpack capsule shares its ``data_ptr``; and
   ``examples/cpp/consumer_demo.cc`` built unchanged with g++ against the
   port's ``libdmlc_torch_native.so`` passes the four checks of
   ``tests/test_cpp_consumer.py``.  (15c) where ``pyarrow`` is present, a
   Parquet copy of 15a's rows (row groups of 65,536) must parse to the
   libsvm parse's columns and fit bitwise phase 6's, with K3's kernel on
   every level and K1 never (counted and added to the kernels line);
   where it is missing, one line says that columnar ingest did not run
   and a ``.parquet`` URI must raise the one clear error naming
   pyarrow;
16. the cluster backends.  (16a) phase 11's 500,000 libsvm rows (written
   again) trained by ``train_gbdt``'s ``main(argv)`` (``--worker backend
   DIR``; phase 4's flags) in 2 workers sharing the card over gloo,
   launched by ``python -m dmlc_core_tpu_torch.tracker.submit`` from a
   temporary directory once through each of ``--cluster local``, ``ssh``
   (a host file of localhost twice and a fake ``ssh`` on ``PATH`` that
   drops ``-o``/``-p`` and runs the remote command through ``sh -c``, as
   sshd does), ``mpi`` (a fake Open MPI ``mpirun``: ``-n``/``-x``, ranks
   with ``OMPI_COMM_WORLD_RANK`` and no ``DMLC_TASK_ID``) and ``sge`` (a
   fake ``qsub`` that runs the array job's script once a task with
   ``SGE_TASK_ID``; the script lands in the launch's cwd).  The fakes are
   written at run time.  Every launch must exit 0 and print one
   ``trained ... over 2 workers`` line twice; each rank's rank must be
   the one ``_task_id_from_env`` reads from its launcher's variable
   (``OMPI_COMM_WORLD_RANK`` under mpi, ``SGE_TASK_ID`` - 1 under sge),
   and so must its collective rank; both ranks' ensembles of every
   launch must be bitwise the local launch's rank 0's; each rank makes
   at least 60 K3 launches and none of K1.  Each rank sends the tracker
   the Rabit ``shutdown`` a Rabit client sends at finalize, since sge's
   launcher joins the tracker as the reference's does.  Per backend it
   prints the launch's wall seconds and the fit's seconds and rows/s.
   (16b) the ssh launch ran with ``--env DMLC_TELEMETRY_DIR=D`` (the
   launcher with it too): ``python -m dmlc_core_tpu_torch.telemetry
   trace D --fail-on-orphans --json --out D/merged.json`` must exit 0
   with the tracker's trace over >= 3 processes and no orphan,
   ``merged.json`` must load, ``telemetry report D --json`` must
   aggregate ranks 0 and 1, and ``python -m dmlc_core_tpu_torch.fault
   validate`` must exit 0 on a good plan and 2 on a malformed one;
17. the port's lint gate and host syncs.  (17a) ``python -m
   dmlc_core_tpu_torch.analysis`` from the checkout must exit 0 with
   ``0 new finding(s)`` (its seconds printed).  (17b) one ``"auto"`` fit
   of phase 4's 2,000,000 binned rows at phase 4's settings (60 K3
   launches, no K1), then ``predict`` of 64 and of 65,536 of those rows,
   each under ``torch.cuda.set_sync_debug_mode("warn")`` (reset to 0 in a
   ``finally``): every synchronizing call the card reports is mapped to
   its innermost frame in the package.  It prints the syncs per fit, per
   round and per ``predict`` call and each distinct site with whether it
   lies in a root of the analyzer's purity pass and which purity finding
   covers its statement; a site inside a root that no finding covers
   fails the phase.  The fit's ensemble and margin must be bitwise phase
   4's ``"auto"`` fit's, and each ``predict`` bitwise the same call with
   the debug mode off.  Last it prints how many static purity findings
   never synced in this run.

The line before the last is a JSON object with one entry per kernel (K1,
K3, K4; K2 has no kernel of its own).  Each ``launches`` is the count of
the main path's run (phase 4 for K1 and K3, phase 5 for K4), with the
counts set to 0 just before it: K1 is on no main path, so its count is 0
(phase 3 prints its launches there on a line of their own, and phase 6
those of the ingest path, phase 7 those of the serving path, phase 8
those of the training paths, phase 9 those of the serving tier and
phase 10 those of the sampled fits); K3's ``launches`` adds rank 0's
count of phase 11, the multi-worker path's run, phase 12's fit from
recordio, phase 13's parse and fit from the bucket, phase 15's parse
and fit through the process pool (and from Parquet, where it ran) and
rank 0's count of phase 16's ssh launch, and K4's adds rank 0's count of
phase 14a's dryrun.
The last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_ROWS = 2_000_000
N_HELDOUT = 200_000
N_AGREE = 200_000
N_FEATURES = 28
NUM_BINS = 256
MAX_DEPTH = 6
ROUNDS = 10
RTOL, ATOL = 1e-4, 1e-3
MESH = {"data": 2, "model": 2}
QUANTILE_SAMPLE = 50_000      # rows per shard the bin edges are fit on
WORKER_TIMEOUT_S = 420       # wall clock of each phase-5 launch
COLLECTIVE_TIMEOUT_S = 300   # a dead peer fails the run after this
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM f32 rate outside the tensor cores
BF16_TC_OPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core rate
RAGGED_ROWS = 1_000_003       # K1's and K3's ragged-shape checks
N_INGEST = 500_000            # phase 6's libsvm rows (writing and parsing
N_CSV = 200_000               # 2M rows twice would not fit its ~120 s)
INGEST_BATCH = 8192
CLI_TIMEOUT_S = 300
SERVE_POOL = 8192             # phase 7's held-out rows the requests draw on
SERVE_REQUESTS = 1000         # per wave; wave 2 runs on through the swap
SERVE_CLIENTS = 8
SERVE_MAX_BATCH = 64
SERVE_APPEND_ROUNDS = 2
EVAL_ROUNDS = 40              # phase 8a's early-stopping fits
EVAL_PATIENCE = 3
TRAIN_FILES = 8               # phase 8's spool: 8 libsvm files of
TRAIN_FILE_ROWS = 31_250      # 31,250 of phase 4's rows (250,000 rows;
                              # 500,000 took phase 8 to 80 s on an H100)
TEXT_CHUNK = 6_250            # rows formatted at a time
TRAIN_ROUNDS_PER_BATCH = 2
TRAIN_PUBLISH_ROUNDS = 4
TRAIN_GATE_ANSWERS = 20       # answers of a step before the next batch
TRAIN_FINAL_ANSWERS = 50      # answers of the last step before the stop
FLEET_ROWS = 200_000          # phase 8e's corpus
FLEET_UNITS = 8
TIER_REPLICAS = 3             # phase 9b's fleet
TIER_RUN_S = 10.0             # 9b's first run and 9d's run
TIER_CHAOS_S = 75.0           # 9b's second run: the kill and a rolling
                              # restart of 3 card replicas (~10-13 s each
                              # to start on an H100 host) fall inside it
TIER_KILL_AT_S = 3.0
TIER_START_S = 240            # replica start-up, five processes at once
TIER_LOAD = dict(num_feature=N_FEATURES, timeout_s=30.0,
                 max_workers=256)   # run_load's settings in 9b and 9d
TIER_QUEUE_BYTES = 256 << 10  # 9b's admission bound per replica, 2,340
                              # rows: at the 1,200-3,800 rows/s a card
                              # replica drains, 0.6-2 s of queue, inside the
                              # router's 5 s try deadline, so overload sheds
                              # a structured 503 instead of timing out
CHURN_CONNECTIONS = 1000      # 9a's idle keep-alive connections
CHURN_ACTIVE = 32
CHURN_S = 5.0
PIPELINE_DEPTH = 8            # 9a: requests sent in one write
SAMPLED = dict(subsample=0.8, colsample_bytree=0.8, colsample_bylevel=0.8,
               colsample_bynode=0.8)  # phase 10a's rates
SAMPLE_SEED = 7
N_SOFTMAX = 200_000           # 10a's 3-class relabel
N_ENTRY = 200_000             # 10b's libsvm rows (phase 6's first 200,000)
N_ENTRY_EVAL = 50_000         # 10b's held-out libsvm rows
N_MULTI = 500_000             # phase 11's libsvm rows, 250,000 a rank
N_MULTI_CLI = 100_000         # its plain `python -m` launch
BACKENDS = ("local", "ssh", "mpi", "sge")   # phase 16's launches, in order
GATE_TIMEOUT_S = 300          # 17a: the port's lint gate (~12 s)
SYNC_PREDICT_ROWS = (64, 65_536)   # 17b: rows of the two predict calls
MW_TIMEOUT_S = 240            # wall clock of each phase-11 launch
MW_COLLECTIVE_TIMEOUT_S = 60  # a dead peer fails phase 11 after this
MW_LEAF_TOL = 1e-4            # 11a: leaf values against the world-1 fit of
                              # the ranks' rows and bins (f32 sums in
                              # another order)
MW_STEP_TOL = 1e-5            # 11b: logreg params and both models' losses
                              # against world-1 steps, relative (atol 1e-6)
MW_GRAD_TOL = 2e-2            # 11b: bf16 MLP gradients, relative and of
                              # each one's largest magnitude (the bf16
                              # bound of tests/test_torch_linear_mlp.py;
                              # a dropped rank moves them 0.26-0.37)
N_REC_PY = 200_000            # 12b: the Python engine's shuffled reads
                              # (one span a record) of the first 200,000
N_REC_PARTS = 4               # 12a's parts; 12d's shuffle parts
REC_BATCH = 8192              # 12b's batch of records
REC_SEED = 11                 # 12b's shuffle seed and 12d's (at 13, 12d's 4
                              # shuffle parts keep their file order)
N_LIBFM = 200_000             # 12e's libfm rows
LIBFM_FIELD_WIDTH = 7         # 12e: columns 7f..7f+6 form field f
MLP_TOL = 1e-5                # 9c: the card's bf16 MLP against the CPU's
REMOTE_WRITE_MB = 64          # 13a: DMLC_S3_WRITE_BUFFER_MB of the upload
N_REMOTE_CLI = 100_000        # 13c: rows of the CLI's object
REMOTE_CKPT_EVERY = 5         # 13c: the CLI's --checkpoint-every
RETRY_OBJECT = 16 << 20       # 13e: bytes read from the flaky store
RETRY_FAIL_EVERY = 7          # 13e: every 7th GET cut off mid-body
                              # bf16 MLP (the same code); 9c's f32 control
                              # must read above it
DRYRUN_RANKS = 8              # 14a: dryrun_multichip's ranks on the card
SEQ_RANKS = 4                 # 14b: the sp mesh
SEQ_B, SEQ_L, SEQ_H, SEQ_D = 1, 8192, 8, 64   # 14b: [B, L, H, D], f32
SEQ_RTOL, SEQ_ATOL = 2e-4, 2e-5   # 14b: outputs (tests/test_sequence.py's)
SEQ_GRAD_TOL = 1e-4           # 14b: dq/dk/dv, of max|g_ref|
SEQ_ITERS = 5                 # 14b: timed calls of each case
RING_ELEMS = 1 << 20          # 14c: ring_allreduce's f32 elements a rank
RING_TOL = 1e-5               # 14c: ring against psum (sums of 4 randn)
RING_BYTES = 64 << 20         # 14c: allreduce_bandwidth_gbps's array
TP_PROBE = 4096               # 14c: rows the checkpoint's predict scores
TP_F32_TOL = 1e-5             # 14c: f32 steps against world-1 steps
PARSE_PROCS = 4               # 15a: DMLC_PARSE_PROC's worker processes
N_SERVED = 200_000            # 15b: rows the reloaded ensemble predicts
K3_RAGGED = [
    # num_nodes, num_bins, bins dtype, (lo, hi) of the bins, f_offset,
    # f_count, offset of the tensors in their allocations (elements); node
    # ids are drawn from [-2, num_nodes + 3)
    (1, 256, torch.uint8, (0, 256), 0, None, 0),
    (5, 255, torch.int32, (-3, 260), 14, 14, 3),
    (13, 255, torch.uint8, (0, 256), 2, 3, 1),
    (37, 255, torch.int32, (-3, 260), 14, 14, 0),
    (256, 255, torch.uint8, (0, 256), 0, None, 5),
]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def make_higgs_like(n, f, seed=0):
    """HIGGS-shaped synthetic data: a noisy linear decision surface."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f).astype(np.float32)
    y = ((x @ w + 0.3 * rng.randn(n)) > 0).astype(np.float32)
    return x, y


def phase_device():
    print("== phase 1: device", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    return card


def phase_build(card):
    from dmlc_core_tpu_torch import native_bridge
    from dmlc_core_tpu_torch.ops import _build, hist_cuda

    print("== phase 2: build", flush=True)
    # the native ingest engine (g++) builds beside the kernels (nvcc), here
    # rather than in later phases' worker processes, which would wait on
    # its build lock
    native = {}

    def build_native():
        start = time.perf_counter()
        try:
            native_bridge.load_library()
        except BaseException as exc:  # noqa: BLE001 - failed below
            native["error"] = exc
        native["sec"] = time.perf_counter() - start

    thread = threading.Thread(target=build_native, name="native-build")
    thread.start()
    start = time.perf_counter()
    try:
        _build.load_library()
    finally:
        thread.join()
    if "error" in native:
        fail(f"the native ingest engine did not build: {native['error']}")
    info = native_bridge.BUILD_INFO
    print(f"native build: {native['sec']:.1f} s (g++ "
          f"{info.get('seconds', 0.0):.1f} s, cached={info.get('cached')}) "
          f"[{card}]", flush=True)
    info = _build.BUILD_INFO
    print(f"built {_build.LIBRARY} in {time.perf_counter() - start:.2f} s "
          f"(nvcc {info.get('seconds', 0.0):.2f} s, cached="
          f"{info.get('cached')})")
    for line in str(info.get("ptxas", "")).splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  " + line.strip())
    if not hist_cuda.kernels_available():
        fail("kernels_available() is False on a card")
    print("probe: K1, K2 and K3 agree with their plain versions",
          flush=True)


def _bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _max_err(got, want):
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def _check_close(name, got, want):
    for a, b in zip(got, want):
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"{name} disagrees with its plain version: max abs err "
                 f"{_max_err(got, want):.3g}")


def _bitwise(fn):
    first, again = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    return all(torch.equal(a, b) for a, b in zip(first, again))


def phase_kernels():
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    print("== phase 3: kernels at 2,000,000 x 28 x 256", flush=True)
    hist_cuda.reset_launches()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, F, nb = N_ROWS, N_FEATURES, NUM_BINS
    bins = torch.randint(0, nb, (B, F), device=dev,
                         generator=gen).to(torch.uint8)
    grad = torch.randn(B, device=dev, generator=gen)
    hess = torch.rand(B, device=dev, generator=gen)
    entries = {}
    for n in (1, 32, 256):
        node = torch.randint(-1, n, (B,), device=dev, generator=gen,
                             dtype=torch.int32)
        live = int(((node >= 0) & (node < n)).sum().item())
        # the scatter formulation as one library call: flat ids for G and H
        ids = (node.long()[:, None] * (F * nb)
               + torch.arange(F, device=dev)[None, :] * nb + bins.long())
        nseg = n * F * nb
        ok = (node >= 0)[:, None].expand(B, F)
        flat = torch.cat([torch.where(ok, ids, 2 * nseg),
                          torch.where(ok, ids + nseg, 2 * nseg)]).reshape(-1)
        src = torch.cat([grad[:, None].expand(B, F),
                         hess[:, None].expand(B, F)]).reshape(-1)
        lib_out = torch.zeros(2 * nseg + 1, device=dev)
        library_ms = cuda_event_ms(lambda: lib_out.index_add_(0, flat, src),
                                   iters=5, warmup=1)
        del ids, ok, flat, src, lib_out

        want = hist_cuda.grad_hist_ref(bins, node, grad, hess, n, nb)
        args = (bins, node, grad, hess, n, nb)
        if not _bitwise(lambda: hist_cuda.grad_hist_ref(*args)):
            fail(f"the plain version (segment sums) is not bitwise "
                 f"repeatable at n={n}")
        # K2 and K3 compute one function: bins, node/g/h in, (G, H) out;
        # both run K3's kernel with one plan
        nbytes = B * F + 12 * B + 2 * n * F * nb * 4
        bound, by = _bound_ms(nbytes, 2 * live * F)
        plan = hist_cuda.grad_hist_fused_plan(n, B, F, nb, 1)
        m_rows = 16 * plan.m_tiles * plan.m_blocks
        cases = [("grad_hist_cuda", lambda: hist_cuda.grad_hist_cuda(*args),
                  lambda: hist_cuda.grad_hist_ref(*args)),
                 ("grad_hist_fused_cuda",
                  lambda: hist_cuda.grad_hist_fused_cuda(*args),
                  lambda: hist_cuda.grad_hist_fused_ref(*args))]
        for name, fn, ref in cases:
            before = dict(hist_cuda.LAUNCHES)
            got = fn()
            if (hist_cuda.LAUNCHES["grad_hist_fused_cuda"]
                    != before["grad_hist_fused_cuda"] + 1
                    or hist_cuda.LAUNCHES["hist_matmul_cuda"]
                    != before["hist_matmul_cuda"]):
                fail(f"{name} at n={n}: launches went from {before} to "
                     f"{hist_cuda.LAUNCHES}, expected one K3 launch")
            _check_close(name, got, want)
            err = _max_err(got, want)
            same = _bitwise(fn)
            if not same:
                fail(f"{name} is not bitwise repeatable at n={n}")
            ms = cuda_event_ms(fn, iters=5, warmup=1)
            plain_ms = cuda_event_ms(ref, iters=3, warmup=1)
            print(f"{name:22s} n={n:3d} max_abs_err={err:.3g} (rtol {RTOL}, "
                  f"atol {ATOL}) bitwise={same} ms={ms:.3f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={bound:.4f} ({by}) "
                  f"dense_tc_ms={_dense_tc_ms(m_rows, B, F, nb):.4f} "
                  f"(M={m_rows}) library_ms={library_ms:.3f}", flush=True)
            if name == "grad_hist_fused_cuda":
                entries[("K3", n)] = dict(
                    name="grad_hist_fused_cuda", route="cuda",
                    source="dmlc_core_tpu_torch/csrc/hist.cu",
                    replaces="dmlc_core_tpu/ops/hist_pallas.py:250",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=library_ms)
        if n == 32:
            # the column window K4 hands the kernels: columns 14..27 of the
            # 28-column rows, read in place (row stride 28, offset 14)
            f0 = F // 2
            want_w = hist_cuda.grad_hist_ref(bins[:, f0:].contiguous(), node,
                                             grad, hess, n, nb)
            for name, fn in (("grad_hist_cuda", hist_cuda.grad_hist_cuda),
                             ("grad_hist_fused_cuda",
                              hist_cuda.grad_hist_fused_cuda)):
                def window(fn=fn):
                    return fn(bins, node, grad, hess, n, nb, f0, F - f0)
                got = window()
                _check_close(f"{name} at f_offset={f0}", got, want_w)
                if not _bitwise(window):
                    fail(f"{name} is not bitwise repeatable on columns "
                         f"{f0}..{F - 1}")
                print(f"{name:22s} n={n:3d} columns {f0}..{F - 1} in place: "
                      f"max_abs_err={_max_err(got, want_w):.3g} bitwise=True",
                      flush=True)
            del want_w, got
        # K1 alone on the W the reference's K2 builds (in one sweep)
        if hist_cuda.hist_node_block(n, F, nb) == n:
            w = hist_cuda.node_weights(node, grad, hess, n)
            M = w.shape[0]
            got = hist_cuda.hist_matmul_cuda(w, bins, nb)
            ref_out = hist_cuda.hist_matmul_ref(w, bins, nb)
            _check_close("hist_matmul_cuda", (got,), (ref_out,))
            err = _max_err((got,), (ref_out,))
            if not _bitwise(lambda: hist_cuda.hist_matmul_cuda(w, bins, nb)):
                fail(f"hist_matmul_cuda is not bitwise repeatable at n={n}")
            ms = cuda_event_ms(lambda: hist_cuda.hist_matmul_cuda(w, bins,
                                                                  nb),
                               iters=5, warmup=1)
            plain_ms = cuda_event_ms(
                lambda: hist_cuda.hist_matmul_ref(w, bins, nb), iters=3,
                warmup=1)
            nbytes = 2 * M * B + B * F + M * F * nb * 4
            bound, by = _bound_ms(nbytes, M * B * F)
            print(f"{'hist_matmul_cuda':22s} n={n:3d} M={M} max_abs_err="
                  f"{err:.3g} bitwise=True ms={ms:.3f} plain_ms="
                  f"{plain_ms:.3f} bound_ms={bound:.4f} ({by}) "
                  f"dense_tc_ms={_dense_tc_ms(M, B, F, nb):.4f} "
                  f"library_ms={library_ms:.3f}", flush=True)
            entries[("K1", n)] = dict(
                name="hist_matmul_cuda", route="cuda",
                source="dmlc_core_tpu_torch/csrc/hist.cu",
                replaces="dmlc_core_tpu/ops/hist_pallas.py:148",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)
            del w, got, ref_out
        del node, want
        torch.cuda.empty_cache()
    _k1_ragged(bins.shape[1], gen)
    _k3_ragged(bins.shape[1], gen)
    print(f"hist_matmul_cuda launches in this phase's checks: "
          f"{hist_cuda.LAUNCHES['hist_matmul_cuda']}", flush=True)
    # the line reports the depth-6 main path's deepest level (32 nodes)
    return entries[("K1", 32)], entries[("K3", 32)]


def _dense_tc_ms(m, rows, features, num_bins):
    """K1's product W[M, B] @ onehot[B, F*nbins] done densely on the tensor
    cores at their peak: the time the tensor-core formulation needs."""
    return 1e3 * 2 * m * rows * features * num_bins / BF16_TC_OPS_PER_S


def _k1_ragged(F, gen):
    """K1 on shapes no tile divides: rows, weight rows and bins ragged,
    bins out of range, uint8 on all columns and int32 on a window."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    dev = torch.device("cuda")
    B, M, nb, f0 = RAGGED_ROWS, 48, 255, F // 2
    w = torch.randn(M, B, device=dev, generator=gen).to(torch.bfloat16)
    for dtype, lo, hi, off in ((torch.uint8, 0, 256, 0),
                               (torch.int32, -3, 260, f0)):
        rb = torch.randint(lo, hi, (B, F), device=dev, generator=gen,
                           dtype=torch.int32).to(dtype)
        count = F - off

        def k1():
            return hist_cuda.hist_matmul_cuda(w, rb, nb, off, count)
        got = k1()
        want = hist_cuda.hist_matmul_ref(w, rb[:, off:].contiguous(), nb)
        _check_close(f"hist_matmul_cuda on {B} x {F} {dtype}", (got,),
                     (want,))
        if not _bitwise(k1):
            fail(f"hist_matmul_cuda is not bitwise repeatable on {B} rows, "
                 f"{dtype}, columns {off}..{F - 1}")
        print(f"{'hist_matmul_cuda':22s} ragged B={B} M={M} nbins={nb} "
              f"{str(dtype).split('.')[-1]} columns {off}..{F - 1} (bins in "
              f"[{lo}, {hi})): max_abs_err={_max_err((got,), (want,)):.3g} "
              f"bitwise=True", flush=True)
        del rb, got, want
    del w
    torch.cuda.empty_cache()


def _k3_ragged(F, gen):
    """K3 on shapes no tile divides (``K3_RAGGED``: node counts that fill
    no m-tile or m-block, node ids and bins out of range, column windows,
    tensors at an offset in their allocations), each against its plain
    version on a copy of the window, bitwise over two launches, and every
    launch counted."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    dev = torch.device("cuda")
    B = RAGGED_ROWS
    for n, nb, dtype, (lo, hi), off, count, shift in K3_RAGGED:
        count = F - off if count is None else count
        rb = torch.randint(lo, hi, (B * F + shift,), device=dev,
                           generator=gen, dtype=torch.int32).to(dtype)
        rb = rb[shift:].view(B, F)
        node = torch.randint(-2, n + 3, (B + shift,), device=dev,
                             generator=gen, dtype=torch.int32)[shift:]
        g = torch.randn(B + shift, device=dev, generator=gen)[shift:]
        h = torch.rand(B + shift, device=dev, generator=gen)[shift:]

        def k3():
            return hist_cuda.grad_hist_fused_cuda(rb, node, g, h, n, nb, off,
                                                  count)
        before = hist_cuda.LAUNCHES["grad_hist_fused_cuda"]
        got = k3()
        want = hist_cuda.grad_hist_fused_ref(
            rb[:, off:off + count].contiguous(), node, g, h, n, nb)
        what = (f"grad_hist_fused_cuda on {B} x {F} {dtype}, n={n}, "
                f"columns {off}..{off + count - 1}, offset {shift}")
        _check_close(what, got, want)
        if not _bitwise(k3):
            fail(f"{what} is not bitwise repeatable")
        launched = hist_cuda.LAUNCHES["grad_hist_fused_cuda"] - before
        if launched != 3:
            fail(f"{what}: {launched} launches counted for 3 calls")
        print(f"{'grad_hist_fused_cuda':22s} ragged B={B} n={n} nbins={nb} "
              f"{str(dtype).split('.')[-1]} columns {off}..{off + count - 1} "
              f"offset {shift} (bins in [{lo}, {hi}), nodes in [-2, {n + 3})"
              f"): max_abs_err={_max_err(got, want):.3g} bitwise=True",
              flush=True)
        del rb, node, g, h, got, want
    torch.cuda.empty_cache()


def _split_agreement(a, b):
    split = a.split_feat >= 0
    same = (a.split_feat == b.split_feat) & (
        (a.split_bin == b.split_bin) | ~split)
    return same.float().mean().item()


def _same_tree(a, b, t):
    split = a.split_feat[t] >= 0
    return (torch.equal(a.split_feat[t], b.split_feat[t])
            and torch.equal(a.split_bin[t][split], b.split_bin[t][split])
            and torch.equal(a.default_left[t], b.default_left[t]))


def phase_gbdt(card):
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.ops.histogram import resolve_hist_method
    from dmlc_core_tpu_torch.utils.timer import device_time

    print("== phase 4: GBDT fit_binned + predict", flush=True)
    x, y = make_higgs_like(N_ROWS + N_HELDOUT, N_FEATURES)
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    model = GBDT(GBDTParam(**param), num_feature=N_FEATURES)
    model.make_bins(x[:50_000])
    binner = HostBinner(model.boundaries, NUM_BINS)
    wire = binner.transform(x)
    if wire.dtype != np.uint8:
        fail(f"wire dtype {wire.dtype}, expected uint8")
    dev = torch.device("cuda")
    bins = torch.from_numpy(wire[:N_ROWS]).to(dev)
    held = torch.from_numpy(wire[N_ROWS:]).to(dev)
    y_tr = torch.from_numpy(y[:N_ROWS]).to(dev)
    y_te = torch.from_numpy(y[N_ROWS:]).to(dev)
    method = resolve_hist_method(model.param.hist_method, bins)
    fused = GBDT(GBDTParam(hist_method="pallas_fused", **param),
                 num_feature=N_FEATURES)
    fused.set_boundaries(model.boundaries)
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    fits = []
    for m in (model, model, fused):
        (ens, margin), sec = device_time(m.fit_binned, bins, y_tr)
        fits.append((ens, margin, sec))
    prob = model.predict(fits[1][0], held)
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)

    need = ROUNDS * MAX_DEPTH
    print(f"hist method {method!r}; launches on the main path {launches} "
          f"(each fit needs >= {need} of K3's kernel, K1 none)")
    if launches["grad_hist_fused_cuda"] < 3 * need:
        fail(f"K3 launched {launches['grad_hist_fused_cuda']} times, "
             f"expected >= {3 * need}")
    if launches["hist_matmul_cuda"] != 0:
        fail(f"K1 launched {launches['hist_matmul_cuda']} times on the main "
             f"path, expected 0")
    for (ens, margin, sec), label in zip(
            fits, ("auto/K2 cold", "auto/K2 warm", "pallas_fused/K3")):
        if margin.shape != (N_ROWS,) or not torch.isfinite(margin).all():
            fail(f"{label}: bad training margin")
        acc = ((margin > 0).float() == y_tr).float().mean().item()
        print(f"fit {label}: {sec:.3f} s, {N_ROWS / sec:,.0f} rows/s, "
              f"train acc {acc:.4f} [{card}]", flush=True)
        if acc < 0.8:
            fail(f"{label}: train accuracy {acc:.4f} < 0.8")
    repeat = all(torch.equal(a, b)
                 for a, b in zip(fits[0][0], fits[1][0]))
    same = (all(torch.equal(a, b) for a, b in zip(fits[1][0], fits[2][0]))
            and torch.equal(fits[1][1], fits[2][1]))
    print(f"two auto fits bitwise identical: {repeat}; auto (K2) fit's "
          f"ensemble and margin bitwise equal to the pallas_fused (K3) "
          f"fit's: {same}")
    if not same:
        fail("the auto fit differs from the pallas_fused fit")
    if prob.shape != (N_HELDOUT,) or not torch.isfinite(prob).all():
        fail("bad held-out predictions")
    held_acc = ((prob > 0.5).float() == y_te).float().mean().item()
    print(f"held-out accuracy {held_acc:.4f} on {N_HELDOUT} rows")
    if held_acc < 0.8:
        fail(f"held-out accuracy {held_acc:.4f} < 0.8")
    _scatter_fits(card, param, model.boundaries, bins, y_tr)

    print(f"== card vs CPU plain versions on {N_AGREE} rows", flush=True)
    accs = {}
    ens = {}
    for where in ("cuda", "cpu"):
        m = GBDT(GBDTParam(hist_method="pallas", **param),
                 num_feature=N_FEATURES, device=where)
        m.set_boundaries(model.boundaries)
        (e, margin), sec = device_time(m.fit_binned, wire[:N_AGREE],
                                       y[:N_AGREE])
        margin = margin.cpu()
        ens[where] = type(e)(*(None if a is None else a.cpu() for a in e))
        accs[where] = ((margin > 0).float().numpy() == y[:N_AGREE]).mean()
        print(f"{where}: fit {sec:.3f} s, train acc "
              f"{accs[where]:.4f}")
    agree = _split_agreement(ens["cuda"], ens["cpu"])
    first = _same_tree(ens["cuda"], ens["cpu"], 0)
    print(f"split agreement {agree:.4f}; first tree identical {first}; "
          f"accuracy gap {abs(accs['cuda'] - accs['cpu']):.5f}")
    if not first:
        fail("the first tree differs between the card and the CPU")
    if abs(accs["cuda"] - accs["cpu"]) > 0.005:
        fail("card and CPU accuracies differ by more than 0.005")
    ref = dict(x=x, y=y, wire=wire, model=model, bins=bins, y_tr=y_tr,
               margin=fits[1][1],
               ens=fits[1][0], fit_sec=fits[1][2])
    return launches, ref


def _scatter_fits(card, param, boundaries, bins, y):
    """Two ``"scatter"`` fits of the phase-4 rows: no kernel launched, the
    same bits twice (segment sums without float atomics)."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    model = GBDT(GBDTParam(hist_method="scatter", **param),
                 num_feature=N_FEATURES)
    model.set_boundaries(boundaries)
    torch.cuda.synchronize()
    # the scatter path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    fits = [device_time(model.fit_binned, bins, y) for _ in range(2)]
    launches = dict(hist_cuda.LAUNCHES)
    if set(launches.values()) != {0}:
        fail(f"the scatter fits launched kernels: {launches}")
    (ens, margin), _ = fits[0]
    same = (all(torch.equal(a, b) for a, b in zip(ens, fits[1][0][0]))
            and torch.equal(margin, fits[1][0][1]))
    acc = ((margin > 0).float() == y).float().mean().item()
    print(f"scatter fits: {fits[0][1]:.3f} s and {fits[1][1]:.3f} s, train "
          f"acc {acc:.4f}, no kernel launched; ensembles and margins "
          f"bitwise equal: {same} [{card}]", flush=True)
    if not same:
        fail("two scatter fits differ on the card")
    if acc < 0.8:
        fail(f"scatter: train accuracy {acc:.4f} < 0.8")


# -- phase 5: distributed GBDT ---------------------------------------------
def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_workers(mode, world, outdir, timeout_s):
    """Run ``world`` worker processes of this script with the DMLC_* env
    contract and a fresh coordinator port; fail on any failure or
    timeout, with each failed worker's stderr tail."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(outdir, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, DMLC_NUM_WORKER=str(world),
                   DMLC_TASK_ID=str(rank),
                   DMLC_COORDINATOR_URI="127.0.0.1",
                   DMLC_COORDINATOR_PORT=str(port), OMP_NUM_THREADS="2")
        out = open(os.path.join(outdir, f"{mode}{rank}.out"), "w")
        err = open(os.path.join(outdir, f"{mode}{rank}.err"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", mode,
             outdir], env=env, cwd=here, stdout=out, stderr=err), out, err))
    deadline = time.monotonic() + timeout_s
    failed = []
    try:
        for rank, (proc, _, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for proc, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    for rank, rc in failed:
        with open(os.path.join(outdir, f"{mode}{rank}.err")) as f:
            tail = f.read()[-3000:]
        print(f"--- {mode} worker {rank} ({rc}) stderr tail:\n{tail}",
              file=sys.stderr, flush=True)
    if failed:
        fail(f"{mode} workers failed: {failed}")
    with open(os.path.join(outdir, f"{mode}0.out")) as f:
        sys.stdout.write(f.read())
    sys.stdout.flush()


def _ensemble_arrays(ens):
    return {k: (None if a is None else a.cpu())
            for k, a in ens._asdict().items()}


def phase_distributed(card):
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam, TreeEnsemble
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 5: distributed GBDT, {MESH} mesh of 4 ranks on one "
          f"card (gloo)", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(here, "build", "chip_smoke_workers")
    shutil.rmtree(outdir, ignore_errors=True)     # no earlier run's results
    torch.cuda.empty_cache()
    start = time.perf_counter()
    _launch_workers("gloo", 4, outdir, WORKER_TIMEOUT_S)
    print(f"4 workers done in {time.perf_counter() - start:.1f} s")
    # written by the workers just above
    ranks = [torch.load(os.path.join(outdir, f"gloo{r}.pt"),
                        weights_only=False) for r in range(4)]
    need = ROUNDS * MAX_DEPTH
    x, y = make_higgs_like(N_ROWS, N_FEATURES)
    bounds = ranks[0]["boundaries"]
    for r in ranks:
        if not np.array_equal(r["boundaries"], bounds):
            fail(f"rank {r['rank']} has other bin edges than rank 0")
    wire = HostBinner(bounds, NUM_BINS).transform(x)
    dev = torch.device("cuda")
    bins = torch.from_numpy(wire).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    for method in ("pallas", "pallas_fused"):
        fits = [r["fits"][method] for r in ranks]
        for r, f in zip(ranks, fits):
            for k, a in f["ensemble"].items():
                if not torch.equal(a, fits[0]["ensemble"][k]):
                    fail(f"{method}: rank {r['rank']}'s {k} differs from "
                         f"rank 0's")
            k4 = f["launches"]["grad_hist_sharded_cuda"]
            if k4 < need:
                fail(f"{method}: rank {r['rank']} launched K4 {k4} times, "
                     f"expected >= {need}")
        correct = sum(f["correct"] for r, f in zip(ranks, fits)
                      if r["coord"]["model"] == 0)
        acc = correct / N_ROWS
        stages = {k: round(v, 4) for k, v in fits[0]["stages"].items()}
        print(f"{method}: 4 ranks bitwise identical; rank 0 fit "
              f"{fits[0]['seconds']:.3f} s (stages timed: {stages} s), "
              f"launches {fits[0]['launches']}, global train acc "
              f"{acc:.4f} [{card}]", flush=True)
        if acc < 0.8:
            fail(f"{method}: global train accuracy {acc:.4f} < 0.8")
        single = GBDT(GBDTParam(hist_method=method, **param),
                      num_feature=N_FEATURES)
        single.set_boundaries(bounds)
        (ens, margin), sec = device_time(single.fit_binned, bins, y_t)
        single_acc = ((margin > 0).float() == y_t).float().mean().item()
        dist_ens = TreeEnsemble(**fits[0]["ensemble"])
        one = TreeEnsemble(**_ensemble_arrays(ens))
        agree = _split_agreement(dist_ens, one)
        first = _same_tree(dist_ens, one, 0)
        print(f"{method}: single-card fit {sec:.3f} s, acc "
              f"{single_acc:.4f}; split agreement {agree:.4f}; first tree "
              f"identical {first}; accuracy gap {abs(acc - single_acc):.5f}",
              flush=True)
        if not first:
            fail(f"{method}: the distributed first tree differs from the "
                 f"single-card fit's")
        if abs(acc - single_acc) > 0.005:
            fail(f"{method}: distributed and single-card accuracies differ "
                 f"by more than 0.005")
    # K2 and K3 run one kernel: the two methods grow the same bits
    for r in ranks:
        k2, k3 = (r["fits"][m]["ensemble"] for m in ("pallas", "pallas_fused"))
        for k, a in k2.items():
            if (a is None) != (k3[k] is None) or (
                    a is not None and not torch.equal(a, k3[k])):
                fail(f"rank {r['rank']}: the pallas and pallas_fused "
                     f"ensembles differ in {k}")
    print("pallas and pallas_fused ensembles bitwise equal on every rank",
          flush=True)
    del bins, y_t, wire, x, y
    torch.cuda.empty_cache()
    k4 = ranks[0]["k4"]
    k4["launches"] = sum(ranks[0]["fits"][m]["launches"]
                         ["grad_hist_sharded_cuda"]
                         for m in ("pallas", "pallas_fused"))

    print("== phase 5b: world size 1 over NCCL, model_axis fit vs the "
          "plain card fit", flush=True)
    _launch_workers("nccl", 1, outdir, WORKER_TIMEOUT_S)
    return k4


def _time_serially(rank, fn):
    """``fn()`` on one rank at a time, the others waiting at a barrier, so
    kernel times are not shared with the other ranks on the card."""
    from dmlc_core_tpu_torch import collective

    out = None
    for r in range(collective.get_world_size()):
        if r == rank:
            out = fn()
        collective.allreduce(np.zeros(1, np.float32))    # barrier
    return out


def _k4_check(mesh, rank, lo, hi):
    """K4 at 32 nodes on the phase-3 shape, every rank taking part: the
    result after the collectives against the plain histogram of the whole
    global array, two calls bitwise, and times."""
    from dmlc_core_tpu_torch.collective.mesh_collectives import (
        MeshCollective)
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    B, F, nb, n = N_ROWS, N_FEATURES, NUM_BINS, 32
    rng = np.random.RandomState(1)
    dev = torch.device("cuda")
    gbins = torch.from_numpy(rng.randint(0, nb, (B, F)).astype(np.uint8))
    gnode = torch.from_numpy(rng.randint(-1, n, B).astype(np.int32))
    gg = torch.from_numpy(rng.randn(B).astype(np.float32))
    gh = torch.from_numpy(rng.rand(B).astype(np.float32))
    local = [t[lo:hi].contiguous().to(dev) for t in (gbins, gnode, gg, gh)]
    want = hist_cuda.grad_hist_ref(*(t.to(dev) for t in
                                     (gbins, gnode, gg, gh)), n, nb)
    del gbins, gnode, gg, gh
    def k4():
        return hist_cuda.grad_hist_sharded_cuda(*local, n, nb, mesh, "model")
    got = k4()
    for a, b in zip(got, want):
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            fail(f"K4 disagrees with the plain global histogram: max abs "
                 f"err {_max_err(got, want):.3g}")
    again = k4()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("K4 is not bitwise repeatable")
    out = {"max_abs_err": _max_err(got, want),
           "k4_ms": cuda_event_ms(k4, iters=5, warmup=1)}
    del want, got, again
    f_count = F // mesh.shape["model"]
    f0 = mesh.coord("model") * f_count
    lb, ln, lg, lh = local
    piece = torch.stack(hist_cuda.grad_hist_fused_cuda(lb, ln, lg, lh, n, nb,
                                                       f0, f_count))
    data_c = MeshCollective(mesh, "data")
    model_c = MeshCollective(mesh, "model")
    out["all_reduce_ms"] = cuda_event_ms(lambda: data_c.psum(piece),
                                         iters=10, warmup=2)
    out["all_gather_ms"] = cuda_event_ms(
        lambda: model_c.allgather(piece, dim=2), iters=10, warmup=2)
    out["all_reduce_bytes"] = piece.numel() * 4
    out["all_gather_bytes"] = piece.numel() * 4 * mesh.shape["model"]

    def alone():
        res = {}
        # the rank's kernel alone: K3's kernel on its window
        res["ms"] = cuda_event_ms(lambda: hist_cuda.grad_hist_fused_cuda(
            lb, ln, lg, lh, n, nb, f0, f_count), iters=5, warmup=1)
        res["plain_ms"] = cuda_event_ms(lambda: hist_cuda.grad_hist_ref(
            lb[:, f0:f0 + f_count].contiguous(), ln, lg, lh, n, nb),
            iters=3, warmup=1)
        # the scatter formulation as one library call on the window
        rows = hi - lo
        ids = (ln.long()[:, None] * (f_count * nb)
               + torch.arange(f_count, device=dev)[None, :] * nb
               + lb[:, f0:f0 + f_count].long())
        nseg = n * f_count * nb
        ok = (ln >= 0)[:, None].expand(rows, f_count)
        flat = torch.cat([torch.where(ok, ids, 2 * nseg),
                          torch.where(ok, ids + nseg, 2 * nseg)]).reshape(-1)
        src = torch.cat([lg[:, None].expand(rows, f_count),
                         lh[:, None].expand(rows, f_count)]).reshape(-1)
        acc = torch.zeros(2 * nseg + 1, device=dev)
        res["library_ms"] = cuda_event_ms(lambda: acc.index_add_(0, flat,
                                                                 src),
                                          iters=5, warmup=1)
        live = int((ln >= 0).sum().item())
        nbytes = rows * f_count + 12 * rows + 2 * n * f_count * nb * 4
        res["bound_ms"], res["bound_by"] = _bound_ms(nbytes,
                                                     2 * live * f_count)
        res["bound_bytes"] = nbytes
        return res

    res = _time_serially(rank, alone)
    if res is not None:
        out.update(res)
    return out


def worker_main(mode, outdir):
    """One rank of phase 5 (``--worker gloo|nccl OUTDIR``)."""
    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh, row_range
    from dmlc_core_tpu_torch.utils.timer import device_time

    if mode == "gloo":
        collective.init({"backend": "gloo", "timeout": COLLECTIVE_TIMEOUT_S})
        mesh, n_rows = make_mesh(MESH), N_ROWS
    else:
        collective.init({"timeout": COLLECTIVE_TIMEOUT_S})  # nccl, the card
        if torch.distributed.get_backend() != "nccl":
            fail(f"backend {torch.distributed.get_backend()}, not nccl")
        mesh, n_rows = make_mesh({"data": 1, "model": 1}), N_AGREE
    rank = collective.get_rank()
    dev = torch.device("cuda")
    x, y = make_higgs_like(n_rows, N_FEATURES)
    lo, hi = row_range(mesh, n_rows)
    x, y = x[lo:hi], y[lo:hi]
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    probe = GBDT(GBDTParam(**param), N_FEATURES, model_axis="model")
    bounds = probe.make_bins(x[:QUANTILE_SAMPLE], comm=collective,
                             count=hi - lo)
    bins = torch.from_numpy(HostBinner(bounds, NUM_BINS).transform(x)).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    result = {"rank": rank, "boundaries": bounds, "fits": {},
              "coord": {a: mesh.coord(a) for a in mesh.axis_names}}
    for method in ("pallas", "pallas_fused"):
        model = GBDT(GBDTParam(hist_method=method, **param), N_FEATURES,
                     model_axis="model")
        model.set_boundaries(bounds)
        # the main path: counts set to 0 just before, read just after
        hist_cuda.reset_launches()
        hist_cuda.STAGE_SECONDS = {}
        with mesh:
            (ens, margin), sec = device_time(model.fit_binned, bins, y_t)
        stages, hist_cuda.STAGE_SECONDS = hist_cuda.STAGE_SECONDS, None
        launches = dict(hist_cuda.LAUNCHES)
        if launches["grad_hist_sharded_cuda"] < ROUNDS * MAX_DEPTH:
            fail(f"{method}: K4 launched {launches} times")
        result["fits"][method] = dict(
            ensemble=_ensemble_arrays(ens), seconds=sec, stages=stages,
            launches=launches,
            correct=int(((margin > 0).float() == y_t).sum().item()))
        print(f"rank {rank} {method}: fit {sec:.3f} s, launches {launches}",
              flush=True)
        if mode == "nccl":
            # the same rows and edges without a mesh: the plain card fit
            plain = GBDT(GBDTParam(hist_method=method, **param), N_FEATURES)
            plain.set_boundaries(bounds)
            ref, ref_margin = plain.fit_binned(bins, y_t)
            same = all(torch.equal(a, b) for a, b in zip(ens, ref)) \
                and torch.equal(margin, ref_margin)
            print(f"nccl world 1, {method}: ensemble and margin bitwise "
                  f"equal to the plain card fit: {same}", flush=True)
            if not same:
                fail(f"{method}: the NCCL world-1 fit differs from the "
                     f"plain card fit")
    if mode == "gloo":
        result["k4"] = _k4_check(mesh, rank, lo, hi)
        if rank == 0:
            print(f"K4 at n=32 on rank 0: {json.dumps(result['k4'])}",
                  flush=True)
    torch.save(result, os.path.join(outdir, f"{mode}{rank}.pt"))
    collective.finalize()

# -- phase 6: ingest ----------------------------------------------------------
def _write_text(path, x, y, head, sep, cell):
    """``label<head>v<sep>v...`` lines, every value with %.9g (every
    float32 survives the round trip), written 50,000 rows at a time.
    ``cell`` is formatted with the column and its libfm field
    (``LIBFM_FIELD_WIDTH`` columns a field)."""
    fmt = "%.9g" + head + sep.join(cell.format(j, j // LIBFM_FIELD_WIDTH)
                                   for j in range(x.shape[1])) + "\n"
    with open(path, "w") as f:
        for s in range(0, len(x), 50_000):
            rows = np.concatenate([y[s:s + 50_000, None], x[s:s + 50_000]],
                                  axis=1).tolist()
            f.write("".join(fmt % tuple(r) for r in rows))
    return os.path.getsize(path)


def _ingest_path():
    """Phase 6's libsvm file, kept for phase 13 under ``build/``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ingest", "train.libsvm")


def _parse_blocks(uri):
    """Every RowBlock of ``uri`` through the port's threaded parser with
    the default thread count; (blocks, seconds)."""
    from dmlc_core_tpu_torch.data.factory import create_parser

    start = time.perf_counter()
    parser = create_parser(uri)
    try:
        blocks = list(parser)
    finally:
        parser.close()
    return blocks, time.perf_counter() - start


class _env:
    """Environment variables set inside the block (None unsets), e.g.
    ``DMLC_TPU_DISABLE_NATIVE="1"``: the port's numpy parse engine and
    Python split engine."""

    def __init__(self, **values):
        self._values = values

    def __enter__(self):
        self._was = {k: os.environ.get(k) for k in self._values}
        for k, v in self._values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self._was.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _same_columns(got, want):
    """Whether two parses' merged RowBlock columns are bitwise equal (an
    absent weight or value column means all ones)."""
    from dmlc_core_tpu_torch.data.row_block import concat_blocks

    a, b = concat_blocks(got), concat_blocks(want)
    for name in ("offset", "label", "weight", "index", "value", "field"):
        x, y = getattr(a, name), getattr(b, name)
        if x is None and y is None:
            continue
        n = a.size if name == "weight" else a.num_nonzero
        x = np.ones(n, np.float32) if x is None else x
        y = np.ones(n, np.float32) if y is None else y
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            return False
    return True


def _dense_rows(blocks, n_feature):
    """The real rows of ``dense_batches`` over ``blocks``: (x, y, seconds)."""
    from dmlc_core_tpu_torch.bridge.batching import dense_batches

    start = time.perf_counter()
    xs, ys = [], []
    for b in dense_batches(blocks, INGEST_BATCH, n_feature):
        xs.append(b.x[:b.num_rows].numpy())
        ys.append(b.label[:b.num_rows].numpy())
    return np.concatenate(xs), np.concatenate(ys), time.perf_counter() - start


def _fill(stream, n, dev):
    """The consumer of phase 6's feed: each batch's real rows copied into
    one preallocated [n, F] tensor on the card; (bins, labels, seconds)."""
    bins = torch.empty((n, N_FEATURES), dtype=torch.uint8, device=dev)
    label = torch.empty(n, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    start = time.perf_counter()
    row = 0
    for b in stream:
        k = b.num_rows
        bins[row:row + k] = b.bins[:k]
        label[row:row + k] = b.label[:k]
        row += k
    torch.cuda.synchronize()
    if row != n:
        fail(f"the feed delivered {row} rows, expected {n}")
    return bins, label, time.perf_counter() - start


def _feed(card, binned, n, dev):
    """``DeviceFeedLoader`` (prefetch 2) into the card: a first epoch with
    telemetry on, which times each hand-off's wait, then a warm epoch
    (the pinned ring allocated) with telemetry off, beside synchronous
    pageable ``.to(card)`` copies of the same batches into the same
    consumer.  Returns the warm epoch's bins and labels."""
    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.bridge.binning import BinnedBatch
    from dmlc_core_tpu_torch.bridge.loader import (DeviceFeedLoader,
                                                   batch_nbytes)

    nbytes = sum(batch_nbytes(b) for b in binned)
    loader = DeviceFeedLoader(lambda: iter(binned), prefetch=2)
    telemetry.enable()
    telemetry.reset()
    _, _, cold = _fill(loader, n, dev)
    wait = telemetry.get_registry().counter(
        "dmlc_transfer_seconds_total", path="device_feed",
        phase="wait").value
    telemetry.reset()
    telemetry.disable()
    bins, label, warm = _fill(loader, n, dev)
    _, _, sync = _fill((BinnedBatch(*(t.to(dev) for t in b[:3]),
                                    num_rows=b.num_rows) for b in binned),
                       n, dev)
    print(f"feed of {len(binned)} batches, {nbytes:,} batch bytes: pinned "
          f"ring (prefetch 2) {warm:.4f} s warm, {nbytes / warm / 1e9:.3f} "
          f"GB/s; first epoch with telemetry {cold:.4f} s, non-overlapped "
          f"wait {wait:.4f} s; synchronous pageable .to(card) {sync:.4f} s, "
          f"{nbytes / sync / 1e9:.3f} GB/s [{card}]", flush=True)
    return bins, label


def phase_ingest(card, ref):
    import tempfile

    from dmlc_core_tpu_torch import native_bridge
    from dmlc_core_tpu_torch.bridge.binning import HostBinner, binned_batches
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 6: ingest, {N_INGEST:,} libsvm rows and {N_CSV:,} CSV "
          f"rows of phase 4's data -> parser -> batches -> uint8 wire -> "
          f"device feed -> fit_binned", flush=True)
    dev = torch.device("cuda")
    x, y = ref["x"][:N_INGEST], ref["y"][:N_INGEST]
    here = os.path.dirname(os.path.abspath(__file__))
    # the libsvm file outlives the phase: phase 13 uploads it to a bucket
    svm = _ingest_path()
    os.makedirs(os.path.dirname(svm), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "train.csv")
        start = time.perf_counter()
        svm_bytes = _write_text(svm, x, y, " ", " ", "{}:%.9g")
        csv_bytes = _write_text(csv, x[:N_CSV], y[:N_CSV], ",", ",", "%.9g")
        print(f"wrote {svm_bytes:,} bytes of libsvm and {csv_bytes:,} bytes "
              f"of CSV in {time.perf_counter() - start:.2f} s [{card}]",
              flush=True)

        # the ingest path: counts set to 0 just before, read just after
        hist_cuda.reset_launches()
        native_bridge.reset_engine_calls()
        files = (("libsvm", svm, svm_bytes, N_INGEST),
                 ("csv", csv + "?format=csv&label_column=0", csv_bytes, N_CSV))
        parsed = {}
        for name, uri, nbytes, rows in files:
            blocks, sec = _parse_blocks(uri)
            px, py, dense_sec = _dense_rows(blocks, N_FEATURES)
            print(f"parse {name}, native engine: {sec:.3f} s, "
                  f"{nbytes / sec / 1e6:.2f} MB/s, {rows / sec:,.0f} rows/s; "
                  f"dense_batches {dense_sec:.3f} s [{card}]", flush=True)
            if not (np.array_equal(px.view(np.uint32),
                                   x[:rows].view(np.uint32))
                    and np.array_equal(py.view(np.uint32),
                                       y[:rows].view(np.uint32))):
                fail(f"the parsed {name} features or labels are not bitwise "
                     f"the float32 arrays that were written")
            parsed[name] = blocks, px
        calls = dict(native_bridge.ENGINE_CALLS)
        print(f"native engine calls: {calls}", flush=True)
        if calls["parse_libsvm"] == 0 or calls["parse_csv"] == 0:
            fail("phase 6 parsed without the native engine")
        print("parsed features and labels bitwise equal to the written "
              "float32 arrays (libsvm and CSV)", flush=True)
        # the same files through the numpy engine, asked for explicitly
        with _env(DMLC_TPU_DISABLE_NATIVE="1"):
            for name, uri, nbytes, rows in files:
                blocks, sec = _parse_blocks(uri)
                print(f"parse {name}, numpy engine: {sec:.3f} s, "
                      f"{nbytes / sec / 1e6:.2f} MB/s, {rows / sec:,.0f} "
                      f"rows/s [{card}]", flush=True)
                if not _same_columns(blocks, parsed[name][0]):
                    fail(f"the numpy engine's {name} columns differ from "
                         f"the native engine's")
                del blocks
        if native_bridge.ENGINE_CALLS != calls:
            fail("the numpy engine called into the native library")
        print("numpy engine's merged columns bitwise the native engine's "
              "(libsvm and CSV)", flush=True)
        blocks, px = parsed.pop("libsvm")
        del parsed
        from dmlc_core_tpu_torch.data.row_block import concat_blocks

        # phase 13 holds its parses from the bucket against this one
        ref["ingest_columns"] = concat_blocks(blocks)

        param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                     num_bins=NUM_BINS, learning_rate=0.3)
        model = GBDT(GBDTParam(**param), num_feature=N_FEATURES)
        start = time.perf_counter()
        model.make_bins(px[:50_000])
        binner = HostBinner(model.boundaries, NUM_BINS)
        binned = list(binned_batches(blocks, binner, INGEST_BATCH))
        bin_sec = time.perf_counter() - start
        del blocks, px
        wire = np.concatenate([b.bins[:b.num_rows].numpy() for b in binned])
        same_wire = np.array_equal(wire, ref["wire"][:N_INGEST])
        print(f"binning (edges on 50,000 rows, binned_batches): {bin_sec:.3f} "
              f"s [{card}]; wire bitwise equal to phase 4's "
              f"binner.transform: {same_wire}", flush=True)
        if not same_wire:
            fail("the binned_batches wire differs from phase 4's")

        bins, y_dev = _feed(card, binned, N_INGEST, dev)
        want = torch.from_numpy(ref["wire"][:N_INGEST]).to(dev)
        if not torch.equal(bins, want):
            fail("the fed tensor differs from torch.from_numpy(wire).to(card)")
        if not torch.equal(y_dev, ref["y_tr"][:N_INGEST]):
            fail("the fed labels differ from the written labels")
        print("fed tensor bitwise equal to torch.from_numpy(wire).to(card)",
              flush=True)

        (ens, margin), fit_sec = device_time(model.fit_binned, bins, y_dev)
        torch.cuda.synchronize()
        launches = dict(hist_cuda.LAUNCHES)
        print(f"ingest-path fit: {fit_sec:.3f} s [{card}]")
        print(f"phase 6 launches on the ingest path: {launches}", flush=True)
        if launches["grad_hist_fused_cuda"] < ROUNDS * MAX_DEPTH:
            fail(f"the ingest-path fit launched K3's kernel "
                 f"{launches['grad_hist_fused_cuda']} times, expected >= "
                 f"{ROUNDS * MAX_DEPTH}")
        if launches["hist_matmul_cuda"] != 0:
            fail("the ingest-path fit launched K1")
        # the same rows from the in-memory arrays, as phase 4 fits them
        ref_ens, ref_margin = ref["model"].fit_binned(
            ref["bins"][:N_INGEST], ref["y_tr"][:N_INGEST])
        same = (all(torch.equal(a, b) for a, b in zip(ens, ref_ens))
                and torch.equal(margin, ref_margin))
        acc = ((margin > 0).float() == y_dev).float().mean().item()
        print(f"ingest-path fit's ensemble and margin bitwise equal to the "
              f"phase-4 auto fit of the same rows from memory: {same}; train "
              f"acc {acc:.4f}", flush=True)
        if not same:
            fail("the ingest-path fit differs from the in-memory fit")
        ref["ingest_fit"] = ens, margin
        del bins, y_dev, want, binned

        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.examples.train_gbdt",
               "--data", svm, "--num-feature", str(N_FEATURES), "--rounds",
               str(ROUNDS), "--max-depth", str(MAX_DEPTH)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        cli_sec = time.perf_counter() - start
        print(proc.stdout.strip())
        if proc.returncode != 0:
            fail(f"the train_gbdt CLI exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        accs = [float(line.rsplit(" ", 1)[1]) for line in
                proc.stdout.splitlines() if "train acc" in line]
        print(f"train_gbdt CLI: exit 0 in {cli_sec:.1f} s, train acc "
              f"{accs} [{card}]", flush=True)
        if not accs or accs[0] < 0.8:
            fail(f"the train_gbdt CLI's train accuracy {accs} < 0.8")
    torch.cuda.empty_cache()


# -- phase 7: serve ------------------------------------------------------------
class _Client:
    """One keep-alive HTTP connection, as a scoring client holds one."""

    def __init__(self, url):
        import http.client
        from urllib.parse import urlparse

        u = urlparse(url)
        self._conn = http.client.HTTPConnection(u.hostname, u.port,
                                                timeout=60)

    def post(self, path, body):
        self._conn.request("POST", path, body=body,
                           headers={"Content-Type": "application/json"})
        resp = self._conn.getresponse()
        return resp.status, json.loads(resp.read())

    def get(self, path):
        self._conn.request("GET", path)
        resp = self._conn.getresponse()
        return resp.status, json.loads(resp.read())

    def post_raw(self, path, body):
        self._conn.request("POST", path, body=body,
                           headers={"Content-Type": "application/json"})
        resp = self._conn.getresponse()
        return resp.status, resp.read()

    def close(self):
        self._conn.close()


def _wave(url, pool, rng, stop_after=None, on_answer=None):
    """Requests of 1-64 pool rows from SERVE_CLIENTS threads, each on its
    own keep-alive connection: ``stop_after`` of them, or until
    ``on_answer(reply)`` returns True.  Returns (answers, wall seconds);
    each answer is (status, body, row ids, sent, received) on the host
    clock."""
    answers = []
    lock = threading.Lock()
    stop = threading.Event()
    errors = []

    def client():
        conn = _Client(url)
        try:
            while not stop.is_set():
                with lock:
                    if stop_after is not None and \
                            len(answers) + in_flight[0] >= stop_after:
                        return
                    in_flight[0] += 1
                    idx = rng.randint(0, len(pool),
                                      rng.randint(1, SERVE_MAX_BATCH + 1))
                body = json.dumps({"instances": pool[idx].tolist()})
                sent = time.perf_counter()
                status, reply = conn.post("/v1/score", body)
                got = time.perf_counter()
                with lock:
                    in_flight[0] -= 1
                    answers.append((status, reply, idx, sent, got))
                    if on_answer is not None and on_answer(reply):
                        stop.set()
        except Exception as exc:        # surfaced by the caller's fail()
            errors.append(repr(exc))
            stop.set()
        finally:
            conn.close()

    in_flight = [0]
    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - start
    if errors or any(t.is_alive() for t in threads):
        fail(f"phase 7 clients failed: {errors[:3]}")
    return answers, wall


def _check_answers(answers, want, label):
    """Every answer 200 and bitwise the predict_float scores of the
    version that answered it; returns the versions seen."""
    versions = set()
    for status, reply, idx, _, _ in answers:
        if status != 200:
            fail(f"{label}: a request answered {status}: {reply}")
        v = reply.get("version")
        if v not in want:
            fail(f"{label}: an answer from unknown version {v!r}")
        got = np.asarray(reply["predictions"], np.float32)
        if not np.array_equal(got.view(np.uint32),
                              want[v][idx].view(np.uint32)):
            fail(f"{label}: an answer of version {v} is not bitwise that "
                 f"version's predict_float")
        versions.add(v)
    return versions


def _latency_line(answers, wall, label, card):
    lat = np.array([got - sent for _, _, _, sent, got in answers]) * 1e3
    rows = sum(len(idx) for _, _, idx, _, _ in answers)
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    print(f"{label}: {len(answers)} requests, latency p50 {p50:.3f} ms, "
          f"p95 {p95:.3f} ms, p99 {p99:.3f} ms; {len(answers) / wall:.1f} "
          f"requests/s, {rows / wall:.0f} rows/s [{card}]", flush=True)
    return len(answers) / wall


def _predict_ms(runtime, rows, reps):
    """Median milliseconds of one synchronous ``predict`` (host binning,
    transfer, trees, scores back on the host)."""
    times = []
    for _ in range(reps + 1):
        start = time.perf_counter()
        runtime.predict(rows)
        times.append(time.perf_counter() - start)
    return 1e3 * float(np.median(times[1:]))


def phase_serve(card, ref):
    from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                       load_checkpoint)
    from dmlc_core_tpu_torch.models.gbdt import GBDT
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.serve import (CheckpointWatcher, GBDTRuntime,
                                           ModelRegistry, ScoringServer,
                                           build_runtime, runtime_builder)

    print(f"== phase 7: serve the phase-4 model ({N_FEATURES} features, "
          f"{NUM_BINS} bins, depth {MAX_DEPTH}, {ROUNDS} rounds) over HTTP "
          f"from a checkpoint, hot-swap {SERVE_APPEND_ROUNDS} appended "
          f"rounds, then the CLI", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    directory = os.path.join(here, "build", "chip_smoke_serve")
    shutil.rmtree(directory, ignore_errors=True)
    model, ens = ref["model"], ref["ens"]
    pool = ref["x"][N_ROWS:N_ROWS + SERVE_POOL]
    rng = np.random.RandomState(7)
    mgr = CheckpointManager(directory, keep=5)

    # the serving path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    mgr.save(1, model.serving_state(ens), async_=False)
    uri1 = mgr.step_uri(1)
    runtime = build_runtime("gbdt", N_FEATURES, checkpoint=uri1)
    if runtime.gbdt.device.type != "cuda":
        fail(f"build_runtime served on {runtime.gbdt.device}, not cuda")
    want = {1: runtime.predict_float(pool)}
    plain, plain_ens = GBDT.from_serving_state(load_checkpoint(uri1),
                                               device="cpu")
    cpu = plain.predict(plain_ens, plain.bin_features(pool)).numpy()
    err = float(np.abs(cpu - want[1]).max())
    print(f"step 1 blob {os.path.getsize(uri1):,} bytes; predict_float on "
          f"the card vs the CPU plain version on {SERVE_POOL} rows: max abs "
          f"err {err:.3g}", flush=True)
    if err > 1e-6:
        fail(f"the card's predict_float differs from the CPU plain version "
             f"by {err:.3g} > 1e-6")
    registry = ModelRegistry()
    registry.add("gbdt", runtime, version=1, max_batch=SERVE_MAX_BATCH,
                 max_delay_ms=2.0, default=True)
    server = ScoringServer(registry, host="127.0.0.1", port=0)
    start = time.perf_counter()
    server.start()
    warm_s = time.perf_counter() - start
    watcher = CheckpointWatcher(registry, "gbdt", directory,
                                runtime_builder("gbdt", N_FEATURES),
                                poll_s=0.05, manager=mgr)
    watcher.start()
    try:
        print(f"warmup (bucket ladder {registry.get().batcher.buckets}) and "
              f"start: {warm_s:.3f} s [{card}]", flush=True)
        answers, wall = _wave(server.url, pool, rng,
                              stop_after=SERVE_REQUESTS)
        _check_answers(answers, want, "wave 1")
        rate = _latency_line(
            answers, wall, f"wave 1 ({SERVE_CLIENTS} clients, "
            f"1-{SERVE_MAX_BATCH} rows each, max_batch {SERVE_MAX_BATCH}, "
            f"max_delay_ms 2)", card)

        # wave 2: the clients keep sending while 2 rounds are appended on
        # the card and published as step 2
        swap = {}

        def trainer():
            try:
                ens2, _ = model.append_rounds(
                    ens, ref["bins"], ref["y_tr"],
                    num_rounds=SERVE_APPEND_ROUNDS)
                want[2] = GBDTRuntime(model, ens2).predict_float(pool)
                swap["publish"] = time.perf_counter()
                mgr.save(2, model.serving_state(ens2), async_=False)
            except Exception as exc:    # surfaced by fail() below
                swap["error"] = repr(exc)

        seen_v2 = [0]
        wave_start = time.perf_counter()

        def swapped_and_settled(reply):
            # stop at the 500th answer from step 2 (or when the trainer
            # failed, or after 120 s, which fail below)
            seen_v2[0] += reply.get("version") == 2
            return (seen_v2[0] >= 500 or "error" in swap
                    or time.perf_counter() - wave_start > 120)

        t = threading.Thread(target=trainer)
        t.start()
        answers2, _ = _wave(server.url, pool, rng,
                            on_answer=swapped_and_settled)
        t.join(300)
        if "publish" not in swap:
            fail(f"appending rounds for step 2 failed: {swap.get('error')}")
        versions = _check_answers(answers2, want, "wave 2")
        first2 = min(got for _, reply, _, _, got in answers2
                     if reply.get("version") == 2)
        print(f"wave 2 through the hot swap: {len(answers2)} requests, all "
              f"200, versions {sorted(versions)}; every answer bitwise its "
              f"version's predict_float; publish -> first step-2 answer "
              f"{first2 - swap['publish']:.3f} s (swap cycle "
              f"{watcher.swaps_completed} ok, {watcher.rejections} "
              f"rejected) [{card}]", flush=True)
        if versions != {1, 2} or watcher.rejections:
            fail(f"the hot swap did not serve both versions cleanly: "
                 f"{sorted(versions)}, {watcher.rejections} rejections")
        plain, plain_ens = GBDT.from_serving_state(
            load_checkpoint(mgr.step_uri(2)), device="cpu")
        cpu = plain.predict(plain_ens, plain.bin_features(pool)).numpy()
        err = float(np.abs(cpu - want[2]).max())
        print(f"step 2: predict_float on the card vs the CPU plain version "
              f"from its blob: max abs err {err:.3g}", flush=True)
        if err > 1e-6:
            fail(f"step 2's predict_float differs from the CPU plain "
                 f"version by {err:.3g} > 1e-6")
        conn = _Client(server.url)
        try:
            status, health = conn.get("/healthz")
            bad_status, bad = conn.post(
                "/v1/score", json.dumps(
                    {"instances": [[0.0] * (N_FEATURES - 1)]}))
        finally:
            conn.close()
        print(f"/healthz after the swap: status {health['status']}, "
              f"version {health['version']}; a {N_FEATURES - 1}-wide row: "
              f"{bad_status} {bad}", flush=True)
        if status != 200 or health["version"] != 2:
            fail(f"/healthz after the swap: {status} {health}")
        if bad_status != 400 or bad.get("error", {}).get("code") \
                != "bad_request":
            fail(f"a wrong-width request got {bad_status} {bad}")
        live = registry.get().runtime
        small, large = pool[:64], ref["x"][N_ROWS:N_ROWS + 65_536]
        print(f"direct predict of the step-2 model: 64 rows "
              f"{_predict_ms(live, small, 20):.3f} ms, 65,536 rows "
              f"{_predict_ms(live, large, 5):.3f} ms [{card}]", flush=True)
        seeded = build_runtime("gbdt", N_FEATURES, seed=0)
        if not np.isfinite(seeded.predict(small)).all():
            fail("the seeded runtime's scores are not finite")
    finally:
        watcher.close()
        server.drain(timeout_s=30, settle_s=0.1)
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)
    need = SERVE_APPEND_ROUNDS * MAX_DEPTH + 8 * 3
    print(f"phase 7 launches on the serving path (the appended rounds and "
          f"the seeded runtime's fit): {launches}", flush=True)
    if launches["grad_hist_fused_cuda"] < need:
        fail(f"phase 7 launched K3's kernel "
             f"{launches['grad_hist_fused_cuda']} times, expected >= {need}")

    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.serve", "--model",
           "gbdt", "--checkpoint", uri1, "--num-feature", str(N_FEATURES),
           "--port", "0"]
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    # a CLI that hangs before its first line must not hang the phase
    killer = threading.Timer(CLI_TIMEOUT_S, proc.kill)
    killer.start()
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving gbdt on http://"):
            proc.kill()
            fail(f"the serve CLI printed {line!r}: "
                 f"{proc.communicate()[1][-3000:]}")
        up_s = time.perf_counter() - start
        url = line.split(" on ", 1)[1].split()[0]
        idx = np.arange(17)
        conn = _Client(url)
        try:
            status, reply = conn.post("/v1/score", json.dumps(
                {"instances": pool[idx].tolist()}))
        finally:
            conn.close()
        got = np.asarray(reply.get("predictions", []), np.float32)
        same = status == 200 and np.array_equal(
            got.view(np.uint32), want[1][idx].view(np.uint32))
        proc.send_signal(signal.SIGTERM)
        out, err_text = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    print(f"serve CLI: up in {up_s:.1f} s; one POST of 17 rows {status}, "
          f"bitwise the in-process step-1 answer: {same}; exit "
          f"{proc.returncode}, {out.strip().splitlines()[-1:]} [{card}]",
          flush=True)
    if not same:
        fail(f"the serve CLI answered {status} {reply}")
    if proc.returncode != 0 or "serve: shut down cleanly" not in out:
        fail(f"the serve CLI did not shut down cleanly: {err_text[-3000:]}")
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    return rate


# -- phase 8: train ------------------------------------------------------------
def _k3_launches():
    from dmlc_core_tpu_torch.ops import hist_cuda

    torch.cuda.synchronize()
    return hist_cuda.LAUNCHES["grad_hist_fused_cuda"]


def _check_k3(label, want):
    """Exactly ``want`` K3 launches since the last reset, and K1 none."""
    from dmlc_core_tpu_torch.ops import hist_cuda

    got = _k3_launches()
    print(f"{label}: {got} K3 launches (6 a round), K1 "
          f"{hist_cuda.LAUNCHES['hist_matmul_cuda']}", flush=True)
    if got != want or hist_cuda.LAUNCHES["hist_matmul_cuda"]:
        fail(f"{label}: K3 launched {got} times, expected {want} (K1 "
             f"{hist_cuda.LAUNCHES['hist_matmul_cuda']})")
    return got


def _fit_with_eval(card, ref):
    """8a: ``fit_with_eval`` on phase 4's rows with its held-out rows."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    dev = torch.device("cuda")
    held = torch.from_numpy(ref["wire"][N_ROWS:]).to(dev)
    y_te = torch.from_numpy(ref["y"][N_ROWS:]).to(dev)
    param = dict(max_depth=MAX_DEPTH, num_bins=NUM_BINS)

    def model(rounds, lr=0.3):
        m = GBDT(GBDTParam(num_boost_round=rounds, learning_rate=lr,
                           **param), N_FEATURES)
        m.set_boundaries(ref["model"].boundaries)
        return m

    m10 = model(ROUNDS)
    hist_cuda.reset_launches()
    (ens, hist), sec = device_time(m10.fit_with_eval, ref["bins"],
                                   ref["y_tr"], held, y_te)
    same = all(torch.equal(a, b) for a, b in zip(ens, ref["ens"]))
    curve = m10.staged_losses(ens, held, y_te)
    err = max(abs(float(c) - h["eval_loss"]) for c, h in zip(curve, hist))
    print(f"8a fit_with_eval, {ROUNDS} rounds on {N_ROWS:,} rows, eval on "
          f"{N_HELDOUT:,}: {sec:.3f} s [{card}]; ensemble bitwise equal to "
          f"phase 4's auto fit: {same}; eval loss {hist[0]['eval_loss']:.5f}"
          f" -> {hist[-1]['eval_loss']:.5f}, max |eval_loss - "
          f"staged_losses| {err:.3g}", flush=True)
    if not same:
        fail("fit_with_eval's ensemble differs from phase 4's auto fit")
    if len(hist) != ROUNDS or err > 1e-6:
        fail(f"fit_with_eval's history ({len(hist)} rounds) disagrees with "
             f"staged_losses by {err:.3g} > 1e-6")
    launches = ROUNDS * MAX_DEPTH
    # learning rates 1.5 and 2 overshoot, so the eval loss stops falling
    # within 40 rounds and the stopping rule truncates
    truncated = 0
    for lr, metrics in ((0.3, ("loss", "error")), (1.5, ("loss",)),
                        (2.0, ("loss",))):
        m40 = model(EVAL_ROUNDS, lr)
        (full, full_hist), sec = device_time(m40.fit_with_eval, ref["bins"],
                                             ref["y_tr"], held, y_te)
        launches += EVAL_ROUNDS * MAX_DEPTH
        print(f"8a {EVAL_ROUNDS} rounds at learning rate {lr} without early "
              f"stopping: {sec:.3f} s [{card}]", flush=True)
        for metric in metrics:
            (stop, stop_hist), sec = device_time(
                m40.fit_with_eval, ref["bins"], ref["y_tr"], held, y_te,
                early_stopping_rounds=EVAL_PATIENCE, eval_metric=metric)
            launches += len(stop_hist) * MAX_DEPTH
            kept = stop.num_trees
            truncated += kept < EVAL_ROUNDS
            same = all(torch.equal(a, b[:kept]) for a, b in zip(stop, full))
            if metric == "loss":
                same = same and [h["eval_loss"] for h in stop_hist] == \
                    [h["eval_loss"] for h in full_hist[:len(stop_hist)]]
            print(f"8a early stopping (learning rate {lr}, eval_metric "
                  f"{metric!r}, patience {EVAL_PATIENCE}): {len(stop_hist)} "
                  f"rounds run, best round {kept - 1}, {sec:.3f} s [{card}]; "
                  f"the kept trees bitwise the first {kept} of the "
                  f"{EVAL_ROUNDS}-round fit: {same}", flush=True)
            if not same:
                fail(f"early stopping ({lr}, {metric}) kept trees that "
                     f"differ from the uninterrupted fit's")
    if not truncated:
        fail("no early-stopping fit stopped within 40 rounds")
    _check_k3("8a launches", launches)


def _classifier(card, ref, tmp):
    """8b: the sklearn facade on the card at full width."""
    from dmlc_core_tpu_torch.models.sklearn import GBDTClassifier
    from dmlc_core_tpu_torch.ops import hist_cuda

    x, y = ref["x"], ref["y"]
    hist_cuda.reset_launches()
    clf = GBDTClassifier(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                         num_bins=NUM_BINS, learning_rate=0.3,
                         device="cuda")
    start = time.perf_counter()
    clf.fit(x[:N_ROWS], y[:N_ROWS])
    torch.cuda.synchronize()
    sec = time.perf_counter() - start
    if clf.model_.device.type != "cuda":
        fail(f"GBDTClassifier trained on {clf.model_.device}")
    acc = clf.score(x[N_ROWS:], y[N_ROWS:])
    imp = clf.feature_importances_
    path = os.path.join(tmp, "classifier.bin")
    clf.save_model(path)
    loaded = GBDTClassifier.load_model(path, device="cuda")
    proba = clf.predict_proba(x[N_ROWS:])
    same = np.array_equal(loaded.predict_proba(x[N_ROWS:]), proba)
    print(f"8b GBDTClassifier(device='cuda').fit on {N_ROWS:,} raw rows "
          f"(edges, binning, {ROUNDS} rounds): {sec:.3f} s [{card}]; "
          f"held-out accuracy {acc:.4f}; feature_importances_ sum "
          f"{imp.sum():.9f}; save_model -> load_model predict_proba bitwise "
          f"equal: {same}", flush=True)
    if acc < 0.8:
        fail(f"GBDTClassifier held-out accuracy {acc:.4f} < 0.8")
    if abs(imp.sum() - 1.0) > 1e-6 or (imp < 0).any():
        fail(f"feature_importances_ sum {imp.sum()}")
    if not same or proba.shape != (N_HELDOUT, 2):
        fail("the loaded classifier's predict_proba differs")
    _check_k3("8b launches", ROUNDS * MAX_DEPTH)


class _Timed:
    """Seconds spent in wrapped calls (the card synchronized around each
    unless ``sync=False``), and each call's (result, end time)."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}

    def wrap(self, name, fn, sync=True):
        def timed(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            end = time.perf_counter()
            self.seconds[name] = self.seconds.get(name, 0.0) + end - start
            self.calls.setdefault(name, []).append((out, end))
            return out
        return timed


class _Paced:
    """The spool source, paced by the server: the next batch is handed out
    only once the newest published step has answered ``TRAIN_GATE_ANSWERS``
    requests, so every step serves before the next replaces it."""

    def __init__(self, inner, seen, lock):
        self.inner = inner
        self.seen = seen
        self.lock = lock
        self.daemon = None

    def next_batch(self, cursor):
        published = self.daemon.publishes_completed
        with self.lock:
            ready = published == 0 or \
                self.seen.get(published, 0) >= TRAIN_GATE_ANSWERS
        return self.inner.next_batch(cursor) if ready else None

    def exhausted(self, cursor):
        return self.inner.exhausted(cursor)


def _train_param():
    from dmlc_core_tpu_torch.models.gbdt import GBDTParam

    return GBDTParam(max_depth=MAX_DEPTH, num_bins=NUM_BINS,
                     learning_rate=0.3)


def _final_step(directory):
    from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                       load_checkpoint)

    mgr = CheckpointManager(directory)
    step, _ = mgr.latest_valid(verify=True)
    if step is None:
        fail(f"no valid step under {directory}")
    return step, load_checkpoint(mgr.step_uri(step))


def _daemon_in_process(card, ref, spool, ckpt):
    """8c: the daemon on the card over the spool, its steps served live."""
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.serve import (CheckpointWatcher, ModelRegistry,
                                           ScoringServer, build_runtime,
                                           runtime_builder)
    from dmlc_core_tpu_torch.train import DirectorySource, TrainerDaemon

    seen, lock = {}, threading.Lock()
    source = _Paced(DirectorySource(spool, N_FEATURES), seen, lock)
    daemon = TrainerDaemon(ckpt, source, N_FEATURES, param=_train_param(),
                           rounds_per_batch=TRAIN_ROUNDS_PER_BATCH,
                           publish_every_rounds=TRAIN_PUBLISH_ROUNDS,
                           poll_s=0.05)
    source.daemon = daemon
    timer = _Timed()
    source.inner.next_batch = timer.wrap("parse", source.inner.next_batch,
                                         sync=False)
    daemon._train_on = timer.wrap("train", daemon._train_on)
    daemon._gbdt.predict_margin = timer.wrap("predict",
                                             daemon._gbdt.predict_margin)
    daemon._gbdt.bin_features = timer.wrap("binning",
                                           daemon._gbdt.bin_features)
    daemon.publish_now = timer.wrap("publish", daemon.publish_now)
    errors = []

    def run():
        try:
            daemon.run(exit_when_idle=True)
        except Exception as exc:      # surfaced by fail() below
            errors.append(repr(exc))

    # the training path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    start = time.perf_counter()
    # a daemon thread: a run that fails below must not hang the exit
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    while daemon.publishes_completed == 0 and thread.is_alive():
        time.sleep(0.01)
    if errors or daemon.publishes_completed == 0:
        fail(f"the daemon published nothing: {errors}")
    mgr = daemon.manager
    registry = ModelRegistry()
    registry.add("gbdt", build_runtime("gbdt", N_FEATURES,
                                       checkpoint=mgr.step_uri(1)),
                 version=1, max_batch=SERVE_MAX_BATCH, max_delay_ms=2.0,
                 default=True)
    server = ScoringServer(registry, host="127.0.0.1", port=0)
    server.start()
    watcher = CheckpointWatcher(registry, "gbdt", ckpt,
                                runtime_builder("gbdt", N_FEATURES),
                                poll_s=0.05, manager=mgr)
    watcher.start()
    pool = ref["x"][N_ROWS:N_ROWS + SERVE_POOL]
    last = TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH // TRAIN_PUBLISH_ROUNDS

    def counted(reply):
        v = reply.get("version")
        with lock:
            seen[v] = seen.get(v, 0) + 1
            done = seen.get(last, 0) >= TRAIN_FINAL_ANSWERS
        return (done or bool(errors)
                or time.perf_counter() - start > 180)

    try:
        answers, _ = _wave(server.url, pool, np.random.RandomState(8),
                           on_answer=counted)
        thread.join(300)
    finally:
        watcher.close()
        server.drain(timeout_s=30, settle_s=0.1)
    if errors or thread.is_alive():
        fail(f"the daemon failed: {errors}")
    sec = time.perf_counter() - start
    state = daemon.describe()
    steps = mgr.all_steps()
    want = {v: build_runtime("gbdt", N_FEATURES,
                             checkpoint=mgr.step_uri(v)).predict_float(pool)
            for v in steps}
    versions = _check_answers(answers, want, "8c")
    firsts = {}
    for _, reply, _, _, got in answers:
        v = reply["version"]
        firsts[v] = min(firsts.get(v, got), got)
    # publish_now returns the step it published, None when nothing was new
    swap = {step: firsts[step] - end for step, end in timer.calls["publish"]
            if step is not None and step in firsts and step > 1}
    step, flat = _final_step(ckpt)
    trees = np.asarray(flat["['split_feat']"]).shape[0]
    cursor = int(np.asarray(flat["['train_cursor']"])[0])
    t = timer.seconds
    rounds_s = t["train"] - t["predict"] - t["binning"]
    rate = state["rounds_completed"] / rounds_s
    print(f"8c daemon over {TRAIN_FILES} files x {TRAIN_FILE_ROWS:,} rows "
          f"({TRAIN_ROUNDS_PER_BATCH} rounds a batch, publish every "
          f"{TRAIN_PUBLISH_ROUNDS} rounds), served live: {sec:.2f} s in all "
          f"[{card}]; parse {t['parse']:.3f} s, binning {t['binning']:.3f} "
          f"s, rounds {rounds_s:.3f} s ({rate:.1f} rounds/s), predict "
          f"(margin recompute) {t['predict']:.3f} s, publish "
          f"{t['publish']:.3f} s", flush=True)
    print(f"8c steps {steps}, final step {step}: {trees} trees, cursor "
          f"{cursor}; {len(answers)} answers, all 200 and bitwise the "
          f"predict_float of their version; versions {sorted(versions)}; "
          f"publish -> first answer of the new version "
          f"{ {k: round(v, 3) for k, v in sorted(swap.items())} } s "
          f"({watcher.swaps_completed} swaps, {watcher.rejections} "
          f"rejected) [{card}]", flush=True)
    if len(versions) < 3 or watcher.rejections:
        fail(f"8c: versions {sorted(versions)} answered, "
             f"{watcher.rejections} swaps rejected")
    if trees != TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH or \
            cursor != TRAIN_FILES or state["quarantined"]:
        fail(f"8c: the final step holds {trees} trees at cursor {cursor} "
             f"({state})")
    _check_k3("8c launches",
              TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH * MAX_DEPTH)
    return flat


def _daemon_cli(card, spool, ckpt, state_file, want):
    """8d: the CLI on the card, killed mid-round and resumed."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.train", "--data", spool,
           "--ckpt", ckpt, "--num-feature", str(N_FEATURES),
           "--rounds-per-batch", str(TRAIN_ROUNDS_PER_BATCH),
           "--publish-every-rounds", str(TRAIN_PUBLISH_ROUNDS),
           "--max-depth", str(MAX_DEPTH), "--num-bins", str(NUM_BINS),
           "--learning-rate", "0.3", "--poll-s", "0.05", "--exit-when-idle",
           "--state-file", state_file]
    kill = {"rules": [{"site": "train.round", "kind": "exit", "code": 43,
                       "match": {"incarnation": "0"}, "after": 9,
                       "times": 1}]}
    tear = {"rules": [{"site": "train.publish", "kind": "truncate",
                       "keep": 64, "match": {"phase": "durable"},
                       "times": 1}]}
    runs = []
    for extra, plan in (([], kill), (["--incarnation", "1"], tear)):
        env = dict(os.environ, DMLC_FAULT_PLAN=json.dumps(plan))
        start = time.perf_counter()
        proc = subprocess.run(cmd + extra, cwd=here, env=env,
                              capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        with open(state_file) as f:
            runs.append((proc, time.perf_counter() - start, json.load(f)))
    (killed, k_sec, k_state), (resumed, r_sec, r_state) = runs
    print(f"8d CLI killed at train.round after 9 rounds: exit "
          f"{killed.returncode} in {k_sec:.1f} s, state {k_state}; resumed "
          f"(--incarnation 1, one torn publish): exit {resumed.returncode} "
          f"in {r_sec:.1f} s, state {r_state} [{card}]", flush=True)
    if killed.returncode != 43:
        fail(f"the killed CLI exited {killed.returncode}: "
             f"{killed.stderr[-3000:]}")
    if resumed.returncode != 0:
        fail(f"the resumed CLI exited {resumed.returncode}: "
             f"{resumed.stderr[-3000:]}")
    if (r_state["resumed_from"] != 2 or r_state["publish_rejections"] != 1
            or r_state["cursor"] != TRAIN_FILES
            or r_state["trees"] != TRAIN_FILES * TRAIN_ROUNDS_PER_BATCH):
        fail(f"the resumed CLI's state {r_state}")
    _, flat = _final_step(ckpt)
    same = sorted(flat) == sorted(want) and all(
        np.array_equal(np.asarray(flat[k]), np.asarray(want[k]))
        for k in want)
    print(f"8d final ensemble bitwise equal to 8c's: {same}", flush=True)
    if not same:
        fail("the killed-and-resumed CLI's final step differs from 8c's")


def _fleet(card, path, ckpt):
    """8e: a port coordinator over a libsvm corpus and one daemon fed from
    it through ``FleetSource``."""
    from dmlc_core_tpu_torch.parallel.fleet_ingest import plan_units
    from dmlc_core_tpu_torch.tracker.rendezvous import ShardLeaseCoordinator
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.train import FleetSource, TrainerDaemon

    units = plan_units(path, 1, num_units=FLEET_UNITS, fmt="libsvm")
    coord = ShardLeaseCoordinator("127.0.0.1", units)
    hist_cuda.reset_launches()
    start = time.perf_counter()
    coord.start()
    rows = []
    try:
        source = FleetSource("w0", N_FEATURES, host="127.0.0.1",
                             port=coord.port).start()
        inner = source.next_batch

        def counting(cursor):
            batch = inner(cursor)
            if batch is not None:
                rows.append(len(batch.label))
            return batch

        source.next_batch = counting
        daemon = TrainerDaemon(ckpt, source, N_FEATURES,
                               param=_train_param(), rounds_per_batch=1,
                               publish_every_rounds=TRAIN_PUBLISH_ROUNDS,
                               poll_s=0.05)
        daemon.run(exit_when_idle=True)
        ledger = coord.result(timeout=60)
    finally:
        coord.stop()
    sec = time.perf_counter() - start
    state = daemon.describe()
    once = (len(ledger) == FLEET_UNITS
            and coord.committed_total == FLEET_UNITS
            and all(e["assigned"] == 1 for e in ledger.values())
            and coord.rejected_total == 0)
    committed = sum(e["rows"] for e in ledger.values())
    print(f"8e FleetSource over {FLEET_ROWS:,} rows in {FLEET_UNITS} units: "
          f"{sec:.2f} s [{card}]; every unit committed once: {once}; rows "
          f"committed {committed:,}, trained {sum(rows):,}; state {state}",
          flush=True)
    if not once or committed != FLEET_ROWS or sum(rows) != FLEET_ROWS:
        fail(f"8e: coverage {len(ledger)} units, {committed} committed "
             f"rows, {sum(rows)} trained rows")
    if state["rounds_completed"] != FLEET_UNITS or state["trees"] != \
            FLEET_UNITS:
        fail(f"8e: the daemon's state {state}")
    _check_k3("8e launches", FLEET_UNITS * MAX_DEPTH)


def phase_train(card, ref):
    import tempfile

    print(f"== phase 8: train: fit_with_eval and early stopping, the sklearn "
          f"facade, the continuous trainer over a spool of {TRAIN_FILES} x "
          f"{TRAIN_FILE_ROWS:,} rows (in process, served live; then the CLI "
          f"killed and resumed) and over the lease fleet", flush=True)
    phase_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _fit_with_eval(card, ref)
        _classifier(card, ref, tmp)
        spool = os.path.join(tmp, "spool")
        os.makedirs(spool)
        start = time.perf_counter()
        # the text of each TEXT_CHUNK rows once: the spool's files and the
        # fleet corpus (its first rows) are made of the same chunks
        n = TRAIN_FILES * TRAIN_FILE_ROWS
        fmt = "%.9g " + " ".join(f"{j}:%.9g" for j in range(N_FEATURES)) \
            + "\n"
        chunks = ["".join(fmt % tuple(r) for r in np.concatenate(
            [ref["y"][lo:lo + TEXT_CHUNK, None],
             ref["x"][lo:lo + TEXT_CHUNK]], axis=1).tolist())
            for lo in range(0, max(n, FLEET_ROWS), TEXT_CHUNK)]
        per_file = TRAIN_FILE_ROWS // TEXT_CHUNK
        for i in range(TRAIN_FILES):
            with open(os.path.join(spool, f"part-{i:04d}.libsvm"), "w") as f:
                f.write("".join(chunks[i * per_file:(i + 1) * per_file]))
        open(os.path.join(spool, "_DONE"), "w").close()
        corpus = os.path.join(tmp, "fleet.libsvm")
        with open(corpus, "w") as f:
            f.write("".join(chunks[:FLEET_ROWS // TEXT_CHUNK]))
        del chunks
        print(f"wrote the spool and the fleet corpus in "
              f"{time.perf_counter() - start:.2f} s [{card}]", flush=True)
        flat = _daemon_in_process(card, ref, spool,
                                  os.path.join(tmp, "ckpt_c"))
        _daemon_cli(card, spool, os.path.join(tmp, "ckpt_d"),
                    os.path.join(tmp, "state_d.json"), flat)
        _fleet(card, corpus, os.path.join(tmp, "ckpt_e"))
    print(f"phase 8: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    torch.cuda.empty_cache()


# -- phase 9: the serving tier ---------------------------------------------------
def _http_raw(sock, buf=b""):
    """One HTTP/1.1 response off a raw socket: (status, body bytes, the
    bytes read past it)."""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("EOF before a response head")
        buf += chunk
    head, _, rest = buf.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    need = 0
    for line in lines[1:]:
        key, _, value = line.partition(":")
        if key.strip().lower() == "content-length":
            need = int(value)
    while len(rest) < need:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("EOF inside a response body")
        rest += chunk
    return int(lines[0].split(" ", 2)[1]), rest[:need], rest[need:]


def _post_bytes(path, body):
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: "
            f"application/json\r\nContent-Length: {len(body)}\r\n\r\n"
            ).encode() + body


def _host_port(url):
    from urllib.parse import urlparse

    u = urlparse(url)
    return u.hostname, u.port


def _fleet_logs(fleet):
    for i in range(fleet.count):
        path = os.path.join(fleet.log_dir, f"replica-{i}.log")
        if os.path.exists(path):
            with open(path, errors="replace") as f:
                text = f.read()
            print(f"--- {path} (last 3000 bytes) ---\n{text[-3000:]}",
                  file=sys.stderr, flush=True)


def _wait_fleets(fleets, timeout_s):
    """Every replica of every fleet answering /healthz "ok"; a replica that
    exits during start-up fails the phase with its log."""
    deadline = time.perf_counter() + timeout_s
    pending = list(fleets)
    while pending:
        for fleet in list(pending):
            if any(n > 1 for n in fleet.launches()):
                _fleet_logs(fleet)
                fail(f"a {fleet.model} replica exited during start-up "
                     f"(launches {fleet.launches()})")
            try:
                fleet.wait_healthy(timeout_s=0.5)
                pending.remove(fleet)
            except RuntimeError:
                pass
        if pending and time.perf_counter() > deadline:
            for fleet in pending:
                _fleet_logs(fleet)
            fail(f"replicas not healthy after {timeout_s} s")


def _load_line(label, report, rows_s, card):
    from dmlc_core_tpu_torch.serve.loadgen import load_line

    print(f"{load_line(label, report, rows_s)} [{card}]", flush=True)


def _check_load(label, report):
    """Zero crashed, refused or wrong; every non-200 answer a structured
    503."""
    c = report["counts"]
    conns = report["connections"]
    if c["crashed"] or c["invalid"] or c["error"] or c["timeout"] \
            or c["rejected"] or conns["refused"] or conns["resets"]:
        fail(f"{label}: {c}, connections {conns}, statuses "
             f"{report['statuses']}, slowest {report['slowest_traces']}")
    if c["ok"] + c["shed"] != report["requests"] \
            or not report["accounting"]["ok"]:
        fail(f"{label}: not every request answered once, 200 or 503: {c}, "
             f"{report['accounting']}")


def _tier_evloop(card, proc, url, runtime, pool, want):
    """9a: the evloop CLI server (a process of its own on the card) under
    CHURN_CONNECTIONS idle keep-alive connections and CHURN_ACTIVE workers;
    then pipelined requests, each answer bitwise the threaded transport's
    and predict_float."""
    from dmlc_core_tpu_torch.serve import ScoringServer
    from dmlc_core_tpu_torch.serve.loadgen import run_churn

    seen = {}

    def sample_open():
        # the server's own count of open connections, mid-run
        time.sleep(CHURN_S * 0.6)
        try:
            conn = _Client(url)
            _, stats = conn.get("/stats")
            conn.close()
            seen.update({k: v for k, v in stats["metrics"].items()
                         if k.startswith("dmlc_serve_connections{")})
        except Exception as exc:      # surfaced in the printed line
            seen["error"] = repr(exc)

    sampler = threading.Thread(target=sample_open)
    sampler.start()
    report = run_churn(url, connections=CHURN_CONNECTIONS,
                       duration_s=CHURN_S, num_feature=N_FEATURES,
                       active=CHURN_ACTIVE, seed=9)
    sampler.join(60)
    conns, reqs = report["connections"], report["requests"]
    lat = report["latency_ms"]
    print(f"9a churn: {CHURN_CONNECTIONS} idle keep-alive connections + "
          f"{CHURN_ACTIVE} active workers for {CHURN_S:g} s: peak open "
          f"{conns['peak_open']}, refused {conns['refused']}, resets "
          f"{conns['resets']}, open errors {conns['open_errors']}, closed by "
          f"the server {conns['closed_by_server']}; {reqs['ok']} ok, "
          f"{reqs['errors']} errors, {report['achieved_qps']} requests/s, "
          f"p50 {lat['p50']} ms, p99 {lat['p99']} ms; the server's "
          f"connection gauges mid-run {seen} [{card}]", flush=True)
    if conns["refused"] or conns["resets"] or conns["open_errors"] \
            or conns["closed_by_server"] or reqs["errors"] or not reqs["ok"] \
            or conns["peak_open"] < CHURN_CONNECTIONS + CHURN_ACTIVE:
        fail(f"9a churn: {conns}, {reqs}")

    rng = np.random.RandomState(17)
    groups = [[rng.randint(0, len(pool), rng.randint(1, SERVE_MAX_BATCH + 1))
               for _ in range(PIPELINE_DEPTH)] for _ in range(8)]
    evloop = []
    host, port = _host_port(url)
    for group in groups:
        bodies = [json.dumps({"instances": pool[idx].tolist()}).encode()
                  for idx in group]
        with socket.create_connection((host, port), timeout=60) as s:
            s.sendall(b"".join(_post_bytes("/v1/score", b) for b in bodies))
            rest = b""
            for idx, body in zip(group, bodies):
                status, answer, rest = _http_raw(s, rest)
                evloop.append((idx, body, status, answer))
    threaded = ScoringServer(runtime, transport="threaded")
    threaded.start()
    try:
        conn = _Client(threaded.url)
        try:
            same = 0
            for idx, body, status, answer in evloop:
                threaded_status, want_body = conn.post_raw("/v1/score", body)
                reply = json.loads(answer)
                got = np.asarray(reply.get("predictions", []), np.float32)
                if status != 200 or reply["num_rows"] != len(idx) \
                        or not np.array_equal(got.view(np.uint32),
                                              want[idx].view(np.uint32)):
                    fail(f"9a: a pipelined answer is out of order or not "
                         f"bitwise predict_float: {status} {answer[:200]}")
                same += threaded_status == 200 and answer == want_body
        finally:
            conn.close()
    finally:
        threaded.drain(timeout_s=30, settle_s=0.0)
    print(f"9a pipelined: {len(evloop)} requests in {len(groups)} writes of "
          f"{PIPELINE_DEPTH}, answered in order, each bitwise predict_float;"
          f" bodies byte-identical to the threaded transport's: {same}/"
          f"{len(evloop)}", flush=True)
    if same != len(evloop):
        fail("9a: the evloop and threaded transports answered other bytes")
    proc.send_signal(signal.SIGTERM)
    out, err_text = proc.communicate(timeout=CLI_TIMEOUT_S)
    if proc.returncode != 0 or "serve: shut down cleanly" not in out:
        fail(f"9a: the evloop CLI did not shut down cleanly: "
             f"{err_text[-3000:]}")


def _tier_families(card, fleets, uris, pool):
    """9c: linear and MLP replicas (the JAX defaults) on the card behind a
    router each: within tolerance of the CPU plain version, and bitwise
    across two requests.  The MLP's bound must tell bf16 from f32: an f32
    forward of the same params, on the CPU, must read above it."""
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
    from dmlc_core_tpu_torch.serve import RouterServer, build_runtime

    rows = pool[:SERVE_MAX_BATCH]
    body = json.dumps({"instances": rows.tolist()})
    for kind, fleet in fleets.items():
        router = RouterServer(fleet.urls).start()
        try:
            conn = _Client(router.url)
            try:
                s1, first = conn.post("/v1/score", body)
                s2, again = conn.post("/v1/score", body)
            finally:
                conn.close()
        finally:
            router.close()
        got = np.asarray(first.get("predictions", []), np.float32)
        got2 = np.asarray(again.get("predictions", []), np.float32)
        cpu_rt = build_runtime(kind, N_FEATURES, checkpoint=uris[kind],
                               device="cpu")
        cpu = cpu_rt.predict(rows)
        tol = 1e-6 if kind == "linear" else MLP_TOL
        ok = (s1 == s2 == 200 and got.shape == cpu.shape
              and np.allclose(got, cpu, rtol=0 if kind == "linear" else tol,
                              atol=tol))
        err = float(np.abs(got - cpu).max()) if got.shape == cpu.shape \
            else float("inf")
        bitwise = got.shape == got2.shape and np.array_equal(
            got.view(np.uint32), got2.view(np.uint32))
        control = ""
        if kind == "mlp":
            f32 = MLP(MLPParam(num_feature=N_FEATURES, hidden="32,32",
                               num_class=2, bf16=False), device="cpu")
            f32_err = float(np.abs(
                f32.predict(cpu_rt.params, rows).numpy() - cpu).max())
            control = f"; an f32 forward of the same params reads " \
                      f"{f32_err:.3g}"
            if f32_err <= tol:
                fail(f"9c mlp: the f32 control reads {f32_err:.3g}, inside "
                     f"the bound {tol:g}: the gate cannot tell bf16 from "
                     f"f32")
        print(f"9c {kind}: {len(rows)} rows through the router to one card "
              f"replica, shape {got.shape}; max abs err vs the CPU plain "
              f"version {err:.3g} (bound {tol:g}){control}; bitwise across "
              f"two requests: {bitwise}", flush=True)
        if not ok or not bitwise:
            fail(f"9c {kind}: {s1} {s2}, err {err:.3g}, bitwise {bitwise}")


def phase_tier(card, ref, serve_rate):
    from dmlc_core_tpu_torch import telemetry
    from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
    from dmlc_core_tpu_torch.models.linear import LinearModel, LinearParam
    from dmlc_core_tpu_torch.models.mlp import MLP, MLPParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.serve import (GBDTRuntime, ReplicaFleet,
                                           build_runtime)
    from dmlc_core_tpu_torch.serve.loadgen import PoolLoad, RouterProcess

    print(f"== phase 9: the serving tier: the event loop under "
          f"{CHURN_CONNECTIONS} connections, {TIER_REPLICAS} card replicas "
          f"of the phase-4 model behind a router (open-loop load, a SIGKILL, "
          f"a rolling restart), linear and MLP replicas, a rolling model "
          f"update", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(here, "build", "chip_smoke_tier")
    shutil.rmtree(root, ignore_errors=True)
    model, ens = ref["model"], ref["ens"]
    pool = ref["x"][N_ROWS:N_ROWS + SERVE_POOL]
    telemetry.enable()

    # the serving tier's path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    mgr = CheckpointManager(os.path.join(root, "gbdt"), keep=5)
    mgr.save(1, model.serving_state(ens), async_=False)
    uri1 = mgr.step_uri(1)
    runtime = build_runtime("gbdt", N_FEATURES, checkpoint=uri1)
    want = {0: runtime.predict_float(pool)}
    want[1] = want[0]      # the watcher swaps step 1 in as version 1
    uris = {}
    for kind, make, seed in (
            ("linear", lambda: LinearModel(LinearParam(
                num_feature=N_FEATURES)), 11),
            ("mlp", lambda: MLP(MLPParam(num_feature=N_FEATURES,
                                         hidden="32,32", num_class=2)), 12)):
        m = CheckpointManager(os.path.join(root, kind))
        m.save(1, make().init_params(seed), async_=False)
        uris[kind] = m.step_uri(1)
    logs = os.path.join(root, "logs")
    fleet = ReplicaFleet(
        TIER_REPLICAS, model="gbdt", num_feature=N_FEATURES, checkpoint=uri1,
        device="cuda", log_dir=logs, max_queue_bytes=TIER_QUEUE_BYTES,
        extra_args=["--watch-dir", mgr.directory, "--watch-interval-s",
                    "0.2"])
    families = {kind: ReplicaFleet(1, model=kind, num_feature=N_FEATURES,
                                   checkpoint=uris[kind], device="cuda",
                                   log_dir=os.path.join(logs, kind))
                for kind in ("linear", "mlp")}
    cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.serve", "--model",
           "gbdt", "--checkpoint", uri1, "--num-feature", str(N_FEATURES),
           "--transport", "evloop", "--port", "0"]
    router = None
    proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    killer = threading.Timer(TIER_START_S + 300, proc.kill)
    killer.start()
    try:
        start = time.perf_counter()
        fleet.start(wait_healthy=False)
        for f in families.values():
            f.start(wait_healthy=False)
        line = proc.stdout.readline()
        if not line.startswith("serving gbdt on http://"):
            proc.kill()
            fail(f"9a: the evloop CLI printed {line!r}: "
                 f"{proc.communicate()[1][-3000:]}")
        _wait_fleets([fleet] + list(families.values()), TIER_START_S)
        print(f"phase 9 start-up: the evloop server and "
              f"{TIER_REPLICAS + 2} replicas, each its own process and CUDA "
              f"context on the one card, up in "
              f"{time.perf_counter() - start:.1f} s [{card}]", flush=True)

        _tier_evloop(card, proc, line.split(" on ", 1)[1].split()[0],
                     runtime, pool, want[0])
        _tier_families(card, families, uris, pool)
        for f in families.values():
            f.close()

        # 9b: open-loop load through the router, then a kill and a
        # rolling restart under 3x that load
        router = RouterProcess(fleet.urls)
        load = PoolLoad(pool, want, max_rows=SERVE_MAX_BATCH)
        report, rows_s, _ = load.run(router.url, serve_rate, TIER_RUN_S, 1,
                                     **TIER_LOAD)
        _load_line(f"9b run 1, {TIER_REPLICAS} replicas", report, rows_s,
                   card)
        _check_load("9b run 1", report)
        fired = 'dmlc_router_hedges_total{outcome="fired"}'
        hedges0 = router.counter(fired)
        states, drill = [], {}
        stop = threading.Event()

        def watch_r1():
            while not stop.is_set():
                try:
                    st = router.get("/healthz")["replicas"]["r1"]["state"]
                except (OSError, ValueError, KeyError):
                    st = "unread"
                if not states or states[-1] != st:
                    states.append(st)
                stop.wait(0.05)

        def chaos():
            try:
                time.sleep(TIER_KILL_AT_S)
                drill["kill"] = time.perf_counter()
                fleet.kill(1)
                while fleet.launches()[1] < 2:
                    if time.perf_counter() - drill["kill"] > 60:
                        raise RuntimeError("the monitor did not relaunch "
                                           "replica 1")
                    time.sleep(0.05)
                fleet.wait_healthy([1], timeout_s=TIER_START_S)
                drill["back"] = time.perf_counter()
                fleet.rolling_restart(settle_s=0.5, timeout_s=TIER_START_S)
                drill["rolled"] = time.perf_counter()
            except Exception as exc:    # surfaced by fail() below
                drill["error"] = repr(exc)

        watcher = threading.Thread(target=watch_r1)
        watcher.start()
        chaos_thread = threading.Thread(target=chaos)
        t0 = time.perf_counter()
        chaos_thread.start()
        report, rows_s, _ = load.run(router.url, 3 * serve_rate,
                                     TIER_CHAOS_S, 2, **TIER_LOAD)
        chaos_thread.join(2 * TIER_START_S)
        stop.set()
        watcher.join(10)
        _load_line(f"9b run 2, 3x the rate, SIGKILL of replica 1 at "
                   f"{TIER_KILL_AT_S:g} s, then a rolling restart", report,
                   rows_s, card)
        hedges = router.counter(fired) - hedges0
        print(f"9b drill: replica 1 killed at "
              f"{drill.get('kill', t0) - t0:.1f} s, back at "
              f"{drill.get('back', t0) - t0:.1f} s, rolling restart done at "
              f"{drill.get('rolled', t0) - t0:.1f} s (load ran "
              f"{report['wall_s']} s); launches {fleet.launches()}; replica "
              f"1's states at the router {states}; hedges fired {hedges:g}",
              flush=True)
        if "error" in drill or "rolled" not in drill:
            _fleet_logs(fleet)
            fail(f"9b: the kill and rolling restart failed: {drill}")
        if drill["rolled"] - t0 > report["wall_s"]:
            fail("9b: the rolling restart outlasted the load")
        _check_load("9b run 2", report)
        if "ejected" not in states \
                or "healthy" not in states[states.index("ejected"):]:
            fail(f"9b: the router never saw replica 1 ejected and healthy "
                 f"again: {states}")
        if hedges < 1:
            fail("9b: no request was hedged")
        if fleet.launches() != [2, 3, 2]:
            fail(f"9b: replica launches {fleet.launches()}, expected "
                 f"[2, 3, 2]")

        # 9d: while the fleet takes load, 2 rounds appended on the card and
        # published as step 2 in the fleet's watch directory
        swap = {}

        def trainer():
            try:
                time.sleep(2.0)
                ens2, _ = model.append_rounds(
                    ens, ref["bins"], ref["y_tr"],
                    num_rounds=SERVE_APPEND_ROUNDS)
                want[2] = GBDTRuntime(model, ens2).predict_float(pool)
                swap["publish"] = time.perf_counter()
                mgr.save(2, model.serving_state(ens2), async_=False)
                # each replica asked directly until it answers step 2
                body = json.dumps({"instances": pool[:1].tolist()})
                first = {}
                while len(first) < fleet.count:
                    if time.perf_counter() - swap["publish"] > 120:
                        raise RuntimeError(f"replicas {first} swapped")
                    for i, url in enumerate(fleet.urls):
                        if i in first:
                            continue
                        conn = _Client(url)
                        try:
                            _, reply = conn.post("/v1/score", body)
                        finally:
                            conn.close()
                        if reply.get("version") == 2:
                            first[i] = time.perf_counter()
                    time.sleep(0.02)
                swap["first"] = first
            except Exception as exc:    # surfaced by fail() below
                swap["error"] = repr(exc)

        t = threading.Thread(target=trainer)
        t.start()
        report, rows_s, versions = load.run(router.url, serve_rate,
                                            TIER_RUN_S, 3, **TIER_LOAD)
        t.join(300)
        _load_line("9d run 3, through the rolling model update", report,
                   rows_s, card)
        if "error" in swap or "first" not in swap:
            _fleet_logs(fleet)
            fail(f"9d: the model update failed: {swap}")
        _check_load("9d run 3", report)
        health = []
        for u in fleet.urls:
            conn = _Client(u)
            try:
                health.append(conn.get("/healthz")[1].get("version"))
            finally:
                conn.close()
        lag = max(swap["first"].values()) - swap["publish"]
        print(f"9d: answers by version {versions}; every replica's /healthz "
              f"version {health}; publish -> the last replica's first step-2"
              f" answer {lag:.3f} s [{card}]", flush=True)
        if health != [2] * fleet.count or not versions.get(2) \
                or not (versions.get(0) or versions.get(1)):
            fail(f"9d: not every replica swapped, or not both versions "
                 f"answered: {health}, {versions}")
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        if router is not None:
            router.close()
        for f in list(families.values()) + [fleet]:
            f.close()
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)
    need = SERVE_APPEND_ROUNDS * MAX_DEPTH
    print(f"phase 9 launches on the serving tier's path (9d's appended "
          f"rounds; scoring launches none): {launches}; phase 9 took "
          f"{time.perf_counter() - phase_start:.1f} s", flush=True)
    if launches["grad_hist_fused_cuda"] < need:
        fail(f"phase 9 launched K3's kernel "
             f"{launches['grad_hist_fused_cuda']} times, expected >= {need}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


# -- phase 10: sampling and the entry points ------------------------------------
def _draw_one_tree(p, rnd, rows, device, class_index=0):
    """One tree's draws: its row weights and column mask, and every
    level's node masks."""
    from dmlc_core_tpu_torch.models.gbdt import _level_mask_fn, _tree_sampling

    row_w, fmask = _tree_sampling(p, rnd, rows, N_FEATURES, class_index,
                                  device)
    level = _level_mask_fn(p, rnd, N_FEATURES, device)
    return [row_w, fmask] + [level(d, 2 ** d, fmask)
                             for d in range(MAX_DEPTH)]


def _draw_device_ms(p, dev):
    """Device time of one tree's draws at phase 4's rows (torch.profiler,
    device events only), and the CUDA-event time a draw takes on the
    stream (host gaps between its small launches included)."""
    from torch.profiler import ProfilerActivity, profile

    from dmlc_core_tpu_torch.utils.timer import cuda_event_ms

    stream_ms = cuda_event_ms(lambda: _draw_one_tree(p, 0, N_ROWS, dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _draw_one_tree(p, 0, N_ROWS, dev)
        torch.cuda.synchronize()
    device_us = 0.0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            device_us += next((getattr(e, n) for n in (
                "self_device_time_total", "self_cuda_time_total")
                if hasattr(e, n)), 0.0)
    return (device_us / 1e3 if device_us > 0 else None), stream_ms


def _sampled_fit(card, ref):
    """10a: phase 4's fit with row and column sampling on."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    dev = torch.device("cuda")
    base = dict(max_depth=MAX_DEPTH, num_bins=NUM_BINS, learning_rate=0.3,
                seed=SAMPLE_SEED, **SAMPLED)

    def model(rounds=ROUNDS, device=None, **kw):
        m = GBDT(GBDTParam(num_boost_round=rounds, **dict(base, **kw)),
                 N_FEATURES, device=device)
        m.set_boundaries(ref["model"].boundaries)
        return m

    bins, y_tr = ref["bins"], ref["y_tr"]
    held = torch.from_numpy(ref["wire"][N_ROWS:]).to(dev)
    y_te = torch.from_numpy(ref["y"][N_ROWS:]).to(dev)
    m = model()
    torch.cuda.synchronize()
    # the sampled path: counts set to 0 just before, read just after
    hist_cuda.reset_launches()
    fits = [device_time(m.fit_binned, bins, y_tr) for _ in range(2)]
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)
    (ens, margin), sec = fits[1]
    same = (all(torch.equal(a, b) for a, b in zip(ens, fits[0][0][0]))
            and torch.equal(margin, fits[0][0][1]))
    prob = m.predict(ens, held)
    held_acc = ((prob > 0.5).float() == y_te).float().mean().item()
    unsampled = ref["fit_sec"]
    print(f"10a sampled fit ({SAMPLED}), {ROUNDS} rounds on {N_ROWS:,} "
          f"rows: {fits[0][1]:.3f} s cold, {sec:.3f} s warm, "
          f"{N_ROWS / sec:,.0f} rows/s; phase 4's unsampled warm fit in this "
          f"run {unsampled:.3f} s, {N_ROWS / unsampled:,.0f} rows/s [{card}]",
          flush=True)
    print(f"10a launches on the sampled path (2 fits): {launches}; two fits "
          f"bitwise equal: {same}; held-out accuracy {held_acc:.4f}",
          flush=True)
    if launches["grad_hist_fused_cuda"] < ROUNDS * MAX_DEPTH:
        fail(f"the sampled fits launched K3's kernel "
             f"{launches['grad_hist_fused_cuda']} times, expected >= "
             f"{ROUNDS * MAX_DEPTH}")
    if launches["hist_matmul_cuda"]:
        fail("the sampled fits launched K1")
    if not same:
        fail("two sampled fits differ on the card")
    if held_acc < 0.8:
        fail(f"sampled fit: held-out accuracy {held_acc:.4f} < 0.8")

    # the card's draws are bitwise the CPU's
    shares = []
    for rnd, k in ((0, 0), (ROUNDS - 1, 0), (3, 2)):
        card_draw = _draw_one_tree(m.param, rnd, N_ROWS, dev, k)
        cpu_draw = _draw_one_tree(m.param, rnd, N_ROWS, torch.device("cpu"),
                                  k)
        if not all(torch.equal(a.cpu(), b)
                   for a, b in zip(card_draw, cpu_draw)):
            fail(f"the card's draws for round {rnd}, class {k} differ from "
                 f"the CPU's")
    for rnd in range(ROUNDS):
        shares.append(_draw_one_tree(m.param, rnd, N_ROWS, dev)[0]
                      .mean().item())
    print(f"10a draws (row weights, column mask, {MAX_DEPTH} level masks) "
          f"bitwise the CPU's for (round, class) (0, 0), ({ROUNDS - 1}, 0), "
          f"(3, 2); kept-row share per round {min(shares):.5f}.."
          f"{max(shares):.5f}", flush=True)
    if max(abs(v - SAMPLED["subsample"]) for v in shares) > 0.005:
        fail(f"kept-row shares {shares} outside 0.8 +- 0.005")
    draw_ms, stream_ms = _draw_device_ms(m.param, dev)
    print(f"10a one tree's draws at {N_ROWS:,} rows: device time "
          f"{'not measured' if draw_ms is None else f'{draw_ms:.3f} ms'} "
          f"(torch.profiler), {stream_ms:.3f} ms on the stream (CUDA "
          f"events); the warm fit's {ROUNDS} trees {1e3 * sec:.1f} ms "
          f"[{card}]", flush=True)

    # the streaming entry points and the eval-tracked fit grow the same bits
    half, hmargin = m.append_rounds(None, bins, y_tr,
                                    num_rounds=ROUNDS // 2)
    half, hmargin = m.append_rounds(half, bins, y_tr,
                                    num_rounds=ROUNDS - ROUNDS // 2,
                                    margin=hmargin)
    appended = (all(torch.equal(a, b) for a, b in zip(half, ens))
                and torch.equal(hmargin, margin))
    (eval_ens, hist), eval_sec = device_time(m.fit_with_eval, bins, y_tr,
                                             held, y_te)
    evaled = all(torch.equal(a, b) for a, b in zip(eval_ens, ens))
    print(f"10a append_rounds(None, ...) twice over {ROUNDS // 2} rounds "
          f"bitwise fit_binned's: {appended}; fit_with_eval ({eval_sec:.3f} "
          f"s, eval loss {hist[0]['eval_loss']:.5f} -> "
          f"{hist[-1]['eval_loss']:.5f}) bitwise fit_binned's: {evaled}",
          flush=True)
    if not appended:
        fail("append_rounds under sampling differs from fit_binned")
    if not evaled:
        fail("fit_with_eval under sampling differs from fit_binned")

    # the first tree on the card is the CPU plain version's
    trees = {}
    for where in ("cuda", "cpu"):
        mm = model(rounds=2, device=where, hist_method="pallas")
        (e, _), s = device_time(mm.fit_binned, ref["wire"][:N_AGREE],
                                ref["y"][:N_AGREE])
        trees[where] = type(e)(*(None if a is None else a.cpu() for a in e))
        print(f"10a {where}: sampled fit of {N_AGREE:,} rows, 2 rounds, "
              f"{s:.3f} s", flush=True)
    first = _same_tree(trees["cuda"], trees["cpu"], 0)
    print(f"10a first sampled tree identical on the card and the CPU: "
          f"{first}; split agreement "
          f"{_split_agreement(trees['cuda'], trees['cpu']):.4f}", flush=True)
    if not first:
        fail("the first sampled tree differs between the card and the CPU")

    # softmax: each class's tree draws its own rows
    x3 = ref["x"][:N_SOFTMAX]
    y3 = torch.from_numpy(ref["y"][:N_SOFTMAX]
                          + (x3[:, 1] > 0).astype(np.float32)).to(dev)
    soft = model(objective="softmax", num_class=3, subsample=0.8,
                 colsample_bytree=1.0, colsample_bylevel=1.0,
                 colsample_bynode=1.0)
    hist_cuda.reset_launches()
    sfits = [device_time(soft.fit_binned, bins[:N_SOFTMAX], y3)
             for _ in range(2)]
    k3 = _k3_launches()
    (sens, smargin), ssec = sfits[1]
    ssame = (all(torch.equal(a, b) for a, b in zip(sens, sfits[0][0][0]))
             and torch.equal(smargin, sfits[0][0][1]))
    sacc = (smargin.argmax(1) == y3.long()).float().mean().item()
    print(f"10a softmax, 3 classes, subsample 0.8, {N_SOFTMAX:,} rows: "
          f"{ssec:.3f} s warm, train acc {sacc:.4f}, two fits bitwise "
          f"equal: {ssame}, {k3} K3 launches [{card}]", flush=True)
    if not ssame or smargin.shape != (N_SOFTMAX, 3) \
            or not torch.isfinite(smargin).all():
        fail("the sampled softmax fits differ or have bad margins")
    if k3 < 2 * ROUNDS * 3 * MAX_DEPTH:
        fail(f"the softmax fits launched K3's kernel {k3} times")
    if sacc < 0.7:
        fail(f"sampled softmax: train accuracy {sacc:.4f} < 0.7")
    return launches


def _cli(module, *args):
    return [sys.executable, "-m", f"dmlc_core_tpu_torch.examples.{module}"] \
        + [str(a) for a in args]


def _run_wave(here, cmds):
    """Run the commands at once; each must exit 0.  Returns their output
    (stdout + stderr) by name."""
    procs = {name: subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in cmds.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            out[name] = stdout + stderr
            if proc.returncode != 0:
                fail(f"10b {name} exited {proc.returncode}: {stderr[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _entry_points(card, ref):
    """10b: the CLIs on phase 4's rows as libsvm, and the graft entry."""
    import tempfile

    from dmlc_core_tpu_torch import graft_entry

    here = os.path.dirname(os.path.abspath(__file__))
    x, y = ref["x"], ref["y"]
    with tempfile.TemporaryDirectory() as tmp:
        svm = os.path.join(tmp, "train.libsvm")
        ev = os.path.join(tmp, "eval.libsvm")
        _write_text(svm, x[:N_ENTRY], y[:N_ENTRY], " ", " ", "{}:%.9g")
        _write_text(ev, x[N_ROWS:N_ROWS + N_ENTRY_EVAL],
                    y[N_ROWS:N_ROWS + N_ENTRY_EVAL], " ", " ", "{}:%.9g")
        common = ["--data", svm, "--num-feature", N_FEATURES]
        gbdt = common + ["--max-depth", MAX_DEPTH, "--subsample", 0.8,
                         "--colsample-bynode", 0.8]
        gdir = os.path.join(tmp, "gbdt_ckpt")
        ltmpl = os.path.join(tmp, "logreg-{version}.bin")
        mdir = os.path.join(tmp, "mlp_ckpt")
        start = time.perf_counter()
        first = _run_wave(here, {
            "train_gbdt --eval-data": _cli(
                "train_gbdt", *gbdt, "--rounds", EVAL_ROUNDS,
                "--learning-rate", 1.5, "--eval-data", ev,
                "--early-stopping-rounds", EVAL_PATIENCE),
            "train_gbdt --checkpoint-dir": _cli(
                "train_gbdt", *gbdt, "--rounds", 10, "--checkpoint-every", 5,
                "--checkpoint-dir", gdir),
            "train_logreg": _cli("train_logreg", *common, "--form", "sparse",
                                 "--epochs", 1, "--checkpoint", ltmpl),
            "train_mlp": _cli("train_mlp", *common, "--epochs", 2,
                              "--checkpoint-dir", mdir)})
        wave1 = time.perf_counter() - start
        second = _run_wave(here, {
            "train_gbdt --checkpoint-dir (rerun)": _cli(
                "train_gbdt", *gbdt, "--rounds", 15, "--checkpoint-every", 5,
                "--checkpoint-dir", gdir),
            "train_logreg (rerun)": _cli(
                "train_logreg", *common, "--form", "sparse", "--epochs", 2,
                "--checkpoint", ltmpl),
            "train_mlp (rerun)": _cli("train_mlp", *common, "--epochs", 3,
                                      "--checkpoint-dir", mdir)})
        wave2 = time.perf_counter() - start - wave1
    for name, text in list(first.items()) + list(second.items()):
        lines = [line for line in text.splitlines()
                 if any(w in line for w in ("eval:", "trained ", "epoch ",
                                            "resuming"))]
        print(f"10b {name}: exit 0; " + " | ".join(lines[-4:]), flush=True)
    want = {"train_gbdt --checkpoint-dir (rerun)":
            "resuming from checkpoint step 5 (5/15 rounds done)",
            "train_logreg (rerun)": "resuming from checkpoint version 1",
            "train_mlp (rerun)": "resuming from checkpoint epoch 1"}
    for name, line in want.items():
        if line not in second[name]:
            fail(f"10b {name} did not resume: no {line!r} in its output")
    if "trees kept" not in first["train_gbdt --eval-data"]:
        fail("10b train_gbdt --eval-data printed no eval line")
    print(f"10b CLIs: two waves of 4 and 3 processes on the card, "
          f"{wave1:.1f} s and {wave2:.1f} s [{card}]", flush=True)

    fn, args = graft_entry.entry()
    got = fn(*args)
    cpu_fn, cpu_args = graft_entry.entry(device="cpu")
    err = (got.cpu() - cpu_fn(*cpu_args)).abs().max().item()
    print(f"10b graft_entry.entry() on the card: {tuple(got.shape)} "
          f"{got.device.type}, max abs diff from the CPU run {err:.3g}",
          flush=True)
    if got.device.type != "cuda" or err > 1e-6:
        fail(f"graft_entry on the card differs from the CPU by {err:.3g}")


def phase_sampling(card, ref):
    print("== phase 10: row and column sampling at full width, and the "
          "entry points (train_gbdt eval/early stopping/checkpoints, "
          "train_logreg, train_mlp, graft_entry)", flush=True)
    phase_start = time.perf_counter()
    launches = _sampled_fit(card, ref)
    _entry_points(card, ref)
    print(f"phase 10: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return launches

# -- phase 11: multi-worker training through the port's launcher ------------
def _tee_lines():
    """Copy everything written to stdout and stderr into a list of lines
    as well (the CLIs print their figures; ``tracker_print`` writes to
    stderr)."""
    import io

    lines = []

    class Tee(io.TextIOBase):
        def __init__(self, inner):
            self.inner = inner

        def write(self, text):
            self.inner.write(text)
            lines.extend(t for t in text.splitlines() if t.strip())
            return len(text)

        def flush(self):
            self.inner.flush()

    sys.stdout, sys.stderr = Tee(sys.stdout), Tee(sys.stderr)
    return lines


def _to_cpu(tree):
    """``tree`` (tensors in dicts, lists and tuples) with every tensor
    detached and on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_to_cpu(v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def cli_worker_main(outdir):
    """One rank of phase 11 (``--worker cli OUTDIR``): the CLIs named in
    ``OUTDIR/cli.json``, each through its ``main(argv)`` on a store port of
    its own; saves each run's model, launch counts, printed lines and the
    seconds of every data all-reduce of the histograms, and what the
    parent replays at world 1: the GBDT's merged boundaries, padded rows
    and the warm-up fit's first tree level by level (inputs and the
    all-reduced (G, H)); the first two logreg steps (params, batch and
    result); the first two MLP steps' params, batch and all-reduced
    (loss, gradients)."""
    from dmlc_core_tpu_torch.examples import (train_gbdt, train_logreg,
                                              train_mlp)
    from dmlc_core_tpu_torch.models import gbdt as gbdt_mod
    from dmlc_core_tpu_torch.models import linear as linear_mod
    from dmlc_core_tpu_torch.models import mlp as mlp_mod
    from dmlc_core_tpu_torch.ops import hist_cuda, histogram

    with open(os.path.join(outdir, "cli.json")) as f:
        runs = json.load(f)
    rank = int(os.environ["DMLC_TASK_ID"])
    # this rank's output in files of its own, printed on a failure
    for fd, ext in ((1, "out"), (2, "err")):
        with open(os.path.join(outdir, f"cli{rank}.{ext}"), "w") as f:
            os.dup2(f.fileno(), fd)
    # the probe's launches check the kernels; they are not the path's
    hist_cuda.kernels_available()
    allreduce_s, fit_s = [], []
    plain = histogram.data_allreduce
    fit_distributed = train_gbdt._fit_distributed
    captured = {}              # what the parent replays at world 1

    def timed_fit(model, bins, label, collective):
        captured.update(param=model.param, boundaries=model.boundaries,
                        label=label.cpu(), n_local=bins.shape[0])
        out = fit_distributed(model, bins, label, collective)
        fit_s.append(out[3])           # the slower rank's fit seconds
        return out

    def timed(*tensors):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = plain(*tensors)
        torch.cuda.synchronize()
        allreduce_s.append(time.perf_counter() - start)
        return out

    # the fit reaches the all-reduce through both modules' names
    histogram.data_allreduce = gbdt_mod.data_allreduce = timed
    train_gbdt._fit_distributed = timed_fit
    grad_histogram = gbdt_mod.grad_histogram

    def recorded_hist(bins, node, g, h, n_nodes, num_bins, **kw):
        out = grad_histogram(bins, node, g, h, n_nodes, num_bins, **kw)
        levels = captured.setdefault("levels", [])
        if len(levels) < MAX_DEPTH:        # the warm-up fit's first tree
            if not levels:
                captured["bins"] = bins.cpu()         # padded to n_max
            levels.append(_to_cpu(dict(node=node, g=g, h=h, n=n_nodes,
                                       G=out[0], H=out[1])))
        return out

    def recorded_step(step):
        def wrapped(model, *args):
            out = step(model, *args)
            steps = captured.setdefault("steps", [])
            if len(steps) < 2:
                steps.append(_to_cpu(dict(param=model.param, args=args,
                                          out=out)))
            return out
        return wrapped

    gbdt_mod.grad_histogram = recorded_hist
    linear_mod.LinearModel.train_step = recorded_step(
        linear_mod.LinearModel.train_step)
    mlp_mod.MLP._data_parallel_grads = recorded_step(
        mlp_mod.MLP._data_parallel_grads)
    mains = {"train_gbdt": train_gbdt.main, "train_logreg": train_logreg.main,
             "train_mlp": train_mlp.main}
    result = {}
    for run in runs:
        lines = _tee_lines()
        os.environ["DMLC_COORDINATOR_PORT"] = str(run["port"])
        del allreduce_s[:]
        captured.clear()
        hist_cuda.reset_launches()
        start = time.perf_counter()
        out = mains[run["module"]](run["argv"])
        wall = time.perf_counter() - start
        sys.stdout, sys.stderr = sys.stdout.inner, sys.stderr.inner
        if run["module"] == "train_gbdt":
            model = _ensemble_arrays(out[0])
        elif run["module"] == "train_logreg":
            model = {k: v.cpu() for k, v in out[0].items()}
        else:
            model = {f"{i}_{k}": layer[k].cpu()
                     for i, layer in enumerate(out[0]["layers"]) for k in "wb"}
        result[run["tag"]] = dict(model=model, launches=dict(
            hist_cuda.LAUNCHES), lines=list(lines), wall=wall,
            allreduce_s=list(allreduce_s), fit_s=list(fit_s),
            captured=dict(captured))
    torch.save(result, os.path.join(outdir, f"cli{rank}.pt"))


def _submit(args, cmd, outdir, name, timeout_s, workers=2, log="cli",
            cluster="local", cwd=None, env_extra=None):
    """``cmd`` in ``workers`` workers through the port's launcher
    (``--cluster cluster``, from ``cwd``, the repo root by default; gloo on
    the one card, a store port of its own); fail with the launch's stderr
    tail and each rank's own log (``OUTDIR/{log}{rank}.err``) on any
    failure.  Returns (stdout and stderr, seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=here,
               DMLC_COLLECTIVE_TIMEOUT=str(MW_COLLECTIVE_TIMEOUT_S))
    env.update(env_extra or {})
    full = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
            "--cluster", cluster, "--num-workers", str(workers), "--env",
            f"DMLC_COORDINATOR_PORT={_free_port()}", *args, "--", *cmd]
    start = time.perf_counter()
    try:
        proc = subprocess.run(full, cwd=cwd or here, env=env,
                              capture_output=True, text=True,
                              timeout=timeout_s)
        rc, out, err = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = "timeout", str(exc.stdout or ""), str(exc.stderr or "")
    secs = time.perf_counter() - start
    if rc != 0:
        print(f"--- {name} launch ({rc}) stderr tail:\n{err[-4000:]}",
              file=sys.stderr, flush=True)
        for rank in range(workers):
            path = os.path.join(outdir, f"{log}{rank}.err")
            if os.path.exists(path):
                with open(path) as f:
                    tail = f.read()[-3000:]
                print(f"--- {name} rank {rank} stderr tail:\n{tail}",
                      file=sys.stderr, flush=True)
        fail(f"{name}: the {workers}-worker launch exited {rc}")
    return out + err, secs


def _over_two(lines):
    """The ``trained ... over 2 workers ...`` summaries in printed lines
    (two ranks printing at once may run their lines together)."""
    import re

    return re.findall(r"trained \d+ rounds on \d+ rows over 2 workers in "
                      r"[^\n]*?train acc \d+\.\d{4}", "\n".join(lines))


def _global_batch(b0, b1):
    """Two ranks' step batches as the one global batch of a world-1 step:
    rank 0's rows, then rank 1's (sparse row ids shifted, both padding
    sentinels moved to the global row count)."""
    cat = torch.cat
    rows = (None if b0.num_rows is None or b1.num_rows is None
            else b0.num_rows + b1.num_rows)
    if hasattr(b0, "x"):
        return type(b0)(cat([b0.x, b1.x]), cat([b0.label, b1.label]),
                        cat([b0.weight, b1.weight]), rows)
    n0, n1 = b0.label.shape[0], b1.label.shape[0]
    row0 = torch.where(b0.row_id == n0, n0 + n1, b0.row_id)
    field = None if b0.field is None else cat([b0.field, b1.field])
    return type(b0)(cat([b0.value, b1.value]), cat([b0.index, b1.index]),
                    cat([row0, b1.row_id + n0]), cat([b0.label, b1.label]),
                    cat([b0.weight, b1.weight]), field, rows)


def _close(got, want, rtol, atol):
    """(whether ``got`` is within tolerance of ``want``, max abs err)."""
    got, want = got.float().cpu(), want.float().cpu()
    return (torch.allclose(got, want, rtol=rtol, atol=atol),
            (got - want).abs().max().item())


def _gbdt_against_world_one(card, caps, ens2):
    """11a: the ranks' GBDT against the plain histogram and a world-1 fit.

    The warm-up fit's first tree, level by level: the all-reduced (G, H)
    against ``grad_hist_ref`` of both ranks' rows (RTOL, ATOL).  Then one
    in-process fit of both ranks' padded rows in rank order (the global
    array) and the ranks' merged bins: every tree's splits equal, leaf
    values within MW_LEAF_TOL."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, TreeEnsemble
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    dev = torch.device("cuda")
    if not np.array_equal(np.asarray(caps[0]["boundaries"]),
                          np.asarray(caps[1]["boundaries"])):
        fail("11a: the ranks' merged bin boundaries differ")
    bins = torch.cat([c["bins"] for c in caps]).to(dev)
    levels = [c["levels"] for c in caps]
    if [len(lv) for lv in levels] != [MAX_DEPTH, MAX_DEPTH]:
        fail(f"11a: {[len(lv) for lv in levels]} levels recorded, want "
             f"{MAX_DEPTH} a rank")
    hist_err = 0.0
    for d, (a, b) in enumerate(zip(*levels)):
        if not (torch.equal(a["G"], b["G"]) and torch.equal(a["H"], b["H"])):
            fail(f"11a: level {d}'s all-reduced histograms differ between "
                 f"the ranks")
        want = hist_cuda.grad_hist_ref(
            bins, *(torch.cat([a[k], b[k]]).to(dev)
                    for k in ("node", "g", "h")), a["n"], NUM_BINS)
        for got, w, name in zip((a["G"], a["H"]), want, "GH"):
            ok, err = _close(got, w, RTOL, ATOL)
            hist_err = max(hist_err, err)
            if not ok:
                fail(f"11a: level {d}'s all-reduced {name} ({a['n']} nodes) "
                     f"disagrees with grad_hist_ref of both ranks' rows: "
                     f"max abs err {err:.3g}")
    print(f"11a the first tree's {MAX_DEPTH} levels (1-{2 ** (MAX_DEPTH - 1)}"
          f" nodes): the all-reduced (G, H) on both ranks bitwise equal, "
          f"within rtol {RTOL}, atol {ATOL} of grad_hist_ref of both ranks' "
          f"{bins.shape[0]:,} padded rows: max abs err {hist_err:.3g}",
          flush=True)

    n_max = caps[0]["bins"].shape[0]
    label = torch.zeros(2 * n_max, dtype=caps[0]["label"].dtype)
    weight = torch.zeros(2 * n_max, dtype=torch.float32)
    for r, c in enumerate(caps):
        label[r * n_max:r * n_max + c["n_local"]] = c["label"]
        weight[r * n_max:r * n_max + c["n_local"]] = 1.0
    label, weight = label.to(dev), weight.to(dev)
    model = GBDT(caps[0]["param"], num_feature=N_FEATURES, device=dev)
    model.set_boundaries(caps[0]["boundaries"])
    (ens, margin), sec = device_time(model.fit_binned, bins, label,
                                     weight=weight)
    one = TreeEnsemble(*(None if a is None else a.cpu() for a in ens))
    two = TreeEnsemble(**ens2)
    same = all(_same_tree(two, one, t) for t in range(ROUNDS))
    ok, leaf_err = _close(two.leaf_value, one.leaf_value, MW_LEAF_TOL,
                          MW_LEAF_TOL)
    hit = ((margin > 0).float() == label).float()
    acc = ((hit * weight).sum() / weight.sum()).item()
    print(f"11a world-1 fit of the ranks' rows and bins: {sec:.3f} s, train "
          f"acc {acc:.4f}; split agreement {_split_agreement(two, one):.4f}, "
          f"every tree identical {same}; leaf values max abs err "
          f"{leaf_err:.3g} (tol {MW_LEAF_TOL}) [{card}]", flush=True)
    if not same:
        fail("11a: the 2-worker ensemble's splits differ from the world-1 "
             "fit of the same rows and bins")
    if not ok:
        fail(f"11a: the 2-worker leaf values differ from the world-1 fit's "
             f"by {leaf_err:.3g}")


def _steps_against_world_one(card, tag, caps):
    """11b: the first two steps of rank 0 against world-1 steps over the
    same global batches (both ranks' batches).  logreg: the new params and
    the loss.  MLP: the all-reduced loss and gradients against the world-1
    step's autograd of the global batch (Adam's first steps move each
    weight by about the rate whatever its gradient, so the gradient is the
    comparable figure)."""
    from dmlc_core_tpu_torch.models import mlp as mlp_mod
    from dmlc_core_tpu_torch.models.linear import LinearModel

    dev = torch.device("cuda")
    steps = [c["steps"] for c in caps]
    if [len(st) for st in steps] != [2, 2]:
        fail(f"11b {tag}: {[len(st) for st in steps]} steps recorded, want 2")
    errs = []
    for k, (s0, s1) in enumerate(zip(*steps)):
        gb = _global_batch(s0["args"][-1], s1["args"][-1])
        if tag == "logreg":
            model = LinearModel(s0["param"], device=dev)
            params = {n: t.to(dev) for n, t in s0["args"][0].items()}
            new, loss = model.train_step(params, gb)
            pairs = [(s0["out"][0][n], new[n], MW_STEP_TOL, 1e-6)
                     for n in new]
            got_loss = s0["out"][1]
        else:
            model = mlp_mod.MLP(s0["param"], device=dev)
            leaves = [t.to(dev).requires_grad_(True) for t in s0["args"][0]]
            with torch.enable_grad():
                loss = model._loss(mlp_mod._rebuild(leaves),
                                   mlp_mod.batch_to(gb, dev))
                grads = torch.autograd.grad(loss, leaves)
            pairs = [(a, b, MW_GRAD_TOL,
                      MW_GRAD_TOL * b.abs().max().item())
                     for a, b in zip(s0["out"][1], grads)]
            got_loss = s0["out"][0]
        pairs.append((got_loss, loss.detach(), MW_STEP_TOL, 1e-6))
        for got, want, rtol, atol in pairs:
            ok, err = _close(got, want, rtol, atol)
            errs.append(err / max(want.abs().max().item(), 1e-30))
            if not ok:
                fail(f"11b {tag}: step {k + 1} on rank 0 differs from the "
                     f"world-1 step over both ranks' batches: max abs err "
                     f"{err:.3g} (rtol {rtol}, atol {atol:.3g})")
    what = "params and loss" if tag == "logreg" else "gradients and loss"
    print(f"11b {tag}: rank 0's first 2 steps' {what} within tolerance of "
          f"world-1 steps over both ranks' batches: max abs err "
          f"{max(errs):.3g} of the largest magnitude [{card}]", flush=True)


def phase_multiworker(card, ref):
    """Phase 11: the CLIs in 2 workers on the card through the port's
    launcher, against an in-process world-1 fit of the same rows."""
    import tempfile

    from dmlc_core_tpu_torch.bridge.binning import HostBinner
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 11: multi-worker training, 2 workers on one card "
          f"through python -m dmlc_core_tpu_torch.tracker.submit (gloo), "
          f"{N_MULTI:,} libsvm rows", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(here, "build", "chip_smoke_multiworker")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    x, y = ref["x"][:N_MULTI], ref["y"][:N_MULTI]
    with tempfile.TemporaryDirectory() as tmp:
        svm = os.path.join(tmp, "train.libsvm")
        small = os.path.join(tmp, "small.libsvm")
        _write_text(svm, x, y, " ", " ", "{}:%.9g")
        _write_text(small, x[:N_MULTI_CLI], y[:N_MULTI_CLI], " ", " ",
                    "{}:%.9g")
        common = ["--data", svm, "--num-feature", str(N_FEATURES)]
        gbdt = common + ["--rounds", str(ROUNDS), "--max-depth",
                         str(MAX_DEPTH), "--num-bins", str(NUM_BINS)]
        runs = [
            dict(tag="gbdt", module="train_gbdt", argv=gbdt + [
                "--checkpoint", os.path.join(outdir, "gbdt.bin")]),
            dict(tag="logreg", module="train_logreg",
                 argv=common + ["--form", "sparse", "--epochs", "2"]),
            dict(tag="mlp", module="train_mlp",
                 argv=common + ["--epochs", "2"]),
        ]
        for run in runs:
            run["port"] = _free_port()
        with open(os.path.join(outdir, "cli.json"), "w") as f:
            json.dump(runs, f)
        _, wall = _submit([], [sys.executable, os.path.abspath(__file__),
                               "--worker", "cli", outdir], outdir, "phase 11 CLIs",
                          MW_TIMEOUT_S)
        ranks = [torch.load(os.path.join(outdir, f"cli{r}.pt"),
                            weights_only=False) for r in range(2)]
        # the command as a user types it: exit 0 and the same line twice
        out, cli_wall = _submit([], [
            sys.executable, "-m", "dmlc_core_tpu_torch.examples.train_gbdt",
            "--data", small, "--num-feature", str(N_FEATURES), "--rounds",
            str(ROUNDS), "--max-depth", str(MAX_DEPTH)], outdir,
            "phase 11 python -m train_gbdt", MW_TIMEOUT_S)
    cli_lines = _over_two(out.splitlines())
    if len(cli_lines) != 2 or cli_lines[0] != cli_lines[1]:
        fail(f"11 python -m train_gbdt: not one line twice: {cli_lines}")
    print(f"11 python -m dmlc_core_tpu_torch.examples.train_gbdt on "
          f"{N_MULTI_CLI:,} rows in 2 workers: exit 0 in {cli_wall:.1f} s; "
          f"{cli_lines[0]} [{card}]", flush=True)

    # 11a: one global GBDT on both ranks
    g = [r["gbdt"] for r in ranks]
    for k, a in g[0]["model"].items():
        b = g[1]["model"][k]
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            fail(f"11a: rank 1's {k} differs from rank 0's")
    lines = [_over_two(r["lines"]) for r in g]
    if any(len(ln) != 1 for ln in lines) or lines[0] != lines[1]:
        fail(f"11a: the ranks' summary lines differ: {lines}")
    _gbdt_against_world_one(card, [r["captured"] for r in g],
                            g[0]["model"])
    k3_need = 2 * ROUNDS * MAX_DEPTH
    for r, run in enumerate(g):
        k1 = run["launches"]["hist_matmul_cuda"]
        k3 = run["launches"]["grad_hist_fused_cuda"]
        if k3 != k3_need or k1 != 0:
            fail(f"11a: rank {r} launched K3 {k3} times (want {k3_need}) "
                 f"and K1 {k1} times (want 0)")
    line = lines[0][0]
    acc = float(line.rsplit(" ", 1)[1])
    fit_sec = g[0]["fit_s"][0]
    # the in-process world-1 fit of the same rows from memory, binned as
    # the single-worker CLI bins them
    model = GBDT(GBDTParam(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                           num_bins=NUM_BINS, learning_rate=0.3),
                 num_feature=N_FEATURES)
    model.make_bins(x[:100_000], count=N_MULTI)
    dev = torch.device("cuda")
    bins = torch.from_numpy(HostBinner(model.boundaries,
                                       NUM_BINS).transform(x)).to(dev)
    y_t = torch.from_numpy(y).to(dev)
    model.fit_binned(bins, y_t)
    (_, margin), one_sec = device_time(model.fit_binned, bins, y_t)
    one_acc = ((margin > 0).float() == y_t).float().mean().item()
    del bins, y_t, margin
    # the warm-up fit and the timed fit make the same all-reduces
    ar = g[0]["allreduce_s"]
    ar_fit = sum(ar[len(ar) // 2:])
    print(f"11a GBDT: {line}", flush=True)
    print(f"11a world 2: fit {fit_sec:.4f} s (the slower rank), "
          f"{N_MULTI * ROUNDS / fit_sec:,.0f} rows/s; data all-reduce "
          f"{len(ar) // 2} calls, {ar_fit:.3f} s on rank 0 "
          f"({100 * ar_fit / fit_sec:.1f}% of the fit); world 1 in "
          f"process: fit {one_sec:.3f} s, {N_MULTI * ROUNDS / one_sec:,.0f} "
          f"rows/s, train acc {one_acc:.4f}; launch of the three CLIs "
          f"{wall:.1f} s, gbdt main() {g[0]['wall']:.1f} s [{card}]",
          flush=True)
    print(f"11a launches a rank: K3 {[r['launches']['grad_hist_fused_cuda'] for r in g]}, "
          f"K1 {[r['launches']['hist_matmul_cuda'] for r in g]} (warm-up "
          f"plus fit); ensembles bitwise equal on both ranks", flush=True)
    if acc < 0.8 or abs(acc - one_acc) > 0.005:
        fail(f"11a: world-2 accuracy {acc:.4f} (world 1 {one_acc:.4f}): "
             f"below 0.8 or more than 0.005 apart")

    # 11b: logreg (sparse) and MLP (dense)
    for tag in ("logreg", "mlp"):
        runs = [r[tag] for r in ranks]
        for k, a in runs[0]["model"].items():
            if not torch.equal(a, runs[1]["model"][k]):
                fail(f"11b {tag}: rank 1's {k} differs from rank 0's")
        _steps_against_world_one(card, tag, [r["captured"] for r in runs])
        losses = [float(ln.split("loss=")[1].split()[0])
                  for ln in runs[0]["lines"] if "loss=" in ln]
        if len(losses) != 2 or not losses[1] < losses[0] \
                or not all(np.isfinite(losses)):
            fail(f"11b {tag}: rank 0's losses {losses} do not fall")
        print(f"11b {tag}: params bitwise equal on both ranks; rank 0's "
              f"epoch losses {losses}; main() {runs[0]['wall']:.1f} s "
              f"[{card}]", flush=True)
    print(f"phase 11: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return g[0]["launches"]["grad_hist_fused_cuda"]


# -- phase 12: recordio and the split engines ----------------------------------
def _read_chunks(split, close=True):
    """Every chunk of an InputSplit, in order; (chunks, seconds)."""
    start = time.perf_counter()
    try:
        chunks = list(iter(split.next_chunk, None))
    finally:
        if close:
            split.close()
    return chunks, time.perf_counter() - start


def _decode(chunks):
    """Phase 12's records in chunk order through the native scan: an
    [n, 32] uint8 array (28 bins, then the float32 label's bytes)."""
    from dmlc_core_tpu_torch import native_bridge

    out = []
    for chunk in chunks:
        head, plen, escaped, _, _ = native_bridge.recordio_scan(
            chunk, 0, len(chunk))
        if len(head) and (plen != 32).any():
            fail("a phase-12 record is not 32 bytes long")
        buf = np.frombuffer(chunk, np.uint8)
        if len(head) * 40 == len(buf) and not escaped.any():
            out.append(buf.reshape(-1, 40)[:, 8:])  # frames back to back
            continue
        rows = buf[(head + 8)[:, None] + np.arange(32)]
        for i in np.nonzero(escaped)[0]:   # a payload holding the magic word
            rows[i] = np.frombuffer(native_bridge.recordio_extract(
                chunk, int(head[i]), 32), np.uint8)
        out.append(rows)
    return np.concatenate(out) if out else np.empty((0, 32), np.uint8)


def _sorted_rows(rows):
    """Rows in lexicographic order of their four 8-byte words."""
    words = np.ascontiguousarray(rows).view(np.uint64)
    return rows[np.lexsort(words.T[::-1])]


def _read_line(label, sec, nbytes, card):
    print(f"{label}: {sec:.3f} s, {nbytes / sec / 1e6:.1f} MB/s [{card}]",
          flush=True)


def _write_records(path, payload):
    """``IndexedRecordIOWriter.write_records`` (the batched native framing)
    into ``path``, its index into ``path + ".idx"``; returns the bytes."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import create_stream

    with create_stream(path, "w") as stream:
        writer = IndexedRecordIOWriter(stream)
        for s in range(0, len(payload), 250_000):
            writer.write_records([r.tobytes() for r in payload[s:s + 250_000]])
    with create_stream(path + ".idx", "w") as stream:
        writer.save_index(stream)
    return os.path.getsize(path)


def phase_recordio(card, ref):
    """Phase 12: phase 4's training rows as recordio through the split
    engines at full width, then a libfm file through both parsers.  Every
    native read covers all 2,000,000 records, and so do the Python engine's
    reads of 12a, 12c and 12d.  12b reads the 2,000,000 shuffled records
    natively in a whole first epoch and the first 200,000 records of the
    second (its plan covers all 2,000,000); its comparison of the engines,
    and of two epochs, reads a file of the first 200,000 records
    (``N_REC_PY``: both engines read one span a record there, ~13-18 us a
    span on the card machine's host).  Returns the K3 launches of 12a's
    fit."""
    import random
    import tempfile

    from dmlc_core_tpu_torch import native_bridge
    from dmlc_core_tpu_torch.io.input_split import (InputSplitShuffle,
                                                    NativeCachedSplitter,
                                                    NativeLineSplitter,
                                                    create_input_split)
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 12: {N_ROWS:,} of phase 4's rows as recordio (28 bins + "
          f"the float32 label a record) through the split engines, then "
          f"{N_LIBFM:,} as libfm", flush=True)
    phase_start = time.perf_counter()
    dev = torch.device("cuda")
    wire, y = ref["wire"][:N_ROWS], ref["y"][:N_ROWS]
    payload = np.concatenate(
        [wire, y.astype(np.float32).view(np.uint8).reshape(-1, 4)], axis=1)
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "train.rec")
        start = time.perf_counter()
        nbytes = _write_records(rec, payload)
        _read_line(f"write {nbytes:,} bytes with IndexedRecordIOWriter",
                   time.perf_counter() - start, nbytes, card)
        small = os.path.join(tmp, "first.rec")
        _write_records(small, payload[:N_REC_PY])

        # (12a) 4 parts through each engine; the native one is the default
        native_bridge.reset_engine_calls()
        parts = {}
        for engine in ("native", "python"):
            sec, chunks = 0.0, []
            for part in range(N_REC_PARTS):
                if engine == "native":
                    split = create_input_split(rec, part, N_REC_PARTS,
                                               "recordio")
                    if not isinstance(split, NativeLineSplitter):
                        fail(f"the recordio split is a {type(split)}")
                else:
                    with _env(DMLC_TPU_DISABLE_NATIVE="1"):
                        split = create_input_split(rec, part, N_REC_PARTS,
                                                   "recordio")
                got, s = _read_chunks(split)
                sec += s
                chunks.append(got)
            parts[engine] = chunks
            _read_line(f"12a: recordio in {N_REC_PARTS} parts, {engine} "
                       f"engine", sec, nbytes, card)
        calls = native_bridge.ENGINE_CALLS["lsplit_next_chunk"]
        if calls == 0:
            fail("12a read without the native split engine")
        for part in range(N_REC_PARTS):
            if (b"".join(parts["native"][part])
                    != b"".join(parts["python"][part])):
                fail(f"12a: part {part}'s records differ between engines")
        start = time.perf_counter()
        rows = _decode([c for p in parts.pop("native") for c in p])
        del parts
        got_wire = np.ascontiguousarray(rows[:, :28])
        got_y = np.ascontiguousarray(rows[:, 28:]).view(np.float32).ravel()
        print(f"12a: decoded {len(rows):,} records in "
              f"{time.perf_counter() - start:.3f} s; {calls} native chunks",
              flush=True)
        if not (np.array_equal(got_wire, wire)
                and np.array_equal(got_y.view(np.uint32),
                                   y.view(np.uint32))):
            fail("12a: the parts' records are not phase 4's wire and labels "
                 "in order (not disjoint and exhaustive, or altered)")
        print(f"12a: parts equal between engines; disjoint and exhaustive; "
              f"wire and labels bitwise phase 4's", flush=True)
        hist_cuda.reset_launches()
        bins = torch.from_numpy(got_wire).to(dev)
        y_dev = torch.from_numpy(got_y).to(dev)
        (ens, margin), fit_sec = device_time(ref["model"].fit_binned, bins,
                                             y_dev)
        torch.cuda.synchronize()
        launches = dict(hist_cuda.LAUNCHES)
        same = (all(torch.equal(a, b) for a, b in zip(ens, ref["ens"]))
                and torch.equal(margin, ref["margin"]))
        print(f"12a: fit from recordio {fit_sec:.3f} s, launches {launches}; "
              f"ensemble and margin bitwise phase 4's auto fit: {same} "
              f"[{card}]", flush=True)
        if not same:
            fail("12a: the fit from recordio differs from phase 4's")
        if launches["grad_hist_fused_cuda"] < ROUNDS * MAX_DEPTH:
            fail("12a: K3's kernel did not run on every level")
        if launches["hist_matmul_cuda"] != 0:
            fail("12a: the fit launched K1")
        del bins, y_dev, ens, margin, rows, got_wire, got_y

        # (12b) shuffled indexed reads: the reference's order for the seed
        kw = dict(shuffle=True, seed=REC_SEED, batch_size=REC_BATCH)
        start = time.perf_counter()
        split = create_input_split(rec, 0, 1, "indexed_recordio",
                                   index_uri=rec + ".idx", **kw)
        print(f"12b: index of {N_ROWS:,} records read in "
              f"{time.perf_counter() - start:.3f} s", flush=True)
        chunks, sec = _read_chunks(split, close=False)
        _read_line("12b: shuffled indexed recordio, native engine", sec,
                   nbytes, card)
        if native_bridge.ENGINE_CALLS["span_next_chunk"] == 0:
            fail("12b read without the native span reader")
        # the second epoch's plan over every record; its first batches read
        split.before_first()
        start = time.perf_counter()
        second = []
        try:
            while sum(len(c) for c in second) < N_REC_PY * 40:
                chunk = split.next_chunk()
                if chunk is None:
                    fail("12b: the second epoch ended early")
                second.append(chunk)
        finally:
            split.close()
        _read_line(f"12b: second epoch, first {len(second)} batches, native "
                   f"engine", time.perf_counter() - start,
                   sum(map(len, second)), card)

        def shuffles(n):
            """The splitter's first two epochs' orders of n records: its
            random.Random(KRAND_MAGIC + seed), KRAND_MAGIC = 111."""
            rng = random.Random(111 + REC_SEED)
            out = []
            for _ in range(2):
                perm = list(range(n))
                rng.shuffle(perm)
                out.append(np.asarray(perm))
            return out

        perms = shuffles(N_ROWS)
        if not np.array_equal(_decode(chunks), payload[perms[0]]):
            fail("12b: the read is not the seed's shuffle of every record "
                 "once")
        rows = _decode(second)
        if not np.array_equal(rows, payload[perms[1][:len(rows)]]):
            fail(f"12b: the second epoch's first {len(rows):,} records are "
                 f"not the seed's second shuffle")
        print(f"12b: the second epoch's first {len(rows):,} records in the "
              f"seed's second shuffle", flush=True)
        del chunks, second, rows, perms
        orders = {}
        for engine in ("native", "python"):
            with (_env(DMLC_TPU_DISABLE_NATIVE="1") if engine == "python"
                  else contextlib.nullcontext()):
                split = create_input_split(small, 0, 1, "indexed_recordio",
                                           index_uri=small + ".idx", **kw)
                first, sec = _read_chunks(split, close=False)
                split.before_first()
                second, sec2 = _read_chunks(split)
            orders[engine] = (first, second)
            _read_line(f"12b: first {N_REC_PY:,} records, two epochs, "
                       f"{engine} engine", sec + sec2,
                       2 * sum(map(len, first)), card)
        if [b"".join(e) for e in orders["native"]] != \
                [b"".join(e) for e in orders["python"]]:
            fail("12b: the engines' shuffled orders differ")
        for epoch, perm in enumerate(shuffles(N_REC_PY)):
            if not np.array_equal(_decode(orders["native"][epoch]),
                                  payload[perm]):
                fail(f"12b: epoch {epoch + 1} of the first {N_REC_PY:,} "
                     f"records is not the seed's shuffle")
        if b"".join(orders["native"][0]) == b"".join(orders["native"][1]):
            fail("12b: two epochs read the records in the same order")
        print("12b: every record once in the seed's order, both engines' "
              "orders equal, the second epoch in another order", flush=True)
        del orders

        # (12c) the #cachefile split: epoch 2 replays epoch 1
        replays = {}
        for engine in ("native", "python"):
            cache = os.path.join(tmp, f"{engine}.cache")
            with (_env(DMLC_TPU_DISABLE_NATIVE="1") if engine == "python"
                  else contextlib.nullcontext()):
                split = create_input_split(f"{rec}#{cache}", 0, 1,
                                           "recordio")
                if (engine == "native") != isinstance(split,
                                                      NativeCachedSplitter):
                    fail(f"12c: {engine} engine gave a {type(split)}")
                first, sec1 = _read_chunks(split, close=False)
                split.before_first()
                second, sec2 = _read_chunks(split)
            _read_line(f"12c: #cachefile recordio, epoch 1 (teeing the "
                       f"cache), {engine} engine", sec1, nbytes, card)
            _read_line(f"12c: #cachefile recordio, epoch 2 (replay), "
                       f"{engine} engine", sec2, nbytes, card)
            if first != second:
                fail(f"12c: the {engine} engine's replay is not epoch 1")
            replays[engine] = first
        if native_bridge.ENGINE_CALLS["creplay_next_chunk"] == 0:
            fail("12c replayed without the native cache engine")
        if b"".join(replays["native"]) != b"".join(replays["python"]):
            fail("12c: the engines' cached epochs differ")
        if not np.array_equal(_decode(replays.pop("native")), payload):
            fail("12c: the cached epoch is not the records in order")
        del replays
        print("12c: replay bitwise epoch 1, both engines equal, the "
              "records in order", flush=True)

        # (12d) InputSplitShuffle over 4 shuffle parts covers every record
        visits = {}
        for engine in ("native", "python"):
            with (_env(DMLC_TPU_DISABLE_NATIVE="1") if engine == "python"
                  else contextlib.nullcontext()):
                split = InputSplitShuffle(rec, 0, 1, "recordio", N_REC_PARTS,
                                          shuffle_seed=REC_SEED)
                chunks, sec = _read_chunks(split)
            _read_line(f"12d: InputSplitShuffle ({N_REC_PARTS} shuffle "
                       f"parts), {engine} engine", sec, nbytes, card)
            visits[engine] = chunks
        if b"".join(visits["native"]) != b"".join(visits["python"]):
            fail("12d: the engines visit the records in another order")
        rows = _decode(visits.pop("native"))
        del visits
        if not np.array_equal(_sorted_rows(rows), _sorted_rows(payload)):
            fail("12d: the shuffle parts do not cover every record once")
        if np.array_equal(rows, payload):
            fail("12d: the shuffle parts were visited in file order")
        print("12d: every record once, both engines' orders equal",
              flush=True)
        del rows, payload

        # (12e) libfm with fields through both parsers
        fm = os.path.join(tmp, "train.libfm")
        x, y_fm = ref["x"][:N_LIBFM], ref["y"][:N_LIBFM]
        fm_bytes = _write_text(fm, x, y_fm, " ", " ", "{1}:{0}:%.9g")
        native_bridge.reset_engine_calls()
        blocks, sec = _parse_blocks(fm + "?format=libfm")
        print(f"12e: parse libfm, native engine: {sec:.3f} s, "
              f"{fm_bytes / sec / 1e6:.2f} MB/s, {N_LIBFM / sec:,.0f} rows/s "
              f"[{card}]", flush=True)
        if native_bridge.ENGINE_CALLS["parse_libfm"] == 0:
            fail("12e parsed without the native libfm parser")
        with _env(DMLC_TPU_DISABLE_NATIVE="1"):
            numpy_blocks, sec = _parse_blocks(fm + "?format=libfm")
        print(f"12e: parse libfm, numpy engine: {sec:.3f} s, "
              f"{fm_bytes / sec / 1e6:.2f} MB/s, {N_LIBFM / sec:,.0f} rows/s "
              f"[{card}]", flush=True)
        if not _same_columns(numpy_blocks, blocks):
            fail("12e: the libfm engines' columns differ")
        from dmlc_core_tpu_torch.data.row_block import concat_blocks

        block = concat_blocks(blocks)
        cols = np.tile(np.arange(N_FEATURES, dtype=np.uint32), N_LIBFM)
        if not (np.array_equal(block.index, cols)
                and np.array_equal(block.field, cols // LIBFM_FIELD_WIDTH)
                and np.array_equal(block.value.view(np.uint32),
                                   x.ravel().view(np.uint32))
                and np.array_equal(block.label.view(np.uint32),
                                   y_fm.view(np.uint32))):
            fail("12e: the parsed libfm columns are not the written rows")
        print("12e: libfm columns bitwise equal between engines and to the "
              "written rows, fields included", flush=True)
    print(f"phase 12: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return launches["grad_hist_fused_cuda"]


# -- phase 13: training from object storage ------------------------------------

def _mock_s3_class():
    """``tests/mock_s3.py``'s strict store, loaded from its file (a
    ``tests`` package installed elsewhere cannot shadow it)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "mock_s3.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_mock_s3", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.MockS3


def _s3_series(telemetry):
    """(GET round trips, read bytes) of the ``dmlc_filesystem_*`` series."""
    metrics = telemetry.snapshot()["metrics"]
    gets = sum(smp["count"] for smp in metrics.get(
        "dmlc_filesystem_request_seconds", {}).get("samples", [])
        if smp["labels"] == {"fs": "s3", "op": "GET"})
    nread = sum(smp["value"] for smp in metrics.get(
        "dmlc_filesystem_read_bytes_total", {}).get("samples", []))
    return gets, int(nread)


def _counter(telemetry, name, **labels):
    return telemetry.get_registry().counter(name, **labels).value


def _same_blocks(got, want):
    """Whether two lists of RowBlocks hold bitwise equal columns."""
    if len(got) != len(want):
        return False
    for a, b in zip(got, want):
        for name in ("offset", "label", "weight", "index", "value", "field"):
            x, y = getattr(a, name), getattr(b, name)
            if (x is None) != (y is None):
                return False
            if x is not None and (x.dtype != y.dtype
                                  or x.tobytes() != y.tobytes()):
                return False
    return True


def _ckpt_field(loaded, name):
    hits = [v for k, v in loaded.items() if k.endswith(f"'{name}']")]
    if len(hits) != 1:
        fail(f"13c: the checkpoint has no single {name!r} leaf: "
             f"{sorted(loaded)}")
    return hits[0]


def _remote_cli(card, here, store):
    """13c's CLI: ``train_gbdt`` on a 100,000-row object with
    ``--checkpoint-dir`` in the bucket, then a rerun that must resume from
    the latest step there; both final ensembles, read back from the
    bucket, bitwise equal, and the bucket's step bitwise their first
    trees."""
    from dmlc_core_tpu_torch.bridge.checkpoint import (CheckpointManager,
                                                       load_checkpoint)

    blob = store.objects[("bucket", "train.libsvm")]
    end = -1
    for _ in range(N_REMOTE_CLI):
        end = blob.index(b"\n", end + 1)
    store.objects[("bucket", "cli.libsvm")] = blob[:end + 1]
    finals = []
    for run in range(2):
        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.examples.train_gbdt",
               "--data", "s3://bucket/cli.libsvm", "--num-feature",
               str(N_FEATURES), "--rounds", str(ROUNDS), "--max-depth",
               str(MAX_DEPTH), "--checkpoint-dir", "s3://bucket/ckpt",
               "--checkpoint-every", str(REMOTE_CKPT_EVERY), "--checkpoint",
               f"s3://bucket/final-{run}.ckpt"]
        start = time.perf_counter()
        proc = subprocess.run(cmd, cwd=here, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        sec = time.perf_counter() - start
        print(proc.stdout.strip())
        if proc.returncode != 0:
            fail(f"13c: the train_gbdt CLI (run {run}) exited "
                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        resumed = f"resuming from checkpoint step {REMOTE_CKPT_EVERY}"
        if (resumed in proc.stdout) != (run == 1):
            did = "did not resume" if run else "resumed"
            fail(f"13c: run {run} of the CLI {did} from the bucket's step "
                 f"{REMOTE_CKPT_EVERY}")
        print(f"13c: train_gbdt CLI run {run} from s3://bucket/cli.libsvm "
              f"with --checkpoint-dir s3://bucket/ckpt: exit 0 in {sec:.1f} "
              f"s{', resumed' if run else ''} [{card}]", flush=True)
        finals.append(load_checkpoint(f"s3://bucket/final-{run}.ckpt"))
    if sorted(finals[0]) != sorted(finals[1]) or not all(
            np.array_equal(finals[0][k], finals[1][k]) for k in finals[0]):
        fail("13c: the resumed CLI's final ensemble differs from the first "
             "run's")
    mgr = CheckpointManager("s3://bucket/ckpt", keep=3)
    if mgr.latest_step() != REMOTE_CKPT_EVERY:
        fail(f"13c: the bucket's latest step is {mgr.latest_step()}")
    step = {k[2:-2]: v for k, v in mgr.restore(REMOTE_CKPT_EVERY).items()}
    names = ("split_feat", "split_bin", "leaf_value", "default_left",
             "split_gain", "split_cover")
    for j, name in enumerate(names):
        field = _ckpt_field(finals[1], name)
        if field.shape[0] != ROUNDS or not all(
                np.array_equal(field[i], step[f"t{i}_{j}"])
                for i in range(REMOTE_CKPT_EVERY)):
            fail(f"13c: the bucket's step {REMOTE_CKPT_EVERY} is not the "
                 f"final ensemble's first trees ({name})")
    print(f"13c: the resumed run's ensemble, read back from the bucket, "
          f"bitwise the first run's; the bucket's step {REMOTE_CKPT_EVERY} "
          f"bitwise its first {REMOTE_CKPT_EVERY} trees", flush=True)


def _remote_cache(card, ref, local_dirs):
    """13d: the fleet-shared page cache in the reference's form."""
    from dmlc_core_tpu_torch import native_bridge, telemetry
    from dmlc_core_tpu_torch.data.factory import create_row_block_iter

    spec = "s3://bucket/train.libsvm#s3://bucket/caches/train.cache"
    with _env(DMLC_CACHE_REMOTE="1", DMLC_CACHE_LOCAL_DIR=local_dirs[0]):
        publishes = _counter(telemetry, "dmlc_cache_remote_publishes_total")
        start = time.perf_counter()
        it = create_row_block_iter(spec)
        epoch1 = list(it)
        build = time.perf_counter() - start
        if _counter(telemetry, "dmlc_cache_remote_publishes_total") \
                != publishes + 1:
            fail("13d: epoch 1 did not publish the cache to the bucket")
        start = time.perf_counter()
        it.before_first()
        epoch2 = list(it)
        replay = time.perf_counter() - start
        it.close()
    if not _same_blocks(epoch2, epoch1):
        fail("13d: epoch 2 (the mmap replay) is not bitwise epoch 1")
    if not _same_columns(epoch1, [ref["ingest_columns"]]):
        fail("13d: the cached blocks are not bitwise 13b's columns")
    size = len(ref["store"].objects[("bucket", "caches/train.cache")])
    print(f"13d: epoch 1 (parse from the bucket, build, publish "
          f"{size:,} bytes): {build:.3f} s; epoch 2 (mmap replay): "
          f"{replay:.3f} s; bitwise epoch 1 and 13b's columns [{card}]",
          flush=True)
    with _env(DMLC_CACHE_REMOTE="1", DMLC_CACHE_LOCAL_DIR=local_dirs[1]):
        hits = _counter(telemetry, "dmlc_cache_remote_hits_total")
        calls = dict(native_bridge.ENGINE_CALLS)
        start = time.perf_counter()
        it = create_row_block_iter(spec)
        fetched = list(it)
        fetch = time.perf_counter() - start
        it.close()
        if native_bridge.ENGINE_CALLS != calls:
            fail("13d: the second host parsed instead of fetching")
        if _counter(telemetry, "dmlc_cache_remote_hits_total") != hits + 1:
            fail("13d: the second host's fetch was not a remote hit")
    if not _same_blocks(fetched, epoch1):
        fail("13d: the fetched cache's blocks are not bitwise epoch 1")
    print(f"13d: another host fetched the published cache with no parse: "
          f"{fetch:.3f} s, {size / fetch / 1e6:.1f} MB/s; bitwise epoch 1 "
          f"[{card}]", flush=True)


def phase_remote(card, ref):
    """Phase 13: training from a bucket on a loopback store (strict SigV4
    mock, in this process).  Returns the K3 launches of 13c's fit."""
    import tempfile

    from dmlc_core_tpu_torch import native_bridge, telemetry
    from dmlc_core_tpu_torch.bridge.binning import HostBinner, binned_batches
    from dmlc_core_tpu_torch.bridge.loader import DeviceFeedLoader
    from dmlc_core_tpu_torch.io.filesys import URI, get_filesystem
    from dmlc_core_tpu_torch.io.stream import (create_stream,
                                               create_stream_for_read)
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda
    from dmlc_core_tpu_torch.utils.timer import device_time

    print(f"== phase 13: training from object storage, phase 6's "
          f"{N_INGEST:,} libsvm rows in a strict SigV4 mock bucket on "
          f"loopback", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")
    svm = _ingest_path()
    if not os.path.exists(svm):
        os.makedirs(os.path.dirname(svm), exist_ok=True)
        _write_text(svm, ref["x"][:N_INGEST], ref["y"][:N_INGEST], " ", " ",
                    "{}:%.9g")
    nbytes = os.path.getsize(svm)
    MockS3 = _mock_s3_class()
    store = MockS3().start()
    flaky = MockS3(fail_every=RETRY_FAIL_EVERY).start()
    ref["store"] = store
    was_on = telemetry.enabled()
    telemetry.enable()
    telemetry.reset()
    tmp = tempfile.mkdtemp()
    try:
        with _env(AWS_ACCESS_KEY_ID="chip-smoke",
                  AWS_SECRET_ACCESS_KEY="chip-smoke-secret",
                  AWS_REGION="us-east-1", AWS_SESSION_TOKEN=None,
                  S3_ENDPOINT=f"http://127.0.0.1:{store.port}",
                  DMLC_S3_WRITE_BUFFER_MB=str(REMOTE_WRITE_MB),
                  DMLC_TPU_NATIVE_REMOTE=None, DMLC_CACHE_REMOTE=None,
                  DMLC_TPU_DISABLE_NATIVE=None):
            # (13a) multipart upload, stat, list, whole read back
            uri = "s3://bucket/train.libsvm"
            start = time.perf_counter()
            with open(svm, "rb") as fi, create_stream(uri, "w") as fo:
                for piece in iter(lambda: fi.read(8 << 20), b""):
                    fo.write(piece)
            up = time.perf_counter() - start
            parts = sum(1 for m, p in store.requests
                        if m == "PUT" and "partNumber" in p)
            want_parts = -(-nbytes // (REMOTE_WRITE_MB << 20))
            if parts != want_parts:
                fail(f"13a: the upload took {parts} parts, expected "
                     f"{want_parts}")
            fs = get_filesystem(URI(uri))
            info = fs.get_path_info(URI(uri))
            listed = {e.path.name: e.size
                      for e in fs.list_directory(URI("s3://bucket/"))}
            if info.size != nbytes or listed.get("/train.libsvm") != nbytes:
                fail(f"13a: stat {info.size} / list {listed} disagree with "
                     f"the file's {nbytes} bytes")
            start = time.perf_counter()
            with create_stream_for_read(uri) as fi:
                back = b"".join(iter(lambda: fi.read(8 << 20), b""))
            down = time.perf_counter() - start
            with open(svm, "rb") as f:
                if back != f.read():
                    fail("13a: the object read back differs from the file")
            del back
            print(f"13a: {nbytes:,} bytes up as a multipart upload of "
                  f"{parts} parts ({REMOTE_WRITE_MB} MB): {up:.3f} s, "
                  f"{nbytes / up / 1e6:.1f} MB/s; stat and list agree; read "
                  f"back whole: {down:.3f} s, {nbytes / down / 1e6:.1f} "
                  f"MB/s, byte-equal [{card}]", flush=True)

            # (13b) the parse from the bucket through both engines; the
            # path's counts set to 0 just before, read after 13c's fit
            hist_cuda.reset_launches()
            parsed = {}
            for engine in ("python", "native"):
                native_bridge.reset_engine_calls()
                telemetry.reset()
                with _env(DMLC_TPU_NATIVE_REMOTE="1" if engine == "native"
                          else None):
                    blocks, sec = _parse_blocks(uri)
                splits = native_bridge.ENGINE_CALLS["lsplit_next_chunk"]
                gets, nread = _s3_series(telemetry)
                print(f"13b: parse from the bucket, {engine} split engine: "
                      f"{sec:.3f} s, {nbytes / sec / 1e6:.2f} MB/s, "
                      f"{N_INGEST / sec:,.0f} rows/s; {gets} GETs, "
                      f"{nread:,} bytes read; native split chunks {splits} "
                      f"[{card}]", flush=True)
                if (splits > 0) != (engine == "native"):
                    fail(f"13b: the {engine} run's native split count is "
                         f"{splits}")
                if not _same_columns(blocks, [ref["ingest_columns"]]):
                    fail(f"13b: the {engine} engine's columns are not "
                         f"bitwise phase 6's local parse")
                parsed[engine] = blocks
            blocks = parsed.pop("native")
            del parsed
            print("13b: both engines' merged columns bitwise phase 6's local "
                  "parse", flush=True)

            # (13c) bin, feed and fit as phase 6 does
            param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                         num_bins=NUM_BINS, learning_rate=0.3)
            model = GBDT(GBDTParam(**param), num_feature=N_FEATURES)
            px, _, _ = _dense_rows(blocks, N_FEATURES)
            model.make_bins(px[:50_000])
            binned = list(binned_batches(
                blocks, HostBinner(model.boundaries, NUM_BINS), INGEST_BATCH))
            del blocks, px
            loader = DeviceFeedLoader(lambda: iter(binned), prefetch=2)
            bins, y_dev, _ = _fill(loader, N_INGEST, dev)
            del binned, loader
            (ens, margin), fit_sec = device_time(model.fit_binned, bins, y_dev)
            torch.cuda.synchronize()
            launches = dict(hist_cuda.LAUNCHES)
            print(f"13c: fit from the bucket: {fit_sec:.3f} s [{card}]; "
                  f"launches {launches}", flush=True)
            if launches["grad_hist_fused_cuda"] < ROUNDS * MAX_DEPTH:
                fail(f"13c: the fit launched K3's kernel "
                     f"{launches['grad_hist_fused_cuda']} times, expected "
                     f">= {ROUNDS * MAX_DEPTH}")
            if launches["hist_matmul_cuda"] != 0:
                fail("13c: the fit launched K1")
            ref_ens, ref_margin = ref["ingest_fit"]
            if not (all(torch.equal(a, b) for a, b in zip(ens, ref_ens))
                    and torch.equal(margin, ref_margin)):
                fail("13c: the fit from the bucket differs from phase 6's "
                     "ingest-path fit")
            print("13c: ensemble and margin bitwise phase 6's ingest-path "
                  "fit", flush=True)
            del bins, y_dev, ens, margin
            _remote_cli(card, here, store)

            # (13d) the fleet-shared page cache
            _remote_cache(card, ref, [os.path.join(tmp, "host1"),
                                      os.path.join(tmp, "host2")])

            # (13e) a store that cuts every 7th GET off mid-body
            payload = np.random.RandomState(13).bytes(RETRY_OBJECT)
            flaky.objects[("bucket", "flaky.bin")] = payload
            retries = _counter(telemetry, "dmlc_net_retry_retries_total",
                               status_class="transport")
            # whole reads, each 4 MiB ranged GETs, until a 7th GET comes
            passes = -(-RETRY_FAIL_EVERY // -(-RETRY_OBJECT // (4 << 20)))
            with _env(S3_ENDPOINT=f"http://127.0.0.1:{flaky.port}"):
                start = time.perf_counter()
                for _ in range(passes):
                    with create_stream_for_read("s3://bucket/flaky.bin") as fi:
                        got = b"".join(iter(lambda: fi.read(1 << 20), b""))
                    if got != payload:
                        fail("13e: the retried read differs from the object")
                sec = time.perf_counter() - start
            retried = _counter(telemetry, "dmlc_net_retry_retries_total",
                               status_class="transport") - retries
            if retried < 1 or flaky.injected_failures < 1:
                fail(f"13e: {flaky.injected_failures} cut GETs, {retried} "
                     f"retries counted")
            print(f"13e: {RETRY_OBJECT:,} bytes read {passes} times "
                  f"through a store that cut {flaky.injected_failures} GETs "
                  f"mid-body: byte-equal after {retried:.0f} retries, "
                  f"{sec:.3f} s [{card}]", flush=True)
    finally:
        ref.pop("store", None)
        store.stop()
        flaky.stop()
        telemetry.reset()
        if not was_on:
            telemetry.disable()
        shutil.rmtree(tmp, ignore_errors=True)
    # the libsvm file stays for phase 14c, which removes it
    print(f"phase 13: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return launches["grad_hist_fused_cuda"]


# -- phase 14: tensor and sequence parallelism on a mesh of ranks --------------
def _seq_case(fn, blocks, mesh, causal):
    """(output block, its q/k/v gradients) of ``fn`` on this rank's
    blocks, the loss ``sum(out**2)`` over every rank."""
    leaves = [t.clone().requires_grad_(True) for t in blocks]
    out = fn(*leaves, mesh, axis="sp", causal=causal)
    (out ** 2).sum().backward()
    return out.detach(), [t.grad for t in leaves]


def _alternate(fns, rounds):
    """Median seconds of each of ``fns``, timed one call each in turns
    (after one untimed call each), so that a drift of the shared host
    touches all of them alike."""
    from dmlc_core_tpu_torch.utils.profiler import device_timer

    times = [[] for _ in fns]
    for fn in fns:
        fn()
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(device_timer(fn, iters=1, warmup=0)[1])
    return [float(np.median(t)) for t in times]


def seq_worker_main(outdir):
    """One rank of phase 14b (``--worker seq OUTDIR``): ring and Ulysses
    attention over a 4-rank ``sp`` mesh on the card at L = 8,192, their
    gradients, the plain reference on the whole sequence (one rank at a
    time: 2.1 GB of scores), and CUDA-event times of each and of the K/V
    rotation or all-to-alls alone, in turns with the forward."""
    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.collective.mesh_collectives import (
        MeshCollective)
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh
    from dmlc_core_tpu_torch.parallel.sequence import (reference_attention,
                                                       ring_attention,
                                                       shard_sequence,
                                                       ulysses_attention)
    from dmlc_core_tpu_torch.utils.profiler import device_timer

    collective.init({"backend": "gloo", "timeout": MW_COLLECTIVE_TIMEOUT_S})
    rank = collective.get_rank()
    dev = torch.device("cuda")
    mesh = make_mesh({"sp": SEQ_RANKS})
    rng = np.random.RandomState(14)
    shape = (SEQ_B, SEQ_L, SEQ_H, SEQ_D)
    full = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
            for _ in range(3)]
    blocks = [shard_sequence(t, mesh, "sp").contiguous() for t in full]
    coll = MeshCollective(mesh, "sp")
    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    result = {"rank": rank}
    for causal in (False, True):
        def reference():
            leaves = [t.clone().requires_grad_(True) for t in full]
            out = reference_attention(*leaves, causal=causal)
            (out ** 2).sum().backward()
            res = [shard_sequence(out.detach(), mesh, "sp")] + [
                shard_sequence(t.grad, mesh, "sp") for t in leaves]
            res = [t.contiguous() for t in res]
            del out, leaves
            torch.cuda.empty_cache()
            return res

        want = _time_serially(rank, reference)
        for name, fn in fns.items():
            tag = f"{name}_{'causal' if causal else 'full'}"
            out, grads = _seq_case(fn, blocks, mesh, causal)
            err = {"out": (out - want[0]).abs().max().item(),
                   "out_ok": torch.allclose(out, want[0], rtol=SEQ_RTOL,
                                            atol=SEQ_ATOL)}
            for t, g, w in zip("qkv", grads, want[1:]):
                scale = w.abs().max().item()
                err["d" + t] = (g - w).abs().max().item() / scale
            _, fwd = device_timer(
                lambda: fn(*blocks, mesh, axis="sp", causal=causal),
                iters=SEQ_ITERS, warmup=1)
            _, both = device_timer(lambda: _seq_case(fn, blocks, mesh,
                                                     causal),
                                   iters=SEQ_ITERS, warmup=1)
            err.update(fwd_ms=fwd * 1e3, fwd_bwd_ms=both * 1e3)
            result[tag] = err
    # the transport alone, in turns with the forward it belongs to: the
    # ring's n - 1 K/V rotations, and Ulysses' four all-to-alls
    kv = torch.stack(blocks[1:])
    fwd, rot = _alternate([
        lambda: ring_attention(*blocks, mesh, axis="sp"),
        lambda: [coll.ppermute(kv, 1) for _ in range(SEQ_RANKS - 1)]],
        SEQ_ITERS)
    ufwd, a2a = _alternate([
        lambda: ulysses_attention(*blocks, mesh, axis="sp"),
        lambda: [coll.all_to_all(t, 2, 1) for t in blocks]
        + [coll.all_to_all(blocks[0], 1, 2)]], SEQ_ITERS)
    result.update(ring_fwd_ms=fwd * 1e3, rotation_ms=rot * 1e3,
                  ulysses_fwd_ms=ufwd * 1e3, all_to_all_ms=a2a * 1e3)
    torch.save(result, os.path.join(outdir, f"seq{rank}.pt"))
    collective.finalize()


def tp_worker_main(outdir):
    """One rank of phase 14c (``--worker tp OUTDIR``), in a 4-worker job
    of the port's launcher: ``ring_allreduce`` against ``psum`` and
    ``allreduce_bandwidth_gbps`` over the 4 ranks; two f32 steps of
    ``MLP(model_axis="model")`` on the rank's first two batches of the
    data; then ``train_mlp.main`` with ``--model-parallel 2`` (bf16, 2
    epochs, a ``--checkpoint-dir``), its first two steps' all-reduced
    gradients and its checkpoint's params captured gathered, with the
    world-1 and the tensor-parallel ``predict`` of probe rows at that
    point."""
    from dmlc_core_tpu_torch import collective
    from dmlc_core_tpu_torch.bridge.loader import MeshBatchLoader
    from dmlc_core_tpu_torch.collective.mesh_collectives import (
        MeshCollective, allreduce_bandwidth_gbps, ring_allreduce)
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.examples import train_mlp
    from dmlc_core_tpu_torch.models import mlp as mlp_mod
    from dmlc_core_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(outdir, "tp.json")) as f:
        run = json.load(f)
    rank = int(os.environ["DMLC_TASK_ID"])
    for fd, ext in ((1, "out"), (2, "err")):
        with open(os.path.join(outdir, f"tp{rank}.{ext}"), "w") as f:
            os.dup2(f.fileno(), fd)
    dev = torch.device("cuda")
    collective.init({"backend": "gloo", "timeout": MW_COLLECTIVE_TIMEOUT_S})
    result = {"rank": rank}

    # the ring all-reduce and the algbw meter over the 4 ranks
    flat = make_mesh({"r": 4})
    x = torch.from_numpy(np.random.RandomState(rank).randn(
        RING_ELEMS).astype(np.float32)).to(dev)
    ring = ring_allreduce(flat, "r", x)
    psum = MeshCollective(flat, "r").psum(x)
    result["ring_err"] = (ring - psum).abs().max().item()
    result["ring_bitwise"] = bool(torch.equal(ring, psum))
    result["gbps"] = allreduce_bandwidth_gbps(flat, "r", nbytes=RING_BYTES,
                                              iters=5)

    # two f32 steps on the rank's first two batches, gathered
    mesh = make_mesh({"data": 2, "model": 2})
    param = mlp_mod.MLPParam(num_feature=N_FEATURES, bf16=False)
    model = mlp_mod.MLP(param, model_axis="model", device=dev, mesh=mesh)
    params = model.init_params()
    opt = model.init_optimizer(params)
    parser = create_parser(run["data"], mesh.coord("data"), 2, type="auto")
    loader = MeshBatchLoader(parser, mesh, form="dense",
                             global_batch_size=1024,
                             num_feature=N_FEATURES, device=dev)
    f32_steps = []
    with mesh:
        for batch, _ in zip(loader, range(2)):
            leaves = [t.detach().requires_grad_(True)
                      for t in mlp_mod._leaves(params)]
            loss, grads = model._data_parallel_grads(leaves, batch)
            f32_steps.append(_to_cpu(dict(
                params=model.gather_params(params),
                grads=model.gather_params(mlp_mod._rebuild(list(grads))),
                loss=loss, batch=batch)))
            params, opt, _ = model.train_step(params, opt, batch)
    loader.close()
    result["f32_steps"] = f32_steps

    # the CLI, its first two steps and its checkpoint captured gathered
    steps, saved = [], {}
    grads_of = mlp_mod.MLP._data_parallel_grads
    gathered = train_mlp._gathered
    probe = torch.from_numpy(np.asarray(run["probe"], np.float32)).to(dev)

    def recorded(self, leaves, batch):
        loss, grads = grads_of(self, leaves, batch)
        if len(steps) < 2:
            steps.append(_to_cpu(dict(
                params=self.gather_params(mlp_mod._rebuild(leaves)),
                grads=self.gather_params(mlp_mod._rebuild(list(grads))),
                loss=loss, batch=batch, param=self.param)))
        return loss, grads

    def gathered_and_scored(model, params, opt_state):
        full = gathered(model, params, opt_state)
        one = mlp_mod.MLP(model.param, device=model.device)
        saved.update(_to_cpu(dict(
            params=full[0], world1_predict=one.predict(full[0], probe),
            tp_predict=model.predict(params, probe))))
        return full

    mlp_mod.MLP._data_parallel_grads = recorded
    train_mlp._gathered = gathered_and_scored
    lines = _tee_lines()
    start = time.perf_counter()
    blocks, _, losses = train_mlp.main(run["argv"])
    sys.stdout, sys.stderr = sys.stdout.inner, sys.stderr.inner
    result.update(wall=time.perf_counter() - start, losses=losses,
                  blocks=_to_cpu(blocks), steps=steps, saved=saved,
                  lines=list(lines))
    torch.save(result, os.path.join(outdir, f"tp{rank}.pt"))


def _replay_world_one(steps, bf16):
    """The largest gradient error of each step of ``steps`` (gathered
    params, batches of both data ranks, all-reduced loss and gradients of
    the tensor-parallel run) against a world-1 step over the global
    batch, relative to the largest gradient, and the loss's relative
    error."""
    from dmlc_core_tpu_torch.models import mlp as mlp_mod

    dev = torch.device("cuda")
    out = []
    for s0, s1 in zip(*steps):
        param = mlp_mod.MLPParam(num_feature=N_FEATURES, bf16=bf16)
        model = mlp_mod.MLP(param, device=dev)
        leaves = [t.to(dev).requires_grad_(True)
                  for t in mlp_mod._leaves(s0["params"])]
        gb = mlp_mod.batch_to(_global_batch(s0["batch"], s1["batch"]), dev)
        with torch.enable_grad():
            loss = model._loss(mlp_mod._rebuild(leaves), gb)
            grads = torch.autograd.grad(loss, leaves)
        got = mlp_mod._leaves(s0["grads"])
        scale = max(g.abs().max().item() for g in grads)
        gerr = max((a.to(dev) - b).abs().max().item()
                   for a, b in zip(got, grads)) / scale
        lerr = abs(float(s0["loss"]) - loss.item()) / abs(loss.item())
        out.append((gerr, lerr))
    return out


def phase_parallel(card, ref):
    """Phase 14: the tensor- and sequence-parallel slice on the card, ranks
    sharing it over gloo.  Returns rank 0's K4 launches of 14a."""
    from dmlc_core_tpu_torch import graft_entry
    from dmlc_core_tpu_torch.bridge.checkpoint import CheckpointManager
    from dmlc_core_tpu_torch.models import mlp as mlp_mod

    print(f"== phase 14: tensor and sequence parallelism, ranks sharing the "
          f"card over gloo (not scaling figures) [{card}]", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()

    # 14a: the dryrun of the reference's multi-device step
    start = time.perf_counter()
    summary = graft_entry.dryrun_multichip(DRYRUN_RANKS,
                                           timeout_s=MW_TIMEOUT_S)
    if summary["k4_launches"] <= 0:
        fail("14a: K4 was not launched on the card")
    k4_err = summary["k4_max_abs_err"]
    if set(k4_err) != {"flat", "hybrid"}:
        fail(f"14a: K4 was held to its plain versions on {sorted(k4_err)}, "
             f"not on the flat and the hybrid mesh")
    print(f"14a dryrun_multichip({DRYRUN_RANKS}) above: rank 0 launched K4 "
          f"{summary['k4_launches']} times; K4 at the dryrun's shapes (16 "
          f"bins, 4 columns a rank) against its plain version and the "
          f"whole rows' grad_hist_ref: max abs err {k4_err['flat']:.3g} on "
          f"the flat mesh, {k4_err['hybrid']:.3g} on the hybrid mesh (rtol "
          f"{graft_entry.K4_RTOL}, atol {graft_entry.K4_ATOL}, every rank); "
          f"{summary['seconds']:.1f} s on rank 0, "
          f"{time.perf_counter() - start:.1f} s with the launch [{card}]",
          flush=True)

    # 14b: ring and Ulysses attention at L = 8,192 over 4 ranks
    outdir = os.path.join(here, "build", "chip_smoke_parallel")
    shutil.rmtree(outdir, ignore_errors=True)
    start = time.perf_counter()
    _launch_workers("seq", SEQ_RANKS, outdir, MW_TIMEOUT_S)
    ranks = [torch.load(os.path.join(outdir, f"seq{r}.pt"),
                        weights_only=False) for r in range(SEQ_RANKS)]
    r0 = ranks[0]
    for tag in ("ring_full", "ring_causal", "ulysses_full",
                "ulysses_causal"):
        errs = [r[tag] for r in ranks]
        worst = {k: max(e[k] for e in errs) for k in ("out", "dq", "dk",
                                                      "dv")}
        e = r0[tag]
        print(f"14b {tag} B={SEQ_B} L={SEQ_L:,} H={SEQ_H} D={SEQ_D} f32 "
              f"over {SEQ_RANKS} ranks: out max abs err {worst['out']:.3g}"
              f" (rtol {SEQ_RTOL}, atol {SEQ_ATOL}); dq/dk/dv max err "
              f"{worst['dq']:.3g}/{worst['dk']:.3g}/{worst['dv']:.3g} of "
              f"max|g_ref|; rank 0 forward {e['fwd_ms']:.2f} ms, "
              f"forward+backward {e['fwd_bwd_ms']:.2f} ms [{card}]",
              flush=True)
        if not all(x["out_ok"] for x in errs):
            fail(f"14b {tag}: the output disagrees with reference_attention")
        if max(worst["dq"], worst["dk"], worst["dv"]) > SEQ_GRAD_TOL:
            fail(f"14b {tag}: gradients beyond {SEQ_GRAD_TOL} of "
                 f"max|g_ref|: {worst}")
    print(f"14b transport (gloo through host memory), medians of "
          f"{SEQ_ITERS} turns with the non-causal forward on rank 0: the "
          f"ring's {SEQ_RANKS - 1} K/V rotations {r0['rotation_ms']:.2f} ms "
          f"of its {r0['ring_fwd_ms']:.2f} ms forward "
          f"({100 * r0['rotation_ms'] / r0['ring_fwd_ms']:.0f}%), Ulysses' "
          f"4 all-to-alls {r0['all_to_all_ms']:.2f} ms of "
          f"{r0['ulysses_fwd_ms']:.2f} ms "
          f"({100 * r0['all_to_all_ms'] / r0['ulysses_fwd_ms']:.0f}%); 14b "
          f"{time.perf_counter() - start:.1f} s [{card}]", flush=True)

    # 14c: train_mlp --model-parallel 2 in 4 workers, then its resume
    start = time.perf_counter()
    data = _ingest_path()          # phase 6's, kept by phase 13
    if not os.path.exists(data):
        os.makedirs(os.path.dirname(data), exist_ok=True)
        _write_text(data, ref["x"][:N_INGEST], ref["y"][:N_INGEST], " ",
                    " ", "{}:%.9g")
    ckpt = os.path.join(outdir, "ckpt")
    probe = make_higgs_like(N_HELDOUT, N_FEATURES, seed=1)[0][:TP_PROBE]
    common = ["--data", data, "--num-feature", str(N_FEATURES),
              "--model-parallel", "2", "--checkpoint-dir", ckpt]
    with open(os.path.join(outdir, "tp.json"), "w") as f:
        json.dump(dict(data=data, probe=probe.tolist(),
                       argv=common + ["--epochs", "2"]), f)
    _submit([], [sys.executable, os.path.abspath(__file__), "--worker",
                 "tp", outdir], outdir, "14c TP", MW_TIMEOUT_S, workers=4,
            log="tp")
    ranks = [torch.load(os.path.join(outdir, f"tp{r}.pt"),
                        weights_only=False) for r in range(4)]
    r0 = ranks[0]
    print(f"14c ring_allreduce of {RING_ELEMS:,} f32 over 4 ranks against "
          f"psum: max abs err {r0['ring_err']:.3g} (bitwise "
          f"{r0['ring_bitwise']}); allreduce_bandwidth_gbps "
          f"{r0['gbps']:.3f} GB/s at {RING_BYTES >> 20} MiB (gloo through "
          f"host, 4 ranks on 1 card: no interconnect figure) [{card}]",
          flush=True)
    if r0["ring_err"] > RING_TOL:
        fail(f"14c: ring_allreduce differs from psum by {r0['ring_err']}")
    # ranks (0, 2) hold model column 0, ranks (1, 3) column 1
    for r in (2, 3):
        for a, b in zip(mlp_mod._leaves(ranks[r]["blocks"]),
                        mlp_mod._leaves(ranks[r - 2]["blocks"])):
            if not torch.equal(a, b):
                fail(f"14c: rank {r}'s blocks differ from rank {r - 2}'s")
    for r in range(4):
        for a, b in zip(mlp_mod._leaves(ranks[r]["saved"]["params"]),
                        mlp_mod._leaves(r0["saved"]["params"])):
            if not torch.equal(a, b):
                fail(f"14c: rank {r}'s gathered checkpoint params differ")
    losses = r0["losses"]
    if len(losses) != 2 or not losses[1] < losses[0]:
        fail(f"14c: rank 0's losses {losses} do not fall")
    bf16 = _replay_world_one([ranks[0]["steps"], ranks[2]["steps"]], True)
    f32 = _replay_world_one([ranks[0]["f32_steps"], ranks[2]["f32_steps"]],
                            False)
    print(f"14c first two steps against world-1 steps over the same global "
          f"batches (gradient error of the largest, loss relative error): "
          f"bf16 {bf16}, f32 {f32} [{card}]", flush=True)
    if max(g for g, _ in bf16) > MW_GRAD_TOL \
            or max(lo for _, lo in bf16) > MW_GRAD_TOL:
        fail(f"14c: bf16 steps beyond {MW_GRAD_TOL}: {bf16}")
    if max(max(g, lo) for g, lo in f32) > TP_F32_TOL:
        fail(f"14c: f32 steps beyond {TP_F32_TOL}: {f32}")
    # the checkpoint is the full tree: a world-1 MLP restores it
    one = mlp_mod.MLP(ranks[0]["steps"][0]["param"], device="cuda")
    tmpl = one.init_params()
    params, _ = CheckpointManager(ckpt).restore(
        1, template=(tmpl, (one.init_optimizer(tmpl), ())))
    params = mlp_mod._rebuild([torch.from_numpy(np.array(a)).cuda()
                               for a in mlp_mod._leaves(params)])
    got = one.predict(params, torch.from_numpy(probe).cuda()).cpu()
    if not torch.equal(got, r0["saved"]["world1_predict"]):
        fail("14c: the restored checkpoint's predict differs from the TP "
             "run's gathered predict")
    tp_err = (r0["saved"]["tp_predict"] - got).abs().max().item()
    if tp_err > MW_GRAD_TOL:
        fail(f"14c: the tensor-parallel predict is {tp_err} from the world-1"
             f" predict of the gathered params")
    print(f"14c train_mlp --model-parallel 2 over 4 ranks (data 2 x model "
          f"2), {N_INGEST:,} rows, 2 epochs: rank 0 losses {losses}; "
          f"blocks bitwise equal across the data line, checkpoint params "
          f"bitwise equal on all 4 ranks; step 1 restored into a world-1 "
          f"MLP predicts bitwise the gathered params' predict on "
          f"{TP_PROBE} rows (tensor-parallel predict within {tp_err:.3g});"
          f" main() {r0['wall']:.1f} s [{card}]", flush=True)
    out, wall = _submit([], [sys.executable, "-m",
                             "dmlc_core_tpu_torch.examples.train_mlp",
                             *common, "--epochs", "3"], outdir,
                        "14c resume", MW_TIMEOUT_S, workers=4, log="tp")
    if "resuming from checkpoint epoch 1" not in out \
            or "epoch 2: loss=" not in out:
        fail("14c: the rerun did not resume from epoch 1 and train epoch 2")
    print(f"14c python -m dmlc_core_tpu_torch.examples.train_mlp "
          f"--model-parallel 2 --epochs 3 in 4 workers resumed and exited 0"
          f" in {wall:.1f} s [{card}]", flush=True)
    shutil.rmtree(os.path.dirname(data), ignore_errors=True)
    print(f"phase 14: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return summary["k4_launches"]

# -- phase 15: the substrate, the parse process pool, columnar ingest ----------
def _fit_from_blocks(blocks):
    """Phase 6's path from parsed RowBlocks: edges on the first 50,000
    rows, ``binned_batches``, the wire on the card, ``fit_binned``.
    Returns (ens, margin, wire, seconds binning, seconds fitting)."""
    from dmlc_core_tpu_torch.bridge.binning import HostBinner, binned_batches
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.utils.timer import device_time

    dev = torch.device("cuda")
    param = dict(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                 num_bins=NUM_BINS, learning_rate=0.3)
    model = GBDT(GBDTParam(**param), num_feature=N_FEATURES)
    start = time.perf_counter()
    px, _, _ = _dense_rows(blocks, N_FEATURES)
    model.make_bins(px[:50_000])
    binned = list(binned_batches(blocks, HostBinner(model.boundaries,
                                                    NUM_BINS), INGEST_BATCH))
    wire = np.concatenate([b.bins[:b.num_rows].numpy() for b in binned])
    label = torch.cat([b.label[:b.num_rows] for b in binned]).to(dev)
    bin_sec = time.perf_counter() - start
    (ens, margin), fit_sec = device_time(model.fit_binned,
                                         torch.from_numpy(wire).to(dev),
                                         label)
    return ens, margin, wire, bin_sec, fit_sec


def _check_fit(label, ens, margin, wire, ref):
    ref_ens, ref_margin = ref["ingest_fit"]
    if not np.array_equal(wire, ref["wire"][:N_INGEST]):
        fail(f"{label}: the binned wire differs from phase 4's")
    if not (all(torch.equal(a, b) for a, b in zip(ens, ref_ens))
            and torch.equal(margin, ref_margin)):
        fail(f"{label}: the fit differs from phase 6's ingest-path fit")


def _consumer_demo(card, build, demo, tmp):
    """15b: the C++ consumer built against the port's library, with the
    four checks of ``tests/test_cpp_consumer.py``."""
    from dmlc_core_tpu_torch import serializer as ser
    from dmlc_core_tpu_torch.io.stream import (create_stream,
                                               create_stream_for_read)

    out, err = build.communicate(timeout=CLI_TIMEOUT_S)
    if build.returncode != 0:
        fail(f"15b: consumer_demo.cc did not build against the port's "
             f"library: {err[-3000:]}")

    def run(*args):
        return subprocess.run([demo, *args], capture_output=True, text=True,
                              timeout=60)

    data = os.path.join(tmp, "demo.libsvm")
    nnz = label_sum = 0
    with open(data, "w") as f:
        for i in range(500):
            feats = [(j, (i + j) % 10 / 10.0) for j in range(i % 4 + 1)]
            f.write(f"{i % 2} " + " ".join(f"{j}:{v}" for j, v in feats)
                    + "\n")
            nnz += len(feats)
            label_sum += i % 2
    for nparts in ("1", "3"):
        proc = run(data, nparts)
        if (proc.returncode != 0 or f"rows=500 nnz={nnz} label_sum="
                f"{float(label_sum):.1f}" not in proc.stdout
                or "nthread : int, default=2" not in proc.stdout
                or "range check ok" not in proc.stdout):
            fail(f"15b: consumer_demo over {nparts} part(s): "
                 f"{proc.stdout}{proc.stderr}")
    spec = ser.Pair(ser.Map(ser.Str, ser.Vector(ser.POD(np.float32))),
                    ser.Vector(ser.Pair(ser.Str, ser.POD(np.int64))))
    blob = os.path.join(tmp, "port.bin")
    with create_stream(blob, "w") as s:
        ser.save(s, ({"bias": np.array([0.125], np.float32),
                      "weights": np.array([1.5, -2.25, 0.0], np.float32)},
                     [("rounds", 10), ("depth", 6)]), spec)
    proc = run("--deserialize", blob)
    if (proc.returncode != 0 or "maps=2 wsum=-0.6250 rounds=10 depth=6"
            not in proc.stdout or "roundtrip ok" not in proc.stdout):
        fail(f"15b: C++ did not load the port's blob: {proc.stdout}"
             f"{proc.stderr}")
    blob = os.path.join(tmp, "cpp.bin")
    proc = run("--serialize", blob)
    if proc.returncode != 0:
        fail(f"15b: consumer_demo --serialize: {proc.stderr}")
    with create_stream_for_read(blob) as s:
        maps, meta = ser.load(s, spec)
    if (list(maps["weights"]) != [1.5, -2.25, 0.0]
            or list(maps["bias"]) != [0.125]
            or meta != [("rounds", 10), ("depth", 6)]):
        fail(f"15b: the port read C++'s blob as {maps}, {meta}")
    garbage = os.path.join(tmp, "garbage.bin")
    with open(garbage, "wb") as f:
        f.write(b"\xff" * 64)
    proc = run("--deserialize", garbage)
    if proc.returncode != 1 or "deserialize failed" not in proc.stderr:
        fail(f"15b: garbage did not fail cleanly: {proc.returncode}")
    if run("--serialise", garbage).returncode != 2:
        fail("15b: an unknown flag was not refused with exit 2")
    print(f"15b consumer_demo.cc built unchanged against "
          f"libdmlc_torch_native.so: shard reads over 1 and 3 parts cover "
          f"500 rows / {nnz} nonzeros once, the port's blob loads in C++ and "
          f"C++'s in the port, garbage fails cleanly [{card}]", flush=True)


def _substrate_on_card(card, ref, tmp):
    """15b: phase 4's ensemble through the port's serializer and back onto
    the card, and dlpack interop with a CUDA tensor."""
    from dmlc_core_tpu_torch import interop
    from dmlc_core_tpu_torch import serializer as ser
    from dmlc_core_tpu_torch.convert import (ensemble_from_numpy,
                                             ensemble_to_numpy)
    from dmlc_core_tpu_torch.io.stream import (create_stream,
                                               create_stream_for_read)

    names = ("split_feat", "split_bin", "leaf_value", "default_left",
             "split_gain", "split_cover")
    arrays = dict(zip(names, ensemble_to_numpy(ref["ens"])))
    ints = {k: v.astype(np.int32).reshape(-1) for k, v in arrays.items()
            if v.dtype.kind in "bi"}
    floats = {k: v.reshape(-1) for k, v in arrays.items()
              if v.dtype.kind == "f"}
    spec = ser.Pair(ser.Map(ser.Str, ser.Vector(ser.POD(np.int32))),
                    ser.Map(ser.Str, ser.Vector(ser.POD(np.float32))))
    path = os.path.join(tmp, "ensemble.bin")
    start = time.perf_counter()
    with create_stream(path, "w") as s:
        ser.save(s, (ints, floats), spec)
    with create_stream_for_read(path) as s:
        got_ints, got_floats = ser.load(s, spec)
    loaded = []
    for name in names:
        want = arrays[name]
        flat = got_ints[name] if name in got_ints else got_floats[name]
        loaded.append(flat.astype(want.dtype).reshape(want.shape))
    ens = ensemble_from_numpy(loaded)
    sec = time.perf_counter() - start
    rows = ref["bins"][:N_SERVED]
    got = ref["model"].predict(ens, rows)
    want = ref["model"].predict(ref["ens"], rows)
    if not torch.equal(got, want):
        fail("15b: predict of the serializer round trip differs from the "
             "original ensemble's")
    print(f"15b phase 4's ensemble as Pair(Map(Str, Vector(POD(int32))), "
          f"Map(Str, Vector(POD(float32)))), {os.path.getsize(path):,} bytes"
          f", saved and loaded in {sec:.3f} s; predict on {N_SERVED:,} rows "
          f"on the card bitwise the original's [{card}]", flush=True)

    t = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    shared = interop.to_torch(torch.utils.dlpack.to_dlpack(t))
    on_card = interop.from_numpy(np.arange(4, dtype=np.float32))
    if (shared.data_ptr() != t.data_ptr() or shared.device != t.device
            or interop.from_torch(t).data_ptr() != t.data_ptr()
            or on_card.device.type != "cuda"
            or interop.to_numpy(on_card).tolist() != [0.0, 1.0, 2.0, 3.0]):
        fail("15b: dlpack interop did not share the CUDA tensor's memory")
    print("15b interop.to_torch of a CUDA tensor's dlpack capsule shares its "
          "data_ptr; from_numpy lands on the card, to_numpy copies back",
          flush=True)


def _columnar(card, ref, tmp, text_columns):
    """15c: a Parquet copy of 15a's rows through the columnar front door,
    where pyarrow is installed."""
    from dmlc_core_tpu_torch.data import arrow_ingest
    from dmlc_core_tpu_torch.data.factory import create_parser
    from dmlc_core_tpu_torch.ops import hist_cuda

    if not arrow_ingest.pyarrow_available():
        try:
            create_parser(os.path.join(tmp, "train.parquet"))
        except RuntimeError as exc:
            if "pyarrow" not in str(exc):
                fail(f"15c: a .parquet URI raised {exc!r}")
        else:
            fail("15c: a .parquet URI built a parser without pyarrow")
        print("15c columnar ingest did not run: pyarrow is not installed on "
              "this machine; a .parquet URI raises the one clear error "
              "naming pyarrow (no card figure)", flush=True)
        return 0
    import pyarrow as pa
    import pyarrow.parquet as pq

    x, y = ref["x"][:N_INGEST], ref["y"][:N_INGEST]
    cols = {"label": pa.array(y, pa.float32())}
    cols.update({f"f{j}": pa.array(x[:, j], pa.float32())
                 for j in range(N_FEATURES)})
    path = os.path.join(tmp, "train.parquet")
    pq.write_table(pa.table(cols), path, row_group_size=65_536)
    hist_cuda.reset_launches()
    blocks, sec = _parse_blocks(path + "?label_column=0")
    if not _same_columns(blocks, text_columns):
        fail("15c: the Parquet columns differ from the libsvm parse")
    ens, margin, wire, _, _ = _fit_from_blocks(blocks)
    torch.cuda.synchronize()
    launches = dict(hist_cuda.LAUNCHES)
    _check_fit("15c", ens, margin, wire, ref)
    print(f"15c Parquet (pyarrow {pa.__version__}, "
          f"{os.path.getsize(path):,} bytes): parse {sec:.3f} "
          f"s, {N_INGEST / sec:,.0f} rows/s, columns bitwise the libsvm "
          f"parse, fit bitwise phase 6's; launches {launches} [{card}]",
          flush=True)
    return launches["grad_hist_fused_cuda"]


def phase_substrate(card, ref):
    import tempfile

    from dmlc_core_tpu_torch import native_bridge
    from dmlc_core_tpu_torch.data import parse_proc
    from dmlc_core_tpu_torch.ops import hist_cuda

    print(f"== phase 15: the parse process pool ({PARSE_PROCS} workers) on "
          f"phase 6's {N_INGEST:,} libsvm rows -> fit, the substrate on the "
          f"card, columnar ingest", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    svm = _ingest_path()
    if not os.path.exists(svm):      # phase 14c removed it
        os.makedirs(os.path.dirname(svm), exist_ok=True)
        _write_text(svm, ref["x"][:N_INGEST], ref["y"][:N_INGEST], " ", " ",
                    "{}:%.9g")
    nbytes = os.path.getsize(svm)
    with tempfile.TemporaryDirectory() as tmp:
        # 15b's C++ consumer compiles while 15a parses
        demo = os.path.join(tmp, "consumer_demo")
        lib = native_bridge.library_path()
        build = subprocess.Popen(
            ["g++", "-std=c++17", "-Wall", "-Wextra", "-Werror", "-I",
             os.path.join(here, "include"),
             os.path.join(here, "examples", "cpp", "consumer_demo.cc"), lib,
             f"-Wl,-rpath,{os.path.dirname(lib)}", "-o", demo],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # 15a: the slice's path, counts set to 0 just before the parse
            hist_cuda.reset_launches()
            native_bridge.reset_engine_calls()
            parses = {}
            # the pool's first parse starts its workers (each spawned child
            # re-imports this script, torch included); the second is warm
            for name, procs in (("threads", "0"),
                                ("process pool, cold", str(PARSE_PROCS)),
                                ("process pool", str(PARSE_PROCS))):
                with _env(DMLC_TPU_DISABLE_NATIVE="1",
                          DMLC_PARSE_PROC=procs):
                    blocks, sec = _parse_blocks(svm)
                if parse_proc.engaged() != (procs != "0"):
                    fail(f"15a: the {name} parse ran with the pool "
                         f"engaged={parse_proc.engaged()}")
                parses[name] = blocks
                print(f"15a parse libsvm, numpy engine, {name} "
                      f"(DMLC_PARSE_PROC={procs}): {sec:.3f} s, "
                      f"{nbytes / sec / 1e6:.2f} MB/s, {N_INGEST / sec:,.0f} "
                      f"rows/s (host clock) [{card}]", flush=True)
            parse_proc.shutdown()
            if not _same_columns(parses.pop("process pool, cold"),
                                 parses["process pool"]):
                fail("15a: the pool's two parses differ")
            if any(native_bridge.ENGINE_CALLS.values()):
                fail(f"15a: the numpy engine called into the native library"
                     f": {native_bridge.ENGINE_CALLS}")
            if not _same_columns(parses["process pool"], parses["threads"]):
                fail("15a: the process pool's blocks differ from the "
                     "threads'")
            if not _same_columns(parses["process pool"],
                                 [ref["ingest_columns"]]):
                fail("15a: the process pool's columns differ from phase 6's "
                     "native parse")
            text_columns = parses.pop("threads")
            ens, margin, wire, bin_sec, fit_sec = _fit_from_blocks(
                parses.pop("process pool"))
            torch.cuda.synchronize()
            launches = dict(hist_cuda.LAUNCHES)
            print(f"15a phase 15 launches on the process-pool path: "
                  f"{launches}", flush=True)
            if launches["grad_hist_fused_cuda"] < ROUNDS * MAX_DEPTH:
                fail(f"15a: K3's kernel launched "
                     f"{launches['grad_hist_fused_cuda']} times, expected "
                     f">= {ROUNDS * MAX_DEPTH}")
            if launches["hist_matmul_cuda"] != 0:
                fail("15a: the fit launched K1")
            _check_fit("15a", ens, margin, wire, ref)
            print(f"15a the two parses' blocks bitwise equal and bitwise "
                  f"phase 6's native columns; binning {bin_sec:.3f} s, fit "
                  f"{fit_sec:.3f} s, ensemble and margin bitwise phase 6's "
                  f"[{card}]", flush=True)
            k3 = launches["grad_hist_fused_cuda"]
            del ens, margin, wire
            _substrate_on_card(card, ref, tmp)
            _consumer_demo(card, build, demo, tmp)
            k3 += _columnar(card, ref, tmp, text_columns)
        finally:
            if build.poll() is None:
                build.kill()
                build.wait()
    shutil.rmtree(os.path.dirname(svm), ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return k3


# -- phase 16: multi-worker training through the cluster backends -----------
FAKE_SSH = """#!/bin/sh
# sshd's side of a connection: drop ssh's options, run the command here
while [ $# -gt 0 ]; do
  case "$1" in
    -o|-p) shift 2 ;;
    *) break ;;
  esac
done
shift
exec sh -c "$*"
"""

FAKE_MPIRUN = """#!{python}
# Open MPI's mpirun: -n N, -x K=V; each rank gets OMPI_COMM_WORLD_RANK
import os, subprocess, sys
args = sys.argv[1:]
if "--version" in args:
    print("mpirun (Open MPI) 5.0.fake")
    sys.exit(0)
n, env, cmd, i = 1, {{}}, [], 0
while i < len(args):
    if args[i] == "-n":
        n = int(args[i + 1]); i += 2
    elif args[i] == "--hostfile":
        i += 2
    elif args[i] == "-x":
        k, _, v = args[i + 1].partition("="); env[k] = v; i += 2
    else:
        cmd = args[i:]; break
procs = []
for r in range(n):
    e = dict(os.environ, **env)
    e.pop("DMLC_TASK_ID", None)
    e.update(OMPI_COMM_WORLD_RANK=str(r), OMPI_COMM_WORLD_SIZE=str(n))
    procs.append(subprocess.Popen(cmd, env=e))
sys.exit(max([p.wait() for p in procs], default=0))
"""

FAKE_QSUB = """#!{python}
# an SGE array job: -t LO-HI runs the script once a task, SGE_TASK_ID set
import os, subprocess, sys
args = sys.argv[1:]
lo = hi = 1
for i, a in enumerate(args):
    if a == "-t":
        lo, hi = (int(x) for x in args[i + 1].split("-"))
procs = [subprocess.Popen(["/bin/bash", args[-1]],
                          env=dict(os.environ, SGE_TASK_ID=str(t)))
         for t in range(lo, hi + 1)]
sys.exit(max([p.wait() for p in procs], default=0))
"""


def _rabit_shutdown(rank):
    """Send the tracker this rank's Rabit ``shutdown``, as a Rabit client's
    finalize does.  The port's ranks meet through torch.distributed and
    never dial the tracker, and a launcher that joins it (sge, as in the
    reference) waits until every rank has shut down."""
    from dmlc_core_tpu_torch.tracker.rendezvous import MAGIC, FramedSocket

    uri = os.environ.get("DMLC_TRACKER_URI")
    port = os.environ.get("DMLC_TRACKER_PORT")
    if not uri or not port:
        fail("16: the rank got no DMLC_TRACKER_URI/PORT")
    try:
        with socket.create_connection((uri, int(port)), timeout=30) as s:
            fs = FramedSocket(s)
            fs.sendint(MAGIC)
            if fs.recvint() != MAGIC:
                fail("16: the tracker answered with another magic")
            fs.sendint(rank)
            fs.sendint(-1)
            fs.sendstr("NULL")
            fs.sendstr("shutdown")
    except OSError:
        # a launcher that does not join the tracker may be gone already
        pass


def backend_worker_main(outdir):
    """One rank of phase 16 (``--worker backend OUTDIR``): train_gbdt's
    ``main(argv)`` with the argv of ``OUTDIR/backend.json``; saves the
    rank that ``_task_id_from_env`` gives it and the launcher's variables
    it came from, the card it ran on, the ensemble, the launch counts, its
    printed lines and the fit's seconds."""
    from dmlc_core_tpu_torch.collective.api import _task_id_from_env
    from dmlc_core_tpu_torch.examples import train_gbdt
    from dmlc_core_tpu_torch.ops import hist_cuda

    with open(os.path.join(outdir, "backend.json")) as f:
        argv = json.load(f)["argv"]
    rank = _task_id_from_env(os.environ)
    with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
        os.dup2(f.fileno(), 2)
    hist_cuda.kernels_available()      # the probe's launches are not the path's
    fit_s = []
    fit_distributed = train_gbdt._fit_distributed

    def timed_fit(model, bins, label, collective):
        out = fit_distributed(model, bins, label, collective)
        fit_s.append((out[3], collective.get_rank(),
                      collective.get_world_size()))
        return out

    train_gbdt._fit_distributed = timed_fit
    lines = _tee_lines()
    hist_cuda.reset_launches()
    out = train_gbdt.main(argv)
    sys.stdout, sys.stderr = sys.stdout.inner, sys.stderr.inner
    env = {k: os.environ.get(k) for k in ("DMLC_TASK_ID",
                                          "OMPI_COMM_WORLD_RANK",
                                          "SGE_TASK_ID", "DMLC_JOB_CLUSTER")}
    torch.save(dict(rank=rank, env=env, card=torch.cuda.current_device(),
                    model=_ensemble_arrays(out[0]), lines=list(lines),
                    launches=dict(hist_cuda.LAUNCHES), fit=fit_s),
               os.path.join(outdir, f"rank{rank}.pt"))
    _rabit_shutdown(rank)


def _write_fakes(bindir):
    os.makedirs(bindir)
    for name, body in (("ssh", FAKE_SSH),
                       ("mpirun", FAKE_MPIRUN.format(python=sys.executable)),
                       ("qsub", FAKE_QSUB.format(python=sys.executable))):
        path = os.path.join(bindir, name)
        with open(path, "w") as f:
            f.write(body)
        os.chmod(path, 0o755)
        if shutil.which(name, path=bindir) != path:
            fail(f"16: the fake {name} at {path} is not runnable")


def _rank_source(backend, r):
    """(what ``_task_id_from_env`` must have read, its launcher variable)
    for rank ``r`` of a ``backend`` launch."""
    return {"mpi": ("OMPI_COMM_WORLD_RANK", r), "sge": ("SGE_TASK_ID", r + 1)
            }.get(backend, ("DMLC_TASK_ID", r))


def _host_cli(args, name, want_rc=0):
    """``python -m dmlc_core_tpu_torch.<args>``; fail unless it exits
    ``want_rc``.  Returns its stdout."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", *args], cwd=here,
                          env=dict(os.environ, PYTHONPATH=here),
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != want_rc:
        fail(f"16b {name}: exit {proc.returncode} (want {want_rc}):\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout


def _telemetry_checks(card, tel):
    """16b: the ssh launch's telemetry directory through the host CLIs."""
    merged = os.path.join(tel, "merged.json")
    report = json.loads(_host_cli(
        ["dmlc_core_tpu_torch.telemetry", "trace", tel, "--fail-on-orphans",
         "--json", "--out", merged], "telemetry trace"))
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    tracker = [t for t in report["traces"] if t["root"] == "tracker.start"]
    if len(tracker) != 1 or len(tracker[0]["pids"]) < 3 \
            or tracker[0]["orphans"] or report["orphans"]:
        fail(f"16b: want one tracker trace over >= 3 processes and no "
             f"orphans: {json.dumps(report)[:3000]}")
    t = tracker[0]
    snaps = json.loads(_host_cli(["dmlc_core_tpu_torch.telemetry", "report",
                                  tel, "--json"], "telemetry report"))
    ranks = sorted({r for v in snaps.values() for r in v.get("ranks", [])})
    if ranks != [0, 1]:
        fail(f"16b: the report aggregates rank(s) {ranks}, want [0, 1]")
    good = os.path.join(tel, "plan-good.json")
    bad = os.path.join(tel, "plan-bad.json")
    with open(good, "w") as f:
        json.dump({"seed": 1, "rules": [{"site": "tracker.accept",
                                         "kind": "delay", "seconds": 0.0}]},
                  f)
    with open(bad, "w") as f:
        f.write('{"rules": [{"site": "tracker.accept", "kind": "nope"}]}')
    _host_cli(["dmlc_core_tpu_torch.fault", "validate", good],
              "fault validate (good plan)")
    _host_cli(["dmlc_core_tpu_torch.fault", "validate", bad],
              "fault validate (malformed plan)", want_rc=2)
    print(f"16b telemetry trace --fail-on-orphans: exit 0; the tracker's "
          f"trace {t['trace_id'][:8]}... holds {t['spans']} spans from "
          f"{len(t['pids'])} processes, 0 orphans, {t['total_ms']:.1f} ms; "
          f"{report['spans']} spans in {report['sources']} files, "
          f"{len(events):,} events in merged.json; telemetry report: ranks "
          f"{ranks}, {len(snaps)} series; fault validate: 0 on a good plan, "
          f"2 on a malformed one [{card}]", flush=True)


def phase_backends(card, ref):
    """Phase 16: train_gbdt in 2 workers on the card through the launcher's
    local, ssh, mpi and sge backends (fake ssh, mpirun and qsub); the
    ssh launch's telemetry through the host CLIs."""
    import tempfile

    print(f"== phase 16: train_gbdt in 2 workers on one card through "
          f"--cluster {', '.join(BACKENDS)} (gloo; fake ssh, mpirun and "
          f"qsub), {N_MULTI:,} libsvm rows", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    outdir = os.path.join(here, "build", "chip_smoke_backends")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    x, y = ref["x"][:N_MULTI], ref["y"][:N_MULTI]
    ranks = {}
    with tempfile.TemporaryDirectory() as tmp:
        svm = os.path.join(tmp, "train.libsvm")
        _write_text(svm, x, y, " ", " ", "{}:%.9g")
        bindir = os.path.join(tmp, "bin")
        _write_fakes(bindir)
        hosts = os.path.join(tmp, "hosts")
        with open(hosts, "w") as f:
            f.write("localhost\nlocalhost\n")
        tel = os.path.join(outdir, "telemetry")
        os.makedirs(tel)
        # the launches' cwd: sge writes its run script there
        rundir = os.path.join(tmp, "run")
        os.makedirs(rundir)
        argv = ["--data", svm, "--num-feature", str(N_FEATURES), "--rounds",
                str(ROUNDS), "--max-depth", str(MAX_DEPTH), "--num-bins",
                str(NUM_BINS)]
        walls = {}
        for backend in BACKENDS:
            bdir = os.path.join(outdir, backend)
            os.makedirs(bdir)
            with open(os.path.join(bdir, "backend.json"), "w") as f:
                json.dump({"argv": argv}, f)
            # what a remote rank needs travels as --env (ssh forwards only
            # its FORWARD_ENV list of the launcher's own variables)
            args = ["--env", f"DMLC_COLLECTIVE_TIMEOUT="
                             f"{MW_COLLECTIVE_TIMEOUT_S}",
                    "--env", "OMP_NUM_THREADS=2"]
            env = {"PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}"}
            if backend == "ssh":
                args += ["--host-file", hosts, "--env",
                         f"DMLC_TELEMETRY_DIR={tel}"]
                env["DMLC_TELEMETRY_DIR"] = tel     # the launcher's own spans
            if backend == "sge":
                args += ["--jobname", "chip_smoke"]
            out, walls[backend] = _submit(
                args, [sys.executable, os.path.abspath(__file__), "--worker",
                       "backend", bdir], bdir, f"phase 16 --cluster {backend}",
                MW_TIMEOUT_S, log="rank", cluster=backend, cwd=rundir,
                env_extra=env)
            paths = [os.path.join(bdir, f"rank{r}.pt") for r in range(2)]
            missing = [p for p in paths if not os.path.exists(p)]
            if missing:
                fail(f"16a --cluster {backend}: exit 0 but no {missing}")
            ranks[backend] = [torch.load(p, weights_only=False)
                              for p in paths]
            summary = _over_two(out.splitlines())
            if len(summary) != 2 or summary[0] != summary[1]:
                fail(f"16a --cluster {backend}: not one trained line twice: "
                     f"{summary}")
        if not os.path.exists(os.path.join(rundir, "chip_smoke.sge.sh")):
            fail("16a --cluster sge wrote no run script into its cwd")

    base = ranks["local"][0]
    k3_need = ROUNDS * MAX_DEPTH
    for backend, runs in ranks.items():
        for r, run in enumerate(runs):
            key, value = _rank_source(backend, r)
            if run["rank"] != r or run["env"][key] != str(value) \
                    or (backend == "mpi" and run["env"]["DMLC_TASK_ID"]):
                fail(f"16a --cluster {backend}: rank {r} read rank "
                     f"{run['rank']} from {run['env']}")
            if [f[1:] for f in run["fit"]] != [(r, 2)]:
                fail(f"16a --cluster {backend}: rank {r}'s collective was "
                     f"(rank, world) {[f[1:] for f in run['fit']]}")
            for k, a in base["model"].items():
                b = run["model"][k]
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    fail(f"16a --cluster {backend}: rank {r}'s {k} differs "
                         f"from the local launch's rank 0")
            k1 = run["launches"]["hist_matmul_cuda"]
            k3 = run["launches"]["grad_hist_fused_cuda"]
            if k3 < k3_need or k1 != 0:
                fail(f"16a --cluster {backend}: rank {r} launched K3 {k3} "
                     f"times (want >= {k3_need}) and K1 {k1} (want 0)")
            lines = _over_two(run["lines"])
            if len(lines) != 1 or lines[0] != _over_two(runs[0]["lines"])[0]:
                fail(f"16a --cluster {backend}: rank {r}'s summary lines "
                     f"{lines}")
        fit = runs[0]["fit"][0][0]
        print(f"16a --cluster {backend}: launch {walls[backend]:.1f} s; fit "
              f"{fit:.4f} s (the slower rank), "
              f"{N_MULTI * ROUNDS / fit:,.0f} rows/s; ranks "
              f"{[run['rank'] for run in runs]} from "
              f"{_rank_source(backend, 0)[0]}, card "
              f"{[run['card'] for run in runs]}; K3 "
              f"{[run['launches']['grad_hist_fused_cuda'] for run in runs]}, "
              f"K1 {[run['launches']['hist_matmul_cuda'] for run in runs]}; "
              f"ensembles bitwise the local launch's [{card}]", flush=True)
    print(f"16a {_over_two(base['lines'])[0]}", flush=True)
    _telemetry_checks(card, tel)
    print(f"phase 16: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)
    return ranks["ssh"][0]["launches"]["grad_hist_fused_cuda"]


def _sync_sites(fn):
    """Run ``fn`` with the card's sync debug mode on.  Returns its result,
    the innermost package frame ``(relpath, line, function)`` of each
    synchronizing call the card reported, in order (a call with no
    package frame on its stack gives ``("<outside the package>", line,
    chain)``, the chain its innermost frames), and the other warnings
    raised meanwhile."""
    import traceback
    import warnings

    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(here, "dmlc_core_tpu_torch") + os.sep
    sites, others = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            others.append(f"{category.__name__}: {message}")
            return
        stack = traceback.extract_stack()[:-1]
        for frame in reversed(stack):
            if frame.filename.startswith(pkg):
                rel = os.path.relpath(frame.filename, here)
                sites.append((rel.replace(os.sep, "/"), frame.lineno,
                              frame.name))
                return
        chain = " <- ".join(
            f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
            for f in reversed(stack) if "warnings" not in f.filename)
        sites.append(("<outside the package>", lineno, chain))

    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sites, others


def _innermost_stmt(tree, line):
    """(first, last) line of the innermost statement holding ``line``."""
    import ast

    best = None
    for node in ast.walk(tree):
        if not (isinstance(node, ast.stmt)
                and node.lineno <= line <= node.end_lineno):
            continue
        span = (node.lineno, node.end_lineno)
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and line < body[0].lineno:
            span = (node.lineno, body[0].lineno - 1)   # a compound header
        if best is None or span[1] - span[0] < best[1] - best[0]:
            best = span
    return best or (line, line)


def _purity_view(relpath):
    """The purity pass's view of one package file: its parsed tree, the
    line spans of its roots and reached functions, and its findings."""
    import ast

    from dmlc_core_tpu_torch.analysis import purity
    from dmlc_core_tpu_torch.analysis.driver import (FileContext,
                                                     analyze_source)

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, relpath), encoding="utf-8") as f:
        src = f.read()
    tree = ast.parse(src, relpath)
    spans = purity.hot_regions(FileContext(relpath, src, tree, True, False))
    return tree, spans, analyze_source(src, relpath, passes=["purity"])


def phase_analysis(card, ref):
    """Phase 17: the port's lint gate on the card machine (17a), then the
    host syncs the card reports through a fit and two predicts, held
    against the static purity rule (17b)."""
    from dmlc_core_tpu_torch.models.gbdt import GBDT, GBDTParam
    from dmlc_core_tpu_torch.ops import hist_cuda

    print("== phase 17: the port's lint gate; host syncs on the card "
          "against the purity rule", flush=True)
    phase_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dmlc_core_tpu_torch.analysis"],
                          cwd=here, capture_output=True, text=True,
                          timeout=GATE_TIMEOUT_S)
    gate_sec = time.perf_counter() - start
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    print(f"17a gate: exit {proc.returncode}, {summary!r}, {gate_sec:.1f} s "
          f"[{card}]", flush=True)
    if proc.returncode != 0 or " 0 new finding(s)" not in summary:
        fail(f"17a: the port's gate failed:\n{proc.stdout}\n{proc.stderr}")

    model = GBDT(GBDTParam(num_boost_round=ROUNDS, max_depth=MAX_DEPTH,
                           num_bins=NUM_BINS, learning_rate=0.3),
                 num_feature=N_FEATURES)
    model.set_boundaries(ref["model"].boundaries)
    bins, y_tr = ref["bins"], ref["y_tr"]
    want = {n: model.predict(ref["ens"], bins[:n]) for n in SYNC_PREDICT_ROWS}
    torch.cuda.synchronize()
    # the control: the first toggle of the debug mode in a process reports
    # one sync of its own, at set_sync_debug_mode, with no work between
    _, control, _ = _sync_sites(lambda: None)
    hist_cuda.reset_launches()
    start = time.perf_counter()
    (ens, margin), fit_sites, others = _sync_sites(
        lambda: model.fit_binned(bins, y_tr))
    fit_sec = time.perf_counter() - start
    _check_k3("17b fit under the sync debug mode", ROUNDS * MAX_DEPTH)
    same = (all(torch.equal(a, b) for a, b in zip(ens, ref["ens"]))
            and torch.equal(margin, ref["margin"]))
    print(f"17b fit: {fit_sec:.3f} s with the debug mode on; ensemble and "
          f"margin bitwise phase 4's auto fit: {same}", flush=True)
    if not same:
        fail("17b: the fit under the sync debug mode differs from phase 4's")
    runs = [("control, no work", control), ("fit", fit_sites)]
    for n in SYNC_PREDICT_ROWS:
        got, sites, more = _sync_sites(
            lambda n=n: model.predict(ref["ens"], bins[:n]))
        others += more
        if not torch.equal(got, want[n]):
            fail(f"17b: predict of {n} rows differs under the debug mode")
        runs.append((f"predict {n}", sites))
    print(f"17b syncs: control {len(control)}; fit {len(fit_sites)} "
          f"({len(fit_sites) / ROUNDS:g} a round), "
          + ", ".join(f"{label} {len(s)}" for label, s in runs[2:])
          + f"; other warnings {len(others)}", flush=True)
    # "error" mode raises at the first sync with its Python stack: the
    # same calls again, as a second witness
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.fit_binned(bins, y_tr)
        for n in SYNC_PREDICT_ROWS:
            model.predict(ref["ens"], bins[:n])
        raised = "nothing"
    except RuntimeError as exc:
        raised = f"{exc}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"17b the fit and both predicts under the \"error\" mode raised "
          f"{raised}", flush=True)
    for w in sorted(set(others))[:5]:
        print(f"17b other warning: {w}")

    views = {}
    unexplained = set()
    seen = set()
    for label, sites in runs:
        for site in sorted(set(sites)):
            rel, line, func = site
            n = sites.count(site)
            if not rel.startswith("dmlc_core_tpu_torch/"):
                print(f"17b site [{label}] {rel}: {n}x, no package frame "
                      f"on its stack: {func}")
                continue
            if rel not in views:
                views[rel] = _purity_view(rel)
            tree, spans, found = views[rel]
            lo, hi = _innermost_stmt(tree, line)
            seen.add((rel, lo, hi))
            hot = [k for k, a, b in spans if a <= line <= b]
            rules = sorted({f.rule for f in found if lo <= f.lineno <= hi})
            print(f"17b site [{label}] {rel}:{line} {func}: {n}x; purity "
                  f"root: {', '.join(sorted(set(hot))) or 'none'}; static "
                  f"finding: {', '.join(rules) or 'none'}", flush=True)
            if hot and not rules:
                unexplained.add(f"{rel}:{line} ({func})")
    static = []
    pkg = os.path.join(here, "dmlc_core_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, name), here).replace(
                os.sep, "/")
            tree, _, found = views.get(rel) or _purity_view(rel)
            for f in found:
                lo, hi = _innermost_stmt(tree, f.lineno)
                static.append((rel, lo, hi) in seen)
    print(f"17b static purity findings: {len(static)}, of which "
          f"{static.count(False)} never synced on the card in this run",
          flush=True)
    if unexplained:
        fail("17b: syncs inside a purity root that are neither a finding "
             f"nor baselined: {sorted(unexplained)}")
    print(f"phase 17: {time.perf_counter() - phase_start:.1f} s [{card}]",
          flush=True)


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False")
        sys.path.insert(0, here)
        if sys.argv[2] == "cli":
            cli_worker_main(sys.argv[3])
        elif sys.argv[2] == "seq":
            seq_worker_main(sys.argv[3])
        elif sys.argv[2] == "tp":
            tp_worker_main(sys.argv[3])
        elif sys.argv[2] == "backend":
            backend_worker_main(sys.argv[3])
        else:
            worker_main(sys.argv[2], sys.argv[3])
        return
    start = time.perf_counter()
    card = phase_device()
    if not os.path.isdir(os.path.join(here, "dmlc_core_tpu_torch")):
        fail(f"no dmlc_core_tpu_torch package beside {__file__}")
    sys.path.insert(0, here)
    phase_build(card)
    k1, k3 = phase_kernels()
    launches, ref = phase_gbdt(card)
    k1["launches"] = launches["hist_matmul_cuda"]     # 0: K1 is off the path
    k3["launches"] = launches["grad_hist_fused_cuda"]
    k4 = phase_distributed(card)
    phase_ingest(card, ref)
    serve_rate = phase_serve(card, ref)
    phase_train(card, ref)
    phase_tier(card, ref, serve_rate)
    phase_sampling(card, ref)
    # the slice's path: K3's launches of a phase-11 rank count too
    k3["launches"] += phase_multiworker(card, ref)
    # and those of phase 12's fit from recordio
    k3["launches"] += phase_recordio(card, ref)
    # and those of phase 13's fit from the bucket
    k3["launches"] += phase_remote(card, ref)
    # the parallel slice's path: rank 0's K4 launches of the dryrun count
    k4["launches"] += phase_parallel(card, ref)
    # and those of phase 15's fit from the parse process pool
    k3["launches"] += phase_substrate(card, ref)
    # and rank 0's of phase 16's launch through the ssh backend
    k3["launches"] += phase_backends(card, ref)
    phase_analysis(card, ref)
    del ref
    print(f"chip_smoke: phases 1-17 passed in "
          f"{time.perf_counter() - start:.1f} s [{card}]", flush=True)
    kernels = [k1, k3, dict(
        name="grad_hist_sharded_cuda", route="cuda",
        source="dmlc_core_tpu_torch/csrc/hist.cu",
        replaces="dmlc_core_tpu/ops/hist_pallas.py:350",
        launches=k4["launches"], max_abs_err=k4["max_abs_err"],
        ms=k4["ms"], plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        bound_by=k4["bound_by"], library_ms=k4["library_ms"])]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
