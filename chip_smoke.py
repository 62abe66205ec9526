#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``fairness_llm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --phase 33`` builds the kernels and runs phase 33
alone; ``--phase 34`` the same for phase 34, llama3-70b with int8 weights,
which needs the whole card: ~72 GB of parameters and a peak near 80 GB;
``--phase 35`` for phase 35, the HF checkpoint path, which needs ~17 GB of
free disk.)

It builds the port's hand-written CUDA kernels from ``ops/csrc/`` with
``nvcc`` (sm_90a), drives the port's phase-1 serving path through
``EngineBackend.generate`` at the full width of llama3-8b (8 of its 32
layers, ``CUT_LAYERS``; random bf16 weights from seed 0): plain, with
greedy prompt-lookup speculation, and with the int8 KV cache on the same
weights; then at the full width of llama3-8b-int8 (the same model with int8
projection and lm_head weights from seed 0, ``CUT_LAYERS`` of its layers
too; phase 35 serves it at all 32). It shows that each path launched its
kernels, holds each kernel against its plain PyTorch version at the shapes
the path gave it, times kernel, plain version and a one-call PyTorch
yardstick, and checks the model's logits and greedy tokens against the
plain versions on a small input. Then it runs the phase-1 sweep itself
(``pipeline/phase1.run_phase1``, from MovieLens to the saved record): on the
two study checkpoints in ``checkpoints/``, read with the port's own
safetensors reader and BPE tokenizer, and at the full width of llama3-8b
with int8 weights. Last it runs phases 2 and 3 of the study
(``pipeline/phase2.run_phase2``, ``pipeline/phase3.run_phase3``) on the
same models, with their teacher-forced scoring forward, and the phase-1
sweep once more through the continuous-batching server
(``serving/ContinuousScheduler`` behind ``backend_for``), then through its
paged KV cache with prefix reuse; then it drives the fault containment on
the card, overload control with its QoS queues and the fairness monitor
through the CLI's telemetry export, the replica fleet with its failover,
autoscaler and rolling upgrade, and last the device-facing telemetry: the
memory ledger, the roofline, the cost ledger and the compile stats, with
their reports and the headroom signals; then the per-phase device trace
of a served full-width run, and the study data-parallel over two ranks; and
last tensor parallelism (the study and the served full-width sweep over two
tp ranks), ring attention over two sp ranks, and training, in one process
and over two tp ranks, with the native ratings parser built on the card's
machine.

Phases (any failure exits non-zero, and no result line is printed); every
path's launch counts are set to 0 just before it and read just after:
  1. the card's name and power limit (nvidia-smi);
  2. build the kernels, one nvcc per source, in parallel;
  bf16 path (llama3-8b at ``CUT_LAYERS`` of its 32 layers; K1 flash
  attention, K2 decode attention, K3 the verify window):
  3. the bf16 logits product on the model's head: an f32 sum of the bf16
     operands with no f32 copy of the head (``head_product_check``); then
     serve 16 counterfactual phase-1 prompts with a sweep-wide shared
     prefix, greedy and at temperature 0.7 with per-row keys;
  4. serve the same prompts with no shared prefix (flash prefill at batch
     16 over the whole prompt); every K1 launch of a bf16 path must be one
     of the tensor-core kernel (``tc_launches`` equal to ``launches``), and
     so must every K2 and K2q launch of every path (``decode_tc_launches``:
     decode_split_tc);
  5. the shared-prefix greedy call with speculation on (draft_len 8,
     ngram_max 3): K3 must launch, every launch on the tensor-core kernel
     (``multi_tc_launches`` equal to the K3 launches); its speculation
     counters are logged, and the call is profiled as in phase 7 (verify
     ms per step, device time of the K3 kernels);
  6. each kernel against its plain version at the shapes of phases 3-5,
     held elementwise to 4e-3 + 1e-2 * |plain| (bf16), with timings, the
     least time the card could take and the achieved TFLOP/s; the kernel
     on a blinded input (one key masked out; for K3 every q_offset lowered
     by one, so each query loses its own slot) must fail that tolerance
     (where a decode row's recorded scores are so flat that one key moves
     no output past it, as at gpt2-small's random weights, the row is held
     again with q scaled by 6, and the blind check made there too);
     the wrapper's host microseconds a call; K2 and K2q also at the study's
     batch of 48 (held to the same tolerance and blind check; times
     reported, not gated);
  7. where a decode call's time goes: the shared-prefix greedy call with 8
     new tokens, three times untraced, then once under torch.profiler (the
     device's busy share over the traced call's span, device time by
     kernel, K2's kernels per step); the SM clock and power draw are sampled
     with nvidia-smi around every serve call;
  8. the share of speculative greedy tokens equal to plain greedy ones at
     the path's depth in bf16 (reported only);
  9. the model's logits with the kernels against the same model run on the
     plain versions, teacher-forced on 4 prompts, at the path's depth in
     bf16 (reported);
  int8 KV cache (kv_cache_quant, over the bf16 engine's own tensors; K2q
  and K3 over an int8 cache):
 10. the engine must share every parameter tensor (no second copy); the
     cache bytes it holds against the bf16 cache's at one shape;
 11. phases 3-4 and then 5 on it: K1, K2q and K3 over int8 must launch,
     every K3 launch on the tensor-core kernel;
 12. both modes against their plain versions as in phase 6, the
     speculative call's profile as in phase 5, and phase 9's report;
 13. the gates in float32 at full width with the depth cut to 4 layers:
     teacher-forced logits within 1e-3 of the largest logit (float cache
     and int8 cache), and speculative greedy tokens equal to plain greedy
     ones (float cache; the int8 cache's are reported); no tensor-core
     kernel may launch, and every kernel call of the gates is held against
     its plain version at float32's 1e-4 with phase 6's blind checks: K1 f32
     (flash_fwd) and K2 f32 (decode_split_f32) as the f32 entries'
     ``gate_shapes``, the verify window over a float cache
     (verify_split_f32) as ``decode_attention_verify_f32``'s, and the two
     float32 routes no other phase runs, the verify window over an int8
     cache (verify_split_f32) and the one-query call over an int8 cache
     (decode_split_f32), as entries of their own
     (``decode_attention_verify_f32_int8_cache``,
     ``decode_attention_f32_int8_cache``); every verify launch must be one
     the C entry reports as verify_split_f32's, and its repeats must agree
     bit for bit;
  int8-weight path (llama3-8b-int8; K4 int8-weight matmul, GEMV and GEMM
  regimes, with K1 and K2), after the bf16 engines are freed:
 14. build the engine; the memory it allocates must stay within 5% of its
     tree (int8 matrices, f32 scales, bf16 embedding and norms);
 15. the three serve calls of phases 3-4, with the peak memory over them;
     both K4 regimes, the grouped call (q/k/v, gate/up), K1 and K2 must all
     launch, and the GEMV regime must make one kernel launch a call;
 16. K4 against its plain version at every (shape, dtypes) the path gave it,
     single and grouped (each output against its own weight's plain
     product), and the GEMV calls of a decode step again at the study's
     batch of 48, held to the same elementwise tolerance; the kernel on x
     with its last 32 columns zeroed (its last k tile dropped) must fail it;
     each launch is timed alone after a 64 MB write evicts the L2 cache, as
     a decode step finds a layer's weights; the host's cost of a call is
     timed beside torch.matmul's (over the group's weights side by side);
 17. the profile of phase 7 for the int8 shared-prefix greedy call, with
     the K4 GEMV kernel's device ms and launches a step beside K2's;
 18. the teacher-forced check of phase 9 with K4 swapped for its plain
     version too: reported in bf16 at 8 layers, held to 1e-3 in float32
     at 4 layers; in float32, with a shared-prefix greedy call of the 16
     prompts after it (4 new tokens: the decode steps at M = 16), every K4
     call (a grouped GEMV call one) is recorded and counted
     (``quant_matmul.f32_launches``: K4's float32 route, two TF32 passes),
     each launch by the kernel the C entry reports (gemv_stream_tf32 for
     M <= 64, tf32_gemm_kernel past it; every one must be on those two),
     and held against its plain version at 1e-4 + 3e-5 * |plain| (as
     tests/test_torch_cuda.py holds it) with phase 16's blind check and
     two calls that agree bit for bit: the ``quant_matmul_f32`` entry.
  the phase-1 sweep (``backend_for`` and ``run_phase1``, the user's entry
  points), after the int8 engine is freed:
 19. on tiny-llama-study and tiny-gpt2-study at the study's settings (45
     profiles and 3 neutral prompts, t=0.7, 64 tokens, chunks of 16): the
     manifest must verify, the checkpoint's BPE tokenizer must be in use,
     K1's and K2's f32 kernels (flash_fwd, decode_split_f32) must launch
     and their tensor-core kernels must not (each one-query launch counted
     by the kernel the C entry reports, so none ran elsewhere); 48 responses with no error entry,
     a non-empty list for some profile, finite metrics, a saved record that
     reads back and matches its manifest entry, and the same responses from
     a second run; then each of the two kernels against its plain version
     at every shape the sweep gave it, held elementwise to 1e-4 (float32),
     each blind check as in phase 6;
 20. the same sweep greedy on the card and on the CPU (the plain
     versions): every engine call's tokens equal row by row, or, where
     they differ, the CPU's top two logits at the first divergent token
     within 1e-4 (teacher-forced; such rows are logged); with equal tokens,
     equal records and metrics within 1e-6;
 21. the default sweep on llama3-8b with int8 weights (``--weight-quant
     int8``) at full width and ``CUT_LAYERS`` of its 32 layers (as phases
     23, 24-27, 29 and 30), random weights from the seed and the
     byte tokenizer: K1 and K2 on their tensor-core kernels and both K4
     regimes must launch, no error entry, the record written and read back;
     the wall seconds, each chunk's prefix, prefill and decode times and the
     peak memory are logged (parses and metrics are vacuous under random
     weights); then K1, K2 and K4 against their plain versions at every
     (shape, dtypes) the sweep gave them, as in phases 6 and 16.
  phases 2 and 3 of the study (``run_phase2``, ``run_phase3``), after the
  phase-1 sweeps:
 22. on tiny-llama-study and tiny-gpt2-study at the study's settings
     (``backend_for``; t=0.7, 64 tokens; phase 2 on the synthetic corpus of
     20 items, one listwise query and 30 comparisons; phase 3 conformal with
     model-conditional calibration over phase 19's record): K1's and K2's
     f32 kernels must launch in each phase and their tensor-core kernels
     must not, a scoring forward must run in each, no error entry, finite
     measures, the records saved, read back and matching their manifest
     entries; then K1 and K2 against their plain versions at every (shape,
     dtype) the two phases gave them that phases 19-21 did not hold (the
     scoring forwards' and the decodes' prefills and steps), held to 1e-4
     with phase 19's blind checks; then both phases greedy on the card and
     on the CPU: every engine call's tokens equal row by row, or differing
     where the CPU's top two logits are within 1e-4 (as phase 20); with
     equal tokens, the phase-2 results equal (floats to 1e-6, perplexity to
     1e-5 relative, the scored ranking up to near ties of 1e-5 in the
     scores), the calibration rows scored alike (log-likelihoods within
     1e-5 + 1e-5 * |value|, mean log-probabilities within 1e-5) and the kept
     lists equal, or differing only as a reordering of near-tied scores
     explains (the card ranks no two rows otherwise than the CPU unless
     their CPU scores lie within 1e-5, and the CPU's phase 3 given the
     card's scores keeps the card's lists); with equal lists the measures
     within 1e-6 (the bias-reduction percentage within 1e-3); and the t=0.7
     run's calibration rows scored on the card and on the CPU within the
     same tolerances;
 23. on llama3-8b with int8 weights (``--weight-quant int8``) at full width
     and depth, random weights from the seed and the byte tokenizer: both
     phases as in phase 22 over phase 21's record, then, since random
     weights name no title and so give phase 3's calibration no row, the
     scoring of phase 22's tiny-llama-study calibration rows through the
     same engine (``score_prompted_continuations``); K1 and K2 only on
     their tensor-core kernels, both K4 regimes launched, the records
     saved and read back; the wall seconds, scoring forwards, rows per
     second, shapes and peak memory of each are logged; then every kernel
     call whose (shape, dtypes) phases 19-21 did not hold against its plain
     version as in phases 6 and 16, among them the K4 GEMM lm_head with an
     f32 output at the scoring forward's M, which must be there. Phases 19,
     21, 22 and 23 number and hold their calls with one function
     (``sweep_kernel_rows``); every K4 row carries the host microseconds
     and ``torch._weight_int8pack_mm`` in the GEMV regime only.
  the continuous-batching server (``serving/``, ``--continuous``), after
  phases 22-23:
 24. the phase-1 sweep through ``backend_for`` with ``Config.serving`` on
     (``ServingBackend``: one persistent KV pool, prompts prefilled in
     groups into their slots, rows evicted and slots backfilled at chunk
     boundaries). On tiny-llama-study and tiny-gpt2-study with 8 slots and
     chunks of 8 at the study's settings (t=0.7, the main path): K1's and
     K2's f32 kernels must launch and their tensor-core kernels must not,
     the record's ``serving`` counters must show all 48 prompts admitted
     and completed, the record saved and read back, and K1 and K2 held
     against their plain versions at every shape the pool gave them (the
     f32 ``decode_split_f32`` at the pool's [8, 768] rows); then greedy, served on
     the card and on the CPU, each row equal to the other's and to phase
     20's engine path on the card, or differing only where the CPU's top
     two logits are within 1e-4 (as phase 20); the t=0.7 sweep's responses
     are kept for phase 27. On llama3-8b with int8
     weights at full width and 8 of its 32 layers (``CUT_LAYERS``, since
     phase 34; phases 25-27 and 29 serve this engine; random weights,
     byte tokenizer) with 16 slots and a prompt budget of 1,024: the t=0.7 sweep (the main path)
     with K1 and K2 on their tensor-core kernels only and both K4 regimes
     launched; its wall seconds beside phase 21's, decode ms per step,
     prefill batches, mean occupancy, tokens/s, peak memory and launches
     logged; every kernel call held against its plain version at the
     pool's shapes; then the greedy gate, in a pool of the engine path's
     own shape (``CONTROL_SERVING``: 16 rows of 960 slots, so that K2 plans
     the same key splits): the greedy sweep at one profile a combination
     (``GATE_PROFILES``: 16 prompts, one call) against ``EngineBackend``
     (``share_prefix=False``) on the same prompts, and a direct ``serve`` of
     32 requests of them in turn at budgets 8 + 8 * (i mod 5), so that
     slots are backfilled in flight, each against its prompt's engine row
     cut to its budget. A
     row may differ only where the engine's top two logits at the first
     divergent token are within the kernels' bf16 allowance (``gate``) at
     the top logit; each such row and gap is printed.
  the paged KV cache (``serving/paged.py``, ``ServingConfig.paged_kv``,
  ``--paged-kv``), after phase 24:
 25. the phase-1 sweep through ``backend_for`` with the paged KV cache on
     (blocks of 16 tokens; the slots' block tables into one arena, each
     prompt's cached prefix matched and only its suffix prefilled; the
     suffix prefill attends densely, so K1 and K3 must not launch). On
     the first study checkpoint (tiny-llama-study) in phase 24's pool at
     t=0.7 (the main path): K2's f32 kernel must launch and its tensor-core kernel
     must not, all 48 prompts admitted and completed, the registry's
     ``prefix_cache_hit_ratio`` above 0.5; then greedy on the card and on
     the CPU, each row equal to the other's, to phase 24's served rows and
     to phase 20's engine path, or differing only where the CPU's top two
     logits are within 1e-4; the t=0.7 responses are kept for phase 27. On
     llama3-8b with int8 weights (phase 24's
     engine; 16 slots, a prompt budget of 1,024 and a cap of 128, so 72
     blocks a slot and 2,304 in the arena): the t=0.7 sweep, K2 only on
     decode_split_tc and both K4 regimes launched, logged beside phase
     24's run and phase 21's engine path (prefill seconds a chunk and each
     prefill group, wall, decode ms per step, hit ratio, matched tokens,
     evictions, arena and peak memory, and the gather and scatter timed at
     the pool's shape against a decode chunk); every kernel call no earlier
     phase held, held against its plain version; then greedy against phase
     24's greedy served rows: in bfloat16 reported (each parting row with
     the non-paged path's own top-two gap, replayed in a pool of its shape,
     and the float32 function's pick between the two tokens), and the same
     sweeps over the same weights in float32 gated: a row may part only
     where the non-paged path's own top two logits, and the paged token,
     are within the float32 allowance. Then a direct serve of 8 of the
     prompts at 16 tokens over an int8 KV cache, paged and not: in
     bfloat16 (K2q on decode_split_tc over the gathered view; its calls
     held; the parting rows reported) and in float32 (gated as above).
     The greedy and float32 sweeps run at one profile a combination
     (``GATE_PROFILES``, as phase 24's gate).
  fault containment (``utils/failures.py``, ``resilience/``, ``integrity/``,
  ``telemetry/incidents.py``), after phase 25:
 26. (a) the greedy phase-1 sweep on the first study checkpoint through
     ``backend_for`` with the numerics guard, the watchdog (600 s), the
     breakers and an armed incident engine, in phase 24's pool and in its
     paged twin, under a fault script (``STUDY_SCRIPT``: a prefill fault
     and a decode fault that requeue once, a request that faults twice, a
     NaN in the carried logits, a simulated hang): the fault, numerics,
     hang and requeue counters must be the script's, requeued and failed
     too, the twice-faulted request an error row, every other row phase
     24's fault-free served row (or differing only where the top two
     logits are within 1e-4, as phase 20), the bundles valid, and, paged,
     the arena never dropped and the hit ratio above 0.5. (b) On llama3-8b
     int8 (phase 24's engine) in the control pool (16 × 960): the greedy
     sweep (16 prompts, as phase 24's gate) with guards, breakers, the
     watchdog (60 s) and a canary every
     call (recorded in a pool of the live pool's shape): no fault, no hang,
     no canary mismatch, every row phase 24's, its wall logged beside
     phase 24's; then a direct serve of 8 prompts of 16 tokens with one
     decode fault and one NaN: the counters the script implies, every request complete
     after one requeue, its kernel calls held, its rows against the
     fault-free ones reported in bf16 and gated in float32 over the same
     weights (as phase 25). (c) One speculative greedy engine call and an
     int8-KV serve with breakers and guards: K3 and K2q launch, every bf16
     launch on a tensor-core kernel, no engine fault. (d) A child process
     serving the tiny-llama-study sweep triggers a device-side assert at a
     decode step: it must exit non-zero, name the CUDA error on stderr and
     leave no record or checkpoint with an error row. (e)
     ``request_drain(grace_s=0)`` after two scheduler steps preempts
     requests into a journal and ``resume_serving`` completes them with the
     uninterrupted tokens; then the CLI's ``--continuous --serving-journal
     --numerics-guards --incidents --telemetry-dir`` run gets a SIGTERM
     mid-run (exit 0), ``resume-serving`` finishes its journal (exit 0) and
     ``incident-report`` renders.
  overload control and the fairness monitor (``serving/overload.py``, the
  QoS queue, ``telemetry/fairness.py``), after phase 26:
 27. (a) The CLI's ``--all --continuous --slots 8 --overload --fairness-obs
     --telemetry-dir`` run on the first study checkpoint, non-paged and with
     ``--paged-kv`` (the main path; K1's and K2's f32 kernels must launch,
     their tensor-core kernels must not): exit 0, the snapshot and
     ``trace.json`` valid (paged: the paged gauges there), the overload
     ladder armed and at 0 with nothing shed, ``check_fairness`` passing
     (the streaming DP/IF/exposure within ``FAIRNESS_TOLERANCE`` of the
     offline scores, pairs joined, no divergent pair, no alert), also
     through ``fairness-report --validate --fail-on-alert``, and every
     phase-1 response that of phase 24's (paged: phase 25's) t=0.7 sweep
     in the same pool. (b) On llama3-8b int8 (phase 24's engine) in the
     control pool's shape with a queue of 32: a flood of 64 batch and 16
     interactive greedy requests (``FLOOD_*``) drives the ladder to rung 1
     at least by queue depth, and it must be back at 0 once the queue has
     drained and a healthy window a rung has passed (its trajectory, the
     outcomes by class and the shed counters logged); every interactive
     request completes, its row that of the same request served without
     overload control in a pool of the same shape (``paged_gate``, bf16
     allowance); a batch request sheds with a retry-after; K1, K2 and K4
     launch on their tensor-core kernels, and each is held against its
     plain version at this phase's shapes (``rehold``). (c) A fresh
     registry's first prefill sample and the estimate it alone gives (what
     an unwarmed process would shed on) are logged; then, warm, a request
     with a 1 ms deadline sheds ``deadline_infeasible`` at ``submit()`` and
     no prefill runs for it. (d) The greedy tiny-llama-study sweep with the
     monitor on and every female profile's request faulting twice: the
     neutrality audit alerts on gender and not on age, and the failures,
     the alert events and the divergent pairs' failed members all name the
     female group.
  the replica fleet (``serving/router.py``, ``fleet.py``, ``autoscaler.py``,
  ``replay.py``, ``rollout.py``; ``--replicas``, ``--autoscale``, the
  ``rollout`` subcommand), after phase 27:
 28. (a) The CLI's ``--phase 1 --continuous --slots 8 --replicas 2
     --serving-journal --telemetry-dir`` run on both study checkpoints (the
     main path; K1's and K2's f32 kernels must launch, their tensor-core
     kernels must not): exit 0, every response that of phase 24's t=0.7
     sweep in one pool of the same shape, both replicas serving, no
     unfinished request in the journal, ``fleet_healthy_replicas`` 2 of 2,
     the snapshot valid and the fleet gate (``check_fleet``) finding only
     that no replica was fenced. (b) Two replicas of the control pool's
     shape over a llama3-8b int8 engine at full depth (one weight tree;
     built as phase 24's, whose depth is cut, with its own greedy rows in a
     control pool, ``full_depth_control``): the 16 gate prompts greedy at
     32 tokens, each row that engine's served row cut to as many
     (``paged_gate``, the kernels' bf16 allowance); the same requests
     again with r0 crashing
     after ``CRASH_POLLS`` health polls: fenced, its unfinished requests at
     the head of r1's queue with their ids and row seeds, every request
     complete with the fault-free row, r0 back through the canary recorded
     in a pool of its shape, ``check_fleet`` clean (the recovery time,
     the migrated count and the rejoin probe's time logged); a child serving
     through a fleet of two hits a device-side assert and must exit
     non-zero with no record, no error row and no fence. (c) One replica
     with the autoscaler under a replayed ``generate_trace`` burst
     (``ELASTIC_*``): 1 -> 2 (a canary-gated standby) -> 1, no request lost,
     every row the gate's cut to its budget, ``check_autoscale`` clean; then
     a retirement with rows in flight, which migrate and finish with the
     gate's rows; after each retirement ``torch.cuda.memory_allocated()``
     within 5% of its value before the scale-up (the retired pool freed).
     (d) The ``rollout`` subcommand on tiny-llama-study to a copy of its
     checkpoint with a new version id exits 0; to a copy with one flipped
     byte in ``model.safetensors`` it exits 2 with cause ``manifest`` before
     any replica of that version joins; no request lost, and the snapshot
     passes ``check_rollout``. K1, K2 and K4 launch on their tensor-core
     kernels in (b)-(c) and every kernel is held against its plain version
     at this phase's shapes.
  the device-facing telemetry (``telemetry/memory.py``, ``roofline.py``,
  ``costmodel.py``, ``compilestats.py``; ``perf-report``, ``memory-report``,
  ``--achievable-gbps``, the headroom signals), after phase 28:
 29. The card's streaming bandwidth from a device-to-device copy (logged
     beside the 3,350 GB/s of its data sheet) and the host's cost of one
     launch (the cost ledger's dispatch term). (a) In a child process, the
     CLI's ``--phase 1 --continuous --slots 8 --paged-kv --telemetry-dir
     --achievable-gbps <measured>`` on the first study checkpoint: exit 0,
     ``perf-report --require-ledger``, ``memory-report --require-ledger``
     and ``telemetry-report --validate --require-costmodel
     --require-memory`` each exit 0, the reconciliation ``measured`` with
     no alert, every response that of phase 25's paged t=0.7 sweep. (b)
     Over phase 24's llama3-8b int8 tensors, under fresh memory ledgers: a
     second engine, whose params pool must be the int8 tree to the byte,
     decodes the gate's 16 prompts (``DEVTEL_TOKENS``), and one served pool
     of the control shape serves them, whose slot cache must be its
     tensors' bytes (the allocator's growth within 1%); each program's step
     ledger must hold ``2·B·Σ d_in·d_out`` matmul FLOPs exactly, at least
     the int8 weight bytes the step streams and some attention bytes; the
     roofline, the gap decomposition and its top contributor are logged.
     (d) A repeated engine call must add a hit and no compile, and the pool
     must have compiled exactly ``serve_prefill`` and ``serve_step``, each
     with its ledger. (c) One replica of the control shape with the
     autoscaler's ``up_headroom_frac`` above the measured headroom must
     scale up on ``hbm_headroom`` and, the threshold lowered, back down,
     leaving none of the retired replica's ledger entries; the allocator,
     the pools and the kernels' workspaces are logged around it; then the
     overload ladder's ``headroom_cap_frac`` above the headroom must clamp
     a batch request to ``DEVTEL_BATCH_CAP`` at rung 0 and leave an
     interactive one whole. K1, K2 and K4 launch on their tensor-core
     kernels and every kernel is held against its plain version at this
     phase's shapes.
  the per-phase device trace (``--trace-dir``, ``utils/profiling.py``) and
  data parallelism (``--mesh dp=N``, ``parallel/``, ``metrics/sharded.py``),
  after phase 29:
 30. (a) In a child, the CLI's ``--phase 1 --quick --continuous --slots 16
     --model llama3-8b --weight-quant int8 --max-new-tokens 16 --trace-dir
     D`` (random int8 weights: one call of 16 prompts of 16 tokens): exit 0,
     one capture (for ``phase1``) and a printed summary of its device ops;
     the capture, read back with ``summarize_trace`` (whose failure fails
     here, though the CLI only warns), names K1's, K2's and both K4
     regimes' kernels; the serve step's device busy share (the union of
     the kernel intervals inside its ``serve_step`` spans over their wall)
     and the capture's bytes are logged. (b) Two ranks, children with the
     environment torchrun gives a rank (127.0.0.1), gloo, both on the one
     card: the greedy phase-1 sweep of tiny-llama-study at phase 20's
     settings on a dp=2 mesh (each rank 8 rows of each call of 16) must
     launch only K1's and K2's f32 kernels, reduce its metric counts over
     dp (``metric_reduction: "dp-psum"``) and equal phase 20's
     single-process card record (a row may part only at a near tie, as
     phase 20); then phase 21's llama3-8b int8 default sweep on the mesh:
     K1, K2 and both K4 regimes on their tensor-core kernels, its wall,
     engine init and each rank's peak memory logged, its rows reported
     against phase 21's; rank 0 alone writes files. Each rank holds every
     kernel call no earlier phase (or the other rank) held against its
     plain version, and sends its launches and rows back; a rank that fails
     fails the phase (no fallback to one process). (c) One rank on NCCL:
     ``initialize_distributed`` on the card picks NCCL, and an all_reduce
     of a CUDA tensor returns the sum.
  tensor parallelism, ring attention and training (``parallel/sharding``'s
  tp layout, ``parallel/ring.py``, ``train/``), after phase 30:
 31. (a) Two ranks in children started with a rank's torchrun environment,
     gloo (NCCL refuses two ranks on one device), both on the one card: the
     greedy phase-1 sweep of tiny-llama-study at phase 20's settings on a
     tp=2 mesh (each rank 2 q heads, 1 kv head, half the MLP and the
     vocabulary; only K1's and K2's f32 kernels) must equal phase 20's
     single-process card record (a row may part only at a near tie); then
     phase 21's llama3-8b int8 sweep at full width cut to 8 of its 32
     layers (``TP_LAYERS``), at one profile a combination (16
     prompts), served with ``ServingConfig(tp=2)``
     over the tp mesh (``--continuous --tp 2``; each rank 16 q and 4 kv
     heads, d_ff 7,168 and 64,128 vocabulary rows): labelled
     ``serve_step@tp2``, K1, K2 and both K4 regimes on their tensor-core
     kernels, its rows reported against phase 21's; the first prefill's
     logits of 4 prompts against a tp=1 engine's over the same weights,
     in float32 (the same int8 weights, float32 activations) within 1e-3
     of the largest logit, in bf16 reported; one speculative greedy engine
     call of 16 tokens launching K3 on its tensor-core kernel; rank 0 alone
     writes files; the float32 tp=2 forward's K4 calls (K4's float32 route
     over the rank's shards) recorded and held as phase 18 holds them.
     Each rank holds every kernel call no earlier phase (or the other rank)
     held against its plain version, at the ranks' local shapes. Then one
     rank on NCCL runs the same sweep code at tp=1. (b) On an sp=2 mesh of
     the same two ranks: ring attention at llama3-8b's head shape (32 q, 8
     kv heads of 128) over 4,096 tokens, 2,048 a rank, in float32 within
     1e-5 of dense attention; the study model's scores with
     ``attention_impl="ring"`` over the two ranks within 1e-5 (relative)
     of one process's. (c) Training in this process: one float32 step of
     the study checkpoint on the card against the port's CPU step (loss
     and every gradient within 1e-4 of the tensor's scale), a remat step
     equal to it, a checkpoint round trip and the fall back past a flipped
     byte; then llama3-8b at full width cut to 8 layers in bf16 (params,
     grads and AdamW moments), remat, 4 steps on one fixed batch: the loss
     must fall; step ms, peak memory and the card's clock and power logged.
     (d) Training at tp=2 on the same two ranks (``tp_train``): one float32
     step of the study checkpoint on a tp=2 mesh, each rank after the tp=1
     step on the card from the same parameters: its loss within 1e-4
     (relative) of tp=1's and each gradient within 1e-4 of the scale of
     its part of tp=1's (``TrainState.cut``); the tp=2 checkpoint restored
     at tp=1 equal to the gathered state, moments and all; then llama3-8b
     at full width cut to 8 layers, bf16 and remat, 4 steps on phase (c)'s
     batch at tp=2 (each rank makes the full parameters from seed 0 and
     keeps its part): the loss must fall and the two ranks' losses be equal
     bit for bit; step ms, init s and peak memory logged a rank, the first
     loss reported beside (c)'s tp=1 first loss (``train_tp2`` line). (e)
     In this process after (c): the native ratings parser
     (``fairness_llm_tpu_torch.native``) built on this machine must give
     the pure-Python parse's arrays on a ``ratings.dat`` the script writes
     (``native_parse`` line).
  the study's speculative sweep (``--speculate``), after phase 31:
 32. on tiny-llama-study and tiny-gpt2-study, phase 20's greedy sweep with
     greedy prompt-lookup speculation (draft 8, n-gram 3) through
     ``backend_for`` and ``run_phase1``: every decode step a float32 verify
     window, each launch on verify_split_f32 (counted by the kernel the C
     entry reports; no tensor-core kernel may launch), every engine call's
     rows equal to phase 20's greedy card rows (a row may part only at a
     near tie), the record then equal to phase 20's; each verify call held
     against its plain version at 1e-4 with phase 6's blind check and its
     repeats bit for bit; the sweeps' wall, tokens per verify step and
     acceptance rate logged (``spec_study`` lines). These sweeps are the
     ``decode_attention_verify_f32`` entry's main path (its launches and
     shapes); phase 13's calls at llama3-8b's width are its
     ``gate_launches`` and ``gate_shapes``.
  the reference's other model families, after phase 32 (random weights
  from seed 0, byte tokenizer, full width and depth, the int8 families'
  depth cut to 8 layers, ``FAMILY_LAYERS``): mistral-7b (sliding window
  4,096), gemma-7b (head width 256, one q head a kv head, GeGLU,
  embed_scale, a tied 256,000-row head in bf16) and qwen2-7b (q/k/v
  biases, seven q heads a kv head), each with int8 weights, and in bf16
  gpt2-small and the tied families llama32-1b (rep 4 at head width 64),
  llama32-3b (24 q heads over 8 of 128) and qwen2-0.5b (rep 7 at head
  width 64, q/k/v biases):
 33. (a) each one's phase-1 sweep through ``backend_for`` and
     ``run_phase1`` (45 profiles and 3 neutral prompts, t=0.7,
     ``MAX_TOKENS`` new tokens, the sweep-wide shared prefix), the record
     checked and read back: K1 on flash_fwd_tc, K2 on decode_split_tc (none
     under mistral's window: the cached steps take the dense window path,
     as in the reference), K4's both regimes (none for gpt2-small) must
     launch, no float32 kernel; wall, engine init, decode ms/step, peak
     memory and launches logged (``families_phase1`` lines). (b)
     ``run_phase2`` over the three int8 families in one call with (a)'s
     backends kept alive: three ``model_results``, the cross-model
     comparison, ``models_evaluated_total`` 3, a scoring forward
     (``families_phase2``). (c) Each family at full width and 4 layers: the
     teacher-forced check of phase 9 in bf16 (reported) and over the same
     weights in float32 (``float32_twin``) held to 1e-3 of the logits'
     scale; each tied head (gemma-7b's, gpt2-small's and the tied
     families') through phase 3's head-product check in bf16
     (``families_f32_gates``, ``head_product_<model>``; the tied families'
     sweeps and gates take ``families_tied_s``). (d) mistral-7b at
     full width and 2 layers: one row of 4,608 tokens prefilled (K1's
     window masks keys of the last 512 query rows a layer) and 16 cached
     steps through the dense window path, against the plain-version path
     (bf16 reported; float32 held to 1e-3 of scale), K1's windowed calls
     held against their plain version (``families_window``). (e) K3
     (decode_verify_tc) at kernel level at each sweep's first decode step,
     q widened to a verify window of 9 rows a row. Every kernel call of
     (a) and (b), and (d)'s K1 calls, at a shape no earlier phase held is
     held against its plain version with phase 6's tolerance and blind
     check ((c) and (d) gate the logits); the entries gain
     ``families_launches`` (``families_<model>``, ``families_phase2``,
     ``families_window_bf16``, ``families_window_f32``) and
     ``families_shapes``.
  BASELINE.json configs[4]'s model, after phase 33, in a child process
  (``chip_smoke.py --phase 34``; the parent empties its allocator's cache,
  logs the card's memory and streams the child's lines, and fails if the
  child exits non-zero):
 34. llama3-70b with int8 weights (random, seed 0; 80 layers, d_model
     8,192, 64 q heads over 8 kv heads of 128, d_ff 28,672, an untied
     128,256-row head), full width and depth, on the one card: the init's
     seconds and peak, and its bytes against ``per_device_param_bytes`` at
     tp=1 within 1% (``llama70b_phase1``); phase 33(a)'s sweep; phase 3 on
     the sweep's record (the conformal variant: the aggressive one raises
     in ``facter.smart_balance`` on random weights, as the reference's
     does) and the scoring forward over the study checkpoint's calibration
     rows (``llama70b_phase3``); with the model freed, every kernel call
     held against its plain version, K3 at kernel level at the sweep's
     first decode step (72 query rows a kv head), K2 and K3 at v of scale
     4 at llama3-8b's and llama3-70b's decode and verify shapes
     (``c9_large_values``), and the float32 gate at full width and 4
     layers (``llama70b_f32_gate``). The entries gain ``llama70b_launches``
     (``llama70b_phase1``, ``llama70b_phase3``,
     ``llama70b_phase3_scoring``) and ``llama70b_shapes``.
  The HF checkpoint path, after phase 34, in a child process as phase 34
  (``chip_smoke.py --phase 35``), in a temporary directory on the local
  disk whose free space is checked first (``checkpoint_disk``):
 35. (a) llama3-8b's bf16 tree (seed 0, 32 layers, 16.06 GB) exported with
     ``save_checkpoint_hf`` (the export's and the manifest's seconds
     apart), loaded back in bf16 and as llama3-8b-int8 (quantized on
     arrival), each bit for bit (the int8 load against ``quantize_params``
     on the card) with the manifest check's and the streaming load's
     seconds, and the int8 load's peak above its start under 0.75x the
     bf16 tree; an engine on each loaded tree beside one on the in-memory
     tree serves the 16 prompts greedy with their shared prefix: tokens
     equal, K1 and K2 (and under int8 both K4 regimes) launched, every new
     kernel shape held as in phase 6 (``checkpoint_llama3_8b``); (b)
     llama3-70b's bf16 tree at 2 of its 80 layers exported, re-sharded
     into 3 files behind ``model.safetensors.index.json`` and loaded as
     int8 through it, bit for bit, each tensor's transient above the
     resident bytes in the map's order, and the 80-layer load's peak
     reckoned from them against the card (``checkpoint_llama3_70b``); (c)
     gemma-7b, qwen2-7b and llama32-1b at 2 layers and gpt2-small at 12,
     norms drawn in [0.5, 2] and biases N(0, 0.02), exported and loaded
     bit for bit (``checkpoint_families``). The entries gain
     ``checkpoint_launches`` (``checkpoint_bf16_memory``,
     ``checkpoint_bf16_loaded``, ``checkpoint_int8_memory``,
     ``checkpoint_int8_loaded``) and ``checkpoint_shapes``.
  The kernels line gains K1's and K2's f32 kernels as entries of their own
  (``flash_attention_f32``, ``decode_attention_f32``; launches and rows from
  phase 19's two t=0.7 sweeps). Every attention row carries ``floor_ms``,
  the device time of an empty kernel (``torch.cuda._sleep(0)``) timed as
  the row's call is, printed first as the ``launch_floor`` line: at the
  study's shapes the bound is below it. The split routes' entries name
  their second launch (``combine_function``). Each entry gets ``phase1_launches``: the
  launches of its own kernel function on phase 19's sweeps and on phase
  21's; the entries phase 21 launched get its rows as ``phase1_shapes``.
  Each entry also gets ``phase2_launches`` and ``phase3_launches`` (phase
  22's two models together, "study"; phase 23's run, FULL_WIDTH; and its
  scoring of the calibration rows, FULL_WIDTH + "_scoring"), and phases
  22-23's new rows: those of a scoring forward's calls as
  ``scoring_shapes``, the others as ``phase23_shapes``; and phase 24's
  launches on the served t=0.7 sweeps as ``serving_launches`` ("study",
  FULL_WIDTH) and its rows as ``serving_shapes``; and phase 25's launches
  on the paged t=0.7 sweeps and the int8-KV serve as ``paged_launches``
  ("study", FULL_WIDTH, FULL_WIDTH + "_kv_int8") and its rows as
  ``paged_shapes``; and phase 26's launches on the contained study sweeps
  and the full-width runs (b)-(c) as ``containment_launches`` ("study",
  FULL_WIDTH) and its rows as ``containment_shapes``; and phase 27's
  launches on the study CLI runs and the flood as ``overload_launches``
  ("study", FULL_WIDTH) and its rows as ``overload_shapes``; and phase 28's
  launches on the study fleet runs and the rollout drill, and on the
  full-width fleet, failover and autoscale runs, as ``fleet_launches``
  ("study", FULL_WIDTH) and its rows as ``fleet_shapes``; and phase 29's
  launches on its in-process runs (b)-(c) as ``devtel_launches``
  (FULL_WIDTH; the CLI child's launches are its own) and its rows as
  ``devtel_shapes``; and phase 30(b)'s launches in each rank's runs as
  ``dp_launches`` ("study_rank<r>", FULL_WIDTH + "_rank<r>") and the rows
  its ranks held as ``dp_shapes``; and phase 31's launches in each rank's
  runs as ``tp_launches`` ("study_tp<k>_rank<r>", FULL_WIDTH +
  "_tp2_rank<r>", K3's "spec_tp2_rank<r>" and K4 f32's
  "f32_logits_tp2_rank<r>") and the rows its ranks held at their local
  shapes as ``tp_shapes``; and phase 32's launches as
  ``spec_sweep_launches`` ("spec_<model>") and its rows as
  ``spec_sweep_shapes``. K4's float32 route is the ``quant_matmul_f32``
  entry (gemv_stream_tf32, and tf32_gemm_kernel in the GEMM regime), held
  at phase 18; its launches in phases 25's and 26's float32 twins are its
  ``paged_launches`` and ``containment_launches`` (FULL_WIDTH + "_f32"),
  their new shapes its ``paged_shapes`` and ``containment_shapes``.

TF32 is off for matmuls and cuDNN, so float32 references are full float32.
The last line is ``{"ok": true, "device": {...}}``; the line before it is the
``{"kernels": [...]}`` record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
MODEL = "llama3-8b"
MODEL_INT8 = "llama3-8b-int8"
# llama3-8b keeps its full width and this many of its 32 layers in the bf16
# path (phases 3-13), the int8 path (14-18, since phase 35 came in), the
# phase-1 and phase-2/3 sweeps (19-23), the served phases on phase 24's
# engine (24-27, 29) and phase 30's runs, for the script's time limit since
# phase 34 came in (``cut_depth``). Every layer gives the kernels the same
# shapes, so no kernel loses a hold: phase 28's fleet drills and phase 35's
# engines run all 32, and each gate compares runs of one depth.
CUT_LAYERS = 8
MAX_TOKENS = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# Kernel against plain version on bf16 inputs: |got - want| <= ATOL + RTOL *
# |want| elementwise. Both sum in float32 and round the output to bf16 once,
# so they differ by summation order and at most one ulp (2^-7 of the value);
# K1, K2 and K3 carry their softmax weights P to P.V in two bf16 terms
# (ROADMAP C8, C9): one term moved an output by up to 2^-9 of the largest
# |v| it averages, which a row of few keys near cancellation did not absorb.
ATOL, RTOL = 4e-3, 1e-2
# Kernel against plain version on float32 inputs (K1's flash_fwd, K2's
# decode_split_f32, K3's verify_split_f32; no TF32 on either side): they
# differ in summation order only, and are held to the float32 allowance of
# tests/test_torch_cuda.py.
ATOL_F32, RTOL_F32 = 1e-4, 0.0
# Where one key moves no decode-attention output past the allowance at the
# recorded input (flat scores), the row is held again with q scaled by this
# (``decode_numbers``): scores 6x as far apart, enough that one key of ~800
# moves some output past the allowance, not so far that one key takes all.
BLIND_Q_SCALE = 6.0
# K4 on float32 x (two TF32 passes) against its plain version, as
# tests/test_torch_cuda.py holds it: 1e-4 + 3e-5 * |plain| (sums over K up
# to 14,336 in another order, x_lo rounded to TF32).
ATOL_K4F32, RTOL_K4F32 = 1e-4, 3e-5
# H100 SXM dense TF32 tensor-core peak. K4's float32 route makes two TF32
# passes (2 x 2MKN over this rate: the design's own yardstick). Its bound is
# the card's best float32-accurate product of an int8 weight: the weight is
# exact in bf16 too, and x split into three bf16 parts keeps float32's
# bits, so 3 x 2MKN over the bf16 peak.
TF32_FLOPS = 495e12
K4_F32_BF16_PASSES = 3
# The profiled calls' new tokens (16 until the fleet's phase 28 came in; 8
# keep the script under half its time limit).
PROFILE_TOKENS = 8
# New tokens of phase 18's float32 greedy call, whose decode steps give K4's
# float32 route its M = 16 calls.
F32_K4_TOKENS = 4
# K2/K2q are also timed at the phase-1 sweep's own batch (45 profiles
# bucketed to 48): reported, not gated.
STUDY_BATCH = 48
# Device kernels whose traced time the plain decode profiles report.
K2_FOCUS = ("decode_split_tc", "combine_splits")
# The K4 GEMV kernel, whose traced time and launches the int8 profile
# reports beside K2's.
K4_FOCUS = ("gemv_stream_tc",)
K1_REPLACES = "fairness_llm_tpu/ops/flash_attention.py:148"
K2_REPLACES = "fairness_llm_tpu/ops/decode_attention.py:413"
K2Q_REPLACES = "fairness_llm_tpu/ops/decode_attention.py:191"
K3_REPLACES = "fairness_llm_tpu/ops/decode_attention.py:404"
K3Q_REPLACES = "fairness_llm_tpu/ops/decode_attention.py:288"
K4_REPLACES = "fairness_llm_tpu/ops/quant_matmul.py:159"
K1_SOURCE = "fairness_llm_tpu_torch/ops/csrc/flash_attention.cu"
K2_SOURCE = "fairness_llm_tpu_torch/ops/csrc/decode_attention.cu"
K2F32_SOURCE = "fairness_llm_tpu_torch/ops/csrc/decode_attention_f32.cu"
K3F32_SOURCE = "fairness_llm_tpu_torch/ops/csrc/decode_verify_f32.cu"
K4_SOURCE = "fairness_llm_tpu_torch/ops/csrc/quant_matmul.cu"
# The CUDA kernel each entry's wrapper launches on this path's inputs; the
# note at the top of its source describes the design.
KERNEL_FUNCTIONS = {
    "flash_attention": "flash_fwd_tc",
    "decode_attention": "decode_split_tc",
    "decode_attention_verify": "decode_verify_tc",
    "decode_attention_int8_cache": "decode_split_tc",
    "decode_attention_verify_int8_cache": "decode_verify_tc",
    "quant_matmul_gemv": "gemv_stream_tc",
    "quant_matmul_gemm": "wg_gemm_kernel",
    "flash_attention_f32": "flash_fwd",
    "decode_attention_f32": "decode_split_f32",
    "decode_attention_f32_int8_cache": "decode_split_f32",
    "decode_attention_verify_f32": "verify_split_f32",
    "decode_attention_verify_f32_int8_cache": "verify_split_f32",
    "quant_matmul_f32": "gemv_stream_tf32",
}
# The kernel an entry that spans both K4 regimes launches past M = 64.
GEMM_FUNCTIONS = {"quant_matmul_f32": "tf32_gemm_kernel"}
# A kernel's second launch, where a call splits its work: combine_splits
# folds the split attention routes' partials.
COMBINE_FUNCTIONS = {"decode_split_tc": "combine_splits", "decode_verify_tc": "combine_splits",
                     "decode_split_f32": "combine_splits", "verify_split_f32": "combine_splits"}
# The int8 engine's allocation may exceed its tree by this share at most.
MEM_SLACK = 0.05
WATCHED = [
    "American Beauty (1999)", "Star Wars: Episode IV - A New Hope (1977)",
    "Schindler's List (1993)", "Fargo (1996)", "Shawshank Redemption, The (1994)",
    "Godfather, The (1972)", "Raiders of the Lost Ark (1981)",
    "Usual Suspects, The (1995)", "Casablanca (1942)", "Rear Window (1954)",
]
GENRES = ["Drama", "Thriller", "Action"]
GENDERS = ["F", "M"]
AGES = ["18-24", "25-34", "45-49", "56+"]
OCCUPATIONS = ["writer", "engineer"]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def preroll(torch, launches: int) -> None:
    """Keep the device busy (~0.5 ms per launch to come, at ~2 GHz) while
    the host queues a timed loop, so that the events time the device's work
    and not the host's cost of issuing it."""
    torch.cuda._sleep(1_000_000 * launches)


def cuda_ms_cold(fn, iters: int, flush) -> float:
    """Mean ms of ``fn``, each launch timed alone with CUDA events after a
    write of ``flush`` (larger than the 50 MB L2) has evicted its inputs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    preroll(torch, iters)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host microseconds to launch ``fn``, with the device asleep so
    that no launch waits for it."""
    import torch

    fn()
    torch.cuda.synchronize()
    preroll(torch, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return dt


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    preroll(torch, iters)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class CardSampler:
    """Samples the card's SM clock (MHz) and power draw (W) with nvidia-smi
    every 100 ms while open; ``summary`` holds [min, median, max] of each."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:  # "[N/A]" or a line cut by the terminate
                continue
        self.summary = {}
        for i, key in enumerate(("sm_clock_mhz", "power_w")):
            vals = sorted(r[i] for r in rows if len(r) == 2)
            self.summary[key] = [vals[0], vals[len(vals) // 2], vals[-1]] if vals else None


_FLOOR_MS = None


def launch_floor_ms(torch) -> float:
    """The device time of an empty kernel, ``torch.cuda._sleep(0)`` (it
    returns at once), timed as the kernel rows time a call (``cuda_ms``):
    the practical floor of one launch, printed beside each attention row's
    bound. Measured once a process."""
    global _FLOOR_MS
    if _FLOOR_MS is None:
        _FLOOR_MS = cuda_ms(lambda: torch.cuda._sleep(0), 200)
    return _FLOOR_MS


def rates(flops: float, ms: float, peak: float) -> dict:
    """Achieved TFLOP/s from a row's own operation count and time, and its
    share of the card's peak for the input type."""
    tflops = flops / (ms * 1e-3) / 1e12
    return {"tflops": tflops, "peak_share": tflops * 1e12 / peak}


def tolerance(f32: bool) -> tuple:
    """(atol, rtol) for a kernel on float32 inputs, or on bfloat16 ones."""
    return (ATOL_F32, RTOL_F32) if f32 else (ATOL, RTOL)


def gate(got, want, f32: bool = False, tol=None):
    """(max |got - want|, the largest error over its allowance atol + rtol *
    |want| from ``tol`` or ``tolerance(f32)``); the second is <= 1 where the
    two agree."""
    atol, rtol = tol or tolerance(f32)
    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err / (atol + rtol * want.float().abs())).max())


class Recorder:
    """Wraps a kernel wrapper on the main path and keeps a copy of the
    inputs of the first call at each distinct shape, with the call count.
    The wrapped function runs unchanged (and counts its own launches)."""

    def __init__(self, module, attr: str, key_fn):
        self.module, self.attr, self.key_fn = module, attr, key_fn
        self.inner = getattr(module, attr)
        self.calls: dict = {}

    def store(self, args, kwargs) -> dict:
        return {"args": _clone(args), "kwargs": _clone(kwargs)}

    def __enter__(self):
        def wrapped(*args, **kwargs):
            key = self.key_fn(*args, **kwargs)
            if key not in self.calls:
                self.calls[key] = {"n": 0, **self.store(args, kwargs)}
            self.calls[key]["n"] += 1
            return self.inner(*args, **kwargs)

        setattr(self.module, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.inner)


class WeightRecorder(Recorder):
    """A Recorder for ``quant_matmul(x, wq, scale, out_dtype=...)`` and
    ``quant_matmul_group(x, [(wq, scale), ...], out_dtype=...)``: it clones
    x only. The weights and scales are the engine's parameters, never
    written, so they are kept by reference: one copy whatever M."""

    def store(self, args, kwargs) -> dict:
        x, *rest = args
        return {"args": (x.detach().clone(), *rest), "kwargs": dict(kwargs)}


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def cut_depth(name: str, layers: int):
    """The registry's config of ``name`` at ``layers`` of its layers (full
    width) while the block runs, in this process: ``backend_for`` builds the
    config the name maps to."""
    from fairness_llm_tpu_torch.models import configs as model_configs

    full = model_configs.MODEL_CONFIGS[name]
    model_configs.MODEL_CONFIGS[name] = dataclasses.replace(full, num_layers=layers)
    try:
        yield full
    finally:
        model_configs.MODEL_CONFIGS[name] = full


def counterfactual_prompts():
    from fairness_llm_tpu_torch.data.profiles import Profile
    from fairness_llm_tpu_torch.pipeline.prompts import recommendation_prompt

    profiles, pid = [], 0
    for g in GENDERS:
        for a in AGES:
            for o in OCCUPATIONS:
                profiles.append(Profile(id=f"user_{pid:04d}", gender=g, age=a, occupation=o,
                                        watched_movies=list(WATCHED),
                                        favorite_genres=list(GENRES)))
                pid += 1
    return profiles, [recommendation_prompt(p) for p in profiles]


def serve(backend, prompts, settings, label, **kw):
    from fairness_llm_tpu_torch.pipeline.parsing import parse_numbered_list

    with CardSampler() as card:
        texts = backend.generate(prompts, settings, **kw)
    st = backend.last_stats
    if len(texts) != len(prompts):
        fail(f"{label}: {len(texts)} texts for {len(prompts)} prompts")
    if not st["logits_finite"]:
        fail(f"{label}: non-finite logits")
    steps = max(st["decode_steps"], 1)
    parsed = sum(len(parse_numbered_list(t)) for t in texts)
    row = {
        "phase": label, "batch": st["batch"], "prompt_len": st["prompt_len"],
        "prefix_len": st["prefix_len"], "cache_slots": st["cache_slots"],
        "prefix_ms": round(st["prefix_s"] * 1e3, 3),
        "prefill_ms": round(st["prefill_s"] * 1e3, 3),
        "decode_steps": st["decode_steps"],
        "decode_ms_per_step": round(st["decode_s"] * 1e3 / steps, 3),
        "decoded_tokens": st["decoded_tokens"],
        "tokens_per_s": round(st["decoded_tokens"] / max(st["decode_s"], 1e-9), 2),
        "parsed_titles": parsed, "card": card.summary,
    }
    log("serve " + json.dumps(row))
    return row


def k1_numbers(call, torch, F):
    from fairness_llm_tpu_torch.ops import flash_attention as fm

    q, k, v, lengths = call["args"][:4]
    kw = dict(call["kwargs"])
    causal, window = kw.get("causal", True), kw.get("window")
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    f32 = q.dtype == torch.float32
    got = fm.flash_attention(q, k, v, lengths, causal=causal, window=window)
    want = fm.flash_attention_reference(q, k, v, lengths, causal=causal, window=window)
    err, ratio = gate(got, want, f32)
    # The kernel with every row's first valid key masked out, on the query
    # rows valid under both masks: the gate must see the difference.
    short = (lengths - 1).clamp_min(0)
    shifted = fm.flash_attention(q, k, v, short, causal=causal, window=window)
    rows = torch.arange(S, device=q.device)[None, :] >= (S - short.long())[:, None]
    sel = rows[:, None, :, None].expand_as(want)
    _, shifted_ratio = gate(shifted[sel], want[sel], f32)
    iters = 20
    ms = cuda_ms(lambda: fm.flash_attention(q, k, v, lengths, causal=causal, window=window), iters)
    # What a float32 call costs the host (the study's sweeps are host-paced).
    wrapper_host_us = host_us(lambda: fm.flash_attention(q, k, v, lengths, causal=causal,
                                                         window=window)) if f32 else None
    # The float32 kernel's query rows a block, as the wrapper plans them.
    rows_per_block = (fm.flash_f32_rows(B, H, S, next(w for w in fm.F32_WIDTHS if w >= D),
                                        fm._build.sm_count(q.device)) if f32 else None)
    plain_ms = cuda_ms(lambda: fm.flash_attention_reference(q, k, v, lengths, causal=causal,
                                                            window=window), 5, warmup=1)
    # Yardstick: one SDPA call with the same mask; kv heads expanded before timing.
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    mask = (j[None] >= (S - lengths.long())[:, None, None]) & (j <= i)[None]
    if window is not None:
        mask = mask & ((i - j) < window)[None]
    ke, ve = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    qc = q.contiguous()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qc, ke, ve,
                                                                attn_mask=mask[:, None]), iters)
    # Bound: the causal, left-padded, windowed score + PV work this input needs
    # (4*D operations per visible (query, key) pair per head, at the peak for
    # q's type), or the bytes it needs (q, k, v at the valid positions read
    # once, o written whole, lengths), whichever takes longer.
    pairs = 0
    for L in lengths.tolist():
        n = torch.arange(L, dtype=torch.float64)  # query offset inside the valid run
        vis = n + 1 if causal else torch.full_like(n, L)
        if window is not None:
            vis = torch.clamp(vis, max=window)
        pairs += int(vis.sum())
    flops = 4.0 * D * H * pairs
    n_valid = int(lengths.sum())
    nbytes = (n_valid * (H + 2 * k.shape[1]) * D + q.numel()) * q.element_size() + 4 * B
    peak = F32_FLOPS if f32 else BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "shape": {"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype)[6:],
                  "window": window},
        **rates(flops, ms, peak), "tol": tolerance(f32),
        "calls": call["n"], "max_abs_err": err, "err_over_tol": ratio, "ok": ratio <= 1,
        "blind_gate_err_over_tol": shifted_ratio, "rows_per_block": rows_per_block,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "host_us": wrapper_host_us,
        "floor_ms": launch_floor_ms(torch), "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def decode_numbers(call, torch, F):
    """One decode-attention mode at one shape: K2 (3-D q, float cache), K2q
    (int8 cache), K3 (4-D q with q_offsets, float or int8 cache)."""
    from fairness_llm_tpu_torch.models.transformer import _dequantize_kv
    from fairness_llm_tpu_torch.ops import decode_attention as dm

    q, k, v, valid = call["args"][:4]
    kw = dict(call["kwargs"])
    shared, offs = kw.get("shared_kv"), kw.get("q_offsets")
    ks, vs = kw.get("k_scale"), kw.get("v_scale")
    multi, quant = q.dim() == 4, ks is not None
    if not multi:
        offs = kw["q_offsets"] = None
    B, D, H = q.shape[0], q.shape[-1], q.shape[-2]
    Q = q.shape[1] if multi else 1
    L, Hkv = k.shape[1], k.shape[2]
    P = 0 if shared is None else shared[0].shape[0]
    f32 = q.dtype == torch.float32
    run = lambda **over: dm.decode_attention(q, k, v, valid, **{**kw, **over})  # noqa: E731

    def hold(qq):
        """(kernel, plain, max error, error over tolerance, the blinded
        kernel's error over tolerance) at query ``qq``."""
        got = dm.decode_attention(qq, k, v, valid, **kw)
        want = dm.decode_attention_reference(qq, k, v, valid, **kw)
        err, ratio = gate(got, want, f32)
        if multi:
            # Every q_offset lowered by one: each query loses its own slot.
            blind = dm.decode_attention(qq, k, v, valid, **{**kw, "q_offsets": offs - 1})
        else:
            # Each row's newest valid slot (the token just written) masked out.
            slots = torch.arange(L, device=q.device)
            newest = torch.where(valid.bool(), slots, -1).amax(1)
            dropped = valid.clone()
            dropped[torch.arange(B, device=q.device), newest] = False
            blind = dm.decode_attention(qq, k, v, dropped, **kw)
        return got, want, err, ratio, gate(blind, want, f32)[1]

    got, want, err, ratio, blind_ratio = hold(q)
    # The float32 verify window's splits are folded in a fixed order: two
    # more calls must equal the first bit for bit.
    repeats = all(torch.equal(run(), got) for _ in range(2)) if f32 and multi else None
    del got, want
    sharpened = None
    if blind_ratio <= 1:
        # Scores so flat (random weights of a small scale: gpt2-small's)
        # that one key moves no output past the allowance: the gate is
        # blind at this input. The kernel is held again on the same shapes,
        # cache and mask with q scaled by BLIND_Q_SCALE, which sharpens the
        # softmax; there it must agree with its plain version, and the
        # blinded call must fail the allowance.
        _, _, s_err, s_ratio, s_blind = hold(q * BLIND_Q_SCALE)
        sharpened = {"q_scale": BLIND_Q_SCALE, "max_abs_err": s_err, "err_over_tol": s_ratio,
                     "blind_gate_err_over_tol": s_blind}
    iters = 200
    ms = cuda_ms(run, iters)
    wrapper_host_us = host_us(run)
    plain_ms = cuda_ms(lambda: dm.decode_attention_reference(q, k, v, valid, **kw), 20)
    # Which own-cache slots each query sees: valid, and for a verify window
    # j <= q_offsets[b] + i.
    slots = torch.arange(L, device=q.device)
    sees = valid.bool()[:, None, :].expand(B, Q, L)
    if multi:
        sees = sees & (slots[None, None, :] <= (offs.long()[:, None, None]
                                                 + torch.arange(Q, device=q.device)[None, :, None]))
    # Yardstick: one SDPA call over [prefix; cache] laid out [B, H, P+L, D]
    # with an explicit boolean mask; the layout (and, for an int8 cache, the
    # dequantization) is built before timing.
    rep = H // Hkv
    kf = _dequantize_kv(k, ks, q.dtype) if quant else k
    vf = _dequantize_kv(v, vs, q.dtype) if quant else v
    kk, vv, mask = kf.transpose(1, 2), vf.transpose(1, 2), sees
    if P:
        kk = torch.cat([shared[0].transpose(0, 1)[None].expand(B, -1, -1, -1), kk], 2)
        vv = torch.cat([shared[1].transpose(0, 1)[None].expand(B, -1, -1, -1), vv], 2)
        mask = torch.cat([torch.ones(B, Q, P, dtype=torch.bool, device=q.device), sees], 2)
    ke = kk.repeat_interleave(rep, 1).contiguous()
    ve = vv.repeat_interleave(rep, 1).contiguous()
    q4 = (q.transpose(1, 2) if multi else q[:, :, None, :]).contiguous()
    m4 = mask[:, None].contiguous()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, ke, ve, attn_mask=m4), iters)
    del kf, vf, kk, vv, ke, ve, q4, m4
    # Bound: the bytes this input needs (q and o; k/v, and their scales, of
    # every cache slot some query sees; the prefix; valid; the offsets), or
    # 4*D operations per visible (query, key) pair per head, whichever is
    # longer.
    needed = int(sees.any(1).sum())
    pairs = int(sees.sum()) + B * Q * P
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * needed * Hkv * D * k.element_size()
              + (2 * needed * Hkv * 4 if quant else 0) + 2 * P * Hkv * D * item + B * L
              + (4 * B if multi else 0))
    flops = 4.0 * D * H * pairs
    peak = F32_FLOPS if f32 else BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    shape = {"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype)[6:],
             "cache": str(k.dtype)[6:], "prefix": P,
             "visible_slots": int(sees.sum()) if multi else needed}
    return {
        "shape": shape, **rates(flops, ms, peak), "bound_share": max(t_ops, t_bytes) / ms,
        "splits": decode_plan(dm, q, k, P, multi, torch), "floor_ms": launch_floor_ms(torch),
        "tol": tolerance(f32),
        "calls": call["n"], "max_abs_err": err, "err_over_tol": ratio,
        "ok": (ratio <= 1 and repeats is not False
               and (sharpened is None or sharpened["err_over_tol"] <= 1)),
        "repeats_equal": repeats, "blind_gate_err_over_tol": blind_ratio,
        "sharpened": sharpened,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "host_us": wrapper_host_us,
        "library_call": "F.scaled_dot_product_attention over [prefix; cache] with a boolean mask"
                        + (", k/v dequantized beforehand" if quant else ""),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def decode_plan(dm, q, k, P: int, multi: bool, torch):
    """(prefix splits, cache splits) the wrapper plans for a call, at the
    head width it pads D to; for the float32 verify window (rows a block,
    prefix splits, cache splits)."""
    from fairness_llm_tpu_torch.ops import _build

    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    L, Hkv = k.shape[1], k.shape[2]
    sms = _build.sm_count(q.device)
    if q.dtype == torch.bfloat16:
        Dk = next(w for w in dm.TC_WIDTHS if w >= D)
        if multi:
            return list(dm.verify_splits(B, Hkv, H // Hkv * q.shape[1], P, L, sms))
        return list(dm.decode_splits(B, Hkv, H // Hkv, P, L, Dk, sms))
    Dk = next(w for w in dm.F32_WIDTHS if w >= D)
    if multi:
        return list(dm.verify_splits_f32(B, Hkv, H // Hkv * q.shape[1], P, L, Dk, sms))
    return list(dm.decode_splits_f32(B, Hkv, H // Hkv, P, L, Dk, sms))


def k4_numbers(call, torch, flush):
    """K4 at one recorded call: ``quant_matmul`` (key "k4") or a grouped
    call of the weights that share x (key "group"), each output against the
    plain product of its own weight. The host microseconds and
    ``torch._weight_int8pack_mm`` only in the GEMV regime, which the decode
    step runs (None in a GEMM row)."""
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    x, rest = call["args"][0], call["args"][1:]
    od = call["kwargs"].get("out_dtype") or x.dtype
    grouped = call["group"]
    mats = list(rest[0]) if grouped else [tuple(rest[:2])]
    M, K = x.shape
    extras = M <= qm.GEMV_MAX_M
    Ns = [wq.shape[1] for wq, _ in mats]
    f32 = x.dtype == torch.float32
    tol = (ATOL_K4F32, RTOL_K4F32) if f32 else tolerance(False)

    def run(xx):
        if grouped:
            return qm.quant_matmul_group(xx, mats, out_dtype=od)
        return [qm.quant_matmul(xx, *mats[0], out_dtype=od)]

    def plain():
        return [qm.quant_matmul_reference(x, wq, scale, od) for wq, scale in mats]

    want = plain()
    f32_before = (qm.tf32_gemv_launches, qm.tf32_gemm_launches)
    got = run(x)
    errs = [gate(g, w, tol=tol) for g, w in zip(got, want)]
    kernel = None
    if f32:  # the kernel the C entry reported, and a second call bit for bit
        kernel = ("gemv_stream_tf32" if qm.tf32_gemv_launches > f32_before[0] else
                  "tf32_gemm_kernel" if qm.tf32_gemm_launches > f32_before[1] else None)
        repeats_equal = all(torch.equal(a, b) for a, b in zip(got, run(x)))
    del got
    # The kernel on x with its last 32 columns zeroed: the gate must see a
    # kernel that drops its last k tile (32 or 64 wide), in every output.
    cut = x.clone()
    cut[:, -32:] = 0
    cut_ratio = min(gate(g, w, tol=tol)[1] for g, w in zip(run(cut), want))
    del want, cut
    flops = 2.0 * M * K * sum(Ns)
    iters = 5 if flops > 1e12 else 20
    ms = cuda_ms_cold(lambda: run(x), iters, flush)
    plain_ms = cuda_ms_cold(plain, max(2, iters // 2), flush)
    # Yardsticks, never called by the port: one torch.matmul over the
    # weights dequantized to x's dtype beforehand and, for a group, laid
    # side by side (library_ms), and PyTorch's own int8-weight product where
    # this build has it on the card (one weight only).
    wd = torch.cat([qm.dequantize_weight(wq, scale, x.dtype) for wq, scale in mats], 1)
    library_ms = cuda_ms_cold(lambda: torch.matmul(x, wd), iters, flush)
    # What a GEMV call costs the host: the decode step is host-bound.
    wrapper_host_us = host_us(lambda: run(x)) if extras else None
    library_host_us = host_us(lambda: torch.matmul(x, wd)) if extras else None
    del wd
    int8pack_ms, int8pack_error = None, None
    if extras and x.dtype == torch.bfloat16 and not grouped:
        wt, sc = mats[0][0].t().contiguous(), mats[0][1].to(x.dtype)
        try:
            int8pack_ms = cuda_ms_cold(lambda: torch._weight_int8pack_mm(x, wt, sc), iters, flush)
        except RuntimeError as e:  # a yardstick only: its absence is recorded
            int8pack_error = str(e).splitlines()[0][:160]
        del wt, sc
    # Bound: the int8 weights, the scales, x and the outputs each moved once,
    # or 2*M*K*N operations at the peak for x's type, whichever is longer.
    nbytes = (K * sum(Ns) + 4 * sum(Ns) + M * K * x.element_size()
              + M * sum(Ns) * torch.finfo(od).bits // 8)
    # float32 x: three bf16 passes (K4_F32_BF16_PASSES), 3 x 2MKN operations
    # at the bf16 peak; the route's own two TF32 passes and the f32 FMAs,
    # which it ran before, are reported beside it.
    peak = BF16_FLOPS if x.dtype == torch.bfloat16 else BF16_FLOPS / K4_F32_BF16_PASSES
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    err = max(e for e, _ in errs)
    ratio = max(r for _, r in errs)
    return {
        "regime": "gemv" if M <= qm.GEMV_MAX_M else "gemm", **rates(flops, ms, peak),
        "shape": {"M": M, "K": K, "N": Ns if grouped else Ns[0], "x": str(x.dtype)[6:],
                  "out": str(od)[6:], **({"group": len(mats)} if grouped else {})},
        "calls": call["n"], "max_abs_err": err, "err_over_tol": ratio, "ok": ratio <= 1,
        "blind_gate_err_over_tol": cut_ratio, "tol": tol,
        # float32 x: the kernel, its K splits in the GEMM regime (the GEMV's
        # plan is gemv_plan's, as bf16's), its repeat, and the f32 FMA bound
        **({"kernel_function": kernel, "repeats_equal": repeats_equal,
            "k_splits": 1 if extras else qm.tf32_gemm_plan(K, sum(Ns))[0],
            "tf32_two_pass_bound_ms": max(2 * flops / TF32_FLOPS * 1e3, t_bytes),
            "f32_fma_bound_ms": max(flops / F32_FLOPS * 1e3, t_bytes)} if f32 else {}),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "library_call": "torch.matmul(x, weight dequantized to x's dtype"
                        + (", the group's side by side)" if grouped else ")"),
        "host_us": wrapper_host_us, "library_host_us": library_host_us,
        "int8pack_ms": int8pack_ms, "int8pack_error": int8pack_error,
        "bound_ms": max(t_ops, t_bytes), "bound_share": max(t_ops, t_bytes) / ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def k4_study_rows(calls, torch, flush, batch: int = STUDY_BATCH):
    """The K4 GEMV at the study's decode batch: each of the path's decode
    step calls (M = 16) with x's rows repeated up to ``batch``, numbered and
    held as the path's own (times reported, the tolerance and blind check
    gated by ``check_rows``)."""
    rows = []
    for call in calls:
        x = call["args"][0]
        if x.shape[0] != 16:
            continue
        big = {**call, "n": 0, "args": (torch.cat([x] * -(-batch // 16))[:batch].contiguous(),
                                        *call["args"][1:])}
        row = k4_numbers(big, torch, flush)
        row["study_batch"] = True
        rows.append(row)
    return rows


def int8_tree_bytes(cfg) -> int:
    """Bytes of an int8 model's parameters as they should be stored: int8
    kernels, f32 scales, every other tensor (embedding, norms) in bf16. From
    the parameter names and shapes, not from what the engine allocated."""
    from fairness_llm_tpu_torch.runtime.weights import param_shapes

    total = 0
    for name, shape in param_shapes(cfg).items():
        item = 1 if name.endswith("kernel_q") else 4 if name.endswith("kernel_scale") else 2
        total += math.prod(shape) * item
    return total


def profiled_decode(backend, prompts, prefix, settings, torch, focus=()):
    """The shared-prefix greedy call three times untraced, then once under
    torch.profiler. The busy share is the union of the device's activity
    intervals over the traced call's span, so it counts launch gaps as idle;
    tracing slows the host, so it is a lower bound for the untraced call.
    ``focus_ms`` sums the device time of the kernels whose names hold each
    string of ``focus``, ``focus_launches_per_step`` counts their launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def per_step(st):
        return st["decode_s"] * 1e3 / max(st["decode_steps"], 1)

    untraced = []
    for _ in range(3):
        with CardSampler() as card:
            backend.generate(prompts, settings, prefix_ids=prefix)
        untraced.append({"decode_ms_per_step": per_step(backend.last_stats),
                         "card": card.summary})
    with CardSampler() as card:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("traced_generate"):
                backend.generate(prompts, settings, prefix_ids=prefix)
            torch.cuda.synchronize()
    traced_step_ms = per_step(backend.last_stats)
    events = prof.events()
    span = next(e for e in events if e.name == "traced_generate")
    # Device activity: kernels, copies, sets. The annotation's own device
    # row spans the whole call, and "Command Buffer Full" is not work.
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.name not in ("traced_generate", "Command Buffer Full")
                 and e.time_range.end > e.time_range.start)
    if not dev:
        fail("the traced decode call shows no device activity")
    t0 = min(span.time_range.start, dev[0][0])
    t1 = max(span.time_range.end, max(d[1] for d in dev))
    busy, cur_s, cur_e, by_name, count = 0.0, None, None, {}, {}
    for start, end, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        count[name] = count.get(name, 0) + 1
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "decode_steps": backend.last_stats["decode_steps"],
        "untraced": untraced, "traced_decode_ms_per_step": traced_step_ms,
        "traced_span_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / (t1 - t0), "traced_card": card.summary,
        "top_device_ms": [{"name": n[:80], "ms": us / 1e3} for n, us in top],
        "focus_ms": {f: sum(us for n, us in by_name.items() if f in n) / 1e3 for f in focus},
        "focus_ms_per_step": {f: sum(us for n, us in by_name.items() if f in n) / 1e3
                              / max(backend.last_stats["decode_steps"], 1) for f in focus},
        "focus_launches_per_step": {f: sum(c for n, c in count.items() if f in n)
                                    / max(backend.last_stats["decode_steps"], 1)
                                    for f in focus},
    }


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper (K1, K2/K3, K4 single and grouped) swapped for
    its plain version inside the block."""
    from fairness_llm_tpu_torch.ops import decode_attention as dm
    from fairness_llm_tpu_torch.ops import flash_attention as fm
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    kernels = (fm.flash_attention, dm.decode_attention, qm.quant_matmul, qm.quant_matmul_group)
    fm.flash_attention = fm.flash_attention_reference
    dm.decode_attention = dm.decode_attention_reference
    qm.quant_matmul = qm.quant_matmul_reference
    qm.quant_matmul_group = qm.quant_matmul_group_reference
    try:
        yield
    finally:
        (fm.flash_attention, dm.decode_attention, qm.quant_matmul,
         qm.quant_matmul_group) = kernels


def teacher_forced_check(engine, prompts, torch):
    """Logits of the kernel path against the same model with each kernel
    wrapper swapped for its plain version, on 4 prompts: the prefill (K1,
    and K4's GEMM regime in an int8 model) plus 4 decode steps (K2, or K2q
    over an int8 cache, and K4's GEMV regime) fed the same tokens. The two differ only where a
    kernel's output rounds differently from its plain version's."""
    from fairness_llm_tpu_torch.models.tokenizer import _left_pad
    from fairness_llm_tpu_torch.runtime.stepbuilder import make_batch_entry

    tb = _left_pad([engine.tokenizer.encode(p) for p in prompts[:4]], engine.tokenizer.pad_id)
    S = -(-tb.tokens.shape[1] // 128) * 128
    tokens = torch.zeros(4, S, dtype=torch.long)
    valid = torch.zeros(4, S, dtype=torch.bool)
    tokens[:, S - tb.tokens.shape[1]:] = torch.from_numpy(tb.tokens)
    valid[:, S - tb.tokens.shape[1]:] = torch.from_numpy(tb.valid)
    tokens, valid = tokens.to(engine.device), valid.to(engine.device)
    n_steps = 4

    def run():
        entry = make_batch_entry(engine.config, engine.model, batch=4, cache_len=S + n_steps)
        logits, cache = entry(tokens, valid, None)
        out = [logits]
        for t in range(n_steps):
            tok = torch.full((4, 1), 300 + t, dtype=torch.long, device=engine.device)
            lg, cache = engine.model(tok, cache.lengths[:, None],
                                     torch.ones_like(tok, dtype=torch.bool), cache)
            out.append(lg[:, -1])
        return torch.stack(out)

    got = run()
    with plain_kernels():
        want = run()
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return {"max_abs_logit_diff": diff, "max_abs_logit": scale, "argmax_agreement": agree,
            "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape)}


def check_rows(name: str, rows, blind: str) -> None:
    for r in rows:
        log(f"kernel {name} {json.dumps(r)}")
        if not r["ok"]:
            atol, rtol = r["tol"]
            fail(f"{name} disagrees with its plain version at {r['shape']}: "
                 f"max_abs_err {r['max_abs_err']}, {r['err_over_tol']:.2f}x the "
                 f"tolerance {atol} + {rtol} * |plain|")
        if r.get("repeats_equal") is False:
            fail(f"{name} at {r['shape']}: repeated calls on one input differ")
        sharp = r.get("sharpened")
        if r["blind_gate_err_over_tol"] <= 1 and (
                sharp is None or sharp["blind_gate_err_over_tol"] <= 1):
            fail(f"{name} at {r['shape']}: {blind} stays within the tolerance "
                 f"({r['blind_gate_err_over_tol']:.2f}x"
                 + (f"; {sharp['blind_gate_err_over_tol']:.2f}x with q scaled by "
                    f"{sharp['q_scale']}" if sharp else "") + "); the gate is blind")


def kernel_entry(name: str, source: str, replaces: str, launches: int, rows) -> dict:
    """The kernels-line entry: the headline row is the shape the main path
    launched most (ties: the larger one); every shape is under "shapes"."""
    top = max(rows, key=lambda r: (r["calls"], r["bytes"]))
    second = COMBINE_FUNCTIONS.get(KERNEL_FUNCTIONS[name])
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "kernel_function": KERNEL_FUNCTIONS[name],
        **({"gemm_function": GEMM_FUNCTIONS[name]} if name in GEMM_FUNCTIONS else {}),
        **({"combine_function": second} if second else {}), "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": top["library_ms"], "shapes": rows,
    }


def serve_three(backend, prompts, keys, prefix, greedy, sampled, label: str):
    rows = [serve(backend, prompts, greedy, f"{label}shared_prefix_greedy", prefix_ids=prefix),
            serve(backend, prompts, sampled, f"{label}shared_prefix_t0.7", keys=keys,
                  prefix_ids=prefix),
            serve(backend, prompts, greedy, f"{label}no_prefix_greedy")]
    if rows[0]["prefix_len"] <= 0 or rows[2]["prefix_len"] != 0:
        fail(f"{label}: the phases did not take the shared-prefix / no-prefix paths")
    return rows


def study_batch_rows(rec, mode: str, name: str, torch, F, batch: int = STUDY_BATCH):
    """K2 (``mode`` "k2") or K2q ("k2q") at the study's batch: each of the
    path's shared-prefix calls with its batch rows repeated up to ``batch``
    (q, cache, valid, scales; the prefix as it was), numbered as
    decode_numbers numbers a path's call. The times are reported, not gated;
    the rows are held to the tolerance and the blind check as the path's
    own (``check_rows``): at 192 query rows a kv head the prefix blocks take
    three chunks of 64, which the path's batch of 16 never reaches."""
    rows = []
    for key, call in rec.calls.items():
        if key[0] != mode or key[3] == 0:
            continue
        q = call["args"][0]
        reps = -(-batch // q.shape[0])

        def grow(t):
            return torch.cat([t] * reps)[:batch].contiguous()

        kw = {n: grow(t) if n in ("k_scale", "v_scale") and t is not None else t
              for n, t in call["kwargs"].items()}
        big = {"n": 0, "args": tuple(grow(t) for t in call["args"][:4]), "kwargs": kw}
        rows.append(decode_numbers(big, torch, F))
        del big, kw
    check_rows(name, rows, "the newest slot masked out")
    return rows


def head_product_check(engine, torch, label: str = "") -> dict:
    """The bf16 logits product (``transformer._logits``) on the model's
    head (its lm_head, e.g. [4096, 128256], or for a tied head the
    embedding's transpose, a strided view) and x [16, d_model] from seed 0
    in the model's compute dtype: it must write f32 within 1e-4 of the
    largest logit of the f32 product of the same bf16 operands, allocate no
    f32 copy of the head (peak allocation during the call under 64 MB, plus
    the bf16 copy ``_logits`` makes of a head stored in float32, as the
    engine stores models under a billion parameters), and the bf16-rounded
    product it replaced must miss that tolerance (the gate sees the
    rounding). Both products timed; returns the row."""
    from fairness_llm_tpu_torch.models.transformer import _logits

    model = engine.model
    head = model.embedding.t() if model.config.tie_embeddings else model.lm_head
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(16, head.shape[0], generator=g, device="cuda").to(torch.bfloat16)
    copy = head.numel() * x.element_size() if head.dtype != x.dtype else 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = _logits(x, head)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    want = x.float() @ head.to(x.dtype).float()
    rounded = (x @ head.to(x.dtype)).float()
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    row = {"x": list(x.shape), "head": list(head.shape), "dtype": str(got.dtype)[6:],
           "head_dtype": str(head.dtype)[6:], "head_copy_bytes": copy,
           "max_abs_err": float((got - want).abs().max()), "tol": tol,
           "rounded_max_abs_err": float((rounded - want).abs().max()),
           "peak_extra_bytes": extra, "out_bytes": got.numel() * got.element_size(),
           "ms": cuda_ms(lambda: _logits(x, head), 50),
           "rounded_ms": cuda_ms(lambda: (x @ head.to(x.dtype)).float(), 50)}
    del want, rounded
    log(f"head_product{label} {json.dumps(row)}")
    if row["dtype"] != "float32" or row["max_abs_err"] > tol:
        fail(f"the bf16 logits product is not an f32 sum of the bf16 operands: {row}")
    if row["rounded_max_abs_err"] <= tol:
        fail(f"the head-product gate does not see bf16 rounding: {row}")
    if extra > (64 << 20) + copy:
        fail(f"the bf16 logits product allocated {extra} bytes (an f32 copy of the head?)")
    return row


def flash_recorder(flash_mod):
    """A Recorder of flash_attention keyed by shapes, dtype and window."""
    return Recorder(flash_mod, "flash_attention",
                    lambda q, k, v, lengths, causal=True, window=None:
                    ("k1", tuple(q.shape), tuple(k.shape), str(q.dtype), window))


def k4_recorders(qm):
    """WeightRecorders of quant_matmul and quant_matmul_group keyed by
    shapes and dtypes."""
    return (WeightRecorder(qm, "quant_matmul",
                           lambda x, wq, scale, out_dtype=None:
                           ("k4", tuple(x.shape), tuple(wq.shape), str(x.dtype),
                            str(out_dtype or x.dtype))),
            WeightRecorder(qm, "quant_matmul_group",
                           lambda x, mats, out_dtype=None:
                           ("group", tuple(x.shape), tuple(tuple(w.shape) for w, _ in mats),
                            str(x.dtype), str(out_dtype or x.dtype))))


def k4_calls(rec4, recg, qm) -> list:
    """The recorded K4 calls, one a kernel launch (or a launch a weight): a
    grouped call in the GEMV regime is one launch and makes no quant_matmul
    call of its own; past it, it is one quant_matmul call a weight, each
    recorded (and given its row) on its own."""
    for call in rec4.calls.values():
        call["group"] = False
    for call in recg.calls.values():
        call["group"] = True
    return list(rec4.calls.values()) + [c for c in recg.calls.values()
                                        if c["args"][0].shape[0] <= qm.GEMV_MAX_M]


def decode_recorder(dec_mod):
    """A Recorder of decode_attention keyed by mode and shapes."""

    def key(q, k, v, valid, shared_kv=None, k_scale=None, v_scale=None, q_offsets=None):
        mode = ("k3" if q.dim() == 4 else "k2") + ("q" if k_scale is not None else "")
        return (mode, tuple(q.shape), tuple(k.shape),
                0 if shared_kv is None else shared_kv[0].shape[0])

    return Recorder(dec_mod, "decode_attention", key)


def decode_counts(dec_mod) -> dict:
    return {"decode_attention": dec_mod.launches,
            "decode_attention_int8_cache": dec_mod.quant_launches,
            "decode_attention_verify": dec_mod.multi_launches,
            "decode_attention_verify_int8_cache": dec_mod.multi_quant_launches,
            "decode_attention_verify_tc": dec_mod.multi_tc_launches,
            "decode_attention_verify_split_f32": dec_mod.verify_f32_launches,
            "decode_attention_tc": dec_mod.decode_tc_launches}


def zero_counts(dec_mod, flash_mod) -> None:
    flash_mod.launches = flash_mod.tc_launches = 0
    dec_mod.launches = dec_mod.quant_launches = 0
    dec_mod.multi_launches = dec_mod.multi_quant_launches = dec_mod.multi_tc_launches = 0
    dec_mod.decode_tc_launches = dec_mod.decode_f32_launches = dec_mod.verify_f32_launches = 0


def one_query_counts(dec_mod) -> tuple:
    """(decode_split_tc, decode_split_f32) launches since the counts were
    zeroed, over either cache: every one-query launch (K2, K2q) must be on
    one of the two split kernels, as the C entry reports."""
    one = dec_mod.launches + dec_mod.quant_launches
    tc, f32 = dec_mod.decode_tc_launches, dec_mod.decode_f32_launches
    if tc + f32 != one:
        fail(f"{one} one-query decode launches, of which {tc} on decode_split_tc and {f32} "
             f"on decode_split_f32")
    return tc, f32


def need_launches(launches: dict, names, path: str) -> None:
    log(f"launches on the {path} path: {json.dumps(launches)}")
    for name in names:
        if launches[name] <= 0:
            fail(f"{name} was not launched on the {path} path")


def need_all_tc(launches: dict, path: str, name: str = "flash_attention",
                tc: str = "flash_attention_tc") -> None:
    """Every launch of kernel ``name`` on a path with bf16 activations (K1;
    K2 and K2q; K3 on a speculative path) must be one the C entry reports
    as its tensor-core kernel (flash_fwd_tc; decode_split_tc;
    decode_verify_tc), counted in ``tc``."""
    if launches[tc] != launches[name]:
        fail(f"on the {path} path {launches[name]} {name} launches, of which "
             f"{launches[tc]} on the tensor-core kernel")


def spec_serve(engine, prompts, prefix, greedy, label: str):
    """The shared-prefix greedy call through EngineBackend with speculation
    on; returns the serve row with the call's speculation counters."""
    from fairness_llm_tpu_torch.config import SpeculationConfig
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend

    backend = EngineBackend(engine, speculation=SpeculationConfig(enabled=True))
    row = serve(backend, prompts, greedy, label, prefix_ids=prefix)
    st = backend.last_stats.get("speculation")
    if st is None or st["verify_steps"] != row["decode_steps"]:
        fail(f"{label}: the call did not take the speculative path ({backend.last_stats})")
    log(f"speculation {label} {json.dumps(st)}")
    return row


def decode_rows(rec, mode: str, name: str, torch, F, blind: str):
    rows = [decode_numbers(call, torch, F) for key, call in rec.calls.items() if key[0] == mode]
    if not rows:
        fail(f"{name}: no launch recorded on its path")
    check_rows(name, rows, blind)
    return rows


def spec_token_share(engine, prompts, prefix, greedy, torch) -> dict:
    """Greedy tokens with speculation against without, on one engine."""
    from fairness_llm_tpu_torch.config import SpeculationConfig

    plain = engine.generate(prompts, greedy, prefix_ids=prefix)
    spec = engine.generate(prompts, greedy, prefix_ids=prefix,
                           speculation=SpeculationConfig(enabled=True))
    same = plain.tokens == spec.tokens
    first = [int(r.argmin()) if not r.all() else None for r in same]
    return {"equal_share": float(same.mean()), "rows_equal": int(same.all(1).sum()),
            "rows": int(same.shape[0]), "first_divergent_step": first,
            "speculation": spec.stats["speculation"], "equal": bool(same.all())}


def cache_bytes(cfg, torch, batch: int, slots: int) -> int:
    """Device bytes init_cache allocates for ``cfg`` at [batch, slots]."""
    from fairness_llm_tpu_torch.models.transformer import init_cache

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache = init_cache(cfg, batch, slots, device=torch.device("cuda"))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del cache
    return held


def bf16_path(torch, F, prompts, keys, greedy, sampled):
    """Phases 3-13 on llama3-8b, with a float and then an int8 KV cache;
    returns the K1, K2, K3, K2q and K3-over-int8 kernel entries with phase
    13's three float32 verify-window and int8-cache entries, and phase 13's
    launches and rows of K1 f32 and K2 f32 (by entry name)."""
    from fairness_llm_tpu_torch.config import ModelSettings
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend, shared_prefix_ids
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_model_config(MODEL), use_decode_attention_kernel=True,
                              num_layers=CUT_LAYERS)
    engine = DecodeEngine(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"engine: {MODEL} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} "
        f"params_gb={torch.cuda.memory_allocated() / 1e9:.2f} init_s={time.perf_counter() - t0:.2f}")
    backend = EngineBackend(engine)
    prefix = shared_prefix_ids(backend, prompts)
    if prefix is None:
        fail("the counterfactual prompts share no 64-token prefix")
    # Warm-up (cuBLAS handles, kernel libraries) outside the counted run.
    backend.generate(prompts[:2], ModelSettings(temperature=0.0, max_tokens=2))
    head_product_check(engine, torch)

    # 3-4. the plain serve calls
    rec1 = flash_recorder(flash_mod)
    rec2 = decode_recorder(dec_mod)
    zero_counts(dec_mod, flash_mod)
    with rec1, rec2:
        serve_three(backend, prompts, keys, prefix, greedy, sampled, "")
    launches = {"flash_attention": flash_mod.launches,
                "flash_attention_tc": flash_mod.tc_launches, **decode_counts(dec_mod)}
    need_launches(launches, ["flash_attention", "decode_attention"], "bf16 main")
    need_all_tc(launches, "bf16 main")
    need_all_tc(launches, "bf16 main", "decode_attention", "decode_attention_tc")

    # 5. the speculative serve call
    rec3 = decode_recorder(dec_mod)
    zero_counts(dec_mod, flash_mod)
    with rec3:
        spec_serve(engine, prompts, prefix, greedy, "shared_prefix_greedy_spec")
    spec_launches = decode_counts(dec_mod)
    need_launches(spec_launches, ["decode_attention_verify"], "bf16 speculative")
    need_all_tc(spec_launches, "bf16 speculative", "decode_attention_verify",
                "decode_attention_verify_tc")

    # 6. kernels against their plain versions at the paths' shapes
    k1_rows = [k1_numbers(call, torch, F) for call in rec1.calls.values()]
    check_rows("flash_attention", k1_rows, "the first valid key masked out")
    k2_rows = decode_rows(rec2, "k2", "decode_attention", torch, F, "the newest slot masked out")
    k3_rows = decode_rows(rec3, "k3", "decode_attention_verify", torch, F,
                          "every q_offset lowered by one")
    dec_src = K2_SOURCE
    kernels = [
        {**kernel_entry("flash_attention", K1_SOURCE, K1_REPLACES, launches["flash_attention"],
                        k1_rows),
         "tc_launches": launches["flash_attention_tc"]},
        {**kernel_entry("decode_attention", dec_src, K2_REPLACES, launches["decode_attention"],
                        k2_rows),
         "tc_launches": launches["decode_attention_tc"],
         "study_batch_shapes": study_batch_rows(rec2, "k2", "decode_attention", torch, F)},
        {**kernel_entry("decode_attention_verify", dec_src, K3_REPLACES,
                        spec_launches["decode_attention_verify"], k3_rows),
         "tc_launches": spec_launches["decode_attention_verify_tc"]},
    ]
    del rec1, rec2, rec3

    # 7. where a decode call's time goes
    prof_row = profiled_decode(backend, prompts, prefix,
                               ModelSettings(temperature=0.0, max_tokens=PROFILE_TOKENS), torch,
                               focus=K2_FOCUS)
    log(f"profile_shared_prefix_greedy {json.dumps(prof_row)}")
    spec_profile(engine, prompts, prefix, torch, "")

    # 8. speculative tokens against plain ones at full depth in bf16: reported
    # only, since a verify window's GEMMs (M = batch x 9) round otherwise than
    # a step's (M = batch) and the random-weight model flips near-ties.
    share = spec_token_share(engine, prompts, prefix, greedy, torch)
    log(f"spec_tokens_vs_plain_bf16_{cfg.num_layers}_layers {json.dumps(share)}")

    # 9. end-to-end check against the plain versions (reported in bf16)
    teacher_forced_gate(engine, prompts, torch, "", cfg.vocab_size)

    # 10-12. the int8 KV cache on the same weights
    kernels += kv_cache_path(torch, F, engine, prompts, keys, prefix, greedy, sampled)
    del engine, backend
    torch.cuda.empty_cache()

    # 13. the gates in float32 at full width, depth cut to 4 layers: kernel
    # and plain versions then differ only in summation order. Every kernel
    # call of the gates is recorded, counted and held against its plain
    # version: the float cache's (K1 f32, K2 f32 on decode_split_f32, the
    # verify window on verify_split_f32), then the int8 cache's.
    small = DecodeEngine(dataclasses.replace(cfg, num_layers=4, dtype="float32"), seed=0)
    rec_k1, rec_f = flash_recorder(flash_mod), decode_recorder(dec_mod)
    zero_counts(dec_mod, flash_mod)
    with rec_k1, rec_f:
        teacher_forced_gate(small, prompts, torch, "", cfg.vocab_size, f32=True)
        share = spec_token_share(small, prompts, prefix, greedy, torch)
    f32_launches = f32_gate_counts(dec_mod, flash_mod)
    log(f"spec_tokens_vs_plain_f32_4_layers {json.dumps(share)}")
    if not share["equal"]:
        fail(f"speculative greedy tokens differ from plain greedy in float32: {share}")
    small_q = DecodeEngine(dataclasses.replace(small.config, kv_cache_quant=True),
                           params=small.model.state_dict())
    rec_q = decode_recorder(dec_mod)
    zero_counts(dec_mod, flash_mod)
    with rec_q:
        teacher_forced_gate(small_q, prompts, torch, "int8_cache_", cfg.vocab_size, f32=True)
        share = spec_token_share(small_q, prompts, prefix, greedy, torch)
    q_launches = f32_gate_counts(dec_mod, flash_mod)
    log(f"spec_tokens_vs_plain_int8_cache_f32_4_layers {json.dumps(share)}")
    need_launches(f32_launches, ["flash_attention_f32", "decode_attention_f32",
                                 "decode_attention_verify_f32"], "float32 gates")
    need_launches(q_launches, ["decode_attention_f32_int8_cache",
                               "decode_attention_verify_f32_int8_cache"],
                  "float32 int8-cache gates")
    del small, small_q
    torch.cuda.empty_cache()
    k1_gate = [k1_numbers(call, torch, F) for call in rec_k1.calls.values()]
    check_rows("flash_attention_f32", k1_gate, "the first valid key masked out")
    newest, lowered = "the newest slot masked out", "every q_offset lowered by one"
    gate = {"flash_attention_f32": {"launches": f32_launches["flash_attention_f32"],
                                    "rows": k1_gate},
            "decode_attention_f32": {"launches": f32_launches["decode_attention_f32"],
                                     "rows": decode_rows(rec_f, "k2", "decode_attention_f32",
                                                         torch, F, newest)}}
    kernels += [
        kernel_entry("decode_attention_verify_f32", K3F32_SOURCE, K3_REPLACES,
                     f32_launches["decode_attention_verify_f32"],
                     decode_rows(rec_f, "k3", "decode_attention_verify_f32", torch, F, lowered)),
        kernel_entry("decode_attention_f32_int8_cache", K2F32_SOURCE, K2Q_REPLACES,
                     q_launches["decode_attention_f32_int8_cache"],
                     decode_rows(rec_q, "k2q", "decode_attention_f32_int8_cache", torch, F,
                                 newest)),
        kernel_entry("decode_attention_verify_f32_int8_cache", K3F32_SOURCE, K3Q_REPLACES,
                     q_launches["decode_attention_verify_f32_int8_cache"],
                     decode_rows(rec_q, "k3q", "decode_attention_verify_f32_int8_cache", torch, F,
                                 lowered)),
    ]
    for entry in kernels[-3:]:
        entry["gate_launches"] = entry["launches"]
    del rec_k1, rec_f, rec_q
    return kernels, gate


def verify_f32_counts(dec_mod) -> int:
    """verify_split_f32's launches since the counts were zeroed: every
    verify window of a float32 model (either cache) must be one the C entry
    reports as verify_split_f32's, and none may run on decode_verify_tc."""
    multi = dec_mod.multi_launches + dec_mod.multi_quant_launches
    if dec_mod.verify_f32_launches != multi or dec_mod.multi_tc_launches:
        fail(f"{multi} float32 verify-window launches, of which {dec_mod.verify_f32_launches} "
             f"on verify_split_f32 and {dec_mod.multi_tc_launches} on decode_verify_tc")
    return multi


def f32_gate_counts(dec_mod, flash_mod) -> dict:
    """Phase 13's launches by kernels-line entry: a float32 model runs no
    tensor-core kernel, each of its one-query launches (either cache) is
    decode_split_f32's and each verify window verify_split_f32's."""
    tc, f32 = one_query_counts(dec_mod)
    verify_f32_counts(dec_mod)
    if tc or flash_mod.tc_launches:
        fail(f"a float32 gate ran a tensor-core kernel: flash {flash_mod.tc_launches}, "
             f"decode {tc}")
    launches = {"flash_attention_f32": flash_mod.launches,
                "decode_attention_f32": dec_mod.launches,
                "decode_attention_f32_int8_cache": dec_mod.quant_launches,
                "decode_attention_verify_f32": dec_mod.multi_launches,
                "decode_attention_verify_f32_int8_cache": dec_mod.multi_quant_launches,
                "decode_attention_split_f32": f32}
    log(f"float32 gate launches {json.dumps(launches)}")
    return launches


def kv_cache_path(torch, F, engine, prompts, keys, prefix, greedy, sampled):
    """Phases 10-12: a second engine with kv_cache_quant over the first
    engine's parameter tensors; returns the K2q and K3-over-int8 entries."""
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    # 10. the engine: it must hold no second copy of the weights
    cfg = dataclasses.replace(engine.config, kv_cache_quant=True)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    eng_q = DecodeEngine(cfg, params=engine.model.state_dict())
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before
    mine = dict(eng_q.model.named_parameters())
    shared = sum(p.data_ptr() == mine[n].data_ptr() for n, p in engine.model.named_parameters())
    log(f"engine: {MODEL} kv_cache_quant=True over the bf16 engine's tensors: "
        f"shared_tensors={shared}/{len(mine)} added_gb={added / 1e9:.4f}")
    if shared != len(mine) or added > 0.01 * before:
        fail(f"the int8-cache engine copied weights: {shared}/{len(mine)} tensors shared, "
             f"{added / 1e9:.3f} GB added")
    B, L = 16, 960  # the no-prefix call's cache
    held = {name: cache_bytes(c, torch, B, L) for name, c in
            (("int8", cfg), ("bf16", engine.config))}
    log(f"kv cache bytes at [{B}, {L}] x {cfg.num_layers} layers: int8 {held['int8']} "
        f"(values + f32 scales), bf16 {held['bf16']}, ratio {held['int8'] / held['bf16']:.4f}")

    # 11. the three serve calls (K1, K2q), then the speculative one (K3 over int8)
    backend = EngineBackend(eng_q)
    rec = decode_recorder(dec_mod)
    zero_counts(dec_mod, flash_mod)
    with rec:
        serve_three(backend, prompts, keys, prefix, greedy, sampled, "int8_cache_")
    launches = {"flash_attention": flash_mod.launches,
                "flash_attention_tc": flash_mod.tc_launches, **decode_counts(dec_mod)}
    need_launches(launches, ["flash_attention", "decode_attention_int8_cache"], "int8-cache")
    need_all_tc(launches, "int8-cache")
    need_all_tc(launches, "int8-cache", "decode_attention_int8_cache", "decode_attention_tc")
    rec_s = decode_recorder(dec_mod)
    zero_counts(dec_mod, flash_mod)
    with rec_s:
        spec_serve(eng_q, prompts, prefix, greedy, "int8_cache_shared_prefix_greedy_spec")
    spec_launches = decode_counts(dec_mod)
    need_launches(spec_launches, ["decode_attention_verify_int8_cache"],
                  "int8-cache speculative")
    need_all_tc(spec_launches, "int8-cache speculative", "decode_attention_verify_int8_cache",
                "decode_attention_verify_tc")

    # 12. both modes against their plain versions, then the bf16 end-to-end report
    k2q_rows = decode_rows(rec, "k2q", "decode_attention_int8_cache", torch, F,
                           "the newest slot masked out")
    k3q_rows = decode_rows(rec_s, "k3q", "decode_attention_verify_int8_cache", torch, F,
                           "every q_offset lowered by one")
    dec_src = K2_SOURCE
    kernels = [
        {**kernel_entry("decode_attention_int8_cache", dec_src, K2Q_REPLACES,
                        launches["decode_attention_int8_cache"], k2q_rows),
         "tc_launches": launches["decode_attention_tc"],
         "study_batch_shapes": study_batch_rows(rec, "k2q", "decode_attention_int8_cache",
                                                torch, F)},
        {**kernel_entry("decode_attention_verify_int8_cache", dec_src, K3Q_REPLACES,
                        spec_launches["decode_attention_verify_int8_cache"], k3q_rows),
         "tc_launches": spec_launches["decode_attention_verify_tc"]},
    ]
    del rec, rec_s
    spec_profile(eng_q, prompts, prefix, torch, "int8_cache_")
    teacher_forced_gate(eng_q, prompts, torch, "int8_cache_", cfg.vocab_size)
    del eng_q, backend
    return kernels


def spec_profile(engine, prompts, prefix, torch, label: str) -> None:
    """Phase 7's profile of the speculative shared-prefix greedy call:
    verify ms per step, and the device time of K3 (decode_verify_tc and its
    combine_splits) in the traced call."""
    from fairness_llm_tpu_torch.config import ModelSettings, SpeculationConfig
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend

    backend = EngineBackend(engine, speculation=SpeculationConfig(enabled=True))
    row = profiled_decode(backend, prompts, prefix,
                          ModelSettings(temperature=0.0, max_tokens=PROFILE_TOKENS), torch,
                          focus=("decode_verify_tc", "combine_splits"))
    log(f"profile_{label}spec_shared_prefix_greedy {json.dumps(row)}")


def teacher_forced_gate(engine, prompts, torch, label, vocab, f32=False):
    tf = teacher_forced_check(engine, prompts, torch)
    name = "f32_4_layers" if f32 else f"bf16_{engine.config.num_layers}_layers"
    log(f"teacher_forced_{label}{name} {json.dumps(tf)}")
    if not tf["finite"] or tf["shape"] != [5, 4, vocab]:
        fail(f"{label}kernel-path logits malformed: {tf}")
    if f32 and tf["max_abs_logit_diff"] > 1e-3 * max(1.0, tf["max_abs_logit"]):
        fail(f"{label}kernel path disagrees with the plain-version path in float32: {tf}")
    return tf


def int8_path(torch, prompts, keys, greedy, sampled):
    """Phases 14-18 on llama3-8b-int8; returns the two K4 kernel entries."""
    from fairness_llm_tpu_torch.config import ModelSettings
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend, shared_prefix_ids
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    # 14. the engine, and what it allocates against its tree
    cfg = dataclasses.replace(get_model_config(MODEL_INT8), use_decode_attention_kernel=True,
                              num_layers=CUT_LAYERS)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = DecodeEngine(cfg, seed=0)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    tree = int8_tree_bytes(cfg)
    kinds = sorted({str(p.dtype)[6:] for p in engine.model.parameters()})
    log(f"engine: {MODEL_INT8} layers={cfg.num_layers} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} params_gb={held / 1e9:.3f} tree_gb={tree / 1e9:.3f} "
        f"dtypes={kinds} init_s={time.perf_counter() - t0:.2f}")
    if held > (1 + MEM_SLACK) * tree:
        fail(f"the int8 engine holds {held / 1e9:.3f} GB, more than {1 + MEM_SLACK:.2f}x "
             f"its tree of {tree / 1e9:.3f} GB")
    backend = EngineBackend(engine)
    prefix = shared_prefix_ids(backend, prompts)
    backend.generate(prompts[:2], ModelSettings(temperature=0.0, max_tokens=2))

    # 15. the main path
    rec4, recg = k4_recorders(qm)
    zero_counts(dec_mod, flash_mod)
    qm.gemv_launches = qm.gemm_launches = qm.group_launches = 0
    torch.cuda.reset_peak_memory_stats()
    with rec4, recg:
        serve_three(backend, prompts, keys, prefix, greedy, sampled, "int8_")
    peak = torch.cuda.max_memory_allocated()
    launches = {"quant_matmul_gemv": qm.gemv_launches, "quant_matmul_gemm": qm.gemm_launches,
                "quant_matmul_group": qm.group_launches,
                "flash_attention": flash_mod.launches,
                "flash_attention_tc": flash_mod.tc_launches, "decode_attention": dec_mod.launches,
                "decode_attention_tc": dec_mod.decode_tc_launches}
    log(f"int8 launches on the main path: {json.dumps(launches)}")
    log(f"int8 serve memory: held_gb={held / 1e9:.3f} peak_allocated_gb={peak / 1e9:.3f}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the int8 main path")
    need_all_tc(launches, "int8 main")
    need_all_tc(launches, "int8 main", "decode_attention", "decode_attention_tc")
    # One kernel launch for each GEMV call.
    calls = k4_calls(rec4, recg, qm)
    gemv_calls = sum(c["n"] for c in calls if c["args"][0].shape[0] <= qm.GEMV_MAX_M)
    group_calls = sum(c["n"] for c in calls if c["group"])
    log(f"int8 K4 GEMV calls {gemv_calls} (grouped {group_calls}), kernel launches "
        f"{launches['quant_matmul_gemv']}")
    if launches["quant_matmul_gemv"] != gemv_calls or launches["quant_matmul_group"] != group_calls:
        fail(f"{gemv_calls} K4 GEMV calls ({group_calls} grouped) made "
             f"{launches['quant_matmul_gemv']} launches ({launches['quant_matmul_group']})")

    # 16. K4 against its plain version at every shape and dtype pair, and
    # the GEMV at the study's batch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = [k4_numbers(call, torch, flush) for call in calls]
    rows += k4_study_rows([c for c in calls if c["args"][0].shape[0] <= qm.GEMV_MAX_M], torch,
                          flush)
    del flush, rec4, recg, calls
    kernels = []
    for regime in ("gemv", "gemm"):
        name = f"quant_matmul_{regime}"
        mine = [r for r in rows if r["regime"] == regime]
        check_rows(name, mine, "x with its last 32 columns zeroed")
        kernels.append(kernel_entry(name, K4_SOURCE, K4_REPLACES, launches[name], mine))

    # 17. where an int8 decode call's time goes
    prof_row = profiled_decode(backend, prompts, prefix,
                               ModelSettings(temperature=0.0, max_tokens=PROFILE_TOKENS), torch,
                               focus=K2_FOCUS + K4_FOCUS)
    log(f"profile_int8_shared_prefix_greedy {json.dumps(prof_row)}")

    # 18. end-to-end check with K4 swapped for its plain version too; in
    # float32 every K4 call (two TF32 passes: gemv_stream_tf32, a grouped
    # call one launch, or tf32_gemm_kernel) is recorded, counted by the
    # kernel the C entry reports and held against its plain version: the
    # check's prefill and steps at batch 4, then a shared-prefix greedy call
    # of the 16 prompts (the prefix's prefill, the rows' suffix, steps at
    # M = 16)
    teacher_forced_gate(engine, prompts, torch, "int8_", cfg.vocab_size)
    del engine, backend
    torch.cuda.empty_cache()
    small = DecodeEngine(dataclasses.replace(cfg, num_layers=4, dtype="float32"), seed=0)
    with f32_k4_recording(qm) as (recs, counts):
        teacher_forced_gate(small, prompts, torch, "int8_", cfg.vocab_size, f32=True)
        EngineBackend(small).generate(
            prompts, ModelSettings(temperature=0.0, max_tokens=F32_K4_TOKENS), prefix_ids=prefix)
    del small
    torch.cuda.empty_cache()
    kernels.append({**kernel_entry("quant_matmul_f32", K4_SOURCE, K4_REPLACES,
                                   counts["quant_matmul_f32"],
                                   k4_f32_rows(recs, counts, torch, "float32 gate", qm)),
                    "gate_launches": counts["quant_matmul_f32"], "launches_by_kernel": counts})
    return kernels


def k4_f32_rows(recs, counts: dict, torch, path: str, qm, held=None) -> list:
    """K4's float32 route at every shape a recorded run gave
    ``quant_matmul`` and ``quant_matmul_group`` over float32 x
    (``k4_recorders``: a grouped call in the GEMV regime is one launch, past
    it one call a weight), each against its plain version at ``ATOL_K4F32``
    + ``RTOL_K4F32`` with phase 16's blind check and a repeat bit for bit.
    The recorded float32 calls must be all of the route's launches
    (``f32_k4_recording``), and every launch must be on gemv_stream_tf32 or
    tf32_gemm_kernel. With ``held`` (a set of recorder keys), a shape held
    before is skipped and the others join it."""
    rec4, recg = recs
    keyed = [(k, dict(c, group=False)) for k, c in rec4.calls.items()]
    keyed += [(k, dict(c, group=True)) for k, c in recg.calls.items()
              if c["args"][0].shape[0] <= qm.GEMV_MAX_M]
    keyed = [(k, c) for k, c in keyed if c["args"][0].dtype == torch.float32]
    if not keyed:
        fail(f"the {path} run made no K4 call over float32 x")
    made = sum(c["n"] for _, c in keyed)
    on_tf32 = counts["gemv_stream_tf32"] + counts["tf32_gemm_kernel"]
    if made != counts["quant_matmul_f32"] or on_tf32 != made:
        fail(f"the {path} run made {made} float32 K4 calls and {counts['quant_matmul_f32']} "
             f"float32 launches, {on_tf32} of them on gemv_stream_tf32 or tf32_gemm_kernel")
    if held is not None:
        keyed = [(k, c) for k, c in keyed if k not in held]
        held.update(k for k, _ in keyed)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = [dict(k4_numbers(c, torch, flush), path=path) for _, c in keyed]
    del flush
    check_rows("quant_matmul_f32", rows, "x with its last 32 columns zeroed")
    bad = [r["shape"] for r in rows if r["kernel_function"] not in ("gemv_stream_tf32",
                                                                     "tf32_gemm_kernel")]
    if bad:
        fail(f"the {path} run's float32 K4 calls at {bad} ran no TF32 kernel")
    return rows


@contextlib.contextmanager
def f32_k4_recording(qm):
    """Records every K4 call (``k4_recorders``) and counts K4's float32
    launches from 0; yields (recorders, counts), the counts filled in when
    the block ends: all of them, and those the C entry reported on each of
    the route's two kernels."""
    recs = k4_recorders(qm)
    counts = {}
    qm.f32_launches = qm.tf32_gemv_launches = qm.tf32_gemm_launches = 0
    with recs[0], recs[1]:
        yield recs, counts
    counts.update({"quant_matmul_f32": qm.f32_launches,
                   "gemv_stream_tf32": qm.tf32_gemv_launches,
                   "tf32_gemm_kernel": qm.tf32_gemm_launches})



# The phase-1 sweep (pipeline/phase1.run_phase1) on the study checkpoints:
# f32 weights at head width 32, so K1 and K2 run their f32 kernels.
STUDY_MODELS = ("tiny-llama-study", "tiny-gpt2-study")
# Phases 25(a), 26(a) and 27(a) drive their study drills (the paged sweeps,
# the contained sweeps, the overload CLI runs) on the first checkpoint only,
# to keep the script near ten minutes; phases 19-24 and 28(a) drive both.
DRILL_MODELS = STUDY_MODELS[:1]
STUDY_PROMPTS = 48  # 45 profiles and 3 neutral prompts
# A greedy row may differ between the card and the CPU only where the CPU's
# top two logits at the first divergent token are within this gap.
NEAR_TIE = 1e-4
METRIC_TOL = 1e-6
# The key of the full-width sweep's launches and kernel rows.
FULL_WIDTH = "llama3-8b-int8"


def phase1_counts(dec_mod, flash_mod, qm) -> dict:
    """Each kernels-line entry's launches since the counts were zeroed,
    counted by the CUDA kernel the entry names (KERNEL_FUNCTIONS): K1's and
    K2's tensor-core and float32 kernels apart. A phase-1 sweep runs no
    int8 cache and no verify window (it fails here if it did), so every
    decode_split_tc launch is K2's; its K4 calls take bf16 x (checked on the
    recorded calls by ``sweep_kernel_rows``), so every GEMV launch is
    gemv_stream_tc's."""
    if dec_mod.quant_launches or dec_mod.multi_launches or dec_mod.multi_quant_launches:
        fail("a phase-1 sweep launched decode attention over an int8 cache or a verify window")
    tc, f32 = one_query_counts(dec_mod)
    return {"flash_attention": flash_mod.tc_launches,
            "flash_attention_f32": flash_mod.launches - flash_mod.tc_launches,
            "decode_attention": tc, "decode_attention_f32": f32,
            "decode_attention_verify": 0, "decode_attention_int8_cache": 0,
            "decode_attention_verify_int8_cache": 0,
            "quant_matmul_gemv": qm.gemv_launches, "quant_matmul_gemm": qm.gemm_launches}


def zero_all(dec_mod, flash_mod, qm) -> None:
    zero_counts(dec_mod, flash_mod)
    qm.gemv_launches = qm.gemm_launches = qm.group_launches = 0


@contextlib.contextmanager
def sweep_recorders(dec_mod, flash_mod, qm):
    """Records every kernel wrapper call of a sweep (K1, K2, K4 single and
    grouped) as phases 3-5 and 15 record theirs."""
    recs = {"k1": flash_recorder(flash_mod), "dec": decode_recorder(dec_mod)}
    recs["k4"], recs["group"] = k4_recorders(qm)
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        yield recs


def sweep_kernel_rows(recs, torch, F, qm, path: str, f32: bool, held=None) -> dict:
    """Each kernel a sweep launched against its plain version at every
    (shape, dtype) the sweep gave its wrapper, with the blind checks of
    phases 6 and 16 (``check_rows``); keyed by kernels-line entry name.
    ``f32``: a float32 model, whose K1 and K2 rows are the f32 entries'.
    With ``held`` (a set of recorder keys), the keys end with the scoring
    flag (``flagged_recorders``): a call whose key, with or without that
    flag, is in ``held`` was held before and is skipped, the others join
    it, and each row says whether a scoring forward made its call; a kernel
    may then be left with no row. Without it, every kernel the sweep
    recorded must have one."""
    suffix = "_f32" if f32 else ""
    if held is not None:
        for r in recs.values():
            fresh = {}
            for key, call in r.calls.items():
                if key not in held and key[:-1] not in held:
                    held.add(key)
                    fresh[key] = {**call, "scoring": key[-1]}
            r.calls = fresh

    def number(name, calls, numbers, blind):
        rows = [numbers(call) for call in calls]
        if not rows and held is None:
            fail(f"{name}: no launch recorded on the {path} sweep")
        for r, call in zip(rows, calls):
            r["path"], r["scoring"] = path, call.get("scoring", False)
        check_rows(name, rows, blind)
        return rows

    rows = {
        f"flash_attention{suffix}": number(
            f"flash_attention{suffix}", list(recs["k1"].calls.values()),
            lambda call: k1_numbers(call, torch, F), "the first valid key masked out"),
        f"decode_attention{suffix}": number(
            f"decode_attention{suffix}",
            [call for key, call in recs["dec"].calls.items() if key[0] == "k2"],
            lambda call: decode_numbers(call, torch, F), "the newest slot masked out"),
    }
    calls = k4_calls(recs["k4"], recs["group"], qm)
    if any(c["args"][0].dtype != torch.bfloat16 for c in calls):
        fail(f"the {path} sweep called K4 with x not in bfloat16")
    if calls:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        for regime in ("gemv", "gemm"):
            name = f"quant_matmul_{regime}"
            mine = [c for c in calls
                    if (c["args"][0].shape[0] <= qm.GEMV_MAX_M) == (regime == "gemv")]
            rows[name] = number(name, mine, lambda call: k4_numbers(call, torch, flush),
                                "x with its last 32 columns zeroed")
        del flush
    return rows


class SweepRecorder:
    """Wraps a backend's ``generate`` for one run: each call's prompts and
    token rows, trailing pad cut (``calls``, in order), and each call's
    stats (``chunks``). An engine backend's call must be one engine call
    over its prompts; a ``ServingBackend``'s rows and stats are its
    ``last_output``'s (the server's counters; prefill and decode seconds,
    host clock, synced)."""

    def __init__(self, backend):
        self.calls, self.chunks, engine_out = [], [], []
        outer, pad = backend.generate, backend.engine.tokenizer.pad_id
        served = hasattr(backend, "serve_totals")
        if not served:
            inner = backend.engine.generate

            def engine_generate(prompts, *args, **kwargs):
                out = inner(prompts, *args, **kwargs)
                engine_out.append((list(prompts), out))
                return out

            backend.engine.generate = engine_generate

        def backend_generate(prompts, settings=None, seed=0, keys=None, prefix_ids=None):
            engine_out.clear()
            texts = outer(prompts, settings, seed=seed, keys=keys, prefix_ids=prefix_ids)
            if served:
                out = backend.last_output
                st, sv = out.stats, out.stats["serving"]
                self.chunks.append({
                    "cache_slots": st["cache_slots"], "prefill_s": st["prefill_s"],
                    "decode_s": st["decode_s"], "prefill_batches": sv["prefill_batches"],
                    "decode_steps": sv["decode_steps"], "decoded_tokens": sv["decoded_tokens"],
                    "avg_occupancy": sv["avg_occupancy"],
                    "loop_iterations": sv["loop_iterations"],
                    "decode_ms_per_step": st["decode_s"] * 1e3 / max(sv["decode_steps"], 1)})
            else:
                if len(engine_out) != 1 or engine_out[0][0] != list(prompts):
                    fail("a chunk was not one engine call over its prompts")
                out = engine_out.pop()[1]
                st = backend.last_stats
                self.chunks.append({
                    "batch": st["batch"], "prompt_len": st["prompt_len"],
                    "prefix_len": st["prefix_len"], "prefix_s": st["prefix_s"],
                    "prefill_s": st["prefill_s"], "decode_steps": st["decode_steps"],
                    "decode_ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
                    "decoded_tokens": st["decoded_tokens"]})
            self.calls.append((list(prompts), [_strip(row, pad) for row in out.tokens]))
            return texts

        backend.generate = backend_generate

    def served_totals(self) -> dict:
        """A ``ServingBackend`` run's seconds, steps and tokens, summed."""
        decode_s = sum(c["decode_s"] for c in self.chunks)
        steps = sum(c["decode_steps"] for c in self.chunks)
        tokens = sum(c["decoded_tokens"] for c in self.chunks)
        return {"prefill_s": sum(c["prefill_s"] for c in self.chunks), "decode_s": decode_s,
                "decode_ms_per_step": decode_s * 1e3 / max(steps, 1),
                "tokens_per_s": tokens / max(decode_s, 1e-9),
                "prefill_batches": sum(c["prefill_batches"] for c in self.chunks),
                "decode_steps": steps, "decoded_tokens": tokens}


def _strip(row, pad: int) -> list:
    """A token row without its trailing pad (a server's rows end at their
    EOS or budget, an engine's run on in pad)."""
    row = [int(t) for t in row]
    while row and row[-1] == pad:
        row.pop()
    return row


def metric_leaves(node, path="metrics"):
    """(path, number) for every number under a record's metrics."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from metric_leaves(v, f"{path}.{k}")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from metric_leaves(v, f"{path}[{i}]")
    elif isinstance(node, (int, float)) and not isinstance(node, bool):
        yield path, float(node)


def check_record(rec, label: str, want_non_empty: bool = True,
                 prompts: int = STUDY_PROMPTS) -> dict:
    """The gates every phase-1 record passes: one response a prompt, no
    error entry, finite metrics; returns its parse counts."""
    entries = rec["recommendations"]
    n = len(entries) + len(rec["neutral_recommendations"])
    if n != prompts:
        fail(f"{label}: {n} responses for {prompts} prompts")
    bad = [k for k, e in entries.items() if "error" in e]
    if bad:
        fail(f"{label}: error entries for {bad}")
    for path, value in metric_leaves(rec["metrics"]):
        if not math.isfinite(value):
            fail(f"{label}: {path} is {value}")
    parsed = [len(e["recommendations"]) for e in entries.values()]
    if want_non_empty and not any(parsed):
        fail(f"{label}: every profile's recommendation list is empty")
    return {"profiles_with_titles": sum(1 for x in parsed if x), "titles": sum(parsed),
            "neutral_titles": sum(len(r) for r in rec["neutral_recommendations"])}


def saved_record_check(config, rec, label: str, phase: int = 1,
                       key: str = "recommendations") -> None:
    """The phase's record on disk reads back (``key`` of it equal to the
    run's) and its manifest entry verifies."""
    from fairness_llm_tpu_torch.integrity.manifest import verify_manifest_entry
    from fairness_llm_tpu_torch.pipeline.results import load_results

    d = pathlib.Path(config.results_dir) / f"phase{phase}"
    fname = f"phase{phase}_results.json"
    saved = load_results(str(d / fname))
    if saved is None or saved[key] != json.loads(json.dumps(rec[key])):
        fail(f"{label}: the saved record does not read back")
    if not verify_manifest_entry(str(d), fname):
        fail(f"{label}: the saved record does not match its manifest entry")


def greedy_config(base, name: str, tokens: int):
    from fairness_llm_tpu_torch.config import ModelSettings

    settings = tuple((n, ModelSettings(temperature=0.0, max_tokens=tokens) if n == name else s)
                     for n, s in base.model_settings)
    return dataclasses.replace(base, model_settings=settings)


def top2_gap(engine, prompt: str, tokens, torch) -> tuple:
    """The gap between the two largest logits after ``prompt`` and
    ``tokens``, teacher-forced through a plain forward of ``engine``, and
    the largest logit."""
    ids = engine.tokenizer.encode(prompt) + list(tokens)
    logits, _ = engine.model(torch.tensor([ids], device=engine.device),
                             torch.arange(len(ids), device=engine.device)[None])
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1]), float(top[0])


def greedy_divergences(label: str, want, got, engine, torch, against: str = "the CPU",
                       tie=lambda top: NEAR_TIE) -> list:
    """Every greedy call's token rows in ``got`` against ``want``'s
    (``SweepRecorder``s, or anything with their ``calls``), row by row. A
    row may differ only where ``engine``'s top two logits at the first
    divergent token (or, where one row is a prefix of the other, at the
    shorter's end) are within ``tie`` of the larger (NEAR_TIE by default);
    returns such rows by (call, row)."""
    if [c[0] for c in want.calls] != [c[0] for c in got.calls]:
        fail(f"{label} greedy: {against} and the run held against it decoded other prompts")
    differ = []
    for ci, ((prompts, want_rows), (_, got_rows)) in enumerate(zip(want.calls, got.calls)):
        for ri, (prompt, w, g) in enumerate(zip(prompts, want_rows, got_rows)):
            if w == g:
                continue
            t = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), min(len(w), len(g)))
            gap, top = top2_gap(engine, prompt, w[:t], torch)
            differ.append({"call": ci, "row": ri, "token": t, "top2_gap": gap, "top": top,
                           "allowed": tie(top)})
            if gap >= tie(top):
                fail(f"{label} greedy: call {ci} row {ri} differs from {against} at token {t}, "
                     f"where the top two logits are {gap:.3e} apart (more than "
                     f"{tie(top):.3e})")
    return differ


def study_sweep(torch, F, name: str, tmp: pathlib.Path):
    """Phases 19-20 for one study checkpoint; returns its log row (with,
    under "greedy_card", the card's greedy record and engine calls, which
    phase 24 reads and the log leaves out), the f32 K1 and K2 rows at the
    t=0.7 sweep's shapes, the t=0.7 record, and the keys of the kernel
    calls it held."""
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.integrity.manifest import maybe_verify_manifest
    from fairness_llm_tpu_torch.models.tokenizer import HFTokenizer
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    if not maybe_verify_manifest(str(ROOT / "checkpoints" / name), kind="weights"):
        fail(f"{name}: the checkpoint has no manifest to verify")
    row = {"model": name}
    # 19. the study's own settings (t=0.7, 64 tokens, chunks of 16)
    cfg = Config(weights_dir=str(ROOT / "checkpoints"), data_dir=str(ROOT / "data" / "ml-1m"),
                 results_dir=str(tmp / name / "run"))
    zero_all(dec_mod, flash_mod, qm)
    t0 = time.perf_counter()
    backend = backend_for(name, cfg)
    if not isinstance(backend.engine.tokenizer, HFTokenizer):
        fail(f"{name}: the backend decodes with {type(backend.engine.tokenizer).__name__}")
    sweep = SweepRecorder(backend)
    with sweep_recorders(dec_mod, flash_mod, qm) as recs:
        rec = run_phase1(cfg, name, backend=backend)
    torch.cuda.synchronize()
    row["wall_s"] = time.perf_counter() - t0
    launches = phase1_counts(dec_mod, flash_mod, qm)
    row["launches"] = launches
    for kernel in ("flash_attention", "decode_attention"):
        f32 = f"{kernel}_f32"
        if launches[f32] <= 0:
            fail(f"{name}: {kernel}'s f32 kernel ({KERNEL_FUNCTIONS[f32]}) was not launched "
                 f"by the sweep")
        if launches[kernel]:
            fail(f"{name}: {launches[kernel]} {kernel} launches of the f32 model ran on "
                 f"{KERNEL_FUNCTIONS[kernel]}")
    row["parsed"] = check_record(rec, f"{name} t=0.7")
    row["chunks"] = sweep.chunks
    saved_record_check(cfg, rec, name)
    kernel_rows = sweep_kernel_rows(recs, torch, F, qm, "phase1_study", f32=True)
    held = {key for r in recs.values() for key in r.calls}
    del recs
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, results_dir=str(tmp / name / "again"))
    again = run_phase1(cfg2, name, backend=backend_for(name, cfg2), save=False)
    row["repeat_wall_s"] = time.perf_counter() - t0
    raw = {k: e["raw_response"] for k, e in rec["recommendations"].items()}
    if raw != {k: e["raw_response"] for k, e in again["recommendations"].items()} or \
            rec["neutral_recommendations"] != again["neutral_recommendations"]:
        fail(f"{name}: a second run with the same seed gave other responses")

    # 20. greedy, on the card and on the CPU (the kernels' plain versions)
    gcfg = greedy_config(dataclasses.replace(cfg, results_dir=str(tmp / name / "greedy")),
                         name, MAX_TOKENS)
    sweeps = {}
    for device in ("cuda", "cpu"):
        b = backend_for(name, gcfg, device=device)
        calls = SweepRecorder(b)
        t0 = time.perf_counter()
        r = run_phase1(gcfg, name, backend=b, save=False)
        row[f"greedy_{device}_wall_s"] = time.perf_counter() - t0
        check_record(r, f"{name} greedy {device}", want_non_empty=False)
        sweeps[device] = (b, calls, r)
    (_, card_calls, card), (cpu_b, cpu_calls, cpu) = sweeps["cuda"], sweeps["cpu"]
    differ = greedy_divergences(name, cpu_calls, card_calls, cpu_b.engine, torch)
    row["greedy_card"] = (card, card_calls)
    if not differ and (card["recommendations"] != cpu["recommendations"]
                       or card["neutral_recommendations"] != cpu["neutral_recommendations"]):
        fail(f"{name} greedy: equal tokens but other responses on the card and the CPU")
    row["greedy_rows_differing"] = differ
    row["greedy_parsed"] = check_record(card, f"{name} greedy", want_non_empty=False)
    if not differ:
        for (path, a), (_, b) in zip(metric_leaves(card["metrics"]),
                                     metric_leaves(cpu["metrics"])):
            if abs(a - b) > METRIC_TOL:
                fail(f"{name} greedy: {path} is {a} on the card, {b} on the CPU")
    row["metrics"] = {k: v.get("score", v.get("snsr")) for k, v in rec["metrics"].items()}
    return row, kernel_rows, rec, held


def phase1_path(torch, F, device_line: str) -> dict:
    """Phases 19-21: the phase-1 sweep on both study checkpoints, then at the
    full width of llama3-8b with int8 weights. Returns, for the two study
    sweeps together ("study") and the full-width one (FULL_WIDTH), each
    kernels-line entry's launches ("launches") and its rows at the sweep's
    shapes ("rows"); each sweep's t=0.7 record ("records", by model), the
    keys of the kernel calls the three sweeps recorded and held ("held"),
    each study model's greedy record and engine calls on the card
    ("greedy_card") and the full-width sweep's wall seconds."""
    import tempfile

    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    study_launches, study_rows, records, held, greedy_card = {}, {}, {}, set(), {}
    greedy_walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in STUDY_MODELS:
            row, rows, records[name], keys = study_sweep(torch, F, name, pathlib.Path(tmp))
            held |= keys
            greedy_card[name] = row.pop("greedy_card")
            greedy_walls[name] = row["greedy_cuda_wall_s"]
            for k, v in row["launches"].items():
                study_launches[k] = study_launches.get(k, 0) + v
            for k, v in rows.items():
                study_rows.setdefault(k, []).extend(v)
            log(f"phase1_study {json.dumps({'device': device_line, **row})}")

        # 21. the default sweep (45 profiles and 3 neutral prompts in three
        # chunks of 16, t=0.7, the sweep-wide shared prefix) at full width
        # and depth, random int8 weights from the seed and the byte tokenizer
        cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                     data_dir=str(ROOT / "data" / "ml-1m"),
                     results_dir=str(pathlib.Path(tmp) / "llama3-8b"))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_all(dec_mod, flash_mod, qm)
        t0 = time.perf_counter()
        with cut_depth(MODEL, CUT_LAYERS):
            backend = backend_for(MODEL, cfg, allow_random=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sweep = SweepRecorder(backend)
        with sweep_recorders(dec_mod, flash_mod, qm) as recs, CardSampler() as card:
            rec = run_phase1(cfg, MODEL, backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = phase1_counts(dec_mod, flash_mod, qm)
        if backend.engine.config.weight_quant != "int8" or \
                rec["metadata"]["weight_quant"] != "int8":
            fail("the full-width sweep did not serve int8 weights")
        for name in ("flash_attention", "decode_attention", "quant_matmul_gemv",
                     "quant_matmul_gemm"):
            if launches[name] <= 0:
                fail(f"{name} ({KERNEL_FUNCTIONS[name]}) was not launched by the full-width "
                     f"sweep")
        for name in ("flash_attention_f32", "decode_attention_f32"):
            if launches[name]:
                fail(f"the full-width bf16 sweep launched {KERNEL_FUNCTIONS[name]} "
                     f"{launches[name]} times")
        # random weights: parses may be empty, so they are reported, not gated
        parsed = check_record(rec, "llama3-8b int8 sweep", want_non_empty=False)
        saved_record_check(cfg, rec, "llama3-8b int8 sweep")
        row = {"model": MODEL, "weight_quant": "int8", "device": device_line,
               "wall_s": wall, "engine_init_s": init_s, "chunks": sweep.chunks,
               "peak_allocated_gb": peak / 1e9,
               "launches": launches, "parsed_vacuous_random_weights": parsed,
               "metrics_vacuous_random_weights": {
                   k: v.get("score", v.get("snsr")) for k, v in rec["metrics"].items()},
               "card": card.summary}
        log(f"phase1_full_width {json.dumps(row)}")
        full_rows = sweep_kernel_rows(recs, torch, F, qm, "phase1_full_width", f32=False)
        held |= {key for r in recs.values() for key in r.calls}
        records[FULL_WIDTH] = rec
        del backend, recs
        torch.cuda.empty_cache()
    return {"launches": {"study": study_launches, FULL_WIDTH: launches},
            "rows": {"study": study_rows, FULL_WIDTH: full_rows},
            "records": records, "held": held, "greedy_card": greedy_card,
            "greedy_walls": greedy_walls, "full_width_wall_s": wall}


# Phases 2 and 3 of the study (pipeline/phase2.run_phase2 and
# phase3.run_phase3, the user's entry points) at the study's settings: the
# synthetic corpus of 20 items, one listwise query and 30 comparisons; phase
# 3 conformal with model-conditional calibration, over phase 19's (and 21's)
# t=0.7 records. They run the decode path of phase 1 and the scoring forward
# (runtime/scoring._forward: whole left-padded rows, full logits).
P2_ITEMS, P2_COMPARISONS = 20, 30
CALIBRATION = "model-conditional"
# Card against CPU, as the CPU tests hold the port to the reference: scored
# rankings and kept lists may differ only inside near ties of the scores;
# log-likelihoods to 1e-5 + 1e-5 * |value|, mean log-probabilities to 1e-5;
# perplexity to 1e-5 relative; the
# bias-reduction percentage divides a 1e-6 parity difference by a bias of
# about 0.25 and is held to 1e-3.
SCORE_NEAR_TIE = 1e-5
SCORE_LL_RTOL, SCORE_ATOL = 1e-5, 1e-5
RATE_TOL = 1e-3
class ScoringRecorder:
    """Wraps ``runtime.scoring._forward``: counts the forwards, their real
    and bucketed rows and shapes, and their seconds (host clock, synced);
    ``on`` is True while one runs."""

    def __init__(self):
        self.on = False

    def __enter__(self):
        import torch
        from fairness_llm_tpu_torch.runtime import scoring as sc

        self.mod, self.inner = sc, sc._forward
        self.forwards, self.rows, self.batch_rows, self.seconds, self.shapes = 0, 0, 0, 0.0, {}

        def wrapped(engine, tokens, valid, prefixes):
            self.on = True
            t0 = time.perf_counter()
            try:
                out = self.inner(engine, tokens, valid, prefixes)
                if tokens.is_cuda:
                    torch.cuda.synchronize()
            finally:
                self.on = False
            self.seconds += time.perf_counter() - t0
            self.forwards += 1
            self.rows += int(valid.any(1).sum())
            self.batch_rows += tokens.shape[0]
            key = "x".join(str(d) for d in tokens.shape)
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return out

        sc._forward = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._forward = self.inner

    def summary(self) -> dict:
        return {"forwards": self.forwards, "rows": self.rows, "batch_rows": self.batch_rows,
                "seconds": self.seconds, "rows_per_s": self.rows / max(self.seconds, 1e-9),
                "shapes": self.shapes}


@contextlib.contextmanager
def flagged_recorders(dec_mod, flash_mod, qm, scoring: ScoringRecorder):
    """``sweep_recorders`` whose keys end with whether a scoring forward made
    the call."""
    with sweep_recorders(dec_mod, flash_mod, qm) as recs:
        for r in recs.values():
            r.key_fn = (lambda f: lambda *a, **k: f(*a, **k) + (scoring.on,))(r.key_fn)
        yield recs


class CalibrationRows:
    """Wraps ``runtime.scoring.score_prompted_continuations``: the rows of
    each call (prompts, continuations) and their scores. With ``replay``
    (ScoreOutputs, one a call), each call returns the next of them, of as
    many rows, instead of scoring."""

    def __init__(self, replay=None):
        self.replay = None if replay is None else list(replay)

    def __enter__(self):
        from fairness_llm_tpu_torch.runtime import scoring as sc

        self.mod, self.inner, self.calls = sc, sc.score_prompted_continuations, []

        def wrapped(engine, prompts, continuations):
            if self.replay is None:
                out = self.inner(engine, prompts, continuations)
            else:
                out = self.replay.pop(0)
                if len(out.token_counts) != len(prompts):
                    fail("a replayed calibration call has other rows")
            self.calls.append((list(prompts), list(continuations), out))
            return out

        sc.score_prompted_continuations = wrapped
        return self

    def __exit__(self, *exc):
        self.mod.score_prompted_continuations = self.inner


def same_tree(a, b, label: str, path: str = "", tol: float = METRIC_TOL) -> None:
    """Equal structure and values, floats within ``tol``; fails otherwise."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or sorted(a) != sorted(b):
            fail(f"{label}: {path} has other keys on the card and the CPU")
        for k in b:
            same_tree(a[k], b[k], label, f"{path}.{k}", tol)
    elif isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            fail(f"{label}: {path} differs in length on the card and the CPU")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, label, f"{path}[{i}]", tol)
    elif isinstance(b, float):
        if not (math.isnan(a) and math.isnan(b)) and abs(a - b) > tol:
            fail(f"{label}: {path} is {a} on the card, {b} on the CPU")
    elif a != b:
        fail(f"{label}: {path} is {a!r} on the card, {b!r} on the CPU")


def scores_agree(got, want, label: str) -> dict:
    """Two ScoreOutputs of the same rows within the CPU tests' tolerances:
    equal token counts, log-likelihoods within 1e-5 + 1e-5 * |CPU's|, mean
    log-probabilities within 1e-5."""
    import numpy as np

    if list(got.token_counts) != list(want.token_counts):
        fail(f"{label}: scored token counts differ on the card and the CPU")
    ll_err = np.abs(got.log_likelihoods - want.log_likelihoods)
    ratio = float(np.max(ll_err / (SCORE_ATOL + SCORE_LL_RTOL * np.abs(want.log_likelihoods)),
                         initial=0.0))
    mean = float(np.max(np.abs(got.mean_logprobs - want.mean_logprobs), initial=0.0))
    if ratio > 1 or mean > SCORE_ATOL:
        fail(f"{label}: log-likelihoods {ratio:.2f}x their tolerance, mean log-probabilities "
             f"{mean:.2e} apart (tolerance {SCORE_ATOL})")
    return {"rows": len(want.token_counts), "ll_max_abs_err": float(np.max(ll_err, initial=0.0)),
            "ll_err_over_tol": ratio, "mean_max_abs_err": mean}


def far_inversions(got, want) -> int:
    """The pairs of rows that ``got``'s scores rank otherwise than
    ``want``'s (stable ranks, as the percentile confidence takes them)
    though ``want``'s two scores lie more than SCORE_NEAR_TIE apart."""
    import numpy as np

    def ranks(v):
        return np.argsort(np.argsort(np.asarray(v, np.float64), kind="stable"), kind="stable")

    rg, rw, w = ranks(got), ranks(want), np.asarray(want, np.float64)
    flipped = (rg[:, None] < rg[None, :]) != (rw[:, None] < rw[None, :])
    return int(np.sum(flipped & (np.abs(w[:, None] - w[None, :]) > SCORE_NEAR_TIE))) // 2


def phase2_agree(name: str, card, cpu, cpu_engine) -> None:
    """Greedy phase-2 records of the card and the CPU (equal decodes): the
    listwise and pairwise results and parse counts equal (floats to 1e-6),
    perplexity to 1e-5 relative, the scored ranking equal up to near ties
    (one listwise query: the default one)."""
    from fairness_llm_tpu_torch.pipeline.phase2 import scored_ranking_prompt
    from fairness_llm_tpu_torch.runtime.scoring import score_continuations

    g, w = card["model_results"][name], cpu["model_results"][name]
    for key in ("listwise", "pairwise", "parse_failures"):
        same_tree(g[key], w[key], f"{name} phase 2 {key}", key)
    if abs(g["corpus_perplexity"] - w["corpus_perplexity"]) > \
            SCORE_LL_RTOL * abs(w["corpus_perplexity"]):
        fail(f"{name} phase 2: perplexity {g['corpus_perplexity']} on the card, "
             f"{w['corpus_perplexity']} on the CPU")
    if g["scored"]["ranking"] != w["scored"]["ranking"]:
        items = cpu["items"]
        sc = score_continuations(cpu_engine, scored_ranking_prompt(None),
                                 [it["text"] for it in items])
        score_of = dict(zip((it["id"] for it in items), sc.mean_logprobs))
        for a, b in zip(g["scored"]["ranking"], w["scored"]["ranking"]):
            if abs(score_of[a] - score_of[b]) > SCORE_NEAR_TIE:
                fail(f"{name} phase 2: the scored rankings differ outside a near tie "
                     f"({a} against {b})")


def phase3_agree(name: str, card, cpu, card_rows, cpu_rows, rerun) -> dict:
    """Greedy phase-3 records of the card and the CPU (equal decodes): the
    same calibration rows, scored within tolerance; the same kept lists, or
    lists that a reordering of near-tied scores explains: the card ranks no
    two rows otherwise than the CPU unless the CPU's scores of the two lie
    within SCORE_NEAR_TIE, and ``rerun`` (the CPU's phase 3 given the
    card's scores) keeps the card's lists. With equal lists, the measures
    within 1e-6 (the rate within 1e-3)."""
    if [c[:2] for c in card_rows.calls] != [c[:2] for c in cpu_rows.calls]:
        fail(f"{name} phase 3: the card and the CPU scored other calibration rows")
    errs = [scores_agree(a[2], b[2], f"{name} phase 3 calibration")
            for a, b in zip(card_rows.calls, cpu_rows.calls)]
    if card["mitigated_recommendations"] != cpu["mitigated_recommendations"]:
        far = sum(far_inversions(a[2].mean_logprobs, b[2].mean_logprobs)
                  for a, b in zip(card_rows.calls, cpu_rows.calls))
        if far:
            fail(f"{name} phase 3: the kept lists differ, and the card ranks {far} pairs of "
                 f"calibration rows otherwise than the CPU outside a near tie")
        again = rerun([c[2] for c in card_rows.calls])
        if again["mitigated_recommendations"] != card["mitigated_recommendations"]:
            fail(f"{name} phase 3: the CPU's phase 3 on the card's scores keeps other lists "
                 f"than the card's")
        return {"lists_equal": False, "scores": errs}
    for part in ("bias_reduction", "quality_preservation"):
        a, b = dict(card[part]), dict(cpu[part])
        ra, rb = a.pop("bias_reduction_rate", 0.0), b.pop("bias_reduction_rate", 0.0)
        if abs(ra - rb) > RATE_TOL:
            fail(f"{name} phase 3: bias reduction {ra} on the card, {rb} on the CPU")
        same_tree(a, b, f"{name} phase 3 {part}", part)
    same_tree(card["blended_fairness"], cpu["blended_fairness"], f"{name} phase 3", "blended")
    return {"lists_equal": True, "scores": errs}


def p23_record_check(config, rec, label: str, phase: int) -> None:
    """No error entry, finite measures, the saved record read back and its
    manifest entry verified."""
    if phase == 2:
        body, key = rec["model_results"], "comparison"
        measures = [rec["comparison"], rec["model_results"]]
    else:
        body, key = rec["mitigated_recommendations"], "mitigated_recommendations"
        measures = [rec["bias_reduction"], rec["quality_preservation"], rec["blended_fairness"]]
    if any(isinstance(v, dict) and "error" in v for v in body.values()):
        fail(f"{label}: an error entry in the record")
    for path, value in metric_leaves(measures, f"phase{phase}"):
        if not math.isfinite(value):
            fail(f"{label}: {path} is {value}")
    saved_record_check(config, rec, label, phase, key)


def need_kernels(launches: dict, label: str, f32: bool) -> None:
    """K1's and K2's kernels of the model's type launched, and the other
    type's not (a float32 model on flash_fwd and decode_split_f32, a bf16 one on
    flash_fwd_tc and decode_split_tc)."""
    for kernel in ("flash_attention", "decode_attention"):
        want, other = (f"{kernel}_f32", kernel) if f32 else (kernel, f"{kernel}_f32")
        if launches[want] <= 0:
            fail(f"{label}: {KERNEL_FUNCTIONS[want]} was not launched")
        if launches[other]:
            fail(f"{label}: {launches[other]} launches of {KERNEL_FUNCTIONS[other]}")


def timed_phase(torch, dec_mod, flash_mod, qm, fn):
    """Runs ``fn`` with the counts zeroed, every kernel wrapper call and
    every scoring forward recorded, and the peak memory reset; returns (its
    result, the log row, the recorders). The row's peak is the allocator's,
    beside what was allocated when it started (``held_before_gb``: engines
    of earlier phases that only a garbage collection frees are collected
    first)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    zero_all(dec_mod, flash_mod, qm)
    t0 = time.perf_counter()
    with ScoringRecorder() as scoring, flagged_recorders(dec_mod, flash_mod, qm, scoring) as recs:
        out = fn()
    torch.cuda.synchronize()
    row = {"wall_s": time.perf_counter() - t0, "launches": phase1_counts(dec_mod, flash_mod, qm),
           "scoring": scoring.summary(),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held_before_gb": held / 1e9}
    return out, row, recs


def study_phases23(torch, F, name: str, tmp: pathlib.Path, p1_record, held):
    """Phase 22 for one study checkpoint; returns its log row (with each
    phase's launches), the rows of every kernel call whose key is not in
    ``held`` (which they join), by kernels-line entry, and the t=0.7 phase
    3's calibration rows."""
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase2 import run_phase2
    from fairness_llm_tpu_torch.pipeline.phase3 import run_phase3
    from fairness_llm_tpu_torch.runtime.scoring import score_prompted_continuations

    cfg = Config(weights_dir=str(ROOT / "checkpoints"), data_dir=str(ROOT / "data" / "ml-1m"),
                 results_dir=str(tmp / name / "run"))
    row = {"model": name}
    # at the study's own settings (t=0.7, 64 tokens), through backend_for
    p2, row["phase2"], recs2 = timed_phase(
        torch, dec_mod, flash_mod, qm,
        lambda: run_phase2(cfg, models=[name], num_items=P2_ITEMS,
                           num_comparisons=P2_COMPARISONS))
    with CalibrationRows() as rows3:
        p3, row["phase3"], recs3 = timed_phase(
            torch, dec_mod, flash_mod, qm,
            lambda: run_phase3(cfg, phase1_results=p1_record, model_name=name,
                               calibration=CALIBRATION))
    for phase in ("phase2", "phase3"):
        need_kernels(row[phase]["launches"], f"{name} {phase}", f32=True)
        if row[phase]["scoring"]["forwards"] <= 0:
            fail(f"{name} {phase}: no scoring forward ran")
    p23_record_check(cfg, p2, f"{name} phase 2", 2)
    p23_record_check(cfg, p3, f"{name} phase 3", 3)
    res = p2["model_results"][name]
    row["phase2_results"] = {"exposure": {m: res[m]["exposure_ratio"]
                                          for m in ("listwise", "pairwise", "scored")},
                             "corpus_perplexity": res["corpus_perplexity"],
                             "parse_failures": res["parse_failures"]}
    row["phase3_results"] = {"bias_reduction": p3["bias_reduction"],
                             "quality_preservation": p3["quality_preservation"],
                             "blended_fairness": p3["blended_fairness"],
                             "kept_titles": sum(len(v) for v in
                                                p3["mitigated_recommendations"].values())}
    if not rows3.calls or not rows3.calls[0][0]:
        fail(f"{name} phase 3: the calibration scored no row")
    calibration = rows3.calls[0][:2]
    row["phase3_calibration_rows"] = len(calibration[0])
    # every (shape, dtype) the earlier phases did not hold, the scoring
    # forward's and the decodes' alike
    kernel_rows = {}
    for recs, path in ((recs2, "phase2_study"), (recs3, "phase3_study")):
        for k, v in sweep_kernel_rows(recs, torch, F, qm, path, f32=True, held=held).items():
            kernel_rows.setdefault(k, []).extend(v)
    del recs2, recs3

    # greedy, on the card and on the CPU (the kernels' plain versions)
    gcfg = greedy_config(dataclasses.replace(cfg, results_dir=str(tmp / name / "greedy")),
                         name, MAX_TOKENS)

    def phase3(b, replay=None):
        with CalibrationRows(replay) as crows:
            r3 = run_phase3(gcfg, phase1_results=p1_record, model_name=name,
                            calibration=CALIBRATION, backend=b, save=False)
        return r3, crows

    runs = {}
    for device in ("cuda", "cpu"):
        b = backend_for(name, gcfg, device=device)
        calls = SweepRecorder(b)
        t0 = time.perf_counter()
        r2 = run_phase2(gcfg, models=[name], num_items=P2_ITEMS,
                        num_comparisons=P2_COMPARISONS, backends={name: b}, save=False)
        r3, crows = phase3(b)
        row[f"greedy_{device}_wall_s"] = time.perf_counter() - t0
        runs[device] = (b, calls, r2, r3, crows)
    (cb, ccalls, c2, c3, crows), (pb, pcalls, g2, g3, grows) = runs["cuda"], runs["cpu"]
    differ = greedy_divergences(name, pcalls, ccalls, pb.engine, torch)
    row["greedy_rows_differing"] = differ
    if not differ:
        phase2_agree(name, c2, g2, pb.engine)
        row["greedy_phase3"] = phase3_agree(name, c3, g3, crows, grows,
                                            lambda scores: phase3(pb, scores)[0])
    # the t=0.7 run's calibration rows, scored on the card and on the CPU
    row["calibration_scores"] = scores_agree(
        score_prompted_continuations(cb.engine, *calibration),
        score_prompted_continuations(pb.engine, *calibration), f"{name} calibration rows")
    return row, kernel_rows, calibration


def full_width_phases23(torch, F, tmp: pathlib.Path, p1_record, calibration, held) -> dict:
    """Phase 23: phases 2 and 3 on llama3-8b with int8 weights (random, from
    the seed; byte tokenizer), then the scoring forward over the study's
    phase-3 calibration rows. Returns each phase's launches and the rows of
    every kernel call whose key is not in ``held`` (which they join), by
    kernels-line entry."""
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase2 import run_phase2
    from fairness_llm_tpu_torch.pipeline.phase3 import run_phase3
    from fairness_llm_tpu_torch.runtime.scoring import score_prompted_continuations

    cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                 data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / "llama3-8b"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with cut_depth(MODEL, CUT_LAYERS):  # as phase 21's sweep, whose record phase 3 reads
        backend = backend_for(MODEL, cfg, allow_random=True)
    torch.cuda.synchronize()
    row = {"model": MODEL, "weight_quant": "int8", "layers": backend.engine.config.num_layers,
           "engine_init_s": time.perf_counter() - t0}
    phases = {}
    p2, row["phase2"], phases["phase2"] = timed_phase(
        torch, dec_mod, flash_mod, qm,
        lambda: run_phase2(cfg, models=[MODEL], num_items=P2_ITEMS,
                           num_comparisons=P2_COMPARISONS, backends={MODEL: backend}))
    p3, row["phase3"], phases["phase3"] = timed_phase(
        torch, dec_mod, flash_mod, qm,
        lambda: run_phase3(cfg, phase1_results=p1_record, model_name=MODEL,
                           calibration=CALIBRATION, backend=backend))
    # Random weights name no title, so run_phase3's calibration scores no
    # row: score the rows the study checkpoint's phase-3 run scored, through
    # the same engine and the same entry point.
    sc, row["phase3_scoring"], phases["phase3_scoring"] = timed_phase(
        torch, dec_mod, flash_mod, qm,
        lambda: score_prompted_continuations(backend.engine, *calibration))
    if backend.engine.config.weight_quant != "int8":
        fail("the full-width phases did not serve int8 weights")
    p23_record_check(cfg, p2, "llama3-8b int8 phase 2", 2)
    p23_record_check(cfg, p3, "llama3-8b int8 phase 3", 3)
    import numpy as np

    if not np.isfinite(sc.log_likelihoods).all() or \
            list(sc.token_counts) == [0] * len(sc.token_counts):
        fail(f"the full-width scoring of the calibration rows is malformed: {sc}")
    for phase in ("phase2", "phase3"):
        need_kernels(row[phase]["launches"], f"llama3-8b int8 {phase}", f32=False)
    for phase in ("phase2", "phase3_scoring"):
        if row[phase]["scoring"]["forwards"] <= 0:
            fail(f"llama3-8b int8 {phase}: no scoring forward ran")
    for kernel in ("quant_matmul_gemv", "quant_matmul_gemm"):
        if row["phase2"]["launches"][kernel] + row["phase3"]["launches"][kernel] <= 0:
            fail(f"{kernel} was not launched by the full-width phases 2 and 3")
    res = p2["model_results"][MODEL]
    row["phase2_results_vacuous_random_weights"] = {
        "exposure": {m: res[m]["exposure_ratio"] for m in ("listwise", "pairwise", "scored")},
        "corpus_perplexity": res["corpus_perplexity"]}
    row["phase3_scoring_rows"] = len(calibration[0])
    log(f"phase23_full_width {json.dumps(row)}")

    # Every new (shape, dtype): the lm_head's K4 GEMM with an f32 output at
    # the scoring forward's M must be among them.
    head = tuple(backend.engine.model.lm_head.kernel_q.shape)
    rows = {}
    for path, recs in phases.items():
        for k, v in sweep_kernel_rows(recs, torch, F, qm, f"{path}_full_width", f32=False,
                                      held=held).items():
            rows.setdefault(k, []).extend(v)
    if not any(r["scoring"] and (r["shape"]["K"], r["shape"]["N"]) == head
               and r["shape"]["out"] == "float32" for r in rows.get("quant_matmul_gemm", [])):
        fail("the lm_head's K4 GEMM with an f32 output was not called by a scoring forward")
    del backend, phases
    torch.cuda.empty_cache()
    return {"launches": {k: row[k]["launches"] for k in ("phase2", "phase3", "phase3_scoring")},
            "rows": rows}


def phase23_path(torch, F, device_line: str, records: dict, held) -> dict:
    """Phases 22-23. Returns each kernels-line entry's launches on phase 2
    and on phase 3 (study sweeps together, "study"; the full-width ones,
    FULL_WIDTH), and the rows of every kernel call whose key is not in
    ``held`` (phases 19-21's), by entry."""
    import tempfile

    launches = {"phase2": {"study": {}}, "phase3": {"study": {}}}
    kernel_rows = {}
    calibration = None
    with tempfile.TemporaryDirectory() as tmp:
        for name in STUDY_MODELS:
            row, rows, cal = study_phases23(torch, F, name, pathlib.Path(tmp), records[name],
                                            held)
            calibration = calibration or cal
            for k, v in rows.items():
                kernel_rows.setdefault(k, []).extend(v)
            for phase in ("phase2", "phase3"):
                for k, v in row[phase]["launches"].items():
                    launches[phase]["study"][k] = launches[phase]["study"].get(k, 0) + v
            log(f"phase23_study {json.dumps({'device': device_line, **row})}")
        full = full_width_phases23(torch, F, pathlib.Path(tmp), records[FULL_WIDTH],
                                   calibration, held)
    launches["phase2"][FULL_WIDTH] = full["launches"]["phase2"]
    launches["phase3"][FULL_WIDTH] = full["launches"]["phase3"]
    launches["phase3"][FULL_WIDTH + "_scoring"] = full["launches"]["phase3_scoring"]
    for k, v in full["rows"].items():
        kernel_rows.setdefault(k, []).extend(v)
    return {"launches": launches, "rows": kernel_rows}


# Phase 24: the continuous-batching server (serving/, ``--continuous``): the
# phase-1 sweep through backend_for with Config.serving on, so every request
# runs in a slot of one persistent KV pool, prefilled in groups and evicted
# and backfilled at chunk boundaries. The study checkpoints run the
# reference's default pool (8 slots, chunks of 8, the default budgets); the
# full-width main path 16 slots with a 1,024-token prompt budget, above the
# longest phase-1 prompt, so that no row is truncated.
STUDY_SERVING = dict(enabled=True, num_slots=8, decode_chunk=8)
FULL_WIDTH_SERVING = dict(enabled=True, num_slots=16, max_prompt_len=1024)
# The full-width greedy gate serves from a pool of the engine path's own
# shape: 16 rows (its batch) of 960 slots (its cache: the prompts' bucket of
# 896 and 64 tokens). K2's key splits follow the batch and the cache length
# (``decode_splits``), so at this shape both paths sum in one order and a
# served row must equal the engine's token for token, but at the engine's
# own near ties (the kernels' bf16 allowance, ``gate``, at its top logit).
CONTROL_SERVING = dict(enabled=True, num_slots=16, max_prompt_len=896,
                       max_new_tokens=MAX_TOKENS)
# The direct serve in that pool: this many requests of the sweep's prompts
# in turn, request i with a budget of 8 + 8 * (i mod 5) tokens, so that rows
# leave at different steps and the queue backfills their slots in flight.
DIRECT_REQUESTS = 32
# The full-width greedy gates (phase 24's served sweep against the engine
# path, phase 25's paged and float32 sweeps, phase 26's guarded sweep) run
# the sweep at one profile a demographic combination: 15 profiles and one
# neutral prompt, one call of 16. The t=0.7 main paths keep the study's
# three a combination (48 prompts).
GATE_PROFILES = 1


def serving_record_check(rec, label: str, num_slots: int, prompts: int = STUDY_PROMPTS) -> dict:
    """The sweep's record holds the server's counters: every prompt admitted
    and completed in the pool."""
    sv = rec["metadata"]["serving"]
    if not sv or sv["num_slots"] != num_slots or sv["admitted"] != prompts \
            or sv["completed"] != prompts or sv["failed"] or sv["expired"]:
        fail(f"{label}: the record's serving counters are {sv}")
    return sv


def study_served(torch, F, name: str, tmp: pathlib.Path, engine_card) -> tuple:
    """Phase 24 for one study checkpoint: the t=0.7 served sweep (the main
    path, its kernel calls recorded and held), then greedy on the card and
    on the CPU. Returns its log row, kernel rows, the keys of the kernel
    calls it held, the card's greedy served calls (phase 25 reads them) and
    the t=0.7 sweep's responses (phase 27 reads them)."""
    from fairness_llm_tpu_torch.config import Config, ServingConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.serving import ServingBackend

    cfg = Config(weights_dir=str(ROOT / "checkpoints"), data_dir=str(ROOT / "data" / "ml-1m"),
                 results_dir=str(tmp / name / "served"),
                 serving=ServingConfig(**STUDY_SERVING))
    row = {"model": name, "serving": STUDY_SERVING}
    zero_all(dec_mod, flash_mod, qm)
    t0 = time.perf_counter()
    backend = backend_for(name, cfg)
    if not isinstance(backend, ServingBackend):
        fail(f"{name}: backend_for gave {type(backend).__name__} with serving on")
    served = SweepRecorder(backend)
    with sweep_recorders(dec_mod, flash_mod, qm) as recs:
        rec = run_phase1(cfg, name, backend=backend)
    torch.cuda.synchronize()
    row["wall_s"] = time.perf_counter() - t0
    row["launches"] = phase1_counts(dec_mod, flash_mod, qm)
    need_kernels(row["launches"], f"{name} served", f32=True)
    row["parsed"] = check_record(rec, f"{name} served t=0.7")
    row["record_serving"] = serving_record_check(rec, f"{name} served", STUDY_SERVING["num_slots"])
    row["chunks"], row["totals"] = served.chunks, served.served_totals()
    saved_record_check(cfg, rec, f"{name} served")
    t07 = {"raw": raw_responses(rec), "neutral": rec["neutral_recommendations"]}
    kernel_rows = sweep_kernel_rows(recs, torch, F, qm, "serving_study", f32=True)
    held = {key for r in recs.values() for key in r.calls}
    del recs

    # greedy, served on the card and on the CPU, against each other and
    # against phase 20's engine path on the card
    gcfg = greedy_config(dataclasses.replace(cfg, results_dir=str(tmp / name / "sgreedy")),
                         name, MAX_TOKENS)
    runs = {}
    for device in ("cuda", "cpu"):
        b = backend_for(name, gcfg, device=device)
        calls = SweepRecorder(b)
        t0 = time.perf_counter()
        r = run_phase1(gcfg, name, backend=b, save=False)
        row[f"greedy_{device}_wall_s"] = time.perf_counter() - t0
        serving_record_check(r, f"{name} served greedy {device}", STUDY_SERVING["num_slots"])
        runs[device] = (b, calls, r)
    (_, card_calls, card), (cpu_b, cpu_calls, cpu) = runs["cuda"], runs["cpu"]
    engine_rec, engine_calls = engine_card
    for key, label, calls, other in (
            ("from_cpu", "the CPU served", cpu_calls, cpu),
            ("from_engine", "the engine path on the card", engine_calls, engine_rec)):
        differ = greedy_divergences(f"{name} served", calls, card_calls, cpu_b.engine, torch,
                                    against=label)
        row[f"greedy_rows_differing_{key}"] = differ
        if not differ and (raw_responses(card) != raw_responses(other)
                           or card["neutral_recommendations"] != other["neutral_recommendations"]):
            fail(f"{name} served greedy: equal tokens but other responses than {label}")
    return row, kernel_rows, held, card_calls, t07


def raw_responses(rec) -> dict:
    return {k: e["raw_response"] for k, e in rec["recommendations"].items()}


def full_width_served(torch, F, tmp: pathlib.Path, engine_wall_s: float, device_line: str):
    """Phase 24 at full width: llama3-8b with int8 weights, random from the
    seed, byte tokenizer. The t=0.7 served sweep (the main path, its kernel
    calls recorded and held), then the greedy gate in a pool of the engine
    path's shape (CONTROL_SERVING): the served greedy sweep and a direct
    serve of mixed budgets against the engine path. Returns the main path's
    launches and kernel rows, and for phase 25 its log row, the keys of the
    kernel calls it held, the greedy sweep's served calls and the engine,
    which the caller frees."""
    import types

    from fairness_llm_tpu_torch.config import Config, ModelSettings, ServingConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend, backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.serving import Request, ServingBackend

    cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                 data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / "llama3-8b"),
                 serving=ServingConfig(**FULL_WIDTH_SERVING))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cut_depth(MODEL, CUT_LAYERS):
        backend = backend_for(MODEL, cfg, allow_random=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    served = SweepRecorder(backend)
    zero_all(dec_mod, flash_mod, qm)
    t0 = time.perf_counter()
    with sweep_recorders(dec_mod, flash_mod, qm) as recs, CardSampler() as card:
        rec = run_phase1(cfg, MODEL, backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = phase1_counts(dec_mod, flash_mod, qm)
    if backend.engine.config.weight_quant != "int8":
        fail("the served full-width sweep did not serve int8 weights")
    need_kernels(launches, "llama3-8b int8 served", f32=False)
    for name in ("quant_matmul_gemv", "quant_matmul_gemm"):
        if launches[name] <= 0:
            fail(f"{name} ({KERNEL_FUNCTIONS[name]}) was not launched by the served sweep")
    parsed = check_record(rec, "llama3-8b int8 served", want_non_empty=False)
    sv = serving_record_check(rec, "llama3-8b int8 served", FULL_WIDTH_SERVING["num_slots"])
    saved_record_check(cfg, rec, "llama3-8b int8 served")
    sched = backend.scheduler_for(cfg.settings_for(MODEL))
    row = {"model": MODEL, "weight_quant": "int8", "device": device_line,
           "layers": backend.engine.config.num_layers,
           "serving": FULL_WIDTH_SERVING, "cache_len": sched.cache_len,
           "prompt_budget": sched.prompt_budget, "wall_s": wall,
           "engine_path_wall_s_phase21": engine_wall_s, "engine_init_s": init_s,
           **served.served_totals(), "avg_occupancy": sv["avg_occupancy"],
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "record_serving": sv, "chunks": served.chunks,
           "parsed_vacuous_random_weights": parsed, "card": card.summary}
    log(f"serving_full_width {json.dumps(row)}")
    kernel_rows = sweep_kernel_rows(recs, torch, F, qm, "serving_full_width", f32=False)
    held = {key for r in recs.values() for key in r.calls}
    engine = backend.engine
    del recs, backend, sched
    torch.cuda.empty_cache()

    # the greedy gate: the served sweep in the engine path's shape against
    # EngineBackend (no prefix, so share_prefix=False) on the same prompts
    gcfg = greedy_config(dataclasses.replace(cfg, results_dir=str(tmp / "greedy")), MODEL,
                         MAX_TOKENS)
    greedy = gcfg.settings_for(MODEL)
    control = ServingBackend(engine, ServingConfig(**CONTROL_SERVING), name=MODEL)
    sched = control.scheduler_for(greedy)
    gserved = SweepRecorder(control)
    t0 = time.perf_counter()
    run_phase1(gcfg, MODEL, GATE_PROFILES, backend=control, save=False)
    gate_row = {"cache_len": sched.cache_len, "served_greedy_wall_s": time.perf_counter() - t0,
                **gserved.served_totals()}
    eb = EngineBackend(engine, name=MODEL)
    ecalls = SweepRecorder(eb)
    t0 = time.perf_counter()
    for prompts, _ in gserved.calls:
        eb.generate(prompts, greedy)
        st = eb.last_stats
        if (st["batch"], st["cache_slots"], st["prefix_len"]) != \
                (sched.num_slots, sched.cache_len, 0):
            fail(f"the engine path decoded {st['batch']} rows of {st['cache_slots']} slots "
                 f"(prefix {st['prefix_len']}), not the control pool's {sched.num_slots} of "
                 f"{sched.cache_len}")
    gate_row["engine_greedy_wall_s"] = time.perf_counter() - t0

    def tie(top):
        return ATOL + RTOL * abs(top)

    gate_row["sweep_rows"] = sum(len(c[0]) for c in gserved.calls)
    gate_row["sweep_rows_differing"] = greedy_divergences(
        "llama3-8b int8 served sweep", ecalls, gserved, engine, torch,
        against="the engine path", tie=tie)

    # the direct serve: mixed budgets through the same pool, backfilled in
    # flight; request i's row must be its prompt's engine row cut to its
    # budget (the engine's rows are causal, and decoded at the pool's shape)
    sweep_prompts = [p for call in gserved.calls for p in call[0]]
    sweep_rows = [r for call in ecalls.calls for r in call[1]]
    prompts = [sweep_prompts[i % len(sweep_prompts)] for i in range(DIRECT_REQUESTS)]
    engine_rows = [sweep_rows[i % len(sweep_rows)] for i in range(DIRECT_REQUESTS)]
    budgets = [8 + 8 * (i % 5) for i in range(len(prompts))]
    reqs = [Request(prompt=p, settings=ModelSettings(temperature=0.0, max_tokens=b),
                    id=f"d{i}") for i, (p, b) in enumerate(zip(prompts, budgets))]
    t0 = time.perf_counter()
    results = sched.serve(reqs)
    direct = sched.last_stats
    gate_row["direct_wall_s"] = time.perf_counter() - t0
    gate_row["direct_stats"] = direct.as_dict()
    if direct.completed != len(reqs) or direct.admitted != len(reqs) \
            or direct.prefill_batches < 3 or not all(r.ok for r in results):
        fail(f"the direct serve did not backfill the pool as planned: {direct.as_dict()}")
    pad = engine.tokenizer.pad_id
    want = types.SimpleNamespace(calls=[(prompts, [r[:b] for r, b in zip(engine_rows, budgets)])])
    got = types.SimpleNamespace(calls=[(prompts, [_strip(r.tokens, pad) for r in results])])
    gate_row["direct_rows"] = len(reqs)
    gate_row["direct_rows_differing"] = greedy_divergences(
        "llama3-8b int8 direct serve", want, got, engine, torch,
        against="the engine path", tie=tie)
    log(f"serving_full_width_gate {json.dumps(gate_row)}")
    del control, sched, eb
    torch.cuda.empty_cache()
    return launches, kernel_rows, {"row": row, "held": held, "greedy": gserved,
                                   "greedy_wall_s": gate_row["served_greedy_wall_s"],
                                   "engine": engine}


def serving_path(torch, F, device_line: str, sweep: dict) -> dict:
    """Phase 24. Returns each kernels-line entry's launches on the served
    t=0.7 sweeps (the study models together, "study"; FULL_WIDTH) and their
    kernel rows, by entry; and under "paged" what phase 25 holds its runs
    against (the keys of the kernel calls phase 24 held, the card's greedy
    served calls by study model, and the full-width run's row, greedy calls
    and engine) and the study models' t=0.7 responses (phase 27's)."""
    import gc
    import tempfile

    launches, rows = {"study": {}}, {}
    paged = {"held": set(), "greedy_card": {}, "t07": {}, "t07_paged": {}}
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        for name in STUDY_MODELS:
            row, krows, held, paged["greedy_card"][name], paged["t07"][name] = study_served(
                torch, F, name, pathlib.Path(tmp), sweep["greedy_card"][name])
            paged["held"] |= held
            for k, v in row["launches"].items():
                launches["study"][k] = launches["study"].get(k, 0) + v
            for k, v in krows.items():
                rows.setdefault(k, []).extend(v)
            log(f"serving_study {json.dumps({'device': device_line, **row})}")
        gc.collect()
        launches[FULL_WIDTH], full_rows, full = full_width_served(
            torch, F, pathlib.Path(tmp), sweep["full_width_wall_s"], device_line)
    paged["held"] |= full.pop("held")
    paged["full_width"] = full
    for k, v in full_rows.items():
        rows.setdefault(k, []).extend(v)
    return {"launches": launches, "rows": rows, "paged": paged}


# Phase 25: the paged KV cache with its radix prefix index
# (``ServingConfig.paged_kv``, ``--paged-kv``): the served phase-1 sweep with
# the slots' KV in blocks of one shared arena, prompt prefixes matched
# against the blocks cached so far and only the unmatched suffix prefilled.
# The study checkpoints run phase 24's pool with blocks of 16 tokens; the
# full-width main path phase 24's 16 slots and 1,024-token prompt budget
# with a decode cap of 128 (above the sweep's 64 tokens), so that each slot
# spans 1,024 + 128 = 1,152 tokens (72 blocks) and the default arena holds
# 2,304 blocks.
PAGED_BLOCK = 16
STUDY_PAGED = dict(STUDY_SERVING, paged_kv=True, kv_block_size=PAGED_BLOCK)
FULL_WIDTH_PAGED = dict(FULL_WIDTH_SERVING, max_new_tokens=128, paged_kv=True,
                        kv_block_size=PAGED_BLOCK)
# The study sweeps' prefix reuse must exceed the reference's own gate
# (tests/test_paged_kv.py): half of the prompt tokens served from cache.
MIN_HIT_RATIO = 0.5
# The int8-KV direct serve at full width: this many of the sweep's prompts,
# this many greedy tokens each, paged and not, over the same weight tensors.
KV_INT8_REQUESTS, KV_INT8_TOKENS = 8, 16
PAGED_GAUGES = ("kv_blocks_free", "kv_block_occupancy", "kv_blocks_cached",
                "prefix_cache_hit_ratio")


def paged_counts(dec_mod, flash_mod, qm) -> dict:
    """Each kernels-line entry's launches on a paged run. Its suffix prefill
    attends densely (suffix buckets are at least 128 tokens on the card, and
    only a window of at most 16 reaches K3), so neither K1 nor K3 may
    launch; over an int8 cache every K2q launch, and every other decode
    launch of a bf16 model, must be decode_split_tc's."""
    if flash_mod.launches or dec_mod.multi_launches or dec_mod.multi_quant_launches:
        fail(f"a paged run launched K1 {flash_mod.launches} or K3 "
             f"{dec_mod.multi_launches + dec_mod.multi_quant_launches} times")
    quant = dec_mod.quant_launches
    tc, f32 = one_query_counts(dec_mod)
    if quant and tc != dec_mod.launches + quant:
        fail("a decode launch of the int8-cache paged run was not decode_split_tc's")
    return {"flash_attention": 0, "flash_attention_f32": 0,
            "decode_attention": tc - quant, "decode_attention_f32": f32,
            "decode_attention_verify": 0, "decode_attention_int8_cache": quant,
            "decode_attention_verify_int8_cache": 0,
            "quant_matmul_gemv": qm.gemv_launches, "quant_matmul_gemm": qm.gemm_launches}


class NotScoring:
    """``flagged_recorders``' flag for runs with no scoring forward."""

    on = False


def paged_gauges(reg, label: str) -> dict:
    """The paged manager's counters and gauges from the port's registry; the
    gauges must be there."""
    out = {}
    for name in PAGED_GAUGES + ("prefix_cache_hit_tokens_total",
                                "prefix_cache_miss_tokens_total", "prefix_cache_cow_total",
                                "kv_blocks_evicted_total"):
        m = reg.peek(name, component="paged_kv")
        if m is None and name in PAGED_GAUGES:
            fail(f"{label}: the registry holds no {name} gauge")
        out[name] = None if m is None else m.value
    h = reg.peek("matched_prefix_len", component="paged_kv")
    out["matched_prefix_len"] = None if h is None else {
        "count": h.count, "sum": h.sum, "p50": h.percentile(50), "max": h.max}
    return out


def paged_rows(recs, torch, F, qm, path: str, f32: bool, held: set) -> dict:
    """The kernel calls of a paged run that no earlier phase held, each
    against its plain version (``sweep_kernel_rows``), K2q's among them."""
    q = [(key, call) for key, call in recs["dec"].calls.items()
         if key[0] == "k2q" and key[:-1] not in held]
    rows = sweep_kernel_rows(recs, torch, F, qm, path, f32=f32, held=held)
    if q:
        qrows = [decode_numbers(call, torch, F) for _, call in q]
        for r, (key, call) in zip(qrows, q):
            r["path"], r["scoring"] = path, False
            held.add(key)
        check_rows("decode_attention_int8_cache", qrows, "the newest slot masked out")
        rows["decode_attention_int8_cache"] = qrows
    return {k: v for k, v in rows.items() if v}


def replayed_logits(engine, serving: dict, rows, torch) -> list:
    """The carried logits a served path samples token ``t`` from, for each
    (prompt, tokens, t) in ``rows``: the prompts served again, greedy, in a
    pool of ``serving``'s shape, one token a chunk (the tokens do not depend
    on the chunk), each row's logits read as it reaches token ``t``. A row
    decodes in its slot independently of the others (K2 plans its key
    splits from the pool's shape only), so the replay must give each row's
    tokens again; it fails otherwise."""
    from fairness_llm_tpu_torch.config import ModelSettings, ServingConfig
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request

    at = {f"r{i}": t for i, (_, _, t) in enumerate(rows)}
    logits = {}

    class LogitsAt(ContinuousScheduler):
        def _decode(self, stats):
            for slot in self.pool.live_slots():
                st = self.pool.get(slot)
                if at.get(st.request.id) == st.emitted:
                    logits[st.request.id] = self._prev_logits[slot].float().clone()
            return super()._decode(stats)

    settings = ModelSettings(temperature=0.0, max_tokens=max(at.values()) + 1)
    sched = LogitsAt(engine, ServingConfig(**{**serving, "decode_chunk": 1}), settings=settings)
    results = sched.serve([Request(prompt=p, id=f"r{i}", settings=dataclasses.replace(
        settings, max_tokens=t + 1)) for i, (p, _, t) in enumerate(rows)])
    pad = engine.tokenizer.pad_id
    for i, ((_, tokens, t), res) in enumerate(zip(rows, results)):
        if _strip(res.tokens, pad) != tokens[:t + 1] or f"r{i}" not in logits:
            fail(f"the replay of row {i} did not give the served path's tokens again")
    del sched
    return [logits[f"r{i}"] for i in range(len(rows))]


def paged_gate(label: str, want, got, engine, serving: dict, torch, f32: bool,
               hard: bool = True) -> list:
    """The paged path's greedy rows (``got``) against a non-paged served
    path's (``want``; ``SweepRecorder``s or anything with their ``calls``),
    served in a pool of ``serving``. A row may part only where the
    non-paged path's own top two logits at the first divergent token
    (``replayed_logits``), and the paged path's token among them, are
    within the kernels' allowance (``tolerance``: float32 with ``f32``, else
    bfloat16) at its top logit. Returns each parting row with its gap;
    with ``hard=False`` it fails on none (a report)."""
    if [c[0] for c in want.calls] != [c[0] for c in got.calls]:
        fail(f"{label}: the two paths decoded other prompts")
    parting = []
    for ci, ((prompts, want_rows), (_, got_rows)) in enumerate(zip(want.calls, got.calls)):
        for ri, (prompt, w, g) in enumerate(zip(prompts, want_rows, got_rows)):
            if w != g:
                t = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
                if t is None:
                    fail(f"{label}: call {ci} row {ri} stops at another length, no token apart")
                parting.append((ci, ri, prompt, w, g, t))
    if not parting:
        return []
    # rows with one prompt and one history up to the parting token (the
    # sweep's prompts repeat) are replayed once
    unique = list(dict.fromkeys((p, tuple(w[:t + 1]), t) for _, _, p, w, _, t in parting))
    replayed = dict(zip(unique, replayed_logits(engine, serving,
                                                [(p, list(w), t) for p, w, t in unique], torch)))
    logits = [replayed[(p, tuple(w[:t + 1]), t)] for _, _, p, w, _, t in parting]
    atol, rtol = tolerance(f32)
    differ = []
    for (ci, ri, _, w, g, t), lg in zip(parting, logits):
        top = torch.topk(lg, 2)
        gap, top0 = float(top.values[0] - top.values[1]), float(top.values[0])
        allowed = atol + rtol * abs(top0)
        below = float(top.values[0] - lg[g[t]])
        row = {"call": ci, "row": ri, "token": t, "top2_gap": gap, "top": top0,
               "allowed": allowed, "want": w[t], "got": g[t], "got_logit_below_top": below,
               "within": int(top.indices[0]) == w[t] and gap < allowed and below < allowed}
        differ.append(row)
        log(f"{label}: call {ci} row {ri} parts at token {t}: {json.dumps(row)}")
        if hard and not row["within"]:
            fail(f"{label}: call {ci} row {ri} parts from the non-paged path at token {t}, "
                 f"where that path's top two logits are {gap:.3e} apart and the paged token "
                 f"{below:.3e} below its top (allowed {allowed:.3e})")
    return differ


def f32_verdicts(eng32, rows, want, torch) -> list:
    """Each parting row (``paged_gate``'s) with the float32 function's own
    logits at its first divergent token, teacher-forced through the
    float32 twin: which of the two paths' tokens it ranks first, and by how
    much the non-paged path's token leads the paged path's."""
    seen = {}
    for r in rows:
        prompt, w = want.calls[r["call"]][0][r["row"]], want.calls[r["call"]][1][r["row"]]
        ids = eng32.tokenizer.encode(prompt) + w[:r["token"]]
        if tuple(ids) not in seen:
            lg, _ = eng32.model(torch.tensor([ids], device=eng32.device),
                                torch.arange(len(ids), device=eng32.device)[None])
            seen[tuple(ids)] = lg[0, -1].float()
        lg = seen[tuple(ids)]
        first = int(lg.argmax())
        r["f32_want_minus_got"] = float(lg[r["want"]] - lg[r["got"]])
        r["f32_picks"] = ("non_paged" if first == r["want"] else
                          "paged" if first == r["got"] else "other")
    return rows


def kv_int8_agreement(eng_q, prompts, kv_serving: dict, torch) -> dict:
    """The int8 KV cache the paged prefill writes against the non-paged
    prefill's, for the same prompts (both prefilled, nothing decoded). At
    the first layer, whose inputs are the same embeddings, every int8 value
    at most one quantization step apart (the same number rounded from
    products summed in another order) and the scales within the float32
    allowance: a row's blocks, positions or rotary phases out of place
    would put values many steps apart. Deeper layers read caches already a
    step apart here and there, so their differences compound: reported
    (the largest step and scale differences, the share of values apart)."""
    from fairness_llm_tpu_torch.config import ModelSettings, ServingConfig
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request
    from fairness_llm_tpu_torch.serving.paged import gather_view
    from fairness_llm_tpu_torch.utils.profiling import ServingStats

    settings = ModelSettings(temperature=0.0, max_tokens=1)
    caches = {}
    for is_paged in (False, True):
        sched = ContinuousScheduler(eng_q, ServingConfig(**{**kv_serving, "paged_kv": is_paged}),
                                    settings=settings)
        for i, prompt in enumerate(prompts):
            sched.submit(Request(prompt=prompt, id=f"c{i}", settings=settings))
        sched._admit(ServingStats(num_slots=sched.num_slots))
        rows = {}
        for slot in sched.pool.live_slots():
            st = sched.pool.get(slot)
            n = st.real_len
            if is_paged:
                table = torch.tensor([sched.pool.paged.table_for(slot)], device=eng_q.device)
                cache = gather_view(sched._arena, table, sched._arena.lengths, sched._view)
                take = (lambda n: lambda t: t[0, :n].clone())(n)
            else:
                cache = sched._cache
                take = (lambda a, b, r: lambda t: t[r, a:b].clone())(st.base - n, st.base, slot)
            rows[st.request.id] = [[take(t) for t in (lc.k, lc.v, lc.k_scale, lc.v_scale)]
                                   for lc in cache.layers]
        if len(rows) != len(prompts):
            fail(f"the int8-KV prefill admitted {len(rows)} of {len(prompts)} prompts")
        caches[is_paged] = rows
        del sched
    num_layers = eng_q.config.num_layers
    steps, scales, apart, total = [0] * num_layers, [0.0] * num_layers, 0, 0
    for rid, layers in caches[False].items():
        for i, ((k0, v0, ks0, vs0), (k1, v1, ks1, vs1)) in enumerate(zip(layers,
                                                                          caches[True][rid])):
            for q0, q1 in ((k0, k1), (v0, v1)):
                d = (q0.int() - q1.int()).abs()
                steps[i] = max(steps[i], int(d.max()))
                apart += int((d > 0).sum())
                total += d.numel()
            scales[i] = max(scales[i], float((ks0 - ks1).abs().max()),
                            float((vs0 - vs1).abs().max()))
    if steps[0] > 1 or scales[0] > ATOL_F32:
        fail(f"the paged int8 KV at the first layer is {steps[0]} steps and {scales[0]:.3e} "
             "in scale from the non-paged one")
    return {"values": total, "share_apart": apart / total, "first_layer_steps": steps[0],
            "first_layer_scale_diff": scales[0], "deeper_max_steps": max(steps[1:], default=0),
            "deeper_max_scale_diff": max(scales[1:], default=0.0)}


def float32_twin(engine, **changes):
    """An engine over ``engine``'s int8 weight tensors (shared, not copied)
    with float32 activations and cache: the same function summed in
    float32, where two computation orders part only at near ties of about
    1e-4 (the kernels' float32 allowance)."""
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    return DecodeEngine(dataclasses.replace(engine.config, dtype="float32", **changes),
                        params=engine.model.state_dict())


def study_paged(torch, F, name: str, tmp: pathlib.Path, engine_card, served_card,
                held: set) -> tuple:
    """Phase 25 for one study checkpoint: the t=0.7 paged sweep (the main
    path), then greedy on the card and on the CPU against each other, the
    non-paged served rows (phase 24) and the engine path (phase 20).
    Returns the log row, the kernel rows and the t=0.7 sweep's responses
    (phase 27 reads them)."""
    from fairness_llm_tpu_torch.config import Config, ServingConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.serving import ServingBackend
    from fairness_llm_tpu_torch.telemetry import use_registry

    cfg = Config(weights_dir=str(ROOT / "checkpoints"), data_dir=str(ROOT / "data" / "ml-1m"),
                 results_dir=str(tmp / name / "paged"), serving=ServingConfig(**STUDY_PAGED))
    row = {"model": name, "serving": STUDY_PAGED}
    zero_all(dec_mod, flash_mod, qm)
    t0 = time.perf_counter()
    backend = backend_for(name, cfg)
    if not isinstance(backend, ServingBackend) or not backend.serving.paged_kv:
        fail(f"{name}: backend_for gave no paged ServingBackend")
    served = SweepRecorder(backend)
    with use_registry() as reg, flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
        rec = run_phase1(cfg, name, backend=backend)
    torch.cuda.synchronize()
    row["wall_s"] = time.perf_counter() - t0
    row["launches"] = paged_counts(dec_mod, flash_mod, qm)
    if row["launches"]["decode_attention_f32"] <= 0 or row["launches"]["decode_attention"]:
        fail(f"{name} paged: decode_split_f32 must launch and decode_split_tc must not: "
             f"{row['launches']}")
    row["parsed"] = check_record(rec, f"{name} paged t=0.7")
    row["record_serving"] = serving_record_check(rec, f"{name} paged",
                                                 STUDY_PAGED["num_slots"])
    row["paged"] = paged_gauges(reg, f"{name} paged")
    if not row["paged"]["prefix_cache_hit_ratio"] > MIN_HIT_RATIO:
        fail(f"{name} paged: prefix_cache_hit_ratio {row['paged']['prefix_cache_hit_ratio']} "
             f"<= {MIN_HIT_RATIO}")
    row["chunks"], row["totals"] = served.chunks, served.served_totals()
    saved_record_check(cfg, rec, f"{name} paged")
    t07 = {"raw": raw_responses(rec), "neutral": rec["neutral_recommendations"]}
    kernel_rows = paged_rows(recs, torch, F, qm, "paged_study", True, held)
    del recs

    gcfg = greedy_config(dataclasses.replace(cfg, results_dir=str(tmp / name / "pgreedy")),
                         name, MAX_TOKENS)
    runs = {}
    for device in ("cuda", "cpu"):
        b = backend_for(name, gcfg, device=device)
        calls = SweepRecorder(b)
        t0 = time.perf_counter()
        r = run_phase1(gcfg, name, backend=b, save=False)
        row[f"greedy_{device}_wall_s"] = time.perf_counter() - t0
        serving_record_check(r, f"{name} paged greedy {device}", STUDY_PAGED["num_slots"])
        runs[device] = (b, calls, r)
    (_, card_calls, card), (cpu_b, cpu_calls, _) = runs["cuda"], runs["cpu"]
    for key, label, want in (("from_cpu", "the CPU paged", cpu_calls),
                             ("from_served", "the non-paged served path on the card",
                              served_card),
                             ("from_engine", "the engine path on the card", engine_card[1])):
        row[f"greedy_rows_differing_{key}"] = greedy_divergences(
            f"{name} paged", want, card_calls, cpu_b.engine, torch, against=label)
    if not any(row[f"greedy_rows_differing_{k}"] for k in ("from_served", "from_engine")) \
            and raw_responses(card) != raw_responses(engine_card[0]):
        fail(f"{name} paged greedy: equal tokens but other responses than the engine path")
    return row, kernel_rows, t07


def time_gather_scatter(sched, torch) -> dict:
    """The paged decode step's gather (arena to view) and scatter (view to
    arena) at the pool's shape, on the last chunk's tables, timed with CUDA
    events, and the bytes each moves."""
    from fairness_llm_tpu_torch.serving.paged import gather_view, scatter_view

    B = sched.num_slots
    arena, view = sched._arena, sched._view
    tables, wtables = sched._tables[:B], sched._wtables[:B]
    gather_ms = cuda_ms(lambda: gather_view(arena, tables, arena.lengths, view), 20)
    v = gather_view(arena, tables, arena.lengths, view)
    scatter_ms = cuda_ms(lambda: scatter_view(arena, v, wtables), 20)
    per_slot = sum(t[:B].element_size() * t[:B].numel() for lc in v.layers
                   for t in (lc.k, lc.v, lc.k_scale, lc.v_scale) if t is not None)
    per_slot += v.key_valid.numel() + v.key_positions.numel() * 8
    return {"gather_ms": gather_ms, "scatter_ms": scatter_ms, "view_bytes": per_slot,
            "gather_tb_per_s": 2 * per_slot / gather_ms / 1e9,
            "scatter_tb_per_s": 2 * per_slot / scatter_ms / 1e9}


def full_width_paged(torch, F, tmp: pathlib.Path, p24: dict, engine_wall_s: float,
                     device_line: str, held: set) -> tuple:
    """Phase 25 at full width: llama3-8b int8 (phase 24's engine) served
    paged. The t=0.7 sweep (the main path), logged beside phase 24's
    non-paged run and phase 21's engine path; the greedy sweep against
    phase 24's greedy served rows; then the int8-KV direct serve, paged
    against not. Returns each run's launches and the kernel rows."""
    from fairness_llm_tpu_torch.config import Config, ModelSettings, ServingConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request, ServingBackend
    from fairness_llm_tpu_torch.telemetry import use_registry, use_timeline

    engine = p24["engine"]
    cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                 data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / "paged"),
                 serving=ServingConfig(**FULL_WIDTH_PAGED))
    backend = ServingBackend(engine, cfg.serving, name=MODEL)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    served = SweepRecorder(backend)
    zero_all(dec_mod, flash_mod, qm)
    t0 = time.perf_counter()
    with use_registry() as reg, use_timeline() as tl, CardSampler() as card, \
            flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
        rec = run_phase1(cfg, MODEL, backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = paged_counts(dec_mod, flash_mod, qm)
    for name in ("decode_attention", "quant_matmul_gemv", "quant_matmul_gemm"):
        if launches[name] <= 0:
            fail(f"{name} ({KERNEL_FUNCTIONS[name]}) was not launched by the paged sweep")
    if launches["decode_attention_f32"]:
        fail(f"the paged bf16 sweep launched decode_split_f32 {launches['decode_attention_f32']} "
             "times")
    parsed = check_record(rec, "llama3-8b int8 paged", want_non_empty=False)
    sv = serving_record_check(rec, "llama3-8b int8 paged", FULL_WIDTH_PAGED["num_slots"])
    saved_record_check(cfg, rec, "llama3-8b int8 paged")
    sched = backend.scheduler_for(cfg.settings_for(MODEL))
    paged = sched.pool.paged
    spans = [e for e in tl.events() if e["type"] == "span"]
    groups = [[e["name"], e["dur_s"], e["args"]["rows"], e["args"]["matched_prefix_tokens"]]
              for e in spans if e["cat"] == "prefill"]
    chunk_s = [e["dur_s"] for e in spans if e["cat"] == "decode"]
    gs = time_gather_scatter(sched, torch)
    chunk_ms = sum(chunk_s) * 1e3 / max(len(chunk_s), 1)
    non_paged = p24["row"]
    row = {"model": MODEL, "weight_quant": "int8", "device": device_line,
           "serving": FULL_WIDTH_PAGED, "cache_len": sched.cache_len,
           "blocks_per_slot": paged.blocks_per_slot, "num_blocks": paged.num_blocks,
           "arena_gb": sum(t.numel() * t.element_size() for t in sched._arena.tensors()) / 1e9,
           "view_gb": gs["view_bytes"] * sched._view.key_valid.shape[0] / sched.num_slots / 1e9,
           "wall_s": wall, **served.served_totals(), "avg_occupancy": sv["avg_occupancy"],
           "prefill_s_by_chunk": [c["prefill_s"] for c in served.chunks],
           "prefill_groups": groups, "decode_chunks": len(chunk_s), "chunk_ms": chunk_ms,
           **gs, "gather_scatter_share_of_chunk": (gs["gather_ms"] + gs["scatter_ms"])
           / max(chunk_ms, 1e-9),
           "paged": paged_gauges(reg, "llama3-8b int8 paged"),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "non_paged_served_phase24": {
               k: non_paged[k] for k in ("wall_s", "prefill_s", "decode_s",
                                         "decode_ms_per_step", "tokens_per_s",
                                         "prefill_batches", "peak_allocated_gb")},
           "non_paged_prefill_s_by_chunk": [c["prefill_s"] for c in non_paged["chunks"]],
           "engine_path_wall_s_phase21": engine_wall_s,
           "launches": launches, "record_serving": sv, "chunks": served.chunks,
           "parsed_vacuous_random_weights": parsed, "card": card.summary}
    log(f"paged_full_width {json.dumps(row)}")
    kernel_rows = paged_rows(recs, torch, F, qm, "paged_full_width", False, held)
    del recs, sched, paged

    # greedy: the paged sweep against phase 24's greedy served rows (which
    # equal the engine path's). In bfloat16 the two paths sum in other
    # orders (the paged prefill attends densely, its prefix computed in
    # another row's forward), and their logits over many layers part by
    # more than one kernel's allowance (PERF.md §6): reported, each parting
    # row with the non-paged path's own gap. In float32 over the same
    # weights the same comparison is the gate.
    gcfg = greedy_config(dataclasses.replace(cfg, results_dir=str(tmp / "pgreedy")), MODEL,
                         MAX_TOKENS)
    gpaged = SweepRecorder(backend)
    t0 = time.perf_counter()
    run_phase1(gcfg, MODEL, GATE_PROFILES, backend=backend, save=False)
    gate_row = {"paged_greedy_wall_s": time.perf_counter() - t0, **gpaged.served_totals()}
    gate_row["sweep_rows"] = sum(len(c[0]) for c in gpaged.calls)
    parting = paged_gate("llama3-8b int8 paged sweep, bf16 (reported)", p24["greedy"], gpaged,
                         engine, CONTROL_SERVING, torch, f32=False, hard=False)
    del backend, gpaged
    torch.cuda.empty_cache()
    # Every K4 call of the float32 twins (the gate's sweeps and replays,
    # and the int8-KV f32 serves) is recorded and held (k4_f32_rows).
    with f32_k4_recording(qm) as (rec32, counts32):
        eng32 = float32_twin(engine)
        gate_row["bf16_sweep_rows_parting"] = f32_verdicts(eng32, parting, p24["greedy"], torch)
        gate_row["bf16_parting_f32_picks"] = {
            k: sum(r["f32_picks"] == k for r in parting) for k in ("non_paged", "paged", "other")}
        sweeps32 = {}
        for key, serving in (("non_paged", CONTROL_SERVING), ("paged", FULL_WIDTH_PAGED)):
            b = ServingBackend(eng32, ServingConfig(**serving), name=MODEL)
            sweeps32[key] = SweepRecorder(b)
            t0 = time.perf_counter()
            run_phase1(gcfg, MODEL, GATE_PROFILES, backend=b, save=False)
            gate_row[f"f32_{key}_greedy_wall_s"] = time.perf_counter() - t0
            del b
            torch.cuda.empty_cache()
        gate_row["f32_sweep_rows_differing"] = paged_gate(
            "llama3-8b int8 paged sweep, f32", sweeps32["non_paged"], sweeps32["paged"], eng32,
            CONTROL_SERVING, torch, f32=True)
        del sweeps32

        # the int8 KV cache: a direct serve of the sweep's first prompts, paged
        # and not, by an engine over the same weight tensors (K2q over the view
        # in bfloat16, reported as above), then the same in float32 (the gate)
        import types

        prompts = [p for call in p24["greedy"].calls for p in call[0]][:KV_INT8_REQUESTS]
        settings = ModelSettings(temperature=0.0, max_tokens=KV_INT8_TOKENS)
        kv_serving = {**FULL_WIDTH_SERVING, "kv_block_size": PAGED_BLOCK,
                      "max_new_tokens": KV_INT8_TOKENS}
        kv_launches = None
        for dtype, eng_q in (("bf16", DecodeEngine(dataclasses.replace(engine.config,
                                                                       kv_cache_quant=True),
                                                   params=engine.model.state_dict())),
                             ("f32", float32_twin(eng32, kv_cache_quant=True))):
            rows_by = {}
            for is_paged in (True, False):
                sched = ContinuousScheduler(eng_q, ServingConfig(**{**kv_serving,
                                                                    "paged_kv": is_paged}),
                                            settings=settings)
                reqs = [Request(prompt=p, settings=settings, id=f"kv{i}")
                        for i, p in enumerate(prompts)]
                main = dtype == "bf16" and is_paged
                zero_all(dec_mod, flash_mod, qm)
                with contextlib.ExitStack() as stack:
                    if main:
                        recs = stack.enter_context(flagged_recorders(dec_mod, flash_mod, qm,
                                                                     NotScoring))
                    t0 = time.perf_counter()
                    results = sched.serve(reqs)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                if not all(r.ok for r in results):
                    fail(f"the {dtype} int8-KV direct serve failed a request")
                key = f"kv_int8_{dtype}_{'paged' if is_paged else 'non_paged'}"
                gate_row[f"{key}_wall_s"] = wall
                gate_row[f"{key}_stats"] = sched.last_stats.as_dict()
                rows_by[is_paged] = [_strip(r.tokens, eng_q.tokenizer.pad_id) for r in results]
                if main:
                    kv_launches = paged_counts(dec_mod, flash_mod, qm)
                    if kv_launches["decode_attention_int8_cache"] <= 0:
                        fail("K2q (decode_split_tc over int8) was not launched by the paged serve")
                    for k, v in paged_rows(recs, torch, F, qm, "paged_full_width_kv_int8", False,
                                           held).items():
                        kernel_rows.setdefault(k, []).extend(v)
                    del recs
                del sched
                torch.cuda.empty_cache()
            # int8 rounding makes the cached function step-wise: inputs summed in
            # another order may round one step apart, and the step compounds
            # through the layers, so in float32 too a row may part beyond the
            # float32 allowance. The gate is the first layer's cache
            # (kv_int8_agreement); the rows are reported.
            gate_row[f"kv_int8_{dtype}_rows"] = len(prompts)
            gate_row[f"kv_int8_{dtype}_rows_parting"] = paged_gate(
                f"llama3-8b int8 paged int8-KV serve, {dtype} (reported)",
                types.SimpleNamespace(calls=[(prompts, rows_by[False])]),
                types.SimpleNamespace(calls=[(prompts, rows_by[True])]), eng_q, kv_serving, torch,
                f32=dtype == "f32", hard=False)
            if dtype == "f32":
                gate_row["kv_int8_f32_cache_agreement"] = kv_int8_agreement(eng_q, prompts,
                                                                            kv_serving, torch)
            del eng_q
    gate_row["kv_int8_launches"] = kv_launches
    gate_row["f32_twin_k4_launches"] = counts32
    kernel_rows["quant_matmul_f32"] = k4_f32_rows(rec32, counts32, torch,
                                                  "paged_full_width_f32", qm, held)
    log(f"paged_full_width_gate {json.dumps(gate_row)}")
    del eng32, rec32
    return launches, kv_launches, {"quant_matmul_f32": counts32["quant_matmul_f32"]}, kernel_rows


def paged_path(torch, F, device_line: str, sweep: dict, p24: dict) -> dict:
    """Phase 25. Returns each kernels-line entry's launches on the paged
    t=0.7 sweeps (the study models together, "study"; FULL_WIDTH) and on
    the int8-KV serve (FULL_WIDTH + "_kv_int8"), and the kernel rows of the
    calls no earlier phase held, by entry. Phase 24's full-width engine
    stays in ``p24`` for phases 26-27 (27 frees it), and each study
    model's t=0.7 responses join it (``t07_paged``)."""
    import gc
    import tempfile

    held = set(sweep["held"]) | p24["held"]
    launches, rows = {"study": {}}, {}
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        for name in DRILL_MODELS:
            row, krows, p24["t07_paged"][name] = study_paged(
                torch, F, name, pathlib.Path(tmp), sweep["greedy_card"][name],
                p24["greedy_card"][name], held)
            for k, v in row["launches"].items():
                launches["study"][k] = launches["study"].get(k, 0) + v
            for k, v in krows.items():
                rows.setdefault(k, []).extend(v)
            log(f"paged_study {json.dumps({'device': device_line, **row})}")
        gc.collect()
        full = p24["full_width"]
        (launches[FULL_WIDTH], launches[FULL_WIDTH + "_kv_int8"],
         launches[FULL_WIDTH + "_f32"], full_rows) = full_width_paged(
            torch, F, pathlib.Path(tmp), full, sweep["full_width_wall_s"], device_line, held)
    for k, v in full_rows.items():
        rows.setdefault(k, []).extend(v)
    return {"launches": launches, "rows": rows, "held": held}


# Phase 26: fault containment on the card (utils/failures.py, resilience/,
# integrity/): the served sweep with scripted faults, the breakers, the
# watchdog, the numerics guard and the canary armed, a fatal CUDA error in a
# child process, and drain, the serving journal and resume.
#
# The study script, one ScriptedFaultInjector a generate call of the sweep
# (its first three keys): call 0 a prefill fault and a decode fault that
# requeue once and a request that faults twice at prefill ("failed", an
# error row); call 1 a NaN in the carried logits of its first key (the
# guard discards that decode chunk: every rider requeues, cause numerics);
# call 2 a simulated hang of an hour (the watchdog classifies that chunk).
STUDY_SCRIPT = (
    lambda k: dict(faults={(k[0], "prefill"): 1, (k[1], "decode"): 1, k[2]: 2}),
    lambda k: dict(corruptions={(k[0], "decode"): 1}),
    lambda k: dict(hangs={(k[0], "decode"): 1}),
)
# The study runs: the watchdog far above any real step, breakers that
# never trip on the script (so that the counters are the script's).
STUDY_RESILIENCE = dict(enabled=True, max_step_seconds=600.0, breaker_threshold=100)
# The full-width runs: the reference's breakers and a watchdog of 60 s (a
# decode chunk takes ~0.4 s, a prefill group ~0.7 s; first uses exempt).
FULL_WIDTH_RESILIENCE = dict(enabled=True, max_step_seconds=60.0)
# The full-width faulted serve: this many of the sweep's prompts, greedy, in
# the control pool; one decode fault and one NaN, in its first decode chunk.
FAULT_REQUESTS, FAULT_TOKENS = 8, 16
# The drill of a fatal CUDA error: the decode step at which the child
# indexes a tensor out of range on the card (a device-side assert).
FATAL_STEP = 20


def containment_counts(dec_mod, flash_mod, qm) -> dict:
    """Each kernels-line entry's launches since the counts were zeroed, by
    the CUDA kernel it names: K1's and K2's tensor-core and float32 kernels
    apart, K2q and the verify windows by their own counters."""
    quant = dec_mod.quant_launches
    tc, f32 = one_query_counts(dec_mod)
    if quant and f32:
        fail(f"a counted containment run launched the float32 kernel ({f32}) beside an "
             f"int8 cache ({quant}): its K2q launches cannot be told apart")
    return {"flash_attention": flash_mod.tc_launches,
            "flash_attention_f32": flash_mod.launches - flash_mod.tc_launches,
            "decode_attention": tc - quant, "decode_attention_f32": f32,
            "decode_attention_verify": dec_mod.multi_launches,
            "decode_attention_int8_cache": quant,
            "decode_attention_verify_int8_cache": dec_mod.multi_quant_launches,
            "quant_matmul_gemv": qm.gemv_launches, "quant_matmul_gemm": qm.gemm_launches}


class ScriptedCalls:
    """Wraps a ``ServingBackend``'s ``generate`` for one sweep: before call
    i it hands the scheduler a ``ScriptedFaultInjector`` built from
    ``script[i]`` over that call's keys (no fault past the script), and it
    keeps every call's keys."""

    def __init__(self, backend, script):
        from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector

        self.keys, outer = [], backend.generate

        def generate(prompts, settings=None, seed=0, keys=None, prefix_ids=None):
            i = len(self.keys)
            self.keys.append(list(keys))
            spec = script[i](keys) if i < len(script) else {}
            backend.fault_injector = ScriptedFaultInjector(**spec)
            backend.scheduler_for(settings).fault_injector = backend.fault_injector
            return outer(prompts, settings, seed=seed, keys=keys, prefix_ids=prefix_ids)

        backend.generate = generate


def counters_of(reg, names) -> dict:
    """The registry's counters named ``names``: {"name{k=v,...}": value}."""
    from fairness_llm_tpu_torch import telemetry as T

    return {c["name"] + "{" + ",".join(f"{k}={v}" for k, v in sorted(c["labels"].items()))
            + "}": c["value"] for c in T.snapshot(reg)["counters"] if c["name"] in names}


FAULT_COUNTERS = ("faults_total", "numerics_faults_total", "watchdog_hangs_total",
                  "serving_requeues_by_cause_total", "canary_runs_total",
                  "canary_mismatch_total", "static_fallback_calls_total")


def study_script_counters(riders: int) -> dict:
    """What ``STUDY_SCRIPT`` implies in a pool of ``riders`` slots (the NaN
    and the hang each discard a full first chunk)."""
    s = "component=serving,"
    return {f"faults_total{{{s}kind=injected,stage=prefill}}": 3,
            f"faults_total{{{s}kind=injected,stage=decode}}": 1,
            f"faults_total{{{s}kind=injected_corruption,stage=decode}}": 1,
            f"faults_total{{{s}kind=numerics,stage=decode}}": 1,
            f"faults_total{{{s}kind=injected_hang,stage=decode}}": 1,
            f"faults_total{{{s}kind=hang,stage=decode}}": 1,
            f"numerics_faults_total{{{s}stage=decode}}": 1,
            f"watchdog_hangs_total{{{s}stage=decode}}": 1,
            "serving_requeues_by_cause_total{cause=injected,component=serving}": 3,
            "serving_requeues_by_cause_total{cause=numerics,component=serving}": riders,
            "serving_requeues_by_cause_total{cause=hang,component=serving}": riders}


def without_rows(rec, drop) -> "types.SimpleNamespace":
    """A ``SweepRecorder``'s calls without the rows at (call, row) in
    ``drop``."""
    import types

    return types.SimpleNamespace(calls=[
        ([p for ri, p in enumerate(prompts) if (ci, ri) not in drop],
         [r for ri, r in enumerate(rows) if (ci, ri) not in drop])
        for ci, (prompts, rows) in enumerate(rec.calls)])


def study_contained(torch, name: str, tmp: pathlib.Path, served_card, paged: bool) -> dict:
    """Phase 26(a) for one study checkpoint: the greedy sweep through
    ``backend_for`` with guards, the watchdog, breakers and an armed
    incident engine, under ``STUDY_SCRIPT``, in phase 24's pool (or its
    paged twin). The counters must be the script's, the failed request an
    error row, every other row phase 24's greedy served row (or differing
    only at the CPU's near ties, as phase 20), the bundles valid; paged, the
    arena is never dropped and the hit ratio stays above 0.5."""
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import (
        Config,
        IntegrityConfig,
        ResilienceConfig,
        ServingConfig,
    )
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.serving import paged as paged_mod

    serving = STUDY_PAGED if paged else STUDY_SERVING
    label = f"{name} contained{' paged' if paged else ''}"
    cfg = greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                               data_dir=str(ROOT / "data" / "ml-1m"),
                               results_dir=str(tmp / name / ("cpaged" if paged else "cserved")),
                               serving=ServingConfig(**serving),
                               resilience=ResilienceConfig(**STUDY_RESILIENCE),
                               integrity=IntegrityConfig(numerics_guards=True)),
                        name, MAX_TOKENS)
    backend = backend_for(name, cfg)
    if not backend.engine.numerics_guards or backend.board is None:
        fail(f"{label}: backend_for armed no numerics guard or breakers")
    script = ScriptedCalls(backend, STUDY_SCRIPT)
    calls = SweepRecorder(backend)
    tel = tmp / name / ("ptel" if paged else "tel")
    resets = []
    real_reset = paged_mod.PagedKV.reset
    paged_mod.PagedKV.reset = lambda self: (resets.append(1), real_reset(self))[1]
    t0 = time.perf_counter()
    try:
        with T.use_registry() as reg, T.use_incident_manager(
                T.IncidentManager(str(tel / "incidents"))):
            rec = run_phase1(cfg, name, backend=backend, save=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = counters_of(reg, FAULT_COUNTERS)
            gauges = paged_gauges(reg, label) if paged else None
    finally:
        paged_mod.PagedKV.reset = real_reset
    riders = serving["num_slots"]
    want = study_script_counters(riders)
    if got != want:
        fail(f"{label}: fault counters {got}, the script implies {want}")
    totals = backend.serve_totals
    if (totals.requeued, totals.failed) != (3 + 2 * riders, 1):
        fail(f"{label}: requeued {totals.requeued}, failed {totals.failed}; the script "
             f"implies {3 + 2 * riders} and 1")
    failed_key = script.keys[0][2]
    errors = sorted(k for k, e in rec["recommendations"].items() if "error" in e)
    if errors != [failed_key] or rec["recommendations"][failed_key]["error"] != "decode_failed":
        fail(f"{label}: error rows {errors}, the script fails {failed_key} only")
    differ = greedy_divergences(label, without_rows(served_card, {(0, 2)}),
                                without_rows(calls, {(0, 2)}), backend.engine, torch,
                                against="the fault-free served rows")
    problems = T.validate_incidents(str(tel), require=True)
    bundles = sorted(b["class"] for b in T.list_bundles(str(tel / "incidents")))
    if problems or not {"numerics_fault", "watchdog_hang"} <= set(bundles):
        fail(f"{label}: incident bundles {bundles}, problems {problems}")
    row = {"model": name, "serving": serving, "wall_s": wall, "counters": got,
           "requeued": totals.requeued, "failed": totals.failed, "error_rows": errors,
           "rows_differing_from_fault_free": differ, "bundles": bundles,
           "calls": len(script.keys)}
    if paged:
        if resets or not gauges["prefix_cache_hit_ratio"] > MIN_HIT_RATIO:
            fail(f"{label}: the arena was dropped {len(resets)} times, hit ratio "
                 f"{gauges['prefix_cache_hit_ratio']}")
        row["paged"], row["arena_resets"] = gauges, len(resets)
    return row


def full_width_contained(torch, F, tmp: pathlib.Path, p24: dict, device_line: str,
                         held: set) -> tuple:
    """Phase 26(b) and (c) on phase 24's llama3-8b int8 engine. (b) the
    greedy sweep in the control pool with guards, breakers, the watchdog and
    a canary every call: no fault, no hang, no canary mismatch, every row
    phase 24's; then a direct serve of 16 prompts with one decode fault and
    one NaN (both requeue once and complete), its kernel calls held, its rows
    against the fault-free ones in bfloat16 (reported) and in float32 over
    the same weights (gated). (c) one speculative greedy engine call and an
    int8-KV serve with breakers and guards: K3 and K2q launch, no fault.
    Returns the main path's launches, the rows of the calls no earlier
    phase held, and the log row."""
    import types

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import (
        Config,
        IntegrityConfig,
        ModelSettings,
        ResilienceConfig,
        ServingConfig,
        SpeculationConfig,
    )
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.resilience import BreakerBoard
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request, ServingBackend
    from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector

    engine, want = p24["engine"], p24["greedy"]
    cfg = greedy_config(Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                               data_dir=str(ROOT / "data" / "ml-1m"),
                               results_dir=str(tmp / "contained")), MODEL, MAX_TOKENS)
    row = {"model": MODEL, "weight_quant": "int8", "device": device_line,
           "serving": CONTROL_SERVING, "resilience": FULL_WIDTH_RESILIENCE}
    resilience = ResilienceConfig(**FULL_WIDTH_RESILIENCE)
    engine.numerics_guards = True
    zero_all(dec_mod, flash_mod, qm)
    with T.use_registry() as reg, T.use_incident_manager(
            T.IncidentManager(str(tmp / "ctel" / "incidents"))), \
            flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
        # (b) the guarded sweep, a canary probe before every call
        backend = ServingBackend(engine, ServingConfig(**CONTROL_SERVING), name=MODEL,
                                 resilience=resilience,
                                 integrity=IntegrityConfig(numerics_guards=True,
                                                           canary_every_n=1))
        served = SweepRecorder(backend)
        t0 = time.perf_counter()
        run_phase1(cfg, MODEL, GATE_PROFILES, backend=backend, save=False)
        torch.cuda.synchronize()
        row["guarded_sweep_wall_s"] = time.perf_counter() - t0
        row["phase24_served_greedy_wall_s"] = p24["greedy_wall_s"]
        row["guarded_sweep"] = {**served.served_totals(), "counters": counters_of(
            reg, FAULT_COUNTERS), "watchdog_step_s_max": reg.peek(
            "watchdog_last_step_s", component="serving").value}
        runs = row["guarded_sweep"]["counters"].get("canary_runs_total{component=serving}", 0)
        if set(row["guarded_sweep"]["counters"]) != {"canary_runs_total{component=serving}"} \
                or runs != len(served.calls):
            fail(f"llama3-8b contained: the guarded sweep counted "
                 f"{row['guarded_sweep']['counters']}; only {len(served.calls)} canary runs "
                 "may be there")
        parting = [(ci, ri) for ci, (a, b) in enumerate(zip(want.calls, served.calls))
                   for ri, (x, y) in enumerate(zip(a[1], b[1])) if x != y]
        if [c[0] for c in want.calls] != [c[0] for c in served.calls] or parting:
            fail(f"llama3-8b contained: the guarded sweep's rows part from phase 24's at "
                 f"{parting}")
        row["guarded_sweep_rows"] = sum(len(c[0]) for c in served.calls)
        del backend, served
        engine.breakers = engine.watchdog = None

        # (b) one decode fault and one NaN in the first decode chunk
        prompts = want.calls[0][0][:FAULT_REQUESTS]
        settings = ModelSettings(temperature=0.0, max_tokens=FAULT_TOKENS)

        def direct(eng, faults: bool):
            inj = (ScriptedFaultInjector(faults={("r1", "decode"): 1},
                                         corruptions={("r4", "decode"): 1}) if faults else None)
            sched = ContinuousScheduler(eng, ServingConfig(**CONTROL_SERVING), settings=settings,
                                        fault_injector=inj, resilience=resilience)
            results = sched.serve([Request(prompt=p, id=f"r{i}", settings=settings)
                                   for i, p in enumerate(prompts)])
            stats = sched.last_stats.as_dict()
            del sched
            return results, stats

        before = counters_of(reg, FAULT_COUNTERS)
        t0 = time.perf_counter()
        results, stats = direct(engine, True)
        row["faulted_serve_wall_s"] = time.perf_counter() - t0
        moved = {k: v - before.get(k, 0) for k, v in counters_of(reg, FAULT_COUNTERS).items()
                 if v != before.get(k, 0)}
        want_moved = {
            "faults_total{component=serving,kind=injected,stage=decode}": 1,
            "faults_total{component=serving,kind=injected_corruption,stage=decode}": 1,
            "faults_total{component=serving,kind=numerics,stage=decode}": 1,
            "numerics_faults_total{component=serving,stage=decode}": 1,
            "serving_requeues_by_cause_total{cause=injected,component=serving}": 1,
            "serving_requeues_by_cause_total{cause=numerics,component=serving}":
                FAULT_REQUESTS - 1}
        by_id = {r.id: r for r in results}
        if moved != want_moved or not all(r.ok for r in results) \
                or (by_id["r1"].retries, by_id["r4"].retries) != (1, 1):
            fail(f"llama3-8b contained: the faulted serve moved {moved} (the script implies "
                 f"{want_moved}); outcomes {[(r.id, r.finish_reason, r.retries) for r in results]}")
        row["faulted_serve"] = {"stats": stats, "counters": moved}
        pad = engine.tokenizer.pad_id
        faulted = types.SimpleNamespace(calls=[(prompts, [_strip(r.tokens, pad)
                                                          for r in results])])
        fault_free = types.SimpleNamespace(calls=[(prompts, [
            r[:FAULT_TOKENS] for r in want.calls[0][1][:FAULT_REQUESTS]])])
        row["faulted_bf16_rows_parting"] = paged_gate(
            "llama3-8b int8 faulted serve, bf16 (reported)", fault_free, faulted, engine,
            CONTROL_SERVING, torch, f32=False, hard=False)

        # (c) speculation and the int8 KV cache, guards and breakers armed
        engine.breakers = BreakerBoard(component="engine")
        spec_out = engine.generate(prompts, settings, speculation=SpeculationConfig(enabled=True))
        row["speculative"] = spec_out.stats["speculation"]
        engine.breakers = None
        eng_q = DecodeEngine(dataclasses.replace(engine.config, kv_cache_quant=True),
                             params=engine.model.state_dict(), numerics_guards=True)
        kv_results, row["kv_int8_serve"] = direct(eng_q, False)
        if not all(r.ok for r in kv_results):
            fail("llama3-8b contained: the int8-KV serve failed a request")
        del eng_q
        torch.cuda.synchronize()
        launches = containment_counts(dec_mod, flash_mod, qm)
        if launches["flash_attention_f32"] or launches["decode_attention_f32"] \
                or dec_mod.multi_tc_launches != (dec_mod.multi_launches
                                                 + dec_mod.multi_quant_launches):
            fail(f"a bf16 launch of the full-width containment path ran no tensor-core "
                 f"kernel: {launches}, K3 on decode_verify_tc {dec_mod.multi_tc_launches}")
        final = counters_of(reg, FAULT_COUNTERS)
        if any(k.startswith("faults_total{component=engine") for k in final):
            fail(f"llama3-8b contained: the engine counted faults {final}")
        bundles = sorted(b["class"] for b in T.list_bundles(str(tmp / "ctel" / "incidents")))
    need_launches(launches, ("flash_attention", "decode_attention", "decode_attention_verify",
                             "decode_attention_int8_cache", "quant_matmul_gemv",
                             "quant_matmul_gemm"), "full-width containment")
    row["launches"], row["bundles"] = launches, bundles
    # the verify windows first: paged_rows marks every recorded key held
    verify = [(key, call) for key, call in recs["dec"].calls.items()
              if key[0] == "k3" and key[:-1] not in held and key not in held]
    kernel_rows = paged_rows(recs, torch, F, qm, "containment_full_width", False, held)
    if verify:
        vrows = [decode_numbers(call, torch, F) for _, call in verify]
        for r, (key, _) in zip(vrows, verify):
            r["path"], r["scoring"] = "containment_full_width", False
            held.add(key)
        check_rows("decode_attention_verify", vrows, "every q_offset lowered by one")
        kernel_rows["decode_attention_verify"] = vrows
    del recs

    # the float32 gate: the same two direct serves over the same weights,
    # every K4 call of the twin recorded and held (k4_f32_rows)
    with f32_k4_recording(qm) as (rec32, counts32):
        eng32 = float32_twin(engine)
        eng32.numerics_guards = True
        with T.use_registry(), T.use_incident_manager():
            f32 = [types.SimpleNamespace(calls=[(prompts, [_strip(r.tokens, pad)
                                                           for r in direct(eng32, faults)[0]])])
                   for faults in (False, True)]
        row["faulted_f32_rows_differing"] = paged_gate(
            "llama3-8b int8 faulted serve, f32", f32[0], f32[1], eng32, CONTROL_SERVING, torch,
            f32=True)
    engine.numerics_guards = False
    row["f32_twin_k4_launches"] = counts32
    kernel_rows["quant_matmul_f32"] = k4_f32_rows(rec32, counts32, torch,
                                                  "containment_full_width_f32", qm, held)
    del eng32, rec32
    return launches, {"quant_matmul_f32": counts32["quant_matmul_f32"]}, kernel_rows, row


# The child of phase 26(d) (and of phase 28(b), through a fleet of two
# replicas): the tiny-llama-study sweep through the server, its containment
# armed, indexing a tensor out of range on the card at a decode step (a
# device-side assert, sticky for the process).
FATAL_CHILD = """
import logging, pathlib, sys
import torch
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
logging.basicConfig(level=logging.WARNING)
from fairness_llm_tpu_torch.config import (Config, FleetConfig, ResilienceConfig,
                                           ServingConfig)
from fairness_llm_tpu_torch.pipeline.backends import backend_for
from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
cfg = Config(weights_dir=str(root / "checkpoints"), data_dir=str(root / "data" / "ml-1m"),
             results_dir=sys.argv[2], serving=ServingConfig(**%(serving)r),
             resilience=ResilienceConfig(enabled=True),
             fleet=FleetConfig(replicas=%(replicas)d))
backend = backend_for(%(model)r, cfg)
model, real, steps = backend.engine.model, backend.engine.model.forward, [0]
def forward(tokens, *args, **kwargs):
    if tokens.shape[1] == 1:
        steps[0] += 1
        if steps[0] == %(step)d:
            torch.zeros(4, device=tokens.device)[torch.full((1,), 1 << 20, device=tokens.device)]
    return real(tokens, *args, **kwargs)
model.forward = forward
run_phase1(cfg, %(model)r, backend=backend)
print("the sweep finished", flush=True)
"""


def fatal_child(tmp: pathlib.Path, replicas: int = 1) -> dict:
    """Phase 26(d), and with ``replicas`` 2 phase 28(b)'s: the child must
    exit non-zero, its stderr name the CUDA error, and it must leave no
    record and no checkpoint with an error row: containment never hides a
    fatal device fault, nor does a fleet count it as a replica's crash."""
    results = tmp / f"fatal_{replicas}"
    code = FATAL_CHILD % {"serving": STUDY_SERVING, "model": STUDY_MODELS[0],
                          "step": FATAL_STEP, "replicas": replicas}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT), str(results)],
                          capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    err_lines = [line for line in proc.stderr.splitlines()
                 if "CUDA error" in line or "device-side assert" in line
                 or "fatal device error" in line]
    records = sorted(str(p.relative_to(results)) for p in results.rglob("*.json"))
    finished = [p for p in records if p.endswith("phase1_results.json")]
    error_rows = [p for p in records if "decode_failed" in (results / p).read_text()]
    fenced = [line for line in proc.stderr.splitlines() if "fencing replica" in line]
    row = {"replicas": replicas, "returncode": proc.returncode, "wall_s": wall,
           "stderr_cuda_lines": err_lines[:6], "stderr_fence_lines": fenced[:4],
           "files": records, "stdout_tail": proc.stdout[-200:]}
    if proc.returncode == 0 or not err_lines or finished or error_rows or fenced \
            or "the sweep finished" in proc.stdout:
        fail(f"the fatal-error child was contained or hid the fault: {row}; stderr tail "
             f"{proc.stderr[-2000:]}")
    return row


def drain_and_resume(torch, tmp: pathlib.Path, served_card) -> dict:
    """Phase 26(e): ``request_drain(grace_s=0)`` after two scheduler steps
    preempts requests into a journal, ``resume_serving`` completes them with
    an uninterrupted run's tokens; then the CLI run with ``--serving-journal
    --numerics-guards --incidents --telemetry-dir`` gets a SIGTERM mid-run,
    ``resume-serving`` finishes its journal (both exit 0), and
    ``incident-report`` renders its telemetry dir."""
    import io
    import signal
    import types

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.cli import main as cli
    from fairness_llm_tpu_torch.config import (
        Config,
        ModelSettings,
        ResilienceConfig,
        ServingConfig,
    )
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.resilience import ServingJournal, resume_serving
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request
    from fairness_llm_tpu_torch.utils.profiling import ServingStats

    name = STUDY_MODELS[0]
    engine = backend_for(name, Config(weights_dir=str(ROOT / "checkpoints"))).engine
    prompts = served_card.calls[0][0]
    settings = ModelSettings(temperature=0.0, max_tokens=MAX_TOKENS)
    serving = ServingConfig(**STUDY_SERVING)
    resilience = ResilienceConfig(enabled=True)
    row = {"model": name}
    with T.use_registry(), T.use_incident_manager():
        base = ContinuousScheduler(engine, serving, settings=settings).serve(
            [Request(prompt=p, id=f"q{i}", settings=settings) for i, p in enumerate(prompts)])
        journal = ServingJournal(str(tmp / "journal"))
        sched = ContinuousScheduler(engine, serving, settings=settings, resilience=resilience,
                                    journal=journal)
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, id=f"q{i}", settings=settings))
        stats = ServingStats(num_slots=sched.num_slots)
        for _ in range(2):
            sched.step(stats)
        sched.request_drain(grace_s=0.0)
        sched.drain()
        outcomes = {f"q{i}": sched.take_result(f"q{i}") for i in range(len(prompts))}
        preempted = sorted(k for k, r in outcomes.items() if r.finish_reason == "preempted")
        open_ids = sorted(r["id"] for r in journal.unfinished())
        if not preempted or open_ids != preempted:
            fail(f"the drain preempted {preempted}, the journal holds {open_ids} open")
        resumed = resume_serving(engine, journal, serving=serving, resilience=resilience)
        if sorted(resumed) != preempted or not all(r.ok for r in resumed.values()) \
                or journal.unfinished():
            fail(f"resume_serving left {journal.unfinished()} open")
        journal.close()
    pad = engine.tokenizer.pad_id
    idx = [int(k[1:]) for k in preempted]
    mine = [prompts[i] for i in idx]
    row["drain"] = {"preempted": len(preempted),
                    "completed_before_drain": len(prompts) - len(preempted),
                    "rows_differing_from_uninterrupted": greedy_divergences(
                        "drain and resume",
                        types.SimpleNamespace(calls=[(mine, [_strip(base[i].tokens, pad)
                                                             for i in idx])]),
                        types.SimpleNamespace(calls=[(mine, [_strip(resumed[k].tokens, pad)
                                                             for k in preempted])]),
                        engine, torch, against="the uninterrupted serve")}
    del engine

    # the CLI: SIGTERM mid-run, then resume-serving and incident-report
    jdir, tel = tmp / "cli_journal", tmp / "cli_tel"
    args = [sys.executable, "-m", "fairness_llm_tpu_torch.cli.main", "--phase", "1",
            "--model", name, "--weights-dir", str(ROOT / "checkpoints"), "--data-dir",
            str(ROOT / "data" / "ml-1m"), "--results-dir", str(tmp / "cli"), "--continuous",
            "--serving-journal", str(jdir), "--numerics-guards", "--incidents",
            "--telemetry-dir", str(tel)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    journal_file = jdir / "journal.jsonl"
    while time.perf_counter() - t0 < 300 and proc.poll() is None and not (
            journal_file.exists() and journal_file.stat().st_size):
        time.sleep(0.02)
    signalled = proc.poll() is None
    if signalled:
        proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=600)
    cli_row = {"returncode": proc.returncode, "signalled": signalled,
               "wall_s": time.perf_counter() - t0,
               "drained": "drained by a signal" in out,
               "open_after_run": len(ServingJournal(str(jdir)).unfinished())}
    if proc.returncode != 0 or not signalled:
        fail(f"the journaled CLI run: {cli_row}; stderr tail {err[-2000:]}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "fairness_llm_tpu_torch.cli.main",
                          "resume-serving", str(jdir), "--model", name, "--weights-dir",
                          str(ROOT / "checkpoints")], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=600)
    cli_row.update(resume_returncode=res.returncode, resume_wall_s=time.perf_counter() - t0,
                   resume_said=[line for line in res.stdout.splitlines()
                                if line.startswith("resumed")],
                   open_after_resume=len(ServingJournal(str(jdir)).unfinished()))
    if res.returncode != 0 or cli_row["open_after_resume"]:
        fail(f"resume-serving: {cli_row}; stderr tail {res.stderr[-2000:]}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["incident-report", str(tel)])
    report = buf.getvalue()
    if rc != 0 or not report.strip():
        fail(f"incident-report exited {rc}: {report[-500:]}")
    cli_row["incident_report_lines"] = len(report.splitlines())
    cli_row["bundles"] = sorted(b["class"] for b in T.list_bundles(str(tel / "incidents")))
    row["cli"] = cli_row
    return row


def containment_path(torch, F, device_line: str, p24: dict, held: set) -> dict:
    """Phase 26. Returns each kernels-line entry's launches on the main
    path's runs (the first study model's contained sweeps, "study";
    FULL_WIDTH) and the rows of the kernel calls no earlier phase held;
    phase 24's full-width engine stays for phase 27."""
    import gc
    import tempfile

    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    launches, rows = {}, {}
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        zero_all(dec_mod, flash_mod, qm)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            for name in DRILL_MODELS:
                for paged in (False, True):
                    row = study_contained(torch, name, tmp, p24["greedy_card"][name], paged)
                    log(f"containment_study {json.dumps({'device': device_line, **row})}")
        launches["study"] = containment_counts(dec_mod, flash_mod, qm)
        need_launches(launches["study"], ("flash_attention_f32", "decode_attention_f32"),
                      "study containment")
        for k, v in sweep_kernel_rows(recs, torch, F, qm, "containment_study", True,
                                      held).items():
            if v:
                rows.setdefault(k, []).extend(v)
        del recs
        gc.collect()
        full = p24["full_width"]
        launches[FULL_WIDTH], launches[FULL_WIDTH + "_f32"], full_rows, row = \
            full_width_contained(torch, F, tmp, full, device_line, held)
        log(f"containment_full_width {json.dumps(row)}")
        for k, v in full_rows.items():
            rows.setdefault(k, []).extend(v)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"containment_fatal {json.dumps(fatal_child(tmp))}")
        drained = drain_and_resume(torch, tmp, p24["greedy_card"][STUDY_MODELS[0]])
        log(f"containment_drain {json.dumps(drained)}")
    return {"launches": launches, "rows": rows}


# Phase 27: overload control with its QoS queues (serving/overload.py,
# ClassedAdmissionQueue, --overload) and the fairness monitor
# (telemetry/fairness.py, --fairness-obs), after phase 26.
#
# (a) The CLI's --all run with both on, non-paged and paged, on each study
# checkpoint in phase 24's pool: a fault-free study, so the ladder stays at
# 0 and the monitor silent.
STUDY_OVERLOAD_ARGS = ["--continuous", "--slots", str(STUDY_SERVING["num_slots"]), "--overload",
                       "--fairness-obs"]
# (b) The flood on phase 24's llama3-8b int8 engine: 64 batch and 16
# interactive greedy requests (every fifth interactive) of the sweep's
# prompts in the control pool's shape, with a queue of 32. The queue-depth
# signal drives the ladder: at three quarters of the queue within a
# one-second window it climbs a rung an evaluation (every 0.2 s), and each
# step down needs FLOOD_HEALTHY_S of health (--shed-healthy-window). The SLO
# targets are set far above the flood's latencies, so that the burn signal
# stays cold and the descent is the healthy window's alone.
FLOOD_BATCH, FLOOD_INTERACTIVE, FLOOD_TOKENS, FLOOD_HEALTHY_S = 64, 16, 16, 0.5
FLOOD_SERVING = dict(CONTROL_SERVING, queue_capacity=32)
FLOOD_OVERLOAD = dict(enabled=True, queue_frac_threshold=0.75, queue_window_s=1.0,
                      healthy_window_s=FLOOD_HEALTHY_S, eval_interval_s=0.2, batch_token_cap=8)
FLOOD_SLO = dict(ttft_p95_s=600.0, e2e_p99_s=1200.0)
# (c) The deadline of the doomed request, once the flood warmed the
# prefill and per-token histograms the estimator reads.
DOOMED_DEADLINE_S = 0.001


def overload_counts(dec_mod, flash_mod, qm) -> dict:
    """``containment_counts`` of a bf16 run, every K1 and K2 launch of
    which must be on its tensor-core kernel."""
    launches = containment_counts(dec_mod, flash_mod, qm)
    if launches["flash_attention_f32"] or launches["decode_attention_f32"]:
        fail(f"a bf16 launch of the overload path ran no tensor-core kernel: {launches}")
    return launches


def rehold(recs, held: set, qm) -> set:
    """``held`` less, for each kernel (K1, K2, K4's GEMV and GEMM regimes)
    whose every call of this run an earlier phase held, this run's first
    call of it: so that ``sweep_kernel_rows`` holds every kernel of the
    path at this phase's shapes, and the calls no earlier phase held."""
    keys = {
        "k1": list(recs["k1"].calls),
        "k2": [k for k in recs["dec"].calls if k[0] == "k2"],
        "gemv": [k for r in ("k4", "group") for k in recs[r].calls
                 if k[1][0] <= qm.GEMV_MAX_M],
        "gemm": [k for k in recs["k4"].calls if k[1][0] > qm.GEMV_MAX_M]}
    keep = set(held)
    for ks in keys.values():
        if ks and all(k in held or k[:-1] in held for k in ks):
            keep.discard(ks[0])
            keep.discard(ks[0][:-1])
    return keep


def overload_cli_run(torch, name: str, tmp: pathlib.Path, paged: bool, want: dict) -> dict:
    """Phase 27(a) for one study checkpoint: the CLI's ``--all
    --continuous --overload --fairness-obs --telemetry-dir`` run (with
    ``--paged-kv`` when ``paged``). Exit 0; the snapshot and ``trace.json``
    valid; the ladder armed and at 0, nothing shed; the fairness check
    (``check_fairness``: live within FAIRNESS_TOLERANCE of offline, pairs
    joined, no divergent pair, no alert) passing, also through
    ``fairness-report --validate --fail-on-alert``; paged, the paged gauges
    there; and the phase-1 responses those of the same t=0.7 sweep in the
    same pool without overload control and the monitor (``want``: phase
    24's, or paged phase 25's)."""
    import io

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.cli import main as cli

    label = f"{name} overload{' paged' if paged else ''} CLI"
    tel, results = tmp / f"{name}_{int(paged)}_tel", tmp / f"{name}_{int(paged)}_cli"
    args = (["--all", "--model", name, "--weights-dir", str(ROOT / "checkpoints"),
             "--data-dir", str(ROOT / "data" / "ml-1m"), "--results-dir", str(results),
             "--telemetry-dir", str(tel)] + STUDY_OVERLOAD_ARGS + (["--paged-kv"] if paged else []))
    out = io.StringIO()
    t0 = time.perf_counter()
    with T.use_registry(), T.use_timeline(), T.use_fairness_monitor(), \
            T.use_incident_manager(), contextlib.redirect_stdout(out):
        rc = cli.main(args)
        report_rc = cli.main(["fairness-report", str(tel), "--validate", "--fail-on-alert"])
    wall = time.perf_counter() - t0
    if rc != 0 or report_rc != 0:
        fail(f"{label}: exit {rc}, fairness-report exit {report_rc}: {out.getvalue()[-3000:]}")
    snap = T.load_snapshot(str(tel))
    trace = json.loads((tel / T.TRACE_FILENAME).read_text())
    problems = T.validate_snapshot(snap) + T.validate_chrome_trace(trace)
    fairness = T.check_fairness(snap)
    gauges = {(g["name"], g["labels"].get("component")): g["value"] for g in snap["gauges"]}
    sheds = [c for c in snap["counters"] if c["name"] == "shed_total"]
    if problems or fairness or gauges.get(("overload_level", "serving")) != 0 or sheds:
        fail(f"{label}: snapshot problems {problems[:5]}, fairness {fairness}, overload level "
             f"{gauges.get(('overload_level', 'serving'))}, sheds {sheds}")
    missing = [g for g in PAGED_GAUGES if (g, "paged_kv") not in gauges] if paged else []
    if missing:
        fail(f"{label}: the snapshot holds no {missing}")
    rec = json.loads((results / "phase1" / "phase1_results.json").read_text())
    if raw_responses(rec) != want["raw"] \
            or rec["neutral_recommendations"] != want["neutral"]:
        parting = sorted(k for k, v in raw_responses(rec).items() if want["raw"].get(k) != v)
        fail(f"{label}: the responses part from the same sweep without overload control and "
             f"the monitor at {parting[:8]} ({len(parting)} rows)")
    block = rec["metadata"]["fairness"]
    return {"model": name, "paged": paged, "argv": args, "wall_s": wall,
            "fairness_live": block["live"], "fairness_offline": block["offline"],
            "serving": rec["metadata"]["serving"], "rows_equal": len(want["raw"]),
            "trace_events": len(trace["traceEvents"]),
            "paged_gauges": {g: gauges[(g, "paged_kv")] for g in PAGED_GAUGES} if paged else None,
            "report_lines": len(out.getvalue().splitlines())}


def overload_flood(torch, F, tmp: pathlib.Path, p24: dict, held: set) -> tuple:
    """Phase 27(b) and (c) on phase 24's llama3-8b int8 engine. (b) the
    flood (FLOOD_*): the ladder climbs to rung 1 at least and is back at 0
    within FLOOD_HEALTHY_S a rung after the queue drains; every interactive
    request completes, its greedy row that of the same request served
    without overload control in a pool of the same shape (``paged_gate``:
    parting only at the kernels' bf16 allowance); a batch request sheds with
    a retry-after; K1, K2 and K4 launch on their tensor-core kernels and
    each is held against its plain version at this phase's shapes. (c) In a
    fresh registry, the first prefill's sample and the estimate it alone
    gives (what an unwarmed process would shed on); then, warm, a request
    with a 1 ms deadline sheds ``deadline_infeasible`` at submit() and no
    prefill runs for it. Returns the launches, the kernel rows and the log
    row."""
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import ModelSettings, OverloadConfig, ServingConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.serving import ContinuousScheduler, Request

    engine = p24["engine"]
    prompts = [p for call in p24["greedy"].calls for p in call[0]]
    settings = ModelSettings(temperature=0.0, max_tokens=FLOOD_TOKENS)
    n = FLOOD_BATCH + FLOOD_INTERACTIVE
    qos = ["interactive" if i % 5 == 4 else "batch" for i in range(n)]
    buckets = sorted({-(-len(engine.tokenizer.encode(p)) // engine.seq_bucket)
                      * engine.seq_bucket for p in prompts})

    def flood_requests():
        return [Request(prompt=prompts[i % len(prompts)], id=f"{qos[i][0]}{i:02d}", qos=qos[i],
                        settings=settings) for i in range(n)]

    row = {"model": MODEL, "weight_quant": "int8", "serving": FLOOD_SERVING,
           "overload": FLOOD_OVERLOAD, "slo_targets": FLOOD_SLO, "prompt_buckets": buckets}
    prev = T.set_slo_targets(T.SLOTargets(**FLOOD_SLO))
    try:
        zero_all(dec_mod, flash_mod, qm)
        with T.use_registry() as reg, T.use_timeline(), T.use_incident_manager(), \
                flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            sched = ContinuousScheduler(engine, ServingConfig(**FLOOD_SERVING),
                                        settings=settings,
                                        overload=OverloadConfig(**FLOOD_OVERLOAD))
            ctl, t_start, ladder = sched.shed_controller, time.monotonic(), []
            real = ctl._transition

            def transition(to, reason, now):
                ladder.append({"t_s": now - t_start, "from": ctl.level, "to": to,
                               "reason": reason})
                real(to, reason, now)

            ctl._transition = transition
            t0 = time.perf_counter()
            results = sched.serve(flood_requests())
            torch.cuda.synchronize()
            row["flood_wall_s"] = time.perf_counter() - t0
            row["flood_stats"] = sched.last_stats.as_dict()
            row["level_at_end_of_serve"] = ctl.level
            # the descent: evaluate until the ladder is back at 0
            t_drained = time.monotonic()
            while ctl.level > 0 and time.monotonic() - t_drained < 10 + 4 * FLOOD_HEALTHY_S:
                ctl.evaluate()
                time.sleep(0.02)
            row["ladder"] = ladder
            row["descent_s_after_serve"] = time.monotonic() - t_drained
            launches = overload_counts(dec_mod, flash_mod, qm)
            shed = [r for r in results if r.finish_reason == "shed"]
            by_class = {c: [r for r, q in zip(results, qos) if q == c]
                        for c in ("batch", "interactive")}
            row["outcomes"] = {c: {reason: sum(r.finish_reason == reason for r in rs)
                                   for reason in sorted({r.finish_reason for r in rs})}
                               for c, rs in by_class.items()}
            row["retry_after_s"] = sorted({r.retry_after_s for r in shed})
            row["shed_total"] = counters_of(reg, ("shed_total",))
            row["overload_transitions"] = counters_of(reg, ("overload_transitions_total",))
            peak = max((t["to"] for t in ladder), default=0)
            if peak < 1 or ctl.level != 0 or not shed \
                    or not all(r.retry_after_s and r.retry_after_s > 0 for r in shed) \
                    or any(q != "batch" for r, q in zip(results, qos) if r.finish_reason == "shed") \
                    or not all(r.ok for r in by_class["interactive"]):
                fail(f"llama3-8b overload flood: ladder {ladder}, level {ctl.level}, outcomes "
                     f"{row['outcomes']}, retry-after {row['retry_after_s']}")

            # (c) a fresh registry: the first prefill's sample alone, then
            # the warm flood registry's doomed request
            with T.use_registry():
                cold = ContinuousScheduler(engine, ServingConfig(**FLOOD_SERVING),
                                           settings=settings,
                                           overload=OverloadConfig(**FLOOD_OVERLOAD))
                t0 = time.perf_counter()
                cold.serve([Request(prompt="a short request", id="cold", settings=settings)])
                torch.cuda.synchronize()
                first = T.get_registry().peek("prefill_wall_s", component="serving")
                est = cold.deadline_estimator.estimate_ttft_s(0, cold.num_slots,
                                                               cold.decode_chunk)
                row["unwarmed"] = {"first_call_wall_s": time.perf_counter() - t0,
                                   "prefill_samples": first.count,
                                   "prefill_p50_s": first.percentile(50),
                                   "estimate_ttft_s": est,
                                   "sheds_deadlines_below_s":
                                       cold.deadline_estimator.safety * est}
                del cold
            before = reg.read_value("serving_prefill_batches_total", component="serving")
            doomed = Request(prompt=prompts[0], id="doomed", qos="interactive",
                             settings=settings, deadline_s=DOOMED_DEADLINE_S)
            accepted = sched.submit(doomed)
            res = sched.take_result("doomed")
            stats = sched.drain()
            after = reg.read_value("serving_prefill_batches_total", component="serving")
            warm = reg.peek("prefill_wall_s", component="serving")
            row["doomed"] = {"accepted": accepted, "finish_reason": res and res.finish_reason,
                             "error": res and res.error, "retry_after_s": res and res.retry_after_s,
                             "prefill_batches": stats.prefill_batches,
                             "prefill_batches_total_moved": after - before,
                             "warm_prefill_p50_s": warm.percentile(50),
                             "warm_prefill_samples": warm.count,
                             "shed_total": counters_of(reg, ("shed_total",))}
            if accepted or res is None or res.finish_reason != "shed" \
                    or "unmeetable" not in (res.error or "") or stats.prefill_batches \
                    or after != before or reg.read_value(
                        "shed_total", component="serving",
                        **{"class": "interactive", "reason": "deadline_infeasible"}) != 1:
                fail(f"llama3-8b overload: the doomed request was not shed before a prefill: "
                     f"{row['doomed']}")
            del sched
        need_launches(launches, ("flash_attention", "decode_attention", "quant_matmul_gemv",
                                 "quant_matmul_gemm"), "full-width overload")
        row["launches"] = launches
        keep = rehold(recs, held, qm)
        kernel_rows = paged_rows(recs, torch, F, qm, "overload_full_width", False, keep)
        held |= keep
        del recs

        # the interactive rows against the same requests served alone without
        # overload control, in a pool of the same shape
        control = ContinuousScheduler(engine, ServingConfig(**FLOOD_SERVING), settings=settings)
        alone = control.serve([r for r in flood_requests() if r.qos == "interactive"])
        del control
    finally:
        T.set_slo_targets(prev)
    import types

    pad = engine.tokenizer.pad_id
    mine = [p for p, q in zip([r.prompt for r in flood_requests()], qos) if q == "interactive"]
    row["interactive_rows_parting"] = paged_gate(
        "llama3-8b overload flood, interactive rows", types.SimpleNamespace(
            calls=[(mine, [_strip(r.tokens, pad) for r in alone])]),
        types.SimpleNamespace(calls=[(mine, [_strip(r.tokens, pad)
                                             for r in by_class["interactive"]])]),
        engine, FLOOD_SERVING, torch, f32=False)
    row["interactive_rows"] = len(mine)
    return launches, kernel_rows, row


def biased_fault_drill(torch, tmp: pathlib.Path) -> dict:
    """Phase 27(d): the greedy phase-1 sweep on the first study checkpoint
    through ``backend_for`` with the monitor on, in phase 24's pool, every
    female profile's request faulting twice (so failing): the neutrality
    audit must alert on gender (impaired and fault rates) and not on age,
    the failures and the divergent pairs' failed members must all be the
    female group's, and the alert must be in the events."""
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import Config, ServingConfig, TelemetryConfig
    from fairness_llm_tpu_torch.data.movielens import load_movielens
    from fairness_llm_tpu_torch.data.profiles import create_base_preferences, create_profile_grid
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector

    name = STUDY_MODELS[0]
    cfg = greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                               data_dir=str(ROOT / "data" / "ml-1m"),
                               results_dir=str(tmp / "biased"),
                               serving=ServingConfig(**STUDY_SERVING),
                               telemetry=TelemetryConfig(fairness_obs=True)), name, MAX_TOKENS)
    data = load_movielens(cfg.data_dir, seed=cfg.random_seed)
    profiles = create_profile_grid(create_base_preferences(data, seed=cfg.random_seed), cfg)
    group = {p.id: p.gender for p in profiles}
    faulted = sorted(k for k, g in group.items() if g == "female")
    backend = backend_for(name, cfg)
    backend.fault_injector = ScriptedFaultInjector(faults={k: 2 for k in faulted})
    tel = tmp / "biased_tel"
    t0 = time.perf_counter()
    with T.use_registry() as reg, T.use_fairness_monitor() as mon, T.use_incident_manager():
        sink = T.configure(str(tel))
        try:
            rec = run_phase1(cfg, name, backend=backend, save=False)
        finally:
            T.install_event_sink(None)
            sink.close()
        snap = T.snapshot(reg)
        divergent = list(mon.divergent)
    wall = time.perf_counter() - t0
    alerts = {(c["labels"]["attribute"], c["labels"]["signal"]): c["value"]
              for c in snap["counters"] if c["name"] == "fairness_alerts_total"}
    failed_groups = sorted({(c["labels"]["attribute"], c["labels"]["group"])
                            for c in snap["counters"] if c["name"] == "fairness_requests_total"
                            and c["labels"]["outcome"] == "failed"
                            and c["labels"]["attribute"] == "gender"})
    rates = {c["labels"]["group"]: 0 for c in snap["counters"]
             if c["name"] == "fairness_requests_total" and c["labels"]["attribute"] == "gender"}
    for c in snap["counters"]:
        if c["name"] == "fairness_requests_total" and c["labels"]["attribute"] == "gender" \
                and c["labels"]["outcome"] == "failed":
            rates[c["labels"]["group"]] += c["value"]
    named = max(rates, key=rates.get) if rates else None
    events = [e for e in T.read_events(str(tel / "events.jsonl")) if e["kind"] == "fairness_alert"]
    errors = sorted(k for k, e in rec["recommendations"].items() if "error" in e)
    bad_members = sorted({m for d in divergent for m, v in d["members"].items()
                          if v["outcome"] == "failed"})
    row = {"model": name, "faulted": len(faulted), "wall_s": wall,
           "alerts": {f"{a}/{s}": v for (a, s), v in alerts.items()},
           "failed_groups": failed_groups, "named_group": named,
           "alert_events": [{k: e.get(k) for k in ("attribute", "signal", "disparity")}
                            for e in events],
           "divergent_pairs": len(divergent), "error_rows": len(errors)}
    if not alerts.get(("gender", "impaired_rate")) or any(a == "age" for a, _ in alerts) \
            or failed_groups != [("gender", "female")] or named != "female" \
            or not any(e.get("attribute") == "gender" for e in events) \
            or errors != faulted or not divergent \
            or any(group.get(m) != "female" for m in bad_members):
        fail(f"the biased fault drill: {row}, failed members {bad_members[:6]}")
    return row


def overload_path(torch, F, device_line: str, p24: dict, held: set) -> dict:
    """Phase 27. Returns each kernels-line entry's launches on the main
    path's runs (the first study model's CLI runs, "study"; the flood,
    FULL_WIDTH) and the rows of its kernel calls."""
    import gc
    import tempfile

    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    launches, rows = {}, {}
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        zero_all(dec_mod, flash_mod, qm)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            for name in DRILL_MODELS:
                for paged in (False, True):
                    want = p24["t07_paged" if paged else "t07"][name]
                    row = overload_cli_run(torch, name, tmp, paged, want)
                    log(f"overload_study_cli {json.dumps({'device': device_line, **row})}")
        launches["study"] = containment_counts(dec_mod, flash_mod, qm)
        need_launches(launches["study"], ("flash_attention_f32", "decode_attention_f32"),
                      "study overload")
        if launches["study"]["flash_attention"] or launches["study"]["decode_attention"]:
            fail(f"the study CLI runs launched a tensor-core kernel: {launches['study']}")
        keep = rehold(recs, held, qm)
        for k, v in sweep_kernel_rows(recs, torch, F, qm, "overload_study", True,
                                      keep).items():
            if v:
                rows.setdefault(k, []).extend(v)
        held |= keep
        del recs
        gc.collect()
        launches[FULL_WIDTH], full_rows, row = overload_flood(torch, F, tmp, p24["full_width"],
                                                              held)
        log(f"overload_full_width {json.dumps({'device': device_line, **row})}")
        for k, v in full_rows.items():
            rows.setdefault(k, []).extend(v)
        log(f"overload_biased_drill {json.dumps(biased_fault_drill(torch, tmp))}")
    return {"launches": launches, "rows": rows}


# Phase 28: the replica fleet (serving/router.py, serving/fleet.py,
# serving/autoscaler.py, serving/replay.py, serving/rollout.py; --replicas,
# --autoscale, the rollout subcommand), after phase 27.
#
# (a) The CLI's phase-1 sweep through two replicas of phase 24's pool on each
# study checkpoint, with the journal and the telemetry export.
FLEET_CLI_ARGS = ["--continuous", "--slots", str(STUDY_SERVING["num_slots"]), "--replicas", "2"]
# (b) Two replicas of the control pool's shape over phase 24's llama3-8b
# int8 engine (one weight tree, two pools). A crash fences r0 after this
# many health polls (each fleet tick polls every replica once); its breakers
# are forced open and half-open after FLEET_RESILIENCE's cooldown, so that
# the canary-gated rejoin comes within a second of the crash.
CRASH_POLLS = 3
# The gate's and the drills' requests decode this many tokens, each row held
# against the first FLEET_TOKENS of phase 24's.
FLEET_TOKENS = 32
FLEET_RESILIENCE = dict(enabled=True, max_step_seconds=60.0, breaker_cooldown_s=0.5)
FLEET_KNOBS = dict(replicas=2, fence_cooldown_s=0.2)
# (c) One replica of the control pool's shape with a fleet queue of 4
# (replicas queue 4 each): a replayed burst of the gate's 16 prompts, 16 or
# 32 tokens each, backs the fleet queue up to half its capacity, which for
# ELASTIC's up_window_s adds a canary-gated standby; the quiet tail retires
# one. The trace (ELASTIC_TRACE: 38 requests in 40 trace seconds, 34 of them
# in a 40x burst from 10 s to 25 s) replays at ELASTIC_COMPRESSION (3.3 s of
# wall, the burst in 1.3 s) with a tail of ELASTIC_TAIL_S trace seconds (5.3
# s of wall for the backlog to drain and the cold window to pass; where the
# backlog outlasts it, the fleet ticks on idle until the standby retires).
# The SLO targets (FLOOD_SLO) stay far above the burst's latencies, so that
# the queue depth alone drives the controller.
ELASTIC_SERVING = dict(CONTROL_SERVING, queue_capacity=4)
ELASTIC = dict(enabled=True, min_replicas=1, max_replicas=2, up_queue_frac=0.5,
               up_window_s=0.5, down_queue_frac=0.0, down_load_frac=0.5, down_window_s=1.0,
               cooldown_s=0.5, eval_interval_s=0.1)
ELASTIC_TRACE = dict(seed=28, duration_s=40.0, base_sessions_per_s=0.05, think_time_s=20.0,
                     session_max_turns=3, bursts=((10.0, 15.0, 40.0),),
                     max_tokens_choices=(16, 32), interactive_frac=0.5)
ELASTIC_COMPRESSION, ELASTIC_TAIL_S = 12.0, 64.0
# device memory after a retirement against before the scale-up
RETIRE_MEM_SLACK = 0.05


def fleet_cli_run(torch, name: str, tmp: pathlib.Path, want: dict) -> dict:
    """Phase 28(a) for one study checkpoint: the CLI's ``--phase 1
    --continuous --slots 8 --replicas 2 --serving-journal --telemetry-dir``
    run. Exit 0; every phase-1 response that of phase 24's t=0.7 sweep in
    one pool of the same shape (``want``: the noise is keyed on the row
    seed and the token index, so routing changes no row); the journal with
    no unfinished request; ``fleet_healthy_replicas`` 2 of 2; the snapshot
    valid, and the fleet gate (``check_fleet``) finding only that no
    replica was fenced, a fault-free run's two problems."""
    import io

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.cli import main as cli
    from fairness_llm_tpu_torch.resilience import ServingJournal
    from fairness_llm_tpu_torch.serving.fleet import check_fleet

    label = f"{name} fleet CLI"
    tel, results, journal = (tmp / f"{name}_fleet_tel", tmp / f"{name}_fleet",
                             tmp / f"{name}_fleet_journal")
    args = (["--phase", "1", "--model", name, "--weights-dir", str(ROOT / "checkpoints"),
             "--data-dir", str(ROOT / "data" / "ml-1m"), "--results-dir", str(results),
             "--serving-journal", str(journal), "--telemetry-dir", str(tel)] + FLEET_CLI_ARGS)
    out = io.StringIO()
    t0 = time.perf_counter()
    with T.use_registry(), T.use_timeline(), T.use_fairness_monitor(), \
            T.use_incident_manager(), contextlib.redirect_stdout(out):
        rc = cli.main(args)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"{label}: exit {rc}: {out.getvalue()[-3000:]}")
    snap = T.load_snapshot(str(tel))
    gauges = {(g["name"], tuple(sorted(g["labels"].items()))): g["value"]
              for g in snap["gauges"]}
    fleet = {k[0]: v for k, v in gauges.items() if k[1] == (("component", "fleet"),)}
    problems = T.validate_snapshot(snap)
    gate = check_fleet(snap)
    unfinished = ServingJournal(str(journal)).unfinished()
    fault_free = {"fleet_fenced_total is zero (no replica was ever fenced)",
                  "fleet_migrated_requests_total is zero (failover never migrated anything)"}
    if problems or unfinished or fleet.get("fleet_healthy_replicas") != 2 \
            or fleet.get("fleet_replicas") != 2 or not set(gate) <= fault_free:
        fail(f"{label}: snapshot problems {problems[:5]}, {len(unfinished)} unfinished "
             f"journal records, fleet gauges {fleet}, fleet gate {gate}")
    rec = json.loads((results / "phase1" / "phase1_results.json").read_text())
    if raw_responses(rec) != want["raw"] or rec["neutral_recommendations"] != want["neutral"]:
        parting = sorted(k for k, v in raw_responses(rec).items() if want["raw"].get(k) != v)
        fail(f"{label}: the responses part from phase 24's single pool at {parting[:8]} "
             f"({len(parting)} rows)")
    served = {g: sum(c["value"] for c in snap["counters"]
                     if c["name"] == "serving_completed_total"
                     and c["labels"].get("replica") == g) for g in ("r0", "r1")}
    if not all(served.values()):
        fail(f"{label}: a replica served nothing: {served}")
    return {"model": name, "argv": args, "wall_s": wall, "serving": rec["metadata"]["serving"],
            "rows_equal": len(want["raw"]), "completed_by_replica": served,
            "fleet_gauges": fleet, "fleet_gate": gate, "journal_unfinished": len(unfinished)}


def fleet_rows(results, pad: int) -> list:
    return [_strip(r.tokens, pad) for r in results]


def full_width_fleet(torch, F, tmp: pathlib.Path, p24: dict, held: set) -> tuple:
    """Phase 28(b) and (c) on a llama3-8b int8 engine (``p24``: its engine
    and its greedy rows in a control pool, as phase 24 gives them;
    ``full_depth_control``'s at full depth). (b) Two
    replicas of the control pool's shape: the 16 gate prompts greedy
    (FLEET_TOKENS), each row that pool's served row cut to as many tokens
    (``paged_gate``: parting only within the kernels' bf16 allowance); then the same requests again with r0 crashing
    after CRASH_POLLS health polls: fenced, its unfinished requests migrated
    to r1 at the head of its queue, every request complete with the
    fault-free row, r0 back through the canary recorded in a pool of its
    shape; ``check_fleet`` clean. (c) One replica with autoscale under a
    replayed burst: 1 -> 2 (a canary-gated standby) -> 1, every replayed
    row the gate's cut to its budget, no request lost; then a retirement
    with rows in flight, which migrate and finish with the gate's rows;
    after each retirement the device memory allocated within
    RETIRE_MEM_SLACK of its value before the scale-up. K1, K2 and K4 launch
    on their tensor-core kernels and are held against their plain versions
    at this phase's shapes. Returns the launches, the kernel rows and the
    two log rows."""
    import gc
    import types

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import (
        AutoscaleConfig,
        FleetConfig,
        IntegrityConfig,
        ModelSettings,
        ResilienceConfig,
        ServingConfig,
    )
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.serving import Autoscaler, ReplayDriver, ReplicaSet, Request
    from fairness_llm_tpu_torch.serving.autoscaler import check_autoscale
    from fairness_llm_tpu_torch.serving.fleet import check_fleet
    from fairness_llm_tpu_torch.serving.replay import TraceConfig, generate_trace
    from fairness_llm_tpu_torch.utils.failures import ScriptedFaultInjector

    engine = p24["engine"]
    pad = engine.tokenizer.pad_id
    gate_calls = p24["greedy"].calls
    gate_prompts = [p for call in gate_calls for p in call[0]]
    gate_rows = {p: r for prompts, rows in gate_calls for p, r in zip(prompts, rows)}

    def bucket(p):
        return -(-len(engine.tokenizer.encode(p)) // engine.seq_bucket) * engine.seq_bucket

    # The gate prompts of the largest prefill bucket (15 of the 16; the
    # neutral prompt buckets one lower): a prefill group pads every row to
    # its largest bucket, so these keep phase 24's layout in any group the
    # fleet forms, and their bf16 rows must equal phase 24's exactly. A row
    # prefilled at another padded length sums in another order, and over
    # many random-weight layers such rows part at gaps over a kernel's allowance
    # (PERF.md §6, the paged sweeps).
    top = max(bucket(p) for p in gate_prompts)
    prompts = [p for p in gate_prompts if bucket(p) == top]
    settings = ModelSettings(temperature=0.0, max_tokens=FLEET_TOKENS)
    fleet_row = {"model": MODEL, "weight_quant": "int8", "serving": CONTROL_SERVING,
                 "fleet": FLEET_KNOBS, "resilience": FLEET_RESILIENCE,
                 "crash_polls": CRASH_POLLS, "tokens": FLEET_TOKENS}
    elastic_row = {"serving": ELASTIC_SERVING, "autoscale": ELASTIC, "trace": ELASTIC_TRACE,
                   "compression": ELASTIC_COMPRESSION, "tail_s": ELASTIC_TAIL_S,
                   "slo_targets": FLOOD_SLO}

    def requests(tag):
        return [Request(prompt=prompts[i % len(prompts)], id=f"{tag}{i:02d}", settings=settings)
                for i in range(len(gate_prompts))]

    def against_gate(label, got_prompts, got, budgets=None):
        want = [gate_rows[p][:b]
                for p, b in zip(got_prompts, budgets or [FLEET_TOKENS] * len(got_prompts))]
        return paged_gate(label, types.SimpleNamespace(calls=[(got_prompts, want)]),
                          types.SimpleNamespace(calls=[(got_prompts, got)]), engine,
                          CONTROL_SERVING, torch, f32=False)

    prev = T.set_slo_targets(T.SLOTargets(**FLOOD_SLO))
    try:
        zero_all(dec_mod, flash_mod, qm)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            # (b) the gate, then the crash
            with T.use_registry() as reg, T.use_timeline(), T.use_incident_manager():
                fleet = ReplicaSet(engine, ServingConfig(**CONTROL_SERVING), settings=settings,
                                   fleet=FleetConfig(**FLEET_KNOBS),
                                   resilience=ResilienceConfig(**FLEET_RESILIENCE),
                                   integrity=IntegrityConfig())
                t0 = time.perf_counter()
                results = fleet.serve(requests("g"))
                torch.cuda.synchronize()
                fleet_row["gate_wall_s"] = time.perf_counter() - t0
                fleet_row["gate_stats"] = fleet.last_stats.as_dict()
                fleet_row["gate_by_replica"] = {
                    rep.name: reg.read_value("serving_completed_total", component="serving",
                                             replica=rep.name) for rep in fleet.replicas}
                if not all(r.ok for r in results) or not all(fleet_row["gate_by_replica"].values()):
                    fail(f"llama3-8b fleet gate: {fleet_row}")
                fleet_row["gate_prompt_bucket"] = top
                fleet_row["gate_rows_parting"] = against_gate(
                    "llama3-8b fleet gate against phase 24's pool", [r.prompt for r in
                                                                    requests("g")],
                    fleet_rows(results, pad))
                inj = ScriptedFaultInjector(replica_crashes={"r0": CRASH_POLLS})
                fleet.fault_injector = inj
                probes = []
                real_probe = fleet._rejoin_probe

                def timed_probe(rep):
                    t = time.perf_counter()
                    ok = real_probe(rep)
                    torch.cuda.synchronize()
                    probes.append({"replica": rep.name, "ok": ok,
                                   "s": time.perf_counter() - t})
                    return ok

                fleet._rejoin_probe = timed_probe
                submitted = []
                for rep in fleet.replicas:
                    real_submit = rep.sched.submit

                    def spy(req, front=False, restamp=True, _real=real_submit, _rep=rep.name):
                        submitted.append((req.id, _rep, front, req.row_seed))
                        return _real(req, front=front, restamp=restamp)

                    rep.sched.submit = spy
                t0 = time.perf_counter()
                results = fleet.serve(requests("c"))
                torch.cuda.synchronize()
                fleet_row["crash_serve_wall_s"] = time.perf_counter() - t0
                whole = fleet.await_recovery(timeout_s=60.0)
                fleet_row["recovered_wall_s"] = time.perf_counter() - t0
                snap = T.snapshot(reg)
                migrated = reg.read_value("fleet_migrated_requests_total", component="fleet")
                fleet_row.update({
                    "fired": inj.replica_faults_fired, "whole": whole,
                    "fences": [(r.name, r.fences, r.rejoins) for r in fleet.replicas],
                    "migrated": migrated,
                    "recovered": reg.read_value("fleet_migrated_recovered_total",
                                                component="fleet"),
                    "fleet_failover_recovery_s": fleet.last_failover_s,
                    "rejoin_probes": probes,
                    "migrations_at_head": sum(1 for _, _, front, _ in submitted if front),
                    "crash_stats": fleet.last_stats.as_dict(),
                    "fleet_gate": check_fleet(snap)})
                moved = [s for s in submitted if s[2]]
                firsts = {s[0]: s for s in submitted if not s[2]}
                if inj.replica_faults_fired != [("r0", "replica_crash")] or not whole \
                        or not migrated or fleet_row["recovered"] != migrated \
                        or not all(r.ok for r in results) or fleet_row["fleet_gate"] \
                        or not moved or any(firsts[m[0]][3] != m[3] or m[1] != "r1"
                                            for m in moved) \
                        or not any(p["ok"] and p["replica"] == "r0" for p in probes):
                    fail(f"llama3-8b fleet crash drill: {fleet_row}")
                fleet_row["crash_rows_parting"] = against_gate(
                    "llama3-8b fleet crash against the fault-free rows",
                    [r.prompt for r in requests("c")], fleet_rows(results, pad))
                del fleet
            gc.collect()
            torch.cuda.empty_cache()

            # (c) autoscale under a replayed burst, then a retirement in flight;
            # the memory ledger's pools and the kernels' workspaces beside the
            # allocator at each point (phase 29 reads them).
            def ledger_point(led):
                return {"pools": {p: led.pool_bytes(p) for p in T.POOLS},
                        "workspaces": workspace_bytes(T)}

            with T.use_registry() as reg, T.use_timeline(), T.use_incident_manager(), \
                    T.use_memory_ledger() as led:
                fleet = ReplicaSet(engine, ServingConfig(**ELASTIC_SERVING), settings=settings,
                                   fleet=FleetConfig(replicas=1),
                                   resilience=ResilienceConfig(**FLEET_RESILIENCE),
                                   integrity=IntegrityConfig())
                fleet.autoscaler = Autoscaler(fleet, AutoscaleConfig(**ELASTIC))
                decisions = []
                real_tick = fleet.autoscaler.tick

                def tick(now=None):
                    action = real_tick(now)
                    if action:
                        decisions.append({"action": action, "t_s": time.perf_counter() - t0,
                                          "replicas": [r.name for r in fleet.replicas],
                                          "signals": fleet.autoscaler.signals(),
                                          "allocated_gb": torch.cuda.memory_allocated() / 1e9})
                    return action

                fleet.autoscaler.tick = tick
                events = generate_trace(TraceConfig(**ELASTIC_TRACE), prompts=prompts)
                gc.collect()
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                elastic_row["ledger_before_scale_up"] = ledger_point(led)
                t0 = time.perf_counter()
                report = ReplayDriver(fleet, events, compression=ELASTIC_COMPRESSION,
                                      tail_s=ELASTIC_TAIL_S, max_wall_s=120.0,
                                      keep_results=True).run()
                # The quiet tail counts from the trace's last arrival, and the
                # burst's backlog may outlast it: the fleet ticks on, idle,
                # until the controller has retired the standby (or 20 s).
                replay_end = time.perf_counter()
                while [d["action"] for d in decisions] == ["up"] \
                        and time.perf_counter() - replay_end < 20.0:
                    fleet.tick()
                    time.sleep(0.01)
                elastic_row["idle_ticking_after_replay_s"] = time.perf_counter() - replay_end
                torch.cuda.synchronize()
                gc.collect()
                after = torch.cuda.memory_allocated()
                elastic_row["ledger_after_retirement"] = ledger_point(led)
                snap = T.snapshot(reg)
                elastic_row.update({
                    "events": len(events), "replay_wall_s": replay_end - t0,
                    "report": report.summary(), "decisions": decisions,
                    "migrated_at_retirement": reg.read_value(
                        "fleet_migrated_requests_total", component="fleet"),
                    "allocated_before_scale_up_gb": before / 1e9,
                    "allocated_after_retirement_gb": after / 1e9,
                    "autoscale_gate": check_autoscale(snap)})
                if [d["action"] for d in decisions] != ["up", "down"] or report.lost \
                        or report.accepted != len(events) or report.timed_out \
                        or elastic_row["autoscale_gate"] \
                        or abs(after - before) > RETIRE_MEM_SLACK * before:
                    fail(f"llama3-8b autoscale replay: {elastic_row}")
                by_id = {e.id: e for e in events}
                ids = sorted(report.results)
                elastic_row["replay_rows_parting"] = against_gate(
                    "llama3-8b replayed burst against the gate rows",
                    [by_id[i].prompt for i in ids],
                    [_strip(report.results[i].tokens, pad) for i in ids],
                    budgets=[by_id[i].max_tokens for i in ids])
                # a retirement with rows in flight
                standby = fleet.add_replica()
                if standby is None:
                    fail("llama3-8b: the standby replica failed its canary gate")
                reqs = requests("m")
                for r in reqs:
                    if not fleet.submit(r):
                        fleet.tick()
                        if not fleet.submit(r):
                            fail("llama3-8b: the fleet refused a request of the retirement drill")
                for _ in range(500):
                    fleet.tick()
                    if standby.sched.pool.occupancy:
                        break
                live = standby.sched.pool.occupancy
                moved = fleet.retire_replica(standby)
                fleet.drain()
                results = [fleet.take_result(r.id) for r in reqs]
                torch.cuda.synchronize()
                gc.collect()
                after_drill = torch.cuda.memory_allocated()
                elastic_row.update({"drill_live_at_retirement": live, "drill_migrated": moved,
                                    "allocated_after_drill_gb": after_drill / 1e9,
                                    "ledger_after_drill": ledger_point(led)})
                if not live or not moved or not all(r is not None and r.ok for r in results) \
                        or abs(after_drill - before) > RETIRE_MEM_SLACK * before:
                    fail(f"llama3-8b retirement drill: {elastic_row}")
                elastic_row["drill_rows_parting"] = against_gate(
                    "llama3-8b retirement drill against the gate rows",
                    [r.prompt for r in reqs], fleet_rows(results, pad))
                del fleet
            launches = overload_counts(dec_mod, flash_mod, qm)
            need_launches(launches, ("flash_attention", "decode_attention", "quant_matmul_gemv",
                                     "quant_matmul_gemm"), "full-width fleet")
            keep = rehold(recs, held, qm)
            kernel_rows = paged_rows(recs, torch, F, qm, "fleet_full_width", False, keep)
            held |= keep
            del recs
    finally:
        T.set_slo_targets(prev)
    fleet_row["launches"] = launches
    return launches, kernel_rows, fleet_row, elastic_row


def rollout_drill(torch, tmp: pathlib.Path) -> dict:
    """Phase 28(d): the ``rollout`` subcommand on the first study checkpoint
    to a copy of it with a new version id must exit 0; to a copy with one
    flipped byte in ``model.safetensors`` it must exit 2 with cause
    ``manifest``, no replica of that version having joined; no request is
    lost either time, and the snapshot holding both passes the rollout
    gate (``check_rollout``)."""
    import io
    import shutil

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.cli import main as cli
    from fairness_llm_tpu_torch.serving.rollout import check_rollout

    name = STUDY_MODELS[0]
    src = ROOT / "checkpoints" / name
    good, bad, tel = tmp / "rollout_good", tmp / "rollout_bad", tmp / "rollout_tel"
    shutil.copytree(src, good)
    shutil.copytree(src, bad)
    blob = bytearray((bad / "model.safetensors").read_bytes())
    blob[len(blob) // 2] ^= 0x01
    (bad / "model.safetensors").write_bytes(bytes(blob))
    base = ["rollout", "--model", name, "--weights-dir", str(src), "--requests", "16",
            "--canary-window", "0.25", "--slo-ttft-p95", "60", "--slo-e2e-p99", "120"]
    row = {"model": name}
    with T.use_registry(), T.use_timeline(), T.use_fairness_monitor(), \
            T.use_incident_manager():
        for key, to, version, extra in (("good", good, "v1", []),
                                        ("bad", bad, "v2", ["--telemetry-dir", str(tel)])):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(base + ["--to-checkpoint", str(to), "--to-version", version]
                              + extra)
            lines = [ln for ln in out.getvalue().splitlines()
                     if ln.startswith(("rollout ", "served ", "LOST"))]
            row[key] = {"exit": rc, "wall_s": time.perf_counter() - t0, "lines": lines}
    snap = T.load_snapshot(str(tel))
    joined = {g["labels"]["version"]: g["value"] for g in snap["gauges"]
              if g["name"] == "rollout_version_replicas"}
    row["replicas_by_version"] = joined
    row["rollout_gate"] = check_rollout(snap)
    good_out, bad_out = "\n".join(row["good"]["lines"]), "\n".join(row["bad"]["lines"])
    if row["good"]["exit"] != 0 or "state=complete" not in good_out \
            or "served 16/16" not in good_out or row["bad"]["exit"] != 2 \
            or "state=rolled_back cause=manifest:" not in bad_out \
            or "served 16/16" not in bad_out or joined.get("v2") != 0 or row["rollout_gate"]:
        fail(f"the rollout drill: {row}")
    return row


def full_depth_control(tmp: pathlib.Path) -> dict:
    """Phase 28(b)-(c)'s llama3-8b int8 engine at full depth (phase 24's
    is cut to CUT_LAYERS): built as phase 24 builds its engine, and its
    greedy rows in a pool of the control shape (``CONTROL_SERVING``, the
    gate's prompts), as phase 24 serves them, for the drills to hold their
    rows against. The autoscale drill holds the allocator after a
    retirement to RETIRE_MEM_SLACK of what was allocated before the scale-up;
    a retirement leaves ~0.4-0.5 GB in no ledger pool (ROADMAP, Memory),
    within that share of the full-depth engine's ~16 GB but not of a cut
    one's ~6 GB."""
    from fairness_llm_tpu_torch.config import Config, ServingConfig
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.serving import ServingBackend

    cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                 data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / "full_depth"))
    engine = backend_for(MODEL, cfg, allow_random=True).engine
    control = ServingBackend(engine, ServingConfig(**CONTROL_SERVING), name=MODEL)
    greedy = SweepRecorder(control)
    run_phase1(greedy_config(cfg, MODEL, MAX_TOKENS), MODEL, GATE_PROFILES, backend=control,
               save=False)
    return {"engine": engine, "greedy": greedy}


def fleet_path(torch, F, device_line: str, p24: dict, held: set) -> dict:
    """Phase 28. Returns each kernels-line entry's launches on the main
    path's runs (the study models' fleet CLI runs and the rollout drill,
    "study"; the llama3-8b fleet, failover and autoscale runs, FULL_WIDTH)
    and the rows of its kernel calls; phase 29 frees phase 24's full-width
    engine."""
    import gc
    import tempfile

    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    launches, rows = {}, {}
    gc.collect()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        zero_all(dec_mod, flash_mod, qm)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            for name in STUDY_MODELS:
                row = fleet_cli_run(torch, name, tmp, p24["t07"][name])
                log(f"fleet_study_cli {json.dumps({'device': device_line, **row})}")
            row = rollout_drill(torch, tmp)
            log(f"fleet_rollout {json.dumps({'device': device_line, **row})}")
        launches["study"] = containment_counts(dec_mod, flash_mod, qm)
        need_launches(launches["study"], ("flash_attention_f32", "decode_attention_f32"),
                      "study fleet")
        if launches["study"]["flash_attention"] or launches["study"]["decode_attention"]:
            fail(f"the study fleet runs launched a tensor-core kernel: {launches['study']}")
        keep = rehold(recs, held, qm)
        for k, v in sweep_kernel_rows(recs, torch, F, qm, "fleet_study", True, keep).items():
            if v:
                rows.setdefault(k, []).extend(v)
        held |= keep
        del recs
        gc.collect()
        launches[FULL_WIDTH], full_rows, frow, erow = full_width_fleet(
            torch, F, tmp, full_depth_control(tmp), held)
        log(f"fleet_full_width {json.dumps({'device': device_line, **frow})}")
        log(f"fleet_autoscale {json.dumps({'device': device_line, **erow})}")
        for k, v in full_rows.items():
            rows.setdefault(k, []).extend(v)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"fleet_fatal {json.dumps(fatal_child(tmp, replicas=2))}")
    return {"launches": launches, "rows": rows}


# Phase 29: the device-facing telemetry (telemetry/memory.py, roofline.py,
# costmodel.py, compilestats.py; perf-report, memory-report, --achievable-gbps,
# the headroom signals), after phase 28.
#
# (a) The CLI's paged phase-1 sweep on the first study checkpoint in phase
# 25's pool, in a process of its own (so that its memory ledger reconciles
# against an allocator that holds nothing else), with the roofline's
# reference bandwidth measured here by a device-to-device copy.
DEVTEL_CLI_ARGS = ["--continuous", "--slots", str(STUDY_SERVING["num_slots"]), "--paged-kv"]
COPY_BYTES = 1 << 30  # each buffer of the bandwidth copy
# (b) llama3-8b int8 through a second engine over phase 24's weight tree and
# one served pool of the control shape: the gate's 16 prompts at this many
# tokens.
DEVTEL_TOKENS = 16
# (c) The overload ladder's early clamp: batch budgets at this cap.
DEVTEL_BATCH_CAP = 8


def measure_copy_gbps(torch) -> dict:
    """A device-to-device copy of COPY_BYTES, timed with CUDA events over ten
    copies after two: each copy reads and writes every byte once."""
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), 10)
    del src, dst
    torch.cuda.empty_cache()
    return {"bytes_per_copy": 2 * COPY_BYTES, "ms": ms, "gbps": 2 * COPY_BYTES / ms / 1e6}


def measure_dispatch_s(torch) -> float:
    """The host's cost of one eager launch: 2,000 one-element adds enqueued
    back to back, host clock over the count (the device catches up after)."""
    a = torch.zeros(1, device="cuda")
    b = torch.empty_like(a)
    for _ in range(50):
        torch.add(a, 1, out=b)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        torch.add(a, 1, out=b)
    host = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return host


def devtel_cli_run(torch, tmp: pathlib.Path, gbps: float, want: dict) -> dict:
    """Phase 29(a): ``--phase 1 --continuous --slots 8 --paged-kv
    --telemetry-dir D --achievable-gbps <measured>`` on the first study
    checkpoint in a child process: exit 0; ``perf-report D
    --require-ledger``, ``memory-report D --require-ledger`` and
    ``telemetry-report D --validate --require-costmodel --require-memory``
    each exit 0; the reconciliation ``measured`` with no alert; the
    reference bandwidth the one measured; every response that of phase 25's
    paged t=0.7 sweep (``want``)."""
    import io

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.cli import main as cli

    name = STUDY_MODELS[0]
    label = f"{name} device-telemetry CLI"
    tel, results = tmp / "devtel_tel", tmp / "devtel_cli"
    args = (["--phase", "1", "--model", name, "--weights-dir", str(ROOT / "checkpoints"),
             "--data-dir", str(ROOT / "data" / "ml-1m"), "--results-dir", str(results),
             "--telemetry-dir", str(tel), "--achievable-gbps", f"{gbps:.1f}"] + DEVTEL_CLI_ARGS)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fairness_llm_tpu_torch.cli.main"] + args,
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    reports = {}
    for sub in (["perf-report", str(tel), "--require-ledger"],
                ["memory-report", str(tel), "--require-ledger"],
                ["telemetry-report", str(tel), "--validate", "--require-costmodel",
                 "--require-memory"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(sub)
        reports[sub[0]] = {"exit": rc, "text": out.getvalue()}
        if rc != 0:
            fail(f"{label}: {' '.join(sub)} exited {rc}: {out.getvalue()[-3000:]}")
    snap = T.load_snapshot(str(tel))
    gauges = {(g["name"], tuple(sorted(g["labels"].items()))): g["value"] for g in snap["gauges"]}
    modes = {dict(k[1]).get("reconciliation") for k in gauges if k[0] == "hbm_bytes_total"}
    alerts = sum(c["value"] for c in snap["counters"]
                 if c["name"] == "hbm_reconciliation_alerts_total")
    ref_gbps = [v for k, v in gauges.items() if k[0] == "cost_reference_gbps"]
    if modes != {"measured"} or alerts or ref_gbps != [float(f"{gbps:.1f}")]:
        fail(f"{label}: reconciliation {modes}, {alerts} alerts, reference bandwidth {ref_gbps}")
    rec = json.loads((results / "phase1" / "phase1_results.json").read_text())
    if raw_responses(rec) != want["raw"] or rec["neutral_recommendations"] != want["neutral"]:
        parting = sorted(k for k, v in raw_responses(rec).items() if want["raw"].get(k) != v)
        fail(f"{label}: the responses part from phase 25's paged sweep at {parting[:8]} "
             f"({len(parting)} rows)")
    decomp = T.gap_decomposition(snap)

    def named(name_):
        return {dict(k[1]).get("pool") or dict(k[1]).get("program"): v
                for k, v in gauges.items() if k[0] == name_}

    return {"model": name, "argv": args, "wall_s": wall, "rows_equal": len(want["raw"]),
            "reconciliation": sorted(modes), "alerts": alerts,
            "hbm_bytes": named("hbm_bytes"), "hbm_bytes_limit": named("hbm_bytes_limit"),
            "delta_bytes": named("hbm_reconciliation_delta_bytes"),
            "achieved_hbm_gbps": named("achieved_hbm_gbps"),
            "achieved_over_achievable": named("achieved_over_achievable"),
            "top_gap_contributor": {p: d["top_gap_contributor"] for p, d in decomp.items()},
            "compiles": {c["labels"]["program"]: c["value"] for c in snap["counters"]
                         if c["name"] == "compiles_total"},
            "report_lines": {k: len(v["text"].splitlines()) for k, v in reports.items()},
            "perf_report": reports["perf-report"]["text"].splitlines()[:40]}


def workspace_bytes(T) -> dict:
    """Device bytes of the kernels' grown workspaces: K2's split partials,
    K4's GEMV partials and arrival counters (``ops/_build.grown``)."""
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    return {"decode_attention": T.tree_device_bytes(list(dec_mod._workspaces.values())),
            "quant_matmul": T.tree_device_bytes(list(qm._partials.values())
                                                + list(qm._counters.values()))}


def param_products(cfg) -> int:
    """Σ d_in·d_out over a decode step's parameter products (q, k, v, o and
    the MLP's projections in every layer, and the head)."""
    mlp = 3 if cfg.mlp == "glu" else 2
    per_layer = (2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + mlp * cfg.d_model * cfg.d_ff)
    return cfg.num_layers * per_layer + cfg.d_model * cfg.vocab_size


def step_ledger(snap, program: str) -> dict:
    """{component: (bytes, flops)} of ``program``'s step scope."""
    rows = {}
    for g in snap["gauges"]:
        lb = g["labels"]
        if g["name"] in ("cost_ledger_bytes", "cost_ledger_flops") \
                and lb.get("program") == program and lb.get("scope") == "step":
            rows.setdefault(lb["component"], {})[g["name"][12:]] = g["value"]
    return {k: (v.get("bytes", 0.0), v.get("flops", 0.0)) for k, v in rows.items()}


def check_step_ledger(label: str, snap, program: str, cfg, batch: int, T) -> dict:
    """The step scope of ``program``: its matmuls FLOPs exactly ``2·B·Σ
    d_in·d_out`` (every K4 call reports its products), its bytes at least
    the int8 weights the step streams (``decode_step_bytes``' parameter term
    less the float embedding: below it a matmul escaped the ledger), and
    attention bytes above zero."""
    step = step_ledger(snap, program)
    want_flops = 2 * batch * param_products(cfg)
    int8_weights = cfg.approx_param_count - cfg.vocab_size * cfg.d_model
    total = sum(b for b, _ in step.values())
    row = {"program": program, "batch": batch, "matmul_flops": step.get("matmuls", (0, 0))[1],
           "want_matmul_flops": want_flops, "step_bytes": total,
           "int8_weight_bytes": int8_weights,
           "attention_bytes": step.get("attention", (0, 0))[0], "components": step}
    if row["matmul_flops"] != want_flops or total < int8_weights or not row["attention_bytes"]:
        fail(f"{label}: the step ledger of {program}: {row}")
    return row


def devtel_full_width(torch, F, p24: dict, held: set, dispatch_s: float,
                      device_line: str) -> tuple:
    """Phase 29(b)-(d) on phase 24's llama3-8b int8 weights. (b) A second
    engine over the same tensors and one served pool of the control shape,
    each under a fresh memory ledger: the params pool the int8 tree to the
    byte, the slot cache its tensors' bytes (and the allocator's growth
    within its rounding), the step ledgers' matmul FLOPs and bytes, the
    roofline and the gap decomposition. (c) One replica with the autoscaler
    scaling up on the headroom signal (threshold above the measured
    fraction) and back down: the retired replica's ledger entries gone, the
    allocator, the pools and the kernels' workspaces around it logged; and
    the overload ladder's early clamp at rung 0. (d) Every program the phase
    ran in ``compiles_total``; a repeated engine call a hit and no compile.
    Logs each part's row as it ends; returns the launches and the kernel
    rows."""
    import gc

    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import (
        AutoscaleConfig,
        FleetConfig,
        IntegrityConfig,
        ModelSettings,
        OverloadConfig,
        ServingConfig,
    )
    from fairness_llm_tpu_torch.models.transformer import init_cache
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.serving import Autoscaler, ContinuousScheduler, ReplicaSet, Request

    base = p24["engine"]
    cfg = base.config
    dev = base.device
    # A second engine over the first one's tensors (the storage dtype kept,
    # so none is copied).
    shared = dict(params=base.model.state_dict(), device=dev,
                  param_dtype=str(base.model.embedding.dtype)[len("torch."):])
    gate_prompts = [p for call in p24["greedy"].calls for p in call[0]]
    settings = ModelSettings(temperature=0.0, max_tokens=DEVTEL_TOKENS)
    T.set_dispatch_s(dispatch_s)

    def done(key: str, row: dict) -> None:
        log(f"devtel_{key} {json.dumps({'device': device_line, **row}, default=str)}")

    prev = T.set_slo_targets(T.SLOTargets(**FLOOD_SLO))
    try:
        zero_all(dec_mod, flash_mod, qm)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            # (b) the engine
            with T.use_registry() as reg, T.use_timeline(), T.use_memory_ledger() as led:
                engine = DecodeEngine(cfg, **shared)
                params = led.pool_bytes("params")
                if params != int8_tree_bytes(cfg):
                    fail(f"llama3-8b params pool {params} B != the int8 tree's "
                         f"{int8_tree_bytes(cfg)} B")
                t0 = time.perf_counter()
                out = engine.generate(gate_prompts, settings, share_prefix=False)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                snap = T.snapshot(reg)
                eng_row = check_step_ledger("llama3-8b engine", snap, "decode", cfg,
                                            out.stats["batch"], T)
                hits = reg.read_value("compile_cache_hits_total", component="compile",
                                      program="decode")
                compiles = reg.read_value("compiles_total", component="compile",
                                          program="decode", reason="shape")
                t0 = time.perf_counter()
                engine.generate(gate_prompts, settings, share_prefix=False)
                torch.cuda.synchronize()
                again_s = time.perf_counter() - t0
                snap = T.snapshot(reg)
                hits2 = reg.read_value("compile_cache_hits_total", component="compile",
                                       program="decode")
                compiles2 = reg.read_value("compiles_total", component="compile",
                                           program="decode", reason="shape")
                if compiles != 1 or compiles2 != 1 or hits2 != (hits or 0) + 1:
                    fail(f"llama3-8b engine compile stats: compiles {compiles} -> {compiles2}, "
                         f"hits {hits} -> {hits2}")
                decomp = T.gap_decomposition(snap)
                eng_row.update({
                    "params_bytes": params, "first_call_s": first_s, "second_call_s": again_s,
                    "decode_s": out.stats["decode_s"], "decode_steps": out.stats["decode_steps"],
                    "achieved_hbm_gbps": reg.read_value("achieved_hbm_gbps",
                                                        component="roofline", program="decode"),
                    "achieved_over_achievable": reg.read_value(
                        "achieved_over_achievable", component="roofline", program="decode"),
                    "decode_step_bytes": reg.read_value("decode_step_bytes",
                                                        component="roofline", program="decode"),
                    "gap": {p: {k: d[k] for k in ("wall_s", "floor_s", "dispatch_s",
                                                  "compile_s", "unattributed_s", "host_gap_s",
                                                  "top_gap_contributor")}
                            for p, d in decomp.items()},
                    "compiles_then_hits": [compiles, compiles2, hits, hits2],
                    "reconciliation": led.reconcile()})
                done("engine", eng_row)
                del engine
            gc.collect()
            # (b) one served pool, (d) its programs
            with T.use_registry() as reg, T.use_timeline(), T.use_memory_ledger() as led:
                engine = DecodeEngine(cfg, **shared)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                sched = ContinuousScheduler(engine, ServingConfig(**CONTROL_SERVING),
                                            settings=settings)
                torch.cuda.synchronize()
                grew = torch.cuda.memory_allocated() - before
                kv = led.pool_bytes("kv_contiguous")
                tree = T.tree_device_bytes(init_cache(cfg, sched.num_slots, sched.cache_len,
                                                      device=dev))
                logits = led.pool_bytes("logits_carry")
                # The allocator's growth: the pool and the logits, rounded
                # per block, within 1%.
                if kv != tree or not 0 <= grew - kv - logits <= 0.01 * (kv + logits):
                    fail(f"llama3-8b pool: kv_contiguous {kv} B, its tensors {tree} B, the "
                         f"allocator grew {grew} B (with {logits} B of logits)")
                t0 = time.perf_counter()
                res = sched.serve([Request(prompt=p, id=f"d{i:02d}", settings=settings)
                                   for i, p in enumerate(gate_prompts)])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if not all(r.ok for r in res):
                    fail("llama3-8b device-telemetry serve: a request failed")
                snap = T.snapshot(reg)
                pool_row = check_step_ledger("llama3-8b pool", snap, "serve_step", cfg,
                                             sched.num_slots, T)
                compiled = {c["labels"]["program"] for c in snap["counters"]
                            if c["name"] == "compiles_total"}
                if compiled != {"serve_prefill", "serve_step"} or T.check_costmodel(snap):
                    fail(f"llama3-8b pool: compiled {compiled}, cost gate "
                         f"{T.check_costmodel(snap)}")
                decomp = T.gap_decomposition(snap)
                pool_row.update({
                    "kv_contiguous_bytes": kv, "cache_tensor_bytes": tree,
                    "allocator_growth_bytes": grew, "logits_carry_bytes": logits,
                    "serve_wall_s": wall,
                    "achieved_hbm_gbps": reg.read_value("achieved_hbm_gbps",
                                                        component="roofline",
                                                        program="serve_step"),
                    "achieved_over_achievable": reg.read_value(
                        "achieved_over_achievable", component="roofline", program="serve_step"),
                    "gap": {p: {k: d[k] for k in ("wall_s", "floor_s", "dispatch_s",
                                                  "compile_s", "unattributed_s", "host_gap_s",
                                                  "top_gap_contributor")}
                            for p, d in decomp.items()},
                    "compiled": sorted(compiled), "reconciliation": led.reconcile()})
                done("pool", pool_row)
                sched.release_memory()
                if led.entries(f"{sched._mem_handle}:"):
                    fail("llama3-8b pool: release_memory left ledger entries")
                del sched, engine
            gc.collect()
            torch.cuda.empty_cache()
            # (c) the fleet's memory and the headroom signals
            with T.use_registry() as reg, T.use_timeline(), T.use_incident_manager(), \
                    T.use_memory_ledger() as led:
                engine = DecodeEngine(cfg, **shared)
                fleet = ReplicaSet(engine, ServingConfig(**CONTROL_SERVING), settings=settings,
                                   fleet=FleetConfig(replicas=1), integrity=IntegrityConfig())
                fleet.serve([Request(prompt=p, id=f"w{i:02d}", settings=settings)
                             for i, p in enumerate(gate_prompts[:4])])
                gc.collect()
                torch.cuda.synchronize()
                frac = led.headroom_frac()
                cfg_up = AutoscaleConfig(enabled=True, min_replicas=1, max_replicas=2,
                                         up_burn_threshold=1e9, up_queue_frac=1e9,
                                         up_overload_level=0,
                                         up_headroom_frac=min(1.0, frac + 0.05),
                                         up_window_s=0.0, down_window_s=0.0, cooldown_s=0.0,
                                         eval_interval_s=0.0)
                scaler = fleet.autoscaler = Autoscaler(fleet, cfg_up)
                reasons, retired = [], []
                real_up, real_retire = scaler._scale_up, fleet.retire_replica
                scaler._scale_up = lambda reason, sig, now: (reasons.append(reason),
                                                             real_up(reason, sig, now))[1]
                fleet.retire_replica = lambda rep: (retired.append(rep),
                                                    real_retire(rep))[1]

                def point():
                    torch.cuda.synchronize()
                    gc.collect()
                    return {"allocated": torch.cuda.memory_allocated(),
                            "pools": {p: led.pool_bytes(p) for p in T.POOLS},
                            "ledger_total": led.total_bytes(), "workspaces": workspace_bytes(T)}

                mem = {"before_scale_up": point()}
                up = scaler.tick(now=1.0)
                mem["with_standby"] = point()
                scaler.config = dataclasses.replace(cfg_up, up_headroom_frac=0.0)
                down = scaler.tick(now=2.0)
                mem["after_retirement"] = point()
                left = led.entries(f"{retired[0].sched._mem_handle}:") if retired else None
                elastic = {"headroom_frac": frac, "up_headroom_frac": cfg_up.up_headroom_frac,
                           "actions": [up, down], "reasons": reasons,
                           "retired": [r.name for r in retired], "memory": mem,
                           "allocated_delta_bytes": mem["after_retirement"]["allocated"]
                           - mem["before_scale_up"]["allocated"],
                           "ledger_delta_bytes": mem["after_retirement"]["ledger_total"]
                           - mem["before_scale_up"]["ledger_total"]}
                if [up, down] != ["up", "down"] or not reasons \
                        or not reasons[0].startswith("hbm_headroom") or left != {}:
                    fail(f"llama3-8b headroom autoscale: {elastic}, entries left {left}")
                del fleet, scaler
                gc.collect()
                # the overload ladder's early clamp, at rung 0
                over = OverloadConfig(enabled=True,
                                      headroom_cap_frac=min(1.0, led.headroom_frac() + 0.05),
                                      batch_token_cap=DEVTEL_BATCH_CAP)
                sched = ContinuousScheduler(engine, ServingConfig(**CONTROL_SERVING),
                                            settings=settings, overload=over)
                reqs = [Request(prompt=p, id=f"o{i}", settings=settings, qos=q)
                        for i, (p, q) in enumerate(zip(gate_prompts, ("batch", "interactive")))]
                res = sched.serve(reqs)
                clamp = {"level": sched.shed_controller.level,
                         "tokens": {r.id: len(r.tokens) for r in res},
                         "headroom_cap_frac": over.headroom_cap_frac}
                if clamp["level"] != 0 or clamp["tokens"] != {"o0": DEVTEL_BATCH_CAP,
                                                              "o1": DEVTEL_TOKENS}:
                    fail(f"llama3-8b overload headroom clamp: {clamp}")
                elastic["overload_clamp"] = clamp
                sched.release_memory()
                done("fleet", elastic)
                del sched, engine
            gc.collect()
            torch.cuda.empty_cache()
        launches = overload_counts(dec_mod, flash_mod, qm)
        need_launches(launches, ("flash_attention", "decode_attention", "quant_matmul_gemv",
                                 "quant_matmul_gemm"), "device telemetry")
        keep = rehold(recs, held, qm)
        kernel_rows = paged_rows(recs, torch, F, qm, "devtel_full_width", False, keep)
        held |= keep
    finally:
        T.set_dispatch_s(None)
        T.set_slo_targets(prev)
    return launches, kernel_rows


def devtel_path(torch, F, device_line: str, p24: dict, held: set) -> dict:
    """Phase 29. Returns each kernels-line entry's launches on the phase's
    in-process runs (FULL_WIDTH; the CLI run's child launches its own) and
    the rows of its kernel calls; frees phase 24's full-width engine."""
    import gc
    import tempfile

    copy = measure_copy_gbps(torch)
    dispatch_s = measure_dispatch_s(torch)
    refs = {"device": device_line, "copy": copy, "data_sheet_gbps": 3350.0,
            "dispatch_s": dispatch_s}
    log(f"devtel_references {json.dumps(refs)}")
    with tempfile.TemporaryDirectory() as tmp:
        row = devtel_cli_run(torch, pathlib.Path(tmp), copy["gbps"],
                             p24["t07_paged"][STUDY_MODELS[0]])
        log(f"devtel_cli {json.dumps({'device': device_line, **row})}")
    launches, rows = devtel_full_width(torch, F, p24["full_width"], held, dispatch_s,
                                       device_line)
    del p24["full_width"]["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {FULL_WIDTH: launches}, "rows": rows}


# Phase 30: the per-phase device trace (--trace-dir over torch.profiler) and
# data parallelism (--mesh dp=N: parallel/, the dp-sharded engine and
# scoring, metrics/sharded.py), after phase 29.
#
# (a) The CLI's traced served phase 1 at full width, in a child: llama3-8b
# with random int8 weights (the child lets backend_for draw them, as the
# in-process phases do), cut to one call of 16 prompts (--quick: 15
# profiles and one neutral prompt) of 16 tokens in a pool of 16 slots.
TRACE_CLI_ARGS = ["--phase", "1", "--quick", "--continuous", "--slots", "16", "--model", MODEL,
                  "--weight-quant", "int8", "--max-new-tokens", "16"]
TRACE_CHILD = """
import dataclasses, functools, sys
sys.path.insert(0, sys.argv[1])
from fairness_llm_tpu_torch.models import configs
from fairness_llm_tpu_torch.pipeline import backends, phase1
phase1.backend_for = functools.partial(backends.backend_for, allow_random=True)
configs.MODEL_CONFIGS[%(model)r] = dataclasses.replace(configs.MODEL_CONFIGS[%(model)r],
                                                       num_layers=%(layers)d)
from fairness_llm_tpu_torch.cli.main import main
sys.exit(main(sys.argv[2:]))
"""
# The device kernels the capture must name: K1, K2 and both K4 regimes.
TRACED_KERNELS = {"flash_attention": "flash_fwd_tc", "decode_attention": "decode_split_tc",
                  "quant_matmul_gemv": "gemv_stream_tc", "quant_matmul_gemm": "wg_gemm_kernel"}
# (b) Two ranks on the one card, gloo (NCCL refuses two ranks on one
# device), each a child running ``dp_rank`` with the environment torchrun
# gives a rank.
DP_WORLD = 2
DP_CHILD = """
import pathlib, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.dp_rank(pathlib.Path(sys.argv[2])))
"""
# (c) One rank on NCCL: the group's all_reduce of a CUDA tensor.
NCCL_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import torch.distributed as dist
from fairness_llm_tpu_torch.parallel.multihost import initialize_distributed
assert initialize_distributed()
x = torch.arange(1, 9, device="cuda", dtype=torch.float32)
want = x.clone() * dist.get_world_size()
dist.all_reduce(x)
torch.cuda.synchronize()
print(json.dumps({"backend": dist.get_backend(), "world": dist.get_world_size(),
                  "device": str(x.device), "sum": x.tolist(), "want": want.tolist()}))
dist.destroy_process_group()
"""


def rank_env(rank: int, world: int, port: int) -> dict:
    import os

    return dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def trace_run(torch, tmp: pathlib.Path) -> dict:
    """Phase 30(a): exit 0, one capture, a printed summary of its device
    ops; the capture's kernels name K1, K2 and both K4 regimes (read back
    with ``summarize_trace``, whose failure fails here); the serve step's
    device busy share (the union of the kernels inside its
    ``record_function`` spans over their wall) and the capture's bytes."""
    from fairness_llm_tpu_torch.utils.profiling import (
        CAPTURE_SUFFIX,
        device_busy_share,
        summarize_trace,
    )

    trace_dir, results = tmp / "trace", tmp / "trace_cli"
    args = TRACE_CLI_ARGS + ["--data-dir", str(ROOT / "data" / "ml-1m"), "--results-dir",
                             str(results), "--trace-dir", str(trace_dir)]
    t0 = time.perf_counter()
    code = TRACE_CHILD % {"model": MODEL, "layers": CUT_LAYERS}
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the traced CLI run exited {proc.returncode}: {proc.stderr[-3000:]}")
    caps = sorted(trace_dir.rglob("*" + CAPTURE_SUFFIX))
    if len(caps) != 1 or not caps[0].parent.name.startswith("phase1-"):
        fail(f"the traced CLI run left captures {caps}, not one for phase1")
    printed = [line for line in proc.stdout.splitlines()
               if ": cuda: " in line and "ms device time" in line]
    if not printed:
        fail(f"the traced CLI run printed no device summary: {proc.stdout[-2000:]}")
    t1 = time.perf_counter()
    try:
        summaries = summarize_trace(str(trace_dir), top_k=100000, device_filter="cuda")
    except (OSError, ValueError, KeyError) as e:
        fail(f"the capture does not summarize: {e!r}")
    summary_s = time.perf_counter() - t1
    if len(summaries) != 1:
        fail(f"the capture holds {len(summaries)} device summaries, not one")
    ops = summaries[0].top_ops
    found = {k: [(n, ms, c) for n, ms, c in ops if fn in n] for k, fn in TRACED_KERNELS.items()}
    missing = [k for k, v in found.items() if not v]
    if missing:
        fail(f"the capture names no kernel of {missing} among {len(ops)} device ops")
    share = device_busy_share(str(caps[0]), "serve_step")
    if not share["spans"] or share["busy_share"] is None:
        fail(f"the capture holds no serve_step span: {share}")
    rec = json.loads((results / "phase1" / "phase1_results.json").read_text())
    errors = sorted(k for k, v in rec["recommendations"].items() if "error" in v)
    if errors or rec["metadata"]["serving"] is None:
        fail(f"the traced CLI run served no record: error rows {errors[:4]}, serving "
             f"{rec['metadata']['serving']}")
    return {"argv": args, "layers": CUT_LAYERS, "wall_s": wall,
            "capture": str(caps[0].relative_to(tmp)),
            "capture_bytes": caps[0].stat().st_size, "summary_s": summary_s,
            "device_ms": summaries[0].total_ms, "device_events": summaries[0].num_events,
            "device_op_names": len(ops), "serve_step": share,
            "kernels": {k: [[n[:60], ms, c] for n, ms, c in v] for k, v in found.items()},
            "top_ops": [[n[:80], ms, c] for n, ms, c in ops[:12]],
            "printed_summary": printed, "rows": len(rec["recommendations"]),
            "serving": rec["metadata"]["serving"]}


def nccl_check() -> dict:
    """Phase 30(c): one rank, ``initialize_distributed`` on the card picks
    NCCL, and an all_reduce of a CUDA tensor returns the sum."""
    proc = subprocess.run([sys.executable, "-c", NCCL_CHILD, str(ROOT)], cwd=ROOT,
                          env=rank_env(0, 1, free_port()), capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        fail(f"the NCCL child exited {proc.returncode}: {proc.stderr[-3000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    if row["backend"] != "nccl" or row["world"] != 1 or row["sum"] != row["want"] \
            or not row["device"].startswith("cuda"):
        fail(f"the NCCL all_reduce: {row}")
    return row


def _keys(obj):
    """JSON lists back into the recorders' tuple keys."""
    return tuple(_keys(x) for x in obj) if isinstance(obj, list) else obj


def dp_rank(out: pathlib.Path) -> int:
    """One rank of phase 30(b), in a child started with a rank's torchrun
    environment: join the gloo group, then (1) the greedy phase-1 sweep of
    the first study checkpoint at phase 20's settings on a dp=2 mesh, (2)
    the llama3-8b int8 default sweep (phase 21's) on it; each with its
    kernels recorded. Then, rank after rank, each kernel against its plain
    version at the shapes no earlier phase held (``spec.json``'s keys, and
    the other rank's). Writes ``rank<r>.json``: its launches, records,
    token rows, walls, peak memory and kernel rows."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from fairness_llm_tpu_torch.config import Config, MeshConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.parallel.multihost import initialize_distributed
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads((out / "spec.json").read_text())
    held = {_keys(k) for k in spec["held"]}
    initialize_distributed()
    rank, mesh = dist.get_rank(), MeshConfig(dp=DP_WORLD)
    mine = out / f"rank{rank}"
    res = {"rank": rank, "backend": dist.get_backend(),
           "cuda_device": torch.cuda.current_device()}
    data = str(ROOT / "data" / "ml-1m")
    runs = {}
    name = STUDY_MODELS[0]
    for key, cfg, model in (
            ("study", greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                                           data_dir=data, results_dir=str(mine / "study"),
                                           mesh=mesh), name, MAX_TOKENS), name),
            (FULL_WIDTH, Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                                data_dir=data, results_dir=str(mine / FULL_WIDTH),
                                mesh=mesh), MODEL)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_all(dec_mod, flash_mod, qm)
        t0 = time.perf_counter()
        with cut_depth(MODEL, CUT_LAYERS):  # as phase 21's sweep
            backend = backend_for(model, cfg, allow_random=model == MODEL)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        calls = SweepRecorder(backend)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            rec = run_phase1(cfg, model, backend=backend)
        torch.cuda.synchronize()
        res[key] = {"wall_s": time.perf_counter() - t0, "engine_init_s": init_s,
                    "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": phase1_counts(dec_mod, flash_mod, qm), "record": rec,
                    "calls": calls.calls, "chunks": calls.chunks,
                    "files": sorted(str(p.relative_to(mine)) for p in mine.rglob("*")
                                    if p.is_file() and key in p.parts)}
        runs[key] = (recs, key == "study")
        del backend
    rows = {}
    for turn in range(DP_WORLD):
        if rank == turn:
            for key, (recs, f32) in runs.items():
                for k, v in sweep_kernel_rows(recs, torch, F, qm, f"dp_{key}_rank{rank}", f32,
                                              held).items():
                    rows.setdefault(k, []).extend(v)
        box = [held]
        dist.broadcast_object_list(box, src=turn)
        held = box[0]
    res["rows"] = rows
    (out / f"rank{rank}.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dp_run(torch, tmp: pathlib.Path, sweep: dict, held: set) -> dict:
    """Phase 30(b) in the parent: start the ranks, wait for both (one that
    fails stops the other and fails here), then check what they sent back."""
    out = tmp / "dp"
    out.mkdir()
    (out / "spec.json").write_text(json.dumps({"held": sorted(held, key=repr)},
                                              default=list))
    port = free_port()
    logs = [open(out / f"rank{r}.log", "w") for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", DP_CHILD, str(ROOT), str(out)], cwd=ROOT,
                              env=rank_env(r, DP_WORLD, port), stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(DP_WORLD)]
    try:
        deadline = time.monotonic() + 900
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if codes != [0] * DP_WORLD:
        tails = "\n".join(f"rank {r}: " + (out / f"rank{r}.log").read_text()[-2500:]
                          for r in range(DP_WORLD))
        fail(f"the dp=2 ranks exited {codes}:\n{tails}")
    return {"wall_s": wall, "ranks": [json.loads((out / f"rank{r}.json").read_text())
                                      for r in range(DP_WORLD)]}


def dp_checks(torch, res: dict, sweep: dict, device_line: str) -> tuple:
    """Phase 30(b)'s checks on the ranks' results: gloo on the one card;
    the study's f32 kernels only, its record equal to phase 20's
    single-process card record (a greedy row may part only at a near tie),
    reduced over dp; K1, K2 and both K4 regimes on their tensor-core
    kernels in the 8B sweep, whose rows are reported against phase 21's;
    rank 0 alone wrote files; every kernel row within its tolerance and its
    blind check failing it. Returns the launches by run and rank, the rows
    by entry, and the log row."""
    import types

    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline.backends import backend_for

    name = STUDY_MODELS[0]
    card, card_calls = sweep["greedy_card"][name]
    phase21 = sweep["records"][FULL_WIDTH]
    engine = backend_for(name, greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                                                    data_dir=str(ROOT / "data" / "ml-1m")),
                                             name, MAX_TOKENS)).engine
    launches, rows = {}, {}
    row = {"device": device_line, "world": DP_WORLD, "wall_s": res["wall_s"], "ranks": []}
    for r, rk in enumerate(res["ranks"]):
        if rk["backend"] != "gloo" or rk["cuda_device"] != 0:
            fail(f"dp rank {r} ran {rk['backend']} on cuda:{rk['cuda_device']}, not gloo on "
                 "the one card")
        study, full = rk["study"], rk[FULL_WIDTH]
        ls, lf = study["launches"], full["launches"]
        if ls["flash_attention_f32"] <= 0 or ls["decode_attention_f32"] <= 0 \
                or ls["flash_attention"] or ls["decode_attention"] or ls["quant_matmul_gemv"] \
                or ls["quant_matmul_gemm"]:
            fail(f"dp rank {r}: the f32 study sweep launched {ls}")
        if any(lf[k] <= 0 for k in TRACED_KERNELS) or lf["flash_attention_f32"] \
                or lf["decode_attention_f32"]:
            fail(f"dp rank {r}: the 8B sweep launched {lf}")
        for key, label in (("study", name), (FULL_WIDTH, "llama3-8b int8")):
            rec = rk[key]["record"]
            if rec["metadata"]["metric_reduction"] != "dp-psum":
                fail(f"dp rank {r} {label}: metric_reduction {rec['metadata']['metric_reduction']}")
            want_files = [f"{key}/phase1/phase1_results.json"] if r == 0 else []
            got_files = [f for f in rk[key]["files"] if f.endswith("phase1_results.json")]
            if got_files != want_files or (r and rk[key]["files"]):
                fail(f"dp rank {r} {label} wrote {rk[key]['files']}")
        calls = types.SimpleNamespace(calls=[(p, t) for p, t in study["calls"]])
        differ = greedy_divergences(f"{name} dp=2 rank {r}", card_calls, calls, engine, torch,
                                    against="the single-process card run")
        rec = study["record"]
        if not differ:
            if rec["recommendations"] != json.loads(json.dumps(card["recommendations"])) or \
                    rec["neutral_recommendations"] != card["neutral_recommendations"]:
                fail(f"dp rank {r}: equal tokens but other responses than the single-process "
                     "card run")
            for (path, a), (_, b) in zip(metric_leaves(rec["metrics"]),
                                         metric_leaves(card["metrics"])):
                if abs(a - b) > METRIC_TOL:
                    fail(f"dp rank {r}: {path} is {a} at dp=2, {b} in one process")
        raw, raw21 = raw_responses(full["record"]), raw_responses(phase21)
        row["ranks"].append({
            "rank": r, "study": {k: study[k] for k in ("wall_s", "engine_init_s",
                                                       "peak_allocated_gb", "launches")},
            "study_rows_differing": differ,
            "full_width": {k: full[k] for k in ("wall_s", "engine_init_s", "peak_allocated_gb",
                                                "launches", "chunks")},
            "full_width_rows_equal_phase21": sum(raw21.get(k) == v for k, v in raw.items()),
            "full_width_rows": len(raw)})
        launches[f"study_rank{r}"], launches[f"{FULL_WIDTH}_rank{r}"] = ls, lf
        for k, v in rk["rows"].items():
            rows.setdefault(k, []).extend(v)
    for k, v in rows.items():
        check_rows(k, v, "the blinded input (as the phase that first held the kernel)")
    row["phase21_wall_s"] = sweep["full_width_wall_s"]
    return launches, rows, row


def trace_dp_path(torch, device_line: str, sweep: dict, held: set) -> dict:
    """Phase 30: (a) the traced CLI run, (b) dp=2 on the card, (c) NCCL at
    one rank. Returns each kernels-line entry's launches in each rank's
    runs and the rows of the calls no earlier phase held."""
    import gc
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        log(f"trace_cli {json.dumps({'device': device_line, **trace_run(torch, tmp)})}")
        log(f"trace_cli_s {time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        launches, rows, row = dp_checks(torch, dp_run(torch, tmp, sweep, held), sweep,
                                        device_line)
        log(f"dp_sweeps {json.dumps(row)}")
        log(f"dp_s {time.perf_counter() - t0:.1f}")
    log(f"nccl_one_rank {json.dumps({'device': device_line, **nccl_check()})}")
    return {"launches": launches, "rows": rows}


# Phase 31: tensor parallelism (--tp, --mesh tp=N: the tp layout of
# parallel/sharding.py and the sharded forward's explicit all-reduces), ring
# attention (--mesh sp=N, parallel/ring.py) and training (train/), after
# phase 30.
#
# (a)-(b) Two ranks on the one card over gloo (NCCL refuses two ranks on one
# device), each a child running ``tp_rank`` with a rank's torchrun
# environment; then one rank on NCCL running the same function at tp=1.
TP_WORLD = 2
TP_CHILD = """
import pathlib, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.exit(chip_smoke.tp_rank(pathlib.Path(sys.argv[2])))
"""
# The first-step logits compared at tp=2 and tp=1: the first prompts of the
# sweep, one prefill forward (K1 and the K4 GEMM over each rank's shard);
# in float32 within F32_LOGIT_TOL of the largest logit (phases 13 and 18's
# float32 logit allowance).
TP_LOGIT_PROMPTS = 4
F32_LOGIT_TOL = 1e-3
# Phase 31(a)'s served llama3-8b int8 sweep at tp=2 runs at full width with
# this many of its 32 layers, for the script's time limit since phase 33
# came in: each layer gives the kernels the same shapes, and the first
# prefill's logits are held at tp=2 against tp=1 of the same cut model.
TP_LAYERS = 8
# Two ranks on one card all-reduce through the host (gloo stages CUDA
# tensors there): at tp=2 a served 8B decode step took ~0.27 s and a
# prefill group of 8 x 896 tokens ~20 s (H100 80GB HBM3, 700 W), so the 8B
# sweep runs phase 21's settings at one profile a combination (15
# profiles and one neutral prompt, one call of 16), and the speculative
# call decodes TP_SPEC_TOKENS tokens.
TP_PROFILES_PER_COMBO = 1
TP_PROMPTS = 16
TP_SPEC_TOKENS = 16
# (b) llama3-8b's attention shape through the ring, in float32.
RING_SHAPE = dict(seq=4096, heads=32, kv_heads=8, head_dim=128)
RING_ATOL = 1e-5
SP_SCORE_RTOL = 1e-5
# (c) Training: the study step held to the CPU's, and llama3-8b at full
# width cut to TRAIN_LAYERS layers (params, grads and AdamW moments in bf16:
# 8 bytes a parameter, ~22 GB), a few remat steps on one fixed batch.
TRAIN_STUDY_BATCH = (4, 65)
TRAIN_TOL = 1e-4
TRAIN_LAYERS = 8
TRAIN_BATCH = (2, 257)
TRAIN_STEPS = 4
# (e) The native parser's input: rows of MovieLens-1M's ranges.
NATIVE_ROWS = 20_000


def study_train_batch(cfg):
    """Phase 31's study training batch: ``TRAIN_STUDY_BATCH`` tokens from a
    seed, row 1 left-padded by 9."""
    import numpy as np

    rng = np.random.default_rng(31)
    b, s = TRAIN_STUDY_BATCH
    tokens = rng.integers(3, cfg.vocab_size, (b, s))
    valid = np.ones((b, s), bool)
    valid[1, :9] = False
    return tokens, valid


def big_train_batch(cfg):
    """Phase 31's llama3-8b training batch: ``TRAIN_BATCH`` tokens from a
    seed, every one valid."""
    import numpy as np

    tokens = np.random.default_rng(8).integers(3, cfg.vocab_size, TRAIN_BATCH)
    return tokens, np.ones(TRAIN_BATCH, bool)


def tp_rank(out: pathlib.Path) -> int:
    """One rank of phase 31(a)-(b), in a child started with a rank's
    torchrun environment. At tp=2 (gloo): (1) the greedy phase-1 sweep of
    the first study checkpoint at phase 20's settings on a tp=2 mesh, (2)
    phase 21's llama3-8b int8 sweep served with ``--continuous --tp 2``
    (``ServingConfig(tp=2)`` over the tp mesh), each with its kernels
    recorded; the first prefill's logits of ``TP_LOGIT_PROMPTS`` prompts
    in bf16 and float32 (``first_logits``); one
    speculative greedy engine call (K3 over the local heads); then, rank
    after rank, each kernel against its plain version at the shapes no
    earlier phase held; (3) on an sp=2 mesh, ring attention at llama3-8b's
    head shape against dense attention, and a scoring forward of the study
    model with ``attention_impl="ring"`` against sp=1. At world 1 (NCCL)
    only (1), on a tp=1 mesh. Writes ``rank<r>.json``."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from fairness_llm_tpu_torch.config import (
        Config,
        MeshConfig,
        ModelSettings,
        ServingConfig,
        SpeculationConfig,
    )
    from fairness_llm_tpu_torch.models.tokenizer import _left_pad
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.parallel.multihost import initialize_distributed
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads((out / "spec.json").read_text())
    held = {_keys(k) for k in spec["held"]}
    initialize_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = out / f"rank{rank}"
    res = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "cuda_device": torch.cuda.current_device()}
    data = str(ROOT / "data" / "ml-1m")
    mesh = MeshConfig(tp=world)
    name = STUDY_MODELS[0]
    runs = {}
    for key in ("study", FULL_WIDTH)[:1 if world == 1 else 2]:
        if key == "study":
            cfg, model = greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                                              data_dir=data, results_dir=str(mine / key),
                                              mesh=mesh), name, MAX_TOKENS), name
        else:
            cfg, model = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS, data_dir=data,
                                results_dir=str(mine / key), mesh=mesh,
                                profiles_per_combo=TP_PROFILES_PER_COMBO,
                                serving=ServingConfig(**FULL_WIDTH_SERVING, tp=world)), MODEL
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_all(dec_mod, flash_mod, qm)
        t0 = time.perf_counter()
        if model == MODEL:
            with cut_depth(MODEL, TP_LAYERS):  # full width, TP_LAYERS deep
                backend = backend_for(model, cfg, allow_random=True)
        else:
            backend = backend_for(model, cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        calls = SweepRecorder(backend)
        with flagged_recorders(dec_mod, flash_mod, qm, NotScoring) as recs:
            rec = run_phase1(cfg, model, backend=backend)
        torch.cuda.synchronize()
        local = backend.engine.model.config
        res[key] = {"wall_s": time.perf_counter() - t0, "engine_init_s": init_s,
                    "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": phase1_counts(dec_mod, flash_mod, qm), "record": rec,
                    "calls": calls.calls, "chunks": calls.chunks,
                    "local_widths": [local.num_heads, local.num_kv_heads, local.d_ff,
                                     local.vocab_size],
                    "served": hasattr(backend, "serve_totals"),
                    "files": sorted(str(p.relative_to(mine)) for p in mine.rglob("*")
                                    if p.is_file() and key in p.parts)}
        if key == "study":
            runs[key] = (recs, True)
            del backend
            continue
        if hasattr(backend, "scheduler_for"):
            sched = backend.scheduler_for(cfg.settings_for(MODEL))
            res[key]["program"] = sched._program
        engine = backend.engine
        del backend
        prompts = counterfactual_prompts()[1][:16]
        # the first prefill's logits at tp=2; rank 0 also at tp=1
        tb = _left_pad([engine.tokenizer.encode(p) for p in prompts[:TP_LOGIT_PROMPTS]],
                       engine.tokenizer.pad_id)
        S, w = -(-tb.tokens.shape[1] // 128) * 128, tb.tokens.shape[1]
        toks = torch.zeros(TP_LOGIT_PROMPTS, S, dtype=torch.long, device="cuda")
        valid = torch.zeros(TP_LOGIT_PROMPTS, S, dtype=torch.bool, device="cuda")
        toks[:, S - w:] = torch.from_numpy(tb.tokens).cuda()
        valid[:, S - w:] = torch.from_numpy(tb.valid).cuda()
        pos = (torch.cumsum(valid.long(), 1) - 1).clamp_min(0)
        res["first_logits"], runs["f32_logits"], res["f32_logits_launches"] = first_logits(
            torch, engine, cfg, toks, pos, valid, rank)
        # one speculative greedy call: K3 over the rank's local heads
        zero_all(dec_mod, flash_mod, qm)
        rec3 = decode_recorder(dec_mod)
        with rec3:
            spec_out = engine.generate(
                prompts, ModelSettings(temperature=0.0, max_tokens=TP_SPEC_TOKENS),
                speculation=SpeculationConfig(enabled=True))
        torch.cuda.synchronize()
        res["spec"] = {"launches": {**decode_counts(dec_mod), "flash_attention": flash_mod.launches,
                                    "flash_attention_tc": flash_mod.tc_launches,
                                    "quant_matmul_gemv": qm.gemv_launches,
                                    "quant_matmul_gemm": qm.gemm_launches},
                       "speculation": spec_out.stats.get("speculation"),
                       "decode_steps": spec_out.stats["decode_steps"]}
        runs[key] = (recs, False)
        runs["spec"] = rec3
        del engine
    rows = {}
    for turn in range(world):
        if rank == turn:
            for key, run in runs.items():
                if key == "f32_logits":  # K4's float32 route over the rank's shards
                    rows.setdefault("quant_matmul_f32", []).extend(k4_f32_rows(
                        run, res["f32_logits_launches"], torch, f"tp_f32_logits_rank{rank}",
                        qm, held))
                    continue
                if key == "spec":
                    fresh = {k: v for k, v in run.calls.items()
                             if k[0] == "k3" and k not in held}
                    held.update(fresh)
                    if fresh:
                        run.calls = fresh
                        rows.setdefault("decode_attention_verify", []).extend(
                            dict(r, path=f"tp_spec_rank{rank}") for r in decode_rows(
                                run, "k3", "decode_attention_verify", torch, F,
                                "every q_offset lowered by one"))
                    continue
                recs, f32 = run
                for k, v in sweep_kernel_rows(recs, torch, F, qm, f"tp_{key}_rank{rank}", f32,
                                              held).items():
                    rows.setdefault(k, []).extend(v)
        if world > 1:
            box = [held]
            dist.broadcast_object_list(box, src=turn)
            held = box[0]
    res["rows"] = rows
    del runs
    if world > 1:
        res["ring"] = sp_checks(torch, out, rank)
        res["train"] = tp_train(torch, out, rank)
    (out / f"rank{rank}.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def first_logits(torch, engine, cfg, toks, pos, valid, rank: int) -> dict:
    """Phase 31(a): the first prefill's logits at tp=2 against tp=1 over
    the same weights (``init_params`` from the config's seed, as
    ``backend_for`` draws them): in bfloat16 (``engine``, the served
    sweep's; reported: 32 layers of bf16 rounding part two summation
    orders by about as much as phase 9's kernels part from their plain
    versions), and in float32 (an engine of the same int8 weights with
    float32 activations at each tp, ``float32_twin``'s function), gated at
    the port's float32 logit allowance: ``F32_LOGIT_TOL`` of the largest
    logit. Both ranks run the tp=2 forwards; rank 0 also the tp=1 ones and
    returns the numbers, with the recorders of the float32 tp=2 forward's
    K4 calls (K4's float32 route over the rank's shards) and their launches
    by kernel (``f32_k4_recording``)."""
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.weights import init_params

    full = init_params(engine.config, cfg.random_seed, torch.device("cuda"), torch.bfloat16)
    f32 = dataclasses.replace(engine.config, dtype="float32")
    twin = DecodeEngine(f32, params=full, mesh=engine.mesh, tokenizer=engine.tokenizer)
    out = {}
    recs, counts = None, None
    for dtype, tp2 in (("bfloat16", engine), ("float32", twin)):
        with (f32_k4_recording(qm) if dtype == "float32"
              else contextlib.nullcontext((None, None))) as (rec, cnt):
            got, _ = tp2.model(toks, pos, valid, left_padded=True, last_only=True)
            torch.cuda.synchronize()
        if rec is not None:
            recs, counts = rec, cnt
        if rank == 0:
            one = DecodeEngine(f32 if dtype == "float32" else engine.config, params=full,
                               tokenizer=engine.tokenizer)
            want, _ = one.model(toks, pos, valid, left_padded=True, last_only=True)
            top = float(want.abs().max())
            out[dtype] = {"max_abs_err": float((got - want).abs().max()), "largest_logit": top,
                          "allowance": F32_LOGIT_TOL * max(1.0, top),
                          "top1_equal_share": float((got.argmax(-1) == want.argmax(-1))
                                                    .float().mean())}
            del one, want
        del got
    del twin, full
    torch.cuda.empty_cache()
    return out, recs, counts


def sp_checks(torch, out: pathlib.Path, rank: int) -> dict:
    """Phase 31(b) in a rank: on an sp=2 mesh, ring attention over
    ``RING_SHAPE`` in float32 (each rank its 2,048-token block, GQA
    unexpanded on the ring) against dense attention over the whole
    sequence, within ``RING_ATOL``, with its wall; then the study model's
    scores with ``attention_impl="ring"`` over the sp ranks against one
    process's on the card."""
    import dataclasses as dc

    from fairness_llm_tpu_torch.config import MeshConfig
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.parallel.ring import full_attention_reference, ring_attention
    from fairness_llm_tpu_torch.parallel.sharding import axis_group, make_mesh
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.scoring import score_texts
    from fairness_llm_tpu_torch.runtime.weights import load_checkpoint

    mesh = make_mesh(MeshConfig(sp=TP_WORLD))
    group = axis_group(mesh, "sp")
    S, H, Hkv, D = (RING_SHAPE[k] for k in ("seq", "heads", "kv_heads", "head_dim"))
    gen = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn(1, S, H, D, device="cuda", generator=gen)
    k = torch.randn(1, S, Hkv, D, device="cuda", generator=gen)
    v = torch.randn(1, S, Hkv, D, device="cuda", generator=gen)
    pos = torch.arange(S, device="cuda")[None]
    valid = torch.ones(1, S, dtype=torch.bool, device="cuda")
    blk = slice(rank * S // TP_WORLD, (rank + 1) * S // TP_WORLD)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ring_attention(q[:, blk], k[:, blk], v[:, blk], pos[:, blk], pos[:, blk],
                         valid[:, blk], group=group)
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    want = full_attention_reference(q, k, v, pos, valid)[:, blk]
    err = float((got - want).abs().max())
    res = {"shape": RING_SHAPE, "block": [blk.start, blk.stop], "ring_s": ring_s,
           "max_abs_err": err, "atol": RING_ATOL, "dtype": str(got.dtype)}
    del q, k, v, got, want
    torch.cuda.empty_cache()
    name = STUDY_MODELS[0]
    path = str(ROOT / "checkpoints" / name)
    cfg = dc.replace(get_model_config(name), attention_impl="ring")
    params = load_checkpoint(cfg, path, device="cuda")
    texts = counterfactual_prompts()[1][:8]
    ring_eng = DecodeEngine(cfg, params=params, device="cuda", mesh=mesh, tokenizer_path=path)
    one_eng = DecodeEngine(get_model_config(name), params=params, device="cuda",
                           tokenizer_path=path)
    got, one = score_texts(ring_eng, texts), score_texts(one_eng, texts)
    rel = float((abs(got.log_likelihoods - one.log_likelihoods)
                 / abs(one.log_likelihoods).clip(1e-30)).max())
    res["scoring"] = {"rows": len(texts), "max_rel_err": rel, "rtol": SP_SCORE_RTOL,
                      "counts_equal": bool((got.token_counts == one.token_counts).all()),
                      "sp1": one.log_likelihoods.tolist(), "sp2": got.log_likelihoods.tolist()}
    return res


def tp_run(tmp: pathlib.Path, held: set, world: int, backend: str) -> dict:
    """Start ``world`` ranks of ``tp_rank`` (gloo at 2 on the one card, NCCL
    at 1), wait for all (one that fails stops the others and fails here),
    and return what they sent back."""
    out = tmp / f"tp{world}"
    out.mkdir()
    (out / "spec.json").write_text(json.dumps({"held": sorted(held, key=repr)},
                                              default=list))
    port = free_port()
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    t0 = time.perf_counter()
    procs = []
    for r in range(world):
        # initialize_distributed picks gloo for two ranks on the one card
        procs.append(subprocess.Popen([sys.executable, "-c", TP_CHILD, str(ROOT), str(out)],
                                      cwd=ROOT, env=rank_env(r, world, port), stdout=logs[r],
                                      stderr=subprocess.STDOUT))
    try:
        deadline = time.monotonic() + 900
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(f"rank {r}: " + (out / f"rank{r}.log").read_text()[-2500:]
                          for r in range(world))
        fail(f"the tp={world} ranks exited {codes}:\n{tails}")
    for r in range(world):
        rk = json.loads((out / f"rank{r}.json").read_text())
        if rk["backend"] != backend or rk["cuda_device"] != 0:
            fail(f"tp rank {r} ran {rk['backend']} on cuda:{rk['cuda_device']}, not {backend} "
                 "on the one card")
    return {"wall_s": wall, "ranks": [json.loads((out / f"rank{r}.json").read_text())
                                      for r in range(world)]}


def tp_checks(torch, res: dict, one: dict, sweep: dict, device_line: str) -> tuple:
    """Phase 31(a)-(b)'s checks on the ranks' results. The study sweep: its
    f32 kernels only, over the rank's local widths (2 q heads, 1 kv head),
    its record equal to phase 20's single-process card record (a greedy row
    may part only at a near tie), rank 0 alone writing files; the same at
    tp=1 on NCCL. The 8B sweep served at tp=2: labelled ``@tp2``, K1, K2
    and both K4 regimes on their tensor-core kernels over 16 q and 4 kv
    heads, its rows reported against phase 21's; the first prefill's
    float32 logits within ``F32_LOGIT_TOL`` of tp=1's (bf16 reported); K3
    launched on its
    tensor-core kernel by the speculative call; every kernel row within its
    tolerance and its blind check failing it; the ring within
    ``RING_ATOL`` of dense attention and the ring scores within
    ``SP_SCORE_RTOL`` of sp=1's. Returns the launches by run and rank, the
    rows by entry, and the log row."""
    import types

    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline.backends import backend_for

    name = STUDY_MODELS[0]
    card, card_calls = sweep["greedy_card"][name]
    phase21 = sweep["records"][FULL_WIDTH]
    engine = backend_for(name, greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                                                    data_dir=str(ROOT / "data" / "ml-1m")),
                                             name, MAX_TOKENS)).engine
    launches, rows = {}, {}
    row = {"device": device_line, "world": TP_WORLD, "wall_s": res["wall_s"],
           "nccl_one_rank_wall_s": one["wall_s"], "ranks": []}
    for label, rk in [(f"tp=2 rank {r}", x) for r, x in enumerate(res["ranks"])] + \
            [("tp=1 nccl", one["ranks"][0])]:
        r, study = rk["rank"], rk["study"]
        ls = study["launches"]
        if ls["flash_attention_f32"] <= 0 or ls["decode_attention_f32"] <= 0 \
                or ls["flash_attention"] or ls["decode_attention"] or ls["quant_matmul_gemv"] \
                or ls["quant_matmul_gemm"]:
            fail(f"{label}: the f32 study sweep launched {ls}")
        widths = [4, 2, 256, 512] if rk["world"] == 1 else [2, 1, 128, 256]
        if study["local_widths"] != widths:
            fail(f"{label}: the study model holds widths {study['local_widths']}, not {widths}")
        rec = study["record"]
        want_files = ["study/phase1/phase1_results.json"] if r == 0 else []
        got_files = [f for f in study["files"] if f.endswith("phase1_results.json")]
        if got_files != want_files or (r and study["files"]):
            fail(f"{label} wrote {study['files']}")
        calls = types.SimpleNamespace(calls=[(p, t) for p, t in study["calls"]])
        differ = greedy_divergences(f"{name} {label}", card_calls, calls, engine, torch,
                                    against="the single-process card run")
        if not differ:
            if rec["recommendations"] != json.loads(json.dumps(card["recommendations"])) or \
                    rec["neutral_recommendations"] != card["neutral_recommendations"]:
                fail(f"{label}: equal tokens but other responses than the single-process run")
            for (path, a), (_, b) in zip(metric_leaves(rec["metrics"]),
                                         metric_leaves(card["metrics"])):
                if abs(a - b) > METRIC_TOL:
                    fail(f"{label}: {path} is {a} here, {b} in one process")
        entry = {"rank": r, "label": label, "backend": rk["backend"],
                 "study": {k: study[k] for k in ("wall_s", "engine_init_s",
                                                 "peak_allocated_gb", "launches")},
                 "study_rows_differing": differ}
        launches[f"study_tp{rk['world']}_rank{r}"] = ls
        if rk["world"] > 1:
            full = rk[FULL_WIDTH]
            lf = full["launches"]
            if any(lf[k] <= 0 for k in TRACED_KERNELS) or lf["flash_attention_f32"] \
                    or lf["decode_attention_f32"]:
                fail(f"{label}: the 8B served sweep launched {lf}")
            if full["local_widths"] != [16, 4, 7168, 64128] or not full["served"] \
                    or full.get("program") != "serve_step@tp2":
                fail(f"{label}: the 8B sweep held {full['local_widths']}, served "
                     f"{full['served']} as {full.get('program')}")
            check_record(full["record"], f"llama3-8b int8 {label}", want_non_empty=False,
                         prompts=TP_PROMPTS)
            serving_record_check(full["record"], f"llama3-8b int8 {label}",
                                 FULL_WIDTH_SERVING["num_slots"], prompts=TP_PROMPTS)
            want_files = [f"{FULL_WIDTH}/phase1/phase1_results.json"] if r == 0 else []
            got_files = [f for f in full["files"] if f.endswith("phase1_results.json")]
            if got_files != want_files or (r and full["files"]):
                fail(f"{label} 8B wrote {full['files']}")
            sl = rk["spec"]["launches"]
            if sl["decode_attention_verify"] <= 0 or \
                    sl["decode_attention_verify_tc"] != sl["decode_attention_verify"]:
                fail(f"{label}: the speculative call launched K3 {sl}")
            raw, raw21 = raw_responses(full["record"]), raw_responses(phase21)
            entry.update({
                "full_width": {k: full[k] for k in ("wall_s", "engine_init_s",
                                                    "peak_allocated_gb", "launches",
                                                    "chunks", "program")},
                "full_width_rows_equal_phase21": sum(raw21.get(k) == v for k, v in raw.items()),
                "full_width_rows_in_phase21": sum(k in raw21 for k in raw),
                "full_width_rows": len(raw), "spec": rk["spec"], "ring": rk["ring"]})
            launches[f"{FULL_WIDTH}_tp2_rank{r}"] = lf
            launches[f"spec_tp2_rank{r}"] = {
                "decode_attention_verify": sl["decode_attention_verify"]}
            f32k4 = rk["f32_logits_launches"]
            if f32k4["quant_matmul_f32"] <= 0 or f32k4["quant_matmul_f32"] != (
                    f32k4["gemv_stream_tf32"] + f32k4["tf32_gemm_kernel"]):
                fail(f"{label}: the float32 tp=2 forward's K4 launches {f32k4} are not all on "
                     "gemv_stream_tf32 and tf32_gemm_kernel")
            launches[f"f32_logits_tp2_rank{r}"] = {"quant_matmul_f32": f32k4["quant_matmul_f32"]}
            ring = rk["ring"]
            if not ring["max_abs_err"] <= RING_ATOL:
                fail(f"{label}: ring attention is {ring['max_abs_err']:.3e} from dense "
                     f"(allowance {RING_ATOL})")
            sc = ring["scoring"]
            if not (sc["max_rel_err"] <= SP_SCORE_RTOL and sc["counts_equal"]):
                fail(f"{label}: ring scores at sp=2 part from sp=1's: {sc}")
            if r == 0:
                fl = rk["first_logits"]["float32"]
                if not fl["max_abs_err"] <= fl["allowance"]:
                    fail(f"the first prefill's float32 logits at tp=2 are "
                         f"{fl['max_abs_err']:.3e} from tp=1's (allowance "
                         f"{fl['allowance']:.3e})")
                entry["first_logits"] = rk["first_logits"]
        row["ranks"].append(entry)
        for k, v in rk["rows"].items():
            rows.setdefault(k, []).extend(v)
    for k, v in rows.items():
        check_rows(k, v, "the blinded input (as the phase that first held the kernel)")
    row["phase21_wall_s"] = sweep["full_width_wall_s"]
    return launches, rows, row


def same_train_state(torch, a: dict, b: dict) -> bool:
    """Two ``train.checkpoint.global_state``s hold the same step, full
    tensors and optimizer entries, bit for bit."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return isinstance(y, torch.Tensor) and torch.equal(x.cpu(), y.cpu())
        return x == y

    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    return (a["step"] == b["step"] and a["params"].keys() == b["params"].keys()
            and all(same(v, b["params"][k]) for k, v in a["params"].items())
            and sa.keys() == sb.keys()
            and all(st.keys() == sb[n].keys() and all(same(v, sb[n][k]) for k, v in st.items())
                    for n, st in sa.items())
            and a["opt_state"]["param_groups"] == b["opt_state"]["param_groups"])


def tp_train(torch, out: pathlib.Path, rank: int) -> dict:
    """Phase 31(d) in a rank: training at tp=2 over the two gloo ranks on the
    one card. (1) One float32 step of the first study checkpoint at tp=2
    after the tp=1 step on the card from the same parameters (each rank
    computes both): the losses and each gradient against the rank's part of
    tp=1's (``TrainState.cut``), the worst error over the part's scale;
    the tp=2 state saved (full tensors gathered, rank 0 writing) and
    restored at tp=1, equal to the gathered state. (2) llama3-8b at full
    width cut to ``TRAIN_LAYERS`` layers, bf16, remat, ``TRAIN_STEPS``
    steps on ``big_train_batch`` at tp=2: each rank makes the full
    parameters from seed 0 on the card and keeps its part. Returns the
    numbers; ``tp_train_checks`` in the parent gates them."""
    import torch.distributed as dist

    from fairness_llm_tpu_torch.config import MeshConfig
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.parallel.sharding import make_mesh
    from fairness_llm_tpu_torch.runtime.weights import load_checkpoint
    from fairness_llm_tpu_torch.train import make_train_step
    from fairness_llm_tpu_torch.train.checkpoint import (
        global_state,
        restore_train_state,
        save_train_state,
    )

    torch.cuda.empty_cache()
    mesh = make_mesh(MeshConfig(tp=TP_WORLD))
    name = STUDY_MODELS[0]
    cfg = get_model_config(name)
    params = load_checkpoint(cfg, str(ROOT / "checkpoints" / name), device="cuda")
    tokens, valid = study_train_batch(cfg)
    init1, step1 = make_train_step(cfg, device="cuda")
    one, loss1 = step1(init1(params=params), tokens, valid)
    init2, step2 = make_train_step(cfg, mesh=mesh, device="cuda")
    two, loss2 = step2(init2(params=params), tokens, valid)
    want = two.cut({k: p.grad for k, p in one.params.items()})
    worst = {}
    for k, p in two.params.items():
        scale = max(float(want[k].abs().max()), 1e-30)
        worst[k] = float((p.grad - want[k]).abs().max()) / scale
    ckpt = out / "train_ckpt_tp2"
    save_train_state(str(ckpt), two)
    saved = global_state(two)
    back = restore_train_state(str(ckpt), init1(5))
    restored = back is not None and same_train_state(torch, global_state(back), saved)
    study = {"model": name, "loss_tp1": float(loss1), "loss_tp2": float(loss2),
             "loss_rel_err": abs(float(loss2) - float(loss1)) / abs(float(loss1)),
             "worst_grad_err_over_scale": max(worst.values()),
             "worst_grad": max(worst, key=worst.get), "tol": TRAIN_TOL,
             "local_widths": [two.model.config.num_heads, two.model.config.num_kv_heads,
                              two.model.config.d_ff, two.model.config.vocab_size],
             "checkpoint_tp2_restored_at_tp1_equal": restored}
    del one, two, back, saved, params, want
    torch.cuda.empty_cache()
    dist.barrier()
    big = dataclasses.replace(get_model_config(MODEL), num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init, step = make_train_step(big, mesh=mesh, remat=True, device="cuda")
    state = init(0, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, valid = big_train_batch(big)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, tokens, valid)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    local = state.model.config
    big_row = {"layers": TRAIN_LAYERS, "dtype": "bfloat16", "remat": True,
               "batch": list(TRAIN_BATCH), "losses": losses, "step_ms": step_ms,
               "init_s": init_s,
               "local_params": sum(p.numel() for p in state.model.parameters()),
               "local_widths": [local.num_heads, local.num_kv_heads, local.d_ff,
                                local.vocab_size],
               "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state
    torch.cuda.empty_cache()
    return {"rank": rank, "study": study, "llama3_8b": big_row}


def tp_train_checks(res: dict, train: dict, device_line: str) -> dict:
    """Phase 31(d)'s gates on the ranks' ``tp_train`` results: the study
    step's loss within ``TRAIN_TOL`` (relative) of tp=1's and every
    gradient within ``TRAIN_TOL`` of its part's scale, the tp=2 checkpoint
    restored at tp=1 equal; llama3-8b's losses finite, falling and equal
    bit for bit on both ranks; its first loss reported beside phase (c)'s
    tp=1 first loss on the same seed and batch (bf16 at two summation
    orders: not gated). Returns the ``train_tp2`` row."""
    ranks = [rk["train"] for rk in res["ranks"]]
    for t in ranks:
        st = t["study"]
        if not (st["loss_rel_err"] <= TRAIN_TOL and st["worst_grad_err_over_scale"] <= TRAIN_TOL):
            fail(f"train tp=2 rank {t['rank']}: the study step (loss {st['loss_tp2']}) against "
                 f"tp=1's ({st['loss_tp1']}): loss {st['loss_rel_err']:.2e}, worst gradient "
                 f"{st['worst_grad']} {st['worst_grad_err_over_scale']:.2e} of scale")
        if st["local_widths"] != [2, 1, 128, 256] or not st["checkpoint_tp2_restored_at_tp1_equal"]:
            fail(f"train tp=2 rank {t['rank']}: widths {st['local_widths']}, the tp=2 checkpoint "
                 f"restored at tp=1 equal: {st['checkpoint_tp2_restored_at_tp1_equal']}")
        losses = t["llama3_8b"]["losses"]
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            fail(f"train tp=2 rank {t['rank']}: the llama3-8b ({TRAIN_LAYERS} layers) loss did "
                 f"not fall: {losses}")
        if t["llama3_8b"]["local_widths"] != [16, 4, 7168, 64128]:
            fail(f"train tp=2 rank {t['rank']}: llama3-8b held {t['llama3_8b']['local_widths']}")
    if ranks[0]["llama3_8b"]["losses"] != ranks[1]["llama3_8b"]["losses"]:
        fail(f"train tp=2: the ranks' llama3-8b losses differ: "
             f"{[t['llama3_8b']['losses'] for t in ranks]}")
    first_tp1 = train["llama3_8b"]["losses"][0]
    first_tp2 = ranks[0]["llama3_8b"]["losses"][0]
    return {"device": device_line, "world": TP_WORLD, "ranks": ranks,
            "llama3_8b_first_loss_tp1": first_tp1, "llama3_8b_first_loss_tp2": first_tp2,
            "llama3_8b_first_loss_rel_diff": abs(first_tp2 - first_tp1) / abs(first_tp1)}


def native_check(tmp: pathlib.Path) -> dict:
    """Phase 31(e): the native ratings parser built on this machine
    (``cc`` into ``build/native/``) parses a ``ratings.dat`` of
    ``NATIVE_ROWS`` rows from a seed into the pure-Python parse's arrays;
    ``data/movielens._parse_ratings`` returns the same."""
    import numpy as np

    from fairness_llm_tpu_torch import native
    from fairness_llm_tpu_torch.data import movielens

    rng = np.random.default_rng(21)
    cols = [rng.integers(1, 6041, NATIVE_ROWS), rng.integers(1, 3953, NATIVE_ROWS),
            rng.integers(1, 6, NATIVE_ROWS), rng.integers(900_000_000, 1_000_000_000, NATIVE_ROWS)]
    path = tmp / "ratings.dat"
    path.write_text("".join(f"{u}::{m}::{r}::{t}\n" for u, m, r, t in zip(*cols)))
    t0 = time.perf_counter()
    got = native.parse_ratings(str(path))
    native_s = time.perf_counter() - t0
    if got is None:
        fail("the native ratings parser did not build on this machine")
    rows = movielens._parse_dat(str(path))
    want = (np.array([int(r[0]) for r in rows], np.int32),
            np.array([int(r[1]) for r in rows], np.int32),
            np.array([float(r[2]) for r in rows], np.float32))
    via = movielens._parse_ratings(str(path))
    for label, arrays in (("native.parse_ratings", got), ("movielens._parse_ratings", via)):
        if not all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(arrays, want)):
            fail(f"{label} parts from the pure-Python parse of {path.name}")
    return {"rows": NATIVE_ROWS, "library": str(native._SO.relative_to(ROOT)),
            "parse_s_including_build": native_s, "equal_to_python": True}


def train_checks(torch, tmp: pathlib.Path, device_line: str) -> dict:
    """Phase 31(c): training on the card. One float32 step of the study
    checkpoint against the port's CPU step (loss and every gradient within
    ``TRAIN_TOL`` of the tensor's scale), a remat step equal to it, a
    checkpoint round trip and the fallback past a flipped byte; then
    llama3-8b at full width cut to ``TRAIN_LAYERS`` layers in bf16, remat,
    ``TRAIN_STEPS`` steps on one fixed batch: the loss must fall; step ms
    and peak memory logged."""
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.weights import load_checkpoint
    from fairness_llm_tpu_torch.train import make_train_step
    from fairness_llm_tpu_torch.train.checkpoint import restore_train_state, save_train_state

    name = STUDY_MODELS[0]
    cfg = get_model_config(name)
    params = load_checkpoint(cfg, str(ROOT / "checkpoints" / name), device="cpu")
    tokens, valid = study_train_batch(cfg)
    out = {"device": device_line}
    steps = {}
    for dev, remat in (("cpu", False), ("cuda", False), ("cuda", True)):
        init, step = make_train_step(cfg, remat=remat, device=dev)
        state, loss = step(init(params=params), tokens, valid)
        steps[(dev, remat)] = (state, float(loss))
    cpu, card, remat = steps[("cpu", False)], steps[("cuda", False)], steps[("cuda", True)]
    worst = {}
    for k, p in cpu[0].params.items():
        want = p.grad.float()
        scale = max(float(want.abs().max()), 1e-30)
        worst[k] = float((card[0].params[k].grad.float().cpu() - want).abs().max()) / scale
        rk = float((remat[0].params[k].grad - card[0].params[k].grad).abs().max()) / scale
        if rk > 1e-6:
            fail(f"train: the remat step's {k} gradient is {rk:.2e} of scale from the plain step's")
    loss_rel = abs(card[1] - cpu[1]) / abs(cpu[1])
    if loss_rel > TRAIN_TOL or max(worst.values()) > TRAIN_TOL or remat[1] != card[1]:
        fail(f"train: the card's study step (loss {card[1]}, remat {remat[1]}) against the "
             f"CPU's ({cpu[1]}): loss {loss_rel:.2e}, worst gradient "
             f"{max(worst.values()):.2e} of scale")
    out["study"] = {"loss_card": card[1], "loss_cpu": cpu[1], "loss_remat": remat[1],
                    "loss_rel_err": loss_rel, "worst_grad_err_over_scale": max(worst.values()),
                    "tol": TRAIN_TOL}
    # checkpoints: a round trip, then the fallback past a flipped byte
    ckpt = tmp / "train_ckpt"
    state = card[0]
    init, step = make_train_step(cfg, device="cuda")
    save_train_state(str(ckpt), state)
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    state, _ = step(state, tokens, valid)
    save_train_state(str(ckpt), state)
    back = restore_train_state(str(ckpt), init(5))
    if back is None or back.step != 2 or any(
            not torch.equal(back.params[k], v) for k, v in state.params.items()):
        fail("train: the step-2 checkpoint did not restore to the state saved")
    blob = ckpt / "2" / "train_state.pt"
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    back = restore_train_state(str(ckpt), init(5))
    if back is None or back.step != 1 or any(
            not torch.equal(back.params[k], v) for k, v in saved.items()):
        fail("train: past a flipped byte in step 2 the restore did not fall back to step 1")
    out["checkpoint"] = {"round_trip": True, "fallback_to_step": back.step}
    del steps, cpu, card, remat, state, back, saved
    torch.cuda.empty_cache()
    # llama3-8b at full width, depth cut, bf16, remat
    big = dataclasses.replace(get_model_config(MODEL), num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    init, step = make_train_step(big, remat=True, device="cuda")
    t0 = time.perf_counter()
    state = init(0, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tokens, valid = big_train_batch(big)
    losses, step_ms = [], []
    with CardSampler() as card_smi:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, loss = step(state, tokens, valid)
            losses.append(float(loss))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    n_params = sum(p.numel() for p in state.model.parameters())
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        fail(f"train: the llama3-8b ({TRAIN_LAYERS} layers) loss did not fall: {losses}")
    out["llama3_8b"] = {"layers": TRAIN_LAYERS, "params": n_params, "dtype": "bfloat16",
                        "remat": True, "batch": list(TRAIN_BATCH), "losses": losses,
                        "step_ms": step_ms, "init_s": init_s,
                        "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "card": card_smi.summary}
    del state
    torch.cuda.empty_cache()
    return out


def tp_ring_train_path(torch, device_line: str, sweep: dict, held: set) -> dict:
    """Phase 31: (a)-(b) tp=2 and sp=2 on the card over gloo, (d) training
    at tp=2 in the same ranks, then tp=1 on NCCL at one rank, (c) training
    in this process and (d)'s gates, (e) the native ratings parser. Returns
    each kernels-line entry's launches in each rank's runs and the rows of
    the calls no earlier phase held."""
    import gc
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        res = tp_run(tmp, held, TP_WORLD, "gloo")
        one = tp_run(tmp, held, 1, "nccl")
        launches, rows, row = tp_checks(torch, res, one, sweep, device_line)
        log(f"tp_sp {json.dumps(row)}")
        log(f"tp_sp_s {time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        train = train_checks(torch, tmp, device_line)
        log(f"train {json.dumps(train)}")
        log(f"train_s {time.perf_counter() - t0:.1f}")
        log(f"train_tp2 {json.dumps(tp_train_checks(res, train, device_line))}")
        log(f"native_parse {json.dumps(native_check(tmp))}")
    return {"launches": launches, "rows": rows}


# Phase 32: the study's speculative greedy sweep (``--speculate``: greedy
# prompt-lookup speculation through ``backend_for`` and ``run_phase1``, at
# SpeculationConfig's draft of 8 and n-gram of 3) on both study checkpoints
# at phase 20's settings: every decode step is a float32 verify window (K3
# on verify_split_f32).


def spec_study_sweep(torch, F, name: str, tmp: pathlib.Path, sweep: dict, held: set) -> tuple:
    """Phase 32 for one study checkpoint: the greedy sweep with speculation
    on the card; every engine call's rows against phase 20's greedy card
    rows (``sweep["greedy_card"]``: its record and calls), parting only at
    a near tie; with equal rows, the record equal to phase 20's. Every
    verify-window launch on verify_split_f32, none on a tensor-core kernel;
    each recorded verify call held against its plain version at 1e-4 with
    phase 6's blind check and its repeats bit for bit. Returns the log row,
    the launches and the rows."""
    from fairness_llm_tpu_torch.config import Config, SpeculationConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    card, card_calls = sweep["greedy_card"][name]
    cfg = greedy_config(Config(weights_dir=str(ROOT / "checkpoints"),
                               data_dir=str(ROOT / "data" / "ml-1m"),
                               results_dir=str(tmp / name / "spec"),
                               speculation=SpeculationConfig(enabled=True)),
                        name, MAX_TOKENS)
    zero_all(dec_mod, flash_mod, qm)
    backend = backend_for(name, cfg)
    calls = SweepRecorder(backend)
    rec = decode_recorder(dec_mod)
    t0 = time.perf_counter()
    with rec, CardSampler() as sampler:
        record = run_phase1(cfg, name, backend=backend, save=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    verify = verify_f32_counts(dec_mod)
    tc, one = one_query_counts(dec_mod)
    launches = {"flash_attention_f32": flash_mod.launches - flash_mod.tc_launches,
                "decode_attention_f32": one, "decode_attention_verify_f32": verify}
    if verify <= 0 or dec_mod.multi_quant_launches or tc or flash_mod.tc_launches:
        fail(f"{name} speculative sweep: launches {decode_counts(dec_mod)}, flash tc "
             f"{flash_mod.tc_launches}")
    spec = backend.spec_totals
    if spec is None or spec.verify_steps <= 0:
        fail(f"{name}: the sweep did not take the speculative path")
    check_record(record, f"{name} speculative greedy", want_non_empty=False)
    differ = greedy_divergences(f"{name} speculative", card_calls, calls, backend.engine, torch,
                                against="phase 20's greedy card run")
    if not differ and (record["recommendations"] != card["recommendations"]
                       or record["neutral_recommendations"] != card["neutral_recommendations"]):
        fail(f"{name} speculative: equal tokens but other responses than phase 20's")
    fresh = {k: v for k, v in rec.calls.items() if k[0] == "k3" and k not in held}
    held.update(fresh)
    rec.calls = fresh
    rows = [dict(r, path="spec_study") for r in decode_rows(
        rec, "k3", "decode_attention_verify_f32", torch, F, "every q_offset lowered by one")]
    row_steps = sum(c["batch"] * c["decode_steps"] for c in calls.chunks)
    row = {"model": name, "wall_s": wall,
           "phase20_greedy_wall_s": sweep["greedy_walls"][name],
           "speculation": spec.as_dict(),
           "tokens_per_verify_step_per_row": spec.emitted / max(row_steps, 1),
           "chunks": calls.chunks, "launches": launches, "rows_differing": differ,
           "card": sampler.summary}
    return row, launches, rows


def spec_study_path(torch, F, device_line: str, sweep: dict, held: set) -> dict:
    """Phase 32 on both study checkpoints; returns the launches (by model)
    and the verify window's rows."""
    import tempfile

    launches, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in STUDY_MODELS:
            row, lm, rm = spec_study_sweep(torch, F, name, pathlib.Path(tmp), sweep, held)
            log(f"spec_study {json.dumps({'device': device_line, **row})}")
            launches[f"spec_{name}"] = lm
            rows.setdefault("decode_attention_verify_f32", []).extend(rm)
    return {"launches": launches, "rows": rows}


# Phase 33: the reference's other model families (models/configs.py) on the
# card, at full width and depth with random weights from seed 0 and the byte
# tokenizer: mistral-7b (a sliding window of 4,096: K2 stays off under it, as
# in the reference, and the cached steps take the dense window path),
# gemma-7b (head width 256, one q head a kv head, GeGLU, embed_scale, a tied
# 256,000 x 3,072 head kept in bf16) and qwen2-7b (q/k/v biases after K4's
# grouped call, seven q heads a kv head, an untied head of 152,064), each
# with int8 weights as the llama3-8b runs serve them; and gpt2-small in bf16
# (BASELINE.json's phase-1 model: head width 64, learned positions,
# LayerNorm, biases, a tied head; cuBLAS projections); then the tied
# families, which have no int8 variant, in bf16 as well: llama32-1b (32 q
# heads over 8 of width 64, rep 4), llama32-3b (24 over 8 of 128, rep 3)
# and qwen2-0.5b (14 over 2 of 64, rep 7, q/k/v biases), each with a tied
# 128,256- or 151,936-row head.
FAMILY_MODELS = ("mistral-7b", "gemma-7b", "qwen2-7b")
FAMILY_BF16 = ("gpt2-small", "llama32-1b", "llama32-3b", "qwen2-0.5b")
# Depth cuts for the script's time limit: every layer of a model gives the
# kernels the same shapes, so the int8 families' sweeps and phase 2 run at
# full width with this many layers (mistral-7b's 32, gemma-7b's and
# qwen2-7b's 28 since phase 35 came in; mistral's window check, (d), runs 2
# layers as before).
FAMILY_LAYERS = {"mistral-7b": 8, "gemma-7b": 8, "qwen2-7b": 8}
# The float32 gates' depth (full width), as phase 18's.
FAMILY_GATE_LAYERS = 4
# Mistral's window on the card: one row past the window, at full width and
# this depth, then the dense window path's cached steps.
WINDOW_LAYERS = 2
WINDOW_ROW = 4608
WINDOW_STEPS = 16
# A verify window's rows a row: the draft of 8 and the bonus token.
VERIFY_Q = 9


def family_sweep(torch, F, name: str, tmp: pathlib.Path, held: set, hold: bool = True) -> dict:
    """Phase 33(a) for one family (and phase 34's sweep): the phase-1 sweep
    through ``backend_for`` and ``run_phase1`` (45 profiles and 3 neutral
    prompts in chunks of 16, t=0.7, ``MAX_TOKENS`` new tokens, the
    sweep-wide shared prefix) with int8 weights (the ``FAMILY_BF16`` models
    in bf16), at the depth ``FAMILY_LAYERS`` gives, the record checked and
    read back from disk. K1 on flash_fwd_tc, K2 on decode_split_tc (none
    under mistral's window) and K4's both regimes (none in bf16) must
    launch, and no float32 kernel. With ``hold``, every kernel call at a
    (shape, dtype) not in ``held`` is held against its plain version here;
    without it, the caller holds ``recs`` (after freeing the model). Returns
    the log row (init seconds, the parameters' bytes and the init's peak
    among them), the launches, the rows by kernels-line entry (None
    without ``hold``), the recorders, the backend, the sweep's first decode
    step and the record."""
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import backend_for
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1

    quant = name not in FAMILY_BF16
    cfg = Config(weight_quant="int8" if quant else None, max_new_tokens=MAX_TOKENS,
                 data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / name))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    depth = FAMILY_LAYERS.get(name, get_model_config(name).num_layers)
    with cut_depth(name, depth) as full:
        backend = backend_for(name, cfg, allow_random=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = (torch.cuda.memory_allocated() - before) / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mcfg = backend.engine.config
    sweep = SweepRecorder(backend)
    with CardSampler() as card:
        rec, prow, recs = timed_phase(torch, dec_mod, flash_mod, qm,
                                      lambda: run_phase1(cfg, name, backend=backend))
    launches = prow["launches"]
    label = f"{name} sweep"
    if (mcfg.weight_quant == "int8") != quant:
        fail(f"{label}: the engine's weights are {mcfg.weight_quant}")
    windowed = mcfg.sliding_window is not None
    need = ["flash_attention"] + ([] if windowed else ["decode_attention"])
    need += ["quant_matmul_gemv", "quant_matmul_gemm"] if quant else []
    need_launches(launches, need, label)
    for kernel in ("flash_attention_f32", "decode_attention_f32") + (
            ("decode_attention",) if windowed else ()) + (
            () if quant else ("quant_matmul_gemv", "quant_matmul_gemm")):
        if launches[kernel]:
            fail(f"{label}: {launches[kernel]} launches of {KERNEL_FUNCTIONS[kernel]}")
    parsed = check_record(rec, label, want_non_empty=False)
    saved_record_check(cfg, rec, label)
    steps = sum(c["decode_steps"] for c in sweep.chunks)
    row = {"model": name, "weight_quant": mcfg.weight_quant,
           "shape": {"layers": mcfg.num_layers, "d_model": mcfg.d_model,
                     "heads": [mcfg.num_heads, mcfg.num_kv_heads], "head_dim": mcfg.head_dim,
                     "d_ff": mcfg.d_ff, "vocab": mcfg.vocab_size, "window": mcfg.sliding_window,
                     "tied": mcfg.tie_embeddings, "qkv_bias": mcfg.qkv_bias},
           "wall_s": prow["wall_s"], "engine_init_s": init_s, "params_gb": params_gb,
           "init_peak_allocated_gb": init_peak_gb, "full_depth": full.num_layers,
           "decode_ms_per_step": sum(c["decode_ms_per_step"] * c["decode_steps"]
                                     for c in sweep.chunks) / max(steps, 1),
           "chunks": sweep.chunks, "peak_allocated_gb": prow["peak_allocated_gb"],
           "held_before_gb": prow["held_before_gb"], "launches": launches,
           "parsed_vacuous_random_weights": parsed, "card": card.summary}
    # The backend goes on to phase 2 unwrapped.
    vars(backend).pop("generate", None)
    vars(backend.engine).pop("generate", None)
    # The sweep's first decode step, for K3 at its shapes (verify_rows).
    first_step = next((c for k, c in recs["dec"].calls.items() if k[0] == "k2"), None)
    rows = (sweep_kernel_rows(recs, torch, F, qm, f"families_{name}", f32=False, held=held)
            if hold else None)
    return {"row": row, "launches": launches, "rows": rows, "recs": recs, "backend": backend,
            "first_step": first_step, "record": rec}


def family_phase2(torch, F, backends: dict, tmp: pathlib.Path, held: set) -> tuple:
    """Phase 33(b): ``run_phase2`` over the three int8 families in one call,
    the backends of (a) injected (kept alive together), at the study's
    settings: the record (three ``model_results`` and the cross-model
    ``comparison``) checked and read back, ``models_evaluated_total`` 3 in
    the phase's registry, a scoring forward run, K1, K2 and K4 launched.
    Returns the log row, the launches and the rows of new shapes."""
    from fairness_llm_tpu_torch import telemetry as T
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.phase2 import run_phase2

    cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                 data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / "phase2"))
    models = list(FAMILY_MODELS)
    with T.use_registry() as reg:
        p2, row, recs = timed_phase(
            torch, dec_mod, flash_mod, qm,
            lambda: run_phase2(cfg, models=models, num_items=P2_ITEMS,
                               num_comparisons=P2_COMPARISONS,
                               backends={m: backends[m] for m in models}))
    evaluated = counters_of(reg, ("models_evaluated_total",))
    label = "families phase 2"
    p23_record_check(cfg, p2, label, 2)
    if sorted(p2["model_results"]) != sorted(models) or \
            sorted(p2["comparison"].get("model_fairness", {})) != sorted(models):
        fail(f"{label}: the record does not hold the three models: "
             f"{sorted(p2['model_results'])}, {sorted(p2['comparison'])}")
    if evaluated != {"models_evaluated_total{component=phase2}": len(models)}:
        fail(f"{label}: models_evaluated_total {evaluated}")
    need_kernels(row["launches"], label, f32=False)
    need_launches(row["launches"], ("quant_matmul_gemv", "quant_matmul_gemm"), label)
    if row["scoring"]["forwards"] <= 0:
        fail(f"{label}: no scoring forward ran")
    row.update(models_evaluated_total=evaluated, results_vacuous_random_weights={
        m: {"exposure": {k: p2["model_results"][m][k]["exposure_ratio"]
                         for k in ("listwise", "pairwise", "scored")},
            "corpus_perplexity": p2["model_results"][m]["corpus_perplexity"],
            "fairness": p2["comparison"]["model_fairness"][m]} for m in models})
    rows = sweep_kernel_rows(recs, torch, F, qm, "families_phase2", f32=False, held=held)
    return row, row["launches"], rows


def family_gates(torch, prompts, name: str) -> dict:
    """Phase 33(c) for one family at full width and ``FAMILY_GATE_LAYERS``
    layers (random weights from seed 0): the teacher-forced check of phase
    9 in bf16 (reported: the largest logit difference and the argmax
    agreement with the plain-version path), then in float32 over the same
    weight tensors (``float32_twin``), held to 1e-3 of the logits' scale;
    for a tied head (gemma and the ``FAMILY_BF16`` models), the head
    product's check of phase 3 in the model's bf16 arithmetic."""
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    base = get_model_config(name if name in FAMILY_BF16 else f"{name}-int8")
    cfg = dataclasses.replace(base, num_layers=FAMILY_GATE_LAYERS,
                              use_decode_attention_kernel=True)
    engine = DecodeEngine(cfg, seed=0)
    label = f"{name}_"
    out = {"bf16": teacher_forced_gate(engine, prompts, torch, label, cfg.vocab_size)}
    if cfg.tie_embeddings:
        out["head_product"] = head_product_check(engine, torch, f"_{name}")
    twin = float32_twin(engine)
    out["f32"] = teacher_forced_gate(twin, prompts, torch, label, cfg.vocab_size, f32=True)
    del engine, twin
    torch.cuda.empty_cache()
    return out


def window_check(torch, F, held: set) -> tuple:
    """Phase 33(d): mistral-7b at full width and ``WINDOW_LAYERS`` layers
    (int8 weights): one row of ``WINDOW_ROW`` tokens prefilled (K1 with the
    window: the last WINDOW_ROW - 4,096 query rows of each layer lose keys),
    then ``WINDOW_STEPS`` cached steps through the dense window path (the
    decode kernel stays off under a window). The last prefill position's
    and each step's logits against the same model with every kernel swapped
    for its plain version: in bf16 reported, in float32 (``float32_twin``)
    held to 1e-3 of the logits' scale. K1 must launch once a layer, K2
    never; K1's windowed calls are held against their plain version (bf16
    and float32). Returns the log row, the launches and the rows."""
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.stepbuilder import make_batch_entry

    cfg = dataclasses.replace(get_model_config("mistral-7b-int8"), num_layers=WINDOW_LAYERS,
                              use_decode_attention_kernel=True)
    window = cfg.sliding_window
    g = torch.Generator().manual_seed(33)
    tokens = torch.randint(3, cfg.vocab_size, (1, WINDOW_ROW), generator=g).cuda()
    valid = torch.ones_like(tokens, dtype=torch.bool)
    steps = torch.randint(3, cfg.vocab_size, (WINDOW_STEPS,), generator=g).tolist()

    def run(engine):
        entry = make_batch_entry(engine.config, engine.model, batch=1,
                                 cache_len=WINDOW_ROW + WINDOW_STEPS)
        logits, cache = entry(tokens, valid, None)
        out = [logits]
        for t in steps:
            tok = torch.full((1, 1), t, dtype=torch.long, device="cuda")
            lg, cache = engine.model(tok, cache.lengths[:, None],
                                     torch.ones_like(tok, dtype=torch.bool), cache)
            out.append(lg[:, -1])
        return torch.cat(out)

    def compare(engine, f32: bool):
        zero_all(dec_mod, flash_mod, qm)
        qm.f32_launches = 0
        rec = flash_recorder(flash_mod)
        with rec:
            got = run(engine)
        torch.cuda.synchronize()
        counts = {"flash_attention": flash_mod.launches, "flash_attention_tc": flash_mod.tc_launches,
                  "decode_attention": dec_mod.launches, "quant_matmul_gemv": qm.gemv_launches,
                  "quant_matmul_gemm": qm.gemm_launches, "quant_matmul_f32": qm.f32_launches}
        with plain_kernels():
            want = run(engine)
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        res = {"max_abs_logit_diff": diff, "max_abs_logit": scale,
               "argmax_agreement": float((got.argmax(-1) == want.argmax(-1)).float().mean()),
               "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape),
               "launches": counts}
        kind = "float32" if f32 else "bf16"
        if not res["finite"] or res["shape"] != [1 + WINDOW_STEPS, cfg.vocab_size]:
            fail(f"mistral window ({kind}): logits malformed: {res}")
        if counts["flash_attention"] != WINDOW_LAYERS or counts["decode_attention"]:
            fail(f"mistral window ({kind}): launches {counts}; K1 must launch once a layer "
                 f"and K2 never under a window")
        if counts["flash_attention_tc"] != (0 if f32 else WINDOW_LAYERS):
            fail(f"mistral window ({kind}): K1 ran the other type's kernel: {counts}")
        if f32 and diff > 1e-3 * max(1.0, scale):
            fail(f"mistral window: the kernel path disagrees with the plain-version path in "
                 f"float32: {res}")
        name = "flash_attention_f32" if f32 else "flash_attention"
        fresh = [c for k, c in rec.calls.items() if k not in held]
        held.update(rec.calls)
        rows = [dict(k1_numbers(c, torch, F), path="families_window") for c in fresh]
        check_rows(name, rows, "the first valid key masked out")
        if not any(r["shape"]["window"] == window and r["shape"]["q"][2] > window
                   for r in rows):
            fail(f"mistral window ({kind}): no K1 row past the window was held")
        # Each kernels-line entry's launches: a float32 run's K1 and K4
        # calls are their float32 routes'.
        by_entry = ({"flash_attention_f32": counts["flash_attention"],
                     "decode_attention_f32": 0, "quant_matmul_f32": counts["quant_matmul_f32"]}
                    if f32 else {"flash_attention": counts["flash_attention_tc"],
                                 "decode_attention": 0,
                                 "quant_matmul_gemv": counts["quant_matmul_gemv"],
                                 "quant_matmul_gemm": counts["quant_matmul_gemm"]})
        return res, by_entry, {name: rows}

    engine = DecodeEngine(cfg, seed=0)
    t0 = time.perf_counter()
    bf16, counts, rows = compare(engine, f32=False)
    twin = float32_twin(engine)
    f32, counts32, rows32 = compare(twin, f32=True)
    del engine, twin
    torch.cuda.empty_cache()
    prefill_cut = WINDOW_LAYERS * max(WINDOW_ROW - window, 0)
    row = {"model": "mistral-7b-int8", "layers": WINDOW_LAYERS, "row_tokens": WINDOW_ROW,
           "steps": WINDOW_STEPS, "window": window, "wall_s": time.perf_counter() - t0,
           "prefill_query_rows_cut": prefill_cut, "decode_query_rows_cut": WINDOW_STEPS,
           "bf16": bf16, "f32": f32}
    if prefill_cut + WINDOW_STEPS <= 0:
        fail(f"mistral window: no query row lost a key to the window: {row}")
    return row, {"window_bf16": counts, "window_f32": counts32}, {**rows, **rows32}


def verify_rows(torch, F, first_steps: dict, path: str = "families") -> list:
    """Phase 33(e): K3 (decode_verify_tc) at the sweeps' shapes, at kernel
    level: for each family with the decode kernel, its phase-1 sweep's
    first recorded decode step (the shared prefix and the row cache as the
    sweep left them) with q widened to a verify window of ``VERIFY_Q`` rows
    a row (random, seed 33) whose last slot is the row's newest valid slot;
    held against the plain version with phase 6's blind check."""
    rows = []
    for name, call in first_steps.items():
        if call is None:
            continue
        q, k, v, valid = call["args"][:4]
        B, H, D = q.shape
        g = torch.Generator(device=q.device).manual_seed(33)
        q4 = torch.randn(B, VERIFY_Q, H, D, generator=g, device=q.device).to(q.dtype)
        slots = torch.arange(valid.shape[1], device=q.device)
        newest = torch.where(valid.bool(), slots, -1).amax(1)
        if int(newest.min()) < VERIFY_Q - 1:
            fail(f"{name}: a row holds fewer than {VERIFY_Q} valid slots for a verify window")
        offs = (newest - (VERIFY_Q - 1)).to(torch.int32)
        k3 = {"n": 0, "args": (q4, k, v, valid),
              "kwargs": {**call["kwargs"], "q_offsets": offs}}
        rows.append(dict(decode_numbers(k3, torch, F), path=f"{path}_{name}_kernel"))
    check_rows("decode_attention_verify", rows, "every q_offset lowered by one")
    return rows


def families_path(torch, F, device_line: str, prompts, held: set) -> dict:
    """Phase 33: (a) each family's phase-1 sweep, (b) phase 2 over the three
    int8 families, (c) the float32 gates at 4 layers, (d) mistral's window,
    (e) K3 at the sweeps' shapes. Kernel calls at a shape in ``held`` (the
    keys earlier phases held: mistral's layers are llama3-8b's) are not
    held again. The seconds of the tied families' sweeps and gates
    (llama32-1b, llama32-3b, qwen2-0.5b) are logged apart
    (``families_tied_s``). Returns the launches by path and the rows by
    kernels-line entry."""
    import gc
    import tempfile

    launches, rows = {}, {}

    def add(new_rows):
        for k, v in new_rows.items():
            rows.setdefault(k, []).extend(v)

    t0 = time.perf_counter()
    backends, first_steps, seconds = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name in FAMILY_MODELS + FAMILY_BF16:
            t1 = time.perf_counter()
            sweep = family_sweep(torch, F, name, tmp, held)
            log(f"families_phase1 {json.dumps({'device': device_line, **sweep['row']})}")
            launches[f"families_{name}"] = sweep["launches"]
            add(sweep["rows"])
            first_steps[name] = sweep["first_step"]
            if name in FAMILY_MODELS:
                backends[name] = sweep["backend"]
            del sweep
            seconds[name] = time.perf_counter() - t1
        row, lm, rm = family_phase2(torch, F, backends, tmp, held)
        log(f"families_phase2 {json.dumps({'device': device_line, **row})}")
        launches["families_phase2"] = lm
        add(rm)
    backends.clear()
    add({"decode_attention_verify": verify_rows(torch, F, first_steps)})
    first_steps.clear()
    gc.collect()
    torch.cuda.empty_cache()
    gates = {}
    for name in FAMILY_MODELS + FAMILY_BF16:
        t1 = time.perf_counter()
        gates[name] = family_gates(torch, prompts, name)
        seconds[name] += time.perf_counter() - t1
    log(f"families_f32_gates {json.dumps({'device': device_line, **gates})}")
    # the tied families' sweeps and gates, which phase 33 ran without before
    log(f"families_tied_s {sum(seconds[name] for name in FAMILY_BF16[1:]):.1f}")
    row, lm, rm = window_check(torch, F, held)
    log(f"families_window {json.dumps({'device': device_line, **row})}")
    launches.update({f"families_{k}": v for k, v in lm.items()})
    add(rm)
    log(f"families_s {time.perf_counter() - t0:.1f}")
    return {"launches": launches, "rows": rows}


# Phase 34: llama3-70b (BASELINE.json configs[4]'s model: 80 layers,
# d_model 8,192, 64 q heads over 8 kv heads of 128, d_ff 28,672, an untied
# 128,256-row head) on the one card with int8 weights at full width and
# depth, the fit the reference names for one device (~71.6 GB of
# parameters). It runs in a child process of its own (``python3
# chip_smoke.py --phase 34``), whose lines the main run streams: the child
# starts from an empty card, where the parent holds what its earlier phases
# left allocated and cached.
LLAMA70B = "llama3-70b"
# The parameters' bytes after init against the port's own count at tp=1
# (``parallel.sharding.per_device_param_bytes``).
PARAM_BYTES_RTOL = 0.01
# C9: K2's and K3's bf16 kernels at llama3-8b's and llama3-70b's decode
# (Q = 1) and verify (Q = 9) heads, (B, Q, H, Hkv) at head width 128, with
# v of scale 4, over rows as the phase-1 sweep gives them (the 640-key
# prefix, 100-224 own slots) and over rows of 12 keys with no prefix.
LARGE_VALUE_SHAPES = {"llama3-8b_decode": (16, 1, 32, 8), "llama3-8b_verify": (16, 9, 32, 8),
                      "llama3-70b_decode": (16, 1, 64, 8), "llama3-70b_verify": (16, 9, 64, 8)}
LLAMA70B_CHILD_S = 1000


def large_value_check(torch) -> dict:
    """C9 on the card: decode_split_tc and decode_verify_tc at
    ``LARGE_VALUE_SHAPES`` with v of scale 4 (bf16, seed 9), each against
    its plain version at the bf16 allowance; each shape's largest error
    over the allowance, which must not pass 1."""
    from fairness_llm_tpu_torch.ops import decode_attention as dm

    D, L = 128, 224
    out = {}
    for shape, (B, Q, H, Hkv) in LARGE_VALUE_SHAPES.items():
        for rows in ("sweep", "short"):
            g = torch.Generator(device="cuda").manual_seed(9)
            q = torch.randn(B, Q, H, D, generator=g, device="cuda").bfloat16()
            k = torch.randn(B, L, Hkv, D, generator=g, device="cuda").bfloat16()
            v = (torch.randn(B, L, Hkv, D, generator=g, device="cuda") * 4).bfloat16()
            if rows == "sweep":
                P, keys = 640, torch.randint(100, L + 1, (B,), generator=g, device="cuda")
                shared = (torch.randn(P, Hkv, D, generator=g, device="cuda").bfloat16(),
                          (torch.randn(P, Hkv, D, generator=g, device="cuda") * 4).bfloat16())
            else:
                keys, shared = torch.full((B,), 12, device="cuda"), None
            valid = torch.arange(L, device="cuda")[None, :] < keys[:, None]
            kw = {} if Q == 1 else {"q_offsets": (keys - Q).to(torch.int32)}
            qq = q[:, 0] if Q == 1 else q
            err, ratio = gate(dm.decode_attention(qq, k, v, valid, shared, **kw),
                              dm.decode_attention_reference(qq, k, v, valid, shared, **kw))
            out[f"{shape}_{rows}"] = {"max_abs_err": err, "err_over_tol": ratio}
    worst = max(r["err_over_tol"] for r in out.values())
    if worst > 1:
        fail(f"K2/K3 at v of scale 4 miss the bf16 allowance: {out}")
    return {"rows": out, "max_err_over_tol": worst}


def study_calibration(tmp: pathlib.Path) -> tuple:
    """The study checkpoint's phase-3 calibration rows (prompts,
    continuations), as phase 22 takes them: tiny-llama-study's t=0.7
    phase-1 sweep, then its phase 3 with the study's calibration."""
    from fairness_llm_tpu_torch.config import Config
    from fairness_llm_tpu_torch.pipeline.phase1 import run_phase1
    from fairness_llm_tpu_torch.pipeline.phase3 import run_phase3

    name = STUDY_MODELS[0]
    cfg = Config(weights_dir=str(ROOT / "checkpoints"), data_dir=str(ROOT / "data" / "ml-1m"),
                 results_dir=str(tmp / name))
    p1 = run_phase1(cfg, name)
    with CalibrationRows() as rows3:
        run_phase3(cfg, phase1_results=p1, model_name=name, calibration=CALIBRATION, save=False)
    if not rows3.calls or not rows3.calls[0][0]:
        fail(f"{name} phase 3: the calibration scored no row")
    return rows3.calls[0][:2]


def memory_line(torch, label: str) -> None:
    free, total = torch.cuda.mem_get_info()
    log(f"{label} " + json.dumps({
        "free_gb": free / 1e9, "total_gb": total / 1e9,
        "allocated_gb": torch.cuda.memory_allocated() / 1e9,
        "reserved_gb": torch.cuda.memory_reserved() / 1e9}))


def llama70b_path(torch, F, device_line: str, prompts) -> dict:
    """Phase 34, in its own process: (1) ``backend_for`` builds llama3-70b
    with ``weight_quant="int8"`` and random weights from seed 0 (byte
    tokenizer); the init's seconds, its peak, and the parameters' bytes
    against ``per_device_param_bytes`` at tp=1 (within 1%) and
    ``int8_tree_bytes``; (2) the phase-1 sweep as ``family_sweep`` runs it
    (K1, K2 and both K4 regimes on their tensor-core kernels, no float32
    kernel; the record checked and read back); (3) ``run_phase3`` on the
    sweep's record with the study's calibration (the conformal variant:
    with random weights naming no title, the aggressive variant raises in
    ``facter.smart_balance``, as the reference's does), then the scoring
    forward over the study checkpoint's calibration rows; (4) with the
    80-layer model freed, every kernel call of (2)-(3) held against its
    plain version (the lm_head's K4 GEMM with a float32 output at the
    scoring M among them), K3 at kernel level at the sweep's first decode
    step (72 query rows a kv head), and K2/K3 at v of scale 4 (C9); (5)
    the float32 gate at full width and 4 layers. Returns the launches by
    path and the rows by kernels-line entry."""
    import gc
    import tempfile

    import numpy as np

    from fairness_llm_tpu_torch.config import Config, MeshConfig
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.parallel.sharding import per_device_param_bytes
    from fairness_llm_tpu_torch.pipeline.phase3 import run_phase3
    from fairness_llm_tpu_torch.runtime.scoring import score_prompted_continuations

    t0 = time.perf_counter()
    memory_line(torch, "llama70b_memory_at_start")
    launches, rows, held = {}, {}, set()

    def add(new_rows):
        for k, v in new_rows.items():
            rows.setdefault(k, []).extend(v)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        calibration = study_calibration(tmp)
        sweep = family_sweep(torch, F, LLAMA70B, tmp, held, hold=False)
        backend, row = sweep.pop("backend"), sweep["row"]
        mcfg = backend.engine.config
        want = per_device_param_bytes(mcfg, MeshConfig(), itemsize=2)
        got = row["params_gb"] * 1e9
        row.update(per_device_param_gb=want / 1e9, int8_tree_gb=int8_tree_bytes(mcfg) / 1e9,
                   params_over_per_device=got / want)
        log(f"llama70b_phase1 {json.dumps({'device': device_line, **row})}")
        if mcfg.num_layers != 80 or mcfg.d_model != 8192 or mcfg.weight_quant != "int8":
            fail(f"phase 34 did not build llama3-70b int8 at full width and depth: {mcfg}")
        if abs(got - want) > PARAM_BYTES_RTOL * want:
            fail(f"llama3-70b int8: {got} bytes allocated by the init, "
                 f"per_device_param_bytes says {want}")
        launches["llama70b_phase1"] = sweep["launches"]

        cfg = Config(weight_quant="int8", max_new_tokens=MAX_TOKENS,
                     data_dir=str(ROOT / "data" / "ml-1m"), results_dir=str(tmp / "phase3"))
        label = "llama3-70b int8 phase 3"
        p3, p3row, recs3 = timed_phase(
            torch, dec_mod, flash_mod, qm,
            lambda: run_phase3(cfg, phase1_results=sweep["record"], model_name=LLAMA70B,
                               calibration=CALIBRATION, backend=backend))
        # Random weights name no title, so run_phase3's calibration scores
        # no row: the study checkpoint's rows, through the same engine.
        sc, scrow, recs_sc = timed_phase(
            torch, dec_mod, flash_mod, qm,
            lambda: score_prompted_continuations(backend.engine, *calibration))
        p23_record_check(cfg, p3, label, 3)
        need_kernels(p3row["launches"], label, f32=False)
        if scrow["scoring"]["forwards"] <= 0:
            fail(f"{label}: no scoring forward ran over the calibration rows")
        if not np.isfinite(sc.log_likelihoods).all() or not any(sc.token_counts):
            fail(f"{label}: the scoring of the calibration rows is malformed: {sc}")
        head = tuple(backend.engine.model.lm_head.kernel_q.shape)
        launches["llama70b_phase3"] = p3row["launches"]
        launches["llama70b_phase3_scoring"] = scrow["launches"]
        log(f"llama70b_phase3 " + json.dumps({
            "device": device_line, "variant": "conformal", "calibration": CALIBRATION,
            "phase3": p3row, "phase3_scoring": scrow, "scoring_rows": len(calibration[0]),
            "kept_titles": sum(len(v) for v in p3["mitigated_recommendations"].values()),
            "mean_logprob_vacuous_random_weights": float(np.mean(sc.mean_logprobs))}))
        del backend, p3, sc
        gc.collect()
        torch.cuda.empty_cache()
        memory_line(torch, "llama70b_memory_freed")
        for recs, path in ((sweep.pop("recs"), "llama70b_phase1"), (recs3, "llama70b_phase3"),
                           (recs_sc, "llama70b_phase3_scoring")):
            add(sweep_kernel_rows(recs, torch, F, qm, path, f32=False, held=held))
        del recs3, recs_sc
    if not any(r["scoring"] and (r["shape"]["K"], r["shape"]["N"]) == head
               and r["shape"]["out"] == "float32" for r in rows.get("quant_matmul_gemm", [])):
        fail("the lm_head's K4 GEMM with an f32 output was not called by a scoring forward")
    add({"decode_attention_verify": verify_rows(torch, F, {LLAMA70B: sweep.pop("first_step")},
                                                "llama70b")})
    log(f"c9_large_values {json.dumps({'device': device_line, **large_value_check(torch)})}")
    gc.collect()
    torch.cuda.empty_cache()
    gate70 = family_gates(torch, prompts, LLAMA70B)
    log(f"llama70b_f32_gate {json.dumps({'device': device_line, **gate70})}")
    log(f"llama70b_s {time.perf_counter() - t0:.1f}")
    return {"launches": launches, "rows": rows}


# Phase 35: the HF checkpoint path at full width, on the card machine's
# local disk. llama3-8b at all 32 layers, bf16 (the export and both loads);
# llama3-70b at 2 of its 80 layers, re-sharded as HF ships it; four more
# families at full width (gpt2-small at its 12 layers, the others at 2).
CKPT_MODEL = "llama3-8b"
CKPT_70B = "llama3-70b"
CKPT_70B_LAYERS = 2
CKPT_70B_SHARDS = 3
CKPT_FAMILIES = {"gemma-7b": 2, "qwen2-7b": 2, "gpt2-small": 12, "llama32-1b": 2}
# The int8 load of the bf16 checkpoint may take at most this share of the
# bf16 tree's bytes above what was allocated when it started: no float copy
# of the tree is made (the largest transient is one tensor's f32 work).
CKPT_INT8_PEAK = 0.75
# Disk the phase may fill at once, beyond its checkpoints' bytes.
CKPT_DISK_SLACK = 1 << 30
CHECKPOINT_CHILD_S = 900


def tree_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())


def same_tensors(got, want, label: str) -> None:
    """Every tensor of ``got`` equal to ``want``'s, bit for bit, in dtype
    and shape, with the same names."""
    import torch

    if sorted(got) != sorted(want):
        fail(f"{label}: names differ: missing {sorted(set(want) - set(got))[:8]}, "
             f"unexpected {sorted(set(got) - set(want))[:8]}")
    bad = [name for name, w in want.items()
           if got[name].dtype != w.dtype or got[name].shape != w.shape
           or not torch.equal(got[name], w)]
    if bad:
        fail(f"{label}: {len(bad)} of {len(want)} tensors differ, e.g. {bad[:8]}")


@contextlib.contextmanager
def manifest_seconds():
    """The seconds ``write_manifest`` and ``maybe_verify_manifest`` take
    inside the export and the loads (both import them when called)."""
    from fairness_llm_tpu_torch.integrity import manifest as man

    seconds = {"write_s": 0.0, "verify_s": 0.0}
    inner = {"write_s": man.write_manifest, "verify_s": man.maybe_verify_manifest}

    def timed(key):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner[key](*args, **kwargs)
            finally:
                seconds[key] += time.perf_counter() - t0
        return run

    man.write_manifest, man.maybe_verify_manifest = timed("write_s"), timed("verify_s")
    try:
        yield seconds
    finally:
        man.write_manifest, man.maybe_verify_manifest = inner["write_s"], inner["verify_s"]


class LoadTrace:
    """Wraps ``SafetensorsFile.get_tensor`` during a load onto the card:
    for each tensor read, in the map's order, the bytes allocated when its
    read starts (what the load holds by then) and the peak allocated until
    the next read starts (so its transient above them)."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from fairness_llm_tpu_torch.runtime.safetensors_io import SafetensorsFile

        torch = self.torch
        self.cls, self.inner, self.rows = SafetensorsFile, SafetensorsFile.get_tensor, []
        torch.cuda.synchronize()
        self.base = torch.cuda.memory_allocated()
        inner = self.inner

        def get_tensor(f, name):
            self._close()
            self.rows.append({"name": name, "resident": torch.cuda.memory_allocated()})
            torch.cuda.reset_peak_memory_stats()
            return inner(f, name)

        self.cls.get_tensor = get_tensor
        return self

    def _close(self) -> None:
        if self.rows and "peak" not in self.rows[-1]:
            self.rows[-1]["peak"] = self.torch.cuda.max_memory_allocated()

    def __exit__(self, *exc):
        self._close()
        self.cls.get_tensor = self.inner

    def peak_above(self) -> int:
        return max((r["peak"] for r in self.rows), default=self.base) - self.base


def tensor_kind(hf_name: str) -> str:
    """A tensor's kind by its HF name: the projection, the embedding, the
    head or a norm."""
    for kind in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        if f".{kind}." in hf_name:
            return kind
    if "embed_tokens" in hf_name:
        return "embedding"
    return "lm_head" if hf_name.startswith("lm_head") else "norm"


def export_checkpoint(torch, cfg, params, d: pathlib.Path) -> dict:
    """``save_checkpoint_hf`` into ``d``: the export's seconds and GB/s
    apart from the manifest's."""
    from fairness_llm_tpu_torch.runtime.weights import save_checkpoint_hf

    torch.cuda.synchronize()
    with manifest_seconds() as man:
        t0 = time.perf_counter()
        save_checkpoint_hf(cfg, params, str(d))
        total = time.perf_counter() - t0
    nbytes = sum(p.stat().st_size for p in d.glob("*.safetensors"))
    write_s = total - man["write_s"]
    return {"file_gb": nbytes / 1e9, "export_s": write_s, "export_gbps": nbytes / 1e9 / write_s,
            "manifest_s": man["write_s"], "manifest_gbps": nbytes / 1e9 / man["write_s"]}


def traced_load(torch, cfg, d: pathlib.Path) -> tuple:
    """``load_checkpoint(cfg, d, device="cuda")`` traced tensor by tensor:
    (the state dict, its row: the manifest check's seconds, the streaming
    load's seconds and GB/s, the peak allocated above the start, the
    tensor whose read reached it, and the trace)."""
    import gc

    from fairness_llm_tpu_torch.runtime.weights import load_checkpoint

    gc.collect()
    torch.cuda.empty_cache()
    nbytes = sum(p.stat().st_size for p in d.glob("*.safetensors"))
    with manifest_seconds() as man, LoadTrace(torch) as trace:
        t0 = time.perf_counter()
        params = load_checkpoint(cfg, str(d), device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    load_s = total - man["verify_s"]
    top = max(trace.rows, key=lambda r: r["peak"])
    row = {"files": len(list(d.glob("*.safetensors"))), "file_gb": nbytes / 1e9,
           "manifest_s": man["verify_s"], "manifest_gbps": nbytes / 1e9 / man["verify_s"],
           "load_s": load_s, "load_gbps": nbytes / 1e9 / load_s,
           "allocated_before_gb": trace.base / 1e9, "tree_gb": tree_bytes(params) / 1e9,
           "peak_above_start_gb": trace.peak_above() / 1e9,
           "peak_allocated_gb": top["peak"] / 1e9, "peak_at": top["name"]}
    return params, row, trace


def disk_check(tmp: pathlib.Path, parts: dict) -> dict:
    """Fails unless ``tmp``'s file system has room for the largest part
    (each part's directory is removed before the next is written); logs
    the host memory available beside it (the page cache holds a written
    checkpoint while there is room)."""
    import os
    import shutil

    free = shutil.disk_usage(tmp).free
    need = max(parts.values()) + CKPT_DISK_SLACK
    host = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    row = {"dir": str(tmp), "free_gb": free / 1e9, "need_gb": need / 1e9,
           "parts_gb": {k: v / 1e9 for k, v in parts.items()},
           "host_memory_available_gb": host / 1e9}
    log(f"checkpoint_disk {json.dumps(row)}")
    if free < need:
        fail(f"phase 35 needs {need / 1e9:.2f} GB free under {tmp} ({row['parts_gb']}), "
             f"has {free / 1e9:.2f} GB")
    return row


def checkpoint_engines(torch, F, cfg, trees: dict, prompts, quant: bool, held: set) -> dict:
    """One engine on each tree of ``trees`` (label -> state dict, the
    in-memory tree first) serves ``prompts`` greedy with their shared
    prefix, ``MAX_TOKENS`` new tokens: the tokens must be equal, K1 and K2
    must launch on their tensor-core kernels (and K4's both regimes under
    int8 weights) and no float32 kernel. Every kernel call at a shape not
    in ``held`` is then held against its plain version."""
    import gc

    import numpy as np

    from fairness_llm_tpu_torch.config import ModelSettings
    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import flash_attention as flash_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend, shared_prefix_ids
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    ecfg = dataclasses.replace(cfg, use_decode_attention_kernel=True)
    greedy = ModelSettings(temperature=0.0, max_tokens=MAX_TOKENS)
    launches, rows, tokens, stats = {}, {}, {}, {}
    for label, params in trees.items():
        engine = DecodeEngine(ecfg, params=params, param_dtype=cfg.dtype)
        if any(p.data_ptr() != params[n].data_ptr() for n, p in engine.model.state_dict().items()
               if n in params):
            fail(f"checkpoint {label}: the engine copied the tree it was given")
        prefix = shared_prefix_ids(EngineBackend(engine), prompts)
        if prefix is None:
            fail("the counterfactual prompts share no 64-token prefix")
        # Warm-up outside the counted run, sharing no prefix: a prefix's KV
        # would be kept for the counted call, and its prefill (K1) skipped.
        engine.generate(prompts[:2], ModelSettings(temperature=0.0, max_tokens=2),
                        share_prefix=False)
        out, row, recs = timed_phase(torch, dec_mod, flash_mod, qm,
                                     lambda: engine.generate(prompts, greedy, prefix_ids=prefix))
        path = f"checkpoint_{label}"
        need = ["flash_attention", "decode_attention"]
        need += ["quant_matmul_gemv", "quant_matmul_gemm"] if quant else []
        need_launches(row["launches"], need, path)
        for kernel in ("flash_attention_f32", "decode_attention_f32") + (
                () if quant else ("quant_matmul_gemv", "quant_matmul_gemm")):
            if row["launches"][kernel]:
                fail(f"{path}: {row['launches'][kernel]} launches of {KERNEL_FUNCTIONS[kernel]}")
        if not out.stats["logits_finite"]:
            fail(f"{path}: non-finite logits")
        if out.stats["prefix_len"] <= 0:
            fail(f"{path}: the call did not take the shared-prefix path")
        launches[path], tokens[label] = row["launches"], out.tokens
        st = out.stats
        stats[label] = {"wall_s": row["wall_s"], "prefix_len": st["prefix_len"],
                        "decode_steps": st["decode_steps"],
                        "decode_ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
                        "peak_allocated_gb": row["peak_allocated_gb"]}
        del engine, out
        gc.collect()
        for k, v in sweep_kernel_rows(recs, torch, F, qm, path, f32=False, held=held).items():
            rows.setdefault(k, []).extend(v)
        del recs
    first, *rest = trees
    for label in rest:
        if not np.array_equal(tokens[label], tokens[first]):
            diff = int((np.asarray(tokens[label]) != np.asarray(tokens[first])).any(1).sum())
            fail(f"checkpoint: greedy tokens of the engine on the {label} tree differ from the "
                 f"{first} tree's in {diff} of {len(prompts)} rows")
    return {"launches": launches, "rows": rows, "stats": stats,
            "tokens_equal": True, "rows_compared": len(prompts)}


def checkpoint_8b(torch, F, tmp: pathlib.Path, prompts, device_line: str, held: set) -> dict:
    """Phase 35(a): llama3-8b's bf16 tree (seed 0) exported at full width
    and depth, loaded back in bf16 and as int8 weights, each bit for bit,
    and served by an engine beside the in-memory tree's."""
    import gc
    import shutil

    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.weights import init_params, quantize_params

    cfg, qcfg = get_model_config(CKPT_MODEL), get_model_config(CKPT_MODEL + "-int8")
    t0 = time.perf_counter()
    tree = init_params(cfg, 0, torch.device("cuda"))
    torch.cuda.synchronize()
    nbytes = tree_bytes(tree)
    row = {"model": CKPT_MODEL, "layers": cfg.num_layers, "tree_gb": nbytes / 1e9,
           "params": sum(t.numel() for t in tree.values()), "init_s": time.perf_counter() - t0}
    d = tmp / CKPT_MODEL
    try:
        row["export"] = export_checkpoint(torch, cfg, tree, d)
        log(f"checkpoint_llama3_8b_export {json.dumps({'device': device_line, **row})}")
        loaded, row["load_bf16"], _ = traced_load(torch, cfg, d)
        log(f"checkpoint_llama3_8b_load_bf16 {json.dumps(row['load_bf16'])}")
        same_tensors(loaded, tree, f"{CKPT_MODEL} bf16 load")
        engines = checkpoint_engines(torch, F, cfg, {"bf16_memory": tree, "bf16_loaded": loaded},
                                     prompts, False, held)
        del loaded
        loaded_q, row["load_int8"], _ = traced_load(torch, qcfg, d)
        limit = CKPT_INT8_PEAK * nbytes
        row["load_int8"]["peak_over_bf16_tree"] = row["load_int8"]["peak_above_start_gb"] * 1e9 \
            / nbytes
        log(f"checkpoint_llama3_8b_load_int8 {json.dumps(row['load_int8'])}")
        want_q = quantize_params(tree)
        same_tensors(loaded_q, want_q, f"{CKPT_MODEL} int8 load")
        if row["load_int8"]["peak_above_start_gb"] * 1e9 > limit:
            fail(f"{CKPT_MODEL} int8 load: peak {row['load_int8']['peak_above_start_gb']:.3f} GB "
                 f"above its start, over {CKPT_INT8_PEAK} x the bf16 tree ({limit / 1e9:.3f} GB)")
        engines_q = checkpoint_engines(torch, F, qcfg,
                                       {"int8_memory": want_q, "int8_loaded": loaded_q},
                                       prompts, True, held)
        del loaded_q, want_q
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    row["engines"] = {**engines["stats"], **engines_q["stats"]}
    log(f"checkpoint_llama3_8b {json.dumps({'device': device_line, **row})}")
    rows = engines["rows"]
    for k, v in engines_q["rows"].items():
        rows.setdefault(k, []).extend(v)
    return {"launches": {**engines["launches"], **engines_q["launches"]}, "rows": rows}


def reshard(src: pathlib.Path, dst: pathlib.Path, shards: int) -> dict:
    """``src``'s tensors written into ``shards`` files under ``dst`` (by the
    file's layout order, a shard closed once it passes its share of the
    bytes) behind a ``model.safetensors.index.json``, with the port's reader
    and writer, one shard's tensors on the host at a time."""
    from fairness_llm_tpu_torch.runtime.safetensors_io import (INDEX_FILENAME, SafetensorsFile,
                                                               read_header, save_file)

    header, _ = read_header(str(src))
    header.pop("__metadata__", None)
    names = sorted(header, key=lambda n: header[n]["data_offsets"][0])
    sizes = {n: header[n]["data_offsets"][1] - header[n]["data_offsets"][0] for n in names}
    total = sum(sizes.values())
    groups, cum = [[]], 0
    for name in names:
        if len(groups) < shards and cum >= total * len(groups) / shards:
            groups.append([])
        groups[-1].append(name)
        cum += sizes[name]
    dst.mkdir(parents=True)
    weight_map, digests = {}, {}
    t0 = time.perf_counter()
    with SafetensorsFile(str(src)) as f:
        for i, group in enumerate(groups):
            fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
            digests[fname] = save_file({n: f.get_tensor(n) for n in group}, str(dst / fname))
            weight_map.update((n, fname) for n in group)
    (dst / INDEX_FILENAME).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))
    return {"shards": len(groups), "shard_gb": [sum(sizes[n] for n in g) / 1e9 for g in groups],
            "reshard_s": time.perf_counter() - t0, "digests": digests}


def reckon_full_depth(torch, trace: LoadTrace, layers_run: int) -> dict:
    """The full-depth int8 load's peak of llama3-70b, reckoned from the
    cut-depth load: its tensors in the map's order, each resident in its
    int8 layout, and each one's transient taken from the same kind of
    tensor in ``trace`` (every layer's tensors have the same shapes)."""
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.weights import hf_name_map, param_shapes

    transient = {}
    for r in trace.rows:
        kind = tensor_kind(r["name"])
        transient[kind] = max(transient.get(kind, 0), r["peak"] - r["resident"])
    full = get_model_config(CKPT_70B + "-int8")
    shapes = param_shapes(full)
    resident, reckoned, at = 0, 0, None
    for ours, (hf_name, _tf) in hf_name_map(full).items():
        base = ours[: -len(".kernel")] if ours.endswith(".kernel") else (
            "lm_head" if ours == "lm_head" else None)
        if base is None:
            nbytes = shapes[ours].numel() * 2
        else:
            nbytes = shapes[f"{base}.kernel_q"].numel() + 4 * shapes[f"{base}.kernel_scale"].numel()
        peak = resident + transient[tensor_kind(hf_name)]
        if peak > reckoned:
            reckoned, at = peak, hf_name
        resident += nbytes
    card = torch.cuda.mem_get_info()[1]
    return {"layers_measured": layers_run, "layers": full.num_layers,
            "transient_gb_by_kind": {k: v / 1e9 for k, v in sorted(transient.items())},
            "resident_int8_tree_gb": resident / 1e9, "reckoned_peak_gb": reckoned / 1e9,
            "reckoned_peak_at": at, "card_gb": card / 1e9,
            "headroom_gb": (card - reckoned) / 1e9}


def checkpoint_70b(torch, tmp: pathlib.Path, device_line: str) -> None:
    """Phase 35(b): llama3-70b's bf16 tree at full width and
    ``CKPT_70B_LAYERS`` layers exported, re-sharded into
    ``CKPT_70B_SHARDS`` files behind an index, and loaded as int8 weights
    through it, bit for bit against quantizing on the card; each tensor's
    transient above the load's resident bytes, and the full-depth peak
    reckoned from them."""
    import gc
    import shutil

    from fairness_llm_tpu_torch.integrity.manifest import write_manifest
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.weights import init_params, quantize_params

    cfg = dataclasses.replace(get_model_config(CKPT_70B), num_layers=CKPT_70B_LAYERS)
    qcfg = dataclasses.replace(get_model_config(CKPT_70B + "-int8"), num_layers=CKPT_70B_LAYERS)
    tree = init_params(cfg, 0, torch.device("cuda"))
    nbytes = tree_bytes(tree)
    row = {"model": CKPT_70B, "layers": CKPT_70B_LAYERS, "tree_gb": nbytes / 1e9}
    single, sharded = tmp / f"{CKPT_70B}-single", tmp / CKPT_70B
    try:
        row["export"] = export_checkpoint(torch, cfg, tree, single)
        row["reshard"] = reshard(single / "model.safetensors", sharded, CKPT_70B_SHARDS)
        shutil.rmtree(single)
        t0 = time.perf_counter()
        write_manifest(str(sharded), digests=row["reshard"].pop("digests"))
        row["reshard"]["manifest_s"] = time.perf_counter() - t0
        if row["reshard"]["shards"] < CKPT_70B_SHARDS:
            fail(f"{CKPT_70B}: re-sharded into {row['reshard']['shards']} files")
        loaded_q, row["load_int8"], trace = traced_load(torch, qcfg, sharded)
        want_q = quantize_params(tree)
        same_tensors(loaded_q, want_q, f"{CKPT_70B} int8 load through the index")
        del loaded_q, want_q
    finally:
        shutil.rmtree(single, ignore_errors=True)
        shutil.rmtree(sharded, ignore_errors=True)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    row["order"] = [{"name": r["name"], "resident_gb": r["resident"] / 1e9,
                     "transient_gb": (r["peak"] - r["resident"]) / 1e9} for r in trace.rows]
    row["full_depth"] = reckon_full_depth(torch, trace, CKPT_70B_LAYERS)
    log(f"checkpoint_llama3_70b {json.dumps({'device': device_line, **row})}")
    if row["full_depth"]["headroom_gb"] <= 0:
        fail(f"{CKPT_70B} int8: the reckoned full-depth load peak "
             f"{row['full_depth']['reckoned_peak_gb']:.2f} GB does not fit the card")


def checkpoint_families(torch, tmp: pathlib.Path, device_line: str) -> None:
    """Phase 35(c): the families' name maps at full width, exported and
    loaded back bit for bit. Norm scales are drawn uniform in [0.5, 2] and
    biases N(0, 0.02) (the init makes them one and zero), so gemma's
    ``scale - 1`` and the q/k/v and Conv1D biases carry values."""
    import gc
    import shutil

    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.safetensors_io import SafetensorsFile, read_header
    from fairness_llm_tpu_torch.runtime.weights import init_params, load_checkpoint

    out = {}
    for name, layers in CKPT_FAMILIES.items():
        cfg = dataclasses.replace(get_model_config(name), num_layers=layers)
        tree = init_params(cfg, 0, torch.device("cuda"))
        g = torch.Generator(device="cuda").manual_seed(35)
        for key, t in tree.items():
            if key.endswith(".scale"):
                t.uniform_(0.5, 2.0, generator=g)
            elif key.endswith(".bias"):
                t.normal_(0.0, 0.02, generator=g)
        d = tmp / name
        try:
            row = {"layers": layers, "tree_gb": tree_bytes(tree) / 1e9,
                   "export": export_checkpoint(torch, cfg, tree, d)}
            header, _ = read_header(str(d / "model.safetensors"))
            row["tensors"] = len(header) - ("__metadata__" in header)
            if ("lm_head.weight" in header) == cfg.tie_embeddings:
                fail(f"{name}: lm_head.weight {'written' if cfg.tie_embeddings else 'missing'}")
            if name.startswith("gemma"):
                with SafetensorsFile(str(d / "model.safetensors")) as f:
                    stored = f.get_tensor("model.norm.weight").to(tree["final_norm.scale"].device)
                if not torch.equal(stored, tree["final_norm.scale"] - 1.0):
                    fail(f"{name}: model.norm.weight is not the scale less one")
            if name.startswith("qwen2") and "model.layers.0.self_attn.q_proj.bias" not in header:
                fail(f"{name}: no q/k/v biases written")
            if name.startswith("gpt2") and header["h.0.attn.c_attn.weight"]["shape"] != [
                    cfg.d_model, 3 * cfg.d_model]:
                fail(f"{name}: c_attn is not q, k and v side by side")
            t0 = time.perf_counter()
            loaded = load_checkpoint(cfg, str(d), device="cuda")
            torch.cuda.synchronize()
            row["load_s"] = time.perf_counter() - t0
            same_tensors(loaded, tree, f"{name} bf16 load")
            del loaded
        finally:
            shutil.rmtree(d, ignore_errors=True)
        out[name] = row
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    log(f"checkpoint_families {json.dumps({'device': device_line, **out})}")


def checkpoint_path(torch, F, device_line: str, prompts) -> dict:
    """Phase 35, in its own process: (a) ``checkpoint_8b``, (b)
    ``checkpoint_70b``, (c) ``checkpoint_families``, in one temporary
    directory on the local disk, checked for room first and removed after.
    Returns the launches and rows of (a)'s engines."""
    import tempfile

    from fairness_llm_tpu_torch.models.configs import get_model_config

    t0 = time.perf_counter()
    memory_line(torch, "checkpoint_memory_at_start")

    def bf16_bytes(name, layers=None):
        cfg = get_model_config(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        return cfg.approx_param_count * 2

    parts = {CKPT_MODEL: bf16_bytes(CKPT_MODEL),
             CKPT_70B: 2 * bf16_bytes(CKPT_70B, CKPT_70B_LAYERS),
             **{n: bf16_bytes(n, layers) for n, layers in CKPT_FAMILIES.items()}}
    held: set = set()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        tmp = pathlib.Path(tmp)
        disk_check(tmp, parts)
        t1 = time.perf_counter()
        out = checkpoint_8b(torch, F, tmp, prompts, device_line, held)
        log(f"checkpoint_8b_s {time.perf_counter() - t1:.1f}")
        t1 = time.perf_counter()
        checkpoint_70b(torch, tmp, device_line)
        log(f"checkpoint_70b_s {time.perf_counter() - t1:.1f}")
        t1 = time.perf_counter()
        checkpoint_families(torch, tmp, device_line)
        log(f"checkpoint_families_s {time.perf_counter() - t1:.1f}")
    log(f"checkpoint_s {time.perf_counter() - t0:.1f}")
    return out


def phase_child(torch, tmp: pathlib.Path, phase: int, timeout_s: int) -> dict:
    """Phases 34 and 35 from the main run: drop the kernels' grown
    workspaces (a later call would grow them again), empty the allocator's
    cache, log the card's memory, start ``chip_smoke.py --phase <phase>``
    and stream its lines; a non-zero exit fails the script. Returns the
    launches and rows the child wrote."""
    import gc
    import threading

    from fairness_llm_tpu_torch.ops import decode_attention as dec_mod
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    for cache in (dec_mod._workspaces, qm._partials, qm._counters):
        cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    memory_line(torch, f"phase{phase}_parent_memory")
    out = tmp / f"phase{phase}.json"
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--phase", str(phase),
                             "--out", str(out)], cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    timer = threading.Timer(timeout_s, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            print(line, end="", flush=True)
        code = proc.wait()
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if code != 0:
        fail(f"phase {phase}'s child exited {code}")
    return json.loads(out.read_text())


def main(argv) -> int:
    # ``--phase 33`` runs phase 33 alone after the build (with no earlier
    # phase's shapes held, every kernel call of it is held), and prints its
    # launches last in place of the kernels and result lines; ``--phase 34``
    # and ``--phase 35`` the same for phases 34 and 35, and with ``--out
    # FILE`` (as the main run starts them) they write their launches and
    # rows there instead.
    families_only = argv == ["--phase", "33"]
    child = argv[1] if argv[:1] == ["--phase"] and argv[1:2] in (["34"], ["35"]) and (
        len(argv) == 2 or (len(argv) == 4 and argv[2] == "--out")) else None
    if argv and not (families_only or child):
        fail(f"unknown arguments {argv}: run with none, with --phase 33, or with --phase 34 or "
             "35 [--out FILE]")
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    sys.path.insert(0, str(ROOT))
    try:
        from fairness_llm_tpu_torch.config import ModelSettings
        from fairness_llm_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port's package is not here ({e}); run from the root of a checkout")

    # Full float32 in the plain references: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device line
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr}")
    device_line = smi.stdout.strip().splitlines()[0]
    log(device_line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build(["flash_attention", "decode_attention", "decode_attention_f32",
                         "decode_verify_f32", "quant_matmul"])
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(sorted(logs)) or 'up to date'})")
    for name, out in sorted(logs.items()):
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}] {line.strip()}")

    profiles, prompts = counterfactual_prompts()
    if families_only:
        t0 = time.perf_counter()
        families = families_path(torch, F, device_line, prompts, set())
        log(f"families_path_s {time.perf_counter() - t0:.1f}")
        log(device_line)
        print(json.dumps({"families_launches": families["launches"]}), flush=True)
        return 0
    if child:
        run, key = {"34": (llama70b_path, "llama70b_launches"),
                    "35": (checkpoint_path, "checkpoint_launches")}[child]
        res = run(torch, F, device_line, prompts)
        if len(argv) == 4:
            pathlib.Path(argv[3]).write_text(json.dumps(res))
            return 0
        log(device_line)
        print(json.dumps({key: res["launches"]}), flush=True)
        return 0
    keys = [p.id for p in profiles]
    greedy = ModelSettings(temperature=0.0, max_tokens=MAX_TOKENS)
    sampled = ModelSettings(temperature=0.7, max_tokens=MAX_TOKENS)
    t0 = time.perf_counter()
    floor = {"kernel": "torch.cuda._sleep(0)", "ms": launch_floor_ms(torch)}
    log(f"launch_floor {json.dumps(floor)}")
    kernels, gate13 = bf16_path(torch, F, prompts, keys, greedy, sampled)
    log(f"bf16_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    kernels += int8_path(torch, prompts, keys, greedy, sampled)
    log(f"int8_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    sweep = phase1_path(torch, F, device_line)
    log(f"phase1_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    p23 = phase23_path(torch, F, device_line, sweep["records"], sweep["held"])
    log(f"phase23_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    served = serving_path(torch, F, device_line, sweep)
    log(f"serving_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    p24 = served.pop("paged")
    paged = paged_path(torch, F, device_line, sweep, p24)
    log(f"paged_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    contained = containment_path(torch, F, device_line, p24, paged["held"])
    log(f"containment_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    overload = overload_path(torch, F, device_line, p24, paged["held"])
    log(f"overload_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    fleet = fleet_path(torch, F, device_line, p24, paged["held"])
    log(f"fleet_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    devtel = devtel_path(torch, F, device_line, p24, paged["held"])
    log(f"devtel_path_s {time.perf_counter() - t0:.1f}")
    p24.clear()
    t0 = time.perf_counter()
    dp = trace_dp_path(torch, device_line, sweep, paged["held"])
    log(f"trace_dp_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    tp = tp_ring_train_path(torch, device_line, sweep, paged["held"])
    log(f"tp_ring_train_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    spec = spec_study_path(torch, F, device_line, sweep, paged["held"])
    log(f"spec_study_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    families = families_path(torch, F, device_line, prompts, paged["held"])
    log(f"families_path_s {time.perf_counter() - t0:.1f}")
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        llama70b = phase_child(torch, pathlib.Path(tmp), 34, LLAMA70B_CHILD_S)
    log(f"llama70b_path_s {time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = phase_child(torch, pathlib.Path(tmp), 35, CHECKPOINT_CHILD_S)
    log(f"checkpoint_path_s {time.perf_counter() - t0:.1f}")
    # K3 f32's main path is phase 32's sweeps; phase 13's calls at
    # llama3-8b's width become its gate launches and shapes
    i = next(i for i, e in enumerate(kernels) if e["name"] == "decode_attention_verify_f32")
    gate_entry = kernels[i]
    rows32 = spec["rows"]["decode_attention_verify_f32"]
    kernels[i] = {**kernel_entry("decode_attention_verify_f32", K3F32_SOURCE, K3_REPLACES,
                                 sum(c["decode_attention_verify_f32"]
                                     for c in spec["launches"].values()), rows32),
                  "max_abs_err": max(r["max_abs_err"] for r in rows32 + gate_entry["shapes"]),
                  "gate_launches": gate_entry["launches"], "gate_shapes": gate_entry["shapes"]}
    # K1's and K2's f32 kernels, whose main path is the study sweeps
    study, study_rows = sweep["launches"]["study"], sweep["rows"]["study"]
    kernels += [kernel_entry("flash_attention_f32", K1_SOURCE, K1_REPLACES,
                             study["flash_attention_f32"], study_rows["flash_attention_f32"]),
                kernel_entry("decode_attention_f32", K2F32_SOURCE, K2_REPLACES,
                             study["decode_attention_f32"], study_rows["decode_attention_f32"])]
    for entry in kernels[-2:]:  # phase 13's calls of the two, at llama3-8b's width
        entry["gate_launches"] = gate13[entry["name"]]["launches"]
        entry["gate_shapes"] = gate13[entry["name"]]["rows"]
    for entry in kernels:
        name = entry["name"]

        def by_path(launches: dict) -> dict:
            # Phase 13's entries have no count in the later phases.
            return {path: counts[name] for path, counts in launches.items() if name in counts}

        entry["phase1_launches"] = by_path(sweep["launches"])
        if name in sweep["rows"][FULL_WIDTH]:
            entry["phase1_shapes"] = sweep["rows"][FULL_WIDTH][name]
        for phase in ("phase2", "phase3"):
            entry[f"{phase}_launches"] = by_path(p23["launches"][phase])
        rows = p23["rows"].get(name, [])
        if any(r["scoring"] for r in rows):
            entry["scoring_shapes"] = [r for r in rows if r["scoring"]]
        if rows and not all(r["scoring"] for r in rows):
            entry["phase23_shapes"] = [r for r in rows if not r["scoring"]]
        for key, phase in (("serving", served), ("paged", paged), ("containment", contained),
                           ("overload", overload), ("fleet", fleet), ("devtel", devtel),
                           ("dp", dp), ("tp", tp), ("spec_sweep", spec),
                           ("families", families), ("llama70b", llama70b),
                           ("checkpoint", checkpoint)):
            entry[f"{key}_launches"] = by_path(phase["launches"])
            if name in phase["rows"]:
                entry[f"{key}_shapes"] = phase["rows"][name]

    log(f"total_s {time.perf_counter() - t_start:.1f}")
    log(device_line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
