"""Batched autoregressive decode engine (counterpart of
``fairness_llm_tpu/runtime/engine.py``: ``GenerateOutput``, the bucketing
helpers, and ``DecodeEngine.__init__``/``generate``).

One ``generate`` call: tokenize and **left-pad** the prompts to a bucketed
[B, S] shape; compute the shared prompt prefix's KV once (kept in an LRU of
4); prefill the batch in one forward; decode up to ``max_new_tokens`` steps,
stopping once every real row has sampled EOS; detokenize.

Greedy decode can take the speculative loop instead (``speculation``, a
``SpeculationConfig``): each step drafts ``draft_len`` tokens per row by
prompt lookup and verifies them in one forward
(``stepbuilder.build_spec_decode``); the tokens equal plain greedy decode.

An ``*-int8`` config serves from int8 weights: ``init_params`` makes (or the
caller hands in) int8 kernels with f32 scales, and the model multiplies by
them through the int8-weight kernel; no dequantized copy of a weight is
built, so the device holds about half the bytes of the bf16 model. A config
with ``kv_cache_quant`` keeps the KV cache in int8 with f32 scales.

Resilience (``resilience/``, ``integrity/``), as in the reference:
``numerics_guards`` reads the decode loop's finite flag (AND-ed over the
chunk's steps on the device, the prefill's logits included) once a call
and raises a containable ``NumericsFault`` when it tripped; ``breakers`` (a
``BreakerBoard``) gates the speculative path on its ``speculate`` stage,
and a speculative call that raises is retried once on the plain path (the
tokens are the same), counted in ``faults_total{stage="speculate"}``;
``watchdog`` (a ``StepWatchdog``) classifies an over-budget call as a
``HangFault``, the first call of a shape and a call that built or loaded a
kernel exempt. A fatal CUDA error is never retried
(``utils/failures.is_fatal_device_error``): it is recorded and raised.

Left out on purpose: the reference's VMEM-gate fallback, which rebuilds the
engine without its decode kernel when that kernel fails to compile. On the
card it would be a plain-version fallback: a kernel that fails to build or
launch raises here.

Data parallelism (``mesh``, a ``parallel.make_mesh`` device mesh with dp >
1, one process a rank): every rank tokenizes the whole batch, buckets it to
a dp multiple and finds the shared prefix as one process would, computes
the prefix KV itself, then prefills and decodes only its contiguous block
of rows (``parallel.batch_sharding``), each row sampled from its global
seed (``seed * 1_000_003 + i`` or ``row_seeds[i]``), so a row's tokens do
not depend on dp. EOS early exit is per rank, so ranks stop at different
steps; every rank's tokens are ``[rows, max_new_tokens]`` pad-filled past
its last step, so one ``all_gather`` over the dp group gives every rank the
whole batch's ``GenerateOutput``. The call's stats are gathered with them:
``decode_steps`` (verify steps) and the seconds are the maximum over
ranks, the speculation counters the sum, the finite flag the AND. Under
gloo the gather goes through the CPU.

Tensor parallelism (a mesh with tp > 1): each rank holds its shard of the
parameters (``parallel.sharding.rank_params`` by the rules, the cut the
tp train state takes too) and its model runs over its local heads, MLP columns
and vocabulary rows with explicit all-reduces over the tp group
(``models/transformer.py``); its KV cache holds its local kv heads. The
ranks of a tp group decode the same rows and see the same full-vocabulary
logits, so they sample the same tokens and stop at the same step. Where
the reference keeps XLA attention for a multi-device decode, each rank
here runs the decode kernel over its local heads, which is exact.

Sequence parallelism (sp > 1) serves the no-cache forward: scoring splits
each row's sequence over the sp ranks and attends through the ring
(``runtime/scoring.py``, ``parallel/ring.py``). A decode step's sequence is
one token, so the sp ranks of a dp block decode its rows alike (the
reference's GSPMD program runs it too; a config with
``attention_impl="ring"`` raises on a cache, as there).

Telemetry (``component="engine"``), as the reference's: per call
``generate_calls_total``, ``prompt_tokens_total``, ``decoded_tokens_total``,
``decode_paths_total{path}``, the ``generate_wall_s`` histogram, the
speculation counters (``SpeculationStats.publish``) and a
``generate[BxS]`` span on the timeline's ``engine`` track; the prefix LRU
publishes ``prefix_kv_entries`` and ``prefix_kv_evictions_total``. The
device-facing telemetry: the parameters are the memory ledger's ``params``
pool and each prefix-LRU entry a ``prefix_cache`` entry
(``telemetry/memory.py``); every program key (``prefix``, ``decode``,
``spec_decode``) is looked up and its first use recorded as a compile
(``telemetry/compilestats.py``), its first armed call walked into a cost
ledger (``telemetry/costmodel.py``); each call feeds the roofline gauges
(``observe_decode``) and the gap attribution (``note_invocation``). Host
clock only: nothing here reads the device beyond the syncs the call makes.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from fairness_llm_tpu_torch.config import MeshConfig, ModelSettings, SpeculationConfig
from fairness_llm_tpu_torch.device import resolve_device
from fairness_llm_tpu_torch.integrity.numerics import check_finite
from fairness_llm_tpu_torch.models.configs import ModelConfig
from fairness_llm_tpu_torch.models.tokenizer import _left_pad, tokenizer_for
from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.parallel.sharding import (
    axis_size,
    batch_sharding,
    gather_rows,
    make_mesh,
    mesh_shape,
    model_parallel,
    param_shardings,
    per_device_param_bytes,
    rank_params,
    shard_params,
)
from fairness_llm_tpu_torch.resilience.watchdog import first_use
from fairness_llm_tpu_torch.runtime.sampling import SamplerSettings, speculation_applicable
from fairness_llm_tpu_torch.runtime.stepbuilder import (
    build_engine_decode,
    build_prefix,
    build_spec_decode,
)
from fairness_llm_tpu_torch.runtime.weights import build_model, init_params
from fairness_llm_tpu_torch.telemetry import get_registry
from fairness_llm_tpu_torch.telemetry.compilestats import note_lookup, record_compile
from fairness_llm_tpu_torch.telemetry.costmodel import InstrumentedProgram, note_invocation
from fairness_llm_tpu_torch.telemetry.memory import get_memory_ledger
from fairness_llm_tpu_torch.telemetry.roofline import observe_decode
from fairness_llm_tpu_torch.telemetry.timeline import get_timeline
from fairness_llm_tpu_torch.utils.failures import (
    NumericsFault,
    is_fatal_device_error,
    note_fatal_device_error,
)
from fairness_llm_tpu_torch.utils.profiling import SpeculationStats

logger = logging.getLogger(__name__)

_PREFIX_LRU = 4


@dataclasses.dataclass
class GenerateOutput:
    texts: List[str]
    tokens: np.ndarray  # [B, max_new] int32 (pad-filled after EOS)
    steps: int  # decode-step cap (max_new_tokens)
    stats: Optional[Dict[str, Any]] = None  # decode shapes and timings


def _bucket_len(n: int, multiple: int = 64) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def _token_lcp(rows) -> int:
    """Longest common token prefix across rows, capped so that every row
    keeps at least one non-prefix token."""
    if not rows:
        return 0
    limit = min(len(r) for r in rows) - 1
    if limit <= 0:
        return 0
    first = np.asarray(rows[0][:limit], dtype=np.int64)
    agree = np.ones(limit, dtype=bool)
    for r in rows[1:]:
        agree &= first == np.asarray(r[:limit], dtype=np.int64)
        if not agree[0]:
            return 0
    mismatch = np.flatnonzero(~agree)
    return int(mismatch[0]) if mismatch.size else limit


def _bucket_batch(n: int, mesh=None) -> int:
    # Multiples of 8, not powers of two: decode streams the whole cache every
    # step, so padding 45 -> 64 rows would cost 42% more traffic; 45 -> 48, 7%.
    # With a mesh, also a multiple of dp.
    b = 8 if n <= 8 else ((n + 7) // 8) * 8
    dp = axis_size(mesh, "dp")
    return ((b + dp - 1) // dp) * dp


class DecodeEngine:
    """Owns the model and its parameters on one device (this rank's, under a
    mesh)."""

    # Memory-ledger handles: one per engine in the process.
    _mem_seq = 0

    def __init__(
        self,
        model_config: ModelConfig,
        params: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer=None,
        seed: int = 0,
        param_dtype: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        speculation: Optional[SpeculationConfig] = None,
        tokenizer_path: Optional[str] = None,
        numerics_guards: bool = False,
        mesh=None,
        mesh_config: Optional[MeshConfig] = None,
    ):
        """``params`` is a state dict (``runtime/weights.params_from_jax`` or
        ``init_params``, or another engine's ``model.state_dict()``: tensors
        already on the device in the storage dtype are used, not copied);
        None draws random parameters from ``seed``. ``param_dtype``
        ("float32"/"bfloat16") overrides the size-based storage policy: bf16
        models of a billion parameters or more store bf16, everything else
        f32. ``device=None`` means CUDA and raises without a card.
        ``speculation`` is the default for ``generate``. ``tokenizer`` or
        else ``tokenizer_path`` (a checkpoint directory holding
        ``tokenizer.json``) picks the tokenizer; with neither, the byte
        tokenizer. ``numerics_guards`` raises a ``NumericsFault`` from a call
        whose live rows' logits were not all finite. ``mesh`` (or
        ``mesh_config``, from which one is made over the world) splits every
        call's rows over its dp ranks, and its tp ranks split the model
        (each holds its shard of the parameters)."""
        self.device = resolve_device(device)
        if mesh is None and mesh_config is not None and mesh_config.num_devices > 1:
            mesh = make_mesh(mesh_config)
        self.mesh = mesh
        self.config = model_config
        self.speculation = speculation
        self.numerics_guards = bool(numerics_guards)
        # Resilience hooks, off by default (backend_for and ServingBackend
        # install them with ResilienceConfig.enabled): a BreakerBoard whose
        # "speculate" stage gates the speculative path, and a StepWatchdog.
        self.breakers = None
        self.watchdog = None
        # Degradation rung 1's shed state lives on the engine, which several
        # schedulers may share.
        self._spec_shed = False
        self._spec_saved_speculation = None
        self.tokenizer = tokenizer or tokenizer_for(model_config, tokenizer_path)
        big = model_config.approx_param_count >= 1_000_000_000
        if param_dtype is not None:
            if param_dtype not in ("float32", "bfloat16"):
                raise ValueError(
                    f"param_dtype must be 'float32' or 'bfloat16', got {param_dtype!r}")
            dtype = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
        else:
            dtype = (torch.bfloat16 if (model_config.dtype == "bfloat16" and big)
                     else torch.float32)
        if params is None:
            params = init_params(model_config, seed, self.device, dtype)
        par = model_parallel(model_config, mesh)
        if mesh is not None:
            # dp and sp replicate the parameters; tp cuts each to the rank's part
            if par is not None and par.layout is not None:
                params = rank_params(model_config, params, par.layout, self.device)
            else:
                params = shard_params(params, param_shardings(model_config, mesh), self.device,
                                      mesh=mesh)
            logger.info("%s on mesh %s: ~%.2f GB params per device", model_config.name,
                        mesh_shape(mesh), per_device_param_bytes(
                            model_config, mesh, itemsize=torch.finfo(dtype).bits // 8) / 1e9)
        self.model = build_model(model_config, params, self.device, dtype, par=par)
        self._prefix_kv: "collections.OrderedDict[tuple, list]" = collections.OrderedDict()
        # Program keys seen (the reference's compiled-program cache): each
        # holds its cost ledger and memory capture.
        self._programs: Dict[tuple, InstrumentedProgram] = {}
        self._mem_handle = f"engine{DecodeEngine._mem_seq}"
        DecodeEngine._mem_seq += 1
        get_memory_ledger().register("params", self._mem_handle, self.model.state_dict())

    @property
    def seq_bucket(self) -> int:
        """Prompt-length bucket: 128 on the card (the flash kernel's query
        tile is 64 rows), 64 on the CPU, as the reference's off-TPU bucket."""
        return 128 if self.device.type == "cuda" else 64

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _program(self, key: tuple) -> InstrumentedProgram:
        """The program of ``key`` (its first element the reference's program
        label), counting the lookup as a hit or a miss."""
        prog = self._programs.get(key)
        note_lookup(key[0], hit=prog is not None)
        if prog is None:
            prog = self._programs[key] = InstrumentedProgram(key[0], device=self.device)
        return prog

    def _prefix_kv_handle(self, key: tuple) -> str:
        """Ledger handle of one prefix-LRU entry."""
        return f"{self._mem_handle}:prefix:{abs(hash(key)):x}"

    def _shared_layers(self, shared_ids: List[int]):
        """Prefix KV for ``shared_ids``, from the LRU or computed now.
        Returns (layers, seconds spent computing them)."""
        key = tuple(shared_ids)
        layers = self._prefix_kv.get(key)
        if layers is not None:
            self._prefix_kv.move_to_end(key)
            return layers, 0.0
        t0 = time.perf_counter()
        run = build_prefix(self.config, self.model, prefix_len=len(shared_ids))
        layers = self._program(("prefix", len(shared_ids))).run(
            run, torch.tensor([shared_ids], dtype=torch.long, device=self.device))
        self._sync()
        seconds = time.perf_counter() - t0
        reg = get_registry()
        mem = get_memory_ledger()
        while len(self._prefix_kv) >= _PREFIX_LRU:
            victim, _ = self._prefix_kv.popitem(last=False)
            mem.release("prefix_cache", self._prefix_kv_handle(victim))
            reg.counter("prefix_kv_evictions_total", component="engine").inc()
        self._prefix_kv[key] = layers
        mem.register("prefix_cache", self._prefix_kv_handle(key), layers)
        reg.gauge("prefix_kv_entries", component="engine").set(len(self._prefix_kv))
        return layers, seconds

    def shed_speculation(self) -> None:
        """Degradation rung 1: turn the default speculation off, keeping the
        original. Idempotent: the first caller wins, so a restore never
        captures an already-shed None."""
        if not self._spec_shed:
            self._spec_saved_speculation = self.speculation
            self.speculation = None
            self._spec_shed = True

    def restore_speculation(self) -> None:
        """Undo ``shed_speculation`` (the ladder retreated)."""
        if self._spec_shed:
            self.speculation = self._spec_saved_speculation
            self._spec_saved_speculation = None
            self._spec_shed = False

    def _gather_ranks(self, toks: np.ndarray, steps_run: int, finite: bool,
                      spec_stats: Optional[SpeculationStats], seconds: tuple):
        """All-gather this rank's rows and stats over the dp group: (the whole
        batch's tokens, the most steps, the AND of the finite flags, the
        summed speculation counters with the most verify steps, and the
        most of each of ``seconds``)."""
        spec = spec_stats or SpeculationStats()
        toks = gather_rows(self.mesh, torch.from_numpy(np.ascontiguousarray(toks, np.int32)),
                           self.device).cpu().numpy()
        row = torch.tensor([[steps_run, float(finite), spec.drafted, spec.accepted,
                             spec.verify_steps, spec.emitted, *seconds]], dtype=torch.float64)
        st = gather_rows(self.mesh, row, self.device).cpu().numpy()
        if spec_stats is not None:
            spec_stats = dataclasses.replace(
                spec_stats, drafted=int(st[:, 2].sum()), accepted=int(st[:, 3].sum()),
                verify_steps=int(st[:, 4].max()), emitted=int(st[:, 5].sum()))
        return (toks, int(st[:, 0].max()), bool(st[:, 1].min() > 0), spec_stats,
                *(float(x) for x in st[:, 6:].max(axis=0)))

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        max_new_tokens: Optional[int] = None,
        seed: int = 0,
        row_seeds: Optional[Sequence[int]] = None,
        share_prefix: Optional[bool] = None,
        prefix_ids: Optional[Sequence[int]] = None,
        speculation: Optional[SpeculationConfig] = None,
    ) -> GenerateOutput:
        """Decode a batch of prompts; returns detokenized continuations.

        ``row_seeds`` (one per prompt) make each row's sampling independent of
        batch composition. Default: seed + position. ``prefix_ids`` must be a
        strict prefix of every prompt's tokens; without it, ``share_prefix``
        None/True detects the common prefix of this batch (at least 64 tokens
        for None, 1 for True) and False turns sharing off.

        ``speculation`` overrides the engine's default. It engages only when
        enabled with ``draft_len > 0``, for greedy settings and
        ``max_new > 1``, and while the ``speculate`` breaker allows it;
        otherwise the plain path runs. The tokens are the same either way.
        """
        settings = settings or ModelSettings()
        max_new = settings.max_tokens if max_new_tokens is None else max_new_tokens
        sampler = SamplerSettings(temperature=settings.temperature,
                                  top_k=settings.top_k, top_p=settings.top_p)
        spec = speculation if speculation is not None else self.speculation
        use_spec = bool(spec is not None and spec.enabled and spec.draft_len > 0
                        and speculation_applicable(sampler) and max_new > 1
                        and (self.breakers is None or self.breakers.allow("speculate")))
        if max_new >= self.config.max_seq_len:
            raise ValueError(
                f"max_new_tokens {max_new} >= model max_seq_len {self.config.max_seq_len}")
        prompt_budget = self.config.max_seq_len - max_new
        t_start = time.perf_counter()
        n = len(prompts)
        if n == 0:
            return GenerateOutput(
                texts=[], tokens=np.zeros((0, max_new), np.int32), steps=max_new,
                stats={"batch": 0, "prompt_len": 0, "prefix_len": 0, "cache_slots": 0},
            )

        rows = [self.tokenizer.encode(p) for p in prompts]
        shared_ids: Optional[list] = None
        if share_prefix is not False and prefix_ids is not None:
            pl = list(prefix_ids)
            if not all(len(r) > len(pl) and r[:len(pl)] == pl for r in rows):
                raise ValueError(
                    "prefix_ids must be a strict prefix of every prompt "
                    "(recompute it over the full sweep, e.g. via "
                    "pipeline.backends.shared_prefix_ids)")
            shared_ids = pl
        elif share_prefix is not False and n >= 2 and prefix_ids is None:
            common = _token_lcp(rows)
            min_shared = 64 if share_prefix is None else 1
            if common >= min_shared:
                shared_ids = rows[0][:common]

        if shared_ids is not None:
            # Constant budget cap (at least 64 remainder slots), identical for
            # every chunk of a sweep.
            shared_ids = shared_ids[:max(0, prompt_budget - 64)]
            if share_prefix is not True:
                shared_ids = shared_ids[:(len(shared_ids) // 64) * 64]
            if not shared_ids:
                shared_ids = None

        if shared_ids is not None:
            remainders = [r[len(shared_ids):] for r in rows]
            rem_budget = prompt_budget - len(shared_ids)
            tb = _left_pad(remainders, self.tokenizer.pad_id)
            prompt_len = _bucket_len(min(tb.tokens.shape[1], rem_budget), 32)
            if prompt_len > rem_budget:
                prompt_len = max(rem_budget, 1)
            if tb.tokens.shape[1] > prompt_len:
                tb = _left_pad(remainders, self.tokenizer.pad_id, max_len=prompt_len)
        else:
            tb = _left_pad(rows, self.tokenizer.pad_id)
            prompt_len = _bucket_len(min(tb.tokens.shape[1], prompt_budget), self.seq_bucket)
            if prompt_len > prompt_budget:
                prompt_len = prompt_budget
            if tb.tokens.shape[1] > prompt_len:
                tb = _left_pad(rows, self.tokenizer.pad_id, max_len=prompt_len)
        batch = _bucket_batch(n, self.mesh)
        tokens = np.full((batch, prompt_len), self.tokenizer.pad_id, dtype=np.int64)
        valid = np.zeros((batch, prompt_len), dtype=bool)
        s = tb.tokens.shape[1]
        tokens[:n, prompt_len - s:] = tb.tokens
        valid[:n, prompt_len - s:] = tb.valid
        # Pad rows get one valid token so attention has something to
        # normalise over.
        valid[n:, -1] = True

        if row_seeds is None:
            seeds = [(seed * 1_000_003 + i) & 0xFFFFFFFF for i in range(batch)]
        else:
            if len(row_seeds) != n:
                raise ValueError(f"row_seeds has {len(row_seeds)} entries for {n} prompts")
            seeds = [int(s) & 0xFFFFFFFF for s in row_seeds] + [0] * (batch - n)
        prefix_len = len(shared_ids) if shared_ids is not None else 0
        # This rank's rows (all of them without a mesh) and its real rows.
        mine = batch_sharding(self.mesh, batch)
        rows_here = mine.stop - mine.start
        n_here = max(0, min(n, mine.stop) - mine.start)
        t0_mono = time.monotonic()
        programs_before = set(self._programs)

        shared_layers, prefix_s = None, 0.0
        if prefix_len:
            shared_layers, prefix_s = self._shared_layers(shared_ids)

        live = np.zeros(rows_here, dtype=bool)
        live[:n_here] = True
        seeds = seeds[mine]
        tokens_dev = torch.from_numpy(tokens[mine]).to(self.device)
        valid_dev = torch.from_numpy(valid[mine]).to(self.device)

        def program_key(use_spec: bool) -> tuple:
            """The reference's compile key of the call's program."""
            if use_spec:
                return ("spec_decode", rows_here, prompt_len, max_new, prefix_len,
                        self.numerics_guards, spec.ngram_max, spec.draft_len)
            return ("decode", rows_here, prompt_len, max_new, sampler, prefix_len,
                    self.numerics_guards)

        def run_program(use_spec: bool):
            return self._program(program_key(use_spec)).run(
                run, use_spec, memory_args=(tokens_dev, valid_dev, shared_layers))

        def run(use_spec: bool):
            """Prefill and decode the batch, on the speculative or the plain
            path: (toks, steps run, finite flag, SpeculationStats or None,
            and the host clock before, between and after the two)."""
            if use_spec:
                entry, spec_loop = build_spec_decode(
                    self.config, self.model, self.tokenizer.pad_id, self.tokenizer.eos_id,
                    batch=rows_here, prompt_len=prompt_len, max_new=max_new,
                    prefix_len=prefix_len, ngram_max=spec.ngram_max, draft_len=spec.draft_len)
            else:
                entry, loop = build_engine_decode(
                    self.config, self.model, sampler, self.tokenizer.pad_id,
                    self.tokenizer.eos_id, batch=rows_here, prompt_len=prompt_len,
                    max_new=max_new, prefix_len=prefix_len)
            t0 = time.perf_counter()
            last_logits, cache = entry(tokens_dev, valid_dev, shared_layers)
            self._sync()
            t1 = time.perf_counter()
            spec_stats = None
            if use_spec:
                prefix_toks = torch.tensor(shared_ids or [], dtype=torch.long,
                                           device=self.device)
                toks, out_len, counters, finite = spec_loop(
                    cache, last_logits, tokens_dev, valid_dev, live, shared_layers, prefix_toks)
                steps_run = counters[2]
                spec_stats = SpeculationStats(
                    drafted=counters[0], accepted=counters[1], verify_steps=counters[2],
                    emitted=int(out_len[:n_here].sum()), draft_len=spec.draft_len,
                    ngram_max=spec.ngram_max)
            else:
                res = loop(cache, last_logits, seeds, live, shared_layers)
                toks, steps_run, finite = res.toks, res.steps, res.finite
            self._sync()
            return toks, steps_run, finite, spec_stats, t0, t1, time.perf_counter()

        # The watchdog's (stage, shape) key and the kernel-load count: a
        # call that is the first of its key, or built a kernel, is exempt.
        key = ("engine", rows_here, prompt_len, max_new, prefix_len, use_spec)
        loads = _build.load_events
        if self.watchdog is not None:
            self.watchdog.arm("decode")
        retried = False
        try:
            toks, steps_run, finite, spec_stats, t0, t1, t2 = run_program(use_spec)
        except Exception as e:  # noqa: BLE001 — the speculative retry below
            if is_fatal_device_error(e):
                note_fatal_device_error(e, "engine", "speculate" if use_spec else "decode")
                raise
            if not (use_spec and self.breakers is not None):
                raise
            # A failed speculative call with a breaker armed: count it
            # (enough in a row open "speculate") and retry this call on the
            # plain path, whose tokens are the same.
            self.breakers.record_failure("speculate")
            get_registry().counter("faults_total", component="engine", kind="device",
                                   stage="speculate").inc()
            logger.warning("speculative decode failed (%s: %s); retrying on the plain path",
                           type(e).__name__, e)
            retried, use_spec = True, False
            toks, steps_run, finite, spec_stats, t0, t1, t2 = run_program(False)
        prefill_s, decode_s = t1 - t0, t2 - t1
        if axis_size(self.mesh, "dp") > 1:
            toks, steps_run, finite, spec_stats, prefix_s, prefill_s, decode_s = \
                self._gather_ranks(toks, steps_run, finite, spec_stats,
                                   (prefix_s, prefill_s, decode_s))
        if self.numerics_guards:
            try:
                check_finite(finite, "engine", "speculate" if use_spec else "decode")
            except NumericsFault:
                if use_spec and self.breakers is not None:
                    # A numerically sick speculative path feeds its breaker
                    # as a crashed one does.
                    self.breakers.record_failure("speculate")
                raise
        # Success only once the call is known good: recorded before the
        # finite check, a persistently poisoned verify window would reset
        # the count every call and the breaker would never open.
        if use_spec and self.breakers is not None:
            self.breakers.record_success("speculate")
        if self.watchdog is not None:
            fresh = first_use(key, loads)
            self.watchdog.observe("decode", classify=not (retried or fresh))
        out = toks[:n]

        texts = []
        for row in out:
            ids = []
            for t in row:
                if t == self.tokenizer.eos_id:
                    break
                ids.append(int(t))
            texts.append(self.tokenizer.decode(ids))
        decoded = int(np.sum(out != self.tokenizer.pad_id))
        path = "speculative" if use_spec else "plain"
        reg = get_registry()
        reg.counter("generate_calls_total", component="engine").inc()
        reg.counter("prompt_tokens_total", component="engine").inc(int(sum(len(r) for r in rows)))
        reg.counter("decoded_tokens_total", component="engine").inc(decoded)
        reg.counter("decode_paths_total", component="engine", path=path).inc()
        # The wall includes any kernel build or load of a shape's first call;
        # the histogram's spread shows it.
        reg.histogram("generate_wall_s", component="engine").observe(time.perf_counter() - t_start)
        if spec_stats is not None:
            spec_stats.publish(reg)
        wall_mono = time.monotonic() - t0_mono
        get_timeline().record_span(f"generate[{batch}x{prompt_len}]",
                                   "speculate" if use_spec else "decode", "engine", t0_mono,
                                   wall_mono, path=path, prefix_len=prefix_len)
        # Every program key the call used first counts as a compile, with
        # the call's wall (the reference's convention); then the roofline
        # and the gap attribution. The wall includes the prefill, so the
        # fraction is a lower bound on the decode's.
        fresh = set(self._programs) - programs_before
        for k in fresh:
            record_compile(k[0], reason="shape", seconds=wall_mono, track="engine", key=k,
                           t0=t0_mono)
        prog_name = "spec_decode" if use_spec else "decode"
        stats: Dict[str, Any] = {
            "batch": batch,
            "prompt_len": prompt_len,
            "prefix_len": prefix_len,
            # the speculative loop carries draft_len spare slots for its last window
            "cache_slots": prompt_len + max_new + (spec.draft_len if use_spec else 0),
            "decode_kernel": bool(self.config.use_decode_attention_kernel),
            # Host-clock seconds around device work that ends in a sync.
            "prefix_s": prefix_s,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            # verify steps on the speculative path
            "decode_steps": steps_run,
            "decoded_tokens": decoded,
            "logits_finite": finite,
        }
        if spec_stats is not None:
            stats["speculation"] = spec_stats.as_dict()
        # The roofline counts this rank's rows: its device streams them.
        observe_decode(self.config, dict(stats, batch=rows_here), steps_run, wall_mono,
                       program=prog_name)
        note_invocation(prog_name, wall_mono, steps_run,
                        ledger=self._programs[program_key(use_spec)].ledger,
                        compiling=bool(fresh))
        return GenerateOutput(texts=texts, tokens=out, steps=max_new, stats=stats)
