"""Analytical per-op cost ledger: bytes and FLOPs per component of every
decode program, and the per-program gap attribution (counterpart of
``fairness_llm_tpu/telemetry/costmodel.py``).

- **The component taxonomy** (``COMPONENTS``, ``classify``): the
  reference's first-match-wins table over op names, unchanged, with its
  labels ``attention`` / ``kv_rw`` / ``weights_dma`` / ``matmuls`` /
  ``norms_elementwise`` / ``sampling`` / ``gather_scatter`` / ``control`` /
  ``collectives``.
- **The aten walk**: the reference walks a program's jaxpr; the port runs
  eagerly, so ``InstrumentedProgram`` runs a ``TorchDispatchMode`` around
  the program's **first armed real invocation** and charges every aten op
  with its input and output tensor bytes (the nothing-fuses bound of the
  reference's ``_eqn_bytes``) and its FLOPs (``2·out·contracted`` for the
  products, one per output element otherwise), classified by
  ``classify_op``, the structural rule of the reference's
  ``classify_eqn``. View ops move nothing and are not charged. The decode
  loops of ``runtime/stepbuilder.py`` mark their body (``decode_loop``):
  the **first iteration** is charged to the ``step`` scope, as the
  reference charges a while body once; every other op of the call (the
  prefill, the prefix, the paged view's gather and scatter) is charged to
  ``call``, and the later iterations run outside the mode. No step runs a
  second time to be counted: the serve step writes the cache and advances
  the rows' sampling streams, so the walk rides the real call.
- **The hand-written kernels report themselves.** They launch through
  ``ctypes`` on raw pointers, which dispatch never sees, so each public op
  (``ops/flash_attention.flash_attention``, ``ops/decode_attention.
  decode_attention``, ``ops/quant_matmul.quant_matmul`` and
  ``quant_matmul_group``) charges its own analytic bytes and FLOPs (the
  counts behind PERF.md's bound column) through ``kernel_cost`` and hides
  its interior from the walk, whichever implementation ran: the kernel on
  the card, its plain version on the CPU. A step's ledger is therefore the
  same on both, which the CPU tests pin.
- **A forced component**: the KV-cache writes (``transformer._cache_write``)
  mark their ops ``kv_rw`` (``component``): the reference tells a cache
  update by its primitive, where aten shows an index write like any
  other. The paged view's gather and scatter, and the embedding lookup,
  are index ops and classify as ``gather_scatter``, as the reference's
  gathers do.
- **Gap attribution**: per invocation ``note_invocation`` accumulates the
  measured wall, steps and calls and the ledger's per-component floor
  (``max(bytes/achievable_bw, flops/achievable_flops)``), the timeline
  accumulates the measured host gap between decode chunks, and
  ``gap_decomposition`` splits ``wall + host gap`` into floor, dispatch,
  compile, unattributed in-step time and host gap, exactly by
  construction. ``render_cost_report`` (``perf-report``) prints it.

A failed walk logs once and never fails the decode; no counting code
swallows an exception of the real call. Gated, like the whole attribution
layer, on ``timeline.attribution_on()``.

The reference rates: ``reference_achievable_gflops`` is the override
(``set_achievable_gflops``), else the card's dense bf16 peak from
``roofline.CARDS``, else (no CUDA card) the reference's CPU nominal; a CUDA
card missing from the table gets no compute wall (0: the floor is bytes
only). ``reference_dispatch_s`` is the override (``set_dispatch_s``, which
``chip_smoke.py`` sets to the host cost of one launch it measures on the
card), else the reference's CPU nominal with no CUDA card, else 0: the port
states no per-dispatch figure it did not measure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import re
from typing import Callable, Dict, List, Optional, Tuple

from fairness_llm_tpu_torch.telemetry.registry import get_registry
from fairness_llm_tpu_torch.telemetry.timeline import attribution_on

logger = logging.getLogger(__name__)

# -- the shared component taxonomy ---------------------------------------------
# The reference's table, pattern and order unchanged (first match wins).
COMPONENTS: List[Tuple[str, "re.Pattern"]] = [
    ("collectives", re.compile(
        r"all-reduce|all-gather|reduce-scatter|collective-permute"
        r"|all-to-all|psum")),
    ("attention", re.compile(
        r"multiply_reduce|reduce_fusion|softmax|exponential|divide_fusion")),
    ("kv_rw", re.compile(r"dynamic-update-slice|update_slice")),
    ("weights_dma", re.compile(
        r"^(slice|bitcast|copy)|slice-start|copy-start|copy-done|slice_fusion")),
    ("matmuls", re.compile(r"dot|matmul|convolution|einsum")),
    ("norms_elementwise", re.compile(
        r"rsqrt|norm|add_fusion|multiply_fusion|subtract|tanh|gelu|silu|logistic")),
    ("sampling", re.compile(r"sort|argmax|rng|random|iota|cumsum|select_n|compare")),
    ("gather_scatter", re.compile(r"gather|scatter")),
    ("control", re.compile(r"while|condition|tuple|parameter|constant")),
]

COMPONENT_TITLES = {
    "collectives": "collectives (TP comm)",
    "attention": "attention (scores/softmax)",
    "kv_rw": "KV read-write (DUS)",
    "weights_dma": "weight DMA / slices",
    "matmuls": "matmuls (params)",
    "norms_elementwise": "norms/elementwise",
    "sampling": "sampling/argmax/rng",
    "gather_scatter": "paged gather-scatter",
    "control": "loop/control",
}


def classify(name: str) -> str:
    """Classify one op name into the shared taxonomy (first match wins);
    'other' when nothing matches."""
    low = name.lower()
    for label, pat in COMPONENTS:
        if pat.search(low):
            return label
    return "other"


# -- aten-level classification ---------------------------------------------------

_SAMPLING_OPS = frozenset({
    "sort", "argmax", "argmin", "topk", "multinomial", "rand", "randn", "randint",
    "randperm", "uniform_", "exponential_", "bernoulli_", "random_", "normal_",
    "arange", "cumsum", "logcumsumexp",
})
# The products: the model's parameter projections are 2-D ``mm``/``addmm``
# (a batch folds into rows), its attention products are batched over heads.
_PRODUCTS = frozenset({"mm", "addmm", "matmul", "linear", "mv", "addmv", "dot", "_int_mm",
                       "bmm", "baddbmm", "convolution"})
_BATCHED_PRODUCTS = frozenset({"bmm", "baddbmm"})
_GATHER_SCATTER_OPS = frozenset({
    "embedding", "index_select", "gather", "scatter", "scatter_", "scatter_add",
    "scatter_add_", "index", "index_put", "index_put_", "index_copy", "index_copy_",
    "index_add", "index_add_",
})
_ELEMENTWISE_OPS = frozenset({
    "exp", "exp2", "log", "log1p", "tanh", "sigmoid", "rsqrt", "sqrt", "erf", "add", "add_",
    "sub", "sub_", "mul", "mul_", "div", "div_", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "neg", "abs", "pow", "expm1", "square", "silu", "gelu", "sum", "mean",
    "amax", "amin", "max", "min", "prod", "var", "std", "_softmax", "softmax",
    "_log_softmax", "log_softmax", "reciprocal",
})
# Allocations write nothing the program reads back as data.
_UNCHARGED = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                        "new_empty_strided", "lift_fresh", "_local_scalar_dense"})


def _tensor_leaves(tree) -> list:
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_bytes(inputs, outputs) -> int:
    return sum(t.numel() * t.element_size() for t in inputs + outputs)


def _op_flops(name: str, args, outputs) -> int:
    if name in _PRODUCTS:
        mats = [a for a in args if hasattr(a, "dim") and a.dim() >= 1]
        # addmm/baddbmm/addmv: the accumulator comes first.
        lhs = mats[1] if name in ("addmm", "baddbmm", "addmv") and len(mats) > 1 else mats[0]
        out = outputs[0].numel() if outputs else 0
        return 2 * out * int(lhs.shape[-1])
    return sum(t.numel() for t in outputs)


def classify_op(name: str, inputs, outputs) -> str:
    """Classify one aten op into the taxonomy: the structural rule of the
    reference's ``classify_eqn``. Sampling ops by name; a batched product
    (the heads are its batch) or any op touching a rank-4 tensor is
    attention; a 2-D product is a parameter matmul; the index ops are
    gather/scatter; elementwise math and reductions are norms/elementwise;
    the rest is control. Cache writes are marked by their caller
    (``component``)."""
    if name in _SAMPLING_OPS:
        return "sampling"
    rank = max((t.dim() for t in inputs + outputs), default=0)
    if name in _PRODUCTS:
        return "attention" if (name in _BATCHED_PRODUCTS or rank >= 4) else "matmuls"
    if name in _GATHER_SCATTER_OPS:
        return "gather_scatter"
    if rank >= 4:
        return "attention"
    if name in _ELEMENTWISE_OPS:
        return "norms_elementwise"
    return "control"


# -- the ledger --------------------------------------------------------------------


@dataclasses.dataclass
class ComponentCost:
    bytes: int = 0
    flops: int = 0

    def add(self, b: int, f: int) -> None:
        self.bytes += b
        self.flops += f

    def min_time_s(self, bytes_per_s: float, flops_per_s: float) -> float:
        """The component's analytic floor: whichever of the memory and
        compute walls binds."""
        bt = self.bytes / bytes_per_s if bytes_per_s > 0 else 0.0
        ft = self.flops / flops_per_s if flops_per_s > 0 else 0.0
        return max(bt, ft)


@dataclasses.dataclass
class CostLedger:
    """Per-component analytic cost of one program: ``per_call`` counts the
    ops outside the decode loop once an invocation, ``per_step`` one loop
    iteration, the decode step."""

    program: str
    per_call: Dict[str, ComponentCost] = dataclasses.field(default_factory=dict)
    per_step: Dict[str, ComponentCost] = dataclasses.field(default_factory=dict)

    def _table(self, scope: str) -> Dict[str, ComponentCost]:
        return self.per_step if scope == "step" else self.per_call

    def record(self, scope: str, component: str, b: int, f: int) -> None:
        self._table(scope).setdefault(component, ComponentCost()).add(b, f)

    @property
    def has_loop(self) -> bool:
        return bool(self.per_step)

    def components(self) -> List[str]:
        return sorted(set(self.per_call) | set(self.per_step))

    def min_times_s(self, steps: float, bytes_per_s: float,
                    flops_per_s: float) -> Dict[str, float]:
        """Per-component floor of one invocation that ran ``steps`` loop
        iterations: the per-call cost once plus the per-step cost x steps."""
        out: Dict[str, float] = {}
        for comp in self.components():
            t = 0.0
            c = self.per_call.get(comp)
            if c is not None:
                t += c.min_time_s(bytes_per_s, flops_per_s)
            s = self.per_step.get(comp)
            if s is not None:
                t += steps * s.min_time_s(bytes_per_s, flops_per_s)
            out[comp] = t
        return out


# -- the walk ----------------------------------------------------------------------

_NULL = contextlib.nullcontext()
_active: Optional["_Walk"] = None


def walk_active() -> bool:
    """Whether a cost walk is recording: the ops' one check before they
    compute their own counts."""
    return _active is not None and _active.entered


class _Walk:
    """The state of one program's walk: the ledger, the current scope, the
    opaque depth (inside a self-reporting op), the forced component, and the
    dispatch mode that feeds it."""

    def __init__(self, program: str, charge: bool, probe=None):
        self.ledger = CostLedger(program=program)
        self.charge = charge
        self.probe = probe
        self.scope = "call"
        self.opaque = 0
        self.forced: Optional[str] = None
        self.failed: Optional[BaseException] = None
        self.mode = _make_mode(self)
        self.entered = False

    def record(self, component: str, b: int, f: int) -> None:
        if self.charge and self.failed is None:
            self.ledger.record(self.scope, component, int(b), int(f))

    def on_op(self, func, args, kwargs, out) -> None:
        if self.probe is not None:
            self.probe.sample()
        if not self.charge or self.opaque or self.failed is not None or func.is_view:
            return
        name = func.overloadpacket.__name__
        if name in _UNCHARGED:
            return
        inputs = _tensor_leaves((args, kwargs))
        outputs = _tensor_leaves(out)
        comp = self.forced or classify_op(name, inputs, outputs)
        self.ledger.record(self.scope, comp, _op_bytes(inputs, outputs),
                           _op_flops(name, args, outputs))

    def enter(self) -> None:
        self.mode.__enter__()
        self.entered = True

    def exit(self) -> None:
        if self.entered:
            self.entered = False
            self.mode.__exit__(None, None, None)


_mode_class = None


def _make_mode(walk: _Walk):
    """A dispatch mode feeding ``walk``. It opts out of torch's default of
    wrapping ``__torch_dispatch__`` against compilation, whose first use
    imports ``torch._dynamo`` (seconds, in every process)."""
    global _mode_class
    if _mode_class is None:
        from torch.utils._python_dispatch import TorchDispatchMode

        class _CostMode(TorchDispatchMode):
            @classmethod
            def _should_skip_dynamo(cls) -> bool:
                return False

            def __init__(self, target: _Walk):
                super().__init__()
                self.target = target

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                try:
                    self.target.on_op(func, args, kwargs, out)
                except Exception as e:  # noqa: BLE001 — counting never fails the call
                    self.target.failed = e
                return out

        _mode_class = _CostMode
    return _mode_class(walk)


class _KernelScope:
    """An op that reports itself: its analytic cost charged once, and its
    interior hidden from the walk."""

    def __init__(self, walk: _Walk, component: str, cost: Tuple[int, int]):
        self.walk, self.component, self.cost = walk, component, cost

    def __enter__(self):
        if self.walk.opaque == 0:
            self.walk.record(self.component, *self.cost)
        self.walk.opaque += 1
        return self

    def __exit__(self, *exc):
        self.walk.opaque -= 1
        return False


def kernel_cost(component: str, cost: Callable[[], Tuple[int, int]]):
    """Context of a self-reporting op: ``cost()`` (bytes, FLOPs) is charged
    to ``component`` in the active walk's scope and the ops inside are not
    charged. A null context when no walk is recording, so ``cost`` is not
    even computed."""
    walk = _active
    if walk is None or walk.opaque or not walk.entered:
        return _NULL
    # The counting's own ops (a sum over a validity mask) are not the
    # program's.
    walk.opaque += 1
    try:
        counts = cost()
    except Exception as e:  # noqa: BLE001 — counting never fails the call
        walk.failed = e
        return _NULL
    finally:
        walk.opaque -= 1
    return _KernelScope(walk, component, counts)


class _Forced:
    def __init__(self, walk: _Walk, component: str):
        self.walk, self.component = walk, component

    def __enter__(self):
        self.prev, self.walk.forced = self.walk.forced, self.component
        return self

    def __exit__(self, *exc):
        self.walk.forced = self.prev
        return False


def component(name: str):
    """Context charging every op inside it to component ``name`` (the cache
    writes); a null context when no walk is recording."""
    walk = _active
    return _NULL if walk is None or not walk.entered else _Forced(walk, name)


class _Step:
    def __init__(self, walk: _Walk):
        self.walk = walk

    def __enter__(self):
        self.walk.scope = "step"
        return self

    def __exit__(self, *exc):
        # The first iteration is the step's ledger; the rest run unwalked.
        self.walk.scope = "call"
        self.walk.exit()
        return False


class _Loop:
    def __init__(self, walk: _Walk):
        self.walk = walk
        self.resume = walk.entered

    def __enter__(self):
        return self

    def __call__(self, t: int):
        return _Step(self.walk) if (t == 0 and self.walk.entered) else _NULL

    def __exit__(self, *exc):
        # What follows the loop (the paged view's scatter) is the call's.
        if self.resume and not self.walk.entered and _active is self.walk:
            self.walk.enter()
        return False


class _NullLoop:
    def __enter__(self):
        return self

    def __call__(self, t: int):
        return _NULL

    def __exit__(self, *exc):
        return False


_NULL_LOOP = _NullLoop()


def decode_loop():
    """The decode loops' marker: ``with decode_loop() as mark: while ...:
    with mark(t): <one step>``. Under a walk the first iteration is charged
    to ``step`` and the later ones run outside the dispatch mode; otherwise
    it costs a call or two."""
    walk = _active
    return _NULL_LOOP if walk is None else _Loop(walk)


# -- reference rates ---------------------------------------------------------------

# Without a CUDA card: the reference's nominal CPU figures (indicative).
CPU_NOMINAL_GFLOPS = 100.0
CPU_DISPATCH_S = 2e-4

_gflops_override: Optional[float] = None
_dispatch_override: Optional[float] = None


def set_achievable_gflops(gflops: Optional[float]) -> None:
    global _gflops_override
    _gflops_override = float(gflops) if gflops else None


def set_dispatch_s(seconds: Optional[float]) -> None:
    global _dispatch_override
    _dispatch_override = float(seconds) if seconds else None


def reference_achievable_gflops() -> float:
    from fairness_llm_tpu_torch.telemetry.roofline import CARDS, card_name

    if _gflops_override is not None:
        return _gflops_override
    name = card_name()
    if name is None:
        return CPU_NOMINAL_GFLOPS
    return CARDS.get(name, {}).get("bf16_gflops", 0.0)


def reference_dispatch_s() -> float:
    from fairness_llm_tpu_torch.telemetry.roofline import card_name

    if _dispatch_override is not None:
        return _dispatch_override
    return CPU_DISPATCH_S if card_name() is None else 0.0


# -- publication -------------------------------------------------------------------


def publish_ledger(ledger: CostLedger) -> None:
    """``cost_ledger_bytes{program, component, scope}`` and
    ``cost_ledger_flops{...}`` (scope ``step``: one decode-loop iteration;
    ``call``: the rest of an invocation)."""
    if not attribution_on():
        return
    reg = get_registry()
    for scope in ("call", "step"):
        for comp, c in ledger._table(scope).items():
            lbl = dict(program=ledger.program, component=comp, scope=scope)
            reg.gauge("cost_ledger_bytes", **lbl).set(c.bytes)
            reg.gauge("cost_ledger_flops", **lbl).set(c.flops)


def note_invocation(program: str, wall_s: float, steps: int = 0,
                    ledger: Optional[CostLedger] = None, compiling: bool = False) -> None:
    """Fold one program invocation into the gap-attribution gauges: wall,
    steps and calls per program, the reference rates, and with the
    program's ledger the per-component floor
    ``cost_component_min_s_total{program, component}``. ``compiling`` marks
    a first use, whose wall also goes to ``cost_compile_s_total``.
    Unlabeled by replica: the decomposition is per program."""
    if not attribution_on():
        return
    reg = get_registry()
    lbl = dict(component="costmodel", program=program)
    reg.gauge("cost_wall_s_total", **lbl).add(max(float(wall_s), 0.0))
    reg.gauge("cost_steps_total", **lbl).add(float(steps))
    reg.gauge("cost_calls_total", **lbl).add(1.0)
    if compiling:
        reg.gauge("cost_compile_s_total", **lbl).add(max(float(wall_s), 0.0))
    gbps = _roofline_gbps()
    gflops = reference_achievable_gflops()
    reg.gauge("cost_reference_gbps", component="costmodel").set(gbps)
    reg.gauge("cost_reference_gflops", component="costmodel").set(gflops)
    reg.gauge("cost_dispatch_s", component="costmodel").set(reference_dispatch_s())
    if ledger is not None:
        for comp, sec in ledger.min_times_s(steps, gbps * 1e9, gflops * 1e9).items():
            reg.gauge("cost_component_min_s_total", program=program, component=comp).add(sec)


def _roofline_gbps() -> float:
    from fairness_llm_tpu_torch.telemetry.roofline import reference_achievable_gbps

    return reference_achievable_gbps()


# -- the per-program hook ----------------------------------------------------------


def tp_collective_costs(model_config, tp: int, rows: int, tokens: int = 1,
                        scope: str = "step") -> List[Tuple[str, int, int]]:
    """Analytic collective traffic of one tensor-parallel forward of ``rows
    x tokens`` positions (the reference's function, unchanged): a ring
    all-reduce of the ``[rows, tokens, d_model]`` activation after each
    row-parallel projection (o where the heads shard, down where ``d_ff``
    does) at ``2 (tp-1)/tp`` bytes a byte, and the logits' gather where the
    vocabulary shards at ``(tp-1)/tp``; FLOPs 0. ``[]`` when nothing shards.
    ``InstrumentedProgram`` adds these rows to a ledger whose walk saw no
    collective."""
    if tp <= 1:
        return []
    itemsize = 2 if model_config.dtype == "bfloat16" else 4
    act_bytes = rows * tokens * model_config.d_model * itemsize
    all_reduces = (int(model_config.num_heads % tp == 0)
                   + int(model_config.d_ff % tp == 0))
    total = int(model_config.num_layers * all_reduces
                * act_bytes * 2 * (tp - 1) / tp)
    if model_config.vocab_size % tp == 0:
        total += int(rows * tokens * model_config.vocab_size * itemsize
                     * (tp - 1) / tp)
    if total <= 0:
        return []
    return [(scope, total, 0)]


def collective_cost(nbytes: int, group_size: int) -> Tuple[int, int]:
    """(bytes, FLOPs) a rank moves in a ring all-reduce of ``nbytes``: the
    ``collectives`` charge of an explicit all-reduce under a walk."""
    return int(nbytes * 2 * (group_size - 1) / group_size), 0


class InstrumentedProgram:
    """One program key's cost ledger and memory capture (the port's
    counterpart of the reference's ``InstrumentedJit``). ``run(fn, *args)``
    calls ``fn(*args)``; on the program's first armed invocation it does so
    under the cost walk (attribution on, until a ledger exists) and the
    memory probe (``memory.program_memory_capture_on()``, until captured).
    A walk or capture that fails logs once and is not tried again for this
    program; the call's own exceptions propagate untouched, and a call that
    raised leaves both to the next invocation. ``collectives`` (rows of
    ``tp_collective_costs``) are added to a ledger whose walk charged no
    collective."""

    def __init__(self, program: str, device=None, collectives=None):
        self.program = program
        self.device = device
        self._collectives = list(collectives or ())
        self.ledger: Optional[CostLedger] = None
        self._ledger_failed = False
        self._memory_done = False
        self._memory_failed = False

    def run(self, fn, *args, memory_args=None):
        """``memory_args`` names the tensors the capture counts as the
        program's arguments (default ``args``)."""
        global _active
        from fairness_llm_tpu_torch.telemetry import memory

        walk_on = self.ledger is None and not self._ledger_failed and attribution_on()
        mem_on = (not self._memory_done and not self._memory_failed
                  and memory.program_memory_capture_on())
        if not (walk_on or mem_on) or _active is not None:
            return fn(*args)
        try:
            probe = memory.ProgramMemoryProbe(self.device) if mem_on else None
            walk = _Walk(self.program, charge=walk_on, probe=probe)
            walk.enter()
        except Exception as e:  # noqa: BLE001 — diagnostics only
            self._ledger_failed = self._memory_failed = True
            logger.warning("cost walk for %s unavailable: %s: %s", self.program,
                           type(e).__name__, e)
            return fn(*args)
        _active = walk
        try:
            out = fn(*args)
        finally:
            _active = None
            try:
                walk.exit()
            except Exception as e:  # noqa: BLE001 — diagnostics only
                walk.failed = walk.failed or e
        if walk_on:
            if walk.failed is not None:
                self._ledger_failed = True
                logger.warning("cost ledger for %s unavailable: %s: %s", self.program,
                               type(walk.failed).__name__, walk.failed)
            else:
                ledger = walk.ledger
                if self._collectives and not any(
                        "collectives" in ledger._table(sc) for sc in ("call", "step")):
                    for scope, b, f in self._collectives:
                        ledger.record(scope, "collectives", int(b), int(f))
                self.ledger = ledger
                publish_ledger(self.ledger)
        if mem_on:
            try:
                probe.publish(self.program, args if memory_args is None else memory_args, out)
                self._memory_done = True
            except Exception as e:  # noqa: BLE001 — diagnostics only
                self._memory_failed = True
                logger.warning("program memory for %s unavailable: %s: %s", self.program,
                               type(e).__name__, e)
        return out


# -- gap decomposition / report ------------------------------------------------------


def gap_decomposition(snap: Dict) -> Dict[str, Dict]:
    """Per-program gap attribution from a telemetry snapshot:

        wall + host_gap = floor (sum component min-times) + dispatch
                        + compile + unattributed + host_gap

    every right-hand term per program (``unattributed`` is the residual, so
    the sum is exact), with the per-component floor table and the top gap
    contributor among the non-floor terms."""
    gauges = snap.get("gauges", [])

    def rows(name):
        return [g for g in gauges if g.get("name") == name]

    def val(name, **want) -> float:
        for g in rows(name):
            lb = g.get("labels", {})
            if all(lb.get(k) == v for k, v in want.items()):
                return float(g.get("value", 0.0))
        return 0.0

    dispatch_s = val("cost_dispatch_s")
    out: Dict[str, Dict] = {}
    programs = sorted({g.get("labels", {}).get("program")
                       for g in rows("cost_wall_s_total")} - {None})
    for p in programs:
        wall = val("cost_wall_s_total", program=p)
        calls = val("cost_calls_total", program=p)
        steps = val("cost_steps_total", program=p)
        host_gap = val("cost_host_gap_s_total", program=p)
        compile_s = val("cost_compile_s_total", program=p)
        comps = {g["labels"].get("component"): float(g.get("value", 0.0))
                 for g in rows("cost_component_min_s_total")
                 if g.get("labels", {}).get("program") == p}
        floor = sum(comps.values())
        dispatch = calls * dispatch_s
        unattributed = wall - dispatch - floor - compile_s
        total = wall + host_gap
        ledger = {}
        for g in rows("cost_ledger_bytes"):
            lb = g.get("labels", {})
            if lb.get("program") != p:
                continue
            ledger[(lb.get("component"), lb.get("scope"))] = {"bytes": float(g.get("value", 0.0))}
        for g in rows("cost_ledger_flops"):
            lb = g.get("labels", {})
            if lb.get("program") != p:
                continue
            ledger.setdefault((lb.get("component"), lb.get("scope")), {})["flops"] = \
                float(g.get("value", 0.0))
        contributors = {"host_gap": host_gap, "dispatch": dispatch, "compile": compile_s,
                        "unattributed_in_step": unattributed}
        top = max(contributors, key=lambda k: contributors[k]) if total > 0 else None
        aoa = None
        for g in rows("achieved_over_achievable"):
            if g.get("labels", {}).get("program") == p:
                aoa = float(g.get("value", 0.0))
        out[p] = {
            "wall_s": wall,
            "host_gap_s": host_gap,
            "calls": calls,
            "steps": steps,
            "dispatch_s": dispatch,
            "compile_s": compile_s,
            "floor_s": floor,
            "floor_components_s": comps,
            "unattributed_s": unattributed,
            "total_s": total,
            "sum_check_s": floor + dispatch + compile_s + unattributed + host_gap,
            "achieved_over_achievable": aoa,
            "top_gap_contributor": top,
            "ledger": ledger,
        }
    return out


def has_cost_data(snap: Dict) -> bool:
    return any(g.get("name") == "cost_wall_s_total" for g in snap.get("gauges", []))


def _fmt_bytes(b: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if b >= div:
            return f"{b / div:.2f} {unit}"
    return f"{b:.0f} B"


def _fmt_s(s: float) -> str:
    if abs(s) >= 1.0:
        return f"{s:.3f} s"
    return f"{s * 1e3:.2f} ms"


def render_cost_report(snap: Dict, width: int = 78) -> str:
    """The cost ledger and gap decomposition in the terminal: the
    ``perf-report`` subcommand, and a section of ``telemetry-report``. The
    text is the reference's, so one snapshot renders alike in both
    packages."""
    lines = ["=" * width, "DECODE COST LEDGER / GAP ATTRIBUTION", "=" * width]
    decomp = gap_decomposition(snap)
    if not decomp:
        lines.append("(no cost-ledger data — was the attribution layer on?)")
        return "\n".join(lines)
    gauges = snap.get("gauges", [])

    def ref(name):
        for g in gauges:
            if g.get("name") == name:
                return float(g.get("value", 0.0))
        return 0.0

    lines.append(
        f"references: {ref('cost_reference_gbps'):g} GB/s streaming, "
        f"{ref('cost_reference_gflops'):g} GFLOP/s, "
        f"{ref('cost_dispatch_s') * 1e6:g} us/dispatch (nominal)"
    )
    for program, d in decomp.items():
        lines.append(f"\n[{program}]  calls={d['calls']:g} steps={d['steps']:g}"
                     + (f"  achieved_over_achievable={d['achieved_over_achievable']:.3f}"
                        if d["achieved_over_achievable"] is not None else ""))
        comp_rows = sorted(d["floor_components_s"].items(), key=lambda kv: -kv[1])
        if comp_rows:
            lines.append(f"  {'component':<26} {'bytes/step':>12} "
                         f"{'flops/step':>12} {'min-time':>12} {'share':>7}")
            for comp, sec in comp_rows:
                sb = d["ledger"].get((comp, "step"), {})
                cb = d["ledger"].get((comp, "call"), {})
                by = sb.get("bytes", cb.get("bytes", 0.0))
                fl = sb.get("flops", cb.get("flops", 0.0))
                share = sec / d["floor_s"] if d["floor_s"] > 0 else 0.0
                lines.append(f"  {COMPONENT_TITLES.get(comp, comp):<26} "
                             f"{_fmt_bytes(by):>12} {fl:>12.3g} "
                             f"{_fmt_s(sec):>12} {share:>6.1%}")
        total = d["total_s"]

        def pct(x):
            return f"{x / total:6.1%}" if total > 0 else "     -"

        lines.append(f"  measured: chunk wall {_fmt_s(d['wall_s'])} "
                     f"+ host gap {_fmt_s(d['host_gap_s'])} = {_fmt_s(total)}")
        lines.append(f"    floor (sum component min-time) "
                     f"{_fmt_s(d['floor_s']):>12}  {pct(d['floor_s'])}")
        lines.append(f"    dispatch (estimated)           "
                     f"{_fmt_s(d['dispatch_s']):>12}  {pct(d['dispatch_s'])}")
        lines.append(f"    compile (first-call walls)     "
                     f"{_fmt_s(d['compile_s']):>12}  {pct(d['compile_s'])}")
        lines.append(f"    unattributed in-step           "
                     f"{_fmt_s(d['unattributed_s']):>12}  {pct(d['unattributed_s'])}")
        lines.append(f"    host gap (measured)            "
                     f"{_fmt_s(d['host_gap_s']):>12}  {pct(d['host_gap_s'])}")
        ok = abs(d["sum_check_s"] - total) <= max(1e-9, 1e-6 * total)
        lines.append(f"    sum check: {'OK' if ok else 'MISMATCH'} "
                     f"(components sum to the measured wall)")
        if d["unattributed_s"] < 0:
            lines.append("    note: negative residual — the nothing-fuses "
                         "byte model charged intermediates XLA fused away")
        if d["top_gap_contributor"] is not None:
            lines.append(f"  top gap contributor: {d['top_gap_contributor']}")
    return "\n".join(lines)


def check_costmodel(snap: Dict) -> List[str]:
    """The cost-ledger gate of the reference's ``tools/validate_telemetry.py
    --require-costmodel`` (which imports the JAX package), the same
    problems for the same snapshot: every program in ``compiles_total``
    published a nonzero ledger, the gap attribution has a measured wall and
    a floor, a ``*_fused`` program a measured wall and host gap, and a
    ``@tp<k>`` program a nonzero ``collectives`` component."""
    problems = []
    compiled = sorted({c.get("labels", {}).get("program") for c in snap.get("counters", [])
                       if c.get("name") == "compiles_total" and c.get("value")} - {None})
    if not compiled:
        problems.append("compiles_total is empty (no compiled program to require a ledger for)")
    ledgered: Dict[str, float] = {}
    for g in snap.get("gauges", []):
        if g.get("name") != "cost_ledger_bytes":
            continue
        prog = g.get("labels", {}).get("program")
        ledgered[prog] = ledgered.get(prog, 0.0) + float(g.get("value", 0.0))
    for prog in compiled:
        if ledgered.get(prog, 0.0) <= 0:
            problems.append(f"compiled program {prog!r} has no nonzero cost_ledger_bytes gauge "
                            "(the jaxpr cost walk never ran for it)")
    walls = {g.get("labels", {}).get("program"): float(g.get("value", 0.0))
             for g in snap.get("gauges", []) if g.get("name") == "cost_wall_s_total"}
    if not any(v > 0 for v in walls.values()):
        problems.append("no nonzero cost_wall_s_total gauge (gap attribution has no measured "
                        "wall to decompose)")
    floors = [g for g in snap.get("gauges", [])
              if g.get("name") == "cost_component_min_s_total" and g.get("value", 0.0) > 0]
    if not floors:
        problems.append("cost_component_min_s_total is empty (no invocation ever folded its "
                        "ledger into the floor)")
    host_gaps = {g.get("labels", {}).get("program"): float(g.get("value", 0.0))
                 for g in snap.get("gauges", []) if g.get("name") == "cost_host_gap_s_total"}
    for prog in compiled:
        if not prog.split("@", 1)[0].endswith("_fused"):
            continue
        if walls.get(prog, 0.0) <= 0:
            problems.append(f"fused program {prog!r} has no measured cost_wall_s_total (its "
                            "invocations were never accumulated)")
        if host_gaps.get(prog, 0.0) <= 0:
            problems.append(f"fused program {prog!r} has no nonzero cost_host_gap_s_total (the "
                            "fused-dispatch boundary never measured a host gap)")
    coll: Dict[str, float] = {}
    for g in snap.get("gauges", []):
        if (g.get("name") == "cost_ledger_bytes"
                and g.get("labels", {}).get("component") == "collectives"):
            prog = g.get("labels", {}).get("program")
            coll[prog] = coll.get(prog, 0.0) + float(g.get("value", 0.0))
    for prog in compiled:
        if "@tp" in prog and coll.get(prog, 0.0) <= 0:
            problems.append(f"sharded program {prog!r} has no nonzero collectives component in "
                            "cost_ledger_bytes (tensor-parallel comm never attributed)")
    return problems

