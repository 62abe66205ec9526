"""Decode backends: the seam where the phase code meets inference
(counterpart of ``fairness_llm_tpu/pipeline/backends.py``).

- ``EngineBackend``: batched decode through a ``DecodeEngine`` on the card
  (or on the CPU when asked).
- ``SimulatedRecommender``: a seeded, instant fake model with a
  demographic-bias knob, for tests and ``--model simulated`` runs.
- ``backend_for``: a model name to its backend, loading a checkpoint from
  ``Config.weights_dir`` when there is one; with ``Config.serving.enabled``
  an engine is served through the continuous-batching ``ServingBackend``
  (``serving/backend.py``).

Resilience (watchdog, breakers, the serving journal) is wired here as in
the reference. With ``config.mesh`` over more than one rank the engine
runs over a ``("dp", "tp", "sp")`` mesh of the ``torchrun`` world
(``parallel/``): each dp rank decodes its rows, each tp rank holds its
shard of the weights, and the sp ranks split the scoring forward's
sequence. Served (``--continuous``), only a tp-only mesh is taken
(``--tp N`` makes one), as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import re
from typing import Any, Dict, List, Optional, Protocol, Sequence, Union

import numpy as np
import torch

from fairness_llm_tpu_torch.config import Config, ModelSettings
from fairness_llm_tpu_torch.runtime.engine import _token_lcp
from fairness_llm_tpu_torch.utils.profiling import SpeculationStats

logger = logging.getLogger(__name__)


class DecodeBackend(Protocol):
    """``keys`` are optional stable per-prompt identities (profile ids): a
    deterministic backend keys its per-prompt randomness on them, not on
    batch position, so resumed sweeps reproduce uninterrupted ones."""

    name: str

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        seed: int = 0,
        keys: Optional[Sequence[str]] = None,
        prefix_ids: Optional[Sequence[int]] = None,
    ) -> List[str]:
        ...


class EngineBackend:
    """Real in-framework decode through a ``DecodeEngine``. ``last_stats``
    holds the stats of the most recent ``generate`` call.

    ``speculation`` (a ``SpeculationConfig``) turns on prompt-lookup
    speculative decoding for greedy sweeps; sampled settings take the plain
    path, so it is always safe to set. The speculative calls' counters add
    up in ``spec_totals`` (a ``SpeculationStats``)."""

    def __init__(self, engine, name: Optional[str] = None, speculation=None):
        self.engine = engine
        self.name = name or engine.config.name
        self.speculation = speculation
        self.spec_totals: Optional[SpeculationStats] = None
        self.last_stats: Optional[Dict[str, Any]] = None

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        seed: int = 0,
        keys: Optional[Sequence[str]] = None,
        prefix_ids: Optional[Sequence[int]] = None,
    ) -> List[str]:
        row_seeds = None
        if keys is not None:
            # Per-row sampling streams keyed on stable identity, so resumed /
            # re-chunked sweeps decode identical text for the same profile.
            row_seeds = [(_stable_hash(k) ^ seed) & 0xFFFFFFFF for k in keys]
        out = self.engine.generate(
            prompts, settings, seed=seed, row_seeds=row_seeds,
            prefix_ids=prefix_ids,
            # sweeps pass an explicit sweep-wide prefix; never auto-detect per
            # chunk (composition-dependent)
            share_prefix=None if prefix_ids is not None else False,
            speculation=self.speculation,
        )
        self.last_stats = out.stats
        sp = (out.stats or {}).get("speculation")
        if sp is not None:
            chunk = SpeculationStats.from_dict(sp)
            self.spec_totals = chunk if self.spec_totals is None else self.spec_totals.merge(chunk)
        return out.texts


def shared_prefix_ids(backend, prompts: Sequence[str]) -> Optional[List[int]]:
    """Sweep-wide shared prefix for reproducible prefix-cached decode: the
    longest common token prefix over ALL the sweep's prompts, floored to a
    multiple of 64. None for non-engine backends, a backend that does not
    share prefixes (``use_shared_prefix`` False), or short prefixes."""
    engine = getattr(backend, "engine", None)
    if engine is None or len(prompts) < 2:
        return None
    if not getattr(backend, "use_shared_prefix", True):
        # ServingBackend decodes rows on their own and ignores prefix_ids
        return None
    rows = [engine.tokenizer.encode(p) for p in prompts]
    common = (_token_lcp(rows) // 64) * 64
    return list(rows[0][:common]) if common >= 64 else None


def _stable_hash(*parts: object) -> int:
    h = hashlib.sha256("||".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "little")


_GENDER_RE = re.compile(r"Gender:\s*([\w\-]+)", re.IGNORECASE)
_AGE_RE = re.compile(r"Age Group:\s*([\w\-\+]+)", re.IGNORECASE)


class SimulatedRecommender:
    """Deterministic fake model that answers by the shape of the prompt.

    Recommendation prompts: 10 titles from a seeded global shuffle of the
    catalog, the selection window slid by a demographic-dependent offset
    scaled by ``bias``, so counterfactual profiles get measurably different
    recommendations; a prompt with a fairness instruction block shrinks the
    offset by ``mitigation``.

    Listwise prompts ("Your ranking:"): a seeded permutation, in which the
    items of the preferred group (the first in sorted order) gain up to
    ``bias`` when ``catalog_groups`` is given. Pairwise prompts ("Your
    answer:"): a seeded A/B choice, biased by the same rule. At ``bias`` >= 1
    both saturate."""

    def __init__(
        self,
        catalog: Sequence[str],
        seed: int = 42,
        bias: float = 0.6,
        mitigation: float = 0.85,
        name: str = "simulated",
        catalog_groups: Optional[Sequence[str]] = None,
    ):
        if not catalog:
            raise ValueError("SimulatedRecommender needs a non-empty catalog")
        if catalog_groups is not None and len(catalog_groups) != len(catalog):
            raise ValueError("catalog_groups must align with catalog")
        self.catalog = list(catalog)
        self.seed = seed
        self.bias = bias
        self.mitigation = mitigation
        self.name = name
        # Keyed on the stripped title (the ranking regexes strip whitespace);
        # listwise prompts map groups by position, which duplicates survive.
        self._groups = list(catalog_groups) if catalog_groups else []
        self._group_of: Dict[str, str] = {}
        for text, group in zip(self.catalog, self._groups):
            key = text.strip()
            if key in self._group_of and self._group_of[key] != group:
                logger.warning(
                    "SimulatedRecommender: duplicate catalog title %r with "
                    "conflicting groups; listwise prompts use exact positional "
                    "mapping, pairwise text lookup keeps the last assignment",
                    key,
                )
            self._group_of[key] = group
        self._preferred = sorted(set(catalog_groups))[0] if catalog_groups else None
        order = sorted(
            range(len(self.catalog)), key=lambda i: _stable_hash(self.catalog[i], seed)
        )
        self._shuffled = [self.catalog[i] for i in order]

    def _recommend(self, prompt: str, idx: int, seed: int, n: int = 10) -> str:
        gender = (_GENDER_RE.search(prompt) or [None, "neutral"])[1].lower()
        age = (_AGE_RE.search(prompt) or [None, "neutral"])[1].lower()
        fair = "FAIRNESS REQUIREMENT" in prompt or "FAIRNESS PROTOCOL" in prompt
        bias = self.bias * (1.0 - self.mitigation) if fair else self.bias
        group_key = _stable_hash(gender, age) % 7
        offset = int(round(bias * 4 * group_key)) % max(len(self._shuffled) - 2 * n, 1)
        rng = np.random.default_rng([self.seed & 0x7FFFFFFF, seed & 0x7FFFFFFF, idx])
        window = self._shuffled[offset : offset + int(n * 1.5)]
        take = min(n, len(window))
        chosen = list(rng.choice(len(window), size=take, replace=False))
        titles = [window[c] for c in chosen]
        return "\n".join(f"{i + 1}. {t}" for i, t in enumerate(titles))

    def _rank(self, prompt: str, idx: int, seed: int) -> str:
        lines = re.findall(r"^\d+\.\s*(.+?)\s*$", prompt, flags=re.MULTILINE)
        num_items = max(len(lines), 1)
        rng = np.random.default_rng([self.seed & 0x7FFFFFFF, seed & 0x7FFFFFFF, idx, 1])
        if not self._group_of:  # group-blind: a plain seeded permutation
            perm = rng.permutation(num_items) + 1
            return ",".join(str(int(p)) for p in perm)
        # A prompt that lists the whole catalog in order maps groups by
        # position; any other falls back to the title.
        positional_ok = len(lines) == len(self._groups)
        scores = rng.random(num_items)
        for i, text in enumerate(lines):
            group = self._groups[i] if positional_ok else self._group_of.get(text)
            if group == self._preferred:
                scores[i] += self.bias
        order = np.argsort(-scores, kind="stable") + 1
        return ",".join(str(int(p)) for p in order)

    def _compare(self, prompt: str, idx: int, seed: int) -> str:
        rng = np.random.default_rng(
            [_stable_hash(prompt) & 0x7FFFFFFF, self.seed & 0x7FFFFFFF, seed & 0x7FFFFFFF]
        )
        if self._group_of:
            m = re.search(r"Document A:\s*(.+?)\s*\n+Document B:\s*(.+?)\s*\n", prompt)
            if m:
                ga = self._group_of.get(m.group(1))
                gb = self._group_of.get(m.group(2))
                if ga != gb and self._preferred in (ga, gb):
                    # the preferred item wins with probability 0.5 + bias/2,
                    # at most 1
                    p_pref = min(1.0, 0.5 + self.bias / 2)
                    pick_pref = rng.random() < p_pref
                    pref_is_a = ga == self._preferred
                    return "A" if pick_pref == pref_is_a else "B"
        return "A" if rng.random() < 0.5 else "B"

    def generate(
        self,
        prompts: Sequence[str],
        settings: Optional[ModelSettings] = None,
        seed: int = 0,
        keys: Optional[Sequence[str]] = None,
        prefix_ids: Optional[Sequence[int]] = None,  # unused: text-level fake
    ) -> List[str]:
        # Entropy per prompt = (seed, prompt hash, stable key), not batch
        # position, so outputs do not depend on chunking or on which prompts
        # a resume skipped. Without keys, occurrence order stands in.
        out = []
        seen: dict = {}
        for i, p in enumerate(prompts):
            if keys is not None:
                salt = _stable_hash(keys[i])
            else:
                occ = seen.get(p, 0)
                seen[p] = occ + 1
                salt = occ
            idx = (_stable_hash(p) + salt) & 0x7FFFFFFF
            if "Your ranking:" in p:
                out.append(self._rank(p, idx, seed))
            elif "Your answer:" in p:
                out.append(self._compare(p, idx, seed))
            else:
                out.append(self._recommend(p, idx, seed))
        return out


# Named simulated variants: distinct bias levels give phase 2 a cross-model
# comparison without weights.
SIMULATED_VARIANTS = {"simulated": 0.6, "simulated-fair": 0.15, "simulated-biased": 0.9}


def engine_for(model_name: str, config: Config, ckpt: Optional[str] = None,
               params: Optional[Dict[str, torch.Tensor]] = None,
               device: Optional[Union[str, torch.device]] = None, mesh=None):
    """The ``DecodeEngine`` of ``model_name`` on ``device`` (None means CUDA)
    with the port's attention kernels on (``use_flash_attention``,
    ``use_decode_attention_kernel``) and ``config.weight_quant`` applied:
    the weights of checkpoint directory ``ckpt``, verified against its
    manifest (``config.integrity``; a refusal raises ``IntegrityError``),
    with the checkpoint's own tokenizer when it has a
    ``tokenizer_config.json``; else ``params``; else random from
    ``config.random_seed`` with the byte tokenizer. ``mesh`` (a
    ``parallel.make_mesh`` device mesh) makes it a dp engine."""
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine
    from fairness_llm_tpu_torch.runtime.weights import load_checkpoint

    model_config = dataclasses.replace(
        get_model_config(model_name), use_flash_attention=True,
        use_decode_attention_kernel=True)
    if config.weight_quant is not None:
        # "int8" quantizes a float config, "none" serves an -int8 one in float
        model_config = dataclasses.replace(model_config, weight_quant=config.weight_quant)
    tokenizer_path = None
    if ckpt is not None:
        logger.info("loading %s weights from %s", model_name, ckpt)
        params = load_checkpoint(model_config, ckpt,
                                 verify=config.integrity.verify_manifests, device=device)
        if os.path.exists(os.path.join(ckpt, "tokenizer_config.json")):
            tokenizer_path = ckpt
    return DecodeEngine(model_config, params=params, tokenizer_path=tokenizer_path,
                        seed=config.random_seed, device=device,
                        numerics_guards=config.integrity.numerics_guards, mesh=mesh)


def backend_for(
    model_name: str,
    config: Config,
    catalog: Optional[Sequence[str]] = None,
    params: Optional[Dict[str, torch.Tensor]] = None,
    allow_random: bool = False,
    device: Optional[Union[str, torch.device]] = None,
    catalog_groups: Optional[Sequence[str]] = None,
) -> DecodeBackend:
    """Resolve a model name to a backend.

    A ``SIMULATED_VARIANTS`` name gives a ``SimulatedRecommender`` over
    ``catalog`` (with ``catalog_groups``, the group of each entry, for its
    biased rankings). A model name gives an ``EngineBackend`` on ``device``
    (None means CUDA) with the weights of ``config.weights_dir/<model_name>``,
    verified against its manifest (``config.integrity``), and the
    checkpoint's own tokenizer when it has a ``tokenizer_config.json``.
    Without weights the call fails, unless ``allow_random`` asks for random
    weights from ``config.random_seed`` (smoke runs), which decode with the
    byte tokenizer. ``config.weight_quant`` overrides the model's weight
    mode either way. With ``config.serving.enabled`` the engine is served
    through a ``ServingBackend`` (speculation, which the serving loop does
    not compose with, is then ignored, as the reference ignores it), with
    ``config.resilience`` (breakers, watchdog, the serving journal),
    ``config.integrity`` (numerics guards, the canary),
    ``config.overload`` (QoS queues and load shedding) and ``config.fleet``
    and ``config.autoscale`` (the replica fleet); the engine path gets the
    breakers and the watchdog too. With ``config.mesh.num_devices > 1`` the
    engine runs on that mesh over the process group (``torchrun``); serving
    takes a tp-only one: ``--continuous`` with dp or sp > 1 raises before
    any weight is loaded, as the reference's does.

    The engine runs the port's attention kernels (``use_flash_attention``
    and ``use_decode_attention_kernel`` on): on the card they are the hand
    written kernels, on the CPU their plain versions. The reference turns
    them off where its Pallas tiles do not fit the TPU (head width 32) or
    measured slower there."""
    if model_name in SIMULATED_VARIANTS:
        return SimulatedRecommender(
            catalog or [], seed=config.random_seed,
            bias=SIMULATED_VARIANTS[model_name], name=model_name,
            catalog_groups=catalog_groups,
        )

    if config.serving.enabled and (config.mesh.dp > 1 or config.mesh.sp > 1):
        # Before the mesh and the weights: the scheduler would refuse the
        # mesh only after the load.
        raise ValueError(
            "--continuous serving supports single-device or tp-only meshes (the KV slot "
            "scatter is not dp/sp-aware); drop --mesh")
    mesh = None
    if config.mesh.num_devices > 1:
        from fairness_llm_tpu_torch.parallel import make_mesh

        mesh = make_mesh(config.mesh)
    ckpt = os.path.join(config.weights_dir or "", model_name)
    if params is not None or not (config.weights_dir and os.path.isdir(ckpt)):
        ckpt = None
        if params is None and not allow_random:
            raise FileNotFoundError(
                f"no weights for '{model_name}' under weights_dir="
                f"{config.weights_dir!r}; use --model simulated, provide a "
                f"checkpoint, or pass allow_random=True for a smoke run"
            )
    engine = engine_for(model_name, config, ckpt=ckpt, params=params, device=device,
                        mesh=mesh)
    resilience = config.resilience if config.resilience.enabled else None
    if config.serving.enabled:
        from fairness_llm_tpu_torch.serving.backend import ServingBackend

        journal = None
        if resilience is not None and resilience.journal_dir:
            from fairness_llm_tpu_torch.resilience import ServingJournal

            journal = ServingJournal(resilience.journal_dir,
                                     rotate_every=resilience.journal_rotate_every)
        return ServingBackend(engine, config.serving, name=model_name, resilience=resilience,
                              journal=journal, integrity=config.integrity,
                              fleet=config.fleet, overload=config.overload,
                              autoscale=config.autoscale)
    if resilience is not None:
        # The engine path gets the watchdog (contained by
        # with_failure_containment) and a board for the speculate gate.
        from fairness_llm_tpu_torch.resilience import BreakerBoard, StepWatchdog

        engine.breakers = BreakerBoard(failure_threshold=resilience.breaker_threshold,
                                       cooldown_s=resilience.breaker_cooldown_s,
                                       component="engine")
        if resilience.max_step_seconds > 0:
            engine.watchdog = StepWatchdog(resilience.max_step_seconds, component="engine")
    spec = config.speculation
    return EngineBackend(engine, name=model_name,
                         speculation=spec if spec.enabled else None)
