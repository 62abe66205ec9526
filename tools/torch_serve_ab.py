#!/usr/bin/env python3
"""Hold checkouts of the port against each other on one card, in alternating
processes: the decode step of a serve call, a traced decode call, and single
kernel calls, each measured in the same run for every checkout.

Run on a machine with one NVIDIA H100, naming the checkouts' roots (this
one's by default):

    python3 tools/torch_serve_ab.py PARENT CHANGE [--model llama3-8b-int8]
        [--rounds 10] [--out FILE]

Each round starts one process per checkout, one after the other, in the
order given and then reversed in the next round (A B, B A, A B, ...), so a
drift of the machine's state falls on every checkout alike. A process puts
its checkout first on ``sys.path``, so it imports only that checkout's
``fairness_llm_tpu_torch`` and builds its kernels into that checkout's
``build/kernels``, then:

- builds ``--model`` (llama3-8b, bf16, or llama3-8b-int8, int8 projections
  through K4) at full width and depth (random weights from seed 0, the
  decode-attention kernel on), serves ``chip_smoke.py``'s 16 counterfactual
  prompts with the sweep-wide shared prefix at temperature 0.7 with per-row
  keys (64 new tokens) ``--calls`` times after a warm-up, and reports each
  call's decode ms per step and prefill ms;
- traces one greedy shared-prefix call of 16 new tokens with torch.profiler
  and reports the device ms and launches a step of the model's decode
  kernels, by name: K2's (``decode_split_tc``, ``combine_splits``,
  ``decode_fwd``) for llama3-8b; K4's for llama3-8b-int8 (the GEMV
  ``gemv_stream_tc`` and the GEMM ``wg_gemm_kernel``, and their float32
  twins ``gemv_stream_tf32`` and ``tf32_gemm_kernel``);
- llama3-8b: calls ``decode_attention`` at each of ``SHAPES`` over a bf16
  cache and an int8 one (values and scales from the port's
  ``_quantize_kv``; valid slots a run per row drawn from seed 0): its host
  microseconds a call (the mean of 200 calls queued while the device
  sleeps, so no call waits for it) and its device ms a call (200 calls
  between CUDA events). A call of more than ~5 launches fills the launch
  queue (~1,000 entries) within the 200, and the host then waits for the
  sleeping device: both of its numbers are then upper bounds.
- llama3-8b-int8: the int8-weight products of one decode layer at batch 16
  (llama3-8b's q/k/v, o, gate/up and down, random weights from seed 0), as
  the checkout's model makes them (grouped where it has
  ``quant_matmul_group``), and lm_head (f32 out) alone: the device ms of
  each call timed alone after a 64 MB write evicts the L2 cache (a decode
  step finds each layer's weights there cold), 20 calls; and the host
  microseconds of the layer's calls, as above.

One JSON line per process, then a summary: each checkout's median, min
and max of every number over its processes, and the card's name and power
limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ITERS = 200
# (label, batch, heads, kv heads, head_dim, prefix, cache slots): llama3-8b
# at the smoke run's shared-prefix decode shape and at the sweep's batch of
# 48, and tiny-llama-study's heads and head_dim 32 at the sweep's batch
# with and without the prefix.
SHAPES = [("llama3-8b", 16, 32, 8, 128, 704, 160),
          ("llama3-8b", 48, 32, 8, 128, 704, 160),
          ("tiny-llama-study", 48, 4, 2, 32, 704, 160),
          ("tiny-llama-study", 48, 4, 2, 32, 0, 960)]


def decode_numbers(torch) -> list:
    from fairness_llm_tpu_torch.models.transformer import _quantize_kv
    from fairness_llm_tpu_torch.ops import decode_attention as dm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, B, H, Hkv, D, P, L in SHAPES:
        bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
        q = torch.randn(B, H, D, **bf)
        k, v = torch.randn(B, L, Hkv, D, **bf), torch.randn(B, L, Hkv, D, **bf)
        shared = (torch.randn(P, Hkv, D, **bf), torch.randn(P, Hkv, D, **bf)) if P else None
        start = torch.randint(0, L // 4, (B, 1), generator=g, device=dev)
        valid = torch.arange(L, device=dev)[None, :] >= start
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        for cache, (kk, vv, sc) in {"bf16": (k, v, {}),
                                    "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}.items():
            def call():
                return dm.decode_attention(q, kk, vv, valid, shared, **sc)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000 * ITERS)  # ~0.5 ms a call to come
            t0 = time.perf_counter()
            for _ in range(ITERS):
                call()
            host_us = (time.perf_counter() - t0) / ITERS * 1e6
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000 * ITERS)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(ITERS):
                call()
            e1.record()
            torch.cuda.synchronize()
            rows.append({"key": f"{label} B={B} D={D} P={P} L={L} {cache}",
                         "host_us": host_us, "ms": e0.elapsed_time(e1) / ITERS})
    return rows


# llama3-8b's int8 projections of one decode layer: (label, K, widths of
# the weights that share x, out dtype).
K4_LAYER = [("qkv", 4096, (4096, 1024, 1024)), ("o", 4096, (4096,)),
            ("gate_up", 4096, (14336, 14336)), ("down", 14336, (4096,))]
K4_HEAD = (4096, 128256)
# Device kernels a decode step's traced time is summed over, by model.
FOCUS = {"llama3-8b": ("decode_split_tc", "combine_splits", "decode_fwd"),
         "llama3-8b-int8": ("gemv_stream_tc", "wg_gemm_kernel", "gemv_stream_tf32",
                            "tf32_gemm_kernel")}


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Mean ms of ``fn``, each call timed alone with CUDA events after a 64
    MB write has evicted the 50 MB L2."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(1_000_000 * iters)
    for e0, e1 in events:
        flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in events) / iters


def k4_numbers(torch) -> list:
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    grouped = hasattr(qm, "quant_matmul_group")
    x = torch.randn(16, 4096, generator=g, device=dev).bfloat16()
    xd = torch.randn(16, 14336, generator=g, device=dev).bfloat16()

    def weight(K, N):
        return qm.quantize_weight(torch.randn(K, N, generator=g, device=dev) * 0.02)

    calls = []
    for label, K, Ns in K4_LAYER:
        mats = [weight(K, N) for N in Ns]
        xx = xd if K == 14336 else x
        if grouped:
            calls.append((label, lambda xx=xx, mats=mats: qm.quant_matmul_group(xx, mats)))
        else:
            calls.append((label, lambda xx=xx, mats=mats: [qm.quant_matmul(xx, *m)
                                                           for m in mats]))
    head = weight(*K4_HEAD)
    rows = [{"key": f"k4 M=16 {label}", "ms": cold_ms(torch, fn)} for label, fn in calls]
    rows.append({"key": "k4 M=16 lm_head f32",
                 "ms": cold_ms(torch, lambda: qm.quant_matmul(x, *head,
                                                              out_dtype=torch.float32))})

    def layer():
        for _, fn in calls:
            fn()

    layer()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000 * ITERS)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        layer()
    rows.append({"key": "k4 M=16 layer host_us", "host_us":
                 (time.perf_counter() - t0) / ITERS * 1e6})
    torch.cuda.synchronize()
    return rows


def traced_step(torch, backend, prompts, prefix, focus) -> dict:
    """Device ms and launches a decode step of the kernels named in
    ``focus``, over one traced greedy shared-prefix call of 16 new tokens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fairness_llm_tpu_torch.config import ModelSettings

    settings = ModelSettings(temperature=0.0, max_tokens=16)
    backend.generate(prompts, settings, prefix_ids=prefix)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        backend.generate(prompts, settings, prefix_ids=prefix)
        torch.cuda.synchronize()
    steps = max(backend.last_stats["decode_steps"], 1)
    us, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and any(f in e.name for f in focus):
            us += e.time_range.end - e.time_range.start
            n += 1
    return {"decode_steps": steps, "focus": list(focus), "device_ms_per_step": us / 1e3 / steps,
            "launches_per_step": n / steps}


def child(tree: pathlib.Path, calls: int, model: str) -> dict:
    """One process's measurements of the checkout at ``tree``."""
    sys.path.insert(0, str(tree))
    import dataclasses

    import torch

    from fairness_llm_tpu_torch.config import ModelSettings
    from fairness_llm_tpu_torch.models.configs import get_model_config
    from fairness_llm_tpu_torch.pipeline.backends import EngineBackend, shared_prefix_ids
    from fairness_llm_tpu_torch.runtime.engine import DecodeEngine

    # The prompts as chip_smoke.py of this tool's own checkout writes them,
    # from the checkout under test's modules.
    spec = importlib.util.spec_from_file_location("smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    profiles, prompts = smoke.counterfactual_prompts()
    keys = [p.id for p in profiles]

    out = {"tree": str(tree), "model": model,
           "kernels": k4_numbers(torch) if model == "llama3-8b-int8" else decode_numbers(torch)}
    cfg = dataclasses.replace(get_model_config(model), use_decode_attention_kernel=True)
    backend = EngineBackend(DecodeEngine(cfg, seed=0))
    prefix = shared_prefix_ids(backend, prompts)
    backend.generate(prompts[:2], ModelSettings(temperature=0.0, max_tokens=2))
    out["traced"] = traced_step(torch, backend, prompts, prefix, FOCUS[model])
    sampled = ModelSettings(temperature=0.7, max_tokens=64)
    out["serve"] = []
    for _ in range(calls):
        backend.generate(prompts, sampled, keys=keys, prefix_ids=prefix)
        st = backend.last_stats
        out["serve"].append({"decode_ms_per_step": st["decode_s"] * 1e3 / max(st["decode_steps"], 1),
                             "prefill_ms": st["prefill_s"] * 1e3, "prefix_len": st["prefix_len"]})
    return out


def summary(results: list) -> dict:
    """Per checkout and number: [median, min, max] over its processes."""
    per: dict = {}
    for r in results:
        d = per.setdefault(r["tree"], {})
        for i, s in enumerate(r["serve"]):
            for name in ("decode_ms_per_step", "prefill_ms"):
                d.setdefault(f"serve call {i} {name}", []).append(s[name])
        for k in r["kernels"]:
            for name in ("host_us", "ms"):
                if name in k:
                    d.setdefault(f"{k['key']} {name}", []).append(k[name])
        for name in ("device_ms_per_step", "launches_per_step"):
            d.setdefault(f"traced {name}", []).append(r["traced"][name])
    return {tree: {k: [statistics.median(v), min(v), max(v)] for k, v in d.items()}
            for tree, d in per.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", default=[str(ROOT)], help="roots of the checkouts")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--calls", type=int, default=2, help="serve calls a process")
    ap.add_argument("--model", default="llama3-8b", choices=sorted(FOCUS))
    ap.add_argument("--out", default=None, help="also write every line to this JSON file")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(pathlib.Path(args.child), args.calls, args.model)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_ab: needs an NVIDIA card", file=sys.stderr)
        return 1
    trees = [pathlib.Path(t).resolve() for t in args.trees]
    results = []
    for rnd in range(args.rounds):
        for tree in (trees if rnd % 2 == 0 else trees[::-1]):
            proc = subprocess.run([sys.executable, __file__, "--child", str(tree),
                                   "--calls", str(args.calls), "--model", args.model],
                                  capture_output=True, text=True, timeout=1800)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            row = {"round": rnd, **json.loads(proc.stdout.strip().splitlines()[-1])}
            results.append(row)
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    device = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    done = {"device": device, "model": args.model, "median_min_max": summary(results)}
    print(json.dumps(done), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"runs": results, **done}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
