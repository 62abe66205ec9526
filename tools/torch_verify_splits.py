#!/usr/bin/env python3
"""Time the port's bf16 split-key decode-attention kernels under every
key-split plan: the verify window (K3, ``decode_verify_tc``) at llama3-8b's
speculative verify shape, and one query per row (K2, K2q,
``decode_split_tc``) at its shared-prefix sweep shape.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/torch_verify_splits.py [--out build/verify_splits.json]

The verify window: q [16, 9, 32, 128] against a 704-slot shared prefix and a
168-slot cache (bf16, then int8 with its scales), window offsets drawn in
[0, 168 - 9] from seed 0 with holes in ``valid`` below them, as the card
tests draw them; plans from one split of each kind to one tile a split.
One query per row: q [B, 32, 128] at B = 16 and at the study's 48 against
the same prefix and a 160-slot cache, row b's valid slots a run [s_b, 96)
with s_b drawn in [0, 24), as a decode step after a left-padded remainder
prefill sees them; every pair of a prefix and a cache split count that
whole-tile runs give. Each plan is checked against the plain version
elementwise to 4e-3 + 1e-2 * |plain|, timed over 200 launches with CUDA
events and printed as one JSON line; the plan the wrapper picks
(``verify_splits``, ``decode_splits``) is marked. A final line gives the
card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ATOL, RTOL = 4e-3, 1e-2
B, Q, H, HKV, D, L, P = 16, 9, 32, 8, 128, 168, 704
DECODE_L, DECODE_BATCHES = 160, (16, 48)


def cuda_ms(torch, fn, iters: int = 200) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # ~0.5 ms of device sleep a launch: the host queues the loop meanwhile.
    torch.cuda._sleep(1_000_000 * iters)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def runs(n: int):
    """The split counts that runs of whole tiles give over n tiles."""
    return sorted({-(-n // run) for run in range(1, n + 1)})


def timed_rows(torch, dm, planner: str, plans, chosen, want, call, label: dict, blocks):
    """Check and time ``call`` under each plan, ``dm.<planner>`` replaced by
    the plan; the wrapper's own planner is put back after. ``blocks(sp,
    sc)``: the plan's grid."""
    rows, saved = [], getattr(dm, planner)
    try:
        for sp, sc in plans:
            setattr(dm, planner, lambda *a, _p=(sp, sc): _p)
            err = (call().float() - want).abs()
            ratio = float((err / (ATOL + RTOL * want.abs())).max())
            row = {**label, "splits_prefix": sp, "splits_cache": sc, "blocks": blocks(sp, sc),
                   "ms": cuda_ms(torch, call),
                   "err_over_tol": ratio, "ok": ratio <= 1, "chosen": (sp, sc) == chosen}
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        setattr(dm, planner, saved)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_verify_splits: needs an NVIDIA card", file=sys.stderr)
        return 1
    from fairness_llm_tpu_torch.models.transformer import _quantize_kv
    from fairness_llm_tpu_torch.ops import decode_attention as dm

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, Q, H, D, generator=g, device=dev, dtype=torch.bfloat16)
    kf = torch.randn(B, L, HKV, D, generator=g, device=dev, dtype=torch.bfloat16)
    vf = torch.randn(B, L, HKV, D, generator=g, device=dev, dtype=torch.bfloat16)
    shared = (torch.randn(P, HKV, D, generator=g, device=dev, dtype=torch.bfloat16),
              torch.randn(P, HKV, D, generator=g, device=dev, dtype=torch.bfloat16))
    offs = torch.randint(0, L - Q + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    slots = torch.arange(L, device=dev)[None, :]
    valid = (slots <= offs[:, None] + Q - 1) & (torch.rand(B, L, generator=g, device=dev) < 0.9)
    valid[:, 0] = True
    (kq, ks), (vq, vs) = _quantize_kv(kf), _quantize_kv(vf)
    caches = {"bf16": (kf, vf, {}), "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}

    ntp, ntc = -(-P // dm.TILE_KEYS), -(-L // dm.TILE_KEYS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = dm.verify_splits(B, HKV, (H // HKV) * Q, P, L, sms)
    plans = sorted({(-(-ntp // run), -(-ntc // run)) for run in range(1, max(ntp, ntc) + 1)})
    rows = []
    for name, (k, v, scales) in caches.items():
        want = dm.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs,
                                             **scales).float()
        call = lambda: dm.decode_attention(q, k, v, valid, shared,  # noqa: E731
                                           q_offsets=offs, **scales)
        rows += timed_rows(torch, dm, "verify_splits", plans, chosen, want, call,
                           {"kernel": "decode_verify_tc", "cache": name, "batch": B},
                           lambda sp, sc: (sp + sc) * B * HKV)

    # One query per row: decode_split_tc.
    ntc = -(-DECODE_L // dm.TILE_KEYS)
    plans = [(sp, sc) for sp in runs(ntp) for sc in runs(ntc)]
    for batch in DECODE_BATCHES:
        q1 = torch.randn(batch, H, D, generator=g, device=dev, dtype=torch.bfloat16)
        kf = torch.randn(batch, DECODE_L, HKV, D, generator=g, device=dev, dtype=torch.bfloat16)
        vf = torch.randn(batch, DECODE_L, HKV, D, generator=g, device=dev, dtype=torch.bfloat16)
        start = torch.randint(0, 24, (batch, 1), generator=g, device=dev)
        slots = torch.arange(DECODE_L, device=dev)[None, :]
        valid1 = (slots >= start) & (slots < 96)
        (kq, ks), (vq, vs) = _quantize_kv(kf), _quantize_kv(vf)
        chosen = dm.decode_splits(batch, HKV, H // HKV, P, DECODE_L, D, sms)
        for name, (k, v, scales) in {"bf16": (kf, vf, {}),
                                     "int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}.items():
            want = dm.decode_attention_reference(q1, k, v, valid1, shared, **scales).float()
            call = lambda: dm.decode_attention(q1, k, v, valid1, shared, **scales)  # noqa: E731
            rows += timed_rows(torch, dm, "decode_splits", plans, chosen, want, call,
                               {"kernel": "decode_split_tc", "cache": name, "batch": batch},
                               lambda sp, sc: (sp * HKV * -(-batch * (H // HKV) // 64)
                                               + sc * batch * HKV))
        del q1, kf, vf, kq, vq, ks, vs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    device = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    best = {}
    for r in rows:
        key = (r["kernel"], r["cache"], r["batch"])
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    print(json.dumps({"device": device, "sms": sms,
                      "fastest": [{k: r[k] for k in ("kernel", "cache", "batch", "splits_prefix",
                                                     "splits_cache", "ms", "chosen")}
                                  for r in best.values()]}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({"device": device, "rows": rows}, indent=1))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
