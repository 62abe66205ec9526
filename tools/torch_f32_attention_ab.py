#!/usr/bin/env python3
"""Time the port's float32 attention kernels (K1's ``flash_fwd``, K2's
one-query route, K3's verify window) at the study checkpoints' shapes and at
the float32 gates' llama3-8b width, in one or more checkouts side by side on
one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/torch_f32_attention_ab.py [ROOT ...] [--plans] [--trace] [--bf16] [--out FILE]

Each ROOT (default: this checkout) runs in a child process of its own, in
the order given, with its own package and its own kernel build, so
``python3 tools/torch_f32_attention_ab.py build/ab/parent . . build/ab/parent``
holds two checkouts against each other in turns (unpack the parent with
``git archive`` into a gitignored directory). The shapes, inputs drawn from
seed 0 on the card:

- K2 f32: the phase-1 sweep's decode step, q [16, 4, 32] over a 128-slot
  shared prefix and a 160-slot cache of 2 kv heads (tiny-llama-study) and
  of 4 (tiny-gpt2-study), row b's valid slots a run [s_b, 128) with s_b in
  [0, 24); the served study pool, q [8, 4, 32] over 768 slots and no
  prefix, row b's first n_b slots valid with n_b in [150, 270] (about the
  pool's 1,680 of 6,144);
- K1 f32: the sweep's prefix, q [1, 4, 128, 32]; phase 3's scoring forward,
  q [184, 4, 128, 32], lengths in [40, 128]; phase 2's listwise query, q
  [8, 4, 640, 32], lengths in [180, 260];
- K3 f32, the verify window (9 queries a row, over a float32 and an int8
  cache): phase 13's float32 gates at llama3-8b's width, q [16, 9, 32, 128]
  over a 704-slot prefix and a 168-slot cache of 8 kv heads, row b's window
  at an offset in [60, 159] and every slot up to its end valid; the study's
  speculative sweep, q [16, 9, 4, 32] over a 128-slot prefix and a 168-slot
  cache of 2 kv heads (tiny-llama-study) and of 4 (tiny-gpt2-study), offsets
  in [24, 159].

Each row is checked against its plain version (|err| <= 1e-4), timed over
200 launches with CUDA events behind a device sleep (the device's time a
call; two launches where the call splits and combines), and its host
microseconds a call taken with the device asleep. With ``--plans``, in a
checkout whose wrappers plan the float32 kernels (``flash_f32_rows``,
``decode_splits_f32``, ``verify_splits_f32``), each K1 row is also timed
under every row plan, each K2 row under one split of each kind, and each
K3 row under every (rows a block, splits) plan of whole runs (``plan`` in
the row; the wrapper's own plan is the row without it). With
``--yardsticks``, each K3 row also gives its plain version's time
(``plain_ms``), one SDPA call's over [prefix; cache] with a boolean mask
(``library_ms``, k/v dequantized beforehand) and its bound (``bound_ms``,
as ``chip_smoke.py``'s decode rows count it). With ``--trace``, each row's
device time a call by CUDA kernel (``kernels_us``, from a torch.profiler
capture of 20 calls). With ``--bf16``, instead, K1's bf16 kernel
(flash_fwd_tc) at the main path's prefill shapes (llama3-8b's, the
families' sweep prefixes, mistral-7b's window over 4,608 tokens, and v of
scale 4), then K2's and K3's (decode_split_tc, decode_verify_tc) at the
decode and verify shapes of llama3-8b, llama3-70b, qwen2-7b and gemma-7b
(and v of scale 4 over sweep rows and rows of 12 keys), each held to
chip_smoke.py's bf16 allowance (``err_over_tol``). One
JSON line a row (its checkout, kernel, shape, plan, ms, host_us,
max_abs_err), then the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, time
import torch
sys.path.insert(0, ".")
from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.ops import decode_attention as dm
from fairness_llm_tpu_torch.ops import flash_attention as fm

torch.backends.cuda.matmul.allow_tf32 = False
_build.build([n for n in ("flash_attention", "decode_attention", "decode_attention_f32",
                          "decode_verify_f32") if (_build.CSRC / f"{n}.cu").exists()])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)


def rnd(*shape):
    return torch.randn(*shape, generator=g, device=dev)


def cuda_ms(fn, iters=200):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000 * iters)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=200):
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000 * iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return dt


PLANS, TRACE = "--plans" in sys.argv, "--trace" in sys.argv
YARDSTICKS = "--yardsticks" in sys.argv
HBM, F32 = 3.35e12, 67e12

if "--bf16" in sys.argv:
    # K1's bf16 tensor-core kernel (flash_fwd_tc) at the main path's prefill
    # shapes, q a head-major view of [B, S, H, D] as the model passes it,
    # each against its plain version at chip_smoke.py's bf16 allowance
    # (4e-3 + 1e-2 * |plain|): llama3-8b's no-prefix prefill and sweep
    # prefix, gemma-7b's, gpt2-small's and qwen2-7b's prefix, mistral-7b's
    # window over one row of 4,608, and v of scale 4 (where one bf16 term
    # of P parts from the plain version: ROADMAP C8).
    for name, B, H, Hkv, S, D, window, vs, lo in (
            ("llama_no_prefix", 16, 32, 8, 896, 128, None, 1.0, 700),
            ("llama_sweep_prefix", 1, 32, 8, 640, 128, None, 1.0, 640),
            ("gemma_sweep_prefix", 1, 16, 16, 640, 256, None, 1.0, 640),
            ("qwen2_sweep_prefix", 1, 28, 4, 640, 128, None, 1.0, 640),
            ("gpt2_sweep_prefix", 1, 12, 12, 640, 64, None, 1.0, 640),
            ("mistral_window", 1, 32, 8, 4608, 128, 4096, 1.0, 4608),
            ("large_v", 2, 32, 8, 256, 128, None, 4.0, 256)):
        q = rnd(B, S, H, D).bfloat16().transpose(1, 2)
        k = rnd(B, S, Hkv, D).bfloat16().transpose(1, 2)
        v = (rnd(B, S, Hkv, D) * vs).bfloat16().transpose(1, 2)
        lengths = torch.randint(lo, S + 1, (B,), generator=g, device=dev, dtype=torch.int32)
        call = lambda: fm.flash_attention(q, k, v, lengths, window=window)  # noqa: E731
        want = fm.flash_attention_reference(q, k, v, lengths, window=window).float()
        err = (call().float() - want).abs()
        ratio = float((err / (4e-3 + 1e-2 * want.abs())).max())
        print(json.dumps({"kernel": "flash_attention", "shape": {
            "name": name, "q": [B, H, S, D], "k": [B, Hkv, S, D], "window": window,
            "v_scale": vs}, "ms": cuda_ms(call, 50), "host_us": host_us(call),
            "max_abs_err": float(err.max()), "err_over_tol": ratio, "ok": ratio <= 1}),
            flush=True)
    # K2's and K3's bf16 kernels (decode_split_tc, decode_verify_tc, Q = 9)
    # at the main path's decode shapes, [B, Q, H, Hkv, D] over a prefix of P
    # and a cache of L whose rows see their first n_b slots, n_b in [lo, hi]:
    # llama3-8b's and llama3-70b's sweep steps, qwen2-7b's rep 7, gemma-7b's
    # D = 256, the served pool (no prefix), and v of scale 4 over sweep rows
    # and over rows of 12 keys (where one bf16 term of P parts from the
    # plain version: ROADMAP C9).
    for name, B, Q, H, Hkv, D, P, L, lo, hi, vs in (
            ("llama3-8b_sweep", 16, 1, 32, 8, 128, 640, 224, 100, 224, 1.0),
            ("llama3-8b_served", 16, 1, 32, 8, 128, 0, 1280, 700, 840, 1.0),
            ("llama3-70b_sweep", 16, 1, 64, 8, 128, 640, 224, 100, 224, 1.0),
            ("qwen2-7b_sweep", 16, 1, 28, 4, 128, 640, 224, 100, 224, 1.0),
            ("gemma-7b_sweep", 16, 1, 16, 16, 256, 640, 224, 100, 224, 1.0),
            ("llama3-8b_verify", 16, 9, 32, 8, 128, 640, 224, 100, 224, 1.0),
            ("llama3-70b_verify", 16, 9, 64, 8, 128, 640, 224, 100, 224, 1.0),
            ("llama3-70b_large_v", 16, 1, 64, 8, 128, 640, 224, 100, 224, 4.0),
            ("llama3-70b_verify_large_v", 16, 9, 64, 8, 128, 640, 224, 100, 224, 4.0),
            ("llama3-70b_short_large_v", 16, 1, 64, 8, 128, 0, 224, 12, 12, 4.0),
            ("llama3-70b_verify_short_large_v", 16, 9, 64, 8, 128, 0, 224, 12, 12, 4.0)):
        q = rnd(B, Q, H, D).bfloat16()
        k = rnd(B, L, Hkv, D).bfloat16()
        v = (rnd(B, L, Hkv, D) * vs).bfloat16()
        shared = (rnd(P, Hkv, D).bfloat16(), (rnd(P, Hkv, D) * vs).bfloat16()) if P else None
        n = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
        valid = torch.arange(L, device=dev)[None, :] < n[:, None]
        kw = {"q_offsets": (n - Q).to(torch.int32)} if Q > 1 else {}
        q = q if Q > 1 else q[:, 0]
        call = lambda: dm.decode_attention(q, k, v, valid, shared, **kw)  # noqa: E731
        want = dm.decode_attention_reference(q, k, v, valid, shared, **kw).float()
        err = (call().float() - want).abs()
        ratio = float((err / (4e-3 + 1e-2 * want.abs())).max())
        print(json.dumps({"kernel": "decode_verify_tc" if Q > 1 else "decode_split_tc",
                          "shape": {"name": name, "q": list(q.shape), "k": [B, L, Hkv, D],
                                    "P": P, "keys_a_row": [lo, hi], "v_scale": vs},
                          "ms": cuda_ms(call, 200), "host_us": host_us(call),
                          "max_abs_err": float(err.max()), "err_over_tol": ratio,
                          "ok": ratio <= 1}), flush=True)
    sys.exit(0)


def kernels_us(call, n=20):
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return {e.key[:48]: e.device_time_total / n for e in prof.key_averages()
            if e.device_time_total > 0}


def row(kernel, shape, call, plain, plan=None, yard=None):
    err = float((call() - plain()).abs().max())
    r = {"kernel": kernel, "shape": shape, "plan": plan, "ms": cuda_ms(call),
         "host_us": host_us(call), "max_abs_err": err, "ok": err <= 1e-4}
    if TRACE:
        r["kernels_us"] = kernels_us(call)
    if yard is not None:
        r.update(plain_ms=cuda_ms(plain, 20), **yard())
    print(json.dumps(r), flush=True)


def planned(mod, planner, plans, kernel, shape, call, plain, yard=None):
    # The row under the wrapper's plan, then (--plans) under each of plans,
    # the planner replaced.
    row(kernel, shape, call, plain, yard=yard if YARDSTICKS else None)
    if not PLANS or not hasattr(mod, planner):
        return
    saved = getattr(mod, planner)
    try:
        for plan in plans:
            setattr(mod, planner, lambda *a, _p=plan: _p)
            row(kernel, shape, call, plain, plan)
    finally:
        setattr(mod, planner, saved)


def decode(name, B, H, Hkv, L, P, valid):
    q, k, v = rnd(B, H, 32), rnd(B, L, Hkv, 32), rnd(B, L, Hkv, 32)
    shared = (rnd(P, Hkv, 32), rnd(P, Hkv, 32)) if P else None
    planned(dm, "decode_splits_f32", [(int(P > 0), 1)], "decode_attention_f32",
            {"name": name, "q": [B, H, 32], "k": [B, L, Hkv, 32], "prefix": P,
             "visible_slots": int(valid.sum())},
            lambda: dm.decode_attention(q, k, v, valid, shared),
            lambda: dm.decode_attention_reference(q, k, v, valid, shared))


slots = torch.arange(160, device=dev)[None, :]
start = torch.randint(0, 24, (16, 1), generator=g, device=dev)
sweep_valid = (slots >= start) & (slots < 128)
for name, hkv in (("study_sweep_llama", 2), ("study_sweep_gpt2", 4)):
    decode(name, 16, 4, hkv, 160, 128, sweep_valid)
n = torch.randint(150, 271, (8, 1), generator=g, device=dev)
pool_valid = torch.arange(768, device=dev)[None, :] < n
for name, hkv in (("served_pool_llama", 2), ("served_pool_gpt2", 4)):
    decode(name, 8, 4, hkv, 768, 0, pool_valid)


def verify(name, B, H, Hkv, L, P, D, lo, int8, Q=9):
    q, k, v = rnd(B, Q, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D)
    shared = (rnd(P, Hkv, D), rnd(P, Hkv, D))
    scales = {}
    if int8:
        from fairness_llm_tpu_torch.models.transformer import _quantize_kv
        (k, ks), (v, vs) = _quantize_kv(k), _quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    offs = torch.randint(lo, L - Q + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    valid = torch.arange(L, device=dev)[None, :] <= (offs[:, None] + Q - 1)

    def yard():
        # chip_smoke.py's decode_numbers: one SDPA call over [prefix; cache]
        # (k/v dequantized beforehand, a boolean mask), and the bound, the
        # bytes the inputs need or 4*D operations a visible (query, key)
        # pair a head over the f32 FMA peak, whichever is longer.
        from fairness_llm_tpu_torch.models.transformer import _dequantize_kv
        slots = torch.arange(L, device=dev)
        sees = valid[:, None, :] & (slots[None, None, :] <= (
            offs.long()[:, None, None] + torch.arange(Q, device=dev)[None, :, None]))
        kf = _dequantize_kv(k, scales["k_scale"], q.dtype) if int8 else k
        vf = _dequantize_kv(v, scales["v_scale"], q.dtype) if int8 else v
        rep = H // Hkv
        kk = torch.cat([shared[0].transpose(0, 1)[None].expand(B, -1, -1, -1),
                        kf.transpose(1, 2)], 2).repeat_interleave(rep, 1).contiguous()
        vv = torch.cat([shared[1].transpose(0, 1)[None].expand(B, -1, -1, -1),
                        vf.transpose(1, 2)], 2).repeat_interleave(rep, 1).contiguous()
        mask = torch.cat([torch.ones(B, Q, P, dtype=torch.bool, device=dev), sees], 2)
        q4, m4 = q.transpose(1, 2).contiguous(), mask[:, None].contiguous()
        lib = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, kk, vv, attn_mask=m4))
        needed = int(sees.any(1).sum())
        pairs = int(sees.sum()) + B * Q * P
        nbytes = (2 * q.numel() * 4 + 2 * needed * Hkv * D * k.element_size()
                  + (2 * needed * Hkv * 4 if int8 else 0) + 2 * P * Hkv * D * 4 + B * L + 4 * B)
        t_ops, t_bytes = 4.0 * D * H * pairs / F32 * 1e3, nbytes / HBM * 1e3
        return {"library_ms": lib, "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    ntp, ntc = -(-P // 32), -(-L // 32)
    plans = sorted({(rb, -(-ntp // run), -(-ntc // run))
                    for rb in getattr(dm, "VERIFY_F32_ROWS", ()) if rb * D <= 8192
                    for run in range(1, max(ntp, ntc) + 1)})
    planned(dm, "verify_splits_f32", plans, "decode_attention_verify_f32",
            {"name": name, "q": [B, Q, H, D], "k": [B, L, Hkv, D], "prefix": P,
             "cache": "int8" if int8 else "float32", "visible_slots": int(valid.sum())},
            lambda: dm.decode_attention(q, k, v, valid, shared, q_offsets=offs, **scales),
            lambda: dm.decode_attention_reference(q, k, v, valid, shared, q_offsets=offs,
                                                  **scales), yard)


for int8 in (False, True):
    verify("gate_llama3_8b", 16, 32, 8, 168, 704, 128, 60, int8)
    for name, hkv in (("study_spec_llama", 2), ("study_spec_gpt2", 4)):
        verify(name, 16, 4, hkv, 168, 128, 32, 24, int8)

for name, B, S, lo, hi in (("study_prefix", 1, 128, 128, 128), ("scoring", 184, 128, 40, 128),
                           ("listwise", 8, 640, 180, 260)):
    q, k, v = rnd(B, 4, S, 32), rnd(B, 2, S, 32), rnd(B, 2, S, 32)
    lengths = torch.randint(lo, hi + 1, (B,), generator=g, device=dev, dtype=torch.int32)
    planned(fm, "flash_f32_rows", [16, 32, 64], "flash_attention_f32",
            {"name": name, "q": [B, 4, S, 32], "k": [B, 2, S, 32],
             "valid_rows": int(lengths.sum())},
            lambda: fm.flash_attention(q, k, v, lengths),
            lambda: fm.flash_attention_reference(q, k, v, lengths))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(ROOT)])
    ap.add_argument("--plans", action="store_true", help="time every plan of the new planners")
    ap.add_argument("--trace", action="store_true", help="device time a call by CUDA kernel")
    ap.add_argument("--yardsticks", action="store_true",
                    help="the verify rows' plain and SDPA times and their bound")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 K1, K2 and K3 kernels at the main path's shapes instead")
    ap.add_argument("--out", default=None, help="also write every row here as JSON lines")
    args = ap.parse_args()
    rows = []
    for turn, root in enumerate(args.roots):
        flags = [f for f, on in (("--plans", args.plans), ("--trace", args.trace),
                                 ("--yardsticks", args.yardsticks), ("--bf16", args.bf16)) if on]
        res = subprocess.run([sys.executable, "-c", CHILD, *flags], cwd=root,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                r = {"root": root, "turn": turn, **json.loads(line)}
                rows.append(r)
                print(json.dumps(r), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
