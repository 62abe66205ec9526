#!/usr/bin/env python3
"""Time K4's float32 route (the int8-weight product over float32 x,
``quant_matmul`` / ``quant_matmul_group``) in one or more checkouts side by
side on one card, beside ``torch.matmul`` in float32.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/torch_k4_f32_ab.py [ROOT ...] [--decode] [--plans] [--out FILE]

Each ROOT (default: this checkout) runs in a child process of its own, in
the order given, with its own package and its own kernel build, so
``python3 tools/torch_k4_f32_ab.py build/ab/parent . . build/ab/parent``
holds two checkouts against each other in turns (unpack the parent with
``git archive`` into a gitignored directory). The shapes are llama3-8b's
weights as ``chip_smoke.py``'s phase 18 (a float32 model over int8
weights) and phase 31 (tp=2's shards) give them, weights drawn from seed 0
on the card and quantized per column, x from a normal:

- decode, M = 48 (the study's batch), 16, 8 and 4: q/k/v and gate/up grouped (one
  ``quant_matmul_group`` call), o, down, lm_head, and gate, q and k alone;
  lm_head at M = 1 (the prefix's last token); with ``--decode`` only these
  rows and tp=2's lm_head;
- prefill, M = 3,584 (4 x 896), 1,536 and 704: gate, down, q and k alone,
  and at M = 128 (phase 25's paged suffix prefills);
- tp=2 at M = 3,584: q [4096, 2048], k [4096, 512], o [2048, 4096],
  gate [4096, 7168], down [7168, 4096]; lm_head [4096, 64128] at M = 4.

Each row is checked against ``quant_matmul_reference`` (1e-4 + 3e-5 *
|plain|, ``err_over_tol``) and timed as ``chip_smoke.py``'s K4 rows are:
each call alone with CUDA events after a 64 MB write has evicted the L2
(``ms``). ``library_ms`` is one ``torch.matmul`` in float32 over the
weight dequantized beforehand, TF32 off (``allow_tf32 = False``: cuBLAS's
float32 GEMM), in the same child. Three bounds are printed, each the
larger of the bytes (int8 weight, scales, x and the output once) over
3.35 TB/s and an operation count over a peak: ``bound_ms``, the card's
best float32-accurate product of an int8 weight (exact in bf16 too; x in
three bf16 parts keeps float32's bits), 3 x 2MKN over 989 TFLOP/s;
``tf32_two_pass_bound_ms``, the route's own design, 2 x 2MKN over 495
TFLOP/s; ``f32_fma_bound_ms``, the parent's yardstick, 2MKN over 67
TFLOP/s. With ``--plans``, in a checkout
that plans the float32 GEMM's K splits (``tf32_gemm_plan``), each GEMM row
is also timed under 1, 2, 4 and 8 splits (``plan`` in the row; the
wrapper's own plan is the row without it). One JSON line a row, then the
card's name and power limit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
import torch
sys.path.insert(0, ".")
from fairness_llm_tpu_torch.ops import _build
from fairness_llm_tpu_torch.ops import quant_matmul as qm

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["quant_matmul"])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
HBM, BF16, TF32, F32 = 3.35e12, 989e12, 495e12, 67e12
weights = {}


def weight(K, N, tag=""):
    if (K, N, tag) not in weights:
        w = torch.randn(K, N, generator=g, device=dev) * 0.02
        weights[(K, N, tag)] = qm.quantize_weight(w)
    return weights[(K, N, tag)]


def cold_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    torch.cuda._sleep(1_000_000 * iters)
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def row(label, M, K, Ns, grouped, plan=None):
    mats = [weight(K, N, f"{label}{i}" if grouped else "") for i, N in enumerate(Ns)]
    x = torch.randn(M, K, generator=g, device=dev)
    if grouped:
        call = lambda: qm.quant_matmul_group(x, mats)
    else:
        call = lambda: [qm.quant_matmul(x, *mats[0])]
    got = call()
    ratio, err = 0.0, 0.0
    for out, (wq, sc) in zip(got, mats):
        want = qm.quant_matmul_reference(x, wq, sc)
        d = (out - want).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (1e-4 + 3e-5 * want.abs())).max()))
    del got
    flops = 2.0 * M * K * sum(Ns)
    iters = 5 if flops > 2e11 else 20
    before = (qm.f32_launches, getattr(qm, "tf32_gemv_launches", 0),
              getattr(qm, "tf32_gemm_launches", 0))
    ms = cold_ms(call, iters)
    launches = [(getattr(qm, n, 0) - b) / (iters + 3) for n, b in
                zip(("f32_launches", "tf32_gemv_launches", "tf32_gemm_launches"), before)]
    wd = torch.cat([qm.dequantize_weight(wq, sc, torch.float32) for wq, sc in mats], 1)
    lib = cold_ms(lambda: torch.matmul(x, wd), iters)
    del wd
    nbytes = K * sum(Ns) + 4 * sum(Ns) + 4 * M * K + 4 * M * sum(Ns)
    bound = max(nbytes / HBM, 3 * flops / BF16) * 1e3
    r = {"label": label, "M": M, "K": K, "N": list(Ns), "grouped": grouped, "plan": plan,
         "ms": ms, "library_ms": lib, "bound_ms": bound,
         "bound_by": "bytes" if nbytes / HBM >= 3 * flops / BF16 else "operations",
         "bound_share": bound / ms,
         "tf32_two_pass_bound_ms": max(nbytes / HBM, 2 * flops / TF32) * 1e3,
         "f32_fma_bound_ms": max(nbytes / HBM, flops / F32) * 1e3,
         "launches_a_call": launches[0], "tf32_gemv_a_call": launches[1],
         "tf32_gemm_a_call": launches[2], "max_abs_err": err, "err_over_tol": ratio,
         "ok": ratio <= 1}
    print(json.dumps(r), flush=True)


DECODE, PLANS = "--decode" in sys.argv, "--plans" in sys.argv


def planned(label, M, K, N):
    # The wrapper's own plan, then (--plans, in a checkout that plans the
    # float32 GEMM's K splits) every split count of 1, 2, 4 and 8 that
    # leaves no split empty.
    row(label, M, K, (N,), False)
    if not (PLANS and hasattr(qm, "tf32_gemm_plan")):
        return
    saved = qm.tf32_gemm_plan
    k_tiles = -(-K // qm.TF32_BK)
    try:
        for splits in (1, 2, 4, 8):
            per = -(-k_tiles // splits)
            if -(-k_tiles // per) != splits:
                continue
            qm.tf32_gemm_plan = lambda K, N, _p=(splits, per * qm.TF32_BK): _p
            row(label, M, K, (N,), False, plan=splits)
    finally:
        qm.tf32_gemm_plan = saved


for M in (48, 16, 8, 4):
    row("qkv", M, 4096, (4096, 1024, 1024), True)
    row("gate_up", M, 4096, (14336, 14336), True)
    for label, K, N in (("o", 4096, 4096), ("down", 14336, 4096), ("lm_head", 4096, 128256),
                        ("gate", 4096, 14336), ("q", 4096, 4096), ("k", 4096, 1024)):
        row(label, M, K, (N,), False)
row("lm_head", 1, 4096, (128256,), False)
if not DECODE:
    for M in (3584, 1536, 704, 128):
        for label, K, N in (("gate", 4096, 14336), ("down", 14336, 4096), ("q", 4096, 4096),
                            ("k", 4096, 1024)):
            planned(label, M, K, N)
    for label, K, N in (("tp2_q", 4096, 2048), ("tp2_k", 4096, 512), ("tp2_o", 2048, 4096),
                        ("tp2_gate", 4096, 7168), ("tp2_down", 7168, 4096)):
        planned(label, 3584, K, N)
row("tp2_lm_head", 4, 4096, (64128,), False)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(ROOT)])
    ap.add_argument("--decode", action="store_true",
                    help="only the decode rows (M <= 16) and tp=2's lm_head")
    ap.add_argument("--plans", action="store_true",
                    help="also time each GEMM row under 1, 2, 4 and 8 K splits")
    ap.add_argument("--out", default=None, help="also write every row here as JSON lines")
    args = ap.parse_args()
    rows = []
    for turn, root in enumerate(args.roots):
        flags = [f for f, on in (("--decode", args.decode), ("--plans", args.plans)) if on]
        res = subprocess.run([sys.executable, "-c", CHILD, *flags], cwd=root,
                             capture_output=True, text=True, timeout=1200)
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
    return 0 if all(r.get("ok", True) for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
