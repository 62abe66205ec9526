#!/usr/bin/env python3
"""Time variants of the K4 GEMV kernel (``gemv_stream_tc``) side by side on
one card, to find what holds it back.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/torch_k4_variants.py [--variants base,no_compute,...]

Each variant is ``ops/csrc/quant_matmul.cu`` with a few lines replaced
(``VARIANTS``), built with the port's nvcc flags into
``build/k4_variants/<name>/`` (one nvcc per variant, all started together)
and loaded in place of the port's library, so the wrapper, the plan and the
workspace are the port's own. ``no_compute`` variants skip the consumers'
products (their outputs are wrong; they time the producer, the ring and the
memory system alone); ``no_load`` ones skip the copies (the consumers alone, on whatever
the ring holds); ``empty`` ones return after setup (launch and setup
alone). For every variant, at llama3-8b's decode shapes (M =
16, or ``--m``; q/k/v and gate/up grouped, o, down, lm_head with an f32 output; random
int8 weights from seed 0): the device ms of a call timed alone after a 64 MB
write evicts the L2 cache (20 calls), and of a call back to back with the
last (50 calls); each variant that computes is held against the plain
version first. The variants run in the order given, then again reversed.
A variant named ``base@splits4`` is the
source as it stands with the plan's STREAM_MAX_SPLITS set to 4,
``base@short0`` with every group on 256-column tiles. One JSON
line per (variant, pass), then the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "fairness_llm_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "k4_variants"

# The bf16 route's k loop (the first of the two in the stream kernel's body).
_LOOP = ("      if constexpr (XB == 2) {\n        const int xr = lane % 16, xc = lane / 16;"
         "  // this lane's ldmatrix row and k half\n#pragma unroll\n"
         "        for (int kk = 0; kk < KSTEPS; ++kk) {")
_STAGES = "constexpr int GS_STAGES = 4;"
_NOX = ("          cp_async16(xd + r * R::X_ROW + (gs_xchunk<XB>(ch, r) << 4),",
        "          if (false) cp_async16(xd + r * R::X_ROW + (gs_xchunk<XB>(ch, r) << 4),")
_NOWORK = ("  if (warp == GS_CONSUMERS) {\n    constexpr int XCH",
           "  if (p.M > 0) return;\n  if (warp == GS_CONSUMERS) {\n    constexpr int XCH")
_NOCOMP = (_LOOP, _LOOP.replace("kk < KSTEPS", "kk < 0"))
_NOLOAD = [("mbar_expect_tx(&full[st], bytes);", "mbar_expect_tx(&full[st], 0);"),
           ("tma_load_2d(wd, &grp.wmap[w]", "if (false) tma_load_2d(wd, &grp.wmap[w]"),
           ("if (two) tma_load_2d(wd", "if (false) tma_load_2d(wd"), _NOX]
_NOMMA = ("for (int c = 0; c < 4; ++c) mma_bf16(acc[m][c], a, b[c][0], b[c][1]);",
          "for (int c = 0; c < 4; ++c) acc[m][c][0] += __uint_as_float(a[0] ^ b[c][0] ^ b[c][1]);")
_NOCONV = ("            b[c][0] = pack_top(f[0][c], f[1][c]);\n"
           "            b[c][1] = pack_top(f[2][c], f[3][c]);",
           "            b[c][0] = wl[c];\n            b[c][1] = wl[(c + 1) & 3];")
# name -> replacements in quant_matmul.cu
VARIANTS = {
    "base": [],
    "stages3": [(_STAGES, "constexpr int GS_STAGES = 3;")],
    "stages6": [(_STAGES, "constexpr int GS_STAGES = 6;")],
    "stages8": [(_STAGES, "constexpr int GS_STAGES = 8;")],
    "no_compute": [_NOCOMP],
    "no_compute_no_x": [_NOCOMP, _NOX],
    "no_load": _NOLOAD,
    "no_load_no_mma": _NOLOAD + [_NOMMA],
    "no_load_no_convert": _NOLOAD + [_NOCONV],
    "empty": [_NOWORK],
}
# (label, K, widths of the weights one launch takes, out dtype name)
SHAPES = [("qkv", 4096, (4096, 1024, 1024), "bfloat16"), ("o", 4096, (4096,), "bfloat16"),
          ("gate_up", 4096, (14336, 14336), "bfloat16"), ("down", 14336, (4096,), "bfloat16"),
          ("lm_head", 4096, (128256,), "float32")]


def build(names) -> None:
    sys.path.insert(0, str(ROOT))
    from fairness_llm_tpu_torch.ops import _build

    procs = []
    for name in names:
        src = (SRC / "quant_matmul.cu").read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in SRC.glob("*.cuh"):
            (d / h.name).write_text(h.read_text())
        (d / "quant_matmul.cu").write_text(src)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(d / "libquant_matmul.so"),
               str(d / "quant_matmul.cu")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        out, _ = proc.communicate()
        regs = [ln.strip() for ln in out.splitlines() if "gemv_stream" in ln or "registers" in ln]
        print(json.dumps({"variant": name, "nvcc_exit": proc.returncode,
                          "ptxas": regs[-12:]}), flush=True)
        if proc.returncode != 0:
            raise SystemExit(out[-4000:])


def use(name: str) -> None:
    """Load variant ``name``'s library in place of the port's; a suffix
    ``@splitsN`` also sets the plan's STREAM_MAX_SPLITS to N, ``@shortN``
    its STREAM_SHORT_RUN (0: every group takes 256-column tiles)."""
    from fairness_llm_tpu_torch.ops import _build
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    name, _, opt = name.partition("@")
    qm.STREAM_MAX_SPLITS, qm.STREAM_SHORT_RUN = DEFAULTS
    if opt.startswith("splits"):
        qm.STREAM_MAX_SPLITS = int(opt[6:])
    elif opt.startswith("short"):
        qm.STREAM_SHORT_RUN = int(opt[5:])
    qm.gemv_plan.cache_clear()

    _build._libs["quant_matmul"] = ctypes.CDLL(str(OUT / name / "libquant_matmul.so"))
    for key in [k for k in _build._fns if k[0] == "quant_matmul"]:
        del _build._fns[key]
    qm._groups.clear()


DEFAULTS = None


def time_variant(torch, name: str, weights, xs) -> dict:
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    use(name)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    row = {"variant": name, "M": next(iter(xs.values())).shape[0]}
    for label, K, Ns, od in SHAPES:
        mats, x = weights[label], xs[K]
        odt = getattr(torch, od)

        def call():
            return qm.quant_matmul_group(x, mats, out_dtype=odt)

        if not name.startswith(("no_compute", "no_load", "empty")):  # they compute
            for got, (wq, scale) in zip(call(), mats):
                want = qm.quant_matmul_reference(x, wq, scale, odt)
                err = (got.float() - want.float()).abs()
                if float((err / (4e-3 + 1e-2 * want.float().abs())).max()) > 1:
                    raise SystemExit(f"variant {name} disagrees with the plain version at {label}")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(20)]
        torch.cuda._sleep(20_000_000)
        for e0, e1 in ev:
            flush.zero_()
            e0.record()
            call()
            e1.record()
        torch.cuda.synchronize()
        cold = sum(e0.elapsed_time(e1) for e0, e1 in ev) / len(ev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(50):
            call()
        e1.record()
        torch.cuda.synchronize()
        row[label] = {"cold_ms": cold, "warm_ms": e0.elapsed_time(e1) / 50,
                      "bytes": K * sum(Ns)}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--m", type=int, default=16, help="rows of x (the decode batch)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_k4_variants: needs an NVIDIA card", file=sys.stderr)
        return 1
    names = args.variants.split(",")
    build(sorted({n.partition("@")[0] for n in names}))
    from fairness_llm_tpu_torch.ops import quant_matmul as qm

    global DEFAULTS
    DEFAULTS = (qm.STREAM_MAX_SPLITS, qm.STREAM_SHORT_RUN)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    weights = {label: [qm.quantize_weight(torch.randn(K, N, generator=g, device=dev) * 0.02)
                       for N in Ns] for label, K, Ns, _ in SHAPES}
    xs = {K: torch.randn(args.m, K, generator=g, device=dev).bfloat16() for K in (4096, 14336)}
    for order in (names, names[::-1]):
        for name in order:
            print(json.dumps(time_variant(torch, name, weights, xs)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
